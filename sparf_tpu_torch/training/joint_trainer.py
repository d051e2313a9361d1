"""Joint pose + NeRF trainer, SPARF's main trainer (torch port of
sparf_tpu/training/joint_trainer.py).

  - initial poses: identity (+ translation centering), noisy GT (se(3)
    noise drawn from a seeded torch.Generator), or given by the caller;
  - pose parametrization from sparf_tpu_torch.models.pose_params;
  - two Adam optimizers (NeRF and poses, each with its own schedule);
  - a joint stage, then frozen poses (optionally re-initializing the NeRF);
  - pose evaluation through sim3 alignment; val and test poses backtracked
    through the saved sim3;
  - test-time photometric pose refinement: an Adam loop over a 6-dof twist
    per test view, `test_iter` steps of `rand_rays` rays;
  - the mid-training rematch (`rematch_at_ratio`): the correspondence pools
    rebuilt once with the current poses as the matcher's prior;
  - SfM initial poses (`initial_pose` containing "sfm"): colmap_init/sfm.py
    on the matcher's flows, pre-aligned to GT as the JAX package does; its
    sparse depth maps go to train_scene as colmap_depth/colmap_conf, for
    the COLMAP depth loss (training/losses/colmap_depth.py).

`NerfTrainerPerSceneWColmapFixedPoses` (model `nerf_fixed_noisy_poses`)
trains the NeRF alone on the frozen initial poses.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sparf_tpu_torch.utils import alignment
from sparf_tpu_torch.models import pose_params as pose_mod
from sparf_tpu_torch.models import renderer as renderer_mod
from sparf_tpu_torch.models.pose_params import PoseConfig
from sparf_tpu_torch.parallel import mesh as mesh_mod
from sparf_tpu_torch.training import engine
from sparf_tpu_torch.training.losses import base as loss_base
from sparf_tpu_torch.training.trainer import NerfTrainerPerScene
from sparf_tpu_torch.utils import camera
from sparf_tpu_torch.utils.draws import Draws


def _refine_stats(pose_pre: torch.Tensor, pose_post: torch.Tensor) -> Dict[str, Any]:
    """How far test-time refinement moved a test pose: rotation (deg) and
    camera-center distance, plus the pre-refinement pose, so that evaluation
    can also render without the refinement."""
    pre = pose_pre.detach().cpu().numpy().reshape(3, 4)
    post = pose_post.detach().cpu().numpy().reshape(3, 4)
    rot = float(alignment.rotation_distance_np(pre[None, :, :3], post[None, :, :3])[0])
    c_pre = -pre[:, :3].T @ pre[:, 3]
    c_post = -post[:, :3].T @ post[:, 3]
    return {"rot_deg": rot * 180.0 / np.pi, "trans": float(np.linalg.norm(c_post - c_pre)),
            "pose_pre": pose_pre}


def noisy_gt_poses(cfg, pose_GT_w2c: np.ndarray) -> np.ndarray:
    """initial_pose="noisy_gt": the GT w2c poses composed with se(3) noise of
    scale cfg.camera.noise drawn from a torch.Generator seeded by cfg.seed
    (the first n_first_fixed_poses kept exact when relative poses are
    optimized). (N,3,4) float32."""
    n_poses = pose_GT_w2c.shape[0]
    n_fixed = (cfg.camera.get("n_first_fixed_poses", 0)
               if cfg.camera.get("optimize_relative_poses") else 0)
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    se3_noise = torch.randn((n_poses - n_fixed, 6), generator=gen) * cfg.camera.noise
    pose_noise = camera.se3_to_SE3(se3_noise)
    if n_fixed > 0:
        pose_noise = torch.cat([torch.eye(3, 4).expand(n_fixed, 3, 4), pose_noise], dim=0)
    return camera.pose_compose([pose_noise, torch.as_tensor(pose_GT_w2c)]).numpy()


class PoseAndNerfTrainerPerScene(NerfTrainerPerScene):
    """Joint pose-NeRF optimization.

    initial_poses_w2c: (N,3,4) or (N,4,4) numpy poses to start from instead of
    the ones cfg.camera.initial_pose describes (lets a test start the port
    from another trainer's poses).
    """

    model_name = "joint_pose_nerf_training"
    _test_optim_enabled = True
    _last_refine: Optional[Dict[str, Any]] = None

    def __init__(self, cfg, workspace: Optional[str] = None, debug: bool = False,
                 device="cuda", initial_poses_w2c: Optional[np.ndarray] = None):
        self._given_initial_poses = initial_poses_w2c
        self._rematched = False
        super().__init__(cfg, workspace=workspace, debug=debug, device=device)

    # ------------------------------------------------------------------ build

    def build_networks(self):
        super().build_networks()
        initial_poses_w2c = self.set_initial_poses()
        self.initial_poses_w2c = torch.as_tensor(initial_poses_w2c[:, :3], dtype=torch.float32,
                                                 device=self.device)
        self.initial_pose_error = alignment.evaluate_any_poses(
            np.asarray(initial_poses_w2c[:, :3]), np.asarray(self.train_scene_np["pose"]))
        self.logger.info(f"initial pose error: {self.initial_pose_error}")
        self.pose_cfg = PoseConfig.from_config(self.cfg, nbr_poses=self.n_train_views)
        self.sim3_est_to_gt_c2w = alignment.identity_sim3()

    def set_initial_poses(self) -> np.ndarray:
        """(N,4,4) float32 initial w2c poses."""
        cfg = self.cfg
        pose_GT_w2c = np.asarray(self.train_scene_np["pose"])
        n_poses = pose_GT_w2c.shape[0]
        if self._given_initial_poses is not None:
            return alignment.pad_poses(np.asarray(self._given_initial_poses,
                                                  np.float32)).astype(np.float32)
        initial_pose = cfg.camera.get("initial_pose", "identity")
        if initial_pose == "identity":
            init = np.broadcast_to(np.eye(3, 4, dtype=np.float32), (n_poses, 3, 4)).copy()
            init, _ = alignment.align_translations(pose_GT_w2c, init)
        elif initial_pose == "noisy_gt":
            init = alignment.pad_poses(noisy_gt_poses(cfg, pose_GT_w2c))
        elif initial_pose == "given":
            init = alignment.pad_poses(np.asarray(self.train_scene_np["pose_initial"]))
        elif "sfm" in initial_pose:
            from sparf_tpu_torch.colmap_init import sfm

            # on rank 0 alone under ray sharding: one SfM result, one cache file
            result = mesh_mod.on_rank0(lambda: sfm.compute_sfm_from_matches(
                cfg, self.train_scene_np,
                save_dir=cfg.get("sfm_cache_dir") or f"{self.workspace}/init_sfm",
                load_colmap_depth=bool(cfg.get("load_colmap_depth")), device=self.device),
                self.mesh)
            init_aligned, sim3 = alignment.prealign_w2c_small_camera_systems(
                result.poses_w2c[:, :3], pose_GT_w2c)
            init = alignment.pad_poses(init_aligned)
            if result.colmap_depth is not None:
                self.train_scene["colmap_depth"] = torch.as_tensor(
                    result.colmap_depth * sim3.s, dtype=torch.float32, device=self.device)
                self.train_scene["colmap_conf"] = torch.as_tensor(
                    result.colmap_conf, dtype=torch.float32, device=self.device)
        else:
            raise ValueError(initial_pose)
        if init.shape[-2] == 3:
            init = alignment.pad_poses(init)
        return init.astype(np.float32)

    def setup_optimizer(self):
        super().setup_optimizer()
        cfg = self.cfg
        self.lr_pose_fn = engine.pose_lr_schedule(cfg.optim.lr_pose, cfg.optim.get("lr_pose_end"),
                                                  cfg.max_iter, cfg.optim.get("warmup_pose"))
        self.tx_pose = engine.Adam(self.lr_pose_fn, cfg.get("pose_gradient_clipping"))

    # -------------------------------------------------------------- schedules

    @property
    def iter_end_joint(self) -> Optional[int]:
        cfg = self.cfg
        if not cfg.get("first_joint_pose_nerf_then_nerf"):
            return None
        ratio = cfg.get("ratio_end_joint_nerf_pose_refinement")
        if ratio is not None:
            return int(cfg.max_iter * ratio)
        return int(cfg.get("end_joint_nerf_pose_refinement"))

    def optimize_poses_at(self, iteration: int) -> bool:
        end = self.iter_end_joint
        return True if end is None else iteration < end

    def on_iteration_start(self, iteration: int):
        end = self.iter_end_joint
        if end is not None and iteration == end and self.cfg.get("restart_nerf"):
            # re-initialize the NeRF and its optimizer at the stage switch;
            # iteration_nerf keeps counting
            self.logger.info("stage switch: re-initializing NeRF and its optimizer")
            nerf_params = renderer_mod.init_graph_params(self.init_generator, self.render_cfg,
                                                         self.device)
            self.state.nerf_params = nerf_params
            self.state.opt_state_nerf = self.tx_nerf.init(engine.tree_leaves(nerf_params))
        rr = self.cfg.get("rematch_at_ratio")
        if (rr is not None and not self._rematched
                and iteration >= int(float(rr) * self.cfg.max_iter) > 0):
            self._rematched = True
            self.refresh_correspondence_pools()

    def refresh_correspondence_pools(self):
        """Mid-training matcher refresh (cfg.rematch_at_ratio; no counterpart in
        the reference, whose pools are static): rebuild the correspondence
        pools with the current pose estimates as the matcher's pose prior,
        and drop the compiled steps, which hold the old pools. Triggers once,
        at or after the boundary (so also on a resume past it)."""
        self.logger.info("rematch: rebuilding correspondence pools with "
                         "current pose estimates as the geometry prior")
        self.matcher_prior_poses_w2c = self.current_poses_w2c().detach().cpu().numpy()
        self.define_loss_module()
        self._step_cache = {}

    # ------------------------------------------------------------- pose state

    def current_poses_w2c(self, state: Optional[engine.TrainState] = None) -> torch.Tensor:
        state = state or self.state
        return pose_mod.get_w2c_poses(self.pose_cfg, state.pose_params, self.pose_constants)

    def evaluate_poses(self) -> Dict[str, float]:
        """Rotation/translation errors vs GT, before and after alignment."""
        pose = self.current_poses_w2c().detach().cpu().numpy()
        return alignment.evaluate_any_poses(pose, np.asarray(self.train_scene_np["pose"]))

    def make_results_dict_low_freq(self) -> Dict[str, float]:
        return self.evaluate_poses()

    def update_sim3(self):
        """The sim3 from the optimized to the GT c2w poses, used to backtrack
        val and test poses into the optimized frame."""
        pose = self.current_poses_w2c().detach().cpu().numpy()
        pose_GT = np.asarray(self.train_scene_np["pose"])
        if pose.shape[0] > 9:
            _, self.sim3_est_to_gt_c2w = alignment.prealign_w2c_large_camera_systems(pose, pose_GT)
        else:
            _, self.sim3_est_to_gt_c2w = alignment.prealign_w2c_small_camera_systems(pose, pose_GT)

    def _backtracked(self, pose_GT: np.ndarray) -> torch.Tensor:
        pose = alignment.backtrack_gt_through_sim3(np.asarray(pose_GT), self.sim3_est_to_gt_c2w)
        return torch.as_tensor(np.asarray(pose, np.float32), device=self.device)

    # -------------------------------------------------------------- val / eval

    def val_pose_and_scale(self, idx: int) -> Tuple[torch.Tensor, float]:
        self.update_sim3()
        pose = self._backtracked(self.val_scene_np["pose"][idx: idx + 1])
        return pose, float(self.sim3_est_to_gt_c2w.s)

    def test_pose_and_scale(self, test_scene, idx: int) -> Tuple[torch.Tensor, float]:
        self.update_sim3()
        pose = self._backtracked(test_scene["pose"][idx: idx + 1].cpu().numpy())
        return self._refine_test_pose(test_scene, idx, pose), float(self.sim3_est_to_gt_c2w.s)

    # ------------------------------------------------ test-time pose refinement

    def _refine_test_pose(self, test_scene, idx: int, pose: torch.Tensor) -> torch.Tensor:
        """`pose` with test-time refinement's twist composed onto it, when
        cfg.optim.test_photo asks for it (its stats in self._last_refine)."""
        self._last_refine = None
        if not (self.cfg.optim.get("test_photo", False) and self._test_optim_enabled):
            return pose
        twist = self.run_test_time_photometric_optim(test_scene, idx, pose)
        refined = camera.pose_compose([camera.se3_to_SE3(twist), pose])
        self._last_refine = _refine_stats(pose, refined)
        return refined

    def test_optim_draws(self, idx: int):
        """The pixel draws of test view idx's refinement: a generator seeded
        by (seed, 1000 + idx)."""
        seed = np.random.SeedSequence([int(self.cfg.get("seed", 0)), 1000 + idx])
        return Draws(int(seed.generate_state(1)[0]), self.device)

    def run_test_time_photometric_optim(self, test_scene, idx: int, pose: torch.Tensor
                                        ) -> torch.Tensor:
        """(1,6) twist that refines the w2c `pose` of test view idx: `test_iter`
        Adam steps (lr_pose, no clipping) on the photometric loss of
        `rand_rays` random pixels, rendered with the frozen NeRF. Only the
        twist's gradient is asked for."""
        cfg = self.cfg
        n_iter = int(cfg.optim.get("test_iter", 100))
        tx = engine.Adam(engine.exponential_lr(float(cfg.optim.lr_pose), None, 1))
        loss_fn = loss_base.huber_loss if cfg.huber_loss_for_photometric else loss_base.mse_loss
        fine_enabled = self.fine_enabled_at(cfg.max_iter)
        H, W = test_scene["image"].shape[-2:]
        rand_rays = int(cfg.nerf.rand_rays)
        nerf_params = engine.tree_unflatten(
            self.state.nerf_params, [t.detach() for t in engine.tree_leaves(self.state.nerf_params)])
        image_flat = test_scene["image"][idx: idx + 1].reshape(1, 3, -1).permute(0, 2, 1)
        intr = test_scene["intr"][idx: idx + 1]
        depth_range = renderer_mod.render_depth_range(cfg, test_scene)
        draws = self.test_optim_draws(idx)
        twist = torch.zeros((1, 6), device=self.device)
        opt_state = tx.init([twist])
        for _ in range(n_iter):
            ray_idx = draws.randint((rand_rays,), 0, H * W)
            pixels = torch.stack([(ray_idx % W).to(torch.float32) + 0.5,
                                  (ray_idx // W).to(torch.float32) + 0.5], dim=-1)
            leaf = twist.detach().requires_grad_(True)
            pose_refined = camera.pose_compose([camera.se3_to_SE3(leaf), pose])
            out = renderer_mod.render_at_pixels(nerf_params, self.render_cfg, pose_refined, intr,
                                                pixels, depth_range, 1.0, draws=None,
                                                stratified=False, fine_enabled=fine_enabled)
            gt = image_flat[:, ray_idx]
            loss = loss_fn(out["rgb"], gt)
            if "rgb_fine" in out:
                loss = loss + loss_fn(out["rgb_fine"], gt)
            (grad,) = torch.autograd.grad(loss, [leaf])
            (upd,), opt_state = tx.update([grad], opt_state)
            twist = twist + upd
        return twist

    def evaluate_full(self, save_ind_files: bool = False, out_dir: Optional[str] = None,
                      with_test_optim: Optional[bool] = None, plot: bool = False) -> Dict:
        """Adds the pose metrics to the evaluation."""
        if with_test_optim is not None:
            self._test_optim_enabled = with_test_optim
        result = super().evaluate_full(save_ind_files, out_dir, plot=plot)
        pose_stats = self.evaluate_poses()
        result["mean"].update({"rot_error": pose_stats["error_R"],
                               "trans_error": pose_stats["error_t"],
                               "init_rot_error": self.initial_pose_error["error_R_before_align"],
                               "init_trans_error": self.initial_pose_error["error_t_before_align"]})
        self.write_eval_json(result, out_dir)
        return result


class NerfTrainerPerSceneWColmapFixedPoses(PoseAndNerfTrainerPerScene):
    """NeRF training on FROZEN noisy/COLMAP initial poses (the ablation of
    the JAX package's trainer of the same name): the poses never step,
    validation and test views render at their GT poses with depth scale 1,
    and test-time refinement composes its twist onto the GT test pose."""

    model_name = "nerf_fixed_noisy_poses"

    def optimize_poses_at(self, iteration: int) -> bool:
        return False

    def val_pose_and_scale(self, idx: int) -> Tuple[torch.Tensor, float]:
        return self.val_scene["pose"][idx: idx + 1], 1.0

    def test_pose_and_scale(self, test_scene, idx: int) -> Tuple[torch.Tensor, float]:
        return self._refine_test_pose(test_scene, idx, test_scene["pose"][idx: idx + 1]), 1.0
