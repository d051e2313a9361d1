"""Joint pose + NeRF trainer, SPARF's main trainer, training only (torch port
of sparf_tpu/training/joint_trainer.py).

  - initial poses: identity (+ translation centering), noisy GT (se(3)
    noise drawn from a seeded torch.Generator), or given by the caller;
  - pose parametrization from sparf_tpu_torch.models.pose_params;
  - two Adam optimizers (NeRF and poses, each with its own schedule);
  - a joint stage, then frozen poses (optionally re-initializing the NeRF).
SfM initial poses, test-time pose refinement and evaluation are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sparf_tpu.utils import alignment
from sparf_tpu_torch.models import pose_params as pose_mod
from sparf_tpu_torch.models import renderer as renderer_mod
from sparf_tpu_torch.models.pose_params import PoseConfig
from sparf_tpu_torch.training import engine
from sparf_tpu_torch.training.trainer import NerfTrainerPerScene
from sparf_tpu_torch.utils import camera


class PoseAndNerfTrainerPerScene(NerfTrainerPerScene):
    """Joint pose-NeRF optimization.

    initial_poses_w2c: (N,3,4) or (N,4,4) numpy poses to start from instead of
    the ones cfg.camera.initial_pose describes (lets a test start the port
    from another trainer's poses).
    """

    model_name = "joint_pose_nerf_training"

    def __init__(self, cfg, workspace: Optional[str] = None, debug: bool = False,
                 device="cuda", initial_poses_w2c: Optional[np.ndarray] = None):
        self._given_initial_poses = initial_poses_w2c
        if cfg.get("rematch_at_ratio") is not None:
            raise NotImplementedError("mid-training rematching is not ported yet")
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
            n_fixed = (cfg.camera.get("n_first_fixed_poses", 0)
                       if cfg.camera.get("optimize_relative_poses") else 0)
            gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
            se3_noise = torch.randn((n_poses - n_fixed, 6), generator=gen) * cfg.camera.noise
            pose_noise = camera.se3_to_SE3(se3_noise)
            if n_fixed > 0:
                eye = torch.eye(3, 4).expand(n_fixed, 3, 4)
                pose_noise = torch.cat([eye, pose_noise], dim=0)
            init = camera.pose_compose([pose_noise, torch.as_tensor(pose_GT_w2c)]).numpy()
            init = alignment.pad_poses(init)
        elif initial_pose == "given":
            init = alignment.pad_poses(np.asarray(self.train_scene_np["pose_initial"]))
        elif "sfm" in initial_pose:
            raise NotImplementedError("SfM initial poses are not ported yet")
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
