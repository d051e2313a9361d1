"""Per-scene trainer (torch port of sparf_tpu/training/trainer.py).

The Python loop feeds the step counter, picks the step of the current stage
(precrop window, fine sampling, pose optimization), logs, validates on
full-image renders with best-model tracking, and saves snapshots; a run
resumes from the latest one. `evaluate_full` renders the test split and
writes the metrics as JSON, with `plot` a panel per test view (plots/) and
with `save_ind_files` its render and depth (renders/), as PNGs.
`visualize_train_view` logs a render panel of a train view (and the poses'
frusta) through the writer's `write_image`. The images come from
utils/vis.py and utils/imgproc.write_png: no matplotlib, OpenCV or imageio.

`cfg.tpu.mesh_shape` = [N] (N the world size of the initialised process
group) or "auto" shards every step's rays over the ranks
(sparf_tpu_torch.parallel); every rank runs the same loop, renders for
validation and evaluation are split across the ranks and gathered, and
only rank 0 writes logs, TensorBoard events, snapshots, panels and videos.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparf_tpu_torch.training.logging_utils import SummaryBoard, TensorboardWriter, Timer, create_logger
from sparf_tpu_torch.datasets import create_dataset
from sparf_tpu_torch.models import renderer as renderer_mod
from sparf_tpu_torch.models.renderer import RenderConfig
from sparf_tpu_torch.parallel import mesh as mesh_mod
from sparf_tpu_torch.training import checkpointing, engine
from sparf_tpu_torch.training import metrics as metrics_mod
from sparf_tpu_torch.training.sampling import make_ray_sampler
from sparf_tpu_torch.utils import imgproc, tracing, vis
from sparf_tpu_torch.utils.draws import Draws


def resolve_device(device) -> torch.device:
    """The training device; "cuda" without a visible GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return device


def merged_render(cfg) -> bool:
    """Whether a step renders its bundles merged (renderer.render_bundles):
    cfg.tpu.merged_render, True when the key is absent, as in the JAX
    trainer; density-noise training keeps the per-bundle path."""
    return bool(cfg.tpu.get("merged_render", True)) and not cfg.nerf.density_noise_reg


def mesh_from_config(cfg) -> Optional[mesh_mod.Mesh]:
    """The mesh that cfg.tpu.mesh_shape asks for: [N] needs an initialised
    process group of N ranks ([1] without one runs unsharded), "auto" takes
    the group's world size when there is one of several ranks."""
    import torch.distributed as dist

    shape = cfg.tpu.get("mesh_shape")
    if not shape:
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError("a process group of several ranks needs cfg.tpu.mesh_shape "
                             "([world size] or 'auto'): ranks would train the same rays")
        return None
    if shape == "auto":
        return mesh_mod.make_mesh() if dist.is_initialized() and dist.get_world_size() > 1 \
            else None
    if int(shape[0]) == 1 and not dist.is_initialized():
        return None
    return mesh_mod.make_mesh(int(shape[0]))


def scene_to_device(scene: Dict[str, Any], device) -> Dict[str, Any]:
    """numpy scene -> tensors on `device`; non-array metadata kept as is."""
    return {k: torch.as_tensor(v, device=device) if isinstance(v, np.ndarray) else v
            for k, v in scene.items()}


class NerfTrainerPerScene:
    """NeRF training with fixed ground-truth poses."""

    model_name = "nerf_gt_poses"

    def __init__(self, cfg, workspace: Optional[str] = None, debug: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.debug = debug
        self.mesh = mesh_from_config(cfg)
        self.is_main = self.mesh is None or self.mesh.rank == 0
        if self.mesh is not None and str(device) == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        self.device = resolve_device(device)
        self.workspace = workspace or cfg.get("workspace") or "./workspace"
        os.makedirs(self.workspace, exist_ok=True)
        # one logger per workspace: create_logger attaches its file handler
        # once per logger name, so a shared name would send every later
        # trainer's log (e.g. eval after training) to the first workspace
        name = f"sparf_tpu_torch:{os.path.abspath(self.workspace)}"
        if self.is_main:
            self.logger = create_logger(os.path.join(self.workspace, "train.log"), name=name)
        else:
            self.logger = create_logger(None, name=f"{name}:rank{self.mesh.rank}")
            self.logger.setLevel("WARNING")
        self.writer = TensorboardWriter((cfg.get("tensorboard_dir")
                                         or os.path.join(self.workspace, "tb"))
                                        if self.is_main else None)
        self.timer = Timer()
        self.summary = SummaryBoard(last_n=cfg.log_steps)
        if debug:
            cfg.max_iter = min(cfg.max_iter, 10)
            cfg.vis_steps, cfg.log_steps = 2, 2
            cfg.val_steps, cfg.snapshot_steps = 5, 5
        if self.mesh is not None:
            self.logger.info(f"ray sharding over {self.mesh.world_size} ranks "
                             f"({self.mesh.backend})")

        seed = int(cfg.get("seed", 0))
        np.random.seed(seed)
        # parameter init and the per-step draws use separate generators
        self.init_generator = torch.Generator(device=self.device).manual_seed(2 * seed)
        self.draws = Draws(2 * seed + 1, self.device)

        with tracing.span("setup.scene"):
            self.load_dataset()
        with tracing.span("setup.networks"):
            self.build_networks()
        with tracing.span("setup.optimizer"):
            self.setup_optimizer()
            self.state, self.pose_constants = engine.init_train_state(
                self.init_generator, self.render_cfg, self.tx_nerf, self.device,
                pose_cfg=getattr(self, "pose_cfg", None),
                initial_poses_w2c=getattr(self, "initial_poses_w2c", None),
                tx_pose=getattr(self, "tx_pose", None))
            mesh_mod.replicate_tree([self.state.nerf_params, self.state.pose_params], self.mesh)
        with tracing.span("setup.pools"):
            self.define_loss_module()
        self.best_val = float("inf")
        self.epoch_of_best_val = 0
        self._step_cache: Dict[Tuple, Any] = {}
        self._lpips = None

    # ------------------------------------------------------------------ setup

    def load_dataset(self):
        cfg = self.cfg
        self.train_scene_np = create_dataset(cfg, "train")
        self.val_scene_np = create_dataset(cfg, "val")
        self.train_scene = scene_to_device(self.train_scene_np, self.device)
        self.val_scene = scene_to_device(self.val_scene_np, self.device)
        self.sampler = make_ray_sampler(cfg, self.train_scene_np, self.device)
        self.H, self.W = self.train_scene_np["image"].shape[-2:]
        self.n_train_views = self.train_scene_np["image"].shape[0]
        self.logger.info(f"loaded scene {self.train_scene_np.get('scene')} "
                         f"({self.n_train_views} train / {self.val_scene_np['image'].shape[0]} "
                         f"val views, {self.H}x{self.W}) on {self.device}")

    def build_networks(self):
        self.render_cfg = RenderConfig.from_config(self.cfg)
        # the inverse parametrization's sampling range, made on the device once: a
        # copy from the host at every step or frame would wait for the device's queue
        self.inverse_depth_range = (renderer_mod.render_depth_range(self.cfg, self.train_scene)
                                    if self.cfg.nerf.depth.param == "inverse" else None)
        # cfg.tpu.use_pallas picks the MLP (RenderConfig.mlp_impl), as the JAX
        # package's mlp_impl does: ops.fused_mlp (the CUDA kernels on a CUDA
        # device, their plain versions on the CPU), or nerf_mlp.nerf_apply in
        # torch ops (the JAX package's XLA MLP)
        self.logger.info(f"MLP: {self.render_cfg.mlp_impl} "
                         f"({self.render_cfg.mlp.compute_dtype}, {self.device})")

    def setup_optimizer(self):
        cfg = self.cfg
        self.lr_fn = engine.exponential_lr(cfg.optim.lr, cfg.optim.get("lr_end"), cfg.max_iter)
        clip = cfg.get("nerf_gradient_clipping") if cfg.get("clip_by_norm", True) else None
        self.tx_nerf = engine.make_optimizer(self.lr_fn, clip,
                                             int(cfg.get("grad_acc_steps", 1) or 1))

    def define_loss_module(self):
        """Photometric is always present; cfg.loss_type substrings add the others."""
        from sparf_tpu_torch.training.losses.factory import build_extra_loss_builders

        self.extra_loss_builders = build_extra_loss_builders(self)

    # -------------------------------------------------------------- schedules

    @property
    def iteration(self) -> int:
        return self.state.iteration

    def fine_enabled_at(self, iteration: int) -> bool:
        cfg = self.cfg
        if not cfg.nerf.fine_sampling:
            return False
        ratio = cfg.nerf.get("ratio_start_fine_sampling_at_x")
        return not (ratio is not None and iteration < cfg.max_iter * ratio)

    def optimize_poses_at(self, iteration: int) -> bool:
        return False

    def update_nerf_at(self, iteration: int) -> bool:
        return True

    def stage_signature(self, iteration: int) -> Tuple:
        return (iteration < self.cfg.get("precrop_iters", 0), self.fine_enabled_at(iteration),
                self.optimize_poses_at(iteration), self.update_nerf_at(iteration))

    def make_loss_builder(self, sample_in_center: bool, fine_enabled: bool):
        """All loss builders of a step, driven in lockstep rounds: each round
        renders every bundle the builders asked for."""
        cfg = self.cfg
        base = engine.default_photometric_loss_builder(cfg, self.train_scene, self.sampler,
                                                       sample_in_center=sample_in_center)
        builders = [base] + [mk(fine_enabled) for mk in self.extra_loss_builders]
        # a builder's span, by the module that defines it: loss.photometric,
        # loss.corres, loss.depth_cons, loss.colmap_depth
        spans = ["loss.photometric"] + ["loss." + mk.__module__.rsplit(".", 1)[-1]
                                        for mk in self.extra_loss_builders]
        render_cfg, scene = self.render_cfg, self.train_scene
        merge = merged_render(cfg)
        depth_range = self.depth_range(scene)

        def combined(nerf_params, poses_w2c, draws, iteration, progress):
            gens = [b(nerf_params, poses_w2c, draws, iteration, progress) for b in builders]
            results: Dict[int, Any] = {}
            pending: Dict[int, Any] = {}
            for i, g in enumerate(gens):
                try:
                    with tracing.span(spans[i]):
                        pending[i] = g.send(None)
                except StopIteration as e:
                    results[i] = e.value
            while pending:
                order = sorted(pending)
                outs = renderer_mod.render_bundles(
                    nerf_params, render_cfg, [bd for i in order for bd in pending[i]],
                    depth_range, progress, draws=draws, fine_enabled=fine_enabled,
                    merge=merge)
                nxt, ofs = {}, 0
                for i in order:
                    n_i = len(pending[i])
                    try:
                        with tracing.span(spans[i]):
                            nxt[i] = gens[i].send(outs[ofs: ofs + n_i])
                    except StopIteration as e:
                        results[i] = e.value
                    ofs += n_i
                pending = nxt
            loss_dict: Dict[str, Any] = {}
            stats: Dict[str, Any] = {}
            for i in range(len(builders)):
                ld, st = results[i]
                loss_dict.update(ld)
                stats.update(st)
            return loss_dict, stats

        return combined

    def get_step(self, iteration: int):
        sig = self.stage_signature(iteration)
        if sig not in self._step_cache:
            sample_in_center, fine_enabled, optimize_poses, update_nerf = sig
            self._step_cache[sig] = engine.make_train_step(
                self.cfg, self.make_loss_builder(sample_in_center, fine_enabled),
                tx_nerf=self.tx_nerf, tx_pose=getattr(self, "tx_pose", None),
                pose_cfg=getattr(self, "pose_cfg", None), pose_constants=self.pose_constants,
                scene=self.train_scene, optimize_poses=optimize_poses, update_nerf=update_nerf,
                mesh=self.mesh)
        return self._step_cache[sig]

    # ------------------------------------------------------------------- run

    def run(self, load_latest: bool = True):
        cfg = self.cfg
        if cfg.get("resume_snapshot"):
            # weights-only warm start from another run: parameters are taken,
            # the optimizers and the iteration start fresh
            self.load_weights_only(cfg.resume_snapshot)
        if load_latest:
            self.load_snapshot("latest")
        self.logger.info(f"training from iteration {self.iteration} to {cfg.max_iter} "
                         f"on {self.device}")
        t_start = t_last_log = time.time()
        it_last_log = it = self.iteration
        while it < cfg.max_iter:
            self.on_iteration_start(it)
            step = self.get_step(it)
            self.timer.add_prepare_time()
            self.state, stats = step(self.state, self.draws)
            it += 1
            if it % cfg.log_steps == 0 or it == 1:
                stats_np = {k: float(v) for k, v in stats.items() if v.numel() == 1}
                stats_np["lr"] = float(self.lr_fn(it))
                stats_np.update(self.make_results_dict_low_freq())
                self.timer.add_process_time()
                self.summary.update_from_dict(stats_np)
                self.writer.write_event("train", stats_np, it)
                now = time.time()
                its = (it - it_last_log) / max(now - t_last_log, 1e-9)
                t_last_log, it_last_log = now, it
                self.logger.info(
                    f"iter {it}/{cfg.max_iter} "
                    + " ".join(f"{k}={v:.4g}" for k, v in sorted(stats_np.items())
                               if k in ("all", "render", "corres", "depth_cons", "mse", "lr",
                                        "error_R", "error_t"))
                    + f" it/s={its:.1f}")
                self.timer.reset()
            if it % cfg.vis_steps == 0:
                self.visualize_train_view(it)
            if it % cfg.val_steps == 0:
                if self.is_main:
                    self.record_pose_history(it)
                self.validate(it)
            if it % cfg.snapshot_steps == 0:
                self.save_snapshot()
        self.logger.info(f"training done in {time.time() - t_start:.1f}s, "
                         f"{int(self.state.nan_count)} skipped non-finite updates")
        self.save_snapshot()
        if cfg.get("do_eval", True):
            self.validate(it)

    def on_iteration_start(self, iteration: int):
        pass

    def make_results_dict_low_freq(self) -> Dict[str, float]:
        return {}

    def visualize_train_view(self, iteration: int):
        """Render a random train view; log GT/render/error/depth panel
        (reference base.py:600-726 septych) and, for a pose-optimizing
        trainer, the optimized and GT frusta."""
        H, W = self.train_scene_np["image"].shape[-2:]
        idx = int(np.random.randint(self.n_train_views))
        out = self.render_full_image(self.train_scene, idx,
                                     self.current_poses_w2c()[idx: idx + 1].detach(),
                                     self.fine_enabled_at(iteration))
        out = {k: v[0].cpu().numpy() for k, v in out.items()}

        def head(sfx):
            return dict(pred_rgb=out["rgb" + sfx].reshape(H, W, 3),
                        pred_depth=out["depth" + sfx].reshape(H, W),
                        opacity=out["opacity" + sfx].reshape(H, W),
                        rgb_var=out["rgb_var" + sfx].reshape(H, W, -1).mean(-1)
                        if "rgb_var" + sfx in out else None,
                        depth_var=out["depth_var" + sfx].reshape(H, W)
                        if "depth_var" + sfx in out else None)

        panel = vis.render_panel(
            gt_rgb=self.train_scene_np["image"][idx].transpose(1, 2, 0),
            gt_depth=self.train_scene_np["depth_gt"][idx]
            if "depth_gt" in self.train_scene_np else None,
            fine_row=head("_fine") if "rgb_fine" in out else None, **head(""))
        self.writer.write_image("train", {f"render_view{idx}": panel}, iteration)
        if hasattr(self, "pose_cfg"):
            frusta = vis.plot_camera_frusta(
                [("optimized", self.current_poses_w2c().detach().cpu().numpy(), "tab:red"),
                 ("GT", self.train_scene_np["pose"], "tab:blue")],
                title=f"iter {iteration}")
            self.writer.write_image("train", {"poses": frusta}, iteration)

    def record_pose_history(self, iteration: int):
        """Append the current pose estimates to workspace/pose_history.npz, as
        (iteration, N x 3 x 4 w2c) entries. Only pose-optimizing trainers record."""
        if not hasattr(self, "pose_cfg"):
            return
        path = os.path.join(self.workspace, "pose_history.npz")
        iters: List[int] = []
        poses: List[np.ndarray] = []
        if os.path.exists(path):
            with np.load(path) as z:
                iters, poses = list(z["iters"]), list(z["poses"])
        if iters and int(iters[-1]) == int(iteration):
            return
        iters.append(int(iteration))
        poses.append(self.current_poses_w2c().detach().cpu().numpy().astype(np.float32))
        np.savez(path, iters=np.asarray(iters), poses=np.stack(poses))

    def current_poses_w2c(self, state: Optional[engine.TrainState] = None) -> torch.Tensor:
        """Current w2c estimates of the train views (GT here)."""
        return self.train_scene["pose"]

    # ------------------------------------------------------------ validation

    def progress(self) -> float:
        """PE progress of the current parameters; it travels with the
        snapshot as iteration_nerf."""
        if self.cfg.get("barf_c2f") is None:
            return 1.0
        return min(1.0, int(self.state.iteration_nerf) / self.cfg.max_iter)

    def depth_range(self, scene: Dict[str, Any]) -> torch.Tensor:
        """renderer.render_depth_range of `scene`, with no copy from the host."""
        if self.inverse_depth_range is not None:
            return self.inverse_depth_range
        return renderer_mod.render_depth_range(self.cfg, scene)

    def render_full_image(self, scene: Dict[str, Any], idx: int, pose: torch.Tensor,
                          fine_enabled: bool) -> Dict[str, torch.Tensor]:
        H, W = scene["image"].shape[-2:]
        with tracing.span("frame"):
            return renderer_mod.render_image_chunked(
                self.state.nerf_params, self.render_cfg, pose, scene["intr"][idx: idx + 1], H,
                W, self.depth_range(scene), self.progress(),
                fine_enabled=fine_enabled, chunk=self.cfg.nerf.rand_rays, mesh=self.mesh)

    def val_pose_and_scale(self, idx: int) -> Tuple[torch.Tensor, float]:
        """w2c pose used to render val image idx, and the depth scaling factor."""
        return self.val_scene["pose"][idx: idx + 1], 1.0

    def render_full_val_image(self, idx: int, fine_enabled: bool) -> Dict[str, torch.Tensor]:
        pose, _ = self.val_pose_and_scale(idx)
        return self.render_full_image(self.val_scene, idx, pose, fine_enabled)

    def get_lpips(self):
        if self._lpips is None:
            from sparf_tpu_torch.training.lpips import LPIPS

            self._lpips = LPIPS()
        return self._lpips

    @staticmethod
    def _gt_of(scene: Dict[str, Any], idx: int) -> Dict[str, Optional[torch.Tensor]]:
        """The reference maps of view idx that the metrics take."""
        return dict(
            depth_gt=scene["depth_gt"][idx: idx + 1].reshape(1, -1, 1)
            if "depth_gt" in scene else None,
            valid_depth_gt=scene["valid_depth_gt"][idx: idx + 1].reshape(1, -1)
            if "valid_depth_gt" in scene else None,
            fg_mask=scene["fg_mask"][idx: idx + 1] if "fg_mask" in scene else None)

    @staticmethod
    def _mean(results: List[Dict[str, float]]) -> Dict[str, float]:
        """Per-key means, leaving out keys whose mean is NaN."""
        mean = {k: float(np.mean([r[k] for r in results])) for k in results[0]} if results else {}
        return {k: v for k, v in mean.items() if not np.isnan(v)}

    def validate(self, iteration: int) -> Dict[str, float]:
        """Full-image renders over the val split (the first 2 views in debug
        runs) with the full metric set (PSNR/SSIM/LPIPS + masked + depth,
        coarse and _fine), and best-model tracking by -PSNR of the finest head."""
        H, W = self.val_scene_np["image"].shape[-2:]
        n = self.val_scene_np["image"].shape[0]
        if self.debug:
            n = min(n, 2)
        fine_enabled = self.fine_enabled_at(iteration)
        lpips = self.get_lpips()
        results = []
        for idx in range(n):
            out = self.render_full_val_image(idx, fine_enabled)
            gt = self.val_scene["image"][idx: idx + 1]
            refs = self._gt_of(self.val_scene, idx)

            def metrics_of(key, dkey, suffix):
                pred = out[key].reshape(1, H, W, 3).permute(0, 3, 1, 2)
                return metrics_mod.compute_metrics(pred, gt, pred_depth=out[dkey].reshape(1, -1, 1),
                                                   lpips_fn=lpips, suffix=suffix, **refs)

            res = metrics_of("rgb", "depth", "")
            if "rgb_fine" in out:
                res.update(metrics_of("rgb_fine", "depth_fine", "_fine"))
            results.append(res)
        mean = self._mean(results)
        self.writer.write_event("val", mean, iteration)
        self.logger.info(f"validation @ {iteration}: "
                         + " ".join(f"{k}={v:.3f}" for k, v in mean.items()))
        val_score = -mean.get("psnr_fine", mean.get("psnr", 0.0))
        if val_score < self.best_val:
            self.best_val = val_score
            self.epoch_of_best_val = iteration
            self.save_snapshot(is_best=True)
        return mean

    # ------------------------------------------------------------ evaluation

    def evaluate_full(self, save_ind_files: bool = False, out_dir: Optional[str] = None,
                      plot: bool = False) -> Dict:
        """Test-split evaluation with depth and masked metrics, written as
        JSON to out_dir/<expname>.json; `plot` saves a qualitative panel per
        test image (plots/eval_NNN.png), `save_ind_files` its render and
        colorized depth (renders/<name>_pred.png, _depth.png)."""
        cfg = self.cfg
        test_scene_np = create_dataset(cfg, "test")
        test_scene = scene_to_device(test_scene_np, self.device)
        H, W = test_scene_np["image"].shape[-2:]
        fine_enabled = self.fine_enabled_at(self.iteration)
        lpips = self.get_lpips()
        per_image = []
        for idx in range(test_scene_np["image"].shape[0]):
            pose, depth_scale = self.test_pose_and_scale(test_scene, idx)
            out = self.render_full_image(test_scene, idx, pose, fine_enabled)
            key = "rgb_fine" if "rgb_fine" in out else "rgb"
            dkey = "depth_fine" if "depth_fine" in out else "depth"
            pred_rgb = out[key].reshape(1, H, W, 3).permute(0, 3, 1, 2)
            gt_rgb = test_scene["image"][idx: idx + 1]
            res = metrics_mod.compute_metrics(
                pred_rgb, gt_rgb, pred_depth=out[dkey].reshape(1, -1, 1), lpips_fn=lpips,
                scaling_factor_for_pred_depth=depth_scale, **self._gt_of(test_scene, idx))
            refine = getattr(self, "_last_refine", None)
            if refine is not None:
                # what test-time pose refinement bought on this view: how far it
                # moved the pose, and the PSNR against a render at the unrefined
                # (backtracked GT) pose
                res["refine_rot_deg"] = refine["rot_deg"]
                res["refine_trans"] = refine["trans"]
                out_pre = self.render_full_image(test_scene, idx, refine["pose_pre"],
                                                 fine_enabled)
                pre_rgb = out_pre[key].reshape(1, H, W, 3).permute(0, 3, 1, 2)
                mse_pre = float(torch.mean((pre_rgb - gt_rgb) ** 2))
                res["psnr_no_refine"] = -10.0 * np.log10(max(mse_pre, 1e-12))
                res["refine_psnr_delta"] = res["psnr"] - res["psnr_no_refine"]
            per_image.append(res)
            pred_hwc = pred_rgb[0].permute(1, 2, 0).cpu().numpy()
            depth_hw = out[dkey].reshape(H, W).cpu().numpy()
            if plot and self.is_main:
                pdir = os.path.join(out_dir or self.workspace, "plots")
                os.makedirs(pdir, exist_ok=True)
                panel = vis.render_panel(
                    gt_rgb=test_scene_np["image"][idx].transpose(1, 2, 0), pred_rgb=pred_hwc,
                    pred_depth=depth_hw,
                    opacity=out["opacity_fine" if "opacity_fine" in out else "opacity"]
                    .reshape(H, W).cpu().numpy(),
                    gt_depth=test_scene_np["depth_gt"][idx] if "depth_gt" in test_scene_np
                    else None)
                imgproc.write_png(os.path.join(pdir, f"eval_{idx:03d}.png"), panel)
            if save_ind_files and self.is_main:
                # per-image renders (reference save_ind_files, base.py:506-597)
                rdir = os.path.join(out_dir or self.workspace, "renders")
                os.makedirs(rdir, exist_ok=True)
                name = test_scene_np.get("rgb_path", [f"{i:03d}" for i in range(999)])[idx]
                stem = os.path.splitext(os.path.basename(str(name)))[0]
                imgproc.write_png(os.path.join(rdir, f"{stem}_pred.png"), pred_hwc)
                imgproc.write_png(os.path.join(rdir, f"{stem}_depth.png"), vis.colorize(depth_hw))
        mean: Dict[str, Any] = self._mean(per_image)
        mean["iteration"] = self.iteration
        mean["lpips_tag"] = lpips.weight_tag
        result = {"mean": mean, "per_image": per_image}
        self.write_eval_json(result, out_dir)
        self.logger.info("eval: " + " ".join(f"{k}={v:.4g}" for k, v in mean.items()
                                             if isinstance(v, float)))
        return result

    def write_eval_json(self, result: Dict, out_dir: Optional[str] = None) -> Optional[str]:
        if not self.is_main:
            return None
        out_dir = out_dir or self.workspace
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{self.cfg.get('expname', 'eval')}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=2, default=float)
        return path

    def test_pose_and_scale(self, test_scene, idx: int) -> Tuple[torch.Tensor, float]:
        return test_scene["pose"][idx: idx + 1], 1.0

    # ---------------------------------------------------------- checkpointing

    def save_snapshot(self, is_best: bool = False):
        if not self.is_main:
            return
        path = checkpointing.save_snapshot(self.workspace, self.state, self.best_val,
                                           self.epoch_of_best_val, is_best=is_best)
        self.logger.info(f"saved snapshot {os.path.basename(path)}"
                         + (" and model_best" if is_best else ""))

    def load_weights_only(self, snapshot_path: str) -> bool:
        """Warm start: take the NeRF and pose parameters of a snapshot, keep
        fresh optimizers and iteration 0. Without c2f the PE progress counts
        as converged (iteration_nerf = max_iter)."""
        workspace, which = os.path.split(os.path.abspath(snapshot_path))
        loaded = checkpointing.load_snapshot(workspace, self.state, which)
        if loaded is None:
            self.logger.warning(f"resume_snapshot: nothing at {snapshot_path}")
            return False
        other, meta = loaded
        self.state = dataclasses.replace(
            self.state, nerf_params=other.nerf_params, pose_params=other.pose_params,
            iteration_nerf=(int(self.cfg.max_iter) if self.cfg.get("barf_c2f") is None
                            else other.iteration_nerf))
        self.logger.info(f"warm-started weights from {snapshot_path} (iter {meta['iteration']})")
        return True

    def load_snapshot(self, which: str = "latest") -> bool:
        loaded = checkpointing.load_snapshot(self.workspace, self.state, which)
        if loaded is None:
            return False
        self.state, meta = loaded
        self.best_val = meta["best_val"]
        self.epoch_of_best_val = meta["epoch_of_best_val"]
        self.logger.info(f"resumed from snapshot at iteration {meta['iteration']}")
        return True
