"""Per-scene trainer, training loop only (torch port of sparf_tpu/training/trainer.py).

The Python loop feeds the step counter, picks the step of the current stage
(precrop window, fine sampling, pose optimization) and logs. Validation,
snapshots and visualisation are not ported yet.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sparf_tpu.training.logging_utils import SummaryBoard, TensorboardWriter, Timer, create_logger
from sparf_tpu_torch.datasets import create_dataset
from sparf_tpu_torch.models import renderer as renderer_mod
from sparf_tpu_torch.models.renderer import RenderConfig
from sparf_tpu_torch.training import engine
from sparf_tpu_torch.training.sampling import make_ray_sampler
from sparf_tpu_torch.utils.draws import Draws


def resolve_device(device) -> torch.device:
    """The training device; "cuda" without a visible GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return device


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
        self.device = resolve_device(device)
        self.workspace = workspace or cfg.get("workspace") or "./workspace"
        os.makedirs(self.workspace, exist_ok=True)
        self.logger = create_logger(os.path.join(self.workspace, "train.log"),
                                    name="sparf_tpu_torch")
        self.writer = TensorboardWriter(cfg.get("tensorboard_dir")
                                        or os.path.join(self.workspace, "tb"))
        self.timer = Timer()
        self.summary = SummaryBoard(last_n=cfg.log_steps)
        if debug:
            cfg.max_iter = min(cfg.max_iter, 10)
            cfg.vis_steps, cfg.log_steps = 2, 2
            cfg.val_steps, cfg.snapshot_steps = 5, 5
        if cfg.tpu.get("mesh_shape"):
            raise NotImplementedError("multi-device training is not ported yet")
        if int(cfg.get("grad_acc_steps", 1) or 1) > 1:
            raise NotImplementedError("gradient accumulation is not ported yet")

        seed = int(cfg.get("seed", 0))
        np.random.seed(seed)
        # parameter init and the per-step draws use separate generators
        self.init_generator = torch.Generator(device=self.device).manual_seed(2 * seed)
        self.draws = Draws(2 * seed + 1, self.device)

        self.load_dataset()
        self.build_networks()
        self.setup_optimizer()
        self.state, self.pose_constants = engine.init_train_state(
            self.init_generator, self.render_cfg, self.tx_nerf, self.device,
            pose_cfg=getattr(self, "pose_cfg", None),
            initial_poses_w2c=getattr(self, "initial_poses_w2c", None),
            tx_pose=getattr(self, "tx_pose", None))
        self.define_loss_module()
        self._step_cache: Dict[Tuple, Any] = {}

    # ------------------------------------------------------------------ setup

    def load_dataset(self):
        cfg = self.cfg
        self.train_scene_np = create_dataset(cfg, "train")
        self.train_scene = scene_to_device(self.train_scene_np, self.device)
        self.sampler = make_ray_sampler(cfg, self.train_scene_np, self.device)
        self.H, self.W = self.train_scene_np["image"].shape[-2:]
        self.n_train_views = self.train_scene_np["image"].shape[0]
        self.logger.info(f"loaded scene {self.train_scene_np.get('scene')} "
                         f"({self.n_train_views} train views, {self.H}x{self.W}) "
                         f"on {self.device}")

    def build_networks(self):
        self.render_cfg = RenderConfig.from_config(self.cfg)
        # the MLP always runs through ops.fused_mlp: the CUDA kernels on a CUDA
        # device, their plain versions on the CPU
        if self.device.type == "cuda" and not self.cfg.tpu.get("use_pallas", True):
            raise NotImplementedError("the port runs the MLP through its CUDA kernels; "
                                      "cfg.tpu.use_pallas=False has no CUDA path")

    def setup_optimizer(self):
        cfg = self.cfg
        self.lr_fn = engine.exponential_lr(cfg.optim.lr, cfg.optim.get("lr_end"), cfg.max_iter)
        clip = cfg.get("nerf_gradient_clipping") if cfg.get("clip_by_norm", True) else None
        self.tx_nerf = engine.Adam(self.lr_fn, clip)

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
        render_cfg, scene = self.render_cfg, self.train_scene
        merge = bool(cfg.tpu.get("merged_render", False)) and not cfg.nerf.density_noise_reg

        def combined(nerf_params, poses_w2c, draws, iteration, progress):
            depth_range = renderer_mod.render_depth_range(cfg, scene)
            gens = [b(nerf_params, poses_w2c, draws, iteration, progress) for b in builders]
            results: Dict[int, Any] = {}
            pending: Dict[int, Any] = {}
            for i, g in enumerate(gens):
                try:
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
                scene=self.train_scene, optimize_poses=optimize_poses, update_nerf=update_nerf)
        return self._step_cache[sig]

    # ------------------------------------------------------------------- run

    def run(self):
        cfg = self.cfg
        self.logger.info(f"training from iteration {self.iteration} to {cfg.max_iter} "
                         f"on {self.device}")
        self.logger.info("validation, snapshots and visualisation are not ported to "
                         "sparf_tpu_torch yet: this run trains and logs only")
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
        self.logger.info(f"training done in {time.time() - t_start:.1f}s, "
                         f"{int(self.state.nan_count)} skipped non-finite updates")

    def on_iteration_start(self, iteration: int):
        pass

    def make_results_dict_low_freq(self) -> Dict[str, float]:
        return {}

    def current_poses_w2c(self, state: Optional[engine.TrainState] = None) -> torch.Tensor:
        """Current w2c estimates of the train views (GT here)."""
        return self.train_scene["pose"]
