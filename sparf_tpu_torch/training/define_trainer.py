"""Trainer factory (torch port of sparf_tpu/training/define_trainer.py)."""
from __future__ import annotations

from typing import Optional

from sparf_tpu_torch.configs.config import ConfigDict, override_options, save_options_file
from sparf_tpu_torch.configs.presets import apply_max_iter_schedule, get_config


def build_config(train_module: str, train_name: str,
                 overrides: Optional[dict] = None) -> ConfigDict:
    """The preset `train_module/train_name` with `overrides` (nested dict) merged in."""
    cfg = get_config(train_module, train_name)
    return override_options(cfg, ConfigDict(overrides)) if overrides else cfg


def define_trainer(cfg: ConfigDict, workspace: Optional[str] = None, debug: bool = False,
                   save_option: bool = True, device="cuda"):
    import torch.distributed as dist

    cfg = apply_max_iter_schedule(cfg)
    if save_option and workspace and not (dist.is_initialized() and dist.get_rank() != 0):
        save_options_file(cfg, workspace)
    if cfg.model == "nerf_gt_poses":
        from sparf_tpu_torch.training.trainer import NerfTrainerPerScene

        return NerfTrainerPerScene(cfg, workspace=workspace, debug=debug, device=device)
    if cfg.model == "joint_pose_nerf_training":
        from sparf_tpu_torch.training.joint_trainer import PoseAndNerfTrainerPerScene

        return PoseAndNerfTrainerPerScene(cfg, workspace=workspace, debug=debug, device=device)
    if cfg.model == "nerf_fixed_noisy_poses":
        from sparf_tpu_torch.training.joint_trainer import NerfTrainerPerSceneWColmapFixedPoses

        return NerfTrainerPerSceneWColmapFixedPoses(cfg, workspace=workspace, debug=debug,
                                                    device=device)
    raise NotImplementedError(f"model {cfg.model!r} is not ported to sparf_tpu_torch yet")
