"""Experiment presets — 1:1 counterparts of the reference's 18
train_settings/**.py files, addressed as '<module>/<dataset>' + '<name>'
(reference run_trainval.py imports train_settings.<module>.<name>.get_config).

Also adds `synthetic` variants (the built-in analytic scene) for smoke/golden
runs without external data.
"""
from __future__ import annotations

from typing import Callable, Dict

from sparf_tpu_torch.configs.config import ConfigDict, override_options
from sparf_tpu_torch.configs.default import (
    get_fixed_colmap_poses_default_config_360_data,
    get_joint_pose_nerf_default_config_360_data,
    get_joint_pose_nerf_default_config_llff,
    get_nerf_default_config_360_data,
    get_nerf_default_config_llff,
)

PRESETS: Dict[str, Callable[[], ConfigDict]] = {}


def register(path: str):
    def deco(fn):
        PRESETS[path] = fn
        return fn

    return deco


def get_config(train_module: str, train_name: str) -> ConfigDict:
    """train_module like 'joint_pose_nerf_training/dtu', train_name like 'sparf'."""
    path = f"{train_module}/{train_name}"
    if path not in PRESETS:
        raise ValueError(f"unknown preset {path!r}; available:\n  " + "\n  ".join(sorted(PRESETS)))
    return PRESETS[path]()


# ---------------------------------------------------------------------------
# helpers shared by the sparf presets
# ---------------------------------------------------------------------------


def _sparf_losses(corres_w: float, depth_cons_w: float) -> ConfigDict:
    return ConfigDict(
        use_flow=True,
        flow_backbone="PDCNet",
        loss_type="photometric_and_corres_and_depth_cons",
        matching_pair_generation="all_to_all",
        gradually_decrease_corres_weight=True,
        loss_weight=ConfigDict(render=0.0, corres=corres_w, depth_cons=depth_cons_w),
    )


# ---------------------------------------------------------------------------
# joint_pose_nerf_training (the SPARF main use case)
# ---------------------------------------------------------------------------


@register("joint_pose_nerf_training/dtu/sparf")
def _():
    cfg = get_joint_pose_nerf_default_config_360_data()
    over = ConfigDict(
        camera=ConfigDict(initial_pose="noisy_gt", noise=0.15),
        first_joint_pose_nerf_then_nerf=True,
        ratio_end_joint_nerf_pose_refinement=0.3,
        barf_c2f=[0.4, 0.7],
        dataset="dtu",
        resize=None,
        nerf=ConfigDict(depth=ConfigDict(param="metric"), fine_sampling=True,
                        ratio_start_fine_sampling_at_x=0.3),
        ratio_start_decrease_corres_weight=0.3,
        corres_weight_reduct_at_x_iter=10000,
    )
    over = override_options(over, _sparf_losses(-3.0, -3.0))
    return override_options(cfg, over)


@register("joint_pose_nerf_training/dtu/sparf_wo_depth_cons_loss")
def _():
    cfg = PRESETS["joint_pose_nerf_training/dtu/sparf"]()
    cfg.loss_type = "photometric_and_corres"
    cfg.loss_weight.depth_cons = None
    return cfg


@register("joint_pose_nerf_training/dtu/barf")
def _():
    cfg = get_joint_pose_nerf_default_config_360_data()
    over = ConfigDict(
        camera=ConfigDict(initial_pose="noisy_gt", noise=0.15),
        barf_c2f=[0.4, 0.7],
        dataset="dtu",
        resize=None,
        nerf=ConfigDict(depth=ConfigDict(param="metric"), fine_sampling=True),
        loss_type="photometric",
        loss_weight=ConfigDict(render=0),
    )
    return override_options(cfg, over)


@register("joint_pose_nerf_training/llff/sparf")
def _():
    cfg = get_joint_pose_nerf_default_config_llff()
    over = ConfigDict(
        camera=ConfigDict(initial_pose="identity"),
        first_joint_pose_nerf_then_nerf=True,
        ratio_end_joint_nerf_pose_refinement=0.3,
        barf_c2f=[0.4, 0.7],
        start_iter=ConfigDict(corres=1000, depth_cons=1000),
        dataset="llff",
        resize=None,
        llff_img_factor=8,
    )
    over = override_options(over, _sparf_losses(-3.0, -3.0))
    over.gradually_decrease_corres_weight = False
    return override_options(cfg, over)


@register("joint_pose_nerf_training/llff/sparf_wo_depth_cons_loss")
def _():
    cfg = PRESETS["joint_pose_nerf_training/llff/sparf"]()
    cfg.loss_type = "photometric_and_corres"
    cfg.loss_weight.depth_cons = None
    return cfg


@register("joint_pose_nerf_training/llff/barf")
def _():
    cfg = get_joint_pose_nerf_default_config_llff()
    over = ConfigDict(
        camera=ConfigDict(initial_pose="identity"),
        barf_c2f=[0.4, 0.7],
        dataset="llff",
        resize=None,
        llff_img_factor=8,
        loss_type="photometric",
        loss_weight=ConfigDict(render=0),
    )
    return override_options(cfg, over)


@register("joint_pose_nerf_training/replica/sparf")
def _():
    cfg = get_joint_pose_nerf_default_config_360_data()
    over = ConfigDict(
        camera=ConfigDict(initial_pose="sfm_pdcnet"),
        first_joint_pose_nerf_then_nerf=True,
        ratio_end_joint_nerf_pose_refinement=0.25,
        barf_c2f=[0.4, 0.7],
        dataset="replica",
        resize=[340, 600],
        nerf=ConfigDict(depth=ConfigDict(param="metric"), fine_sampling=True,
                        ratio_start_fine_sampling_at_x=0.25),
        filter_corr_w_cc=True,
        ratio_start_decrease_corres_weight=0.25,
        corres_weight_reduct_at_x_iter=10000,
    )
    over = override_options(over, _sparf_losses(-3.0, -3.0))
    return override_options(cfg, over)


@register("joint_pose_nerf_training/replica/sparf_wo_depth_cons_loss")
def _():
    cfg = PRESETS["joint_pose_nerf_training/replica/sparf"]()
    cfg.loss_type = "photometric_and_corres"
    cfg.loss_weight.depth_cons = None
    return cfg


@register("joint_pose_nerf_training/replica/barf")
def _():
    cfg = get_joint_pose_nerf_default_config_360_data()
    over = ConfigDict(
        camera=ConfigDict(initial_pose="sfm_pdcnet"),
        barf_c2f=[0.4, 0.7],
        dataset="replica",
        resize=[340, 600],
        nerf=ConfigDict(depth=ConfigDict(param="metric"), fine_sampling=True),
        loss_type="photometric",
        loss_weight=ConfigDict(render=0),
    )
    return override_options(cfg, over)


@register("joint_pose_nerf_training/synthetic/sparf")
def _():
    cfg = PRESETS["joint_pose_nerf_training/dtu/sparf"]()
    cfg.dataset = "synthetic"
    cfg.camera.initial_pose = "noisy_gt"
    cfg.camera.noise = 0.15
    return cfg


@register("joint_pose_nerf_training/synthetic/barf")
def _():
    cfg = PRESETS["joint_pose_nerf_training/dtu/barf"]()
    cfg.dataset = "synthetic"
    return cfg


# ---------------------------------------------------------------------------
# nerf_training_w_gt_poses
# ---------------------------------------------------------------------------


@register("nerf_training_w_gt_poses/dtu/sparf")
def _():
    cfg = get_nerf_default_config_360_data()
    over = ConfigDict(
        dataset="dtu",
        resize=None,
        barf_c2f=[0.1, 0.5],
        nerf=ConfigDict(depth=ConfigDict(param="metric"), fine_sampling=True),
        filter_corr_w_cc=True,
    )
    over = override_options(over, _sparf_losses(-4.0, -3.0))
    return override_options(cfg, over)


@register("nerf_training_w_gt_poses/dtu/nerf")
def _():
    cfg = get_nerf_default_config_360_data()
    over = ConfigDict(
        dataset="dtu",
        resize=None,
        barf_c2f=None,
        nerf=ConfigDict(depth=ConfigDict(param="metric"), fine_sampling=True),
        loss_type="photometric",
        loss_weight=ConfigDict(render=0),
    )
    return override_options(cfg, over)


@register("nerf_training_w_gt_poses/llff/nerf")
def _():
    cfg = get_nerf_default_config_llff()
    over = ConfigDict(
        barf_c2f=None,
        nerf=ConfigDict(fine_sampling=True),
        dataset="llff",
        resize=None,
        llff_img_factor=8,
        loss_type="photometric",
        loss_weight=ConfigDict(render=0),
    )
    return override_options(cfg, over)


@register("nerf_training_w_gt_poses/llff/nerf_coarse")
def _():
    cfg = PRESETS["nerf_training_w_gt_poses/llff/nerf"]()
    cfg.nerf.fine_sampling = False
    return cfg


@register("nerf_training_w_gt_poses/llff/sparf")
def _():
    cfg = get_nerf_default_config_llff()
    over = ConfigDict(
        dataset="llff",
        resize=None,
        llff_img_factor=8,
        barf_c2f=[0.1, 0.5],
        nerf=ConfigDict(fine_sampling=True),
    )
    over = override_options(over, _sparf_losses(-3.0, -3.0))
    return override_options(cfg, over)


@register("nerf_training_w_gt_poses/llff/sparf_coarse")
def _():
    cfg = PRESETS["nerf_training_w_gt_poses/llff/sparf"]()
    cfg.nerf.fine_sampling = False
    return cfg


@register("nerf_training_w_gt_poses/replica/sparf")
def _():
    cfg = get_nerf_default_config_360_data()
    over = ConfigDict(
        dataset="replica",
        resize=[340, 600],
        barf_c2f=[0.1, 0.5],
        nerf=ConfigDict(depth=ConfigDict(param="metric"), fine_sampling=True),
        filter_corr_w_cc=True,
    )
    over = override_options(over, _sparf_losses(-3.0, -3.0))
    return override_options(cfg, over)


@register("nerf_training_w_gt_poses/replica/nerf")
def _():
    cfg = get_nerf_default_config_360_data()
    over = ConfigDict(
        dataset="replica",
        resize=[340, 600],
        barf_c2f=None,
        nerf=ConfigDict(depth=ConfigDict(param="metric"), fine_sampling=True),
        loss_type="photometric",
        loss_weight=ConfigDict(render=0),
    )
    return override_options(cfg, over)


@register("nerf_training_w_gt_poses/synthetic/nerf")
def _():
    cfg = get_nerf_default_config_360_data()
    over = ConfigDict(
        dataset="synthetic",
        barf_c2f=None,
        nerf=ConfigDict(depth=ConfigDict(param="metric"), fine_sampling=True),
        loss_type="photometric",
        loss_weight=ConfigDict(render=0),
    )
    return override_options(cfg, over)


@register("nerf_training_w_gt_poses/synthetic/sparf")
def _():
    cfg = PRESETS["nerf_training_w_gt_poses/dtu/sparf"]()
    cfg.dataset = "synthetic"
    return cfg


# ---------------------------------------------------------------------------
# nerf_fixed_noisy_poses (ablation: frozen COLMAP-initialized poses)
# ---------------------------------------------------------------------------


@register("nerf_fixed_noisy_poses/replica/sparf")
def _():
    cfg = get_fixed_colmap_poses_default_config_360_data()
    over = ConfigDict(
        dataset="replica",
        resize=[340, 600],
        barf_c2f=[0.1, 0.5],
        nerf=ConfigDict(depth=ConfigDict(param="metric"), fine_sampling=True),
        filter_corr_w_cc=True,
    )
    over = override_options(over, _sparf_losses(-3.0, -3.0))
    return override_options(cfg, over)


@register("nerf_fixed_noisy_poses/synthetic/sparf")
def _():
    cfg = PRESETS["nerf_fixed_noisy_poses/replica/sparf"]()
    cfg.dataset = "synthetic"
    cfg.camera.initial_pose = "noisy_gt"
    cfg.camera.noise = 0.15
    return cfg


# ---------------------------------------------------------------------------
# max_iter schedule (define_trainer.py:40-77)
# ---------------------------------------------------------------------------


def apply_max_iter_schedule(cfg: ConfigDict) -> ConfigDict:
    dataset = cfg.get("dataset") or ""
    sub = cfg.get("train_sub")
    if cfg.model != "joint_pose_nerf_training":
        if "dtu" in dataset or "replica" in dataset:
            cfg.max_iter = {3: 50000, 6: 100000, 9: 150000}.get(sub, cfg.max_iter)
        elif "llff" in dataset:
            cfg.max_iter = {3: 70000, 6: 140000, 9: 200000}.get(sub, cfg.max_iter)
    else:
        if "dtu" in dataset or "replica" in dataset:
            cfg.max_iter = {2: 60000, 3: 100000, 6: 150000}.get(sub, 200000)
        elif "llff" in dataset:
            cfg.max_iter = {2: 60000, 3: 100000, 6: 170000}.get(sub, 220000)
    if dataset == "dtu" and cfg.get("scene"):
        cfg.seed = int(str(cfg.scene).split("scan")[-1])
    return cfg
