"""Dataset registry of the port (reference source/datasets/create_dataset.py:103-143).

`synthetic` renders its views with the port's camera; `llff`, `dtu` and
`replica` are the port's own copies of the numpy loaders, decoding their
images with utils/imgproc.py (PNG and baseline JPEG) instead of
imageio/OpenCV, and replica's far-plane rays with the port's camera.
"""
from __future__ import annotations

from typing import Any, Dict

from sparf_tpu_torch.datasets import base


def _load_llff(cfg, split: str) -> base.Scene:
    from sparf_tpu_torch.datasets.llff import load_llff_scene

    return load_llff_scene(
        root=cfg.env.llff,
        scene=cfg.scene,
        split=split,
        train_sub=cfg.get("train_sub"),
        val_sub=cfg.get("val_sub"),
        llffhold=cfg.get("llffhold", 8),
        img_factor=cfg.get("llff_img_factor", 8),
        resize=cfg.get("resize"),
        crop_ratio=cfg.get("crop_ratio"),
        increase_depth_range_by_x_percent=cfg.get("increase_depth_range_by_x_percent", 0.0),
    )


def _load_dtu(cfg, split: str) -> base.Scene:
    from sparf_tpu_torch.datasets.dtu import load_dtu_scene

    return load_dtu_scene(
        root=cfg.env.dtu,
        scene=cfg.scene,
        split=split,
        train_sub=cfg.get("train_sub"),
        val_sub=cfg.get("val_sub"),
        split_type=cfg.get("dtu_split_type", "pixelnerf"),
        mask_root=cfg.env.get("dtu_mask"),
        depth_root=cfg.env.get("dtu_depth"),
        resize=cfg.get("resize"),
        crop_ratio=cfg.get("crop_ratio"),
        mask_img=cfg.get("mask_img", False),
        increase_depth_range_by_x_percent=cfg.get("increase_depth_range_by_x_percent", 0.0),
    )


def _load_replica(cfg, split: str) -> base.Scene:
    from sparf_tpu_torch.datasets.replica import load_replica_scene

    return load_replica_scene(
        root=cfg.env.replica,
        scene=cfg.scene,
        split=split,
        train_sub=cfg.get("train_sub"),
        val_sub=cfg.get("val_sub"),
        resize=cfg.get("resize"),
        increase_depth_range_by_x_percent=cfg.get("increase_depth_range_by_x_percent", 0.0),
    )


def _load_synthetic(cfg, split: str) -> base.Scene:
    from sparf_tpu_torch.datasets.synthetic import load_synthetic_scene

    kw: Dict[str, Any] = dict(cfg.get("synthetic", {}))
    return load_synthetic_scene(
        scene=cfg.get("scene") or "spheres",
        split=split,
        train_sub=cfg.get("train_sub"),
        val_sub=cfg.get("val_sub"),
        increase_depth_range_by_x_percent=cfg.get("increase_depth_range_by_x_percent", 0.0),
        **kw,
    )


dataset_dict = {
    "llff": _load_llff,
    "dtu": _load_dtu,
    "replica": _load_replica,
    "synthetic": _load_synthetic,
}


def create_dataset(cfg, mode: str = "train") -> base.Scene:
    """Load the whole scene of one split as stacked numpy arrays."""
    name = cfg.dataset
    if name not in dataset_dict:
        raise ValueError(f"unknown dataset {name!r}; available: {sorted(dataset_dict)}")
    return dataset_dict[name](cfg, mode)
