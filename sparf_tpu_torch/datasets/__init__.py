"""Datasets of the port: `synthetic` uses the port's camera; every other
dataset comes from the shared registry of sparf_tpu.datasets."""
from __future__ import annotations

from typing import Any, Dict

from sparf_tpu.datasets import base
from sparf_tpu.datasets.registry import create_dataset as _create_shared


def create_dataset(cfg, mode: str = "train") -> base.Scene:
    """Load the whole scene of one split as stacked numpy arrays."""
    if cfg.dataset != "synthetic":
        return _create_shared(cfg, mode)
    from sparf_tpu_torch.datasets.synthetic import load_synthetic_scene

    kw: Dict[str, Any] = dict(cfg.get("synthetic", {}))
    return load_synthetic_scene(
        scene=cfg.get("scene") or "spheres",
        split=mode,
        train_sub=cfg.get("train_sub"),
        val_sub=cfg.get("val_sub"),
        increase_depth_range_by_x_percent=cfg.get("increase_depth_range_by_x_percent", 0.0),
        **kw,
    )
