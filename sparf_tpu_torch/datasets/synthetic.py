"""The synthetic analytic scene (ray-traced textured spheres with exact GT
depth), with the port's own camera for ray generation.

`ray_trace`, `look_at_pose_w2c` and `apply_photometric_perturbation` are the
JAX package's numpy functions, reused as they are; only `render_view` (which
calls the camera) and the loader that uses it are defined here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sparf_tpu.datasets import base
from sparf_tpu.datasets.synthetic import (  # noqa: F401  (re-exported)
    CAM_RADIUS, FAR, NEAR, apply_photometric_perturbation, look_at_pose_w2c, ray_trace)
from sparf_tpu_torch.utils import camera


def render_view(pose_w2c: np.ndarray, intr: np.ndarray, H: int, W: int,
                texture_octaves: int = 1, specular: float = 0.0):
    """Analytic render: (image (H,W,3), depth (H,W), fg (H,W))."""
    center, ray = camera.get_center_and_ray(
        torch.as_tensor(pose_w2c[None]), H, W, torch.as_tensor(intr[None].astype(np.float32)))
    rgb, depth, hit = ray_trace(center[0].numpy(), ray[0].numpy(), texture_octaves, specular)
    return rgb.reshape(H, W, 3), depth.reshape(H, W), hit.reshape(H, W)


def load_synthetic_scene(
    root: str = "",
    scene: str = "spheres",
    split: str = "train",
    train_sub: Optional[int] = None,
    val_sub: Optional[int] = None,
    H: int = 60,
    W: int = 80,
    n_train: int = 6,
    n_test: int = 3,
    increase_depth_range_by_x_percent: float = 0.0,
    angular_span: float = 1.0,
    texture_octaves: int = 1,
    specular: float = 0.0,
    exposure_jitter: float = 0.0,
    wb_jitter: float = 0.0,
    noise_sigma: float = 0.0,
    vignette: float = 0.0,
    photo_seed: int = 7,
    **_unused,
) -> base.Scene:
    """Procedural scene, the same views as sparf_tpu.datasets.synthetic.load_synthetic_scene."""
    focal = 0.9 * W
    intr = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    n_total = n_train + n_test
    angles = np.linspace(-0.5, 0.5, n_total) * angular_span
    heights = 0.35 * angular_span * np.sin(np.linspace(0, 2.3, n_total))
    eyes = np.stack([np.sin(angles) * CAM_RADIUS, heights, -np.cos(angles) * CAM_RADIUS], -1)
    poses = np.stack([look_at_pose_w2c(e) for e in eyes])

    test_ids = list(np.linspace(1, n_total - 2, n_test).round().astype(int)) if n_test else []
    train_ids = [i for i in range(n_total) if i not in test_ids][:n_train]
    indices = train_ids if split == "train" else test_ids
    if split == "train" and train_sub is not None:
        indices = indices[:train_sub]
    if split != "train" and val_sub is not None:
        indices = indices[:val_sub]

    perturb = exposure_jitter > 0 or wb_jitter > 0 or noise_sigma > 0 or vignette > 0
    samples = []
    for local_i, idx in enumerate(indices):
        img, depth, fg = render_view(poses[idx], intr, H, W, texture_octaves, specular)
        if perturb:
            img = apply_photometric_perturbation(
                img, np.random.RandomState(photo_seed * 1000 + idx),
                exposure_jitter=exposure_jitter, wb_jitter=wb_jitter,
                noise_sigma=noise_sigma, vignette=vignette)
        samples.append(dict(
            idx=local_i,
            rgb_path=f"view{idx:03d}.png",
            image=base.image_to_chw01(img),
            intr=intr.copy(),
            pose=poses[idx],
            depth_range=np.array([NEAR, FAR], np.float32),
            depth_gt=depth,
            valid_depth_gt=fg,
            fg_mask=fg[None],
        ))
    out = base.stack_scene(samples)
    out["scene"] = scene
    return base.apply_increase_depth_range(out, increase_depth_range_by_x_percent)
