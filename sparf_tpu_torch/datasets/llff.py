"""LLFF per-scene loader (parity with reference source/datasets/llff.py:34-212).

Pipeline: poses_bounds.npy -> LLFF c2w -> OpenGL c2w -> scale by
1/(0.75*min bound) -> recenter around the average pose -> OpenCV w2c ->
flip to face +z (critical for identity pose init, llff.py:197-211).
Standard 1/8 test holdout (`llffhold`); train_sub = linspace subset.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from sparf_tpu_torch.datasets import base
from sparf_tpu_torch.utils import imgproc
from sparf_tpu_torch.utils import alignment

_FLIP = np.diag([1.0, -1.0, -1.0]).astype(np.float32)


def _compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """b(a(x)) for (3,4) numpy poses."""
    R = b[:, :3] @ a[:, :3]
    t = b[:, :3] @ a[:, 3] + b[:, 3]
    return np.concatenate([R, t[:, None]], axis=1)


def parse_cameras_and_bounds(path: str, factor: int = 1):
    """Returns (poses_c2w_opengl (N,3,4), bounds (N,2), focal, H, W)."""
    data = np.load(os.path.join(path, "poses_bounds.npy")).astype(np.float32)
    cam_data = data[:, :-2].reshape(-1, 3, 5)
    poses_c2w_llff = cam_data[..., :4]

    # LLFF [down,right,backwards] -> OpenGL [right,up,backwards]
    poses_c2w_opengl = poses_c2w_llff.copy()
    poses_c2w_opengl[..., 0] = poses_c2w_llff[..., 1]
    poses_c2w_opengl[..., 1] = -poses_c2w_llff[..., 0]

    raw_H, raw_W, focal = cam_data[0, :, -1]
    raw_H /= float(factor)
    raw_W /= float(factor)
    focal /= float(factor)

    bounds = data[:, -2:].copy()
    scale = 1.0 / (bounds.min() * 0.75)
    poses_c2w_opengl[..., 3] *= scale
    bounds *= scale

    poses_c2w_opengl = center_camera_poses(poses_c2w_opengl)
    return poses_c2w_opengl, bounds, float(focal), int(raw_H), int(raw_W)


def center_camera_poses(poses: np.ndarray) -> np.ndarray:
    """Recenter around the average pose (llff.py:133-143)."""
    center = poses[..., 3].mean(axis=0)
    v1 = poses[..., 1].mean(axis=0)
    v1 /= np.linalg.norm(v1) + 1e-12
    v2 = poses[..., 2].mean(axis=0)
    v2 /= np.linalg.norm(v2) + 1e-12
    v0 = np.cross(v1, v2)
    pose_avg = np.stack([v0, v1, v2, center], axis=-1).astype(np.float32)  # (3,4)
    pose_avg_inv = alignment.invert_poses(pose_avg[None])[0]
    return np.stack([_compose(p, pose_avg_inv) for p in poses])


def parse_raw_camera(pose_c2w_opengl: np.ndarray) -> np.ndarray:
    """OpenGL c2w -> OpenCV w2c facing +z (llff.py:197-211)."""
    flip34 = np.concatenate([_FLIP, np.zeros((3, 1), np.float32)], axis=1)
    pose_c2w_opencv = _compose(flip34, pose_c2w_opengl[:3])
    pose_w2c_opencv = alignment.invert_poses(pose_c2w_opencv[None])[0]
    return _compose(flip34, pose_w2c_opencv).astype(np.float32)


def load_llff_scene(
    root: str,
    scene: str,
    split: str = "train",
    train_sub: Optional[int] = None,
    val_sub: Optional[int] = None,
    llffhold: int = 8,
    img_factor: int = 8,
    resize: Optional[tuple] = None,
    crop_ratio: Optional[float] = None,
    increase_depth_range_by_x_percent: float = 0.0,
) -> base.Scene:
    path = os.path.join(root, scene)
    imgdir_suffix = f"_{img_factor}" if img_factor and img_factor > 1 else ""
    factor = img_factor if img_factor and img_factor > 1 else 1
    path_image = os.path.join(path, "images" + imgdir_suffix)
    image_fnames = sorted(
        f for f in os.listdir(path_image) if f.lower().endswith(("jpg", "png", "jpeg"))
    )

    poses_c2w_opengl, bounds, focal, raw_H, raw_W = parse_cameras_and_bounds(path, factor)
    assert len(image_fnames) == len(poses_c2w_opengl), (
        f"{len(image_fnames)} images vs {len(poses_c2w_opengl)} poses"
    )
    near = bounds.min() * 0.9
    far = bounds.max() * 1.0

    all_indices = np.arange(len(image_fnames), dtype=np.int32)
    if split == "train":
        indices = all_indices[all_indices % llffhold != 0]
        if train_sub is not None:
            idx_sub = [round(i) for i in np.linspace(0, len(indices) - 1, train_sub)]
            indices = indices[idx_sub]
    else:
        indices = all_indices[all_indices % llffhold == 0]
        if val_sub is not None:
            indices = indices[:val_sub]

    intr0 = np.array([[focal, 0, raw_W / 2], [0, focal, raw_H / 2], [0, 0, 1]], np.float32)

    samples = []
    for local_i, idx in enumerate(indices):
        image = imgproc.read_png(os.path.join(path_image, image_fnames[idx]))
        img, intr, _ = base.preprocess_image_and_intrinsics(
            image, intr0, resize=resize, crop_ratio=crop_ratio
        )
        samples.append(
            dict(
                idx=local_i,
                rgb_path=image_fnames[idx],
                image=img,
                intr=intr,
                pose=parse_raw_camera(poses_c2w_opengl[idx]),
                depth_range=np.array([near, far], np.float32),
            )
        )
    out = base.stack_scene(samples)
    out["scene"] = scene
    out = base.apply_increase_depth_range(out, increase_depth_range_by_x_percent)
    return out
