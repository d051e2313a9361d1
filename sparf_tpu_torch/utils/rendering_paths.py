"""Novel-view camera paths for video synthesis (numpy, host-side; the port's
copy of sparf_tpu/utils/rendering_paths.py, held to it by
tests/test_torch_shared_copies.py).

Parity with reference source/datasets/rendering_path.py:24-141: LLFF
forward-facing spiral from pose statistics, DTU spiral around the focus
point, plus the oscillation path living in sparf_tpu_torch.utils.camera
(get_novel_view_poses).
"""
from __future__ import annotations

import numpy as np


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(lookdir, up, position, subtract_position: bool = False) -> np.ndarray:
    """Look-at c2w (3,4): columns [right, up', forward, position]."""
    vec2 = normalize((lookdir - position) if subtract_position else lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def poses_avg(poses_c2w: np.ndarray) -> np.ndarray:
    position = poses_c2w[:, :3, 3].mean(0)
    z_axis = poses_c2w[:, :3, 2].mean(0)
    up = poses_c2w[:, :3, 1].mean(0)
    return viewmatrix(z_axis, up, position)


def focus_pt_fn(poses_c2w: np.ndarray) -> np.ndarray:
    """Nearest point to all focal axes."""
    directions, origins = poses_c2w[:, :3, 2:3], poses_c2w[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def generate_spiral_path(
    poses_c2w: np.ndarray, bounds: np.ndarray, n_frames: int = 240,
    n_rots: int = 2, zrate: float = 0.5,
) -> np.ndarray:
    """Forward-facing spiral (LLFF). poses_c2w (N,3,4) OpenCV; returns (F,3,4) c2w."""
    poses_c2w = np.asarray(poses_c2w, np.float64)
    bounds = np.asarray(bounds)
    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1 / ((1 - dt) / close_depth + dt / inf_depth)

    positions = poses_c2w[:, :3, 3]
    radii = np.percentile(np.abs(positions), 90, 0)
    radii = np.concatenate([radii, [1.0]])

    render_poses = []
    cam2world = poses_avg(poses_c2w)
    up = poses_c2w[:, :3, 1].mean(0)
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        position = cam2world @ t
        lookat = cam2world @ [0, 0, -focal, 1.0]
        z_axis = position - lookat
        render_poses.append(viewmatrix(z_axis, up, position))
    return np.stack(render_poses).astype(np.float32)


def generate_spiral_path_dtu(
    poses_c2w: np.ndarray, n_frames: int = 240, n_rots: int = 2,
    zrate: float = 0.5, perc: float = 60,
) -> np.ndarray:
    """Spiral around the focus point (DTU). Returns (F,3,4) c2w."""
    poses_c2w = np.asarray(poses_c2w, np.float64)
    positions = poses_c2w[:, :3, 3]
    radii = np.percentile(np.abs(positions), perc, 0)
    radii = np.concatenate([radii, [1.0]])

    render_poses = []
    cam2world = poses_avg(poses_c2w)
    up = poses_c2w[:, :3, 1].mean(0)
    z_axis = focus_pt_fn(poses_c2w)
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        position = cam2world @ t
        render_poses.append(viewmatrix(z_axis, up, position, True))
    return np.stack(render_poses).astype(np.float32)
