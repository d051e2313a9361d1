"""Replica (NICE-SLAM format) per-scene loader (the port's copy of
sparf_tpu/datasets/replica.py): frames decoded by utils/imgproc.py (baseline
JPEG and 16-bit PNG in numpy), the far-plane bound through the port's camera.

Parity with reference source/datasets/rgbd_datasets.py:42-305: results/frame*.jpg
+ depth*.png (/6553.5), traj.txt c2w poses, fixed intrinsics 680x1200 f=600,
recentering by mean camera translation AND by the center of the far-plane 3D
bound of the selected train views, per-scene hand-tuned train/test frame
intervals, per-scene near/far.
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

import torch

from sparf_tpu_torch.datasets import base
from sparf_tpu_torch.utils import alignment, camera, imgproc

PNG_DEPTH_SCALE = 6553.5
H0, W0 = 680, 1200
FX, FY, CX, CY = 600.0, 600.0, 599.5, 339.5


def scene_depth_range(scene: str):
    if scene in ("room1", "office1", "office0"):
        return 0.1, 4.5
    return 0.1, 6.5


def scene_intervals(scene: str, train_sub: Optional[int]):
    """(start, train_interval, test_interval) per scene (rgbd_datasets.py:196-262)."""
    start = 0
    if scene == "office0":
        train_interval = 50 if (train_sub is not None and train_sub > 3) else 80
        test_interval = 10
    elif scene == "office1":
        if train_sub is not None and train_sub > 6:
            train_interval = 80
        elif train_sub is not None and train_sub > 3:
            train_interval = 100
        else:
            train_interval = 200
        test_interval = 50
    elif scene == "office2":
        if train_sub is not None and train_sub > 6:
            train_interval = 80
        elif train_sub is not None and train_sub > 3:
            train_interval = 100
        else:
            train_interval = 150
        test_interval = 10
    elif scene == "office3":
        train_interval = 200 if (train_sub is not None and train_sub > 3) else 350
        test_interval = 30
    elif scene == "office4":
        start, train_interval, test_interval = 850, 100, 30
    elif scene == "room0":
        train_interval = 100 if (train_sub is not None and train_sub > 3) else 250
        test_interval = 10
    elif scene == "room1":
        if train_sub is not None and train_sub > 3:
            start, train_interval = 300, 100
        else:
            train_interval = 50
        test_interval = 10
    else:
        train_interval, test_interval = 80, 10
    return start, train_interval, test_interval


def compute_3d_bounds_center(
    H: int, W: int, intrinsics: np.ndarray, poses_w2c: np.ndarray, far: float
) -> np.ndarray:
    """Center of the far-plane 3D bounding box over all train rays
    (rgbd_datasets.py:49-71)."""
    B = poses_w2c.shape[0]
    intr = np.broadcast_to(intrinsics, (B, 3, 3)).astype(np.float32)
    rays_o, rays_d = camera.get_center_and_ray(
        torch.as_tensor(poses_w2c[:, :3].astype(np.float32)), H, W, torch.as_tensor(intr)
    )
    pts = (rays_o + rays_d * far).numpy().reshape(-1, 3)
    return (pts.max(0) + pts.min(0)) / 2.0


def load_replica_scene(
    root: str,
    scene: str,
    split: str = "train",
    train_sub: Optional[int] = None,
    val_sub: Optional[int] = None,
    resize: Optional[tuple] = None,
    increase_depth_range_by_x_percent: float = 0.0,
) -> base.Scene:
    input_folder = os.path.join(root, scene)
    color_paths = np.array(sorted(glob.glob(f"{input_folder}/results/frame*.jpg")))
    depth_paths = np.array(sorted(glob.glob(f"{input_folder}/results/depth*.png")))
    n_img = len(color_paths)
    assert n_img > 0, f"no frames under {input_folder}/results"

    with open(f"{input_folder}/traj.txt") as f:
        lines = f.readlines()
    poses_c2w = np.stack(
        [np.array(list(map(float, lines[i].split()))).reshape(4, 4) for i in range(n_img)]
    ).astype(np.float32)

    intr0 = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)

    # recenter by mean camera translation (rgbd_datasets.py:186-189)
    poses_c2w[:, :3, -1] -= poses_c2w[:, :3, -1].mean(0, keepdims=True)

    near, far = scene_depth_range(scene)
    start, train_interval, test_interval = scene_intervals(scene, train_sub)
    i_train = np.arange(start, n_img)[::train_interval].astype(int)
    if train_sub is not None:
        i_train = i_train[:train_sub]
    end_test = i_train[-1] + test_interval
    i_test = np.array([j for j in np.arange(start, end_test) if j not in i_train])[::test_interval]

    # recenter by far-plane bound center of the *train* views (rgbd_datasets.py:270-279)
    train_poses_w2c = alignment.invert_poses(poses_c2w[i_train])
    bb_center = compute_3d_bounds_center(H0, W0, intr0, train_poses_w2c, far)
    poses_c2w[:, :3, -1] -= bb_center[None]

    indices = i_train if split == "train" else i_test
    if split != "train" and val_sub is not None:
        indices = indices[:val_sub]

    samples = []
    for local_i, idx in enumerate(indices):
        color = imgproc.read_image(str(color_paths[idx]))
        depth = imgproc.read_png(str(depth_paths[idx])).astype(np.float32)
        depth /= PNG_DEPTH_SCALE
        Hd, Wd = depth.shape
        if color.shape[:2] != (Hd, Wd):
            # cv2.resize's INTER_LINEAR in float, rounded: within a level of
            # OpenCV's 11-bit fixed-point uint8 path
            color = np.clip(np.rint(imgproc.resize_linear(color.astype(np.float32), (Hd, Wd))),
                            0, 255).astype(np.uint8)

        img, intr, extras = base.preprocess_image_and_intrinsics(
            color, intr0, resize=resize, extras=[depth]
        )
        depth_p = extras[0]
        pose_w2c = alignment.invert_poses(poses_c2w[idx : idx + 1])[0, :3].astype(np.float32)
        samples.append(
            dict(
                idx=local_i,
                rgb_path=os.path.basename(str(color_paths[idx])),
                image=img,
                intr=intr,
                pose=pose_w2c,
                depth_range=np.array([near, far], np.float32),
                depth_gt=depth_p.astype(np.float32),
                valid_depth_gt=depth_p > 0,
            )
        )
    out = base.stack_scene(samples)
    out["scene"] = scene
    out = base.apply_increase_depth_range(out, increase_depth_range_by_x_percent)
    return out
