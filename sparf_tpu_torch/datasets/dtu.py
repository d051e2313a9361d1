"""DTU (pixelNeRF-processed) per-scene loader.

Parity with reference source/datasets/dtu.py:61-371: cameras.npz projection
matrices decomposed as cv2.decomposeProjectionMatrix does (utils.imgproc),
scale_mat recentering, world scaled by 1/300, pixelNeRF split train=[25,22,28,40,44,48,0,8,13] with
15 excluded test indices, train_sub = first-N, IDR/RegNeRF fg masks, optional
MVSNet PFM GT depth (x 1/300), near/far = 1.2/5.2.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

from sparf_tpu_torch.datasets import base
from sparf_tpu_torch.utils import alignment, imgproc

NEAR_DEPTH = 1.2
FAR_DEPTH = 5.2
SCALING_FACTOR = 1.0 / 300.0

PIXELNERF_TRAIN_IDX = [25, 22, 28, 40, 44, 48, 0, 8, 13]
PIXELNERF_EXCLUDE_IDX = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]
IDR_SCANS = ["scan40", "scan55", "scan63", "scan110", "scan114"]


def read_pfm(filename: str) -> Tuple[np.ndarray, float]:
    """Minimal PFM reader (reference dtu.py:61-96)."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError("not a PFM file")
        dim_match = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError("malformed PFM header")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().decode("utf-8").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = np.reshape(data, shape)
    return np.flipud(data), scale


def decompose_projection(P: np.ndarray):
    """(3,4) projection -> (K, pose_c2w 4x4) as from cv2.decomposeProjectionMatrix."""
    K, R, t = imgproc.decompose_projection_matrix(P[:3])
    K = K / K[2, 2]
    pose_c2w = np.eye(4, dtype=np.float32)
    pose_c2w[:3, :3] = R.transpose()
    pose_c2w[:3, 3] = (t[:3] / t[3])[:, 0]
    return K.astype(np.float32), pose_c2w


def load_scene_cameras(scene_path: str, n_images: int):
    """cameras.npz -> per-image (K (3,3), pose_c2w (4,4)) scaled to 1/300 world."""
    camera_info = np.load(os.path.join(scene_path, "cameras.npz"))
    intrinsics, poses_c2w = [], []
    for p in range(n_images):
        P = camera_info[f"world_mat_{p}"][:3]
        K, pose_c2w = decompose_projection(P)
        scale_mat = camera_info.get(f"scale_mat_{p}")
        if scale_mat is not None:
            pose_c2w[:3, 3:] -= scale_mat[:3, 3:]
            norm_scale = np.diagonal(scale_mat[:3, :3])
            assert np.allclose(norm_scale.mean(), 300.0), (
                "DTU scale_mat != 300; adjust SCALING_FACTOR"
            )
        pose_c2w[:3, 3:] *= SCALING_FACTOR
        intrinsics.append(K)
        poses_c2w.append(pose_c2w)
    return np.stack(intrinsics), np.stack(poses_c2w)


def split_indices_pixelnerf(n: int = 49, split_type: str = "pixelnerf", dtuhold: int = 8):
    if split_type == "pixelnerf":
        train_idx = PIXELNERF_TRAIN_IDX
        test_idx = [i for i in range(49) if i not in train_idx + PIXELNERF_EXCLUDE_IDX]
        return {"train": train_idx, "test": test_idx}
    if split_type == "all":
        return {"train": list(range(n)), "test": list(range(n))}
    if split_type == "pixelnerf_reduced_testset":
        train_idx = [25, 22, 28, 40, 44, 48, 0, 8, 13, 24, 30, 41, 47, 43, 29, 45, 34, 33]
        test_idx = [1, 2, 9, 10, 11, 12, 14, 15, 23, 26, 27, 31, 32, 35, 42, 46]
        return {"train": train_idx, "test": test_idx}
    all_idx = np.arange(n)
    return {
        "train": list(all_idx[all_idx % dtuhold != 0]),
        "test": list(all_idx[all_idx % dtuhold == 0]),
    }


def mask_path_for(mask_root: str, scene: str, idx: int) -> str:
    if scene in IDR_SCANS:
        return os.path.join(mask_root, scene, "mask", f"{idx:03d}.png")
    return os.path.join(mask_root, scene, f"{idx:03d}.png")


def load_dtu_scene(
    root: str,
    scene: str,
    split: str = "train",
    train_sub: Optional[int] = None,
    val_sub: Optional[int] = None,
    split_type: str = "pixelnerf",
    mask_root: Optional[str] = None,
    depth_root: Optional[str] = None,
    resize: Optional[tuple] = None,
    crop_ratio: Optional[float] = None,
    mask_img: bool = False,
    increase_depth_range_by_x_percent: float = 0.0,
) -> base.Scene:
    import imageio.v2 as imageio

    scene_path = os.path.join(root, scene)
    image_dir = os.path.join(scene_path, "image")
    rgb_files = sorted(
        os.path.join(image_dir, f) for f in os.listdir(image_dir) if f.endswith("png")
    )
    n = len(rgb_files)
    intrinsics, poses_c2w = load_scene_cameras(scene_path, n)

    indices = split_indices_pixelnerf(n, split_type)[("train" if split == "train" else "test")]
    if split == "train" and train_sub is not None:
        indices = indices[:train_sub]
    if split != "train" and val_sub is not None:
        indices = indices[:val_sub]

    samples = []
    for local_i, idx in enumerate(indices):
        image = imageio.imread(rgb_files[idx])
        H_img, W_img = image.shape[:2]

        fg_mask = None
        if mask_root is not None:
            mpath = mask_path_for(mask_root, scene, idx)
            if os.path.exists(mpath):
                m = imageio.imread(mpath)
                if m.ndim == 3:
                    m = m[..., 0]
                fg_mask = (m > 127).astype(np.float32)

        depth = None
        if depth_root is not None:
            dpath = os.path.join(depth_root, scene.replace("scan", "Depths/scan"), f"depth_map_{idx:04d}.pfm")
            alt = os.path.join(depth_root, scene, f"depth_map_{idx:04d}.pfm")
            for cand in (dpath, alt):
                if os.path.exists(cand):
                    depth = (read_pfm(cand)[0] * SCALING_FACTOR).astype(np.float32)
                    break

        if mask_img and fg_mask is not None:
            image = image.astype(np.float32)
            image = image * fg_mask[..., None] + 255.0 * (1 - fg_mask[..., None])

        img, intr, extras = base.preprocess_image_and_intrinsics(
            image, intrinsics[idx], resize=resize, crop_ratio=crop_ratio,
            extras=[fg_mask, depth],
        )
        fg_mask_p, depth_p = extras if extras else (None, None)

        pose_w2c = alignment.invert_poses(poses_c2w[idx : idx + 1, :3])[0].astype(np.float32)
        sample = dict(
            idx=local_i,
            rgb_path=os.path.basename(rgb_files[idx]),
            image=img,
            intr=intr,
            pose=pose_w2c,
            depth_range=np.array([NEAR_DEPTH, FAR_DEPTH], np.float32),
        )
        if fg_mask_p is not None:
            sample["fg_mask"] = fg_mask_p[None].astype(bool)  # (1,H,W)
        if depth_p is not None:
            sample["depth_gt"] = depth_p.astype(np.float32)
            sample["valid_depth_gt"] = depth_p > 0.5 * NEAR_DEPTH
        samples.append(sample)

    out = base.stack_scene(samples)
    out["scene"] = scene
    out = base.apply_increase_depth_range(out, increase_depth_range_by_x_percent)
    return out
