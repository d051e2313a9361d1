"""Dataset foundations: the Scene container and image preprocessing.

TPU-native data model: a *scene* is a dict of stacked numpy arrays (the whole
per-scene dataset), moved to device once (the reference prefetches the full
scene to GPU the same way, source/training/base.py:376-379 / datasets/base.py:66-69).

Canonical keys (parity with reference data_dict, README.md:443-444):
  image (B,3,H,W) float32 in [0,1], pose (B,3,4) GT w2c, intr (B,3,3),
  idx (B,), depth_range (B,2), optional depth_gt (B,H,W),
  valid_depth_gt (B,H,W) bool, fg_mask (B,1,H,W) bool, scene (str),
  rgb_path (list[str]).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from sparf_tpu_torch.utils import imgproc

Scene = Dict[str, Any]


def resize_image_w_intrinsics(
    image: np.ndarray,
    new_size: Optional[Sequence[int]],
    resize_factor: Optional[float],
    intr: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Resize (H,W,3) float image; scale intrinsics rows 0/1 accordingly.

    new_size is (H_new, W_new); sizes are rounded down to even numbers
    (reference data_utils resize semantics). Area resampling (cv2.INTER_AREA's,
    through utils.imgproc).
    """
    H, W = image.shape[:2]
    if new_size is not None:
        H_new, W_new = int(new_size[0]), int(new_size[1])
    elif resize_factor is not None:
        H_new, W_new = int(H * resize_factor), int(W * resize_factor)
    else:
        return image, intr
    H_new -= H_new % 2
    W_new -= W_new % 2
    resized = imgproc.resize_area(image, (H_new, W_new))
    if intr is not None:
        intr = intr.copy().astype(np.float32)
        intr[0] *= W_new / W
        intr[1] *= H_new / H
    return resized, intr


def center_crop_w_intrinsics(
    image: np.ndarray, crop_hw: Tuple[int, int], intr: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Center crop (H,W,...) image; shift principal point."""
    H, W = image.shape[:2]
    ch, cw = crop_hw
    ch += ch % 2
    cw += cw % 2
    y0 = (H - ch) // 2
    x0 = (W - cw) // 2
    out = image[y0 : y0 + ch, x0 : x0 + cw]
    if intr is not None:
        intr = intr.copy().astype(np.float32)
        intr[0, 2] -= x0
        intr[1, 2] -= y0
    return out, intr


def image_to_chw01(image: np.ndarray) -> np.ndarray:
    """(H,W,3) uint8/float -> (3,H,W) float32 in [0,1]."""
    img = np.asarray(image).astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return np.transpose(img, (2, 0, 1))


def preprocess_image_and_intrinsics(
    image: np.ndarray,
    intr: np.ndarray,
    resize: Optional[Sequence[int]] = None,
    resize_factor: Optional[float] = None,
    crop_ratio: Optional[float] = None,
    extras: Optional[List[Optional[np.ndarray]]] = None,
):
    """Crop -> resize -> CHW[0,1]; adjusts intrinsics; resizes extras (nearest).

    (reference datasets/base.py:148-210)
    """
    image = np.asarray(image).astype(np.float32)
    if crop_ratio is not None:
        H, W = image.shape[:2]
        image, intr = center_crop_w_intrinsics(image, (int(H * crop_ratio), int(W * crop_ratio)), intr)
        if extras:
            extras = [
                None if e is None else center_crop_w_intrinsics(e, (int(H * crop_ratio), int(W * crop_ratio)))[0]
                for e in extras
            ]
    image, intr = resize_image_w_intrinsics(image, resize, resize_factor, intr)
    H_new, W_new = image.shape[:2]
    out_extras = []
    if extras:
        for e in extras:
            if e is None:
                out_extras.append(None)
            else:
                out_extras.append(imgproc.resize_nearest(e.astype(np.float32), (H_new, W_new)))
    return image_to_chw01(image), intr.astype(np.float32), out_extras


def stack_scene(samples: List[Dict[str, Any]]) -> Scene:
    """Collate per-image dicts into a stacked Scene (default_collate analog)."""
    scene: Scene = {}
    keys = samples[0].keys()
    for k in keys:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            scene[k] = np.stack([s[k] for s in samples]).astype(v0.dtype)
        elif isinstance(v0, (int, np.integer)):
            scene[k] = np.asarray([s[k] for s in samples], np.int32)
        elif isinstance(v0, (float, np.floating)):
            scene[k] = np.asarray([s[k] for s in samples], np.float32)
        else:
            scene[k] = [s[k] for s in samples]
    return scene


def get_nearest_pose_ids(
    tar_pose_c2w: np.ndarray,
    ref_poses_c2w: np.ndarray,
    num_select: int,
    tar_id: int = -1,
    angular_dist_method: str = "vector",
    scene_center: Tuple[float, float, float] = (0, 0, 0),
) -> np.ndarray:
    """ids of the nearest reference views by angular distance
    (reference data_utils.py:248-312).

    tar_pose_c2w (3or4,4); ref_poses_c2w (N,3or4,4).
    """
    num_cams = len(ref_poses_c2w)
    num_select = min(num_select, num_cams - 1 if tar_id >= 0 else num_cams)

    if angular_dist_method == "matrix":
        from sparf_tpu_torch.utils.alignment import rotation_distance_np

        dists = rotation_distance_np(
            np.broadcast_to(tar_pose_c2w[:3, :3], (num_cams, 3, 3)), ref_poses_c2w[:, :3, :3]
        )
    elif angular_dist_method == "vector":
        tar_vec = tar_pose_c2w[:3, 3] - np.asarray(scene_center)
        ref_vecs = ref_poses_c2w[:, :3, 3] - np.asarray(scene_center)
        tar_u = tar_vec / (np.linalg.norm(tar_vec) + 1e-12)
        ref_u = ref_vecs / (np.linalg.norm(ref_vecs, axis=-1, keepdims=True) + 1e-12)
        dists = np.arccos(np.clip(ref_u @ tar_u, -1, 1))
    elif angular_dist_method == "dist":
        dists = np.linalg.norm(ref_poses_c2w[:, :3, 3] - tar_pose_c2w[:3, 3], axis=-1)
    else:
        raise ValueError(angular_dist_method)

    if tar_id >= 0:
        dists[tar_id] = 1e10  # exclude the target itself
    return np.argsort(dists)[:num_select]


def apply_increase_depth_range(scene: Scene, percent: float) -> Scene:
    """Widen [near, far] by +-percent (reference dtu.py:351-353 semantics)."""
    if percent and "depth_range" in scene:
        dr = scene["depth_range"].astype(np.float32)
        near, far = dr[..., 0], dr[..., 1]
        span_low = near * percent
        span_high = far * percent
        scene["depth_range"] = np.stack(
            [np.maximum(near - span_low, 1e-4), far + span_high], axis=-1
        ).astype(np.float32)
    return scene


def scene_image_hw(scene: Scene) -> Tuple[int, int]:
    return int(scene["image"].shape[2]), int(scene["image"].shape[3])
