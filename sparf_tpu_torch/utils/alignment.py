"""Trajectory/pose alignment (host-side numpy; evaluation path only).

Covers the reference's vendored rpg_trajectory_evaluation (third_party/ATE)
plus source/utils/geometry/align_trajectories.py and the few-view pairwise
alignment of joint_pose_nerf_trainer.py:160-254. These run at log/eval
cadence, not in the jitted hot path, so float64 numpy is both simpler and
closer to the reference's .cpu().double() numerics.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# sim3 container
# ---------------------------------------------------------------------------


@dataclass
class Sim3:
    """gt_c2w ~ s * R @ est_c2w + t (per camera-center)."""

    R: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    t: np.ndarray = field(default_factory=lambda: np.zeros((3, 1), dtype=np.float32))
    s: float = 1.0
    type: str = "traj_align"

    def as_dict(self):
        return dict(R=self.R.tolist(), t=self.t.reshape(-1).tolist(), s=float(self.s), type=self.type)


def identity_sim3() -> Sim3:
    return Sim3()


# ---------------------------------------------------------------------------
# basic pose numpy helpers
# ---------------------------------------------------------------------------


def pad_poses(poses: np.ndarray) -> np.ndarray:
    """(N,3,4) -> (N,4,4)."""
    poses = np.asarray(poses)
    bottom = np.zeros((*poses.shape[:-2], 1, 4), poses.dtype)
    bottom[..., 0, 3] = 1.0
    return np.concatenate([poses[..., :3, :], bottom], axis=-2)


def invert_poses(poses: np.ndarray) -> np.ndarray:
    """Invert (N,3,4) or (N,4,4) rigid poses, returns (N,3,4)."""
    R = poses[..., :3, :3]
    t = poses[..., :3, 3:]
    R_inv = np.swapaxes(R, -1, -2)
    t_inv = -R_inv @ t
    return np.concatenate([R_inv, t_inv], axis=-1)


def rotation_distance_np(R1: np.ndarray, R2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    R_diff = R1 @ np.swapaxes(R2, -2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return np.arccos(np.clip((trace - 1) / 2, -1 + eps, 1 - eps))


# ---------------------------------------------------------------------------
# Umeyama (third_party/ATE/align_trajectory.py:28-84)
# ---------------------------------------------------------------------------


def align_umeyama(
    model: np.ndarray, data: np.ndarray, known_scale: bool = False, yaw_only: bool = False
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares sim3: model ~ s * R @ data + t. Arrays are (N,3)."""
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    model_zc = model - mu_m
    data_zc = data - mu_d
    n = model.shape[0]

    C = (1.0 / n) * model_zc.T @ data_zc
    sigma2 = (1.0 / n) * (data_zc * data_zc).sum()
    sigma2_invalid = sigma2 < 1e-5
    if sigma2_invalid:
        sigma2 = 1.0

    U, D, Vh = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh.T) < 0:
        S[2, 2] = -1

    if yaw_only:
        rot_C = data_zc.T @ model_zc
        theta = math.pi / 2 - math.atan2(rot_C[0, 0] + rot_C[1, 1], rot_C[0, 1] - rot_C[1, 0])
        c, s_ = math.cos(theta), math.sin(theta)
        R = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float64)
    else:
        R = U @ S @ Vh

    if known_scale or sigma2_invalid:
        s = 1.0
    else:
        s = 1.0 / (sigma2 + 1e-6) * np.trace(np.diag(D) @ S)

    t = mu_m - s * R @ mu_d
    return float(s), R, t


def align_trajectory(
    p_es: np.ndarray,
    p_gt: np.ndarray,
    R_es: Optional[np.ndarray] = None,
    R_gt: Optional[np.ndarray] = None,
    method: str = "sim3",
    pose_id_to_align: int = 0,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """rpg-style dispatcher: returns (s,R,t) with p_gt ~ s R p_es + t.

    method in {'sim3','se3','posyaw','first_frame'}
    (third_party/ATE/align_utils.py:10-143).
    """
    if method == "sim3":
        return align_umeyama(p_gt, p_es)
    if method == "se3":
        s, R, t = align_umeyama(p_gt, p_es, known_scale=True)
        return 1.0, R, t
    if method == "posyaw":
        s, R, t = align_umeyama(p_gt, p_es, known_scale=True, yaw_only=True)
        return 1.0, R, t
    if method == "first_frame":
        assert R_es is not None and R_gt is not None
        i = pose_id_to_align
        R = R_gt[i] @ R_es[i].T
        t = p_gt[i] - R @ p_es[i]
        return 1.0, R, t
    raise ValueError(f"unknown alignment method {method}")


# ---------------------------------------------------------------------------
# trajectory alignment (align_trajectories.py:214-292)
# ---------------------------------------------------------------------------


def align_ate_c2b_use_a2b(
    traj_a_c2w: np.ndarray,
    traj_b_c2w: np.ndarray,
    traj_c: Optional[np.ndarray] = None,
    method: str = "sim3",
    pose_id_to_align: int = 0,
) -> Tuple[np.ndarray, Sim3]:
    """Align trajectory c to b using the sim3 estimated from a to b.

    All trajectories are c2w, (N,3or4,4). Returns ((N,4,4), Sim3).
    """
    traj_a = np.asarray(traj_a_c2w, np.float64)
    traj_b = np.asarray(traj_b_c2w, np.float64)
    traj_c = traj_a.copy() if traj_c is None else np.asarray(traj_c, np.float64)

    s, R, t = align_trajectory(
        traj_a[:, :3, 3],
        traj_b[:, :3, 3],
        traj_a[:, :3, :3],
        traj_b[:, :3, :3],
        method=method,
        pose_id_to_align=pose_id_to_align,
    )
    R = R[None].astype(np.float64)
    t = t.reshape(1, 3, 1).astype(np.float64)

    R_c = traj_c[:, :3, :3]
    t_c = traj_c[:, :3, 3:4]
    R_c_aligned = R @ R_c
    t_c_aligned = s * (R @ t_c) + t
    traj_c_aligned = pad_poses(np.concatenate([R_c_aligned, t_c_aligned], axis=2))
    sim3 = Sim3(R=R[0].astype(np.float32), t=t[0].astype(np.float32), s=float(s))
    return traj_c_aligned.astype(np.float32), sim3


def apply_sim3_to_c2w(traj_c2w: np.ndarray, sim3: Sim3) -> np.ndarray:
    """Map c2w poses through sim3 (same formula as align_ate_c2b_use_a2b)."""
    traj = np.asarray(traj_c2w, np.float64)
    R_c = traj[:, :3, :3]
    t_c = traj[:, :3, 3:4]
    R_a = sim3.R[None].astype(np.float64) @ R_c
    t_a = sim3.s * (sim3.R[None].astype(np.float64) @ t_c) + sim3.t[None].astype(np.float64)
    return pad_poses(np.concatenate([R_a, t_a], axis=2)).astype(np.float32)


def backtrack_gt_through_sim3(pose_GT_w2c: np.ndarray, sim3: Sim3) -> np.ndarray:
    """Map GT w2c test poses into the optimized coordinate frame.

    Inverse of apply_sim3: c2w_aligned = R^T/s (c2w_t - t), rotation R^T R_c.
    (reference align_trajectories.py:93-103 backtrack_from_aligning_the_trajectory)
    Returns (N,3,4) w2c.
    """
    pose_GT_c2w = invert_poses(np.asarray(pose_GT_w2c, np.float64))
    R_gt = pose_GT_c2w[:, :3, :3]
    t_gt = pose_GT_c2w[:, :3, 3:4]
    R_al = np.swapaxes(sim3.R.astype(np.float64), -1, -2)[None] @ R_gt
    t_al = (np.swapaxes(sim3.R.astype(np.float64), -1, -2)[None] / sim3.s) @ (
        t_gt - sim3.t[None].astype(np.float64)
    )
    pose_c2w_aligned = np.concatenate([R_al, t_al], axis=-1)
    return invert_poses(pose_c2w_aligned).astype(np.float32)


# ---------------------------------------------------------------------------
# camera-pose evaluation (joint_pose_nerf_trainer.py:256-311)
# ---------------------------------------------------------------------------


def evaluate_camera_alignment(pose_aligned_w2c: np.ndarray, pose_GT_w2c: np.ndarray) -> dict:
    """Rotation (rad) and camera-center translation errors per pose."""
    pose_aligned_c2w = invert_poses(pose_aligned_w2c)
    pose_GT_c2w = invert_poses(pose_GT_w2c)
    R_err = rotation_distance_np(pose_aligned_c2w[..., :3, :3], pose_GT_c2w[..., :3, :3])
    t_err = np.linalg.norm(pose_aligned_c2w[..., :3, 3] - pose_GT_c2w[..., :3, 3], axis=-1)
    return dict(R=R_err, t=t_err)


def prealign_w2c_large_camera_systems(
    pose_w2c: np.ndarray, pose_GT_w2c: np.ndarray, n_first_fixed_poses: int = 0
) -> Tuple[np.ndarray, Sim3]:
    """sim3 trajectory alignment; use for >10 poses (joint trainer :127-157)."""
    if n_first_fixed_poses > 1:
        return np.asarray(pose_w2c, np.float32), identity_sim3()
    pose_c2w = invert_poses(pose_w2c)
    pose_GT_c2w = invert_poses(pose_GT_w2c)
    try:
        aligned_c2w, sim3 = align_ate_c2b_use_a2b(pose_c2w, pose_GT_c2w, method="sim3")
        return invert_poses(aligned_c2w[:, :3]).astype(np.float32), sim3
    except np.linalg.LinAlgError:
        return np.asarray(pose_w2c, np.float32), identity_sim3()


def prealign_w2c_small_camera_systems(
    pose_w2c: np.ndarray, pose_GT_w2c: np.ndarray, n_first_fixed_poses: int = 0
) -> Tuple[np.ndarray, Sim3]:
    """Exhaustive pairwise two-camera alignment, robust for <10 views
    (joint_pose_nerf_trainer.py:160-254)."""
    pose_w2c = np.asarray(pose_w2c, np.float64)
    pose_GT_w2c = np.asarray(pose_GT_w2c, np.float64)
    if n_first_fixed_poses > 1:
        return pose_w2c.astype(np.float32), identity_sim3()

    pose_c2w = pad_poses(invert_poses(pose_w2c))
    pose_GT_c2w = pad_poses(invert_poses(pose_GT_w2c))
    B = pose_c2w.shape[0]

    def alignment_function(idx_a: int, idx_b: int):
        src = pose_c2w.copy()
        dist_from = np.linalg.norm(src[idx_a, :3, 3] - src[idx_b, :3, 3])
        dist_to = np.linalg.norm(pose_GT_c2w[idx_a, :3, 3] - pose_GT_c2w[idx_b, :3, 3])
        scale = dist_to / max(dist_from, 1e-12)
        src[:, :3, 3] *= scale
        T = pose_GT_c2w[idx_a] @ np.linalg.inv(src[idx_a])
        aligned_c2w = T[None] @ src
        aligned_w2c = invert_poses(aligned_c2w)
        sim3 = Sim3(
            R=T[:3, :3].astype(np.float32), t=T[:3, 3].reshape(3, 1).astype(np.float32), s=float(scale)
        )
        return aligned_w2c, sim3

    best = None
    for a in range(min(B, 10)):
        for b in range(min(B, 10)):
            if a == b:
                continue
            aligned_w2c, sim3 = alignment_function(a, b)
            err = evaluate_camera_alignment(aligned_w2c, pose_GT_w2c)
            score = err["t"].mean() * (err["R"].mean() * 180.0 / math.pi)
            if best is None or score < best[0]:
                best = (score, aligned_w2c, sim3)
    assert best is not None
    return best[1].astype(np.float32), best[2]


def evaluate_any_poses(pose_w2c: np.ndarray, pose_GT_w2c: np.ndarray) -> dict:
    """Rot/trans errors before and after alignment (joint trainer :289-311)."""
    pose_w2c = np.asarray(pose_w2c)
    stats = {}
    err = evaluate_camera_alignment(pose_w2c, pose_GT_w2c)
    stats["error_R_before_align"] = float(err["R"].mean() * 180.0 / math.pi)
    stats["error_t_before_align"] = float(err["t"].mean())
    if pose_w2c.shape[0] > 10:
        aligned, _ = prealign_w2c_large_camera_systems(pose_w2c, pose_GT_w2c)
    else:
        aligned, _ = prealign_w2c_small_camera_systems(pose_w2c, pose_GT_w2c)
    err = evaluate_camera_alignment(aligned, pose_GT_w2c)
    stats["error_R"] = float(err["R"].mean() * 180.0 / math.pi)
    stats["error_t"] = float(err["t"].mean())
    return stats


# ---------------------------------------------------------------------------
# initial-pose normalization (align_trajectories.py:105-192)
# ---------------------------------------------------------------------------


def align_translations(pose_GT_w2c: np.ndarray, initial_poses_w2c: np.ndarray):
    """Center the initial camera positions on the GT mean camera position."""
    pose_GT_c2w = pad_poses(invert_poses(np.asarray(pose_GT_w2c, np.float64)))
    init_c2w = pad_poses(invert_poses(np.asarray(initial_poses_w2c, np.float64)))
    trans_error = pose_GT_c2w[:, :3, 3].mean(0) - init_c2w[:, :3, 3].mean(0)
    init_c2w[:, :3, 3] += trans_error[None]
    return pad_poses(invert_poses(init_c2w)).astype(np.float32), 1.0


def align_to_first_camera(pose_GT_w2c: np.ndarray, initial_poses_w2c: np.ndarray):
    """Re-express initial poses relative to cam0 = GT cam0, rescale + recenter."""
    pose_GT_w2c_p = pad_poses(np.asarray(pose_GT_w2c, np.float64))
    init_w2c = pad_poses(np.asarray(initial_poses_w2c, np.float64))

    init_w2c[1:] = init_w2c[1:] @ np.linalg.inv(init_w2c[0])[None]
    init_w2c[0] = pose_GT_w2c_p[0]
    init_w2c[1:] = init_w2c[1:] @ init_w2c[0][None]

    pose_GT_c2w = invert_poses(pose_GT_w2c_p)
    init_c2w = pad_poses(invert_poses(init_w2c))

    rel = init_w2c[0] @ np.linalg.inv(init_w2c[1])
    if np.any(rel[:3, 3] == 0.0):
        translation_scaling = 1.0
    else:
        GT_rel = pose_GT_w2c_p[0] @ np.linalg.inv(pose_GT_w2c_p[1])
        translation_scaling = float(np.abs(GT_rel[:3, 3] / rel[:3, 3]).mean())
    init_c2w[:, :3, 3] *= translation_scaling

    trans_error = pose_GT_c2w[:, :3, 3].mean(0) - init_c2w[:, :3, 3].mean(0)
    init_c2w[:, :3, 3] += trans_error[None]
    return pad_poses(invert_poses(init_c2w)).astype(np.float32), translation_scaling
