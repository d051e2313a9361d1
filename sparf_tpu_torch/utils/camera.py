"""Camera poses, Lie-group math, quaternions and ray generation (torch port of
sparf_tpu/utils/camera.py).

Conventions:
  - poses are world-to-camera (w2c) ``[R|t]`` matrices of shape ``(..., 3, 4)``,
    OpenCV axes [right, down, forward]; projection is ``u = K (R x + t)``;
  - pixel centers sit at integer+0.5;
  - ``compose([p1, p2, ..., pN])(x) = pN(... p2(p1(x)))``.

The JAX package wraps this math in `f32_matmuls` because the TPU's default
matmul is one bf16 pass. Here float32 matmuls are full float32 as long as
TF32 stays off (`torch.backends.cuda.matmul.allow_tf32 = False`, PyTorch's
default, which chip_smoke.py also sets).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sparf_tpu_torch.utils import tracing


def to_hom(x: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last dim: (..., K) -> (..., K+1)."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


# ---------------------------------------------------------------------------
# Pose ([R|t], (...,3,4)) operations
# ---------------------------------------------------------------------------


def pose_from_rt(R: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Construct (...,3,4) pose from R (...,3,3) and/or t (...,3)."""
    if R is None and t is None:
        raise ValueError("pose_from_rt needs R or t")
    if R is None:
        t = torch.as_tensor(t, dtype=torch.float32)
        R = torch.eye(3, dtype=torch.float32, device=t.device).expand(*t.shape[:-1], 3, 3)
    elif t is None:
        R = torch.as_tensor(R, dtype=torch.float32)
        t = torch.zeros(R.shape[:-1], dtype=torch.float32, device=R.device)
    else:
        R = torch.as_tensor(R, dtype=torch.float32)
        t = torch.as_tensor(t, dtype=torch.float32, device=R.device).expand(R.shape[:-1])
    return torch.cat([R, t[..., None]], dim=-1)


def pose_invert(pose: torch.Tensor) -> torch.Tensor:
    """Invert (...,3,4) rigid pose: R' = R^T, t' = -R^T t."""
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    return pose_from_rt(R_inv, -(R_inv @ t)[..., 0])


def pose_compose_pair(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """pose_new(x) = pose_b(pose_a(x)): R = R_b R_a, t = R_b t_a + t_b."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return pose_from_rt(R_b @ R_a, (R_b @ t_a + t_b)[..., 0])


def pose_compose(pose_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """compose([p1..pN])(x) = pN(...p1(x)) (first pose applied first)."""
    out = pose_list[0]
    for p in pose_list[1:]:
        out = pose_compose_pair(out, p)
    return out


def pose_to_4x4(pose: torch.Tensor) -> torch.Tensor:
    """(...,3,4) -> (...,4,4) homogeneous."""
    bottom = torch.zeros((*pose.shape[:-2], 1, 4), dtype=pose.dtype, device=pose.device)
    # a host number into a device tensor: a copy the device has to finish first
    with tracing.wait("camera.pose_to_4x4"):
        bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], dim=-2)


def pose_inverse_4x4(mat: torch.Tensor) -> torch.Tensor:
    """Invert (...,4,4) rigid transform without a matrix inverse."""
    R, t = mat[..., :3, :3], mat[..., :3, 3:]
    R_inv = R.transpose(-1, -2)
    return pose_to_4x4(torch.cat([R_inv, -(R_inv @ t)], dim=-1))


# ---------------------------------------------------------------------------
# world/camera/image transforms
# ---------------------------------------------------------------------------


def world2cam(x_world: torch.Tensor, pose_w2c: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) world points -> camera frame via (...,3,4) w2c pose."""
    return to_hom(x_world) @ pose_w2c.transpose(-1, -2)


def cam2world(x_cam: torch.Tensor, pose_w2c: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) camera points -> world frame via (...,3,4) w2c pose."""
    return to_hom(x_cam) @ pose_invert(pose_w2c).transpose(-1, -2)


def cam2img(x: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) camera points -> homogeneous image coords via K (...,3,3)."""
    return x @ intr.transpose(-1, -2)


def img2cam(x: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) homogeneous pixels -> camera coords via K^-1."""
    return x @ intr_inverse(intr).transpose(-1, -2)


def intr_inverse(intr: torch.Tensor) -> torch.Tensor:
    """K^-1 (...,3,3). The inverse checks its result on the host: a wait on a
    CUDA device."""
    with tracing.wait("camera.intr_inverse"):
        return torch.linalg.inv(intr)


# ---------------------------------------------------------------------------
# Lie algebra so(3)/SO(3), se(3)/SE(3)
# ---------------------------------------------------------------------------


def skew_symmetric(w: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) cross-product matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([zeros, -w2, w1], dim=-1),
        torch.stack([w2, zeros, -w0], dim=-1),
        torch.stack([-w1, w0, zeros], dim=-1),
    ], dim=-2)


def _taylor_poly_sq(x2: torch.Tensor, coeff_denoms: Sequence[float]) -> torch.Tensor:
    """sum_i (-1)^i x2^i / denom_i, an even polynomial evaluated from x^2.

    Taking x^2 (not x) keeps gradients finite at the identity: it avoids the
    non-differentiable sqrt in ||w||. Accurate for |x| <= pi at 10th order.
    """
    out = torch.zeros_like(x2)
    term = torch.ones_like(x2)
    for i, denom in enumerate(coeff_denoms):
        out = out + ((-1.0) ** i) * term / denom
        term = term * x2
    return out


def _denoms(kind: str, nth: int = 10):
    denoms, acc = [], 1.0
    for i in range(nth + 1):
        if kind == "A":  # sin(x)/x
            if i > 0:
                acc *= (2 * i) * (2 * i + 1)
        elif kind == "B":  # (1-cos x)/x^2
            acc *= (2 * i + 1) * (2 * i + 2)
        elif kind == "C":  # (x-sin x)/x^3
            acc *= (2 * i + 2) * (2 * i + 3)
        denoms.append(acc)
    return denoms


_DENOMS_A = _denoms("A")
_DENOMS_B = _denoms("B")
_DENOMS_C = _denoms("C")


def taylor_A(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x as a 10th-order even polynomial (smooth at 0)."""
    return _taylor_poly_sq(x * x, _DENOMS_A)


def taylor_B(x: torch.Tensor) -> torch.Tensor:
    """(1-cos(x))/x^2."""
    return _taylor_poly_sq(x * x, _DENOMS_B)


def taylor_C(x: torch.Tensor) -> torch.Tensor:
    """(x-sin(x))/x^3."""
    return _taylor_poly_sq(x * x, _DENOMS_C)


def so3_to_SO3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    wx = skew_symmetric(w)
    theta_sq = torch.sum(w * w, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    A = _taylor_poly_sq(theta_sq, _DENOMS_A)
    B = _taylor_poly_sq(theta_sq, _DENOMS_B)
    return eye + A * wx + B * (wx @ wx)


def SO3_to_so3(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Log map: (...,3,3) -> (...,3); theta wrapped mod pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))
    theta = torch.remainder(theta, math.pi)[..., None, None]
    lnR = 1 / (2 * taylor_A(theta) + 1e-8) * (R - R.transpose(-2, -1))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    """(...,6) [w|u] twist -> (...,3,4) pose."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew_symmetric(w)
    theta_sq = torch.sum(w * w, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    A = _taylor_poly_sq(theta_sq, _DENOMS_A)
    B = _taylor_poly_sq(theta_sq, _DENOMS_B)
    C = _taylor_poly_sq(theta_sq, _DENOMS_C)
    wx2 = wx @ wx
    R = eye + A * wx + B * wx2
    V = eye + B * wx + C * wx2
    return torch.cat([R, V @ u[..., None]], dim=-1)


def SE3_to_se3(Rt: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(...,3,4) pose -> (...,6) twist."""
    R, t = Rt[..., :3], Rt[..., 3:]
    w = SO3_to_so3(R)
    wx = skew_symmetric(w)
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=Rt.dtype, device=Rt.device)
    A, B = taylor_A(theta), taylor_B(theta)
    invV = eye - 0.5 * wx + (1 - A / (2 * B)) / (theta**2 + eps) * (wx @ wx)
    return torch.cat([w, (invV @ t)[..., 0]], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def quaternion_to_R(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (...,4) [w,x,y,z] -> rotation matrix (...,3,3)."""
    qa, qb, qc, qd = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (qc**2 + qd**2), 2 * (qb * qc - qa * qd),
                     2 * (qa * qc + qb * qd)], dim=-1),
        torch.stack([2 * (qb * qc + qa * qd), 1 - 2 * (qb**2 + qd**2),
                     2 * (qc * qd - qa * qb)], dim=-1),
        torch.stack([2 * (qb * qd - qa * qc), 2 * (qa * qb + qc * qd),
                     1 - 2 * (qb**2 + qc**2)], dim=-1),
    ], dim=-2)


def R_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> unit quaternion (...,4) [w,x,y,z] (branchless
    Shepperd method, canonical sign w >= 0)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)
    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_product(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product (...,4)x(...,4) -> (...,4)."""
    q1a, q1b, q1c, q1d = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    q2a, q2b, q2c, q2d = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        q1a * q2a - q1b * q2b - q1c * q2c - q1d * q2d,
        q1a * q2b + q1b * q2a + q1c * q2d - q1d * q2c,
        q1a * q2c - q1b * q2d + q1c * q2a + q1d * q2b,
        q1a * q2d + q1b * q2c - q1c * q2b + q1d * q2a,
    ], dim=-1)


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------


def rotation_distance(R1: torch.Tensor, R2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle between rotation matrices, radians."""
    R_diff = R1 @ R2.transpose(-2, -1)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1) / 2, -1 + eps, 1 - eps))


def procrustes_analysis(X0: np.ndarray, X1: np.ndarray) -> dict:
    """sim3 {t0,t1,s0,s1,R} aligning point sets; X1->X0 is ((X1-t1)/s1)R^T s0+t0.

    Host numpy in float64 (the eval and alignment path only), as the JAX
    package computes it."""
    X0 = np.asarray(X0, np.float64)
    X1 = np.asarray(X1, np.float64)
    t0, t1 = X0.mean(axis=0), X1.mean(axis=0)
    X0c, X1c = X0 - t0, X1 - t1
    s0 = max(np.sqrt((X0c**2).sum(-1).mean()), 1e-12)
    s1 = max(np.sqrt((X1c**2).sum(-1).mean()), 1e-12)
    U, _, Vh = np.linalg.svd((X0c / s0).T @ (X1c / s1), full_matrices=False)
    R = U @ Vh
    if np.linalg.det(R) < 0:
        R[2] *= -1
    return dict(t0=t0.astype(np.float32), t1=t1.astype(np.float32), s0=np.float32(s0),
                s1=np.float32(s1), R=R.astype(np.float32))


def angle_to_rotation_matrix(a: torch.Tensor, axis: str) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) by the angles a around axis X, Y or Z."""
    roll = dict(X=1, Y=2, Z=0)[axis]
    zeros, ones = torch.zeros_like(a), torch.ones_like(a)
    M = torch.stack([torch.stack([torch.cos(a), -torch.sin(a), zeros], -1),
                     torch.stack([torch.sin(a), torch.cos(a), zeros], -1),
                     torch.stack([zeros, zeros, ones], -1)], dim=-2)
    return torch.roll(M, shifts=(roll, roll), dims=(-2, -1))


def get_novel_view_poses(pose_anchor: torch.Tensor, N: int = 60, scale: float = 1.0
                         ) -> torch.Tensor:
    """N w2c poses (N, 3, 4) oscillating around the anchor w2c pose (3, 4):
    a rotation of up to asin(0.1) about a point 4 * scale in front of the
    camera, shifted back by 3.8 * scale."""
    dev = pose_anchor.device
    theta = torch.arange(N, dtype=torch.float32, device=dev) / N * 2 * math.pi
    R_x = angle_to_rotation_matrix(torch.arcsin(torch.sin(theta) * 0.1), "X")
    R_y = angle_to_rotation_matrix(torch.arcsin(torch.cos(theta) * 0.1), "Y")
    pose_rot = pose_from_rt(R=R_y @ R_x)
    pose_shift = pose_from_rt(t=torch.tensor([0.0, 0.0, -4 * scale], device=dev))
    pose_shift2 = pose_from_rt(t=torch.tensor([0.0, 0.0, 3.8 * scale], device=dev))
    pose_oscil = pose_compose([pose_shift, pose_rot, pose_shift2])
    return pose_compose([pose_oscil, pose_anchor[None]])


def get_pixel_grid(H: int, W: int, device=None) -> torch.Tensor:
    """(H*W, 2) pixel-center coordinates (x+0.5, y+0.5), row-major over y."""
    y = torch.arange(H, dtype=torch.float32, device=device) + 0.5
    x = torch.arange(W, dtype=torch.float32, device=device) + 0.5
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y], dim=-1).reshape(-1, 2)


def get_center_and_ray_at_pixels(pose_w2c: torch.Tensor, pixels: torch.Tensor,
                                 intr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera centers + (unnormalized) ray directions at given pixels.

    pose_w2c (B,3,4); pixels (N,2) shared across the batch or (B,N,2);
    intr (B,3,3). Returns center, ray (B,N,3); ray = R_c2w K^-1 [u,v,1].
    """
    B = pose_w2c.shape[0]
    if pixels.ndim == 2:
        pixels = pixels[None].expand(B, *pixels.shape)
    grid_3d = img2cam(to_hom(pixels), intr)
    center = cam2world(torch.zeros_like(grid_3d), pose_w2c)
    grid_world = cam2world(grid_3d, pose_w2c)
    return center, grid_world - center


def get_center_and_ray(pose_w2c: torch.Tensor, H: int, W: int, intr: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centers + rays at every pixel of an (H,W) image. Returns (B,HW,3) pairs."""
    return get_center_and_ray_at_pixels(pose_w2c, get_pixel_grid(H, W, pose_w2c.device), intr)


def get_3d_points_from_depth(center: torch.Tensor, ray: torch.Tensor, depth: torch.Tensor,
                             multi_samples: bool = False) -> torch.Tensor:
    """x = c + t*d. depth: (B,N,S,1) if multi_samples else broadcastable to ray."""
    if multi_samples:
        center, ray = center[:, :, None], ray[:, :, None]
    return center + ray * depth


def convert_NDC(center: torch.Tensor, ray: torch.Tensor, intr: torch.Tensor,
                near: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift ray origins to the near plane and map to NDC."""
    center = center + (near - center[..., 2:]) / ray[..., 2:] * ray
    cx, cy, cz = center.unbind(-1)
    rx, ry, rz = ray.unbind(-1)
    scale_x = (intr[:, 0, 0] / intr[:, 0, 2])[:, None]
    scale_y = (intr[:, 1, 1] / intr[:, 1, 2])[:, None]
    center_ndc = torch.stack([scale_x * (cx / cz), scale_y * (cy / cz), 1 - 2 * near / cz], -1)
    ray_ndc = torch.stack([scale_x * (rx / rz - cx / cz), scale_y * (ry / rz - cy / cz),
                           2 * near / cz], -1)
    return center_ndc, ray_ndc

