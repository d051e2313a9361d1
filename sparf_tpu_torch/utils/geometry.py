"""Batched projective geometry (torch port of sparf_tpu/utils/geometry.py).

Back-projection by depth, cross-image reprojection, depth-map sampling with a
bilinear/nearest fallback. "Invalid" is a boolean mask, never NaN control flow.
"""
from __future__ import annotations

from typing import Tuple

import torch

from sparf_tpu_torch.utils import camera


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def from_homogeneous(points: torch.Tensor) -> torch.Tensor:
    return points[..., :-1] / (points[..., -1:] + 1e-6)


def batch_backproject_to_3d(kpi: torch.Tensor, di: torch.Tensor, Ki: torch.Tensor,
                            T_itoj: torch.Tensor) -> torch.Tensor:
    """Backproject pixels of image i by depth and express them in frame j.

    kpi (B,N,2) pixels; di (B,N) depths; Ki (B,3,3); T_itoj (B,4,4).
    Returns (B,N,3).
    """
    pts3d_i = to_homogeneous(kpi) @ camera.intr_inverse(Ki).transpose(-1, -2)
    pts3d_i = pts3d_i * di[..., None]
    return from_homogeneous(to_homogeneous(pts3d_i) @ T_itoj.transpose(-1, -2))


def batch_project(kpi_3d: torch.Tensor, T_itoj: torch.Tensor, Kj: torch.Tensor) -> torch.Tensor:
    """Project 3D points in frame i into image j: (B,N,3) -> (B,N,2)."""
    kpi_3d_j = from_homogeneous(to_homogeneous(kpi_3d) @ T_itoj.transpose(-1, -2))
    return from_homogeneous(kpi_3d_j @ Kj.transpose(-1, -2))


def batch_project_to_other_img(kpi: torch.Tensor, di: torch.Tensor, Ki: torch.Tensor,
                               Kj: torch.Tensor, T_itoj: torch.Tensor,
                               return_depth: bool = False):
    """Project pixels of image i (with depth) into image j.

    kpi (B,N,2), di (B,N), Ki/Kj (B,3,3), T_itoj (B,4,4).
    Returns kpi_j (B,N,2) [, di_j (B,N), the depth in frame j].
    """
    kpi_3d_i = to_homogeneous(kpi) @ camera.intr_inverse(Ki).transpose(-1, -2)
    kpi_3d_i = kpi_3d_i * di[..., None]
    kpi_3d_j = from_homogeneous(to_homogeneous(kpi_3d_i) @ T_itoj.transpose(-1, -2))
    kpi_j = from_homogeneous(kpi_3d_j @ Kj.transpose(-1, -2))
    if return_depth:
        return kpi_j, kpi_3d_j[..., -1]
    return kpi_j


def sample_depth_at(pts: torch.Tensor, depth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample a depth map at float pixel coords with validity handling.

    Bilinear interpolation treating depth <= 0 as holes; where any bilinear
    neighbour is a hole, fall back to nearest neighbour (align_corners
    semantics: grid point k is pixel index k).

    pts (B,N,2) xy pixel coords; depth (B,H,W). Returns (interp, valid) (B,N).
    """
    B, H, W = depth.shape
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    flat = depth.reshape(B, H * W)

    def gather(yi, xi):
        yi_c = torch.clamp(yi.to(torch.int64), 0, H - 1)
        xi_c = torch.clamp(xi.to(torch.int64), 0, W - 1)
        d = torch.gather(flat, 1, yi_c * W + xi_c)
        inb = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        return d, inb & (d > 0)

    d00, v00 = gather(y0, x0)
    d01, v01 = gather(y0, x1)
    d10, v10 = gather(y1, x0)
    d11, v11 = gather(y1, x1)
    wx, wy = x - x0, y - y0
    interp_lin = (d00 * (1 - wy) * (1 - wx) + d01 * (1 - wy) * wx
                  + d10 * wy * (1 - wx) + d11 * wy * wx)
    lin_valid = v00 & v01 & v10 & v11
    d_nn, nn_valid = gather(torch.round(y), torch.round(x))
    interp = torch.where(lin_valid, interp_lin, d_nn)
    valid = lin_valid | nn_valid
    return torch.where(valid, interp, torch.zeros_like(interp)), valid


def batch_project_to_other_img_and_check_depth(kpi, di, depthj, Ki, Kj, T_itoj, validi,
                                               rth: float = 0.1,
                                               return_repro_error: bool = False):
    """Project pixels i->j and keep those whose projected depth agrees with
    image j's depth map within relative threshold rth."""
    kpi_j, di_j = batch_project_to_other_img(kpi, di, Ki, Kj, T_itoj, return_depth=True)
    dj, validj = sample_depth_at(kpi_j, depthj)
    repro_error = torch.abs(di_j - dj) / torch.clamp(dj, min=1e-8)
    visible = validi & (repro_error < rth) & validj
    if return_repro_error:
        return kpi_j, visible, repro_error
    return kpi_j, visible


def pose_to_T4x4(pose_w2c: torch.Tensor) -> torch.Tensor:
    """(...,3,4) -> (...,4,4)."""
    return camera.pose_to_4x4(pose_w2c)


def relative_transform_i_to_j(pose_i_w2c: torch.Tensor, pose_j_w2c: torch.Tensor
                              ) -> torch.Tensor:
    """T_i->j = P_j @ P_i^{-1} as 4x4."""
    return pose_to_T4x4(camera.pose_compose_pair(camera.pose_invert(pose_i_w2c), pose_j_w2c))
