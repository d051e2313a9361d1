"""Camera and projective geometry of the reference: frozen copies of the
functions of sparf_tpu_torch/utils/camera.py and utils/geometry.py that a
SPARF step and a render use, in the same order of operations. Plain torch."""
from __future__ import annotations

import torch


def to_hom(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def from_hom(x: torch.Tensor) -> torch.Tensor:
    return x[..., :-1] / (x[..., -1:] + 1e-6)


def pose_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R, t[..., None]], dim=-1)


def pose_invert(pose: torch.Tensor) -> torch.Tensor:
    R, t = pose[..., :3], pose[..., 3:]
    R_inv = R.transpose(-1, -2)
    return pose_from_rt(R_inv, -(R_inv @ t)[..., 0])


def pose_compose_pair(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """x -> pose_b(pose_a(x))."""
    R_a, t_a = pose_a[..., :3], pose_a[..., 3:]
    R_b, t_b = pose_b[..., :3], pose_b[..., 3:]
    return pose_from_rt(R_b @ R_a, (R_b @ t_a + t_b)[..., 0])


def pose_to_4x4(pose: torch.Tensor) -> torch.Tensor:
    bottom = torch.zeros((*pose.shape[:-2], 1, 4), dtype=pose.dtype, device=pose.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], dim=-2)


def pose_inverse_4x4(mat: torch.Tensor) -> torch.Tensor:
    R, t = mat[..., :3, :3], mat[..., :3, 3:]
    R_inv = R.transpose(-1, -2)
    return pose_to_4x4(torch.cat([R_inv, -(R_inv @ t)], dim=-1))


def world2cam(x: torch.Tensor, pose_w2c: torch.Tensor) -> torch.Tensor:
    return to_hom(x) @ pose_w2c.transpose(-1, -2)


def cam2world(x: torch.Tensor, pose_w2c: torch.Tensor) -> torch.Tensor:
    return to_hom(x) @ pose_invert(pose_w2c).transpose(-1, -2)


def cam2img(x: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    return x @ intr.transpose(-1, -2)


def img2cam(x: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    return x @ torch.linalg.inv(intr).transpose(-1, -2)


def _skew(w: torch.Tensor) -> torch.Tensor:
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w0)
    return torch.stack([torch.stack([z, -w2, w1], dim=-1), torch.stack([w2, z, -w0], dim=-1),
                        torch.stack([-w1, w0, z], dim=-1)], dim=-2)


def _denoms(kind: str, nth: int = 10):
    out, acc = [], 1.0
    for i in range(nth + 1):
        if kind == "A" and i > 0:
            acc *= (2 * i) * (2 * i + 1)
        elif kind == "B":
            acc *= (2 * i + 1) * (2 * i + 2)
        elif kind == "C":
            acc *= (2 * i + 2) * (2 * i + 3)
        out.append(acc)
    return out


def _taylor(x2: torch.Tensor, denoms) -> torch.Tensor:
    out, term = torch.zeros_like(x2), torch.ones_like(x2)
    for i, d in enumerate(denoms):
        out = out + ((-1.0) ** i) * term / d
        term = term * x2
    return out


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    """(...,6) twist [w|u] -> (...,3,4) pose (10th-order Taylor terms)."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = _skew(w)
    theta_sq = torch.sum(w * w, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    A, B, C = (_taylor(theta_sq, _denoms(k)) for k in "ABC")
    wx2 = wx @ wx
    R = eye + A * wx + B * wx2
    V = eye + B * wx + C * wx2
    return torch.cat([R, V @ u[..., None]], dim=-1)


def pixel_grid(H: int, W: int, device=None) -> torch.Tensor:
    """(H*W, 2) pixel centres (x+0.5, y+0.5), row-major over y."""
    y = torch.arange(H, dtype=torch.float32, device=device) + 0.5
    x = torch.arange(W, dtype=torch.float32, device=device) + 0.5
    Y, X = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([X, Y], dim=-1).reshape(-1, 2)


def center_and_ray_at_pixels(pose_w2c: torch.Tensor, pixels: torch.Tensor, intr: torch.Tensor):
    """pose (B,3,4); pixels (N,2) or (B,N,2); intr (B,3,3) -> center, ray (B,N,3)."""
    if pixels.ndim == 2:
        pixels = pixels[None].expand(pose_w2c.shape[0], *pixels.shape)
    grid_3d = img2cam(to_hom(pixels), intr)
    center = cam2world(torch.zeros_like(grid_3d), pose_w2c)
    return center, cam2world(grid_3d, pose_w2c) - center


def project_to_other_img(kpi, di, Ki, Kj, T_itoj):
    """Pixels of image i with depth -> (pixels in j (B,N,2), depth in j (B,N))."""
    pts = to_hom(kpi) @ torch.linalg.inv(Ki).transpose(-1, -2)
    pts = pts * di[..., None]
    pts_j = from_hom(to_hom(pts) @ T_itoj.transpose(-1, -2))
    return from_hom(pts_j @ Kj.transpose(-1, -2)), pts_j[..., -1]


def backproject_to_3d(kpi, di, Ki, T_itoj):
    pts = to_hom(kpi) @ torch.linalg.inv(Ki).transpose(-1, -2)
    pts = pts * di[..., None]
    return from_hom(to_hom(pts) @ T_itoj.transpose(-1, -2))


def sample_depth_at(pts: torch.Tensor, depth: torch.Tensor):
    """Bilinear depth at float pixels, nearest where a neighbour is a hole:
    (value, valid) (B,N)."""
    B, H, W = depth.shape
    x, y = pts[..., 0], pts[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    flat = depth.reshape(B, H * W)

    def gather(yi, xi):
        d = torch.gather(flat, 1, torch.clamp(yi.to(torch.int64), 0, H - 1) * W
                         + torch.clamp(xi.to(torch.int64), 0, W - 1))
        inb = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        return d, inb & (d > 0)

    d00, v00 = gather(y0, x0)
    d01, v01 = gather(y0, x1)
    d10, v10 = gather(y1, x0)
    d11, v11 = gather(y1, x1)
    wx, wy = x - x0, y - y0
    lin = (d00 * (1 - wy) * (1 - wx) + d01 * (1 - wy) * wx
           + d10 * wy * (1 - wx) + d11 * wy * wx)
    lin_valid = v00 & v01 & v10 & v11
    d_nn, nn_valid = gather(torch.round(y), torch.round(x))
    interp = torch.where(lin_valid, lin, d_nn)
    valid = lin_valid | nn_valid
    return torch.where(valid, interp, torch.zeros_like(interp)), valid
