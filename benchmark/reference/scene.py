"""What a SPARF training step stands on, worked out from the configuration
alone: the synthetic spheres scene, the GT-depth correspondence pools and
the initial poses.

Frozen copies of the arithmetic the program runs for the same purpose
(sparf_tpu_torch/datasets/synthetic.py, models/flow_net.py's gt_depth
backend, training/losses/corres.py's pools, training/joint_trainer.py's
initial poses), so that a later change to the program cannot move them.
Plain numpy and torch; imports nothing of the program.
"""
from __future__ import annotations

from itertools import permutations
from typing import Dict

import numpy as np
import torch

from benchmark.reference import geometry as geo

SPHERES = np.array(
    [
        [0.0, 0.0, 0.0, 0.55, 0.9, 0.2, 0.2],
        [0.7, 0.25, 0.35, 0.3, 0.2, 0.8, 0.3],
        [-0.65, -0.2, 0.4, 0.35, 0.25, 0.35, 0.95],
        [0.15, -0.55, -0.5, 0.28, 0.95, 0.85, 0.2],
        [-0.3, 0.55, -0.4, 0.22, 0.7, 0.3, 0.85],
    ],
    np.float32,
)
LIGHT_DIR = np.array([0.4, -0.7, -0.6], np.float32) / np.linalg.norm([0.4, -0.7, -0.6])
BG_COLOR = np.array([1.0, 1.0, 1.0], np.float32)
CAM_RADIUS = 3.0
NEAR, FAR = 1.5, 4.8


def look_at_pose_w2c(eye: np.ndarray) -> np.ndarray:
    """OpenCV w2c [R|t] looking from eye toward the origin, +z forward, y down."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1).T
    return np.concatenate([R, (-R @ eye)[:, None]], axis=1).astype(np.float32)


def ray_trace(centers: np.ndarray, dirs: np.ndarray):
    """Closed-form sphere intersection with the one-octave texture:
    (rgb (N,3), depth (N,), hit (N,))."""
    N = centers.shape[0]
    best_t = np.full(N, np.inf, np.float32)
    best_rgb = np.tile(BG_COLOR, (N, 1))
    for cx, cy, cz, r, cr, cg, cb in SPHERES:
        oc = centers - np.array([cx, cy, cz], np.float32)
        a = np.sum(dirs * dirs, axis=-1)
        b = 2 * np.sum(oc * dirs, axis=-1)
        c = np.sum(oc * oc, axis=-1) - r * r
        disc = b * b - 4 * a * c
        sq = np.sqrt(np.maximum(disc, 0))
        t = (-b - sq) / (2 * a)
        valid = (disc > 0) & (t > 1e-3) & (t < best_t)
        if not np.any(valid):
            continue
        pts = centers[valid] + dirs[valid] * t[valid, None]
        normal = (pts - np.array([cx, cy, cz], np.float32)) / r
        shade = (0.35 + 0.65 * np.clip(-(normal @ LIGHT_DIR), 0.0, 1.0))[:, None]
        tex = (0.75 + 0.125 * np.sin(14.0 * pts[:, 0] + 23.0 * pts[:, 1])
               + 0.125 * np.sin(19.0 * pts[:, 1] * pts[:, 2] + 7.0 * pts[:, 0]))[:, None]
        best_t[valid] = t[valid]
        best_rgb[valid] = shade * tex * np.array([cr, cg, cb], np.float32)
    hit = np.isfinite(best_t)
    return best_rgb.astype(np.float32), np.where(hit, best_t, 0.0).astype(np.float32), hit


def synthetic_train_scene(H: int, W: int, n_train: int, n_test: int,
                          increase_depth_range: float) -> Dict[str, np.ndarray]:
    """The train split of the spheres scene: image (N,3,H,W), intr, pose
    (N,3,4) w2c, depth_range (N,2), depth_gt and valid_depth_gt (N,H,W)."""
    focal = 0.9 * W
    intr = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    n_total = n_train + n_test
    angles = np.linspace(-0.5, 0.5, n_total)
    heights = 0.35 * np.sin(np.linspace(0, 2.3, n_total))
    eyes = np.stack([np.sin(angles) * CAM_RADIUS, heights, -np.cos(angles) * CAM_RADIUS], -1)
    poses = np.stack([look_at_pose_w2c(e) for e in eyes])
    test_ids = list(np.linspace(1, n_total - 2, n_test).round().astype(int)) if n_test else []
    train_ids = [i for i in range(n_total) if i not in test_ids][:n_train]
    images, depths, hits = [], [], []
    for idx in train_ids:
        center, ray = geo.center_and_ray_at_pixels(
            torch.as_tensor(poses[idx][None]), geo.pixel_grid(H, W),
            torch.as_tensor(intr[None]))
        rgb, depth, hit = ray_trace(center[0].numpy(), ray[0].numpy())
        images.append(np.transpose(rgb.reshape(H, W, 3), (2, 0, 1)))
        depths.append(depth.reshape(H, W))
        hits.append(hit.reshape(H, W))
    n = len(train_ids)
    near, far = np.float32(NEAR), np.float32(FAR)
    if increase_depth_range:
        near, far = (np.maximum(near - near * increase_depth_range, 1e-4),
                     far + far * increase_depth_range)
    return dict(image=np.stack(images).astype(np.float32),
                intr=np.stack([intr] * n), pose=poses[train_ids].astype(np.float32),
                depth_range=np.tile(np.array([near, far], np.float32), (n, 1)),
                depth_gt=np.stack(depths), valid_depth_gt=np.stack(hits))


def gt_pools(scene: Dict[str, np.ndarray], min_nbr_matches: int,
             rth: float = 0.05) -> Dict[str, np.ndarray]:
    """Fixed-size pixel pools of every ordered pair (target, source) whose
    GT-depth correspondences (in bounds and depth-consistent) number more
    than min_nbr_matches."""
    n_views, _, H, W = scene["image"].shape
    combi = np.array(list(permutations(range(n_views), 2)), np.int32).T
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    pixels = torch.as_tensor(np.stack([xx, yy], -1).reshape(1, -1, 2).astype(np.float32))
    t = torch.as_tensor
    kept = []
    for ti, si in combi.T:
        T = geo.pose_to_4x4(geo.pose_compose_pair(geo.pose_invert(t(scene["pose"][ti])),
                                                  t(scene["pose"][si])))[None]
        kpj, di_j = geo.project_to_other_img(
            pixels, t(scene["depth_gt"][ti].reshape(1, -1)), t(scene["intr"][ti: ti + 1]),
            t(scene["intr"][si: si + 1]), T)
        dj, validj = geo.sample_depth_at(kpj, t(scene["depth_gt"][si][None]))
        err = torch.abs(di_j - dj) / torch.clamp(dj, min=1e-8)
        vis = t(scene["valid_depth_gt"][ti].reshape(1, -1)) & (err < rth) & validj
        corres = kpj.numpy().reshape(H, W, 2).transpose(2, 0, 1)
        x, y = corres[0], corres[1]
        mask = vis.numpy().reshape(H, W) & (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
        if mask.sum() > min_nbr_matches:
            kept.append((ti, si, corres, mask))
    counts = [int(m.sum()) for *_, m in kept]
    n, p_max = len(kept), max(counts)
    pix_self = np.zeros((n, p_max, 2), np.float32)
    pix_other = np.zeros((n, p_max, 2), np.float32)
    conf = np.zeros((n, p_max), np.float32)
    for k, (ti, si, corres, mask) in enumerate(kept):
        ys, xs = np.where(mask)
        pix_self[k, : len(ys)] = np.stack([xs, ys], -1)
        pix_other[k, : len(ys)] = corres[:, ys, xs].T
        conf[k, : len(ys)] = 1.0
    return dict(pool_pix_self=pix_self, pool_pix_other=pix_other, pool_conf=conf,
                pool_count=np.asarray(counts, np.int64),
                pair_ids=np.asarray([[ti, si] for ti, si, *_ in kept], np.int64))


def initial_poses_w2c(kind: str, pose_gt_w2c: np.ndarray, noise: float, seed: int
                      ) -> np.ndarray:
    """(N,3,4) float32: "noisy_gt" composes se(3) noise drawn from a CPU
    torch.Generator seeded by `seed` with the GT poses; "identity" puts every
    camera at the identity rotation, centred on the GT cameras' mean
    position."""
    n = pose_gt_w2c.shape[0]
    if kind == "noisy_gt":
        gen = torch.Generator().manual_seed(int(seed))
        pose_noise = geo.se3_to_SE3(torch.randn((n, 6), generator=gen) * noise)
        return geo.pose_compose_pair(pose_noise, torch.as_tensor(pose_gt_w2c)).numpy()
    if kind == "identity":
        def inv(p):
            R = np.swapaxes(p[..., :3, :3], -1, -2)
            return np.concatenate([R, -R @ p[..., :3, 3:]], axis=-1)

        gt_c2w = inv(np.asarray(pose_gt_w2c, np.float64))
        init_c2w = inv(np.broadcast_to(np.eye(3, 4), (n, 3, 4)).astype(np.float64))
        init_c2w[:, :3, 3] += (gt_c2w[:, :3, 3].mean(0) - init_c2w[:, :3, 3].mean(0))[None]
        return inv(init_c2w).astype(np.float32)
    raise ValueError(f"initial poses {kind!r} are not in the benchmark's reference")
