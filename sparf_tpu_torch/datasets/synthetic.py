"""The synthetic analytic scene (ray-traced textured spheres with exact GT
depth), with the port's own camera for ray generation.

The scene, `ray_trace`, `look_at_pose_w2c` and `apply_photometric_perturbation`
are numpy, copied from the JAX package's loader so that both render the same
views; `render_view` generates the rays with the port's camera.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sparf_tpu_torch.datasets import base
from sparf_tpu_torch.utils import camera

# scene definition: spheres (center xyz, radius, albedo rgb)
SPHERES = np.array(
    [
        # x, y, z, r, R, G, B
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


def look_at_pose_w2c(eye: np.ndarray, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """OpenCV w2c [R|t] looking from eye toward target, +z forward, y down."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up_world = np.array([0.0, -1.0, 0.0])
    right = np.cross(up_world, fwd)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_c2w = np.stack([right, down, fwd], axis=1)  # columns = camera axes in world
    R = R_c2w.T
    t = -R @ eye
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def _value_noise3(pts: np.ndarray, freq: float, seed: int) -> np.ndarray:
    """Deterministic aperiodic 3-D value noise in [-1,1], (N,).

    Hash-based lattice + smoothstep trilinear interpolation — the aperiodic
    texture statistics of real photographs. (Periodic sine octaves were
    tried first and are ADVERSARIAL for matching: ZNCC locks onto the wrong
    period with cycle-consistent errors that poison pose estimation.)"""
    p = pts.astype(np.float64) * freq
    p0 = np.floor(p)
    f = p - p0
    f = f * f * (3.0 - 2.0 * f)
    i0 = p0.astype(np.int64).astype(np.uint64)

    def hashv(ix, iy, iz):
        h = (ix * np.uint64(73856093)
             ^ iy * np.uint64(19349663)
             ^ iz * np.uint64(83492791)
             ^ np.uint64(seed * 2654435761 + 1))
        h = (h ^ (h >> np.uint64(13))) * np.uint64(1274126177)
        h = h ^ (h >> np.uint64(16))
        return (h & np.uint64(0xFFFF)).astype(np.float64) / 65535.0

    one = np.uint64(1)
    n = 0.0
    for dx, wx in ((0, 1 - f[:, 0]), (1, f[:, 0])):
        for dy, wy in ((0, 1 - f[:, 1]), (1, f[:, 1])):
            for dz, wz in ((0, 1 - f[:, 2]), (1, f[:, 2])):
                v = hashv(i0[:, 0] + np.uint64(dx) * one,
                          i0[:, 1] + np.uint64(dy) * one,
                          i0[:, 2] + np.uint64(dz) * one)
                n = n + v * wx * wy * wz
    return 2.0 * n - 1.0


def _albedo_texture(pts: np.ndarray, octaves: int) -> np.ndarray:
    """World-anchored view-independent procedural texture, (N,1) in ~[0.4,1.1].

    Octave 1 is the original broad-stripe pattern (wavelength ~ sphere
    radius). Higher octaves add band-limited APERIODIC detail (value noise) —
    at 300x400 the octave-3 feature size is ~8 px. Default stays 1 octave so
    low-resolution fixtures keep their exact appearance."""
    tex = (
        0.75
        + 0.125 * np.sin(14.0 * pts[:, 0] + 23.0 * pts[:, 1])
        + 0.125 * np.sin(19.0 * pts[:, 1] * pts[:, 2] + 7.0 * pts[:, 0])
    )
    if octaves >= 2:
        tex = tex + 0.10 * _value_noise3(pts, 12.0, 11)
    if octaves >= 3:
        tex = tex + 0.07 * _value_noise3(pts, 38.0, 29)
    if octaves >= 4:
        tex = tex + 0.05 * _value_noise3(pts, 90.0, 47)
    return tex[:, None]


def ray_trace(
    centers: np.ndarray, dirs: np.ndarray, texture_octaves: int = 1,
    specular: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Closed-form sphere intersection; returns (rgb (N,3), depth (N,), hit (N,)).

    `depth` is the ray parameter t (z-depth convention when dirs are
    K^-1-scaled, matching the renderer's expected-depth output).

    `specular` > 0 adds a white Blinn-Phong lobe (exponent 48) — a
    VIEW-DEPENDENT highlight that breaks the lambertian photometric-constancy
    assumption, stress-testing the matcher like real glossy DTU materials
    (VERDICT r2 #3).
    """
    N = centers.shape[0]
    best_t = np.full(N, np.inf, np.float32)
    best_rgb = np.tile(BG_COLOR, (N, 1))
    for cx, cy, cz, r, cr, cg, cb in SPHERES:
        oc = centers - np.array([cx, cy, cz], np.float32)
        a = np.sum(dirs * dirs, axis=-1)
        b = 2 * np.sum(oc * dirs, axis=-1)
        c = np.sum(oc * oc, axis=-1) - r * r
        disc = b * b - 4 * a * c
        hit = disc > 0
        sq = np.sqrt(np.maximum(disc, 0))
        t = (-b - sq) / (2 * a)
        valid = hit & (t > 1e-3) & (t < best_t)
        if not np.any(valid):
            continue
        pts = centers[valid] + dirs[valid] * t[valid, None]
        normal = (pts - np.array([cx, cy, cz], np.float32)) / r
        lam = np.clip(-(normal @ LIGHT_DIR), 0.0, 1.0)
        shade = (0.35 + 0.65 * lam)[:, None]
        # procedural 3D texture (world-anchored, view-independent): makes the
        # scene matchable by appearance and well-conditioned for pose recovery
        tex = _albedo_texture(pts, texture_octaves)
        rgb_v = shade * tex * np.array([cr, cg, cb], np.float32)
        if specular > 0:
            view = -dirs[valid] / np.linalg.norm(dirs[valid], axis=-1, keepdims=True)
            half = view - LIGHT_DIR
            half /= np.linalg.norm(half, axis=-1, keepdims=True)
            spec = specular * np.clip(np.sum(normal * half, -1), 0, 1) ** 48
            rgb_v = rgb_v + spec[:, None]
        best_t[valid] = t[valid]
        best_rgb[valid] = rgb_v
    hit_mask = np.isfinite(best_t)
    depth = np.where(hit_mask, best_t, 0.0).astype(np.float32)
    return best_rgb.astype(np.float32), depth, hit_mask


def apply_photometric_perturbation(
    img: np.ndarray, rng: np.random.RandomState,
    exposure_jitter: float = 0.0, wb_jitter: float = 0.0,
    noise_sigma: float = 0.0, vignette: float = 0.0,
) -> np.ndarray:
    """Camera-realistic per-view corruption of an (H,W,3) image in [0,1]:
    exposure shift (+-stops), white-balance gain, radial vignetting falloff,
    additive sensor noise. Deterministic given `rng` (VERDICT r2 #3 —
    photometric-reality hardening rungs)."""
    H, W, _ = img.shape
    out = img.astype(np.float32)
    if exposure_jitter > 0:
        out = out * 2.0 ** rng.uniform(-exposure_jitter, exposure_jitter)
    if wb_jitter > 0:
        out = out * np.exp(rng.uniform(-wb_jitter, wb_jitter, 3))[None, None, :]
    if vignette > 0:
        yy = (np.arange(H) / max(H - 1, 1) - 0.5)[:, None]
        xx = (np.arange(W) / max(W - 1, 1) - 0.5)[None, :]
        r2 = (xx**2 + yy**2) / 0.5
        k = rng.uniform(0.5, 1.0) * vignette
        out = out * (1.0 - k * r2)[..., None]
    if noise_sigma > 0:
        out = out + rng.normal(0.0, noise_sigma, out.shape)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def render_view(pose_w2c: np.ndarray, intr: np.ndarray, H: int, W: int,
                texture_octaves: int = 1, specular: float = 0.0):
    """Analytic render: (image (H,W,3), depth (H,W), fg (H,W))."""
    center, ray = camera.get_center_and_ray(
        torch.as_tensor(pose_w2c[None]), H, W, torch.as_tensor(intr[None].astype(np.float32)))
    rgb, depth, hit = ray_trace(center[0].numpy(), ray[0].numpy(), texture_octaves, specular)
    return rgb.reshape(H, W, 3), depth.reshape(H, W), hit.reshape(H, W)


def load_synthetic_scene(
    root: str = "",
    scene: str = "spheres",
    split: str = "train",
    train_sub: Optional[int] = None,
    val_sub: Optional[int] = None,
    H: int = 60,
    W: int = 80,
    n_train: int = 6,
    n_test: int = 3,
    increase_depth_range_by_x_percent: float = 0.0,
    angular_span: float = 1.0,
    texture_octaves: int = 1,
    specular: float = 0.0,
    exposure_jitter: float = 0.0,
    wb_jitter: float = 0.0,
    noise_sigma: float = 0.0,
    vignette: float = 0.0,
    photo_seed: int = 7,
    **_unused,
) -> base.Scene:
    """Procedural scene, the same views as the JAX package's synthetic loader."""
    focal = 0.9 * W
    intr = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    n_total = n_train + n_test
    angles = np.linspace(-0.5, 0.5, n_total) * angular_span
    heights = 0.35 * angular_span * np.sin(np.linspace(0, 2.3, n_total))
    eyes = np.stack([np.sin(angles) * CAM_RADIUS, heights, -np.cos(angles) * CAM_RADIUS], -1)
    poses = np.stack([look_at_pose_w2c(e) for e in eyes])

    test_ids = list(np.linspace(1, n_total - 2, n_test).round().astype(int)) if n_test else []
    train_ids = [i for i in range(n_total) if i not in test_ids][:n_train]
    indices = train_ids if split == "train" else test_ids
    if split == "train" and train_sub is not None:
        indices = indices[:train_sub]
    if split != "train" and val_sub is not None:
        indices = indices[:val_sub]

    perturb = exposure_jitter > 0 or wb_jitter > 0 or noise_sigma > 0 or vignette > 0
    samples = []
    for local_i, idx in enumerate(indices):
        img, depth, fg = render_view(poses[idx], intr, H, W, texture_octaves, specular)
        if perturb:
            img = apply_photometric_perturbation(
                img, np.random.RandomState(photo_seed * 1000 + idx),
                exposure_jitter=exposure_jitter, wb_jitter=wb_jitter,
                noise_sigma=noise_sigma, vignette=vignette)
        samples.append(dict(
            idx=local_i,
            rgb_path=f"view{idx:03d}.png",
            image=base.image_to_chw01(img),
            intr=intr.copy(),
            pose=poses[idx],
            depth_range=np.array([NEAR, FAR], np.float32),
            depth_gt=depth,
            valid_depth_gt=fg,
            fg_mask=fg[None],
        ))
    out = base.stack_scene(samples)
    out["scene"] = scene
    return base.apply_increase_depth_range(out, increase_depth_range_by_x_percent)
