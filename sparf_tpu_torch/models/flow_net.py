"""Dense correspondence front-end (torch port of sparf_tpu/models/flow_net.py).

The matcher facade `FlowSelectionWrapper` routes to
  - 'gt_depth': exact correspondences from GT depth and GT poses;
  - 'PDCNet' / 'pdcnet_jax': the learned net of models/pdcnet.py, its raw
    flows (the bundled weights when no checkpoint is given);
  - 'SPSG': the sparse keypoint matcher of models/sparse_matcher.py;
  - 'zncc': the classical hierarchical ZNCC matcher, its appearance stage
    (stage 1: ZNCC pyramid, median filtering, subpixel fit, optional
    homography pre-alignment; cycle-consistency confidence).
With the scene's intrinsics, 'zncc' and PDC-Net with
`pdcnet_geometry_refine=True` (the presets' default) go on to the geometry
stage: mini-SfM poses from the stage-1 seeds (colmap_init/sfm.py on the
two-view and PnP solvers of utils/imgproc.py), plane-sweep rematching at
those poses, repeated in rounds that race the prior-chained poses against a
fresh bootstrap; scenes over 260 px run it at <= 200 px and rematch once at
full resolution. The route each round took is reported in `last_geom`.

All backends return numpy maps with the JAX package's contract:
  corres_maps (P, 2, H, W) float32, conf_maps (P, 1, H, W) float32
for a combi list (2, P) with row 0 = target indices, row 1 = source indices.
Matching runs on `device` (the card by default) with TF32 off.
"""
from __future__ import annotations

import logging
import os
import time
from itertools import permutations
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparf_tpu_torch.utils import geometry, imgproc
from sparf_tpu_torch.utils.precision import ieee_fp32

def get_combi_list(num_views: int, method: str = "all") -> np.ndarray:
    """(2, P) pair indices; row 0 target, row 1 source. 'all' = permutations."""
    if method != "all":
        raise ValueError(method)
    combi = np.array(list(permutations(range(num_views), 2)), np.int32).T
    return combi.reshape(2, num_views * (num_views - 1))


def generate_pair_list(n_views: int) -> np.ndarray:
    """Unordered exhaustive pairs (2, P): (0,1),(0,2)... (i<j)."""
    pairs = [[i, j] for i in range(n_views) for j in range(i + 1, n_views)]
    return np.array(pairs, np.int32).T


def image_pair_candidates_with_angular_distance(extrinsics_w2c: np.ndarray,
                                                pairing_angle_threshold: float = 60.0
                                                ) -> np.ndarray:
    """Pairs whose relative rotation angle is below the threshold (2, P)."""
    n = extrinsics_w2c.shape[0]
    pairs = []
    for i in range(n):
        for j in range(i + 1, n):
            R_ij = extrinsics_w2c[i, :3, :3] @ extrinsics_w2c[j, :3, :3].T
            cos = np.clip((np.trace(R_ij) - 1) / 2, -1 + 1e-7, 1 - 1e-7)
            if abs(np.degrees(np.arccos(cos))) < pairing_angle_threshold:
                pairs.append([i, j])
    return np.array(pairs, np.int32).T if pairs else np.zeros((2, 0), np.int32)


def get_mask_valid_from_conf_map(conf_maps: np.ndarray, corres_maps: np.ndarray,
                                 min_confidence: float,
                                 max_confidence: Optional[float] = None) -> np.ndarray:
    """(P,1,H,W) bool: confident AND in-bounds matches."""
    H, W = corres_maps.shape[-2:]
    x, y = corres_maps[:, 0], corres_maps[:, 1]
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    mask = conf_maps[:, 0] >= min_confidence
    if max_confidence is not None:
        mask &= conf_maps[:, 0] <= max_confidence
    return (mask & valid)[:, None]


def gt_correspondences_for_pair(scene: Dict[str, np.ndarray], idx_target: int,
                                idx_source: int, rth: float = 0.05
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """corres (2,H,W) + valid (H,W) from GT depth and poses (computed on the CPU)."""
    depth_t = np.asarray(scene["depth_gt"][idx_target])
    valid_t = np.asarray(scene["valid_depth_gt"][idx_target])
    depth_s = np.asarray(scene["depth_gt"][idx_source])
    H, W = depth_t.shape
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    pixels = np.stack([xx, yy], -1).reshape(1, -1, 2).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a))

    T = geometry.relative_transform_i_to_j(t(scene["pose"][idx_target]),
                                           t(scene["pose"][idx_source]))[None]
    kpj, vis = geometry.batch_project_to_other_img_and_check_depth(
        t(pixels), t(depth_t.reshape(1, -1)), t(depth_s[None]),
        t(scene["intr"][idx_target: idx_target + 1]),
        t(scene["intr"][idx_source: idx_source + 1]), T, t(valid_t.reshape(1, -1)), rth=rth)
    corres = kpj.numpy().reshape(H, W, 2).transpose(2, 0, 1)
    return corres.astype(np.float32), vis.numpy().reshape(H, W)


def compute_gt_flow_of_combi_list(scene, combi_list: np.ndarray):
    corres, conf = [], []
    for t, s in combi_list.T:
        cmap, mask = gt_correspondences_for_pair(scene, int(t), int(s))
        corres.append(cmap)
        conf.append(mask[None].astype(np.float32))
    return np.stack(corres), np.stack(conf)




# ---------------------------------------------------------------------------
# shared helpers: sampling, homographies, cycle consistency
# ---------------------------------------------------------------------------


def _pixel_grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return xx, yy


def _bilinear_at(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample (C,H,W) at float coords x, y of shape S -> (C, *S), clamped to
    the image (F.grid_sample, border padding, align_corners). The normalised
    coordinates round in float32: ~1e-5 px from an exact bilinear at 400 px."""
    C, H, W = img.shape
    grid = torch.stack([x.reshape(-1) * (2.0 / max(W - 1, 1)) - 1.0,
                        y.reshape(-1) * (2.0 / max(H - 1, 1)) - 1.0], -1)[None, None]
    out = F.grid_sample(img[None], grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out[0, :, 0].reshape((C,) + tuple(x.shape))


def _apply_homography(Hm: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Hm (3,3) applied to pixel points (...,2) -> (...,2)."""
    x, y = pts[..., 0], pts[..., 1]
    d = Hm[2, 0] * x + Hm[2, 1] * y + Hm[2, 2]
    tiny = torch.where(d < 0, torch.full_like(d, -1e-8), torch.full_like(d, 1e-8))
    d = torch.where(torch.abs(d) < 1e-8, tiny, d)
    u = (Hm[0, 0] * x + Hm[0, 1] * y + Hm[0, 2]) / d
    v = (Hm[1, 0] * x + Hm[1, 1] * y + Hm[1, 2]) / d
    return torch.stack([u, v], -1)


def _fit_homography_weighted(corres: torch.Tensor, weights: torch.Tensor,
                             n_irls: int = 5) -> torch.Tensor:
    """Robust global homography target -> source from a dense flow field.

    corres (H,W,2) source coords of every target pixel, weights (H,W) >= 0.
    Normalised DLT: the eigenvector of the smallest eigenvalue of the 9x9
    weighted normal matrix, re-weighted n_irls times with a Geman-McClure
    kernel whose scale follows the median residual (1 px whenever a weight
    is 0, as `jnp.median` of the NaN-masked residuals gives). Out-of-bounds
    correspondences get weight 0. Returned with Hm[2,2] = 1, so the
    eigenvector's sign does not matter.
    """
    H, W = corres.shape[:2]
    dev = corres.device
    xx, yy = _pixel_grid(H, W, dev)
    src = torch.stack([xx, yy], -1).reshape(-1, 2)
    dst = corres.reshape(-1, 2)
    w0 = torch.clamp(weights.reshape(-1), min=0.0)
    inb = (dst[:, 0] >= 0) & (dst[:, 0] <= W - 1) & (dst[:, 1] >= 0) & (dst[:, 1] <= H - 1)
    w0 = w0 * inb

    s = 2.0 / float(np.float32(max(H, W)))
    cx, cy = (W - 1) / 2, (H - 1) / 2
    T = torch.tensor([[s, 0, -s * cx], [0, s, -s * cy], [0, 0, 1]], dtype=torch.float32,
                     device=dev)
    Tinv = torch.tensor([[1 / s, 0, cx], [0, 1 / s, cy], [0, 0, 1]], dtype=torch.float32,
                        device=dev)
    center = torch.tensor([cx, cy], dtype=torch.float32, device=dev)
    sn, dn = (src - center) * s, (dst - center) * s
    one = torch.ones_like(sn[:, :1])
    zero3 = torch.zeros_like(torch.cat([sn, one], -1))
    p = torch.cat([sn, one], -1)
    r1 = torch.cat([p, zero3, -dn[:, :1] * p], -1)
    r2 = torch.cat([zero3, p, -dn[:, 1:2] * p], -1)

    def solve(w):
        A = torch.cat([r1 * w[:, None], r2 * w[:, None]], 0)
        _, vecs = torch.linalg.eigh(A.t() @ A)
        return Tinv @ vecs[:, 0].reshape(3, 3) @ T

    with ieee_fp32():
        w = torch.sqrt(w0)
        Hm = solve(w)
        any_zero = bool((w0 <= 0).any())
        for _ in range(n_irls):
            res = torch.linalg.norm(_apply_homography(Hm, src) - dst, dim=-1)
            med = 1.0 if any_zero else float(torch.quantile(res, 0.5))
            sigma2 = max(1.4826 * med, 0.5) ** 2
            w = torch.sqrt(w0) * sigma2 / (sigma2 + res ** 2)
            Hm = solve(w)
    return Hm / torch.where(torch.abs(Hm[2, 2]) < 1e-8, torch.ones_like(Hm[2, 2]), Hm[2, 2])


def _warp_image_by_homography(img: torch.Tensor, Hm: torch.Tensor) -> torch.Tensor:
    """(C,H,W) source resampled so that warped(u) = img(Hm(u))."""
    C, H, W = img.shape
    xx, yy = _pixel_grid(H, W, img.device)
    sp = _apply_homography(Hm, torch.stack([xx, yy], -1))
    return _bilinear_at(img, sp[..., 0], sp[..., 1]).reshape(C, H, W)


def _cycle_error(corres_ts: torch.Tensor, corres_st: torch.Tensor) -> torch.Tensor:
    """Forward-backward cycle error in px (H,W) of (H,W,2) maps."""
    H, W, _ = corres_ts.shape
    Hs, Ws, _ = corres_st.shape
    sx = torch.clamp(torch.round(corres_ts[..., 0]), 0, Ws - 1).to(torch.int64)
    sy = torch.clamp(torch.round(corres_ts[..., 1]), 0, Hs - 1).to(torch.int64)
    back = corres_st[sy, sx]
    xx, yy = _pixel_grid(H, W, corres_ts.device)
    return torch.linalg.norm(back - torch.stack([xx, yy], -1), dim=-1)


def _cycle_confidence(corres_ts: torch.Tensor, corres_st: torch.Tensor,
                      sigma: float = 1.0) -> torch.Tensor:
    """exp(-err^2 / (2 sigma^2)) of the forward-backward cycle error: conf >=
    0.95 is err <= 0.32 px, the role of PDC-Net's p_r >= 0.95."""
    err = _cycle_error(corres_ts, corres_st)
    return torch.exp(-(err ** 2) / (2 * sigma ** 2))


def cc_maps_from_corres(corres_maps: np.ndarray, combi_list: np.ndarray) -> np.ndarray:
    """(P,1,H,W) cyclic-consistency confidence 1/(1+err) from dense maps that
    hold both directions of each pair; ones where the reverse is absent."""
    idx_of = {(int(t), int(s)): p for p, (t, s) in enumerate(combi_list.T)}
    out = np.ones((corres_maps.shape[0], 1) + corres_maps.shape[-2:], np.float32)
    for p, (t, s) in enumerate(combi_list.T):
        q = idx_of.get((int(s), int(t)))
        if q is None:
            continue
        err = _cycle_error(torch.as_tensor(corres_maps[p].transpose(1, 2, 0)),
                           torch.as_tensor(corres_maps[q].transpose(1, 2, 0)))
        out[p, 0] = (1.0 / (1.0 + err)).numpy()
    return out


# ---------------------------------------------------------------------------
# ZNCC hierarchical matcher, appearance stage
# ---------------------------------------------------------------------------


def _edge_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge padding of the last two dims of a (C,H,W) tensor."""
    return F.pad(x[None], (r, r, r, r), mode="replicate")[0]


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """(C,H,W) -> (C,H/2,W/2), odd edges dropped."""
    C, H, W = x.shape
    return x[:, : H // 2 * 2, : W // 2 * 2].reshape(C, H // 2, 2, W // 2, 2).mean((2, 4))


def _patch_descriptors(img: torch.Tensor, patch: int = 7) -> torch.Tensor:
    """Per-pixel zero-mean, unit-norm RGB-patch descriptors (H,W,C*p*p)."""
    C, H, W = img.shape
    padded = _edge_pad(img, patch // 2)
    desc = torch.stack([padded[:, dy: dy + H, dx: dx + W]
                        for dy in range(patch) for dx in range(patch)], dim=-1)
    desc = desc.permute(1, 2, 0, 3).reshape(H, W, C * patch * patch)
    desc = desc - desc.mean(-1, keepdim=True)
    return desc / (torch.linalg.norm(desc, dim=-1, keepdim=True) + 1e-6)


def _global_match(desc_t: torch.Tensor, desc_s: torch.Tensor) -> torch.Tensor:
    """Exhaustive ZNCC argmax at the coarsest level -> integer flow (H,W,2)."""
    Ht, Wt, D = desc_t.shape
    Ws = desc_s.shape[1]
    with ieee_fp32():
        scores = desc_t.reshape(-1, D) @ desc_s.reshape(-1, D).t()
    best = torch.argmax(scores, dim=-1)
    return torch.stack([(best % Ws).to(torch.float32), (best // Ws).to(torch.float32)],
                       -1).reshape(Ht, Wt, 2)


def _local_refine(desc_t: torch.Tensor, desc_s: torch.Tensor, corres: torch.Tensor,
                  radius: int = 2, subpixel: bool = False, return_score: bool = False):
    """ZNCC search over the (2r+1)^2 window around the current match.

    desc_* (H,W,D); corres (H,W,2) absolute source coords at this level.
    subpixel: 1-D quadratic fits along x and y around the peak. return_score
    adds (peak score, peak minus window mean)."""
    Hs, Ws, D = desc_s.shape
    k = 2 * radius + 1
    cx = torch.clamp(torch.round(corres[..., 0]), 0, Ws - 1).to(torch.int64)
    cy = torch.clamp(torch.round(corres[..., 1]), 0, Hs - 1).to(torch.int64)
    flat_s = desc_s.reshape(-1, D)

    def score_at(dy, dx):
        sy = torch.clamp(cy + dy, 0, Hs - 1)
        sx = torch.clamp(cx + dx, 0, Ws - 1)
        return torch.sum(desc_t * flat_s[sy * Ws + sx], dim=-1)

    scores = torch.stack([score_at(dy, dx) for dy in range(-radius, radius + 1)
                          for dx in range(-radius, radius + 1)], dim=-1)
    best = torch.argmax(scores, dim=-1)
    dy = (best // k).to(torch.float32) - radius
    dx = (best % k).to(torch.float32) - radius
    if subpixel:
        def get(o):
            return torch.gather(scores, -1, torch.clamp(o, 0, k * k - 1)[..., None])[..., 0]

        s0, sxm, sxp = get(best), get(best - 1), get(best + 1)
        denom_x = sxm - 2 * s0 + sxp
        off_x = torch.where(torch.abs(denom_x) > 1e-6, 0.5 * (sxm - sxp) / (denom_x + 1e-12),
                            torch.zeros_like(denom_x))
        sym, syp = get(best - k), get(best + k)
        denom_y = sym - 2 * s0 + syp
        off_y = torch.where(torch.abs(denom_y) > 1e-6, 0.5 * (sym - syp) / (denom_y + 1e-12),
                            torch.zeros_like(denom_y))
        dx = dx + torch.clamp(off_x, -0.5, 0.5)
        dy = dy + torch.clamp(off_y, -0.5, 0.5)
    out = torch.stack([cx.to(torch.float32) + dx, cy.to(torch.float32) + dy], dim=-1)
    if return_score:
        best_score = scores.max(dim=-1).values
        return out, (best_score, best_score - scores.mean(dim=-1))
    return out


def _image_grads(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (gx, gy) of (C,H,W), edge-padded."""
    pad = _edge_pad(img, 1)
    return ((pad[:, 1:-1, 2:] - pad[:, 1:-1, :-2]) * 0.5,
            (pad[:, 2:, 1:-1] - pad[:, :-2, 1:-1]) * 0.5)


def _window_slices(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(C,H,W) -> (K,C,H,W), the K = (2r+1)^2 window-shifted images."""
    C, H, W = img.shape
    pad = _edge_pad(img, radius)
    return torch.stack([pad[:, dy: dy + H, dx: dx + W] for dy in range(2 * radius + 1)
                        for dx in range(2 * radius + 1)], dim=0)


def _lk_refine(img_t: torch.Tensor, img_s: torch.Tensor, corres: torch.Tensor,
               radius: int = 3, n_iters: int = 5, affine: bool = False,
               max_step: float = 1.5) -> torch.Tensor:
    """Dense inverse-compositional Lucas-Kanade refinement of a flow field
    (translation, or a local 2x2 linear warp per pixel when affine), with a
    per-iteration step clip; pixels that move more than 3 n_iters max_step
    px fall back to the input. img_* (C,H,W), corres (H,W,2) -> (H,W,2)."""
    C, H, W = img_t.shape
    K = (2 * radius + 1) ** 2
    dev = img_t.device
    uv = torch.tensor([[dx, dy] for dy in range(-radius, radius + 1)
                       for dx in range(-radius, radius + 1)], dtype=torch.float32, device=dev)
    T = _window_slices(img_t, radius)
    gx, gy = _image_grads(img_t)
    Gx, Gy = _window_slices(gx, radius), _window_slices(gy, radius)
    T = T - T.mean(dim=(0, 1), keepdim=True)
    if affine:
        u = uv[:, 0][:, None, None, None]
        v = uv[:, 1][:, None, None, None]
        sd = torch.stack([Gx * u, Gx * v, Gx, Gy * u, Gy * v, Gy], dim=2)
        n_p = 6
    else:
        sd = torch.stack([Gx, Gy], dim=2)
        n_p = 2
    with ieee_fp32():
        Hmat = torch.einsum("kcihw,kcjhw->hwij", sd, sd)
    damp = 1e-4 * torch.diagonal(Hmat, dim1=-2, dim2=-1).sum(-1)[..., None, None] + 1e-6
    Hmat = Hmat + damp * torch.eye(n_p, device=dev)

    q0 = corres
    q = q0
    A = torch.eye(2, device=dev).expand(H, W, 2, 2)
    for _ in range(n_iters):
        ax = A[..., 0, 0] * uv[:, 0][:, None, None] + A[..., 0, 1] * uv[:, 1][:, None, None]
        ay = A[..., 1, 0] * uv[:, 0][:, None, None] + A[..., 1, 1] * uv[:, 1][:, None, None]
        sx, sy = q[..., 0][None] + ax, q[..., 1][None] + ay
        I = _bilinear_at(img_s, sx.reshape(-1), sy.reshape(-1)).reshape(C, K, H, W)
        I = I.permute(1, 0, 2, 3)
        e = (I - I.mean(dim=(0, 1), keepdim=True)) - T
        with ieee_fp32():
            b = torch.einsum("kcihw,kchw->hwi", sd, e)
        delta = torch.linalg.solve(Hmat, b[..., None])[..., 0]
        if affine:
            dA = delta.reshape(H, W, 2, 3)
            inc = torch.eye(2, device=dev) + dA[..., :2]
            dt = dA[..., 2]
            det = inc[..., 0, 0] * inc[..., 1, 1] - inc[..., 0, 1] * inc[..., 1, 0]
            det = torch.where(torch.abs(det) < 1e-3, torch.ones_like(det), det)
            inv = torch.stack([torch.stack([inc[..., 1, 1], -inc[..., 0, 1]], -1),
                               torch.stack([-inc[..., 1, 0], inc[..., 0, 0]], -1)],
                              -2) / det[..., None, None]
            A = torch.einsum("hwij,hwjk->hwik", A, inv)
            step = -torch.einsum("hwij,hwj->hwi", A, dt)
        else:
            step = -torch.einsum("hwij,hwj->hwi", A, delta)
        q = q + torch.clamp(step, -max_step, max_step)
    far = torch.linalg.norm(q - q0, dim=-1) > (3.0 * n_iters * max_step)
    return torch.where(far[..., None], q0, q)


def _median_filter_flow(corres: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Per-channel median filter of the flow (corres - pixel grid), edge-padded."""
    H, W, _ = corres.shape
    xx, yy = _pixel_grid(H, W, corres.device)
    grid = torch.stack([xx, yy], -1)
    pad = _edge_pad((corres - grid).permute(2, 0, 1), radius).permute(1, 2, 0)
    k = 2 * radius + 1
    stack = torch.stack([pad[dy: dy + H, dx: dx + W] for dy in range(k) for dx in range(k)], 0)
    return grid + torch.median(stack, dim=0).values


def _resize_hw2(corres: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """jax.image.resize of an (h,w,2) map to (H,W,2), bilinear."""
    return imgproc.resize_bilinear(corres.permute(2, 0, 1), (H, W)).permute(1, 2, 0)


def _match_pair_pyramid(img_t: torch.Tensor, img_s: torch.Tensor, n_levels: int,
                        patch: int = 7):
    """Hierarchical match target -> source of (3,H,W) images.

    Coarsest level: the global ZNCC argmax raced per pixel against the
    identity after a local sweep, then a median filter; each finer level:
    upsample, a radius-3 sweep, a median filter, a final radius-3 sweep with
    the subpixel fit at full resolution and a last 3x3 median. Returns
    (corres (H,W,2), score (H,W), margin (H,W))."""
    pyr_t, pyr_s = [img_t], [img_s]
    for _ in range(n_levels - 1):
        pyr_t.append(_avg_pool2(pyr_t[-1]))
        pyr_s.append(_avg_pool2(pyr_s[-1]))

    d_t, d_s = _patch_descriptors(pyr_t[-1], patch), _patch_descriptors(pyr_s[-1], patch)
    hc, wc = pyr_t[-1].shape[-2:]
    xx, yy = _pixel_grid(hc, wc, img_t.device)
    ident = torch.stack([xx, yy], -1)
    cand_g, (score_g, _) = _local_refine(d_t, d_s, _global_match(d_t, d_s), radius=2,
                                         return_score=True)
    cand_i, (score_i, _) = _local_refine(d_t, d_s, ident, radius=3, return_score=True)
    corres = torch.where((score_i >= score_g)[..., None], cand_i, cand_g)
    corres = _median_filter_flow(corres, radius=2)

    score = None
    for lvl in range(n_levels - 2, -1, -1):
        Ht, Wt = pyr_t[lvl].shape[-2:]
        corres = _resize_hw2(corres * 2.0, Ht, Wt)
        d_t, d_s = _patch_descriptors(pyr_t[lvl], patch), _patch_descriptors(pyr_s[lvl], patch)
        corres = _local_refine(d_t, d_s, corres, radius=3)
        corres = _median_filter_flow(corres, radius=2)
        corres, score = _local_refine(d_t, d_s, corres, radius=3, subpixel=(lvl == 0),
                                      return_score=True)
        if lvl == 0:
            corres = _median_filter_flow(corres, radius=1)
    if score is None:  # a single level
        corres, score = _local_refine(d_t, d_s, corres, radius=1, return_score=True)
    return corres, score[0], score[1]


def _match_pair_pyramid_homog(img_t: torch.Tensor, img_s: torch.Tensor, n_levels: int,
                              patch: int = 7):
    """`_match_pair_pyramid`, plus a rematch against the source warped by a
    robust homography fit to its result; per pixel the estimate with the
    higher final ZNCC wins (composed coords outside the image score -1)."""
    c0, s0, m0 = _match_pair_pyramid(img_t, img_s, n_levels, patch)
    Hm = _fit_homography_weighted(c0, torch.clamp(s0, min=0.0) ** 2)
    c1, s1, m1 = _match_pair_pyramid(img_t, _warp_image_by_homography(img_s, Hm), n_levels,
                                     patch)
    cH = _apply_homography(Hm, c1)
    H, W = img_t.shape[-2:]
    inb = (cH[..., 0] >= 0) & (cH[..., 0] <= W - 1) & (cH[..., 1] >= 0) & (cH[..., 1] <= H - 1)
    s1 = torch.where(inb, s1, torch.full_like(s1, -1.0))
    use1 = s1 > s0
    return (torch.where(use1[..., None], cH, c0), torch.where(use1, s1, s0),
            torch.where(use1, m1, m0))


def _pair_sets(combi_list: np.ndarray):
    """(ordered pairs to match, both directions; sorted unordered pairs)."""
    needed = set()
    for t, s in combi_list.T:
        needed.add((int(t), int(s)))
        needed.add((int(s), int(t)))
    return needed, sorted({(min(t, s), max(t, s)) for (t, s) in needed})


def _stage1_flows(imgs: torch.Tensor, needed, n_levels: int, patch: int,
                  homography: bool = False):
    """Appearance matching of every ordered pair: {(t,s): (corres, score, margin)}."""
    fn = _match_pair_pyramid_homog if homography else _match_pair_pyramid
    return {(t, s): fn(imgs[t], imgs[s], n_levels, patch) for t, s in sorted(needed)}


# ---------------------------------------------------------------------------
# geometry stage: plane-sweep rematching
#
# For rigid scenes with wide baselines: estimate the epipolar geometry from
# confident seeds, then rematch densely with perspective-correct warps. Pass
# 1 sweeps fronto-parallel depth planes in the target frame (the source
# warped by each plane's homography, windowed ZNCC, the per-pixel peak over
# depth with a parabola in inverse depth); pass 2 sweeps each pixel's own
# inverse depth and a 7-px band across its epipolar line. Hypotheses are
# scored in chunks of `_SWEEP_CHUNK`; each is computed on its own, so the
# result does not depend on the chunk size.
# ---------------------------------------------------------------------------

_SWEEP_CHUNK = 16
# errors that degenerate input raises in the SfM and pose code (too few
# matches, empty arrays, singular systems); torch's own failures on the card
# (RuntimeError, out of memory) are not among them and propagate
_DEGENERATE = (ValueError, IndexError, np.linalg.LinAlgError)


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Windowed (2r+1)^2 sum over the last two dims, same shape, zero padded
    (XLA's reduce_window "SAME" with init 0): shifted slices, rows then
    columns."""
    H, W = x.shape[-2:]
    k = 2 * radius + 1
    p = F.pad(x, (radius, radius, radius, radius))
    rows = p[..., 0:H, :]
    for dy in range(1, k):
        rows = rows + p[..., dy: dy + H, :]
    out = rows[..., 0:W]
    for dx in range(1, k):
        out = out + rows[..., dx: dx + W]
    return out


def _on_grid(M: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """M (3,3) applied to every pixel (x, y, 1): (3,H,W) = M[:,0] x + M[:,1] y
    + M[:,2], as the JAX package's M @ grid_h, in separate elementwise ops:
    a matmul's summation order (and FMA contraction) differs between cuBLAS
    and the CPU, and a coordinate an ulp apart flips a hypothesis in or out
    of the image; these ops round the same on every device."""
    xx, yy = _pixel_grid(H, W, M.device)
    return (M[:, 0, None, None] * xx + M[:, 1, None, None] * yy) + M[:, 2, None, None]


def _safe_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)


# Window statistics. A window's variance Sxx - Sx^2 / n cancels: in float32 its
# rounding is ~1e-6 of Sxx, so the ZNCC of a low-texture window (a few grey
# levels of variation) moves by up to ~0.05 between two summation orders (the
# JAX package's, the card's, the CPU's). The port forms the sums and the ZNCC
# in float64 from the float32 samples and returns float32 scores.
#
# A window is flat when its variance is at most _FLAT_VAR_SHARE of its energy
# Sxx (a constant colour: the synthetic scene's background). The JAX package
# divides regardless, by a variance clamped at 1e-8, so a flat window scores
# rounding noise (up to ~500) that its gates and round scores then see; the
# port scores a hypothesis 0 (no evidence) when the target or the warped
# source window is flat.
_FLAT_VAR_SHARE = 1e-5


def _channel_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over a channel dim in a fixed order, the same on every device."""
    parts = x.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _window_var(S: torch.Tensor, Sq: torch.Tensor, k2n: float):
    """(variance clamped at 1e-8, flat) of windows with sums S and Sq."""
    var = Sq - S * S / k2n
    return torch.clamp(var, min=1e-8), var <= _FLAT_VAR_SHARE * Sq


def _window_zncc(img_t: torch.Tensor, warped: torch.Tensor, target_stats, radius: int,
                 k2n: float) -> torch.Tensor:
    """ZNCC of (C,H,W) target windows against (n,C,H,W) warped sources ->
    (n,H,W) float32, the sums in float64; 0 where either window is flat."""
    St, var_t, flat_t, img_t64 = target_stats
    w = warped.double()
    Ss = _channel_sum(_box_sum(w, radius), 1)
    Sss = _channel_sum(_box_sum(w * w, radius), 1)
    Sts = _channel_sum(_box_sum(img_t64[None] * w, radius), 1)
    cov = Sts - St * Ss / k2n
    var_s, flat_s = _window_var(Ss, Sss, k2n)
    zncc = cov / torch.sqrt(var_t * var_s)
    return torch.where(flat_t | flat_s, torch.zeros_like(zncc), zncc).float()


def _target_stats(img_t: torch.Tensor, radius: int, k2n: float):
    """(St, clamped variance, flat, the target in float64) of the target's
    windows."""
    t64 = img_t.double()
    St = _channel_sum(_box_sum(t64, radius), 0)
    Stt = _channel_sum(_box_sum(t64 * t64, radius), 0)
    return (St,) + _window_var(St, Stt, k2n) + (t64,)


def _parabola(sm, s0, sp):
    denom = sm - 2 * s0 + sp
    off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (sm - sp) / (denom + 1e-12),
                      torch.zeros_like(denom))
    return torch.clamp(off, -0.5, 0.5), denom


def _plane_sweep_scores(img_t, img_s, Ag, Bg, inv_depths, radius: int) -> torch.Tensor:
    """(D,H,W) ZNCC of every fronto-parallel hypothesis; -1 where the warp
    leaves the source or the plane is behind it."""
    C, H, W = img_t.shape
    k2n = float(C * (2 * radius + 1) ** 2)
    stats = _target_stats(img_t, radius, k2n)
    out = []
    for a in range(0, inv_depths.shape[0], _SWEEP_CHUNK):
        d = inv_depths[a: a + _SWEEP_CHUNK]
        ph = Ag[None] + d[:, None, None] * Bg[None]                      # (n,3,HW)
        z = _safe_z(ph[:, 2])
        x, y = ph[:, 0] / z, ph[:, 1] / z
        inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1) & (ph[:, 2] > 1e-6)
        warped = _bilinear_at(img_s, x, y).reshape(C, -1, H, W).permute(1, 0, 2, 3)
        zncc = _window_zncc(img_t, warped, stats, radius, k2n)
        out.append(torch.where(inb.reshape(-1, H, W), zncc, torch.full_like(zncc, -1.0)))
    return torch.cat(out, 0)


def _median0(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 0, the mean of the two middle values when even (as
    jnp.median; torch.median returns the lower one)."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _plane_sweep_pair(img_t: torch.Tensor, img_s: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, inv_depths: torch.Tensor, radius: int = 2):
    """Dense depth-sweep match target -> source: p_s ~ (A + inv_d B) (x, y, 1)
    with A = K_s R K_t^-1, B = K_s t n^T K_t^-1, n = [0,0,1]. Returns
    (corres (H,W,2), zncc peak (H,W), margin = peak - median (H,W)); the
    first hypothesis wins ties (out-of-bounds ones all score -1)."""
    C, H, W = img_t.shape
    Ag, Bg = _on_grid(A, H, W).reshape(3, -1), _on_grid(B, H, W).reshape(3, -1)
    scores = _plane_sweep_scores(img_t, img_s, Ag, Bg, inv_depths, radius)
    D = inv_depths.shape[0]
    best = torch.argmax(scores, dim=0)
    s0 = scores.max(dim=0).values
    margin = s0 - _median0(scores)
    sm = torch.gather(scores, 0, torch.clamp(best - 1, 0, D - 1)[None])[0]
    sp = torch.gather(scores, 0, torch.clamp(best + 1, 0, D - 1)[None])[0]
    off, _ = _parabola(sm, s0, sp)
    off = off * ((best > 0) & (best < D - 1))
    step = inv_depths[1] - inv_depths[0] if D > 1 else torch.zeros((), device=img_t.device)
    inv_d_star = inv_depths[best] + off * step
    ph = Ag.reshape(3, H, W) + inv_d_star[None] * Bg.reshape(3, H, W)
    z = _safe_z(ph[2])
    return torch.stack([ph[0] / z, ph[1] / z], -1), s0, margin


def _local_sweep_setup(img_t, A, B, n_perp: int = 3):
    H, W = img_t.shape[-2:]
    Ag, Bg = _on_grid(A, H, W), _on_grid(B, H, W)
    # epipolar direction at p: d(warp)/d(inv_d) ~ (B1 A3 - A1 B3, B2 A3 - A2 B3)
    ex = Bg[0] * Ag[2] - Ag[0] * Bg[2]
    ey = Bg[1] * Ag[2] - Ag[1] * Bg[2]
    en = torch.sqrt(ex * ex + ey * ey) + 1e-9
    perp = torch.arange(-n_perp, n_perp + 1, dtype=torch.float32, device=img_t.device)
    return Ag, Bg, -ey / en, ex / en, perp


def _local_sweep_scores(img_t, img_s, Ag, Bg, px_dir, py_dir, perp, inv_d0, offsets,
                        radius: int) -> torch.Tensor:
    """(J*K,H,W) ZNCC of each (depth offset j, perpendicular offset k),
    j-major, per pixel from its own inverse depth."""
    C, H, W = img_t.shape
    k2n = float(C * (2 * radius + 1) ** 2)
    stats = _target_stats(img_t, radius, k2n)
    K_perp = perp.shape[0]
    jk = torch.arange(offsets.shape[0] * K_perp, device=img_t.device)
    out = []
    for a in range(0, jk.shape[0], _SWEEP_CHUNK):
        j, k = jk[a: a + _SWEEP_CHUNK] // K_perp, jk[a: a + _SWEEP_CHUNK] % K_perp
        inv_d = inv_d0[None] + offsets[j][:, None, None]                   # (n,H,W)
        ph = Ag[None] + inv_d[:, None] * Bg[None]                           # (n,3,H,W)
        z = _safe_z(ph[:, 2])
        x = ph[:, 0] / z + perp[k][:, None, None] * px_dir[None]
        y = ph[:, 1] / z + perp[k][:, None, None] * py_dir[None]
        inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1) & (ph[:, 2] > 1e-6)
        warped = _bilinear_at(img_s, x.reshape(-1), y.reshape(-1)).reshape(C, -1, H, W)
        zncc = _window_zncc(img_t, warped.permute(1, 0, 2, 3), stats, radius, k2n)
        out.append(torch.where(inb, zncc, torch.full_like(zncc, -1.0)))
    return torch.cat(out, 0)


def _local_depth_sweep(img_t: torch.Tensor, img_s: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, inv_d0: torch.Tensor, d_inv_step: float,
                       n_offsets: int = 8, radius: int = 1):
    """Per-pixel inverse-depth sweep around inv_d0 (2 n_offsets + 1 steps)
    times a +-3 px band across the epipolar line (the estimated pose leaves
    the true match off the line). Flat argmax, then parabolas along depth
    and across the band. Returns (corres, zncc, curvature, inv_depth):
    curvature is the negated second difference along depth at the peak, 0
    at the sweep's ends."""
    H, W = img_t.shape[-2:]
    Ag, Bg, px_dir, py_dir, perp = _local_sweep_setup(img_t, A, B)
    offsets = torch.arange(-n_offsets, n_offsets + 1, dtype=torch.float32,
                           device=img_t.device) * d_inv_step
    J, K_perp = offsets.shape[0], perp.shape[0]
    scores = _local_sweep_scores(img_t, img_s, Ag, Bg, px_dir, py_dir, perp, inv_d0, offsets,
                                 radius)
    flat_best = torch.argmax(scores, dim=0)
    s0 = scores.max(dim=0).values
    best, best_k = flat_best // K_perp, flat_best % K_perp

    def at(idx):
        return torch.gather(scores, 0, idx[None])[0]

    off_j, denom_j = _parabola(at(torch.clamp(best - 1, 0, J - 1) * K_perp + best_k), s0,
                               at(torch.clamp(best + 1, 0, J - 1) * K_perp + best_k))
    interior = (best > 0) & (best < J - 1)
    inv_d_star = inv_d0 + offsets[best] + off_j * interior * d_inv_step
    off_k, _ = _parabola(at(best * K_perp + torch.clamp(best_k - 1, 0, K_perp - 1)), s0,
                         at(best * K_perp + torch.clamp(best_k + 1, 0, K_perp - 1)))
    perp_star = perp[best_k] + off_k * ((best_k > 0) & (best_k < K_perp - 1))
    ph = Ag + inv_d_star[None] * Bg
    z = _safe_z(ph[2])
    corres = torch.stack([ph[0] / z + perp_star * px_dir, ph[1] / z + perp_star * py_dir], -1)
    curv = torch.clamp(-denom_j, min=0.0) * interior
    return corres, s0, curv, inv_d_star


def _sweep_operators(K_t, K_s, R, t):
    """The per-depth homography chain A + inv_d B in integer-grid coords:
    (R, t) come from the pixel-centre SfM, so both are conjugated by the
    half-pixel shift S (x + 0.5) / S^-1. float64 products, float32 out."""
    S = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]])
    S_inv = np.array([[1.0, 0.0, -0.5], [0.0, 1.0, -0.5], [0.0, 0.0, 1.0]])
    A = S_inv @ K_s @ R @ np.linalg.inv(K_t) @ S
    B = S_inv @ K_s @ np.outer(t, np.array([0.0, 0.0, 1.0])) @ np.linalg.inv(K_t) @ S
    return A.astype(np.float32), B.astype(np.float32)


def _sweep_depths(K_s, t, depths, coarse_step_px: float = 1.0, max_hyp: int = 512):
    """(inv_lo, inv_hi, D, parallax per inverse depth) of pass 1: a generous
    range around the triangulated seeds, 1-px parallax steps, D bucketed to
    a multiple of 32 (the JAX package's compile buckets; D sets the
    hypotheses, so the bucketing is kept)."""
    lo = np.percentile(depths, 2) * 0.3
    hi = np.percentile(depths, 98) * 3.0
    inv_lo, inv_hi = 1.0 / hi, 1.0 / lo
    f = float(max(K_s[0, 0], K_s[1, 1]))
    parallax_per_invd = f * float(np.linalg.norm(t)) + 1e-12
    D = int(np.clip(np.ceil(parallax_per_invd * (inv_hi - inv_lo) / coarse_step_px), 16, max_hyp))
    D = int(min(-(-D // 32) * 32, max_hyp))
    return inv_lo, inv_hi, D, parallax_per_invd


def _pass1_inverse_depth(corres: torch.Tensor, A: torch.Tensor, B: torch.Tensor, inv_lo: float,
                         inv_hi: float) -> torch.Tensor:
    """Per-pixel inverse depth of pass 1's match: corres_x (A3 + d B3) = A1 +
    d B1 (or the y analog, whichever is better conditioned), clipped to the
    sweep's range."""
    H, W = corres.shape[:2]
    Ag, Bg = _on_grid(A, H, W), _on_grid(B, H, W)
    num_x = corres[..., 0] * Ag[2] - Ag[0]
    den_x = Bg[0] - corres[..., 0] * Bg[2]
    num_y = corres[..., 1] * Ag[2] - Ag[1]
    den_y = Bg[1] - corres[..., 1] * Bg[2]

    def safe(d):
        return torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)

    inv_d0 = torch.where(torch.abs(den_x) >= torch.abs(den_y), num_x / safe(den_x),
                         num_y / safe(den_y))
    return torch.clamp(inv_d0, inv_lo, inv_hi)


def _geom_rematch_pair(img_t: torch.Tensor, img_s: torch.Tensor, K_t: np.ndarray,
                       K_s: np.ndarray, R: np.ndarray, t: np.ndarray, depths: np.ndarray,
                       coarse_step_px: float = 1.0, fine_step_px: float = 0.25,
                       max_hyp: int = 512, radius: int = 1):
    """Two-pass depth-sweep rematch given the relative pose target -> source:
    the global fronto-parallel sweep over the seeds' depth range, then the
    per-pixel slanted sweep around its depth (0.25-px steps). Returns
    (corres, score, margin, curvature, inverse depth). TF32 off inside."""
    inv_lo, inv_hi, D, parallax_per_invd = _sweep_depths(K_s, t, depths, coarse_step_px,
                                                          max_hyp)
    dev = img_t.device
    A_np, B_np = _sweep_operators(K_t, K_s, R, t)
    A, B = torch.as_tensor(A_np, device=dev), torch.as_tensor(B_np, device=dev)
    with ieee_fp32():
        inv_depths = torch.linspace(inv_lo, inv_hi, D, dtype=torch.float32, device=dev)
        corres, score, margin = _plane_sweep_pair(img_t, img_s, A, B, inv_depths, radius=radius)
        inv_d0 = _pass1_inverse_depth(corres, A, B, inv_lo, inv_hi)
        corres, score, curv, inv_d = _local_depth_sweep(
            img_t, img_s, A, B, inv_d0, float(fine_step_px / parallax_per_invd), n_offsets=16,
            radius=radius)
    return corres, score, margin, curv, inv_d


# ---------------------------------------------------------------------------
# geometry stage: poses from seeds
# ---------------------------------------------------------------------------


def _pair_generator(seed: int, *index) -> torch.Generator:
    """A CPU generator for one RANSAC call, seeded from (seed, index...)."""
    state = np.random.SeedSequence([int(seed), *[int(i) for i in index]]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


def _refine_relpose_sampson(R: np.ndarray, t: np.ndarray, pn_t: np.ndarray, pn_s: np.ndarray,
                            f_scale: float = 2e-3) -> Tuple[np.ndarray, np.ndarray]:
    """Polish (R, t) by robust Sampson least squares over normalised pairs
    (scipy, soft-l1 at f_scale, then a plain fit on the pairs within 3
    f_scale). Returns the input when the fit fails on degenerate input."""
    from scipy.optimize import least_squares
    from scipy.spatial.transform import Rotation

    t = t / (np.linalg.norm(t) + 1e-12)
    x0 = np.concatenate([Rotation.from_matrix(R).as_rotvec(), t])
    ones = np.ones((pn_t.shape[0], 1))
    xt, xs = np.hstack([pn_t, ones]), np.hstack([pn_s, ones])

    def residuals(x):
        Rm = Rotation.from_rotvec(x[:3]).as_matrix()
        tv = x[3:] / (np.linalg.norm(x[3:]) + 1e-12)
        E = np.array([[0, -tv[2], tv[1]], [tv[2], 0, -tv[0]], [-tv[1], tv[0], 0]]) @ Rm
        Ex, Etx = xt @ E.T, xs @ E
        num = np.sum(xs * Ex, axis=1)
        den = Ex[:, 0] ** 2 + Ex[:, 1] ** 2 + Etx[:, 0] ** 2 + Etx[:, 1] ** 2
        return num / np.sqrt(np.maximum(den, 1e-12))

    try:
        x = least_squares(residuals, x0, loss="soft_l1", f_scale=f_scale, max_nfev=100).x
        keep = np.abs(residuals(x)) < 3.0 * f_scale
        if keep.sum() >= 16:
            x = least_squares(lambda xx: residuals(xx)[keep], x, max_nfev=60).x
    except _DEGENERATE:
        return R, t
    return Rotation.from_rotvec(x[:3]).as_matrix(), x[3:] / (np.linalg.norm(x[3:]) + 1e-12)


def _relpose_from_seeds(pts_t: np.ndarray, pts_s: np.ndarray, K_t: np.ndarray, K_s: np.ndarray,
                        prior: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                        generator: Optional[torch.Generator] = None, device="cpu"):
    """Relative pose from seed matches. With a prior (R0, t0), robust Sampson
    least squares from it; without, 5-point essential RANSAC (threshold 1.5
    px, prob 0.9999) + cheirality + the Sampson polish. Returns (R, t_unit,
    depths in the target frame, depths in the source frame) or None."""
    if pts_t.shape[0] < 24:
        return None

    def norm(p, K):
        return (p - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])

    pn_t = norm(pts_t, K_t).astype(np.float64)
    pn_s = norm(pts_s, K_s).astype(np.float64)
    f = float(max(K_t[0, 0], K_t[1, 1]))
    if prior is not None:
        R, t_vec = _refine_relpose_sampson(prior[0], prior[1], pn_t, pn_s, f_scale=2.0 / f)
        t = t_vec[:, None]
        m = np.ones(pn_t.shape[0], bool)
    else:
        try:
            E, inl = imgproc.find_essential_ransac(pn_t, pn_s, None, thresh=1.5 / f,
                                                   prob=0.9999, generator=generator,
                                                   device=device)
        except ValueError:
            return None
        if inl.sum() < 16:
            return None
        _, R, t, inl2 = imgproc.recover_pose(E, pn_t, pn_s, None, mask=inl, device=device)
        if inl2.sum() < 16:
            return None
        m = inl2
        R, t_vec = _refine_relpose_sampson(R, t[:, 0], pn_t[m], pn_s[m], f_scale=1.5 / f)
        t = t_vec[:, None]
    P_t = np.hstack([np.eye(3), np.zeros((3, 1))])
    X = imgproc.triangulate_points(P_t, np.hstack([R, t]), pn_t[m].T, pn_s[m].T, device=device)
    X3 = X[:3] / np.where(np.abs(X[3]) < 1e-12, 1e-12, X[3])
    d_t = X3[2]
    d_s = (R @ X3 + t)[2]
    ok = (d_t > 1e-6) & (d_s > 1e-6) & np.isfinite(d_t) & np.isfinite(d_s)
    if ok.sum() < 8:
        return None
    return R, t[:, 0], d_t[ok], d_s[ok]


def _select_seed_matches(flow_ts: tuple, flow_st: tuple, max_seeds: int = 4000
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """High-confidence sparse matches of a dense flow for pose RANSAC:
    (cycle conf, score, margin) above (0.6, 0.8, 0.08), else (0.3, 0.65,
    0.04) below 48 seeds; None below 24; the max_seeds best by conf x score."""
    corres_ts, score_ts, margin_ts = flow_ts
    conf = _cycle_confidence(corres_ts, flow_st[0]).cpu().numpy()
    sc, mg, c = (x.cpu().numpy() for x in (score_ts, margin_ts, corres_ts))
    for thr in ((0.6, 0.8, 0.08), (0.3, 0.65, 0.04)):
        ys, xs = np.where((conf > thr[0]) & (sc > thr[1]) & (mg > thr[2]))
        if len(ys) >= 48:
            break
    if len(ys) < 24:
        return None
    if len(ys) > max_seeds:
        order = np.argsort(-(conf * sc)[ys, xs])[:max_seeds]
        ys, xs = ys[order], xs[order]
    return np.stack([xs, ys], -1).astype(np.float64), c[ys, xs].astype(np.float64)


def _pairwise_geom_round(imgs: torch.Tensor, intr: np.ndarray, flows, unordered,
                         init_poses_w2c: Optional[np.ndarray], lk_for_next: bool,
                         seed: int = 0, round_index: int = 0) -> None:
    """One round of independent per-pair pose + sweep (when global SfM
    fails), seeded by the initial-pose prior when there is one. Mutates
    `flows`."""
    for t, s in unordered:
        K_t, K_s = intr[t], intr[s]
        prior = None
        if init_poses_w2c is not None:
            P = np.asarray(init_poses_w2c)
            R0 = P[s, :3, :3] @ P[t, :3, :3].T
            t0 = P[s, :3, 3] - R0 @ P[t, :3, 3]
            nrm = np.linalg.norm(t0)
            if nrm > 1e-9:
                prior = (R0, t0 / nrm)
        seeds = _select_seed_matches(flows[(t, s)], flows[(s, t)])
        if seeds is None:
            continue
        rp = _relpose_from_seeds(seeds[0], seeds[1], K_t, K_s, prior=prior,
                                 generator=_pair_generator(seed, round_index, t, s),
                                 device=imgs.device)
        if rp is None:
            continue
        R, tvec, d_t, d_s = rp
        c_ts, s_ts, m_ts, _, _ = _geom_rematch_pair(imgs[t], imgs[s], K_t, K_s, R, tvec, d_t)
        c_st, s_st, m_st, _, _ = _geom_rematch_pair(imgs[s], imgs[t], K_s, K_t, R.T,
                                                    -R.T @ tvec, d_s)
        if lk_for_next:
            c_ts = _lk_refine(imgs[t], imgs[s], c_ts, radius=3, n_iters=3, max_step=0.5)
            c_st = _lk_refine(imgs[s], imgs[t], c_st, radius=3, n_iters=3, max_step=0.5)
        flows[(t, s)] = (c_ts, s_ts, m_ts)
        flows[(s, t)] = (c_st, s_st, m_st)


# ---------------------------------------------------------------------------
# geometry stage: global poses (mini-SfM)
# ---------------------------------------------------------------------------


def _sparse_rematch_scores(img_t: torch.Tensor, img_s: torch.Tensor, corres: torch.Tensor,
                           kps: np.ndarray, patch_radius: int, search_radius: int):
    """The ZNCC of each keypoint's target patch img_t(p + u) against
    img_s(corres(p + u) + d) for every integer offset d = (dy, dx) of a
    (2 search_radius + 1)^2 grid, dy-major: (scores (D*D,K), corres(p) (2,K),
    the offsets along one axis (D,)). Offsets are scored in batches of ~1M
    samples on the CPU, ~16M on the card."""
    C = img_t.shape[0]
    dev = img_t.device
    K = kps.shape[0]
    kx = torch.as_tensor(kps[:, 0], dtype=torch.float32, device=dev)
    ky = torch.as_tensor(kps[:, 1], dtype=torch.float32, device=dev)
    us = torch.arange(-patch_radius, patch_radius + 1, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(us, us, indexing="ij")
    uu, vv = uu.reshape(-1), vv.reshape(-1)
    tx, ty = kx[:, None] + uu[None], ky[:, None] + vv[None]                  # (K,P2)

    def normed(patch):
        patch = patch - patch.mean(dim=(1, 2), keepdim=True)
        return patch / (torch.linalg.norm(patch.reshape(patch.shape[0], -1), dim=-1)
                        [:, None, None] + 1e-6)

    Tn = normed(_bilinear_at(img_t, tx.reshape(-1), ty.reshape(-1)).reshape(C, K, -1)
                .permute(1, 2, 0))                                            # (K,P2,C)
    anchors = _bilinear_at(corres.permute(2, 0, 1), tx.reshape(-1), ty.reshape(-1)
                           ).reshape(2, K, -1)                                # (2,K,P2)
    c0 = anchors[:, :, (anchors.shape[-1] - 1) // 2]
    ds = torch.arange(-search_radius, search_radius + 1, dtype=torch.float32, device=dev)
    offs = torch.stack(torch.meshgrid(ds, ds, indexing="ij"), -1).reshape(-1, 2)  # (dy, dx)
    chunk = max(1, (2 ** 24 if dev.type == "cuda" else 2 ** 20) // (K * tx.shape[1]))
    flat = []
    for a in range(0, offs.shape[0], chunk):
        o = offs[a: a + chunk]
        sx = anchors[0][None] + o[:, 1, None, None]
        sy = anchors[1][None] + o[:, 0, None, None]
        S = _bilinear_at(img_s, sx.reshape(-1), sy.reshape(-1)).reshape(C, o.shape[0], K, -1)
        Sn = normed(S.permute(1, 2, 3, 0).reshape(-1, S.shape[-1], C))
        flat.append((Sn.reshape(o.shape[0], K, -1, C) * Tn[None]).sum((2, 3)))
    return torch.cat(flat, 0), c0, ds


def _sparse_guided_rematch(img_t: torch.Tensor, img_s: torch.Tensor, corres: torch.Tensor,
                           kps: np.ndarray, patch_radius: int = 5, search_radius: int = 6,
                           min_zncc: float = 0.75) -> Tuple[np.ndarray, np.ndarray]:
    """Distortion-compensated sparse rematch: per keypoint, the first peak of
    `_sparse_rematch_scores`, then a parabola along x and y. Returns (xy
    (K,2) float32 in source coords, peak zncc (K,))."""
    flat, c0, ds = _sparse_rematch_scores(img_t, img_s, corres, kps, patch_radius,
                                          search_radius)
    D, K, dev = ds.shape[0], flat.shape[1], flat.device
    best = torch.argmax(flat, dim=0)
    s0 = flat.max(dim=0).values
    by, bx = best // D, best % D
    cols = torch.arange(K, device=dev)

    def at(iy, ix):
        return flat[torch.clamp(iy, 0, D - 1) * D + torch.clamp(ix, 0, D - 1), cols]

    off_x, _ = _parabola(at(by, bx - 1), s0, at(by, bx + 1))
    off_y, _ = _parabola(at(by - 1, bx), s0, at(by + 1, bx))
    mx = c0[0] + ds[bx] + off_x * ((bx > 0) & (bx < D - 1))
    my = c0[1] + ds[by] + off_y * ((by > 0) & (by < D - 1))
    return (torch.stack([mx, my], -1).cpu().numpy().astype(np.float32), s0.cpu().numpy())


# the sparse guided rematch skips a keypoint when more than this share of its
# patch's pixels have flat 3x3 windows; when that leaves fewer than
# _SPARSE_MIN_KEYPOINTS in a view, the round takes the flows' grid matches
# instead (see _sparse_matches_for_sfm)
_SPARSE_FLAT_SHARE = 0.1
_SPARSE_MIN_KEYPOINTS = 64


def _near_flat(img: torch.Tensor, patch_radius: int) -> np.ndarray:
    """(H,W) bool: more than _SPARSE_FLAT_SHARE of the (2 patch_radius + 1)^2
    patch around the pixel has flat 3x3 windows (see _FLAT_VAR_SHARE)."""
    flat = _target_stats(img, 1, float(img.shape[0] * 9))[2].float()
    k = 2 * patch_radius + 1
    near = F.avg_pool2d(flat[None, None], k, stride=1, padding=patch_radius,
                        count_include_pad=False)[0, 0]
    return near.cpu().numpy() > _SPARSE_FLAT_SHARE


def _sparse_matches_for_sfm(imgs, flows, unordered, H: int, W: int, stride: int = 2,
                            min_zncc: float = 0.8, max_cycle_px: float = 1.5,
                            search_radius: int = 6, extra_flows=None):
    """Pose-estimation matches (kps, pair_matches) by sparse guided rematch
    on the current flows,
    cycle-checked through the rematcher itself in both directions; with
    `extra_flows` (the stage-1 flows) each keypoint also takes a rematch
    seeded from them when it scores higher.

    A keypoint whose 11x11 patch is more than a tenth flat (a silhouette
    against a textureless background, or a textureless area) is not matched.
    The flows carry no match at flat pixels (the sweeps score flat windows
    0), so such a patch is sampled through a coherent but meaningless warp
    and matches its constant part well: at a silhouette that is a biased
    match. The JAX package drops most of them by accident, through the
    rounding noise its flat windows score. Measured on the synthetic scene
    from a noisy prior (tests/geometry_reference.py and the 64x80 rig of
    tests/test_torch_geometry_vs_jax.py): with them the port's SfM came to
    7.9 deg at round 1 (300x400) and 6.3 deg after the stage (64x80), the JAX
    package to 2.9 and 6.9; skipping patches more than 0 / 0.1 / 0.2 flat
    gave 1.2 / 1.2 / 1.1 deg and 7.5 / 1.5 / 2.3 deg. Keeping those keypoints
    and leaving their flat pixels out of the patch ZNCC instead does not
    remove the bias at 300x400.

    The synthetic scene's background is flat, so the rule keeps about a
    fifth of the keypoints at every size (more texture on the spheres,
    `texture_octaves` 3, keeps the same counts): 111 of 520 per view at
    51x64, ~160 of 884 at 64x80, ~1,400 of 6,486 at 150x200, but 32-35 of
    140 at 32x40, where the SfM on the few survivors landed at 15.7 deg from
    every prior (the JAX stage 1.4-3.1). Below _SPARSE_MIN_KEYPOINTS kept in
    a source view the function returns None, and the round solves its SfM on the flows'
    grid matches, as round 0 does; at 32x40 that ends at 3.6-4.3 deg from
    six priors, against 4.1 without the rule and 7.0 / 11.3 / 14.1 with
    shares of 0.5 / 0.3 / 0.2 (PERF.md). Sizes from 51x64 up keep the rule
    and its readings."""
    from sparf_tpu_torch.colmap_init.sfm import grid_keypoints

    kps = grid_keypoints(H, W, stride, margin=6)
    kx, ky = kps[:, 0].astype(int), kps[:, 1].astype(int)
    textured_of = {int(i): ~_near_flat(imgs[int(i)], 5)[ky, kx] for i, _ in unordered}
    if min(int(t.sum()) for t in textured_of.values()) < _SPARSE_MIN_KEYPOINTS:
        return None
    pair_matches = {}
    for i, j in unordered:
        textured = textured_of[int(i)]
        seeds = [flows] if extra_flows is None else [flows, extra_flows]
        K = kps.shape[0]
        best_xy = np.zeros((K, 2), np.float32)
        best_score = np.full(K, -np.inf, np.float32)
        for fl in seeds:
            xy_j, z1 = _sparse_guided_rematch(imgs[i], imgs[j], fl[(i, j)][0], kps,
                                              search_radius=search_radius)
            xy_back, z2 = _sparse_guided_rematch(imgs[j], imgs[i], fl[(j, i)][0], xy_j,
                                                 search_radius=search_radius)
            cyc = np.linalg.norm(xy_back - kps, axis=-1)
            score = np.minimum(z1, z2)
            ok = ((z1 > min_zncc) & (z2 > min_zncc) & (cyc < max_cycle_px) & textured
                  & (xy_j[:, 0] >= 0) & (xy_j[:, 0] <= W - 1)
                  & (xy_j[:, 1] >= 0) & (xy_j[:, 1] <= H - 1))
            take = ok & (score > best_score)
            best_xy[take] = xy_j[take]
            best_score[take] = score[take]
        sel = np.where(np.isfinite(best_score))[0]
        pair_matches[(int(i), int(j))] = (sel, best_xy[sel])
    return kps, pair_matches


def _sfm_from_matches(scene_stub, kps, pair_matches, ba_iters, init_poses_w2c, seed: int = 0,
                      device="cpu"):
    """Prior-initialised SfM when initial poses exist, else (or when it
    fails) the incremental essential + PnP pipeline."""
    from sparf_tpu_torch.colmap_init import sfm as sfm_mod

    if init_poses_w2c is not None:
        try:
            res = sfm_mod.run_prior_init_sfm(scene_stub, (kps, pair_matches),
                                             np.asarray(init_poses_w2c),
                                             ba_iters=max(ba_iters, 1500))
            if not res.index_images_excluded and res.colmap_depth is not None:
                return res
        except _DEGENERATE:
            pass
    return sfm_mod.run_mini_sfm(scene_stub, None, ba_iters=ba_iters,
                                matches=(kps, pair_matches), seed=seed, device=device)


def _global_poses_from_flows(images: np.ndarray, intr: np.ndarray, flows, unordered,
                             min_conf: float = 0.85, stride: int = 2, min_score: float = 0.6,
                             ba_iters: int = 1000, matches=None, init_poses_w2c=None,
                             seed: int = 0, device="cpu"):
    """Globally consistent poses + per-view depth pools from the current flows
    (grid matches of the cycle/score-gated flows, or the given `matches`,
    through the mini-SfM). Returns (poses (B,3,4) float64, {view: depths})
    or (None, None) when SfM does not register every view."""
    from sparf_tpu_torch.colmap_init import sfm as sfm_mod

    B, _, H, W = images.shape
    scene_stub = {"image": images, "intr": intr}
    if matches is not None:
        kps, pair_matches = matches
    else:
        kps = sfm_mod.grid_keypoints(H, W, stride)
        kx, ky = kps[:, 0].astype(int), kps[:, 1].astype(int)
        pair_matches = {}
        for i, j in unordered:
            corres_ij, score_ij, _ = flows[(i, j)]
            conf = _cycle_confidence(corres_ij, flows[(j, i)][0]).cpu().numpy()
            conf = conf * (score_ij.cpu().numpy() >= min_score)
            sel = np.where(conf[ky, kx] >= min_conf)[0]
            xy_j = corres_ij.cpu().numpy()[ky[sel], kx[sel]]
            inb = ((xy_j[:, 0] >= 0) & (xy_j[:, 0] <= W - 1)
                   & (xy_j[:, 1] >= 0) & (xy_j[:, 1] <= H - 1))
            pair_matches[(int(i), int(j))] = (sel[inb], xy_j[inb])
    try:
        res = _sfm_from_matches(scene_stub, kps, pair_matches, ba_iters, init_poses_w2c,
                                seed=seed, device=device)
    except _DEGENERATE:
        return None, None
    if res.index_images_excluded or res.colmap_depth is None:
        return None, None
    depth_pool = {}
    for v in range(B):
        d = res.colmap_depth[v]
        d = d[d > 0]
        depth_pool[v] = d if d.size >= 8 else None
    return res.poses_w2c[:, :3].astype(np.float64), depth_pool


# ---------------------------------------------------------------------------
# geometry stage: rounds
# ---------------------------------------------------------------------------


def _rematch_all_pairs(imgs: torch.Tensor, intr: np.ndarray, flows, unordered, poses,
                       depth_pool, radius: int = 1, extras=None) -> None:
    """Plane-sweep rematch of both directions of every pair at `poses`
    (in place on `flows`); `extras` receives {(t,s): (curvature, inverse
    depth)} for the optional confidence gates."""
    for t, s in unordered:
        if depth_pool.get(t) is None or depth_pool.get(s) is None:
            continue
        R_rel = poses[s, :3, :3] @ poses[t, :3, :3].T
        t_rel = poses[s, :3, 3] - R_rel @ poses[t, :3, 3]
        if np.linalg.norm(t_rel) < 1e-9:
            continue
        c_ts, s_ts, m_ts, cv_ts, d_ts = _geom_rematch_pair(
            imgs[t], imgs[s], intr[t], intr[s], R_rel, t_rel, depth_pool[t], radius=radius)
        c_st, s_st, m_st, cv_st, d_st = _geom_rematch_pair(
            imgs[s], imgs[t], intr[s], intr[t], R_rel.T, -R_rel.T @ t_rel, depth_pool[s],
            radius=radius)
        flows[(t, s)] = (c_ts, s_ts, m_ts)
        flows[(s, t)] = (c_st, s_st, m_st)
        if extras is not None:
            extras[(t, s)] = (cv_ts, d_ts)
            extras[(s, t)] = (cv_st, d_st)


def _rematched_flow_quality(flows, unordered, parts: bool = False):
    """Round score: mean over directed pairs of the confident-pixel fraction
    x mean confident ZNCC (the mean of score where margin > 0.5) of flows
    rematched at the round's poses; -inf without pairs. With `parts`,
    (score, coverage, mean confident ZNCC), the last two each a mean over
    directed pairs, from the same host copies."""
    vals, cover, zncc = [], [], []
    for t, s in unordered:
        for key in ((t, s), (s, t)):
            _, sc, m = flows[key]
            sc, m = sc.cpu().numpy(), m.cpu().numpy() > 0.5
            # numpy's float32 mean over the host copy, as the JAX package takes it
            vals.append(float(np.where(m, sc, 0.0).mean()))
            if parts:
                cover.append(float(m.mean()))
                zncc.append(float(sc[m].mean()) if m.any() else 0.0)
    score = float(np.mean(vals)) if vals else -np.inf
    if not parts:
        return score
    return score, float(np.mean(cover)), float(np.mean(zncc))


def _clock(device) -> float:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _geometry_rounds(images: np.ndarray, imgs: torch.Tensor, intr: np.ndarray, flows,
                     unordered, init_poses_w2c, geom_iters: int, radius: int = 1,
                     seed: int = 0, report: Optional[list] = None,
                     candidates: bool = False):
    """mini-SfM <-> plane-sweep-rematch rounds, in place on `flows`.

    Each round races the prior-chained candidate (SfM refined from the
    previous round's poses, or the initial poses) against a fresh essential
    + PnP bootstrap and keeps the one whose rematched flows score higher
    (_rematched_flow_quality; ties go to the first, the prior). Rounds after
    the first take their SfM matches from a sparse guided rematch, with a
    search radius growing 4 px per round and the stage-1 flows as a second
    seed. When global SfM fails for both, the round falls back to
    independent per-pair poses (`_pairwise_geom_round`). The flows and poses
    of the best-scoring round are kept. `report` receives one dict per round:
    winner ("prior", "fresh" or "pairwise"), score, views registered,
    seconds and the SfM matches kept per pair (`keypoints`: {"i-j": count}
    of sparse rematch matches, or None for the flows' grid matches); with
    `candidates` also each candidate (`candidates`: name, poses as a (B,3,4)
    nested list or None, score, coverage and mean confident ZNCC). Returns
    (poses (B,3,4) float64, depth_pool) or (None, None) when every round fell
    back to pairwise geometry."""
    dev = imgs.device
    best, best_score, best_flows = (None, None), -np.inf, None
    stage1 = dict(flows)
    prior = init_poses_w2c
    for it in range(max(geom_iters, 0)):
        t0 = _clock(dev)
        last = it == geom_iters - 1
        matches = None
        if it > 0:
            H, W = imgs.shape[-2:]
            matches = _sparse_matches_for_sfm(imgs, flows, unordered, H, W,
                                              search_radius=6 + 4 * it, extra_flows=stage1)
        inits = [prior] if prior is None else [prior, None]
        round_best, cands = None, []
        for c, init_p in enumerate(inits):
            name = "fresh" if init_p is None else "prior"
            poses, depth_pool = _global_poses_from_flows(
                np.asarray(images), intr, flows, unordered, min_conf=0.80, matches=matches,
                init_poses_w2c=init_p, seed=int(seed) * 1000 + 10 * it + c, device=dev)
            if poses is None:
                cands.append(dict(candidate=name, poses=None))
                continue
            trial = dict(flows)
            _rematch_all_pairs(imgs, intr, trial, unordered, poses, depth_pool, radius=radius)
            if candidates:
                score, coverage, zncc = _rematched_flow_quality(trial, unordered, parts=True)
                cands.append(dict(candidate=name, poses=poses.tolist(), score=score,
                                  coverage=coverage, mean_zncc=zncc))
            else:
                score = _rematched_flow_quality(trial, unordered)
            if round_best is None or score > round_best[0]:
                round_best = (score, poses, depth_pool, trial, name)
        keypoints = (None if matches is None
                     else {f"{i}-{j}": int(len(v[0])) for (i, j), v in matches[1].items()})
        if round_best is None:
            _pairwise_geom_round(imgs, intr, flows, unordered, init_poses_w2c,
                                 lk_for_next=not last, seed=seed, round_index=it)
            if report is not None:
                report.append(dict(round=it, winner="pairwise", score=None, views=0,
                                   seconds=_clock(dev) - t0, keypoints=keypoints,
                                   **(dict(candidates=cands) if candidates else {})))
            continue
        score, poses, depth_pool, trial, winner = round_best
        flows.clear()
        flows.update(trial)
        prior = poses
        if score >= best_score:
            best, best_score, best_flows = (poses, depth_pool), score, dict(trial)
        if report is not None:
            report.append(dict(round=it, winner=winner, score=score, views=len(poses),
                               seconds=_clock(dev) - t0, keypoints=keypoints,
                               **(dict(candidates=cands) if candidates else {})))
    if best_flows is not None:
        flows.clear()
        flows.update(best_flows)
    return best


def _pdcnet_stage1_provider(images_full: np.ndarray, weights_path, adapt_steps: int = 0,
                            use_homography: bool = False, multiscale_factors=None,
                            device="cuda"):
    """Stage 1 of the hybrid route: PDC-Net (models/pdcnet.py) runs once at
    the full resolution for every ordered pair the stage needs; smaller
    stage-1 requests get linear resizes of its maps (coordinates scaled).
    The score and margin slots both carry p_r, read as p_r thresholds until
    the plane sweep replaces them with ZNCC scores."""
    cache = {}

    def provider(imgs, needed, n_levels, patch, homography=False):
        del n_levels, patch, homography
        H, W = int(imgs.shape[-2]), int(imgs.shape[-1])
        Hf, Wf = int(images_full.shape[-2]), int(images_full.shape[-1])
        if not cache:
            from sparf_tpu_torch.models import pdcnet

            pairs = sorted(needed)
            combi = np.array([[t for t, _ in pairs], [s for _, s in pairs]], np.int32)
            corres, conf = pdcnet.compute_pdcnet_flow_of_combi_list(
                images_full, combi, weights_path=weights_path, adapt_steps=adapt_steps,
                use_homography=use_homography, multiscale_factors=multiscale_factors,
                device=device)
            for p, (t, s) in enumerate(pairs):
                cache[(t, s)] = (corres[p].transpose(1, 2, 0), conf[p, 0])
        out = {}
        for t, s in sorted(needed):
            c, f = cache[(t, s)]
            if (H, W) != (Hf, Wf):
                sc = np.array([W / Wf, H / Hf], np.float32)
                c = imgproc.resize_linear(np.asarray(c), (H, W)) * sc
                f = imgproc.resize_linear(np.asarray(f), (H, W))
            f = torch.as_tensor(np.asarray(f), device=imgs.device)
            out[(t, s)] = (torch.as_tensor(np.asarray(c), device=imgs.device), f, f)
        return out

    return provider


# the geometry bootstrap runs at <= this many px on the long side; at full
# resolution only the final plane-sweep rematch runs
_BOOTSTRAP_MAX_DIM = 200


def _n_levels_for(H: int, W: int) -> int:
    return max(2, int(np.floor(np.log2(min(H, W) / 10))) + 1)


def _compute_zncc_flow_impl(images, combi_list, n_levels, patch, min_zncc_score, min_margin,
                            intr, init_poses_w2c, geom_iters, return_cc, use_homography,
                            stage1_fn, geom_out, seed, round_candidates, device):
    stage1 = stage1_fn or _stage1_flows
    images_np = np.asarray(images)
    imgs = torch.as_tensor(images_np, dtype=torch.float32, device=device)
    B, C, H, W = imgs.shape
    needed, unordered = _pair_sets(combi_list)
    geom = {} if geom_out is None else geom_out
    seconds, rounds = {}, []

    if intr is not None and max(H, W) > _BOOTSTRAP_MAX_DIM * 1.3:
        # low-resolution bootstrap: stage 1, SfM and the rematch rounds at
        # <= _BOOTSTRAP_MAX_DIM px, then one full-resolution plane-sweep
        # rematch at the bootstrap's poses with 7x7 windows (radius 3)
        intr = np.asarray(intr)
        sc = _BOOTSTRAP_MAX_DIM / max(H, W)
        Hs, Ws = int(round(H * sc)), int(round(W * sc))
        small_np = np.stack([imgproc.resize_area(im.transpose(1, 2, 0), (Hs, Ws))
                             .transpose(2, 0, 1) for im in images_np])
        S = np.diag([Ws / W, Hs / H, 1.0])
        intr_small = np.stack([S @ np.asarray(K, np.float64) for K in intr])
        imgs_small = torch.as_tensor(small_np, dtype=torch.float32, device=device)
        t0 = _clock(device)
        flows_small = stage1(imgs_small, needed, _n_levels_for(Hs, Ws), patch,
                             homography=use_homography)
        seconds["stage1"] = _clock(device) - t0
        poses, depth_pool = _geometry_rounds(small_np, imgs_small, intr_small, flows_small,
                                             unordered, init_poses_w2c, geom_iters, radius=1,
                                             seed=seed, report=rounds,
                                             candidates=round_candidates)
        geom.update(bootstrap=(Hs, Ws), rounds=rounds, seconds=seconds)

        def upsampled(key):
            c, scr, mg = flows_small[key]
            c = c.cpu().numpy() * np.array([W / Ws, H / Hs], np.float32)
            return tuple(torch.as_tensor(imgproc.resize_linear(x, (H, W)), device=device)
                         for x in (c, scr.cpu().numpy(), mg.cpu().numpy()))

        flows, extras = {}, {}
        if poses is not None:
            geom["poses_w2c"] = np.asarray(poses)[:, :3]
            t0 = _clock(device)
            _rematch_all_pairs(imgs, intr, flows, unordered, poses, depth_pool, radius=3,
                               extras=extras)
            seconds["rematch_full"] = _clock(device) - t0
        # pairs without a full-resolution rematch (no global poses, or a view
        # with fewer than 8 SfM depths) take the bootstrap's flows, upsampled
        # (the JAX package raises a KeyError on the second case)
        missing = sorted(k for k in flows_small if k not in flows)
        geom["output"] = ("full-resolution rematch" if not missing
                          else "upsampled bootstrap flows" if not flows
                          else f"full-resolution rematch, {len(missing)} directed pairs upsampled")
        flows.update({k: upsampled(k) for k in missing})
        return _assemble_flow_outputs(flows, combi_list, min_zncc_score, min_margin, return_cc,
                                      extras=extras)

    if n_levels is None:
        n_levels = _n_levels_for(H, W)
    t0 = _clock(device)
    flows = stage1(imgs, needed, n_levels, patch, homography=use_homography)
    seconds["stage1"] = _clock(device) - t0
    if intr is not None:
        poses, _ = _geometry_rounds(images_np, imgs, np.asarray(intr), flows, unordered,
                                    init_poses_w2c, geom_iters, radius=1, seed=seed,
                                    report=rounds, candidates=round_candidates)
        geom.update(bootstrap=None, rounds=rounds, seconds=seconds,
                    output="rematched flows" if poses is not None else "pairwise or stage-1 flows")
        if poses is not None:
            geom["poses_w2c"] = np.asarray(poses)[:, :3]
    return _assemble_flow_outputs(flows, combi_list, min_zncc_score, min_margin, return_cc)


def _multiview_agreement_masks(extras, mv_tol: float):
    """{(t,s): bool (H,W)}: does pair (t,s)'s inverse depth of view t agree
    (relative difference < mv_tol) with at least one other pair of view t?"""
    by_target: Dict[int, list] = {}
    for (t, s), (_curv, invd) in extras.items():
        by_target.setdefault(t, []).append((s, invd))
    masks = {}
    for t, lst in by_target.items():
        if len(lst) < 2:
            continue
        for i, (s_i, d_i) in enumerate(lst):
            ok = None
            for j, (_, d_j) in enumerate(lst):
                if i == j:
                    continue
                rel = torch.abs(d_i - d_j) / torch.clamp(torch.maximum(torch.abs(d_i),
                                                                       torch.abs(d_j)), min=1e-9)
                ok = rel < mv_tol if ok is None else (ok | (rel < mv_tol))
            masks[(t, s_i)] = ok
    return masks


def _assemble_flow_outputs(flows, combi_list: np.ndarray, min_zncc_score: float,
                           min_margin: float, return_cc: bool, extras=None,
                           min_curv: float = 0.0, mv_tol: float = 0.0):
    """Maps of the combi list: confidence = cycle consistency x (score >=
    min_zncc_score) x (margin >= min_margin), then, with `extras`, x
    (curvature >= min_curv) and, when mv_tol > 0, the multi-view inverse-depth
    agreement (both gates off by default, as in the JAX package); cc =
    1/(1+cycle error)."""
    mv_masks = _multiview_agreement_masks(extras, mv_tol) if extras and mv_tol > 0 else {}
    corres_out, conf_out, cc_out = [], [], []
    for t, s in combi_list.T:
        t, s = int(t), int(s)
        corres_ts, score_ts, margin_ts = flows[(t, s)]
        corres_st = flows[(s, t)][0]
        conf = (_cycle_confidence(corres_ts, corres_st) * (score_ts >= min_zncc_score)
                * (margin_ts >= min_margin))
        if extras and (t, s) in extras:
            conf = conf * (extras[(t, s)][0] >= min_curv)
        if (t, s) in mv_masks:
            conf = conf * mv_masks[(t, s)]
        corres_out.append(corres_ts.permute(2, 0, 1).cpu().numpy())
        conf_out.append(conf.cpu().numpy()[None])
        if return_cc:
            cc_out.append((1.0 / (1.0 + _cycle_error(corres_ts, corres_st))).cpu().numpy()[None])
    corres_np = np.stack(corres_out).astype(np.float32)
    conf_np = np.stack(conf_out).astype(np.float32)
    if return_cc:
        return corres_np, conf_np, np.stack(cc_out).astype(np.float32)
    return corres_np, conf_np


def compute_zncc_flow_of_combi_list(images: np.ndarray, combi_list: np.ndarray,
                                    n_levels: Optional[int] = None, patch: int = 7,
                                    min_zncc_score: float = 0.7, min_margin: float = 0.05,
                                    intr: Optional[np.ndarray] = None,
                                    init_poses_w2c: Optional[np.ndarray] = None,
                                    geom_iters: int = 3, return_cc: bool = False,
                                    use_homography: bool = False, stage1_fn=None,
                                    geom_out: Optional[dict] = None, seed: int = 0,
                                    round_candidates: bool = False, device="cuda"):
    """Dense matching of every pair: (P,2,H,W) corres + (P,1,H,W) conf (+ cc).

    Stage 1 (`stage1_fn`, default the ZNCC pyramid) matches by appearance.
    With `intr` (B,3,3) the geometry stage follows (`_geometry_rounds`, from
    the `init_poses_w2c` prior when given), at <= _BOOTSTRAP_MAX_DIM px for
    larger scenes with one full-resolution rematch after. `geom_out` receives
    the stage's report: 'poses_w2c' (B,3,4) float64 when global poses were
    found, 'rounds' (winner, score, views, seconds and SfM matches per
    round; with `round_candidates` every candidate's poses and score parts,
    _geometry_rounds), 'seconds'
    (stage1, rematch_full), 'bootstrap' (the small size or None) and
    'output' (which flows were emitted). RANSAC generators derive from
    `seed`. Everything from stage 1 to the assembled maps runs in full
    float32 (TF32 off): the sweeps put pixel coordinates through matmuls."""
    with torch.no_grad(), ieee_fp32():
        return _compute_zncc_flow_impl(images, combi_list, n_levels, patch, min_zncc_score,
                                       min_margin, intr, init_poses_w2c, geom_iters, return_cc,
                                       use_homography, stage1_fn, geom_out, seed,
                                       round_candidates, device)


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


class FlowSelectionWrapper:
    """Matcher facade: backend 'gt_depth' | 'PDCNet' | 'pdcnet_jax' | 'SPSG' |
    'zncc'. 'PDCNet' takes ckpt_path, else the bundled weights; without
    either it falls back to 'zncc' with the JAX package's warning. With the
    scene's intrinsics, 'zncc' and 'pdcnet_jax' with geometry_refine run the
    geometry stage from the init_poses_w2c prior; `last_geom` then holds its
    report (compute_zncc_flow_of_combi_list's geom_out), else it is empty.
    `seed` seeds the stage's RANSAC generators."""

    def __init__(self, backend: str = "zncc", ckpt_path: Optional[str] = None,
                 adapt_steps: int = 0, init_poses_w2c: Optional[np.ndarray] = None,
                 use_homography: bool = False, geometry_refine: bool = True,
                 multiscale_factors=None, seed: int = 0, device="cuda"):
        self.backend = backend
        self.ckpt_path = ckpt_path
        self.adapt_steps = adapt_steps
        self.multiscale_factors = tuple(multiscale_factors or ())
        self.use_homography = bool(use_homography)
        self.geometry_refine = bool(geometry_refine)
        self.init_poses_w2c = np.asarray(init_poses_w2c) if init_poses_w2c is not None else None
        self.seed = int(seed)
        self.device = device
        self.last_geom: dict = {}
        self._resolved_backend: Optional[str] = None

    def _resolve_backend(self) -> str:
        """The backend that runs, resolved once (so the fallback warns once)."""
        if self._resolved_backend:
            return self._resolved_backend
        backend = self.backend
        if backend == "PDCNet":
            from sparf_tpu_torch.models import pdcnet

            log = logging.getLogger("sparf_tpu_torch")
            if not self.ckpt_path:
                if os.path.exists(pdcnet.BUNDLED_WEIGHTS):
                    self.ckpt_path = pdcnet.BUNDLED_WEIGHTS
            elif not os.path.exists(self.ckpt_path):
                log.warning("PDCNet ckpt_path %s does not exist — treating as unset",
                            self.ckpt_path)
                self.ckpt_path = None
            if self.ckpt_path:
                backend = "pdcnet_jax"
            else:
                log.warning("PDCNet backend requested but no weights found (ckpt_path unset, "
                            "no bundled sparf_tpu/data/pdcnet_synth.npz) — falling back to "
                            "the classical geometry-guided matcher")
                backend = "zncc"
        self._resolved_backend = backend
        return backend

    def compute_flow_and_confidence_map_of_combi_list(self, scene: Dict[str, np.ndarray],
                                                      combi_list: np.ndarray,
                                                      return_cc: bool = False):
        backend = self._resolve_backend()
        self.last_geom = {}
        if backend == "gt_depth":
            if "depth_gt" not in scene:
                raise ValueError("the gt_depth backend needs GT depth")
            corres, conf = compute_gt_flow_of_combi_list(scene, combi_list)
            return (corres, conf, np.ones_like(conf)) if return_cc else (corres, conf)
        images = np.asarray(scene["image"])
        intr = np.asarray(scene["intr"]) if "intr" in scene else None
        if backend == "zncc":
            if intr is not None:
                self.last_geom["route"] = "ZNCC seeds -> mini-SfM -> plane-sweep rematch"
            return compute_zncc_flow_of_combi_list(
                images, combi_list, intr=intr, init_poses_w2c=self.init_poses_w2c,
                return_cc=return_cc, use_homography=self.use_homography,
                geom_out=self.last_geom, seed=self.seed, device=self.device)
        if backend == "SPSG":
            from sparf_tpu_torch.models import sparse_matcher

            return sparse_matcher.compute_spsg_flow_of_combi_list(
                images, combi_list, return_cc=return_cc, device=self.device)
        if backend == "pdcnet_jax":
            from sparf_tpu_torch.models import pdcnet

            if self.geometry_refine and intr is not None:
                self.last_geom["route"] = "PDC-Net seeds -> mini-SfM -> plane-sweep rematch"
                return compute_zncc_flow_of_combi_list(
                    images, combi_list, intr=intr, init_poses_w2c=self.init_poses_w2c,
                    return_cc=return_cc,
                    stage1_fn=_pdcnet_stage1_provider(
                        images, self.ckpt_path, self.adapt_steps,
                        use_homography=self.use_homography,
                        multiscale_factors=self.multiscale_factors, device=self.device),
                    geom_out=self.last_geom, seed=self.seed, device=self.device)
            corres, conf = pdcnet.compute_pdcnet_flow_of_combi_list(
                images, combi_list, weights_path=self.ckpt_path, adapt_steps=self.adapt_steps,
                use_homography=self.use_homography, multiscale_factors=self.multiscale_factors,
                device=self.device)
            if return_cc:
                return corres, conf, cc_maps_from_corres(corres, combi_list)
            return corres, conf
        raise ValueError(backend)

    def compute_flow_and_confidence_map_and_cc_of_combi_list(self, scene, combi_list):
        """Also returns the separate cyclic-consistency confidence map."""
        return self.compute_flow_and_confidence_map_of_combi_list(scene, combi_list,
                                                                  return_cc=True)
