"""Dense correspondence front-end (torch port of sparf_tpu/models/flow_net.py).

The matcher facade `FlowSelectionWrapper` routes to
  - 'gt_depth': exact correspondences from GT depth and GT poses;
  - 'PDCNet' / 'pdcnet_jax': the learned net of models/pdcnet.py, its raw
    flows (the bundled weights when no checkpoint is given);
  - 'SPSG': the sparse keypoint matcher of models/sparse_matcher.py;
  - 'zncc': the classical hierarchical ZNCC matcher, its appearance stage
    (stage 1: ZNCC pyramid, median filtering, subpixel fit, optional
    homography pre-alignment; cycle-consistency confidence).
The geometry stage that both 'zncc' and PDCNet's default
(`pdcnet_geometry_refine=True`) run when the scene has intrinsics (mini-SfM,
plane-sweep rematching) is not ported: those routes raise
NotImplementedError naming its ROADMAP item, and nothing substitutes another
backend without the JAX package's warning.

All backends return numpy maps with the JAX package's contract:
  corres_maps (P, 2, H, W) float32, conf_maps (P, 1, H, W) float32
for a combi list (2, P) with row 0 = target indices, row 1 = source indices.
Matching runs on `device` (the card by default) with TF32 off.
"""
from __future__ import annotations

import logging
import os
from itertools import permutations
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparf_tpu_torch.utils import geometry, imgproc
from sparf_tpu_torch.utils.precision import ieee_fp32

GEOMETRY_STAGE_TODO = (
    "the matchers' geometry stage (mini-SfM pose bootstrap and plane-sweep rematching; "
    "ROADMAP Queue 1 item 19) is not ported to sparf_tpu_torch yet. Use "
    "--pdcnet_geometry_refine=false for raw PDC-Net flows, or "
    "--use_gt_correspondences=true")


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
    """Sample (C,H,W) at float coords x, y of shape S -> (C, *S), clamped."""
    C, H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx, wy = x - x0, y - y0
    flat = img.reshape(C, -1)

    def g(yy, xx):
        return flat[:, (yy * W + xx).to(torch.int64)]

    return (g(y0, x0) * (1 - wx) * (1 - wy) + g(y0, x1) * wx * (1 - wy)
            + g(y1, x0) * (1 - wx) * wy + g(y1, x1) * wx * wy)


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


def _assemble_flow_outputs(flows, combi_list: np.ndarray, min_zncc_score: float,
                           min_margin: float, return_cc: bool):
    """Maps of the combi list: confidence = cycle consistency x (score >=
    min_zncc_score) x (margin >= min_margin); cc = 1/(1+cycle error)."""
    corres_out, conf_out, cc_out = [], [], []
    for t, s in combi_list.T:
        t, s = int(t), int(s)
        corres_ts, score_ts, margin_ts = flows[(t, s)]
        corres_st = flows[(s, t)][0]
        conf = (_cycle_confidence(corres_ts, corres_st) * (score_ts >= min_zncc_score)
                * (margin_ts >= min_margin))
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
                                    return_cc: bool = False, use_homography: bool = False,
                                    device="cuda"):
    """The ZNCC matcher's appearance stage over every pair: (P,2,H,W) corres
    + (P,1,H,W) conf (+ cc). With `intr` the JAX package goes on to its
    geometry stage, which is not ported: that raises."""
    if intr is not None:
        raise NotImplementedError("zncc with scene intrinsics: " + GEOMETRY_STAGE_TODO)
    imgs = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    H, W = imgs.shape[-2:]
    if n_levels is None:
        n_levels = max(2, int(np.floor(np.log2(min(H, W) / 10))) + 1)
    needed, _ = _pair_sets(combi_list)
    with torch.no_grad(), ieee_fp32():
        flows = _stage1_flows(imgs, needed, n_levels, patch, homography=use_homography)
        return _assemble_flow_outputs(flows, combi_list, min_zncc_score, min_margin, return_cc)


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


class FlowSelectionWrapper:
    """Matcher facade: backend 'gt_depth' | 'PDCNet' | 'pdcnet_jax' | 'SPSG' |
    'zncc'. 'PDCNet' takes ckpt_path, else the bundled weights; without
    either it falls back to 'zncc' with the JAX package's warning.
    `last_geom` holds what the geometry stage would report (empty: that
    stage is not ported)."""

    def __init__(self, backend: str = "zncc", ckpt_path: Optional[str] = None,
                 adapt_steps: int = 0, init_poses_w2c: Optional[np.ndarray] = None,
                 use_homography: bool = False, geometry_refine: bool = True,
                 multiscale_factors=None, device="cuda"):
        self.backend = backend
        self.ckpt_path = ckpt_path
        self.adapt_steps = adapt_steps
        self.multiscale_factors = tuple(multiscale_factors or ())
        self.use_homography = bool(use_homography)
        self.geometry_refine = bool(geometry_refine)
        # the geometry stage's pose prior (item 19); kept for it
        self.init_poses_w2c = np.asarray(init_poses_w2c) if init_poses_w2c is not None else None
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
        if backend == "zncc":
            return compute_zncc_flow_of_combi_list(
                images, combi_list, intr=np.asarray(scene["intr"]) if "intr" in scene else None,
                return_cc=return_cc, use_homography=self.use_homography, device=self.device)
        if backend == "SPSG":
            from sparf_tpu_torch.models import sparse_matcher

            return sparse_matcher.compute_spsg_flow_of_combi_list(
                images, combi_list, return_cc=return_cc, device=self.device)
        if backend == "pdcnet_jax":
            from sparf_tpu_torch.models import pdcnet

            if self.geometry_refine and "intr" in scene:
                raise NotImplementedError(
                    "PDCNet with pdcnet_geometry_refine=True: " + GEOMETRY_STAGE_TODO)
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
