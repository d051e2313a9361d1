"""The NeRF of the reference: positional encoding with BARF's coarse-to-fine
weights, the MLP in plain float32 torch (TF32 off, set by the caller),
stratified and hierarchical depth sampling, compositing, and the renders a
SPARF step and a full-image render make. Frozen copies of
sparf_tpu_torch/models/{embedder,nerf_mlp,renderer}.py's arithmetic, in the
same order of operations, with the MLP written out layer by layer."""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import geometry as geo


def encode(x: torch.Tensor, L: int, c2f, progress: float) -> torch.Tensor:
    """[x, sin/cos(2^k pi x) weighted by BARF's c2f window]: (...,3) -> (...,3+6L)."""
    freq = (2.0 ** torch.arange(L, dtype=torch.float32, device=x.device)) * math.pi
    spectrum = x[..., None] * freq
    enc = torch.stack([torch.sin(spectrum), torch.cos(spectrum)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], -1)
    if c2f is not None:
        start, end = c2f
        alpha = torch.as_tensor((progress - start) / (end - start) * L, dtype=torch.float32,
                                device=x.device)
        k = torch.arange(L, dtype=torch.float32, device=x.device)
        w = (1 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2
        enc = (enc.reshape(-1, L) * w).reshape(enc.shape)
    return torch.cat([x, enc], dim=-1)


def mlp(params, skip, pts_enc: torch.Tensor, view_enc: torch.Tensor):
    """(raw density (T,), raw rgb (T,3)) of the trunk and the view head;
    params {"feat": [(W, b)], "rgb": [(W, b)]}, W (out, in)."""
    feat = pts_enc
    n = len(params["feat"])
    for li, (W, b) in enumerate(params["feat"]):
        if li in skip:
            feat = torch.cat([feat, pts_enc], dim=-1)
        feat = torch.addmm(b, feat, W.t())
        if li == n - 1:
            raw_density, feat = feat[:, 0], feat[:, 1:]
        feat = F.relu(feat)
    feat = torch.cat([feat, view_enc], dim=-1)
    m = len(params["rgb"])
    for li, (W, b) in enumerate(params["rgb"]):
        feat = torch.addmm(b, feat, W.t())
        if li != m - 1:
            feat = F.relu(feat)
    return raw_density, feat


def nerf(params, spec: Dict, pts: torch.Tensor, ray: torch.Tensor, progress: float):
    """rgb (B,R,S,3) and density (B,R,S) at points pts (B,R,S,3) along rays (B,R,3)."""
    B, R, S, _ = pts.shape
    c2f = spec["barf_c2f"]
    pts_enc = encode(pts, spec["L_3D"], c2f, progress).reshape(B * R * S, -1)
    unit = ray / (torch.linalg.norm(ray, dim=-1, keepdim=True) + 1e-12)
    view = encode(unit, spec["L_view"], c2f, progress)
    view_enc = view[:, :, None, :].expand(B, R, S, view.shape[-1]).reshape(B * R * S, -1)
    leaves = [t for W, b in params["feat"] + params["rgb"] for t in (W, b)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves + [pts_enc, view_enc]):
        # recomputed in the backward: the activations of 1.6M points would
        # otherwise hold tens of GB
        raw_density, raw_rgb = checkpoint(
            lambda p, v, *flat: mlp(_unflat(flat, params), spec["skip"], p, v),
            pts_enc, view_enc, *leaves, use_reentrant=False)
    else:
        raw_density, raw_rgb = mlp(params, spec["skip"], pts_enc, view_enc)
    return (torch.sigmoid(raw_rgb).reshape(B, R, S, 3),
            F.softplus(raw_density).reshape(B, R, S))


def _unflat(flat, like):
    it = iter(flat)
    return {k: [(next(it), next(it)) for _ in like[k]] for k in ("feat", "rgb")}


def composite(ray, rgb_s, density_s, depth_s) -> Dict[str, torch.Tensor]:
    ray_length = torch.linalg.norm(ray, dim=-1, keepdim=True)
    t = depth_s[..., 0]
    intv = t[..., 1:] - t[..., :-1]
    intv = torch.cat([intv, torch.full_like(intv[..., :1], 1e10)], dim=-1)
    sigma_delta = density_s * (intv * ray_length)
    alpha = 1 - torch.exp(-sigma_delta)
    shifted = torch.cat([torch.zeros_like(sigma_delta[..., :1]), sigma_delta[..., :-1]], dim=-1)
    T = torch.exp(-torch.cumsum(shifted, dim=-1))
    weights = (T * alpha)[..., None]
    depth = torch.sum(depth_s * weights, dim=2)
    rgb = torch.sum(rgb_s * weights, dim=2)
    return dict(rgb=rgb, depth=depth, opacity=torch.sum(weights, dim=2), weights=weights,
                all_cumulated=T[..., -2])


def stratified_depths(draws, B: int, R: int, S: int, depth_range, inverse: bool):
    if draws is not None:
        rand = draws.uniform((B, R, S, 1))
    else:
        rand = torch.full((B, R, S, 1), 0.5, device=depth_range.device)
    rand = rand + torch.arange(S, dtype=torch.float32, device=depth_range.device)[None, None, :,
                                                                                  None]
    samples = rand / S * (depth_range[1] - depth_range[0]) + depth_range[0]
    return 1.0 / (samples + 1e-8) if inverse else samples


def pdf_depths(draws, weights, S: int, Sf: int, depth_range):
    """Inverse-CDF resampling of the coarse histogram over linear bins."""
    dmin, dmax = depth_range[0], depth_range[1]
    pdf = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-6)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    grid = (torch.linspace(0.0, 1.0, Sf + 1, device=weights.device) if draws is None
            else draws.uniform((Sf + 1,)))
    unif = (0.5 * (grid[:-1] + grid[1:])).expand(*cdf.shape[:-1], Sf)
    le = cdf[..., None, :] <= unif[..., :, None]
    idx = torch.sum(le, dim=-1)
    cdf_b = cdf[..., None, :].expand(le.shape)
    cdf_low = torch.amax(torch.where(le, cdf_b, torch.full_like(cdf_b, -1.0)), dim=-1)
    cdf_high = torch.amin(torch.where(le, torch.full_like(cdf_b, float("inf")), cdf_b), dim=-1)
    cdf_high = torch.where(torch.isfinite(cdf_high), cdf_high, cdf[..., -1:])
    delta = (dmax - dmin) / S
    d_low = dmin + torch.clamp(idx - 1, 0, S).to(torch.float32) * delta
    d_high = dmin + torch.clamp(idx, max=S).to(torch.float32) * delta
    t = (unif - cdf_low) / (cdf_high - cdf_low + 1e-8)
    return (d_low + t * (d_high - d_low))[..., None]


def render_pixels(params, spec, pose_w2c, intr, pixels, depth_range, progress, draws,
                  fine: bool) -> Dict[str, torch.Tensor]:
    """Coarse [+ fine] render at pixels; draws=None renders deterministically."""
    center, ray = geo.center_and_ray_at_pixels(pose_w2c, pixels, intr)
    B, R = ray.shape[:2]
    depth = stratified_depths(draws, B, R, spec["sample_intvs"], depth_range,
                              spec["depth_param"] == "inverse")
    pts = center[:, :, None] + ray[:, :, None] * depth
    out = composite(ray, *nerf(params["coarse"], spec, pts, ray, progress), depth)
    if fine:
        depth_f = pdf_depths(draws, out["weights"][..., 0].detach(), spec["sample_intvs"],
                             spec["sample_intvs_fine"], depth_range)
        depth_all = torch.sort(torch.cat([depth, depth_f], dim=2), dim=2).values.detach()
        pts = center[:, :, None] + ray[:, :, None] * depth_all
        out.update({k + "_fine": v for k, v in composite(
            ray, *nerf(params["fine"], spec, pts, ray, progress), depth_all).items()})
    return out


def render_to_max(params, spec, pose_w2c, intr, pixels, depth_min, depth_max, progress,
                  fine: bool) -> Dict[str, torch.Tensor]:
    """Deterministic samples up to a per-ray depth (B,N): the visibility pass."""
    center, ray = geo.center_and_ray_at_pixels(pose_w2c, pixels, intr)
    B, R = ray.shape[:2]
    S = spec["sample_intvs"]
    rand = (1.0 + torch.arange(S, dtype=torch.float32, device=ray.device))
    rand = rand[None, None, :, None].expand(B, R, S, 1)
    depth = rand / S * (depth_max[..., None, None] - depth_min) + depth_min
    pts = center[:, :, None] + ray[:, :, None] * depth
    out = composite(ray, *nerf(params["coarse"], spec, pts, ray, progress), depth)
    if fine:
        out.update({k + "_fine": v for k, v in composite(
            ray, *nerf(params["fine"], spec, pts, ray, progress), depth).items()})
    return out


@torch.no_grad()
def render_image(params, spec, pose_w2c, intr, H: int, W: int, depth_range, progress,
                 fine: bool, chunk: int) -> Dict[str, torch.Tensor]:
    """Full image, `chunk` rays at a time, padded with pixel (0, 0) and cropped:
    rgb, depth (1, H*W, k) and their _fine twins."""
    HW = H * W
    n_chunks = -(-HW // chunk)
    pixels = geo.pixel_grid(H, W, pose_w2c.device)
    pixels = torch.cat([pixels, pixels.new_zeros((n_chunks * chunk - HW, 2))], dim=0)
    keys = ["rgb", "depth"] + (["rgb_fine", "depth_fine"] if fine else [])
    parts: Dict[str, List[torch.Tensor]] = {k: [] for k in keys}
    for c in range(n_chunks):
        out = render_pixels(params, spec, pose_w2c, intr, pixels[c * chunk: (c + 1) * chunk],
                            depth_range, progress, None, fine)
        for k in keys:
            parts[k].append(out[k])
    return {k: torch.cat(v, dim=1)[:, :HW] for k, v in parts.items()}


def depth_range(run: Dict, scene: Dict, device) -> torch.Tensor:
    """[near, far] of the samples: the configured range for inverse depth,
    the scene's bounds otherwise."""
    if run["nerf.depth.param"] == "inverse":
        return torch.as_tensor(run["nerf.depth.range"], dtype=torch.float32, device=device)
    return torch.as_tensor(scene["depth_range"][0], device=device)


def progress(run: Dict, iteration_nerf: int) -> float:
    """BARF's coarse-to-fine progress of the encodings."""
    if run["barf_c2f"] is None:
        return 1.0
    return min(1.0, iteration_nerf / float(run["max_iter"]))


def init_spec(run: Dict) -> Dict:
    """The reference's view of a configuration file's `run` section."""
    return dict(L_3D=run["arch.posenc.L_3D"], L_view=run["arch.posenc.L_view"],
                skip=tuple(run["arch.skip"]), barf_c2f=run["barf_c2f"],
                sample_intvs=run["nerf.sample_intvs"],
                sample_intvs_fine=run["nerf.sample_intvs_fine"],
                depth_param=run["nerf.depth.param"])

