"""Volume renderer, main-path part (torch port of sparf_tpu/models/renderer.py):
stratified and hierarchical depth sampling, the MLP call, compositing.

  - `render_rays` renders a (B,R) tile of rays, coarse [+ fine];
  - `render_to_max` renders up to a per-ray max depth; its `all_cumulated`
    is the visibility signal of the depth-consistency loss;
  - `render_bundles` renders the RayBundles a training step's losses ask for:
    one render call per bundle, or (merge=True) one MLP call per hierarchy
    level and gradient group over the points of every bundle;
  - `render_image_chunked` renders a full image deterministically, in chunks
    of rays, without gradients (validation and evaluation).

The MLP runs through sparf_tpu_torch.ops.fused_mlp: the CUDA kernels on CUDA
tensors, their plain versions on CPU tensors. Random numbers come from a Draws object
(sparf_tpu_torch.utils.draws), consumed in the JAX package's order.

Under ray sharding (sparf_tpu_torch.parallel) a training step's bundles
hold only this rank's rays, sharded where the losses sample them, so the
renderer sees local rays; `render_image_chunked` splits each chunk's rays
across ranks itself and gathers the results.

Spans (utils/tracing.py): `render.bundles` per render_bundles call,
`render.coarse` (geometry, depth samples and the coarse MLP), `render.fine`
(the PDF's samples, the sort and the fine MLP) and `render.composite` per
level, `render.chunk` per chunk of a full image.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from sparf_tpu_torch.models import nerf_mlp
from sparf_tpu_torch.models.nerf_mlp import MLPConfig
from sparf_tpu_torch.ops import fused_mlp
from sparf_tpu_torch.parallel import mesh as mesh_mod
from sparf_tpu_torch.utils import camera, tracing


@dataclass(frozen=True)
class RenderConfig:
    """Static rendering options."""

    mlp: MLPConfig
    sample_intvs: int = 128
    sample_intvs_fine: int = 128
    fine_sampling: bool = False
    sample_stratified: bool = True
    depth_param: str = "metric"  # or 'inverse'
    rand_rays: int = 2048
    setbg_opaque: bool = False
    ndc: bool = False
    mlp_fine: Optional[MLPConfig] = None
    # the MLP (cfg.tpu.use_pallas): "fused", ops/fused_mlp.nerf_apply_fused
    # (the CUDA kernels on a CUDA device, their plain versions on the CPU), or
    # "plain", nerf_mlp.nerf_apply in torch ops (the JAX package's XLA MLP)
    mlp_impl: str = "fused"

    @property
    def fine_mlp(self) -> MLPConfig:
        return self.mlp_fine or self.mlp

    @classmethod
    def from_config(cls, cfg) -> "RenderConfig":
        from dataclasses import replace

        mlp = MLPConfig.from_config(cfg)
        mlp_fine = None
        if cfg.arch.get("layers_feat_fine"):
            mlp_fine = replace(mlp, layers_feat=tuple(cfg.arch.layers_feat_fine[1:]))
        return cls(
            mlp=mlp,
            sample_intvs=cfg.nerf.sample_intvs,
            sample_intvs_fine=cfg.nerf.sample_intvs_fine,
            fine_sampling=cfg.nerf.fine_sampling,
            sample_stratified=cfg.nerf.sample_stratified,
            depth_param=cfg.nerf.depth.param,
            rand_rays=cfg.nerf.rand_rays,
            setbg_opaque=bool(cfg.nerf.setbg_opaque) or bool(cfg.get("mask_img", False)),
            ndc=bool(cfg.camera.ndc),
            mlp_fine=mlp_fine,
            mlp_impl="fused" if cfg.tpu.get("use_pallas", True) else "plain",
        )


def render_depth_range(cfg, scene) -> torch.Tensor:
    """Sampling range: the config range for the inverse parametrization, the
    dataset near/far otherwise."""
    if cfg.nerf.depth.param == "inverse":
        return torch.as_tensor(cfg.nerf.depth.range, dtype=torch.float32,
                               device=scene["depth_range"].device)
    return scene["depth_range"][0]


# ---------------------------------------------------------------------------
# depth sampling
# ---------------------------------------------------------------------------


def sample_depth(draws, batch_size: int, num_rays: int, n_samples: int,
                 depth_range: torch.Tensor, depth_param: str = "metric",
                 stratified: bool = True, n_rays: Optional[int] = None) -> torch.Tensor:
    """Stratified (or midpoint) depth samples, (B,R,S,1); under ray sharding
    the R rays are this rank's share of `n_rays` (mesh.draw_rays)."""
    depth_min, depth_max = depth_range[0], depth_range[1]
    shape = (batch_size, num_rays, n_samples, 1)
    if stratified and draws is not None:
        rand = mesh_mod.draw_rays(draws, shape, n_rays)
    else:
        rand = torch.full(shape, 0.5, device=depth_range.device)
    rand = rand + torch.arange(n_samples, dtype=torch.float32,
                               device=depth_range.device)[None, None, :, None]
    samples = rand / n_samples * (depth_max - depth_min) + depth_min
    if depth_param == "inverse":
        samples = 1.0 / (samples + 1e-8)
    elif depth_param != "metric":
        raise ValueError(f"unknown depth parametrization {depth_param}")
    return samples


def sample_depth_from_pdf(draws, weights: torch.Tensor, n_samples_coarse: int,
                          n_samples_fine: int, depth_range: torch.Tensor,
                          det: bool) -> torch.Tensor:
    """Inverse-CDF resampling of the coarse weight histogram, (B,R,Sf,1).

    weights (B,R,S). Bins are linear in [depth_min, depth_max]. The bin
    search is the JAX package's broadcast compare, including its fallback
    where u >= cdf[-1] (a clipped gather returns cdf[-1]).
    """
    depth_min, depth_max = depth_range[0], depth_range[1]
    pdf = weights / (torch.sum(weights, dim=-1, keepdim=True) + 1e-6)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (B,R,S+1)
    if det or draws is None:
        grid = torch.linspace(0.0, 1.0, n_samples_fine + 1, device=weights.device)
    else:
        grid = draws.uniform((n_samples_fine + 1,))
    unif = 0.5 * (grid[:-1] + grid[1:])
    unif = unif.expand(*cdf.shape[:-1], n_samples_fine)

    le = cdf[..., None, :] <= unif[..., :, None]                       # (B,R,Nf,S+1)
    idx = torch.sum(le, dim=-1)                                         # #{cdf <= u}
    cdf_b = cdf[..., None, :].expand(le.shape)
    cdf_low = torch.amax(torch.where(le, cdf_b, torch.full_like(cdf_b, -1.0)), dim=-1)
    cdf_high = torch.amin(torch.where(le, torch.full_like(cdf_b, float("inf")), cdf_b), dim=-1)
    cdf_high = torch.where(torch.isfinite(cdf_high), cdf_high, cdf[..., -1:])

    delta = (depth_max - depth_min) / n_samples_coarse
    idx_low = torch.clamp(idx - 1, 0, n_samples_coarse)
    idx_high = torch.clamp(idx, max=n_samples_coarse)
    depth_low = depth_min + idx_low.to(torch.float32) * delta
    depth_high = depth_min + idx_high.to(torch.float32) * delta
    t = (unif - cdf_low) / (cdf_high - cdf_low + 1e-8)
    return (depth_low + t * (depth_high - depth_low))[..., None]


def sample_depth_diff_max_range_per_ray(batch_size: int, num_rays: int, n_samples: int,
                                        depth_min: torch.Tensor, depth_max: torch.Tensor
                                        ) -> torch.Tensor:
    """Deterministic samples up to a per-ray max depth; depth_max (B,R) -> (B,R,S,1)."""
    rand = 1.0 + torch.arange(n_samples, dtype=torch.float32, device=depth_max.device)
    rand = rand[None, None, :, None].expand(batch_size, num_rays, n_samples, 1)
    return rand / n_samples * (depth_max[..., None, None] - depth_min) + depth_min


# ---------------------------------------------------------------------------
# MLP dispatch and rendering
# ---------------------------------------------------------------------------

def mlp_apply(cfg: RenderConfig):
    """The MLP that cfg.mlp_impl names, with nerf_mlp.nerf_apply's signature."""
    if cfg.mlp_impl == "fused":
        return fused_mlp.nerf_apply_fused
    if cfg.mlp_impl == "plain":
        return nerf_mlp.nerf_apply
    raise ValueError(f"unknown mlp_impl {cfg.mlp_impl!r}")


def forward_samples(params: Dict[str, Any], cfg: RenderConfig, center: torch.Tensor,
                    ray: torch.Tensor, depth_samples: torch.Tensor, progress: float,
                    density_noise: Optional[torch.Tensor] = None,
                    mlp_cfg: Optional[MLPConfig] = None) -> Dict[str, torch.Tensor]:
    """Points from depths -> MLP."""
    pts = camera.get_3d_points_from_depth(center, ray, depth_samples, multi_samples=True)
    return mlp_apply(cfg)(params, mlp_cfg or cfg.mlp, pts, ray, progress, density_noise)


def _composite(cfg: RenderConfig, ray, pred, depth_samples):
    out = nerf_mlp.composite(ray, pred["rgb_samples"], pred["density_samples"], depth_samples,
                             cfg.setbg_opaque)
    out["t"] = depth_samples
    return out


def render_rays(params: Dict[str, Any], cfg: RenderConfig, center: torch.Tensor,
                ray: torch.Tensor, depth_range: torch.Tensor, progress: float, draws=None,
                stratified: bool = True, fine_enabled: bool = False,
                n_rays: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Render a (B,R) tile of rays; params {'coarse': tree [, 'fine': tree]}.

    draws=None renders deterministically (midpoint and det fine samples).
    `n_rays`: see RayBundle.
    """
    B, R = ray.shape[0], ray.shape[1]
    with tracing.span("render.coarse"):
        depth_samples = sample_depth(draws, B, R, cfg.sample_intvs, depth_range,
                                     cfg.depth_param,
                                     stratified=cfg.sample_stratified and stratified,
                                     n_rays=n_rays)
        noise = None
        if draws is not None and stratified and cfg.mlp.density_noise_reg:
            noise = mesh_mod.rank_draws(draws).normal((B, R, cfg.sample_intvs))
        pred = forward_samples(params["coarse"], cfg, center, ray, depth_samples, progress,
                               density_noise=noise)
    with tracing.span("render.composite"):
        out = _composite(cfg, ray, pred, depth_samples)
    out["origins"] = center
    out["viewdirs"] = ray

    if cfg.fine_sampling and fine_enabled:
        with tracing.span("render.fine"):
            det = not (cfg.sample_stratified and stratified)
            depth_fine = sample_depth_from_pdf(draws, out["weights"][..., 0].detach(),
                                               cfg.sample_intvs, cfg.sample_intvs_fine,
                                               depth_range, det=det)
            # the merged depths carry no gradient (coarse depths are random draws,
            # fine depths resample detached weights)
            depth_all = torch.sort(torch.cat([depth_samples, depth_fine], dim=2), dim=2).values
            depth_all = depth_all.detach()
            pred_f = forward_samples(params["fine"], cfg, center, ray, depth_all, progress,
                                     mlp_cfg=cfg.fine_mlp)
        with tracing.span("render.composite"):
            out.update({k + "_fine": v
                        for k, v in _composite(cfg, ray, pred_f, depth_all).items()})
    return out


def _geometry(cfg: RenderConfig, pose_w2c, intr, pixels):
    center, ray = camera.get_center_and_ray_at_pixels(pose_w2c, pixels, intr)
    if cfg.ndc:
        center, ray = camera.convert_NDC(center, ray, intr)
    return center, ray


def render_at_pixels(params: Dict[str, Any], cfg: RenderConfig, pose_w2c: torch.Tensor,
                     intr: torch.Tensor, pixels: torch.Tensor, depth_range: torch.Tensor,
                     progress: float, draws=None, stratified: bool = True,
                     fine_enabled: bool = False, n_rays: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Render at explicit pixel coords: pose_w2c (B,3,4), intr (B,3,3), pixels (N,2) or (B,N,2)."""
    center, ray = _geometry(cfg, pose_w2c, intr, pixels)
    return render_rays(params, cfg, center, ray, depth_range, progress, draws, stratified,
                       fine_enabled, n_rays)


def render_image_chunked(params: Dict[str, Any], cfg: RenderConfig, pose_w2c: torch.Tensor,
                         intr: torch.Tensor, H: int, W: int, depth_range: torch.Tensor,
                         progress: float, fine_enabled: bool = False,
                         chunk: Optional[int] = None,
                         mesh: Optional[mesh_mod.Mesh] = None) -> Dict[str, torch.Tensor]:
    """Full-image deterministic render, `chunk` rays at a time, no gradients.

    H*W is padded up to a multiple of `chunk` with pixel (0, 0) and the result
    cropped back, as the JAX package does. Returns rgb, depth, ... of shape
    (B, H*W, k), all_cumulated (B, H*W), and their _fine twins when the fine
    network runs. With a `mesh` of several ranks (every rank calls this
    together), each rank renders its share of every chunk, padded to a
    multiple of the world size with trailing copies, and the shares are
    gathered.
    """
    chunk = chunk or cfg.rand_rays
    HW = H * W
    n_chunks = -(-HW // chunk)
    pixels = camera.get_pixel_grid(H, W, pose_w2c.device)
    pixels = torch.cat([pixels, pixels.new_zeros((n_chunks * chunk - HW, 2))], dim=0)
    keep = ["rgb", "rgb_var", "depth", "depth_var", "opacity", "all_cumulated"]
    if cfg.fine_sampling and fine_enabled:
        keep += [k + "_fine" for k in keep]
    parts: Dict[str, list] = {}
    with torch.no_grad():
        for c in range(n_chunks):
            with tracing.span("render.chunk"):
                px = mesh_mod.shard_padded(pixels[c * chunk: (c + 1) * chunk], mesh)
                out = render_at_pixels(params, cfg, pose_w2c, intr, px, depth_range, progress,
                                       draws=None, stratified=False, fine_enabled=fine_enabled)
                for k in keep:
                    if k in out:
                        parts.setdefault(k, []).append(
                            mesh_mod.gather_rays(out[k], mesh, chunk, axis=1))
    return {k: torch.cat(v, dim=1)[:, :HW] for k, v in parts.items()}


def render_to_max(params: Dict[str, Any], cfg: RenderConfig, pose_w2c: torch.Tensor,
                  intr: torch.Tensor, pixels: torch.Tensor, depth_min: torch.Tensor,
                  depth_max: torch.Tensor, progress: float, fine_enabled: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """Render rays only up to a per-ray max depth (B,N); `all_cumulated` is the
    probability that a ray reaches depth_max unoccluded. Metric depth only."""
    center, ray = _geometry(cfg, pose_w2c, intr, pixels)
    B, R = ray.shape[0], ray.shape[1]
    out_all: Dict[str, torch.Tensor] = {"origins": center, "viewdirs": ray}
    with tracing.span("render.coarse"):
        depth_samples = sample_depth_diff_max_range_per_ray(B, R, cfg.sample_intvs, depth_min,
                                                            depth_max)
        pred = forward_samples(params["coarse"], cfg, center, ray, depth_samples, progress)
    with tracing.span("render.composite"):
        out_all.update(_composite(cfg, ray, pred, depth_samples))
    if cfg.fine_sampling and fine_enabled:
        # the same samples through the fine MLP
        with tracing.span("render.fine"):
            pred_f = forward_samples(params["fine"], cfg, center, ray, depth_samples, progress,
                                     mlp_cfg=cfg.fine_mlp)
        with tracing.span("render.composite"):
            out_all.update({k + "_fine": v
                            for k, v in _composite(cfg, ray, pred_f, depth_samples).items()})
    return out_all


def init_graph_params(gen: torch.Generator, cfg: RenderConfig, device=None) -> Dict[str, Any]:
    """{'coarse': mlp tree [, 'fine': mlp tree]}."""
    params = {"coarse": nerf_mlp.init_nerf_params(gen, cfg.mlp, device)}
    if cfg.fine_sampling:
        params["fine"] = nerf_mlp.init_nerf_params(gen, cfg.fine_mlp, device)
    return params


@dataclass
class RayBundle:
    """One render request of a training step.

    kind='pixels' is render_at_pixels, kind='tomax' is render_to_max.
    `no_grad` renders under torch.no_grad() (the visibility pass of the
    depth-consistency loss), so only the forward kernel runs.
    """

    pixels: torch.Tensor                      # (N,2) or (B,N,2)
    pose_w2c: torch.Tensor                    # (B,3,4)
    intr: torch.Tensor                        # (B,3,3)
    stratified: bool = True
    kind: str = "pixels"
    depth_min: Optional[torch.Tensor] = None  # tomax: scalar near plane
    depth_max: Optional[torch.Tensor] = None  # tomax: (B,N)
    no_grad: bool = False
    # the step's ray count along N, of which the pixels are this rank's
    # share under ray sharding (the stratified draws are taken at that count)
    n_rays: Optional[int] = None


def _grad_mode(b: RayBundle):
    return torch.no_grad() if b.no_grad else torch.enable_grad()


def _coarse_depths(cfg: RenderConfig, b: RayBundle, center, draws, depth_range):
    B, R = center.shape[0], center.shape[1]
    if b.kind == "tomax":
        return sample_depth_diff_max_range_per_ray(B, R, cfg.sample_intvs, b.depth_min,
                                                   b.depth_max)
    return sample_depth(draws, B, R, cfg.sample_intvs, depth_range, cfg.depth_param,
                        stratified=cfg.sample_stratified and b.stratified, n_rays=b.n_rays)


def _merged_mlp_level(params_level, cfg: RenderConfig, mlp_cfg: MLPConfig, bundles, geoms,
                      depths, progress: float) -> list:
    """One MLP call per gradient group over the concatenation of its bundles'
    sample points (as a (1, T, 1) batch), split back per bundle: the gradient
    group through K1 (and K2 in the backward), the no-grad group under
    torch.no_grad(), so through K3 alone."""
    preds = [None] * len(bundles)
    for no_grad in (False, True):
        idxs = [i for i, b in enumerate(bundles) if b.no_grad == no_grad]
        if not idxs:
            continue
        with torch.no_grad() if no_grad else torch.enable_grad():
            pts, dirs, shapes = [], [], []
            for i in idxs:
                (center, ray), d = geoms[i], depths[i]
                B, R, S = d.shape[:3]
                p = camera.get_3d_points_from_depth(center, ray, d, multi_samples=True)
                pts.append(p.reshape(1, B * R * S, 1, 3))
                dirs.append(ray[..., None, :].expand(B, R, S, 3).reshape(1, B * R * S, 3))
                shapes.append((B, R, S))
            out = mlp_apply(cfg)(params_level, mlp_cfg, torch.cat(pts, dim=1),
                                 torch.cat(dirs, dim=1), progress)
            sizes = [B * R * S for B, R, S in shapes]
            rgb = out["rgb_samples"].reshape(-1, 3).split(sizes)
            density = out["density_samples"].reshape(-1).split(sizes)
            for i, (B, R, S), c, s in zip(idxs, shapes, rgb, density):
                preds[i] = dict(rgb_samples=c.reshape(B, R, S, 3),
                                density_samples=s.reshape(B, R, S))
    return preds


@tracing.traced("render.bundles")
def render_bundles(params: Dict[str, Any], cfg: RenderConfig, bundles: list,
                   depth_range: torch.Tensor, progress: float, draws=None,
                   fine_enabled: bool = False, merge: bool = True) -> list:
    """Render a list of RayBundles; one output dict per bundle, with the
    render_at_pixels / render_to_max keys.

    merge=True evaluates every bundle with one MLP call per hierarchy level
    and gradient group (one K1/K2 pair for the bundles that carry a
    gradient, one K3 for the no-grad ones), then splits and composites per
    bundle. The MLP is pointwise over samples, so the outputs are those of
    the per-bundle calls; the draws are taken in the JAX package's merged
    order: every bundle's coarse draws, then every bundle's fine draws.
    Density noise is not drawn here (the trainer keeps the per-bundle path
    for density-noise training, as the JAX package does).

    merge=False renders one bundle at a time (coarse and fine draws of a
    bundle together)."""
    if not merge:
        outs = []
        for b in bundles:
            with _grad_mode(b):
                if b.kind == "tomax":
                    outs.append(render_to_max(params, cfg, b.pose_w2c, b.intr, b.pixels,
                                              b.depth_min, b.depth_max, progress,
                                              fine_enabled=fine_enabled))
                else:
                    outs.append(render_at_pixels(params, cfg, b.pose_w2c, b.intr, b.pixels,
                                                 depth_range, progress, draws=draws,
                                                 stratified=b.stratified,
                                                 fine_enabled=fine_enabled, n_rays=b.n_rays))
        return outs

    geoms, depths = [], []
    with tracing.span("render.coarse"):
        for b in bundles:
            with _grad_mode(b):
                center, ray = _geometry(cfg, b.pose_w2c, b.intr, b.pixels)
                geoms.append((center, ray))
                depths.append(_coarse_depths(cfg, b, center, draws, depth_range))
        preds = _merged_mlp_level(params["coarse"], cfg, cfg.mlp, bundles, geoms, depths,
                                  progress)
    outs = []
    with tracing.span("render.composite"):
        for b, (center, ray), d, pred in zip(bundles, geoms, depths, preds):
            with _grad_mode(b):
                out = _composite(cfg, ray, pred, d)
            out["origins"] = center
            out["viewdirs"] = ray
            outs.append(out)

    if cfg.fine_sampling and fine_enabled:
        depths_f = []
        with tracing.span("render.fine"):
            for b, d, out in zip(bundles, depths, outs):
                if b.kind == "tomax":
                    depths_f.append(d)  # the same samples through the fine MLP
                    continue
                det = not (cfg.sample_stratified and b.stratified)
                depth_fine = sample_depth_from_pdf(draws, out["weights"][..., 0].detach(),
                                                   cfg.sample_intvs, cfg.sample_intvs_fine,
                                                   depth_range, det=det)
                depths_f.append(torch.sort(torch.cat([d, depth_fine], dim=2),
                                           dim=2).values.detach())
            preds_f = _merged_mlp_level(params["fine"], cfg, cfg.fine_mlp, bundles, geoms,
                                        depths_f, progress)
        with tracing.span("render.composite"):
            for b, (center, ray), d, pred, out in zip(bundles, geoms, depths_f, preds_f, outs):
                with _grad_mode(b):
                    out.update({k + "_fine": v
                                for k, v in _composite(cfg, ray, pred, d).items()})
    return outs
