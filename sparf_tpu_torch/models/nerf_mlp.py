"""NeRF MLP as explicit (W, b) tensor lists (torch port of
sparf_tpu/models/nerf_mlp.py).

  - feature trunk [in, 256 x 8] with the input concatenated at the skip
    layers; the last trunk layer emits 256+1 units, unit 0 is raw density;
  - RGB head [feat (+ view encoding), 128, 3] with a sigmoid output;
  - TF-style Xavier-uniform init (ReLU gain sqrt(2) except the last RGB layer
    and the density row, gain 1);
  - BARF coarse-to-fine masking of both encodings.

Parameters are ``{'feat': [(W, b)], 'rgb': [(W, b)]}`` with W in (out, in)
layout, as torch.nn.Linear keeps it. The eager `nerf_apply` is the plain
version of the fused kernels in sparf_tpu_torch/ops/fused_mlp.py.
`compute_dtype` (cfg.tpu.compute_dtype) is the dtype of the MLP's products:
float32, or bfloat16 operands with float32 sums (`linear`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from sparf_tpu_torch.models import embedder


@dataclass(frozen=True)
class MLPConfig:
    """Static architecture spec."""

    layers_feat: Tuple[int, ...] = (256, 256, 256, 256, 256, 256, 256, 256)
    layers_rgb: Tuple[int, ...] = (128, 3)
    skip: Tuple[int, ...] = (4,)
    L_3D: int = 10
    L_view: int = 4
    add_raw_3D_points: bool = True
    add_raw_rays: bool = True
    include_pi: bool = True
    log_sampling: bool = True
    view_dep: bool = True
    density_activ: str = "softplus"
    tf_init: bool = True
    barf_c2f: Optional[Tuple[float, float]] = None
    density_noise_reg: Optional[float] = None
    compute_dtype: Any = torch.float32

    @property
    def input_3d_dim(self) -> int:
        dim = 3 if self.add_raw_3D_points else 0
        dim += 6 * self.L_3D if self.L_3D > 0 else 0
        if dim <= 0:
            raise ValueError("empty 3D input encoding")
        return dim

    @property
    def input_view_dim(self) -> int:
        if not self.view_dep:
            return 0
        dim = 3 if self.add_raw_rays else 0
        dim += 6 * self.L_view if self.L_view > 0 else 0
        if dim <= 0:
            raise ValueError("empty view encoding")
        return dim

    @classmethod
    def from_config(cls, cfg) -> "MLPConfig":
        """Build from the ConfigDict tree (arch/nerf sections)."""
        arch, nerf = cfg.arch, cfg.nerf
        pe = arch.posenc
        return cls(
            layers_feat=tuple(arch.layers_feat[1:]),
            layers_rgb=tuple(arch.layers_rgb[1:]),
            skip=tuple(arch.skip),
            L_3D=pe.L_3D,
            L_view=pe.L_view,
            add_raw_3D_points=pe.add_raw_3D_points,
            add_raw_rays=pe.add_raw_rays,
            include_pi=pe.include_pi_in_posenc,
            log_sampling=pe.log_sampling,
            view_dep=nerf.view_dep,
            density_activ=arch.density_activ,
            tf_init=arch.tf_init,
            barf_c2f=tuple(cfg.barf_c2f) if cfg.get("barf_c2f") else None,
            density_noise_reg=nerf.density_noise_reg if nerf.density_noise_reg else None,
            compute_dtype=(torch.bfloat16 if cfg.tpu.compute_dtype == "bfloat16"
                           else torch.float32),
        )


def _xavier_uniform(gen: torch.Generator, shape, gain: float, device) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ semantics on an (out, in) weight."""
    fan_out, fan_in = shape
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u * (2 * a) - a


def layer_dims(cfg: MLPConfig) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """(out, in) of every trunk layer and every RGB layer."""
    feat, k_in = [], cfg.input_3d_dim
    n = len(cfg.layers_feat)
    for li, k_out in enumerate(cfg.layers_feat):
        if li in cfg.skip:
            k_in += cfg.input_3d_dim
        feat.append((k_out + 1 if li == n - 1 else k_out, k_in))
        k_in = cfg.layers_feat[li]
    rgb, k_in = [], cfg.layers_feat[-1] + cfg.input_view_dim
    for k_out in cfg.layers_rgb:
        rgb.append((k_out, k_in))
        k_in = k_out
    return feat, rgb


def init_nerf_params(gen: torch.Generator, cfg: MLPConfig,
                     device=None) -> Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Parameter tree {'feat': [(W,b)..], 'rgb': [(W,b)..]}; W is (out,in)."""
    relu_gain = math.sqrt(2.0)
    feat_dims, rgb_dims = layer_dims(cfg)
    n = len(feat_dims)
    feat_layers = []
    for li, (k_out, k_in) in enumerate(feat_dims):
        if cfg.tf_init and li == n - 1:
            # density row gain 1, feature rows relu gain
            w_density = _xavier_uniform(gen, (1, k_in), 1.0, device)
            w_feat = _xavier_uniform(gen, (k_out - 1, k_in), relu_gain, device)
            W = torch.cat([w_density, w_feat], dim=0)
        else:
            W = _xavier_uniform(gen, (k_out, k_in), relu_gain if cfg.tf_init else 1.0, device)
        feat_layers.append((W, torch.zeros(k_out, device=device)))
    rgb_layers = []
    m = len(rgb_dims)
    for li, (k_out, k_in) in enumerate(rgb_dims):
        gain = 1.0 if (li == m - 1 or not cfg.tf_init) else relu_gain
        rgb_layers.append((_xavier_uniform(gen, (k_out, k_in), gain, device),
                           torch.zeros(k_out, device=device)))
    return {"feat": feat_layers, "rgb": rgb_layers}


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` (to nearest even) and held in float32; x itself
    for float32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def linear(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x W^T + b with the product in `dtype`: float32, or both operands
    rounded to bf16 and summed in float32 (a bf16 x bf16 product is exact in
    float32), as sparf_tpu's _linear / the Pallas kernels' dots."""
    if dtype == torch.float32:
        return torch.addmm(b, x, W.t())
    return round_to(x, dtype) @ round_to(W, dtype).t() + b


def density_activation(raw: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "softplus":
        return F.softplus(raw)
    if kind == "relu":
        return F.relu(raw)
    if kind == "abs":
        return torch.abs(raw)
    if kind == "sigmoid":
        return torch.sigmoid(raw)
    if kind == "exp":
        return torch.exp(raw)
    raise ValueError(f"unknown density activation {kind}")


def encode_points(cfg: MLPConfig, pts: torch.Tensor, progress: float) -> torch.Tensor:
    """PE (+c2f mask) + optional raw concat for 3D points. (...,3)->(...,in3d)."""
    if cfg.L_3D <= 0:
        return pts
    enc = embedder.positional_encoding(pts, cfg.L_3D, cfg.include_pi, cfg.log_sampling)
    enc = embedder.apply_c2f_mask(
        enc, embedder.c2f_weights(progress, cfg.L_3D, cfg.barf_c2f, device=pts.device))
    return torch.cat([pts, enc], dim=-1) if cfg.add_raw_3D_points else enc


def encode_views(cfg: MLPConfig, ray_unit: torch.Tensor, progress: float) -> torch.Tensor:
    if cfg.L_view <= 0:
        return ray_unit
    enc = embedder.positional_encoding(ray_unit, cfg.L_view, cfg.include_pi, cfg.log_sampling)
    enc = embedder.apply_c2f_mask(
        enc, embedder.c2f_weights(progress, cfg.L_view, cfg.barf_c2f, device=ray_unit.device))
    return torch.cat([ray_unit, enc], dim=-1) if cfg.add_raw_rays else enc


def unit_rays(ray: torch.Tensor) -> torch.Tensor:
    return ray / (torch.linalg.norm(ray, dim=-1, keepdim=True) + 1e-12)


def nerf_apply(params: Dict[str, Any], cfg: MLPConfig, pts: torch.Tensor, ray: torch.Tensor,
               progress: float, density_noise: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """MLP prediction at sample points, eager.

    pts (B,R,S,3) world points; ray (B,R,3) unnormalized directions;
    density_noise: standard-normal draws (B,R,S) for the train-time density
    noise, or None. Returns rgb_samples (B,R,S,3), density_samples (B,R,S).
    """
    batch_shape = pts.shape[:-1]
    pts_enc = encode_points(cfg, pts, progress).reshape(-1, cfg.input_3d_dim)
    feat = pts_enc
    n = len(params["feat"])
    raw_density = None
    for li, (W, b) in enumerate(params["feat"]):
        if li in cfg.skip:
            feat = torch.cat([feat, pts_enc], dim=-1)
        feat = linear(feat, W, b, cfg.compute_dtype)
        if li == n - 1:
            raw_density = feat[:, 0]
            feat = feat[:, 1:]
        feat = F.relu(feat)
    raw_density = raw_density.reshape(batch_shape)
    if density_noise is not None and cfg.density_noise_reg:
        raw_density = raw_density + density_noise * cfg.density_noise_reg
    density = density_activation(raw_density, cfg.density_activ)
    if cfg.view_dep:
        ray_enc = encode_views(cfg, unit_rays(ray), progress)
        ray_enc = ray_enc[..., None, :].expand(*batch_shape, ray_enc.shape[-1])
        feat = torch.cat([feat, ray_enc.reshape(feat.shape[0], -1)], dim=-1)
    m = len(params["rgb"])
    for li, (W, b) in enumerate(params["rgb"]):
        feat = linear(feat, W, b, cfg.compute_dtype)
        if li != m - 1:
            feat = F.relu(feat)
    rgb = torch.sigmoid(feat).reshape(*batch_shape, 3)
    return dict(rgb_samples=rgb, density_samples=density)


def composite(ray: torch.Tensor, rgb_samples: torch.Tensor, density_samples: torch.Tensor,
              depth_samples: torch.Tensor, setbg_opaque: bool = False
              ) -> Dict[str, torch.Tensor]:
    """Volume compositing (same outputs as sparf_tpu.models.nerf_mlp.composite).

    ray (B,R,3); rgb_samples (B,R,S,3); density_samples (B,R,S);
    depth_samples (B,R,S,1). all_cumulated (B,R) is the transmittance before
    the last sample.
    """
    ray_length = torch.linalg.norm(ray, dim=-1, keepdim=True)  # (B,R,1)
    t = depth_samples[..., 0]
    intv = t[..., 1:] - t[..., :-1]
    intv = torch.cat([intv, torch.full_like(intv[..., :1], 1e10)], dim=-1)
    sigma_delta = density_samples * (intv * ray_length)
    alpha = 1 - torch.exp(-sigma_delta)
    shifted = torch.cat([torch.zeros_like(sigma_delta[..., :1]), sigma_delta[..., :-1]], dim=-1)
    T = torch.exp(-torch.cumsum(shifted, dim=-1))
    all_cumulated = T[..., -2]
    weights = (T * alpha)[..., None]
    depth = torch.sum(depth_samples * weights, dim=2)
    depth_var = torch.sum(weights * (depth_samples - depth[..., None, :]) ** 2, dim=2)
    rgb = torch.sum(rgb_samples * weights, dim=2)
    rgb_var = torch.sum(
        torch.sum(rgb_samples - rgb[..., None, :], dim=-1, keepdim=True) * weights, dim=2)
    opacity = torch.sum(weights, dim=2)
    if setbg_opaque:
        rgb = rgb + (1.0 - opacity)
    return dict(rgb=rgb, rgb_var=rgb_var, depth=depth, depth_var=depth_var, opacity=opacity,
                weights=weights, all_cumulated=all_cumulated)
