"""PDC-Net-style probabilistic dense correspondence network (torch port of
sparf_tpu/models/pdcnet_jax.py).

A feature pyramid (/2, /4, /8), a soft-argmax over the global correlation at
/8 (temperature 16), PWC-style warp + shifted-cost-volume refinement at /8,
/4 and /2, and a two-component Laplacian-mixture uncertainty head whose
P(err < 1 px) / 0.5730 is the confidence p_r. `PDCNet`'s parameters are
named like the keys of the JAX package's weight files (`feat0_down__0` is
feat0_down's W, `__1` its b), so the bundled `sparf_tpu/data/pdcnet_synth.npz`
and `pdcnet_synth_r5.npz` load as they are (read by path, as data).

Differences from the JAX module, none of which changes a result:
  - "SAME" padding is explicit per input size (a stride-2 convolution of an
    even size pads 0 before and 1 after, which `padding=1` would not);
  - `jax.image.resize(..., "bilinear")` is `utils.imgproc.resize_bilinear`;
  - every convolution and matmul (the net, the correlations, the resizes
    of flows, the warps, adaptation's forward and backward) runs with TF32
    off (`utils.precision.ieee_fp32`), whatever the global setting;
  - random draws (initialisation, `self_supervised_adapt`) come from torch
    generators or a `Draws` object, so they differ from JAX's PRNG unless a
    test injects the same numbers.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sparf_tpu_torch.utils import imgproc
from sparf_tpu_torch.utils.draws import Draws
from sparf_tpu_torch.utils.precision import ieee_fp32

FEAT_CHANNELS = (32, 64, 96)   # /2, /4, /8
LOCAL_RADIUS = 3

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "sparf_tpu", "data")
BUNDLED_WEIGHTS = os.path.normpath(os.path.join(_DATA, "pdcnet_synth.npz"))
BUNDLED_WEIGHTS_R5 = os.path.normpath(os.path.join(_DATA, "pdcnet_synth_r5.npz"))


def _layer_shapes() -> List[Tuple[str, int, int]]:
    """(name, c_in, c_out) of every 3x3 convolution, in the JAX init order."""
    shapes, c_prev = [], 3
    for li, c in enumerate(FEAT_CHANNELS):
        shapes += [(f"feat{li}_down", c_prev, c), (f"feat{li}_res", c, c)]
        c_prev = c
    n_corr = (2 * LOCAL_RADIUS + 1) ** 2
    for lev, c in ((8, FEAT_CHANNELS[2]), (4, FEAT_CHANNELS[1]), (2, FEAT_CHANNELS[0])):
        shapes += [(f"ref{lev}_dec0", n_corr + c + 2, 96), (f"ref{lev}_dec1", 96, 64),
                   (f"ref{lev}_flow", 64, 2)]
    shapes += [("unc_dec0", 64, 32), ("unc_out", 32, 3)]
    return shapes


def _same_pad(n: int, stride: int, k: int = 3) -> Tuple[int, int]:
    """XLA's "SAME" padding (before, after) of one dimension."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1) -> torch.Tensor:
    ph, pw = _same_pad(x.shape[-2], stride), _same_pad(x.shape[-1], stride)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, b, stride=stride)


def _l2norm(f: torch.Tensor) -> torch.Tensor:
    return f / (torch.linalg.norm(f, dim=1, keepdim=True) + 1e-6)


def global_correlation_mapping(f_t: torch.Tensor, f_s: torch.Tensor) -> torch.Tensor:
    """Soft-argmax (temperature 16) over the full correlation volume: f_*
    (B,C,h,w) -> mapping (B,2,h,w) in absolute source coordinates."""
    B, C, h, w = f_t.shape
    t = _l2norm(f_t).reshape(B, C, h * w)
    s = _l2norm(f_s).reshape(B, C, h * w)
    attn = torch.softmax(torch.einsum("bci,bcj->bij", t, s) * 16.0, dim=-1)
    xs = torch.arange(w, dtype=f_t.dtype, device=f_t.device)
    ys = torch.arange(h, dtype=f_t.dtype, device=f_t.device)
    map_x = attn @ xs.repeat(h)
    map_y = attn @ ys.repeat_interleave(w)
    return torch.stack([map_x, map_y], 1).reshape(B, 2, h, w)


def _bilinear_sample(f: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """f (B,C,h,w) sampled at absolute xy coords (B,2,h',w') -> (B,C,h',w'),
    coordinates clamped to the image."""
    B, C, h, w = f.shape
    ho, wo = coords.shape[-2:]
    x = torch.clamp(coords[:, 0], 0, w - 1)
    y = torch.clamp(coords[:, 1], 0, h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = (x - x0)[:, None]
    wy = (y - y0)[:, None]
    flat = f.reshape(B, C, h * w)

    def gather(yi, xi):
        idx = (yi * w + xi).to(torch.int64).reshape(B, 1, -1).expand(B, C, -1)
        return torch.gather(flat, 2, idx).reshape(B, C, ho, wo)

    return (gather(y0, x0) * (1 - wx) * (1 - wy) + gather(y0, x1) * wx * (1 - wy)
            + gather(y1, x0) * (1 - wx) * wy + gather(y1, x1) * wx * wy)


def shifted_correlation(f_t: torch.Tensor, f_s_warped: torch.Tensor,
                        radius: int = LOCAL_RADIUS) -> torch.Tensor:
    """PWC cost volume: f_t(x) . f_s_warped(x + d) over the (2r+1)^2 integer
    displacements d, zero outside -> (B,(2r+1)^2,h,w)."""
    h, w = f_t.shape[-2:]
    t = _l2norm(f_t)
    s_pad = F.pad(_l2norm(f_s_warped), (radius, radius, radius, radius))
    return torch.cat([torch.sum(t * s_pad[:, :, dy: dy + h, dx: dx + w], dim=1, keepdim=True)
                      for dy in range(2 * radius + 1) for dx in range(2 * radius + 1)], dim=1)


def _identity_grid(B: int, h: int, w: int, device) -> torch.Tensor:
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=device)[None, None, :, None]
    return torch.cat([xx.expand(B, 1, h, w), yy.expand(B, 1, h, w)], dim=1)


def p_r_from_mixture(alpha: torch.Tensor, var_s: torch.Tensor, var_l: torch.Tensor,
                     radius: float = 1.0) -> torch.Tensor:
    """P(|err| < radius) under a 2-component 2D-Laplacian mixture, / 0.5730
    and clipped to [0, 1] like PDC-Net's p_r."""

    def p_component(var):
        b = torch.sqrt(torch.clamp(var, min=1e-6) / 2.0)
        return (1 - torch.exp(-radius / b)) ** 2

    p = alpha * p_component(var_s) + (1 - alpha) * p_component(var_l)
    return torch.clamp(p / 0.5730, 0.0, 1.0)


class PDCNet(nn.Module):
    """The network; parameters `<layer>__0` (W, OIHW) and `<layer>__1` (b)."""

    def __init__(self, generator: Optional[torch.Generator] = None, device="cpu"):
        super().__init__()
        for name, c_in, c_out in _layer_shapes():
            w = torch.randn((c_out, c_in, 3, 3), generator=generator) * math.sqrt(2.0 / (c_in * 9))
            self.register_parameter(f"{name}__0", nn.Parameter(w))
            self.register_parameter(f"{name}__1", nn.Parameter(torch.zeros(c_out)))
        self.to(device)

    def _conv(self, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return _conv(x, getattr(self, f"{name}__0"), getattr(self, f"{name}__1"), stride)

    def extract_features(self, img: torch.Tensor) -> List[torch.Tensor]:
        """img (B,3,H,W) -> [(B,32,H/2,W/2), (B,64,H/4,W/4), (B,96,H/8,W/8)]."""
        feats, h = [], img
        for li in range(len(FEAT_CHANNELS)):
            h = F.relu(self._conv(f"feat{li}_down", h, stride=2))
            h = h + F.relu(self._conv(f"feat{li}_res", h))
            feats.append(h)
        return feats

    def _refine_level(self, lev: int, f_t: torch.Tensor, f_s: torch.Tensor,
                      mapping: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One warp + cost-volume refinement at pyramid level lev (8/4/2):
        (mapping, decoder features) at that level's resolution."""
        B, _, h, w = f_t.shape
        corr = shifted_correlation(f_t, _bilinear_sample(f_s, mapping))
        flow = mapping - _identity_grid(B, h, w, f_t.device)
        x = torch.cat([corr, f_t, flow], dim=1)
        x = F.relu(self._conv(f"ref{lev}_dec0", x))
        x = F.relu(self._conv(f"ref{lev}_dec1", x))
        return mapping + self._conv(f"ref{lev}_flow", x), x

    def forward(self, img_t: torch.Tensor, img_s: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Dense mapping target -> source and p_r at 1/2 resolution:
        {'mapping': (B,2,H/2,W/2) absolute source coords at /2, 'p_r',
        'alpha', 'log_var_s', 'log_var_l' (B,1,H/2,W/2), 'mapping8',
        'mapping4'}."""
        with ieee_fp32():
            ft, fs = self.extract_features(img_t), self.extract_features(img_s)
            mapping8 = global_correlation_mapping(ft[2], fs[2])
            mapping8, _ = self._refine_level(8, ft[2], fs[2], mapping8)
            mapping4 = imgproc.resize_bilinear(mapping8 * 2.0, ft[1].shape[-2:])
            mapping4, _ = self._refine_level(4, ft[1], fs[1], mapping4)
            mapping2 = imgproc.resize_bilinear(mapping4 * 2.0, ft[0].shape[-2:])
            mapping2, x2 = self._refine_level(2, ft[0], fs[0], mapping2)
            u = self._conv("unc_out", F.relu(self._conv("unc_dec0", x2)))
        log_var_s = torch.clamp(u[:, 0:1], -6.0, 4.0)
        log_var_l = torch.clamp(u[:, 1:2] + 2.0, -4.0, 8.0)
        alpha = torch.sigmoid(u[:, 2:3])
        p_r = p_r_from_mixture(alpha, torch.exp(log_var_s), torch.exp(log_var_l), radius=1.0)
        return dict(mapping=mapping2, p_r=p_r, alpha=alpha, log_var_s=log_var_s,
                    log_var_l=log_var_l, mapping8=mapping8, mapping4=mapping4)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def load_weights_npz(path: str, device="cpu") -> PDCNet:
    """A PDCNet holding the weights of a JAX-package npz (`<layer>__<i>` keys;
    keys without `__`, e.g. 'provenance', are metadata)."""
    model = PDCNet(generator=torch.Generator().manual_seed(0))
    with np.load(path) as data:
        state = {k: torch.as_tensor(np.array(data[k], np.float32)) for k in data.files if "__" in k}
    model.load_state_dict(state)
    return model.to(device)


def save_weights_npz(model: PDCNet, path: str) -> None:
    np.savez_compressed(path, **{k: v.detach().cpu().numpy() for k, v in model.state_dict().items()})


# ---------------------------------------------------------------------------
# self-supervised adaptation on synthetic warps
# ---------------------------------------------------------------------------


def _solve_corner_homography(src: np.ndarray, dst: torch.Tensor) -> torch.Tensor:
    """(B,4,2) destination corners -> (B,3,3) homographies taking src to dst."""
    rows_a, rows_b = [], []
    for k, (x, y) in enumerate(src):
        u, v = dst[:, k, 0], dst[:, k, 1]
        one, zero = torch.ones_like(u), torch.zeros_like(u)
        rows_a += [torch.stack([one * x, one * y, one, zero, zero, zero, -u * x, -u * y], -1),
                   torch.stack([zero, zero, zero, one * x, one * y, one, -v * x, -v * y], -1)]
        rows_b += [u, v]
    h = torch.linalg.solve(torch.stack(rows_a, 1), torch.stack(rows_b, 1))
    return torch.cat([h, torch.ones_like(h[:, :1])], 1).reshape(-1, 3, 3)


def _random_homography_batch(draws, B: int, H: int, W: int, max_shift: float = 0.25,
                             device="cpu") -> torch.Tensor:
    """Random perspective warps as target -> source mappings (B,2,H,W): each
    image corner moves by a uniform draw in +-max_shift of the image size."""
    u = draws.uniform((B, 4, 2)).to(device)
    disp = (u * (2 * max_shift) - max_shift) * torch.tensor([W, H], dtype=torch.float32,
                                                            device=device)
    src = np.array([[0, 0], [W - 1, 0], [W - 1, H - 1], [0, H - 1]], np.float32)
    Hs = _solve_corner_homography(src, torch.as_tensor(src, device=device)[None] + disp)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    grid = torch.stack([xx, yy, torch.ones_like(xx)], 0).reshape(3, -1)
    warped = torch.einsum("bij,jk->bik", Hs, grid)
    warped = warped[:, :2] / torch.clamp(warped[:, 2:], min=1e-6)
    return warped.reshape(B, 2, H, W)


def _uniform(draws, shape, lo: float, hi: float, device) -> torch.Tensor:
    return draws.uniform(shape).to(device) * (hi - lo) + lo


def adaptation_loss(model: PDCNet, imgs: torch.Tensor, draws, batch: int = 2) -> torch.Tensor:
    """One batch of self-supervised adaptation: random homography warps of
    the (N,3,H,W) images with photometric jitter; huber(mapping, gt) + 0.1 x
    the mixture's negative log-likelihood. Draws, in this order: image
    indices, corner shifts, per-channel gain, bias, pixel noise. Matmuls
    and convolutions run in full float32 (warps and flows are coordinates)."""
    device = imgs.device
    N, _, H, W = imgs.shape
    with ieee_fp32():
        tgt = imgs[draws.randint((batch,), 0, N).to(device)]
        map_full = _random_homography_batch(draws, batch, H, W, device=device)
        src = _bilinear_sample(tgt, map_full)
        gain = torch.exp(_uniform(draws, (batch, 3, 1, 1), -0.2, 0.2, device))
        bias = _uniform(draws, (batch, 1, 1, 1), -0.05, 0.05, device)
        noise = draws.normal(tuple(src.shape)).to(device)
        src = torch.clamp(src * gain + bias + 0.01 * noise, 0, 1)
        out = model(tgt, src)
        gt = imgproc.resize_bilinear(map_full / 2.0, out["mapping"].shape[-2:])
    abs_err = torch.linalg.norm(out["mapping"] - gt, dim=1, keepdim=True)
    huber = torch.where(abs_err < 1.0, 0.5 * abs_err ** 2, abs_err - 0.5)

    def nll(var):
        b = torch.sqrt(torch.clamp(var, min=1e-6) / 2)
        return abs_err / b + 2 * torch.log(b)

    m_nll = -torch.log(out["alpha"] * torch.exp(-nll(torch.exp(out["log_var_s"])))
                       + (1 - out["alpha"]) * torch.exp(-nll(torch.exp(out["log_var_l"])))
                       + 1e-9)
    return torch.mean(huber) + 0.1 * torch.mean(m_nll)


def adaptation_optimizer(model: PDCNet, lr: float = 1e-3) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def self_supervised_adapt(model: PDCNet, images, draws=None, n_steps: int = 500,
                          batch: int = 2, lr: float = 1e-3) -> PDCNet:
    """Train `model` in place for n_steps Adam steps of `adaptation_loss` on
    the scene's own images (N,3,H,W), with draws from `draws` (a `Draws`
    seeded 1 on the model's device when None)."""
    device = next(model.parameters()).device
    draws = draws if draws is not None else Draws(1, device)
    imgs = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    opt = adaptation_optimizer(model, lr)
    with ieee_fp32():  # the backward pass too
        for _ in range(n_steps):
            loss = adaptation_loss(model, imgs, draws, batch)
            opt.zero_grad()
            loss.backward()
            opt.step()
    return model


# ---------------------------------------------------------------------------
# inference over a pair list, with the pre-warp races
# ---------------------------------------------------------------------------


def compose_candidate_uncertainty(c1: torch.Tensor, alpha: torch.Tensor, var_s: torch.Tensor,
                                  var_l: torch.Tensor, Hm: torch.Tensor):
    """Compose a pre-warp candidate's mapping c1 (2,H,W) into the Hm-warped
    source canvas back to source coords; its mixture variances scale by
    |det J_Hm(c1)| = |det Hm| / w^3 and p_r is recomputed from them. Returns
    (cH (H,W,2), p_r (H,W), expected variance (H,W))."""
    from sparf_tpu_torch.models.flow_net import _apply_homography

    cH = _apply_homography(Hm, c1.permute(1, 2, 0))
    w = Hm[2, 0] * c1[0] + Hm[2, 1] * c1[1] + Hm[2, 2]
    det_j = torch.abs(torch.linalg.det(Hm)) / torch.clamp(torch.abs(w), min=1e-6) ** 3
    var_s, var_l = var_s * det_j, var_l * det_j
    evar = alpha * var_s + (1 - alpha) * var_l
    return cH, p_r_from_mixture(alpha, var_s, var_l), evar


def _scale_about_center_homography(f: float, H: int, W: int, device="cpu") -> torch.Tensor:
    """Zoom about the image centre by 1/f: a warped-canvas pixel u samples the
    original at c + f (u - c)."""
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    return torch.tensor([[f, 0.0, cx * (1.0 - f)], [0.0, f, cy * (1.0 - f)], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def compute_pdcnet_flow_of_combi_list(
    images: np.ndarray, combi_list: np.ndarray, model: Optional[PDCNet] = None,
    weights_path: Optional[str] = None, adapt_steps: int = 0, use_homography: bool = False,
    multiscale_factors: Optional[Sequence[float]] = None, device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Matcher-facade entry: (P,2,H,W) correspondences + (P,1,H,W) p_r.

    The net runs at the input resolution; its /2 mapping and mixture are
    resized to full size. multiscale_factors adds centre-zoom pre-warp
    candidates and use_homography a candidate against the source warped by a
    robust homography fit to the base matches; every candidate is composed
    back to source coords and raced per pixel by expected mixture variance
    (lower wins). Without `model` or `weights_path` a seeded random net is
    used, adapted for adapt_steps steps when > 0.
    """
    from sparf_tpu_torch.models import flow_net as fn

    device = torch.device(device)
    if model is None:
        if weights_path:
            model = load_weights_npz(weights_path, device)
        else:
            model = PDCNet(generator=torch.Generator().manual_seed(0), device=device)
            if adapt_steps > 0:
                self_supervised_adapt(model, images, Draws(1, device), n_steps=adapt_steps)
    imgs = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    _, _, H, W = imgs.shape

    def infer(t_img, s_img):
        out = model(t_img[None], s_img[None])
        mapping = imgproc.resize_bilinear(out["mapping"] * 2.0, (H, W))[0]
        p_r = imgproc.resize_bilinear(out["p_r"], (H, W))[0, 0]

        def rs(x):
            return imgproc.resize_bilinear(x, (H, W))[0, 0]

        alpha = rs(out["alpha"])
        var_s, var_l = rs(torch.exp(out["log_var_s"])), rs(torch.exp(out["log_var_l"]))
        return mapping, p_r, alpha * var_s + (1 - alpha) * var_l, (alpha, var_s, var_l)

    def race_prewarp(c0, p0, v0, img_t, img_s, Hm):
        c1, _, _, (a1, vs1, vl1) = infer(img_t, fn._warp_image_by_homography(img_s, Hm))
        cH, p1, v1 = compose_candidate_uncertainty(c1, a1, vs1, vl1, Hm)
        inb = (cH[..., 0] >= 0) & (cH[..., 0] <= W - 1) & (cH[..., 1] >= 0) & (cH[..., 1] <= H - 1)
        p1 = torch.where(inb, p1, torch.zeros_like(p1))
        v1 = torch.where(inb, v1, torch.full_like(v1, float("inf")))
        use1 = v1 < v0
        return (torch.where(use1[None], cH.permute(2, 0, 1), c0), torch.where(use1, p1, p0),
                torch.where(use1, v1, v0))

    scale_prewarps = [_scale_about_center_homography(float(f), H, W, device)
                      for f in (multiscale_factors or ()) if abs(float(f) - 1.0) > 1e-6]
    corres_out, conf_out = [], []
    with torch.no_grad(), ieee_fp32():
        for t, s in combi_list.T:
            t_img, s_img = imgs[int(t)], imgs[int(s)]
            c0, p0, v0, _ = infer(t_img, s_img)
            for Hm in scale_prewarps:
                c0, p0, v0 = race_prewarp(c0, p0, v0, t_img, s_img, Hm)
            if use_homography:
                Hm = fn._fit_homography_weighted(c0.permute(1, 2, 0),
                                                 torch.clamp(p0, min=0.0) ** 2)
                c0, p0, v0 = race_prewarp(c0, p0, v0, t_img, s_img, Hm)
            corres_out.append(c0.cpu().numpy())
            conf_out.append(p0.cpu().numpy()[None])
    return np.stack(corres_out).astype(np.float32), np.stack(conf_out).astype(np.float32)
