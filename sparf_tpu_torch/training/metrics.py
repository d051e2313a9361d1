"""Quality metrics: PSNR, SSIM, LPIPS, depth errors, masked metrics (torch
port of sparf_tpu/training/metrics.py).

SSIM is pytorch_ssim's: an 11x11 Gaussian window with sigma 1.5, zero "same"
padding, C1 = 0.01^2, C2 = 0.03^2. Its E[x^2] - E[x]^2 variances cancel
catastrophically in reduced precision (on a TPU the bf16 default pushed SSIM
to 1.42-1.58), and cuDNN runs float32 convolutions in TF32 by default, so
every convolution here runs inside `utils.precision.ieee_fp32()`, whatever
the global setting.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparf_tpu_torch.utils.precision import ieee_fp32


# ---------------------------------------------------------------------------
# PSNR / mse
# ---------------------------------------------------------------------------


def mse(pred: torch.Tensor, label: torch.Tensor, mask: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    d = (pred - label) ** 2
    if mask is not None:
        m = mask.to(d.dtype).expand(d.shape)
        return torch.sum(d * m) / (torch.sum(m) + 1e-9)
    return torch.mean(d)


def psnr(pred: torch.Tensor, label: torch.Tensor, mask: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    return -10.0 * torch.log10(mse(pred, label, mask) + 1e-12)


def compute_mse_on_rays(image_at_rays: torch.Tensor, output_dict: Dict[str, torch.Tensor]):
    """MSE between rendered rays and GT pixels; returns (coarse, fine-or-None)."""
    B = image_at_rays.shape[0]
    m_coarse = mse(output_dict["rgb"].reshape(B, -1, 3), image_at_rays)
    m_fine = None
    if "rgb_fine" in output_dict:
        m_fine = mse(output_dict["rgb_fine"].reshape(B, -1, 3), image_at_rays)
    return m_coarse, m_fine


# ---------------------------------------------------------------------------
# SSIM
# ---------------------------------------------------------------------------


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.array([math.exp(-((x - window_size // 2) ** 2) / (2 * sigma**2))
                  for x in range(window_size)])
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_conv(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """img (B,C,H,W), window (k,k); per-channel "same" convolution."""
    C, k = img.shape[1], window.shape[-1]
    with ieee_fp32():
        return F.conv2d(img, window.expand(C, 1, k, k), padding=k // 2, groups=C)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM on (B,C,H,W) images in [0,1]."""
    window = torch.as_tensor(_gaussian_window(window_size), device=img1.device)
    mu1 = _depthwise_conv(img1, window)
    mu2 = _depthwise_conv(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _depthwise_conv(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_conv(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_conv(img1 * img2, window) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return torch.mean(ssim_map)
    return torch.mean(ssim_map, dim=(1, 2, 3))


# ---------------------------------------------------------------------------
# depth errors
# ---------------------------------------------------------------------------


def compute_depth_error_on_rays(depth_gt_at_rays: torch.Tensor, valid_at_rays: torch.Tensor,
                                pred_depth: torch.Tensor,
                                scaling_factor_for_pred_depth: float = 1.0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked abs/rmse depth error at rays. Shapes (B,N,1)/(B,N)/(B,N,1)."""
    valid = valid_at_rays.reshape(-1).to(torch.float32)
    gt = depth_gt_at_rays.reshape(-1)
    pred = pred_depth.reshape(-1) * scaling_factor_for_pred_depth
    abs_e = torch.sum(torch.abs(gt - pred) * valid) / (torch.sum(valid) + 1e-6)
    rmse = torch.sqrt(torch.sum((gt - pred) ** 2 * valid) / (torch.sum(valid) + 1e-6))
    return abs_e, rmse


def compute_depth_error(depth_gt: torch.Tensor, valid_depth_gt: torch.Tensor,
                        pred_depth: torch.Tensor, scaling_factor_for_pred_depth: float = 1.0
                        ) -> Tuple[float, float]:
    """Full-image depth error; the min over {scaled, unscaled} when a sim3
    scale ambiguity exists. Host floats."""

    def metric(scale):
        a, r = compute_depth_error_on_rays(depth_gt, valid_depth_gt, pred_depth, scale)
        return float(a), float(r)

    if scaling_factor_for_pred_depth != 1.0:
        a0, r0 = metric(1.0)
        a1, r1 = metric(scaling_factor_for_pred_depth)
        return min(a0, a1), min(r0, r1)
    return metric(1.0)


# ---------------------------------------------------------------------------
# full metric bundles
# ---------------------------------------------------------------------------


def compute_metrics_masked(fg_mask: torch.Tensor, pred_rgb_map: torch.Tensor,
                           gt_rgb_map: torch.Tensor, lpips_fn: Optional[Callable] = None,
                           suffix: str = "") -> Dict[str, float]:
    """Composite the foreground onto white, then PSNR (in the mask), SSIM, LPIPS."""
    mask_float = fg_mask.to(torch.float32)
    if mask_float.ndim == 3:
        mask_float = mask_float[:, None]
    mask = mask_float == 1.0
    rgb_fg = pred_rgb_map * mask_float + (1.0 - mask_float)
    gt_fg = gt_rgb_map * mask_float + (1.0 - mask_float)
    out = {"psnr_masked" + suffix: float(psnr(rgb_fg, gt_fg, mask)),
           "ssim_masked" + suffix: float(ssim(rgb_fg, gt_fg))}
    if lpips_fn is not None:
        out["lpips_masked" + suffix] = float(lpips_fn(rgb_fg * 2 - 1, gt_fg * 2 - 1))
    return out


def compute_metrics(pred_rgb_map: torch.Tensor, gt_rgb_map: torch.Tensor,
                    pred_depth: Optional[torch.Tensor] = None,
                    depth_gt: Optional[torch.Tensor] = None,
                    valid_depth_gt: Optional[torch.Tensor] = None,
                    fg_mask: Optional[torch.Tensor] = None, lpips_fn: Optional[Callable] = None,
                    scaling_factor_for_pred_depth: float = 1.0, suffix: str = ""
                    ) -> Dict[str, float]:
    """Full-image PSNR/SSIM/LPIPS [+ depth errors + masked variants]."""
    results = {"psnr" + suffix: float(psnr(pred_rgb_map, gt_rgb_map)),
               "ssim" + suffix: float(ssim(pred_rgb_map, gt_rgb_map))}
    if lpips_fn is not None:
        results["lpips" + suffix] = float(lpips_fn(pred_rgb_map * 2 - 1, gt_rgb_map * 2 - 1))
    if depth_gt is not None and pred_depth is not None:
        abs_e, rmse = compute_depth_error(depth_gt, valid_depth_gt, pred_depth,
                                          scaling_factor_for_pred_depth)
        results["abse_depth" + suffix] = abs_e
        results["rmse_depth" + suffix] = rmse
    else:
        results["abse_depth" + suffix] = float("nan")
        results["rmse_depth" + suffix] = float("nan")
    if fg_mask is not None:
        results.update(compute_metrics_masked(fg_mask, pred_rgb_map, gt_rgb_map, lpips_fn,
                                              suffix))
    return results
