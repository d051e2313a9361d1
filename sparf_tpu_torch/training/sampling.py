"""Ray sampling (torch port of sparf_tpu/training/sampling.py).

Pixel pools (all pixels minus the patch border, the center box, the dilated
foreground mask) are built on the host once; each step draws i.i.d. indices
into them, as the JAX package does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sparf_tpu_torch.utils import imgproc


@dataclass
class RaySampler:
    """Static pools + sampling options. Build with `make_ray_sampler`."""

    H: int
    W: int
    nbr_images: int
    all_pixels: torch.Tensor             # (P,2) int64 xy
    center_pixels: torch.Tensor          # (Pc,2)
    mask_pixels: Optional[torch.Tensor]  # (B,Pm,2) padded per-image pools or None
    mask_counts: Optional[torch.Tensor]  # (B,)
    min_nbr_in_mask: int
    sample_fraction_in_fg_mask: float
    sampled_fraction_in_center: float
    depth_patch: bool
    patch_size: int
    dxdy: torch.Tensor                   # (patch_size^2, 2)

    def __call__(self, draws, nbr_pixels: int, sample_in_center: bool = False) -> torch.Tensor:
        """Flat ray indices y*W+x: (N,) shared or (B,N) per image."""
        B = self.nbr_images
        n_rand = nbr_pixels // B
        if self.depth_patch:
            n_rand = n_rand // self.patch_size**2

        pixels_in_mask = pixels_in_center = None
        if self.sample_fraction_in_fg_mask > 0.0 and self.mask_pixels is not None:
            n_mask = min(self.min_nbr_in_mask, int(n_rand * self.sample_fraction_in_fg_mask))
            n_rand -= n_mask
            raw = draws.randint((B, n_mask), 0, 2**31 - 1)
            idx = raw % self.mask_counts[:, None]
            pixels_in_mask = torch.gather(self.mask_pixels, 1,
                                          idx[..., None].expand(B, n_mask, 2))
        elif self.sampled_fraction_in_center > 0:
            n_center = int(n_rand * self.sampled_fraction_in_center)
            n_rand -= n_center
            idx = draws.randint((n_center,), 0, self.center_pixels.shape[0])
            pixels_in_center = self.center_pixels[idx]

        pool = self.center_pixels if sample_in_center else self.all_pixels
        random_pixels = pool[draws.randint((n_rand,), 0, pool.shape[0])]
        if pixels_in_mask is not None:
            random_pixels = torch.cat([random_pixels[None].expand(B, n_rand, 2), pixels_in_mask],
                                      dim=1)
        if pixels_in_center is not None:
            random_pixels = torch.cat([random_pixels, pixels_in_center], dim=0)
        if self.depth_patch:
            random_pixels = expand_to_patches(random_pixels, self.dxdy)
        return random_pixels[..., 1] * self.W + random_pixels[..., 0]


def expand_to_patches(pixels: torch.Tensor, dxdy: torch.Tensor) -> torch.Tensor:
    """(...,N,2) -> (...,N*p^2,2): each pixel becomes its p x p patch."""
    expanded = pixels[..., :, None, :] + dxdy[None, :, :]
    return expanded.reshape(*pixels.shape[:-2], pixels.shape[-2] * dxdy.shape[0], 2)


def make_ray_sampler(cfg, scene, device="cpu") -> RaySampler:
    """Build the pools from the numpy scene on the host (fg masks dilated 10
    times by a 3x3 box)."""
    B, _, H, W = scene["image"].shape
    patch_size = int(cfg.get("depth_regu_patch_size", 2))
    depth_patch = cfg.loss_weight.get("depth_patch") is not None

    if depth_patch:
        ys, xs = np.mgrid[0: H - patch_size - 1, 0: W - patch_size - 1]
    else:
        ys, xs = np.mgrid[0:H, 0:W]
    all_pixels = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)

    frac = float(cfg.get("precrop_frac", 0.5))
    dH, dW = int(H // 2 * frac), int(W // 2 * frac)
    ys, xs = np.mgrid[H // 2 - dH: H // 2 + dH, W // 2 - dW: W // 2 + dW]
    center_pixels = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    mask_pixels = mask_counts = None
    min_nbr_in_mask = 0
    if cfg.get("sample_fraction_in_fg_mask", 0.0) > 0.0 and "fg_mask" in scene:
        pools = []
        for b in range(B):
            m = scene["fg_mask"][b].reshape(H, W).astype(np.float32)
            dil = imgproc.dilate(m, iterations=10) > 0
            border = np.zeros_like(dil)
            border[: H - patch_size - 1, : W - patch_size - 1] = True
            yy, xx = np.where(dil & border)
            pools.append(np.stack([xx, yy], axis=-1))
        min_nbr_in_mask = min(len(p) for p in pools)
        padded = np.zeros((B, max(len(p) for p in pools), 2), np.int64)
        for b, p in enumerate(pools):
            padded[b, : len(p)] = p
        mask_pixels = t(padded)
        mask_counts = t([len(p) for p in pools])

    yy, xx = np.mgrid[0:patch_size, 0:patch_size]
    dxdy = np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1)
    return RaySampler(
        H=H, W=W, nbr_images=B, all_pixels=t(all_pixels), center_pixels=t(center_pixels),
        mask_pixels=mask_pixels, mask_counts=mask_counts, min_nbr_in_mask=min_nbr_in_mask,
        sample_fraction_in_fg_mask=float(cfg.get("sample_fraction_in_fg_mask", 0.0)),
        sampled_fraction_in_center=float(cfg.get("sampled_fraction_in_center", 0.0)),
        depth_patch=depth_patch, patch_size=patch_size, dxdy=t(dxdy),
    )
