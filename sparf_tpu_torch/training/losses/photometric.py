"""Photometric + mask + regularization losses (torch port of
sparf_tpu/training/losses/photometric.py)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from sparf_tpu_torch.parallel import mesh as mesh_mod
from sparf_tpu_torch.training.losses import base as L
from sparf_tpu_torch.training.losses import regularization as regu


def photometric_and_regu_loss(output_dict: Dict[str, torch.Tensor], image_at_rays: torch.Tensor,
                              fg_mask_at_rays: Optional[torch.Tensor] = None,
                              huber_photometric: bool = True, loss_weight: Optional[Dict] = None,
                              depth_regu_patch_size: int = 2, gate: float = 1.0
                              ) -> Dict[str, torch.Tensor]:
    """{'render': ..., ['fg_mask', 'distortion', 'depth_patch']}.

    image_at_rays (B,N,3) GT rgb at the rendered rays; fg_mask_at_rays
    (B,N,1) or None; gate 0/1 for start_iter scheduling.
    """
    loss_weight = loss_weight or {}
    B = image_at_rays.shape[0]
    loss_fn = L.huber_loss if huber_photometric else L.mse_loss
    loss_dict: Dict[str, torch.Tensor] = {}
    render = loss_fn(output_dict["rgb"].reshape(B, -1, 3), image_at_rays)
    if "rgb_fine" in output_dict:
        render = render + loss_fn(output_dict["rgb_fine"].reshape(B, -1, 3), image_at_rays)
    loss_dict["render"] = render * gate

    if loss_weight.get("fg_mask") is not None and fg_mask_at_rays is not None:
        mask_loss = 0.5 * mesh_mod.ray_mean(
            torch.abs(fg_mask_at_rays - output_dict["opacity"].reshape(B, -1, 1)))
        if "opacity_fine" in output_dict:
            mask_loss = mask_loss + 0.5 * mesh_mod.ray_mean(
                torch.abs(fg_mask_at_rays - output_dict["opacity_fine"].reshape(B, -1, 1)))
        loss_dict["fg_mask"] = mask_loss * gate

    if loss_weight.get("distortion") is not None:
        strength = 1e-3 * 2
        dist = strength * regu.lossfun_distortion(output_dict["t"], output_dict["weights"])
        if "weights_fine" in output_dict:
            dist = dist + strength * regu.lossfun_distortion(output_dict["t_fine"],
                                                             output_dict["weights_fine"])
        loss_dict["distortion"] = dist * gate

    if loss_weight.get("depth_patch") is not None:
        strength = 0.01 * 2
        dp = strength * regu.depth_patch_loss(output_dict["depth"], depth_regu_patch_size)
        if "depth_fine" in output_dict:
            dp = dp + strength * regu.depth_patch_loss(output_dict["depth_fine"],
                                                       depth_regu_patch_size)
        loss_dict["depth_patch"] = dp * gate
    return loss_dict


def gather_pixels_at_rays(image: torch.Tensor, ray_idx: torch.Tensor) -> torch.Tensor:
    """image (B,3,H,W); ray_idx (N,) shared or (B,N) per image. Returns (B,N,3)."""
    B = image.shape[0]
    flat = image.reshape(B, 3, -1).transpose(1, 2)  # (B,HW,3)
    if ray_idx.ndim == 1:
        return flat[:, ray_idx]
    return torch.gather(flat, 1, ray_idx[..., None].expand(*ray_idx.shape, 3))


def gather_mask_at_rays(mask: torch.Tensor, ray_idx: torch.Tensor) -> torch.Tensor:
    """mask (B,1,H,W) or (B,H,W); ray_idx (N,) or (B,N). Returns (B,N,1) float."""
    flat = mask.reshape(mask.shape[0], -1).to(torch.float32)
    out = flat[:, ray_idx] if ray_idx.ndim == 1 else torch.gather(flat, 1, ray_idx)
    return out[..., None]
