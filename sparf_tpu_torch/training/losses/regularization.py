"""Regularization losses (torch port of sparf_tpu/training/losses/regularization.py);
under ray sharding each mean is this rank's share (parallel.mesh.ray_mean)."""
from __future__ import annotations

import torch

from sparf_tpu_torch.parallel import mesh as mesh_mod


def lossfun_distortion(t: torch.Tensor, w: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """mip-NeRF-360 distortion loss; t, w (B,R,S,1) sample depths and weights."""
    if normalize:
        w = w + 1e-6
        w = w / torch.sum(w, dim=-2, keepdim=True)
    w, t = w[..., 0], t[..., 0]
    ut = (t[..., 1:] + t[..., :-1]) / 2
    w_ = w[..., 1:]
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w_ * torch.sum(w_[..., None, :] * dut, dim=-1), dim=-1)
    loss_intra = torch.sum(w_**2 * torch.diff(t, dim=-1), dim=-1) / 3
    return mesh_mod.ray_mean(loss_inter + loss_intra)


def depth_patch_loss(depths: torch.Tensor, patch_size: int,
                     charbonnier_padding: float = 0.001) -> torch.Tensor:
    """Charbonnier smoothness over depth patches; depths (B,N*(p^2),1)."""
    d = depths.reshape(depths.shape[0], -1, patch_size**2)
    resid_sq = (d[..., None] - d[..., None, :]) ** 2
    return mesh_mod.ray_mean(torch.sqrt(resid_sq + charbonnier_padding**2))
