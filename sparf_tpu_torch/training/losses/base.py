"""Loss primitives + weighted combination (torch port of
sparf_tpu/training/losses/base.py). "Loss inactive before iteration X" is a
0/1 gate, as in the JAX package. Under ray sharding every reduction is this
rank's share (a local sum over the global count, sparf_tpu_torch.parallel),
so the ranks' losses sum to the unsharded loss."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from sparf_tpu_torch.parallel import mesh as mesh_mod


def l1_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return mesh_mod.ray_mean(torch.abs(pred - label))


def mse_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    d = (pred - label) ** 2
    return torch.sum(d) / (mesh_mod.ray_count(d) + 1e-6)


def huber(diff: torch.Tensor, delta: float) -> torch.Tensor:
    """Elementwise huber: 0.5 x^2 if |x|<delta else delta(|x|-0.5 delta)."""
    abs_d = torch.abs(diff)
    return torch.where(abs_d < delta, 0.5 * diff**2, delta * (abs_d - 0.5 * delta))


def huber_loss(pred: torch.Tensor, label: torch.Tensor, delta: float = 0.5) -> torch.Tensor:
    """Photometric huber: delta 0.5, scaled x2."""
    return mesh_mod.ray_mean(huber(pred - label, delta)) * 2.0


def compute_diff_loss(loss_type: str, diff: torch.Tensor, weights: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None, dim: int = -1) -> torch.Tensor:
    """Masked/weighted reduction; huber here uses delta=1."""
    lt = loss_type.lower()
    if lt == "epe":
        loss = torch.linalg.norm(diff, dim=dim, keepdim=True)
    elif lt == "l1":
        loss = torch.abs(diff)
    elif lt == "mse":
        loss = diff**2
    elif lt == "huber":
        loss = huber(diff, delta=1.0)
    else:
        raise ValueError(f"wrong loss type: {loss_type}")
    if weights is not None:
        if weights.ndim != loss.ndim:
            raise ValueError("weights must have the loss's rank")
        loss = loss * weights
    if mask is not None:
        if mask.ndim != loss.ndim:
            raise ValueError("mask must have the loss's rank")
        mask = mask.to(loss.dtype)
        return torch.sum(loss * mask) / (mesh_mod.global_sum(torch.sum(mask)) + 1e-6)
    return torch.sum(loss) / (mesh_mod.ray_count(loss) + 1e-6)


def summarize_loss_w_predefined_weights(loss_dict: Dict[str, torch.Tensor], loss_weight: Dict,
                                        parametrization: str = "exp") -> Dict[str, torch.Tensor]:
    """total = sum 10^w_k * loss_k."""
    loss_all = 0.0
    updated = {}
    for key, value in loss_dict.items():
        w_cfg = loss_weight.get(key)
        if w_cfg is None:
            continue
        w = 10.0 ** float(w_cfg) if parametrization == "exp" else float(w_cfg)
        weighted = w * value
        loss_all = loss_all + weighted
        updated[key + "_after_w"] = weighted
    out = dict(loss_dict)
    out["all"] = torch.as_tensor(loss_all) if not torch.is_tensor(loss_all) else loss_all
    out.update(updated)
    return out


def summarize_loss_w_equal_weights(loss_dict: Dict[str, torch.Tensor],
                                   loss_weight: Dict) -> Dict[str, torch.Tensor]:
    """Scale every loss to the render loss's magnitude (the ranks' summed
    magnitudes under ray sharding)."""
    render_loss = mesh_mod.global_sum(loss_dict["render"].detach())
    loss_all = 0.0
    updated = {}
    for key, value in loss_dict.items():
        if loss_weight.get(key) is None:
            continue
        total = mesh_mod.global_sum(value.detach())
        w = torch.where(total != 0.0, render_loss / (total + 1e-6), torch.ones_like(value))
        weighted = w * value
        loss_all = loss_all + weighted
        updated[key + "_after_w"] = weighted
    out = dict(loss_dict)
    out["all"] = torch.as_tensor(loss_all) if not torch.is_tensor(loss_all) else loss_all
    out.update(updated)
    return out


def iteration_gate(iteration: float, start_iter: float) -> float:
    """1.0 once iteration >= start_iter else 0.0."""
    return 1.0 if iteration >= start_iter else 0.0
