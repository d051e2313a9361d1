"""Conversion between the JAX package's parameter pytrees (as numpy arrays)
and the port's tensors. Both keep W in (out, in) layout, so values map one to
one: {"coarse": {"feat": [(W, b)], "rgb": [(W, b)]}, "fine": ...} for the
NeRF, {name: (N, d)} for the pose embeddings, {layer: [W, b]} for PDC-Net
(whose torch module names them `<layer>__0` and `<layer>__1`)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v, device) for v in tree)
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def nerf_params_from_jax(params: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """JAX NeRF pytree (numpy leaves) -> the port's tree of float32 tensors."""
    return _to_tensors(params, device)


def nerf_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's NeRF tree -> the JAX package's layout, numpy leaves."""
    return _to_numpy(params)


def pose_params_from_jax(params: Dict[str, Any], device="cpu") -> Dict[str, torch.Tensor]:
    """JAX pose-parameter dict (numpy leaves) -> the port's dict of tensors."""
    return _to_tensors(params, device)


def pose_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return _to_numpy(params)


def pdcnet_params_from_jax(params: Dict[str, Any], device="cpu"):
    """pdcnet_jax params {layer: [W (OIHW), b]} -> a models.pdcnet.PDCNet."""
    from sparf_tpu_torch.models.pdcnet import PDCNet

    model = PDCNet(generator=torch.Generator().manual_seed(0))
    model.load_state_dict({f"{name}__{i}": torch.as_tensor(np.array(a, dtype=np.float32))
                           for name, wb in params.items() for i, a in enumerate(wb)})
    return model.to(device)


def pdcnet_params_to_numpy(model) -> Dict[str, list]:
    """A PDCNet -> pdcnet_jax's {layer: [W, b]} layout, numpy leaves."""
    out: Dict[str, list] = {}
    for key, value in model.state_dict().items():
        name, idx = key.rsplit("__", 1)
        out.setdefault(name, [None, None])[int(idx)] = value.detach().cpu().numpy()
    return out
