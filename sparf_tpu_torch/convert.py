"""Conversion between the JAX package's parameter pytrees (as numpy arrays)
and the port's tensors. Both keep W in (out, in) layout, so values map one to
one: {"coarse": {"feat": [(W, b)], "rgb": [(W, b)]}, "fine": ...} for the
NeRF, {name: (N, d)} for the pose embeddings."""
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
