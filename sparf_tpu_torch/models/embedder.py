"""Frequency positional encoding + BARF coarse-to-fine masking (torch port of
sparf_tpu/models/embedder.py).

Encoding layout per input channel c:
``[sin(f_0 x_c)..sin(f_{L-1} x_c), cos(f_0 x_c)..cos(f_{L-1} x_c)]`` flattened
channel-major, so an (L,) weight applied to ``enc.reshape(-1, L)`` masks
frequency k everywhere.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from sparf_tpu_torch.utils import tracing


def frequency_bands(L: int, include_pi: bool = True, log_sampling: bool = True,
                    device=None) -> torch.Tensor:
    if log_sampling:
        freq = 2.0 ** torch.arange(L, dtype=torch.float32, device=device)
        if include_pi:
            freq = freq * math.pi
    else:
        freq = torch.linspace(2.0**0.0, 2.0 ** (L - 1), L, dtype=torch.float32,
                              device=device) * math.pi
    return freq


def positional_encoding(x: torch.Tensor, L: int, include_pi: bool = True,
                        log_sampling: bool = True) -> torch.Tensor:
    """(..., C) -> (..., C*2*L)."""
    freq = frequency_bands(L, include_pi, log_sampling, device=x.device)
    spectrum = x[..., None] * freq                        # (..., C, L)
    enc = torch.stack([torch.sin(spectrum), torch.cos(spectrum)], dim=-2)  # (..., C, 2, L)
    return enc.reshape(*x.shape[:-1], -1)


def c2f_weights(progress: float, L: int, c2f: Optional[Sequence[float]],
                device=None) -> Optional[torch.Tensor]:
    """BARF frequency weights: w_k = (1-cos(clamp(alpha-k,0,1) pi))/2."""
    if c2f is None:
        return None
    start, end = c2f
    # a host number onto the device: a copy the device has to finish first
    with tracing.wait("embedder.c2f_alpha"):
        alpha = torch.as_tensor((progress - start) / (end - start) * L, dtype=torch.float32,
                                device=device)
    k = torch.arange(L, dtype=torch.float32, device=device)
    return (1 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2


def apply_c2f_mask(enc: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Apply per-frequency weights; weight has shape (L,)."""
    if weight is None:
        return enc
    L = weight.shape[0]
    return (enc.reshape(-1, L) * weight).reshape(enc.shape)
