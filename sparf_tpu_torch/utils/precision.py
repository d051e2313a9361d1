"""Full float32 on the card: TF32 off for cuDNN convolutions and cuBLAS matmuls.

PyTorch leaves `torch.backends.cudnn.allow_tf32` on by default, so float32
convolutions run in TF32 unless told otherwise. SSIM, LPIPS and the matchers
(their convolutions, correlation volumes and ZNCC scores) run inside
`ieee_fp32()`, whatever the global settings.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def ieee_fp32():
    """cuDNN convolutions and cuBLAS matmuls in full float32 inside the block."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
