"""LPIPS perceptual metric with an AlexNet backbone (torch port of
sparf_tpu/training/lpips_jax.py).

The weights are found in the JAX package's order: an explicit path, then
$SPARF_LPIPS_WEIGHTS, then the converted official weights
sparf_tpu/data/lpips_alex.npz, then the self-supervised weights bundled as
sparf_tpu/data/lpips_selfsup.npz (read as a data file), then the same
RandomState(0) random backbone. `weight_tag` says which one was used, with the
JAX package's names. Images are NCHW in [-1, 1]. The convolutions run with
TF32 off (utils.precision.ieee_fp32).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sparf_tpu_torch.utils.precision import ieee_fp32

# (out_ch, in_ch, k, stride, pad) for AlexNet features; ReLU after each
_ALEX_CONVS = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
# max-pool(3, stride 2) after ReLU 1 and ReLU 2
_POOL_AFTER = {0, 1}

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32).reshape(1, 3, 1, 1)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32).reshape(1, 3, 1, 1)

# the JAX package's data directory, found by path from the repository root:
# its files are read, never imported
DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "sparf_tpu", "data")


def _init_random_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """The JAX package's random backbone, from the same numpy stream."""
    rng = np.random.RandomState(seed)
    params: Dict[str, np.ndarray] = {}
    for i, (out_c, in_c, k, _, _) in enumerate(_ALEX_CONVS):
        fan_in = in_c * k * k
        params[f"conv{i}_w"] = (rng.randn(out_c, in_c, k, k) / np.sqrt(fan_in)).astype(np.float32)
        params[f"conv{i}_b"] = np.zeros(out_c, np.float32)
        params[f"lin{i}_w"] = np.full((out_c,), 1.0 / out_c, np.float32)
    return params


def load_weights_npz(path: str) -> Dict[str, np.ndarray]:
    """Every array of an LPIPS weight file (`provenance` included)."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def convert_torch_lpips_checkpoint(alexnet_pth: str, lpips_pth: str, out_npz: str) -> None:
    """Convert official torchvision-alexnet + lpips-lin checkpoints to npz.

    alexnet_pth: a torchvision alexnet state_dict (features.0.weight, ...);
    lpips_pth: the lpips 'alex' linear weights (lin0.model.1.weight, ...)."""
    alex = torch.load(alexnet_pth, map_location="cpu")
    lin = torch.load(lpips_pth, map_location="cpu")
    out: Dict[str, np.ndarray] = {}
    for i, fid in enumerate([0, 3, 6, 8, 10]):
        out[f"conv{i}_w"] = alex[f"features.{fid}.weight"].numpy()
        out[f"conv{i}_b"] = alex[f"features.{fid}.bias"].numpy()
        out[f"lin{i}_w"] = lin[f"lin{i}.model.1.weight"].numpy().reshape(-1)
    np.savez(out_npz, **out)


def features(params: Dict[str, torch.Tensor], x: torch.Tensor) -> List[torch.Tensor]:
    """The five AlexNet ReLU activations of normalised NCHW images (the
    caller chooses no_grad and the precision)."""
    feats = []
    for i, (_, _, _, stride, pad) in enumerate(_ALEX_CONVS):
        x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"], stride=stride,
                            padding=pad))
        feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return feats


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x**2, dim=1, keepdim=True)) + eps)


class LPIPS:
    """Callable lpips(img1, img2) on NCHW images in [-1, 1]; returns the mean distance."""

    def __init__(self, weights_path: Optional[str] = None):
        candidates = [weights_path, os.environ.get("SPARF_LPIPS_WEIGHTS"),
                      os.path.join(DATA_DIR, "lpips_alex.npz"),
                      os.path.join(DATA_DIR, "lpips_selfsup.npz")]
        weights_path = next((p for p in candidates if p and os.path.exists(p)), None)
        if weights_path:
            raw = load_weights_npz(weights_path)
            self.provenance = str(raw.pop("provenance", "converted official weights"))
            official = "official" in self.provenance.lower()
            self.weight_tag = "lpips" if official else "lpips(selfsup)"
        else:
            raw = _init_random_params()
            self.provenance = "random features"
            self.weight_tag = "lpips(rand)"
        self._params_np = raw
        self._params: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def params_on(self, device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        if device not in self._params:
            self._params[device] = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                                    for k, v in self._params_np.items()}
        return self._params[device]

    def __call__(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        params = self.params_on(img1.device)
        with torch.no_grad(), ieee_fp32():
            # AlexNet needs >= ~64 px (the second max-pool empties smaller
            # inputs): upsample tiny images first
            H, W = img1.shape[-2:]
            if min(H, W) < 64:
                s = int(np.ceil(64 / min(H, W)))
                img1 = F.interpolate(img1, size=(H * s, W * s), mode="bilinear",
                                     align_corners=False)
                img2 = F.interpolate(img2, size=(H * s, W * s), mode="bilinear",
                                     align_corners=False)
            shift = torch.as_tensor(_SHIFT, device=img1.device)
            scale = torch.as_tensor(_SCALE, device=img1.device)
            f1 = features(params, (img1 - shift) / scale)
            f2 = features(params, (img2 - shift) / scale)
            total = torch.zeros((), device=img1.device)
            for i, (a, b) in enumerate(zip(f1, f2)):
                d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
                w = params[f"lin{i}_w"].reshape(1, -1, 1, 1)
                total = total + torch.mean(torch.sum(d * w, dim=1))
        return total
