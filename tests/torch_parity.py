"""Helpers for the tests that hold sparf_tpu_torch to the JAX package: thread
caps, numpy conversion, tolerance asserts, interpret-mode Pallas, and a
stand-in for `jax` whose random draws come from numpy (so both packages can
be fed the same numbers)."""
from __future__ import annotations

import functools
from typing import Any, List

import jax
import numpy as np
import torch

# each xdist worker runs its own process; keep them from oversubscribing the CPU
torch.set_num_threads(2)


def to_np(x) -> Any:
    """torch / jax / nested containers -> numpy (float32 arrays stay float32)."""
    if isinstance(x, dict):
        return {k: to_np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_np(v) for v in x)
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t(x, requires_grad: bool = False) -> torch.Tensor:
    """numpy / jax array -> float32 CPU tensor."""
    out = torch.as_tensor(np.array(x, dtype=np.float32))
    return out.requires_grad_(requires_grad)


def assert_close(actual, expected, atol: float, rtol: float = 0.0, what: str = ""):
    np.testing.assert_allclose(to_np(actual), to_np(expected), atol=atol, rtol=rtol,
                               err_msg=what)


def assert_close_scaled(actual, expected, rel: float, what: str = ""):
    """max |a - b| <= rel * max |b| (for sums whose magnitude varies by tensor)."""
    a, b = to_np(actual), to_np(expected)
    scale = max(float(np.abs(b).max()) if b.size else 0.0, 1e-12)
    err = float(np.abs(a - b).max()) if b.size else 0.0
    assert err <= rel * scale, f"{what}: max err {err:.3g} > {rel} x {scale:.3g}"


def interpret_pallas(monkeypatch):
    """Run the fused-VJP Pallas kernels of sparf_tpu in interpret mode (as
    tests/test_ops.py does) and return that module."""
    import jax.experimental.pallas as plmod
    import sparf_tpu.ops.fused_mlp_vjp as fv

    monkeypatch.setattr(fv.pl, "pallas_call", functools.partial(plmod.pallas_call,
                                                                interpret=True))
    return fv


class _NumpyRandom:
    """`jax.random` whose randint/uniform return numpy-made arrays, recorded in order."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.recorded: List[np.ndarray] = []

    def randint(self, key, shape, minval, maxval, dtype=jax.numpy.int32):
        a = self.rng.randint(int(minval), int(maxval), size=tuple(shape)).astype(np.int32)
        self.recorded.append(a)
        return jax.numpy.asarray(a)

    def uniform(self, key, shape=(), dtype=jax.numpy.float32, minval=0.0, maxval=1.0):
        a = self.rng.uniform(minval, maxval, size=tuple(shape)).astype(np.float32)
        self.recorded.append(a)
        return jax.numpy.asarray(a)

    def __getattr__(self, name):
        return getattr(jax.random, name)


class NumpyDrawsJax:
    """Stand-in for the `jax` module: everything passes through to jax except
    random.randint / random.uniform, which come from numpy and are recorded."""

    def __init__(self, seed: int = 0):
        self.random = _NumpyRandom(seed)

    @property
    def recorded(self) -> List[np.ndarray]:
        return self.random.recorded

    def __getattr__(self, name):
        return getattr(jax, name)


def patch_jax_draws(monkeypatch, modules, seed: int = 0) -> NumpyDrawsJax:
    """Replace the `jax` attribute of each module with one shared NumpyDrawsJax."""
    shim = NumpyDrawsJax(seed)
    for m in modules:
        monkeypatch.setattr(m, "jax", shim)
    return shim
