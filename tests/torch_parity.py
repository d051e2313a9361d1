"""Helpers for the tests that hold sparf_tpu_torch to the JAX package: thread
caps, numpy conversion, tolerance asserts, interpret-mode Pallas, and a
stand-in for `jax` whose random draws come from numpy (so both packages can
be fed the same numbers)."""
from __future__ import annotations

import functools
import os
import subprocess
import sys
from typing import Any, List

import jax
import numpy as np
import torch

# each xdist worker runs its own process; keep them from oversubscribing the CPU
THREADS = 2
torch.set_num_threads(THREADS)

# the first lines of a fresh interpreter's code: block JAX, the JAX package,
# OpenCV, imageio and PIL (none is on the card's machine), so that an import
# of any of them, eager or lazy, fails; and cap torch's threads as in a worker
BLOCK = ("import sys\n"
         "for name in ('jax', 'jaxlib', 'flax', 'optax', 'sparf_tpu', 'cv2', 'imageio', 'PIL'):\n"
         "    sys.modules[name] = None\n"
         f"import torch\ntorch.set_num_threads({THREADS})\n")


def run_python(code: str, cwd: str, timeout: int = 300) -> subprocess.CompletedProcess:
    """Run `code` in a fresh interpreter with the workers' thread cap (its
    OpenMP and MKL pools too), capturing its output. The timeout guards
    against a hang; a test's subprocess takes well under it alone."""
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS), MKL_NUM_THREADS=str(THREADS))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


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
    """`jax.random` whose randint/uniform/normal return numpy-made arrays,
    recorded in order. A uniform draw records the unit draw u in [0, 1) and
    returns u * (maxval - minval) + minval in float32, as jax.random does, so
    that the port can scale the replayed u itself."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.recorded: List[np.ndarray] = []

    def randint(self, key, shape, minval, maxval, dtype=jax.numpy.int32):
        a = self.rng.randint(int(minval), int(maxval), size=tuple(shape)).astype(np.int32)
        self.recorded.append(a)
        return jax.numpy.asarray(a)

    def uniform(self, key, shape=(), dtype=jax.numpy.float32, minval=0.0, maxval=1.0):
        u = self.rng.uniform(0.0, 1.0, size=tuple(shape)).astype(np.float32)
        self.recorded.append(u)
        return jax.numpy.asarray(u * np.float32(maxval - minval) + np.float32(minval))

    def normal(self, key, shape=(), dtype=jax.numpy.float32):
        a = self.rng.standard_normal(size=tuple(shape)).astype(np.float32)
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


# ---------------------------------------------------------------------------
# 3xTF32: the products the fused-MLP kernels run on the tensor cores
# ---------------------------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by mantissa masking, round to nearest (ties away from
    zero): add half a unit of the 13 dropped bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value a tensor core reads from a float32 register: the 13 low
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it: x = hi + lo with hi = tf32(x) and lo =
    x - hi, read by the tensor core as tf32_truncated(lo); hi*hi + hi*lo +
    lo*hi, each TF32 product exact in float32, summed in float32 (the lo*lo
    term is dropped)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass (what the tensor cores give without the split)."""
    return tf32(a) @ tf32(b)


def mlp_chain(meta, pts_enc, view_enc, weights, g_density, g_rgb, mm):
    """The fused chain's outputs and K2's gradients (recompute, masks from the
    next layer's input > 0), every product through mm. Returns (raw_density,
    raw_rgb, [d_pts, d_view, dW0, db0, ...], min |pre-activation| per point)."""
    n_layers = meta.n_feat + meta.n_rgb
    xs, zmin = [], None
    feat = pts_enc
    for li in range(n_layers):
        W, b = weights[2 * li], weights[2 * li + 1]
        if li < meta.n_feat and li in meta.skip:
            feat = torch.cat([feat, pts_enc], -1)
        if li == meta.n_feat and meta.view_dep:
            feat = torch.cat([feat, view_enc], -1)
        xs.append(feat)
        z = mm(feat, W.t()) + b
        if li == n_layers - 1:
            raw_rgb = z[:, :3]
            break
        if li == meta.n_feat - 1:
            raw_density, z = z[:, 0], z[:, 1:]
        m = z.abs().amin(1)
        zmin = m if zmin is None else torch.minimum(zmin, m)
        feat = torch.relu(z)
    d_pts, d_view = torch.zeros_like(pts_enc), torch.zeros_like(view_enc)
    grads = [None] * (2 * n_layers)
    g_z = g_rgb
    for li in range(n_layers - 1, -1, -1):
        x = xs[li]
        grads[2 * li], grads[2 * li + 1] = mm(g_z.t(), x), g_z.sum(0)
        g_x = mm(g_z, weights[2 * li])
        if li == 0:
            d_pts = d_pts + g_x
            break
        w2 = (meta.d_in if li < meta.n_feat and li in meta.skip else
              meta.d_view if li == meta.n_feat and meta.view_dep else 0)
        w1 = x.shape[1] - w2
        if li < meta.n_feat and li in meta.skip:
            d_pts = d_pts + g_x[:, w1:]
        elif li == meta.n_feat and meta.view_dep:
            d_view = g_x[:, w1:]
        g_z = g_x[:, :w1] * (x[:, :w1] > 0)
        if li == meta.n_feat:
            g_z = torch.cat([g_density[:, None], g_z], -1)
    return raw_density, raw_rgb, [d_pts, d_view, *grads], zmin
