"""Many steps of the JAX trainer on numpy-made draws, one compile per stage.

tests/torch_parity.py's NumpyDrawsJax draws at trace time, so a jitted step
would keep the first step's numbers. Here the modules that draw get a
stand-in `jax` whose random calls return, in call order, arrays that the
step takes as arguments: the step is traced once per stage signature (first
abstractly, to learn each draw's kind, shape and range), and every call
gets fresh numpy draws. The port replays the same numbers through
`ReplayDraws` (unit uniforms, as the port scales them itself)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import jax
import numpy as np

from torch_parity import assert_close, assert_close_scaled, to_np
from sparf_tpu.models import renderer as jren
from sparf_tpu.training import engine as jeng
from sparf_tpu.training import sampling as jsamp
from sparf_tpu.training.losses import corres as jcorres
from sparf_tpu.training.losses import depth_cons as jdc
from sparf_tpu_torch.convert import nerf_params_from_jax
from sparf_tpu_torch.training import engine as teng
from sparf_tpu_torch.utils.draws import ReplayDraws

DRAWING_MODULES = [jsamp, jcorres, jdc, jren]


class _FedRandom:
    """`jax.random` whose randint/uniform/normal hand out `fed` in order (or,
    with fed None, zeros, recording each call's spec)."""

    def __init__(self):
        self.fed = None
        self.spec: List[Tuple] = []

    def _next(self, kind, shape, lo=None, hi=None, dtype=None):
        shape = tuple(int(s) for s in shape)
        if self.fed is None:
            self.spec.append((kind, shape, lo, hi))
            return jax.numpy.zeros(shape, dtype)
        return self.fed.pop(0)

    def randint(self, key, shape, minval, maxval, dtype=jax.numpy.int32):
        return self._next("randint", shape, int(minval), int(maxval), jax.numpy.int32)

    def uniform(self, key, shape=(), dtype=jax.numpy.float32, minval=0.0, maxval=1.0):
        return self._next("uniform", shape, float(minval), float(maxval), jax.numpy.float32)

    def normal(self, key, shape=(), dtype=jax.numpy.float32):
        return self._next("normal", shape, dtype=jax.numpy.float32)

    def __getattr__(self, name):
        return getattr(jax.random, name)


class _FedJax:
    def __init__(self):
        self.random = _FedRandom()

    def __getattr__(self, name):
        return getattr(jax, name)


class _NoJit:
    """`jax` for the engine module: jit returns the step itself."""

    @staticmethod
    def jit(fn, **_):
        return fn

    def __getattr__(self, name):
        return getattr(jax, name)


def make_draws(spec, rng: np.random.RandomState):
    """(arrays for the JAX step, arrays for ReplayDraws) of one step: ints in
    [lo, hi), unit uniforms u (the JAX step gets u * (hi - lo) + lo in
    float32), standard normals."""
    fed, replay = [], []
    for kind, shape, lo, hi in spec:
        if kind == "randint":
            a = rng.randint(lo, hi, size=shape).astype(np.int32)
            fed.append(a)
        elif kind == "uniform":
            a = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
            fed.append(a * np.float32(hi - lo) + np.float32(lo))
        else:
            a = rng.standard_normal(size=shape).astype(np.float32)
            fed.append(a)
        replay.append(a)
    return fed, replay


class JaxStepper:
    """step(iteration, state, rng, edit=None) -> (new_state, stats, replay
    arrays) on the JAX trainer `jt`. `edit(fed, replay)` may change the
    draws of a step before it runs (e.g. put a NaN in one, the same in both
    lists)."""

    def __init__(self, jt, monkeypatch, extra_modules=()):
        self.jt = jt
        self.shim = _FedJax()
        for m in DRAWING_MODULES + list(extra_modules):
            monkeypatch.setattr(m, "jax", self.shim)
        monkeypatch.setattr(jeng, "jax", _NoJit())
        self._compiled: Dict[Tuple, Tuple] = {}

    def _for(self, iteration):
        sig = self.jt.stage_signature(iteration)
        if sig not in self._compiled:
            raw = self.jt.get_step(iteration)
            rnd = self.shim.random
            rnd.fed, rnd.spec = None, []
            jax.eval_shape(raw, self.jt.state)
            spec = list(rnd.spec)

            def fed_step(state, draws):
                rnd.fed = list(draws)
                out = raw(state)
                assert not rnd.fed, "the step took fewer draws than at the spec trace"
                return out

            self._compiled[sig] = (spec, jax.jit(fed_step))
        return self._compiled[sig]

    def step(self, iteration, state, rng, edit=None):
        spec, fn = self._for(iteration)
        fed, replay = make_draws(spec, rng)
        if edit is not None:
            edit(fed, replay)
        new_state, stats = fn(state, [jax.numpy.asarray(a) for a in fed])
        return new_state, stats, replay


def _mu(opt_state):
    """Adam's first moment inside the JAX engine's optax chain state."""
    return next(s.mu for s in opt_state if hasattr(s, "mu"))


def assert_one_step_matches(jt, tt, iteration, monkeypatch, seed=0, extra_modules=(),
                            keep_grad=1e-6):
    """One step of the JAX trainer `jt` and the port's `tt` from the same
    state at `iteration`, on shared draws, held to tests/test_torch_slice.py's
    tolerances: every loss and scalar stat rtol 1e-4; the NeRF gradients
    (Adam's mu / 0.1 after one step from zero) within 1e-3 of each tensor's
    largest magnitude; the updated parameters atol 1e-6, except where JAX's
    gradient is below 1e-6 = 100 x Adam's eps. There the first step,
    lr g / (|g| + eps), turns the gradients' float32 rounding into a step
    difference of lr |dg| eps / (|g| + eps)^2 (2.8e-6 at g = 3.8e-8 in one
    case), as a ReLU tie does in a gradient check; those gradients are still
    held by the check on mu. `keep_grad` sets that threshold (1e-6). Returns
    the stats (JAX's, the port's)."""
    assert tt.stage_signature(iteration) == jt.stage_signature(iteration)
    stepper = JaxStepper(jt, monkeypatch, extra_modules)
    state_j = jt.state.replace(iteration=jax.numpy.asarray(iteration, jax.numpy.int32),
                               iteration_nerf=jax.numpy.asarray(iteration, jax.numpy.int32))
    new_j, stats_j, replay = stepper.step(iteration, state_j, np.random.RandomState(seed))
    state_t = dataclasses.replace(tt.state, iteration=iteration, iteration_nerf=iteration)
    draws = ReplayDraws(replay)
    new_t, stats_t = tt.get_step(iteration)(state_t, draws)
    assert not draws.arrays, "the port consumed fewer draws than the JAX step"
    for k, v in stats_j.items():
        assert_close(stats_t[k], v, atol=1e-7, rtol=1e-4, what=k)
    assert int(new_t.nan_count) == int(new_j.nan_count) == 0
    mu_j = teng.tree_leaves(nerf_params_from_jax(to_np(_mu(new_j.opt_state_nerf))))
    for a, b in zip(new_t.opt_state_nerf.mu, mu_j):
        assert_close_scaled(a / 0.1, b / 0.1, 1e-3, "nerf grad")
    p_j = teng.tree_leaves(nerf_params_from_jax(to_np(new_j.nerf_params)))
    for a, b, g in zip(teng.tree_leaves(new_t.nerf_params), p_j, mu_j):
        keep = np.abs(to_np(g) / 0.1) >= keep_grad
        assert_close(to_np(a)[keep], to_np(b)[keep], atol=1e-6)
    return stats_j, stats_t
