"""sparf_tpu_torch renderer vs the JAX package: deterministic renders
(stratified=False), renders with injected uniforms, the inverse-CDF fine
sampler including its clipped-gather fallback, and render_to_max.

Small MLP (4x64, skip at 2). Tolerances: float32; depths and colours within
1e-4 (compositing over up to 48 samples), gradients within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, patch_jax_draws, t, to_np

from sparf_tpu.models import nerf_mlp as jmlp
from sparf_tpu.models import renderer as jren
from sparf_tpu_torch.convert import nerf_params_from_jax
from sparf_tpu_torch.models import nerf_mlp as tmlp
from sparf_tpu_torch.models import renderer as tren
from sparf_tpu_torch.utils.draws import ReplayDraws

SMALL = dict(layers_feat=(64,) * 4, layers_rgb=(32, 3), skip=(2,), L_3D=6, L_view=2)


def _setup(fine=True):
    cfg_j = jren.RenderConfig(mlp=jmlp.MLPConfig(**SMALL), sample_intvs=32,
                              sample_intvs_fine=16, fine_sampling=fine)
    cfg_t = tren.RenderConfig(mlp=tmlp.MLPConfig(**SMALL), sample_intvs=32,
                              sample_intvs_fine=16, fine_sampling=fine)
    params_j = jren.init_graph_params(jax.random.PRNGKey(0), cfg_j)
    pose = np.array([[[1, 0, 0, 0.1], [0, 1, 0, -0.2], [0, 0, 1, 3.0]]], np.float32)
    intr = np.array([[[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]]], np.float32)
    pixels = np.random.RandomState(0).uniform(0, 12, size=(7, 2)).astype(np.float32)
    return cfg_j, cfg_t, params_j, pose, intr, pixels


def _compare(out_t, out_j, keys, atol=1e-4):
    for k in keys:
        assert_close(out_t[k], out_j[k], atol=atol, what=k)


@pytest.mark.parametrize("fine_enabled", [False, True])
def test_render_at_pixels_deterministic(fine_enabled):
    cfg_j, cfg_t, params_j, pose, intr, pixels = _setup()
    dr = np.array([1.5, 4.8], np.float32)
    out_j = jren.render_at_pixels(params_j, cfg_j, pose, intr, pixels, jnp.asarray(dr),
                                  jnp.asarray(1.0), key=None, stratified=False,
                                  fine_enabled=fine_enabled)
    params_t = nerf_params_from_jax(to_np(params_j))
    out_t = tren.render_at_pixels(params_t, cfg_t, t(pose), t(intr), t(pixels), t(dr), 1.0,
                                  draws=None, stratified=False, fine_enabled=fine_enabled)
    keys = ["rgb", "depth", "opacity", "all_cumulated", "t", "weights"]
    if fine_enabled:
        keys += ["rgb_fine", "depth_fine", "t_fine", "weights_fine"]
    _compare(out_t, out_j, keys)


def test_render_with_injected_uniforms_and_gradients(monkeypatch):
    """Stratified coarse jitter and the fine sampler's uniforms fed to both."""
    cfg_j, cfg_t, params_j, pose, intr, pixels = _setup()
    shim = patch_jax_draws(monkeypatch, [jren], seed=3)
    dr = np.array([1.5, 4.8], np.float32)

    def loss_j(p):
        o = jren.render_at_pixels(p, cfg_j, pose, intr, pixels, jnp.asarray(dr),
                                  jnp.asarray(1.0), key=jax.random.PRNGKey(5),
                                  stratified=True, fine_enabled=True)
        return jnp.sum(o["rgb_fine"] ** 2) + jnp.sum(o["depth"]), o

    (l_j, out_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params_j)
    assert [a.shape for a in shim.recorded] == [(1, 7, 32, 1), (17,)]
    params_t = nerf_params_from_jax(to_np(params_j))
    for layer in params_t["coarse"]["feat"] + params_t["fine"]["feat"]:
        layer[0].requires_grad_(True)
    out_t = tren.render_at_pixels(params_t, cfg_t, t(pose), t(intr), t(pixels), t(dr), 1.0,
                                  draws=ReplayDraws(shim.recorded), stratified=True,
                                  fine_enabled=True)
    _compare(out_t, out_j, ["rgb", "depth", "t", "rgb_fine", "depth_fine", "t_fine"])
    (torch.sum(out_t["rgb_fine"] ** 2) + torch.sum(out_t["depth"])).backward()
    for level in ("coarse", "fine"):
        for (Wt, _), (Wj, _) in zip(params_t[level]["feat"], g_j[level]["feat"]):
            assert_close(Wt.grad, Wj, atol=1e-4)


@pytest.mark.parametrize("det", [True, False])
def test_sample_depth_from_pdf_clipped_fallback(monkeypatch, det):
    """u >= cdf[-1] (weights summing below 1) takes the clipped-gather value."""
    rng = np.random.RandomState(4)
    w = rng.uniform(0, 1, size=(2, 5, 16)).astype(np.float32)
    w[0, 0] = 0.0                      # all-zero histogram
    w[1, 2, 3:] = 0.0                  # mass only in the first bins
    w *= 0.5                           # total weight < 1
    dr = np.array([1.0, 3.0], np.float32)
    shim = patch_jax_draws(monkeypatch, [jren], seed=6)
    s_j = jren.sample_depth_from_pdf(jax.random.PRNGKey(0), jnp.asarray(w), 16, 8,
                                     jnp.asarray(dr), det=det)
    s_t = tren.sample_depth_from_pdf(ReplayDraws(shim.recorded), t(w), 16, 8, t(dr), det=det)
    assert len(shim.recorded) == (0 if det else 1)
    assert_close(s_t, s_j, atol=1e-5)


def test_render_to_max():
    cfg_j, cfg_t, params_j, pose, intr, pixels = _setup()
    dmax = np.random.RandomState(5).uniform(2, 4, size=(1, 7)).astype(np.float32)
    out_j = jren.render_to_max(params_j, cfg_j, pose, intr, pixels, jnp.asarray(1.5),
                               jnp.asarray(dmax), jnp.asarray(1.0), fine_enabled=True)
    out_t = tren.render_to_max(nerf_params_from_jax(to_np(params_j)), cfg_t, t(pose), t(intr),
                               t(pixels), torch.tensor(1.5), t(dmax), 1.0, fine_enabled=True)
    _compare(out_t, out_j, ["all_cumulated", "all_cumulated_fine", "depth", "t", "opacity"])
