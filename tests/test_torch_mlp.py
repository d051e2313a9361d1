"""sparf_tpu_torch embedder / NeRF MLP / compositing vs the JAX package.

Small MLP (5x64, skip at 2, L_3D=6, L_view=2) as in tests/test_ops.py.
Tolerances: float32; outputs within 1e-5, gradients within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, t, to_np

from sparf_tpu.models import embedder as jemb
from sparf_tpu.models import nerf_mlp as jmlp
from sparf_tpu_torch.convert import nerf_params_from_jax, nerf_params_to_numpy
from sparf_tpu_torch.models import embedder as temb
from sparf_tpu_torch.models import nerf_mlp as tmlp

SMALL = dict(layers_feat=(64,) * 5, layers_rgb=(32, 3), skip=(2,), L_3D=6, L_view=2)


@pytest.mark.parametrize("c2f,progress", [(None, 1.0), ((0.1, 0.5), 0.3), ((0.1, 0.5), 0.9)])
def test_positional_encoding_and_c2f(c2f, progress):
    x = np.random.RandomState(0).normal(size=(7, 3)).astype(np.float32)
    enc_j = jemb.positional_encoding(x, 6)
    assert_close(temb.positional_encoding(t(x), 6), enc_j, atol=1e-5)
    w_j = jemb.c2f_weights(jnp.asarray(progress, jnp.float32), 6, c2f)
    w_t = temb.c2f_weights(progress, 6, c2f)
    if c2f is None:
        assert w_t is None and w_j is None
    else:
        assert_close(w_t, w_j, atol=1e-6)
        assert_close(temb.apply_c2f_mask(t(enc_j), w_t), jemb.apply_c2f_mask(enc_j, w_j),
                     atol=1e-6)


@pytest.mark.parametrize("view_dep", [True, False])
def test_nerf_apply_values_and_gradients(view_dep):
    cfg_j = jmlp.MLPConfig(view_dep=view_dep, barf_c2f=(0.1, 0.5), **SMALL)
    cfg_t = tmlp.MLPConfig(view_dep=view_dep, barf_c2f=(0.1, 0.5), **SMALL)
    params_j = jmlp.init_nerf_params(jax.random.PRNGKey(0), cfg_j)
    params_t = nerf_params_from_jax(to_np(params_j))
    rng = np.random.RandomState(1)
    pts = rng.normal(size=(2, 9, 5, 3)).astype(np.float32)
    ray = rng.normal(size=(2, 9, 3)).astype(np.float32)

    def loss_j(p, x):
        o = jmlp.nerf_apply(p, cfg_j, x, ray, jnp.asarray(0.3))
        return jnp.sum(o["rgb_samples"] ** 2) + jnp.sum(jnp.sin(o["density_samples"]))

    l_j, (g_pj, g_xj) = jax.value_and_grad(loss_j, argnums=(0, 1))(params_j, pts)
    leaves = [w for layer in params_t["feat"] + params_t["rgb"] for w in layer]
    for w in leaves:
        w.requires_grad_(True)
    x = t(pts, requires_grad=True)
    o = tmlp.nerf_apply(params_t, cfg_t, x, t(ray), 0.3)
    l_t = torch.sum(o["rgb_samples"] ** 2) + torch.sum(torch.sin(o["density_samples"]))
    l_t.backward()
    assert_close(l_t, l_j, atol=0, rtol=1e-5)
    assert_close(x.grad, g_xj, atol=1e-4)
    for (Wt, bt), (Wj, bj) in zip(params_t["feat"] + params_t["rgb"],
                                  g_pj["feat"] + g_pj["rgb"]):
        assert_close(Wt.grad, Wj, atol=1e-4)
        assert_close(bt.grad, bj, atol=1e-4)


def test_init_matches_layout_and_roundtrip():
    cfg_j = jmlp.MLPConfig(**SMALL)
    cfg_t = tmlp.MLPConfig(**SMALL)
    pj = to_np(jmlp.init_nerf_params(jax.random.PRNGKey(0), cfg_j))
    pt = tmlp.init_nerf_params(torch.Generator().manual_seed(0), cfg_t)
    for (Wj, bj), (Wt, bt) in zip(pj["feat"] + pj["rgb"], pt["feat"] + pt["rgb"]):
        assert Wt.shape == Wj.shape and bt.shape == bj.shape
        # same Xavier-uniform spread (std of U(-a, a) is a / sqrt(3))
        assert abs(float(Wt.std()) / float(np.std(Wj)) - 1.0) < 0.1
    back = nerf_params_to_numpy(nerf_params_from_jax(pj))
    for (Wj, _), (Wb, _) in zip(pj["feat"], back["feat"]):
        np.testing.assert_array_equal(Wj, Wb)


@pytest.mark.parametrize("setbg", [False, True])
def test_composite_values_and_gradients(setbg):
    rng = np.random.RandomState(2)
    ray = rng.normal(size=(2, 6, 3)).astype(np.float32)
    rgb = rng.uniform(size=(2, 6, 8, 3)).astype(np.float32)
    dens = rng.uniform(0, 3, size=(2, 6, 8)).astype(np.float32)
    depth = np.sort(rng.uniform(1, 4, size=(2, 6, 8, 1)), axis=2).astype(np.float32)
    out_j = jmlp.composite(ray, rgb, dens, depth, setbg)
    d = t(dens, requires_grad=True)
    out_t = tmlp.composite(t(ray), t(rgb), d, t(depth), setbg)
    for k in out_j:
        assert_close(out_t[k], out_j[k], atol=1e-5, what=k)
    g_j = jax.grad(lambda x: jnp.sum(jmlp.composite(ray, rgb, x, depth, setbg)["depth"])
                   + jnp.sum(jmlp.composite(ray, rgb, x, depth, setbg)["rgb"]))(dens)
    (torch.sum(out_t["depth"]) + torch.sum(out_t["rgb"])).backward()
    assert_close(d.grad, g_j, atol=1e-4)

