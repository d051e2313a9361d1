"""The port's PDC-Net (sparf_tpu_torch/models/pdcnet.py) against
sparf_tpu/models/pdcnet_jax.py on the same inputs: the forward pass with
numpy-made random parameters and with the bundled weights (even and odd
sizes, so the explicit "SAME" padding is checked), the mixture's p_r and the
candidate composition, the flows over a pair list (plain, multiscale race,
homography race), two self-supervised adaptation steps with injected draws,
the npz round trip, and the facade's resolution to the bundled weights.

Tolerances (float32, other summation orders): mappings 1e-4 px at the net's
/2 level and 1e-3 px after the full-size resize and races (the homography
race goes through a float32 9x9 eigendecomposition); p_r and the mixture
terms 1e-5; confidence masks at 0.95 equal except pixels within 1e-4 of the
threshold, which are counted and held out.
"""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import assert_close
from sparf_tpu.models import flow_net as fj
from sparf_tpu.models import pdcnet_jax as pj
from sparf_tpu_torch import convert
from sparf_tpu_torch.datasets import synthetic
from sparf_tpu_torch.models import flow_net as ft
from sparf_tpu_torch.models import pdcnet as pt
from sparf_tpu_torch.utils.draws import ReplayDraws


def _numpy_params(seed: int):
    """pdcnet_jax's parameter layout, He-normal weights and small biases from numpy."""
    rng = np.random.RandomState(seed)
    return {name: [(rng.standard_normal((c_out, c_in, 3, 3)) * np.sqrt(2.0 / (c_in * 9))
                    ).astype(np.float32), (rng.standard_normal(c_out) * 0.05).astype(np.float32)]
            for name, c_in, c_out in pt._layer_shapes()}


def _bundled_params():
    return {k: [np.asarray(a) for a in v] for k, v in pj.load_weights_npz(pt.BUNDLED_WEIGHTS).items()}


def _scene(H, W):
    sc = synthetic.load_synthetic_scene(split="train", H=H, W=W, n_train=3, n_test=1)
    return np.asarray(sc["image"])


def test_layer_names_match_jax_init():
    params = jax.eval_shape(pj.init_params, jax.random.PRNGKey(0))
    assert {n: (ci, co) for n, ci, co in pt._layer_shapes()} == {
        n: (int(v[0].shape[1]), int(v[0].shape[0])) for n, v in params.items()}


@pytest.mark.parametrize("weights,H,W", [("random", 48, 64), ("bundled", 48, 64),
                                         ("bundled", 50, 66), ("bundled", 75, 100)])
def test_forward_matches_jax(weights, H, W):
    params = _numpy_params(3) if weights == "random" else _bundled_params()
    rng = np.random.RandomState(H)
    imgs = rng.rand(2, 3, H, W).astype(np.float32)
    out_j = jax.jit(pj.forward)({k: [jnp.asarray(a) for a in v] for k, v in params.items()},
                                jnp.asarray(imgs[:1]), jnp.asarray(imgs[1:]))
    model = convert.pdcnet_params_from_jax(params)
    with torch.no_grad():
        feats = model.extract_features(torch.as_tensor(imgs[:1]))
        out_t = model(torch.as_tensor(imgs[:1]), torch.as_tensor(imgs[1:]))
    # "SAME" stride-2 sizes: ceil(n / 2) per level (75 -> 38 -> 19 -> 10)
    h = H
    for f in feats:
        h = -(-h // 2)
        assert f.shape[-2] == h
    for k in ("mapping", "mapping8", "mapping4"):
        assert_close(out_t[k], out_j[k], atol=1e-4, what=k)
    for k in ("p_r", "alpha", "log_var_s", "log_var_l"):
        assert_close(out_t[k], out_j[k], atol=1e-5, what=k)


def test_p_r_and_candidate_composition_match_jax():
    rng = np.random.RandomState(1)
    H, W = 12, 16
    alpha = rng.rand(H, W).astype(np.float32)
    var_s = np.exp(rng.uniform(-6, 4, (H, W))).astype(np.float32)
    var_l = np.exp(rng.uniform(-4, 8, (H, W))).astype(np.float32)
    assert_close(pt.p_r_from_mixture(*map(torch.as_tensor, (alpha, var_s, var_l))),
                 pj.p_r_from_mixture(*map(jnp.asarray, (alpha, var_s, var_l))), atol=1e-6)
    c1 = (np.stack(np.meshgrid(np.arange(W), np.arange(H)))
          + rng.randn(2, H, W)).astype(np.float32)
    for Hm in (pj._scale_about_center_homography(1.4, H, W),
               np.array([[1.05, 0.02, 0.7], [-0.01, 0.97, -0.4], [1e-3, -2e-3, 1.0]], np.float32)):
        Hm = np.asarray(Hm, np.float32)
        out_j = pj.compose_candidate_uncertainty(*map(jnp.asarray, (c1, alpha, var_s, var_l, Hm)))
        out_t = pt.compose_candidate_uncertainty(*map(torch.as_tensor,
                                                      (c1, alpha, var_s, var_l, Hm)))
        assert_close(out_t[0], out_j[0], atol=1e-4, what="cH")
        assert_close(out_t[1], out_j[1], atol=1e-5, what="p_r")
        assert_close(out_t[2], out_j[2], atol=0, rtol=1e-5, what="expected variance")
    assert_close(pt._scale_about_center_homography(1.4, H, W),
                 pj._scale_about_center_homography(1.4, H, W), atol=0)


@pytest.mark.parametrize("variant", ["plain", "multiscale", "homography"])
def test_flow_of_combi_list_matches_jax(variant):
    kw = {"plain": {}, "multiscale": dict(multiscale_factors=(1.4,)),
          "homography": dict(use_homography=True)}[variant]
    imgs = _scene(48, 64)
    combi = fj.get_combi_list(3, "all")[:, :2]
    cj, pj_r = pj.compute_pdcnet_flow_of_combi_list(imgs, combi, weights_path=pt.BUNDLED_WEIGHTS,
                                                    **kw)
    ct, pt_r = pt.compute_pdcnet_flow_of_combi_list(imgs, combi, weights_path=pt.BUNDLED_WEIGHTS,
                                                    device="cpu", **kw)
    assert ct.shape == cj.shape == (2, 2, 48, 64) and pt_r.shape == (2, 1, 48, 64)
    assert_close(ct, cj, atol=1e-3, what="correspondences")
    assert_close(pt_r, pj_r, atol=1e-4, what="p_r")
    near = np.abs(pj_r - 0.95) < 1e-4
    assert near.sum() <= 16, f"{near.sum()} pixels within 1e-4 of the 0.95 threshold"
    np.testing.assert_array_equal((pt_r >= 0.95)[~near], (pj_r >= 0.95)[~near])
    assert (pt_r >= 0.95).mean() > 0.3  # the bundled net is confident on most of the scene


def test_two_adaptation_steps_match_jax(monkeypatch):
    """Two Adam steps of self_supervised_adapt from the bundled weights on
    numpy-made images and draws. The JAX step is jitted, so it takes its
    draws once, when traced; the port replays the same draws at both steps.
    Each step is compared from the same state: the port's second step starts
    from JAX's first-step parameters (with the port's own Adam moments).

    A parameter whose gradient is tiny takes Adam's step (lr x g / (|g| +
    eps) ~ lr x sign(g)) in either direction between two summation orders.
    So after each step every parameter is within 1e-5 of JAX's, except those
    whose gradient in that step (or the one before) is below 1e-2 of its
    tensor's largest (their float32 gradients carry the largest relative
    error); those are counted, and at most 0.1% of all."""
    shim = torch_parity.patch_jax_draws(monkeypatch, [pj], seed=0)
    rng = np.random.RandomState(0)
    imgs = rng.rand(3, 3, 48, 64).astype(np.float32)
    params = _bundled_params()
    steps_j = []
    for n in (1, 2):
        shim.random.rng = np.random.RandomState(0)  # both runs take the same draws
        steps_j.append(pj.self_supervised_adapt(
            {k: [jnp.asarray(a) for a in v] for k, v in params.items()}, imgs,
            jax.random.PRNGKey(0), n_steps=n, batch=2))
    assert [a.shape for a in shim.recorded[:5]] == [(2,), (2, 4, 2), (2, 3, 1, 1), (2, 1, 1, 1),
                                                    (2, 3, 48, 64)]
    assert all(np.array_equal(a, b) for a, b in zip(shim.recorded[:5], shim.recorded[5:]))
    model = convert.pdcnet_params_from_jax(params)
    opt = pt.adaptation_optimizer(model)
    timgs = torch.as_tensor(imgs)
    tiny_before = {}
    n_ambiguous = n_total = 0
    for step, new_j in enumerate(steps_j):
        draws = ReplayDraws(shim.recorded[:5])
        loss = pt.adaptation_loss(model, timgs, draws, batch=2)
        assert not draws.arrays
        opt.zero_grad()
        loss.backward()
        opt.step()
        for name, p in model.named_parameters():
            layer, i = name.rsplit("__", 1)
            b = np.asarray(new_j[layer][int(i)])
            g = p.grad.abs().numpy()
            tiny = (g < 1e-2 * g.max()) | tiny_before.get(name, False)
            tiny_before[name] = tiny
            off = np.abs(p.detach().numpy() - b) > 1e-5
            assert not (off & ~tiny).any(), f"step {step + 1} {name}: {int((off & ~tiny).sum())}"
            n_ambiguous += int(off.sum())
            n_total += b.size
            with torch.no_grad():  # the next step starts from JAX's parameters
                p.copy_(torch.as_tensor(b))
    print(f"adaptation: {n_ambiguous} of {n_total} parameter updates differ by > 1e-5")
    assert n_ambiguous <= 1e-3 * n_total, f"{n_ambiguous} of {n_total}"


def test_weights_npz_round_trip(tmp_path):
    model = pt.load_weights_npz(pt.BUNDLED_WEIGHTS)
    ref = pj.load_weights_npz(pt.BUNDLED_WEIGHTS)
    with np.load(pt.BUNDLED_WEIGHTS) as z:
        assert any("__" not in k for k in z.files)  # metadata keys are skipped
    for name, wb in convert.pdcnet_params_to_numpy(model).items():
        for a, b in zip(wb, ref[name]):
            np.testing.assert_array_equal(a, np.asarray(b))
    path = str(tmp_path / "w.npz")
    pt.save_weights_npz(model, path)
    for name, wb in pj.load_weights_npz(path).items():
        for a, b in zip(wb, ref[name]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert os.path.exists(pt.BUNDLED_WEIGHTS_R5)
    r5 = pt.load_weights_npz(pt.BUNDLED_WEIGHTS_R5)
    assert not torch.equal(r5.unc_out__0, model.unc_out__0)


def test_facade_resolves_the_bundled_weights(tmp_path, caplog):
    for wrapper in (ft.FlowSelectionWrapper("PDCNet", device="cpu"),
                    fj.FlowSelectionWrapper("PDCNet")):
        assert wrapper._resolve_backend() == "pdcnet_jax"
        assert os.path.samefile(wrapper.ckpt_path, pt.BUNDLED_WEIGHTS)
    missing = str(tmp_path / "none.npz")
    with caplog.at_level(logging.WARNING):
        port = ft.FlowSelectionWrapper("PDCNet", ckpt_path=missing, device="cpu")
        assert port._resolve_backend() == fj.FlowSelectionWrapper(
            "PDCNet", ckpt_path=missing)._resolve_backend() == "zncc"
    port_msgs = [r.getMessage() for r in caplog.records if r.name == "sparf_tpu_torch"]
    assert sum("does not exist" in m for m in port_msgs) == 1
    assert sum("falling back" in m for m in port_msgs) == 1
