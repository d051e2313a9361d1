"""The MLP implementation the renderer picks (RenderConfig.mlp_impl, from
cfg.tpu.use_pallas), and MLP chains across the CUDA kernels' domain.

cfg.tpu.use_pallas=False runs the MLP as models/nerf_mlp.nerf_apply in torch
ops, on any device and at any width: the port's counterpart of the JAX
package's XLA MLP (sparf_tpu/training/trainer.py, mlp_impl="xla"). With
use_pallas=True (the default) the MLP runs through ops/fused_mlp: on a CUDA
device the kernels, which take every chain of up to 512 features per layer
and pts_enc and view_enc up to 128 wide and raise ValueError past that
(chip_smoke.py kernels, wide-check and routes), on the CPU their plain
versions. Here, on the CPU:

- the renderer calls the implementation that use_pallas names, and nothing
  else;
- nerf_apply on the presets' chain and on other chains of the domain (4x64
  with L_3D=12, three 150-wide layers, 8x256 with L_3D=12 and with L_3D=6,
  four 384-wide layers, four 32-wide layers, and its corner: 8x512 with
  L_3D=20 and L_view=20) against the JAX package's nerf_apply, in both
  compute dtypes;
- one use_pallas=False trainer step, joint and fine stage, against the JAX
  trainer's step (the XLA MLP, the JAX trainer's choice on the CPU);
- the plain versions of K1/K2/K3 on each of those chains against the JAX
  package's Pallas K1/K2 and K3 in interpret mode, at the tolerances of
  test_torch_fused_mlp.py (float32) and test_torch_bf16_kernels.py
  (bfloat16; K3 on the bf16 kernels' weight layout, WgPackedWeights);
- K3's weight layout at bfloat16 (the wgmma kernels') takes every chain of
  the domain and refuses the chains past it, as k_wg_layout does on the
  card;
- the kernels' route (fused_mlp.route) on a stand-in for the library's C
  sizes entries: its K2 choice and sizes, one question per entry, chain
  and dtype, and the width refusals, which name use_pallas=False.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from test_torch_bf16_kernels import BWD_REL, FWD_REL, LOSS_REL, WEIGHT_REL, assert_points_close
from torch_parity import assert_close, assert_close_scaled, interpret_pallas, t, to_np
from traced_draws import assert_one_step_matches

from sparf_tpu.configs.config import ConfigDict, override_options
from sparf_tpu.models import nerf_mlp as jmlp
from sparf_tpu.ops import fused_mlp as jfused
from sparf_tpu.training.joint_trainer import PoseAndNerfTrainerPerScene as JaxTrainer
from sparf_tpu_torch.convert import nerf_params_from_jax, pose_params_from_jax
from sparf_tpu_torch.models import nerf_mlp as tmlp
from sparf_tpu_torch.models import renderer as tren
from sparf_tpu_torch.ops import fused_mlp as fm
from sparf_tpu_torch.training.joint_trainer import PoseAndNerfTrainerPerScene as TorchTrainer

D_PTS_REL = 4e-6  # float32 point gradients, of their largest magnitude
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# widths, and whether the bf16 kernels' layout (wg_layout) takes the chain:
# every chain of the kernels' domain (chip_smoke.py KERNEL_CHAINS)
CHAINS = {
    "presets-8x256": (dict(), True),
    "4x64-L3D12": (dict(layers_feat=(64,) * 4, layers_rgb=(32, 3), skip=(2,), L_3D=12), True),
    "3x150": (dict(layers_feat=(150,) * 3, layers_rgb=(32, 3), skip=()), True),
    "8x256-L3D12": (dict(L_3D=12), True),
    "4x384-skip2": (dict(layers_feat=(384,) * 4, skip=(2,)), True),
    "8x256-L3D6": (dict(L_3D=6), True),
    "4x32": (dict(layers_feat=(32,) * 4, layers_rgb=(32, 3), skip=(2,)), True),
    "8x512-L3D20-Lview20": (dict(layers_feat=(512,) * 8, skip=(4,), L_3D=20, L_view=20), True),
}
WIDE = [c for c in CHAINS if c != "presets-8x256"]
# bf16 on chains of 256 features or more that no earlier version of these
# tests held (a point there rounds thousands of values: ~2,300 at 8x256,
# ~4,500 at 8x512, where test_torch_bf16_kernels.py's 64-wide chain rounds
# ~400): two correct float32 sum orders flip 6.8% to 9.1% of the points here
# (measured on 44 and 76 points), past that file's 3%, and one point's d_pts
# by 2.5e-2 of scale. These cases are held to the bounds chip_smoke.py states
# for the same comparison at the full width (BF16_FLIPPED, BF16_LOOSE,
# BF16_WEIGHT_RTOL; on the H100 the kernels flip 3.2% at 8x256 and 12% at
# 8x512, PERF.md): each point within FWD_REL / BWD_REL but FULL_FLIPPED of
# them, every point within FULL_LOOSE, each weight gradient within
# FULL_WEIGHT_REL.
FULL_WIDTH_NEW = {
    "plain": ("8x256-L3D6", "8x512-L3D20-Lview20"),
    "interpret": ("8x256-L3D12", "4x384-skip2", "8x256-L3D6", "8x512-L3D20-Lview20"),
}
FULL_FLIPPED = 0.15
FULL_LOOSE = (5e-2, 0.3)  # forward outputs, point gradients
FULL_WEIGHT_REL = 5e-2


def _points_close(actual, expected, rel, what, full):
    """assert_points_close, or at the full width (FULL_WIDTH_NEW) its bounds
    there."""
    if not full:
        assert_points_close(actual, expected, rel, what)
        return
    a, b = (np.asarray(to_np(x), np.float64) for x in (actual, expected))
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    err = np.abs(a - b).max(axis=1) / max(float(np.abs(b).max()), 1e-12)
    flipped, loose = float((err > rel).mean()), FULL_LOOSE[0 if rel == FWD_REL else 1]
    assert err.max() <= loose and flipped <= FULL_FLIPPED, (
        f"{what}: {flipped:.3f} of the points past {rel}, worst {err.max():.3g} of scale")
# past the kernels' domain: a 640-wide layer, pts_enc 129 wide, view_enc 129 wide
PAST = {
    "640-wide": dict(layers_feat=(640,) * 4, layers_rgb=(32, 3), skip=(2,)),
    "L3D21": dict(L_3D=21),
    "Lview21": dict(L_view=21),
}


def _cases(chain, dtype, R, S=4):
    kw = dict(view_dep=True, barf_c2f=(0.2, 0.9), **CHAINS[chain][0])
    cfg_j = jmlp.MLPConfig(compute_dtype=DTYPES[dtype][1], **kw)
    cfg_t = tmlp.MLPConfig(compute_dtype=DTYPES[dtype][0], **kw)
    params_j = jmlp.init_nerf_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(R)
    # non-zero biases exercise the bias add
    params_j = jax.tree_util.tree_map(
        lambda x: x + (0.1 * rng.normal(size=x.shape).astype(np.float32) if x.ndim == 1 else 0),
        params_j)
    pts = rng.normal(size=(1, R, S, 3)).astype(np.float32)
    ray = rng.normal(size=(1, R, 3)).astype(np.float32)
    return cfg_j, cfg_t, params_j, pts, ray


def _loss(o, sin=torch.sin):
    return (o["rgb_samples"] ** 2).sum() + sin(o["density_samples"]).sum()


def _tpu_cfg(**tpu):
    return override_options(__graft_entry__._flagship_cfg(1), ConfigDict(dict(
        use_gt_correspondences=True, max_iter=100, tpu=ConfigDict(donate_state=False, **tpu),
        arch=dict(posenc=dict(L_3D=4, L_view=2)))))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_pallas", [True, False])
def test_use_pallas_picks_the_renderers_mlp(monkeypatch, use_pallas, dtype):
    """RenderConfig.from_config maps use_pallas to mlp_impl, and the
    renderer's MLP calls (per bundle and merged) go to that implementation
    only."""
    rcfg = tren.RenderConfig.from_config(_tpu_cfg(use_pallas=use_pallas, compute_dtype=dtype))
    assert rcfg.mlp_impl == ("fused" if use_pallas else "plain")
    assert rcfg.mlp.compute_dtype == DTYPES[dtype][0]
    called = []
    for mod, name, tag in ((fm, "nerf_apply_fused", "fused"), (tmlp, "nerf_apply", "plain")):
        def counted(*a, _f=getattr(mod, name), _tag=tag, **k):
            called.append(_tag)
            return _f(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    params = tmlp.init_nerf_params(torch.Generator().manual_seed(0), rcfg.mlp)
    gen = torch.Generator().manual_seed(1)
    center, ray = torch.randn(1, 5, 3, generator=gen), torch.randn(1, 5, 3, generator=gen)
    depths = torch.rand(1, 5, 6, 1, generator=gen) + 1.0
    out = tren.forward_samples(params, rcfg, center, ray, depths, 1.0)
    merged = tren._merged_mlp_level(params, rcfg, rcfg.mlp, [tren.RayBundle(None, None, None)],
                                    [(center, ray)], [depths], 1.0)
    assert called == [rcfg.mlp_impl] * 2
    for k in ("rgb_samples", "density_samples"):
        assert torch.equal(merged[0][k].reshape(out[k].shape), out[k])
    with pytest.raises(ValueError, match="unknown mlp_impl"):
        tren.mlp_apply(tren.RenderConfig(mlp=rcfg.mlp, mlp_impl="xla"))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chain", list(CHAINS))
def test_plain_mlp_matches_the_jax_xla_mlp(chain, dtype):
    """nerf_apply (use_pallas=False) against the JAX package's nerf_apply on
    chains at and past the kernels' widths: values and gradients at float32;
    at bfloat16 values per point, and the gradients of the chains at most
    150 wide. At 256 and 384 wide the two packages' float32 sums (XLA's and
    torch's CPU matmuls) round enough products to another bf16 value to move
    a weight gradient by 3.0e-3 to 1.7e-2 of its scale and a point's by up to
    3.0e-2 (measured here), past test_torch_bf16_kernels.py's bounds, as two
    correct sum orders do on the card (chip_smoke.py wide-check)."""
    bf16 = dtype == "bfloat16"
    full = chain in FULL_WIDTH_NEW["plain"]
    cfg_j, cfg_t, params_j, pts, ray = _cases(chain, dtype, R=11)

    def loss_j(p, x):
        return _loss(jmlp.nerf_apply(p, cfg_j, x, ray, jnp.asarray(0.8)), jnp.sin)

    out_j = jmlp.nerf_apply(params_j, cfg_j, pts, ray, jnp.asarray(0.8))
    l_j, (g_pj, g_xj) = jax.value_and_grad(loss_j, argnums=(0, 1))(params_j, pts)
    params_t = nerf_params_from_jax(to_np(params_j))
    leaves = fm.flat_weights(params_t)
    for w in leaves:
        w.requires_grad_(True)
    x = t(pts, requires_grad=True)
    out_t = tmlp.nerf_apply(params_t, cfg_t, x, t(ray), 0.8)
    l_t = _loss(out_t)
    l_t.backward()
    if bf16:
        for k in ("rgb_samples", "density_samples"):
            _points_close(out_t[k].reshape(-1, *out_t[k].shape[3:]),
                          np.reshape(out_j[k], (-1, *out_j[k].shape[3:])), FWD_REL, k, full)
        assert_close_scaled(l_t, l_j, LOSS_REL, what="loss")
        if chain in ("4x64-L3D12", "3x150"):
            assert_points_close(x.grad.reshape(-1, 3), np.reshape(g_xj, (-1, 3)), BWD_REL,
                                "d_pts")
            g_leaves = [g for layer in g_pj["feat"] + g_pj["rgb"] for g in layer]
            for i, (w, g) in enumerate(zip(leaves, g_leaves)):
                assert_close_scaled(w.grad, g, WEIGHT_REL, what=f"{'Wb'[i % 2]}{i // 2}")
        return
    assert_close(out_t["rgb_samples"], out_j["rgb_samples"], atol=1e-5)
    assert_close(out_t["density_samples"], out_j["density_samples"], atol=1e-5)
    assert_close(l_t, l_j, atol=0, rtol=1e-5)
    assert_close_scaled(x.grad, g_xj, D_PTS_REL, what="d_pts")
    g_leaves = [g for layer in g_pj["feat"] + g_pj["rgb"] for g in layer]
    for w, g in zip(leaves, g_leaves):
        assert_close(w.grad, g, atol=1e-4)


@pytest.mark.parametrize("iteration,stage", [(0, "joint"), (60, "fine")])
def test_use_pallas_false_step_matches_the_jax_xla_step(tmp_path, monkeypatch, iteration, stage):
    """A use_pallas=False step of the port's joint trainer (nerf_apply, never
    ops/fused_mlp) against the JAX trainer's step with the XLA MLP, held to
    tests/traced_draws.assert_one_step_matches's bounds."""
    cfg = _tpu_cfg(use_pallas=False)
    jt = JaxTrainer(cfg, workspace=str(tmp_path / "jax"))
    assert jt.mlp_impl == "xla"
    tt = TorchTrainer(cfg, workspace=str(tmp_path / "torch"), device="cpu",
                      initial_poses_w2c=np.asarray(jt.initial_poses_w2c))
    tt.state.nerf_params = nerf_params_from_jax(to_np(jt.state.nerf_params))
    tt.state.pose_params = pose_params_from_jax(to_np(jt.state.pose_params))
    assert tt.render_cfg.mlp_impl == "plain"
    assert (iteration < tt.iter_end_joint) == (stage == "joint")

    def not_called(*a, **k):
        raise AssertionError("use_pallas=False reached ops/fused_mlp")

    monkeypatch.setattr(fm, "nerf_apply_fused", not_called)
    assert_one_step_matches(jt, tt, iteration, monkeypatch)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chain", WIDE)
def test_wide_chains_plain_kernels_match_pallas_interpret(monkeypatch, chain, dtype):
    """K1 + K2 (FusedMLPFunction's plain versions on CPU tensors) and K3's
    plain version (on pack_weights' layout of the dtype: the 3xTF32
    fragments, or the bf16 kernels' forward layout) on the chains of the
    kernels' domain beside the presets', against the fused-VJP and the
    forward Pallas kernels in interpret mode."""
    bf16 = dtype == "bfloat16"
    full = chain in FULL_WIDTH_NEW["interpret"]
    fv = interpret_pallas(monkeypatch)
    R = 19
    cfg_j, cfg_t, params_j, pts, ray = _cases(chain, dtype, R)
    out_j = fv.nerf_apply_fused_vjp(params_j, cfg_j, pts, ray, jnp.asarray(0.8))
    l_j, (g_pj, g_xj) = jax.value_and_grad(
        lambda p, x: _loss(fv.nerf_apply_fused_vjp(p, cfg_j, x, ray, jnp.asarray(0.8)), jnp.sin),
        argnums=(0, 1))(params_j, pts)

    params_t = nerf_params_from_jax(to_np(params_j))
    weights = fm.flat_weights(params_t)
    for w in weights:
        w.requires_grad_(True)
    x = t(pts, requires_grad=True)
    out_t = fm.nerf_apply_fused(params_t, cfg_t, x, t(ray), 0.8)
    l_t = _loss(out_t)
    l_t.backward()
    g_leaves = [g for layer in g_pj["feat"] + g_pj["rgb"] for g in layer]
    if bf16:
        for k in ("rgb_samples", "density_samples"):
            _points_close(out_t[k].reshape(-1, *out_t[k].shape[3:]),
                          np.reshape(out_j[k], (-1, *out_j[k].shape[3:])), FWD_REL, k, full)
        assert_close_scaled(l_t, l_j, LOSS_REL, what="loss")
        _points_close(x.grad.reshape(-1, 3), np.reshape(g_xj, (-1, 3)), BWD_REL, "d_pts", full)
        for i, (w, g) in enumerate(zip(weights, g_leaves)):
            assert_close_scaled(w.grad, g, FULL_WEIGHT_REL if full else WEIGHT_REL,
                                what=f"{'Wb'[i % 2]}{i // 2}")
    else:
        assert_close(out_t["rgb_samples"], out_j["rgb_samples"], atol=1e-5)
        assert_close(out_t["density_samples"], out_j["density_samples"], atol=1e-5)
        assert_close(l_t, l_j, atol=0, rtol=1e-6)
        # test_torch_fused_mlp.py's 1e-4 is 4e-6 of its point gradients' scale
        # (25-31); the top PE frequency (2^11 pi at L_3D=12) lifts it to 147-804 here
        assert_close_scaled(x.grad, g_xj, D_PTS_REL, what="d_pts")
        for w, g in zip(weights, g_leaves):
            assert_close(w.grad, g, atol=1e-4)

    meta = fm.FusedMeta.from_cfg(cfg_t)
    # K3: the forward Pallas kernel on the encoded points
    xs = t(pts).reshape(-1, 3)
    pts_enc = tmlp.encode_points(cfg_t, xs, 0.8)
    rays = tmlp.unit_rays(t(ray))[:, :, None].expand(1, R, 4, 3).reshape(-1, 3)
    view_enc = tmlp.encode_views(cfg_t, rays, 0.8)
    dens_j, rgb_j = jfused.fused_mlp_forward(params_j, cfg_j, to_np(pts_enc), to_np(view_enc),
                                             interpret=True)
    with torch.no_grad():
        packed = fm.pack_weights(params_t, meta)
        dens_t, rgb_t = fm.fused_mlp_forward_packed_plain(meta, pts_enc, view_enc, packed)
    dims = tuple(meta.dims(weights))
    assert isinstance(packed, fm.PackedWeights if not bf16 and fm.tf32wg_layout(dims) is None
                      else fm.WgPackedWeights)
    if bf16:
        _points_close(dens_t[:, None], np.asarray(dens_j)[:, None], FWD_REL, "K3 density", full)
        _points_close(rgb_t, rgb_j, FWD_REL, "K3 rgb", full)
    else:
        assert_close(dens_t, dens_j, atol=1e-5)
        assert_close(rgb_t, rgb_j, atol=1e-5)


@pytest.mark.parametrize("chain", list(CHAINS) + list(PAST))
def test_bf16_k3_layout_takes_what_the_bf16_kernels_take(chain):
    """pack_weights at bfloat16 lays out every chain of the kernels' domain
    (wg_layout) and raises ValueError for the chains past it, on the CPU as
    k_wg_layout does on the card; at float32 the CPU packs every chain (the
    3xTF32 kernels' own limits are the C side's, chip_smoke.py routes)."""
    widths, takes = CHAINS[chain] if chain in CHAINS else (PAST[chain], False)
    for dtype in (torch.float32, torch.bfloat16):
        cfg = tmlp.MLPConfig(compute_dtype=dtype, **widths)
        params = tmlp.init_nerf_params(torch.Generator().manual_seed(0), cfg)
        meta = fm.FusedMeta.from_cfg(cfg)
        if dtype == torch.bfloat16 and not takes:
            with pytest.raises(ValueError, match="compute_dtype bfloat16"):
                fm.pack_weights(params, meta)
            continue
        packed = fm.pack_weights(params, meta)
        f32 = (fm.PackedWeights if fm.tf32wg_layout(tuple(fm.chain_dims(cfg))) is None
               else fm.WgPackedWeights)
        assert isinstance(packed, fm.WgPackedWeights if dtype == torch.bfloat16 else f32)


class _SizesLibrary:
    """The kernel library's three C sizes entries as `answers` (entry ->
    (rc, sizes)) give them, each call counted; no kernel behind them."""

    def __init__(self, answers):
        self.answers, self.asked = answers, []
        for name in answers:
            setattr(self, f"sparf_fused_mlp_{name}", self._entry(name))

    def _entry(self, name):
        def sizes_entry(c_dims, sizes):
            self.asked.append(name)
            rc, values = self.answers[name]
            sizes[:len(values)] = values
            return rc
        return sizes_entry


def _route_on(monkeypatch, answers):
    """fm.route on a _SizesLibrary of `answers`, with a cache of its own."""
    from sparf_tpu_torch.ops import _build

    lib = _SizesLibrary(answers)
    monkeypatch.setattr(_build, "load_library", lambda defines=(): lib)
    monkeypatch.setattr(fm, "route", functools.lru_cache(maxsize=64)(fm.route.__wrapped__))
    return lib


@pytest.mark.parametrize("rc", [-2, -4, -7])
def test_width_refusals_name_use_pallas_false(monkeypatch, rc):
    """A chain past the kernels' widths raises ValueError from its route,
    before any launch, naming the limit and the way to run it
    (use_pallas=False); other refusals name no way. -2 and -4 are the
    float32 sizes entry's width codes, -7 the bf16 one's."""
    dims, bf16 = tuple(fm.chain_dims(tmlp.MLPConfig())), rc == -7
    for refusal in (rc, -3):
        _route_on(monkeypatch, {"sizes_tf32": (refusal, ()), "wg_sizes": (refusal, ()),
                                "tf32wg_sizes": (0, ())})
        with pytest.raises(ValueError, match=r"the kernels take ") as err:
            fm.route(dims, bf16)
        assert ("cfg.tpu.use_pallas=False" in str(err.value)) == (refusal != -3)


def test_route_asks_each_sizes_entry_once_and_picks_k2(monkeypatch):
    """The route takes the float32 kernels on wgmma (K1, K2 and K3) where
    their sizes entry takes the chain, fused_mlp.cu's where it answers -7,
    the bf16 kernels at bfloat16, with the sizes of the entry that serves
    them (and at float32 fused_mlp.cu's); a chain's route asks each entry
    once."""
    dims = tuple(fm.chain_dims(tmlp.MLPConfig()))
    fp32, tfwg, wg = tuple(range(1, 8)), tuple(range(11, 20)), tuple(range(21, 30))
    for tf32wg_rc, impl in ((0, "tf32wg"), (-7, "tf32")):
        lib = _route_on(monkeypatch, {"sizes_tf32": (0, fp32), "wg_sizes": (0, wg),
                                      "tf32wg_sizes": (tf32wg_rc, tfwg)})
        r = fm.route(dims, False)
        assert (r.dims, r.bf16, r.impl, r.tf32_sizes) == (dims, False, impl, fp32)
        assert r.sizes == (tfwg if impl == "tf32wg" else fp32)
        assert list(r.c_dims) == list(dims)
        r_bf16 = fm.route(dims, True)
        assert (r_bf16.impl, r_bf16.sizes, r_bf16.tf32_sizes) == ("wg", wg, ())
        assert fm.route(dims, False) is r and fm.route(dims, True) is r_bf16
        assert sorted(lib.asked) == ["sizes_tf32", "tf32wg_sizes", "wg_sizes"]
