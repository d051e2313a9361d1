"""The fused NeRF-MLP op of sparf_tpu_torch (ops/fused_mlp.py, kernels K1/K2).

On the CPU, FusedMLPFunction runs its plain versions; they are held against
the JAX fused custom-VJP in Pallas interpret mode (forward within 1e-5,
parameter and point gradients within 1e-4, as tests/test_ops.py holds the
Pallas kernels), and K2's plain algorithm against torch autograd. The CUDA
kernels themselves are checked on the card by chip_smoke.py, at the full width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, interpret_pallas, mlp_chain, mm_3xtf32, mm_tf32, t,
                          tf32, to_np)

from sparf_tpu.models import nerf_mlp as jmlp
from sparf_tpu_torch.convert import nerf_params_from_jax
from sparf_tpu_torch.models import nerf_mlp as tmlp
from sparf_tpu_torch.ops import fused_mlp as fm

SMALL = dict(layers_feat=(64,) * 5, layers_rgb=(32, 3), skip=(2,), L_3D=6, L_view=2)


def _loss_j(apply_fn, cfg, p, pts, ray):
    o = apply_fn(p, cfg, pts, ray, jnp.asarray(0.8))
    return jnp.sum(o["rgb_samples"] ** 2) + jnp.sum(jnp.sin(o["density_samples"]))


@pytest.mark.parametrize("view_dep", [True, False])
@pytest.mark.parametrize("R", [13, 19])  # odd T = R * 4 exercises the ragged tile
def test_fused_function_matches_pallas_vjp(monkeypatch, view_dep, R):
    fv = interpret_pallas(monkeypatch)
    cfg_j = jmlp.MLPConfig(view_dep=view_dep, barf_c2f=(0.2, 0.9), **SMALL)
    cfg_t = tmlp.MLPConfig(view_dep=view_dep, barf_c2f=(0.2, 0.9), **SMALL)
    params_j = jmlp.init_nerf_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(R)
    pts = rng.normal(size=(1, R, 4, 3)).astype(np.float32)
    ray = rng.normal(size=(1, R, 3)).astype(np.float32)

    out_j = fv.nerf_apply_fused_vjp(params_j, cfg_j, pts, ray, jnp.asarray(0.8))
    l_j, (g_pj, g_xj) = jax.value_and_grad(
        lambda p, x: _loss_j(fv.nerf_apply_fused_vjp, cfg_j, p, x, ray), argnums=(0, 1)
    )(params_j, pts)

    launches = (fm.K1_LAUNCHES, fm.K2_LAUNCHES)
    params_t = nerf_params_from_jax(to_np(params_j))
    weights = fm.flat_weights(params_t)
    for w in weights:
        w.requires_grad_(True)
    x = t(pts, requires_grad=True)
    out_t = fm.nerf_apply_fused(params_t, cfg_t, x, t(ray), 0.8)
    assert_close(out_t["rgb_samples"], out_j["rgb_samples"], atol=1e-5)
    assert_close(out_t["density_samples"], out_j["density_samples"], atol=1e-5)
    l_t = torch.sum(out_t["rgb_samples"] ** 2) + torch.sum(torch.sin(out_t["density_samples"]))
    l_t.backward()
    assert_close(l_t, l_j, atol=0, rtol=1e-6)
    assert_close(x.grad, g_xj, atol=1e-4)
    g_leaves = [g for layer in g_pj["feat"] + g_pj["rgb"] for g in layer]
    for w, g in zip(weights, g_leaves):
        assert_close(w.grad, g, atol=1e-4)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (fm.K1_LAUNCHES, fm.K2_LAUNCHES) == launches


@pytest.mark.parametrize("view_dep", [True, False])
def test_backward_plain_matches_autograd(view_dep):
    """K2's algorithm (recompute, masks from the next layer's input, skip and
    view split) against torch autograd through the plain chain."""
    cfg = tmlp.MLPConfig(view_dep=view_dep, **SMALL)
    gen = torch.Generator().manual_seed(0)
    weights = fm.flat_weights(tmlp.init_nerf_params(gen, cfg))
    for i in range(1, len(weights), 2):
        weights[i].normal_(0.0, 0.1, generator=gen)
    T = 37
    pts_enc = tmlp.encode_points(cfg, torch.randn(T, 3, generator=gen), 1.0)
    view_enc = (tmlp.encode_views(cfg, torch.randn(T, 3, generator=gen), 1.0) if view_dep
                else torch.zeros(T, 0))
    g_d, g_rgb = torch.randn(T, generator=gen), torch.randn(T, 3, generator=gen)
    meta = fm.FusedMeta.from_cfg(cfg)
    d_pts, d_view, grads = fm.fused_mlp_backward_plain(meta, pts_enc, view_enc, weights, g_d,
                                                       g_rgb)
    leaves = [x.clone().requires_grad_(True) for x in (pts_enc, view_enc, *weights)]
    d, rgb = fm.fused_mlp_forward_plain(meta, leaves[0], leaves[1], leaves[2:])
    ref = torch.autograd.grad((d * g_d).sum() + (rgb * g_rgb).sum(), leaves, allow_unused=True)
    assert_close(d_pts, ref[0], atol=1e-5)
    if view_dep:
        assert_close(d_view, ref[1], atol=1e-5)
    for g, r in zip(grads, ref[2:]):
        assert_close(g, r, atol=1e-5)


def test_meta_dims_and_cuda_only_dispatch():
    cfg = tmlp.MLPConfig()
    meta = fm.FusedMeta.from_cfg(cfg)
    weights = fm.flat_weights(tmlp.init_nerf_params(torch.Generator().manual_seed(0), cfg))
    dims = meta.dims(weights)
    assert dims[:5] == [8, 2, 63, 27, 1]
    per_layer = np.array(dims[5:]).reshape(-1, 3)
    assert per_layer[4].tolist() == [256, 319, 1]   # skip layer: [feat | pts_enc]
    assert per_layer[7].tolist() == [257, 256, 0]   # density unit + 256 features
    assert per_layer[8].tolist() == [128, 283, 0]   # [feat | view_enc]
    with pytest.raises(ValueError):
        fm.fused_mlp_forward(meta, torch.zeros(4, 63, device="meta"),
                             torch.zeros(4, 27, device="meta"), weights)



# ---------------------------------------------------------------------------
# K3: forward-only chain on packed weights
# ---------------------------------------------------------------------------

FULL = dict(barf_c2f=(0.3, 0.7))  # the 8x256 arch with skip at 4


@pytest.mark.parametrize("view_dep", [True, False])
def test_pack_weights_round_trips(view_dep):
    """pack_weights lays each W out as mma.sync B fragments of hi = TF32(w),
    lo = w - hi; hi + lo gives W back exactly, and the fragment (ks, nt),
    lane (g, t), float c holds B[ks*8 + t + 4 (c % 2), nt*8 + g]."""
    cfg = tmlp.MLPConfig(view_dep=view_dep)
    meta = fm.FusedMeta.from_cfg(cfg)
    params = tmlp.init_nerf_params(torch.Generator().manual_seed(1), cfg)
    weights = fm.flat_weights(params)
    packed = fm.pack_weights(params, meta)
    assert list(packed.dims) == meta.dims(weights)
    assert all(torch.equal(b, w) for b, w in zip(packed.biases, weights[1::2]))
    f4 = packed.frag.view(-1, 4)
    assert torch.equal(fm.tf32_round(f4[:, :2]), f4[:, :2])  # the high parts are TF32 values
    assert float(f4[:, 2:].abs().max()) <= 2.0 ** -11 * float(f4[:, :2].abs().max())
    for W, Wu in zip(weights[::2], fm.unpack_fragments(packed.dims, packed.frag)):
        assert torch.equal(Wu, W)
    # layer 0 (63 inputs padded to 64, 256 outputs): k-step 7, n-tile 3, lane 9 (g=2, t=1)
    frag0 = f4[: (64 // 8) * (256 // 8) * 32].view(8, 32, 32, 4)
    w = weights[0][3 * 8 + 2, 7 * 8 + 1]
    assert frag0[7, 3, 9, 0] == fm.tf32_round(w) and frag0[7, 3, 9, 2] == w - fm.tf32_round(w)
    assert frag0[7, 3, 11, 1] == 0  # lane 11: t=3, row 7*8 + 3 + 4 = 63 is padding
    # the transposed set (K2's g_x) holds the same values in B = W order
    ft = fm.pack_fragments_plain(packed.dims, weights, transposed=True)
    assert ft.numel() == packed.frag.numel()
    assert torch.equal(torch.sort(ft).values, torch.sort(packed.frag).values)
    # the skip layer (4) keeps its [feat | pts_enc] order: k-step 32 starts pts_enc
    ofs = sum(kp // 8 * np8 // 8 * 128 for *_, kp, np8 in list(fm._layers(packed.dims))[:4])
    frag4 = packed.frag[ofs: ofs + 320 // 8 * 256 // 8 * 128].view(40, 32, 32, 4)
    w = weights[8][0 * 8 + 0, 256]
    assert frag4[32, 0, 0, 0] == fm.tf32_round(w)


@pytest.mark.parametrize("widths", [
    dict(layers_feat=(104,) * 4, layers_rgb=(32, 3), skip=(2,), L_3D=8),
    dict(layers_feat=(48,) * 4, layers_rgb=(40, 3), skip=(2,), L_view=8),
    dict(layers_feat=(200,) * 3, layers_rgb=(56, 3), skip=(1,), L_3D=7),
    dict(layers_feat=(512,) * 3, layers_rgb=(128, 3), skip=(1,), L_3D=20, L_view=20),
], ids=["w104-L3D8", "w48-Lview8", "w200-L3D7", "w512"])
def test_pack_fragments_round_trip_past_four_extra_n_tiles(widths):
    """Chains whose padded widths run 5-7 n-tiles (or k-steps) past a
    multiple of 8 (pts_enc 51 wide padded to 56, 104 features to 13
    n-tiles, 48 to 6, a 201-wide density layer to 26, view_enc 51 wide), and
    the wide plan's corner (512 features, both encodings 123 wide): hi + lo
    of the forward fragments gives W back exactly, and the transposed set
    holds the same values."""
    cfg = tmlp.MLPConfig(**widths)
    meta = fm.FusedMeta.from_cfg(cfg)
    params = tmlp.init_nerf_params(torch.Generator().manual_seed(2), cfg)
    weights = fm.flat_weights(params)
    packed = fm.pack_weights(params, meta)
    layers = list(fm._layers(packed.dims))
    past4 = [x // 8 % 8 for *_, k1p, kp, n_pad in layers for x in (k1p, kp - k1p, n_pad)]
    assert max(past4) >= 5 or max(n_pad for *_, n_pad in layers) == 520
    assert packed.frag.numel() == 4 * sum(kp // 8 * n_pad // 8 * 32 for *_, kp, n_pad in layers)
    for W, Wu in zip(weights[::2], fm.unpack_fragments(packed.dims, packed.frag)):
        assert torch.equal(Wu, W)
    ft = fm.pack_fragments_plain(packed.dims, weights, transposed=True)
    assert torch.equal(torch.sort(ft).values, torch.sort(packed.frag).values)


def test_tf32_round_is_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -11 + 2 ** -20, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12, 3.14159265])
    r = fm.tf32_round(x)
    assert r.tolist()[:5] == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0]
    assert abs(float(r[5]) - 3.14159265) <= 2 ** -11 * 4
    assert torch.equal(fm.tf32_round(r), r)


@pytest.mark.parametrize("view_dep", [True, False])
@pytest.mark.parametrize("arch", ["small", "full"])
def test_packed_plain_matches_pallas_k3(view_dep, arch):
    """K3's plain version against the JAX fused forward (sparf_tpu/ops/fused_mlp.py,
    interpret mode) at the sizes tests/test_ops.py uses, within 1e-5."""
    from sparf_tpu.ops import fused_mlp as jfused

    kw, (B, R, S) = (dict(SMALL, layers_feat=(64,) * 4), (2, 19, 8)) if arch == "small" \
        else (FULL, (1, 7, 4))
    cfg_j = jmlp.MLPConfig(view_dep=view_dep, **kw)
    cfg_t = tmlp.MLPConfig(view_dep=view_dep, **kw)
    params_j = jmlp.init_nerf_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(B * R * S)
    pts = rng.normal(size=(B * R * S, 3)).astype(np.float32)
    rays = rng.normal(size=(B * R * S, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    pts_enc = jmlp.encode_points(cfg_j, jnp.asarray(pts), jnp.asarray(0.45))
    view_enc = (jmlp.encode_views(cfg_j, jnp.asarray(rays), jnp.asarray(0.45)) if view_dep
                else jnp.zeros((B * R * S, 1)))
    dens_j, rgb_j = jfused.fused_mlp_forward(params_j, cfg_j, pts_enc, view_enc, interpret=True)

    meta = fm.FusedMeta.from_cfg(cfg_t)
    packed = fm.pack_weights(nerf_params_from_jax(to_np(params_j)), meta)
    view_t = t(view_enc) if view_dep else torch.zeros((B * R * S, 0))
    launches = fm.K3_LAUNCHES
    dens_t, rgb_t = fm.fused_mlp_forward_packed(meta, t(pts_enc), view_t, packed)
    assert fm.K3_LAUNCHES == launches  # CPU tensors take the plain version
    assert_close(dens_t, dens_j, atol=1e-5)
    assert_close(rgb_t, rgb_j, atol=1e-5)


def test_nerf_apply_takes_k3_exactly_when_nothing_requires_grad(monkeypatch):
    cfg = tmlp.MLPConfig(**SMALL)
    params = tmlp.init_nerf_params(torch.Generator().manual_seed(2), cfg)
    gen = torch.Generator().manual_seed(3)
    pts, ray = torch.randn(1, 5, 4, 3, generator=gen), torch.randn(1, 5, 3, generator=gen)
    taken = []
    real_fn, real_k3 = fm.FusedMLPFunction.apply, fm.fused_mlp_forward_packed
    monkeypatch.setattr(fm.FusedMLPFunction, "apply",
                        lambda *a: taken.append("K1/K2") or real_fn(*a))
    monkeypatch.setattr(fm, "fused_mlp_forward_packed",
                        lambda *a: taken.append("K3") or real_k3(*a))

    def path(weights_grad, pts_grad, grad_mode):
        taken.clear()
        for W, _ in params["feat"] + params["rgb"]:
            W.requires_grad_(weights_grad)
        with torch.set_grad_enabled(grad_mode):
            out = fm.nerf_apply_fused(params, cfg, pts.clone().requires_grad_(pts_grad), ray, 1.0)
        (which,) = taken
        return which, out

    which, ref = path(False, False, True)
    assert which == "K3"
    assert path(False, False, False)[0] == "K3"
    assert path(True, False, False)[0] == "K3"
    assert path(False, True, False)[0] == "K3"
    for weights_grad, pts_grad in ((True, False), (False, True), (True, True)):
        which, out = path(weights_grad, pts_grad, True)
        assert which == "K1/K2"
        assert_close(out["rgb_samples"], ref["rgb_samples"], atol=1e-6)
        assert_close(out["density_samples"], ref["density_samples"], atol=1e-6)


# ---------------------------------------------------------------------------
# the numerics of the tensor-core kernels: 3xTF32
# ---------------------------------------------------------------------------


def _full_width_case(view_dep, T=512, seed=0):
    """The 8x256 chain with numpy-made weights, inputs and output gradients."""
    cfg = tmlp.MLPConfig(view_dep=view_dep, barf_c2f=(0.4, 0.7))
    meta = fm.FusedMeta.from_cfg(cfg)
    rng = np.random.RandomState(seed)
    weights = []
    for W in fm.flat_weights(tmlp.init_nerf_params(torch.Generator().manual_seed(seed), cfg))[::2]:
        n_out, n_in = W.shape
        weights += [t(rng.normal(size=(n_out, n_in)) * np.sqrt(2.0 / n_in)),
                    t(rng.normal(size=n_out) * 0.1)]
    pts_enc = tmlp.encode_points(cfg, t(rng.normal(size=(T, 3)) * 1.5), 0.55)
    rays = tmlp.unit_rays(t(rng.normal(size=(T, 3))))
    view_enc = tmlp.encode_views(cfg, rays, 0.55) if view_dep else torch.zeros(T, 0)
    return meta, pts_enc, view_enc, weights, t(rng.normal(size=T)), t(rng.normal(size=(T, 3)))


def _rel(a, b):
    return float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-30) if b.numel() else 0.0


@pytest.mark.parametrize("view_dep", [True, False])
def test_3xtf32_products_meet_the_kernels_bounds(view_dep):
    """The chain with every product in 3xTF32 (hi*hi + hi*lo + lo*hi) against
    the float64 chain at the full 8x256 width, T=512: forward within 1e-5 of
    the largest output, every gradient within 1e-4 of its own largest
    magnitude, the bounds tests/test_ops.py holds the Pallas kernels to (and
    chip_smoke.py, looser, the CUDA kernels). Points with a pre-activation
    within 1e-4 of 0 get no output gradient: their ReLU masks may flip
    between two roundings. One TF32 pass misses the forward bound."""
    meta, pts_enc, view_enc, weights, g_d, g_rgb = _full_width_case(view_dep)
    d64 = [x.double() for x in (pts_enc, view_enc, *weights)]
    dens_r, rgb_r, _, zmin = mlp_chain(meta, d64[0], d64[1], d64[2:], g_d.double(),
                                       g_rgb.double(), torch.matmul)
    keep = (zmin >= 1e-4).float()
    assert 0.3 < float(keep.mean()) < 1.0
    g_d, g_rgb = g_d * keep, g_rgb * keep[:, None]
    _, _, ref, _ = mlp_chain(meta, d64[0], d64[1], d64[2:], g_d.double(), g_rgb.double(),
                             torch.matmul)
    dens, rgb, grads, _ = mlp_chain(meta, pts_enc, view_enc, weights, g_d, g_rgb, mm_3xtf32)
    assert max(_rel(dens, dens_r), _rel(rgb, rgb_r)) <= 1e-5
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert _rel(g, r) <= 1e-4, i
    dens1, rgb1, grads1, _ = mlp_chain(meta, pts_enc, view_enc, weights, g_d, g_rgb, mm_tf32)
    assert max(_rel(dens1, dens_r), _rel(rgb1, rgb_r)) > 1e-5
    assert max(_rel(g, r) for g, r in zip(grads1, ref)) > 1e-4


def test_tf32_emulations_agree():
    """The test emulation's rounding and the port's (pack_fragments_plain's),
    two implementations of cvt.rna.tf32.f32, give the same bits."""
    scale = 10.0 ** np.random.RandomState(1).randint(-20, 20, 4096)
    x = torch.from_numpy((np.random.RandomState(0).normal(size=4096) * scale).astype(np.float32))
    assert torch.equal(tf32(x), fm.tf32_round(x))
