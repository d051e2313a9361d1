"""The data layouts of the float32 K2 on wgmma (csrc/fused_mlp_wgmma.cu:
k_tf_layout, k2_tf, k2_dw_tf), through their plain versions in
ops/fused_mlp.py, on numpy-made weights and inputs at tiny T: the presets'
8x256 chain (skip at 4, the 128-wide view head), a narrow chain and a chain
without a skip.

- `tf32wg_weights_plain` (the weights in the layouts the TMA maps read; the
  kernel `k_tf_layout` is held to it bit for bit on the card by
  chip_smoke.py): hi + lo rebuilds W exactly, hi is the TF32
  round-to-nearest of W (as `k_pack` splits it), bias_f holds b, and every
  padding position holds zeros.
- `tf32wg_workspace_plain` (what K2's first pass stores for the dW pass):
  X's rows are every layer's input, G's rows every g_z, exactly, each row
  point-contiguous; the dW products and db sums taken from them equal the
  plain K2's weight gradients to float32 summation order.
- `tf32wg_layout` (build_tf_desc's mirror) sends these chains to the new
  kernels, and a chain to them exactly where the bf16 plan M takes it; the
  rest keep fused_mlp.cu's K2.
"""
import numpy as np
import pytest
import torch

from sparf_tpu_torch.models import nerf_mlp as tmlp
from sparf_tpu_torch.ops import fused_mlp as fm

PRESETS = dict()  # the 8x256 chain, skip at 4, the 128-wide view head
NARROW = dict(layers_feat=(64,) * 4, layers_rgb=(32, 3), skip=(2,), L_3D=6, L_view=2)
NO_SKIP = dict(layers_feat=(128,) * 3, layers_rgb=(64, 3), skip=())
CASES = [(PRESETS, True), (NARROW, True), (NO_SKIP, False)]
IDS = ["presets", "narrow", "no-skip"]
SUM_REL = 1e-5  # float32 summation order, of the largest magnitude


def _chain(widths, view_dep, T=200, seed=0):
    cfg = tmlp.MLPConfig(view_dep=view_dep, **widths)
    meta = fm.FusedMeta.from_cfg(cfg)
    rng = np.random.RandomState(seed)
    n_feat = len(cfg.layers_feat)
    weights = []
    d_in, d_view, prev = cfg.input_3d_dim, cfg.input_view_dim, cfg.input_3d_dim
    for li, out in enumerate(list(cfg.layers_feat) + list(cfg.layers_rgb)):
        if li == n_feat - 1:
            out += 1  # the density unit
        n_in = prev + (d_in if (0 < li < n_feat and li in cfg.skip) else 0)
        n_in += d_view if (li == n_feat and view_dep) else 0
        weights.append(torch.tensor(rng.randn(out, n_in) / np.sqrt(n_in), dtype=torch.float32))
        weights.append(torch.tensor(rng.randn(out) * 0.1, dtype=torch.float32))
        prev = out - (1 if li == n_feat - 1 else 0)
    pts = torch.tensor(rng.randn(T, d_in), dtype=torch.float32)
    view = torch.tensor(rng.randn(T, d_view), dtype=torch.float32)
    g_d = torch.tensor(rng.randn(T), dtype=torch.float32)
    g_rgb = torch.tensor(rng.randn(T, 3), dtype=torch.float32)
    return meta, weights, pts, view, g_d, g_rgb


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("widths,view_dep", CASES, ids=IDS)
def test_tf32wg_weights_hi_lo_rebuild_w(widths, view_dep):
    meta, weights, *_ = _chain(widths, view_dep)
    dims = meta.dims(weights)
    lay = fm.tf32wg_layout(tuple(dims))
    wf, wt, bias_f = fm.tf32wg_weights_plain(dims, weights)
    assert wf.shape == (2 * lay.RF, lay.KF) and wt.shape == (2 * lay.RT, lay.KT)
    for hi, lo in ((wf[: lay.RF], wf[lay.RF:]), (wt[: lay.RT], wt[lay.RT:])):
        assert torch.equal(_bits(fm.tf32_round(hi)), _bits(hi))  # hi is a TF32 value
        assert torch.equal(_bits(fm.tf32_round(hi + lo)), _bits(hi))  # the nearest one
        assert torch.all(lo.abs() <= hi.abs() * 2.0 ** -11)
    full_f, full_t = wf[: lay.RF] + wf[lay.RF:], wt[: lay.RT] + wt[lay.RT:]
    seen_f = torch.zeros_like(full_f, dtype=torch.bool)
    seen_t = torch.zeros_like(full_t, dtype=torch.bool)
    for L, W, b in zip(lay.layers, weights[::2], weights[1::2]):
        i = L.inputs()
        cols = torch.nonzero(i >= 0).reshape(-1)
        if L.nm:  # the forward rows: the features (the density unit is not recomputed)
            u = L.forward_units()
            rows = torch.nonzero(u >= 0).reshape(-1)
            assert torch.equal(_bits(full_f[L.rf + rows][:, cols]), _bits(W[u[rows]][:, i[cols]]))
            assert torch.equal(_bits(bias_f[L.rf + rows]), _bits(b[u[rows]]))
            seen_f[(L.rf + rows)[:, None], cols[None, :]] = True
            assert rows.numel() == L.out - L.dens
        u = L.gz_units()
        gcols = torch.nonzero(u >= 0).reshape(-1)
        assert gcols.numel() == L.out  # every output, the density unit at column nm
        assert torch.equal(_bits(full_t[L.rt + cols][:, gcols]), _bits(W[u[gcols]][:, i[cols]].t()))
        seen_t[(L.rt + cols)[:, None], gcols[None, :]] = True
        assert torch.equal(full_t[L.rt + torch.nonzero(i < 0).reshape(-1)],
                           torch.zeros_like(full_t[L.rt + torch.nonzero(i < 0).reshape(-1)]))
    assert not torch.any(full_f[~seen_f]) and not torch.any(full_t[~seen_t])
    assert int(seen_f.sum()) == sum(int(W.numel()) for W in weights[:-2:2]) - lay.layers[
        meta.n_feat - 1].n_in  # every weight but the last layer's and the density unit's
    assert int(seen_t.sum()) == sum(int(W.numel()) for W in weights[::2])


@pytest.mark.parametrize("widths,view_dep", CASES, ids=IDS)
def test_tf32wg_workspace_holds_the_operands_of_dw(widths, view_dep):
    meta, weights, pts, view, g_d, g_rgb = _chain(widths, view_dep, T=200)
    lay = fm.tf32wg_layout(tuple(meta.dims(weights)))
    X, G, masks = fm.tf32wg_workspace_plain(meta, pts, view, weights, g_d, g_rgb)
    T, x_rows = pts.shape[0], 256
    assert X.shape == (lay.NX, x_rows) and G.shape == (lay.NG, x_rows)
    assert not torch.any(X[:, T:]) and not torch.any(G[:, T:])
    _, _, xs = fm._forward_chain(meta, pts, view, weights)
    g_zs = []
    _, _, grads = fm.fused_mlp_backward_plain(meta, pts, view, weights, g_d, g_rgb, g_zs=g_zs)
    for li, (L, x_ref, g_ref) in enumerate(zip(lay.layers, xs, g_zs)):
        seg1 = X[L.x1: L.x1 + L.w1, :T]
        segs = [seg1] + ([X[L.x2: L.x2 + L.w2, :T]] if L.w2 else [])
        x_l = torch.cat(segs)  # the layer's input, a row per input column
        assert torch.equal(_bits(x_l.t()), _bits(x_ref))
        u = L.dw_units()[: L.out]  # G's rows: the outputs, the density unit last
        g_l = G[L.go: L.go + L.out, :T]
        assert torch.equal(_bits(g_l.t()), _bits(g_ref[:, u]))
        dW, db = g_l @ x_l.t(), g_l.sum(dim=1)
        for got, ref in ((dW, grads[2 * li][u]), (db, grads[2 * li + 1][u])):
            assert float((got - ref).abs().max()) <= SUM_REL * float(ref.abs().max())
        if li > 0:  # the ReLU mask words of the layer's input, as the bf16 plan M keeps them
            assert torch.equal(masks[li], fm.relu_mask_words_plain(x_ref[:, : L.w1]))


# chains past the bf16 plan M: pts_enc 75 wide, view_enc 75 wide, features
# padded to 192, 384 and 512 features
PAST = {"L_3D=12": dict(L_3D=12), "L_view=12": dict(L_view=12),
        "3x150": dict(layers_feat=(150,) * 3, layers_rgb=(32, 3), skip=()),
        "4x384": dict(layers_feat=(384,) * 4, skip=(2,)),
        "8x512": dict(layers_feat=(512,) * 8)}


@pytest.mark.parametrize("widths,view_dep", CASES, ids=IDS)
def test_tf32wg_layout_takes_the_chain(widths, view_dep):
    dims = fm.chain_dims(tmlp.MLPConfig(view_dep=view_dep, **widths))
    lay = fm.tf32wg_layout(tuple(dims))
    assert lay is not None and fm.wg_layout(tuple(dims)).tile == fm.WG_TILE
    # the stages and the tile's buffer hold every product
    assert all(L.nm in (0, 64, 128, 256) and L.k1p in (64, 128, 256) and L.c2 in (0, 32, 64)
               for L in lay.layers)


@pytest.mark.parametrize("widths", list(PAST.values()), ids=list(PAST))
def test_tf32wg_layout_leaves_the_rest_to_fused_mlp_cu(widths):
    dims = tuple(fm.chain_dims(tmlp.MLPConfig(view_dep=True, **widths)))
    assert fm.tf32wg_layout(dims) is None
    assert fm.wg_layout(dims).tile == 64  # the bf16 kernels' plan N: not plan M either


def test_tf32wg_layout_takes_exactly_the_plan_m_chains():
    widths = (1, 8, 31, 32, 33, 63, 64, 65, 100, 128, 129, 150, 192, 193, 200, 255, 256, 257, 300)
    chains = ([dict(layers_feat=(w,) * 4, skip=(2,)) for w in widths]
              + [dict(layers_rgb=(w, 3)) for w in widths]
              + [dict(L_3D=L, L_view=L) for L in (0, 4, 10, 11)])
    for over in chains:
        for view_dep in (True, False):
            dims = tuple(fm.chain_dims(tmlp.MLPConfig(view_dep=view_dep, **over)))
            plan_m = isinstance(fm._wg_plan(dims, False), fm.WgLayout)
            assert (fm.tf32wg_layout(dims) is not None) == plan_m, (over, view_dep)
