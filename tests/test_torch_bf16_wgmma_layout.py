"""The data layouts of the bf16 K1 / K2 on wgmma (csrc/fused_mlp_wgmma.cu),
through their plain versions in ops/fused_mlp.py, on numpy-made weights and
inputs at small widths, at the full 8x256 chain (plan M, 128-point tiles)
and at chains of plan N (64-point tiles, each warpgroup half of every
product): pts_enc and view_enc in two chunks, features padded to 192, 384
and 512.

- `wgmma_layout_plain` (the weights in the layouts the TMA maps read; the
  kernel `k_wg_layout` is held to it bit for bit on the card by
  chip_smoke.py) round-trips to bf16(W) and b exactly, with zeros in every
  padding position.
- `bf16_workspace_plain` (what K2's first pass stores) holds exactly the
  operands the plain dW reads: every layer's input and g_z rounded to bf16;
  the dW products taken from it equal the plain K2's weight gradients, and
  db summed from its partials per 64 points of the unrounded g_z equals the plain
  db, both to float32 summation order (1e-5 of scale).
- The ReLU masks K2 keeps for its backward (each thread's bits of its
  accumulator fragment, `relu_mask_words_plain`) are the float32 X > 0, also
  where bf16(X) is 0.

The plain bf16 K2 itself is held to the Pallas kernels in interpret mode by
tests/test_torch_bf16_kernels.py.
"""
import numpy as np
import pytest
import torch

from sparf_tpu_torch.models import nerf_mlp as tmlp
from sparf_tpu_torch.ops import fused_mlp as fm

SMALL = dict(layers_feat=(64,) * 5, layers_rgb=(32, 3), skip=(2,), L_3D=6, L_view=2)
FULL = dict()  # the 8x256 chain with the 128-wide view head
# plan N: pts_enc and view_enc 75 wide (two chunks each); 150 features
# (padded to 192); 384; 512 with both encodings 123 wide
ENC2 = dict(layers_feat=(64,) * 4, layers_rgb=(32, 3), skip=(2,), L_3D=12, L_view=12)
W192 = dict(layers_feat=(150,) * 3, layers_rgb=(32, 3), skip=())
W384 = dict(layers_feat=(384,) * 4, layers_rgb=(64, 3), skip=(2,), L_3D=4, L_view=2)
W512 = dict(layers_feat=(512,) * 3, layers_rgb=(128, 3), skip=(1,), L_3D=20, L_view=20)
CASES = [(SMALL, True), (SMALL, False), (FULL, True), (ENC2, True), (ENC2, False),
         (W192, True), (W384, True), (W512, True)]
IDS = ["small-view", "small", "full-view", "enc2-view", "enc2", "w192-view", "w384-view",
       "w512-view"]
SUM_REL = 1e-5  # float32 summation order, of the largest magnitude


def _chain(widths, view_dep, T=300, seed=0):
    cfg = tmlp.MLPConfig(view_dep=view_dep, compute_dtype=torch.bfloat16, **widths)
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


@pytest.mark.parametrize("widths,view_dep", CASES, ids=IDS)
def test_wgmma_layout_round_trips_to_w(widths, view_dep):
    meta, weights, *_ = _chain(widths, view_dep)
    dims = meta.dims(weights)
    wf, wt, bias_f = fm.wgmma_layout_plain(dims, weights)
    lay = fm.wg_layout(tuple(dims))
    assert lay.tile == (128 if widths in (SMALL, FULL) else 64)
    assert wf.shape == (lay.RF, lay.KF) and wt.shape == (lay.RT, lay.KT)
    assert wf.dtype == wt.dtype == torch.bfloat16
    n_nonzero = 0
    for (W_f, W_t, b), W, b_ref in zip(fm.unpack_wgmma_layout(dims, wf, wt, bias_f),
                                       weights[::2], weights[1::2]):
        ref = W.to(torch.bfloat16).float()
        assert torch.equal(W_f, ref) and torch.equal(W_t, ref)
        assert torch.equal(b, b_ref)
        n_nonzero += int((ref != 0).sum())
    # nothing but the weights: every padding position holds a zero
    assert int((wf != 0).sum()) == int((wt != 0).sum()) == n_nonzero
    assert int((bias_f != 0).sum()) == sum(int((b != 0).sum()) for b in weights[1::2])
    # the density unit sits behind the features' rows of the last trunk layer
    L = lay.layers[meta.n_feat - 1]
    assert L.dens and torch.equal(wf[L.rf + L.nm, : L.w1].float(),
                                  weights[2 * meta.n_feat - 2][0].to(torch.bfloat16).float())


@pytest.mark.parametrize("widths,view_dep", CASES, ids=IDS)
def test_bf16_workspace_holds_the_operands_of_dw(widths, view_dep):
    meta, weights, pts, view, g_d, g_rgb = _chain(widths, view_dep, T=300 if widths else 200)
    T = pts.shape[0]
    X, G, masks, db_part = fm.bf16_workspace_plain(meta, pts, view, weights, g_d, g_rgb)
    g_zs = []
    _, _, grads = fm.fused_mlp_backward_plain(meta, pts, view, weights, g_d, g_rgb, g_zs=g_zs)
    _, _, xs = fm._forward_chain(meta, pts, view, weights)
    lay = fm.wg_layout(tuple(meta.dims(weights)))
    assert X.shape == (384 if T == 300 else 256, lay.KX) and G.shape[1] == lay.KG
    assert masks.shape == (len(lay.layers), X.shape[0] // lay.tile, 256, 4)
    assert not X[T:].float().abs().sum() and not G[T:].float().abs().sum()
    for li, (L, x, g) in enumerate(zip(lay.layers, xs, g_zs)):
        Xl = X[:T, L.xo: L.xo + L.kp].float()
        i = L.inputs()
        # the stored input is bf16(x), the operand the plain dW rounds to
        assert torch.equal(X[:T, L.xo: L.xo + L.kp][:, i >= 0], x[:, i[i >= 0]].to(torch.bfloat16))
        assert not Xl[:, i < 0].abs().sum()
        # the ReLU masks: the float32 x > 0 of the input features, not bf16(x) != 0
        if li > 0:
            half = L.nx if lay.tile == 64 else None
            assert torch.equal(fm.relu_mask_from_words(masks[li], T, L.w1, half),
                               x[:, : L.w1] > 0)
        u = L.units(L.kz)
        Gl = G[:T, L.go: L.go + L.kz].float()
        assert torch.equal(Gl[:, u >= 0], g[:, u[u >= 0]].to(torch.bfloat16).float())
        assert not Gl[:, u < 0].abs().sum()
        # dW = G^T X from the workspace, at (unit, input) = the plain K2's
        dW = (Gl.t().double() @ Xl.double())[u >= 0][:, i >= 0]
        ref = torch.zeros_like(grads[2 * li], dtype=torch.float64)
        ref[u[u >= 0][:, None], i[i >= 0][None, :]] = dW
        scale = float(grads[2 * li].abs().max())
        assert float((ref - grads[2 * li].double()).abs().max()) <= SUM_REL * scale
        # db: the column sums of the unrounded g_z per 64 points, summed in order
        assert db_part.shape == (X.shape[0] // 64, lay.KG)
        db = db_part[:, L.go: L.go + L.kz].sum(dim=0)[u >= 0]
        ref_b = torch.zeros_like(grads[2 * li + 1])
        ref_b[u[u >= 0]] = db
        scale = float(grads[2 * li + 1].abs().max())
        assert float((ref_b - grads[2 * li + 1]).abs().max()) <= SUM_REL * scale


def test_relu_mask_words_hold_the_float32_mask():
    """The mask words keep x > 0 where bf16(x) is 0 (a positive float32 below
    half of bf16's smallest subnormal rounds to +0), for every (thread, bit)
    of a ragged last tile."""
    rng = np.random.RandomState(0)
    x = torch.tensor(np.maximum(rng.randn(300, 256), 0.0), dtype=torch.float32)
    x[::7, ::5] = 2.0 ** -135
    assert not x[::7, ::5].to(torch.bfloat16).float().any()
    words = fm.relu_mask_words_plain(x)
    assert words.shape == (3, 256, 4) and words.dtype == torch.int32
    assert torch.equal(fm.relu_mask_from_words(words, 300, 256), x > 0)
    # a narrower input: the words past its columns stay clear
    narrow = fm.relu_mask_words_plain(x[:, :32])
    assert torch.equal(fm.relu_mask_from_words(narrow, 300, 256)[:, 32:],
                       torch.zeros((300, 224), dtype=torch.bool))


@pytest.mark.parametrize("widths,why", [
    (dict(layers_feat=(640,) * 2, layers_rgb=(32, 3), skip=()), "a 640-wide layer"),
    (dict(layers_feat=(64,) * 3, layers_rgb=(32, 3), skip=(), L_3D=21), "pts_enc 129 wide"),
    (dict(layers_feat=(64,) * 3, layers_rgb=(32, 3), skip=(), L_view=21), "view_enc 129 wide"),
])
def test_wg_layout_refuses_chains_the_kernels_do_not_take(widths, why):
    """Past the kernels' domain (every layer up to 512 features, pts_enc and
    view_enc up to 128 wide) wg_layout raises, as build_wg_desc returns -7."""
    cfg = tmlp.MLPConfig(view_dep=True, compute_dtype=torch.bfloat16, **widths)
    with pytest.raises(ValueError, match="bfloat16"):
        fm.wg_layout(tuple(fm.chain_dims(cfg)))


@pytest.mark.parametrize("widths,why", [
    (dict(layers_feat=(150,) * 3, layers_rgb=(32, 3), skip=()), "features padded to 192"),
    (dict(layers_feat=(64,) * 3, layers_rgb=(32, 3), skip=(), L_3D=12), "pts_enc 75 wide"),
    (dict(layers_feat=(300,) * 2, layers_rgb=(32, 3), skip=()), "300 features"),
])
def test_wg_layout_takes_in_plan_n_what_plan_m_refuses(widths, why):
    """The chains plan M (128-point tiles) does not take run in plan N: each
    warpgroup's half of a product is a multiple of 32 (8 at the RGB output),
    its rows twice that, and every layer's input chunks are its product's."""
    cfg = tmlp.MLPConfig(view_dep=True, compute_dtype=torch.bfloat16, **widths)
    lay = fm.wg_layout(tuple(fm.chain_dims(cfg)))
    assert lay.tile == 64
    for L, nxt in zip(lay.layers, lay.layers[1:] + (None,)):
        half = L.nm // 2
        assert half == (8 if nxt is None else nxt.k1p // 2) and half % 8 == 0
        assert L.nx == L.k1p // 2 and L.kz == -(-((L.nm + 8) if L.dens else L.out) // 64) * 64
