"""The pieces of the matchers' geometry stage (sparf_tpu_torch/models/
flow_net.py) against the JAX package's, on the same numpy-made inputs: the
windowed box sum, both depth sweeps, the whole two-pass rematch of a pair, the
sparse guided rematch, seed selection, the round score, the multi-view
agreement masks and the assembled outputs with their optional gates.

The sweeps score every hypothesis on its own, so the port's score volume
(`_plane_sweep_scores`, `_local_sweep_scores`, `_sparse_rematch_scores`) is
held to the JAX volume, captured from its `jax.lax.map`, within 1e-4. The
argmax over hypotheses may pick another of two scores that agree within that
rounding: the best hypothesis must agree on at least 0.999 of the pixels (or
keypoints), and every disagreement is shown to be a near-tie (the JAX scores
of the two picks within 2e-4). Where the argmax agrees, the peak score,
margin and curvature are held within 1e-4 and coordinates within 1e-3 px; a
subpixel vertex on a flat peak moves with the scores' rounding, so up to
0.5% of those coordinates (counted) may be off by up to 1e-2 px.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread cap)
from torch_parity import assert_close
from sparf_tpu.models import flow_net as fj
from sparf_tpu_torch.datasets import synthetic
from sparf_tpu_torch.models import flow_net as ft
from sparf_tpu_torch.utils import geometry

T = torch.as_tensor
J = jnp.asarray
SCORE_TOL = 1e-4
PX_TOL = 1e-3


@pytest.fixture(scope="module")
def rig():
    """3-view 32x40 synthetic scene; pair 0 -> 1 with its GT relative pose,
    the sweep operators at that pose and the target's GT inverse depth.

    The images are centred (zero mean per channel; ZNCC does not see the
    shift) and get 0.1 of uniform noise. The scene's background is flat,
    and a window of constant colour has a ZNCC of rounding noise over a
    clamped variance (values up to ~500 in either package). A window's
    variance is a difference of sums, Stt - St^2 / n, whose float32 rounding
    grows with the image's mean: on the uncentred images the two packages'
    summation orders differ by up to 5e-3 in the scores of low-texture
    windows, on the centred ones by < 1e-4."""
    sc = synthetic.load_synthetic_scene(split="train", H=32, W=40, n_train=3, n_test=1,
                                        angular_span=0.35)
    T_ts = geometry.relative_transform_i_to_j(T(sc["pose"][0]), T(sc["pose"][1])).numpy()
    R, t = T_ts[:3, :3].astype(np.float64), T_ts[:3, 3].astype(np.float64)
    K = np.asarray(sc["intr"], np.float64)
    A, B = ft._sweep_operators(K[0], K[1], R, t)
    d = np.asarray(sc["depth_gt"][0])
    valid = np.asarray(sc["valid_depth_gt"][0]) > 0
    imgs = np.asarray(sc["image"], np.float32)
    imgs = (imgs - imgs.mean((0, 2, 3), keepdims=True)
            + np.random.RandomState(0).rand(*imgs.shape).astype(np.float32) * 0.1)
    return dict(imgs=imgs, K=K, R=R, t=t, A=A, B=B,
                depths=d[valid].astype(np.float64),
                inv_d=np.where(valid, 1.0 / np.maximum(d, 1e-3), 0.3).astype(np.float32))


def _capture_map(monkeypatch, fn):
    """fn with its outermost jax.lax.map's output returned beside its own
    (traceable, so the pair can be jitted)."""
    captured = []
    orig = jax.lax.map

    def rec(f, xs, *a, **k):
        out = orig(f, xs, *a, **k)
        captured.append(out)
        return out

    monkeypatch.setattr(jax.lax, "map", rec)

    def run(*args):
        captured.clear()
        out = fn(*args)
        return out, captured[-1]  # the outermost map returns last

    return run


def _check_coords(ct, cj, same, what):
    """Coordinates where the argmax agrees: within 1e-3 px on >= 0.995 of
    those pixels, and all within 1e-2 px. A vertex on a flat peak moves
    with the scores' rounding (0.5 (sm - sp) / (sm - 2 s0 + sp) over a small
    denominator), by a few 1e-3 px between the packages."""
    d = np.linalg.norm(np.asarray(ct) - np.asarray(cj), axis=-1)[same]
    print(f"{what}: {int((d > PX_TOL).sum())} of {d.size} coordinates off by > {PX_TOL} px "
          f"(largest {d.max(initial=0.0):.2g})")
    assert (d <= PX_TOL).mean() >= 0.995 and d.max(initial=0.0) <= 10 * PX_TOL


def _check_volume(vol_t, vol_j, axis=0, what=""):
    """Score volumes within SCORE_TOL; the argmax over `axis` agrees on >=
    0.999 of the positions, the others near-ties. Returns the agreement mask."""
    vol_t, vol_j = np.asarray(vol_t), np.asarray(vol_j)
    assert vol_t.shape == vol_j.shape
    assert_close(vol_t, vol_j, atol=SCORE_TOL, what=f"{what} scores")
    bt, bj = vol_t.argmax(axis), vol_j.argmax(axis)
    same = bt == bj
    s_at_t = np.take_along_axis(vol_j, np.expand_dims(bt, axis), axis).squeeze(axis)
    s_at_j = np.take_along_axis(vol_j, np.expand_dims(bj, axis), axis).squeeze(axis)
    gap = np.abs(s_at_j - s_at_t)[~same]
    print(f"{what}: best hypothesis differs at {int((~same).sum())} of {same.size} "
          f"(largest score gap {gap.max(initial=0.0):.2g})")
    assert same.mean() >= 0.999 and (gap <= 2 * SCORE_TOL).all()
    return same


# ---------------------------------------------------------------------------
# box sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_box_sum_matches_jax(radius):
    """reduce_window "SAME" with init 0 pads with zeros: a 3x3 box sum of
    ones is 4 at the corners."""
    x = np.random.RandomState(radius).rand(2, 3, 21, 26).astype(np.float32) * 4.0
    a = ft._box_sum(T(x), radius)
    b = np.asarray(jax.jit(fj._box_sum, static_argnums=1)(J(x), radius))
    np.testing.assert_allclose(a.numpy(), b, rtol=1e-5)
    ones = ft._box_sum(torch.ones(5, 6), 1)
    assert float(ones[0, 0]) == 4.0 and float(ones[2, 2]) == 9.0 and float(ones[0, 2]) == 6.0


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [32, 33])
def test_plane_sweep_matches_jax(monkeypatch, rig, D):
    """The fronto-parallel sweep of pair 0 -> 1 at its GT pose. D = 32 is even
    (every D of the stage is a multiple of 32): the margin's median is the
    mean of the two middle scores, as jnp.median takes it, not torch.median's
    lower one."""
    inv = rig["inv_d"][rig["inv_d"] > 0.3]
    inv_depths = np.linspace(inv.min() * 0.8, inv.max() * 1.2, D).astype(np.float32)
    args = (rig["imgs"][0], rig["imgs"][1], rig["A"], rig["B"], inv_depths)
    (cj, sj, mj), vol_j = jax.jit(_capture_map(monkeypatch, fj._plane_sweep_pair))(
        *map(J, args))
    img_t, img_s, A, B, invd = map(T, args)
    Ag, Bg = ft._on_grid(A, 32, 40).reshape(3, -1), ft._on_grid(B, 32, 40).reshape(3, -1)
    vol_t = ft._plane_sweep_scores(img_t, img_s, Ag, Bg, invd, 2)
    same = _check_volume(vol_t, vol_j, what=f"plane sweep D={D}")
    ct, st_, mt = ft._plane_sweep_pair(img_t, img_s, A, B, invd)
    _check_coords(ct, cj, same, f"plane sweep D={D}")
    assert_close(st_, sj, atol=SCORE_TOL, what="peak")
    assert_close(mt, mj, atol=SCORE_TOL, what="margin")
    lower = vol_t.median(dim=0).values
    if D % 2 == 0:  # torch.median's lower middle value is another margin
        assert np.abs((st_ - lower).numpy() - np.asarray(mj)).max() > SCORE_TOL


def test_sweep_results_do_not_depend_on_the_chunk(monkeypatch, rig):
    args = [T(a) for a in (rig["imgs"][0], rig["imgs"][1], rig["A"], rig["B"])]
    inv_depths = torch.linspace(0.2, 0.6, 32)
    ref = ft._plane_sweep_pair(*args, inv_depths)
    ref_local = ft._local_depth_sweep(*args, T(rig["inv_d"]), 0.01, n_offsets=4)
    monkeypatch.setattr(ft, "_SWEEP_CHUNK", 5)
    for a, b in zip(ft._plane_sweep_pair(*args, inv_depths), ref):
        assert torch.equal(a, b)
    for a, b in zip(ft._local_depth_sweep(*args, T(rig["inv_d"]), 0.01, n_offsets=4),
                    ref_local):
        assert torch.equal(a, b)


@pytest.mark.parametrize("radius", [1, 3])
def test_local_depth_sweep_matches_jax(monkeypatch, rig, radius):
    """The per-pixel slanted sweep (33 depth offsets x a 7-px band across the
    epipolar line) around a GT inverse depth moved by up to 3 steps."""
    rng = np.random.RandomState(radius)
    step = 0.004
    inv_d0 = (rig["inv_d"] + rng.uniform(-3, 3, rig["inv_d"].shape) * step).astype(np.float32)
    args = (rig["imgs"][0], rig["imgs"][1], rig["A"], rig["B"], inv_d0)

    def fn(img_t, img_s, A, B, d0):
        return fj._local_depth_sweep(img_t, img_s, A, B, d0, step, n_offsets=16, radius=radius)

    out_j, vol_j = jax.jit(_capture_map(monkeypatch, fn))(*map(J, args))
    img_t, img_s, A, B, d0 = map(T, args)
    Ag, Bg, px, py, perp = ft._local_sweep_setup(img_t, A, B)
    offsets = torch.arange(-16, 17, dtype=torch.float32) * step
    vol_t = ft._local_sweep_scores(img_t, img_s, Ag, Bg, px, py, perp, d0, offsets, radius)
    same = _check_volume(vol_t, vol_j, what=f"local sweep r={radius}")
    ct, st_, cv, dt = ft._local_depth_sweep(img_t, img_s, A, B, d0, step, n_offsets=16,
                                            radius=radius)
    cj, sj, cvj, dj = (np.asarray(x) for x in out_j)
    _check_coords(ct, cj, same, f"local sweep r={radius}")
    assert_close(st_, sj, atol=SCORE_TOL, what="peak")
    assert_close(cv.numpy()[same], cvj[same], atol=2 * SCORE_TOL, what="curvature")
    # the depth vertex moves as the coordinates do: within 1/20 of a step
    assert_close(dt.numpy()[same], dj[same], atol=0.05 * step, what="inverse depth")


def test_geom_rematch_pair_matches_jax(rig):
    """Both passes at the GT pose, both directions of pair 0 - 1: the D
    bucketing, the half-pixel conjugation and the inverse depth handed from
    pass 1 to pass 2. A pass-1 near-tie moves pass 2's start, so the
    outputs are compared where the coordinates agree (>= 0.99 of pixels)."""
    imgs, K, R, t = rig["imgs"], rig["K"], rig["R"], rig["t"]
    for (a, b, Ka, Kb, Rab, tab) in ((0, 1, K[0], K[1], R, t),
                                     (1, 0, K[1], K[0], R.T, -R.T @ t)):
        out_t = ft._geom_rematch_pair(T(imgs[a]), T(imgs[b]), Ka, Kb, Rab, tab, rig["depths"])
        out_j = fj._geom_rematch_pair(J(imgs[a]), J(imgs[b]), Ka, Kb, Rab, tab, rig["depths"])
        ct, cj = out_t[0].numpy(), np.asarray(out_j[0])
        same = np.linalg.norm(ct - cj, axis=-1) <= PX_TOL
        print(f"rematch {a}->{b}: coordinates agree at {same.mean():.5f} of pixels")
        assert same.mean() >= 0.99
        # 3x3 windows: the JAX package's float32 variances round at ~1e-6 of
        # Sxx (the port's float64 ones do not), up to ~4e-4 in a score here;
        # the curvature is a second difference of three scores
        for name, x, y, tol in zip(("score", "margin", "curvature", "inverse depth"),
                                   out_t[1:], out_j[1:], (5e-4, 5e-4, 2e-3, 5e-4)):
            assert_close(x.numpy()[same], np.asarray(y)[same], atol=tol, what=name)


def test_sparse_guided_rematch_matches_jax(monkeypatch, rig):
    """Keypoints on a 3-px grid, seeded from the GT flow moved by 1.3 px."""
    sc = synthetic.load_synthetic_scene(split="train", H=32, W=40, n_train=3, n_test=1,
                                        angular_span=0.35)
    gt, _ = ft.gt_correspondences_for_pair(sc, 0, 1)
    corres = (gt.transpose(1, 2, 0) + np.float32(1.3)).astype(np.float32)
    ys, xs = np.mgrid[6:26:3, 6:34:3]
    kps = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    img_t, img_s = rig["imgs"][0], rig["imgs"][1]
    run = _capture_map(monkeypatch, fj._sparse_guided_rematch)
    (xy_j, s_j), vol_j = run(J(img_t), J(img_s), J(corres), kps)
    vol_t, _, _ = ft._sparse_rematch_scores(T(img_t), T(img_s), T(corres), kps, 5, 6)
    vol_j = np.asarray(vol_j).reshape(-1, kps.shape[0])
    same = _check_volume(vol_t, vol_j, what="sparse rematch")
    xy_t, s_t = ft._sparse_guided_rematch(T(img_t), T(img_s), T(corres), kps)
    assert xy_t.dtype == np.float32 and xy_t.shape == (kps.shape[0], 2)
    _check_coords(xy_t, xy_j, same, "sparse rematch")
    assert_close(s_t, s_j, atol=SCORE_TOL, what="peak")


# ---------------------------------------------------------------------------
# seeds, round score, masks, outputs
# ---------------------------------------------------------------------------


def _random_flows(seed, H=24, W=30, pairs=((0, 1), (0, 2), (1, 2))):
    """Flows of both directions of each pair: corres near the identity with
    1-px noise, scores and margins spread over the gates."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    flows = {}
    for t, s in pairs:
        for key in ((t, s), (s, t)):
            c = np.stack([xx, yy], -1) + rng.randn(H, W, 2).astype(np.float32) * 0.6
            flows[key] = (c.astype(np.float32), rng.uniform(0.4, 1.0, (H, W)).astype(np.float32),
                          rng.uniform(0.0, 0.9, (H, W)).astype(np.float32))
    return flows


def _as(flows, conv):
    return {k: tuple(conv(x) for x in v) for k, v in flows.items()}


@pytest.mark.parametrize("case", ["many", "relaxed", "none"])
def test_select_seed_matches_matches_jax(case):
    flows = _random_flows(5)
    f_ts, f_st = flows[(0, 1)], flows[(1, 0)]
    if case == "relaxed":  # too few at the strict gates: the relaxed ones
        f_ts = (f_ts[0], f_ts[1] * 0.87, f_ts[2])
    if case == "none":
        f_ts = (f_ts[0], f_ts[1] * 0.3, f_ts[2])
    out_t = ft._select_seed_matches(tuple(map(T, f_ts)), tuple(map(T, f_st)), max_seeds=40)
    out_j = fj._select_seed_matches(tuple(map(J, f_ts)), tuple(map(J, f_st)), max_seeds=40)
    if case == "none":
        assert out_t is None and out_j is None
        return
    assert out_t is not None and len(out_t[0]) >= 24
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a, b)


def test_rematched_flow_quality_matches_jax():
    flows = _random_flows(6)
    unordered = [(0, 1), (0, 2), (1, 2)]
    q = ft._rematched_flow_quality(_as(flows, T), unordered)
    assert q == fj._rematched_flow_quality(_as(flows, J), unordered) and q > 0
    assert ft._rematched_flow_quality({}, []) == -np.inf


def test_multiview_agreement_masks_matches_jax():
    rng = np.random.RandomState(7)
    extras = {}
    for key in ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0)):
        extras[key] = (rng.rand(6, 8).astype(np.float32),
                       (0.4 + rng.rand(6, 8) * 0.05).astype(np.float32))
    mt = ft._multiview_agreement_masks(_as(extras, T), 0.05)
    mj = fj._multiview_agreement_masks(extras, 0.05)
    assert sorted(mt) == sorted(mj) and (2, 0) not in mt  # view 2 has one pair only
    for k in mj:
        np.testing.assert_array_equal(mt[k].numpy(), mj[k])
        assert 0 < mj[k].mean() < 1


@pytest.mark.parametrize("gates", [dict(), dict(min_curv=0.3, mv_tol=0.02)])
def test_assemble_flow_outputs_matches_jax(gates):
    flows = _random_flows(8)
    rng = np.random.RandomState(9)
    extras = {k: (rng.rand(24, 30).astype(np.float32),
                  (0.4 + rng.rand(24, 30) * 0.03).astype(np.float32)) for k in flows}
    combi = np.array([[0, 1, 2, 0], [1, 0, 0, 2]], np.int32)
    out_t = ft._assemble_flow_outputs(_as(flows, T), combi, 0.7, 0.05, True,
                                      extras=_as(extras, T), **gates)
    out_j = fj._assemble_flow_outputs(_as(flows, J), combi, 0.7, 0.05, True,
                                      extras=_as(extras, J), **gates)
    for a, b in zip(out_t, out_j):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(out_t[0], out_j[0])
    np.testing.assert_array_equal(out_t[1] > 0, out_j[1] > 0)
    # exp and the norm of the cycle error round within an ulp of XLA's
    assert_close(out_t[1], out_j[1], atol=1e-7, what="conf")
    assert_close(out_t[2], out_j[2], atol=1e-7, what="cc")
    assert 0 < (out_t[1] > 0).mean() < 1
