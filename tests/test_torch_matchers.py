"""The port's classical and sparse matchers (sparf_tpu_torch/models/
flow_net.py, sparse_matcher.py) against the JAX package's, on numpy-made
inputs: the sampling, homography and cycle-consistency helpers, the
`jax.image.resize` replacement, each piece of the ZNCC appearance stage, the
whole stage 1 (intr=None) with and without the homography race, the SPSG
matcher, and the facade's geometry routes (zncc and PDC-Net with the
geometry stage), which run whenever the scene has intrinsics.

Tolerances (float32): interpolation and homography helpers 1e-5 (1e-4 px
where coordinates pass through a division); ZNCC scores 1e-5. ZNCC argmax
can flip between near-equal window scores under another summation order, so
the matched coordinates are compared by the fraction of pixels that differ
by more than 1e-3 px, which is bounded and reported, never excused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread cap)
from torch_parity import assert_close
from sparf_tpu.models import flow_net as fj
from sparf_tpu.models import sparse_matcher as sj
from sparf_tpu_torch.datasets import synthetic
from sparf_tpu_torch.models import flow_net as ft
from sparf_tpu_torch.models import pdcnet
from sparf_tpu_torch.models import sparse_matcher as st
from sparf_tpu_torch.utils import imgproc

T = torch.as_tensor
J = jnp.asarray
BUNDLED_PDCNET = pdcnet.BUNDLED_WEIGHTS


def _scene(H, W):
    return synthetic.load_synthetic_scene(split="train", H=H, W=W, n_train=3, n_test=1)


def _flipped(a, b, tol=1e-3):
    """Fraction of pixels whose (…,2,H,W) or (H,W,2) coordinates differ by > tol."""
    a, b = np.asarray(a), np.asarray(b)
    axis = 1 if a.ndim == 4 else -1
    return float((np.linalg.norm(a - b, axis=axis) > tol).mean())


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def test_bilinear_at_and_homography_helpers_match_jax():
    rng = np.random.RandomState(0)
    img = rng.rand(3, 10, 12).astype(np.float32)
    x = rng.uniform(-2, 14, (5, 7)).astype(np.float32)
    y = rng.uniform(-2, 12, (5, 7)).astype(np.float32)
    assert_close(ft._bilinear_at(T(img), T(x), T(y)), fj._bilinear_at(J(img), J(x), J(y)),
                 atol=1e-6)
    Hm = np.array([[1.02, 0.03, 0.8], [-0.02, 0.98, -0.5], [1e-3, 5e-4, 1.0]], np.float32)
    pts = rng.uniform(0, 12, (4, 6, 2)).astype(np.float32)
    assert_close(ft._apply_homography(T(Hm), T(pts)), fj._apply_homography(J(Hm), J(pts)),
                 atol=1e-4)
    assert_close(ft._warp_image_by_homography(T(img), T(Hm)),
                 fj._warp_image_by_homography(J(img), J(Hm)), atol=1e-5)


@pytest.mark.parametrize("with_zero_weights", [False, True])
def test_fit_homography_weighted_matches_jax(with_zero_weights):
    """A flow from a known homography with 0.05 px noise and 10% gross
    outliers: both fits recover it (within 0.1 px over the image) and agree
    with each other within 0.02 px, after the Hm[2,2] = 1 normalisation that
    makes the eigenvector's sign irrelevant."""
    rng = np.random.RandomState(int(with_zero_weights))
    H, W = 30, 40
    H_true = np.array([[1.05, 0.04, 2.0], [-0.03, 0.97, 1.5], [4e-4, -3e-4, 1.0]])
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))

    def apply(Hm):
        p = np.asarray(Hm, np.float64) @ np.stack([xx.ravel(), yy.ravel(), np.ones(xx.size)])
        return (p[:2] / p[2]).T.reshape(H, W, 2)

    corres = apply(H_true) + rng.randn(H, W, 2) * 0.05
    out = rng.rand(H, W) < 0.1
    corres[out] += rng.uniform(-8, 8, (int(out.sum()), 2))
    weights = rng.uniform(0.2, 1.0, (H, W))
    if with_zero_weights:  # the JAX median then is NaN, taken as 1 px
        weights[rng.rand(H, W) < 0.2] = 0.0
    corres, weights = corres.astype(np.float32), weights.astype(np.float32)
    Hj = np.asarray(jax.jit(fj._fit_homography_weighted)(J(corres), J(weights)))
    Ht = ft._fit_homography_weighted(T(corres), T(weights)).numpy()
    assert Ht[2, 2] == 1.0
    assert np.abs(apply(Hj) - apply(H_true)).max() < 0.1
    assert np.abs(apply(Ht) - apply(H_true)).max() < 0.1
    assert np.abs(apply(Ht) - apply(Hj)).max() < 0.02


def test_cycle_consistency_and_cc_maps_match_jax():
    rng = np.random.RandomState(2)
    P, H, W = 2, 9, 11
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    grid = np.stack([xx, yy]).astype(np.float32)
    corres = (grid[None] + rng.randn(P, 2, H, W) * 1.5).astype(np.float32)
    combi = np.array([[0, 1], [1, 0]], np.int32)
    a, b = corres[0].transpose(1, 2, 0), corres[1].transpose(1, 2, 0)
    assert_close(ft._cycle_error(T(a), T(b)), fj._cycle_error(J(a), J(b)), atol=1e-5)
    assert_close(ft._cycle_confidence(T(a), T(b)), fj._cycle_confidence(J(a), J(b)), atol=1e-6)
    assert_close(ft.cc_maps_from_corres(corres, combi), fj.cc_maps_from_corres(corres, combi),
                 atol=1e-6)
    one_way = np.array([[0], [1]], np.int32)  # the reverse direction is absent: ones
    np.testing.assert_array_equal(ft.cc_maps_from_corres(corres[:1], one_way), 1.0)


@pytest.mark.parametrize("shape,size", [((2, 38, 50), (75, 100)), ((1, 2, 24, 33), (48, 64)),
                                        ((3, 48, 64), (24, 32)), ((2, 30, 40), (11, 17))])
def test_resize_bilinear_matches_jax_image_resize(shape, size):
    """Upsampling at integer and non-integer ratios; downsampling, where JAX
    antialiases (a triangle kernel widened by the scale)."""
    x = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    ref = jax.image.resize(J(x), shape[:-2] + size, "bilinear")
    assert_close(imgproc.resize_bilinear(T(x), size), ref, atol=1e-5)


# ---------------------------------------------------------------------------
# ZNCC appearance stage
# ---------------------------------------------------------------------------


def test_zncc_pieces_match_jax():
    rng = np.random.RandomState(3)
    img = rng.rand(3, 20, 26).astype(np.float32)
    assert_close(ft._avg_pool2(T(img)), fj._avg_pool2(J(img)), atol=1e-6)
    for a, b in zip(ft._image_grads(T(img)), fj._image_grads(J(img))):
        assert_close(a, b, atol=1e-6)
    assert_close(ft._window_slices(T(img), 2), fj._window_slices(J(img), 2), atol=0)
    d_t, d_s = ft._patch_descriptors(T(img), 5), fj._patch_descriptors(J(img), 5)
    assert_close(d_t, d_s, atol=1e-6)
    img2 = np.roll(img, (1, 2), axis=(1, 2)) + rng.randn(*img.shape).astype(np.float32) * 0.02
    e_t, e_s = ft._patch_descriptors(T(img2), 5), fj._patch_descriptors(J(img2), 5)
    g_t, g_j = ft._global_match(d_t, e_t), fj._global_match(d_s, e_s)
    assert _flipped(g_t, g_j) <= 0.01
    corres = (np.asarray(g_j) + rng.randn(20, 26, 2).astype(np.float32)).astype(np.float32)
    for subpixel in (False, True):
        ct, (st_, mt) = ft._local_refine(d_t, e_t, T(corres), radius=3, subpixel=subpixel,
                                         return_score=True)
        cj, (sj_, mj) = fj._local_refine(d_s, e_s, J(corres), radius=3, subpixel=subpixel,
                                         return_score=True)
        assert _flipped(ct, cj) <= 0.01
        same = np.linalg.norm(ct.numpy() - np.asarray(cj), axis=-1) <= 1e-3
        assert_close(st_.numpy()[same], np.asarray(sj_)[same], atol=1e-5)
        assert_close(mt, mj, atol=1e-5)
    assert_close(ft._median_filter_flow(T(corres), 2), fj._median_filter_flow(J(corres), 2),
                 atol=1e-5)


@pytest.mark.parametrize("affine", [False, True])
def test_lk_refine_matches_jax(affine):
    """Lucas-Kanade on a smooth image pair shifted by (0.6, -0.4) px, from an
    integer start: within 1e-3 px of JAX's result."""
    yy, xx = np.mgrid[0:24, 0:30].astype(np.float32)

    def smooth(dx, dy):
        x, y = xx + dx, yy + dy
        return np.stack([np.sin(x / 3.0) * np.cos(y / 4.0), np.cos((x + y) / 5.0),
                         np.sin(x / 4.0 + y / 6.0)]).astype(np.float32) * 0.5 + 0.5

    img_t, img_s = smooth(0.0, 0.0), smooth(-0.6, 0.4)
    corres = np.stack([xx, yy], -1)
    a = ft._lk_refine(T(img_t), T(img_s), T(corres), radius=2, n_iters=3, affine=affine)
    b = fj._lk_refine(J(img_t), J(img_s), J(corres), radius=2, n_iters=3, affine=affine)
    assert_close(a, b, atol=1e-3)


def test_zncc_stage1_matches_jax():
    """compute_zncc_flow_of_combi_list with intr=None (stage 1 only) on the
    synthetic scene at 50x66 (odd sizes through the pyramid), all 6 pairs."""
    imgs = np.asarray(_scene(50, 66)["image"])
    combi = fj.get_combi_list(3, "all")
    cj, fj_conf, ccj = fj.compute_zncc_flow_of_combi_list(imgs, combi, return_cc=True)
    ct, ft_conf, cct = ft.compute_zncc_flow_of_combi_list(imgs, combi, return_cc=True,
                                                          device="cpu")
    flipped = _flipped(ct, cj)
    conf_off = float((np.abs(ft_conf - fj_conf) > 1e-4).mean())
    cc_off = float((np.abs(cct - ccj) > 1e-4).mean())
    print(f"zncc stage 1: {flipped:.5f} of pixels matched elsewhere, conf off {conf_off:.5f}, "
          f"cc off {cc_off:.5f}")
    assert flipped <= 0.005 and conf_off <= 0.005 and cc_off <= 0.005
    assert (ft_conf > 0.5).mean() > 0.1  # the stage keeps a useful share of the scene


def test_zncc_homography_race_matches_jax(monkeypatch):
    """The homography race of stage 1 (use_homography=True) for two pairs of
    a 32x40 scene (2 levels), with both sides given JAX's homography: the weighted fit is a float32
    9x9 eigendecomposition, ill-conditioned on these flows (tested on its
    own above), so it is held fixed here and the rest compared."""
    imgs = np.asarray(_scene(32, 40)["image"])
    fit_j = jax.jit(fj._fit_homography_weighted)
    given = {}
    monkeypatch.setattr(fj, "_fit_homography_weighted", lambda c, w: given["j"])
    monkeypatch.setattr(ft, "_fit_homography_weighted", lambda c, w: given["t"])

    def race(a, b, hm):
        given["j"] = hm
        return fj._match_pair_pyramid_homog(a, b, 2, 7)

    match_j, race_j = jax.jit(lambda a, b: fj._match_pair_pyramid(a, b, 2, 7)), jax.jit(race)
    for t, s in ((0, 1), (2, 1)):
        c0, s0, _ = match_j(J(imgs[t]), J(imgs[s]))
        Hm = np.asarray(fit_j(c0, jnp.clip(s0, 0.0, None) ** 2))
        out_j = race_j(J(imgs[t]), J(imgs[s]), J(Hm))
        given["t"] = T(Hm)
        out_t = ft._match_pair_pyramid_homog(T(imgs[t]), T(imgs[s]), 2, 7)
        flipped = _flipped(out_t[0], out_j[0])
        print(f"homography race ({t},{s}): {flipped:.5f} of pixels matched elsewhere")
        assert flipped <= 0.005
        same = np.linalg.norm(out_t[0].numpy() - np.asarray(out_j[0]), axis=-1) <= 1e-3
        assert_close(out_t[1].numpy()[same], np.asarray(out_j[1])[same], atol=1e-5)


# ---------------------------------------------------------------------------
# SPSG
# ---------------------------------------------------------------------------


def test_spsg_matches_jax():
    imgs = np.asarray(_scene(64, 80)["image"])
    kt, sc_t = st.detect_keypoints(T(imgs[0]), max_kp=256)
    kj, sc_j = sj.detect_keypoints(J(imgs[0]), max_kp=256)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert_close(sc_t, sc_j, atol=1e-7)
    assert_close(st.describe_keypoints(T(imgs[0]), kt), sj.describe_keypoints(J(imgs[0]), kj),
                 atol=1e-5)
    combi = fj.get_combi_list(3, "all")
    cj, fj_conf, ccj = sj.compute_spsg_flow_of_combi_list(imgs, combi, return_cc=True)
    ct, ft_conf, cct = st.compute_spsg_flow_of_combi_list(imgs, combi, return_cc=True,
                                                          device="cpu")
    np.testing.assert_array_equal(ft_conf > 0, fj_conf > 0)
    assert (ft_conf > 0).sum() >= 30
    assert_close(ct, cj, atol=0)
    # conf = cosine x clip(margin / 0.05): the margin's rounding is scaled by 20
    assert_close(ft_conf, fj_conf, atol=1e-4)
    np.testing.assert_array_equal(cct, ccj)


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,kw", [("zncc", {}), ("PDCNet", {}),
                                        ("pdcnet_jax", dict(ckpt_path=BUNDLED_PDCNET))])
def test_geometry_routes_run_with_intrinsics(backend, kw):
    """zncc, and PDC-Net with geometry_refine=True, run the geometry stage
    whenever the scene has intrinsics: the contract's shapes, and the
    stage's report in last_geom (its route, one entry per round)."""
    scene = _scene(24, 32)
    wrapper = ft.FlowSelectionWrapper(backend, geometry_refine=True, device="cpu", **kw)
    corres, conf, cc = wrapper.compute_flow_and_confidence_map_and_cc_of_combi_list(
        scene, fj.get_combi_list(3, "all"))
    assert corres.shape == (6, 2, 24, 32) and conf.shape == cc.shape == (6, 1, 24, 32)
    assert corres.dtype == conf.dtype == cc.dtype == np.float32
    assert np.isfinite(corres).all() and (conf > 0.95).any()
    geom = wrapper.last_geom
    seeds = "ZNCC" if backend == "zncc" else "PDC-Net"
    assert geom["route"] == f"{seeds} seeds -> mini-SfM -> plane-sweep rematch"
    assert len(geom["rounds"]) == 3 and geom["bootstrap"] is None
    assert {r["winner"] for r in geom["rounds"]} <= {"prior", "fresh", "pairwise"}


def test_device_errors_inside_the_stage_propagate(monkeypatch):
    """The stage catches what degenerate input raises (ValueError,
    LinAlgError, IndexError), never RuntimeError: a CUDA error inside a
    solver reaches the caller instead of turning into a fallback route."""
    def failing(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(imgproc, "find_essential_ransac", failing)
    scene = _scene(24, 32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ft.compute_zncc_flow_of_combi_list(np.asarray(scene["image"]),
                                           fj.get_combi_list(3, "all")[:, :2],
                                           intr=np.asarray(scene["intr"]), device="cpu")


def test_facade_routes_without_intrinsics():
    """Without intrinsics zncc is stage 1 only, and SPSG returns its all-ones cc."""
    scene = {k: v for k, v in _scene(32, 40).items() if k != "intr"}
    combi = fj.get_combi_list(3, "all")[:, :2]
    corres, conf = ft.FlowSelectionWrapper("zncc", device="cpu") \
        .compute_flow_and_confidence_map_of_combi_list(scene, combi)
    assert corres.shape == (2, 2, 32, 40) and conf.shape == (2, 1, 32, 40)
    corres, conf, cc = ft.FlowSelectionWrapper("SPSG", device="cpu") \
        .compute_flow_and_confidence_map_and_cc_of_combi_list(scene, combi)
    assert np.all(cc == 1.0) and conf.shape == (2, 1, 32, 40)
