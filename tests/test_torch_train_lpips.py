"""The port's LPIPS trainer (sparf_tpu_torch/scripts/train_lpips_selfsup.py)
against the JAX script (scripts/train_lpips_selfsup.py, imported by path):
the cv2-free helpers of utils/imgproc.py against OpenCV on seeded inputs, the
procedural patches and distortion batches from one RandomState, three
training steps against the JAX script's step (a copy of its loss and step)
from the same seed, and a short CLI run.

Tolerances: fill_poly pixel for pixel; gaussian_blur, warp_affine_reflect
and the resizes within 1e-6 (float32, another summation order); patches
and batches within 1e-6, scene renders and crops within 5e-4 (each package renders the
analytic scene from its own rays, an ulp apart, through the procedural
texture); losses within 1e-5 relative and parameters within 1e-5 after
three Adam steps.
"""
import importlib.util
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity  # noqa: F401  (thread cap)
from torch_parity import assert_close
from sparf_tpu.training import lpips_jax
from sparf_tpu.training import metrics as jmet
from sparf_tpu_torch.scripts import train_lpips_selfsup as tl
from sparf_tpu_torch.training.engine import Adam
from sparf_tpu_torch.utils import imgproc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lpips_selfsup", os.path.join(REPO, "scripts", "train_lpips_selfsup.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JS = _jax_script()


@pytest.mark.parametrize("ksize,sigma", [((3, 3), 0.8), ((5, 5), 2.0), ((7, 7), 3.0),
                                         ((0, 0), 0.5), ((0, 0), 1.37), ((0, 0), 4.5)])
def test_gaussian_blur_matches_opencv(ksize, sigma):
    img = np.random.RandomState(int(sigma * 100)).rand(64, 64, 3).astype(np.float32)
    np.testing.assert_allclose(imgproc.gaussian_blur(img, ksize, sigma),
                               cv2.GaussianBlur(img, ksize, sigma), atol=1e-6)


def test_fill_poly_matches_opencv_pixel_for_pixel():
    rng = np.random.RandomState(1)
    for _ in range(200):
        img = np.zeros((64, 64, 3), np.float32)
        ref = img.copy()
        pts = (rng.rand(rng.randint(3, 6), 2) * 64).astype(np.int32)
        color = tuple(float(c) for c in rng.rand(3))
        imgproc.fill_poly(img, [pts], color)
        cv2.fillPoly(ref, [pts], color)
        np.testing.assert_array_equal(img, ref, err_msg=str(pts.tolist()))


@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_reflect_matches_opencv(seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(64, 64, 3).astype(np.float32)
    d = 1.0 + 7.0 * rng.rand()
    ang = rng.rand() * 2 * np.pi
    M = np.float32([[1, 0, d * np.cos(ang)], [0, 1, d * np.sin(ang)]])
    np.testing.assert_allclose(imgproc.warp_affine_reflect(img, M, (64, 64)),
                               cv2.warpAffine(img, M, (64, 64), borderMode=cv2.BORDER_REFLECT),
                               atol=1e-6)
    M = np.float32([[1, 0, 0.3], [0, 1, -0.3]])
    np.testing.assert_allclose(imgproc.warp_affine_reflect(img, M, (64, 64)),
                               cv2.warpAffine(img, M, (64, 64), borderMode=cv2.BORDER_REFLECT),
                               atol=1e-6)


@pytest.mark.parametrize("f", [4, 9, 23, 37, 50, 61])
def test_block_resizes_match_opencv(f):
    img = np.random.RandomState(f).rand(64, 64, 3).astype(np.float32)
    small = imgproc.resize_area(img, (f, f))
    np.testing.assert_allclose(small, cv2.resize(img, (f, f), interpolation=cv2.INTER_AREA),
                               atol=1e-6)
    np.testing.assert_array_equal(imgproc.resize_nearest(small, (64, 64)),
                                  cv2.resize(small, (64, 64), interpolation=cv2.INTER_NEAREST))


@pytest.fixture(scope="module")
def scenes():
    from sparf_tpu.datasets.synthetic import load_synthetic_scene

    jax_imgs = []
    for hw in ((120, 160), (90, 120)):
        sc = load_synthetic_scene(split="train", H=hw[0], W=hw[1], n_train=6, n_test=1)
        jax_imgs += [np.asarray(im).transpose(1, 2, 0) for im in sc["image"]]
    return jax_imgs, tl.scene_images()


def test_patch_generators_match_the_jax_script(scenes):
    jax_imgs, port_imgs = scenes
    for a, b in zip(port_imgs, jax_imgs):
        np.testing.assert_allclose(a, b, atol=5e-4)
    # procedural patches and every family on them: the same RandomState draws
    rng_j, rng_t = np.random.RandomState(3), np.random.RandomState(3)
    for fn_j, fn_t in ((JS._smooth_noise, tl._smooth_noise),):
        for scale in (1, 2, 3):
            np.testing.assert_allclose(fn_t(rng_t, scale), fn_j(rng_j, scale), atol=1e-6)
    for fn_j, fn_t in ((JS._gradient, tl._gradient), (JS._polygons, tl._polygons)):
        for _ in range(5):
            np.testing.assert_allclose(fn_t(rng_t), fn_j(rng_j), atol=1e-6)
    clean = rng_j.rand(64, 64, 3).astype(np.float32)
    rng_t.rand(64, 64, 3)
    for fam_j, fam_t in zip(JS.FAMILIES, tl.FAMILIES):
        for s in (0.05, 0.4, 0.97):
            np.testing.assert_allclose(fam_t(clean, s, rng_t), fam_j(clean, s, rng_j), atol=1e-6,
                                       err_msg=fam_j.__name__)
    # whole batches with scene crops, from the same seed; the RandomState
    # streams stay in step (the next draw agrees)
    rng_j, rng_t = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(2):
        for a, b in zip(tl.batch_triplets(port_imgs, rng_t, 16) + tl.batch_cross(port_imgs, rng_t, 16),
                        JS.batch_triplets(jax_imgs, rng_j, 16) + JS.batch_cross(jax_imgs, rng_j, 16)):
            np.testing.assert_allclose(a, b, atol=5e-4)
    assert rng_t.rand() == rng_j.rand()


def _jax_step(lr=1e-4, margin=0.05):
    """A copy of scripts/train_lpips_selfsup.py's dist, loss_fn and step
    (:225-289), from lpips_jax and the JAX metrics."""
    shift = jnp.asarray(lpips_jax._SHIFT)
    scale = jnp.asarray(lpips_jax._SCALE)

    def dist(p, a, b):
        f1 = lpips_jax._features(p, (a - shift) / scale)
        f2 = lpips_jax._features(p, (b - shift) / scale)
        tot = 0.0
        for i, (u, v) in enumerate(zip(f1, f2)):
            d = (lpips_jax._normalize_tensor(u) - lpips_jax._normalize_tensor(v)) ** 2
            w = jax.nn.relu(p[f"lin{i}_w"]).reshape(1, -1, 1, 1)
            tot = tot + jnp.mean(jnp.sum(d * w, axis=1), axis=(1, 2))
        return tot

    def per_sample_psnr(a, b):
        mse = jnp.mean((a - b) ** 2, axis=(1, 2, 3))
        return -10.0 * jnp.log10(jnp.maximum(mse, 1e-12))

    def loss_fn(p, x, mild, severe, xc, ca, cb):
        d_m = dist(p, x, mild)
        d_s = dist(p, x, severe)
        rank = jnp.mean(jax.nn.relu(margin + d_m - d_s))
        d_a = dist(p, xc, ca)
        d_b = dist(p, xc, cb)
        s_a = jmet.ssim(xc, ca, size_average=False)
        s_b = jmet.ssim(xc, cb, size_average=False)
        q_a = per_sample_psnr(xc, ca)
        q_b = per_sample_psnr(xc, cb)
        b_worse = ((s_b < s_a - 0.02) & (q_b < q_a - 0.5)).astype(jnp.float32)
        a_worse = ((s_a < s_b - 0.02) & (q_a < q_b - 0.5)).astype(jnp.float32)
        cross = jnp.sum(b_worse * jax.nn.relu(margin + d_a - d_b)
                        + a_worse * jax.nn.relu(margin + d_b - d_a)
                        ) / jnp.maximum(jnp.sum(b_worse + a_worse), 1.0)
        reg = jnp.mean((d_s - 0.5) ** 2) * 0.01
        return rank + cross + reg, (jnp.mean((d_s > d_m).astype(jnp.float32)))

    tx = optax.adam(lr)

    @jax.jit
    def step(p, opt, x, m, s, xc, ca, cb):
        (l, acc), g = jax.value_and_grad(loss_fn, has_aux=True)(p, x, m, s, xc, ca, cb)
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, l, acc

    return tx, step


def test_three_steps_match_the_jax_step(scenes):
    """Three steps at batch 4 from seed 0 on the same batches (made by the
    JAX script's generators) against the JAX script's step."""
    jax_imgs, _ = scenes
    tx_j, step_j = _jax_step()
    params_j = {k: jnp.asarray(v) for k, v in lpips_jax._init_random_params(0).items()}
    opt_j = tx_j.init(params_j)
    params_t = tl.initial_params(0, "cpu")
    tx_t = Adam(lambda count: torch.full((), 1e-4))
    opt_t = tx_t.init([params_t[k] for k in sorted(params_t)])
    rng = np.random.RandomState(0)
    for it in range(3):
        batch = JS.batch_triplets(jax_imgs, rng, 4) + JS.batch_cross(jax_imgs, rng, 4)
        params_j, opt_j, loss_j, acc_j = step_j(params_j, opt_j,
                                                *(jnp.asarray(a, jnp.float32) for a in batch))
        loss_t, acc_t, _, opt_t = tl.train_step(
            params_t, tx_t, opt_t, [torch.as_tensor(np.asarray(a, np.float32)) for a in batch])
        assert_close(loss_t, loss_j, atol=0, rtol=1e-5, what=f"loss, step {it}")
        assert float(acc_t) == float(acc_j)
    for k, v in params_j.items():
        assert_close(params_t[k], v, atol=1e-5, what=k)


def test_cli_run_writes_lpips_weights(tmp_path):
    out = str(tmp_path / "lpips.npz")
    res = tl.main(["--steps", "2", "--batch", "2", "--device", "cpu", "--out", out])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert 0.0 <= res["rank_acc"] <= 1.0
    w = lpips_jax.load_weights_npz(out)
    assert "steps=2" in str(w["provenance"])
    assert all((w[f"lin{i}_w"] >= 0).all() for i in range(5))
    from sparf_tpu_torch.training import lpips as tlp

    assert tlp.LPIPS(out).weight_tag == "lpips(selfsup)"
    with pytest.raises(SystemExit, match="sparf_tpu"):
        tl.main(["--steps", "1", "--device", "cpu", "--out",
                 os.path.join(REPO, "sparf_tpu", "data", "never.npz")])
