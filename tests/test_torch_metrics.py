"""sparf_tpu_torch metrics and LPIPS against the JAX package, on the same
numpy-made images: PSNR, SSIM, the masked metrics, the depth errors with
their min over {scaled, unscaled}, and AlexNet LPIPS with the bundled weights,
below 64 px (bilinear upsampling first) and above. Tolerance: rtol 1e-5 (float32,
convolutions summed in other orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, t

from sparf_tpu.training import lpips_jax
from sparf_tpu.training import metrics as jmet
from sparf_tpu_torch.training import lpips as tlpips
from sparf_tpu_torch.training import metrics as tmet


def _images(shape, seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 1, size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.15, size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def lpips_pair():
    return lpips_jax.LPIPS(), tlpips.LPIPS()


@pytest.mark.parametrize("shape", [(1, 3, 24, 32), (2, 3, 37, 29)])
def test_psnr_ssim_match_jax(shape):
    a, b = _images(shape, seed=shape[2])
    assert_close(tmet.psnr(t(a), t(b)), jmet.psnr(jnp.asarray(a), jnp.asarray(b)), 0, 1e-5)
    assert_close(tmet.ssim(t(a), t(b)), jmet.ssim(jnp.asarray(a), jnp.asarray(b)), 0, 1e-5)
    assert_close(tmet.ssim(t(a), t(b), size_average=False),
                 jmet.ssim(jnp.asarray(a), jnp.asarray(b), size_average=False), 0, 1e-5)
    mask = (np.random.RandomState(1).uniform(size=shape) > 0.4)
    assert_close(tmet.psnr(t(a), t(b), torch.as_tensor(mask)),
                 jmet.psnr(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)), 0, 1e-5)


def test_ssim_convs_ignore_the_global_tf32_setting():
    from sparf_tpu_torch.utils.precision import ieee_fp32

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        with ieee_fp32():
            assert cudnn.allow_tf32 is False and matmul.allow_tf32 is False
        assert cudnn.allow_tf32 is True and matmul.allow_tf32 is True
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


@pytest.mark.parametrize("scale", [1.0, 1.7])
def test_depth_error_matches_jax(scale):
    rng = np.random.RandomState(3)
    gt = rng.uniform(1, 4, size=(1, 200, 1)).astype(np.float32)
    pred = (gt * 0.6 + rng.normal(0, 0.1, size=gt.shape)).astype(np.float32)
    valid = rng.uniform(size=(1, 200)) > 0.3
    ref = jmet.compute_depth_error(jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(pred), scale)
    got = tmet.compute_depth_error(t(gt), torch.as_tensor(valid), t(pred), scale)
    assert_close(got, ref, 0, 1e-5)
    on_rays = tmet.compute_depth_error_on_rays(t(gt), torch.as_tensor(valid), t(pred), scale)
    assert_close(on_rays, jmet.compute_depth_error_on_rays(jnp.asarray(gt), jnp.asarray(valid),
                                                           jnp.asarray(pred), scale), 0, 1e-5)


@pytest.mark.parametrize("shape", [(1, 3, 24, 32), (1, 3, 72, 80)])
def test_lpips_matches_jax(lpips_pair, shape):
    """Bundled self-supervised weights; 24x32 takes the upsampling branch."""
    lp_j, lp_t = lpips_pair
    assert lp_t.weight_tag == lp_j.weight_tag == "lpips(selfsup)"
    a, b = _images(shape, seed=7)
    ref = float(lp_j(jnp.asarray(a * 2 - 1), jnp.asarray(b * 2 - 1)))
    got = float(lp_t(t(a * 2 - 1), t(b * 2 - 1)))
    assert ref > 0.01
    assert_close(got, ref, 0, 1e-5)


def test_lpips_random_backbone_matches_jax(monkeypatch, tmp_path):
    """No weights found: both fall back to the same RandomState(0) backbone."""
    monkeypatch.setattr(tlpips, "DATA_DIR", str(tmp_path))
    lp_t = tlpips.LPIPS()
    assert lp_t.weight_tag == "lpips(rand)"
    ref_params = lpips_jax._init_random_params()
    for k, v in lp_t.params_on("cpu").items():
        np.testing.assert_array_equal(v.numpy(), ref_params[k])


@pytest.mark.parametrize("suffix", ["", "_fine"])
def test_compute_metrics_bundle_matches_jax(lpips_pair, suffix):
    lp_j, lp_t = lpips_pair
    a, b = _images((1, 3, 24, 32), seed=11)
    rng = np.random.RandomState(12)
    fg = (rng.uniform(size=(1, 1, 24, 32)) > 0.5).astype(np.float32)
    depth_gt = rng.uniform(1, 4, size=(1, 768, 1)).astype(np.float32)
    valid = rng.uniform(size=(1, 768)) > 0.2
    pred_depth = (depth_gt + rng.normal(0, 0.2, size=depth_gt.shape)).astype(np.float32)
    ref = jmet.compute_metrics(jnp.asarray(a), jnp.asarray(b), jnp.asarray(pred_depth),
                               jnp.asarray(depth_gt), jnp.asarray(valid), jnp.asarray(fg),
                               lpips_fn=lp_j, scaling_factor_for_pred_depth=1.3, suffix=suffix)
    got = tmet.compute_metrics(t(a), t(b), t(pred_depth), t(depth_gt), torch.as_tensor(valid),
                               t(fg), lpips_fn=lp_t, scaling_factor_for_pred_depth=1.3,
                               suffix=suffix)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert_close(got[k], ref[k], 0, 1e-5, what=k)
    m_c, m_f = tmet.compute_mse_on_rays(t(b.reshape(1, -1, 3)),
                                        {"rgb": t(a.reshape(1, -1, 3))})
    assert m_f is None
    assert_close(m_c, jmet.compute_mse_on_rays(jnp.asarray(b.reshape(1, -1, 3)),
                                               {"rgb": jnp.asarray(a.reshape(1, -1, 3))})[0],
                 0, 1e-5)
