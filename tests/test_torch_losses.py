"""sparf_tpu_torch losses and ray sampling vs the JAX package: value and
gradients of each loss on fixed renders, and the sampler with injected draws.

Tolerances: float32; loss values rtol 1e-5, gradients atol 1e-5 (O(1) inputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, patch_jax_draws, t, to_np

from sparf_tpu.configs.config import ConfigDict
from sparf_tpu.training import sampling as jsamp
from sparf_tpu.training.losses import base as jL
from sparf_tpu.training.losses import corres as jcorres
from sparf_tpu.training.losses import depth_cons as jdc
from sparf_tpu.training.losses import photometric as jphoto
from sparf_tpu_torch.training import sampling as tsamp
from sparf_tpu_torch.training.losses import base as tL
from sparf_tpu_torch.training.losses import corres as tcorres
from sparf_tpu_torch.training.losses import depth_cons as tdc
from sparf_tpu_torch.training.losses import photometric as tphoto
from sparf_tpu_torch.utils.draws import ReplayDraws


@pytest.mark.parametrize("loss_type", ["huber", "l1", "mse", "epe"])
@pytest.mark.parametrize("masked", [False, True])
def test_compute_diff_loss(loss_type, masked):
    rng = np.random.RandomState(0)
    diff = rng.normal(size=(20, 2)).astype(np.float32) * 2
    w = rng.uniform(size=(20, 1 if loss_type == "epe" else 2)).astype(np.float32)
    mask = (rng.uniform(size=w.shape) > 0.3) if masked else None
    v_j, g_j = jax.value_and_grad(lambda d: jL.compute_diff_loss(loss_type, d, w, mask))(diff)
    d = t(diff, requires_grad=True)
    v_t = tL.compute_diff_loss(loss_type, d, t(w),
                               None if mask is None else torch.as_tensor(mask))
    v_t.backward()
    assert_close(v_t, v_j, atol=0, rtol=1e-5)
    assert_close(d.grad, g_j, atol=1e-5)


def test_photometric_and_regularization_losses():
    rng = np.random.RandomState(1)
    B, N, S = 2, 8, 6
    out = {
        "rgb": rng.uniform(size=(B, N, 3)), "rgb_fine": rng.uniform(size=(B, N, 3)),
        "opacity": rng.uniform(size=(B, N, 1)), "opacity_fine": rng.uniform(size=(B, N, 1)),
        "t": np.sort(rng.uniform(1, 3, size=(B, N, S, 1)), axis=2),
        "weights": rng.uniform(size=(B, N, S, 1)) / S,
        "t_fine": np.sort(rng.uniform(1, 3, size=(B, N, S, 1)), axis=2),
        "weights_fine": rng.uniform(size=(B, N, S, 1)) / S,
        "depth": rng.uniform(1, 3, size=(B, N, 1)), "depth_fine": rng.uniform(1, 3, size=(B, N, 1)),
    }
    out = {k: v.astype(np.float32) for k, v in out.items()}
    gt = rng.uniform(size=(B, N, 3)).astype(np.float32)
    fg = (rng.uniform(size=(B, N, 1)) > 0.5).astype(np.float32)
    lw = {"fg_mask": 0, "distortion": 0, "depth_patch": 0}
    for huber in (True, False):
        def total_j(o):
            ld = jphoto.photometric_and_regu_loss(o, gt, fg, huber, lw, 2, gate=1.0)
            return sum(ld.values()), ld

        (tot_j, ld_j), g_j = jax.value_and_grad(total_j, has_aux=True)(out)
        o_t = {k: t(v, requires_grad=True) for k, v in out.items()}
        ld_t = tphoto.photometric_and_regu_loss(o_t, t(gt), t(fg), huber, lw, 2, gate=1.0)
        sum(ld_t.values()).backward()
        for k in ld_j:
            assert_close(ld_t[k], ld_j[k], atol=0, rtol=1e-5, what=k)
        for k in out:
            assert_close(o_t[k].grad, g_j[k], atol=1e-5, what=k)
    img = rng.uniform(size=(B, 3, 4, 5)).astype(np.float32)
    idx = rng.randint(0, 20, size=(B, 7))
    assert_close(tphoto.gather_pixels_at_rays(t(img), torch.as_tensor(idx)),
                 jphoto.gather_pixels_at_rays(img, idx), atol=0)
    assert_close(tphoto.gather_pixels_at_rays(t(img), torch.as_tensor(idx[0])),
                 jphoto.gather_pixels_at_rays(img, idx[0]), atol=0)


@pytest.mark.parametrize("checks", [False, True])
def test_corres_reprojection_loss(checks):
    cfg = ConfigDict(diff_loss_type="huber",
                     renderrepro_do_pixel_reprojection_check=checks,
                     renderrepro_pixel_reprojection_thresh=3.0,
                     renderrepro_do_depth_reprojection_check=checks,
                     renderrepro_depth_reprojection_thresh=0.1)
    rng = np.random.RandomState(2)
    N = 24
    pix_s = rng.randint(0, 16, size=(N, 2)).astype(np.float32)
    pix_o = pix_s + rng.normal(size=(N, 2)).astype(np.float32)
    d_s = rng.uniform(2, 3, size=(N,)).astype(np.float32)
    d_o = rng.uniform(2, 3, size=(N,)).astype(np.float32)
    K = np.array([[[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]]], np.float32)
    T = np.eye(4, dtype=np.float32)[None]
    T[0, :3, 3] = [0.05, -0.02, 0.01]
    conf = rng.uniform(0.5, 1, size=(N,)).astype(np.float32)

    def f_j(ds, do, Tm):
        return jcorres.compute_render_and_repro_loss_w_repro_thres(
            cfg, pix_s, ds, K, pix_o, do, K, Tm, conf)

    v_j, g_j = jax.value_and_grad(f_j, argnums=(0, 1, 2))(d_s, d_o, T)
    ds, do, Tm = t(d_s, True), t(d_o, True), t(T, True)
    v_t = tcorres.compute_render_and_repro_loss_w_repro_thres(
        cfg, t(pix_s), ds, t(K), t(pix_o), do, t(K), Tm, t(conf))
    v_t.backward()
    assert_close(v_t, v_j, atol=0, rtol=1e-5)
    for x, b in zip((ds, do, Tm), g_j):  # d_other enters only through a detached check
        assert_close(torch.zeros_like(x) if x.grad is None else x.grad, b, atol=1e-5)


def test_nearest_pose_by_angle():
    rng = np.random.RandomState(3)
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(5, 3))
    for i in range(5):
        assert int(tdc.nearest_pose_id_by_angle(t(poses), torch.tensor(i))) == int(
            jdc.nearest_pose_id_by_angle(jnp.asarray(poses), jnp.asarray(i)))


@pytest.mark.parametrize("mode", ["plain", "center", "fg_mask", "patch"])
def test_ray_sampler_with_injected_draws(monkeypatch, mode):
    rng = np.random.RandomState(4)
    H, W, B = 12, 16, 3
    fg = np.zeros((B, 1, H, W), bool)
    fg[:, :, 3:9, 4:12] = True
    scene = {"image": rng.uniform(size=(B, 3, H, W)).astype(np.float32), "fg_mask": fg}
    cfg = ConfigDict(precrop_frac=0.5, depth_regu_patch_size=2,
                     sample_fraction_in_fg_mask=0.5 if mode == "fg_mask" else 0.0,
                     sampled_fraction_in_center=0.25 if mode == "center" else 0.0,
                     loss_weight=ConfigDict(depth_patch=0 if mode == "patch" else None))
    shim = patch_jax_draws(monkeypatch, [jsamp], seed=5)
    idx_j = jsamp.make_ray_sampler(cfg, scene)(jax.random.PRNGKey(0), 48)
    sampler_t = tsamp.make_ray_sampler(cfg, scene)
    idx_t = sampler_t(ReplayDraws(shim.recorded), 48)
    np.testing.assert_array_equal(to_np(idx_t), np.asarray(idx_j))
    idx_j = jsamp.make_ray_sampler(cfg, scene)(jax.random.PRNGKey(1), 48, sample_in_center=True)
    n = len(shim.recorded)
    idx_t = sampler_t(ReplayDraws(shim.recorded[n // 2:]), 48, sample_in_center=True)
    np.testing.assert_array_equal(to_np(idx_t), np.asarray(idx_j))


def test_l1_loss_matches_jax():
    rng = np.random.RandomState(11)
    a, b = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    assert_close(tL.l1_loss(t(a), t(b)), jL.l1_loss(jnp.asarray(a), jnp.asarray(b)), atol=0, rtol=1e-6)
