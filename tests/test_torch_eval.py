"""The evaluation path of sparf_tpu_torch against the JAX package: the
chunked full-image render, validation and test evaluation of the joint
trainer started from the JAX trainer's parameters and poses, and test-time
pose refinement with injected pixel indices against a reference loop of the
JAX renderer and optax.adam.

Tiny sparf config (24x32 scene, 4x64 MLP, 32+16 samples, 16 rays), with 4
point and 2 view PE frequencies instead of 10 and 4: at 10, the gradient of
the photometric loss with respect to the pose twist is ill-conditioned in
float32 (a 1e-7 change of the pose moves the JAX package's own gradient by
~5%, through the 2^9 pi phases of the PE), so two float32 implementations
cannot agree on it to better than that. Tolerances (float32): renders atol
1e-5; per-image metrics within 1e-4 (PSNR relative, the others absolute:
SSIM/LPIPS/depth errors are O(1)); refined twists atol 1e-5 after 3 Adam
steps of lr 1e-3.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import assert_close, t, to_np

import __graft_entry__
from sparf_tpu.configs.config import ConfigDict, override_options
from sparf_tpu.models import nerf_mlp as jmlp
from sparf_tpu.models import renderer as jren
from sparf_tpu.training.joint_trainer import PoseAndNerfTrainerPerScene as JaxTrainer
from sparf_tpu.training.losses import base as jloss
from sparf_tpu.utils import camera as jcam
from sparf_tpu_torch.convert import nerf_params_from_jax, pose_params_from_jax
from sparf_tpu_torch.models import nerf_mlp as tmlp
from sparf_tpu_torch.models import renderer as tren
from sparf_tpu_torch.ops import fused_mlp as fm
from sparf_tpu_torch.training.joint_trainer import PoseAndNerfTrainerPerScene as TorchTrainer
from sparf_tpu_torch.utils.draws import ReplayDraws

SMALL = dict(layers_feat=(64,) * 4, layers_rgb=(32, 3), skip=(2,), L_3D=6, L_view=2)
ITER = 350  # fine sampling on, c2f progress 0.35


@pytest.mark.parametrize("fine", [False, True])
def test_render_image_chunked_matches_jax(monkeypatch, fine):
    cfg_j = jren.RenderConfig(mlp=jmlp.MLPConfig(**SMALL), sample_intvs=32,
                              sample_intvs_fine=16, fine_sampling=True)
    cfg_t = tren.RenderConfig(mlp=tmlp.MLPConfig(**SMALL), sample_intvs=32,
                              sample_intvs_fine=16, fine_sampling=True)
    params_j = jren.init_graph_params(jax.random.PRNGKey(0), cfg_j)
    pose = np.array([[[1, 0, 0, 0.1], [0, 1, 0, -0.2], [0, 0, 1, 3.0]]], np.float32)
    intr = np.array([[[12.0, 0, 4.5], [0, 12.0, 3.5], [0, 0, 1]]], np.float32)
    dr = np.array([1.5, 4.8], np.float32)
    H, W, chunk = 7, 9, 10  # 63 pixels: the last chunk is padded
    out_j = jren.render_image_chunked(params_j, cfg_j, pose, intr, H, W, jnp.asarray(dr),
                                      jnp.asarray(1.0), fine_enabled=fine, chunk=chunk,
                                      impl="xla")
    k3_calls = []
    real = fm.pack_weights
    monkeypatch.setattr(fm, "pack_weights", lambda *a: k3_calls.append(1) or real(*a))
    params_t = nerf_params_from_jax(to_np(params_j))
    for W_, _ in params_t["coarse"]["feat"]:
        W_.requires_grad_(True)  # no_grad inside: still the forward-only kernel
    out_t = tren.render_image_chunked(params_t, cfg_t, t(pose), t(intr), H, W, t(dr), 1.0,
                                      fine_enabled=fine, chunk=chunk)
    assert sorted(out_t) == sorted(out_j)
    assert ("rgb_fine" in out_t) == fine
    assert len(k3_calls) == 7 * (2 if fine else 1)
    for k in out_j:
        assert out_t[k].shape == out_j[k].shape, k
        assert_close(out_t[k], out_j[k], atol=1e-5, what=k)


def _cfg(**over):
    return override_options(__graft_entry__._flagship_cfg(1), ConfigDict(
        use_gt_correspondences=True, tpu=ConfigDict(donate_state=False), **over))


@pytest.fixture(scope="module")
def trainers():
    over = dict(optim=ConfigDict(test_photo=False, test_iter=3),
                arch=ConfigDict(posenc=ConfigDict(L_3D=4, L_view=2)))
    jt = JaxTrainer(_cfg(**over), workspace=tempfile.mkdtemp(prefix="sparf_jax_eval_"))
    tt = TorchTrainer(_cfg(**over), workspace=tempfile.mkdtemp(prefix="sparf_torch_eval_"),
                      device="cpu", initial_poses_w2c=np.asarray(jt.initial_poses_w2c))
    # one step moves the poses, so the sim3 backtracking is not the identity
    state_j, _ = jt.get_step(0)(jt.state)
    jt.state = state_j.replace(iteration=jnp.asarray(ITER, jnp.int32),
                               iteration_nerf=jnp.asarray(ITER, jnp.int32))
    tt.state = dataclasses.replace(
        tt.state, iteration=ITER, iteration_nerf=ITER,
        nerf_params=nerf_params_from_jax(to_np(jt.state.nerf_params)),
        pose_params=pose_params_from_jax(to_np(jt.state.pose_params)))
    return jt, tt


def _assert_metrics_close(got, ref, what):
    assert sorted(got) == sorted(ref), what
    for k, v in ref.items():
        if isinstance(v, str):
            assert got[k] == v, k
        elif k.startswith("psnr"):
            assert_close(got[k], v, atol=0, rtol=1e-4, what=f"{what} {k}")
        else:
            assert_close(got[k], v, atol=1e-4, what=f"{what} {k}")


def test_validate_matches_jax(trainers):
    jt, tt = trainers
    assert tt.fine_enabled_at(ITER) and jt.fine_enabled_at(ITER)
    ref = jt.validate(ITER)
    got = tt.validate(ITER)
    assert "psnr_fine" in got and "lpips_masked_fine" in got
    _assert_metrics_close(got, ref, "validate")
    assert tt.best_val == pytest.approx(-got["psnr_fine"]) and tt.epoch_of_best_val == ITER


def test_evaluate_full_matches_jax(trainers):
    jt, tt = trainers
    ref = jt.evaluate_full(out_dir=tempfile.mkdtemp(prefix="sparf_jax_eval_out_"),
                           with_test_optim=False)
    got = tt.evaluate_full(out_dir=tempfile.mkdtemp(prefix="sparf_torch_eval_out_"),
                           with_test_optim=False)
    assert len(got["per_image"]) == len(ref["per_image"]) == 1
    for g, r in zip(got["per_image"], ref["per_image"]):
        _assert_metrics_close(g, r, "per-image")
    _assert_metrics_close(got["mean"], ref["mean"], "mean")


def test_test_time_refinement_matches_jax_reference_loop(trainers, monkeypatch):
    """3 steps with the same pixel indices: the port against a loop of the JAX
    render_at_pixels and optax.adam (what the JAX trainer's jitted loop runs)."""
    jt, tt = trainers
    cfg = tt.cfg
    test_scene = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                  for k, v in tt.val_scene_np.items()}  # the synthetic test split
    H, W = test_scene["image"].shape[-2:]
    rng = np.random.RandomState(21)
    idx = [rng.randint(0, H * W, size=(cfg.nerf.rand_rays,)) for _ in range(3)]
    pose, _ = tt.val_pose_and_scale(0)
    monkeypatch.setattr(tt, "test_optim_draws", lambda i: ReplayDraws(idx))
    twist_t = tt.run_test_time_photometric_optim(test_scene, 0, pose)

    params_j = jt.state.nerf_params
    image_flat = jnp.asarray(tt.val_scene_np["image"][:1]).reshape(1, 3, -1).transpose(0, 2, 1)
    intr = jnp.asarray(tt.val_scene_np["intr"][:1])
    dr = jnp.asarray(tt.val_scene_np["depth_range"][0])
    pose_j = jnp.asarray(pose.numpy())
    fine = jt.fine_enabled_at(cfg.max_iter)
    lossf = jloss.huber_loss if cfg.huber_loss_for_photometric else jloss.mse_loss

    def loss_fn(twist, ray_idx):
        pose_refined = jcam.pose_compose([jcam.se3_to_SE3(twist), pose_j])
        px = jnp.stack([(ray_idx % W).astype(jnp.float32) + 0.5,
                        (ray_idx // W).astype(jnp.float32) + 0.5], axis=-1)
        out = jren.render_at_pixels(params_j, jt.render_cfg, pose_refined, intr, px, dr,
                                    jnp.asarray(1.0), key=None, stratified=False,
                                    fine_enabled=fine)
        gt = image_flat[:, ray_idx]
        loss = lossf(out["rgb"], gt)
        return loss + lossf(out["rgb_fine"], gt) if "rgb_fine" in out else loss

    tx = optax.adam(float(cfg.optim.lr_pose))
    twist = jnp.zeros((1, 6))
    opt_state = tx.init(twist)
    grad_fn = jax.jit(jax.grad(loss_fn))
    for ray_idx in idx:
        g = grad_fn(twist, jnp.asarray(ray_idx))
        upd, opt_state = tx.update(g, opt_state, twist)
        twist = optax.apply_updates(twist, upd)
    assert float(jnp.abs(twist).max()) > 1e-4
    assert_close(twist_t, twist, atol=1e-5)
