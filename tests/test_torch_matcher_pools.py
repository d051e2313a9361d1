"""Correspondence pools from the raw PDC-Net matcher (bundled weights,
pdcnet_geometry_refine=False), the port's against the JAX package's, and one
SPARF training step per stage on those pools.

The scene and model are __graft_entry__._flagship_cfg's (24x32 synthetic
scene, 3 views, 4x64 MLP, 32+16 samples, 16 rays). Without geometric
verification the pools hold the same pixels: confidence masks equal except
pixels within 1e-4 of the 0.95 threshold (counted), correspondences within
1e-3 px, confidences within 1e-4. With verification on, RANSAC draws differ
(OpenCV's against the port's generator), so the verified pools are held to
JAX's by agreement rate over the candidate pixels, reported. The training
step takes JAX's pools on both sides (so that a threshold tie on another CPU
cannot change which pixel a draw picks) and the tolerances of
tests/test_torch_slice.py: losses rtol 1e-4, gradients 1e-3 of each
tensor's largest magnitude, updated parameters 1e-6. Adam's step lr x g /
(|g| + 1e-8) amplifies the relative error of a gradient near 1e-8, so an
updated parameter whose gradient is below 1e-4 of its tensor's largest may
differ by more; those are counted (at most 0.1%) and reported.
"""
import dataclasses
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import assert_close, assert_close_scaled, patch_jax_draws, to_np

import __graft_entry__
from sparf_tpu.configs.config import ConfigDict, override_options
from sparf_tpu.datasets import create_dataset
from sparf_tpu.models import renderer as jren
from sparf_tpu.training import sampling as jsamp
from sparf_tpu.training.joint_trainer import PoseAndNerfTrainerPerScene as JaxTrainer
from sparf_tpu.training.losses import corres as jcorres
from sparf_tpu.training.losses import depth_cons as jdc
from sparf_tpu_torch.convert import nerf_params_from_jax, pose_params_from_jax
from sparf_tpu_torch.training import engine as teng
from sparf_tpu_torch.training.joint_trainer import PoseAndNerfTrainerPerScene as TorchTrainer
from sparf_tpu_torch.training.losses import corres as tcorres
from sparf_tpu_torch.utils.draws import ReplayDraws

POOL_KEYS = ("pool_pix_self", "pool_pix_other", "pool_conf", "pool_count", "pair_ids")


def _cfg(**over):
    over = dict(dict(pdcnet_geometry_refine=False, geometric_verification=False,
                     tpu=ConfigDict(donate_state=False)), **over)
    return override_options(__graft_entry__._flagship_cfg(1), ConfigDict(**over))


@pytest.fixture(scope="module")
def scene():
    return create_dataset(_cfg(), "train")


def test_pools_match_jax(scene):
    cfg = _cfg()
    pj = jcorres.build_correspondence_pools(cfg, scene)
    pt = tcorres.build_correspondence_pools(cfg, scene, device="cpu")
    assert pt["backend"] == "pdcnet_jax" and pj["n_pairs"] == pt["n_pairs"] == 6
    assert_close(pt["corres_maps"], pj["corres_maps"], atol=1e-3, what="corres maps")
    assert_close(pt["conf_maps"], pj["conf_maps"], atol=1e-4, what="p_r maps")
    near = np.abs(pj["conf_maps"] - 0.95) < 1e-4
    print(f"pools: {int(near.sum())} pixels within 1e-4 of the 0.95 threshold held out")
    assert near.sum() <= 8
    np.testing.assert_array_equal(pt["mask_valid"][~near], pj["mask_valid"][~near])
    if np.array_equal(pt["mask_valid"], pj["mask_valid"]):
        for k in POOL_KEYS:
            assert_close(pt[k], pj[k], atol=1e-3, what=k)
    assert set(pt["seconds"]) == {"matching", "verification", "pools"}


def test_verified_pools_agree_with_jax(scene):
    cfg = _cfg(geometric_verification=True)
    pj = jcorres.build_correspondence_pools(cfg, scene)
    pt = tcorres.build_correspondence_pools(cfg, scene, device="cpu")
    candidates = tcorres.build_correspondence_pools(_cfg(), scene, device="cpu")["mask_valid"]
    assert not (pt["mask_valid"] & ~candidates).any()  # verification only removes pixels
    agreement = float((pt["mask_valid"] == pj["mask_valid"])[candidates].mean())
    print(f"verified pools: {agreement:.4f} of {int(candidates.sum())} candidate pixels agree "
          f"with the OpenCV-verified pools; kept {int(pt['mask_valid'].sum())} "
          f"(JAX {int(pj['mask_valid'].sum())})")
    assert agreement >= 0.6 and pt["n_pairs"] == pj["n_pairs"]


@pytest.fixture(scope="module")
def trainers(scene):
    jt = JaxTrainer(_cfg(), workspace=tempfile.mkdtemp(prefix="sparf_jax_"))
    jax_pools = jt.corres_pools
    mp = pytest.MonkeyPatch()
    mp.setattr(tcorres, "build_correspondence_pools", lambda *a, **k: jax_pools)
    try:
        tt = TorchTrainer(_cfg(), workspace=tempfile.mkdtemp(prefix="sparf_torch_"),
                          device="cpu", initial_poses_w2c=np.asarray(jt.initial_poses_w2c))
    finally:
        mp.undo()
    tt.state.nerf_params = nerf_params_from_jax(to_np(jt.state.nerf_params))
    tt.state.pose_params = pose_params_from_jax(to_np(jt.state.pose_params))
    return jt, tt


def _mu(opt_state):
    return next(s.mu for s in opt_state if hasattr(s, "mu"))


@pytest.mark.parametrize("iteration,stage", [(0, "joint_coarse"), (350, "fine_frozen_poses")])
def test_one_step_on_matcher_pools_matches_jax(monkeypatch, trainers, iteration, stage):
    jt, tt = trainers
    assert jt.corres_pools["n_pairs"] == 6 and tt.corres_pools is jt.corres_pools
    assert float(np.min(jt.corres_pools["pool_conf"][:, :1])) < 1.0  # p_r weights, not ones
    shim = patch_jax_draws(monkeypatch, [jsamp, jcorres, jdc, jren], seed=iteration + 7)
    state_j = jt.state.replace(iteration=jnp.asarray(iteration, jnp.int32),
                               iteration_nerf=jnp.asarray(iteration, jnp.int32))
    new_j, stats_j = jt.get_step(iteration)(state_j)
    state_t = dataclasses.replace(tt.state, iteration=iteration, iteration_nerf=iteration)
    draws = ReplayDraws(shim.recorded)
    new_t, stats_t = tt.get_step(iteration)(state_t, draws)
    assert not draws.arrays
    assert float(stats_t["corres"]) > 0
    for k, v in stats_j.items():
        assert_close(stats_t[k], v, atol=1e-7, rtol=1e-4, what=k)
    mu_j = teng.tree_leaves(nerf_params_from_jax(to_np(_mu(new_j.opt_state_nerf))))
    for a, b in zip(new_t.opt_state_nerf.mu, mu_j):
        assert_close_scaled(a / 0.1, b / 0.1, 1e-3, "nerf grad")
    if stage == "joint_coarse":
        assert_close_scaled(new_t.opt_state_pose.mu[0] / 0.1,
                            np.asarray(_mu(new_j.opt_state_pose)["pose_embedding"]) / 0.1, 1e-3,
                            "pose grad")
    n_held = n_total = 0
    for a, b, mu in zip(teng.tree_leaves(new_t.nerf_params),
                        teng.tree_leaves(nerf_params_from_jax(to_np(new_j.nerf_params))),
                        new_t.opt_state_nerf.mu):
        off = (a - b).abs().numpy() > 1e-6
        tiny = mu.abs().numpy() < 1e-4 * float(mu.abs().max())
        assert not (off & ~tiny).any()
        n_held += int(off.sum())
        n_total += off.size
    print(f"step at {iteration}: {n_held} of {n_total} NeRF updates off by > 1e-6, all with "
          f"gradients below 1e-4 of their tensor's largest")
    assert n_held <= 1e-3 * n_total

    assert_close(new_t.pose_params["pose_embedding"], new_j.pose_params["pose_embedding"],
                 atol=1e-6)


def test_rematch_rebuilds_the_pools_once_with_the_current_poses():
    """rematch_at_ratio: at the first iteration at or past ratio x max_iter
    the trainer rebuilds its pools with its current poses as the matcher's
    prior and drops its compiled steps; once only (as the JAX trainer)."""
    tt = TorchTrainer(_cfg(rematch_at_ratio=0.5), workspace=tempfile.mkdtemp(prefix="sparf_rm_"),
                      device="cpu")
    before = tt.corres_pools
    tt.get_step(0)
    tt.on_iteration_start(499)
    assert tt.corres_pools is before and tt._step_cache
    tt.on_iteration_start(500)
    assert tt.corres_pools is not before and tt._step_cache == {}
    assert tt.corres_pools["n_pairs"] == before["n_pairs"] == 6
    np.testing.assert_array_equal(tt.matcher_prior_poses_w2c,
                                  tt.current_poses_w2c().detach().numpy())
    rebuilt = tt.corres_pools
    tt.on_iteration_start(501)
    assert tt.corres_pools is rebuilt
