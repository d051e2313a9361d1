"""One SPARF training step of sparf_tpu_torch against the JAX trainer.

The tiny sparf config of __graft_entry__._flagship_cfg (24x32 synthetic
scene, 4x64 MLP, 32+16 samples, 16 rays) with GT-depth correspondences. The
port starts from the JAX trainer's converted parameters and initial poses;
both take the same random draws (numpy-made, fed to the JAX modules through a
stand-in `jax` and to the port through ReplayDraws). One step is compared in
the joint coarse stage (iteration 0) and in the fine, frozen-pose stage
(iteration 350): every loss and scalar stat, the gradients (recovered from
Adam's first moment, mu = 0.1 g after one step from zero), and the updated
parameters.

Tolerances (float32, different summation orders, ray marching over 48
samples): losses rtol 1e-4; gradients within 1e-3 of each tensor's largest
magnitude; updated parameters atol 1e-6 (one Adam step moves a parameter by
at most lr = 5e-4 for the NeRF, 1e-3 for the poses, times g/(|g|+eps)).
"""
import dataclasses
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import assert_close, assert_close_scaled, patch_jax_draws, to_np

import __graft_entry__
from sparf_tpu.configs.config import ConfigDict, override_options
from sparf_tpu.models import renderer as jren
from sparf_tpu.training import sampling as jsamp
from sparf_tpu.training.joint_trainer import PoseAndNerfTrainerPerScene as JaxTrainer
from sparf_tpu.training.losses import corres as jcorres
from sparf_tpu.training.losses import depth_cons as jdc
from sparf_tpu_torch.convert import nerf_params_from_jax, pose_params_from_jax
from sparf_tpu_torch.training import engine as teng
from sparf_tpu_torch.training.joint_trainer import PoseAndNerfTrainerPerScene as TorchTrainer
from sparf_tpu_torch.utils.draws import ReplayDraws


def _cfg():
    return override_options(__graft_entry__._flagship_cfg(1), ConfigDict(
        use_gt_correspondences=True, tpu=ConfigDict(donate_state=False)))


@pytest.fixture(scope="module")
def trainers():
    jt = JaxTrainer(_cfg(), workspace=tempfile.mkdtemp(prefix="sparf_jax_"))
    tt = TorchTrainer(_cfg(), workspace=tempfile.mkdtemp(prefix="sparf_torch_"), device="cpu",
                      initial_poses_w2c=np.asarray(jt.initial_poses_w2c))
    tt.state.nerf_params = nerf_params_from_jax(to_np(jt.state.nerf_params))
    tt.state.pose_params = pose_params_from_jax(to_np(jt.state.pose_params))
    return jt, tt


def _mu(opt_state):
    """Adam's first moment inside the JAX engine's optax chain state."""
    return next(s.mu for s in opt_state if hasattr(s, "mu"))


@pytest.mark.parametrize("iteration,stage", [(0, "joint_coarse"), (350, "fine_frozen_poses")])
def test_one_step_matches_jax(monkeypatch, trainers, iteration, stage):
    jt, tt = trainers
    assert tt.stage_signature(iteration) == jt.stage_signature(iteration)
    assert jt.optimize_poses_at(iteration) == (stage == "joint_coarse")

    shim = patch_jax_draws(monkeypatch, [jsamp, jcorres, jdc, jren], seed=iteration + 1)
    state_j = jt.state.replace(iteration=jnp.asarray(iteration, jnp.int32),
                               iteration_nerf=jnp.asarray(iteration, jnp.int32))
    new_j, stats_j = jt.get_step(iteration)(state_j)
    state_t = dataclasses.replace(tt.state, iteration=iteration, iteration_nerf=iteration)
    draws = ReplayDraws(shim.recorded)
    new_t, stats_t = tt.get_step(iteration)(state_t, draws)
    assert not draws.arrays, "the port consumed fewer draws than the JAX step"
    # 6 index draws + 4 stratified renders + the virtual-pose weight + the
    # virtual render; the fine stage adds one inverse-CDF draw per stratified render
    assert len(shim.recorded) == (12 if stage == "joint_coarse" else 17)

    for k in ("all", "render", "corres", "depth_cons"):
        assert k in stats_t
    for k, v in stats_j.items():
        assert_close(stats_t[k], v, atol=1e-7, rtol=1e-4, what=k)
    assert int(new_t.nan_count) == int(new_j.nan_count) == 0

    # gradients, through Adam's first moment after one step from zero
    mu_j = teng.tree_leaves(nerf_params_from_jax(to_np(_mu(new_j.opt_state_nerf))))
    for a, b in zip(new_t.opt_state_nerf.mu, mu_j):
        assert_close_scaled(a / 0.1, b / 0.1, 1e-3, "nerf grad")
    if stage == "joint_coarse":
        mu_pj = _mu(new_j.opt_state_pose)
        assert_close_scaled(new_t.opt_state_pose.mu[0] / 0.1,
                            np.asarray(mu_pj["pose_embedding"]) / 0.1, 1e-3, "pose grad")

    # updated parameters
    p_j = teng.tree_leaves(nerf_params_from_jax(to_np(new_j.nerf_params)))
    for a, b in zip(teng.tree_leaves(new_t.nerf_params), p_j):
        assert_close(a, b, atol=1e-6)
    assert_close(new_t.pose_params["pose_embedding"], new_j.pose_params["pose_embedding"],
                 atol=1e-6)
    moved = float((new_t.pose_params["pose_embedding"]
                   - tt.state.pose_params["pose_embedding"]).abs().max())
    assert (moved > 0) == (stage == "joint_coarse")
