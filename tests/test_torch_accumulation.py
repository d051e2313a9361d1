"""Gradient accumulation (grad_acc_steps = 2) against the JAX trainer's
optax.MultiSteps, and a snapshot resumed mid-accumulation.

The trajectory test's config (tests/test_torch_trajectory.py) with
grad_acc_steps = 2, nine steps in the joint stage on shared draws, the
fourth with a NaN in one stratified draw, so that its gradients are not
finite. After every step the NeRF parameters, the accumulator and the
mini-step counter, the inner Adam's count, mu and nu, and the pose
parameters and their Adam state are held to JAX's; the non-finite step
leaves all of it as it was in both packages, and does not count toward k.

Tolerances (float32; the gradients agree to ~1e-4 of their scale, as in
tests/test_torch_slice.py): parameters atol 1e-6 (a step moves a parameter
by at most lr = 5e-4 for the NeRF, 1e-3 for the poses, times
g / (|g| + eps)); the accumulator and Adam's mu within 1e-3 of each
tensor's largest magnitude; nu within 2e-3 (a square); counts exactly.
"""
import numpy as np
import torch

from test_torch_trajectory import trainers
from torch_parity import assert_close, assert_close_scaled, to_np
from traced_draws import JaxStepper
from sparf_tpu_torch.convert import nerf_params_from_jax
from sparf_tpu_torch.training import checkpointing, engine
from sparf_tpu_torch.utils.draws import Draws, ReplayDraws

N_STEPS = 9
NAN_STEP = 3


def _adam(chain_state):
    return next(s for s in chain_state if hasattr(s, "mu"))


def _nerf_leaves(tree_j):
    return engine.tree_leaves(nerf_params_from_jax(to_np(tree_j)))


def _put_nan_in_a_stratified_draw(fed, replay):
    i = next(i for i, a in enumerate(replay) if a.dtype == np.float32 and a.ndim == 4)
    fed[i] = fed[i].copy()
    replay[i] = replay[i].copy()
    fed[i][0, 0, 0, 0] = replay[i][0, 0, 0, 0] = np.nan


def test_accumulation_matches_jax(tmp_path, monkeypatch):
    jt, tt = trainers(tmp_path, grad_acc_steps=2)
    assert isinstance(tt.tx_nerf, engine.MultiSteps) and tt.tx_nerf.k == 2
    stepper = JaxStepper(jt, monkeypatch)
    rng = np.random.RandomState(5)
    state_j, state_t = jt.state, tt.state
    applied = 0
    for it in range(N_STEPS):
        before_t = state_t
        edit = _put_nan_in_a_stratified_draw if it == NAN_STEP else None
        state_j, _, replay = stepper.step(it, state_j, rng, edit=edit)
        state_t, _ = tt.get_step(it)(state_t, ReplayDraws(replay))
        acc_j, acc_t = state_j.opt_state_nerf, state_t.opt_state_nerf
        finite = it != NAN_STEP
        assert int(state_t.nan_count) == int(state_j.nan_count) == (0 if it < NAN_STEP else 1)
        if not finite:
            for a, b in zip(engine.tree_leaves(state_t.nerf_params),
                            engine.tree_leaves(before_t.nerf_params)):
                assert torch.equal(a, b)
            for a, b in zip(acc_t.acc, before_t.opt_state_nerf.acc):
                assert torch.equal(a, b)
        else:
            applied += int(acc_t.mini_step) == 0
        # counters: the dropped step does not count toward k
        assert int(acc_t.mini_step) == int(acc_j.mini_step)
        inner_j = _adam(acc_j.inner_opt_state)
        assert int(acc_t.inner.count) == int(inner_j.count) == int(acc_j.gradient_step) == applied
        for a, b in zip(acc_t.acc, _nerf_leaves(acc_j.acc_grads)):
            assert_close_scaled(a, b, 1e-3, f"accumulator, step {it}")
        for a, b in zip(acc_t.inner.mu, _nerf_leaves(inner_j.mu)):
            assert_close_scaled(a, b, 1e-3, f"mu, step {it}")
        for a, b in zip(acc_t.inner.nu, _nerf_leaves(inner_j.nu)):
            assert_close_scaled(a, b, 2e-3, f"nu, step {it}")
        for a, b in zip(engine.tree_leaves(state_t.nerf_params),
                        _nerf_leaves(state_j.nerf_params)):
            assert_close(a, b, atol=1e-6, what=f"NeRF parameters, step {it}")
        # the pose optimizer steps on every finite iteration
        pose_j = _adam(state_j.opt_state_pose)
        finite_so_far = it + 1 - int(it >= NAN_STEP)
        assert int(state_t.opt_state_pose.count) == int(pose_j.count) == finite_so_far
        assert_close_scaled(state_t.opt_state_pose.mu[0], np.asarray(pose_j.mu["pose_embedding"]),
                            1e-3, f"pose mu, step {it}")
        assert_close(state_t.pose_params["pose_embedding"],
                     state_j.pose_params["pose_embedding"], atol=1e-6,
                     what=f"pose parameters, step {it}")
    assert applied == (N_STEPS - 1) // 2


def _run(trainer, state, first, n, seed):
    draws = Draws(seed, "cpu")
    for it in range(first, first + n):
        state, _ = trainer.get_step(it)(state, draws)
    return state


def test_snapshot_resumed_mid_accumulation(tmp_path):
    """Three steps, a snapshot (one mini-step accumulated), then three more:
    a trainer that loads the snapshot ends bit for bit where the
    uninterrupted one does."""
    _, tt = trainers(tmp_path, grad_acc_steps=2)
    state = _run(tt, tt.state, 0, 3, seed=1)
    assert int(state.opt_state_nerf.mini_step) == 1
    assert any(float(a.abs().max()) > 0 for a in state.opt_state_nerf.acc)
    checkpointing.save_snapshot(str(tmp_path / "ws"), state, 0.0, 0)
    uninterrupted = _run(tt, state, 3, 3, seed=2)

    _, resumed = trainers(tmp_path / "b", grad_acc_steps=2)
    resumed.workspace = str(tmp_path / "ws")
    assert resumed.load_snapshot("latest")
    assert resumed.state.iteration == 3 and int(resumed.state.opt_state_nerf.mini_step) == 1
    after = _run(resumed, resumed.state, 3, 3, seed=2)
    assert after.iteration == uninterrupted.iteration == 6
    for a, b in zip(_tensors(after), _tensors(uninterrupted)):
        assert torch.equal(a, b)


def _tensors(state):
    acc, pose = state.opt_state_nerf, state.opt_state_pose
    return (engine.tree_leaves(state.nerf_params) + engine.tree_leaves(state.pose_params)
            + [acc.mini_step, acc.inner.count, pose.count]
            + acc.acc + acc.inner.mu + acc.inner.nu + pose.mu + pose.nu)
