"""The port's N-step training trajectory against the JAX trainer's.

The tiny sparf config of __graft_entry__._flagship_cfg (24x32 synthetic
scene, 4x64 MLP, 32+16 samples, 16 rays) with GT-depth correspondences and
4 point / 2 view PE frequencies (with 10 the pose-twist gradient is
ill-conditioned in float32, in both packages). max_iter = 400, so that the
200 steps cross the stage switch at 120 (poses frozen, fine sampling on)
and coarse-to-fine PE starts at 160. Both trainers start from the JAX
trainer's parameters and initial poses and take the same numpy-made draws
at every step (tests/traced_draws.py).

At every step the loss and the pose error after alignment (rotation in
degrees, translation) are compared. The two packages sum in different
orders, and the trajectory amplifies float32 rounding, so the tolerance
grows with the step n:
  loss                 |port - JAX| <= (2e-4 + 1e-5 n) |JAX|
  rotation error, deg  |port - JAX| <= 1e-3 + 5e-5 n
  translation error    |port - JAX| <= 5e-5 + 5e-6 n
Measured on the CPU, the largest gaps over the 200 steps are 5.3e-4 of the
loss, 2.7e-3 deg and 2.2e-4, all at step 119, the last joint step; the
tightest is the rotation at step 52, 0.59 of its bound. The poses move by
~1.2 deg in the joint stage, so a pose optimizer off by a few percent
leaves the bound.
"""
import numpy as np

import __graft_entry__
from torch_parity import to_np
from traced_draws import JaxStepper
from sparf_tpu.configs.config import ConfigDict, override_options
from sparf_tpu.training.joint_trainer import PoseAndNerfTrainerPerScene as JaxTrainer
from sparf_tpu_torch.convert import nerf_params_from_jax, pose_params_from_jax
from sparf_tpu_torch.training.joint_trainer import PoseAndNerfTrainerPerScene as TorchTrainer
from sparf_tpu_torch.utils import alignment
from sparf_tpu_torch.utils.draws import ReplayDraws

N_STEPS = 200
MAX_ITER = 400


def cfg_for(**over):
    return override_options(__graft_entry__._flagship_cfg(1), ConfigDict(dict(
        use_gt_correspondences=True, max_iter=MAX_ITER, tpu=ConfigDict(donate_state=False),
        arch=dict(posenc=dict(L_3D=4, L_view=2)), **over)))


def trainers(tmp_path, **over):
    """(JAX trainer, port trainer on the CPU) from the same parameters and poses."""
    jt = JaxTrainer(cfg_for(**over), workspace=str(tmp_path / "jax"))
    tt = TorchTrainer(cfg_for(**over), workspace=str(tmp_path / "torch"), device="cpu",
                      initial_poses_w2c=np.asarray(jt.initial_poses_w2c))
    tt.state.nerf_params = nerf_params_from_jax(to_np(jt.state.nerf_params))
    tt.state.pose_params = pose_params_from_jax(to_np(jt.state.pose_params))
    return jt, tt


def pose_error(poses_w2c, gt):
    e = alignment.evaluate_any_poses(np.asarray(poses_w2c, np.float32), gt)
    return e["error_R"], e["error_t"]


def run_both(jt, tt, monkeypatch, n_steps, seed=0):
    """n_steps of both trainers on shared draws; per step (loss JAX, loss
    port, rotation error JAX, port, translation error JAX, port)."""
    stepper = JaxStepper(jt, monkeypatch)
    rng = np.random.RandomState(seed)
    gt = np.asarray(jt.train_scene_np["pose"])
    rows = []
    state_j, state_t = jt.state, tt.state
    for it in range(n_steps):
        state_j, stats_j, replay = stepper.step(it, state_j, rng)
        draws = ReplayDraws(replay)
        state_t, stats_t = tt.get_step(it)(state_t, draws)
        assert not draws.arrays
        jt.state, tt.state = state_j, state_t
        rj, tj = pose_error(jt.current_poses_w2c(), gt)
        rt, tr = pose_error(tt.current_poses_w2c().detach().numpy(), gt)
        rows.append((float(stats_j["all"]), float(stats_t["all"]), rj, rt, tj, tr))
    return np.asarray(rows)


def test_trajectory_matches_jax(tmp_path, monkeypatch):
    jt, tt = trainers(tmp_path)
    switch = tt.iter_end_joint
    assert switch == 120 and 0 < switch < N_STEPS
    rows = run_both(jt, tt, monkeypatch, N_STEPS)
    n = np.arange(N_STEPS)
    gaps = np.abs(rows[:, 1::2] - rows[:, 0::2])
    print(f"largest gaps: loss rel {np.max(gaps[:, 0] / np.abs(rows[:, 0])):.3g}, "
          f"rot {gaps[:, 1].max():.3g} deg, trans {gaps[:, 2].max():.3g}; "
          f"pose error at the switch JAX {rows[switch, 2]:.4f} deg, port {rows[switch, 3]:.4f}; "
          f"initial {rows[0, 2]:.4f}")
    # the poses moved in the joint stage and stayed put after the switch
    assert rows[switch - 1, 2] < rows[0, 2]
    assert np.all(rows[switch:, 3] == rows[switch, 3])
    assert np.all(gaps[:, 0] <= (2e-4 + 1e-5 * n) * np.abs(rows[:, 0]))
    assert np.all(gaps[:, 1] <= 1e-3 + 5e-5 * n)
    assert np.all(gaps[:, 2] <= 5e-5 + 5e-6 * n)
    assert int(tt.state.nan_count) == int(jt.state.nan_count) == 0
