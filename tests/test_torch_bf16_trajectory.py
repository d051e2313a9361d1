"""A short bf16 training trajectory of the port against the JAX trainer on
the interpret-mode Pallas kernels (tests/test_torch_bf16_trainer.py's
setup): N_STEPS steps across the stage switch at 30 (poses frozen, fine
sampling on) and the start of coarse-to-fine PE at 40, on shared numpy-made
draws. At every step the loss and the pose error after alignment are held to
bounds that grow with the step n, as tests/test_torch_trajectory.py does for
float32, wider because a bf16 flip moves a step more than float32 summation
order does:
  loss                 |port - JAX| <= (5e-4 + 5e-5 n) |JAX|
  rotation error, deg  |port - JAX| <= 2e-3 + 2e-4 n
  translation error    |port - JAX| <= 1e-4 + 1e-5 n
Measured on the CPU: largest gaps 4.7e-4 of the loss, 1.4e-3 deg, 1.5e-4;
at most 0.37 of a bound (translation); over 200 steps (max_iter 400, the
switch at 120) 3.3e-3, 2.7e-3 deg, 1.6e-4, at most 0.61 of a bound. Then
the training CLI and the eval entry point at bf16.
"""
import numpy as np
import torch

from test_torch_bf16_trainer import trainers
from traced_draws import JaxStepper
from sparf_tpu_torch.utils import alignment
from sparf_tpu_torch.utils.draws import ReplayDraws

N_STEPS = 45
LOSS_REL = (5e-4, 5e-5)
ROT_DEG = (2e-3, 2e-4)
TRANS = (1e-4, 1e-5)


def test_bf16_trajectory_matches_jax(tmp_path, monkeypatch):
    jt, tt = trainers(tmp_path, monkeypatch)
    switch = tt.iter_end_joint
    assert 0 < switch < N_STEPS
    stepper = JaxStepper(jt, monkeypatch)
    rng = np.random.RandomState(0)
    gt = np.asarray(jt.train_scene_np["pose"])
    rows = []
    for it in range(N_STEPS):
        jt.state, stats_j, replay = stepper.step(it, jt.state, rng)
        draws = ReplayDraws(replay)
        tt.state, stats_t = tt.get_step(it)(tt.state, draws)
        ej = alignment.evaluate_any_poses(np.asarray(jt.current_poses_w2c(), np.float32), gt)
        et = alignment.evaluate_any_poses(tt.current_poses_w2c().detach().numpy(), gt)
        rows.append((float(stats_j["all"]), float(stats_t["all"]), ej["error_R"], et["error_R"],
                     ej["error_t"], et["error_t"]))
    rows = np.asarray(rows)
    n = np.arange(N_STEPS)
    gaps = np.abs(rows[:, 1::2] - rows[:, 0::2])
    print(f"largest gaps: loss rel {np.max(gaps[:, 0] / np.abs(rows[:, 0])):.3g}, "
          f"rot {gaps[:, 1].max():.3g} deg, trans {gaps[:, 2].max():.3g}; shares of the bounds "
          f"{np.max(gaps[:, 0] / ((LOSS_REL[0] + LOSS_REL[1] * n) * np.abs(rows[:, 0]))):.3g} "
          f"{np.max(gaps[:, 1] / (ROT_DEG[0] + ROT_DEG[1] * n)):.3g} "
          f"{np.max(gaps[:, 2] / (TRANS[0] + TRANS[1] * n)):.3g}")
    assert rows[switch - 1, 2] < rows[0, 2]  # the poses moved in the joint stage
    assert np.all(rows[switch:, 3] == rows[switch, 3])
    assert np.all(gaps[:, 0] <= (LOSS_REL[0] + LOSS_REL[1] * n) * np.abs(rows[:, 0]))
    assert np.all(gaps[:, 1] <= ROT_DEG[0] + ROT_DEG[1] * n)
    assert np.all(gaps[:, 2] <= TRANS[0] + TRANS[1] * n)
    assert int(tt.state.nan_count) == int(jt.state.nan_count) == 0


def test_cli_trains_and_evaluates_in_bf16(tmp_path):
    """--tpu.compute_dtype=bfloat16 through the training CLI (10 debug
    iterations, validation, snapshots) and the eval entry point, on the CPU."""
    from torch_entry_common import TINY

    from sparf_tpu_torch import eval as teval
    from sparf_tpu_torch import run_trainval

    trainer = run_trainval.main(
        ["joint_pose_nerf_training/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
         "--device", "cpu", "--workspace_dir", str(tmp_path), *TINY, "--optim.test_iter=2",
         "--tpu.compute_dtype=bfloat16"])
    assert trainer.render_cfg.mlp.compute_dtype == torch.bfloat16
    assert trainer.state.iteration == 10 and int(trainer.state.nan_count) == 0
    res = teval.main(["--ckpt_dir", trainer.workspace, "--device", "cpu", "--out_dir",
                      str(tmp_path / "ev"), "--expname", "e"])
    for k in ("psnr", "rot_error"):
        assert np.isfinite(res["latest"]["w_test_optim"][k]), k
