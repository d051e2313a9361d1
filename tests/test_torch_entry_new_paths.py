"""The CLI on the trainer paths added last, each in a fresh interpreter with
JAX, the JAX package, OpenCV, imageio and PIL blocked (torch_parity.BLOCK)
and the workers' thread cap: the fixed-pose trainer
(nerf_fixed_noisy_poses/synthetic/sparf) trains with its poses frozen, and
DS-NeRF (nerf_training_w_gt_poses with SparseCOLMAPDepthLoss) triangulates
its depth supervision and trains on it (weight 10^0: no preset weighs the
loss, and a loss without a weight is only reported)."""
from torch_entry_common import REPO, TINY
from torch_parity import BLOCK, run_python


def test_cli_trains_fixed_poses_without_jax(tmp_path):
    args = ["nerf_fixed_noisy_poses/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
            "--device", "cpu", "--workspace_dir", str(tmp_path), *TINY]
    code = BLOCK + (
        "from sparf_tpu_torch import run_trainval\n"
        f"trainer = run_trainval.main({args!r})\n"
        "assert type(trainer).__name__ == 'NerfTrainerPerSceneWColmapFixedPoses'\n"
        "assert trainer.state.iteration == 10 and int(trainer.state.nan_count) == 0\n"
        "moved = (trainer.current_poses_w2c() - trainer.initial_poses_w2c).abs().max()\n"
        "assert float(moved) < 1e-5, moved  # the pose parametrization's rounding only\n"
        "print(trainer.evaluate_poses()['error_R'])\n"
    )
    proc = run_python(code, REPO)
    assert proc.returncode == 0, proc.stderr
    assert float(proc.stdout.strip().splitlines()[-1]) > 1.0  # the frozen noisy poses
    log = (tmp_path / "nerf_fixed_noisy_poses/synthetic/sparf/spheres/train.log").read_text()
    assert "iter 10/10" in log


def test_cli_dsnerf_run_without_jax(tmp_path):
    args = ["nerf_training_w_gt_poses/synthetic", "nerf", "--scene", "spheres", "--debug", "True",
            "--device", "cpu", "--workspace_dir", str(tmp_path), *TINY,
            "--loss_type=photometric_and_SparseCOLMAPDepthLoss", "--loss_weight.colmap_depth=0.0"]
    code = BLOCK + (
        "from sparf_tpu_torch import run_trainval\n"
        f"trainer = run_trainval.main({args!r})\n"
        "assert trainer.state.iteration == 10 and int(trainer.state.nan_count) == 0\n"
        "_, stats = trainer.get_step(10)(trainer.state, trainer.draws)\n"
        "weighted = {k: float(v) for k, v in stats.items() if k.endswith('_after_w')}\n"
        "assert weighted.get('colmap_depth_after_w', 0) > 0, weighted  # trained on, not only shown\n"
        "assert abs(sum(weighted.values()) - float(stats['all'])) < 1e-5 * float(stats['all'])\n"
        "print(int((trainer.train_scene['colmap_depth'] > 0).sum()))\n"
    )
    proc = run_python(code, REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) > 50
    log = (tmp_path / "nerf_training_w_gt_poses/synthetic/nerf/spheres/train.log").read_text()
    assert "triangulating matches with known poses for SparseCOLMAPDepthLoss" in log
