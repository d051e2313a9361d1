"""The port's entry points and its import boundary: the CLI trains 10 debug
iterations on the CPU, with validation and snapshots, resumes, and evaluates;
the eval entry point writes the means with and without test-time pose
refinement; sparf_tpu_torch imports and runs without JAX, without the JAX
package and without OpenCV, on GT-depth correspondences and on raw PDC-Net
flows; the preset's matcher default (PDC-Net with the geometry stage) raises
NotImplementedError naming that stage; asking for a CUDA device that is not
there raises instead of falling back."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread cap)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ["--synthetic.H=24", "--synthetic.W=32", "--synthetic.n_train=3", "--synthetic.n_test=1",
        "--arch.layers_feat=[null,64,64,64,64]", "--arch.layers_rgb=[null,32,3]",
        "--arch.skip=[2]", "--nerf.sample_intvs=32", "--nerf.sample_intvs_fine=16",
        "--nerf.rand_rays=16", "--depth_cons_nbr_rays=16", "--min_nbr_matches=10",
        "--use_gt_correspondences=True", "--max_iter=1000"]


def test_run_trainval_debug_on_cpu(tmp_path):
    from sparf_tpu_torch import run_trainval

    trainer = run_trainval.main(
        ["joint_pose_nerf_training/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
         "--device", "cpu", "--workspace_dir", str(tmp_path), *TINY])
    assert trainer.state.iteration == 10 and trainer.cfg.max_iter == 10
    assert int(trainer.state.nan_count) == 0
    # 10 debug iterations: joint stage until 3, then fine sampling with frozen poses
    assert trainer.iter_end_joint == 3 and trainer.fine_enabled_at(3)
    poses = trainer.current_poses_w2c().detach().numpy()
    assert np.isfinite(poses).all()
    assert not np.allclose(poses, trainer.initial_poses_w2c.numpy())
    assert os.path.exists(tmp_path / "joint_pose_nerf_training/synthetic/sparf/spheres/train.log")


def test_eval_entry_after_cli_training(tmp_path):
    from sparf_tpu_torch import eval as teval
    from sparf_tpu_torch import run_trainval

    args = ["joint_pose_nerf_training/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
            "--device", "cpu", "--workspace_dir", str(tmp_path), *TINY, "--optim.test_iter=2"]
    trainer = run_trainval.main(args)
    ws = trainer.workspace
    # debug cadence: validation and a snapshot every 5 iterations, the last two kept
    assert {"iter-5", "iter-10", "model_best", "pose_history.npz"} <= set(os.listdir(ws))
    assert trainer.epoch_of_best_val in (5, 10)

    res = teval.main(["--ckpt_dir", ws, "--device", "cpu", "--out_dir", str(tmp_path / "ev"),
                      "--expname", "e"])
    with open(tmp_path / "ev" / "e.json") as f:
        written = json.load(f)
    assert sorted(written) == ["iteration", "w_test_optim", "without_test_optim"]
    assert written == json.loads(json.dumps(res["latest"]))
    w, wo = written["w_test_optim"], written["without_test_optim"]
    for k in ("psnr", "ssim", "lpips", "abse_depth", "rot_error", "init_rot_error"):
        assert np.isfinite(w[k]) and np.isfinite(wo[k]), k
    assert "refine_rot_deg" in w and "psnr_no_refine" in w and "refine_rot_deg" not in wo
    assert w["lpips_tag"] == "lpips(selfsup)" and written["iteration"] == 10

    resumed = run_trainval.main(args)  # picks up iter-10: nothing left to train
    assert resumed.state.iteration == 10 and resumed.best_val == trainer.best_val
    run_trainval.main(args + ["--test_metrics_only"])
    assert os.path.exists(tmp_path / "eval/joint_pose_nerf_training/synthetic/sparf/spheres/"
                                     "eval.json")
    with pytest.raises(NotImplementedError):
        run_trainval.main(args + ["--render_video_only"])
    with pytest.raises(NotImplementedError):
        resumed.evaluate_full(plot=True)


# blocks JAX, the JAX package and OpenCV in a fresh interpreter: an import of
# any of them, eager or lazy, then fails
_BLOCK = ("import sys\n"
          "for name in ('jax', 'jaxlib', 'flax', 'optax', 'sparf_tpu', 'cv2'):\n"
          "    sys.modules[name] = None\n")


def test_package_imports_without_jax():
    code = _BLOCK + (
        "import pkgutil, importlib\n"
        "import sparf_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(sparf_tpu_torch.__path__, 'sparf_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for m in ('training.joint_trainer', 'training.metrics', 'training.lpips',\n"
        "          'training.checkpointing', 'eval', 'configs.presets', 'admin',\n"
        "          'datasets.dtu', 'datasets.llff', 'utils.alignment', 'utils.imgproc',\n"
        "          'models.pdcnet', 'models.sparse_matcher'):\n"
        "    assert 'sparf_tpu_torch.' + m in mods, mods\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30


def test_entry_points_run_without_jax_package(tmp_path):
    """The tiny CPU training run and its evaluation, with JAX and the JAX
    package blocked, so that the lazy imports inside functions are covered."""
    args = ["joint_pose_nerf_training/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
            "--device", "cpu", "--workspace_dir", str(tmp_path), *TINY, "--optim.test_iter=2"]
    code = _BLOCK + (
        "from sparf_tpu_torch import eval as teval, run_trainval\n"
        f"trainer = run_trainval.main({args!r})\n"
        "assert trainer.state.iteration == 10\n"
        f"res = teval.main(['--ckpt_dir', trainer.workspace, '--device', 'cpu', "
        f"'--out_dir', {str(tmp_path / 'ev')!r}, '--expname', 'e'])\n"
        "print(res['latest']['w_test_optim']['lpips_tag'])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "lpips(selfsup)"
    assert os.path.exists(tmp_path / "ev" / "e.json")


# raw PDC-Net flows (bundled weights) instead of GT-depth correspondences
RAW_PDCNET = [a for a in TINY if not a.startswith("--use_gt_correspondences")] + [
    "--use_gt_correspondences=False", "--flow_backbone=PDCNet", "--pdcnet_geometry_refine=false"]


def test_cli_trains_on_raw_pdcnet_flows_without_jax_or_cv2(tmp_path):
    """The tiny CPU training run on pools from the port's PDC-Net, in a fresh
    interpreter with JAX, the JAX package and OpenCV blocked."""
    args = ["joint_pose_nerf_training/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
            "--device", "cpu", "--workspace_dir", str(tmp_path), *RAW_PDCNET]
    code = _BLOCK + (
        "from sparf_tpu_torch import run_trainval\n"
        f"trainer = run_trainval.main({args!r})\n"
        "assert trainer.state.iteration == 10 and int(trainer.state.nan_count) == 0\n"
        "pools = trainer.corres_pools\n"
        "print(pools['backend'], pools['n_pairs'])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    backend, n_pairs = proc.stdout.strip().splitlines()[-1].split()
    assert backend == "pdcnet_jax" and int(n_pairs) > 0
    log = (tmp_path / "joint_pose_nerf_training/synthetic/sparf/spheres/train.log").read_text()
    assert "correspondence precompute [pdcnet_jax]" in log


def test_preset_matcher_default_raises_naming_the_geometry_stage(tmp_path):
    """Without overrides the config is the JAX package's: PDC-Net with the
    geometry stage, which the port has not ported; it raises, it does not
    fall back to GT depth or another matcher."""
    from sparf_tpu_torch import run_trainval

    args = ["joint_pose_nerf_training/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
            "--device", "cpu", "--workspace_dir", str(tmp_path),
            *[a for a in TINY if not a.startswith("--use_gt_correspondences")]]
    with pytest.raises(NotImplementedError, match="geometry stage.*item 19"):
        run_trainval.main(args)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sparf_tpu_torch.training.trainer import resolve_device

    with pytest.raises(RuntimeError):
        resolve_device("cuda")
