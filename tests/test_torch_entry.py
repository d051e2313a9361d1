"""The port's entry point and its import boundary: the CLI trains 10 debug
iterations on the CPU; sparf_tpu_torch imports without JAX; asking for a CUDA
device that is not there raises instead of falling back."""
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


def test_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import sparf_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(sparf_tpu_torch.__path__, 'sparf_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'sparf_tpu_torch.training.joint_trainer' in mods, mods\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sparf_tpu_torch.training.trainer import resolve_device

    with pytest.raises(RuntimeError):
        resolve_device("cuda")
