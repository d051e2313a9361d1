"""The port's import boundary: sparf_tpu_torch imports, and its CPU train and
eval entry points run, in a fresh interpreter with JAX, the JAX package,
OpenCV, imageio and PIL blocked (none is on the card's machine), so that the
lazy imports inside functions are covered too. The interpreter runs with
the workers' thread cap (torch_parity.run_python)."""
import os

from torch_entry_common import REPO, TINY
from torch_parity import BLOCK, run_python


def test_package_imports_without_jax():
    code = BLOCK + (
        "import pkgutil, importlib\n"
        "import sparf_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(sparf_tpu_torch.__path__, 'sparf_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for m in ('training.joint_trainer', 'training.metrics', 'training.lpips',\n"
        "          'training.checkpointing', 'eval', 'configs.presets', 'admin',\n"
        "          'datasets.dtu', 'datasets.llff', 'utils.alignment', 'utils.imgproc',\n"
        "          'models.pdcnet', 'models.sparse_matcher', 'parallel.mesh', 'parallel.dryrun',\n"
        "          'scripts.profile_step', 'scripts.validate_dataset',\n"
        "          'scripts.test_matcher_installation'):\n"
        "    assert 'sparf_tpu_torch.' + m in mods, mods\n"
        "print(len(mods))\n"
    )
    proc = run_python(code, REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30


def test_entry_points_run_without_jax_package(tmp_path):
    """The tiny CPU training run and its evaluation, with JAX and the JAX
    package blocked, so that the lazy imports inside functions are covered."""
    args = ["joint_pose_nerf_training/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
            "--device", "cpu", "--workspace_dir", str(tmp_path), *TINY, "--optim.test_iter=2"]
    code = BLOCK + (
        "from sparf_tpu_torch import eval as teval, run_trainval\n"
        f"trainer = run_trainval.main({args!r})\n"
        "assert trainer.state.iteration == 10\n"
        f"res = teval.main(['--ckpt_dir', trainer.workspace, '--device', 'cpu', "
        f"'--out_dir', {str(tmp_path / 'ev')!r}, '--expname', 'e'])\n"
        "print(res['latest']['w_test_optim']['lpips_tag'])\n"
    )
    proc = run_python(code, REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "lpips(selfsup)"
    assert os.path.exists(tmp_path / "ev" / "e.json")
