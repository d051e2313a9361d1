"""The CLI trains on raw PDC-Net flows (bundled weights) in a fresh
interpreter with JAX, the JAX package and OpenCV blocked."""
from torch_entry_common import RAW_PDCNET, REPO
from torch_parity import BLOCK, run_python


def test_cli_trains_on_raw_pdcnet_flows_without_jax_or_cv2(tmp_path):
    """The tiny CPU training run on pools from the port's PDC-Net, in a fresh
    interpreter with JAX, the JAX package and OpenCV blocked."""
    args = ["joint_pose_nerf_training/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
            "--device", "cpu", "--workspace_dir", str(tmp_path), *RAW_PDCNET]
    code = BLOCK + (
        "from sparf_tpu_torch import run_trainval\n"
        f"trainer = run_trainval.main({args!r})\n"
        "assert trainer.state.iteration == 10 and int(trainer.state.nan_count) == 0\n"
        "pools = trainer.corres_pools\n"
        "print(pools['backend'], pools['n_pairs'])\n"
    )
    proc = run_python(code, REPO)
    assert proc.returncode == 0, proc.stderr
    backend, n_pairs = proc.stdout.strip().splitlines()[-1].split()
    assert backend == "pdcnet_jax" and int(n_pairs) > 0
    log = (tmp_path / "joint_pose_nerf_training/synthetic/sparf/spheres/train.log").read_text()
    assert "correspondence precompute [pdcnet_jax]" in log
