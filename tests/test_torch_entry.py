"""The port's entry points and its import boundary: the CLI trains 10 debug
iterations on the CPU, with validation and snapshots, resumes, and evaluates;
the eval entry point writes the means with and without test-time pose
refinement; sparf_tpu_torch imports and runs without JAX, the JAX package,
OpenCV, imageio and PIL, on GT-depth correspondences and on raw PDC-Net
flows; the preset's matcher default (PDC-Net with the geometry stage) trains
and logs its route; SfM initial poses build a joint trainer, on GT-depth
matches and on the matcher's own flows; asking for a CUDA device that is not
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


# blocks JAX, the JAX package, OpenCV, imageio and PIL in a fresh
# interpreter (none is on the card's machine): an import of any of them,
# eager or lazy, then fails
_BLOCK = ("import sys\n"
          "for name in ('jax', 'jaxlib', 'flax', 'optax', 'sparf_tpu', 'cv2', 'imageio', 'PIL'):\n"
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


def test_preset_matcher_default_runs_the_geometry_stage(tmp_path):
    """Without overrides the matcher is the presets' default: PDC-Net seeds,
    then the geometry stage (mini-SfM, plane-sweep rematch) from the noisy
    initial poses. The CPU entry point trains on its pools to the end and
    logs the route and each round's winner."""
    from sparf_tpu_torch import run_trainval

    args = ["joint_pose_nerf_training/synthetic", "sparf", "--scene", "spheres", "--debug", "True",
            "--device", "cpu", "--workspace_dir", str(tmp_path),
            *[a for a in TINY if not a.startswith("--use_gt_correspondences")]]
    trainer = run_trainval.main(args)
    assert trainer.state.iteration == 10 and int(trainer.state.nan_count) == 0
    pools = trainer.corres_pools
    assert pools["backend"] == "pdcnet_jax" and pools["n_pairs"] > 0
    assert pools["geom"]["route"] == "PDC-Net seeds -> mini-SfM -> plane-sweep rematch"
    log = (tmp_path / "joint_pose_nerf_training/synthetic/sparf/spheres/train.log").read_text()
    assert "geometry stage: route PDC-Net seeds -> mini-SfM -> plane-sweep rematch" in log
    for r in pools["geom"]["rounds"]:
        assert f"round {r['round']}: {r['winner']}" in log


def test_sfm_initial_poses_build_a_joint_trainer(tmp_path):
    """camera.initial_pose="sfm_pdcnet": the port's colmap_init/sfm.py (the
    incremental essential + PnP route, on GT-depth matches here, as
    tests/test_sfm_and_vis.py runs the original: at 24x32 the matchers' own
    flows leave the SfM to chance) gives the initial poses, pre-aligned to
    GT, and its sparse depth maps go to the train scene on the trainer's
    device. The COLMAP depth loss and the fixed-pose trainer still raise."""
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    over = dict(env={}, scene="spheres", max_iter=1000, min_nbr_matches=10,
                use_gt_correspondences=True, load_colmap_depth=True,
                camera=dict(initial_pose="sfm_pdcnet"),
                synthetic=dict(H=24, W=32, n_train=3, n_test=1),
                arch=dict(layers_feat=[None, 64, 64, 64, 64], layers_rgb=[None, 32, 3], skip=[2]),
                nerf=dict(sample_intvs=32, sample_intvs_fine=16, rand_rays=16),
                depth_cons_nbr_rays=16)
    cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", over)
    trainer = define_trainer(cfg, workspace=str(tmp_path), device="cpu", save_option=False)
    init = trainer.initial_poses_w2c.numpy()
    assert init.shape == (3, 3, 4) and np.isfinite(init).all()
    assert os.path.exists(tmp_path / "init_sfm" / "sfm_result.npz")
    depth = trainer.train_scene["colmap_depth"]
    assert depth.device.type == "cpu" and depth.shape == (3, 24, 32) and (depth > 0).any()
    assert trainer.train_scene["colmap_conf"].shape == (3, 24, 32)
    print(f"SfM initial poses: {trainer.initial_pose_error}")
    assert trainer.initial_pose_error["error_R"] < 2.0
    with pytest.raises(NotImplementedError, match="item 12"):
        define_trainer(build_config("joint_pose_nerf_training/synthetic", "sparf",
                                    dict(over, loss_type="photometric_and_SparseCOLMAPDepthLoss")),
                       workspace=str(tmp_path / "b"), device="cpu", save_option=False)
    with pytest.raises(NotImplementedError, match="item 12"):
        define_trainer(build_config("nerf_fixed_noisy_poses/synthetic", "sparf", dict(env={})),
                       workspace=str(tmp_path / "c"), device="cpu", save_option=False)


def test_sfm_initial_poses_from_the_matchers_own_flows(tmp_path, monkeypatch):
    """camera.initial_pose="sfm_pdcnet" on the presets' default matcher at
    64x80: PDC-Net seeds through the geometry stage (no prior: every round's
    candidate is a fresh essential + PnP bootstrap), whose internal poses
    seed the SfM's prior-initialised rounds on the stage's flows. Every view
    is registered, the poses are finite and the sparse depth maps reach the
    train scene. The pose error is printed, not bounded: from no prior at
    this size the stage lands far from GT, and on the CPU where it lands
    moves with the thread count (PDC-Net's float sums change with it); at
    the tests' 2 threads it is the same from run to run."""
    from sparf_tpu_torch.models import flow_net
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    seen = []
    run = flow_net.FlowSelectionWrapper.compute_flow_and_confidence_map_of_combi_list

    def spy(self, *a, **k):
        out = run(self, *a, **k)
        seen.append((self._resolve_backend(), dict(self.last_geom)))
        return out

    monkeypatch.setattr(flow_net.FlowSelectionWrapper,
                        "compute_flow_and_confidence_map_of_combi_list", spy)
    over = dict(env={}, scene="spheres", max_iter=1000, min_nbr_matches=10,
                use_gt_correspondences=False, load_colmap_depth=True,
                camera=dict(initial_pose="sfm_pdcnet"),
                synthetic=dict(H=64, W=80, n_train=3, n_test=1),
                arch=dict(layers_feat=[None, 64, 64, 64, 64], layers_rgb=[None, 32, 3], skip=[2]),
                nerf=dict(sample_intvs=32, sample_intvs_fine=16, rand_rays=16),
                depth_cons_nbr_rays=16)
    cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", over)
    trainer = define_trainer(cfg, workspace=str(tmp_path), device="cpu", save_option=False)
    backend, geom = seen[0]
    assert backend == "pdcnet_jax"
    assert geom["route"] == "PDC-Net seeds -> mini-SfM -> plane-sweep rematch"
    assert geom["poses_w2c"].shape == (3, 3, 4)
    print(f"SfM initial poses on the matcher's flows: {trainer.initial_pose_error}; stage "
          f"rounds {[(r['winner'], r['score']) for r in geom['rounds']]}")
    init = trainer.initial_poses_w2c.numpy()
    assert init.shape == (3, 3, 4) and np.isfinite(init).all()
    assert np.isfinite(trainer.initial_pose_error["error_R"])
    depth = trainer.train_scene["colmap_depth"]
    assert depth.shape == (3, 64, 80) and ((depth > 0).sum((1, 2)) > 0).all()


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sparf_tpu_torch.training.trainer import resolve_device

    with pytest.raises(RuntimeError):
        resolve_device("cuda")
