"""The port's training and eval entry points, in this process: the CLI
trains 10 debug iterations on the CPU, with validation and snapshots,
resumes, and evaluates; the eval entry point writes the means with and
without test-time pose refinement; asking for a CUDA device that is not
there raises instead of falling back. The import boundary (fresh
interpreters with JAX, the JAX package, OpenCV, imageio and PIL blocked) is
in tests/test_torch_entry_boundary.py and _raw_pdcnet.py, the SfM and
matcher routes in tests/test_torch_entry_sfm*.py, the fixed-pose and DS-NeRF
runs in tests/test_torch_entry_new_paths.py."""
import json
import os

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread cap)
from torch_entry_common import TINY


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
    # the novel-view and pose videos of the latest snapshot, animated PNGs that
    # decode (PIL here; the port's reader on the card, chip_smoke.py)
    from PIL import Image

    from sparf_tpu_torch.utils import imgproc

    video = run_trainval.main(args + ["--render_video_only"])
    vdir = os.path.join(video.workspace, "videos")
    assert sorted(os.listdir(vdir)) == ["depth_novel_view.png", "poses.png", "rgb_novel_view.png"]
    for name, n_frames in (("rgb_novel_view.png", 60), ("poses.png", 3 + 10)):
        frames = imgproc.read_apng(os.path.join(vdir, name))
        with Image.open(os.path.join(vdir, name)) as im:
            assert im.n_frames == len(frames) == n_frames
            im.seek(n_frames - 1)
            assert np.array_equal(np.asarray(im.convert("RGB")), frames[-1])
        assert frames[0].shape[2] == 3 and np.ptp(frames[0]) > 0
    # the eval panels and per-image files
    ev_dir = tmp_path / "ev_plots"
    resumed.evaluate_full(plot=True, save_ind_files=True, out_dir=str(ev_dir))
    H, W = resumed.H, resumed.W
    panel = imgproc.read_png(ev_dir / "plots" / "eval_000.png")
    assert panel.shape == (H, 6 * W, 3) and np.ptp(panel) > 0  # GT, render, error, 3 maps
    stem = os.path.splitext(_test_view_name(resumed))[0]  # the test view's file name
    assert sorted(os.listdir(ev_dir / "renders")) == [f"{stem}_depth.png", f"{stem}_pred.png"]
    for name in os.listdir(ev_dir / "renders"):
        img = imgproc.read_png(ev_dir / "renders" / name)
        assert img.shape == (H, W, 3) and np.ptp(img) > 0


def _test_view_name(trainer) -> str:
    from sparf_tpu_torch.datasets import create_dataset

    return create_dataset(trainer.cfg, "test")["rgb_path"][0]


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sparf_tpu_torch.training.trainer import resolve_device

    with pytest.raises(RuntimeError):
        resolve_device("cuda")
