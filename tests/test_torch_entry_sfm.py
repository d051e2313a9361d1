"""The presets' matcher default (PDC-Net with the geometry stage) trains
through the CLI and logs its route; SfM initial poses on GT-depth matches
build a joint trainer, and that trainer's sparse depth maps feed the COLMAP
depth loss."""
import os

import numpy as np

import torch_parity  # noqa: F401  (thread cap)
from torch_entry_common import TINY


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
    device. A trainer with the COLMAP depth loss takes those maps for its
    pools and steps; the fixed-pose trainer builds on the same config."""
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
    with_depth = define_trainer(
        build_config("joint_pose_nerf_training/synthetic", "sparf",
                     dict(over, loss_type="photometric_and_SparseCOLMAPDepthLoss")),
        workspace=str(tmp_path / "b"), device="cpu", save_option=False)
    _, stats = with_depth.get_step(0)(with_depth.state, with_depth.draws)
    assert float(stats["colmap_depth"]) > 0
    assert float(stats["perc_col_depth"]) == float((with_depth.train_scene["colmap_depth"] > 0)
                                                   .float().mean())
    fixed = define_trainer(build_config("nerf_fixed_noisy_poses/synthetic", "sparf", over),
                           workspace=str(tmp_path / "c"), device="cpu", save_option=False)
    assert type(fixed).__name__ == "NerfTrainerPerSceneWColmapFixedPoses"
    assert not fixed.optimize_poses_at(0) and "colmap_depth" in fixed.train_scene
