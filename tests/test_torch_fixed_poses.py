"""The fixed-pose trainer (`nerf_fixed_noisy_poses`,
training/joint_trainer.py::NerfTrainerPerSceneWColmapFixedPoses) against the
JAX package's: one step in each sampling stage, and a twin of
tests/test_fixed_poses_trainer.py::test_fixed_poses_trainer_smoke.

The step uses the preset nerf_fixed_noisy_poses/synthetic/sparf at the tiny
shape of __graft_entry__._flagship_cfg (24x32, 4x64 MLP, 32+16 samples, 16
rays, GT-depth correspondences, 4 point / 2 view PE frequencies), fine
sampling from 30% of max_iter, so that iteration 0 is coarse only and 350
renders coarse + fine. Both trainers start from the JAX trainer's
parameters and frozen initial poses and take the same draws; the step is
held to the slice's single-step tolerances
(tests/traced_draws.py::assert_one_step_matches) and leaves the poses as
they were.
"""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread cap)
from torch_parity import to_np
from traced_draws import assert_one_step_matches
from sparf_tpu.configs.config import ConfigDict, override_options
from sparf_tpu.configs.presets import PRESETS
from sparf_tpu.training.joint_trainer import NerfTrainerPerSceneWColmapFixedPoses as JaxTrainer
from sparf_tpu_torch.convert import nerf_params_from_jax, pose_params_from_jax
from sparf_tpu_torch.training.define_trainer import build_config, define_trainer
from sparf_tpu_torch.training.joint_trainer import NerfTrainerPerSceneWColmapFixedPoses

TINY = dict(env={}, scene="spheres", synthetic=dict(H=24, W=32, n_train=3, n_test=1),
            max_iter=1000, arch=dict(layers_feat=[None, 64, 64, 64, 64],
                                     layers_rgb=[None, 32, 3], skip=[2],
                                     posenc=dict(L_3D=4, L_view=2)),
            nerf=dict(sample_intvs=32, sample_intvs_fine=16, rand_rays=16,
                      ratio_start_fine_sampling_at_x=0.3),
            depth_cons_nbr_rays=16, min_nbr_matches=10, use_gt_correspondences=True)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    cfg_j = override_options(PRESETS["nerf_fixed_noisy_poses/synthetic/sparf"](),
                             ConfigDict(dict(TINY, tpu=dict(donate_state=False))))
    jt = JaxTrainer(cfg_j, workspace=str(tmp_path_factory.mktemp("jax")))
    tt = define_trainer(build_config("nerf_fixed_noisy_poses/synthetic", "sparf", TINY),
                        workspace=str(tmp_path_factory.mktemp("torch")), device="cpu",
                        save_option=False)
    assert type(tt) is NerfTrainerPerSceneWColmapFixedPoses
    # the JAX trainer's noise draw, so that both start from the same poses
    tt = NerfTrainerPerSceneWColmapFixedPoses(
        tt.cfg, workspace=tt.workspace, device="cpu",
        initial_poses_w2c=np.asarray(jt.initial_poses_w2c))
    tt.state.nerf_params = nerf_params_from_jax(to_np(jt.state.nerf_params))
    tt.state.pose_params = pose_params_from_jax(to_np(jt.state.pose_params))
    return jt, tt


@pytest.mark.parametrize("iteration,stage", [(0, "coarse"), (350, "fine")])
def test_fixed_pose_step_matches_jax(monkeypatch, trainers, iteration, stage):
    jt, tt = trainers
    assert not tt.optimize_poses_at(iteration) and not jt.optimize_poses_at(iteration)
    assert tt.fine_enabled_at(iteration) == (stage == "fine")
    poses = tt.current_poses_w2c().clone()
    stats_j, stats_t = assert_one_step_matches(jt, tt, iteration, monkeypatch, seed=iteration + 7)
    for k in ("render", "corres", "depth_cons"):
        assert k in stats_t
    assert torch.equal(tt.current_poses_w2c(), poses)


def test_fixed_poses_trainer_smoke(tmp_path):
    over = dict(env={}, scene="spheres", synthetic=dict(H=24, W=32, n_train=3, n_test=1),
                max_iter=6, log_steps=3, val_steps=1000, snapshot_steps=1000, vis_steps=1000,
                arch=dict(layers_feat=[None, 32, 32, 32], layers_rgb=[None, 16, 3], skip=[1]),
                nerf=dict(sample_intvs=16, sample_intvs_fine=8, rand_rays=128,
                          fine_sampling=False, ratio_start_fine_sampling_at_x=None),
                depth_cons_nbr_rays=64, min_nbr_matches=20, use_gt_correspondences=True,
                loss_type="photometric", camera=dict(initial_pose="noisy_gt", noise=0.1),
                optim=dict(test_iter=3))
    tr = NerfTrainerPerSceneWColmapFixedPoses(
        build_config("nerf_fixed_noisy_poses/synthetic", "sparf", over),
        workspace=str(tmp_path), device="cpu")
    # poses must stay frozen through training
    p_before = tr.current_poses_w2c().detach().clone()
    tr.run(load_latest=False)
    assert torch.equal(tr.current_poses_w2c(), p_before)
    assert not tr.optimize_poses_at(0)
    # eval path: GT test poses + test-time refinement
    result = tr.evaluate_full()
    assert "psnr" in result["mean"] and "refine_rot_deg" in result["per_image"][0]
    assert int(tr.state.nan_count) == 0
