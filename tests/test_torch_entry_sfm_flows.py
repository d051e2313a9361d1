"""SfM initial poses from the matchers' own flows (the geometry stage with
no prior) build a joint trainer at 64x80."""
import numpy as np

import torch_parity  # noqa: F401  (thread cap)


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
