"""DS-NeRF's sparse depth supervision in the port against the JAX package:
triangulation with known poses (colmap_init/triangulation.py), the COLMAP
depth loss (training/losses/colmap_depth.py) in one `nerf_gt_poses` step,
and a twin of tests/test_resume_and_dsnerf.py::test_dsnerf_triangulated_depth_loss.

On the same matches the port's depth and confidence maps equal the JAX
package's pixel for pixel (test_triangulated_maps_match_jax says why its
own matches move a few pixels). The step is held to the
slice's single-step tolerances (tests/traced_draws.py::assert_one_step_matches).
"""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread cap)
from torch_parity import to_np
from traced_draws import assert_one_step_matches
from sparf_tpu.colmap_init import sfm as sfm_j
from sparf_tpu.colmap_init import triangulation as tri_j
from sparf_tpu.configs import default as default_j
from sparf_tpu.configs.config import ConfigDict, override_options
from sparf_tpu.datasets.synthetic import load_synthetic_scene
from sparf_tpu.training.losses import colmap_depth as jcd
from sparf_tpu.training.trainer import NerfTrainerPerScene as JaxTrainer
from sparf_tpu_torch.colmap_init import sfm as sfm_t
from sparf_tpu_torch.colmap_init import triangulation as tri_t
from sparf_tpu_torch.configs import default as default_t
from sparf_tpu_torch.configs.config import ConfigDict as ConfigDictT
from sparf_tpu_torch.configs.config import override_options as override_t
from sparf_tpu_torch.convert import nerf_params_from_jax
from sparf_tpu_torch.training.trainer import NerfTrainerPerScene as TorchTrainer


def test_triangulated_maps_match_jax(monkeypatch):
    """tests/test_sfm_and_vis.py::test_triangulation_known_poses' scene.

    On the JAX package's matches the port's maps equal JAX's pixel for
    pixel. On its own GT-depth matches (within 2e-5 px of JAX's, float32
    flows) a few pixels differ in which point wins: every source keypoint
    lies on the integer grid, on a pixel border, and the export floors its
    reprojection, so a 1e-5 px shift moves it to the neighbouring pixel
    (91 of 1,626 pixels here). Those maps are held to the same accuracy
    against GT depth and to the same pixels where both keep one point."""
    scene = load_synthetic_scene(split="train", H=64, W=80, n_train=4, n_test=1)
    out_j = tri_j.compute_triangulation_from_matches(ConfigDict(use_gt_correspondences=True),
                                                     scene)
    out_t = tri_t.compute_triangulation_from_matches(ConfigDictT(use_gt_correspondences=True),
                                                     scene, device="cpu")
    d_t, d_j = out_t["colmap_depth"], out_j["colmap_depth"]
    assert d_t.shape == d_j.shape == (4, 64, 80)
    m_t, m_j = d_t > 0, d_j > 0
    gt = scene["depth_gt"]
    med = [float(np.median(np.abs(d[m] - gt[m]) / gt[m])) for d, m in ((d_t, m_t), (d_j, m_j))]
    print(f"valid px port {int(m_t.sum())}, JAX {int(m_j.sum())}, differing {int((m_t ^ m_j).sum())};"
          f" median relative error against GT depth port {med[0]:.4g}, JAX {med[1]:.4g}")
    assert m_t.sum() > 100 and med[0] < 0.02
    assert abs(int(m_t.sum()) - int(m_j.sum())) <= 0.01 * m_j.sum()
    assert (m_t & m_j).sum() >= 0.95 * m_j.sum()

    matches_j = sfm_j.matches_from_dense_flow(scene, ConfigDict(use_gt_correspondences=True))
    matches_t = sfm_t.matches_from_dense_flow(scene, ConfigDictT(use_gt_correspondences=True),
                                              device="cpu")
    np.testing.assert_array_equal(matches_t[0], matches_j[0])
    for pair, (idx, xy) in matches_j[1].items():
        np.testing.assert_array_equal(matches_t[1][pair][0], idx)
        np.testing.assert_allclose(matches_t[1][pair][1], xy, atol=2e-5)
    monkeypatch.setattr(sfm_t, "matches_from_dense_flow", lambda *a, **k: matches_j)
    same = tri_t.compute_triangulation_from_matches(ConfigDictT(use_gt_correspondences=True),
                                                    scene, device="cpu")
    np.testing.assert_array_equal(same["colmap_depth"], d_j)
    np.testing.assert_array_equal(same["colmap_conf"], out_j["colmap_conf"])


def _small(default, config, tmp_path, **extra):
    """tests/test_resume_and_dsnerf.py's small config (in either package)."""
    ConfigDict_, override = config
    cfg = default.get_nerf_default_config_360_data()
    cfg = override(cfg, ConfigDict_(dict(
        env=ConfigDict_(), dataset="synthetic", scene="spheres",
        synthetic=dict(H=24, W=32, n_train=3, n_test=1),
        max_iter=8, log_steps=4, val_steps=1000, snapshot_steps=4, vis_steps=1000,
        workspace=str(tmp_path / "ws"),
        arch=dict(layers_feat=[None, 32, 32, 32], layers_rgb=[None, 16, 3], skip=[1]),
        nerf=ConfigDict_(sample_intvs=16, sample_intvs_fine=8, rand_rays=128,
                         fine_sampling=False),
        loss_type="photometric_and_SparseCOLMAPDepthLoss",
        loss_weight=dict(colmap_depth=0.0),
        use_gt_correspondences=True, min_nbr_matches=20)))
    return override(cfg, ConfigDict_(extra))


@pytest.mark.parametrize("fine_sampling", [False, True])
def test_colmap_depth_step_matches_jax(tmp_path, monkeypatch, fine_sampling):
    # 4 point / 2 view PE frequencies: with 10, the first layer's gradient is
    # ill-conditioned in float32 in both packages (~1e-3 of scale apart)
    nerf, arch = dict(fine_sampling=fine_sampling), dict(posenc=dict(L_3D=4, L_view=2))
    jt = JaxTrainer(_small(default_j, (ConfigDict, override_options), tmp_path / "j",
                           tpu=dict(donate_state=False), nerf=nerf, arch=arch),
                    workspace=str(tmp_path / "j"))
    tt = TorchTrainer(_small(default_t, (ConfigDictT, override_t), tmp_path / "t", nerf=nerf,
                             arch=arch),
                      workspace=str(tmp_path / "t"), device="cpu")
    # each trainer triangulated its own scene's GT-depth matches; the step is
    # held on the same maps (test_triangulated_maps_match_jax holds the maps)
    m_t, m_j = tt.train_scene["colmap_depth"].numpy() > 0, to_np(jt.train_scene["colmap_depth"]) > 0
    assert (m_t & m_j).sum() >= 0.9 * m_j.sum()
    for k in ("colmap_depth", "colmap_conf"):
        tt.train_scene[k] = torch.as_tensor(np.array(jt.train_scene[k]))
    tt.define_loss_module()
    tt.state.nerf_params = nerf_params_from_jax(to_np(jt.state.nerf_params))
    stats_j, stats_t = assert_one_step_matches(jt, tt, 0, monkeypatch, seed=3,
                                               extra_modules=[jcd])
    assert float(stats_t["colmap_depth"]) > 0 and "perc_col_depth" in stats_t
    print(f"colmap_depth loss JAX {float(stats_j['colmap_depth']):.6g}, port "
          f"{float(stats_t['colmap_depth']):.6g}; perc_col_depth "
          f"{float(stats_t['perc_col_depth']):.4g}")


def test_dsnerf_triangulated_depth_loss(tmp_path):
    """loss_type with SparseCOLMAPDepthLoss + GT poses triggers triangulation."""
    cfg = _small(default_t, (ConfigDictT, override_t), tmp_path)
    tr = TorchTrainer(cfg, workspace=cfg.workspace, device="cpu")
    assert "colmap_depth" in tr.train_scene
    n_px = int((tr.train_scene["colmap_depth"] > 0).sum())
    assert n_px > 50, n_px
    tr.run(load_latest=False)
    assert int(tr.state.nan_count) == 0 and tr.iteration == 8
