"""What the geometry-stage tests against the JAX stage share
(tests/test_torch_geometry_vs_jax*.py): the DTU-like rig, its noisy prior,
both packages' stage from that prior, the EPE contract and the check of one
rig. The rigs are split over three files so that `pytest -n ... --dist
loadfile` runs them on different workers."""
import numpy as np
from scipy.spatial.transform import Rotation

import torch_parity  # noqa: F401  (thread cap)
from sparf_tpu.models import flow_net as fj
from sparf_tpu_torch.datasets import synthetic
from sparf_tpu_torch.models import flow_net as ft

COMBI = np.array([[0, 0, 1], [1, 2, 2]], np.int32)


def _mean_rel_rot_err(poses, gt) -> float:
    errs = []
    for a in range(len(gt)):
        for b in range(a + 1, len(gt)):
            Rg = gt[b][:3, :3] @ gt[a][:3, :3].T
            Re = poses[b][:3, :3] @ poses[a][:3, :3].T
            c = (np.trace(Rg.T @ Re) - 1) / 2
            errs.append(np.degrees(np.arccos(np.clip(c, -1, 1))))
    return float(np.mean(errs))


def _rig(H, W):
    sc = synthetic.load_synthetic_scene(split="train", H=H, W=W, n_train=3, n_test=1,
                                        angular_span=0.35)
    rng = np.random.RandomState(3)
    prior = []
    for P in np.asarray(sc["pose"], np.float64):
        dR = Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
        prior.append(np.concatenate([dR @ P[:3, :3], (dR @ P[:3, 3] + rng.randn(3) * 0.05)[:, None]],
                                    1))
    return sc, np.stack(prior)


def _run_both(sc, prior):
    """(port's corres, conf, geom_out; the port's, the JAX stage's and the
    prior's mean relative rotation errors)."""
    geom_t, geom_j = {}, {}
    corres, conf = ft.compute_zncc_flow_of_combi_list(sc["image"], COMBI, intr=sc["intr"],
                                                      init_poses_w2c=prior, geom_out=geom_t,
                                                      device="cpu")
    fj.compute_zncc_flow_of_combi_list(sc["image"], COMBI, intr=sc["intr"],
                                       init_poses_w2c=prior, geom_out=geom_j)
    gt = np.asarray(sc["pose"], np.float64)
    errs = [_mean_rel_rot_err(p, gt) for p in (geom_t["poses_w2c"], geom_j["poses_w2c"], prior)]
    print(f"bootstrap {geom_t['bootstrap']}: mean relative rotation error port {errs[0]:.4f} "
          f"deg, JAX {errs[1]:.4f}, prior {errs[2]:.4f}; rounds "
          f"{[(r['winner'], r['score']) for r in geom_t['rounds']]}")
    return corres, conf, geom_t, errs


def _epe_contract(sc, corres, conf):
    gt_corres, gt_conf = ft.compute_gt_flow_of_combi_list(sc, COMBI)
    counts, medians = [], []
    for p in range(COMBI.shape[1]):
        m = (conf[p, 0] > 0.95) & (gt_conf[p, 0] > 0.5)
        counts.append(int(m.sum()))
        medians.append(float(np.median(np.linalg.norm(corres[p] - gt_corres[p], axis=0)[m])))
    print(f"confident px {counts}, median EPE per pair {np.round(medians, 3)}")
    assert min(counts) > 45 and np.median(medians) < 1.5


# _BOOTSTRAP_MAX_DIM (None: unpatched) -> the rig's (H, W)
RIGS = {None: (64, 80), 40: (64, 80), 64: (128, 160)}


def check_stage_from_the_prior(monkeypatch, bootstrap_max_dim):
    """The stage from the rig's prior in both packages: the EPE contract,
    the bootstrap branch's report, and the port's internal poses within
    0.25 deg of the JAX stage's error (or below it); at 32x40 below 5 deg
    and below the prior's error instead."""
    H, W = RIGS[bootstrap_max_dim]
    sc, prior = _rig(H, W)
    if bootstrap_max_dim is not None:
        monkeypatch.setattr(fj, "_BOOTSTRAP_MAX_DIM", bootstrap_max_dim)
        monkeypatch.setattr(ft, "_BOOTSTRAP_MAX_DIM", bootstrap_max_dim)
    corres, conf, geom_t, (err_t, err_j, err_prior) = _run_both(sc, prior)
    assert corres.shape == (3, 2, H, W)
    _epe_contract(sc, corres, conf)
    if bootstrap_max_dim is None:
        assert geom_t["bootstrap"] is None
    else:
        small = {40: (32, 40), 64: (51, 64)}[bootstrap_max_dim]
        assert geom_t["bootstrap"] == small and "rematch_full" in geom_t["seconds"]
        assert geom_t["output"].startswith("full-resolution rematch")
    if bootstrap_max_dim != 40:
        assert err_t <= err_j + 0.25
    else:
        # what the grid-match fallback of _sparse_matches_for_sfm earns here:
        # 4.304 deg from a 6.045-deg prior (15.695 without it)
        assert err_t < min(5.0, err_prior)
