"""Correspondence pools from the presets' default matcher route, PDC-Net with
the geometry stage (PDC-Net seeds, mini-SfM, plane-sweep rematch), the
port's against the JAX package's.

The whole route, at the shape of tests/test_torch_matcher_pools.py
(__graft_entry__._flagship_cfg: a 24x32 synthetic scene, 3 views), from the
same noisy prior: the same pairs kept. At this shape the stage's global SfM
fails in every round of both packages and each pair falls back to its own
prior-seeded pose, so a pool holds 10-30 pixels, each at a gate's edge:
their count moves with the float summation order (the port's pools here are
[27, 25] at 2 CPU threads and [23, 32] at 4, the JAX package's [16, 13]).
Pool sizes are printed, not bounded. At any size each package's SfM lands
on its own poses (the RANSAC draws differ) and the pools are rematched at
those poses, so the whole route's pool sizes are not comparable.

So the pools are held at shared poses: the last step of the route, the
plane-sweep rematch of every pair at the GT poses followed by the
confidence gates, on the 64x80 rig. Where both packages keep a pixel, they
put it at the same place; the pool sizes, counted over the pixels with a GT
flow, agree within 5%. The rest of the difference is at silhouettes over the
flat background, pixels without a GT flow, where the JAX package's windows
score float32 rounding noise and the port's score 0 (flow_net.py,
_FLAT_VAR_SHARE)."""
import jax.numpy as jnp
import numpy as np
import torch
from scipy.spatial.transform import Rotation

import torch_parity  # noqa: F401  (thread cap)
import __graft_entry__
from sparf_tpu.configs.config import ConfigDict, override_options
from sparf_tpu.datasets import create_dataset
from sparf_tpu.models import flow_net as fj
from sparf_tpu.training.losses import corres as jcorres
from sparf_tpu_torch.datasets import synthetic
from sparf_tpu_torch.models import flow_net as ft
from sparf_tpu_torch.training.losses import corres as tcorres


def test_hybrid_route_pools_match_jax():
    cfg = override_options(__graft_entry__._flagship_cfg(1),
                           ConfigDict(pdcnet_geometry_refine=True, geometric_verification=False,
                                      tpu=ConfigDict(donate_state=False)))
    scene = create_dataset(cfg, "train")
    rng = np.random.RandomState(4)
    prior = []
    for P in np.asarray(scene["pose"], np.float64):
        dR = Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
        prior.append(np.concatenate([dR @ P[:3, :3], (dR @ P[:3, 3])[:, None]], 1))
    prior = np.stack(prior)
    pj = jcorres.build_correspondence_pools(cfg, scene, init_poses_w2c=prior)
    pt = tcorres.build_correspondence_pools(cfg, scene, init_poses_w2c=prior, device="cpu")
    geom = pt["geom"]
    print(f"hybrid pools: pairs {pt['n_pairs']} (JAX {pj['n_pairs']}), sizes "
          f"{pt.get('pool_count', np.zeros(0)).tolist()} (JAX "
          f"{pj.get('pool_count', np.zeros(0)).tolist()}); rounds "
          f"{[(r['winner'], r['score']) for r in geom['rounds']]}")
    assert pt["backend"] == "pdcnet_jax" and pj["n_pairs"] > 0
    assert geom["route"] == "PDC-Net seeds -> mini-SfM -> plane-sweep rematch"
    np.testing.assert_array_equal(pt["pair_ids"], pj["pair_ids"])
    assert len(geom["rounds"]) == 3 and (pt["pool_count"] > cfg.min_nbr_matches).all()


def test_rematched_pools_at_shared_poses_match_jax_at_64x80():
    sc = synthetic.load_synthetic_scene(split="train", H=64, W=80, n_train=3, n_test=1,
                                        angular_span=0.35)
    poses = np.asarray(sc["pose"], np.float64)
    depth = np.asarray(sc["depth_gt"])
    depth_pool = {v: depth[v][depth[v] > 0][::7].astype(np.float64) for v in range(3)}
    unordered = [(0, 1), (0, 2), (1, 2)]
    combi = np.array([[0, 0, 1, 1, 2, 2], [1, 2, 0, 2, 0, 1]], np.int32)
    intr, imgs = np.asarray(sc["intr"], np.float64), np.asarray(sc["image"], np.float32)
    flows_j, flows_t = {}, {}
    fj._rematch_all_pairs(jnp.asarray(imgs), intr, flows_j, unordered, poses, depth_pool, radius=1)
    ft._rematch_all_pairs(torch.as_tensor(imgs), intr, flows_t, unordered, poses, depth_pool,
                          radius=1)
    corres_j, conf_j = (np.asarray(x) for x in fj._assemble_flow_outputs(flows_j, combi, 0.7,
                                                                          0.05, False))
    corres_t, conf_t = ft._assemble_flow_outputs(flows_t, combi, 0.7, 0.05, False)
    in_j, in_t = conf_j[:, 0] >= 0.95, conf_t[:, 0] >= 0.95
    has_gt = ft.compute_gt_flow_of_combi_list(sc, combi)[1][:, 0] > 0.5
    both = in_j & in_t
    same = np.linalg.norm(corres_j - corres_t, axis=1) < 1e-2
    sizes_j, sizes_t = (in_j & has_gt).sum((1, 2)), (in_t & has_gt).sum((1, 2))
    print(f"pools over pixels with GT flow: port {sizes_t.tolist()}, JAX {sizes_j.tolist()}; "
          f"all pixels: port {in_t.sum((1, 2)).tolist()}, JAX {in_j.sum((1, 2)).tolist()}; "
          f"kept by both {int(both.sum())}, at the same place {int((both & same).sum())}")
    assert (both & same).sum() >= 0.95 * both.sum()
    assert (np.abs(sizes_t - sizes_j) <= 0.05 * sizes_j).all()
