"""The matchers' geometry stage at full size on the CPU, the port's against the
JAX package's: the correspondence precompute of the 300x400 synthetic scene
(chip_smoke.py's MATCHER_POOLS) from the joint trainer's noisy initial poses
as prior, with the stage's candidates traced round by round.

    JAX_PLATFORMS=cpu python tests/geometry_reference.py jax  [--backend PDCNet] [--seed 0]
    JAX_PLATFORMS=cpu python tests/geometry_reference.py port [--backend zncc] [--seed 1]
    python tests/geometry_reference.py port --device cuda --seed 2    (the port on the card)
    JAX_PLATFORMS=cpu python tests/geometry_reference.py jax --rig 64x80 [--bootstrap 40] --priors 0,1,2
        [--texture_octaves 3]

The last form runs the ZNCC stage of tests/test_torch_geometry_vs_jax*.py
on its DTU-like rig instead (H x W, `_BOOTSTRAP_MAX_DIM` set to --bootstrap),
from the rig's noisy prior drawn with each of --priors as the numpy seed
(that test uses 3), and prints one JSON line per prior (~1-2 min each).

Prints, per round, each candidate's mean relative rotation error against GT
and its rematched-flow score, then one JSON line: seconds, pairs kept, pool
sizes, flow quality against GT, the prior's and the stage's internal pose
errors. Both packages run their own code (OpenCV's RANSAC in the JAX
package, the port's solvers in sparf_tpu_torch). A run takes ~7-20 min on
2-3 CPU threads. tests/test_torch_geometry_full.py (marked slow) runs it
for both packages from four priors."""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def run(package: str, backend: str = "PDCNet", seed: int = 0, device: str = "cpu") -> dict:
    """One correspondence precompute of the 300x400 scene in `package` ("jax"
    or "port", the port on `device`), from the prior of cfg.seed = `seed`,
    tracing each round's candidates; returns the summary dict."""
    from sparf_tpu_torch.training.define_trainer import build_config

    scene = cs.full_scene()
    over = dict(cs.MATCHER_POOLS, flow_backbone=backend, seed=seed)
    cfg = build_config("joint_pose_nerf_training/synthetic", "sparf", over)
    prior = cs.geometry_prior(cfg, scene)
    gt = np.asarray(scene["pose"], np.float64)
    if package == "jax":
        from sparf_tpu.configs.config import ConfigDict, override_options
        from sparf_tpu.configs.presets import get_config
        from sparf_tpu.models import flow_net as mod
        from sparf_tpu.training.losses import corres

        cfg = override_options(get_config("joint_pose_nerf_training/synthetic", "sparf"),
                               ConfigDict(over))
        kw = {}
    else:
        from sparf_tpu_torch.models import flow_net as mod
        from sparf_tpu_torch.training.losses import corres

        kw = dict(device=device)

    saved = (mod._rematched_flow_quality, mod._global_poses_from_flows,
             mod.compute_zncc_flow_of_combi_list)
    quality, global_poses, zncc = saved
    candidates = []

    def traced_quality(flows, unordered):
        score = quality(flows, unordered)
        candidates[-1]["score"] = score
        print(f"  rematched-flow score {score:.6f}", flush=True)
        return score

    def traced_poses(*a, **k):
        poses, depth_pool = global_poses(*a, **k)
        err = None if poses is None else cs.mean_rel_rot_deg(poses, gt)
        name = "prior" if k.get("init_poses_w2c") is not None else "fresh"
        candidates.append(dict(candidate=name, rot_err_deg=err))
        print(f"candidate {name}: {'no global poses' if err is None else f'{err:.4f} deg'}",
              flush=True)
        return poses, depth_pool

    geom_out = {}

    def keep_geom(*a, **k):
        k["geom_out"] = geom_out if k.get("geom_out") is None else k["geom_out"]
        out = zncc(*a, **k)
        geom_out.update(k["geom_out"])
        return out

    mod._rematched_flow_quality, mod._global_poses_from_flows = traced_quality, traced_poses
    mod.compute_zncc_flow_of_combi_list = keep_geom
    try:
        t0 = time.time()
        pools = corres.build_correspondence_pools(cfg, scene, init_poses_w2c=prior, **kw)
        seconds = time.time() - t0
    finally:
        (mod._rematched_flow_quality, mod._global_poses_from_flows,
         mod.compute_zncc_flow_of_combi_list) = saved
    return dict(package=package, backend=backend, seed=seed, seconds=seconds,
                n_pairs=int(pools["n_pairs"]),
                pool_count=[int(c) for c in pools.get("pool_count", [])],
                flow_quality=corres.compute_flow_metrics(pools, scene),
                prior_rot_err_deg=cs.mean_rel_rot_deg(prior.astype(np.float64), gt),
                internal_rot_err_deg=(cs.mean_rel_rot_deg(np.asarray(geom_out["poses_w2c"]), gt)
                                      if "poses_w2c" in geom_out else None),
                candidates=candidates)


def run_rig(package: str, H: int, W: int, bootstrap_max_dim=None, seeds=(3,),
            texture_octaves: int = 1):
    """The ZNCC geometry stage on the H x W DTU-like rig (its spheres'
    albedo with `texture_octaves` octaves) from the noisy prior of each numpy
    seed: yields one dict per seed (the prior's and the stage's mean relative
    rotation error, each round's candidates)."""
    from scipy.spatial.transform import Rotation

    from sparf_tpu_torch.datasets import synthetic

    if package == "jax":
        from sparf_tpu.models import flow_net as mod

        kw = {}
    else:
        from sparf_tpu_torch.models import flow_net as mod

        kw = dict(device="cpu")
    sc = synthetic.load_synthetic_scene(split="train", H=H, W=W, n_train=3, n_test=1,
                                        angular_span=0.35, texture_octaves=texture_octaves)
    gt = np.asarray(sc["pose"], np.float64)
    combi = np.array([[0, 0, 1], [1, 2, 2]], np.int32)
    saved = (mod._BOOTSTRAP_MAX_DIM, mod._rematched_flow_quality, mod._global_poses_from_flows)
    candidates = []

    def traced_quality(flows, unordered):
        candidates[-1]["score"] = saved[1](flows, unordered)
        return candidates[-1]["score"]

    def traced_poses(*a, **k):
        poses, depth_pool = saved[2](*a, **k)
        candidates.append(dict(candidate="prior" if k.get("init_poses_w2c") is not None
                               else "fresh",
                               rot_err_deg=None if poses is None
                               else cs.mean_rel_rot_deg(poses, gt)))
        return poses, depth_pool

    if bootstrap_max_dim is not None:
        mod._BOOTSTRAP_MAX_DIM = bootstrap_max_dim
    mod._rematched_flow_quality, mod._global_poses_from_flows = traced_quality, traced_poses
    try:
        for seed in seeds:
            rng = np.random.RandomState(seed)
            prior = []
            for P in gt:
                dR = Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
                prior.append(np.concatenate(
                    [dR @ P[:3, :3], (dR @ P[:3, 3] + rng.randn(3) * 0.05)[:, None]], 1))
            prior = np.stack(prior)
            candidates.clear()
            geom = {}
            t0 = time.time()
            mod.compute_zncc_flow_of_combi_list(sc["image"], combi, intr=sc["intr"],
                                                init_poses_w2c=prior, geom_out=geom, **kw)
            yield dict(package=package, rig=f"{H}x{W}", bootstrap_max_dim=bootstrap_max_dim,
                       texture_octaves=texture_octaves, prior_seed=seed, seconds=time.time() - t0,
                       prior_rot_err_deg=cs.mean_rel_rot_deg(prior, gt),
                       internal_rot_err_deg=(cs.mean_rel_rot_deg(geom["poses_w2c"], gt)
                                             if "poses_w2c" in geom else None),
                       candidates=list(candidates))
    finally:
        mod._BOOTSTRAP_MAX_DIM, mod._rematched_flow_quality, mod._global_poses_from_flows = saved


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("package", choices=["jax", "port"])
    parser.add_argument("--backend", default="PDCNet", choices=["PDCNet", "zncc"])
    parser.add_argument("--seed", type=int, default=0,
                        help="cfg.seed: the prior's noise draw (and the port's RANSAC seeds)")
    parser.add_argument("--threads", type=int, default=3)
    parser.add_argument("--device", default="cpu", help="the port's device (cpu or cuda)")
    parser.add_argument("--rig", default=None, help="HxW: run the DTU-like rig instead")
    parser.add_argument("--bootstrap", type=int, default=None,
                        help="with --rig: _BOOTSTRAP_MAX_DIM")
    parser.add_argument("--priors", default="3", help="with --rig: the prior's numpy seeds")
    parser.add_argument("--texture_octaves", type=int, default=1,
                        help="with --rig: octaves of the spheres' albedo texture")
    args = parser.parse_args()
    torch.set_num_threads(args.threads)
    if args.rig:
        H, W = (int(v) for v in args.rig.split("x"))
        for row in run_rig(args.package, H, W, args.bootstrap,
                           [int(v) for v in args.priors.split(",")], args.texture_octaves):
            print(json.dumps(row), flush=True)
    else:
        print(json.dumps(run(args.package, args.backend, args.seed, args.device)))


if __name__ == "__main__":
    main()
