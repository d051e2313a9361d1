"""The matchers' geometry stage at full size on the CPU, the port's against the
JAX package's: the correspondence precompute of the 300x400 synthetic scene
(chip_smoke.py's MATCHER_POOLS) from the joint trainer's noisy initial poses
as prior, with the stage's candidates traced round by round.

    JAX_PLATFORMS=cpu python tests/geometry_reference.py jax  [--backend PDCNet] [--seed 0]
    JAX_PLATFORMS=cpu python tests/geometry_reference.py port [--backend zncc] [--seed 1]
    python tests/geometry_reference.py port --device cuda --seed 2    (the port on the card)
    JAX_PLATFORMS=cpu python tests/geometry_reference.py jax --rig 64x80 [--bootstrap 40] --priors 0,1,2
        [--texture_octaves 3] [--keypoints] [--flat_share 1.0] [--flat-zero]
    python tests/geometry_reference.py --compare jax.jsonl port.jsonl port

The last form runs the ZNCC stage of tests/test_torch_geometry_vs_jax*.py
on its DTU-like rig instead (H x W, `_BOOTSTRAP_MAX_DIM` set to --bootstrap),
from the rig's noisy prior drawn with each of --priors as the numpy seed
(that test uses 3), and prints one JSON line per prior (~1-2 min each).
With --keypoints it also reads the first sparse guided rematch (round 1)
per grid keypoint: each seed's z1, z2, cycle error, whether the package
kept the match, the port's flat rule at its share (`textured`), and, when
the rematch runs at 32x40, the match's distance from the GT correspondence
of the synthetic scene rendered at 32x40; --flat_share sets the port's
`_SPARSE_FLAT_SHARE` for the run (1.0 turns the rule off). --flat-zero runs
the JAX stage with the two sweeps of tests/geometry_vs_jax_common.py that
score a flat window 0, as the port does, instead of rounding noise divided
by a clamped variance (install_flat_zero).

Prints, per round, each candidate's mean relative rotation error against GT
and its rematched-flow score, then one JSON line: seconds, pairs kept, pool
sizes, flow quality against GT, the prior's and the stage's internal pose
errors. Both packages run their own code (OpenCV's RANSAC in the JAX
package, the port's solvers in sparf_tpu_torch). A run takes ~7-20 min on
2-3 CPU threads. tests/test_torch_geometry_full.py (marked slow) runs it
for both packages from four priors."""
import argparse
import importlib
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


def _traced_sparse_matches(mod, calls):
    """`mod._sparse_matches_for_sfm` that also records, per call, every grid
    keypoint's rematch readings (see --keypoints) into `calls`."""
    from sparf_tpu_torch.datasets import synthetic
    from sparf_tpu_torch.models import flow_net as tfn

    original = mod._sparse_matches_for_sfm
    rule_share = tfn._SPARSE_FLAT_SHARE   # the rule's share, whatever --flat_share sets
    scene32 = synthetic.load_synthetic_scene(split="train", H=32, W=40, n_train=3, n_test=1,
                                             angular_span=0.35)

    def traced(imgs, flows, unordered, H, W, stride=2, min_zncc=0.8, max_cycle_px=1.5,
               search_radius=6, extra_flows=None):
        sfm = importlib.import_module(mod.__name__.replace("models.flow_net", "colmap_init.sfm"))
        kps = sfm.grid_keypoints(H, W, stride, margin=6)
        kx, ky = kps[:, 0].astype(int), kps[:, 1].astype(int)
        rec = dict(H=H, W=W, pairs={})
        for i, j in unordered:
            i, j = int(i), int(j)
            run_share, tfn._SPARSE_FLAT_SHARE = tfn._SPARSE_FLAT_SHARE, rule_share
            textured = ~tfn._near_flat(torch.as_tensor(np.array(imgs[i])), 5)[ky, kx]
            tfn._SPARSE_FLAT_SHARE = run_share
            gt, gt_valid = (tfn.gt_correspondences_for_pair(scene32, i, j) if (H, W) == (32, 40)
                            else (None, None))
            seeds = []
            for fl in ([flows] if extra_flows is None else [flows, extra_flows]):
                xy, z1 = mod._sparse_guided_rematch(imgs[i], imgs[j], fl[(i, j)][0], kps,
                                                    search_radius=search_radius)
                back, z2 = mod._sparse_guided_rematch(imgs[j], imgs[i], fl[(j, i)][0], xy,
                                                      search_radius=search_radius)
                xy, back, z1, z2 = (np.asarray(a) for a in (xy, back, z1, z2))
                cyc = np.linalg.norm(back - kps, axis=-1)
                ok = ((z1 > min_zncc) & (z2 > min_zncc) & (cyc < max_cycle_px)
                      & (xy[:, 0] >= 0) & (xy[:, 0] <= W - 1) & (xy[:, 1] >= 0)
                      & (xy[:, 1] <= H - 1))
                seeds.append(dict(z1=z1.tolist(), z2=z2.tolist(), cyc=cyc.tolist(),
                                  ok=ok.tolist(),
                                  gt_err_px=None if gt is None else
                                  np.linalg.norm(xy - gt[:, ky, kx].T, axis=-1).tolist()))
            rec["pairs"][f"{i}-{j}"] = dict(
                textured=textured.tolist(), seeds=seeds,
                gt_valid=None if gt_valid is None else gt_valid[ky, kx].tolist())
        calls.append(rec)
        return original(imgs, flows, unordered, H, W, stride, min_zncc, max_cycle_px,
                        search_radius, extra_flows)

    return traced


def run_rig(package: str, H: int, W: int, bootstrap_max_dim=None, seeds=(3,),
            texture_octaves: int = 1, keypoints: bool = False, flat_share=None,
            flat_zero: bool = False):
    """The ZNCC geometry stage on the H x W DTU-like rig (its spheres'
    albedo with `texture_octaves` octaves) from the noisy prior of each numpy
    seed: yields one dict per seed (the prior's and the stage's mean relative
    rotation error, each round's candidates; with `keypoints` the sparse
    rematch readings per keypoint, `sparse_calls`). `flat_share` sets the
    port's `_SPARSE_FLAT_SHARE` for the run; `flat_zero` (package "jax")
    installs the flat-zero sweeps of geometry_vs_jax_common for the run."""
    from scipy.spatial.transform import Rotation

    from sparf_tpu_torch.datasets import synthetic
    from sparf_tpu_torch.models import flow_net as tfn

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
    saved = (mod._BOOTSTRAP_MAX_DIM, mod._rematched_flow_quality, mod._global_poses_from_flows,
             mod._sparse_matches_for_sfm, tfn._SPARSE_FLAT_SHARE)
    sweeps = {name: getattr(mod, name) for name in ("_plane_sweep_pair", "_local_depth_sweep")}
    candidates, calls = [], []

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
    if keypoints:
        mod._sparse_matches_for_sfm = _traced_sparse_matches(mod, calls)
    if flat_share is not None:
        tfn._SPARSE_FLAT_SHARE = flat_share
    if flat_zero:
        if package != "jax":
            raise ValueError("--flat-zero patches the JAX stage (the port scores flat windows 0)")
        from geometry_vs_jax_common import install_flat_zero

        install_flat_zero(setattr)
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
            calls.clear()
            geom = {}
            t0 = time.time()
            mod.compute_zncc_flow_of_combi_list(sc["image"], combi, intr=sc["intr"],
                                                init_poses_w2c=prior, geom_out=geom, **kw)
            yield dict(package=package, rig=f"{H}x{W}", bootstrap_max_dim=bootstrap_max_dim,
                       texture_octaves=texture_octaves, flat_zero=flat_zero, prior_seed=seed,
                       seconds=time.time() - t0,
                       prior_rot_err_deg=cs.mean_rel_rot_deg(prior, gt),
                       internal_rot_err_deg=(cs.mean_rel_rot_deg(geom["poses_w2c"], gt)
                                             if "poses_w2c" in geom else None),
                       candidates=list(candidates),
                       **(dict(sparse_calls=list(calls)) if keypoints else {}))
    finally:
        (mod._BOOTSTRAP_MAX_DIM, mod._rematched_flow_quality, mod._global_poses_from_flows,
         mod._sparse_matches_for_sfm, tfn._SPARSE_FLAT_SHARE) = saved
        for name, fn in sweeps.items():
            setattr(mod, name, fn)


def _round1_keypoints(pair):
    """Per keypoint of one pair's first rematch: kept (by any seed) and the
    GT distance of the seed that wins it (the higher min(z1, z2))."""
    seeds = pair["seeds"]
    best = np.full(len(seeds[0]["z1"]), -np.inf)
    kept = np.zeros(best.shape, bool)
    err = np.full(best.shape, np.nan)
    for sd in seeds:
        ok, score = np.array(sd["ok"]), np.minimum(sd["z1"], sd["z2"])
        take = ok & (score > best)
        best[take], kept = score[take], kept | ok
        err[take] = np.array(sd["gt_err_px"])[take]
    return kept, err


def compare_keypoints(jax_rows, port_rows) -> list:
    """Round 1's sparse rematch per keypoint, the JAX stage's against the
    port's (each a --keypoints --rig 64x80 --bootstrap 40 run, the port's
    with --flat_share 1.0): per prior and pair, the keypoints each kept,
    those both kept, those of JAX's that the port's flat rule drops, and the
    median distance from the GT correspondence of the kept matches on the
    spheres, split by the rule's verdict; and over every prior and pair."""
    out, pooled = [], {}
    for j, p in zip(jax_rows, port_rows):
        for key, pj in j["sparse_calls"][0]["pairs"].items():
            pp = p["sparse_calls"][0]["pairs"][key]
            tex, gtv = np.array(pp["textured"]), np.array(pp["gt_valid"])
            (kj, ej), (kp, ep) = _round1_keypoints(pj), _round1_keypoints(pp)
            row = dict(prior=j["prior_seed"], pair=key, jax_kept=int(kj.sum()),
                       port_kept=int(kp.sum()), both=int((kj & kp).sum()),
                       rule_keeps=int(tex.sum()), jax_kept_rule_drops=int((kj & ~tex).sum()))
            for name, kept, err in (("jax", kj, ej), ("port", kp, ep)):
                for verdict, sel in (("textured", tex), ("flat", ~tex)):
                    e = err[kept & sel & gtv]
                    pooled.setdefault(f"{name}_{verdict}", []).extend(e.tolist())
                    row[f"{name}_{verdict}_median_px"] = float(np.median(e)) if e.size else None
            out.append(row)
    for k, v in pooled.items():
        v = np.array(v)
        out.append(dict(pooled=k, n=int(v.size), median_px=float(np.median(v)),
                        mean_px=float(v.mean()), share_over_1px=float((v > 1).mean())))
    return out


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
    parser.add_argument("--keypoints", action="store_true",
                        help="with --rig: per-keypoint readings of each sparse rematch")
    parser.add_argument("--compare", nargs=2, default=None, metavar=("JAX", "PORT"),
                        help="compare two --keypoints outputs (JSON lines files)")
    parser.add_argument("--flat_share", type=float, default=None,
                        help="with --rig: the port's _SPARSE_FLAT_SHARE (1.0: rule off)")
    parser.add_argument("--flat-zero", dest="flat_zero", action="store_true",
                        help="with --rig, jax: flat windows score 0 in the JAX sweeps")
    args = parser.parse_args()
    torch.set_num_threads(args.threads)
    if args.compare:
        rows = [[json.loads(line) for line in open(f) if line.startswith("{")]
                for f in args.compare]
        for row in compare_keypoints(*rows):
            print(json.dumps(row))
    elif args.rig:
        H, W = (int(v) for v in args.rig.split("x"))
        for row in run_rig(args.package, H, W, args.bootstrap,
                           [int(v) for v in args.priors.split(",")], args.texture_octaves,
                           args.keypoints, args.flat_share, args.flat_zero):
            print(json.dumps(row), flush=True)
    else:
        print(json.dumps(run(args.package, args.backend, args.seed, args.device)))


if __name__ == "__main__":
    main()
