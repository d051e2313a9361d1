#!/usr/bin/env python
"""The no-prior SfM-init path, stage by stage (the port of
scripts/diag_sfm_init.py): where does the pose error enter, in the matcher's
internal mini-SfM (whose poses the plane-sweep rematch bakes into every
emitted flow), or in the outer SfM that derives poses again from those flows?

    python -m sparf_tpu_torch.scripts.diag_sfm_init [--backend PDCNet|zncc] [--H 300 --W 400]
        [--n 4] [--span 0.35] [--octaves 3] [--device cuda|cpu]

Prints the internal rounds' pose errors, the matches per pair, the hand-off
poses' error, the outer prior-init SfM's and the outer run_mini_sfm's (rotation
in degrees and translation, after the small-camera-system pre-alignment of
utils/alignment.py). Runs on the card unless --device cpu (or --cpu) is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def pose_err(poses_w2c_34, gt_34):
    """(mean rotation error in degrees, mean translation error) after
    alignment.prealign_w2c_small_camera_systems."""
    from sparf_tpu_torch.utils import alignment

    aligned, _ = alignment.prealign_w2c_small_camera_systems(
        np.asarray(poses_w2c_34, np.float32), np.asarray(gt_34, np.float32))
    err = alignment.evaluate_camera_alignment(aligned, np.asarray(gt_34, np.float32))
    return float(np.asarray(err["R"]).mean() * 180 / np.pi), float(np.asarray(err["t"]).mean())


def run(backend: str = "PDCNet", H: int = 300, W: int = 400, n: int = 4, span: float = 0.35,
        octaves: int = 3, device="cuda") -> dict:
    """Returns {'internal': [(rot, trans) per successful round], 'matches':
    {pair: count}, 'hint', 'outer_prior', 'outer_mini'} ((rot, trans) or None)."""
    from sparf_tpu_torch.colmap_init import sfm as sfm_mod
    from sparf_tpu_torch.configs.config import ConfigDict
    from sparf_tpu_torch.datasets.synthetic import load_synthetic_scene
    from sparf_tpu_torch.models import flow_net

    scene = load_synthetic_scene(split="train", H=H, W=W, n_train=n, n_test=4,
                                 texture_octaves=octaves, angular_span=span)
    gt = np.asarray(scene["pose"])
    out = dict(internal=[], matches={}, hint=None, outer_prior=None, outer_mini=None)

    orig_global = flow_net._global_poses_from_flows

    def traced_global(*a, **kw):
        poses, depth_pool = orig_global(*a, **kw)
        if poses is not None:
            e = pose_err(poses[:, :3], gt)
            out["internal"].append(e)
            print(f"[diag] internal SfM round {len(out['internal'])}: rot {e[0]:.3f} deg  "
                  f"trans {e[1]:.4f}", flush=True)
        else:
            print("[diag] internal SfM round: FAILED (pairwise fallback)", flush=True)
        return poses, depth_pool

    cfg = ConfigDict(use_gt_correspondences=False, flow_backbone=backend)
    flow_net._global_poses_from_flows = traced_global
    try:
        kps, pair_matches, poses_hint = sfm_mod.matches_from_dense_flow(scene, cfg, device=device)
    finally:
        flow_net._global_poses_from_flows = orig_global

    for (i, j), (idx, _) in sorted(pair_matches.items()):
        out["matches"][f"{i}-{j}"] = len(idx)
        print(f"[diag] pair ({i},{j}): {len(idx)} confident grid matches")
    if poses_hint is not None:
        out["hint"] = pose_err(np.asarray(poses_hint)[:, :3], gt)
        print(f"[diag] poses_hint (best internal round, handoff): rot {out['hint'][0]:.3f} deg  "
              f"trans {out['hint'][1]:.4f}", flush=True)
        result = sfm_mod.run_prior_init_sfm(scene, (kps, pair_matches), np.asarray(poses_hint),
                                            rounds=3)
        out["outer_prior"] = pose_err(result.poses_w2c[:, :3], gt)
        print(f"[diag] OUTER prior-init SfM (new path): rot {out['outer_prior'][0]:.3f} deg  "
              f"trans {out['outer_prior'][1]:.4f}  (excluded: {result.index_images_excluded})",
              flush=True)
    result = sfm_mod.run_mini_sfm(scene, cfg, matches=(kps, pair_matches), device=device)
    out["outer_mini"] = pose_err(result.poses_w2c[:, :3], gt)
    print(f"[diag] OUTER run_mini_sfm (legacy path): rot {out['outer_mini'][0]:.3f} deg  "
          f"trans {out['outer_mini'][1]:.4f}  (excluded: {result.index_images_excluded})",
          flush=True)
    if out["internal"]:
        print(f"[diag] best internal round: rot {min(e[0] for e in out['internal']):.3f} deg")
        print(f"[diag] last internal round: rot {out['internal'][-1][0]:.3f} deg")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="PDCNet")
    ap.add_argument("--H", type=int, default=300)
    ap.add_argument("--W", type=int, default=400)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--span", type=float, default=0.35)
    ap.add_argument("--octaves", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("diag_sfm_init: no CUDA device; pass --device cpu to run on the CPU")
    run(args.backend, args.H, args.W, args.n, args.span, args.octaves, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
