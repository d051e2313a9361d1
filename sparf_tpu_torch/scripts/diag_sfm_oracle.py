#!/usr/bin/env python
"""The oracle-matches SfM ceiling (the port of scripts/diag_sfm_oracle.py):
run_mini_sfm fed GT-depth correspondences at the geometry-bootstrap
resolution, and the prior-init SfM from the GT poses themselves (a fixed-point
check of its bundle adjustment). If the ceiling is above ~0.5 deg, the
no-prior SfM machinery (init-pair choice, BA convergence), not the matcher,
caps the sfm_init rows.

    python -m sparf_tpu_torch.scripts.diag_sfm_oracle [--H 150 --W 200] [--n 4] [--span 0.35]
        [--noise_px 0.0] [--ba_iters 1500] [--device cuda|cpu]

Runs on the card unless --device cpu (or --cpu) is given (the JAX script is
CPU-only). --noise_px adds N(0, noise_px) to the matches from numpy
RandomState(0), as the JAX script does.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from sparf_tpu_torch.scripts.diag_sfm_init import pose_err


def run(H: int = 150, W: int = 200, n: int = 4, span: float = 0.35, noise_px: float = 0.0,
        ba_iters: int = 1500, device="cuda") -> dict:
    """Returns {'matches': {pair: count}, 'mini': (rot, trans), 'prior_gt':
    (rot, trans), 'excluded': run_mini_sfm's excluded views}."""
    from sparf_tpu_torch.colmap_init import sfm as sfm_mod
    from sparf_tpu_torch.configs.config import ConfigDict
    from sparf_tpu_torch.datasets.synthetic import load_synthetic_scene

    scene = load_synthetic_scene(split="train", H=H, W=W, n_train=n, n_test=4, texture_octaves=3,
                                 angular_span=span)
    gt = np.asarray(scene["pose"])
    cfg = ConfigDict(use_gt_correspondences=True, flow_backbone="zncc")
    kps, pair_matches, _ = sfm_mod.matches_from_dense_flow(scene, cfg, device=device)
    if noise_px > 0:
        rng = np.random.RandomState(0)
        pair_matches = {k: (idx, xy + rng.normal(0, noise_px, xy.shape).astype(np.float32))
                        for k, (idx, xy) in pair_matches.items()}
    out = dict(matches={})
    for (i, j), (idx, _) in sorted(pair_matches.items()):
        out["matches"][f"{i}-{j}"] = len(idx)
        print(f"pair ({i},{j}): {len(idx)} matches")
    res = sfm_mod.run_mini_sfm(scene, cfg, matches=(kps, pair_matches), ba_iters=ba_iters,
                               device=device)
    out["mini"] = pose_err(res.poses_w2c[:, :3], gt)
    out["excluded"] = list(res.index_images_excluded)
    print(f"ORACLE run_mini_sfm @ {H}x{W} noise={noise_px}px: rot {out['mini'][0]:.4f} deg  "
          f"trans {out['mini'][1]:.5f}  excluded={res.index_images_excluded}")
    gt44 = np.concatenate([gt, np.tile(np.array([[[0, 0, 0, 1.0]]], np.float32),
                                       (gt.shape[0], 1, 1))], 1)
    res2 = sfm_mod.run_prior_init_sfm(scene, (kps, pair_matches), gt44, ba_iters=ba_iters)
    out["prior_gt"] = pose_err(res2.poses_w2c[:, :3], gt)
    print(f"ORACLE run_prior_init_sfm(GT prior): rot {out['prior_gt'][0]:.4f} deg  "
          f"trans {out['prior_gt'][1]:.5f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--H", type=int, default=150)
    ap.add_argument("--W", type=int, default=200)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--span", type=float, default=0.35)
    ap.add_argument("--noise_px", type=float, default=0.0)
    ap.add_argument("--ba_iters", type=int, default=1500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("diag_sfm_oracle: no CUDA device; pass --device cpu to run on the CPU")
    run(args.H, args.W, args.n, args.span, args.noise_px, args.ba_iters, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
