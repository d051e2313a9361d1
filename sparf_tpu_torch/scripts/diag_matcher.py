#!/usr/bin/env python
"""The geometry-guided matcher, stage by stage, on the analytic scene (the
port of scripts/diag_matcher.py).

Reports, per pair (median EPE over confident px against the GT flow):
  1. stage-1 appearance matching (hierarchical ZNCC + LK);
  2. the full pipeline (mini-SfM + plane-sweep rematch rounds), with the
     error along and across the GT epipolar line;
  3. the ORACLE-POSE rematch: `_geom_rematch_pair` fed the GT relative pose
     and the GT depth range, which separates sweep precision from pose error;
  4. the mini-SfM's pose error: the mean relative rotation error of the
     stage's internal poses against GT.

    python -m sparf_tpu_torch.scripts.diag_matcher [--H 300 --W 400 --n 3 --span 1.0]
        [--noise 0.05] [--priors 0,1,2 [--bootstrap 40]] [--rounds] [--device cuda|cpu]

--priors runs the full pipeline once from each of the DTU-like rig's noisy
priors (tests/geometry_reference.py --rig: a numpy RandomState(seed) rotation
and translation noise of 0.05 per view) instead of --noise; --bootstrap sets
the stage's `_BOOTSTRAP_MAX_DIM` for the run (the rig of
tests/test_torch_geometry_vs_jax_boot40.py is --H 64 --W 80 --span 0.35
--bootstrap 40). --rounds adds, per round and candidate, the winner, the
candidate's pose error, its rematched-flow score split into coverage and
mean confident ZNCC, and the SfM matches kept per pair ("grid" when the
round took the flows' grid matches). --noise draws its se(3) noise from
torch.Generator seed 1, not from the JAX script's PRNGKey(1): the two
scripts' noisy priors differ. Runs on the card unless --device cpu (or
--cpu) is given.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch


def rel_pose(poses, t, s):
    Rt, tt = poses[t][:3, :3], poses[t][:3, 3]
    Rs, ts = poses[s][:3, :3], poses[s][:3, 3]
    R = Rs @ Rt.T
    return R, ts - R @ tt


def epe_stats(corres, conf, gt_corres, gt_conf, min_conf=0.95, epi_dir=None):
    """EPE statistics over confident px with GT. epi_dir: (H,W,2) unit GT
    epipolar direction at the GT match, which adds the error along and across
    the GT epipolar line: the error across it biases pose recovery, the error
    along it only implies another depth."""
    m = (conf > min_conf) & (gt_conf[0] > 0.5)
    if m.sum() < 10:
        return dict(n=int(m.sum()))
    diff = np.asarray(corres).transpose(2, 0, 1) - gt_corres
    err = np.linalg.norm(diff, axis=0)[m]
    out = dict(n=int(m.sum()), med=float(np.median(err)), mean=float(err.mean()),
               pck1=float((err <= 1).mean()), pck3=float((err <= 3).mean()))
    if epi_dir is not None:
        d = diff.transpose(1, 2, 0)[m]
        e = epi_dir[m]
        along = np.abs(np.sum(d * e, -1))
        perp = np.abs(d[:, 0] * e[:, 1] - d[:, 1] * e[:, 0])
        out["med_along"] = float(np.median(along))
        out["med_perp"] = float(np.median(perp))
        out["perp_pck1"] = float((perp <= 1).mean())
    return out


def gt_epipolar_dirs(sc, t, s, eps=1e-3):
    """(H,W,2) unit direction of the GT epipolar line at the GT match:
    d(project)/d(depth), normalised."""
    from sparf_tpu_torch.utils import geometry

    H, W = sc["depth_gt"][t].shape
    xx, yy = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    pix = torch.as_tensor(np.stack([xx, yy], -1).reshape(1, -1, 2))
    depth = torch.as_tensor(np.asarray(sc["depth_gt"][t], np.float32).reshape(1, -1))
    T = geometry.relative_transform_i_to_j(torch.as_tensor(np.asarray(sc["pose"][t])),
                                           torch.as_tensor(np.asarray(sc["pose"][s])))[None]
    K = torch.as_tensor(np.asarray(sc["intr"][:1]))
    p0 = geometry.batch_project_to_other_img(pix, depth, K, K, T)[0].numpy()
    p1 = geometry.batch_project_to_other_img(pix, depth * (1 + eps), K, K, T)[0].numpy()
    d = p1 - p0
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    return (d / np.where(n < 1e-9, 1e-9, n)).reshape(H, W, 2)


def mean_rel_rot_deg(poses, gt) -> float:
    """Mean over view pairs of the relative rotation's angle error, degrees."""
    errs = []
    for a in range(len(gt)):
        for b in range(a + 1, len(gt)):
            Rg = gt[b][:3, :3] @ gt[a][:3, :3].T
            Re = poses[b][:3, :3] @ poses[a][:3, :3].T
            c = (np.trace(Rg.T @ Re) - 1) / 2
            errs.append(float(np.degrees(np.arccos(np.clip(c, -1, 1)))))
    return float(np.mean(errs))


def rig_prior(gt: np.ndarray, seed: int) -> np.ndarray:
    """The DTU-like rig's noisy prior (tests/geometry_reference.py --rig):
    per view a rotation vector and a translation of N(0, 0.05) from
    numpy RandomState(seed)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    prior = []
    for P in np.asarray(gt, np.float64):
        dR = Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
        prior.append(np.concatenate([dR @ P[:3, :3], (dR @ P[:3, 3] + rng.randn(3) * 0.05)[:, None]],
                                    1))
    return np.stack(prior)


def describe_rounds(rounds, gt) -> list:
    """Per round: winner, score, matches kept and every candidate's pose error
    and score parts (from compute_zncc_flow_of_combi_list's geom_out)."""
    out = []
    for r in rounds:
        cands = []
        for c in r.get("candidates", []):
            row = dict(candidate=c["candidate"])
            if c.get("poses") is None:
                row["rot_err_deg"] = None
            else:
                row.update(rot_err_deg=mean_rel_rot_deg(np.asarray(c["poses"]), gt),
                           score=c["score"],
                           coverage=c["coverage"], mean_zncc=c["mean_zncc"])
            cands.append(row)
        kp = r.get("keypoints")
        out.append(dict(round=r["round"], winner=r["winner"], score=r["score"],
                        keypoints="grid" if kp is None else dict(sorted(kp.items())),
                        candidates=cands))
    return out


def run(H: int = 300, W: int = 400, n: int = 3, span: float = 1.0, octaves: int = 1,
        noise: float = 0.0, skip_stage1: bool = False, priors=None,
        bootstrap: Optional[int] = None, rounds: bool = False, device="cuda") -> dict:
    """Every section's readings as a dict (and printed as the JAX script
    prints them): 'stage1', 'oracle' ({pair: stats}), 'full' (one entry per
    prior: its pair stats, the prior's and the stage's rotation errors and,
    with `rounds`, the rounds)."""
    from sparf_tpu_torch.datasets.synthetic import load_synthetic_scene
    from sparf_tpu_torch.models import flow_net as F
    from sparf_tpu_torch.utils import camera as cam

    sc = load_synthetic_scene(split="train", H=H, W=W, n_train=n, n_test=1, angular_span=span,
                              texture_octaves=octaves)
    imgs = np.asarray(sc["image"])
    intr = np.asarray(sc["intr"])
    gt = np.asarray(sc["pose"], np.float64)
    combi = F.get_combi_list(imgs.shape[0], "all")
    gt_corres, gt_conf = F.compute_gt_flow_of_combi_list(sc, combi)
    poses44 = []
    for i in range(imgs.shape[0]):
        p = np.eye(4)
        p[:3] = sc["pose"][i]
        poses44.append(p)
    out = dict(stage1={}, full=[], oracle={})

    if not skip_stage1:
        c1, f1 = F.compute_zncc_flow_of_combi_list(imgs, combi, intr=None, device=device)
        print("== stage-1 appearance matching ==")
        for p, (t, s) in enumerate(combi.T):
            st = epe_stats(np.asarray(c1[p]).transpose(1, 2, 0), f1[p, 0], gt_corres[p],
                           gt_conf[p: p + 1, 0])
            out["stage1"][f"{t}->{s}"] = st
            print(f"  pair {t}->{s}: {st}")

    if priors is not None:
        inits = [(seed, rig_prior(gt, seed)) for seed in priors]
    elif noise > 0:
        g = torch.Generator().manual_seed(1)
        se3_noise = torch.randn((imgs.shape[0], 6), generator=g) * noise
        inits = [(None, cam.pose_compose([cam.se3_to_SE3(se3_noise),
                                          torch.as_tensor(np.asarray(sc["pose"]))]).numpy())]
    else:
        inits = [(None, None)]
    saved_boot = F._BOOTSTRAP_MAX_DIM
    if bootstrap is not None:
        F._BOOTSTRAP_MAX_DIM = bootstrap
    try:
        for seed, init_poses in inits:
            geom = {}
            c2, f2 = F.compute_zncc_flow_of_combi_list(imgs, combi, intr=intr,
                                                       init_poses_w2c=init_poses, geom_out=geom,
                                                       round_candidates=rounds, device=device)
            print("== full pipeline (mini-SfM + rematch)"
                  + ("" if seed is None else f", prior seed {seed}") + " ==")
            entry = dict(prior_seed=seed, pairs={},
                         prior_rot_err_deg=(None if init_poses is None
                                            else mean_rel_rot_deg(init_poses, gt)),
                         sfm_rot_err_deg=(mean_rel_rot_deg(geom["poses_w2c"], gt)
                                          if "poses_w2c" in geom else None))
            for p, (t, s) in enumerate(combi.T):
                ed = gt_epipolar_dirs(sc, int(t), int(s))
                st = epe_stats(np.asarray(c2[p]).transpose(1, 2, 0), f2[p, 0], gt_corres[p],
                               gt_conf[p: p + 1, 0], epi_dir=ed)
                entry["pairs"][f"{t}->{s}"] = st
                print(f"  pair {t}->{s}: {st}")
            print(f"  mini-SfM: mean relative rotation error {entry['sfm_rot_err_deg']} deg "
                  f"(prior {entry['prior_rot_err_deg']})")
            if rounds:
                entry["rounds"] = describe_rounds(geom.get("rounds", []), gt)
                for r in entry["rounds"]:
                    print(f"  round {json.dumps(r)}")
            out["full"].append(entry)
    finally:
        F._BOOTSTRAP_MAX_DIM = saved_boot

    if not skip_stage1:
        print("== oracle-pose plane-sweep rematch ==")
        jimgs = torch.as_tensor(imgs, dtype=torch.float32, device=device)
        with torch.no_grad():
            for p, (t, s) in enumerate(combi.T):
                t, s = int(t), int(s)
                R, tr = rel_pose(poses44, t, s)
                d = sc["depth_gt"][t][sc["valid_depth_gt"][t]]
                c, score, mg, _cv, _d = F._geom_rematch_pair(jimgs[t], jimgs[s], intr[t], intr[s],
                                                             R, tr, d)
                conf = (score.cpu().numpy() >= 0.5) & (mg.cpu().numpy() >= 0.02)
                st = epe_stats(c.cpu().numpy(), conf.astype(np.float32), gt_corres[p],
                               gt_conf[p: p + 1, 0], min_conf=0.5)
                out["oracle"][f"{t}->{s}"] = st
                print(f"  pair {t}->{s}: {st}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--H", type=int, default=300)
    ap.add_argument("--W", type=int, default=400)
    ap.add_argument("--n", type=int, default=3)
    ap.add_argument("--span", type=float, default=1.0)
    ap.add_argument("--octaves", type=int, default=1)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="se3 noise sigma of the init-pose prior (0 = no prior)")
    ap.add_argument("--priors", default=None,
                    help="comma-separated numpy seeds of the rig's noisy priors")
    ap.add_argument("--bootstrap", type=int, default=None, help="_BOOTSTRAP_MAX_DIM for the run")
    ap.add_argument("--rounds", action="store_true", help="report every round's candidates")
    ap.add_argument("--skip-stage1", action="store_true",
                    help="skip the stage-1-only and oracle sections")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("diag_matcher: no CUDA device; pass --device cpu to run on the CPU")
    run(args.H, args.W, args.n, args.span, args.octaves, args.noise, args.skip_stage1,
        None if args.priors is None else [int(v) for v in args.priors.split(",")],
        args.bootstrap, args.rounds, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
