#!/usr/bin/env python
"""Standalone evaluator of the PyTorch port (counterpart of eval.py).

Rebuilds the trainer from a run's saved options.yaml, loads its latest (or
best, or iter-N) snapshot, runs evaluate_full with and without test-time
pose refinement, and writes the means as JSON:

  python -m sparf_tpu_torch.eval --ckpt_dir workspace/joint_pose_nerf_training/... \\
      --out_dir ./eval_out --expname myrun [--which latest|best|iter-N|both] [--device cuda]

The qualitative panels and per-image files (--plot, --save_ind_files) are not
ported yet.
"""
from __future__ import annotations

import argparse
import json
import os


def load_model(ckpt_dir: str, data_root: str = "", which: str = "latest", device="cuda"):
    from sparf_tpu_torch.configs.config import load_options
    from sparf_tpu_torch.training.define_trainer import define_trainer

    options_path = os.path.join(ckpt_dir, "options.yaml")
    if not os.path.exists(options_path):
        raise FileNotFoundError(f"no options.yaml in {ckpt_dir}")
    cfg = load_options(options_path)
    if data_root:
        for k in ("llff", "dtu", "replica"):
            cfg.env[k] = data_root
    trainer = define_trainer(cfg, workspace=ckpt_dir, save_option=False, device=device)
    if not trainer.load_snapshot(which):
        raise FileNotFoundError(f"no snapshot {which!r} in {ckpt_dir}")
    return trainer, cfg


def run_eval(trainer, cfg, out_dir: str, expname: str):
    """evaluate_full with and without test-time refinement (when the
    trainer refines poses); writes out_dir/<expname>.json."""
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    refines = cfg.get("model") == "joint_pose_nerf_training" and cfg.optim.get("test_photo")
    for test_optim in ([True, False] if refines else [False]):
        tag = "w_test_optim" if test_optim else "without_test_optim"
        if hasattr(trainer, "_test_optim_enabled"):
            res = trainer.evaluate_full(out_dir=out_dir, with_test_optim=test_optim)
        else:
            res = trainer.evaluate_full(out_dir=out_dir)
        results[tag] = res["mean"]
    results["iteration"] = trainer.iteration
    path = os.path.join(out_dir, f"{expname}.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(f"wrote {path}")
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description="sparf_tpu_torch standalone evaluation")
    parser.add_argument("--ckpt_dir", required=True)
    parser.add_argument("--out_dir", default="./eval_out")
    parser.add_argument("--expname", default="eval")
    parser.add_argument("--data_root", default="")
    parser.add_argument("--which", default="latest",
                        help="latest | best | iter-N | both (latest, then best)")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' fails when no GPU is present")
    args = parser.parse_args(argv)
    which_list = ["latest", "best"] if args.which == "both" else [args.which]
    out = {}
    for which in which_list:
        try:
            trainer, cfg = load_model(args.ckpt_dir, args.data_root, which, device=args.device)
        except FileNotFoundError as e:
            print(f"skipping {which}: {e}")
            continue
        suffix = "" if len(which_list) == 1 else f"_{which.replace('-', '')}"
        out[which] = run_eval(trainer, cfg, args.out_dir, args.expname + suffix)
    return out


if __name__ == "__main__":
    main()
