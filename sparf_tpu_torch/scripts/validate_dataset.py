#!/usr/bin/env python
"""Real-data readiness drill for the port's loaders (the counterpart of
scripts/validate_dataset.py): point this at a mounted DTU / LLFF / Replica
root and it checks sparf_tpu_torch.datasets' output against the invariants
SURVEY.md documents for the reference (dtu.py:113-136, llff.py:34-84,
rgbd_datasets.py:196-279), so golden runs can start minutes after data
appears instead of after a debugging session.

Usage:
  python -m sparf_tpu_torch.scripts.validate_dataset --dataset dtu --root /data/rs_dtu_4 \
      --scene scan82 [--mask_root ...] [--depth_root ...] [--train_sub 3]
  python -m sparf_tpu_torch.scripts.validate_dataset --dataset llff --root /data/llff --scene horns
  python -m sparf_tpu_torch.scripts.validate_dataset --dataset replica --root /data/replica \
      --scene office0
  python -m sparf_tpu_torch.scripts.validate_dataset --dataset synthetic --scene spheres

Exit code 0 = all checks pass. Needs no GPU (numpy only); the synthetic
scene needs no root.
"""
from __future__ import annotations

import argparse
import os
import sys
import traceback

import numpy as np

# reference constants (SURVEY.md §2.36-38)
DTU_TRAIN_IDS = [25, 22, 28, 40, 44, 48, 0, 8, 13]   # pixelnerf split, dtu.py:132-136
DTU_EXCLUDE = {3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39}
DTU_NEAR, DTU_FAR = 1.2, 5.2                          # dtu.py:119-121
DTU_HW = (300, 400)
REPLICA_INTR = dict(f=600.0, H=680, W=1200)           # rgbd_datasets.py fixed intrinsics
REPLICA_DEPTH_SCALE = 6553.5


class Report:
    def __init__(self):
        self.n_pass = 0
        self.n_fail = 0

    def check(self, name: str, ok: bool, detail: str = ""):
        mark = "PASS" if ok else "FAIL"
        self.n_pass += ok
        self.n_fail += not ok
        print(f"  [{mark}] {name}" + (f": {detail}" if detail else ""))


def rot_orthonormality(pose_w2c: np.ndarray) -> float:
    R = pose_w2c[:, :3, :3]
    err = np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max()
    det = np.abs(np.linalg.det(R) - 1.0).max()
    return max(float(err), float(det))


def common_checks(rep: Report, scene: dict, split: str):
    img = scene["image"]
    B, C, H, W = img.shape
    rep.check(f"{split}: image (B,3,H,W) float in [0,1]",
              C == 3 and img.dtype == np.float32 and 0 <= img.min() and img.max() <= 1.0001,
              f"shape={img.shape} range=[{img.min():.3f},{img.max():.3f}]")
    pose = scene["pose"]
    rep.check(f"{split}: pose (B,3,4) w2c", pose.shape == (B, 3, 4), f"{pose.shape}")
    # 5e-3: float32 poses_bounds roundtrips carry ~1e-3 slop; convention bugs
    # (c2w-vs-w2c, bad decomposition) produce O(1) errors
    rep.check(f"{split}: rotations orthonormal",
              rot_orthonormality(pose) < 5e-3, f"max err {rot_orthonormality(pose):.2e}")
    intr = scene["intr"]
    rep.check(f"{split}: intr (B,3,3)", intr.shape == (B, 3, 3), f"{intr.shape}")
    cx, cy = intr[:, 0, 2], intr[:, 1, 2]
    rep.check(f"{split}: principal point near image center",
              np.all(np.abs(cx - W / 2) < 0.25 * W) and np.all(np.abs(cy - H / 2) < 0.25 * H),
              f"cx~{cx.mean():.1f} (W={W}), cy~{cy.mean():.1f} (H={H})")
    rep.check(f"{split}: positive focal lengths",
              np.all(intr[:, 0, 0] > 0) and np.all(intr[:, 1, 1] > 0),
              f"fx~{intr[:, 0, 0].mean():.1f}")
    dr = scene["depth_range"]
    rep.check(f"{split}: depth_range 0 < near < far",
              np.all(dr[:, 0] > 0) and np.all(dr[:, 0] < dr[:, 1]),
              f"near~{dr[:, 0].mean():.3f} far~{dr[:, 1].mean():.3f}")
    if "fg_mask" in scene:
        m = scene["fg_mask"]
        rep.check(f"{split}: fg_mask aligned + binary",
                  m.shape[-2:] == (H, W) and set(np.unique(m.astype(np.float32))) <= {0.0, 1.0},
                  f"shape={m.shape} mean={m.astype(np.float32).mean():.3f}")
    if "depth_gt" in scene:
        d = scene["depth_gt"]
        v = scene.get("valid_depth_gt", np.isfinite(d) & (d > 0))
        dv = d[v.astype(bool)]
        near, far = dr[:, 0].min(), dr[:, 1].max()
        frac_in = float(np.mean((dv >= near * 0.8) & (dv <= far * 1.2))) if dv.size else 0.0
        rep.check(f"{split}: depth_gt within depth_range (80% margin)",
                  frac_in > 0.95, f"{100 * frac_in:.1f}% in range, "
                  f"median={np.median(dv) if dv.size else float('nan'):.3f}")
    # camera centers should sit at O(1) distance in the normalized world
    R, t = pose[:, :3, :3], pose[:, :3, 3]
    centers = -np.einsum("bij,bi->bj", R, t)
    rad = np.linalg.norm(centers, axis=-1)
    rep.check(f"{split}: camera centers O(1) from origin (world scaling applied)",
              0.01 < rad.mean() < 100.0, f"mean |C| = {rad.mean():.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", required=True, choices=["dtu", "llff", "replica", "synthetic"])
    ap.add_argument("--root", default="")
    ap.add_argument("--scene", required=True)
    ap.add_argument("--train_sub", type=int, default=3)
    ap.add_argument("--mask_root", default=None)
    ap.add_argument("--depth_root", default=None)
    args = ap.parse_args(argv)

    if args.dataset != "synthetic" and not os.path.isdir(args.root):
        print(f"root {args.root} does not exist / is not a directory")
        return 2

    from sparf_tpu_torch.configs.config import ConfigDict
    from sparf_tpu_torch.datasets import create_dataset

    cfg = ConfigDict(
        dataset=args.dataset, scene=args.scene, train_sub=args.train_sub,
        env=ConfigDict(llff=args.root, dtu=args.root, replica=args.root,
                       dtu_mask=args.mask_root, dtu_depth=args.depth_root),
    )

    rep = Report()
    scenes = {}
    for split in ("train", "test"):
        try:
            scenes[split] = create_dataset(cfg, split)
        except Exception as e:
            rep.check(f"load {split} split", False, f"{type(e).__name__}: {e}")
            traceback.print_exc()
    for split, scene in scenes.items():
        print(f"\n== {args.dataset}/{args.scene} [{split}] ==")
        common_checks(rep, scene, split)

    def image_ids(scene):
        """Original per-image ids from rgb_path basenames (scene['idx'] is the
        in-split position, not the source image id)."""
        ids = []
        for p in scene.get("rgb_path", []):
            stem = os.path.splitext(os.path.basename(str(p)))[0]
            digits = "".join(c for c in stem if c.isdigit())
            ids.append(int(digits) if digits else stem)
        return ids

    if "train" in scenes and "test" in scenes:
        tr, te = scenes["train"], scenes["test"]
        tr_ids, te_ids_l = image_ids(tr), image_ids(te)
        overlap = set(tr_ids) & set(te_ids_l)
        rep.check("train/test split disjoint", bool(tr_ids) and not overlap,
                  f"overlap={sorted(overlap)}")

        if args.dataset == "dtu":
            want = DTU_TRAIN_IDS[: args.train_sub]
            rep.check("DTU pixelnerf train ids (first-N of fixed list)",
                      tr_ids == want, f"got {tr_ids}, want {want}")
            rep.check("DTU test ids exclude the 15 unusable views",
                      bool(te_ids_l) and not (set(te_ids_l) & DTU_EXCLUDE))
            H, W = tr["image"].shape[-2:]
            rep.check("DTU 300x400 rectified resolution", (H, W) == DTU_HW, f"{(H, W)}")
            dr = tr["depth_range"]
            rep.check("DTU near/far = 1.2/5.2 (1/300-scaled world)",
                      np.allclose(dr[:, 0], DTU_NEAR, atol=0.3)
                      and np.allclose(dr[:, 1], DTU_FAR, atol=0.6),
                      f"near~{dr[:, 0].mean():.2f} far~{dr[:, 1].mean():.2f}")
        if args.dataset == "llff":
            te_ids = np.asarray([i for i in te_ids_l if isinstance(i, int)])
            rep.check("LLFF holdout = every 8th image",
                      te_ids.size > 0 and np.all(te_ids % 8 == 0),
                      f"test ids {te_ids.tolist()}")
            # +z flip check: average camera forward should face +z in world
            R = tr["pose"][:, :3, :3]
            fwd = R[:, 2, :]  # w2c row 2 = camera z axis in world coords
            rep.check("LLFF cameras face +z after flip (identity-init ready)",
                      fwd[:, 2].mean() > 0, f"mean forward-z {fwd[:, 2].mean():.3f}")
        if args.dataset == "replica":
            f = tr["intr"][:, 0, 0]
            H, W = tr["image"].shape[-2:]
            want_f = REPLICA_INTR["f"] * W / REPLICA_INTR["W"]
            rep.check("Replica fixed intrinsics (f=600 @ 1200px, scaled)",
                      np.allclose(f, want_f, rtol=0.05), f"f~{f.mean():.1f} want~{want_f:.1f}")

    print(f"\n{rep.n_pass} passed, {rep.n_fail} failed")
    return 0 if rep.n_fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
