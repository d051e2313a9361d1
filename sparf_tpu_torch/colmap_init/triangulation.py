"""Triangulation with KNOWN poses, DS-NeRF-style sparse depth supervision
(the port's copy of sparf_tpu/colmap_init/triangulation.py).

Triangulate matcher correspondences holding the (ground-truth) camera poses
fixed, and export per-image sparse depth + confidence maps for the COLMAP
depth loss (training/losses/colmap_depth.py). The matcher runs on `device`;
the rest is host numpy float64 (colmap_init/sfm.py).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from sparf_tpu_torch.colmap_init import sfm as sfm_mod


def compute_triangulation_from_matches(cfg, scene: Dict[str, np.ndarray],
                                       max_reproj_err: float = 4.0, device="cuda") -> dict:
    """Returns {'colmap_depth': (N,H,W), 'colmap_conf': (N,H,W)}."""
    images = scene["image"]
    n, _, H, W = images.shape
    K = np.asarray(scene["intr"], np.float64)
    poses_w2c = {}
    for i in range(n):
        p = np.eye(4)
        p[:3] = scene["pose"][i]
        poses_w2c[i] = p

    kps, pair_matches, _ = sfm_mod.matches_from_dense_flow(scene, cfg, device=device)
    tracks = sfm_mod.build_tracks(kps, pair_matches, n, H, W)

    def P_of(img):
        return K[img] @ poses_w2c[img][:3]

    points3d = {}
    for ti, tr in enumerate(tracks):
        seen = list(tr.keys())
        if len(seen) < 2:
            continue
        X = sfm_mod.triangulate_dlt([(P_of(im), tr[im]) for im in seen])
        if X is None:
            continue
        errs = sfm_mod.reprojection_errors(X, tr, poses_w2c, K)
        if max(errs) < max_reproj_err:
            points3d[ti] = X

    return sfm_mod.export_depth_maps(points3d, tracks, poses_w2c, K, n, H, W,
                                     max_err_px=max_reproj_err)
