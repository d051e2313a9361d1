"""Pose initialization from matches, the reference's `sfm_pdcnet` path (the
port's copy of sparf_tpu/colmap_init/sfm.py).

The reference writes dense-matcher correspondences at grid keypoints into
hloc files and runs pycolmap's incremental mapping with known intrinsics.
Without pycolmap the same capability is built in, on the host in numpy
float64 except for the two-view and PnP solvers:
  1. grid keypoints + dense-matcher correspondences (the port's
     models/flow_net.py);
  2. tracks keyed by source keypoint;
  3. two-view init: essential matrix (5-point RANSAC) on the pair with the
     most matches + pose recovery + triangulation;
  4. incremental PnP RANSAC registration of the remaining views,
     re-triangulation of new tracks; the solvers of 3 and 4 are
     utils/imgproc.py's (torch float64 on `device`, one fixed generator seed
     per call), in place of OpenCV's;
  5. bundle adjustment: Schur-complement Levenberg-Marquardt over cameras and
     points, huber weights, float64 on the host (COLMAP's Ceres step);
  6. identity fallback + excluded-index list for unregistered images, and
     sparse depth/confidence map export.
Results are cached under save_dir (`sfm_result.npz`).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sparf_tpu_torch.utils import imgproc


@dataclass
class SfmResult:
    poses_w2c: np.ndarray                 # (N,4,4)
    valid_poses_idx: List[int]
    index_images_excluded: List[int]
    colmap_depth: Optional[np.ndarray] = None  # (N,H,W)
    colmap_conf: Optional[np.ndarray] = None   # (N,H,W)


# ---------------------------------------------------------------------------
# keypoints + matches from the dense matcher
# ---------------------------------------------------------------------------


def grid_keypoints(H: int, W: int, stride: int = 4, margin: int = 4) -> np.ndarray:
    ys, xs = np.mgrid[margin : H - margin : stride, margin : W - margin : stride]
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.float32)


def matches_from_dense_flow(
    scene: Dict[str, np.ndarray], cfg, stride: int = 2, min_conf: float = 0.95,
    device="cuda",
):
    """Run the matcher over exhaustive pairs; sample at grid keypoints.

    Returns (kps (K,2), pair_matches {(i,j): (idx_i (M,), xy_j (M,2))},
    poses_hint) where poses_hint is the matcher geometry stage's internal
    mini-SfM estimate ((N,3,4) w2c float64) or None for appearance-only
    backends. The hint matters: geometry-refined flows are epipolar-
    consistent with these very poses, so re-deriving poses from them via
    essential-matrix bootstrap can only reproduce (or degrade) the internal
    estimate — the caller should refine from the hint instead.
    """
    from sparf_tpu_torch.models import flow_net

    images = scene["image"]
    n, _, H, W = images.shape
    combi = flow_net.generate_pair_list(n)  # unordered pairs (i<j)
    backend = cfg.get("flow_backbone", "zncc")
    if cfg.get("use_gt_correspondences") and "depth_gt" in scene:
        backend = "gt_depth"
    if backend == "SPSG":
        # sparse maps are zero except at detected keypoints (reference
        # compute_triangulation_sp_sg, triangulation_w_known_poses.py:42-103
        # consumes the keypoints directly) — a strided grid would miss
        # off-grid keypoints, so sample every pixel
        stride = 1
    kps = grid_keypoints(H, W, stride)
    wrapper = flow_net.FlowSelectionWrapper(backend=backend, seed=int(cfg.get("seed", 0)),
                                            device=device)
    corres, conf = wrapper.compute_flow_and_confidence_map_of_combi_list(scene, combi)

    min_conf_eff = 1.0 if backend == "gt_depth" else min_conf
    pair_matches = {}
    kx = kps[:, 0].astype(int)
    ky = kps[:, 1].astype(int)
    for p, (i, j) in enumerate(combi.T):
        c = conf[p, 0, ky, kx]
        sel = np.where(c >= min_conf_eff)[0]
        xy_j = corres[p, :, ky[sel], kx[sel]]
        inb = (
            (xy_j[:, 0] >= 0) & (xy_j[:, 0] <= W - 1)
            & (xy_j[:, 1] >= 0) & (xy_j[:, 1] <= H - 1)
        )
        pair_matches[(int(i), int(j))] = (sel[inb], xy_j[inb])
    poses_hint = getattr(wrapper, "last_geom", {}).get("poses_w2c")
    return kps, pair_matches, poses_hint


# ---------------------------------------------------------------------------
# tracks
# ---------------------------------------------------------------------------


class UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        self.parent.setdefault(x, x)
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(kps: np.ndarray, pair_matches, n_images: int, H: int, W: int,
                 quant: float = 2.0):
    """Tracks keyed by exact source keypoint: track (i,k) collects the
    keypoint's matched location in every paired view. Returns list of
    {img: xy}.

    Earlier rounds unified matched locations through a union-find over
    `quant`-px cells to get transitive multi-view tracks; measured on oracle
    matches, cell merging fused DISTINCT 3D points up to `quant` px apart
    into one track — a structured observation error that dominated the
    SfM noise floor (0.3 deg from exact matches). Exact per-keypoint tracks
    duplicate physical points across source views instead (more, smaller
    tracks) — redundant but unbiased; `quant` is kept for signature
    compatibility and unused."""
    del quant
    tracks: Dict[Tuple[int, int], Dict[int, np.ndarray]] = {}
    for (i, j), (idx_i, xy_j) in pair_matches.items():
        for k in range(len(idx_i)):
            key = (int(i), int(idx_i[k]))
            tr = tracks.setdefault(key, {int(i): np.asarray(kps[idx_i[k]], np.float32)})
            if int(j) not in tr:
                tr[int(j)] = np.asarray(xy_j[k], np.float32)
    return [t for t in tracks.values() if len(t) >= 2]


def _shift_to_pixel_centers(kps: np.ndarray, pair_matches):
    """Integer-grid match coords -> pixel-center coords (+0.5).

    The matchers label the content of pixel (x,y) with the integer coord
    (x,y) (reference correspondence-loss parity), but physically that content
    sits on the ray through (x+0.5, y+0.5) — the renderer's convention
    (camera.get_center_and_ray). Using integer coords in SfM is equivalent to
    a half-pixel principal-point error: measured ~0.1 deg of irreducible pose
    bias on oracle matches. All SfM geometry (triangulation, PnP, BA) runs in
    center coords; export_depth_maps floors back to pixel indices."""
    kps = np.asarray(kps, np.float32) + 0.5
    shifted = {
        k: (idx, np.asarray(xy, np.float32) + 0.5)
        for k, (idx, xy) in pair_matches.items()
    }
    return kps, shifted


# ---------------------------------------------------------------------------
# geometry (DLT triangulation; the minimal solvers are utils/imgproc.py's)
# ---------------------------------------------------------------------------


def triangulate_dlt(obs: List[Tuple[np.ndarray, np.ndarray]]) -> Optional[np.ndarray]:
    """obs: [(P 3x4 = K[R|t], xy)] -> 3D point via DLT; None if degenerate."""
    A = []
    for P, xy in obs:
        A.append(xy[0] * P[2] - P[0])
        A.append(xy[1] * P[2] - P[1])
    A = np.stack(A)
    _, _, Vt = np.linalg.svd(A)
    X = Vt[-1]
    if abs(X[3]) < 1e-12:
        return None
    return X[:3] / X[3]


def reprojection_errors(X: np.ndarray, obs, poses_w2c, K) -> List[float]:
    errs = []
    for img, xy in obs.items():
        x_cam = poses_w2c[img][:3, :3] @ X + poses_w2c[img][:3, 3]
        if x_cam[2] <= 1e-6:
            errs.append(1e9)
            continue
        uv = K[img] @ x_cam
        errs.append(float(np.hypot(uv[0] / uv[2] - xy[0], uv[1] / uv[2] - xy[1])))
    return errs


def run_mini_sfm(
    scene: Dict[str, np.ndarray], cfg, max_reproj_err: float = 4.0,
    ba_iters: int = 1500, matches=None, seed: int = 0, device="cuda",
) -> SfmResult:
    """Incremental SfM over the scene's training images.

    `matches`: optional precomputed (kps (K,2), pair_matches {(i,j): (idx_i,
    xy_j)}) — used by the matcher's geometric-rematch stage, which feeds its
    own dense flows back through this pipeline for globally consistent poses.
    The essential-matrix and PnP RANSACs run on `device` with generators
    seeded `seed` (the init pair) and seed + 1 + the number of registered
    views (each registration)."""
    images = scene["image"]
    n, _, H, W = images.shape
    K = np.asarray(scene["intr"], np.float64)

    if matches is not None:
        kps, pair_matches = matches
    else:
        kps, pair_matches, poses_hint = matches_from_dense_flow(scene, cfg, device=device)
        if poses_hint is not None and len(poses_hint) == n:
            # the matcher's geometry stage already solved these poses; refine
            # from them with the robust prior-init rounds instead of re-rolling
            # the essential-matrix bootstrap on epipolar-consistent flows
            res = run_prior_init_sfm(
                scene, (kps, pair_matches), np.asarray(poses_hint),
                ba_iters=ba_iters, rounds=3, max_reproj_err=max_reproj_err,
            )
            if not res.index_images_excluded:
                return res
    kps, pair_matches = _shift_to_pixel_centers(kps, pair_matches)
    tracks = build_tracks(kps, pair_matches, n, H, W)
    if not tracks:
        return SfmResult(
            poses_w2c=np.broadcast_to(np.eye(4), (n, 4, 4)).copy(),
            valid_poses_idx=[], index_images_excluded=list(range(n)),
        )

    # --- init pair: most two-view matches
    pair_counts = {p: len(v[0]) for p, v in pair_matches.items()}
    (i0, j0) = max(pair_counts, key=pair_counts.get)
    idx_i, xy_j = pair_matches[(i0, j0)]
    pts_i = kps[idx_i].astype(np.float64)
    pts_j = xy_j.astype(np.float64)
    try:
        E, inliers = imgproc.find_essential_ransac(
            pts_i, pts_j, K[i0], thresh=1.5, prob=0.999,
            generator=torch.Generator().manual_seed(seed), device=device,
        )
    except ValueError:  # fewer than 5 pairs, or no sample gave a model
        return SfmResult(
            poses_w2c=np.broadcast_to(np.eye(4), (n, 4, 4)).copy(),
            valid_poses_idx=[], index_images_excluded=list(range(n)),
        )
    _, R, t, _ = imgproc.recover_pose(E, pts_i, pts_j, K[i0], mask=inliers, device=device)

    poses_w2c = {i0: np.eye(4), j0: np.eye(4)}
    poses_w2c[j0][:3, :3] = R
    poses_w2c[j0][:3, 3] = t[:, 0]

    def P_of(img):
        return K[img] @ poses_w2c[img][:3]

    # triangulate tracks seen by the registered pair
    points3d: Dict[int, np.ndarray] = {}
    for ti, tr in enumerate(tracks):
        seen = [img for img in tr if img in poses_w2c]
        if len(seen) >= 2:
            X = triangulate_dlt([(P_of(img), tr[img]) for img in seen])
            if X is not None:
                errs = reprojection_errors(X, {m: tr[m] for m in seen}, poses_w2c, K)
                if max(errs) < max_reproj_err:
                    points3d[ti] = X

    # --- incremental registration
    remaining = [i for i in range(n) if i not in poses_w2c]
    progress = True
    while remaining and progress:
        progress = False
        # image with most 2D-3D correspondences
        scores = []
        for img in remaining:
            cnt = sum(1 for ti in points3d if img in tracks[ti])
            scores.append((cnt, img))
        scores.sort(reverse=True)
        cnt, img = scores[0]
        if cnt < 6:
            break
        obj, imgp = [], []
        for ti, X in points3d.items():
            if img in tracks[ti]:
                obj.append(X)
                imgp.append(tracks[ti][img])
        obj = np.asarray(obj, np.float64)
        imgp = np.asarray(imgp, np.float64)
        ok, rvec, tvec, inl = imgproc.solve_pnp_ransac(
            obj, imgp, K[img], reproj_err=max_reproj_err, iters=200,
            generator=torch.Generator().manual_seed(seed + 1 + len(poses_w2c)),
            device=device,
        )
        if not ok or inl is None or len(inl) < 6:
            break
        Rm = _rodrigues(rvec[:, 0])
        pose = np.eye(4)
        pose[:3, :3] = Rm
        pose[:3, 3] = tvec[:, 0]
        poses_w2c[img] = pose
        remaining.remove(img)
        progress = True
        # extend the map with new tracks
        for ti, tr in enumerate(tracks):
            if ti in points3d:
                continue
            seen = [im for im in tr if im in poses_w2c]
            if len(seen) >= 2:
                X = triangulate_dlt([(P_of(im), tr[im]) for im in seen])
                if X is not None:
                    errs = reprojection_errors(X, {m: tr[m] for m in seen}, poses_w2c, K)
                    if max(errs) < max_reproj_err:
                        points3d[ti] = X

    registered = sorted(poses_w2c)
    if len(registered) >= 2 and points3d:
        refined = bundle_adjust(poses_w2c, points3d, tracks, K, ba_iters)
        poses_w2c.update(refined)
        # resection-intersection polish: the incremental estimate's track
        # set was gated under its own (possibly-biased) poses; re-triangulate
        # ALL tracks from scratch each round so the selection bias cannot
        # pin the solution (measured: 0.96 -> ~0.05 deg at 0.3 px match noise)
        pts = _resection_intersection_rounds(
            tracks, poses_w2c, K, H, W, rounds=3,
            max_reproj_err=max_reproj_err, ba_iters=ba_iters,
        )
        if pts is not None:
            points3d = pts

    out = np.broadcast_to(np.eye(4), (n, 4, 4)).copy()
    for img, p in poses_w2c.items():
        out[img] = p
    excluded = [i for i in range(n) if i not in poses_w2c]
    return SfmResult(
        poses_w2c=out.astype(np.float32),
        valid_poses_idx=sorted(poses_w2c),
        index_images_excluded=excluded,
        **export_depth_maps(points3d, tracks, poses_w2c, K, n, H, W),
    )


def run_prior_init_sfm(
    scene: Dict[str, np.ndarray], matches, init_poses_w2c: np.ndarray,
    ba_iters: int = 1500, rounds: int = 2, max_reproj_err: float = 4.0,
) -> "SfmResult":
    """SfM seeded from PRIOR poses instead of essential-matrix initialization.

    SPARF's joint-training regime always has noisy initial poses (~10 deg);
    two-view minimal-solver initialization is brittle exactly where that
    prior shines — when confident matches cluster on a near-planar surface
    patch, the essential matrix is degenerate and RANSAC returns an
    arbitrary member of the ambiguity family (measured 10-50 deg errors),
    while prior-init triangulation + robust BA converges reliably.
    Resection-intersection: triangulate tracks with the current poses ->
    huber bundle adjustment -> drop high-residual tracks -> repeat.
    """
    images = scene["image"]
    n, _, H, W = images.shape
    K = np.asarray(scene["intr"], np.float64)
    kps, pair_matches = _shift_to_pixel_centers(*matches)
    tracks = build_tracks(kps, pair_matches, n, H, W)
    if not tracks:
        return SfmResult(
            poses_w2c=np.broadcast_to(np.eye(4), (n, 4, 4)).copy(),
            valid_poses_idx=[], index_images_excluded=list(range(n)),
        )

    poses_w2c = {}
    for i in range(n):
        p = np.eye(4)
        p[:3] = np.asarray(init_poses_w2c)[i, :3]
        poses_w2c[i] = p

    points3d = _resection_intersection_rounds(
        tracks, poses_w2c, K, H, W, rounds=max(rounds, 1),
        max_reproj_err=max_reproj_err, ba_iters=ba_iters,
    )
    if points3d is None:
        return SfmResult(
            poses_w2c=np.broadcast_to(np.eye(4), (n, 4, 4)).copy(),
            valid_poses_idx=[], index_images_excluded=list(range(n)),
        )

    return SfmResult(
        poses_w2c=np.stack([poses_w2c[i] for i in range(n)]).astype(np.float32),
        valid_poses_idx=list(range(n)),
        index_images_excluded=[],
        **export_depth_maps(points3d, tracks, poses_w2c, K, n, H, W),
    )


def _rodrigues(w: np.ndarray) -> np.ndarray:
    """so3 exp, float64, (3,) -> (3,3)."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _resection_intersection_rounds(tracks, poses_w2c: Dict[int, np.ndarray],
                                   K, H: int, W: int, rounds: int,
                                   max_reproj_err: float, ba_iters: int):
    """Triangulate-all -> gate -> BA, repeated. Mutates `poses_w2c` in place;
    returns the final points3d dict, or None when too few tracks survive.
    Round 0 gates loosely (the starting poses may project tens of px off),
    later rounds at the target threshold."""
    points3d: Dict[int, np.ndarray] = {}
    for rnd in range(rounds):
        def P_of(img):
            return K[img] @ poses_w2c[img][:3]

        gate = max_reproj_err if rnd > 0 else max(0.12 * max(H, W), 25.0)
        points3d = {}
        for ti, tr in enumerate(tracks):
            seen = [im for im in tr if im in poses_w2c]
            if len(seen) < 2:
                continue
            X = triangulate_dlt([(P_of(im), tr[im]) for im in seen])
            if X is None:
                continue
            errs = reprojection_errors(X, {m: tr[m] for m in seen}, poses_w2c, K)
            if max(errs) < gate:
                points3d[ti] = X
        if len(points3d) < 24:
            return None
        refined = bundle_adjust(poses_w2c, points3d, tracks, K, ba_iters)
        poses_w2c.update(refined)
    return points3d


def bundle_adjust(poses_w2c, points3d, tracks, K, n_iters: int = 300,
                  huber_px: float = 2.0):
    """Bundle adjustment: joint Levenberg-Marquardt over all cameras + points
    with the point block eliminated by Schur complement, huber IRLS weights,
    float64 on the host.

    Replaces the round-1..4 Adam-on-twists BA: measured on oracle matches,
    1500 Adam steps left a 0.3-1.6 deg pose floor (underconverged first-order
    steps on the badly scaled twist/point mix); an intermediate alternating
    resection/intersection GN fixed the floor but stalled from far-off priors
    (pose-point correlation). The Schur-reduced joint step solves a dense
    6(C-1) system (C <= ~10 cameras here) plus batched 3x3 point solves —
    CERES-grade convergence at trivial cost. First camera is gauge-fixed.
    Replaces COLMAP's CERES step (reference sfm.py:47-62).

    `n_iters` is a max-LM-iterations budget (legacy callers pass Adam-scale
    numbers; clamped to [10, 120] — convergence stops earlier)."""
    imgs = sorted(poses_w2c)
    img_to_i = {im: i for i, im in enumerate(imgs)}
    tids = sorted(points3d)
    tid_to_i = {t: i for i, t in enumerate(tids)}

    obs_cam, obs_pt, obs_xy = [], [], []
    for ti in tids:
        for im, xy in tracks[ti].items():
            if im in img_to_i:
                obs_cam.append(img_to_i[im])
                obs_pt.append(tid_to_i[ti])
                obs_xy.append(xy)
    obs_cam = np.asarray(obs_cam, np.int64)
    obs_pt = np.asarray(obs_pt, np.int64)
    obs_xy = np.asarray(obs_xy, np.float64)
    Kc = np.stack([np.asarray(K[im], np.float64) for im in imgs])
    R = np.stack([poses_w2c[im][:3, :3] for im in imgs]).astype(np.float64)
    t = np.stack([poses_w2c[im][:3, 3] for im in imgs]).astype(np.float64)
    X = np.stack([points3d[ti] for ti in tids]).astype(np.float64)
    C, P = len(imgs), len(tids)

    def residuals(R, t, X):
        Xc = np.einsum("nij,nj->ni", R[obs_cam], X[obs_pt]) + t[obs_cam]
        uvh = np.einsum("nij,nj->ni", Kc[obs_cam], Xc)
        z = uvh[:, 2]
        valid = z > 1e-6
        zs = np.where(valid, z, 1.0)
        uv = uvh[:, :2] / zs[:, None]
        r = uv - obs_xy
        nrm = np.linalg.norm(r, axis=1)
        w = np.where(nrm <= huber_px, 1.0, huber_px / np.maximum(nrm, 1e-12))
        w = np.where(valid, w, 0.0)
        # huber cost (for the accept/damping logic)
        cost = np.where(
            nrm <= huber_px, 0.5 * nrm**2, huber_px * (nrm - 0.5 * huber_px)
        )
        cost = float(np.sum(np.where(valid, cost, huber_px * 50.0)))
        return Xc, uv, zs, r, w, cost

    def duv_dXc(uv, zs, cams):
        """(M,2,3): d(perspective K-projection)/dXc, general K."""
        Kr = Kc[cams]  # (M,3,3)
        return (Kr[:, :2] - uv[..., None] * Kr[:, 2:3]) / zs[:, None, None]

    # obs-pair index lists for the Schur reduction: all ordered pairs of
    # observations sharing a point
    order = np.argsort(obs_pt, kind="stable")
    pt_sorted = obs_pt[order]
    starts = np.r_[0, np.flatnonzero(np.diff(pt_sorted)) + 1]
    counts = np.diff(np.r_[starts, len(pt_sorted)])
    pm1 = np.concatenate([order[s : s + c].repeat(c) for s, c in zip(starts, counts)])
    pm2 = np.concatenate([np.tile(order[s : s + c], c) for s, c in zip(starts, counts)])

    n_alt = int(np.clip(n_iters, 10, 120))
    lam = 1e-6
    Xc, uv, zs, r, w, cost = residuals(R, t, X)
    reject_streak = 0
    n_obs_pt = np.bincount(obs_pt, minlength=P)
    for _ in range(n_alt):
        prev_cost = cost
        A = duv_dXc(uv, zs, obs_cam)                      # (M,2,3) duv/dXc
        Bp = A @ R[obs_cam]                               # (M,2,3) duv/dX
        M = obs_xy.shape[0]
        skew = np.zeros((M, 3, 3))
        skew[:, 0, 1] = -Xc[:, 2]
        skew[:, 0, 2] = Xc[:, 1]
        skew[:, 1, 0] = Xc[:, 2]
        skew[:, 1, 2] = -Xc[:, 0]
        skew[:, 2, 0] = -Xc[:, 1]
        skew[:, 2, 1] = Xc[:, 0]
        # duv/d(omega,v) = A @ [-[Xc]x | I]  (perturbation R<-exp(w)R,
        # t<-exp(w)t+v, so dXc = omega x Xc + v = -[Xc]x omega + v)
        Bc = np.concatenate([-np.matmul(A, skew), A], axis=2)  # (M,2,6)
        Bcw = Bc * w[:, None, None]
        Bpw = Bp * w[:, None, None]
        # normal-equation blocks
        Hcc = np.zeros((C, 6, 6))
        gc = np.zeros((C, 6))
        np.add.at(Hcc, obs_cam, np.einsum("mki,mkj->mij", Bcw, Bc))
        np.add.at(gc, obs_cam, np.einsum("mki,mk->mi", Bcw, r))
        Hpp = np.zeros((P, 3, 3))
        gp = np.zeros((P, 3))
        np.add.at(Hpp, obs_pt, np.einsum("mki,mkj->mij", Bpw, Bp))
        np.add.at(gp, obs_pt, np.einsum("mki,mk->mi", Bpw, r))
        Hcp = np.einsum("mki,mkj->mij", Bcw, Bp)          # (M,6,3) per obs
        # LM damping (multiplicative on the diagonals)
        Hcc_d = Hcc + lam * np.eye(6) * np.maximum(
            np.einsum("cii->c", Hcc), 1e-6)[:, None, None] / 6
        Hpp_d = Hpp + lam * np.eye(3) * np.maximum(
            np.einsum("pii->p", Hpp), 1e-6)[:, None, None] / 3
        Hpp_d += 1e-10 * np.eye(3)
        Hpp_inv = np.linalg.inv(Hpp_d)
        # Schur complement over cameras: S = Hcc - sum_p Hcp Hpp^-1 Hpc
        T = Hcp @ Hpp_inv[obs_pt]                         # (M,6,3)
        S = np.zeros((C, C, 6, 6))
        for c0 in range(C):
            S[c0, c0] += Hcc_d[c0]
        chunk = 200_000
        for a in range(0, len(pm1), chunk):
            m1 = pm1[a : a + chunk]
            m2 = pm2[a : a + chunk]
            contrib = T[m1] @ np.transpose(Hcp[m2], (0, 2, 1))  # (m,6,6)
            np.add.at(S, (obs_cam[m1], obs_cam[m2]), -contrib)
        g_red = gc.copy()
        np.add.at(g_red, obs_cam, -np.einsum("mij,mj->mi", T, gp[obs_pt]))
        # gauge: drop camera 0 from the reduced system
        Sm = np.transpose(S[1:, 1:], (0, 2, 1, 3)).reshape(6 * (C - 1), 6 * (C - 1))
        gm = g_red[1:].reshape(-1)
        try:
            dc = np.linalg.solve(Sm, -gm).reshape(C - 1, 6)
        except np.linalg.LinAlgError:
            lam = min(lam * 10.0, 1e4)
            continue
        dcam = np.concatenate([np.zeros((1, 6)), dc], 0)
        # back-substitute the point update
        rhs = gp.copy()
        np.add.at(rhs, obs_pt, np.einsum("mij,mi->mj", Hcp, dcam[obs_cam]))
        dX = -np.einsum("pij,pj->pi", Hpp_inv, rhs)
        dX[n_obs_pt < 2] = 0.0
        R_new = np.stack([_rodrigues(dcam[c, :3]) @ R[c] for c in range(C)])
        t_new = np.stack([
            _rodrigues(dcam[c, :3]) @ t[c] + dcam[c, 3:] for c in range(C)
        ])
        X_new = X + dX
        Xc2, uv2, zs2, r2, w2, cost_new = residuals(R_new, t_new, X_new)
        if cost_new <= prev_cost:
            R, t, X = R_new, t_new, X_new
            Xc, uv, zs, r, w, cost = Xc2, uv2, zs2, r2, w2, cost_new
            lam = max(lam * 0.3, 1e-9)
            reject_streak = 0
            if prev_cost - cost < 1e-12 * max(prev_cost, 1.0):
                break
        else:
            lam = min(lam * 10.0, 1e4)
            reject_streak += 1
            if reject_streak >= 10:
                break

    out = {}
    for im, i in img_to_i.items():
        p4 = np.eye(4, dtype=np.float32)
        p4[:3, :3] = R[i].astype(np.float32)
        p4[:3, 3] = t[i].astype(np.float32)
        out[im] = p4
    # refined points back into the caller's dict (run_prior_init_sfm's
    # re-triangulation gates and the depth export both read them)
    for ti, i in tid_to_i.items():
        points3d[ti] = X[i]
    return out


def export_depth_maps(points3d, tracks, poses_w2c, K, n, H, W,
                      max_err_px: float = 4.0) -> dict:
    """Sparse depth + confidence maps from the 3D points (sfm.py:74-156):
    conf = 1/(1+reproj_err)."""
    depth = np.zeros((n, H, W), np.float32)
    conf = np.zeros((n, H, W), np.float32)
    for ti, X in points3d.items():
        for img, xy in tracks[ti].items():
            if img not in poses_w2c:
                continue
            x_cam = poses_w2c[img][:3, :3] @ X + poses_w2c[img][:3, 3]
            if x_cam[2] <= 1e-6:
                continue
            uv = K[img] @ x_cam
            u, v = uv[0] / uv[2], uv[1] / uv[2]
            err = np.hypot(u - xy[0], v - xy[1])
            if err > max_err_px:
                continue
            # center-coord u=x+0.5 is the middle of pixel x -> floor
            ui, vi = int(np.floor(u)), int(np.floor(v))
            if 0 <= ui < W and 0 <= vi < H:
                c = 1.0 / (1.0 + err)
                if c > conf[img, vi, ui]:
                    depth[img, vi, ui] = x_cam[2]
                    conf[img, vi, ui] = c
    return dict(colmap_depth=depth, colmap_conf=conf)


# ---------------------------------------------------------------------------
# public entry (joint_pose_nerf_trainer.py:82-122 counterpart)
# ---------------------------------------------------------------------------


def compute_sfm_from_matches(
    cfg, scene: Dict[str, np.ndarray], save_dir: str, load_colmap_depth: bool = False,
    device="cuda",
) -> SfmResult:
    """Run (or load cached) SfM initialization for the scene."""
    os.makedirs(save_dir, exist_ok=True)
    cache = os.path.join(save_dir, "sfm_result.npz")
    if os.path.exists(cache):
        data = np.load(cache, allow_pickle=True)
        return SfmResult(
            poses_w2c=data["poses_w2c"],
            valid_poses_idx=list(data["valid_poses_idx"]),
            index_images_excluded=list(data["index_images_excluded"]),
            colmap_depth=data["colmap_depth"] if load_colmap_depth else None,
            colmap_conf=data["colmap_conf"] if load_colmap_depth else None,
        )
    result = run_mini_sfm(scene, cfg, seed=int(cfg.get("seed", 0)), device=device)
    np.savez_compressed(
        cache,
        poses_w2c=result.poses_w2c,
        valid_poses_idx=np.asarray(result.valid_poses_idx, np.int32),
        index_images_excluded=np.asarray(result.index_images_excluded, np.int32),
        colmap_depth=result.colmap_depth if result.colmap_depth is not None else np.zeros(0),
        colmap_conf=result.colmap_conf if result.colmap_conf is not None else np.zeros(0),
    )
    if not load_colmap_depth:
        result.colmap_depth = None
        result.colmap_conf = None
    return result
