"""What the geometry-stage tests against the JAX stage share
(tests/test_torch_geometry_vs_jax*.py): the DTU-like rig, its noisy prior,
both packages' stage from that prior, the EPE contract and the check of one
rig. The rigs are split over three files so that `pytest -n ... --dist
loadfile` runs them on different workers."""
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation

import torch_parity  # noqa: F401  (thread cap)
from sparf_tpu.models import flow_net as fj
from sparf_tpu_torch.datasets import synthetic
from sparf_tpu_torch.models import flow_net as ft

Array = jax.Array

COMBI = np.array([[0, 0, 1], [1, 2, 2]], np.int32)


def _mean_rel_rot_err(poses, gt) -> float:
    errs = []
    for a in range(len(gt)):
        for b in range(a + 1, len(gt)):
            Rg = gt[b][:3, :3] @ gt[a][:3, :3].T
            Re = poses[b][:3, :3] @ poses[a][:3, :3].T
            c = (np.trace(Rg.T @ Re) - 1) / 2
            errs.append(np.degrees(np.arccos(np.clip(c, -1, 1))))
    return float(np.mean(errs))


def _rig(H, W):
    sc = synthetic.load_synthetic_scene(split="train", H=H, W=W, n_train=3, n_test=1,
                                        angular_span=0.35)
    rng = np.random.RandomState(3)
    prior = []
    for P in np.asarray(sc["pose"], np.float64):
        dR = Rotation.from_rotvec(rng.randn(3) * 0.05).as_matrix()
        prior.append(np.concatenate([dR @ P[:3, :3], (dR @ P[:3, 3] + rng.randn(3) * 0.05)[:, None]],
                                    1))
    return sc, np.stack(prior)


def _run_both(sc, prior):
    """(port's corres, conf, geom_out; the port's, the JAX stage's and the
    prior's mean relative rotation errors)."""
    geom_t, geom_j = {}, {}
    corres, conf = ft.compute_zncc_flow_of_combi_list(sc["image"], COMBI, intr=sc["intr"],
                                                      init_poses_w2c=prior, geom_out=geom_t,
                                                      device="cpu")
    fj.compute_zncc_flow_of_combi_list(sc["image"], COMBI, intr=sc["intr"],
                                       init_poses_w2c=prior, geom_out=geom_j)
    gt = np.asarray(sc["pose"], np.float64)
    errs = [_mean_rel_rot_err(p, gt) for p in (geom_t["poses_w2c"], geom_j["poses_w2c"], prior)]
    print(f"bootstrap {geom_t['bootstrap']}: mean relative rotation error port {errs[0]:.4f} "
          f"deg, JAX {errs[1]:.4f}, prior {errs[2]:.4f}; rounds "
          f"{[(r['winner'], r['score']) for r in geom_t['rounds']]}")
    return corres, conf, geom_t, errs


def _epe_contract(sc, corres, conf):
    gt_corres, gt_conf = ft.compute_gt_flow_of_combi_list(sc, COMBI)
    counts, medians = [], []
    for p in range(COMBI.shape[1]):
        m = (conf[p, 0] > 0.95) & (gt_conf[p, 0] > 0.5)
        counts.append(int(m.sum()))
        medians.append(float(np.median(np.linalg.norm(corres[p] - gt_corres[p], axis=0)[m])))
    print(f"confident px {counts}, median EPE per pair {np.round(medians, 3)}")
    assert min(counts) > 45 and np.median(medians) < 1.5


# _BOOTSTRAP_MAX_DIM (None: unpatched) -> the rig's (H, W)
RIGS = {None: (64, 80), 40: (64, 80), 64: (128, 160)}


def check_stage_from_the_prior(monkeypatch, bootstrap_max_dim, flat_zero=False):
    """The stage from the rig's prior in both packages: the EPE contract,
    the bootstrap branch's report, and the port's internal poses within
    0.25 deg of the JAX stage's error (or below it); at 32x40 below 5 deg
    and below the prior's error instead, and, with `flat_zero` (the JAX
    stage's sweeps scoring flat windows 0, install_flat_zero), within 0.25
    deg of that stage as well."""
    H, W = RIGS[bootstrap_max_dim]
    sc, prior = _rig(H, W)
    if flat_zero:
        install_flat_zero(monkeypatch.setattr)
    if bootstrap_max_dim is not None:
        monkeypatch.setattr(fj, "_BOOTSTRAP_MAX_DIM", bootstrap_max_dim)
        monkeypatch.setattr(ft, "_BOOTSTRAP_MAX_DIM", bootstrap_max_dim)
    corres, conf, geom_t, (err_t, err_j, err_prior) = _run_both(sc, prior)
    assert corres.shape == (3, 2, H, W)
    _epe_contract(sc, corres, conf)
    if bootstrap_max_dim is None:
        assert geom_t["bootstrap"] is None
    else:
        small = {40: (32, 40), 64: (51, 64)}[bootstrap_max_dim]
        assert geom_t["bootstrap"] == small and "rematch_full" in geom_t["seconds"]
        assert geom_t["output"].startswith("full-resolution rematch")
    if bootstrap_max_dim != 40 or flat_zero:
        assert err_t <= err_j + 0.25
    if bootstrap_max_dim == 40:
        # what the grid-match fallback of _sparse_matches_for_sfm earns here:
        # 4.304 deg from a 6.045-deg prior (15.695 without it)
        assert err_t < min(5.0, err_prior)


# ---------------------------------------------------------------------------
# The JAX stage without its flat-window noise. The two sweeps below are
# sparf_tpu/models/flow_net.py's _plane_sweep_pair and _local_depth_sweep,
# verbatim but for the lines marked "flat-zero": a hypothesis scores 0 where
# the target or the warped source window is flat under the port's rule
# (unclamped variance <= ft._FLAT_VAR_SHARE of the window's energy Sxx),
# instead of rounding noise divided by a variance clamped at 1e-8.
# install_flat_zero puts them in place of the originals; nothing under
# sparf_tpu/ changes.
# ---------------------------------------------------------------------------


def _flat(S, Sq, k2n):
    """The port's flat rule (sparf_tpu_torch/models/flow_net.py _window_var)."""
    return Sq - S * S / k2n <= ft._FLAT_VAR_SHARE * Sq


def _plane_sweep_pair_flat0(
    img_t: Array, img_s: Array, A: Array, B: Array, inv_depths: Array,
    radius: int = 2,
) -> Tuple[Array, Array, Array]:
    """Dense depth-sweep match target->source.

    p_s ~ (A + inv_d * B) @ (x, y, 1): A = K_s R K_t^-1, B = K_s t n^T K_t^-1
    with n = [0,0,1] (fronto-parallel planes in the target camera frame).
    Returns (corres (H,W,2), zncc_peak (H,W), margin (H,W)).
    """
    C, H, W = img_t.shape
    k2n = float(C * (2 * radius + 1) ** 2)
    xx, yy = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32), jnp.arange(H, dtype=jnp.float32))
    grid_h = jnp.stack([xx, yy, jnp.ones_like(xx)], 0).reshape(3, -1)  # (3,HW)
    Ag = A @ grid_h  # (3,HW), fixed across hypotheses
    Bg = B @ grid_h

    # target window statistics (fixed)
    St = fj._box_sum(img_t, radius).sum(0)          # (H,W) over window+channels
    Stt = fj._box_sum(img_t * img_t, radius).sum(0)
    var_t = jnp.maximum(Stt - St * St / k2n, 1e-8)
    flat_t = _flat(St, Stt, k2n)  # flat-zero

    def score_one(inv_d):
        ph = Ag + inv_d * Bg                      # (3,HW)
        z = ph[2]
        x = ph[0] / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        y = ph[1] / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1) & (z > 1e-6)
        warped = fj._bilinear_at(img_s, x, y).reshape(C, H, W)
        Ss = fj._box_sum(warped, radius).sum(0)
        Sss = fj._box_sum(warped * warped, radius).sum(0)
        Sts = fj._box_sum(img_t * warped, radius).sum(0)
        cov = Sts - St * Ss / k2n
        var_s = jnp.maximum(Sss - Ss * Ss / k2n, 1e-8)
        zncc = cov / jnp.sqrt(var_t * var_s)
        zncc = jnp.where(flat_t | _flat(Ss, Sss, k2n), 0.0, zncc)  # flat-zero
        return jnp.where(inb.reshape(H, W), zncc, -1.0)

    scores = jax.lax.map(score_one, inv_depths)   # (D,H,W)
    D = inv_depths.shape[0]
    best = jnp.argmax(scores, axis=0)             # (H,W)
    s0 = jnp.max(scores, axis=0)
    margin = s0 - jnp.median(scores, axis=0)

    # parabola subpixel along the inverse-depth axis
    bm = jnp.clip(best - 1, 0, D - 1)
    bp = jnp.clip(best + 1, 0, D - 1)
    sm = jnp.take_along_axis(scores, bm[None], axis=0)[0]
    sp = jnp.take_along_axis(scores, bp[None], axis=0)[0]
    denom = sm - 2 * s0 + sp
    off = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (sm - sp) / (denom + 1e-12), 0.0)
    off = jnp.clip(off, -0.5, 0.5) * ((best > 0) & (best < D - 1))
    step = inv_depths[1] - inv_depths[0] if D > 1 else jnp.asarray(0.0)
    inv_d_star = inv_depths[best] + off * step    # (H,W)

    ph = Ag.reshape(3, H, W) + inv_d_star[None] * Bg.reshape(3, H, W)
    z = jnp.where(jnp.abs(ph[2]) < 1e-6, 1e-6, ph[2])
    corres = jnp.stack([ph[0] / z, ph[1] / z], -1)
    return corres, s0, margin


def _local_depth_sweep_flat0(
    img_t: Array, img_s: Array, A: Array, B: Array, inv_d0: Array,
    d_inv_step: float, n_offsets: int = 8, radius: int = 1,
) -> Tuple[Array, Array, Array, Array]:
    """Per-pixel inverse-depth refinement sweep around an initial depth map.

    Unlike the global homography sweep, each pixel carries its own depth, so
    the warped windows follow the local surface (a slanted-plane sweep) —
    tighter than fronto-parallel on curved geometry.
    Returns (corres, zncc, curvature, inv_depth): `curvature` is the negated
    second difference of the ZNCC profile at the peak (per step^2) — the
    localizability of the match along the epipolar line. Smooth-shading
    pixels produce cycle-consistent matches with near-zero curvature that
    drift many px along the line; gating on curvature removes exactly those
    (the geometric analog of PDC-Net's low-p_r regions)."""
    C, H, W = img_t.shape
    k2n = float(C * (2 * radius + 1) ** 2)
    xx, yy = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32), jnp.arange(H, dtype=jnp.float32))
    grid_h = jnp.stack([xx, yy, jnp.ones_like(xx)], 0).reshape(3, -1)
    Ag = (A @ grid_h).reshape(3, H, W)
    Bg = (B @ grid_h).reshape(3, H, W)

    St = fj._box_sum(img_t, radius).sum(0)
    Stt = fj._box_sum(img_t * img_t, radius).sum(0)
    var_t = jnp.maximum(Stt - St * St / k2n, 1e-8)
    flat_t = _flat(St, Stt, k2n)  # flat-zero

    offsets = jnp.arange(-n_offsets, n_offsets + 1, dtype=jnp.float32) * d_inv_step
    J = offsets.shape[0]

    # perpendicular band: the epipolar geometry here comes from an ESTIMATED
    # pose; a ~0.5 deg error shifts the true match a few px off the line, and
    # an on-line-only search then slides far ALONG the line to the best
    # on-line appearance (measured 11-22 px along-EPE on biased pairs).
    # Searching a narrow band perpendicular to the line both finds the true
    # match and lets the emitted matches EXPRESS the pose error — the
    # reprojection loss needs exactly that off-epipolar signal.
    n_perp = 3  # band = +-3 px in 1 px steps
    # epipolar direction at p: d(warp)/d(inv_d) ∝ (B1 A3 - A1 B3, B2 A3 - A2 B3)
    ex = Bg[0] * Ag[2] - Ag[0] * Bg[2]
    ey = Bg[1] * Ag[2] - Ag[1] * Bg[2]
    en = jnp.sqrt(ex * ex + ey * ey) + 1e-9
    # unit perpendicular
    px_dir = -ey / en
    py_dir = ex / en
    perp = jnp.arange(-n_perp, n_perp + 1, dtype=jnp.float32)  # px units
    K_perp = perp.shape[0]

    def score_one(jk):
        j = jk // K_perp
        k = jk % K_perp
        inv_d = inv_d0 + offsets[j]
        ph = Ag + inv_d[None] * Bg
        z = jnp.where(jnp.abs(ph[2]) < 1e-6, 1e-6, ph[2])
        x = ph[0] / z + perp[k] * px_dir
        y = ph[1] / z + perp[k] * py_dir
        inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1) & (ph[2] > 1e-6)
        warped = fj._bilinear_at(img_s, x.reshape(-1), y.reshape(-1)).reshape(C, H, W)
        Ss = fj._box_sum(warped, radius).sum(0)
        Sss = fj._box_sum(warped * warped, radius).sum(0)
        Sts = fj._box_sum(img_t * warped, radius).sum(0)
        cov = Sts - St * Ss / k2n
        var_s = jnp.maximum(Sss - Ss * Ss / k2n, 1e-8)
        zncc = cov / jnp.sqrt(var_t * var_s)
        zncc = jnp.where(flat_t | _flat(Ss, Sss, k2n), 0.0, zncc)  # flat-zero
        return jnp.where(inb, zncc, -1.0)

    scores = jax.lax.map(score_one, jnp.arange(J * K_perp))  # (J*K,H,W)
    flat_best = jnp.argmax(scores, axis=0)
    s0 = jnp.max(scores, axis=0)
    best = flat_best // K_perp
    best_k = flat_best % K_perp

    def parab(idx_lo, idx_hi, step_idx):
        sm = jnp.take_along_axis(scores, idx_lo[None], axis=0)[0]
        sp = jnp.take_along_axis(scores, idx_hi[None], axis=0)[0]
        denom = sm - 2 * s0 + sp
        off = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (sm - sp) / (denom + 1e-12), 0.0)
        return jnp.clip(off, -0.5, 0.5), denom

    # subpixel along the depth axis (at the best perp offset)
    bm = jnp.clip(best - 1, 0, J - 1) * K_perp + best_k
    bp = jnp.clip(best + 1, 0, J - 1) * K_perp + best_k
    off_j, denom_j = parab(bm, bp, 1)
    off_j = off_j * ((best > 0) & (best < J - 1))
    inv_d_star = inv_d0 + offsets[best] + off_j * d_inv_step

    # subpixel across the band (at the best depth)
    km = best * K_perp + jnp.clip(best_k - 1, 0, K_perp - 1)
    kp = best * K_perp + jnp.clip(best_k + 1, 0, K_perp - 1)
    off_k, _ = parab(km, kp, 1)
    off_k = off_k * ((best_k > 0) & (best_k < K_perp - 1))
    perp_star = perp[best_k] + off_k

    ph = Ag + inv_d_star[None] * Bg
    z = jnp.where(jnp.abs(ph[2]) < 1e-6, 1e-6, ph[2])
    corres = jnp.stack(
        [ph[0] / z + perp_star * px_dir, ph[1] / z + perp_star * py_dir], -1
    )
    # boundary peaks (true optimum outside the sweep range) get curvature 0:
    # their second difference is meaningless and the match is untrusted
    interior = (best > 0) & (best < J - 1)
    curv = jnp.maximum(-denom_j, 0.0) * interior
    return corres, s0, curv, inv_d_star




def install_flat_zero(setattr_):
    """Put the flat-zero sweeps in place of the JAX package's, through
    `setattr_` (pytest's monkeypatch.setattr, or setattr for a script)."""
    setattr_(fj, "_plane_sweep_pair", _plane_sweep_pair_flat0)
    setattr_(fj, "_local_depth_sweep", _local_depth_sweep_flat0)
