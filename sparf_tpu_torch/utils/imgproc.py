"""The image and two-view operations the port needs, without OpenCV.

The JAX package calls OpenCV for these; the machine that runs the port on the
card has no `cv2`, so the port keeps its own versions, held to OpenCV's by
`tests/test_torch_imgproc.py`:

  - `resize_area` (cv2.INTER_AREA): the box mean for integer factors and the
    area-overlap weights otherwise, summed in OpenCV's order so that 3-channel
    float32 images come out bit for bit; upscaling takes OpenCV's
    area-mode linear coefficients;
  - `resize_linear` (cv2.INTER_LINEAR, half-pixel centres, edge clamp) and
    `resize_nearest` (cv2.INTER_NEAREST);
  - `resize_bilinear`: `jax.image.resize(..., "bilinear")` on torch tensors
    (a triangle kernel, antialiased when downsampling), which the matchers
    use where the JAX package resizes flows and confidences;
  - `dilate` (cv2.dilate with a 3x3 box, iterated);
  - `decompose_projection_matrix` (cv2.decomposeProjectionMatrix's K, R, t);
  - `find_fundamental_ransac`: epipolar RANSAC in place of
    cv2.findFundamentalMat(FM_RANSAC). RANSAC draws random samples, so its
    masks agree with OpenCV's by rate, not bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparf_tpu_torch.utils.precision import ieee_fp32

# ---------------------------------------------------------------------------
# resizing (numpy, host side, like OpenCV)
# ---------------------------------------------------------------------------


def _float_image(image: np.ndarray) -> Tuple[np.ndarray, bool]:
    img = np.asarray(image)
    if not np.issubdtype(img.dtype, np.floating):
        raise TypeError(f"expected a float image, got {img.dtype}")
    return (img[..., None], True) if img.ndim == 2 else (img, False)


def _cv_scale(src: int, dst: int) -> float:
    """OpenCV's source pixels per destination pixel: 1 / (dst / src) in double."""
    return 1.0 / (dst / src)


def _area_tab(src: int, dst: int, scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's computeResizeAreaTab as a (dst, taps) table of source indices
    and float32 weights, in OpenCV's tap order; unused taps have weight 0."""
    rows = []
    for d in range(dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, src - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, (s1 - fs1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            taps.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((dst, k), np.int64)
    w = np.zeros((dst, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], w[d, j] = s, np.float32(a)
    return idx, w


def _linear_tab(src: int, dst: int, scale: float, area_mode: bool
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's linear coefficients: (i0, i1, float32 w1) per destination
    pixel; area_mode gives INTER_AREA's upscaling coefficients."""
    i0 = np.zeros(dst, np.int64)
    w1 = np.zeros(dst, np.float32)
    for d in range(dst):
        if area_mode:
            s = math.floor(d * scale)
            f = float(np.float32((d + 1) - (s + 1) * (1.0 / scale)))
            f = 0.0 if f <= 0 else f - math.floor(f)
        else:
            f = (d + 0.5) * scale - 0.5
            s = math.floor(f)
            f -= s
        if s < 0:
            f, s = 0.0, 0
        if s >= src - 1:
            f, s = 0.0, src - 1
        i0[d], w1[d] = s, np.float32(f)
    return i0, np.minimum(i0 + 1, src - 1), w1


def _resize_linear_np(img: np.ndarray, size_hw: Sequence[int], area_mode: bool) -> np.ndarray:
    H, W = img.shape[:2]
    Ho, Wo = int(size_hw[0]), int(size_hw[1])
    x0, x1, wx = _linear_tab(W, Wo, _cv_scale(W, Wo), area_mode)
    y0, y1, wy = _linear_tab(H, Ho, _cv_scale(H, Ho), area_mode)
    one = np.float32(1.0)
    rows = img[:, x0] * (one - wx)[None, :, None] + img[:, x1] * wx[None, :, None]
    return rows[y0] * (one - wy)[:, None, None] + rows[y1] * wy[:, None, None]


def resize_area(image: np.ndarray, size_hw: Sequence[int]) -> np.ndarray:
    """cv2.resize(image, (W, H), interpolation=cv2.INTER_AREA) for float
    (H, W) or (H, W, C) images; size_hw is (H, W)."""
    img, squeeze = _float_image(image)
    H, W = img.shape[:2]
    Ho, Wo = int(size_hw[0]), int(size_hw[1])
    sx, sy = _cv_scale(W, Wo), _cv_scale(H, Ho)
    if sx < 1 or sy < 1:
        out = _resize_linear_np(img, (Ho, Wo), area_mode=True)
    elif abs(sx - round(sx)) < np.finfo(np.float64).eps and abs(sy - round(sy)) < np.finfo(np.float64).eps:
        # integer factors: OpenCV sums each box in row-major order, four terms
        # at a time, then scales by 1/area in float32
        kx, ky = int(round(sx)), int(round(sy))
        blocks = img[: Ho * ky, : Wo * kx].reshape(Ho, ky, Wo, kx, -1)
        terms = [blocks[:, a, :, b] for a in range(ky) for b in range(kx)]
        total = np.zeros_like(terms[0])
        n4 = len(terms) // 4 * 4
        for k in range(0, n4, 4):
            total = total + (((terms[k] + terms[k + 1]) + terms[k + 2]) + terms[k + 3])
        for k in range(n4, len(terms)):
            total = total + terms[k]
        out = total * img.dtype.type(1.0 / len(terms))
    else:
        # area-overlap weights: a horizontal pass per source row, then the
        # rows summed with their vertical weights, each in OpenCV's tap order
        xi, xw = _area_tab(W, Wo, sx)
        yi, yw = _area_tab(H, Ho, sy)
        xw, yw = xw.astype(img.dtype), yw.astype(img.dtype)
        buf = np.zeros((H, Wo, img.shape[2]), img.dtype)
        for k in range(xi.shape[1]):
            buf = buf + img[:, xi[:, k]] * xw[None, :, k, None]
        out = np.zeros((Ho, Wo, img.shape[2]), img.dtype)
        for k in range(yi.shape[1]):
            out = out + buf[yi[:, k]] * yw[:, k, None, None]
    out = out.astype(img.dtype, copy=False)
    return out[..., 0] if squeeze else out


def resize_linear(image: np.ndarray, size_hw: Sequence[int]) -> np.ndarray:
    """cv2.resize(image, (W, H)) (INTER_LINEAR, half-pixel centres, edge
    clamp) for float (H, W) or (H, W, C) images."""
    img, squeeze = _float_image(image)
    out = _resize_linear_np(img, size_hw, area_mode=False).astype(img.dtype, copy=False)
    return out[..., 0] if squeeze else out


def resize_nearest(image: np.ndarray, size_hw: Sequence[int]) -> np.ndarray:
    """cv2.resize(image, (W, H), interpolation=cv2.INTER_NEAREST): source
    index floor(d * src/dst), any dtype, (H, W) or (H, W, C)."""
    img = np.asarray(image)
    H, W = img.shape[:2]
    Ho, Wo = int(size_hw[0]), int(size_hw[1])
    sx, sy = _cv_scale(W, Wo), _cv_scale(H, Ho)
    xs = np.minimum(np.floor(np.arange(Wo) * sx).astype(np.int64), W - 1)
    ys = np.minimum(np.floor(np.arange(Ho) * sy).astype(np.int64), H - 1)
    return img[ys][:, xs]


def resize_bilinear(x: torch.Tensor, size_hw: Sequence[int], antialias: bool = True
                    ) -> torch.Tensor:
    """jax.image.resize(x, (..., H, W), "bilinear") over the last two dims:
    a triangle kernel at half-pixel centres, widened by the scale when
    downsampling (antialias), weights normalised over the in-range taps.
    The weights are applied as a matmul in full float32 whatever the global
    TF32 setting: the inputs are often pixel coordinates, which TF32's 10-bit
    mantissa would move by ~0.2 px at 400 px."""
    out = x
    with ieee_fp32():
        for axis, n_out in ((-2, int(size_hw[0])), (-1, int(size_hw[1]))):
            n_in = out.shape[axis]
            if n_in == n_out:
                continue
            wmat = _triangle_weights(n_in, n_out, antialias).to(out.device)
            out = torch.movedim(torch.movedim(out, axis, -1) @ wmat, -1, axis)
    return out


def _triangle_weights(n_in: int, n_out: int, antialias: bool) -> torch.Tensor:
    """jax.image's compute_weight_mat for the triangle kernel, (n_in, n_out) float32."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0)) if antialias else np.float32(1.0)
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kscale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - dist)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.as_tensor(np.where(inside[None, :], w, 0).astype(np.float32))


# ---------------------------------------------------------------------------
# morphology
# ---------------------------------------------------------------------------


def dilate(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """cv2.dilate(mask, np.ones((3, 3)), iterations=n) for an (H, W) array:
    a 3x3 max, iterated; pixels outside the image never win."""
    m = np.asarray(mask)
    x = torch.as_tensor(m.astype(np.float32))[None, None]
    for _ in range(int(iterations)):
        x = F.max_pool2d(x, 3, stride=1, padding=1)
    return x[0, 0].numpy().astype(m.dtype)


# ---------------------------------------------------------------------------
# projection matrices
# ---------------------------------------------------------------------------


def _mm3(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """3x3 product, each entry summed left to right (OpenCV's order)."""
    C = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            C[i, j] = A[i, 0] * B[0, j] + A[i, 1] * B[1, j] + A[i, 2] * B[2, j]
    return C


def _givens(s: float, c: float) -> Tuple[float, float]:
    z = 1.0 / math.sqrt(c * c + s * s)
    return s * z, c * z


def _rq_decomp3x3(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's RQDecomp3x3: M = K Q by Givens rotations about x, y and z, K
    upper triangular with K[0,0], K[1,1] > 0 and Q a rotation."""
    s, c = _givens(M[2, 1], M[2, 2])
    Qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]], np.float64)
    R = _mm3(M, Qx)
    R[2, 1] = 0.0
    s, c = _givens(-R[2, 0], R[2, 2])
    Qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float64)
    M2 = _mm3(R, Qy)
    M2[2, 0] = 0.0
    s, c = _givens(M2[1, 0], M2[1, 1])
    Qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float64)
    K = _mm3(M2, Qz)
    K[1, 0] = 0.0
    Q = _mm3(_mm3(Qz.T, Qy.T), Qx.T)
    # a 180-degree turn about z, y or x makes K[0,0] and K[1,1] positive
    flip = None
    if K[0, 0] < 0:
        flip = (-1.0, -1.0, 1.0) if K[1, 1] < 0 else (-1.0, 1.0, -1.0)
    elif K[1, 1] < 0:
        flip = (1.0, -1.0, -1.0)
    if flip is not None:
        d = np.array(flip)
        K, Q = K * d[None, :], d[:, None] * Q
    return K, Q


def decompose_projection_matrix(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2.decomposeProjectionMatrix(P)[:3] for a (3, 4) P: K upper triangular
    with K[0,0], K[1,1] > 0 (K[2,2] takes the sign of det P[:, :3]), R a
    rotation with P[:, :3] = K R, both by OpenCV's Givens sequence (so K
    comes out bit for bit), and t (4, 1) the homogeneous camera centre
    (P t = 0, unit norm; its sign is arbitrary, as OpenCV's: divide by t[3])."""
    P = np.asarray(P, np.float64)[:3]
    K, R = _rq_decomp3x3(P[:, :3])
    _, _, vt = np.linalg.svd(np.vstack([P, np.zeros((1, 4))]))
    return K, R, vt[-1].reshape(4, 1)


# ---------------------------------------------------------------------------
# fundamental matrix, RANSAC
# ---------------------------------------------------------------------------


def _hartley(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 2) float64 -> (T (3, 3), normalised points (N, 2)): centroid to 0,
    mean distance sqrt(2)."""
    c = p.mean(0)
    d = torch.linalg.norm(p - c, dim=-1).mean()
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-12)
    T = torch.zeros((3, 3), dtype=p.dtype, device=p.device)
    T[0, 0] = T[1, 1] = s
    T[0, 2], T[1, 2] = -s * c[0], -s * c[1]
    T[2, 2] = 1.0
    return T, (p - c) * s


def _design(n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """(..., N, 9) rows of x2^T F x1 = 0 for row-major F."""
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    one = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], -1)


def _rank2(Fm: torch.Tensor) -> torch.Tensor:
    U, S, Vh = torch.linalg.svd(Fm)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return U @ torch.diag_embed(S) @ Vh


def _sampson(Fm: torch.Tensor, x1h: torch.Tensor, x2h: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distances (B, N) of (N, 3) homogeneous pixel pairs under
    (B, 3, 3) fundamental matrices."""
    Fx1 = torch.einsum("bij,nj->bni", Fm, x1h)
    Ftx2 = torch.einsum("bji,nj->bni", Fm, x2h)
    e = (x2h[None] * Fx1).sum(-1)
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return e * e / torch.clamp(den, min=1e-30)


def _sample_without_replacement(n: int, k: int, batch: int, generator: torch.Generator
                                ) -> torch.Tensor:
    """(batch, k) distinct indices in [0, n) per row (Floyd's algorithm),
    drawn on the CPU so that a run gives the same samples on any device."""
    out = torch.empty((batch, k), dtype=torch.int64)
    for i, j in enumerate(range(n - k, n)):
        t = torch.randint(0, j + 1, (batch,), generator=generator)
        taken = (out[:, :i] == t[:, None]).any(1)
        out[:, i] = torch.where(taken, torch.full_like(t, j), t)
    return out


def find_fundamental_ransac(pts1, pts2, thresh_px: float = 1.0, confidence: float = 0.999,
                            generator: Optional[torch.Generator] = None,
                            max_iters: int = 1000, device=None
                            ) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Fundamental matrix F (pts2^T F pts1 = 0) by RANSAC over (N, 2) pixel
    pairs, in float64 on `device` (default: pts1's device, else the CPU).

    Hypotheses come from Hartley-normalised 8-point fits of distinct samples,
    drawn on the CPU from `generator` (seed 0 when None) and solved and
    scored in batches on the device; a pair is an inlier when its squared
    Sampson distance is at most thresh_px^2 / 2 (where both epipolar lines
    have the same gradient norm, this is OpenCV's test that each point lies
    within thresh_px of its epipolar line). The iteration count adapts to
    the best inlier share (`confidence` that one all-inlier sample was
    drawn), at most max_iters. The best model is refit by least squares on
    its inliers and kept if it holds at least as many. Returns (F (3, 3)
    float64, inlier mask (N,) bool), or (None, all False) below 8 pairs.
    """
    if device is None:
        device = pts1.device if torch.is_tensor(pts1) else "cpu"
    p1 = torch.as_tensor(pts1, dtype=torch.float64, device=device).reshape(-1, 2)
    p2 = torch.as_tensor(pts2, dtype=torch.float64, device=device).reshape(-1, 2)
    n = p1.shape[0]
    if n < 8:
        return None, np.zeros(n, bool)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    T1, n1 = _hartley(p1)
    T2, n2 = _hartley(p2)
    one = torch.ones((n, 1), dtype=torch.float64, device=device)
    x1h, x2h = torch.cat([p1, one], 1), torch.cat([p2, one], 1)
    thr = float(thresh_px) ** 2 / 2.0
    batch = int(min(256, max(8, 2 ** 23 // n)))

    best_F, best_count, done, needed = None, -1, 0, max_iters
    while done < min(needed, max_iters):
        b = min(batch, max_iters - done)
        idx = _sample_without_replacement(n, 8, b, gen).to(device)
        _, _, Vh = torch.linalg.svd(_design(n1[idx], n2[idx]))
        Fm = T2.t() @ _rank2(Vh[:, -1].reshape(b, 3, 3)) @ T1
        counts = (_sampson(Fm, x1h, x2h) <= thr).sum(1)
        k = int(torch.argmax(counts))
        if int(counts[k]) > best_count:
            best_F, best_count = Fm[k], int(counts[k])
        done += b
        share = best_count / n
        if share >= 1.0:
            needed = 0
        elif share > 0.0:
            needed = math.ceil(math.log(1.0 - confidence) / math.log(1.0 - share ** 8))
    mask = _sampson(best_F[None], x1h, x2h)[0] <= thr
    if int(mask.sum()) >= 8:
        A = _design(n1[mask], n2[mask])
        _, vecs = torch.linalg.eigh(A.t() @ A)
        F_fit = T2.t() @ _rank2(vecs[:, 0].reshape(3, 3)) @ T1
        mask_fit = _sampson(F_fit[None], x1h, x2h)[0] <= thr
        if int(mask_fit.sum()) >= int(mask.sum()):
            best_F, mask = F_fit, mask_fit
    return best_F.cpu().numpy(), mask.cpu().numpy()
