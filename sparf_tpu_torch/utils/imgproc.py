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
  - `gaussian_blur` (cv2.GaussianBlur, BORDER_REFLECT_101, ksize (0, 0)
    from sigma), `warp_affine_reflect` (cv2.warpAffine, bilinear,
    BORDER_REFLECT) and `fill_poly` (cv2.fillPoly, LINE_8, pixel for pixel),
    the LPIPS trainer's patch operations;
  - `decompose_projection_matrix` (cv2.decomposeProjectionMatrix's K, R, t);
  - `find_fundamental_ransac`: epipolar RANSAC in place of
    cv2.findFundamentalMat(FM_RANSAC). RANSAC draws random samples, so its
    masks agree with OpenCV's by rate, not bit for bit;
  - the two-view and PnP solvers of the matchers' geometry stage and of
    colmap_init/sfm.py: `triangulate_points` (cv2.triangulatePoints),
    `find_essential_ransac` (cv2.findEssentialMat with RANSAC, a 5-point
    minimal solver), `recover_pose` (cv2.recoverPose) and
    `solve_pnp_ransac` (cv2.solvePnPRansac with SOLVEPNP_ITERATIVE);
  - `read_png`: PNG decoding with zlib and numpy (imageio.imread's arrays);
    `encode_png` / `write_png` / `write_apng`: 8-bit RGB PNG and animated
    PNG (the port's video format) encoding, `read_apng` their frames back;
    `decode_jpeg`: baseline JPEG in libjpeg's integer arithmetic (PIL's and
    OpenCV's arrays, bit for bit); `read_image`: either, by content.
"""
from __future__ import annotations

import math
import struct
import zlib
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
            wmat = _triangle_weights(n_in, n_out, antialias).to(out.device, out.dtype)
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
# filtering, warping and polygon filling (host numpy, like OpenCV)
# ---------------------------------------------------------------------------


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F) for sigma > 0: the
    normalised exp(-x^2 / (2 sigma^2)) at x = i - (ksize - 1) / 2, computed in
    double and stored as float32."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * float(sigma) ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: np.ndarray, ksize: Sequence[int], sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(image, ksize, sigma) for a float32 (H, W) or (H, W, C)
    image with sigma > 0 and the default border (BORDER_REFLECT_101). A ksize
    of (0, 0) takes OpenCV's float size, round(sigma * 8 + 1) | 1. The
    separable passes (rows, then columns) accumulate in float64 and store
    float32, as OpenCV stores its intermediate rows."""
    img, squeeze = _float_image(image)
    kx, ky = int(ksize[0]), int(ksize[1])
    if kx <= 0:
        kx = int(np.rint(sigma * 8 + 1)) | 1
    if ky <= 0:
        ky = int(np.rint(sigma * 8 + 1)) | 1
    out = img.astype(np.float32)
    for axis, k in ((1, kx), (0, ky)):
        w = gaussian_kernel(k, sigma).astype(np.float64)
        r = k // 2
        pad = [(0, 0)] * out.ndim
        pad[axis] = (r, r)
        padded = np.pad(out, pad, mode="reflect").astype(np.float64)
        n = out.shape[axis]
        acc = np.zeros(out.shape, np.float64)
        for i in range(k):
            acc += w[i] * np.take(padded, np.arange(i, i + n), axis=axis)
        out = acc.astype(np.float32)
    return out[..., 0] if squeeze else out


def _reflect_index(i: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's BORDER_REFLECT ("fedcba|abcdefgh|hgfedcb") index into [0, n)."""
    period = 2 * n
    i = np.mod(i, period)
    return np.where(i >= n, period - 1 - i, i)


def warp_affine_reflect(image: np.ndarray, M: np.ndarray, dsize: Sequence[int]) -> np.ndarray:
    """cv2.warpAffine(image, M, dsize, borderMode=cv2.BORDER_REFLECT) with
    bilinear interpolation for a float32 (H, W) or (H, W, C) image; dsize is
    (W, H). M maps source to destination, so each destination pixel samples
    the source at M^-1 (x, y) in float32 coordinates (OpenCV 5 does not round
    float32 warps to 1/32 px), weighted in float64."""
    img, squeeze = _float_image(image)
    H, W = img.shape[:2]
    Wo, Ho = int(dsize[0]), int(dsize[1])
    A = np.asarray(M, np.float64)
    inv = np.linalg.inv(np.vstack([A, [0.0, 0.0, 1.0]]))[:2]
    yy, xx = np.meshgrid(np.arange(Ho, dtype=np.float64), np.arange(Wo, dtype=np.float64),
                         indexing="ij")
    # the source coordinates are rounded to float32, as OpenCV holds them
    sx = (inv[0, 0] * xx + inv[0, 1] * yy + inv[0, 2]).astype(np.float32).astype(np.float64)
    sy = (inv[1, 0] * xx + inv[1, 1] * yy + inv[1, 2]).astype(np.float32).astype(np.float64)
    x0, y0 = np.floor(sx), np.floor(sy)
    wx, wy = (sx - x0)[..., None], (sy - y0)[..., None]
    xi = [_reflect_index(x0.astype(np.int64) + d, W) for d in (0, 1)]
    yi = [_reflect_index(y0.astype(np.int64) + d, H) for d in (0, 1)]
    src = img.astype(np.float64)
    top = src[yi[0], xi[0]] * (1 - wx) + src[yi[0], xi[1]] * wx
    bottom = src[yi[1], xi[0]] * (1 - wx) + src[yi[1], xi[1]] * wx
    out = (top * (1 - wy) + bottom * wy).astype(np.float32)
    return out[..., 0] if squeeze else out


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _line8(img: np.ndarray, p0, p1, color) -> None:
    """OpenCV's Line() with 8-connectivity (its LineIterator, left to right)
    between integer points inside the image."""
    (x0, y0), (x1, y1) = p0, p1
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        img[y, x] = color
        if err < 0:            # a diagonal step
            err += 2 * dx - 2 * dy
            x, y = x + sx, y + sy
        else:                  # a step along the major axis
            err -= 2 * dy
            if vert:
                y += sy
            else:
                x += sx


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_poly(img: np.ndarray, polygons, color) -> np.ndarray:
    """cv2.fillPoly(img, polygons, color) in place for int32 vertices inside
    the image (lineType LINE_8, shift 0), convex or not: OpenCV draws each
    edge as an 8-connected line, then fills its edge table scanline by
    scanline (even-odd, x in 16.16 fixed point, each span from the ceiling
    of its left x to the floor of its right x). Returns img."""
    color = np.asarray(color, img.dtype)
    H, W = img.shape[:2]
    edges = []
    for poly in polygons:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        px, py = pts[-1]
        for x, y in pts:
            _line8(img, (px, py), (x, y), color)
            if py != y:
                (ax, ay), (bx, by) = ((px, py), (x, y)) if py < y else ((x, y), (px, py))
                edges.append([ay, by, ax << _XY_SHIFT,
                              _trunc_div((bx - ax) << _XY_SHIFT, by - ay)])
            px, py = x, y
    if len(edges) < 2:
        return img
    edges.sort(key=lambda e: (e[0], e[2], e[3]))   # y0, x, dx
    active, i = [], 0
    y = edges[0][0]
    y_max = min(max(e[1] for e in edges), H)
    while y < y_max:
        active = [e for e in active if e[1] != y]
        while i < len(edges) and edges[i][0] == y:
            active.append(edges[i])
            i += 1
        active.sort(key=lambda e: e[2])
        for a, b in zip(active[0::2], active[1::2]):
            x1 = max((a[2] + _XY_ONE - 1) >> _XY_SHIFT, 0)
            x2 = min(b[2] >> _XY_SHIFT, W - 1)
            if x1 < W and x2 >= 0 and 0 <= y:
                img[y, x1: x2 + 1] = color
            a[2] += a[3]
            b[2] += b[3]
        y += 1
    return img


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


def _ransac_update_iters(confidence: float, outlier_share: float, model_points: int,
                         max_iters: int) -> int:
    """OpenCV's RANSACUpdateNumIters: iterations for `confidence` that one
    all-inlier sample was drawn at this outlier share, at most max_iters."""
    p = min(max(confidence, 0.0), 1.0)
    ep = min(max(outlier_share, 0.0), 1.0)
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num, denom = math.log(num), math.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(round(num / denom))


def _as_points(pts, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(pts), dtype=torch.float64, device=device).reshape(-1, 2)


def _normalize_by_K(p: torch.Tensor, K) -> torch.Tensor:
    """Pixel points (N, 2) -> normalised camera coordinates, as OpenCV's
    findEssentialMat and recoverPose do with their camera matrix."""
    if K is None:
        return p
    K = np.asarray(K, np.float64)
    c = torch.tensor([K[0, 2], K[1, 2]], dtype=p.dtype, device=p.device)
    f = torch.tensor([K[0, 0], K[1, 1]], dtype=p.dtype, device=p.device)
    return (p - c) / f


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------


def _triangulate(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
                 ) -> torch.Tensor:
    """Linear DLT per point: P1, P2 (..., 3, 4), x1, x2 (..., N, 2) ->
    homogeneous points (..., N, 4), the right singular vector of the
    smallest singular value of each 4x4 system (cvTriangulatePoints)."""
    rows = [x1[..., 0:1] * P1[..., None, 2, :] - P1[..., None, 0, :],
            x1[..., 1:2] * P1[..., None, 2, :] - P1[..., None, 1, :],
            x2[..., 0:1] * P2[..., None, 2, :] - P2[..., None, 0, :],
            x2[..., 1:2] * P2[..., None, 2, :] - P2[..., None, 1, :]]
    _, _, Vh = torch.linalg.svd(torch.stack(rows, -2))
    return Vh[..., -1, :]


def triangulate_points(P1, P2, x1, x2, device="cpu") -> np.ndarray:
    """cv2.triangulatePoints(P1, P2, x1, x2): (3, 4) projection matrices and
    (2, N) image points -> (4, N) homogeneous points (float64; the sign of
    each column is arbitrary, as OpenCV's)."""
    P = [torch.as_tensor(np.asarray(m), dtype=torch.float64, device=device) for m in (P1, P2)]
    x = [torch.as_tensor(np.asarray(v), dtype=torch.float64, device=device).reshape(2, -1).t()
         for v in (x1, x2)]
    return _triangulate(P[0], P[1], x[0], x[1]).t().cpu().numpy()


# ---------------------------------------------------------------------------
# essential matrix: 5-point RANSAC, and pose recovery
# ---------------------------------------------------------------------------

# Monomials in the unknowns (x, y, z) of E = x X + y Y + z Z + W: the ten
# cubics first (eliminated), then the ten of degree <= 2, the basis of the
# quotient ring (Stewenius, Engels and Nister's action-matrix solver).
_LIN = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0))
_MONO = ((3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2), (0, 3, 0),
         (0, 2, 1), (0, 1, 2), (0, 0, 3),
         (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
         (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0))
_QUAD = _MONO[10:]


def _product_table(a, b) -> np.ndarray:
    """(len a, len b, 20): coefficient a_i b_j lands on monomial a_i b_j."""
    index = {e: i for i, e in enumerate(_MONO)}
    T = np.zeros((len(a), len(b), len(_MONO)))
    for i, ea in enumerate(a):
        for j, eb in enumerate(b):
            T[i, j, index[tuple(u + v for u, v in zip(ea, eb))]] = 1.0
    return T


_T_LIN_LIN = _product_table(_LIN, _LIN)[:, :, 10:]   # linear x linear -> degree <= 2
_T_QUAD_LIN = _product_table(_QUAD, _LIN)            # degree <= 2 x linear -> degree <= 3
# row k of the action matrix of x: the monomial x * basis_k in _MONO
_X_TIMES_BASIS = [_MONO.index((e[0] + 1, e[1], e[2])) for e in _QUAD]


def _five_point(n1: torch.Tensor, n2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Essential matrices from (B, 5, 2) normalised point pairs (n2^T E n1 =
    0): (B, 10, 3, 3) candidates of unit norm and (B, 10) validity.

    E lies in the 4-dimensional null space of the 5 epipolar rows; det E = 0
    and 2 E E^T E - tr(E E^T) E = 0 give ten cubics in (x, y, z), reduced by
    Gauss-Jordan to the action matrix of x on the ten basis monomials
    (10x20 -> 10x10), whose real eigenvectors are the solutions. They are
    ordered by x, so the order does not depend on the eigensolver."""
    B = n1.shape[0]
    dt, dev = n1.dtype, n1.device
    _, _, Vh = torch.linalg.svd(_design(n1, n2))
    E = Vh[:, 5:9].permute(0, 2, 1).reshape(B, 3, 3, 4)   # entries as [x, y, z, 1] coefficients
    T11 = torch.as_tensor(_T_LIN_LIN, dtype=dt, device=dev)
    T21 = torch.as_tensor(_T_QUAD_LIN, dtype=dt, device=dev)
    EEt = torch.einsum("bikp,bjkq,pqr->bijr", E, E, T11)
    EEtE = torch.einsum("bikp,bkjq,pqr->bijr", EEt, E, T21)
    trace = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    trE = torch.einsum("bp,bijq,pqr->bijr", trace, E, T21)

    def minor(i0, j0, i1, j1):
        return (torch.einsum("bp,bq,pqr->br", E[:, i0, j0], E[:, i1, j1], T11)
                - torch.einsum("bp,bq,pqr->br", E[:, i0, j1], E[:, i1, j0], T11))

    det = (torch.einsum("bp,bq,pqr->br", minor(1, 1, 2, 2), E[:, 0, 0], T21)
           - torch.einsum("bp,bq,pqr->br", minor(1, 0, 2, 2), E[:, 0, 1], T21)
           + torch.einsum("bp,bq,pqr->br", minor(1, 0, 2, 1), E[:, 0, 2], T21))
    C = torch.cat([det[:, None], (2 * EEtE - trE).reshape(B, 9, 20)], 1)
    G, info = torch.linalg.solve_ex(C[:, :, :10], C[:, :, 10:])
    eye = torch.eye(10, dtype=dt, device=dev).expand(B, 10, 10)
    M = torch.cat([-G, eye], 1)[:, _X_TIMES_BASIS]
    ok = (info == 0) & torch.isfinite(M).all(-1).all(-1)
    M = torch.where(ok[:, None, None], M, torch.zeros_like(M))
    # the batch of 10x10 eigenproblems goes to the host (LAPACK's geev) from
    # any device: torch's CUDA eig is MAGMA's hybrid routine, also on the host
    lam, V = (x.to(dev) for x in torch.linalg.eig(M.cpu()))
    w = V[:, 9, :]
    valid = ok[:, None] & (lam.imag.abs() <= 1e-9 * (1.0 + lam.real.abs())) & (w.abs() > 1e-12)
    w = torch.where(valid, w, torch.ones_like(w))
    xyz = torch.stack([(V[:, 6, :] / w).real, (V[:, 7, :] / w).real, (V[:, 8, :] / w).real,
                       torch.ones_like(lam.real)], -1)                   # (B, 10, 4)
    Es = torch.einsum("bsc,bijc->bsij", xyz, E)
    Es = Es / torch.linalg.norm(Es, dim=(-2, -1), keepdim=True).clamp(min=1e-300)
    valid &= torch.isfinite(Es).all(-1).all(-1)
    key = torch.where(valid, lam.real, torch.full_like(lam.real, float("inf")))
    order = torch.argsort(key, dim=1, stable=True)
    Es = torch.gather(Es, 1, order[:, :, None, None].expand(B, 10, 3, 3))
    return Es, torch.gather(valid, 1, order)


def find_essential_ransac(pts1, pts2, K=None, thresh: float = 1.0, prob: float = 0.999,
                          generator: Optional[torch.Generator] = None, max_iters: int = 1000,
                          device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """cv2.findEssentialMat(pts1, pts2, K, method=RANSAC, prob, threshold):
    E with pts2^T E pts1 = 0 in normalised coordinates, and the inlier mask.

    Points are normalised by K (identity when None) and the threshold by
    (fx + fy) / 2, as OpenCV does. Each hypothesis set comes from the 5-point
    solver on 5 distinct pairs drawn on the CPU from `generator` (seed 0 when
    None) and solved in batches in float64 on `device`; a pair is an inlier
    when its squared Sampson distance is at most thresh^2 (OpenCV's
    EMEstimatorCallback). The best model is the first with the most inliers;
    the iteration count adapts to its inlier share as OpenCV's does, at most
    max_iters. Then up to five local-optimisation rounds refit the model to
    its inliers (Levenberg-Marquardt on Sampson distances), each kept while
    it holds at least as many: OpenCV returns the best minimal model, 0.2-0.6
    deg off at 0.5 px noise where the refit is 0.02-0.03 deg off
    (tests/test_torch_sfm.py). Raises ValueError below 5 pairs or when no
    sample gives a model."""
    p1 = _as_points(pts1, device)
    p2 = _as_points(pts2, device)
    n = p1.shape[0]
    if n < 5 or p2.shape[0] != n:
        raise ValueError(f"find_essential_ransac needs >= 5 point pairs, got {n}")
    n1, n2 = _normalize_by_K(p1, K), _normalize_by_K(p2, K)
    if K is not None:
        thresh = float(thresh) / ((float(K[0][0]) + float(K[1][1])) / 2.0)
    thr = float(thresh) ** 2
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    one = torch.ones((n, 1), dtype=torch.float64, device=device)
    x1h, x2h = torch.cat([n1, one], 1), torch.cat([n2, one], 1)
    batch = int(max(1, min(64, 2 ** 22 // (10 * n))))

    best_E, best_count, done, needed = None, 4, 0, max_iters
    while done < needed:
        b = min(batch, needed - done)
        idx = _sample_without_replacement(n, 5, b, gen).to(device)
        Es, valid = _five_point(n1[idx], n2[idx])
        counts = (_sampson(Es.reshape(-1, 3, 3), x1h, x2h) <= thr).sum(1)
        counts = torch.where(valid.reshape(-1), counts, torch.full_like(counts, -1))
        k = int(torch.argmax(counts))
        if int(counts[k]) > best_count:
            best_E, best_count = Es.reshape(-1, 3, 3)[k], int(counts[k])
            needed = min(needed, _ransac_update_iters(prob, (n - best_count) / n, 5, needed))
        done += b
    if best_E is None:
        raise ValueError("find_essential_ransac: no sample gave an essential matrix with "
                         ">= 5 inliers")
    mask = _sampson(best_E[None], x1h, x2h)[0] <= thr
    for _ in range(5):
        E_fit = _refine_essential(best_E, n1[mask], n2[mask])
        mask_fit = _sampson(E_fit[None], x1h, x2h)[0] <= thr
        if int(mask_fit.sum()) < int(mask.sum()):
            break
        grew = int(mask_fit.sum()) > int(mask.sum())
        best_E, mask = E_fit, mask_fit
        if not grew:
            break
    return best_E.cpu().numpy(), mask.cpu().numpy()


def _recover_pose(E: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                  mask: Optional[torch.Tensor], distance_thresh: float = 50.0):
    """recover_pose on normalised (N, 2) tensors: (counts of the 4
    candidates, index picked, R, t (3, 1), mask of the pick)."""
    dev, n = p1.device, p1.shape[0]
    U, _, Vt = torch.linalg.svd(E)
    if torch.linalg.det(U) < 0:
        U = -U
    if torch.linalg.det(Vt) < 0:
        Vt = -Vt
    W = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64,
                     device=dev)
    R1, R2, t = U @ W @ Vt, U @ W.t() @ Vt, U[:, 2:3]
    cands = [(R1, t), (R2, t), (R1, -t), (R2, -t)]
    P0 = torch.eye(3, 4, dtype=torch.float64, device=dev)
    Ps = torch.stack([torch.cat([R, tt], 1) for R, tt in cands])           # (4, 3, 4)
    Q = _triangulate(P0.expand(4, 3, 4), Ps, p1.expand(4, n, 2), p2.expand(4, n, 2))
    good = Q[..., 2] * Q[..., 3] > 0
    Xn = Q[..., :3] / Q[..., 3:4]
    good &= Xn[..., 2] < distance_thresh
    z2 = torch.einsum("cj,cnj->cn", Ps[:, 2, :3], Xn) + Ps[:, 2, 3:4]
    good &= (z2 > 0) & (z2 < distance_thresh)
    if mask is not None:
        good &= mask[None]
    counts = [int(c) for c in good.sum(1)]
    pick = 3
    for c in range(3):
        if all(counts[c] > counts[o] for o in range(4) if o != c):
            pick = c
            break
    R, tt = cands[pick]
    return counts, pick, R, tt, good[pick]


def _refine_essential(E: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor,
                      n_iters: int = 10) -> torch.Tensor:
    """Levenberg-Marquardt on the signed Sampson distances of normalised
    inlier pairs over (R, t) of E's cheirality-checked decomposition:
    E = [t]x exp([w]x) R0, t unit. Returns E of unit norm."""
    _, _, R0, t0, _ = _recover_pose(E, n1, n2, None)
    t0 = t0[:, 0]
    one = torch.ones((n1.shape[0], 1), dtype=n1.dtype, device=n1.device)
    x1h, x2h = torch.cat([n1, one], 1), torch.cat([n2, one], 1)

    def essential(p):
        tv = t0 + p[3:]
        return _skew(tv / torch.linalg.norm(tv)) @ torch.linalg.matrix_exp(_skew(p[:3])) @ R0

    def resid(p):
        Em = essential(p)
        Ex1, Etx2 = x1h @ Em.t(), x2h @ Em
        den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
        return (x2h * Ex1).sum(1) / torch.sqrt(den.clamp(min=1e-300))

    p = torch.zeros(6, dtype=n1.dtype, device=n1.device)
    r = resid(p)
    cost, lam = float(r @ r), 1e-3
    for _ in range(n_iters):
        J = torch.autograd.functional.jacobian(resid, p, vectorize=True,
                                               strategy="forward-mode")
        H, g = J.t() @ J, J.t() @ r
        improved = False
        for _ in range(8):
            step, info = torch.linalg.solve_ex(H + lam * torch.diag(torch.diagonal(H) + 1e-18),
                                               -g)
            if int(info) != 0:  # singular on degenerate inliers: damp harder
                lam *= 10.0
                continue
            r_new = resid(p + step)
            cost_new = float(r_new @ r_new)
            if cost_new < cost:
                improved = cost - cost_new > 1e-12 * cost
                p, r, cost, lam = p + step, r_new, cost_new, max(lam * 0.1, 1e-12)
                break
            lam *= 10.0
        if not improved:
            break
    Em = essential(p)
    return Em / torch.linalg.norm(Em)


def recover_pose(E, pts1, pts2, K=None, mask=None, distance_thresh: float = 50.0,
                 device="cpu") -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """cv2.recoverPose(E, pts1, pts2, K, mask=mask): the (R, t) of the four
    decompositions of E (cv2.decomposeEssentialMat: R1 = U W V^T,
    R2 = U W^T V^T, t = +-U[:, 2]) that puts the most masked pairs in front
    of both cameras, closer than distance_thresh (normalised units), by
    triangulating every pair. Ties go to the later candidate, as OpenCV's
    chain of strict comparisons does. Returns (count, R (3, 3), t (3, 1),
    mask (N,) bool) in float64."""
    p1 = _normalize_by_K(_as_points(pts1, device), K)
    p2 = _normalize_by_K(_as_points(pts2, device), K)
    m = (None if mask is None
         else torch.as_tensor(np.asarray(mask).reshape(-1) != 0, device=device))
    E_t = torch.as_tensor(np.asarray(E, np.float64)[:3, :3], device=device)
    counts, _, R, t, good = _recover_pose(E_t, p1, p2, m, distance_thresh)
    return max(counts), R.cpu().numpy(), t.cpu().numpy(), good.cpu().numpy()


# ---------------------------------------------------------------------------
# PnP: RANSAC over 6-point DLT + Gauss-Newton samples, a Levenberg-Marquardt polish
# ---------------------------------------------------------------------------


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _pnp_dlt(X: torch.Tensor, xn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Calibrated DLT of (B, 6, 3) object points and (B, 6, 2) normalised
    image points: the 3x4 P of the 12x12 system's null vector (points
    centred and scaled first), its left 3x3 block projected onto SO(3).
    Returns R (B, 3, 3), t (B, 3)."""
    B, m, _ = X.shape
    c = X.mean(1, keepdim=True)
    s = torch.linalg.norm(X - c, dim=-1).mean(1).clamp(min=1e-12)           # (B,)
    Xh = torch.cat([(X - c) / s[:, None, None], torch.ones_like(X[..., :1])], -1)
    zero = torch.zeros_like(Xh)
    A = torch.cat([torch.cat([Xh, zero, -xn[..., 0:1] * Xh], -1),
                   torch.cat([zero, Xh, -xn[..., 1:2] * Xh], -1)], 1)         # (B, 12, 12)
    _, _, Vh = torch.linalg.svd(A)
    Pn = Vh[:, -1].reshape(B, 3, 4)
    # undo the normalisation: P = Pn [I/s, -c/s; 0, 1]
    M = Pn[:, :, :3] / s[:, None, None]
    p4 = Pn[:, :, 3] - torch.einsum("bij,bj->bi", M, c[:, 0])
    sign = torch.sign(torch.linalg.det(M))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    M, p4 = M * sign[:, None, None], p4 * sign[:, None]
    U, S, Vt = torch.linalg.svd(M)
    return U @ Vt, p4 / S.mean(-1, keepdim=True).clamp(min=1e-300)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[v]x of (..., 3) vectors -> (..., 3, 3)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _pnp_gauss_newton(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor, xn: torch.Tensor,
                      n_iters: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped Gauss-Newton of each (B, 3, 3), (B, 3) pose on its own (B, m)
    sample in normalised coordinates (R <- exp([w]x) R, t <- t + v): the
    DLT's projection onto SO(3) discards what its 11 degrees of freedom
    fitted to the noise; the calibrated 6-dof fit averages it."""
    eye = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(n_iters):
        Xr = torch.einsum("bij,bnj->bni", R, X)
        Xc = Xr + t[:, None]
        z = torch.where(Xc[..., 2].abs() < 1e-12, torch.full_like(Xc[..., 2], 1e-12), Xc[..., 2])
        r = (Xc[..., :2] / z[..., None] - xn).reshape(R.shape[0], -1)            # (B, 2m)
        zero = torch.zeros_like(z)
        dpi = torch.stack([torch.stack([1 / z, zero, -Xc[..., 0] / z ** 2], -1),
                           torch.stack([zero, 1 / z, -Xc[..., 1] / z ** 2], -1)], -2)  # (B,m,2,3)
        Jw = -dpi @ _skew(Xr)
        J = torch.cat([Jw, dpi], -1).reshape(R.shape[0], -1, 6)                  # (B, 2m, 6)
        H = J.transpose(1, 2) @ J
        H = H + (1e-9 * torch.diagonal(H, dim1=1, dim2=2).sum(-1))[:, None, None] * eye
        step, info = torch.linalg.solve_ex(H, -(J.transpose(1, 2) @ r[..., None])[..., 0])
        step = torch.where((info == 0)[:, None] & torch.isfinite(step), step,
                           torch.zeros_like(step))
        R = torch.linalg.matrix_exp(_skew(step[:, :3])) @ R
        t = t + step[:, 3:]
    return R, t


def _reproj_sq(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor, uv: torch.Tensor,
               K: torch.Tensor) -> torch.Tensor:
    """Squared pixel reprojection errors (B, N) of (B, 3, 3), (B, 3) poses;
    inf for points not in front of the camera (a mirrored pose can project
    points behind it onto their pixels)."""
    Xc = torch.einsum("bij,nj->bni", R, X) + t[:, None]
    p = torch.einsum("ij,bnj->bni", K, Xc)
    z = p[..., 2]
    front = Xc[..., 2] > 0
    z = torch.where(front, z, torch.ones_like(z))
    err = ((p[..., :2] / z[..., None] - uv) ** 2).sum(-1)
    return torch.where(front, err, torch.full_like(err, float("inf")))


def _pnp_lm(X: torch.Tensor, uv: torch.Tensor, K: torch.Tensor, R: np.ndarray, t: np.ndarray,
            n_iters: int = 20) -> Tuple[np.ndarray, np.ndarray]:
    """Levenberg-Marquardt on the pixel reprojection error over (R, t): the
    perturbation R <- exp(w) R, t <- t + v; the 6x6 step is solved on the
    host, the per-point Jacobians on X's device."""
    dev = X.device

    def cost_of(R_, t_):
        Rt = torch.as_tensor(R_, device=dev)[None]
        return float(_reproj_sq(Rt, torch.as_tensor(t_, device=dev)[None], X, uv, K).sum())

    lam, cost = 1e-3, cost_of(R, t)
    for _ in range(n_iters):
        Rt, tt = torch.as_tensor(R, device=dev), torch.as_tensor(t, device=dev)
        Xr = X @ Rt.t()
        Xc = Xr + tt
        p = Xc @ K.t()
        z = p[:, 2]
        uvp = p[:, :2] / z[:, None]
        A = (K[:2][None] - uvp[:, :, None] * K[2][None, None]) / z[:, None, None]  # (N, 2, 3)
        skew = torch.zeros((X.shape[0], 3, 3), dtype=X.dtype, device=dev)
        skew[:, 0, 1], skew[:, 0, 2] = -Xr[:, 2], Xr[:, 1]
        skew[:, 1, 0], skew[:, 1, 2] = Xr[:, 2], -Xr[:, 0]
        skew[:, 2, 0], skew[:, 2, 1] = -Xr[:, 1], Xr[:, 0]
        J = torch.cat([-(A @ skew), A], -1)                                      # (N, 2, 6)
        r = uvp - uv
        H = torch.einsum("nki,nkj->ij", J, J).cpu().numpy()
        g = torch.einsum("nki,nk->i", J, r).cpu().numpy()
        improved = False
        for _ in range(10):
            try:
                step = np.linalg.solve(H + lam * np.diag(np.diag(H) + 1e-12), -g)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            R_new, t_new = _so3_exp(step[:3]) @ R, t + step[3:]
            cost_new = cost_of(R_new, t_new)
            if cost_new < cost:
                improved = cost - cost_new > 1e-12 * max(cost, 1e-12)
                R, t, cost, lam = R_new, t_new, cost_new, max(lam * 0.1, 1e-12)
                break
            lam *= 10.0
        if not improved:
            break
    return R, t


def solve_pnp_ransac(obj, img, K, reproj_err: float = 8.0, iters: int = 100,
                     confidence: float = 0.99, generator: Optional[torch.Generator] = None,
                     device="cpu"):
    """cv2.solvePnPRansac(obj, img, K, None, reprojectionError, iterationsCount,
    flags=SOLVEPNP_ITERATIVE), without distortion.

    Minimal samples are solved by a 6-point calibrated DLT, refined by five
    Gauss-Newton steps on the sample (not EPnP, which OpenCV uses for this
    flag: a bare 6-point DLT lost half the inliers to OpenCV on a 60x80
    view at 0.5 px noise, the refined one matches it). Samples are drawn on the CPU from `generator` (seed 0 when
    None), solved and scored in float64 batches on `device`; a point is an
    inlier within reproj_err px (OpenCV's squared-error test). The best
    model is the first with the most inliers, and the iteration count adapts
    to `confidence` as OpenCV's RANSAC does, at most `iters`. The pose is
    then polished by Levenberg-Marquardt over its inliers, and the inliers
    of the polished pose are returned. Returns (ok, rvec (3, 1), tvec (3, 1),
    inlier indices (M, 1) int32); ok is False with Nones when no model has
    6 inliers. Raises ValueError below 6 points."""
    from scipy.spatial.transform import Rotation

    X = torch.as_tensor(np.asarray(obj), dtype=torch.float64, device=device).reshape(-1, 3)
    uv = _as_points(img, device)
    n = X.shape[0]
    if n < 6 or uv.shape[0] != n:
        raise ValueError(f"solve_pnp_ransac needs >= 6 point pairs, got {n}")
    Kt = torch.as_tensor(np.asarray(K, np.float64), device=device)
    xn = _normalize_by_K(uv, np.asarray(K, np.float64))
    thr = float(reproj_err) ** 2
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    batch = int(max(1, min(64, 2 ** 22 // n)))

    best, best_count, done, needed = None, 5, 0, int(iters)
    while done < needed:
        b = min(batch, needed - done)
        idx = _sample_without_replacement(n, 6, b, gen).to(device)
        R, t = _pnp_gauss_newton(*_pnp_dlt(X[idx], xn[idx]), X[idx], xn[idx])
        err = _reproj_sq(R, t, X, uv, Kt)
        counts = torch.where(torch.isfinite(err), err <= thr, torch.zeros_like(err, dtype=torch.bool)
                             ).sum(1)
        k = int(torch.argmax(counts))
        if int(counts[k]) > best_count:
            best, best_count = (R[k], t[k]), int(counts[k])
            needed = min(needed, _ransac_update_iters(confidence, (n - best_count) / n, 6,
                                                      needed))
        done += b
    if best is None:
        return False, None, None, None
    mask = _reproj_sq(best[0][None], best[1][None], X, uv, Kt)[0] <= thr
    R, t = _pnp_lm(X[mask], uv[mask], Kt, best[0].cpu().numpy(), best[1].cpu().numpy())
    # the inliers of the polished pose: a minimal model's mask moves with its
    # sample, the polished one's does not (OpenCV's agrees with it)
    mask = _reproj_sq(torch.as_tensor(R, device=device)[None],
                      torch.as_tensor(t, device=device)[None], X, uv, Kt)[0] <= thr
    rvec = Rotation.from_matrix(R).as_rotvec()
    inliers = np.flatnonzero(mask.cpu().numpy()).astype(np.int32)[:, None]
    return True, rvec[:, None], np.asarray(t, np.float64)[:, None], inliers


# ---------------------------------------------------------------------------
# PNG decoding
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> samples per pixel


def _unfilter_average(f: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Average: out[i] = f[i] + (out[i - bpp] + prev[i]) // 2, a recurrence
    along the row (Python integers over the row's bytes)."""
    fl, b = f.tolist(), prev.tolist()
    out = [0] * len(fl)
    for i in range(min(bpp, len(fl))):
        out[i] = (fl[i] + (b[i] >> 1)) & 255
    for i in range(bpp, len(fl)):
        out[i] = (fl[i] + ((out[i - bpp] + b[i]) >> 1)) & 255
    return np.asarray(out, np.uint8)


def _unfilter_paeth(f: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Paeth: out[i] = f[i] + the one of (left, up, up-left) nearest to
    left + up - up-left, a recurrence along the row. The first pixel's
    predictor is `up`."""
    fl, b = f.tolist(), prev.tolist()
    out = [0] * len(fl)
    for i in range(min(bpp, len(fl))):
        out[i] = (fl[i] + b[i]) & 255
    for i in range(bpp, len(fl)):
        a, bb, c = out[i - bpp], b[i], b[i - bpp]
        p = a + bb - c
        pa, pb, pc = abs(p - a), abs(p - bb), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (bb if pb <= pc else c)
        out[i] = (fl[i] + pred) & 255
    return np.asarray(out, np.uint8)


def _unfilter(raw: np.ndarray, H: int, stride: int, bpp: int, name: str) -> np.ndarray:
    """Undo the row filters of H rows of `stride` bytes (each row led by its
    filter byte): (H, stride) uint8."""
    raw = raw.reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(H):
        ftype, line = int(raw[r, 0]), raw[r, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum along the row, per byte of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:
            cur = _unfilter_average(line, prev, bpp)
        elif ftype == 4:
            cur = _unfilter_paeth(line, prev, bpp)
        else:
            raise ValueError(f"{name}: PNG row filter {ftype} is not defined")
        out[r] = cur
        prev = cur
    return out


# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows -> (rows, width, channels) samples (uint8, or uint16 at
    16 bits; 1/2/4-bit samples unpacked, most significant first)."""
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(len(rows), width, channels)
    if depth == 8:
        return rows.reshape(len(rows), width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(len(rows), -1, depth)
    vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
    return vals[:, :width, None]


def read_png(path) -> np.ndarray:
    """Decode a PNG file as imageio.imread does: (H, W) for gray, (H, W, 2)
    gray + alpha, (H, W, 3) RGB, (H, W, 4) RGBA, uint8 or uint16 (8 or 16 bits
    per sample); a palette image (1, 2, 4 or 8 bits) as RGB, or RGBA when it
    has a tRNS chunk. Any of the five row filters, non-interlaced or Adam7.
    Anything else (a JPEG, gray below 8 bits) raises ValueError naming it."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIGNATURE:
        kind = "a JPEG" if data[:3] == b"\xff\xd8\xff" else "not a PNG"
        raise ValueError(f"{path}: {kind}; read_png decodes PNG only")
    pos, header, idat, palette, trns = 8, None, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        kind, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, color, _, _, interlace = header
    if color == 3:
        if depth not in (1, 2, 4, 8) or palette is None:
            raise ValueError(f"{path}: palette PNG at {depth} bits or without PLTE")
        channels = 1
    elif color not in _PNG_CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: PNG colour type {color} at {depth} bits is not decoded "
                         "(gray, gray+alpha, RGB, RGBA at 8 or 16 bits and palette are)")
    else:
        channels = _PNG_CHANNELS[color]
    bpp = max(1, channels * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    img = np.empty((H, W, channels), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in passes:
        w, h = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if w <= 0 or h <= 0:
            continue
        stride = -(-w * channels * depth // 8)
        if raw.size < at + h * (stride + 1):
            raise ValueError(f"{path}: truncated PNG image data")
        rows = _unfilter(raw[at: at + h * (stride + 1)], h, stride, bpp, path)
        img[y0::dy, x0::dx] = _png_samples(rows, w, depth, channels)
        at += h * (stride + 1)
    if color == 3:
        rgba = np.concatenate([palette, np.full((len(palette), 1), 255, np.uint8)], 1)
        if trns is not None:
            rgba[: len(trns), 3] = trns
        return rgba[img[..., 0]][..., : 4 if trns is not None else 3]
    return img[..., 0] if channels == 1 else img

def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _rgb8(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8, or float in [0, 1] (clipped, scaled by 255 and
    truncated, as `(np.clip(x, 0, 1) * 255).astype(np.uint8)`)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) images, got {img.shape}")
    return img


def _idat(img: np.ndarray) -> bytes:
    """zlib stream of the rows, each with filter byte 0 (none)."""
    H = img.shape[0]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, -1)], 1)
    return zlib.compress(rows.tobytes(), 6)


def _ihdr(H: int, W: int) -> bytes:
    return _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))


def encode_png(img: np.ndarray) -> bytes:
    """An (H, W, 3) image (uint8, or float in [0, 1]) as the bytes of an 8-bit
    RGB PNG."""
    img = _rgb8(img)
    return (_PNG_SIGNATURE + _ihdr(*img.shape[:2]) + _png_chunk(b"IDAT", _idat(img))
            + _png_chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> str:
    """Writes an (H, W, 3) image (uint8, or float in [0, 1]) as an 8-bit RGB
    PNG; returns the path."""
    with open(path, "wb") as fh:
        fh.write(encode_png(img))
    return str(path)


def write_apng(path, frames: Sequence[np.ndarray], fps: int = 15) -> str:
    """Writes equal-size (H, W, 3) frames as an animated PNG (APNG: acTL, one
    fcTL per frame, frame 0 in IDAT and the rest in fdAT; every frame full
    size, drawn over nothing), looping, 1/fps s per frame; lossless. Viewers
    without APNG show frame 0. Returns the path."""
    imgs = [_rgb8(f) for f in frames]
    if not imgs or any(f.shape != imgs[0].shape for f in imgs):
        raise ValueError("write_apng takes one or more frames of one size")
    H, W = imgs[0].shape[:2]
    out = [_PNG_SIGNATURE, _ihdr(H, W), _png_chunk(b"acTL", struct.pack(">II", len(imgs), 0))]
    seq = 0
    for i, img in enumerate(imgs):
        out.append(_png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, W, H, 0, 0, 1,
                                                   int(fps), 0, 0)))
        seq += 1
        if i == 0:
            out.append(_png_chunk(b"IDAT", _idat(img)))
        else:
            out.append(_png_chunk(b"fdAT", struct.pack(">I", seq) + _idat(img)))
            seq += 1
    out.append(_png_chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return str(path)


def read_apng(path) -> list:
    """The frames of an 8-bit RGB animated PNG as (H, W, 3) uint8 arrays:
    each fcTL region (its IDAT or fdAT data, any row filter) drawn over the
    canvas (blend op 0); a PNG without acTL is one frame. Raises ValueError
    for other colour types, interlacing, or the dispose / blend ops 1-2."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, frames, regions = 8, None, [], []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        kind, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"fcTL":
            _, w, h, x0, y0, _, _, dispose, blend = struct.unpack(">IIIIIHHBB", body)
            if dispose or blend:
                raise ValueError(f"{path}: APNG dispose/blend op {dispose}/{blend} not read")
            regions.append((w, h, x0, y0, []))
        elif kind in (b"IDAT", b"fdAT"):
            if not regions:  # a plain PNG, or an APNG whose IDAT is no frame
                regions.append((None, None, 0, 0, []))
            regions[-1][4].append(body if kind == b"IDAT" else body[4:])
        elif kind == b"IEND":
            break
    if header is None or header[2:5] != (8, 2, 0) or header[6]:
        raise ValueError(f"{path}: read_apng reads non-interlaced 8-bit RGB only")
    W, H = header[:2]
    canvas = np.zeros((H, W, 3), np.uint8)
    for w, h, x0, y0, parts in regions:
        if not parts:
            continue
        w, h = w or W, h or H
        raw = np.frombuffer(zlib.decompress(b"".join(parts)), np.uint8)
        rows = _unfilter(raw[: h * (3 * w + 1)], h, 3 * w, 3, str(path))
        canvas[y0: y0 + h, x0: x0 + w] = rows.reshape(h, w, 3)
        frames.append(canvas.copy())
    return frames


# ---------------------------------------------------------------------------
# JPEG decoding (baseline, Huffman), as libjpeg(-turbo) decodes by default
# ---------------------------------------------------------------------------

# jpeg_natural_order: zigzag position k holds the coefficient at _ZIGZAG[k]
_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
                    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
                    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
                    61, 54, 47, 55, 62, 63])
_JPEG_NOT_BASELINE = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless"}


def _huffman_lut(counts: Sequence[int], symbols: Sequence[int]) -> list:
    """Canonical Huffman code -> a 65,536-entry table indexed by the next 16
    bits of the stream: (symbol << 5) | code length (0: no such code)."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo: lo + (1 << (16 - length))] = (symbols[k] << 5) | length
            code, k = code + 1, k + 1
        code <<= 1
    return lut.tolist()


def _decode_interval(data: bytes, units: list, n_comps: int) -> None:
    """Huffman-decode the MCUs of one restart interval from its unstuffed
    bytes. Each MCU is a list of blocks (coefficient list, offset, DC table,
    AC table, index of the component in the scan); each block's 64
    coefficients are written in zigzag order. The DC predictors start at 0.
    Python walks the symbols; everything after this is numpy."""
    pred = [0] * n_comps
    pos = 0
    for mcu in units:
        for coefs, base, dc, ac, ci in mcu:
            q = pos >> 3
            e = dc[(int.from_bytes(data[q: q + 3], "big") >> (8 - (pos & 7))) & 0xFFFF]
            if not e & 31:
                raise ValueError("corrupt JPEG: no such Huffman code")
            pos += e & 31
            s = e >> 5
            if s:
                q = pos >> 3
                v = (int.from_bytes(data[q: q + 4], "big") >> (32 - s - (pos & 7))) & ((1 << s) - 1)
                pos += s
                pred[ci] += v if v >> (s - 1) else v - (1 << s) + 1
            coefs[base] = pred[ci]
            k = 1
            while k < 64:
                q = pos >> 3
                e = ac[(int.from_bytes(data[q: q + 3], "big") >> (8 - (pos & 7))) & 0xFFFF]
                if not e & 31:
                    raise ValueError("corrupt JPEG: no such Huffman code")
                pos += e & 31
                rs = e >> 5
                s = rs & 15
                if s == 0:
                    if rs != 0xF0:
                        break  # end of block
                    k += 16
                    continue
                k += rs >> 4
                q = pos >> 3
                v = (int.from_bytes(data[q: q + 4], "big") >> (32 - s - (pos & 7))) & ((1 << s) - 1)
                pos += s
                coefs[base + k] = v if v >> (s - 1) else v - (1 << s) + 1
                k += 1


def _scan_end(data: bytes, pos: int) -> int:
    """Where the entropy-coded data from `pos` ends: at the first marker
    that is neither a stuffed 0xFF00 nor a restart marker."""
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            return len(data)
        if data[pos + 1] == 0 or 0xD0 <= data[pos + 1] <= 0xD7:
            pos += 2
            continue
        return pos


def _decode_scan(data: bytes, pos: int, header: bytes, frame: dict, dc_tabs: dict,
                 ac_tabs: dict, restart: int) -> int:
    """Huffman-decode one scan into its components' coefficients; returns the
    position of the marker after the scan."""
    comps, H, W = frame["comps"], frame["H"], frame["W"]
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    for c in comps:
        if "coefs" not in c:
            c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
            c["coefs"] = [0] * (c["bw"] * c["bh"] * 64)
    ns = header[0]
    by_id = {c["id"]: c for c in comps}
    scan = [(by_id[header[1 + 2 * i]], dc_tabs[header[2 + 2 * i] >> 4],
             ac_tabs[header[2 + 2 * i] & 15]) for i in range(ns)]
    if (header[1 + 2 * ns], header[2 + 2 * ns]) != (0, 63):
        raise ValueError("progressive JPEG scan is not decoded (baseline only)")
    units = []
    if ns == 1:  # non-interleaved: the component's own blocks, in raster order
        c, dc, ac = scan[0]
        for by in range(-(-(-(-H * c["v"] // vmax)) // 8)):
            for bx in range(-(-(-(-W * c["h"] // hmax)) // 8)):
                units.append([(c["coefs"], (by * c["bw"] + bx) * 64, dc, ac, 0)])
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                units.append([(c["coefs"], ((my * c["v"] + yy) * c["bw"] + mx * c["h"] + xx) * 64,
                               dc, ac, ci)
                              for ci, (c, dc, ac) in enumerate(scan)
                              for yy in range(c["v"]) for xx in range(c["h"])])
    end = _scan_end(data, pos)
    segments, start = [], pos
    if restart:
        for m in range(pos, end - 1):
            if data[m] == 0xFF and 0xD0 <= data[m + 1] <= 0xD7:
                segments.append(data[start:m])
                start = m + 2
    segments.append(data[start:end])
    per = restart or len(units)
    for k, seg in enumerate(segments):
        # libjpeg reads zero bits past the end of a segment
        _decode_interval(seg.replace(b"\xff\x00", b"\xff") + b"\x00" * 8,
                         units[k * per:(k + 1) * per], ns)
    return end


# jidctint.c's constants: FIX(x) = round(x * 2^13)
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172
# the post-IDCT range-limit table, indexed by the low 10 bits of a sample
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(0, 128)]).astype(np.uint8)


def _idct_pass(c: Sequence[np.ndarray]) -> list:
    """One pass of libjpeg's jpeg_idct_islow on the 8 inputs c[0..7] of every
    column (pass 1) or row (pass 2), int64, before the pass's descale."""
    z1 = (c[2] + c[6]) * _F0541
    tmp2, tmp3 = z1 - c[6] * _F1847, z1 + c[2] * _F0765
    tmp0, tmp1 = (c[0] + c[4]) << 13, (c[0] - c[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0, o1, o2, o3 = o0 * _F0298, o1 * _F2053, o2 * _F3072, o3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def _idct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's accurate integer IDCT (jidctint.c) of dequantized (N, 8, 8)
    [row, column] coefficients, range-limited: (N, 8, 8) uint8."""
    x = blocks.astype(np.int64)
    ws = np.stack([(v + (1 << 10)) >> 11 for v in _idct_pass([x[:, k] for k in range(8)])], 1)
    out = np.stack([(v + (1 << 17)) >> 18 for v in _idct_pass([ws[:, :, k] for k in range(8)])],
                   2)
    return _IDCT_LIMIT[out & 1023]


def _fancy_upsample(plane: np.ndarray, h: int, v: int) -> np.ndarray:
    """libjpeg's fancy (triangle) upsampling of an int64 plane by h in x and
    v in y, the edges replicated: jdsample.c's h2v1_fancy_upsample (3/4 and
    1/4 of the nearer and further column, rounding +1 / +2) and
    h2v2_fancy_upsample (9/16, 3/16, 3/16, 1/16, rounding +8 / +7)."""
    if (h, v) == (1, 1):
        return plane
    if (h, v) not in ((2, 1), (2, 2)):
        raise ValueError(f"JPEG chroma subsampled {h}x{v} is not decoded "
                         "(4:4:4, 4:2:2 and 4:2:0 are)")
    p = np.pad(plane, ((v - 1, v - 1), (1, 1)), mode="edge")
    if v == 2:  # column sums 3 * nearer row + further row, output rows in pairs
        near = 3 * p[1:-1]
        p = np.stack([near + p[:-2], near + p[2:]], 1).reshape(-1, p.shape[1])
        even = (3 * p[:, 1:-1] + p[:, :-2] + 8) >> 4
        odd = (3 * p[:, 1:-1] + p[:, 2:] + 7) >> 4
    else:
        even = (3 * p[:, 1:-1] + p[:, :-2] + 1) >> 2
        odd = (3 * p[:, 1:-1] + p[:, 2:] + 2) >> 2
    return np.stack([even, odd], 2).reshape(even.shape[0], -1)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: 16-bit fixed-point tables, clamped."""
    def fix(x):
        return int(x * (1 << 16) + 0.5)

    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + (1 << 15)) >> 16)
    g = y + ((-fix(0.34414) * cb + (1 << 15) - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + (1 << 15)) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """Decode a baseline JPEG: (H, W) uint8 for one component, (H, W, 3) RGB
    for three. Huffman coding with restart markers, 4:4:4, 4:2:2 and 4:2:0
    sampling, in the integer arithmetic of libjpeg's defaults (the ISLOW
    IDCT, fancy upsampling, the YCbCr tables), so that the output equals
    PIL's and OpenCV's (libjpeg-turbo). Other JPEG processes (progressive,
    arithmetic-coded, lossless, 12-bit) raise ValueError naming them."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG")
    qt, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart, adobe, jfif = None, 0, None, False
    pos = 2
    while pos + 1 < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt JPEG (no marker at byte {pos})")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        pos += 2
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos: pos + 2])
        body = data[pos + 2: pos + length]
        pos += length
        if marker in _JPEG_NOT_BASELINE:
            raise ValueError(f"{name}: {_JPEG_NOT_BASELINE[marker]} JPEG is not decoded "
                             "(baseline only)")
        if marker in (0xC0, 0xC1):
            prec, H, W, nf = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"{name}: {prec}-bit JPEG is not decoded (8-bit only)")
            if H == 0:
                raise ValueError(f"{name}: JPEG whose height is given by DNL is not decoded")
            comps = [dict(id=body[6 + 3 * i], h=body[7 + 3 * i] >> 4, v=body[7 + 3 * i] & 15,
                          tq=body[8 + 3 * i]) for i in range(nf)]
            frame = dict(H=H, W=W, comps=comps)
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                wide, n = body[i] >> 4, 128 if body[i] >> 4 else 64
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = np.frombuffer(body[i + 1: i + 1 + n], ">u2" if wide else np.uint8)
                qt[body[i] & 15] = table
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                counts = list(body[i + 1: i + 17])
                symbols = list(body[i + 17: i + 17 + sum(counts)])
                (ac_tabs if body[i] >> 4 else dc_tabs)[body[i] & 15] = _huffman_lut(counts,
                                                                                    symbols)
                i += 17 + sum(counts)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            pos = _decode_scan(data, pos, body, frame, dc_tabs, ac_tabs, restart)
    if frame is None or any("coefs" not in c for c in frame["comps"]):
        raise ValueError(f"{name}: JPEG without image data for every component")
    comps, H, W = frame["comps"], frame["H"], frame["W"]
    if len(comps) not in (1, 3):
        raise ValueError(f"{name}: {len(comps)}-component JPEG is not decoded (gray and "
                         "three-component are)")
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    planes = []
    for c in comps:
        zz = np.asarray(c["coefs"], np.int64).reshape(-1, 64)
        blocks = np.empty_like(zz)
        blocks[:, _ZIGZAG] = zz
        pix = _idct_islow((blocks * qt[c["tq"]]).reshape(-1, 8, 8))
        plane = pix.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(
            c["bh"] * 8, c["bw"] * 8).astype(np.int64)
        plane = plane[: -(-H * c["v"] // vmax), : -(-W * c["h"] // hmax)]
        planes.append(_fancy_upsample(plane, hmax // c["h"], vmax // c["v"])[:H, :W])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    ids = tuple(c["id"] for c in comps)
    rgb = (not jfif) and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def read_image(path) -> np.ndarray:
    """Decode a PNG (read_png) or a baseline JPEG (decode_jpeg), by content."""
    with open(path, "rb") as fh:
        data = fh.read()
    return decode_jpeg(data, str(path)) if data[:3] == b"\xff\xd8\xff" else read_png(path)
