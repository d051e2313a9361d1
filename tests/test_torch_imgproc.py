"""The port's OpenCV replacements (sparf_tpu_torch/utils/imgproc.py) against
OpenCV itself, which the JAX package calls.

Tolerances: INTER_AREA on 3-channel float32 images and INTER_NEAREST are bit
for bit (the same sums in the same order); INTER_AREA on one channel and
INTER_LINEAR within 2.4e-7 (OpenCV's vectorised paths fuse or reorder a
multiply-add); dilation exact; the projection decomposition's K bit for bit
(OpenCV's Givens sequence), R within 1e-12, the camera centre rtol 1e-9.
RANSAC draws its own samples, so the verified masks are held to OpenCV's by
agreement rate on fixtures with known inliers (noise
0.4 px, 20% gross outliers): at least 80% (83-90% measured), reported, and
the port keeps at least as many true inliers as OpenCV (its least-squares
refit on the inliers gives a better model than a minimal sample) with no
more than 1.5x its outliers.
"""
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread cap)
from sparf_tpu_torch.utils import imgproc

cv2 = pytest.importorskip("cv2")

RESIZES = [(378, 504, 60, 80), (300, 400, 150, 200), (300, 400, 75, 100), (301, 401, 150, 200),
           (48, 64, 20, 30), (48, 64, 96, 128), (48, 64, 70, 90), (48, 64, 20, 90)]


@pytest.mark.parametrize("H,W,Ho,Wo", RESIZES)
def test_resize_matches_opencv(H, W, Ho, Wo):
    rng = np.random.RandomState(H + Wo)
    img = rng.rand(H, W, 3).astype(np.float32)
    np.testing.assert_array_equal(imgproc.resize_area(img, (Ho, Wo)),
                                  cv2.resize(img, (Wo, Ho), interpolation=cv2.INTER_AREA))
    gray = img[..., 0].copy()
    np.testing.assert_allclose(imgproc.resize_area(gray, (Ho, Wo)),
                               cv2.resize(gray, (Wo, Ho), interpolation=cv2.INTER_AREA),
                               rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(imgproc.resize_linear(img, (Ho, Wo)),
                               cv2.resize(img, (Wo, Ho), interpolation=cv2.INTER_LINEAR),
                               rtol=0, atol=2.4e-7)
    labels = rng.randint(0, 5, (H, W)).astype(np.float32)
    np.testing.assert_array_equal(imgproc.resize_nearest(labels, (Ho, Wo)),
                                  cv2.resize(labels, (Wo, Ho), interpolation=cv2.INTER_NEAREST))


def test_dilate_matches_opencv():
    m = (np.random.RandomState(0).rand(40, 50) > 0.97).astype(np.float32)
    for n in (1, 10):
        np.testing.assert_array_equal(imgproc.dilate(m, n),
                                      cv2.dilate(m, np.ones((3, 3)), iterations=n))
    assert imgproc.dilate(m > 0, 2).dtype == bool


@pytest.mark.parametrize("scale", [1.0, 300.0, -2.0, -0.5])
def test_decompose_projection_matrix_matches_opencv(scale):
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(int(abs(scale)))
    K = np.array([[360.0, 2.0, 200.0], [0.0, 340.0, 150.0], [0.0, 0.0, 1.0]])
    R = Rotation.from_rotvec(rng.randn(3)).as_matrix()
    P = scale * K @ np.concatenate([R, rng.randn(3, 1) * 50], 1)
    Kc, Rc, tc = cv2.decomposeProjectionMatrix(P)[:3]
    Kp, Rp, tp = imgproc.decompose_projection_matrix(P)
    np.testing.assert_array_equal(Kp, Kc)
    np.testing.assert_allclose(Rp, Rc, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tp[:3] / tp[3], tc[:3] / tc[3], rtol=1e-9)
    assert np.linalg.det(Rp) > 0


def _two_view_fixture(seed: int, n: int):
    """Pixels of n points seen by two cameras; 0.4 px noise in the second
    view and 20% of its points moved by up to 15 px (the outliers)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    X = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(3, 5, (n, 1))], 1)
    R = Rotation.from_rotvec(rng.randn(3) * 0.1).as_matrix()
    x1 = X @ K.T
    x2 = (X @ R.T + np.array([0.5, 0.05, 0.02])) @ K.T
    x1, x2 = x1[:, :2] / x1[:, 2:], x2[:, :2] / x2[:, 2:]
    x2 = x2 + rng.randn(n, 2) * 0.4
    outlier = rng.rand(n) < 0.2
    x2[outlier] += rng.uniform(-15, 15, (int(outlier.sum()), 2))
    return x1, x2, outlier


@pytest.mark.parametrize("seed,n", [(0, 200), (1, 1000), (2, 3000)])
def test_ransac_agrees_with_opencv(seed, n):
    x1, x2, outlier = _two_view_fixture(seed, n)
    _, mask_cv = cv2.findFundamentalMat(x1, x2, cv2.FM_RANSAC, 1.0, 0.999)
    mask_cv = mask_cv[:, 0].astype(bool)
    F, mask = imgproc.find_fundamental_ransac(x1, x2, 1.0, 0.999,
                                              generator=torch.Generator().manual_seed(seed))
    agreement = float((mask == mask_cv).mean())
    print(f"RANSAC n={n}: agreement with OpenCV {agreement:.4f}; inliers kept "
          f"{int((mask & ~outlier).sum())} (OpenCV {int((mask_cv & ~outlier).sum())}), "
          f"outliers kept {int((mask & outlier).sum())} (OpenCV {int((mask_cv & outlier).sum())})")
    assert agreement >= 0.8
    assert (mask & ~outlier).sum() >= (mask_cv & ~outlier).sum()
    assert (mask & outlier).sum() <= 1.5 * (mask_cv & outlier).sum() + 2
    # the inliers lie near their epipolar lines in the second view
    x1h = np.concatenate([x1[mask], np.ones((int(mask.sum()), 1))], 1)
    lines = x1h @ F.T
    dist = np.abs(np.sum(lines[:, :2] * x2[mask], 1) + lines[:, 2]) / np.linalg.norm(
        lines[:, :2], axis=1)
    assert np.median(dist) < 0.5


def test_ransac_is_deterministic_and_guards_small_inputs():
    x1, x2, _ = _two_view_fixture(3, 300)
    runs = [imgproc.find_fundamental_ransac(x1, x2, generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    F, mask = imgproc.find_fundamental_ransac(x1[:7], x2[:7])
    assert F is None and mask.shape == (7,) and not mask.any()
