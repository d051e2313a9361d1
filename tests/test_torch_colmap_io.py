"""The port's copy of colmap_init/colmap_model_io.py: a twin of
tests/test_colmap_io.py::test_model_roundtrip, and models written by one
package read by the other, field for field, with w2c poses equal to the
JAX package's (both float32 from the same quaternion formula)."""
import numpy as np
import pytest

from sparf_tpu.colmap_init import colmap_model_io as cio_j
from sparf_tpu_torch.colmap_init import colmap_model_io as cio


def _model(mod, rng):
    cameras = {
        1: mod.Camera(1, "SIMPLE_PINHOLE", 400, 300, np.array([360.0, 200.0, 150.0])),
        2: mod.Camera(2, "PINHOLE", 640, 480, np.array([500.0, 510.0, 320.0, 240.0])),
    }
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    images = {
        1: mod.Image(1, q.copy(), np.array([0.1, -0.2, 0.3]), 1, "img001.png",
                     np.array([[1.5, 2.5], [3.0, 4.0]]), np.array([7, -1], np.int64)),
        2: mod.Image(2, np.array([1.0, 0, 0, 0]), np.zeros(3), 2, "img002.png"),
    }
    points = {
        7: mod.Point3D(7, np.array([0.1, 0.2, 0.3]), np.array([255, 128, 0]), 0.75,
                       np.array([1, 2]), np.array([0, 5])),
    }
    return cameras, images, points


def test_model_roundtrip(tmp_path, rng):
    cameras, images, points = _model(cio, rng)
    q = images[1].qvec
    cio.write_model(cameras, images, points, str(tmp_path))
    c2, i2, p2 = cio.read_model(str(tmp_path))

    assert c2[1].model == "SIMPLE_PINHOLE" and c2[2].model == "PINHOLE"
    np.testing.assert_allclose(c2[1].params, cameras[1].params)
    np.testing.assert_allclose(c2[1].K()[0, 0], 360.0)
    np.testing.assert_allclose(i2[1].qvec, q)
    np.testing.assert_allclose(i2[1].xys, images[1].xys)
    np.testing.assert_array_equal(i2[1].point3D_ids, images[1].point3D_ids)
    assert i2[1].name == "img001.png"
    np.testing.assert_allclose(p2[7].xyz, points[7].xyz)
    np.testing.assert_array_equal(p2[7].image_ids, points[7].image_ids)
    assert abs(p2[7].error - 0.75) < 1e-12

    # pose conversion: w2c rotation from quaternion is orthonormal
    w2c = i2[1].w2c()
    RtR = w2c[:, :3].T @ w2c[:, :3]
    np.testing.assert_allclose(RtR, np.eye(3), atol=1e-5)

    poses = cio.read_images_binary_to_poses(str(tmp_path / "images.bin"))
    assert set(poses) == {"img001.png", "img002.png"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_models_cross_read(tmp_path, rng, writer):
    """A model written by one package reads the same in the other."""
    w = cio_j if writer == "jax" else cio
    w.write_model(*_model(w, rng), str(tmp_path))
    read_t, read_j = cio.read_model(str(tmp_path)), cio_j.read_model(str(tmp_path))
    for a, b in zip(read_t, read_j):
        assert sorted(a) == sorted(b)
        for k in a:
            for field, value in vars(b[k]).items():
                got = getattr(a[k], field)
                if isinstance(value, np.ndarray):
                    np.testing.assert_array_equal(got, value)
                else:
                    assert got == value, field
    for k in read_j[1]:
        np.testing.assert_array_equal(read_t[1][k].w2c(), read_j[1][k].w2c())
    poses_t = cio.read_images_binary_to_poses(str(tmp_path / "images.bin"))
    poses_j = cio_j.read_images_binary_to_poses(str(tmp_path / "images.bin"))
    assert sorted(poses_t) == sorted(poses_j)
    for k in poses_j:
        np.testing.assert_array_equal(poses_t[k], poses_j[k])
