"""`imgproc.decode_jpeg`, the port's baseline-JPEG decoder (numpy; the card's
machine has no PIL, imageio or OpenCV), against PIL and OpenCV (both
libjpeg-turbo) bit for bit: JPEGs that PIL encodes at 4:4:4, 4:2:2 and
4:2:0 and in gray, with and without restart markers, at odd sizes; one
frame of Replica's size (680x1200), timed. Progressive and arithmetic-coded
JPEGs raise ValueError naming the process. `read_image` reads PNG and JPEG
by content, and the LLFF loader at llff_img_factor=1 (full-resolution
`images/`, JPEG) gives the JAX package's scene (imageio) bit for bit."""
import io
import time

import cv2
import numpy as np
import pytest
from PIL import Image

import torch_parity  # noqa: F401  (thread cap)
from sparf_tpu_torch.utils import imgproc

SAMPLING = {"444": 0, "422": 1, "420": 2}  # PIL's subsampling option


def _image(h, w, seed, channels=3):
    """Smooth ramps plus noise, so that every coefficient band is coded."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 7.0 + k) * 90 + np.cos(yy / 5.0 + k) * 60 + 128
                     for k in range(channels)], -1)
    return np.clip(base + rng.randn(h, w, channels) * 20, 0, 255).astype(np.uint8)


def _encode(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _assert_equals_pil_and_cv2(data, gray=False):
    out = imgproc.decode_jpeg(data)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("L" if gray else "RGB"))
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    cv = cv2.imdecode(np.frombuffer(data, np.uint8),
                      cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(out, cv if gray else cv[..., ::-1])
    return out


@pytest.mark.parametrize("restart", [None, 3])
@pytest.mark.parametrize("size", [(16, 16), (37, 53), (9, 130)])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_decode_jpeg_equals_pil(sampling, size, restart):
    kw = dict(quality=90, subsampling=SAMPLING[sampling])
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _encode(_image(*size, seed=size[1]), **kw)
    assert (b"\xff\xdd" in data) == bool(restart)  # DRI
    _assert_equals_pil_and_cv2(data)


@pytest.mark.parametrize("restart", [None, 2])
@pytest.mark.parametrize("quality", [40, 97])
def test_decode_gray_jpeg(restart, quality):
    kw = dict(quality=quality, restart_marker_blocks=restart) if restart else dict(quality=quality)
    data = _encode(_image(29, 35, seed=quality, channels=1)[..., 0], **kw)
    assert _assert_equals_pil_and_cv2(data, gray=True).shape == (29, 35)


def test_replica_size_frame():
    """One frame of Replica's size (680x1200, quality 95, 4:2:0)."""
    data = _encode(_image(680, 1200, seed=0), quality=95)
    t0 = time.perf_counter()
    out = imgproc.decode_jpeg(data)
    seconds = time.perf_counter() - t0
    print(f"680x1200 JPEG ({len(data)} bytes) decoded in {seconds:.3f} s")
    np.testing.assert_array_equal(out, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_other_jpeg_processes_raise():
    img = _image(16, 24, seed=1)
    with pytest.raises(ValueError, match="progressive"):
        imgproc.decode_jpeg(_encode(img, progressive=True))
    data = bytearray(_encode(img))
    sof = data.find(b"\xff\xc0")
    data[sof + 1] = 0xC9  # the same frame, declared arithmetic-coded
    with pytest.raises(ValueError, match="arithmetic-coded"):
        imgproc.decode_jpeg(bytes(data))
    with pytest.raises(ValueError, match="not a JPEG"):
        imgproc.decode_jpeg(b"\x89PNG\r\n\x1a\n")


def test_read_image_reads_png_and_jpeg(tmp_path):
    img = _image(12, 20, seed=2)
    Image.fromarray(img).save(tmp_path / "a.png")
    Image.fromarray(img).save(tmp_path / "b.jpg", quality=90)
    np.testing.assert_array_equal(imgproc.read_image(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(imgproc.read_image(tmp_path / "b.jpg"),
                                  np.asarray(Image.open(tmp_path / "b.jpg")))


@pytest.mark.parametrize("split", ["train", "test"])
def test_llff_full_resolution_jpeg_equals_jax(tmp_path, split):
    """An LLFF scene with only `images/` (JPEG): the port's loader at
    llff_img_factor=1 against the JAX package's (imageio)."""
    from scipy.spatial.transform import Rotation

    from sparf_tpu.configs import config as config_j
    from sparf_tpu.datasets import create_dataset as create_dataset_j
    from sparf_tpu_torch import datasets as datasets_t
    from sparf_tpu_torch.configs import config as config_t

    img_dir = tmp_path / "fern" / "images"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    rows = []
    for i in range(10):
        R = Rotation.from_rotvec(rng.randn(3) * 0.1).as_matrix()
        t = rng.randn(3) * 0.2 + np.array([0, 0, 4.0])
        hwf = np.array([48.0, 64.0, 52.0])[:, None]
        row = np.concatenate([np.concatenate([R, t[:, None]], 1), hwf], axis=1).reshape(-1)
        rows.append(np.concatenate([row, [2.0 + 0.1 * i, 8.0 - 0.1 * i]]))
        Image.fromarray(_image(48, 64, seed=i)).save(img_dir / f"img{i:03d}.JPG", quality=92)
    np.save(str(tmp_path / "fern" / "poses_bounds.npy"), np.stack(rows))
    kw = dict(dataset="llff", scene="fern", train_sub=3, llff_img_factor=1)
    a = datasets_t.create_dataset(
        config_t.ConfigDict(kw, env=config_t.ConfigDict(llff=str(tmp_path))), split)
    b = create_dataset_j(config_j.ConfigDict(kw, env=config_j.ConfigDict(llff=str(tmp_path))),
                         split)
    assert sorted(a) == sorted(b) and a["image"].shape[-2:] == (48, 64)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k
