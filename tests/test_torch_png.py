"""`imgproc.read_png`, the port's PNG decoder (stdlib zlib and numpy; the
card's machine has no imageio, PIL or OpenCV), against imageio.imread, bit
for bit: PNGs that imageio writes in each mode, and PNGs written here with a
chosen row filter per row, so that all five filters (None, Sub, Up, Average,
Paeth) are decoded in every mode, 8 and 16 bits. JPEG and interlaced PNG
raise ValueError naming the format. The DTU loader, which decodes its images
and masks with read_png, still gives the JAX package's scene with imageio
blocked."""
import struct
import sys
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest

import torch_parity  # noqa: F401  (thread cap)
from sparf_tpu_torch.utils import imgproc

COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, row, prev, bpp):
    """PNG filter `kind` applied to one row of bytes (ints)."""
    out = []
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out.append((x - pred) & 255)
    return out


def _write_png(path, img, interlace=0):
    """Encode (H, W[, C]) uint8/uint16 with filter type r % 5 on row r."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[2]
    depth = 16 if img.dtype == np.uint16 else 8
    raw = img.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1).view(np.uint8)
    bpp = C * depth // 8
    body, prev = bytearray(), [0] * raw.shape[1]
    for r in range(H):
        row = raw[r].tolist()
        body += bytes([r % 5] + _filter_row(r % 5, row, prev, bpp))
        prev = row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", W, H, depth, COLOR_TYPE[C], 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(bytes(body))) + chunk(b"IEND", b""))


def _image(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    hi = 65536 if dtype == np.uint16 else 256
    # smooth ramps plus noise: every filter's predictor matters
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = (xx * 7 + yy * 3) % hi
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 40
    return ((base + rng.randint(0, hi // 8, shape)) % hi).astype(dtype)


SHAPES = [(13, 17), (13, 17, 2), (13, 17, 3), (13, 17, 4)]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", SHAPES, ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_read_png_decodes_every_filter(tmp_path, shape, dtype):
    img = _image(shape, dtype, seed=len(shape))
    path = str(tmp_path / "f.png")
    _write_png(path, img)
    out = imgproc.read_png(path)
    assert out.dtype == img.dtype and out.shape == img.shape
    np.testing.assert_array_equal(out, img)
    ref = imageio.imread(path)
    if ref.dtype == out.dtype:  # imageio's PIL reader narrows some 16-bit modes to 8 bits
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape,dtype", [((30, 41), np.uint8), ((30, 41), np.uint16),
                                         ((30, 41, 2), np.uint8), ((30, 41, 3), np.uint8),
                                         ((30, 41, 4), np.uint8), ((300, 400, 3), np.uint8)])
def test_read_png_equals_imageio_on_its_own_files(tmp_path, shape, dtype):
    img = _image(shape, dtype, seed=7)
    path = str(tmp_path / "i.png")
    imageio.imwrite(path, img)
    ref = imageio.imread(path)
    out = imgproc.read_png(path)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_read_png_names_what_it_does_not_decode(tmp_path):
    jpg = str(tmp_path / "x.jpg")
    imageio.imwrite(jpg, _image((16, 16, 3), np.uint8, 0))
    with pytest.raises(ValueError, match="JPEG"):
        imgproc.read_png(jpg)
    inter = str(tmp_path / "adam7.png")
    _write_png(inter, _image((8, 8), np.uint8, 0), interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        imgproc.read_png(inter)


def test_dtu_loader_equals_jax_without_imageio(tmp_path, monkeypatch):
    """A DTU scan written by imageio (images and foreground masks) loads
    through the port with imageio and PIL blocked, equal to the JAX
    package's loader (which decodes with imageio)."""
    from scipy.spatial.transform import Rotation

    from sparf_tpu.configs import config as config_j
    from sparf_tpu.datasets import create_dataset as create_dataset_j
    from sparf_tpu_torch import datasets as datasets_t
    from sparf_tpu_torch.configs import config as config_t

    rng = np.random.RandomState(1)
    img_dir, mask_dir = tmp_path / "dtu" / "scan82" / "image", tmp_path / "masks" / "scan82"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir(parents=True)
    K = np.array([[360.0, 0, 200.0], [0, 360.0, 150.0], [0, 0, 1]])
    cams = {}
    yy, xx = np.mgrid[0:300, 0:400]
    for i in range(49):
        R = Rotation.from_rotvec(rng.randn(3) * 0.2).as_matrix()
        t = rng.randn(3) * 50 + np.array([0, 0, 600.0])
        cams[f"world_mat_{i}"] = np.concatenate([K @ np.concatenate([R, t[:, None]], 1),
                                                 [[0, 0, 0, 1]]], 0)
        cams[f"scale_mat_{i}"] = np.diag([300.0, 300.0, 300.0, 1.0])
        imageio.imwrite(str(img_dir / f"{i:06d}.png"),
                        (rng.rand(300, 400, 3) * 255).astype(np.uint8))
        disc = (xx - 200 - i) ** 2 + (yy - 150) ** 2 < (80 + i) ** 2
        imageio.imwrite(str(mask_dir / f"{i:03d}.png"), (disc * 255).astype(np.uint8))
    np.savez(str(tmp_path / "dtu" / "scan82" / "cameras.npz"), **cams)
    kw = dict(dataset="dtu", scene="scan82", train_sub=3, resize=[76, 100], mask_img=True)
    env = dict(dtu=str(tmp_path / "dtu"), dtu_mask=str(tmp_path / "masks"))
    b = create_dataset_j(config_j.ConfigDict(kw, env=config_j.ConfigDict(env)), "train")
    for name in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    a = datasets_t.create_dataset(config_t.ConfigDict(kw, env=config_t.ConfigDict(env)), "train")
    assert sorted(a) == sorted(b) and "fg_mask" in a
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k
