"""COLMAP binary/text model IO (cameras/images/points3D): the port's copy of
sparf_tpu/colmap_init/colmap_model_io.py, its w2c through the port's camera.

Counterpart of the reference's vendored third_party/colmap_read_write_model.py
(:76-473): lets the framework consume reconstructions produced by real COLMAP
(or export our mini-SfM results in COLMAP format). Implemented from the
documented COLMAP binary format spec.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def K(self) -> np.ndarray:
        if self.model == "SIMPLE_PINHOLE":
            f, cx, cy = self.params[:3]
            return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64)
        if self.model == "PINHOLE":
            fx, fy, cx, cy = self.params[:4]
            return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        raise ValueError(f"no pinhole K for model {self.model}")


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # (4,) w,x,y,z — world-to-camera rotation
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def w2c(self) -> np.ndarray:
        import torch

        from sparf_tpu_torch.utils import camera as cam

        # float32, as the JAX package's default dtype computes it
        R = cam.quaternion_to_R(torch.as_tensor(self.qvec[None], dtype=torch.float32))[0].numpy()
        return np.concatenate([R, self.tvec.reshape(3, 1)], axis=1).astype(np.float32)


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def _read(fid, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fid.read(size))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * n_params))
            cameras[cam_id] = Camera(cam_id, name, int(width), int(height), params)
    return cameras


def write_cameras_binary(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid, n_params = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * n_params, *cam.params[:n_params]))


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            image_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            camera_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.fromfile(f, "<f8", int(n_pts) * 3).reshape(-1, 3)
            xys = data[:, :2].copy()
            ids = data[:, 2].astype(np.int64)
            images[image_id] = Image(image_id, qvec, tvec, camera_id,
                                     name.decode("utf-8"), xys, ids)
    return images


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            if len(im.xys):
                data = np.concatenate(
                    [im.xys.astype("<f8"), im.point3D_ids.astype("<f8")[:, None]], axis=1
                )
                data.astype("<f8").tofile(f)


def read_points3D_binary(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<ddd"))
            rgb = np.array(_read(f, "<BBB"))
            (error,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            data = np.fromfile(f, "<i4", int(track_len) * 2).reshape(-1, 2)
            points[pid] = Point3D(pid, xyz, rgb, float(error), data[:, 0].copy(),
                                  data[:, 1].copy())
    return points


def write_points3D_binary(points: Dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<ddd", *p.xyz))
            f.write(struct.pack("<BBB", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            data = np.stack([p.image_ids, p.point2D_idxs], axis=1).astype("<i4")
            data.tofile(f)


def read_model(model_dir: str):
    """(cameras, images, points3D) from a COLMAP sparse model dir (binary)."""
    cameras = read_cameras_binary(os.path.join(model_dir, "cameras.bin"))
    images = read_images_binary(os.path.join(model_dir, "images.bin"))
    points = read_points3D_binary(os.path.join(model_dir, "points3D.bin"))
    return cameras, images, points


def write_model(cameras, images, points, model_dir: str) -> None:
    os.makedirs(model_dir, exist_ok=True)
    write_cameras_binary(cameras, os.path.join(model_dir, "cameras.bin"))
    write_images_binary(images, os.path.join(model_dir, "images.bin"))
    write_points3D_binary(points, os.path.join(model_dir, "points3D.bin"))


def read_images_binary_to_poses(path: str) -> Dict[str, np.ndarray]:
    """image name -> (3,4) w2c pose (reference colmap_read_write_model.py helper)."""
    return {im.name: im.w2c() for im in read_images_binary(path).values()}
