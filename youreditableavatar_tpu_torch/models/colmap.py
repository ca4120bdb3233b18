"""COLMAP sparse-reconstruction readers (binary + text).

Capability parity with `tetgs_scene/colmap_loader.py:43-294`: cameras,
images (extrinsics), and points3D, in both binary and text formats. Pure
numpy/stdlib implementation of the public COLMAP file-format spec.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Tuple

import numpy as np

# COLMAP camera model ids → (name, num_params).
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


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-dependent


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) wxyz world→cam rotation
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    # Normalize defensively: COLMAP writes unit quaternions, but a
    # hand-built or truncated-precision model would otherwise yield a
    # non-orthonormal rotation that silently skews every pose.
    n = float(np.linalg.norm(qvec))
    if not np.isfinite(n) or n < 1e-8:
        raise ValueError(f"degenerate quaternion in COLMAP model: {qvec}")
    w, x, y, z = np.asarray(qvec) / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(fd, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fd.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as fd:
        (n,) = _read(fd, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fd, "<iiQQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.array(_read(fd, f"<{nparams}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height),
                                        params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path, "rb") as fd:
        (n,) = _read(fd, "<Q")
        for _ in range(n):
            vals = _read(fd, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = fd.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(fd, "<Q")
            fd.read(24 * npts)  # skip 2D points (x, y, point3D_id)
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8")
            )
    return images


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (xyz (N,3) float64, rgb (N,3) uint8)."""
    xyzs, rgbs = [], []
    with open(path, "rb") as fd:
        (n,) = _read(fd, "<Q")
        for _ in range(n):
            vals = _read(fd, "<QdddBBBd")
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            (track_len,) = _read(fd, "<Q")
            fd.read(8 * track_len)
    return np.array(xyzs), np.array(rgbs, dtype=np.uint8)


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path) as fd:
        for line in fd:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path) as fd:
        # Keep EMPTY lines: each image is a meta line followed by its 2D
        # point list, and that second line is legitimately empty for images
        # with zero observations — filtering blanks would desynchronize the
        # meta/points pairing and silently drop every other image.
        lines = [ln.strip() for ln in fd if not ln.startswith("#")]
    is_meta = True
    for ln in lines:
        if is_meta and not ln:
            continue  # stray blank between records
        if is_meta:
            parts = ln.split()
            images[int(parts[0])] = ColmapImage(
                int(parts[0]),
                np.array([float(p) for p in parts[1:5]]),
                np.array([float(p) for p in parts[5:8]]),
                int(parts[8]),
                parts[9],
            )
            is_meta = False
        else:
            is_meta = True  # the (possibly empty) 2D point list line
    return images


def read_points3d_text(path: str) -> Tuple[np.ndarray, np.ndarray]:
    xyzs, rgbs = [], []
    with open(path) as fd:
        for line in fd:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(p) for p in parts[1:4]])
            rgbs.append([int(p) for p in parts[4:7]])
    return np.array(xyzs), np.array(rgbs, dtype=np.uint8)


def load_sparse_model(sparse_dir: str):
    """Load (cameras, images, points) from a COLMAP sparse dir (bin or txt)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        images = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts_path = os.path.join(sparse_dir, "points3D.bin")
        pts = read_points3d_binary(pts_path) if os.path.exists(pts_path) else (
            np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
        )
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        images = read_images_text(os.path.join(sparse_dir, "images.txt"))
        pts_path = os.path.join(sparse_dir, "points3D.txt")
        pts = read_points3d_text(pts_path) if os.path.exists(pts_path) else (
            np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
        )
    return cams, images, pts


def camera_intrinsics(cam: ColmapCamera) -> Tuple[float, float, float, float]:
    """(fx, fy, cx, cy) for pinhole-family models."""
    if cam.model == "SIMPLE_PINHOLE" or cam.model == "SIMPLE_RADIAL":
        f, cx, cy = cam.params[:3]
        return float(f), float(f), float(cx), float(cy)
    if cam.model in ("PINHOLE", "OPENCV"):
        fx, fy, cx, cy = cam.params[:4]
        return float(fx), float(fy), float(cx), float(cy)
    raise ValueError(f"unsupported camera model {cam.model}")
