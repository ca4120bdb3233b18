"""Camera layer: COLMAP loading, synthetic ring samplers, tet↔COLMAP pose chain.

Counterpart of `youreditableavatar_tpu/models/cameras.py`:

  * `GSCamera` + `load_colmap_cameras` — COLMAP-posed training cameras with
    image loading, resize, and white-background compositing.
  * `spherical_c2w` / `gen_tet_camera` — look-at cameras on a sphere with the
    garment-dependent focal scaling and center shifts.
  * `tet_to_colmap_pose` and `tet_mesh_to_colmap` — the pose chain between
    the tet-grid frame (unit cube, anchor-aligned) and the COLMAP
    reconstruction frame via anchor centroid/scale, a rotation, and the
    sdfstudio→colmap axis swap.
  * Ring samplers `sample_ring_cameras` (3 elevations × 8/12/12 azimuths)
    and `sample_circle_cameras` (60-view turntable).
  * `transfer_pcd_color` — SfM-point k-NN color seeding.

All host-side numpy but `transfer_pcd_color`'s distance matrix; a camera
becomes device tensors through `GSCamera.raster_camera(device)`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from youreditableavatar_tpu_torch.models.colmap import (
    camera_intrinsics,
    load_sparse_model,
    qvec_to_rotmat,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.types import RasterCamera
from youreditableavatar_tpu_torch.utils.device import resolve_device

# Fixed axis swap between the sdfstudio training frame and COLMAP.
SDFSTUDIO_TO_COLMAP = np.array(
    [
        [-0.0, 1.0, 0.0, 0.0],
        [1.0, 0.0, -0.0, -0.0],
        [-0.0, -0.0, -1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


@dataclasses.dataclass
class GSCamera:
    """A posed pinhole camera (3DGS convention: R = cam→world rotation)."""

    R: np.ndarray  # (3, 3) c2w rotation
    T: np.ndarray  # (3,) w2c translation
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    name: str = ""
    image: Optional[np.ndarray] = None  # (H, W, 3) float32 in [0, 1]
    mask: Optional[np.ndarray] = None  # (H, W) float32

    @property
    def viewmat(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.R.T
        m[:3, 3] = self.T
        return m

    @property
    def c2w(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.R
        m[:3, 3] = -self.R @ self.T
        return m

    @property
    def campos(self) -> np.ndarray:
        return -self.R @ self.T

    def raster_camera(self, device=None) -> RasterCamera:
        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return RasterCamera(
            viewmat=f32(self.viewmat), fx=f32(self.fx), fy=f32(self.fy),
            cx=f32(self.cx), cy=f32(self.cy),
            width=self.width, height=self.height,
        )

    def resized(self, factor: float) -> "GSCamera":
        w = int(round(self.width * factor))
        h = int(round(self.height * factor))
        return dataclasses.replace(
            self,
            fx=self.fx * w / self.width,
            fy=self.fy * h / self.height,
            cx=self.cx * w / self.width,
            cy=self.cy * h / self.height,
            width=w,
            height=h,
        )


def load_colmap_cameras(
    source_path: str,
    images_dir: str = "images",
    masks_dir: Optional[str] = None,
    downscale: float = 1.0,
    white_background: bool = True,
    load_images: bool = True,
) -> List[GSCamera]:
    """Load COLMAP-posed cameras (+frames) like `load_gs_cameras`.

    Images with an alpha/mask are composited onto white when
    `white_background` (`cameras.py:144-160` behavior).
    """
    sparse = os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    cams, images, _ = load_sparse_model(sparse)

    out: List[GSCamera] = []
    for img in sorted(images.values(), key=lambda im: im.name):
        cam = cams[img.camera_id]
        fx, fy, cx, cy = camera_intrinsics(cam)
        gs = GSCamera(
            R=qvec_to_rotmat(img.qvec).T,
            T=img.tvec.astype(np.float32),
            fx=fx, fy=fy, cx=cx, cy=cy,
            width=cam.width, height=cam.height,
            name=img.name,
        )
        if downscale != 1.0:
            gs = gs.resized(1.0 / downscale)
        if load_images:
            path = os.path.join(source_path, images_dir, img.name)
            if os.path.exists(path):
                import imageio.v2 as imageio

                arr = np.asarray(imageio.imread(path)).astype(np.float32) / 255
                if arr.ndim == 2:
                    arr = arr[..., None].repeat(3, -1)
                if arr.shape[-1] == 4:
                    alpha = arr[..., 3:4]
                    rgb = arr[..., :3]
                    if white_background:
                        rgb = rgb * alpha + (1 - alpha)
                    arr = rgb
                    gs.mask = alpha[..., 0]
                if arr.shape[0] != gs.height or arr.shape[1] != gs.width:
                    arr = _resize_image(arr, gs.height, gs.width)
                gs.image = arr
            if masks_dir is not None:
                mpath = os.path.join(source_path, masks_dir, img.name)
                if os.path.exists(mpath):
                    import imageio.v2 as imageio

                    m = np.asarray(imageio.imread(mpath)).astype(np.float32)
                    m = m / 255 if m.max() > 1 else m
                    if m.ndim == 3:
                        m = m[..., 0]
                    gs.mask = _resize_image(m[..., None], gs.height,
                                            gs.width)[..., 0]
        out.append(gs)
    return out


def _resize_image(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize (numpy; images load on host)."""
    ys = np.linspace(0, arr.shape[0] - 1, h)
    xs = np.linspace(0, arr.shape[1] - 1, w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, arr.shape[0] - 1)
    x1 = np.minimum(x0 + 1, arr.shape[1] - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = arr[y0][:, x0] * (1 - wy) * (1 - wx)
    b = arr[y0][:, x1] * (1 - wy) * wx
    c = arr[y1][:, x0] * wy * (1 - wx)
    d = arr[y1][:, x1] * wy * wx
    return (a + b + c + d).astype(arr.dtype)


def train_test_split(
    cameras: Sequence[GSCamera], eval_every: int = 8
) -> Tuple[List[GSCamera], List[GSCamera]]:
    """Every-8th eval split (`gs_model.py:102-114`)."""
    train = [c for i, c in enumerate(cameras) if i % eval_every != 0]
    test = [c for i, c in enumerate(cameras) if i % eval_every == 0]
    return train, test


def spherical_c2w(elevation_deg: float, azimuth_deg: float, radius: float,
                  center: np.ndarray | None = None,
                  up: np.ndarray | None = None) -> np.ndarray:
    """Look-at c2w with columns [right, up, −lookat]; scene-up is +z."""
    el = np.deg2rad(elevation_deg)
    az = np.deg2rad(azimuth_deg)
    pos = radius * np.array(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)]
    )
    center = np.zeros(3) if center is None else np.asarray(center, np.float64)
    up = np.array([0.0, 0.0, 1.0]) if up is None else np.asarray(up)
    lookat = center - pos
    lookat = lookat / np.linalg.norm(lookat)
    right = np.cross(lookat, up)
    right = right / np.linalg.norm(right)
    up2 = np.cross(right, lookat)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up2, -lookat], axis=-1)
    c2w[:3, 3] = pos
    return c2w


# Focal scale + vertical center shift per crop type.
SAMPLE_TYPE_PARAMS = {
    "full": (1.4, -0.05),
    "upper": (2.2, +0.3),
    "lower": (1.8, -0.3),
}


def gen_tet_camera(idx: int, radius: float, elevation_deg: float,
                   azimuth_deg: float, fov_deg: float, height: int,
                   sample_type: str = "full") -> Tuple[np.ndarray, float]:
    """(c2w, focal_px) for probe views; the first two use full framing."""
    scale, z_shift = SAMPLE_TYPE_PARAMS["full" if idx < 2 else sample_type]
    c2w = spherical_c2w(elevation_deg, azimuth_deg, radius,
                        np.array([0.0, 0.0, z_shift]))
    focal = 0.5 * height / np.tan(0.5 * np.deg2rad(fov_deg))
    return c2w, float(scale * focal)


def tet_to_colmap_pose(
    c2w: np.ndarray,
    anchor_centroid: np.ndarray,
    mesh_scale: float,
    shape_init_params: float = 0.9,
    y_offset: float = 0.3,
) -> np.ndarray:
    """Map tet-frame c2w poses into the reconstruction frame
    (`convert_mesh_init`, `cameras.py:225-279`).

    The tet frame is the anchor mesh recentred (− centroid, + y_offset in y),
    rotated up-y→up-z / front-z→front-x, and scaled to |v|∞ = shape_init_params.
    Cameras go through the inverse chain.
    """
    # std2mesh for up=+y, front=+z: x_=front(+z)... columns [x_, y_, z_]ᵀ.
    x_ = np.array([0.0, 0.0, 1.0])
    z_ = np.array([0.0, 1.0, 0.0])
    y_ = np.cross(z_, x_)
    std2mesh = np.stack([x_, y_, z_], axis=0).T

    out = np.array(c2w, dtype=np.float64, copy=True)
    pose = std2mesh @ out[:3, :4]
    out[:3, :4] = pose * mesh_scale / shape_init_params
    out[:3, 3] = out[:3, 3] + np.asarray(anchor_centroid)
    out[1, 3] -= y_offset
    out[3, 3] = 1.0
    return out


def tet_mesh_to_colmap(
    verts: np.ndarray, worldtogt: np.ndarray, rotation: np.ndarray
) -> np.ndarray:
    """Transform tet-frame mesh vertices into the COLMAP frame
    (`trans_gs_mesh`, `general_utils.py:60-81`): R⁻¹, worldtogt, axis swap."""
    r_inv = np.linalg.inv(rotation)
    v = np.hstack([verts, np.ones((len(verts), 1))])
    v = (r_inv @ v.T).T
    v = v @ np.asarray(worldtogt).T
    v = v @ SDFSTUDIO_TO_COLMAP
    return v[:, :3]


def c2w_to_gs_camera(c2w: np.ndarray, focal: float, width: int, height: int,
                     name: str = "") -> GSCamera:
    """OpenGL-style look-at c2w → COLMAP-convention GSCamera."""
    gl2cv = np.diag([1.0, -1.0, -1.0])
    r_c2w = c2w[:3, :3] @ gl2cv
    t_c2w = c2w[:3, 3]
    r_w2c = r_c2w.T
    t_w2c = -r_w2c @ t_c2w
    return GSCamera(
        R=r_c2w.astype(np.float32),
        T=t_w2c.astype(np.float32),
        fx=focal, fy=focal,
        cx=(width - 1) / 2.0, cy=(height - 1) / 2.0,
        width=width, height=height, name=name,
    )


def sample_ring_cameras(
    radius: float = 2.7,
    elevations: Sequence[float] = (5.0, 25.0, -20.0),
    counts: Sequence[int] = (8, 12, 12),
    fov_deg: float = 50.0,
    height: int = 2048,
    width: int = 2048,
    sample_type: str = "full",
    pose_transform=None,
) -> List[GSCamera]:
    """The 3-ring view set (elevations × evenly spaced azimuths)."""
    out = []
    idx = 0
    for elev, n in zip(elevations, counts):
        for k in range(n):
            c2w, focal = gen_tet_camera(idx, radius, elev, 360.0 * k / n,
                                        fov_deg, height, sample_type)
            if pose_transform is not None:
                c2w = pose_transform(c2w)
            out.append(c2w_to_gs_camera(c2w, focal, width, height,
                                        name=f"ring{idx:03d}"))
            idx += 1
    return out


def sample_circle_cameras(
    num_views: int = 60,
    radius: float = 2.7,
    elevation_deg: float = 5.0,
    fov_deg: float = 50.0,
    height: int = 2048,
    width: int = 2048,
    sample_type: str = "full",
    pose_transform=None,
) -> List[GSCamera]:
    """60-view turntable (`sample_circle_gs_cameras`)."""
    out = []
    for k in range(num_views):
        az = 360.0 * k / num_views
        c2w, focal = gen_tet_camera(
            2, radius, elevation_deg, az, fov_deg, height, sample_type
        )
        if pose_transform is not None:
            c2w = pose_transform(c2w)
        out.append(
            c2w_to_gs_camera(c2w, focal, width, height, name=f"circle{k:04d}")
        )
    return out


def transfer_pcd_color(
    sparse_points: np.ndarray,
    sparse_colors: np.ndarray,
    dense_points: np.ndarray,
    k: int = 20,
    white_threshold: float = 0.95,
    device=None,
) -> np.ndarray:
    """k-NN color transfer from the SfM cloud, as one distance matrix and
    a top-k instead of a per-point KD-tree loop."""
    non_white = ~np.all(sparse_colors > white_threshold, axis=1)
    pts = sparse_points[non_white]
    cols = sparse_colors[non_white]
    if len(pts) == 0:
        return np.full((len(dense_points), 3), 0.5)

    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(dense_points, np.float32), device=dev)
    s = torch.as_tensor(np.asarray(pts, np.float32), device=dev)
    d2 = (
        torch.sum(q**2, -1)[:, None]
        + torch.sum(s**2, -1)[None, :]
        - 2.0 * q @ s.T
    )
    k = min(k, len(pts))
    idx = torch.topk(-d2, k, dim=-1).indices
    c = torch.as_tensor(np.asarray(cols, np.float32), device=dev)
    return torch.mean(c[idx], dim=1).cpu().numpy()
