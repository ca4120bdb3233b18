# Frozen copy of the back-projection and region refinement of youreditableavatar_tpu_torch/stages/localization.py, with ops/morphology.py's mesh-region sweeps, stages/export.py's floater removal and models/cameras.py's ring cameras.
"""The localization stage after segmentation, as plain PyTorch and numpy:
each probe view's face ids from the mesh rasterizer (the plain resolve of
`mesh_raster.py`), the votes of the views' 2D masks, dilation and erosion
over shared edges, and the removal of floating components. Where the
reference (`mesh_localization.py`) casts rays with open3d and refines with
pymeshlab, this takes the rasterizer's per-pixel face ids and numpy sweeps
over the face adjacency, as the port does."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from benchmark.reference.cameras import GSCamera, c2w_to_gs_camera
from benchmark.reference.mesh_raster import MeshRasterConfig, rasterize_mesh

# Focal scale and vertical centre shift of the "full" framing.
FULL_FRAMING = (1.4, -0.05)


def _spherical_c2w(elevation_deg, azimuth_deg, radius, center):
    el, az = np.deg2rad(elevation_deg), np.deg2rad(azimuth_deg)
    pos = radius * np.array(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    up = np.array([0.0, 0.0, 1.0])
    lookat = np.asarray(center, np.float64) - pos
    lookat = lookat / np.linalg.norm(lookat)
    right = np.cross(lookat, up)
    right = right / np.linalg.norm(right)
    up2 = np.cross(right, lookat)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, up2, -lookat], axis=-1)
    c2w[:3, 3] = pos
    return c2w


def ring_cameras(radius: float, elevations: Sequence[float],
                 counts: Sequence[int], fov_deg: float,
                 size: int) -> list:
    """The probe rings: per elevation, `count` evenly spaced azimuths from
    0, framed whole."""
    scale, z_shift = FULL_FRAMING
    focal = scale * 0.5 * size / np.tan(0.5 * np.deg2rad(fov_deg))
    return [c2w_to_gs_camera(
        _spherical_c2w(el, 360.0 * k / n, radius, [0.0, 0.0, z_shift]),
        float(focal), size, size)
        for el, n in zip(elevations, counts) for k in range(n)]


def face_adjacency(faces: np.ndarray) -> np.ndarray:
    f = np.asarray(faces)
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    edges_sorted = np.sort(edges, axis=1)
    keys = edges_sorted[:, 0].astype(np.int64) * (1 << 31) + edges_sorted[:, 1]
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    face_of = order % len(f)
    nbr = np.full(len(keys), -1, np.int64)
    same = ks[1:] == ks[:-1]
    i = np.flatnonzero(same)
    nbr[order[i]] = face_of[i + 1]
    nbr[order[i + 1]] = face_of[i]
    return nbr.reshape(3, len(f)).T.astype(np.int32)


def dilate_face_region(faces, face_mask, iterations: int):
    adj = face_adjacency(faces)
    m = np.asarray(face_mask, bool).copy()
    for _ in range(iterations):
        nbr_sel = np.zeros_like(m)
        for k in range(3):
            valid = adj[:, k] >= 0
            nbr_sel[valid] |= m[adj[valid, k]]
        m = m | nbr_sel
    return m


def erode_face_region(faces, face_mask, iterations: int):
    return ~dilate_face_region(faces, ~np.asarray(face_mask, bool), iterations)


def face_components(faces: np.ndarray, num_verts: int) -> np.ndarray:
    parent = np.arange(num_verts)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in faces:
        r0 = find(f[0])
        r1 = find(f[1])
        r2 = find(f[2])
        parent[r1] = r0
        parent[r2] = r0
    roots = np.array([find(v) for v in faces[:, 0]])
    _, comp = np.unique(roots, return_inverse=True)
    return comp


def remove_floaters(verts, faces, min_fraction: float) -> np.ndarray:
    if len(faces) == 0:
        return np.zeros((0,), bool)
    comp = face_components(faces, len(verts))
    counts = np.bincount(comp)
    good = np.flatnonzero(counts >= max(1, int(len(faces) * min_fraction)))
    return np.isin(comp, good)


def backproject(verts: np.ndarray, faces: np.ndarray,
                cameras: Sequence[GSCamera], masks: Sequence[np.ndarray],
                mesh_cfg: MeshRasterConfig, min_views: int,
                dilate_iters: int, erode_iters: int,
                floater_min_fraction: float, device) -> np.ndarray:
    """The (F,) bool face mask that the views' (H, W) masks select."""
    faces = np.asarray(faces, np.int64)
    votes = np.zeros(len(faces), np.int32)
    seen = np.zeros(len(faces), np.int32)
    vt = torch.tensor(np.asarray(verts, np.float32), device=device)
    ft = torch.tensor(faces.astype(np.int32), device=device)
    for cam, mask2d in zip(cameras, masks):
        fid = rasterize_mesh(vt, ft, cam.raster_camera(device),
                             mesh_cfg).face_id.cpu().numpy()
        vis = fid >= 0
        seen[np.unique(fid[vis])] += 1
        votes[np.unique(fid[vis & np.asarray(mask2d, bool)])] += 1
    fmask = votes >= np.minimum(min_views, np.maximum(seen, 1))
    fmask = dilate_face_region(faces, fmask, dilate_iters)
    fmask = erode_face_region(faces, fmask, erode_iters)
    sel = np.flatnonzero(fmask)
    if len(sel):
        keep = remove_floaters(verts, faces[sel], floater_min_fraction)
        fmask = np.zeros_like(fmask)
        fmask[sel[keep]] = True
    return fmask
