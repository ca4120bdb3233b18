"""Winding-number shape-guidance loss.

Counterpart of `youreditableavatar_tpu/ops/shape_loss.py`: a guide mesh
defines target occupancy; the field's occupancy is pulled toward the
winding-number indicator with a binary cross-entropy, down-weighted near
the guide surface by a Gaussian of the point-to-mesh distance.

The exact generalized winding number is the van Oosterom–Strackee
solid-angle formula summed over every triangle: a dense (points, faces)
computation, taken `chunk` points at a time. Each (point, face) entry
holds ~80 B of intermediates, so where the JAX package's 2048 points
against 81,920 faces would need ~13 GB, the default chunk here keeps one
chunk's intermediates within `CHUNK_BYTES`; the result does not depend on
the chunk. The proximity weight uses the native `MeshSDF` distance
(host-side).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from youreditableavatar_tpu_torch.utils.device import resolve_device

CHUNK_BYTES = 1 << 30  # a default chunk's intermediates
BYTES_PER_PAIR = 80  # intermediates per (point, face)


def default_chunk(num_faces: int) -> int:
    """Points per chunk whose (chunk, F) intermediates fit CHUNK_BYTES."""
    return int(max(1, min(2048, CHUNK_BYTES // (BYTES_PER_PAIR
                                                 * max(num_faces, 1)))))


def winding_number(points: Tensor, verts: Tensor, faces: Tensor,
                   chunk: Optional[int] = None) -> Tensor:
    """Generalized winding number of each point w.r.t. the mesh.

    points: (P, 3); verts: (V, 3); faces: (F, 3) int. Returns (P,) — ≈1
    inside a watertight mesh, ≈0 outside. `chunk` points are evaluated at
    a time (default: `default_chunk(F)`).
    """
    tri = verts[faces.long()]  # (F, 3, 3)
    chunk = chunk or default_chunk(tri.shape[0])
    out = []
    for start in range(0, points.shape[0], chunk):
        p = points[start:start + chunk, None, :]  # (c, 1, 3)
        a, b, c = tri[None, :, 0] - p, tri[None, :, 1] - p, tri[None, :, 2] - p
        la, lb, lc = (torch.linalg.norm(x, dim=-1) for x in (a, b, c))
        det = torch.sum(a * torch.linalg.cross(b, c, dim=-1), -1)
        denom = (la * lb * lc + torch.sum(a * b, -1) * lc
                 + torch.sum(b * c, -1) * la + torch.sum(c * a, -1) * lb)
        out.append(torch.sum(2.0 * torch.atan2(det, denom), -1))
    if not out:
        return points.new_zeros((0,))
    return torch.cat(out) / (4.0 * np.pi)


class ShapeLoss:
    """BCE between field occupancy and guide-mesh winding occupancy:
    indicator = w > 0.5, occupancy = 1 − exp(−δ·σ), weight = 1 −
    exp(−d²/(2·s²)) so points near the guide surface are unconstrained
    (σ there is supervised by rendering)."""

    def __init__(
        self,
        verts: np.ndarray,
        faces: np.ndarray,
        mesh_scale: float = 0.7,
        proximal_surface: float = 0.3,
        delta: float = 0.2,
        device=None,
    ):
        self.device = resolve_device(device)
        v = np.asarray(verts, np.float32)
        center = 0.5 * (v.max(0) + v.min(0))
        scale = mesh_scale / max(np.abs(v - center).max(), 1e-9)
        v = (v - center) * scale
        self.verts = torch.as_tensor(v, device=self.device)
        self.faces = torch.as_tensor(np.asarray(faces, np.int64).astype(np.int32),
                                     device=self.device)
        self.proximal_surface = proximal_surface
        self.delta = delta
        self._meshsdf = None
        if proximal_surface > 0:
            from youreditableavatar_tpu_torch.native import MeshSDF

            self._meshsdf = MeshSDF(v, np.asarray(faces, np.int64))

    def proximity_weight(self, points: np.ndarray) -> np.ndarray:
        """Host-side: 1 − gaussian(distance)."""
        if self._meshsdf is None:
            return np.ones(len(points), np.float32)
        d = np.abs(self._meshsdf(np.asarray(points, np.float32)))
        s = self.proximal_surface
        return (1.0 - np.exp(-(d * d) / (2.0 * s * s))).astype(np.float32)

    def __call__(self, points: Tensor, sigmas: Tensor,
                 weight: Optional[Tensor] = None) -> Tensor:
        """points (P, 3), sigmas (P,) densities → scalar BCE loss."""
        with torch.no_grad():
            w = winding_number(points, self.verts, self.faces)
        indicator = (w > 0.5).to(torch.float32)
        occ = torch.clamp(1.0 - torch.exp(-self.delta * sigmas), 0.0, 1.1)
        ce = -(indicator * torch.log(torch.clamp(occ, 1e-6, 1.0))
               + (1.0 - indicator) * torch.log(torch.clamp(1.0 - occ, 1e-6,
                                                           1.0)))
        if weight is not None:
            ce = ce * weight
        return torch.mean(ce)
