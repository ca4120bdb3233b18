"""Triangle-mesh container: lazy normals, tangents, UV atlas, cleanup.

Counterpart of `youreditableavatar_tpu/models/mesh.py`: a v_pos /
t_pos_idx container with cached vertex normals, a chart-based UV unwrap
(normal-cone region growing, planar projection, a rasterized self-overlap
check that bisects overlapping charts, shelf packing at one global scale),
tangent frames from the UV parameterization, outlier removal and the
normal-consistency regularizer.

Everything but the regularizer is host NumPy, the same code as the JAX
package's (it runs once per mesh, between stages); `normal_consistency`
builds the mesh as tensors on a device and calls
`models.part_renderer.normal_consistency`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from youreditableavatar_tpu_torch.utils.device import resolve_device


def _cross2(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """z of the cross product of 2-D vectors (`np.cross`'s 2-D case)."""
    return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]


def _chart_self_overlaps(
    uv: np.ndarray, tri: np.ndarray, res: int = 384
) -> bool:
    """True if any two triangles' open interiors share a sample point.

    Point-in-triangle at pixel centers is exact for overlap detection (a
    point strictly inside two triangles ⇒ genuine overlap; shared edges
    and vertices never trigger). Thin slivers below sample spacing can be
    missed — acceptable for chart-splitting heuristics.
    """
    lo = uv.min(0)
    span = float((uv.max(0) - lo).max()) + 1e-12
    p = (uv - lo) / span * (res - 1)
    count = np.zeros((res, res), np.int32)
    a, b, c = p[tri[:, 0]], p[tri[:, 1]], p[tri[:, 2]]
    for i in range(len(tri)):
        xmin = int(max(np.floor(min(a[i, 0], b[i, 0], c[i, 0])), 0))
        xmax = int(min(np.ceil(max(a[i, 0], b[i, 0], c[i, 0])), res - 1))
        ymin = int(max(np.floor(min(a[i, 1], b[i, 1], c[i, 1])), 0))
        ymax = int(min(np.ceil(max(a[i, 1], b[i, 1], c[i, 1])), res - 1))
        if xmax < xmin or ymax < ymin:
            continue
        xs, ys = np.meshgrid(
            np.arange(xmin, xmax + 1), np.arange(ymin, ymax + 1)
        )
        q = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64)
        d0, d1, d2 = b[i] - a[i], c[i] - b[i], a[i] - c[i]
        s0 = _cross2(d0, q - a[i])
        s1 = _cross2(d1, q - b[i])
        s2 = _cross2(d2, q - c[i])
        area2 = abs(float(_cross2(b[i] - a[i], c[i] - a[i]))) + 1e-30
        eps = 1e-6 * area2
        inside = ((s0 > eps) & (s1 > eps) & (s2 > eps)) | (
            (s0 < -eps) & (s1 < -eps) & (s2 < -eps)
        )
        count[q[inside, 1].astype(int), q[inside, 0].astype(int)] += 1
        if count.max() > 1:
            return True
    return False


def _shelf_pack(sizes: np.ndarray, padding: float) -> np.ndarray:
    """Shelf-pack rects (C, 2) (already scaled) into [0, ~1]²; returns
    lower-left offsets in input order. Caller validates the fit."""
    order = np.argsort(-sizes[:, 1], kind="stable")
    offs = np.zeros_like(sizes)
    x = y = shelf_h = 0.0
    for i in order:
        w, h = float(sizes[i, 0]), float(sizes[i, 1])
        if x > 0 and x + w + 2 * padding > 1.0:
            y += shelf_h
            x = 0.0
            shelf_h = 0.0
        offs[i] = (x + padding, y + padding)
        x += w + 2 * padding
        shelf_h = max(shelf_h, h + 2 * padding)
    return offs


def _shelf_pack_scale(sizes: np.ndarray, padding: float) -> float:
    """Largest-ish single scale at which the shelf packing fits [0,1]²."""

    def fits(s: float) -> bool:
        sc = sizes * s
        if (sc[:, 0] + 2 * padding > 1.0).any():
            return False
        offs = _shelf_pack(sc, padding)
        return float((offs + sc).max()) + padding <= 1.0

    total = float((sizes[:, 0] * sizes[:, 1]).sum()) + 1e-20
    s = min(
        np.sqrt(0.8 / total),
        (1.0 - 2 * padding) / (float(sizes[:, 0].max()) + 1e-20),
    )
    while not fits(s):
        s *= 0.92
    return s


@dataclasses.dataclass
class Mesh:
    v_pos: np.ndarray  # (V, 3) float32
    t_pos_idx: np.ndarray  # (F, 3) int64
    _v_nrm: Optional[np.ndarray] = None
    _v_tex: Optional[np.ndarray] = None  # (Vt, 2)
    _t_tex_idx: Optional[np.ndarray] = None  # (F, 3)
    _v_tng: Optional[np.ndarray] = None

    # ------------------------------------------------------------ normals

    @property
    def v_nrm(self) -> np.ndarray:
        if self._v_nrm is None:
            self._v_nrm = self._compute_vertex_normals()
        return self._v_nrm

    def _compute_vertex_normals(self) -> np.ndarray:
        v, f = self.v_pos, self.t_pos_idx
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, f[:, k], fn)
        n = np.linalg.norm(vn, axis=-1, keepdims=True)
        return (vn / np.maximum(n, 1e-20)).astype(np.float32)

    # ------------------------------------------------------------ UV atlas

    @property
    def v_tex(self) -> np.ndarray:
        if self._v_tex is None:
            self.unwrap_uv()
        return self._v_tex

    @property
    def t_tex_idx(self) -> np.ndarray:
        if self._t_tex_idx is None:
            self.unwrap_uv()
        return self._t_tex_idx

    def unwrap_uv(
        self,
        padding: float = 0.01,
        cone_angle_deg: float = 60.0,
        max_chart_faces: int = 20000,
    ) -> None:
        """Chart-based UV atlas (xatlas role, `mesh.py:215-255`).

        1. Region-grow charts over face adjacency under a normal-cone
           constraint (every face normal within `cone_angle_deg` of the
           chart's running mean normal) — the xatlas segmentation role.
        2. Planar-project each chart onto its mean-normal plane (front-
           facing by construction, so triangles never flip).
        3. Rasterize-check each chart for global self-overlap (an S-shaped
           patch can still collide); overlapping charts are bisected along
           their principal axis and re-checked.
        4. Shelf-pack chart rectangles into [0,1]² at ONE global scale
           (uniform texel density) with `padding` gutters.

        Charts are seam-correct (vertices duplicated per chart) and feed
        the same tangent-frame math as the reference's xatlas output.
        """
        v, f = self.v_pos, self.t_pos_idx
        nf = len(f)
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        fn = fn / np.maximum(
            np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20
        )
        cos_cone = np.cos(np.deg2rad(cone_angle_deg))

        # --- face adjacency over shared (undirected) edges
        ea = f[:, [0, 1, 2]].reshape(-1)
        eb = f[:, [1, 2, 0]].reshape(-1)
        ekey = (np.minimum(ea, eb).astype(np.int64) << 32) | np.maximum(
            ea, eb
        ).astype(np.int64)
        order = np.argsort(ekey, kind="stable")
        sk, sface = ekey[order], order // 3
        same = sk[1:] == sk[:-1]
        pa, pb = sface[:-1][same], sface[1:][same]
        nbr = [[] for _ in range(nf)]
        for a, b in zip(pa, pb):
            nbr[a].append(b)
            nbr[b].append(a)

        # --- normal-cone region growing
        chart_of = np.full(nf, -1, np.int64)
        charts: list[np.ndarray] = []
        for seed in range(nf):
            if chart_of[seed] >= 0:
                continue
            cid = len(charts)
            nsum = fn[seed].copy()
            members = [seed]
            chart_of[seed] = cid
            queue = [seed]
            while queue and len(members) < max_chart_faces:
                cur = queue.pop()
                nmean = nsum / max(np.linalg.norm(nsum), 1e-20)
                for g in nbr[cur]:
                    if chart_of[g] >= 0:
                        continue
                    if fn[g] @ nmean < cos_cone:
                        continue
                    chart_of[g] = cid
                    nsum += fn[g]
                    members.append(g)
                    queue.append(g)
            charts.append(np.asarray(members))

        # --- project, overlap-split, collect (uv per chart, local faces)
        out_charts = []  # (uv (Vc,2) world-scale, tri (Fc,3), orig faces)
        stack = charts
        while stack:
            members = stack.pop()
            nsum = fn[members].sum(0)
            n = nsum / max(np.linalg.norm(nsum), 1e-20)
            t = np.cross(n, [0.0, 0.0, 1.0])
            if np.linalg.norm(t) < 1e-6:
                t = np.cross(n, [0.0, 1.0, 0.0])
            t /= np.linalg.norm(t)
            b = np.cross(n, t)
            used, inv = np.unique(
                f[members].reshape(-1), return_inverse=True
            )
            uv = np.stack(
                [v[used] @ t, v[used] @ b], axis=-1
            ).astype(np.float64)
            tri = inv.reshape(-1, 3)
            if len(members) > 1 and _chart_self_overlaps(uv, tri):
                # bisect along the longer in-plane axis by face centroid
                cen = uv[tri].mean(1)
                ax = int(np.argmax(uv.max(0) - uv.min(0)))
                cut = np.median(cen[:, ax])
                left = members[cen[:, ax] <= cut]
                right = members[cen[:, ax] > cut]
                if len(left) and len(right):
                    stack.append(left)
                    stack.append(right)
                    continue
            out_charts.append((uv, tri, members))

        # --- shelf-pack at one global scale
        rects = []
        for uv, tri, members in out_charts:
            lo, hi = uv.min(0), uv.max(0)
            rects.append((hi - lo)[None])
        sizes = np.concatenate(rects, axis=0)  # (C, 2) world units
        scale = _shelf_pack_scale(sizes, padding)
        offsets = _shelf_pack(sizes * scale, padding)

        uvs, tidx = [], np.zeros_like(f)
        base = 0
        for (uv, tri, members), off in zip(out_charts, offsets):
            p2 = (uv - uv.min(0)) * scale + off
            uvs.append(p2.astype(np.float32))
            tidx[members] = tri + base
            base += uv.shape[0]
        self._v_tex = np.concatenate(uvs, axis=0)
        self._t_tex_idx = tidx.astype(np.int64)
        self._v_tng = None  # tangents depend on the parameterization

    # ------------------------------------------------------------ tangents

    @property
    def v_tng(self) -> np.ndarray:
        if self._v_tng is None:
            self._v_tng = self._compute_vertex_tangents()
        return self._v_tng

    def _compute_vertex_tangents(self) -> np.ndarray:
        """Per-vertex tangent of the UV parameterization
        (`mesh.py:257-300`): solve dP = T·du + B·dv per face, average onto
        vertices, Gram-Schmidt against the normal."""
        v, f = self.v_pos, self.t_pos_idx
        uv, ft = self.v_tex, self.t_tex_idx
        p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        t0, t1, t2 = uv[ft[:, 0]], uv[ft[:, 1]], uv[ft[:, 2]]
        e1, e2 = p1 - p0, p2 - p0
        d1, d2 = t1 - t0, t2 - t0
        det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
        det = np.where(np.abs(det) < 1e-12, 1e-12, det)
        tang = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) / det[:, None]
        vt = np.zeros_like(v)
        for k in range(3):
            np.add.at(vt, f[:, k], tang)
        n = self.v_nrm
        vt = vt - n * np.sum(vt * n, axis=-1, keepdims=True)
        l = np.linalg.norm(vt, axis=-1, keepdims=True)
        fallback = np.cross(n, np.array([0.0, 0.0, 1.0], np.float32))
        fb_l = np.linalg.norm(fallback, axis=-1, keepdims=True)
        fallback = np.where(fb_l > 1e-6, fallback / np.maximum(fb_l, 1e-20),
                            np.array([1.0, 0.0, 0.0], np.float32))
        return np.where(l > 1e-8, vt / np.maximum(l, 1e-20),
                        fallback).astype(np.float32)

    # ------------------------------------------------------------ cleanup

    def remove_outliers(self, min_fraction: float = 0.1) -> "Mesh":
        """Keep face components ≥ min_fraction of the largest (trimesh
        outlier removal role, `mesh.py:80-110`)."""
        from youreditableavatar_tpu_torch.stages.export import remove_floaters

        keep = remove_floaters(self.v_pos, self.t_pos_idx,
                               min_fraction=min_fraction)
        f = self.t_pos_idx[keep]
        used, inv = np.unique(f.reshape(-1), return_inverse=True)
        return Mesh(self.v_pos[used].copy(),
                    inv.reshape(-1, 3).astype(np.int64))

    # ------------------------------------------------------------ losses

    def normal_consistency(self, device=None) -> Tensor:
        """Mean (1 − cos) between unit normals of edge-adjacent faces, on
        `device` (`models.part_renderer.normal_consistency`)."""
        from youreditableavatar_tpu_torch.models.part_renderer import (
            normal_consistency as nc,
        )
        from youreditableavatar_tpu_torch.ops.marching_tets import MTOutput

        dev = resolve_device(device)
        nv, nf = len(self.v_pos), len(self.t_pos_idx)
        zeros = torch.zeros(nv, dtype=torch.int32, device=dev)
        mt = MTOutput(
            verts=torch.as_tensor(self.v_pos, dtype=torch.float32, device=dev),
            verts_valid=torch.ones(nv, dtype=torch.bool, device=dev),
            faces=torch.as_tensor(self.t_pos_idx, dtype=torch.int32,
                                  device=dev),
            faces_valid=torch.ones(nf, dtype=torch.bool, device=dev),
            face_to_tet=torch.zeros(nf, dtype=torch.int32, device=dev),
            num_verts=torch.tensor(nv, dtype=torch.int32, device=dev),
            num_faces=torch.tensor(nf, dtype=torch.int32, device=dev),
            edge_lo=zeros,
            edge_hi=zeros,
        )
        return nc(mt)
