# Frozen copy of youreditableavatar_tpu_torch/ops/mesh_raster/interpolate.py (the plain PyTorch path only).
"""Differentiable attribute interpolation + soft silhouette over frozen visibility.

Counterpart of `youreditableavatar_tpu/ops/mesh_raster/interpolate.py`:
given the discrete `RasterOutput` (face ids fixed by the z-buffer),
recompute barycentrics differentiably from the vertex positions and blend
attributes with perspective correction — autograd then provides exact
gradients to vertex positions and attributes through the visible-surface
parameterization. The soft silhouette alpha provides boundary gradients for
mask losses via a signed-distance band around each visible face's edges.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from benchmark.reference.mesh_raster import RasterOutput
from benchmark.reference.gather import (
    gather_rows, scatter_add_rows)


def _pixel_grid(height: int, width: int, device) -> Tuple[Tensor, Tensor]:
    px = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    py = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    return px.expand(height, width), py.expand(height, width)


def _visible_corners(out: RasterOutput, faces: Tensor):
    """`corner(x, i)`: rows of the per-vertex `x` at the i-th corner of
    each pixel's visible face, (H, W, ...). Background pixels read face 0's
    corners; they are the gathers' padding slots."""
    f = faces.long()
    background = out.face_id < 0
    tri = f.index_select(0, torch.clamp(out.face_id, min=0).reshape(-1).long())

    def corner(x: Tensor, i: int) -> Tensor:
        return gather_rows(x, tri[:, i].reshape(out.face_id.shape),
                           pad=background, pad_row=f[0, i])

    return corner


def recompute_barycentrics(
    out: RasterOutput, faces: Tensor
) -> Tuple[Tensor, Tensor]:
    """Differentiable (l0, l1, l2) + perspective-corrected variants.

    Returns:
      bary_affine: (H, W, 3) screen-affine barycentrics.
      bary_persp: (H, W, 3) perspective-corrected (for world-space attrs).
    """
    h, w = out.face_id.shape
    corner = _visible_corners(out, faces)
    p0, p1, p2 = (corner(out.verts_screen, i) for i in range(3))
    px, py = _pixel_grid(h, w, out.face_id.device)

    d = (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - (
        p1[..., 1] - p0[..., 1]
    ) * (p2[..., 0] - p0[..., 0])
    ok = torch.abs(d) > 1e-12
    # 1/d only where it is used, so a degenerate face 0 under background
    # pixels gives zero gradients instead of 0 · inf.
    inv_d = torch.where(ok, 1.0 / torch.where(ok, d, torch.ones_like(d)),
                        torch.zeros_like(d))
    l1 = ((px - p0[..., 0]) * (p2[..., 1] - p0[..., 1])
          - (py - p0[..., 1]) * (p2[..., 0] - p0[..., 0])) * inv_d
    l2 = ((py - p0[..., 1]) * (p1[..., 0] - p0[..., 0])
          - (px - p0[..., 0]) * (p1[..., 1] - p0[..., 1])) * inv_d
    l0 = 1.0 - l1 - l2
    bary_affine = torch.stack([l0, l1, l2], dim=-1)

    iw0, iw1, iw2 = (corner(out.verts_zw, i)[..., 1] for i in range(3))
    wsum = l0 * iw0 + l1 * iw1 + l2 * iw2
    wsum = torch.where(torch.abs(wsum) > 1e-12, wsum, torch.ones_like(wsum))
    bary_persp = torch.stack(
        [l0 * iw0 / wsum, l1 * iw1 / wsum, l2 * iw2 / wsum], dim=-1
    )
    return bary_affine, bary_persp


def interpolate_attributes(
    out: RasterOutput,
    faces: Tensor,
    attrs: Tensor,
    background: Union[Tensor, float] = 0.0,
    perspective: bool = True,
) -> Tensor:
    """Blend per-vertex attributes over the visible surface.

    Args:
      out: rasterization result.
      faces: (F, 3) int32.
      attrs: (V, C) per-vertex attributes (differentiable).
      background: value for background pixels.
    Returns:
      (H, W, C) interpolated image.
    """
    bary_a, bary_p = recompute_barycentrics(out, faces)
    bary = bary_p if perspective else bary_a
    corner = _visible_corners(out, faces)
    a0, a1, a2 = (corner(attrs, i) for i in range(3))
    img = a0 * bary[..., 0:1] + a1 * bary[..., 1:2] + a2 * bary[..., 2:3]
    mask = (out.face_id >= 0)[..., None]
    bg = torch.as_tensor(background, dtype=img.dtype, device=img.device)
    return torch.where(mask, img, bg)


def silhouette_alpha(
    out: RasterOutput, faces: Tensor, sharpness: float = 1.0
) -> Tensor:
    """Soft coverage in a ±1-px band around the visible face's edges.

    Per covered pixel, alpha = clamp(0.5 + s·dist_edge, 0, 1) where
    dist_edge is the signed pixel distance to the nearest edge of the
    pixel's visible face (positive inside). Background pixels get 0 —
    gradients flow through the covered rim, which is what mask/opacity
    losses need.
    """
    h, w = out.face_id.shape
    corner = _visible_corners(out, faces)
    p0, p1, p2 = (corner(out.verts_screen, i) for i in range(3))
    px, py = _pixel_grid(h, w, out.face_id.device)

    def edge_dist(a, b):
        ex = b[..., 0] - a[..., 0]
        ey = b[..., 1] - a[..., 1]
        # Signed area of (a, b, p) normalized by edge length → distance.
        cross = ex * (py - a[..., 1]) - ey * (px - a[..., 0])
        return cross / torch.sqrt(ex * ex + ey * ey + 1e-12)

    d0 = edge_dist(p0, p1)
    d1 = edge_dist(p1, p2)
    d2 = edge_dist(p2, p0)
    # Winding may be either sign; orient by the triangle's area sign.
    area = (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - (
        p1[..., 1] - p0[..., 1]
    ) * (p2[..., 0] - p0[..., 0])
    sgn = torch.sign(area).detach()
    dist = torch.minimum(torch.minimum(d0 * sgn, d1 * sgn), d2 * sgn)
    alpha = torch.clamp(0.5 + sharpness * dist, 0.0, 1.0)
    return torch.where(out.face_id >= 0, alpha, torch.zeros_like(alpha))


def compute_vertex_normals(
    verts: Tensor, faces: Tensor, faces_valid: Optional[Tensor] = None
) -> Tensor:
    """Area-weighted vertex normals via scatter-add (`index_add_`).

    Padded faces (`~faces_valid`) are the padding slots of the gathers and
    the scatter: their normals are replaced by zeros, so their gradient
    rows are zero and their adds are dropped."""
    f = faces.long()
    pad = None if faces_valid is None else ~faces_valid
    p0, p1, p2 = (gather_rows(verts, f[:, i], pad=pad,
                              pad_row=0 if pad is None else None)
                  for i in range(3))
    fn = torch.linalg.cross(p1 - p0, p2 - p0)  # area-weighted
    if faces_valid is not None:
        fn = torch.where(faces_valid[:, None], fn, torch.zeros_like(fn))
    vn = scatter_add_rows(verts.shape[0], f.T.reshape(-1), fn.repeat(3, 1),
                          None if pad is None else pad.repeat(3))
    # rsqrt(Σx²+ε) is gradient-safe at 0 (‖·‖ has NaN grad there).
    return vn * torch.rsqrt(torch.sum(vn * vn, dim=-1, keepdim=True) + 1e-20)
