"""Partitioned-surface renderer: local/global normal, opacity, depth maps.

Counterpart of `youreditableavatar_tpu/models/part_renderer.py`: the LOCAL
view rasterizes keep (no gradient) ∥ update meshes and emits camera-space
normal, opacity and depth maps of the edit region; the GLOBAL view
rasterizes the union for the full-body normal map. Built on the port's
mesh rasterizer (the z-buffer resolve is K5); normals and the silhouette
re-attach differentiably in the vertices.

Also provides the budgeted-mesh `normal_consistency` loss: mean over
interior edges of (1 − cos) between adjacent face normals, via the same
sort-rank edge dedup used by marching tets.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor

from youreditableavatar_tpu_torch.models.geometry import concat_meshes
from youreditableavatar_tpu_torch.ops.gaussian_raster.types import RasterCamera
from youreditableavatar_tpu_torch.ops.marching_tets import (
    MTOutput,
    unique_edge_slots,
)
from youreditableavatar_tpu_torch.ops.mesh_raster import (
    MeshRasterConfig,
    compute_vertex_normals,
    interpolate_attributes,
    rasterize_mesh,
)
from youreditableavatar_tpu_torch.ops.mesh_raster.interpolate import (
    silhouette_alpha,
)


def render_geometry_maps(
    verts: Tensor,
    faces: Tensor,
    faces_valid: Tensor,
    camera: RasterCamera,
    cfg: MeshRasterConfig,
    bg_normal: float = 0.5,
) -> Dict[str, Tensor]:
    """Camera-space normal (+[0,1] encoded), opacity, depth for one mesh."""
    out = rasterize_mesh(verts, faces, camera, cfg, faces_valid=faces_valid)
    vn = compute_vertex_normals(verts, faces, faces_valid)
    # Camera-space normals: n_cam = R_w2c @ n.
    r = camera.viewmat[:3, :3]
    vn_cam = vn @ r.T
    normal_img = interpolate_attributes(
        out, faces, vn_cam, background=0.0, perspective=False
    )
    normal_img = normal_img * torch.rsqrt(
        torch.sum(normal_img * normal_img, dim=-1, keepdim=True) + 1e-12
    )
    alpha = silhouette_alpha(out, faces)
    covered = out.face_id >= 0
    mask = covered.to(torch.float32)
    normal_01 = torch.where(
        covered[..., None], normal_img * 0.5 + 0.5,
        torch.full_like(normal_img, bg_normal),
    )
    depth = torch.where(covered, out.depth, torch.zeros_like(out.depth))
    return {
        "normal": normal_img,
        "comp_normal": normal_01,
        "opacity": alpha,
        "mask": mask,
        "depth": depth,
        "face_id": out.face_id,
        # () int32 (face, tile) pairs laid out — budget-overflow probe
        "num_pairs": out.num_pairs,
    }


def render_part_maps(
    keep_mesh: MTOutput,
    update_mesh: MTOutput,
    camera_local: RasterCamera,
    camera_global: Optional[RasterCamera],
    cfg: MeshRasterConfig,
) -> Dict[str, Tensor]:
    """LOCAL maps over keep(frozen) ∥ update, GLOBAL normal over the union.

    The keep mesh is the cached partition surface (no gradient), so only
    the update region back-propagates.
    """
    verts, faces, valid = concat_meshes(keep_mesh, update_mesh)
    local = render_geometry_maps(verts, faces, valid, camera_local, cfg)
    # Which local pixels show the update region (face ids past the keep part).
    n_keep_faces = keep_mesh.faces.shape[0]
    local["update_mask"] = (local["face_id"] >= n_keep_faces).to(torch.float32)
    out = {f"local_{k}": v for k, v in local.items()}
    if camera_global is not None:
        glob = render_geometry_maps(verts, faces, valid, camera_global, cfg)
        out.update({f"global_{k}": v for k, v in glob.items()})
    return out


def normal_consistency(mesh: MTOutput) -> Tensor:
    """Mean (1 − cos) between unit normals of edge-adjacent faces."""
    f = mesh.faces.long()
    p0 = mesh.verts[f[:, 0]]
    p1 = mesh.verts[f[:, 1]]
    p2 = mesh.verts[f[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-20)
    n = torch.where(mesh.faces_valid[:, None], n, torch.zeros_like(n))

    # Each face contributes its normal to its 3 edges; interior edges
    # receive exactly two unit normals.
    e_lo = torch.stack([f[:, 0], f[:, 1], f[:, 2]], -1)
    e_hi = torch.stack([f[:, 1], f[:, 2], f[:, 0]], -1)
    lo = torch.minimum(e_lo, e_hi)
    hi = torch.maximum(e_lo, e_hi)
    valid3 = mesh.faces_valid[:, None].expand(lo.shape)
    budget = f.shape[0] * 2  # interior edges of a closed mesh: E = 3F/2
    slot, _, _, _ = unique_edge_slots(lo, hi, valid3, budget)

    tgt = torch.clamp(slot.long(), max=budget).reshape(-1)
    sums = torch.zeros((budget + 1, 3), dtype=n.dtype, device=n.device)
    sums = sums.index_add(0, tgt, n[:, None, :].expand(lo.shape + (3,))
                          .reshape(-1, 3))
    counts = torch.zeros(budget + 1, dtype=n.dtype, device=n.device)
    counts = counts.index_add(0, tgt, valid3.reshape(-1).to(n.dtype))
    sums = sums[:budget]
    counts = counts[:budget]

    interior = counts == 2.0
    sq = torch.sum(sums * sums, dim=-1)
    # |a+b|² = 2 + 2·a·b for unit a, b  ⇒  1 − a·b = 2 − |a+b|²/2.
    one_minus_cos = torch.where(interior, 2.0 - sq / 2.0, torch.zeros_like(sq))
    denom = torch.clamp(interior.sum(), min=1)
    return torch.sum(one_minus_cos) / denom
