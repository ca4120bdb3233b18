"""Partitioned tet-grid geometry: full/keep/update isosurface orchestration.

Counterpart of `youreditableavatar_tpu/models/geometry.py`: full-grid
marching tets, the frozen/editable tet partition (`partition_init`), the
cached fine keep-region surface, and the per-step partitioned extraction
where keep vertices read the frozen field and update vertices the live one.

All data-dependent steps stay behind the same static budgets as the JAX
code:
  * the keep region is subdivided once at partition time with the frozen
    field and its marching-tets surface is cached;
  * the per-step update path scatters live SDF over the update-exclusive
    vertices, compacts near-surface tets to a budget, subdivides them once
    with a live re-query, and runs marching tets.

Per step the live field takes gradients at three point sets only — the
selected-tet corners (≤ 4·compact), the midpoints (`subdiv_mid`) and the
trainer's recon points — so the hash-grid backward (K4) runs three times.

The owner of a duplicated corner in the sparse requery (`_part_core`) is
the largest row id (`scatter_reduce` amax); XLA leaves the choice
unspecified. Values and gradients do not depend on it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from youreditableavatar_tpu_torch.models.sdf import SDFField, SDFParams
from youreditableavatar_tpu_torch.ops.marching_tets import (
    MTOutput,
    compact_tets,
    compact_tets_lattice,
    make_tet_grid,
    marching_tets,
    mark_part_tets,
    overlap_vertex_mask,
    subdivide_tets,
)
from youreditableavatar_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class GeometryBudgets:
    """Static shape budgets (overflow is detectable via num_* fields)."""

    mt_verts: int = 1 << 16
    mt_faces: int = 1 << 17
    compact: int = 1 << 14  # near-surface update tets kept for subdivision
    subdiv_mid: int = 1 << 16  # midpoint vertices for the 8× subdivision
    fine_mt_verts: int = 1 << 16
    fine_mt_faces: int = 1 << 17


class Partition(NamedTuple):
    """Frozen partition state produced at `partition_init`."""

    update_tet_mask: Tensor  # (Nt,) bool
    keep_tet_mask: Tensor  # (Nt,) bool
    overlap_verts: Tensor  # (Nv,) bool — frozen even inside the update region
    live_vert_mask: Tensor  # (Nv,) bool — vertices that read the live field
    frozen_sdf: Tensor  # (Nv,) frozen field at all grid vertices
    keep_mesh: MTOutput  # cached fine keep-region surface
    keep_fine_pos: Tensor  # subdivided keep vertices (diagnostics/export)
    keep_fine_sdf: Tensor
    # Exact-size index forms of the masks (computed once at partition_init),
    # so the per-step extraction touches O(update region), not O(grid).
    live_vert_idx: Tensor  # (Lv,) int32 — vertices that read the live field
    update_tet_idx: Tensor  # (Lt,) int32 — tets in the update region


class TetGeometry:
    """Field + tet grid + budgets."""

    def __init__(
        self,
        field: SDFField,
        resolution: int = 64,
        budgets: GeometryBudgets = GeometryBudgets(),
        grid_scale: float = 2.0,
        device=None,
    ):
        self.field = field
        self.budgets = budgets
        self.device = resolve_device(device)
        verts, tets = make_tet_grid(resolution)
        # Grid spans [-scale/2, scale/2]³.
        self.grid_pos = torch.as_tensor(verts * grid_scale, device=self.device)
        self.grid_tets = torch.as_tensor(tets, device=self.device)
        self.resolution = resolution
        self.spacing = grid_scale / resolution

    # ---- full-grid surface -------------------------------------------------

    def isosurface(
        self, params: SDFParams, level_mask: Optional[Tensor] = None
    ) -> MTOutput:
        """Full-grid marching tets of the live field."""
        sdf = self.field.forward_sdf_chunked(
            params, self.grid_pos, level_mask=level_mask
        )
        return marching_tets(
            self.grid_pos, sdf, self.grid_tets,
            self.budgets.mt_verts, self.budgets.mt_faces,
        )

    # ---- partition ---------------------------------------------------------

    @torch.no_grad()
    def partition_init(
        self,
        frozen_params: SDFParams,
        edit_face_mask: Tensor,
        frozen_mt: Optional[MTOutput] = None,
    ) -> Partition:
        """Split the grid into keep/update from an editable-face mask.

        Args:
          frozen_params: the previous-stage field (frozen).
          edit_face_mask: (max_faces,) bool over `frozen_mt` faces.
          frozen_mt: surface of the frozen field (recomputed if omitted).
        """
        if frozen_mt is None:
            frozen_mt = self.isosurface(frozen_params)
        frozen_sdf = self.field.forward_sdf_chunked(frozen_params, self.grid_pos)

        update_mask, keep_mask = mark_part_tets(
            self.grid_tets, frozen_mt.face_to_tet, frozen_mt.faces_valid,
            edit_face_mask.to(self.device),
        )
        nv = self.grid_pos.shape[0]
        overlap = overlap_vertex_mask(self.grid_tets, update_mask, nv)
        # Vertices of update tets, minus overlap, read the live field.
        tets = self.grid_tets.long()
        in_update = torch.zeros(nv, dtype=torch.bool, device=self.device)
        in_update[torch.where(update_mask[:, None], tets,
                              torch.zeros_like(tets))] = True
        in_update[0] = (update_mask[:, None] & (tets == 0)).any()
        live_mask = in_update & (~overlap)

        # Fine keep region: compact near-surface keep tets with the frozen
        # field, subdivide once, re-query the frozen field at midpoints.
        keep_sdf = frozen_sdf
        idx, valid, _ = compact_tets(
            self.grid_pos, keep_sdf, self.grid_tets, self.budgets.compact,
            tet_mask=keep_mask, corner_threshold=self.spacing,
        )
        sub_tets = self.grid_tets[idx.long()]
        fine_pos, _, child_tets, child_valid, _ = subdivide_tets(
            self.grid_pos, keep_sdf, sub_tets, valid, self.budgets.subdiv_mid,
        )
        mids = fine_pos[nv:]
        mid_sdf = self.field.forward_sdf_chunked(frozen_params, mids)
        fine_sdf = torch.cat([keep_sdf, mid_sdf])
        keep_mesh = marching_tets(
            fine_pos, fine_sdf, child_tets,
            self.budgets.fine_mt_verts, self.budgets.fine_mt_faces,
            tet_valid=child_valid,
        )
        live_idx = torch.nonzero(live_mask).flatten().to(torch.int32)
        upd_idx = torch.nonzero(update_mask).flatten().to(torch.int32)
        return Partition(
            update_tet_mask=update_mask,
            keep_tet_mask=keep_mask,
            overlap_verts=overlap,
            live_vert_mask=live_mask,
            frozen_sdf=frozen_sdf,
            keep_mesh=keep_mesh,
            keep_fine_pos=fine_pos,
            keep_fine_sdf=fine_sdf,
            live_vert_idx=live_idx,
            update_tet_idx=upd_idx,
        )

    # ---- per-step update surface -------------------------------------------

    def part_isosurface(
        self,
        params: SDFParams,
        part: Partition,
        level_mask: Optional[Tensor] = None,
        n_active: Optional[int] = None,
    ) -> MTOutput:
        """Update-region surface from the live field (differentiable).

        Composite SDF: frozen values everywhere, live values on the
        update-exclusive vertices (without gradient: they only select
        tets); then budgeted compaction, one live subdivision and marching
        tets restricted to update tets. Gradients come from the sparse
        requery at the selected tets' corners (exact: same parameters, same
        values).
        """
        live_idx = part.live_vert_idx.long()
        with torch.no_grad():
            live_vals = self.field.forward_sdf(
                params, self.grid_pos[live_idx], level_mask=level_mask,
                n_active=n_active,
            )
            sdf0 = part.frozen_sdf.clone()
            sdf0[live_idx] = live_vals
        mt, _ = self._part_core(params, part, sdf0, level_mask, n_active)
        return mt

    def part_isosurface_cached(
        self,
        params: SDFParams,
        part: Partition,
        sdf_cache: Tensor,
        refresh_idx: Tensor,
        level_mask: Optional[Tensor] = None,
        n_active: Optional[int] = None,
    ) -> Tuple[MTOutput, Tensor]:
        """`part_isosurface` with a carried selection cache.

        Reads the carried composite SDF `sdf_cache`, refreshing a rotating
        no-grad slice `refresh_idx` of the live vertices and — through the
        sparse grad requery — every selected-tet corner each step.

        Returns (mt, new_cache); carry new_cache into the next step.
        """
        refresh_idx = refresh_idx.long()
        with torch.no_grad():
            refresh_vals = self.field.forward_sdf(
                params, self.grid_pos[refresh_idx], level_mask=level_mask,
                n_active=n_active,
            )
            sdf0 = sdf_cache.clone()
            sdf0[refresh_idx] = refresh_vals
        return self._part_core(params, part, sdf0, level_mask, n_active)

    def _part_core(
        self,
        params: SDFParams,
        part: Partition,
        sdf0: Tensor,
        level_mask: Optional[Tensor],
        n_active: Optional[int] = None,
    ) -> Tuple[MTOutput, Tensor]:
        """Selection on `sdf0` (no-grad composite), sparse grad requery,
        subdivision + marching tets. Returns (mt, new_cache) where new_cache
        is sdf0 with this step's fresh values written at selected corners."""
        idx, valid, _ = compact_tets_lattice(
            sdf0, self.resolution, self.budgets.compact,
            tet_mask=part.update_tet_mask,
            corner_threshold=self.spacing,
        )
        sub_tets = self.grid_tets[idx.long()].long()

        # Sparse grad-enabled requery at selected-tet corners. Each unique
        # vertex gets exactly one owner row, so duplicate corners are not
        # counted twice; non-owners add an exact zero. The owner row's add
        # replaces the (possibly stale) cached value with the fresh one.
        nv = self.grid_pos.shape[0]
        live_sel = part.live_vert_mask[
            torch.where(valid[:, None], sub_tets, torch.zeros_like(sub_tets))
        ] & valid[:, None]
        live_flat = live_sel.reshape(-1)
        sv = torch.where(live_flat, sub_tets.reshape(-1),
                         torch.zeros_like(live_flat, dtype=torch.int64))
        fresh = self.field.forward_sdf(
            params, self.grid_pos[sv], level_mask=level_mask,
            n_active=n_active,
        )
        # Non-live rows own the sentinel slot `nv`, not vertex 0.
        sv_own = torch.where(live_flat, sv, torch.full_like(sv, nv))
        rows = torch.arange(sv.shape[0], device=sv.device)
        owner = torch.full((nv + 1,), -1, dtype=torch.int64, device=sv.device)
        owner = owner.scatter_reduce(0, sv_own, rows, reduce="amax")
        is_owner = (owner[sv_own] == rows) & live_flat
        delta = torch.where(is_owner, fresh - sdf0[sv], torch.zeros_like(fresh))
        sdf = sdf0.index_add(0, sv, delta)
        new_cache = sdf.detach()
        fine_pos, _, child_tets, child_valid, _ = subdivide_tets(
            self.grid_pos, sdf, sub_tets, valid, self.budgets.subdiv_mid
        )
        mids = fine_pos[nv:]
        mid_live = self.field.forward_sdf_chunked(
            params, mids, level_mask=level_mask, n_active=n_active
        )
        fine_sdf = torch.cat([sdf, mid_live])
        mt = marching_tets(
            fine_pos, fine_sdf, child_tets,
            self.budgets.fine_mt_verts, self.budgets.fine_mt_faces,
            tet_valid=child_valid,
        )
        return mt, new_cache


def concat_meshes(a: MTOutput, b: MTOutput) -> Tuple[Tensor, Tensor, Tensor]:
    """(verts, faces, faces_valid) of two budgeted meshes concatenated
    (keep ∥ update, as the local render concatenates them)."""
    nva = a.verts.shape[0]
    verts = torch.cat([a.verts, b.verts])
    faces = torch.cat([a.faces, b.faces + nva])
    valid = torch.cat([a.faces_valid, b.faces_valid])
    return verts, faces, valid
