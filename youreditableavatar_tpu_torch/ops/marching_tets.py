"""Marching tetrahedra + tet-grid machinery, with static budgets.

Counterpart of `youreditableavatar_tpu/ops/marching_tets.py`:

  * data-dependent vertex/face counts become fixed budgets + validity
    masks; overflow is reported (`num_*` keep the true counts), never
    silently truncated inside the budget;
  * vertex deduplication (one vertex per cut grid edge) is a stable sort
    of the int64 composite key lo << 32 | hi (the JAX code's two-key
    `lax.sort`) + first-occurrence ranking;
  * `jnp.nonzero(size=budget, fill_value=0)` becomes a cumsum-and-scatter
    that pads with index 0 exactly as the JAX code fills, without a host
    sync;
  * the tet grid is generated (6-tets-per-cube lattice).

Index outputs are int32, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from youreditableavatar_tpu_torch.ops.padded_gather import gather_rows
from youreditableavatar_tpu_torch.ops.segments import range_owner

# Standard marching-tetrahedra tables. Occupancy code bit i = (sdf[v_i] > 0).
# Edge order: (0,1) (0,2) (0,3) (1,2) (1,3) (2,3).
TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32
)
NUM_TRIANGLES_TABLE = np.array(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], np.int32
)
TRIANGLE_TABLE = np.array(
    [
        [-1, -1, -1, -1, -1, -1],
        [1, 0, 2, -1, -1, -1],
        [4, 0, 3, -1, -1, -1],
        [1, 4, 2, 1, 3, 4],
        [3, 1, 5, -1, -1, -1],
        [2, 3, 0, 2, 5, 3],
        [1, 4, 0, 1, 5, 4],
        [4, 2, 5, -1, -1, -1],
        [4, 5, 2, -1, -1, -1],
        [4, 1, 0, 4, 5, 1],
        [3, 2, 0, 3, 5, 2],
        [1, 3, 5, -1, -1, -1],
        [4, 1, 2, 4, 3, 1],
        [3, 0, 4, -1, -1, -1],
        [2, 0, 1, -1, -1, -1],
        [-1, -1, -1, -1, -1, -1],
    ],
    np.int32,
)
_INT32_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> Tuple[Tensor, Tensor, Tensor]:
    """TET_EDGES, TRIANGLE_TABLE and NUM_TRIANGLES_TABLE as int64 on
    `device`, copied there once: a host copy at every call would wait for
    the stream each time."""
    return tuple(torch.as_tensor(a.astype(np.int64), device=device)
                 for a in (TET_EDGES, TRIANGLE_TABLE, NUM_TRIANGLES_TABLE))


def build_tet_grid(
    verts: np.ndarray,
    faces: np.ndarray,
    resolution: int = 64,
    band: float = 0.15,
    margin: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tet grid fitted to a mesh: the lattice masked to the mesh's SDF band
    (numpy; the native `MeshSDF` BVH supplies the distance, geometry
    normalized to [-0.5, 0.5]³ with `margin`).

    Returns (verts (V', 3) float32 in the normalized grid frame,
    tets (T', 4) int32)."""
    from youreditableavatar_tpu_torch.native import MeshSDF

    v = np.asarray(verts, np.float32)
    center = 0.5 * (v.max(0) + v.min(0))
    half = max(np.abs(v - center).max(), 1e-9) / (0.5 - margin)
    v_n = (v - center) / half  # fits in [-0.5+margin, 0.5-margin]

    gverts, gtets = make_tet_grid(resolution)
    sdf = MeshSDF(v_n, np.asarray(faces, np.int64))(gverts)
    near = np.abs(sdf) <= band
    keep = near[gtets].any(axis=1)
    tets = gtets[keep]
    used, inv = np.unique(tets.reshape(-1), return_inverse=True)
    return gverts[used].copy(), inv.reshape(-1, 4).astype(np.int32)


def make_tet_grid(resolution: int) -> Tuple[np.ndarray, np.ndarray]:
    """Regular tetrahedral grid over [-0.5, 0.5]³ (host-side, numpy).

    Each lattice cube splits into 6 tetrahedra sharing the main diagonal.

    Returns:
      verts: ((R+1)³, 3) float32 in [-0.5, 0.5].
      tets: (6·R³, 4) int32.
    """
    r = resolution
    grid = np.stack(
        np.meshgrid(np.arange(r + 1), np.arange(r + 1), np.arange(r + 1),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)
    verts = grid.astype(np.float32) / r - 0.5

    def vid(i, j, k):
        return (i * (r + 1) + j) * (r + 1) + k

    i, j, k = np.meshgrid(np.arange(r), np.arange(r), np.arange(r),
                          indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    c = np.stack(
        [
            vid(i, j, k), vid(i + 1, j, k), vid(i, j + 1, k),
            vid(i + 1, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
            vid(i, j + 1, k + 1), vid(i + 1, j + 1, k + 1),
        ],
        axis=-1,
    )  # (R³, 8) cube corners
    # 6 tets per cube around the 0-7 diagonal.
    tet_corners = np.array(
        [
            [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
            [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7],
        ],
        np.int64,
    )
    tets = c[:, tet_corners].reshape(-1, 4)
    return verts, tets.astype(np.int32)


def _nonzero_padded(mask: Tensor, budget: int) -> Tensor:
    """(budget,) int32 indices of the first `budget` set entries of a 1-D
    mask in order, padded with 0 (`jnp.nonzero(size=, fill_value=0)`)."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (pos < budget), pos,
                      torch.full_like(pos, budget))
    out = torch.zeros(budget + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, tgt, torch.arange(mask.shape[0], device=mask.device))
    return out[:budget].to(torch.int32)


def unique_edge_slots(
    lo: Tensor, hi: Tensor, valid: Tensor, budget: int
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Deduplicate undirected edges (lo ≤ hi) into ≤ budget slots.

    Stable sort of the composite key lo << 32 | hi, first-occurrence
    ranking, and a scatter of ranks back to the original positions. Invalid
    entries sort to the end and get slot = budget.

    Returns:
      slot: same shape as lo, int32 slot id per input edge (budget if invalid
        or overflowed).
      uniq_lo, uniq_hi: (budget,) int32 endpoint ids per slot (0 where unused).
      num: () int32 true number of unique valid edges.
    """
    shape = lo.shape
    dev = lo.device
    lo_f = torch.where(valid, lo.to(torch.int64), _INT32_MAX).reshape(-1)
    hi_f = torch.where(valid, hi.to(torch.int64), _INT32_MAX).reshape(-1)
    n = lo_f.shape[0]
    key_s, pos_s = torch.sort((lo_f << 32) | hi_f, stable=True)
    lo_s = key_s >> 32
    hi_s = key_s & 0xFFFFFFFF

    valid_s = lo_s != _INT32_MAX
    first = torch.cat([
        valid_s[:1],
        valid_s[1:] & ((lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])),
    ])
    rank = torch.cumsum(first.to(torch.int64), 0) - 1  # unique index, sorted
    num = torch.zeros((), dtype=torch.int64, device=dev)
    if n:
        num = torch.where(valid_s.any(), rank.max() + 1, num)
    fill = torch.full_like(rank, budget)
    slot_sorted = torch.where(valid_s & (rank < budget), rank, fill)
    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    slot[pos_s] = slot_sorted

    write = first & (rank < budget)
    tgt = torch.where(write, rank, fill)
    zero = torch.zeros_like(lo_s)
    uniq_lo = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    uniq_lo[tgt] = torch.where(write, lo_s, zero)
    uniq_hi = torch.zeros(budget + 1, dtype=torch.int64, device=dev)
    uniq_hi[tgt] = torch.where(write, hi_s, zero)
    return (slot.reshape(shape).to(torch.int32),
            uniq_lo[:budget].to(torch.int32), uniq_hi[:budget].to(torch.int32),
            num.to(torch.int32))


class MTOutput(NamedTuple):
    """Budgeted marching-tets surface."""

    verts: Tensor  # (max_verts, 3) float32; invalid slots = 0
    verts_valid: Tensor  # (max_verts,) bool
    faces: Tensor  # (max_faces, 3) int32 into verts; invalid = 0
    faces_valid: Tensor  # (max_faces,) bool
    face_to_tet: Tensor  # (max_faces,) int32 source tet index (−1 invalid)
    num_verts: Tensor  # () int32 true count (may exceed budget → overflow)
    num_faces: Tensor  # () int32 true count
    edge_lo: Tensor  # (max_verts,) int32 grid-edge endpoint a per vertex
    edge_hi: Tensor  # (max_verts,) int32 grid-edge endpoint b per vertex


def marching_tets(
    pos: Tensor,
    sdf: Tensor,
    tets: Tensor,
    max_verts: int,
    max_faces: int,
    tet_valid: Optional[Tensor] = None,
) -> MTOutput:
    """Extract the sdf=0 surface of a tet grid (differentiable w.r.t. pos/sdf).

    Args:
      pos: (Nv, 3) grid vertex positions.
      sdf: (Nv,) signed distances.
      tets: (Nt, 4) integer tet vertex ids.
      max_verts / max_faces: output budgets.
      tet_valid: optional (Nt,) mask restricting extraction to a tet subset.
    """
    dev = pos.device
    tets = tets.long()
    occ = sdf > 0.0  # (Nv,)
    tet_occ = occ[tets].to(torch.int64)  # (Nt, 4)
    code = (tet_occ[:, 0] + tet_occ[:, 1] * 2 + tet_occ[:, 2] * 4
            + tet_occ[:, 3] * 8)
    surf = (code > 0) & (code < 15)
    if tet_valid is not None:
        surf = surf & tet_valid

    edges, tri_table, ntri_table = _tables(dev)
    ev0 = tets[:, edges[:, 0]]  # (Nt, 6)
    ev1 = tets[:, edges[:, 1]]
    cut = (occ[ev0] != occ[ev1]) & surf[:, None]

    lo = torch.minimum(ev0, ev1)
    hi = torch.maximum(ev0, ev1)
    edge_slot, va, vb, num_verts = unique_edge_slots(lo, hi, cut, max_verts)
    verts_valid = torch.arange(max_verts, device=dev) < torch.clamp(
        num_verts, max=max_verts)

    # gather_rows, not indexing: padded vertex slots gather row 0, and
    # autograd of `x[idx]` walks each run of equal indices serially;
    # gather_rows' backward spreads them off row 0 (ops/padded_gather.py).
    va_l, vb_l = va.long(), vb.long()
    sa = gather_rows(sdf, va_l)
    sb = gather_rows(sdf, vb_l)
    denom = sb - sa
    safe = torch.abs(denom) >= 1e-10
    denom = torch.where(safe, denom, torch.ones_like(denom))
    # Weight of endpoint a; 0.5 on degenerate/invalid edges keeps the
    # division's gradient finite (0·inf = NaN otherwise).
    t = torch.where(safe & verts_valid, sb / denom, torch.full_like(sb, 0.5))
    verts = (gather_rows(pos, va_l) * t[:, None]
             + gather_rows(pos, vb_l) * (1.0 - t[:, None]))
    verts = torch.where(verts_valid[:, None], verts, torch.zeros_like(verts))

    local = tri_table[code]  # (Nt, 6) local edge ids (−1 pad)
    global_vid = torch.gather(edge_slot.long(), 1, torch.clamp(local, min=0))

    ntri = torch.where(surf, ntri_table[code],
                       torch.zeros_like(code))  # (Nt,) 0..2
    num_faces = ntri.sum().to(torch.int32)

    # Face slot → owning tet via the range-owner helper.
    g_safe, lf, fvalid = range_owner(ntri.to(torch.int32), max_faces)
    tri = global_vid[g_safe.long()]  # (max_faces, 6)
    # Slots past the face total have no triangle (their rows are zeroed
    # below); clamp their column so the gather stays in range.
    lf3 = lf.long() * 3
    faces = torch.stack(
        [torch.gather(tri, 1, torch.clamp(lf3 + i, max=5)[:, None])[:, 0]
         for i in range(3)], dim=-1)
    # Clamp guards the vertex-budget-overflow case (detectable via num_verts).
    faces = torch.clamp(torch.where(fvalid[:, None], faces,
                                    torch.zeros_like(faces)),
                        0, max_verts - 1).to(torch.int32)
    face_to_tet = torch.where(fvalid, g_safe, torch.full_like(g_safe, -1))

    return MTOutput(
        verts=verts,
        verts_valid=verts_valid,
        faces=faces,
        faces_valid=fvalid,
        face_to_tet=face_to_tet,
        num_verts=num_verts,
        num_faces=num_faces,
        edge_lo=va,
        edge_hi=vb,
    )


def _compacted(mask: Tensor, tet_mask: Optional[Tensor], budget: int):
    if tet_mask is not None:
        mask = mask & tet_mask
    idx = _nonzero_padded(mask, budget)
    num = mask.sum().to(torch.int32)
    valid = torch.arange(budget, device=mask.device) < torch.clamp(num, max=budget)
    return idx, valid, num


def compact_tets(
    pos: Tensor,
    sdf: Tensor,
    tets: Tensor,
    budget: int,
    threshold: float = 0.02,
    tet_mask: Optional[Tensor] = None,
    corner_threshold: float = 0.0,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Select near-surface tets: |mean vertex sdf| ≤ threshold, OR sign
    change, OR any corner within `corner_threshold` of the surface.
    `tet_mask` restricts selection before the budget applies.

    Returns:
      idx: (budget,) int32 selected tet indices (0 fill for invalid).
      valid: (budget,) bool.
      num: () int32 true count (> budget ⇒ overflow: tets were dropped).
    """
    tsdf = sdf[tets.long()]  # (Nt, 4)
    near = torch.abs(torch.mean(tsdf, dim=-1)) <= threshold
    sign_change = (tsdf.min(-1).values < 0) & (tsdf.max(-1).values > 0)
    mask = near | sign_change
    if corner_threshold > 0.0:
        mask = mask | (torch.abs(tsdf).min(-1).values <= corner_threshold)
    return _compacted(mask, tet_mask, budget)


# make_tet_grid's 6-tets-per-cube split around the 0–7 diagonal; corner id
# n has lattice offset (n&1, n>>1&1, n>>2&1).
_TET_CORNERS = ((0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7),
                (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7))


def compact_tets_lattice(
    sdf: Tensor,
    resolution: int,
    budget: int,
    threshold: float = 0.02,
    tet_mask: Optional[Tensor] = None,
    corner_threshold: float = 0.0,
) -> Tuple[Tensor, Tensor, Tensor]:
    """`compact_tets` specialized to the `make_tet_grid` lattice: each
    corner value is a shifted 3-D view of the (R+1)³ SDF volume, so the
    per-tet stats are elementwise. Same selection, same flat tet order.

    Returns (idx, valid, num) with idx indexing the FULL grid tet list.
    """
    r = resolution
    v = sdf.reshape(r + 1, r + 1, r + 1)
    corner = [
        v[n & 1:(n & 1) + r,
          (n >> 1) & 1:((n >> 1) & 1) + r,
          (n >> 2) & 1:((n >> 2) & 1) + r]
        for n in range(8)
    ]
    masks = []
    for cs in _TET_CORNERS:
        c0, c1, c2, c3 = (corner[c] for c in cs)
        mn = torch.minimum(torch.minimum(c0, c1), torch.minimum(c2, c3))
        mx = torch.maximum(torch.maximum(c0, c1), torch.maximum(c2, c3))
        mean = (c0 + c1 + c2 + c3) * 0.25
        m = (torch.abs(mean) <= threshold) | ((mn < 0) & (mx > 0))
        if corner_threshold > 0.0:
            amn = torch.minimum(
                torch.minimum(torch.abs(c0), torch.abs(c1)),
                torch.minimum(torch.abs(c2), torch.abs(c3)),
            )
            m = m | (amn <= corner_threshold)
        masks.append(m)
    mask = torch.stack(masks, dim=-1).reshape(-1)  # (R³·6,) = flat tet order
    return _compacted(mask, tet_mask, budget)


def subdivide_tets(
    pos: Tensor,
    sdf: Tensor,
    tets: Tensor,
    tet_valid: Tensor,
    max_mid: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """1→8 midpoint subdivision of a tet subset.

    Midpoints are deduplicated per grid edge. New vertices are appended
    after the parent vertex array; new vertex sdf is the edge-endpoint mean
    (callers typically re-query the field instead).

    Args:
      pos: (Nv, 3); sdf: (Nv,); tets: (M, 4) the subset (already gathered);
      tet_valid: (M,) mask; max_mid: midpoint budget.
    Returns:
      new_pos: (Nv + max_mid, 3); new_sdf: (Nv + max_mid,);
      child_tets: (8·M, 4) int32 into new_pos;
      child_valid: (8·M,) bool; num_mid: () int32 true midpoint count.
    """
    dev = pos.device
    nv = pos.shape[0]
    tets = tets.long()
    edges = _tables(dev)[0]
    ev0 = tets[:, edges[:, 0]]  # (M, 6)
    ev1 = tets[:, edges[:, 1]]
    lo = torch.minimum(ev0, ev1)
    hi = torch.maximum(ev0, ev1)
    valid6 = tet_valid[:, None].expand(lo.shape)
    slot, ma, mb, num_mid = unique_edge_slots(lo, hi, valid6, max_mid)
    mid_valid = torch.arange(max_mid, device=dev) < torch.clamp(
        num_mid, max=max_mid)

    ma, mb = ma.long(), mb.long()
    # gather_rows: padded midpoint slots gather row 0 (see marching_tets).
    mid_pos = 0.5 * (gather_rows(pos, ma) + gather_rows(pos, mb))
    mid_sdf = 0.5 * (gather_rows(sdf, ma) + gather_rows(sdf, mb))
    new_pos = torch.cat([pos, torch.where(mid_valid[:, None], mid_pos,
                                          torch.zeros_like(mid_pos))])
    new_sdf = torch.cat([sdf, torch.where(mid_valid, mid_sdf,
                                          torch.zeros_like(mid_sdf))])

    mid_slot = nv + torch.clamp(slot.long(), max=max_mid - 1)  # (M, 6)

    a, b, c, d = tets[:, 0], tets[:, 1], tets[:, 2], tets[:, 3]
    ab, ac, ad = mid_slot[:, 0], mid_slot[:, 1], mid_slot[:, 2]
    bc, bd, cd = mid_slot[:, 3], mid_slot[:, 4], mid_slot[:, 5]
    # 4 corner children + 4 octahedron children (split along ac–bd diagonal).
    children = torch.stack(
        [
            torch.stack([a, ab, ac, ad], -1),
            torch.stack([b, bc, ab, bd], -1),
            torch.stack([c, ac, bc, cd], -1),
            torch.stack([d, ad, cd, bd], -1),  # ordered to keep parent parity
            torch.stack([ab, ac, ad, bd], -1),
            torch.stack([ab, bc, ac, bd], -1),
            torch.stack([cd, ac, bc, bd], -1),
            torch.stack([cd, ad, ac, bd], -1),
        ],
        dim=1,
    )  # (M, 8, 4)
    child_tets = children.reshape(-1, 4).to(torch.int32)
    child_valid = tet_valid[:, None].expand(-1, 8).reshape(-1)
    return new_pos, new_sdf, child_tets, child_valid, num_mid


def mark_part_tets(
    tets: Tensor,
    face_to_tet: Tensor,
    faces_valid: Tensor,
    edit_face_mask: Tensor,
    num_tets: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Partition tets into frozen ("keep") and editable ("update") sets:
    KEEP tets hold extracted surface faces that are NOT editable; UPDATE
    tets are the entire complement.

    Returns:
      update_mask: (Nt,) bool; keep_mask: (Nt,) bool (= ~update).
    """
    nt = tets.shape[0] if num_tets is None else num_tets
    keep_hit = faces_valid & (~edit_face_mask) & (face_to_tet >= 0)
    tgt = torch.where(keep_hit, face_to_tet.long(),
                      torch.full_like(face_to_tet, nt, dtype=torch.int64))
    keep = torch.zeros(nt + 1, dtype=torch.bool, device=tets.device)
    keep[tgt] = True
    keep = keep[:nt]
    return ~keep, keep


def _touched(tets: Tensor, rows: Tensor, nv: int) -> Tensor:
    """(Nv,) bool: vertices of the tets where `rows` is set (masked rows
    write vertex 0, which is then corrected as the JAX code does)."""
    out = torch.zeros(nv, dtype=torch.bool, device=tets.device)
    out[torch.where(rows[:, None], tets, torch.zeros_like(tets))] = True
    out[0] = (rows[:, None] & (tets == 0)).any()
    return out


def overlap_vertex_mask(
    tets: Tensor, update_mask: Tensor, num_verts: int
) -> Tensor:
    """(Nv,) bool: grid vertices used by both keep and update tets."""
    tets = tets.long()
    return _touched(tets, update_mask, num_verts) & _touched(
        tets, ~update_mask, num_verts)
