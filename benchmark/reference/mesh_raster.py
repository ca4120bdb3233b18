# Frozen copy of youreditableavatar_tpu_torch/ops/mesh_raster/raster.py (the plain PyTorch path only).
"""Triangle visibility rasterization: tile binning + z-buffer resolve.

Counterpart of `youreditableavatar_tpu/ops/mesh_raster/raster.py`: per-face
screen-space preprocess, fixed-budget (face, tile) pair expansion with a
stable tile sort (`torch.sort(stable=True)` where the JAX code calls
`jax.lax.sort`), then the per-tile z-buffer resolve (K5). Outputs per pixel:
visible face id (−1 = background), affine barycentrics (l1, l2) and NDC
depth. All outputs are non-differentiable by construction (visibility is a
discrete argmin); `interpolate.py` re-attaches gradients.

The resolve is `resolve_tiles`: CUDA tensors launch `csrc/mesh_resolve.cu`
(four CTAs per tile, one per 16×16 quarter; each warp an 8×4 pixel block
that evaluates only the faces whose conservative box, `face_box_plain`,
meets it; the running nearest face in registers); CPU tensors go to
`resolve_tiles_plain`, a chunked scan that repeats the same f32 operations
in the same order, so the two agree bit for bit. Like the
Pallas path of the JAX package — and unlike its `"xla"` fallback — neither
caps a tile's face list, so `MeshRasterConfig` carries no `tile_capacity`,
`backend` or `pallas_interpret`.

`RasterOutput.num_pairs` is, as in the JAX package, the number of pairs
that entered the layout: it saturates at `pair_budget`, so a value equal to
the budget means faces may have been dropped.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from benchmark.reference.cameras import RasterCamera
from benchmark.reference.segments import range_owner

# Per-face row: x0,y0,x1,y1,x2,y2 (screen px), z0,z1,z2 (ndc).
ROW_FLOATS = 9
CHUNK = 128  # pairs per step of the plain scan (and per staging round of K5)
Z_FAR = 3.4e38  # empty-pixel depth sentinel
KERNEL_TILE = 32  # the CUDA kernel's tile edge
BOX_U = 2.0 ** -24  # f32 unit roundoff, in `face_box_plain`'s bound
# Tiles scanned together by the plain version: bounds its (tiles, CHUNK,
# pixels) temporaries to 32 MiB each.
PLAIN_TILE_GROUP = 64


@dataclasses.dataclass(frozen=True)
class MeshRasterConfig:
    tile_size: int = 32
    pair_budget: int = 1 << 18
    backface_cull: bool = False  # reference nvdiffrast does not cull
    near: float = 1e-4


class RasterOutput(NamedTuple):
    face_id: Tensor  # (H, W) int32, −1 background
    bary: Tensor  # (H, W, 2) affine (l1, l2) of the visible face
    depth: Tensor  # (H, W) ndc z of the visible face (Z_FAR background)
    verts_screen: Tensor  # (V, 2) screen positions (for downstream reuse)
    verts_zw: Tensor  # (V, 2) (z_ndc, inv_w) per vertex
    num_pairs: Tensor  # () int32 (face, tile) pairs laid out; == the pair
    #   budget when the budget truncated the list


def project_vertices(
    verts: Tensor, camera: RasterCamera, near: float
) -> Tuple[Tensor, Tensor, Tensor]:
    """World → (screen xy, (ndc z, 1/w), valid). Differentiable."""
    w = camera.viewmat
    x = verts[:, 0] * w[0, 0] + verts[:, 1] * w[0, 1] + verts[:, 2] * w[0, 2] + w[0, 3]
    y = verts[:, 0] * w[1, 0] + verts[:, 1] * w[1, 1] + verts[:, 2] * w[1, 2] + w[1, 3]
    z = verts[:, 0] * w[2, 0] + verts[:, 1] * w[2, 1] + verts[:, 2] * w[2, 2] + w[2, 3]
    z_safe = torch.clamp(z, min=near)
    sx = camera.fx * x / z_safe + camera.cx
    sy = camera.fy * y / z_safe + camera.cy
    inv_w = 1.0 / z_safe
    # "ndc z": monotone in view z; screen-affine per triangle. 1 − 1/z is
    # bounded and increases with distance.
    zndc = 1.0 - inv_w
    valid = z > near
    return torch.stack([sx, sy], -1), torch.stack([zndc, inv_w], -1), valid


def _face_fields(
    verts_screen: Tensor, verts_zw: Tensor, vert_valid: Tensor, faces: Tensor,
    faces_valid: Optional[Tensor], camera: RasterCamera, cfg: MeshRasterConfig,
):
    """Per-face rows (F, 9), tiles touched (F,) and tile rectangles."""
    f = faces.long()
    p0 = verts_screen[f[:, 0]]
    p1 = verts_screen[f[:, 1]]
    p2 = verts_screen[f[:, 2]]
    z = verts_zw[:, 0]

    ok = vert_valid[f[:, 0]] & vert_valid[f[:, 1]] & vert_valid[f[:, 2]]
    if faces_valid is not None:
        ok = ok & faces_valid
    area = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (
        p1[:, 1] - p0[:, 1]
    ) * (p2[:, 0] - p0[:, 0])
    if cfg.backface_cull:
        ok = ok & (area > 0.0)
    else:
        ok = ok & (torch.abs(area) > 1e-12)

    rows = torch.stack(
        [p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1], p2[:, 0], p2[:, 1],
         z[f[:, 0]], z[f[:, 1]], z[f[:, 2]]], dim=1,
    ).contiguous()
    return (rows,) + bin_face_rows(rows, ok, camera.width, camera.height,
                                   cfg.tile_size)


def bin_face_rows(rows: Tensor, ok: Tensor, width: int, height: int, ts: int):
    """Tiles touched (F,) by each face row kept by `ok` (its bounding box's
    tile rectangle, nothing for a face off screen) and the rectangles:
    (tiles, rect, ntx, nty)."""
    ntx = -(-width // ts)
    nty = -(-height // ts)
    xs = rows[:, 0:6:2].T
    ys = rows[:, 1:6:2].T
    xmin, xmax = xs.min(0).values, xs.max(0).values
    ymin, ymax = ys.min(0).values, ys.max(0).values
    rect_min_x = torch.clamp(torch.floor(xmin / ts), 0, ntx).to(torch.int32)
    rect_min_y = torch.clamp(torch.floor(ymin / ts), 0, nty).to(torch.int32)
    rect_max_x = torch.clamp(torch.floor(xmax / ts) + 1, 0, ntx).to(torch.int32)
    rect_max_y = torch.clamp(torch.floor(ymax / ts) + 1, 0, nty).to(torch.int32)
    offscreen = (xmax < 0) | (xmin >= width) | (ymax < 0) | (ymin >= height)
    ok = ok & (~offscreen)
    w_t = torch.clamp(rect_max_x - rect_min_x, min=0)
    h_t = torch.clamp(rect_max_y - rect_min_y, min=0)
    tiles = torch.where(ok, w_t * h_t, torch.zeros_like(w_t))
    return tiles, (rect_min_x, rect_min_y, rect_max_x), ntx, nty


def _expand_pairs(tiles, rect, ntx, nty, pair_budget):
    """(face, tile) pair expansion + stable tile sort.

    Returns (face_s (P,) int32 face per sorted pair, start (T,), count (T,)).
    """
    rect_min_x, rect_min_y, rect_max_x = rect
    num_tiles = ntx * nty
    if tiles.shape[0] == 0:  # no faces: every tile's list is empty
        empty = torch.zeros(num_tiles, dtype=torch.int32, device=tiles.device)
        return (torch.zeros(pair_budget, dtype=torch.int32,
                            device=tiles.device), empty, empty)
    owner, local, valid = range_owner(tiles, pair_budget)
    o = owner.long()
    rect_w = torch.clamp(rect_max_x[o] - rect_min_x[o], min=1)
    # The row by an f32 division, as the JAX code computes it.
    row = torch.floor(
        local.to(torch.float32) / rect_w.to(torch.float32)
    ).to(torch.int32)
    tx = rect_min_x[o] + local - row * rect_w
    ty = rect_min_y[o] + row
    tile = torch.where(valid, ty * ntx + tx,
                       torch.full_like(tx, num_tiles)).to(torch.int32)
    tile_s, order = torch.sort(tile, stable=True)
    face_s = owner[order].contiguous()
    tids = torch.arange(num_tiles, dtype=torch.int32, device=tile.device)
    start = torch.searchsorted(tile_s, tids, right=False).to(torch.int32)
    end = torch.searchsorted(tile_s, tids, right=True).to(torch.int32)
    return face_s, start, end - start


def _untile(x: Tensor, ntx: int, nty: int, ts: int, width: int, height: int):
    """(T, ts·ts, ...) per-tile planes → (H, W, ...) image."""
    tail = x.shape[2:]
    x = x.reshape(nty, ntx, ts, ts, *tail).transpose(1, 2)
    return x.reshape(nty * ts, ntx * ts, *tail)[:height, :width]




def resolve_tiles_plain(
    rows: Tensor, face_s: Tensor, starts: Tensor, counts: Tensor,
    ntx: int, nty: int, ts: int, width: int, height: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch z-buffer resolve: a scan over 128-pair chunks of every
    tile's face list, as long as the deepest tile needs (no capacity cut).

    Within a chunk the nearest face is the *first* minimum; across chunks
    the update is strict (`zmin < best_z`), so the earliest pair wins ties.
    """
    dev = rows.device
    num_tiles = ntx * nty
    pix = ts * ts
    p = torch.arange(pix, dtype=torch.int32, device=dev)
    slot = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    last = max(face_s.shape[0] - 1, 0)
    outs = []
    for t0 in range(0, num_tiles, PLAIN_TILE_GROUP):
        t = torch.arange(t0, min(t0 + PLAIN_TILE_GROUP, num_tiles),
                         dtype=torch.int32, device=dev)
        nt = t.shape[0]
        px = ((t % ntx) * ts)[:, None] + (p % ts)[None, :]
        py = (torch.div(t, ntx, rounding_mode="floor") * ts)[:, None] + \
            torch.div(p, ts, rounding_mode="floor")[None, :]
        pxb = px.to(torch.float32)[:, None, :]
        pyb = py.to(torch.float32)[:, None, :]
        st, cn = starts[t.long()], counts[t.long()]
        best_z = torch.full((nt, pix), Z_FAR, dtype=torch.float32, device=dev)
        best_f = torch.full((nt, pix), -1, dtype=torch.int32, device=dev)
        best_u = torch.zeros((nt, pix), dtype=torch.float32, device=dev)
        best_v = torch.zeros((nt, pix), dtype=torch.float32, device=dev)
        chunks = -(-int(cn.max()) // CHUNK) if nt and rows.shape[0] else 0
        for c in range(chunks):
            sl = st[:, None] + c * CHUNK + slot[None, :]
            ok_slot = (c * CHUNK + slot[None, :]) < cn[:, None]
            fidx = face_s[torch.clamp(sl, 0, last).long()]  # (nt, CHUNK)
            fc = rows[fidx.long()]  # (nt, CHUNK, 9)
            x0, y0, x1, y1, x2, y2, z0, z1, z2 = (
                fc[..., i][..., None] for i in range(ROW_FLOATS))
            d = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
            nondeg = torch.abs(d) > 1e-12
            inv_d = torch.where(nondeg, 1.0 / d, torch.zeros_like(d))
            l1 = ((pxb - x0) * (y2 - y0) - (pyb - y0) * (x2 - x0)) * inv_d
            l2 = ((pyb - y0) * (x1 - x0) - (pxb - x0) * (y1 - y0)) * inv_d
            l0 = 1.0 - l1 - l2
            inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & nondeg \
                & ok_slot[..., None]
            z = z0 * l0 + z1 * l1 + z2 * l2
            z = torch.where(inside, z, torch.full_like(z, Z_FAR))
            zmin = z.min(dim=1).values  # (nt, pix)
            # First slot that attains the minimum (torch's argmin does not
            # promise the first index on every device).
            amin = torch.where(z == zmin[:, None, :], slot[None, :, None],
                               CHUNK).min(dim=1).values.long()
            upd = zmin < best_z

            def take(a):
                return torch.gather(a.expand(nt, CHUNK, pix), 1,
                                    amin[:, None, :])[:, 0]

            best_f = torch.where(upd, take(fidx[..., None]), best_f)
            best_u = torch.where(upd, take(l1), best_u)
            best_v = torch.where(upd, take(l2), best_v)
            best_z = torch.where(upd, zmin, best_z)
        outs.append((best_z, best_f, best_u, best_v))
    bz, bf, bu, bv = (torch.cat(x) for x in zip(*outs))
    depth = _untile(bz, ntx, nty, ts, width, height).contiguous()
    face_id = _untile(bf, ntx, nty, ts, width, height).contiguous()
    bary = _untile(torch.stack([bu, bv], -1), ntx, nty, ts, width,
                   height).contiguous()
    return depth, face_id, bary


def tile_face_lists(
    verts: Tensor,
    faces: Tensor,
    camera: RasterCamera,
    cfg: MeshRasterConfig,
    faces_valid: Optional[Tensor] = None,
):
    """Project the mesh and bin its faces into tiles.

    Returns (verts_screen, verts_zw, resolve_args): the differentiable
    projections, and the argument tuple of `resolve_tiles` /
    `resolve_tiles_plain`, computed without gradients (visibility is
    discrete — its inputs are frozen).
    """
    verts_screen, verts_zw, vert_valid = project_vertices(
        verts, camera, cfg.near
    )
    with torch.no_grad():
        rows, tiles, rect, ntx, nty = _face_fields(
            verts_screen.detach(), verts_zw.detach(), vert_valid, faces,
            faces_valid, camera, cfg,
        )
        face_s, starts, counts = _expand_pairs(
            tiles, rect, ntx, nty, cfg.pair_budget
        )
    return verts_screen, verts_zw, (
        rows, face_s, starts, counts, ntx, nty, cfg.tile_size,
        camera.width, camera.height,
    )


def rasterize_mesh(
    verts: Tensor,
    faces: Tensor,
    camera: RasterCamera,
    cfg: MeshRasterConfig = MeshRasterConfig(),
    faces_valid: Optional[Tensor] = None,
) -> RasterOutput:
    """Resolve per-pixel visibility of a triangle mesh.

    Args:
      verts: (V, 3) world positions.
      faces: (F, 3) int32.
      faces_valid: optional (F,) bool mask (budgeted meshes).
    """
    verts_screen, verts_zw, args = tile_face_lists(verts, faces, camera, cfg,
                                                   faces_valid)
    with torch.no_grad():
        depth, face_id, bary = resolve_tiles_plain(*args)
        num_pairs = torch.sum(args[3], dtype=torch.int32)
    return RasterOutput(
        face_id=face_id,
        bary=bary,
        depth=depth,
        verts_screen=verts_screen,
        verts_zw=verts_zw,
        num_pairs=num_pairs,
    )
