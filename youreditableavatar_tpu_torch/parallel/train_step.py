"""Sharded photometric train step: views over `data`, tile rows over `tile`.

Counterpart of `youreditableavatar_tpu/parallel/train_step.py` (its Pallas
branch; the port has no `"xla"` backend). One process per rank of a
(data, tile) `DeviceMesh`:

  * every rank holds the whole stacked batch; data rank r renders views
    [r·v, (r+1)·v);
  * within a view, the per-Gaussian preprocess is repeated on every tile
    rank (N-sized, identical by construction), while the pair layout (K2,
    K3a, K3b), the gathered pair rows and the compositing (K1f, K6) cover
    only the rank's own band of tile rows. The bands are all-gathered over
    the tile group and every tile rank evaluates the same full-image loss
    (exact SSIM: no window crosses a band edge unseen);
  * the gather's backward hands each rank only its own band's slice of the
    cotangent, so a rank's gradient is its band's share; one all-reduce
    (sum) over the world of all gradient leaves, divided by the data size,
    gives every rank the mean gradient over the views. (In JAX the gather's
    transpose hands every band K copies of its cotangent and `pmean` over
    (data, tile) divides them out.)

Parameters start replicated by construction (same inputs on every rank);
`utils.misc.assert_replicated` checks it.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh

from youreditableavatar_tpu_torch.models.tetgs import (
    TetGSBinding,
    TetGSParams,
    gaussian_arrays,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_cuda import (
    composite_tiles,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_xla import (
    assemble_image,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.preprocess import (
    preprocess_gaussians,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
    RasterizeConfig,
    build_pair_layout_counting,
    gather_pair_rows,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.types import RasterCamera
from youreditableavatar_tpu_torch.ops.image_losses import l1_dssim


def _shard_proj_rows(proj, row_lo: int, rows_loc: int, tile_size: int):
    """Restrict a projection to the band of tile rows [row_lo, row_lo +
    rows_loc): every Gaussian's tile rect is clipped to it, and the rect and
    the screen mean move into the band's frame, so the unmodified layout and
    compositing run on the band as if it were the whole screen. Gaussians
    whose rect misses the band get tiles_touched 0 and no pairs."""
    y_shift = float(row_lo * tile_size)
    rmin_y = torch.clamp(proj.rect_min[:, 1] - row_lo, 0, rows_loc)
    rmax_y = torch.clamp(proj.rect_max[:, 1] - row_lo, 0, rows_loc)
    w_t = torch.clamp(proj.rect_max[:, 0] - proj.rect_min[:, 0], min=0)
    h_t = torch.clamp(rmax_y - rmin_y, min=0)
    tiles = torch.where(proj.tiles_touched > 0, w_t * h_t,
                        torch.zeros_like(w_t))
    shift = torch.tensor([0.0, y_shift], dtype=proj.mean2d.dtype,
                         device=proj.mean2d.device)
    return proj._replace(
        mean2d=proj.mean2d - shift,
        rect_min=torch.stack([proj.rect_min[:, 0], rmin_y], dim=-1),
        rect_max=torch.stack([proj.rect_max[:, 0], rmax_y], dim=-1),
        tiles_touched=tiles,
    )


def render_band(means, scales, quats, opac, sh, camera: RasterCamera,
                cfg: RasterizeConfig, band: int, n_bands: int,
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Composite band `band` of `n_bands` equal bands of tile rows.

    Returns (rgb (T_band, 3, 1024), final_t (T_band, 1024), the count of the
    band's tiles over `cfg.tile_capacity`, a diagnostic: nothing is cut).
    `cfg.pair_budget` is the band's own budget. The layout is the counting
    one (K2, K3a, K3b), the rows one `index_select` gather, the compositing
    K1f with K6 as its gradient.
    """
    ts = cfg.tile_size
    ntx = -(-camera.width // ts)
    nty = -(-camera.height // ts)
    if nty % n_bands != 0:
        raise ValueError(f"{nty} tile rows not divisible by {n_bands} bands "
                         f"(bands are whole tile rows)")
    rows_loc = nty // n_bands
    proj = preprocess_gaussians(means, scales, quats, opac, sh, camera,
                                cfg.sh_degree, ts, cfg.scale_mod,
                                rect_mode=cfg.rect_mode)
    proj_loc = _shard_proj_rows(proj, band * rows_loc, rows_loc, ts)
    fields_ext, pg_padded, astart, tile_count, _ = build_pair_layout_counting(
        proj_loc, ntx, rows_loc, cfg.pair_budget, ts)
    rgb, final_t, _ = composite_tiles(gather_pair_rows(fields_ext, pg_padded),
                                      astart, tile_count, ntx, rows_loc, ts,
                                      cfg.chunk)
    overflow = torch.sum(tile_count > cfg.tile_capacity, dtype=torch.int32)
    return rgb, final_t, overflow


class _GatherBands(torch.autograd.Function):
    """All-gather of equal bands along dim 0 over `group`; the backward
    returns this rank's own slice of the cotangent, with no communication
    (every rank of the group differentiates the same loss)."""

    @staticmethod
    def forward(ctx, x, group, band, n_bands):
        x = x.contiguous()
        out = x.new_empty((n_bands * x.shape[0],) + tuple(x.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, x, group=group)
        ctx.band, ctx.rows = band, x.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        lo = ctx.band * ctx.rows
        return g[lo: lo + ctx.rows], None, None, None


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _render_tile_sharded(means, scales, quats, opac, sh, camera: RasterCamera,
                         cfg: RasterizeConfig, bg: Tensor, mesh: DeviceMesh,
                         tile_axis: str = "tile"):
    """Render one view with the tile rows split over `tile_axis`; every
    rank of the tile group gets the whole image. Returns (image (H, W, 3),
    this rank's count of tiles over `cfg.tile_capacity`)."""
    group = mesh.get_group(tile_axis)
    n_bands = _axis_size(mesh, tile_axis)
    band = dist.get_rank(group)
    rgb, final_t, overflow = render_band(means, scales, quats, opac, sh,
                                         camera, cfg, band, n_bands)
    # One collective for both planes: (T_band, 4, 1024) = rgb + final T.
    both = _GatherBands.apply(torch.cat([rgb, final_t[:, None]], dim=1),
                              group, band, n_bands)
    ts = cfg.tile_size
    img, t_all = assemble_image(both[:, :3], both[:, 3], -(-camera.width // ts),
                                -(-camera.height // ts), ts, camera.width,
                                camera.height)
    return img + t_all[..., None] * bg, overflow


def make_sharded_render_train_step(
    binding: TetGSBinding,
    optimizer,
    cfg: RasterizeConfig,
    mesh: DeviceMesh,
    height: int,
    width: int,
    bg: Tensor | None = None,
    dssim_factor: float = 0.2,
    data_axis: str = "data",
    tile_axis: str = "tile",
) -> Callable:
    """Build the sharded train step.

    `optimizer` (a `TetGSOptimizer` over the parameters the step is given)
    takes the place of the JAX optax transformation: a torch optimizer
    holds its own state. The returned `step(params, batch)` takes the whole
    stacked batch on every rank — viewmats (B, 4, 4), fx/fy/cx/cy (B,),
    images (B, H, W, 3), B = data size × views per rank — backpropagates the
    mean loss of the rank's views, leaves the combined gradient in each
    leaf's `.grad`, steps the optimizer in place and returns (params,
    optimizer, loss, num_tile_overflow): the mean loss over all views and
    the count of tiles over `cfg.tile_capacity` summed over views and bands
    (a diagnostic: nothing is cut).
    """
    dev = binding.ori_points.device
    bg = (torch.zeros(3, device=dev) if bg is None
          else torch.as_tensor(bg, dtype=torch.float32, device=dev))
    n_data = _axis_size(mesh, data_axis)
    n_tile = _axis_size(mesh, tile_axis)
    data_rank = mesh.get_local_rank(data_axis)

    def step(params: TetGSParams, batch: Dict[str, Tensor]):
        b = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
             for k, v in batch.items()}
        total = b["viewmats"].shape[0]
        if total % n_data != 0:
            raise ValueError(f"{total} views not divisible by the data axis "
                             f"{n_data}")
        per = total // n_data
        optimizer.zero_grad()
        means, scales, quats, opac, sh = gaussian_arrays(binding, params)
        losses = []
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        for i in range(data_rank * per, (data_rank + 1) * per):
            cam = RasterCamera(viewmat=b["viewmats"][i], fx=b["fx"][i],
                               fy=b["fy"][i], cx=b["cx"][i], cy=b["cy"][i],
                               width=width, height=height)
            img, of = _render_tile_sharded(means, scales, quats, opac, sh,
                                           cam, cfg, bg, mesh, tile_axis)
            losses.append(l1_dssim(img, b["images"][i], dssim_factor))
            overflow = overflow + of
        loss = torch.stack(losses).mean()
        loss.backward()

        # One all-reduce for every gradient leaf, the loss and the overflow.
        leaves = list(params.parameters())
        flat = torch.cat(
            [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
             for p in leaves]
            + [loss.detach().reshape(1), overflow.to(torch.float32).reshape(1)])
        dist.all_reduce(flat)
        off = 0
        for p in leaves:
            p.grad = flat[off: off + p.numel()].view_as(p) / n_data
            off += p.numel()
        optimizer.step()
        return (params, optimizer, flat[off] / (n_data * n_tile),
                flat[off + 1].round().to(torch.int32))

    return step
