"""PyTorch port vs the JAX package: the non-fused compositing over gathered
pair rows (`composite_tiles`, kernels K1f + K6) and its pair-row layout.

The JAX side runs `composite_tiles_pallas` interpreted on the CPU, as
`test_raster_pallas.py` does; the port runs the plain PyTorch version of
its kernels. The kernel-vs-plain test at the end needs a CUDA card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    cuda_device,  # noqa: F401  (fixture)
    jax_camera,
    random_scene,
    single_threaded_torch,  # noqa: F401  (fixture)
    to_torch_proj,
)

W = H = 64
BUDGET = 4096
GRAD_RTOL_OF_MAX = 5e-5  # per column, as the JAX suite holds its backends


@pytest.fixture(scope="module")
def layout():
    """The JAX projection, sort-path binning and pair rows of a 64×64 scene
    of 700 Gaussians with colours (200–270 pairs a tile)."""
    from youreditableavatar_tpu.ops.gaussian_raster.binning import bin_gaussians
    from youreditableavatar_tpu.ops.gaussian_raster.preprocess import (
        preprocess_gaussians,
    )
    from youreditableavatar_tpu.ops.gaussian_raster.render import (
        build_pallas_pair_rows,
    )

    scene, vm, _, _ = random_scene(11, 700, W, H, scale_hi=0.1)
    cam = jax_camera(vm, 0.8, 0.8, W, H)
    proj = preprocess_gaussians(
        *(jnp.asarray(scene[k]) for k in ("means", "scales", "quats", "opac")),
        jnp.zeros((700, 1, 3)), cam, 0, 32,
        colors_override=jnp.asarray(scene["colors"]))
    binning = bin_gaussians(proj, 2, 2, BUDGET, 32)
    rows, astart = build_pallas_pair_rows(proj, binning, 2, 2, BUDGET)
    return proj, binning, np.asarray(rows), np.asarray(astart)


def _real_slots(astart, counts):
    return np.concatenate([np.arange(s, s + c) for s, c in zip(astart, counts)])


def _cotangents(num_t, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(num_t, 3, 1024)).astype(np.float32),
            rng.normal(size=(num_t, 1024)).astype(np.float32))


def test_composite_tiles_matches_jax(layout):
    """Image, final T and n_contrib to 1e-6; the per-pair gradient rows on
    real pairs to 5e-5·max|g| per column (the JAX padding rows are not
    compared: its kernel leaves them unspecified)."""
    from youreditableavatar_tpu.ops.gaussian_raster.composite_pallas import (
        composite_tiles_pallas,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_cuda import (
        composite_tiles,
    )

    _, binning, rows, astart = layout
    counts = np.asarray(binning.tile_count)
    drgb, dt = _cotangents(len(counts))

    def jfn(r):
        rgb, t, _ = composite_tiles_pallas(r, jnp.asarray(astart),
                                           jnp.asarray(counts), 2, 2, 32, True)
        return rgb, t

    (jrgb, jt), vjp = jax.vjp(jfn, jnp.asarray(rows))
    (jg,) = vjp((jnp.asarray(drgb), jnp.asarray(dt)))
    jcnt = composite_tiles_pallas(jnp.asarray(rows), jnp.asarray(astart),
                                  jnp.asarray(counts), 2, 2, 32, True)[2]

    tr = torch.tensor(rows, requires_grad=True)
    trgb, tt, tcnt = composite_tiles(tr, torch.tensor(astart),
                                     torch.tensor(counts), 2, 2)
    ((trgb * torch.tensor(drgb)).sum() + (tt * torch.tensor(dt)).sum()).backward()

    np.testing.assert_allclose(trgb.detach().numpy(), np.asarray(jrgb), atol=1e-6)
    np.testing.assert_allclose(tt.detach().numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt).astype(np.int32))
    assert tcnt.dtype == torch.int32 and not tcnt.requires_grad
    real = _real_slots(astart, counts)
    g_t, g_j = tr.grad.numpy()[real], np.asarray(jg)[real]
    for col in range(9):
        tol = GRAD_RTOL_OF_MAX * max(np.abs(g_j[:, col]).max(), 1e-6)
        np.testing.assert_allclose(g_t[:, col], g_j[:, col], rtol=0, atol=tol,
                                   err_msg=f"column {col}")
    assert np.abs(g_j[:, :9]).max() > 0
    np.testing.assert_array_equal(tr.grad.numpy()[:, 9:], 0.0)


def test_pair_gradient_is_zero_off_real_pairs(layout):
    """Padding slots, inside the tiles' aligned ranges and after them, get
    zero rows (the kernel writes every slot of a range; the buffer starts
    at zero)."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_cuda import (
        composite_tiles,
    )

    _, binning, rows, astart = layout
    counts = np.asarray(binning.tile_count)
    tr = torch.tensor(rows, requires_grad=True)
    rgb, t, _ = composite_tiles(tr, torch.tensor(astart), torch.tensor(counts),
                                2, 2)
    (rgb.sum() + t.sum()).backward()
    pad = np.ones(len(rows), bool)
    pad[_real_slots(astart, counts)] = False
    assert pad.sum() > 0
    np.testing.assert_array_equal(tr.grad.numpy()[pad], 0.0)


def test_pair_rows_match_jax_bit_exact(layout):
    """`build_pallas_pair_rows` from the same sort-path binning, and the
    counting layout's gathered rows, equal the JAX rows bit for bit."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import types
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        build_pair_layout_counting,
        build_pallas_pair_rows,
        gather_pair_rows,
    )

    proj, binning, rows, astart = layout
    pt = to_torch_proj(proj)
    bt = types.TileBinning(*(torch.tensor(np.asarray(x)) for x in binning))
    t_rows, t_astart = build_pallas_pair_rows(pt, bt, 2, 2, BUDGET)
    np.testing.assert_array_equal(t_rows.detach().numpy(), rows)
    np.testing.assert_array_equal(t_astart.numpy(), astart)

    fields, pg, c_astart, c_counts, total = build_pair_layout_counting(
        pt, 2, 2, BUDGET, 32)
    np.testing.assert_array_equal(gather_pair_rows(fields, pg).detach().numpy(),
                                  rows)
    np.testing.assert_array_equal(c_astart.numpy(), astart)
    np.testing.assert_array_equal(c_counts.numpy(), np.asarray(binning.tile_count))
    assert int(total) == int(binning.num_pairs)


def test_gather_backward_is_index_add():
    """The pair-row gather differentiates into `index_add_` (atomics on the
    card), not the sort-based backward of `x[idx]`; both sum alike on every
    Gaussian's row. The padding slots (row 0, the layout's zero row, whose
    gradient no caller keeps) go to spread dump rows and are dropped."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        gather_pair_rows,
    )

    rng = np.random.default_rng(5)
    fields = torch.tensor(rng.normal(size=(50, 16)).astype(np.float32),
                          requires_grad=True)
    pg = torch.tensor(np.where(rng.random(600) < 0.4, 0,
                               rng.integers(1, 50, 600)).astype(np.int32))
    rows = gather_pair_rows(fields, pg)
    assert torch.equal(rows, fields.detach()[pg.long()])
    assert type(rows.grad_fn).__name__.startswith("_PaddedGatherBackward")
    g = torch.tensor(rng.normal(size=(600, 16)).astype(np.float32))
    rows.backward(g)
    want = torch.zeros(50, 16).index_add_(0, pg.long(), g)
    torch.testing.assert_close(fields.grad[1:], want[1:], rtol=0, atol=1e-5)
    assert torch.equal(fields.grad[0], torch.zeros(16))


def test_pair_gradient_sums_to_the_fused_gradient(layout):
    """Per-pair rows summed onto the Gaussians by the gather's backward
    equal the fused compositing's per-Gaussian gradient (both plain)."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_cuda import (
        composite_tiles, composite_tiles_fused,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        build_pair_layout_counting, gather_pair_rows,
    )

    pt = to_torch_proj(layout[0])
    fields, pg, astart, counts, _ = build_pair_layout_counting(pt, 2, 2,
                                                              BUDGET, 32)
    drgb, dt = (torch.tensor(x) for x in _cotangents(4, seed=7))
    grads = []
    for pairs in (True, False):
        f = fields.detach().clone().requires_grad_()
        if pairs:
            rgb, t, _ = composite_tiles(gather_pair_rows(f, pg), astart,
                                        counts, 2, 2)
        else:
            rgb, t, _ = composite_tiles_fused(f, pg, astart, counts, 2, 2)
        ((rgb * drgb).sum() + (t * dt).sum()).backward()
        grads.append(f.grad[:, :9])
    scale = grads[1].abs().amax(0).clamp(min=1e-6)
    assert float(((grads[0] - grads[1]).abs() / scale).max()) <= 1e-5


def test_composite_tiles_needs_tile_32():
    from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_cuda import (
        composite_tiles,
    )

    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile_size == 32"):
        composite_tiles(torch.zeros(512, 16), z, z, 2, 2, tile_size=16)


@pytest.mark.cuda
def test_pairs_kernel_matches_plain_on_card(layout, cuda_device):
    """K1f (direct rows) and K6 against the plain version on the card: the
    forward to 1e-5, the rows to 5e-5·max|g| per column, two launches bit
    for bit equal."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import composite_cuda as cc

    _, binning, rows, astart = layout
    counts = np.asarray(binning.tile_count)
    drgb, dt = (torch.tensor(x, device=cuda_device) for x in _cotangents(4))
    args = (torch.tensor(astart, device=cuda_device),
            torch.tensor(counts, device=cuda_device))
    out = {}
    for name, fn in (("kernel", cc.composite_tiles),
                     ("plain", cc.composite_tiles_pairs_plain)):
        r = torch.tensor(rows, device=cuda_device, requires_grad=True)
        rgb, t, _ = fn(r, *args, 2, 2)
        g = torch.autograd.grad((rgb * drgb).sum() + (t * dt).sum(), r)[0]
        out[name] = (rgb, g)
    assert float((out["kernel"][0] - out["plain"][0]).abs().max()) <= 1e-5
    gk, gp = out["kernel"][1], out["plain"][1]
    tol = GRAD_RTOL_OF_MAX * gp.abs().amax(0).clamp(min=1e-6)
    assert bool(((gk - gp).abs() <= tol).all())
    rgb, t, _, ckpt = cc._forward_rows(torch.tensor(rows, device=cuda_device),
                                       *args, 2, save=True)
    again = [cc.backward_pairs(torch.tensor(rows, device=cuda_device), *args,
                               rgb, t, drgb, dt, 2, ckpt) for _ in range(2)]
    assert torch.equal(again[0], again[1])
