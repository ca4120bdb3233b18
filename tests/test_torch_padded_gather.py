"""The port's padded gather: `index_select`'s forward bit for bit, and a
backward that sends the padding slots to spread dump rows instead of
adding them all onto the pad row (`ops/padded_gather.py`), at the sites
that use it (interpolation, vertex normals, normal consistency)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from youreditableavatar_tpu_torch.ops import padded_gather as pgm
from youreditableavatar_tpu_torch.ops.mesh_raster import interpolate


def _padded(seed, n=40, m=900, cols=(5,), share=0.6, dtype=torch.int64):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(n,) + cols).astype(np.float32),
                     requires_grad=True)
    idx = np.where(rng.random(m) < share, 0, rng.integers(1, n, m))
    g = torch.tensor(rng.normal(size=(m,) + cols).astype(np.float32))
    return x, torch.tensor(idx, dtype=dtype), g


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("cols", [(), (3,), (2, 4)])
def test_forward_is_index_select(dtype, cols):
    x, idx, _ = _padded(1, cols=cols, dtype=dtype)
    want = x.detach().index_select(0, idx)
    assert torch.equal(pgm.gather_rows(x, idx), want)
    idx2 = idx[:900].reshape(30, 30)
    assert torch.equal(pgm.gather_rows(x, idx2),
                       x.detach().index_select(0, idx2.reshape(-1))
                       .reshape((30, 30) + cols))


@pytest.mark.parametrize("m", [50, 900])
@pytest.mark.parametrize("cols", [(), (3,), (16,)])
def test_gradient_equals_index_select(m, cols):
    """Many slots on row 0: every row's gradient equals index_select's
    autograd to 1e-6 of max|g|."""
    x, idx, g = _padded(2, m=m, cols=cols)
    got = torch.autograd.grad(pgm.gather_rows(x, idx), x, g)[0]
    want = torch.autograd.grad(x.index_select(0, idx), x, g)[0]
    tol = 1e-6 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert int((idx == 0).sum()) > m // 3


@pytest.mark.parametrize("cols", [(), (3,), (16,)])
def test_gradient_equals_index_select_past_the_dump_rows(cols):
    """20,000 slots, ~12,000 on row 0: several padding slots share each
    dump row. Integer-valued cotangents make every f32 sum exact in any
    order, so the gradients are equal bit for bit."""
    x, idx, g = _padded(2, m=20_000, cols=cols)
    g = torch.round(g * 4)
    got = torch.autograd.grad(pgm.gather_rows(x, idx), x, g)[0]
    want = torch.autograd.grad(x.index_select(0, idx), x, g)[0]
    assert torch.equal(got, want)
    assert int((idx == 0).sum()) > 2 * pgm.DUMP_ROWS


def test_gradient_exact_when_padding_carries_zero():
    """Where the row-0 slots carry zero gradient the result is index_add_'s
    bit for bit (every other row sums the same slots in the same order)."""
    x, idx, g = _padded(3, m=2000, cols=(3,))
    g = torch.where((idx == 0)[:, None], torch.zeros_like(g), g)
    got = torch.autograd.grad(pgm.gather_rows(x, idx), x, g)[0]
    want = torch.autograd.grad(x.index_select(0, idx), x, g)[0]
    assert torch.equal(got, want)


def test_pad_mask_and_tensor_pad_row():
    """A mask of padding slots that all read row 7 (a 0-d tensor), as the
    background pixels read face 0's corners; and `pad_row=None` drops them."""
    x, idx, g = _padded(4, m=1500, cols=(2,))
    idx = torch.where(idx == 0, torch.full_like(idx, 7), idx)
    pad = torch.tensor(np.random.default_rng(4).random(1500) < 0.5) & (idx == 7)
    want = torch.autograd.grad(x.index_select(0, idx), x, g)[0]
    got = torch.autograd.grad(pgm.gather_rows(x, idx, pad=pad,
                                              pad_row=torch.tensor(7)), x, g)[0]
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    dropped = torch.autograd.grad(pgm.gather_rows(x, idx, pad=pad,
                                                  pad_row=None), x, g)[0]
    keep = torch.where(pad[:, None], torch.zeros_like(g), g)
    assert torch.equal(dropped, torch.zeros_like(x).index_add_(0, idx, keep))
    with pytest.raises(ValueError):
        pgm.gather_rows(x, idx, pad_row=None)


@pytest.mark.parametrize("pad_row", [0, 7])
def test_int_and_tensor_pad_row_agree(pad_row):
    """An int pad row and the same row as a 0-d tensor: the same padding
    slots and the same gradient, bit for bit."""
    x, idx, g = _padded(7, m=1200, cols=(3,))
    idx = torch.where(idx == 0, torch.full_like(idx, pad_row), idx)
    got = [torch.autograd.grad(pgm.gather_rows(x, idx, pad_row=r), x, g)[0]
           for r in (pad_row, torch.tensor(pad_row))]
    assert torch.equal(got[0], got[1])
    want = torch.autograd.grad(x.index_select(0, idx), x, g)[0]
    torch.testing.assert_close(got[0], want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


def test_scatter_add_rows_drops_padding():
    rng = np.random.default_rng(5)
    idx = torch.tensor(rng.integers(0, 30, 5000))
    src = torch.tensor(rng.normal(size=(5000, 3)).astype(np.float32),
                       requires_grad=True)
    pad = torch.tensor(rng.random(5000) < 0.7)
    got = pgm.scatter_add_rows(30, idx, src, pad)
    keep = torch.where(pad[:, None], torch.zeros_like(src), src)
    assert torch.equal(got, torch.zeros(30, 3).index_add(0, idx[~pad], src[~pad]))
    torch.testing.assert_close(got, torch.zeros(30, 3).index_add(0, idx, keep),
                               rtol=0, atol=1e-5)
    gout = torch.tensor(rng.normal(size=(30, 3)).astype(np.float32))
    gs = torch.autograd.grad(got, src, gout)[0]
    assert torch.equal(gs[~pad], gout[idx[~pad]])
    assert torch.equal(gs[pad], torch.zeros_like(gs[pad]))
    assert torch.equal(pgm.scatter_add_rows(30, idx, src, None),
                       torch.zeros(30, 3).index_add(0, idx, src))


def test_dump_rows():
    assert pgm.dump_rows(100, 16) == 100
    assert pgm.dump_rows(10**6, 16) == 1024
    assert pgm.dump_rows(10**6, 2) == pgm.DUMP_ROWS
    assert pgm.dump_rows(10**6, 1000) == 256
    assert pgm.dump_rows(0, 3) == 1


def _normals_reference(verts, faces, faces_valid):
    """The vertex normals as `index_select` gathers and three `index_add`s."""
    f = faces.long()
    p0, p1, p2 = (verts.index_select(0, f[:, i]) for i in range(3))
    fn = torch.linalg.cross(p1 - p0, p2 - p0)
    fn = torch.where(faces_valid[:, None], fn, torch.zeros_like(fn))
    vn = torch.zeros_like(verts)
    for i in range(3):
        vn = vn.index_add(0, f[:, i], fn)
    return vn * torch.rsqrt(torch.sum(vn * vn, dim=-1, keepdim=True) + 1e-20)


def test_vertex_normals_match_the_index_add_formula():
    """Padded faces (all corners on row 0) dropped from the gathers and the
    scatter: the same normals and vertex gradients."""
    from chip_smoke import icosphere

    v, f = icosphere(2)
    pad_faces = 200
    faces = torch.tensor(np.concatenate([f, np.zeros((pad_faces, 3), np.int64)]),
                         dtype=torch.int32)
    valid = torch.arange(len(faces)) < len(f)
    g = torch.tensor(np.random.default_rng(6).normal(size=v.shape)
                     .astype(np.float32))
    outs = []
    for fn in (interpolate.compute_vertex_normals, _normals_reference):
        verts = torch.tensor(v, requires_grad=True)
        vn = fn(verts, faces, valid)
        outs.append((vn.detach(), torch.autograd.grad(vn, verts, g)[0]))
    (a, ga), (b, gb) = outs
    assert torch.equal(a, b)
    torch.testing.assert_close(ga, gb, rtol=0, atol=1e-6 * float(gb.abs().max()))
