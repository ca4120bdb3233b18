"""PyTorch port: the compositing forward's per-warp cull (K1f), on the CPU.

The kernel runs each 32×32 tile as a cluster of 4 CTAs, one 16×16 quarter
each, every warp on a compact 8×4 pixel block, and a warp skips every pair
whose conservative α ≥ 1/255 box (`cull_box`) misses its block. The plain
scan is also held to the 16×8 blocks of a layout with one CTA per tile
(the backward's warp blocks).
That is exact: the plain scan masked the same way
(`composite_tiles_plain(cull_block=...)`) gives every output and every
checkpoint of the uncull scan bit for bit, on the scene layouts, on the
layout built against the cull and with Gaussians centred on block edges.
The kernel-vs-plain test at the end needs a CUDA card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import adversarial_layout
from torch_port_helpers import (
    composite_layout,
    cuda_device,  # noqa: F401  (fixture)
    single_threaded_torch,  # noqa: F401  (fixture)
)
from youreditableavatar_tpu_torch.ops.gaussian_raster import composite_cuda as cc

# Warp blocks: 16×8 (one CTA per tile, as in the backward) and 8×4 (the
# forward kernel's: a 16×16 quarter per CTA of the cluster).
BLOCKS = [(cc.BLOCK_W, cc.BLOCK_H), (cc.FWD_BLOCK_W, cc.FWD_BLOCK_H)]


@pytest.fixture(scope="module", params=["sparse", "opaque"])
def layout(request):
    return composite_layout(request.param)[1:]


def _culled_equals_uncull(fields, pg, starts, counts, ntx, nty, block):
    """Assert the culled plain forward bit-equal to the uncull one (rgb,
    final T, n_contrib, checkpoint state, packed and swept); return the
    live evaluations (uncull, culled)."""
    ref = cc.composite_tiles_plain(fields, pg, starts, counts, ntx, nty,
                                   return_evals=True, return_checkpoints=True)
    got = cc.composite_tiles_plain(fields, pg, starts, counts, ntx, nty,
                                   return_evals=True, return_checkpoints=True,
                                   cull_block=block)
    for name, a, b in zip(("rgb", "final_t", "n_contrib"), ref[:3], got[:3]):
        assert torch.equal(a, b), f"{name} differs with {block} blocks"
    for name, a, b in zip(cc.Checkpoints._fields, ref[4], got[4]):
        assert torch.equal(a, b), f"checkpoint {name} differs with {block}"
    assert got[3] <= ref[3]
    return ref[3], got[3]


@pytest.mark.parametrize("block", BLOCKS)
def test_culled_forward_is_bit_equal(layout, block):
    """The scene layouts: the cull removes over 30% of the live
    evaluations (the opaque scene's wide Gaussians the fewest) and changes
    no bit."""
    evals, left = _culled_equals_uncull(*layout, 2, 2, block)
    assert left < 0.7 * evals


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("block", BLOCKS)
def test_culled_forward_on_adversarial_layout(seed, block):
    """The layout built against the cull (chip_smoke.py's, at 3 × 2
    tiles): σ up to 120 px across tile edges, opacities at and just above
    1/255, opaque pairs (early stops), indefinite conics."""
    fields, pg, starts, counts = adversarial_layout("cpu", seed, 3, 2, 300)
    _culled_equals_uncull(fields, pg, starts, counts, 3, 2, block)


ALPHA_MIN_F32 = float(np.float32(1.0 / 255.0))


@st.composite
def edge_layouts(draw):
    """A 2 × 1 tile layout of 4–24 Gaussians whose means sit on or next
    to the x edges of the 8-px and y edges of the 4-px block grid (exactly
    on, ±1e-3, ±0.5 and ±1 px), thin to wide, faint to opaque; every tile
    holds every Gaussian in index order."""
    n = draw(st.integers(4, 24))
    off = st.sampled_from([0.0, 1e-3, -1e-3, 0.5, -0.5, 1.0, -1.0])
    fields = np.zeros((n + 1, 16), np.float32)
    for i in range(1, n + 1):
        s1 = draw(st.floats(0.3, 24.0))
        s2 = s1 * draw(st.floats(0.05, 1.0))
        th = draw(st.floats(0.0, np.pi))
        c, s = np.cos(th), np.sin(th)
        i1, i2 = 1 / s1 ** 2, 1 / s2 ** 2
        fields[i, 0] = 8 * draw(st.integers(0, 8)) + draw(off)
        fields[i, 1] = 4 * draw(st.integers(0, 8)) + draw(off)
        fields[i, 2:5] = (c * c * i1 + s * s * i2, c * s * (i1 - i2),
                          s * s * i1 + c * c * i2)
        fields[i, 5] = draw(st.one_of(
            st.floats(1e-6, 0.05).map(lambda e: ALPHA_MIN_F32 * (1 + e)),
            st.floats(0.004, 1.0), st.just(1.0)))
        fields[i, 6:9] = draw(st.floats(0.0, 1.0)), 0.5, 1.0
        fields[i, 9] = i
    pg = np.zeros(2 * cc.CHUNK, np.int32)
    pg[:n] = pg[cc.CHUNK:cc.CHUNK + n] = np.arange(1, n + 1)
    return (torch.tensor(fields), torch.tensor(pg),
            torch.tensor([0, cc.CHUNK], dtype=torch.int32),
            torch.tensor([n, n], dtype=torch.int32))


@settings(max_examples=40, deadline=None, database=None, derandomize=True)
@given(edge_layouts())
def test_culled_forward_with_gaussians_on_block_edges(layout_):
    for block in BLOCKS:
        _culled_equals_uncull(*layout_, 2, 1, block)


# On the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_forward_kernel_on_card(layout, cuda_device):
    """K1f, indexed and over direct rows, with and without the checkpoint
    store, against the plain scan on the card: images within 1e-5,
    n_contrib and the checkpoints of every swept batch equal, the store
    changing no bit."""
    fields, pg, starts, counts = (x.to(cuda_device) for x in layout)
    rgb, t, cnt, ck = cc.composite_tiles_plain(fields, pg, starts, counts, 2,
                                               2, return_checkpoints=True)
    _, _, b = cc.swept_batches(ck, starts)
    rows = fields[pg.long()]
    for src, ids in ((fields, pg), (rows, None)):
        out = cc._forward(src, ids, starts, counts, 2, True)
        bare = cc._forward(src, ids, starts, counts, 2, False)
        for a, z in zip(out[:3], bare[:3]):
            assert torch.equal(a, z)
        assert float((out[0] - rgb).abs().max()) <= 1e-5
        assert float((out[1] - t).abs().max()) <= 1e-5
        assert torch.equal(out[2], cnt)
        assert torch.equal(out[3].swept, ck.swept)
        assert torch.equal(out[3].state[b], ck.state[b])
        assert torch.equal(out[3].packed[b], ck.packed[b])
