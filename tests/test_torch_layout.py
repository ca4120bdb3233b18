"""PyTorch port vs the JAX package: preprocess and the pair layout.

The JAX side runs its Pallas layout kernels (`expand_pallas.py`,
`counting.py`) interpreted on the CPU, as `test_raster_pallas.py` does; the
port runs the plain PyTorch versions of its CUDA kernels. Layouts must
agree bit for bit. The kernel-vs-plain tests at the end need a CUDA card.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    EXPAND_CASES,
    HIST_CASES,
    RANK_CASES,
    cuda_device,  # noqa: F401  (fixture)
    expand_case,
    hist_case,
    jax_camera,
    rank_case,
    random_scene,
    single_threaded_torch,  # noqa: F401  (fixture)
    to_torch_proj,
    torch_camera,
)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_proj(n, seed, width=96, height=64, sh_degree=0, rect_mode="support",
              scale_hi=0.1, fov=(0.8, 0.6)):
    from youreditableavatar_tpu.ops.gaussian_raster.preprocess import (
        preprocess_gaussians,
    )

    scene, vm, w, h = random_scene(seed, n, width, height, scale_hi)
    sh = np.random.default_rng(seed + 1).normal(
        size=(n, (sh_degree + 1) ** 2, 3)).astype(np.float32) * 0.3
    cam = jax_camera(vm, *fov, w, h)
    proj = preprocess_gaussians(
        *(jnp.asarray(scene[k]) for k in ("means", "scales", "quats", "opac")),
        jnp.asarray(sh), cam, sh_degree, 32, rect_mode=rect_mode)
    return proj, scene, sh, vm


class TestPreprocess:
    @pytest.mark.parametrize("rect_mode", ["support", "3sigma"])
    def test_matches_jax(self, rect_mode):
        from youreditableavatar_tpu_torch.ops.gaussian_raster.preprocess import (
            preprocess_gaussians,
        )

        pj, scene, sh, vm = _jax_proj(300, 42, sh_degree=2, rect_mode=rect_mode)
        pt = preprocess_gaussians(
            *(torch.as_tensor(scene[k]) for k in ("means", "scales", "quats",
                                                  "opac")),
            torch.as_tensor(sh), torch_camera(vm, 0.8, 0.6, 96, 64), 2, 32,
            rect_mode=rect_mode)
        for name in ("mean2d", "depth", "conic", "color", "opacity"):
            np.testing.assert_allclose(
                getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                rtol=1e-5, atol=1e-6, err_msg=name)
        for name in ("radius", "tiles_touched", "rect_min", "rect_max"):
            np.testing.assert_array_equal(
                getattr(pt, name).numpy(), np.asarray(getattr(pj, name)),
                err_msg=name)
        assert int(pt.tiles_touched.sum()) > 0


class TestExpansion:
    @pytest.mark.parametrize("n,budget", [(300, 2048), (2500, 8192)])
    def test_pack_and_expand_match_jax(self, n, budget):
        from youreditableavatar_tpu.ops.gaussian_raster.binning import (
            expand_pairs, pack_depth_ordered)
        from youreditableavatar_tpu.ops.gaussian_raster.expand_pallas import (
            expand_pairs_pallas,
        )
        from youreditableavatar_tpu_torch.ops.gaussian_raster import (
            binning as tbin,
        )
        from youreditableavatar_tpu_torch.ops.gaussian_raster.expand_cuda import (
            expand_pairs_kernel,
        )

        pj, *_ = _jax_proj(n, n)
        pt = to_torch_proj(pj)
        packed_j = np.asarray(pack_depth_ordered(pj))
        packed_t = tbin.pack_depth_ordered(pt).numpy()
        # Order and every column bit for bit, but column 10 = 2·ln(255·op):
        # XLA's CPU log and PyTorch's differ in the last bit (≤ 1 ulp).
        cols = [c for c in range(16) if c != 10]
        np.testing.assert_array_equal(packed_t[:, cols], packed_j[:, cols])
        np.testing.assert_allclose(packed_t[:, 10], packed_j[:, 10],
                                   rtol=2.4e-7, atol=0)

        # The kernel's plain version vs the interpreted Pallas kernel, on
        # the same packed table: tile, gauss (0 on culled slots), total.
        t1, g1, n1 = expand_pairs_pallas(jnp.asarray(packed_j), budget, 3, 2,
                                         32, interpret=True)
        t2, g2, n2 = expand_pairs_kernel(torch.tensor(packed_j), budget, 3,
                                         2, 32)
        assert int(n1) == int(n2) > 0
        np.testing.assert_array_equal(t2.numpy(), np.asarray(t1))
        np.testing.assert_array_equal(g2.numpy(), np.asarray(g1))

        # binning.expand_pairs from the projection vs the JAX XLA expansion.
        t3, g3, n3 = expand_pairs(pj, 3, 2, budget, 32)
        t4, g4, n4 = tbin.expand_pairs(pt, 3, 2, budget, 32)
        assert int(n3) == int(n4)
        np.testing.assert_array_equal(t4.numpy(), np.asarray(t3))
        live = np.asarray(t3) < 6
        np.testing.assert_array_equal(g4.numpy()[live], np.asarray(g3)[live])

    def test_empty_scene(self):
        from youreditableavatar_tpu_torch.ops.gaussian_raster.expand_cuda import (
            expand_pairs_kernel,
        )

        packed = torch.zeros((64, 16))
        tile, gauss, total = expand_pairs_kernel(packed, 1024, 3, 2, 32)
        assert int(total) == 0
        assert bool((tile == 6).all()) and bool((gauss == 0).all())


class TestExpansionWindow:
    """The fact K2's kernel rests on: zero-pair rows sort last, so every
    row before them owns ≥ 1 slot and the owners of any 1024 consecutive
    slots lie in [lo, lo + 1024), lo the first slot's owner — the first
    row whose cumsum exceeds the slot. Held against the JAX package's
    expansion (the XLA path writes each slot's owner, culled or not)."""

    @pytest.mark.parametrize("seed,n,offscreen", [
        (0, 3000, 0.0), (1, 4000, 0.8), (2, 6000, 0.97)])
    def test_block_owners_lie_in_one_window(self, seed, n, offscreen):
        from youreditableavatar_tpu.ops.gaussian_raster.binning import (
            expand_pairs, pack_depth_ordered)

        scene, vm, w, h = random_scene(seed, n, 96, 64, scale_hi=0.12)
        rng = np.random.default_rng(seed)
        # Push a share of the Gaussians out of the frame or behind the
        # camera: they touch no tile.
        away = rng.uniform(size=n) < offscreen
        scene["means"][away, 0] += rng.choice([-40.0, 40.0], int(away.sum()))
        scene["means"][away[::-1], 2] -= 10.0
        from youreditableavatar_tpu.ops.gaussian_raster.preprocess import (
            preprocess_gaussians)
        pj = preprocess_gaussians(
            *(jnp.asarray(scene[k]) for k in ("means", "scales", "quats",
                                              "opac")),
            jnp.zeros((n, 1, 3)), jax_camera(vm, 0.8, 0.6, w, h), 0, 32)
        packed = np.asarray(pack_depth_ordered(pj))
        counts = packed[:, 0].astype(np.int64)
        live = int((counts > 0).sum())
        assert live > 0 and (counts[:live] > 0).all() and not counts[live:].any()
        if offscreen:
            assert live < n * (1 - offscreen / 2)
        cum = np.cumsum(counts)
        total = int(cum[-1])
        budget = -(-total // 1024) * 1024
        _, gauss, n_pairs = expand_pairs(pj, 3, 2, budget, 32)
        assert int(n_pairs) == total
        row_of = np.empty(n, np.int64)
        row_of[packed[:, 4].astype(np.int64)] = np.arange(n)
        owner = row_of[np.asarray(gauss)[:total]]
        # Every live row owns a slot; the owners follow the rows in order.
        assert np.array_equal(np.unique(owner), np.arange(live))
        assert (np.diff(owner) >= 0).all()
        for first in range(0, total, 1024):
            block = owner[first:first + 1024]
            lo = int(np.searchsorted(cum, first, side="right"))
            hi = int(np.searchsorted(cum, first + len(block) - 1, side="right"))
            assert block[0] == lo and block[-1] == hi
            assert hi < lo + 1024
            # Each slot's owner found inside the staged window alone.
            window = cum[lo:hi + 1]
            slots = np.arange(first, first + len(block))
            assert np.array_equal(
                lo + np.searchsorted(window, slots, side="right"), block)


def _chunk_boundary_tiles(counts, budget, seed):
    """(P,) tile ids, per-tile counts as given, culled pairs (sentinel)
    mixed in, pair order shuffled so every tile's pairs interleave."""
    rng = np.random.default_rng(seed)
    num_tiles = len(counts)
    tile = np.concatenate([np.full(c, t) for t, c in enumerate(counts)]
                          + [np.full(budget - sum(counts), num_tiles)])
    return rng.permutation(tile).astype(np.int32)


class TestCountingLayout:
    @pytest.mark.parametrize("counts", [
        [0, 127, 128, 129],
        [129, 0, 0, 127, 1],
        [1, 128, 0, 5, 300],
    ])
    def test_chunk_boundary_counts_match_jax(self, counts):
        from youreditableavatar_tpu.ops.gaussian_raster import counting as jc
        from youreditableavatar_tpu_torch.ops.gaussian_raster import (
            counting as tc,
        )

        budget, chunk = 1024, 128
        padded = budget + len(counts) * chunk
        tile = _chunk_boundary_tiles(counts, budget, seed=len(counts))
        hist_j = jc.tile_histogram(jnp.asarray(tile), len(counts))
        hist_t = tc.tile_histogram(torch.as_tensor(tile), len(counts))
        np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
        np.testing.assert_array_equal(hist_t.numpy()[:-1], counts)
        out_j = jc.counting_layout(jnp.asarray(tile), len(counts), chunk, padded)
        out_t = tc.counting_layout(torch.as_tensor(tile), len(counts), chunk,
                                   padded)
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_random_tiles_match_jax(self):
        from youreditableavatar_tpu.ops.gaussian_raster import counting as jc
        from youreditableavatar_tpu_torch.ops.gaussian_raster import (
            counting as tc,
        )

        rng = np.random.default_rng(3)
        num_tiles, chunk, p = 24, 128, 4096
        tile = rng.integers(0, num_tiles + 1, p).astype(np.int32)
        tile[tile == 5] = 6  # an empty tile
        out_j = jc.counting_layout(jnp.asarray(tile), num_tiles, chunk,
                                   p + num_tiles * chunk)
        out_t = tc.counting_layout(torch.as_tensor(tile), num_tiles, chunk,
                                   p + num_tiles * chunk)
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_budget_not_multiple_of_1024_raises(self):
        from youreditableavatar_tpu_torch.ops.gaussian_raster import (
            RasterizeConfig, render_gaussians,
        )
        from youreditableavatar_tpu_torch.ops.gaussian_raster.counting import (
            counting_layout, tile_histogram,
        )

        with pytest.raises(ValueError, match="multiple of 1024"):
            tile_histogram(torch.zeros(1000, dtype=torch.int32), 4)
        with pytest.raises(ValueError, match="multiple of 1024"):
            counting_layout(torch.zeros(1536, dtype=torch.int32), 4, 128, 2048)
        scene, vm, w, h = random_scene(n=20)
        with pytest.raises(ValueError, match="multiple of 1024"):
            render_gaussians(
                *(torch.as_tensor(scene[k]) for k in ("means", "scales",
                                                      "quats", "opac")),
                None, torch_camera(vm, 0.8, 0.6, w, h),
                RasterizeConfig(pair_budget=1000),
                colors_override=torch.as_tensor(scene["colors"]))


class TestPairLayout:
    def test_scene_layout_matches_jax_counting(self):
        """pg_padded / astart / tile_count / num_pairs and the field rows,
        bit for bit, from the same projection."""
        from youreditableavatar_tpu.ops.gaussian_raster.render import (
            build_pallas_pair_layout_counting,
        )
        from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
            build_pair_layout_counting,
        )

        pj, *_ = _jax_proj(400, 11)
        out_j = build_pallas_pair_layout_counting(pj, 3, 2, 2048, 32)
        out_t = build_pair_layout_counting(to_torch_proj(pj), 3, 2, 2048, 32)
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))

    def test_more_than_512_tiles_matches_jax_sort_path(self):
        """Past the TPU counting path's 512 tiles the JAX render falls back
        to the sort path; the port's counting layout must match it."""
        from youreditableavatar_tpu.ops.gaussian_raster.binning import (
            bin_gaussians,
        )
        from youreditableavatar_tpu.ops.gaussian_raster.render import (
            build_pallas_pair_layout,
        )
        from youreditableavatar_tpu_torch.ops.gaussian_raster import (
            binning as tbin,
        )
        from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
            build_pair_layout_counting,
        )

        w, h, budget = 800, 704, 8192  # 25 × 22 = 550 tiles
        ntx, nty = 25, 22
        pj, *_ = _jax_proj(1500, 5, width=w, height=h, scale_hi=0.03,
                           fov=(0.9, 0.8))
        pt = to_torch_proj(pj)
        binning = bin_gaussians(pj, ntx, nty, budget, 32)
        fe_j, pg_j, as_j = build_pallas_pair_layout(pj, binning, ntx, nty,
                                                    budget)
        fe_t, pg_t, as_t, tc_t, np_t = build_pair_layout_counting(
            pt, ntx, nty, budget, 32)
        assert int(np_t) == int(binning.num_pairs) > 0
        np.testing.assert_array_equal(pg_t.numpy(), np.asarray(pg_j))
        np.testing.assert_array_equal(as_t.numpy(), np.asarray(as_j))
        np.testing.assert_array_equal(tc_t.numpy(),
                                      np.asarray(binning.tile_count))
        np.testing.assert_array_equal(fe_t.detach().numpy(), np.asarray(fe_j))

        # The port's own sort path agrees as well.
        bt = tbin.bin_gaussians(pt, ntx, nty, budget, 32)
        np.testing.assert_array_equal(bt.tile_count.numpy(),
                                      np.asarray(binning.tile_count))
        np.testing.assert_array_equal(bt.tile_start.numpy(),
                                      np.asarray(binning.tile_start))
        live = int(binning.num_pairs)
        np.testing.assert_array_equal(bt.pair_gauss.numpy()[:live],
                                      np.asarray(binning.pair_gauss)[:live])
        dst, astart, total = tbin.pad_tile_ranges(bt, 128, pg_t.shape[0])
        np.testing.assert_array_equal(astart.numpy(), as_t.numpy())
        assert int(total) == int(tc_t.sum())


def _port_sources():
    files = sorted((REPO / "youreditableavatar_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported(nodes):
    """Top-level package names imported by the given AST nodes."""
    out = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add((node.module or "").split(".")[0])
    return out


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    """No module of the port imports JAX or the JAX package anywhere, and
    none imports imageio, yaml or wandb while it is imported (the card's
    machine is not promised to have them): only inside a function."""
    tree = ast.parse(path.read_text())
    banned = {"jax", "jaxlib", "optax", "youreditableavatar_tpu"}
    assert not _imported(ast.walk(tree)) & banned, path
    assert not _imported(tree.body) & {"imageio", "yaml", "wandb"}, path


@pytest.mark.cuda
def test_layout_kernels_match_plain_on_card(cuda_device):
    """K2, K3a, K3b against their plain versions on the card, bit for bit."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import counting as tc
    from youreditableavatar_tpu_torch.ops.gaussian_raster.binning import (
        pack_depth_ordered,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster.expand_cuda import (
        expand_pairs_kernel, expand_pairs_plain,
    )

    pj, *_ = _jax_proj(2500, 7)
    pt = to_torch_proj(pj)
    pt = type(pt)(*(x.to(cuda_device) for x in pt))
    packed = pack_depth_ordered(pt)
    out_k = expand_pairs_kernel(packed, 8192, 3, 2, 32)
    out_p = expand_pairs_plain(packed, 8192, 3, 2, 32)
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    tile = out_k[0]
    assert torch.equal(tc.tile_histogram(tile, 6), tc.tile_histogram_plain(tile, 6))
    astart_ext = torch.tensor([0, 128, 256, 512, 640, 768, 10_000],
                              dtype=torch.int32, device=cuda_device)
    assert torch.equal(tc.rank_destinations(tile, astart_ext),
                       tc.rank_destinations_plain(tile, astart_ext))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EXPAND_CASES))
def test_expand_kernel_matches_plain_on_card(cuda_device, case):
    """K2 bit for bit against its plain version: the total past the budget,
    an owner of more than 1024 slots, fewer rows than a block, an empty
    table and one of zero-pair rows, the last live row ending on a block
    edge, zero-pair rows inside the table."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster.expand_cuda import (
        expand_pairs_kernel, expand_pairs_plain,
    )

    packed, budget = expand_case(case)
    packed = torch.tensor(packed, device=cuda_device)
    out_k = expand_pairs_kernel(packed, budget, 64, 64, 32)
    out_p = expand_pairs_plain(packed, budget, 64, 64, 32)
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RANK_CASES))
def test_rank_kernel_matches_plain_on_card(cuda_device, case):
    """K3b bit for bit against its plain version: 1 << 20 pairs at 16,385
    bins, every pair in one bin, every pair in the sentinel bin, one
    block, 1024 blocks."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import counting as tc

    tile, nbins = rank_case(case)
    tile = torch.tensor(tile, device=cuda_device)
    hist = tc.tile_histogram(tile, nbins - 1)
    assert torch.equal(hist, tc.tile_histogram_plain(tile, nbins - 1))
    ext = tc.aligned_starts_ext(hist, nbins - 1, 128,
                                tile.shape[0] + (nbins - 1) * 128)
    assert torch.equal(tc.rank_destinations(tile, ext),
                       tc.rank_destinations_plain(tile, ext))


@pytest.mark.parametrize("case", list(HIST_CASES))
def test_histogram_cases_match_jax(case):
    """K3a's cases on the CPU (the plain version) against the JAX
    `tile_histogram` (its Pallas kernel interpreted), bit for bit, where
    the JAX package serves the bin count (≤ its MAX_BINS of 512); past
    that, where it serves no such tile grid, against numpy."""
    from youreditableavatar_tpu.ops.gaussian_raster import counting as jc
    from youreditableavatar_tpu_torch.ops.gaussian_raster import counting as tc

    tile, nbins = hist_case(case)
    hist = tc.tile_histogram(torch.tensor(tile), nbins - 1).numpy()
    if nbins <= jc.MAX_BINS:
        want = np.asarray(jc.tile_histogram(jnp.asarray(tile), nbins - 1))
    else:
        want = np.bincount(tile, minlength=nbins)
    np.testing.assert_array_equal(hist, want)
    if case == "max_bins":
        assert nbins == tc.MAX_BINS


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(HIST_CASES))
def test_histogram_kernel_matches_plain_on_card(cuda_device, case):
    """K3a bit for bit against its plain version on each case."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import counting as tc

    tile, nbins = hist_case(case)
    tile = torch.tensor(tile, device=cuda_device)
    assert torch.equal(tc.tile_histogram(tile, nbins - 1),
                       tc.tile_histogram_plain(tile, nbins - 1))
