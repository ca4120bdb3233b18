#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (each prints its line and seconds; any failure exits non-zero and
prints no result):
  1. device  — the card, its power limit; TF32 off for matmul and cuDNN.
  2. build   — nvcc builds every kernel under youreditableavatar_tpu_torch/csrc
               (ptxas's registers / shared memory of the compositing kernels).
  3. kernels — every kernel against its plain PyTorch version on the card:
               pair expansion, tile histogram and counting ranks bit-exact,
               compositing forward (and its per-batch checkpoints) and its
               gradient at full width with the tile-depth line, the
               per-pair compositing backward (K6) over the same layout's
               gathered rows (two launches bit-identical; the gather and
               its backward timed apart), K1b and K6 on an adversarial
               layout built against their cull, the render's input gradients at
               256² (20k Gaussians) against the plain render on the CPU,
               the mesh z-buffer resolve bit-exact at 512² on the
               81,920-face icosphere, plus each kernel's time, its plain
               version's time and its bound at the main-path shapes.
  4. render  — render forward + backward on the 512²/100k sphere-shell scene.
  5. fit     — the init-texture trainer (TetGSInitTrainer) for 50 steps at
               512² on an icosphere with 6 subdivisions (81,920 faces) and
               8 ring cameras; targets rendered from a colour-pattern copy.
  6. edit    — the edit-texture stage on the same icosphere: InpaintTrainer
               (8 ring views, stub inpainter, the cap z > 0.1 editable) →
               prepare_refine_guidance (8 turntable views) → RefineTrainer
               (40 steps) → validate, at 512².
  7. spatial — the spatial stage at full width (16 levels × 2^19 hash grid,
               grid 64, 512² normal maps), cut in depth: ShapeInitializer on
               the same icosphere (200 of 15,000 SDF steps, 10 of 501 normal
               steps), then HumanEditTrainer with the stub SDS prior on a
               fresh sphere field's cap z > 0.1, 6 + 30 steps from step 0
               (8 hash levels) and 6 + 30 from step 8000 (16 levels).
  8. sharded — the sharded TetGS step (parallel/) as a one-rank NCCL world
               on the fit phase's icosphere and 8 ring views at 512²: its
               first step against the single-device render and loss, 2 and
               4 tile-row bands in one process against the unsharded image
               and gradients, then 20 timed steps whose loss must fall.
  9. a `kernels` JSON line: each kernel's launches on its main path (the
     fit; the edit stage for the mesh resolve; the spatial stage for the
     hash-grid scatter; the sharded step for the per-pair backward), error
     against its plain version, ms, plain ms, library ms and bound.
The last line is {"ok": true, "device": {...}}.

Weights and scenes are random, made from fixed seeds.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) op/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per (pair, pixel) evaluation, counted from the kernels'
# inner loops (the exp counted as one): forward, and backward (its own
# forward recompute + the gradient terms).
FWD_OPS_PER_EVAL = 27
BWD_OPS_PER_EVAL = 60

WIDTH = HEIGHT = 512
N_GAUSS = 100_000
PAIR_BUDGET = 184_320  # bench.py's budget: 1440 × 128 ≥ the scene's pairs
GRAD_SIZE, GRAD_N = 256, 20_000
FIT_SUBDIV, FIT_VIEWS, FIT_STEPS, FIT_TIMED_STEPS = 6, 8, 50, 20
# f32 operations per (pair, pixel) evaluation of the mesh z-buffer resolve:
# 2 subtractions, 4 + 4 for l1 and l2, 2 for l0, 5 for z, 4 compares.
MESH_OPS_PER_EVAL = 21
# The edit phase: ring views per elevation, the fit-iteration ladder of the
# view groups (2 / 3 / 3 views), turntable views, refine steps.
EDIT_RING, EDIT_LADDER, EDIT_GROUPS = (2, 3, 3), (20, 16, 8), (2, 3)
EDIT_TURNTABLE, EDIT_REFINE_STEPS, EDIT_TIMED_STEPS = 8, 40, 20
EDIT_CAP_Z = 0.1  # vertices above it are editable
# The kernels of the Gaussian render: the main path of `render` and `fit`.
RENDER_KERNELS = ("tile_histogram", "counting_layout", "expand_pairs",
                  "composite_forward", "composite_backward")
EDIT_MIN_PAINTED = 0.9  # share of the seen editable vertices to paint
EDIT_NO_TARGET_LOSS = 1e-3  # a fit loss below it: nothing left to paint
# Kernel vs plain tolerances: the compositing forward repeats the plain
# version's f32 ops (both use expf), so images agree to rounding; float
# atomics reorder the backward's sums, held like the JAX suite's backends.
FWD_ATOL = 1e-5
GRAD_RTOL_OF_MAX = 5e-5
# The hash-grid scatter (K4): float atomics add in a run-to-run order, so
# each level's table gradient is held to this share of its largest entry.
SCATTER_RTOL_OF_MAX = 1e-5
SCATTER_POINTS = 65_536  # points of the K4 check: one edit-step requery
# The spatial phase: depth cuts of the shape init (of 15,000 / 501 steps)
# and the edit halves (warm-up + timed steps from each start step).
INIT_SDF_STEPS, INIT_NORMAL_STEPS = 200, 10
EDIT_WARM, EDIT_TIMED, EDIT_STARTS = 6, 30, (0, 8000)
SPATIAL_GRID = 64  # tet-grid resolution of both spatial stages
K4_PER_EDIT_STEP = 3  # selected-corner requery, midpoints, recon points
# The sharded phase: timed steps, the band counts checked in one process,
# and the kernels its step launches once per view.
SHARDED_STEPS, SHARDED_BANDS = 20, (2, 4)
SHARDED_KERNELS = ("tile_histogram", "counting_layout", "expand_pairs",
                   "composite_forward", "composite_backward_pairs")


def make_bench_scene(dev, seed=0, n=None, size=None):
    """bench.py's scene: Gaussians on a noisy sphere shell, SH degree 3."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterCamera

    n = N_GAUSS if n is None else n
    size = WIDTH if size is None else size
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    means = d * (0.8 + 0.05 * rng.normal(size=(n, 1)).astype(np.float32))
    scales = rng.uniform(0.004, 0.012, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = rng.uniform(-1, 1, (n, 3))
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 2.5
    cam = RasterCamera.from_fov(vm, 0.9, 0.9, size, size, device=dev)
    arrays = [torch.as_tensor(a, device=dev)
              for a in (means, scales, quats, opac, sh)]
    return arrays, cam


def icosphere(subdiv: int, radius: float = 0.8):
    """(verts (V, 3) f32, faces (F, 3) int64): 20·4^subdiv outward faces."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdiv):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                        f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mids = v[uniq].mean(axis=1)
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        ab, bc, ca = (len(v) + inv.reshape(3, -1))
        v = np.concatenate([v, mids])
        a, b, c = f.T
        f = np.concatenate([np.stack(x, 1) for x in
                            ((a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca))])
    return (v * radius).astype(np.float32), f.astype(np.int64)


def pattern_colors(points: np.ndarray) -> np.ndarray:
    """A smooth colour pattern over positions, in [0.05, 0.95]."""
    phase = np.array([1.0, 2.0, 3.0])
    return 0.5 + 0.45 * np.sin(points * np.array([4.0, 5.0, 6.0]) + phase)


def device_ms(fn, iters, warmup=2):
    """Mean device time of `fn` over `iters` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def each_device_ms(fn, iters, warmup=3):
    """Device time of each of `iters` calls (CUDA events around each)."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def both_ms(fn, iters=20):
    """(mean of `iters` back-to-back calls, the `iters` calls timed one by
    one): the compositing kernels' rows keep the statistic of their earlier
    rows, and the other is printed beside it."""
    return device_ms(fn, iters), each_device_ms(fn, iters)


def spread(mean, times):
    return (f"mean {mean:.4f} ms back to back; one by one median "
            f"{statistics.median(times):.4f} (min {min(times):.4f}, max "
            f"{max(times):.4f})")


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, report):
    """Each kernel against its plain version, then timed at main-path shapes."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        RasterizeConfig, count_pairs, fit_pair_budget, render_gaussians)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.binning import (
        pack_depth_ordered)
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        composite_cuda as comp)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.counting import (
        aligned_starts_ext, rank_destinations, rank_destinations_plain,
        tile_histogram, tile_histogram_plain)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.expand_cuda import (
        expand_pairs_kernel, expand_pairs_plain)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.preprocess import (
        preprocess_gaussians)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        build_pair_layout_counting)

    (means, scales, quats, opac, sh), cam = make_bench_scene(dev)
    ntx = nty = WIDTH // 32
    num_t = ntx * nty
    with torch.no_grad():
        proj = preprocess_gaussians(means, scales, quats, opac, sh, cam, 3, 32)
        packed = pack_depth_ordered(proj)

        # K2: pair expansion, bit-exact.
        tk, gk, nk = expand_pairs_kernel(packed, PAIR_BUDGET, ntx, nty, 32)
        tp, gp, np_ = expand_pairs_plain(packed, PAIR_BUDGET, ntx, nty, 32)
        err = max(int((tk - tp).abs().max()), int((gk - gp).abs().max()),
                  abs(int(nk) - int(np_)))
        live = int((tk < num_t).sum())
        print(f"  expand_pairs: total {int(nk)} pairs, {live} kept after the "
              f"cull, max |kernel - plain| = {err}")
        if err:
            raise AssertionError("expand_pairs kernel differs from its plain version")
        report["expand_pairs"] = dict(
            max_abs_err=err,
            ms=device_ms(lambda: expand_pairs_kernel(packed, PAIR_BUDGET, ntx,
                                                    nty, 32), 50),
            plain_ms=device_ms(lambda: expand_pairs_plain(packed, PAIR_BUDGET,
                                                         ntx, nty, 32), 5),
            bound=bound(packed.numel() * 4 + 2 * PAIR_BUDGET * 4 + 4, 60 * PAIR_BUDGET),
        )

        # K3a: tile histogram, bit-exact.
        hk, hp = tile_histogram(tk, num_t), tile_histogram_plain(tk, num_t)
        err = int((hk - hp).abs().max())
        print(f"  tile_histogram: max |kernel - plain| = {err}")
        if err:
            raise AssertionError("tile_histogram kernel differs")
        report["tile_histogram"] = dict(
            max_abs_err=err,
            ms=device_ms(lambda: tile_histogram(tk, num_t), 100),
            plain_ms=device_ms(lambda: tile_histogram_plain(tk, num_t), 20),
            library_ms=device_ms(lambda: torch.bincount(tk, minlength=num_t + 1), 100),
            bound=bound(PAIR_BUDGET * 4 + (num_t + 1) * 4, PAIR_BUDGET),
        )

        # K3b: stable ranks → destinations, bit-exact.
        def astart_ext_of(hist, tiles, pairs):
            return aligned_starts_ext(hist, tiles, comp.CHUNK,
                                      pairs + tiles * comp.CHUNK)

        astart_ext = astart_ext_of(hk, num_t, PAIR_BUDGET)
        dk = rank_destinations(tk, astart_ext)
        dp = rank_destinations_plain(tk, astart_ext)
        err = int((dk - dp).abs().max())
        print(f"  counting_layout: max |kernel - plain| = {err}")
        if err:
            raise AssertionError("counting_layout kernel differs")
        report["counting_layout"] = dict(
            max_abs_err=err,
            ms=device_ms(lambda: rank_destinations(tk, astart_ext), 100),
            plain_ms=device_ms(lambda: rank_destinations_plain(tk, astart_ext), 10),
            bound=bound(2 * PAIR_BUDGET * 4 + (num_t + 1) * 4, 3 * PAIR_BUDGET),
        )

        # K3a/K3b past a block's default 48 KB of shared memory: 16,385
        # bins (a 4096² image at tile 32), random tile ids, bit-exact.
        big_t, big_p = 16_384, 1 << 20
        tb = torch.randint(0, big_t + 1, (big_p,), dtype=torch.int32,
                           device=dev, generator=torch.Generator(
                               device=dev).manual_seed(3))
        hb = tile_histogram(tb, big_t)
        ext = astart_ext_of(hb, big_t, big_p)
        err = max(int((hb - tile_histogram_plain(tb, big_t)).abs().max()),
                  int((rank_destinations(tb, ext)
                       - rank_destinations_plain(tb, ext)).abs().max()))
        print(f"  counting at {big_t} tiles, {big_p} pairs: max |kernel - "
              f"plain| = {err}")
        if err:
            raise AssertionError("counting kernels differ at 16,384 tiles")

        # K1f: compositing forward at full width.
        fields, pg, astart, tcount, _ = build_pair_layout_counting(
            proj, ntx, nty, PAIR_BUDGET, 32)
        rk, fk, ck = comp.composite_tiles_fused(fields, pg, astart, tcount,
                                                 ntx, nty)
        rp, fp, cp, evals = comp.composite_tiles_plain(
            fields, pg, astart, tcount, ntx, nty, return_evals=True)
        err = max(float((rk - rp).abs().max()), float((fk - fp).abs().max()))
        mism = int((ck != cp).sum())
        print(f"  composite_forward: {evals} live (pair, pixel) evaluations, "
              f"max |kernel - plain| = {err:.3g} (atol {FWD_ATOL}), "
              f"n_contrib mismatches {mism} of {ck.numel()}")
        if not err <= FWD_ATOL:
            raise AssertionError("composite forward kernel differs")
        # K1f saving the backward's checkpoints (the main path: a gradient
        # follows): the same outputs bit for bit, and checkpoints and swept
        # counts equal to the plain version's.
        rs, fs, cs, ckpt = comp._forward(fields, pg, astart, tcount, ntx,
                                         True)
        if not (torch.equal(rs, rk) and torch.equal(fs, fk)
                and torch.equal(cs, ck)):
            raise AssertionError("K1f with the checkpoint store differs")
        ck_plain = comp.composite_tiles_plain(
            fields, pg, astart, tcount, ntx, nty, return_checkpoints=True)[3]
        check_checkpoints(ckpt, ck_plain, astart, "512²/100k vs plain")
        layout_stats(fields, pg, astart, tcount, ck_plain, cp, evals, ntx, nty)
        # The compositing bounds count what this layout needs: the
        # arithmetic of the contributing (pair, pixel) evaluations only, and
        # the checkpoints of the swept batches (written by K1f on the main
        # path, read by K1b / K6) besides the rows and image planes.
        contrib = int(cp.sum())
        ckpt_bytes = int(ckpt.swept.sum()) * 5 * 1024 * 4 + num_t * 4
        fwd_bytes = (fields.numel() * 4 + pg.numel() * 4 + 2 * num_t * 4
                     + num_t * 5 * 1024 * 4 + ckpt_bytes)
        fwd_mean, fwd_times = both_ms(lambda: comp._forward(
            fields, pg, astart, tcount, ntx, True))
        nostore_mean, nostore_times = both_ms(lambda: comp._forward(
            fields, pg, astart, tcount, ntx, False))
        print(f"  composite_forward with the checkpoint store: "
              f"{spread(fwd_mean, fwd_times)}; without: "
              f"{spread(nostore_mean, nostore_times)}")
        report["composite_forward"] = dict(
            max_abs_err=err, ms=fwd_mean,
            plain_ms=device_ms(lambda: comp.composite_tiles_plain(
                fields, pg, astart, tcount, ntx, nty), 2, warmup=1),
            bound=bound(fwd_bytes, FWD_OPS_PER_EVAL * contrib),
        )
        print(f"  compositing bounds over {contrib} contributing evaluations "
              f"(over all {evals} live ones they would be K1f "
              f"{FWD_OPS_PER_EVAL * evals / F32_OPS_PER_S * 1e3:.4f} ms, "
              f"K1b / K6 {BWD_OPS_PER_EVAL * evals / F32_OPS_PER_S * 1e3:.4f} "
              f"ms); checkpoints of the swept batches {ckpt_bytes} B")

    # K1b at full width: the kernel's gradient (through the autograd
    # Function) against autograd of the plain version, same random
    # cotangents, each of the 9 columns at GRAD_RTOL_OF_MAX · its max|g|.
    gen = torch.Generator(device=dev).manual_seed(1)
    drgb = torch.randn(rk.shape, generator=gen, device=dev)
    dt = torch.randn(fk.shape, generator=gen, device=dev)
    bwd_ms, bwd_times = both_ms(lambda: comp._backward_raw(
        fields, pg, astart, tcount, rk, fk, drgb, dt, ntx, ckpt))

    def composite_grad(fn):
        """fields_ext gradient of fn and the device ms of its backward."""
        f = fields.detach().requires_grad_()
        r, t, _ = fn(f, pg, astart, tcount, ntx, nty)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        g = torch.autograd.grad((r * drgb).sum() + (t * dt).sum(), f)[0]
        t1.record()
        t1.synchronize()
        return g, t0.elapsed_time(t1)

    gk_, _ = composite_grad(comp.composite_tiles_fused)
    gp_, bwd_plain_ms = composite_grad(comp.composite_tiles_plain)
    worst, err = 0.0, 0.0
    for col in range(9):
        scale = max(float(gp_[:, col].abs().max()), 1e-3)
        e = float((gk_[:, col] - gp_[:, col]).abs().max())
        err = max(err, e)
        worst = max(worst, e / (GRAD_RTOL_OF_MAX * scale))
    print(f"  composite_backward at {WIDTH}² / {N_GAUSS} Gaussians, "
          f"{int(tcount.sum())} pairs kept: max |kernel - plain| = {err:.3g}, "
          f"worst column at {worst:.3f} of its tolerance "
          f"({GRAD_RTOL_OF_MAX}·max|g|); {spread(bwd_ms, bwd_times)}")
    if not worst <= 1.0:
        raise AssertionError("composite backward kernel differs")
    bwd_bytes = (fields.numel() * 4 * 2 + pg.numel() * 4 + 2 * num_t * 4
                 + num_t * 8 * 1024 * 4 + ckpt_bytes)

    # Render-level gradients of all five inputs at 256² / 20k Gaussians:
    # kernels on the card against the plain versions on the CPU, same inputs.
    (gm, gs, gq, go, gsh), gcam = make_bench_scene(dev, seed=2,
                                                   n=GRAD_N, size=GRAD_SIZE)
    gcfg = RasterizeConfig(sh_degree=3)
    budget = fit_pair_budget(int(count_pairs(gm, gs, gq, go, gsh, gcam, gcfg)))

    def render_grads(device):
        leaves = [x.detach().to(device).requires_grad_()
                  for x in (gm, gs, gq, go, gsh)]
        c = type(gcam)(*(x.to(device) if torch.is_tensor(x) else x
                         for x in gcam))
        out = render_gaussians(*leaves, c, dataclasses.replace(
            gcfg, pair_budget=budget))
        loss = (out["image"] ** 2).mean() + 0.1 * out["alpha"].mean()
        return [g.cpu() for g in torch.autograd.grad(loss, leaves)], out
    gcuda, out_k = render_grads(dev)
    gcpu, out_p = render_grads("cpu")
    img_err = float((out_k["image"].detach().cpu() - out_p["image"].detach()).abs().max())
    ratios = []
    for a, b in zip(gcuda, gcpu):
        tol = GRAD_RTOL_OF_MAX * max(float(b.abs().max()), 1e-3)
        ratios.append(float((a - b).abs().max()) / tol)
    print(f"  render at {GRAD_SIZE}²: image |card - cpu plain| = {img_err:.3g}; "
          f"input-gradient errors as fractions of their tolerance: "
          + ", ".join(f"{r:.3f}" for r in ratios))
    if not (img_err <= FWD_ATOL and max(ratios) <= 1.0):
        raise AssertionError("render on the card differs from the plain render")
    report["composite_backward"] = dict(
        max_abs_err=err, ms=bwd_ms, plain_ms=bwd_plain_ms,
        bound=bound(bwd_bytes, BWD_OPS_PER_EVAL * contrib),
    )
    report["composite_backward_pairs"] = check_composite_pairs(
        fields, pg, astart, tcount, ntx, nty, rk, fk, drgb, dt, contrib,
        ckpt_bytes, ckpt)
    check_adversarial(dev)
    report["mesh_resolve"] = check_mesh_resolve(dev)
    report["hash_scatter"] = check_hash_scatter(dev)


def check_checkpoints(ck, ck_plain, astart, what):
    """The kernel's checkpoints bit-equal to the reference ones (the plain
    version's) on every batch a tile swept, and the same swept counts."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        composite_cuda as comp)

    b = comp.swept_batches(ck_plain, astart)[2]
    same = (torch.equal(ck.swept, ck_plain.swept)
            and torch.equal(ck.state[b], ck_plain.state[b])
            and torch.equal(ck.packed[b], ck_plain.packed[b]))
    print(f"  K1f checkpoints ({what}): {b.numel()} swept batches of "
          f"{ck.state.shape[0]}; bit-equal: {same}")
    if not same:
        raise AssertionError(f"K1f checkpoints differ ({what})")


def layout_stats(fields, pg, astart, tcount, ck, n_contrib, evals, ntx, nty):
    """The tile-depth line: pairs per tile, batches, evaluations, and the
    (pair, warp) sweeps the backward's box cull leaves."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        composite_cuda as comp)

    c = tcount.double()
    swept = ck.swept.long()
    tile, lb, _ = comp.swept_batches(ck, astart)
    slots = ((astart[tile].long() + lb * comp.CHUNK)[:, None]
             + torch.arange(comp.CHUNK, device=swept.device))
    real = (lb * comp.CHUNK)[:, None] + torch.arange(
        comp.CHUNK, device=swept.device) < tcount[tile].long()[:, None]
    box = comp.cull_box_plain(fields[pg[slots[real]].long()])
    tx = (tile % ntx).float()[:, None].expand_as(slots)[real] * 32
    ty = torch.div(tile, ntx, rounding_mode="floor").float()[
        :, None].expand_as(slots)[real] * 32
    hits = 0
    for w in range(8):
        x0, y0 = tx + (w % 2) * 16, ty + (w // 2) * 8
        hits += int((~((box[:, 1] < x0) | (box[:, 0] > x0 + 15)
                       | (box[:, 3] < y0) | (box[:, 2] > y0 + 7))).sum())
    print(f"  tile depth: {int(tcount.sum())} pairs over {c.numel()} tiles "
          f"(max {int(c.max())}, mean {float(c.mean()):.1f}, median "
          f"{float(c.median()):.0f}, {int((c == 0).sum())} empty); "
          f"{int(((c + 127) // 128).sum())} batches, {int(swept.sum())} swept "
          f"(deepest tile {int(swept.max())}); {evals} live (pair, pixel) "
          f"evaluations, {int(n_contrib.sum())} contributing; "
          f"{8 * int(real.sum())} (pair, warp) sweeps, {hits} inside the "
          f"cull box")


def adversarial_layout(dev, seed=5, ntx=8, nty=8, n=400):
    """A compositing layout built to stress the backward's box cull: n
    Gaussians in every tile of an ntx × nty tile grid (depth order = index
    order), σ up to 120 px and anisotropic, means on and off the
    screen, opacities mostly just above 1/255 (boxes barely wider than the
    1 px pad), some exactly 1/255, some opaque (early exits) and some with
    an indefinite conic (never culled). Returns (fields_ext (n+1, 16),
    pg_padded, starts, counts)."""
    rng = np.random.default_rng(seed)
    w, h = ntx * 32, nty * 32
    mean = rng.uniform([-40, -40], [w + 40, h + 40], (n, 2))
    s1 = np.exp(rng.uniform(np.log(1.0), np.log(120.0), n))
    s2 = s1 * rng.uniform(0.05, 1.0, n)
    th = rng.uniform(0, np.pi, n)
    cos, sin = np.cos(th), np.sin(th)
    # conic = R diag(1/s1², 1/s2²) Rᵀ
    i1, i2 = 1 / s1 ** 2, 1 / s2 ** 2
    ca = cos ** 2 * i1 + sin ** 2 * i2
    cc = sin ** 2 * i1 + cos ** 2 * i2
    cb = cos * sin * (i1 - i2)
    kind = rng.uniform(size=n)
    faint = np.float32(1 / 255) * (1 + rng.uniform(1e-6, 0.05, n))
    op = np.where(kind < 0.6, faint, rng.uniform(0.05, 0.99, n))
    op = np.where((kind >= 0.6) & (kind < 0.7), np.float32(1 / 255), op)
    op = np.where(kind >= 0.95, 1.0, op)
    # Indefinite conics, wide enough that exp(power) stays finite on the
    # screen (the plain version's autograd would give inf · 0 there).
    indef = rng.uniform(size=n) < 0.03
    wide = 1 / rng.uniform(60.0, 120.0, (2, n)) ** 2
    ca, cc = np.where(indef, wide[0], ca), np.where(indef, wide[1], cc)
    cb = np.where(indef, 1.5 * np.sqrt(ca * cc), cb)
    fields = np.zeros((n + 1, 16), np.float32)
    fields[1:, 0:2] = mean
    fields[1:, 2], fields[1:, 3], fields[1:, 4] = ca, cb, cc
    fields[1:, 5] = op
    fields[1:, 6:9] = rng.uniform(0, 1, (n, 3))
    fields[:, 9] = np.arange(n + 1)
    per = -(-n // 128) * 128
    pg = np.zeros(ntx * nty * per, np.int32)
    for t in range(ntx * nty):
        pg[t * per: t * per + n] = np.arange(1, n + 1)
    starts = np.arange(ntx * nty, dtype=np.int32) * per
    counts = np.full(ntx * nty, n, np.int32)
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (fields, pg, starts, counts))


def check_adversarial(dev):
    """K1f, its checkpoints, K1b and K6 on `adversarial_layout` against the
    plain versions: images to FWD_ATOL, checkpoints bit for bit, gradients
    within GRAD_RTOL_OF_MAX·max|g| per column, K6 zero off real pairs and
    bit-identical over two launches."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        composite_cuda as comp)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        gather_pair_rows)

    fields, pg, starts, counts = adversarial_layout(dev)
    ntx = nty = 8
    with torch.no_grad():
        rgb, ft, cnt, ck = comp._forward(fields, pg, starts, counts, ntx, True)
        rp, fp, cp, ck_plain = comp.composite_tiles_plain(
            fields, pg, starts, counts, ntx, nty, return_checkpoints=True)
    err = max(float((rgb - rp).abs().max()), float((ft - fp).abs().max()))
    if not (err <= FWD_ATOL and torch.equal(cnt, cp)):
        raise AssertionError("K1f differs on the adversarial layout")
    check_checkpoints(ck, ck_plain, starts, "adversarial vs plain")
    gen = torch.Generator(device=dev).manual_seed(4)
    drgb = torch.randn(rgb.shape, generator=gen, device=dev)
    dt = torch.randn(ft.shape, generator=gen, device=dev)

    def worst_of(gk, gp, cols):
        return max(float((gk[:, c] - gp[:, c]).abs().max())
                   / (GRAD_RTOL_OF_MAX * max(float(gp[:, c].abs().max()), 1e-6))
                   for c in cols)

    grads = []
    for fn in (comp.composite_tiles_fused, comp.composite_tiles_plain):
        f = fields.detach().requires_grad_()
        r, t, _ = fn(f, pg, starts, counts, ntx, nty)
        grads.append(torch.autograd.grad((r * drgb).sum() + (t * dt).sum(), f)[0])
    w1b = worst_of(grads[0], grads[1], range(9))
    rows = gather_pair_rows(fields, pg)
    k6 = [comp.backward_pairs(rows, starts, counts, rgb, ft, drgb, dt, ntx, ck)
          for _ in range(2)]
    r_ = rows.detach().requires_grad_()
    r, t, _ = comp.composite_tiles_pairs_plain(r_, starts, counts, ntx, nty)
    gp = torch.autograd.grad((r * drgb).sum() + (t * dt).sum(), r_)[0]
    real = pg > 0
    w6 = worst_of(k6[0][real], gp[real], range(9))
    stray = float(k6[0][~real].abs().max()) + float(k6[0][:, 9:].abs().max())
    same = torch.equal(k6[0], k6[1])
    print(f"  adversarial layout ({int(counts.sum())} pairs, "
          f"{int(ck_plain.swept.sum())} swept batches, {int(cnt.sum())} "
          f"contributions): forward |kernel - plain| = {err:.3g}; K1b worst "
          f"column at {w1b:.3f} and K6 at {w6:.3f} of their tolerance; K6 "
          f"off real pairs {stray}, two launches bit-identical: {same}")
    if not (w1b <= 1.0 and w6 <= 1.0 and stray == 0.0 and same):
        raise AssertionError("K1b / K6 differ on the adversarial layout")


def check_composite_pairs(fields, pg, astart, tcount, ntx, nty, rgb, final_t,
                          drgb, dt, contrib, ckpt_bytes, ck_indexed):
    """K6 (and K1f over direct rows) at the 512²/100k layout: the rows are
    gathered as the sharded step gathers them. The forward and its
    checkpoints must equal the indexed K1f's bit for bit; K6's rows must
    match autograd of the plain version within GRAD_RTOL_OF_MAX·max|g| per
    column on the real pairs, be zero on every other slot, and repeat bit
    for bit on a second launch."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        composite_cuda as comp)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        gather_pair_rows)

    rows = gather_pair_rows(fields, pg)
    p_pad, num_t = rows.shape[0], astart.shape[0]
    with torch.no_grad():
        rk, fk, _, ck = comp._forward_rows(rows, astart, tcount, ntx, True)
    if not (torch.equal(rk, rgb) and torch.equal(fk, final_t)):
        raise AssertionError("K1f over direct rows differs from K1f indexed")
    check_checkpoints(ck, ck_indexed, astart, "over direct rows vs indexed")
    k1 = comp.backward_pairs(rows, astart, tcount, rk, fk, drgb, dt, ntx, ck)
    k2 = comp.backward_pairs(rows, astart, tcount, rk, fk, drgb, dt, ntx, ck)
    r = rows.detach().requires_grad_()
    out = comp.composite_tiles_pairs_plain(r, astart, tcount, ntx, nty)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    gp = torch.autograd.grad((out[0] * drgb).sum() + (out[1] * dt).sum(), r)[0]
    t1.record()
    t1.synchronize()
    plain_ms = t0.elapsed_time(t1)
    slot = torch.arange(p_pad, device=rows.device)
    owner = torch.searchsorted(astart, slot.to(torch.int32), right=True) - 1
    real = (slot - astart[owner]) < tcount[owner]
    worst, err = 0.0, 0.0
    for col in range(9):
        scale = max(float(gp[real, col].abs().max()), 1e-3)
        e = float((k1[real, col] - gp[real, col]).abs().max())
        err = max(err, e)
        worst = max(worst, e / (GRAD_RTOL_OF_MAX * scale))
    stray = float(k1[~real].abs().max()) + float(k1[:, 9:].abs().max())
    same = torch.equal(k1, k2)
    print(f"  composite_backward_pairs (K6): P_pad {p_pad}, {int(real.sum())} "
          f"real pairs; max |kernel - plain| = {err:.3g}, worst column at "
          f"{worst:.3f} of its tolerance ({GRAD_RTOL_OF_MAX}·max|g|); off "
          f"real pairs and columns 9-15 max |row| = {stray}; two launches "
          f"bit-identical: {same}; K1f over direct rows equals K1f indexed")
    if not (worst <= 1.0 and stray == 0.0 and same):
        raise AssertionError("composite_backward_pairs differs from its plain version")

    # The row gather of the sharded step and its backward, timed apart;
    # `fields[pg]`'s sort-based index backward beside them.
    g_rows = torch.randn(rows.shape, device=rows.device)
    f = fields.detach().requires_grad_()
    gathered = gather_pair_rows(f, pg)
    indexed = f[pg.long()]
    gather_ms = device_ms(lambda: gather_pair_rows(fields, pg), 50)
    gather_bwd_ms = device_ms(lambda: torch.autograd.grad(
        gathered, f, g_rows, retain_graph=True), 20)
    indexed_bwd_ms = device_ms(lambda: torch.autograd.grad(
        indexed, f, g_rows, retain_graph=True), 5)
    print(f"  pair-row gather ({p_pad} rows of {fields.shape[0]}): index_select "
          f"{gather_ms:.4f} ms, its backward (index_add_) {gather_bwd_ms:.4f} "
          f"ms; fields[pg] backward (sort-based index backward) "
          f"{indexed_bwd_ms:.4f} ms")
    mean, times = both_ms(lambda: comp.backward_pairs(
        rows, astart, tcount, rk, fk, drgb, dt, ntx, ck))
    moved = (2 * p_pad * rows.shape[1] * 4 + 2 * num_t * 4
             + num_t * 8 * 1024 * 4 + ckpt_bytes)
    result = dict(max_abs_err=err, ms=statistics.median(times),
                  plain_ms=plain_ms,
                  bound=bound(moved, BWD_OPS_PER_EVAL * contrib))
    print(f"  composite_backward_pairs: {spread(mean, times)}; bound "
          f"{result['bound'][0]:.4f} ms by {result['bound'][1]}; plain "
          f"backward on the card {plain_ms:.1f} ms")
    return result


def check_hash_scatter(dev):
    """K4 against its plain version: the corner rows of 65,536 random
    points through the production HashGridConfig's 16 levels (dense coarse
    levels included), normal values, one row in 16 the padding sentinel.
    The plain version sums sequentially on the CPU copy."""
    from youreditableavatar_tpu_torch.ops import hashgrid as hg
    from youreditableavatar_tpu_torch.ops import hashgrid_cuda as hc

    cfg = hg.HashGridConfig()
    t = cfg.table_size
    gen = torch.Generator().manual_seed(4)
    x = torch.rand((SCATTER_POINTS, 3), generator=gen)
    idx = torch.stack([hg._level_corners(x, res, t)[0].reshape(-1)
                       for res in cfg.level_resolutions()]).to(torch.int32)
    idx[:, ::16] = t
    v0 = torch.randn(idx.shape, generator=gen)
    v1 = torch.randn(idx.shape, generator=gen)
    levels, rows = idx.shape
    t0 = time.perf_counter()
    ref = hc.hash_scatter_add_plain(idx, v0, v1, t)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    idx_d, v0_d, v1_d = (a.to(dev) for a in (idx, v0, v1))
    out = hc.hash_scatter_add(idx_d, v0_d, v1_d, t).cpu()
    errs = [(float((out[l] - ref[l]).abs().max()), float(ref[l].abs().max()))
            for l in range(levels)]
    worst = max(e / (SCATTER_RTOL_OF_MAX * m) for e, m in errs)
    dense = sum((r + 1) ** 3 <= t for r in cfg.level_resolutions())
    print(f"  hash_scatter: {levels} levels ({dense} dense) × {rows} rows into "
          f"{levels} × {t} × 2, vector atomics {hc.vector_atomics()}; "
          f"max |card - cpu plain| per level "
          + ", ".join(f"{e:.3g}" for e, _ in errs)
          + f"; worst level at {worst:.3f} of its tolerance "
          f"({SCATTER_RTOL_OF_MAX}·max|plain|); cpu plain {cpu_ms:.1f} ms")
    if not worst <= 1.0:
        raise AssertionError("hash_scatter kernel differs from its plain version")
    # index_add_ over the same rows into a flattened table with one dump
    # row for the sentinels (indices prepared outside the timing).
    level = torch.arange(levels, device=dev)[:, None]
    flat = torch.where(idx_d < t, level * t + idx_d.long(),
                       torch.full_like(level, levels * t)).reshape(-1)
    vals = torch.stack([v0_d, v1_d], -1).reshape(-1, 2)
    times = each_device_ms(lambda: hc.hash_scatter_add(idx_d, v0_d, v1_d, t), 30)
    out = dict(
        max_abs_err=max(e for e, _ in errs),
        ms=statistics.median(times),
        plain_ms=device_ms(lambda: hc.hash_scatter_add_plain(
            idx_d, v0_d, v1_d, t), 10),
        library_ms=device_ms(lambda: torch.zeros(
            (levels * t + 1, 2), device=dev).index_add_(0, flat, vals), 10),
        bound=bound(levels * rows * 12 + levels * t * 2 * 4, 2 * levels * rows),
    )
    print(f"  hash_scatter: median {out['ms']:.4f} ms over 30 launches (min "
          f"{min(times):.4f}, max {max(times):.4f}), zeroing included; bound "
          f"{out['bound'][0]:.4f} ms by {out['bound'][1]}; plain version on the "
          f"card {out['plain_ms']:.4f} ms; index_add_ {out['library_ms']:.4f} ms")
    return out


def check_mesh_resolve(dev):
    """K5 against its plain version at the edit phase's shapes: the
    81,920-face icosphere from the first ring view at 512², default
    MeshRasterConfig. Everything must agree bit for bit."""
    from youreditableavatar_tpu_torch.models.cameras import sample_ring_cameras
    from youreditableavatar_tpu_torch.ops.mesh_raster import raster

    verts, faces = icosphere(FIT_SUBDIV)
    cfg = raster.MeshRasterConfig()
    cam = sample_ring_cameras(counts=EDIT_RING, height=HEIGHT,
                              width=WIDTH)[0].raster_camera(dev)
    with torch.no_grad():
        _, _, args = raster.tile_face_lists(
            torch.as_tensor(verts, device=dev),
            torch.as_tensor(faces.astype(np.int32), device=dev), cam, cfg)
        rows, face_s, starts, counts = args[:4]
        (zk, fk, bk), (zp, fp, bp) = (raster.resolve_tiles(*args),
                                      raster.resolve_tiles_plain(*args))
        pairs = int(counts.sum())
        mism = {"face_id": int((fk != fp).sum()), "z": int((zk != zp).sum()),
                "bary": int((bk != bp).sum())}
        err = max(float((zk - zp).abs().max()), float((bk - bp).abs().max()))
        print(f"  mesh_resolve: {len(faces)} faces, {pairs} (face, tile) pairs "
              f"of budget {cfg.pair_budget}, deepest tile {int(counts.max())}, "
              f"{int((fk >= 0).sum())} covered pixels; mismatches against the "
              f"plain version {json.dumps(mism)}, max |kernel - plain| = {err}")
        if any(mism.values()):
            raise AssertionError("mesh_resolve kernel differs from its plain version")
        if not 0 < pairs < cfg.pair_budget:
            raise AssertionError("the mesh raster's pair budget is too small")

        # A ragged tile edge and depth ties: a 500×300 view with every face
        # listed twice. The first copy must win every pixel.
        cam2 = sample_ring_cameras(counts=(1,), height=300,
                                   width=500)[0].raster_camera(dev)
        _, _, args2 = raster.tile_face_lists(
            torch.as_tensor(verts, device=dev),
            torch.as_tensor(np.concatenate([faces, faces]).astype(np.int32),
                            device=dev), cam2, cfg)
        tied_k = raster.resolve_tiles(*args2)
        tied_p = raster.resolve_tiles_plain(*args2)
        same = all(torch.equal(a, b) for a, b in zip(tied_k, tied_p))
        print(f"  mesh_resolve at 500×300 with every face twice: "
              f"{int(args2[3].sum())} pairs, bit-equal to the plain version: "
              f"{same}; largest visible face id {int(tied_k[1].max())} of "
              f"{2 * len(faces)} faces")
        if not (same and 0 <= int(tied_k[1].max()) < len(faces)):
            raise AssertionError("mesh_resolve differs on ties or a ragged edge")
        moved = (rows.numel() * 4 + face_s.numel() * 4 + 2 * starts.numel() * 4
                 + WIDTH * HEIGHT * 16)
        return dict(
            max_abs_err=err,
            ms=device_ms(lambda: raster.resolve_tiles(*args), 50),
            plain_ms=device_ms(lambda: raster.resolve_tiles_plain(*args), 3,
                               warmup=1),
            bound=bound(moved, MESH_OPS_PER_EVAL * pairs * cfg.tile_size ** 2),
        )


def phase_render(dev, kernels):
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        RasterizeConfig, render_gaussians)

    (means, scales, quats, opac, sh), cam = make_bench_scene(dev)
    leaves = [x.requires_grad_() for x in (means, scales, quats, opac, sh)]
    cfg = RasterizeConfig(pair_budget=PAIR_BUDGET, sh_degree=3)
    bg = torch.zeros(3, device=dev)
    state = {}

    def step():
        out = render_gaussians(*leaves, cam, cfg, bg)
        (out["image"] ** 2).mean().backward()
        state["out"] = out

    iters, warmup = 20, 3
    kernels.reset_launches()
    times = each_device_ms(step, iters, warmup=warmup)
    launches = {k: kernels.LAUNCHES[k] / (iters + warmup)
                for k in RENDER_KERNELS}
    out = state["out"]
    if not bool(torch.isfinite(out["image"]).all()):
        raise AssertionError("non-finite render")
    print(f"  render fwd+bwd {WIDTH}²/{N_GAUSS}: median "
          f"{statistics.median(times):.3f} ms over {iters} iterations "
          f"(min {min(times):.3f}, max {max(times):.3f}); num_pairs "
          f"{int(out['num_pairs'])} of budget {PAIR_BUDGET}; launches per "
          f"iteration {json.dumps(launches)}")
    if any(v == 0 for v in launches.values()):
        raise AssertionError("a kernel of the render path was never launched")
    median = statistics.median(times)
    profile_window(step, iters=5, step_ms=median)
    return median


def profile_window(step, iters, step_ms):
    """Device time by kernel over a short steady window (torch.profiler),
    and the device's busy share of the window's wall time and of the
    unprofiled median step `step_ms` (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side kernels only: user ranges (e.g. "Optimizer.step#Adam.step")
    # would count the kernels inside them a second time.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print("  profile: the profiler recorded no device time (not measured)")
        return
    print(f"  profile over {iters} iterations: device busy {busy_us / iters / 1e3:.3f} "
          f"ms of {wall_us / iters / 1e3:.3f} ms wall per iteration "
          f"(busy share {busy_us / wall_us:.3f}; of the unprofiled median "
          f"{step_ms:.3f} ms: {busy_us / iters / 1e3 / step_ms:.3f}); "
          f"{len(kernels)} distinct "
          f"kernels, {sum(e.count for e in kernels) / iters:.0f} launches per "
          f"iteration; top device time per iteration:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / iters / 1e3:8.3f} ms "
              f"{e.count / iters:5.0f}× {e.key[:90]}")


def phase_fit(dev, kernels):
    from youreditableavatar_tpu_torch.models.cameras import sample_ring_cameras
    from youreditableavatar_tpu_torch.models.tetgs import (
        TetGSParams, build_tetgs, gaussian_arrays)
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        RasterizeConfig, count_pairs, fit_pair_budget, render_gaussians)
    from youreditableavatar_tpu_torch.ops.sh import rgb_to_sh_dc
    from youreditableavatar_tpu_torch.stages.init_texture import (
        InitTextureConfig, TetGSInitTrainer)

    verts, faces = icosphere(FIT_SUBDIV)
    t0 = time.perf_counter()
    binding, params = build_tetgs(verts, faces, sh_levels=2, device=dev)
    print(f"  icosphere {len(faces)} faces → {binding.n_gaussians} Gaussians "
          f"(build_tetgs {time.perf_counter() - t0:.2f} s)")
    cams = sample_ring_cameras(radius=2.7, elevations=(10.0,),
                               counts=(FIT_VIEWS,), height=HEIGHT, width=WIDTH)

    # Targets: a copy whose SH-dc carries a colour pattern.
    colors = pattern_colors(binding.ori_points.cpu().numpy())
    target = TetGSParams(**{k: v.detach().clone()
                            for k, v in params.named_parameters()})
    with torch.no_grad():
        target.sh_dc.copy_(rgb_to_sh_dc(torch.as_tensor(
            colors, dtype=torch.float32, device=dev))[:, None, :])
        g = gaussian_arrays(binding, target)
        rcfg = RasterizeConfig(sh_degree=1)
        need = max(int(count_pairs(*g, c.raster_camera(dev), rcfg)) for c in cams)
        rcfg = dataclasses.replace(rcfg, pair_budget=fit_pair_budget(need))
        white = torch.ones(3, device=dev)
        for c in cams:
            img = render_gaussians(*g, c.raster_camera(dev), rcfg, white)["image"]
            c.image = img.clamp(0, 1).cpu().numpy()

    cfg = InitTextureConfig(num_iterations=FIT_STEPS, log_every=1,
                            sh_warmup_every=FIT_STEPS // 2,
                            auto_size_budget=True,
                            raster=RasterizeConfig(sh_degree=1))
    trainer = TetGSInitTrainer(binding, params, cams, cfg, device=dev)
    print(f"  auto-sized pair budget {trainer.cfg.raster.pair_budget}, tile "
          f"capacity {trainer.cfg.raster.tile_capacity}")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    losses = trainer.losses
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"  {FIT_STEPS} steps in {wall:.2f} s (logging every step); loss "
          f"first {losses[0]:.5f} last {losses[-1]:.5f}; mean of first 5 "
          f"{first:.5f}, of last 5 {last:.5f}; num_pairs at the last step "
          f"{trainer.stats[-1]['num_pairs']}; launches {json.dumps(launches)}")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError("the fit's loss did not fall or is not finite")
    if any(launches[k] == 0 for k in RENDER_KERNELS):
        raise AssertionError("a kernel of the fit was never launched")

    rng = np.random.default_rng(1)
    times = []
    for it in range(FIT_TIMED_STEPS):
        step = trainer.step_fn(FIT_STEPS + it)
        idx = int(rng.integers(0, len(cams)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(idx)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(times)
    print(f"  fit step at {WIDTH}²: median {median:.3f} ms "
          f"over {FIT_TIMED_STEPS} synchronised steps (min {min(times):.3f}, "
          f"max {max(times):.3f})")
    step = trainer.step_fn(FIT_STEPS + FIT_TIMED_STEPS)
    profile_window(lambda: step(0), iters=5, step_ms=median)
    return launches


def phase_edit(dev, kernels):
    """InpaintTrainer → prepare_refine_guidance → RefineTrainer → validate."""
    from youreditableavatar_tpu_torch.guidance.stub import StubInpainter
    from youreditableavatar_tpu_torch.models.cameras import (
        sample_circle_cameras, sample_ring_cameras)
    from youreditableavatar_tpu_torch.models.tetgs import (
        build_tetgs, extract_keep_gaussians)
    from youreditableavatar_tpu_torch.models.tetgs_edit import build_edit_tetgs
    from youreditableavatar_tpu_torch.models.textured_mesh import (
        TexturedMeshModel)
    from youreditableavatar_tpu_torch.ops.mesh_raster import (
        MeshRasterConfig, rasterize_mesh)
    from youreditableavatar_tpu_torch.ops.sh import rgb_to_sh_dc
    from youreditableavatar_tpu_torch.stages.edit_texture import (
        InpaintConfig, InpaintTrainer, RefineConfig, RefineTrainer)
    from youreditableavatar_tpu_torch.utils.graphics import inverse_sigmoid

    # The fit phase's model as the stage-2 source: colour pattern, opaque.
    verts, faces = icosphere(FIT_SUBDIV)
    binding, params = build_tetgs(verts, faces, None, np.arange(len(faces)),
                                  sh_levels=2, device=dev)
    with torch.no_grad():
        params.sh_dc.copy_(rgb_to_sh_dc(torch.as_tensor(
            pattern_colors(binding.ori_points.cpu().numpy()),
            dtype=torch.float32, device=dev))[:, None, :])
        params.opacity_raw.fill_(float(inverse_sigmoid(torch.tensor(0.9))))
    # The cap z > EDIT_CAP_Z is the editable region; its faces, re-indexed,
    # are the edit mesh, the Gaussians of all other faces are kept.
    in_cap = verts[faces].mean(1)[:, 2] > EDIT_CAP_Z
    keep = extract_keep_gaussians(binding, params, np.flatnonzero(~in_cap))
    used = np.unique(faces[in_cap])
    remap = np.zeros(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    ebinding, eparams = build_edit_tetgs(verts[used], remap[faces[in_cap]],
                                         keep, sh_levels=1, device=dev)
    editable = verts[:, 2] > EDIT_CAP_Z
    mcfg = MeshRasterConfig()
    mesh_model = TexturedMeshModel(verts, faces, editable, mcfg, device=dev)
    ring = sample_ring_cameras(counts=EDIT_RING, height=HEIGHT, width=WIDTH)
    turntable = sample_circle_cameras(EDIT_TURNTABLE, height=HEIGHT, width=WIDTH)
    print(f"  {binding.n_gaussians} stage-2 Gaussians → {ebinding.n_keep} kept "
          f"+ {ebinding.n_edit} edit disks on {int(in_cap.sum())} cap faces; "
          f"{int(editable.sum())} editable vertices; {len(ring)} ring and "
          f"{len(turntable)} turntable views at {WIDTH}²")

    # Before the counted run: the mesh raster's pairs stay under its budget
    # in every view, and the editable vertices that some ring view sees.
    seen = np.zeros(len(verts), bool)
    most = 0
    for i, c in enumerate(ring + turntable):
        out = rasterize_mesh(mesh_model.verts, mesh_model.faces,
                             c.raster_camera(dev), mcfg)
        most = max(most, int(out.num_pairs))
        if i < len(ring):
            fid = out.face_id.cpu().numpy()
            seen[np.unique(faces[np.unique(fid[fid >= 0])])] = True
    print(f"  mesh raster: at most {most} (face, tile) pairs in a view, "
          f"budget {mcfg.pair_budget}")
    if not most < mcfg.pair_budget:
        raise AssertionError("the mesh raster's pair budget is too small")

    a, b, c = EDIT_LADDER
    cfg = InpaintConfig(iters_first=a, iters_second=b, iters_rest=c,
                        first_group=EDIT_GROUPS[0], second_group=EDIT_GROUPS[1])
    inpaint = InpaintTrainer(ebinding, eparams, mesh_model, ring,
                             StubInpainter(), "a red hat", "blurry", cfg,
                             device=dev)
    print(f"  inpaint: auto-sized pair budget {inpaint.cfg.raster.pair_budget}, "
          f"tile capacity {inpaint.cfg.raster.tile_capacity}")

    # Log what the trainer does not keep: each fit step's loss and time,
    # and the painted count after each view's back-projection.
    fit_log, painted_log = [], []
    fit_step, back_project = inpaint._fit_step, mesh_model.back_project

    def logged_fit_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, diag = fit_step(*args)
        torch.cuda.synchronize()
        fit_log.append((loss, (time.perf_counter() - t0) * 1e3))
        return loss, diag

    def logged_back_project(*args, **kw):
        out = back_project(*args, **kw)
        painted_log.append(int(mesh_model.painted.sum()))
        return out

    inpaint._fit_step = logged_fit_step
    mesh_model.back_project = logged_back_project

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inpaint.inpaint_training(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_inpaint = time.perf_counter() - t0
    blends = inpaint.prepare_refine_guidance(
        turntable, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    t_guidance = time.perf_counter() - t0 - t_inpaint
    refine = RefineTrainer(ebinding, inpaint.params, turntable, blends,
                           RefineConfig(num_iterations=EDIT_REFINE_STEPS,
                                        key_views=(0, EDIT_TURNTABLE // 2)),
                           device=dev)
    refine_log = []
    refine_step = refine.step

    def logged_refine_step(view_idx):
        loss, diag = refine_step(view_idx)
        refine_log.append((view_idx, loss))
        return loss, diag

    refine.step = logged_refine_step
    t1 = time.perf_counter()
    refine.refined_editing(seed=0)
    torch.cuda.synchronize()
    t_refine = time.perf_counter() - t1
    final = refine.validate(turntable)
    launches = dict(kernels.LAUNCHES)
    inpaint._fit_step, refine.step = fit_step, refine_step
    mesh_model.back_project = back_project

    # Checks.
    images = blends + final
    if not all(im.shape == (HEIGHT, WIDTH, 3) and np.isfinite(im).all()
               for im in images):
        raise AssertionError("a blend or validate image is not finite")
    iters = [h["iters"] for h in inpaint.history]
    if len(fit_log) != sum(iters):
        raise AssertionError("a view's fit was restarted: the budget grew")
    first_last, pos = [], 0
    for n in iters:
        first_last.append((float(fit_log[pos][0]), float(fit_log[pos + n - 1][0])))
        pos += n
    # A view that finds nothing left to paint starts at a loss of 0 (its
    # target is its own render) and must stay there; every other view's
    # loss must fall.
    if not all(np.isfinite(l) and (l < f or f < EDIT_NO_TARGET_LOSS > l)
               for f, l in first_last):
        raise AssertionError(f"a view's fit loss did not fall: {first_last}")
    share = float((mesh_model.painted & seen).sum()) / max(
        int((editable & seen).sum()), 1)
    grew = all(y >= x for x, y in zip(painted_log, painted_log[1:]))
    if not (grew and painted_log[-1] > painted_log[0] > 0
            and share >= EDIT_MIN_PAINTED):
        raise AssertionError(f"painted set {painted_log}, share {share:.3f}")
    by_view = {}
    for vi, loss in refine_log:
        by_view.setdefault(vi, []).append(float(loss))
    again = [v for v in by_view.values() if len(v) > 1]
    r_first, r_last = sum(v[0] for v in again), sum(v[-1] for v in again)
    if not (len(refine_log) == EDIT_REFINE_STEPS and again
            and np.isfinite(r_last) and r_last < r_first):
        raise AssertionError(f"the refine loss did not fall: {by_view}")
    if any(launches[k] == 0 for k in RENDER_KERNELS + ("mesh_resolve",)):
        raise AssertionError("a kernel of the edit stage was never launched")
    fit_ms = statistics.median(ms for _, ms in fit_log)
    print(f"  inpaint: {len(ring)} views, {sum(iters)} fit steps in "
          f"{t_inpaint:.2f} s; fit step median {fit_ms:.3f} ms (synchronised; "
          f"min {min(ms for _, ms in fit_log):.3f}, max "
          f"{max(ms for _, ms in fit_log):.3f}); loss first → last per view "
          + ", ".join(f"{f:.5f} → {l:.5f}" for f, l in first_last))
    print(f"  painted vertices after each view {painted_log}: {share:.3f} of "
          f"the {int((editable & seen).sum())} editable vertices a ring view sees")
    print(f"  refine guidance: {len(blends)} blends in {t_guidance:.2f} s; "
          f"refine: {EDIT_REFINE_STEPS} steps in {t_refine:.2f} s, pair budget "
          f"{refine.cfg.raster.pair_budget}; summed loss of the "
          f"{len(again)} views visited twice or more, first visit "
          f"{r_first:.5f} → last {r_last:.5f}")
    print(f"  launches over the stage {json.dumps(launches)}")

    # Times of the three steps a user repeats.
    cam0 = ring[0].raster_camera(dev)
    view_ms = each_device_ms(lambda: mesh_model.render_view(cam0), 20)
    rng = np.random.default_rng(2)
    times = []
    for _ in range(EDIT_TIMED_STEPS):
        vi = int(rng.integers(0, len(turntable)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refine.step(vi)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    refine_ms = statistics.median(times)
    print(f"  render_view at {WIDTH}²: median {statistics.median(view_ms):.3f} "
          f"ms of device time (min {min(view_ms):.3f}, max {max(view_ms):.3f}); "
          f"refine step: median {refine_ms:.3f} ms over {EDIT_TIMED_STEPS} "
          f"synchronised steps (min {min(times):.3f}, max {max(times):.3f})")

    # Profiles: one inpaint fit step (fresh copy of the weights, as each
    # view's fit starts), one render_view, one refine step.
    from youreditableavatar_tpu_torch.stages.edit_texture import (
        make_edit_optimizer)

    probe = inpaint.params.copy()
    optimizer = make_edit_optimizer(probe, cfg.lr_sh, cfg.lr_opacity,
                                    inpaint.train_mask)
    view = mesh_model.render_view(cam0)
    target = torch.as_tensor(blends[0], device=dev)
    weight = (view["editable"] > 0.5).to(torch.float32)
    print("  inpaint fit step:")
    profile_window(lambda: fit_step(probe, optimizer, cam0, target, weight),
                   iters=5, step_ms=fit_ms)
    print("  render_view:")
    profile_window(lambda: mesh_model.render_view(cam0), iters=5,
                   step_ms=statistics.median(view_ms))
    print("  refine step:")
    profile_window(lambda: refine.step(0), iters=5, step_ms=refine_ms)
    return launches


def phase_spatial(dev, kernels):
    """Stages 0–1 at full width: ShapeInitializer, then HumanEditTrainer."""
    from youreditableavatar_tpu_torch.data.camera_sampler import (
        RandomCameraConfig)
    from youreditableavatar_tpu_torch.guidance.prompts import PromptProcessor
    from youreditableavatar_tpu_torch.guidance.sds import SDSConfig, SDSGuidance
    from youreditableavatar_tpu_torch.guidance.stub import (
        StubDiffusionPrior, StubPromptEncoder)
    from youreditableavatar_tpu_torch.models.geometry import TetGeometry
    from youreditableavatar_tpu_torch.models.sdf import SDFField, SDFFieldConfig
    from youreditableavatar_tpu_torch.native import MeshSDF
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
    from youreditableavatar_tpu_torch.stages.spatial import (
        HumanEditConfig, HumanEditTrainer, ShapeInitConfig, ShapeInitializer,
        align_anchor_mesh)

    # ---- shape init on the icosphere (stage 0) ----
    verts, faces = icosphere(FIT_SUBDIV)
    body, _ = align_anchor_mesh(verts.astype(np.float64))
    field = SDFField(SDFFieldConfig(sdf_bias="sphere", sdf_bias_radius=0.4))
    geometry = TetGeometry(field, SPATIAL_GRID, device=dev)
    cfg = ShapeInitConfig(
        sdf_iters=INIT_SDF_STEPS, normal_iters=INIT_NORMAL_STEPS,
        normal_height=HEIGHT, normal_width=WIDTH,
        camera=dataclasses.replace(ShapeInitConfig().camera, height=HEIGHT,
                                   width=WIDTH))
    init = ShapeInitializer(field, geometry, cfg, device=dev)
    stamps = {"sdf": [], "normal": []}
    draw = init.draw

    def timed_draw(phase, step):  # one call at the start of every step
        if phase in stamps:
            torch.cuda.synchronize()
            stamps[phase].append(time.perf_counter())
        return draw(phase, step)

    init.draw = timed_draw
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, info = init.run(body, faces, seed=0)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    init_launches = dict(kernels.LAUNCHES)
    init_peak = torch.cuda.max_memory_allocated() / 2**20
    sdf_ms = statistics.median(np.diff(stamps["sdf"]) * 1e3)
    normal_ms = statistics.median(
        np.diff(stamps["normal"] + [t_end]) * 1e3)
    trace = {k: [float(x) for x in v] for k, v in init.trace.items()}
    with torch.no_grad():
        mt = geometry.isosurface(params, level_mask=field.level_mask(0, dev))
        rng = np.random.default_rng(5)
        probe = rng.uniform(-0.95, 0.95, (20_000, 3)).astype(np.float32)
        pred = field.forward_sdf(params, torch.as_tensor(probe, device=dev),
                                 field.level_mask(0, dev)).cpu().numpy()
    gt = MeshSDF(body, faces)(probe)
    corr = float(np.corrcoef(pred, gt)[0, 1])
    # One launch per SDF step; per normal step one per 262,144-point chunk
    # of the grid (2 at grid 64) and one for the anchor points.
    chunks = -(-(SPATIAL_GRID + 1) ** 3 // 262_144)
    k4_expect = INIT_SDF_STEPS + (chunks + 1) * INIT_NORMAL_STEPS
    print(f"  shape init on {len(faces)} faces: MeshSDF native "
          f"{init.using_native}; pool of {cfg.sdf_pool_size} points + setup "
          f"{stamps['sdf'][0] - t0:.2f} s; SDF step median {sdf_ms:.3f} ms "
          f"over {INIT_SDF_STEPS} steps, loss {trace['sdf'][0]:.5f} → "
          f"{trace['sdf'][-1]:.6f}; normal step median {normal_ms:.3f} ms over "
          f"{INIT_NORMAL_STEPS} steps at {cfg.normal_height}², loss "
          f"{trace['normal'][0]:.5f} → {trace['normal'][-1]:.5f}; launches "
          f"{json.dumps(init_launches)} (hash_scatter per SDF step 1, per "
          f"normal step {chunks + 1}); isosurface {int(mt.num_verts)} vertices, "
          f"{int(mt.num_faces)} faces; field vs mesh SDF on 20,000 probes: "
          f"corr {corr:.4f}; peak memory {init_peak:.0f} MiB")
    if not init.using_native:
        raise AssertionError("MeshSDF fell back to numpy")
    losses = trace["sdf"] + trace["normal"]
    if not (np.all(np.isfinite(losses)) and trace["sdf"][-1] < trace["sdf"][0]):
        raise AssertionError("the shape init's loss did not fall or is not finite")
    if init_launches["hash_scatter"] != k4_expect:
        raise AssertionError(f"hash_scatter launched {init_launches['hash_scatter']} "
                             f"times in the shape init, not {k4_expect}")
    if not (corr > 0.9 and 0 < int(mt.num_faces) <= geometry.budgets.mt_faces
            and int(mt.num_verts) <= geometry.budgets.mt_verts):
        raise AssertionError("the fitted field does not follow the mesh")
    # Profile: a short shape init (1 SDF + 3 normal steps; a pool of
    # 200,000 points keeps the host BVH queries out of the way).
    short = ShapeInitializer(field, geometry, dataclasses.replace(
        cfg, sdf_iters=1, normal_iters=3, sdf_pool_size=200_000), device=dev)
    print("  shape init, 1 SDF + 3 normal steps:")
    profile_window(lambda: short.run(body, faces, seed=1), iters=1,
                   step_ms=sdf_ms + 3 * normal_ms)

    # ---- SDS geometry edit (stage 1), bench_spatial's operating point ----
    field = SDFField(SDFFieldConfig(sdf_bias="sphere", sdf_bias_radius=0.45))
    params = field.init_params(0, device=dev)
    geometry = TetGeometry(field, SPATIAL_GRID, device=dev)
    with torch.no_grad():
        mt = geometry.isosurface(params)
        fc = mt.verts[mt.faces.long()].mean(1)
        edit_faces = (fc[:, 2] > EDIT_CAP_Z) & mt.faces_valid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part = geometry.partition_init(params, edit_faces, frozen_mt=mt)
    torch.cuda.synchronize()
    t_part = time.perf_counter() - t0
    prior = StubDiffusionPrior(device=dev)
    guidance = SDSGuidance(prior, SDSConfig(guidance_scale=7.5))
    cache = kernels.BUILD_DIR / "text_embeddings"
    prompts = PromptProcessor("a red down jacket", "low quality",
                              StubPromptEncoder(device=dev),
                              cache_dir=str(cache), model_name="bench-stub")
    ecfg = HumanEditConfig(camera=RandomCameraConfig(height=HEIGHT, width=WIDTH))
    mcfg = MeshRasterConfig()
    trainer = HumanEditTrainer(field, geometry, part, params, guidance,
                               prompts, prompts, ecfg, mcfg, device=dev)
    print(f"  edit: isosurface {int(mt.num_faces)} faces, "
          f"{int(edit_faces.sum())} editable; partition_init {t_part:.2f} s: "
          f"{part.live_vert_idx.numel()} live vertices, "
          f"{part.update_tet_idx.numel()} update tets, keep mesh "
          f"{int(part.keep_mesh.num_faces)} faces")
    for start in EDIT_STARTS:
        trainer.global_step = start
        for _ in range(EDIT_WARM):
            trainer.train_step(seed=1)
        before = dict(kernels.LAUNCHES)
        recs, times = [], []
        for _ in range(EDIT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs.append(trainer.train_step(seed=1))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = {k: (kernels.LAUNCHES[k] - before[k]) / EDIT_TIMED
                    for k in ("hash_scatter", "mesh_resolve")}
        median = statistics.median(times)
        pairs = max(r["mesh_pairs"] for r in recs)
        n_active = min(8 + start // 1000, 16)
        print(f"  edit from step {start} ({n_active} hash levels): step median "
              f"{median:.3f} ms over {EDIT_TIMED} synchronised steps (min "
              f"{min(times):.3f}, max {max(times):.3f}); loss first "
              f"{recs[0]['loss']:.4f} last {recs[-1]['loss']:.4f}; sds "
              f"{recs[-1]['sds']:.4f}, recon {recs[-1]['recon']:.3g}, nc "
              f"{recs[-1]['nc']:.5f}; launches per step {json.dumps(per_step)}; "
              f"mesh pairs at most {int(pairs)} of budget {mcfg.pair_budget}")
        if not all(np.isfinite(v) for r in recs for v in r.values()):
            raise AssertionError("a non-finite edit loss")
        if per_step["hash_scatter"] != K4_PER_EDIT_STEP:
            raise AssertionError("hash_scatter did not launch 3 times per edit step")
        if not pairs < mcfg.pair_budget:
            raise AssertionError("the mesh raster's pair budget is too small")
        profile_window(lambda: trainer.train_step(seed=1), iters=5,
                       step_ms=median)
    moved = float((trainer.params.grid.detach()
                   - trainer.frozen_params.grid).abs().sum())
    print(f"  parameters moved: Σ|Δ table| = {moved:.6g}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if not (np.isfinite(moved) and moved > 0):
        raise AssertionError("the edit did not move the parameters")
    return dict(kernels.LAUNCHES)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_sharded(dev, kernels):
    """The sharded TetGS step (views over `data`, tile rows over `tile`) as
    a one-rank NCCL world, at the fit phase's width: the 81,920-face
    icosphere (122,880 Gaussians), 8 ring views at 512². Its first step is
    held against the single-device render (K1f + K1b), 2 and 4 bands
    rendered in this process against the unsharded image and gradients,
    then SHARDED_STEPS steps are timed and their launches counted."""
    import os

    import torch.distributed as dist

    from youreditableavatar_tpu_torch.models.cameras import sample_ring_cameras
    from youreditableavatar_tpu_torch.models.optimizer import (
        OptimizationParams, make_tetgs_optimizer)
    from youreditableavatar_tpu_torch.models.tetgs import (
        TetGSParams, build_tetgs, gaussian_arrays)
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        RasterizeConfig, count_pairs, fit_pair_budget, render_gaussians)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_xla import (
        assemble_image)
    from youreditableavatar_tpu_torch.ops.image_losses import l1_dssim
    from youreditableavatar_tpu_torch.ops.sh import rgb_to_sh_dc
    from youreditableavatar_tpu_torch.parallel import (
        distributed_init, make_mesh, make_sharded_render_train_step)
    from youreditableavatar_tpu_torch.parallel.train_step import render_band
    from youreditableavatar_tpu_torch.utils.misc import assert_replicated

    for key, value in (("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", str(_free_port())), ("RANK", "0"),
                       ("WORLD_SIZE", "1")):
        os.environ.setdefault(key, value)
    rank, world = distributed_init(device=dev)
    try:
        mesh = make_mesh((1, 1), device=dev)
        print(f"  process group: rank {rank} of {world}, backend "
              f"{dist.get_backend()}, mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")
        if dist.get_backend() != "nccl":
            raise AssertionError("the sharded step on the card must run on NCCL")

        verts, faces = icosphere(FIT_SUBDIV)
        binding, params = build_tetgs(verts, faces, sh_levels=2, device=dev)
        cams = [c.raster_camera(dev) for c in sample_ring_cameras(
            radius=2.7, elevations=(10.0,), counts=(FIT_VIEWS,), height=HEIGHT,
            width=WIDTH)]
        bg = torch.zeros(3, device=dev)
        with torch.no_grad():  # targets: the colour-pattern copy's renders
            target = TetGSParams(**{k: v.detach().clone()
                                    for k, v in params.named_parameters()})
            target.sh_dc.copy_(rgb_to_sh_dc(torch.as_tensor(
                pattern_colors(binding.ori_points.cpu().numpy()),
                dtype=torch.float32, device=dev))[:, None, :])
            g = gaussian_arrays(binding, target)
            cfg = RasterizeConfig(sh_degree=1)
            need = max(int(count_pairs(*g, c, cfg)) for c in cams)
            cfg = dataclasses.replace(cfg, pair_budget=fit_pair_budget(need))
            images = torch.stack([
                render_gaussians(*g, c, cfg, torch.ones(3, device=dev))["image"]
                .clamp(0, 1) for c in cams])
        batch = {"viewmats": torch.stack([c.viewmat for c in cams]),
                 **{k: torch.stack([getattr(c, k) for c in cams])
                    for k in ("fx", "fy", "cx", "cy")},
                 "images": images}
        start = TetGSParams(**{k: v.detach().clone()
                               for k, v in params.named_parameters()})
        opt = make_tetgs_optimizer(params, OptimizationParams(), 1.0)
        step = make_sharded_render_train_step(binding, opt, cfg, mesh, HEIGHT,
                                              WIDTH, bg=bg)

        # 1. The first step against the single-device render and loss.
        params, opt, loss, overflow = step(params, batch)
        grads = [p.grad.detach().clone() for p in params.parameters()]
        arrays = gaussian_arrays(binding, start)
        ref = torch.stack([l1_dssim(render_gaussians(*arrays, c, cfg, bg)["image"],
                                    images[i], 0.2)
                           for i, c in enumerate(cams)]).mean()
        ref.backward()
        ratios = [float((a - b.grad).abs().max())
                  / (GRAD_RTOL_OF_MAX * max(float(b.grad.abs().max()), 1e-12))
                  for a, b in zip(grads, start.parameters())]
        ref = ref.detach()
        rel = abs(float(loss) - float(ref)) / abs(float(ref))
        print(f"  {binding.n_gaussians} Gaussians, {len(cams)} views at "
              f"{WIDTH}², pair budget {cfg.pair_budget} per band (the most a "
              f"view needs: {need}); first step loss {float(loss):.6f} vs "
              f"single-device {float(ref):.6f} (relative {rel:.2e}); gradient "
              f"errors per leaf as fractions of {GRAD_RTOL_OF_MAX}·max|g|: "
              + ", ".join(f"{r:.3f}" for r in ratios)
              + f"; tiles over capacity {int(overflow)}")
        if not (rel <= 1e-5 and max(ratios) <= 1.0):
            raise AssertionError("the sharded step differs from the single-device step")

        # 2. 2 and 4 bands of one view in this process against the render.
        leaves = [x.detach().requires_grad_() for x in arrays]
        out = render_gaussians(*leaves, cams[0], cfg, bg)["image"]
        want = torch.autograd.grad(l1_dssim(out, images[0], 0.2), leaves)
        for n_bands in SHARDED_BANDS:
            parts = [render_band(*leaves, cams[0], cfg, b, n_bands)
                     for b in range(n_bands)]
            ntiles = WIDTH // cfg.tile_size
            img, t_img = assemble_image(torch.cat([q[0] for q in parts]),
                                        torch.cat([q[1] for q in parts]),
                                        ntiles, ntiles, cfg.tile_size, WIDTH,
                                        HEIGHT)
            img = img + t_img[..., None] * bg
            got = torch.autograd.grad(l1_dssim(img, images[0], 0.2), leaves)
            img_err = float((img - out).detach().abs().max())
            band_ratios = [float((a - b).abs().max())
                           / (GRAD_RTOL_OF_MAX * max(float(b.abs().max()), 1e-12))
                           for a, b in zip(got, want)]
            print(f"  {n_bands} bands of view 0: image |bands - unsharded| = "
                  f"{img_err:.3g} (atol {FWD_ATOL}); input-gradient errors as "
                  f"fractions of their tolerance: "
                  + ", ".join(f"{r:.3f}" for r in band_ratios))
            if not (img_err <= FWD_ATOL and max(band_ratios) <= 1.0):
                raise AssertionError(f"{n_bands} bands differ from the render")

        # 3. The main path: SHARDED_STEPS synchronised steps, counted.
        kernels.reset_launches()
        losses, times = [], []
        for _ in range(SHARDED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss, overflow = step(params, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        launches = dict(kernels.LAUNCHES)
        per_step = {k: launches[k] / SHARDED_STEPS for k in SHARDED_KERNELS}
        median = statistics.median(times)
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"  {SHARDED_STEPS} steps: median {median:.3f} ms (min "
              f"{min(times):.3f}, max {max(times):.3f}); loss {losses[0]:.6f} → "
              f"{losses[-1]:.6f} (means of first and last 5: {first:.6f} → "
              f"{last:.6f}); launches per step {json.dumps(per_step)}")
        if not (np.all(np.isfinite(losses)) and last < first):
            raise AssertionError("the sharded step's loss did not fall")
        if any(per_step[k] != len(cams) for k in SHARDED_KERNELS):
            raise AssertionError("a kernel of the sharded step did not launch "
                                 "once per view and step")
        if launches["composite_backward"] != 0:
            raise AssertionError("the sharded step went through the fused backward")
        assert_replicated(params)
        profile_window(lambda: step(params, batch), iters=3, step_ms=median)
        return launches
    finally:
        dist.destroy_process_group()


SOURCES = {
    "tile_histogram": ("youreditableavatar_tpu_torch/csrc/counting.cu",
                       "youreditableavatar_tpu/ops/gaussian_raster/counting.py:89"),
    "counting_layout": ("youreditableavatar_tpu_torch/csrc/counting.cu",
                        "youreditableavatar_tpu/ops/gaussian_raster/counting.py:184"),
    "expand_pairs": ("youreditableavatar_tpu_torch/csrc/expand.cu",
                     "youreditableavatar_tpu/ops/gaussian_raster/expand_pallas.py:305"),
    "composite_forward": ("youreditableavatar_tpu_torch/csrc/composite.cu",
                          "youreditableavatar_tpu/ops/gaussian_raster/composite_pallas.py:510"),
    "composite_backward": ("youreditableavatar_tpu_torch/csrc/composite.cu",
                           "youreditableavatar_tpu/ops/gaussian_raster/composite_pallas.py:867"),
    "composite_backward_pairs": (
        "youreditableavatar_tpu_torch/csrc/composite.cu",
        "youreditableavatar_tpu/ops/gaussian_raster/composite_pallas.py:545"),
    "mesh_resolve": ("youreditableavatar_tpu_torch/csrc/mesh_resolve.cu",
                     "youreditableavatar_tpu/ops/mesh_raster/raster.py:385"),
    "hash_scatter": ("youreditableavatar_tpu_torch/csrc/hash_scatter.cu",
                     "youreditableavatar_tpu/ops/hashgrid_pallas.py:148"),
}


def run_phase(name, fn, failures):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    try:
        result = fn()
        torch.cuda.synchronize()  # a fault in the phase surfaces here
    except Exception:  # report, keep going, fail at the end
        traceback.print_exc()
        failures.append(name)
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.2f} s", flush=True)
        return None
    print(f"[{name}] ok in {time.perf_counter() - t0:.2f} s", flush=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from youreditableavatar_tpu_torch import _kernels

    dev = torch.device("cuda")
    failures: list = []
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]

    def device():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} × {torch.cuda.device_count()}")

    def build():
        t0 = time.perf_counter()
        _kernels.library()
        print(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s "
              f"(nvcc {_kernels.BUILD_SECONDS} s)")
        # ptxas on the compositing kernels: registers, shared memory, spills.
        for line in _kernels.BUILD_LOGS.get("composite.cu", "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas composite.cu:", line.split("ptxas info")[-1].strip())

    report: dict = {}
    run_phase("device", device, failures)
    run_phase("build", build, failures)
    if failures:
        return 1
    phases = {
        "kernels": lambda: phase_kernels(dev, report),
        "render": lambda: phase_render(dev, _kernels),
        "fit": lambda: phase_fit(dev, _kernels),
        "edit": lambda: phase_edit(dev, _kernels),
        "spatial": lambda: phase_spatial(dev, _kernels),
        "sharded": lambda: phase_sharded(dev, _kernels),
    }
    results = {name: run_phase(name, fn, failures)
               for name, fn in phases.items()}
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    # Each kernel's launches come from the run of its own main path.
    main_path = {"mesh_resolve": "edit", "hash_scatter": "spatial",
                 "composite_backward_pairs": "sharded"}

    kernels = []
    for name in _kernels.KERNEL_NAMES:
        r = report[name]
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": results[main_path.get(name, "fit")][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
