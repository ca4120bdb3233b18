#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases (each prints its line and seconds; any failure exits non-zero and
prints no result):
  1. device  — the card, its power limit; TF32 off for matmul and cuDNN.
  2. build   — nvcc builds every kernel under youreditableavatar_tpu_torch/csrc.
  3. kernels — every kernel against its plain PyTorch version on the card:
               pair expansion, tile histogram and counting ranks bit-exact,
               compositing forward and its gradient at full width, the
               render's input gradients at 256² (20k Gaussians) against the
               plain render on the CPU, plus each kernel's time, its plain
               version's time and its bound at the main-path shapes.
  4. render  — render forward + backward on the 512²/100k sphere-shell scene.
  5. fit     — the init-texture trainer (TetGSInitTrainer) for 50 steps at
               512² on an icosphere with 6 subdivisions (81,920 faces) and
               8 ring cameras; targets rendered from a colour-pattern copy.
  6. a `kernels` JSON line: each kernel's launches on the main path (the
     fit), error against its plain version, ms, plain ms and bound.
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
# Kernel vs plain tolerances: the compositing forward repeats the plain
# version's f32 ops (both use expf), so images agree to rounding; float
# atomics reorder the backward's sums, held like the JAX suite's backends.
FWD_ATOL = 1e-5
GRAD_RTOL_OF_MAX = 5e-5


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
        fwd_bytes = (fields.numel() * 4 + pg.numel() * 4 + 2 * num_t * 4
                     + num_t * 5 * 1024 * 4)
        report["composite_forward"] = dict(
            max_abs_err=err,
            ms=device_ms(lambda: comp.composite_tiles_fused(
                fields, pg, astart, tcount, ntx, nty), 20),
            plain_ms=device_ms(lambda: comp.composite_tiles_plain(
                fields, pg, astart, tcount, ntx, nty), 2, warmup=1),
            bound=bound(fwd_bytes, FWD_OPS_PER_EVAL * evals),
        )

    # K1b at full width: the kernel's gradient (through the autograd
    # Function) against autograd of the plain version, same random
    # cotangents, each of the 9 columns at GRAD_RTOL_OF_MAX · its max|g|.
    gen = torch.Generator(device=dev).manual_seed(1)
    drgb = torch.randn(rk.shape, generator=gen, device=dev)
    dt = torch.randn(fk.shape, generator=gen, device=dev)
    bwd_ms = device_ms(lambda: comp._backward_raw(
        fields, pg, astart, tcount, rk, fk, drgb, dt, ntx), 20)

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
          f"({GRAD_RTOL_OF_MAX}·max|g|)")
    if not worst <= 1.0:
        raise AssertionError("composite backward kernel differs")
    bwd_bytes = (fields.numel() * 4 * 2 + pg.numel() * 4 + 2 * num_t * 4
                 + num_t * 8 * 1024 * 4)

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
        bound=bound(bwd_bytes, BWD_OPS_PER_EVAL * evals),
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
    launches = {k: v / (iters + warmup) for k, v in kernels.LAUNCHES.items()}
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
    if any(v == 0 for v in launches.values()):
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

    report: dict = {}
    run_phase("device", device, failures)
    run_phase("build", build, failures)
    if failures:
        return 1
    run_phase("kernels", lambda: phase_kernels(dev, report), failures)
    run_phase("render", lambda: phase_render(dev, _kernels), failures)
    launches = run_phase("fit", lambda: phase_fit(dev, _kernels),
                         failures) or {}
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1

    kernels = []
    for name in _kernels.KERNEL_NAMES:
        r = report[name]
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
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
