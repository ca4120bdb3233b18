#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py                  # every phase, as the check runs it
    python3 chip_smoke.py --phases kernels # device, build, then those phases

Phases (each prints its line and seconds; any failure exits non-zero and
prints no result):
  1. device  — the card, its power limit; TF32 off for matmul and cuDNN.
  2. build   — nvcc builds every kernel under youreditableavatar_tpu_torch/csrc
               (ptxas's registers / shared memory of the compositing kernels;
               the compositing forward's resident 4-CTA clusters).
  3. kernels — every kernel against its plain PyTorch version on the card:
               pair expansion, tile histogram and counting ranks bit-exact
               at the render's, the inpaint fit's and a sharded band's pair
               budgets (each kernel's own launch timed apart from its
               wrapper, with the profiled device time by kernel), the
               expansion with its total past the budget, the ranks over
               1024 blocks at 257 and 16,385 bins, the tile histogram
               bit-exact on a partial last CTA (13 blocks), one block, an
               input all sentinel and bin counts up to MAX_BINS,
               compositing forward (its checkpoints bit-exact) and its
               gradient at full width with the tile-depth line, the
               per-pair compositing backward (K6) over the same layout's
               gathered rows (two launches bit-identical; the gather and
               its backward timed apart), K1b and K6 on an adversarial
               layout built against their cull, the forward over direct
               rows at the sharded step's layout, the render's input
               gradients at 256² (20k Gaussians) against the plain render
               on the CPU, the mesh z-buffer resolve bit-exact at 512² on
               the 81,920-face icosphere, at 500×300 with every face twice
               and on slivers listed twice (with its layout statistics:
               pairs, deepest tile, (pair, quarter) and (pair, warp) sweeps
               in the face box, evaluations inside), the hash-grid scatter
               at a uniform and a sphere-shell shape with its time split
               (zero fill, dense levels, hashed levels), the row gather's
               backward (padding spread off row 0) beside index_select's,
               plus each kernel's time, its plain version's time and its
               bound at the main-path shapes.
  4. render  — render forward + backward on the 512²/100k sphere-shell scene.
  5. fit     — the init-texture trainer (TetGSInitTrainer) for 50 steps at
               512² on an icosphere with 6 subdivisions (81,920 faces) and
               8 ring cameras; targets rendered from a colour-pattern copy.
  6. edit    — the edit-texture stage on the same icosphere: InpaintTrainer
               (8 ring views, stub inpainter, the cap z > 0.1 editable) →
               prepare_refine_guidance (8 turntable views) → RefineTrainer
               (40 steps) → validate, at 512²; then, at small depth, the
               inpaint with a HeuristicSegmenter (the edge fix of views 0
               and 1), the refine with an LPIPS term (10 steps) and
               LocalMeshEditing.localize from 3 ring views.
  7. spatial — the spatial stage at full width (16 levels × 2^19 hash grid,
               grid 64, 512² normal maps), cut in depth: ShapeInitializer on
               the same icosphere (200 of 15,000 SDF steps, 10 of 501 normal
               steps), then HumanEditTrainer with the stub SDS prior on a
               fresh sphere field's cap z > 0.1, 6 + 30 steps from step 0
               (8 hash levels) and 6 + 30 from step 8000 (16 levels).
  8. du      — the stage-1 edit in the "du" mode at the spatial phase's
               full width: SDSDUGuidance (stub prior, per_editing_step 10,
               an LPIPS perceptual term) for 30 steps from step 0, refresh
               and pull steps timed apart; LPIPS on the card held against
               its f32 path on the CPU and timed at 1 × 512².
  9. mesh    — Mesh.unwrap_uv and its tangents on the 81,920-face
               icosphere; winding numbers of 4,096 points inside and
               outside it on the card.
 10. sd15    — the full-width SD1.5 stack (SD15_UNET, SD_VAE, SD15_CLIP;
               1.07 B random parameters drawn on the card): one UNet
               forward and one VAE decode in f32 against f64 on the card
               (a TF32-on control must fail), the networks' device times
               and the UNet's f32 bound, then HumanEditTrainer at the du
               phase's operating point with the SD1.5 prior: 20 SDS steps
               and 20 du steps (one azimuth bucket, refreshes at steps 0
               and 10) from step 0.
 11. sdxl    — the full-width SDXL + ControlNet-Union stack
               (SDXLPipelineConfig(), the two text towers as the factory
               builds them; 4.73 B random parameters): a denoising step,
               ControlNet and UNet apart, the VAE and the text encoders
               timed at 1024²; inpaint (both controls) and img2img at
               1024², 4 steps; then the edit phase's icosphere at 512² with
               this inpainter behind InpaintTrainer (2 views, ladder 2/1/1)
               and prepare_refine_guidance(upscale_to_2048=True) on one
               turntable view.
 12. segment — the full-width LangSAM stack on random weights drawn on
               the card: SAM ViT-H at 1024² and GroundingDINO Swin-T at 800²
               (256 text tokens, 900 queries, the hash tokenizer), each in
               f32 against f64 on the card (TF32-on controls must fail) and
               timed; one SAMSegmenter.segment through a DinoGrounder and
               LocalMeshEditing.localize through it on the edit phase's
               icosphere (3 views at 512²).
 13. pipeline — run_synthetic_pipeline (cli/pipeline.py) at grid 64 / 512²
               with the production hash grid, budgets and raster configs,
               cut in depth; each stage's seconds, the MeshSDF pool signs,
               the artifacts read back, every kernel's launches (all but
               the per-pair backward), one profiled edit-texture stage, and
               the spatial CLI's --validate on the produced checkpoint.
 14. sharded — the sharded TetGS step (parallel/) as a one-rank NCCL world
               on the fit phase's icosphere and 8 ring views at 512²: its
               first step against the single-device render and loss, 2 and
               4 tile-row bands in one process against the unsharded image
               and gradients, then 20 timed steps whose loss must fall.
 15. a `kernels` JSON line: each kernel's launches on its main path (the
     fit; the edit stage for the mesh resolve; the spatial stage for the
     hash-grid scatter; the sharded step for the per-pair backward), error
     against its plain version, ms, plain ms, library ms and bound.
The last line is {"ok": true, "device": {...}}.

Each profiled step prints the device's busy share as the union of its
device intervals (kernels, memcpys, memsets; `union_length`) beside the
sum of their times, which counts overlapping kernels twice.

Weights and scenes are random, made from fixed seeds. Without a CUDA card
the script exits 2; copied alone into a directory without the port, it
exits 1 (the port does not import).
"""

from __future__ import annotations

import dataclasses
import json
import os
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
# The edit stage's options at small depth: the inpaint ladder with the
# segmenter edge fix, and the perceptual refine's steps.
EDIT_OPTION_LADDER, EDIT_OPTION_REFINE = (4, 2, 1), 10
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
SPATIAL_WATCH = ("index", "indexfunc", "scatter_kernel")
# The du phase: steps from step 0 and the edit cache's refresh period.
DU_STEPS, DU_PER_EDIT = 30, 10
# LPIPS on the card (f32, TF32 off) against its plain path in f64 on the
# CPU: the image size of the check, the value's relative tolerance, and the
# gradient's, as a share of its largest entry.
LPIPS_CHECK_SIZE, LPIPS_RTOL, LPIPS_GRAD_RTOL_OF_MAX = 128, 1e-4, 1e-4
# The mesh phase: winding-number points and how far from 1 / 0 they may be.
WINDING_POINTS, WINDING_ATOL = 4096, 1e-3
K4_PER_EDIT_STEP = 3  # selected-corner requery, midpoints, recon points
# The sd15 phase: SDS and du steps from step 0, the latent size of the
# 512² normal maps, and the networks' f32-vs-f64 limit on the card (max
# error as a share of the f64 result's largest entry).
SD_STEPS, SD_LATENT, SD_F64_RTOL = 20, 64, 1e-4
# K7's check: the SDS step's costliest and edge convolutions, then the
# inpaint call's costliest (name, x shape, HWIO w shape, stride, pads),
# each held, forward and input gradient, to CONV_ERR_OF_CUDNN ×
# cuDNN-f32's max |Δ| against f64 on the same inputs. The first is the
# row of the kernels line; the UNet's 8² level splits K, whose second
# pass is conv_reduce's row.
CONV_SAME = ((1, 1), (1, 1))
CONV_SHAPES = (
    ("VAE encoder 3×3 at 512²·128", (1, 512, 512, 128), (3, 3, 128, 128),
     1, CONV_SAME),
    ("VAE encoder downsample 3×3/2 (0, 1)", (1, 512, 512, 128),
     (3, 3, 128, 128), 2, ((0, 1), (0, 1))),
    ("UNet 3×3 at 8²·1280, CFG batch 2", (2, 8, 8, 1280), (3, 3, 1280, 1280),
     1, CONV_SAME),
    ("UNet conv_out 320→4 at 64²", (2, 64, 64, 320), (3, 3, 320, 4), 1,
     CONV_SAME),
    ("VAE encoder conv_in 3→128 at 512²", (1, 512, 512, 3), (3, 3, 3, 128),
     1, CONV_SAME),
    ("VAE encoder 3×3 at 256²·256", (1, 256, 256, 256), (3, 3, 256, 256),
     1, CONV_SAME),
    ("VAE encoder 3×3 at 128²·512", (1, 128, 128, 512), (3, 3, 512, 512),
     1, CONV_SAME),
    ("SDXL 3×3 at 32²·1280, CFG batch 2", (2, 32, 32, 1280),
     (3, 3, 1280, 1280), 1, CONV_SAME),
    ("SDXL 3×3 at 128²·320", (2, 128, 128, 320), (3, 3, 320, 320), 1,
     CONV_SAME),
    ("SDXL 3×3 at 64²·640", (2, 64, 64, 640), (3, 3, 640, 640), 1,
     CONV_SAME),
    ("SDXL 3×3 2560→1280 at 32²", (2, 32, 32, 2560), (3, 3, 2560, 1280), 1,
     CONV_SAME),
    ("SDXL 3×3 at 64²·1280", (2, 64, 64, 1280), (3, 3, 1280, 1280), 1,
     CONV_SAME),
)
CONV_SPLIT_K, CONV_ERR_OF_CUDNN = 2, 2.0
# The segment phase: GroundingDINO at the "sam" backend's 800², its
# parameter count from the JAX package's init tree, and the f32-vs-f64
# limits of the segmentation networks, set from the H100's readings: SAM's
# mask logits 2.0e-06 and GroundingDINO's boxes 5.4e-06 (TF32 controls
# 2.2e-03 / 5.2e-03) under 1e-4; its logits 8.2e-05 (TF32 2.4e-02) under
# 5e-4.
SEG_DINO_SIZE, GDINO_SWIN_T_PARAMS = 800, 168_108_034
SEG_F64_RTOL, GDINO_LOGITS_F64_RTOL = 1e-4, 5e-4
# The pipeline phase: production widths, cut in depth only.
PIPE_DEPTH = dict(sdf_iters=20, normal_iters=3, edit_steps=4, fit_iters=30,
                  inpaint_views=3, turntable_views=4, refine_iters=10)
PIPE_KERNELS = ("composite_forward", "composite_backward", "expand_pairs",
                "tile_histogram", "counting_layout", "hash_scatter",
                "mesh_resolve")
# The sdxl phase: its image size, the denoising steps of each pipeline
# call, and the edit's fit-iteration ladder.
XL_SIZE, XL_STEPS, XL_EDIT_LADDER = 1024, 4, (2, 1, 1)
# The sharded phase: timed steps, the band counts checked in one process,
# and the kernels its step launches once per view.
SHARDED_STEPS, SHARDED_BANDS = 20, (2, 4)
SHARDED_KERNELS = ("tile_histogram", "counting_layout", "expand_pairs",
                   "composite_forward", "composite_backward_pairs")
# Pair budgets of K2 / K3 beside the render's: the edit stage's inpaint fit
# (auto-sized), and one below the render scene's pre-cull total (overflow).
INPAINT_BUDGET, OVERFLOW_BUDGET = 393_216, 65_536
LAYOUT_ITERS = 200  # launches back to back per layout-kernel timing
# A sleep long enough (~20 ms at the H100's clock) for the host to queue
# LAYOUT_ITERS launches behind it.
QUEUE_SLEEP_CYCLES = 40_000_000
# Profiled kernels of K2 and K3 (the first port's and the present ones; the
# K3b entry's status clear is a memset).
LAYOUT_WATCH = ("expand_kernel", "expand_window_kernel", "hist_kernel",
                "block_counts_kernel", "column_scan_kernel", "rank_dst_kernel",
                "rank_lookback_kernel", "memset")


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


def queued_ms(fn, iters, warmup=2):
    """Mean device time of `fn` over `iters` calls queued behind a sleep
    kernel: the host enqueues every call before the first runs, so the
    events read the device's time back to back, not the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
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

        # K2, K3a, K3b bit-exact against their plain versions, and timed
        # (each kernel's own launch beside its wrapper) at the render's and
        # the inpaint fit's pair budgets; the sharded band's in
        # check_sharded_layout.
        layout = time_layout(packed, PAIR_BUDGET, ntx, nty, "render")
        time_layout(packed, INPAINT_BUDGET, ntx, nty, "inpaint fit")
        for name in ("expand_pairs", "tile_histogram", "counting_layout"):
            report[name] = layout[name]

        # K2 with the pre-cull total past the budget (overflow), bit-exact.
        tk, gk, nk = expand_pairs_kernel(packed, OVERFLOW_BUDGET, ntx, nty, 32)
        tp, gp, np_ = expand_pairs_plain(packed, OVERFLOW_BUDGET, ntx, nty, 32)
        err = max(int((tk - tp).abs().max()), int((gk - gp).abs().max()),
                  abs(int(nk) - int(np_)))
        print(f"  expand_pairs at budget {OVERFLOW_BUDGET} < total {int(nk)} "
              f"(overflow): max |kernel - plain| = {err}")
        if err or not int(nk) > OVERFLOW_BUDGET:
            raise AssertionError("expand_pairs differs on overflow")

        def astart_ext_of(hist, tiles, pairs):
            return aligned_starts_ext(hist, tiles, comp.CHUNK,
                                      pairs + tiles * comp.CHUNK)

        # K3a/K3b over 1024 blocks (1 << 20 random tile ids) at the render's
        # 257 bins and past a block's default 48 KB of shared memory at
        # 16,385 bins (a 4096² image at tile 32), bit-exact.
        big_p = 1 << 20
        for big_t in (num_t, 16_384):
            tb = torch.randint(0, big_t + 1, (big_p,), dtype=torch.int32,
                               device=dev, generator=torch.Generator(
                                   device=dev).manual_seed(3))
            hb = tile_histogram(tb, big_t)
            ext = astart_ext_of(hb, big_t, big_p)
            err = max(int((hb - tile_histogram_plain(tb, big_t)).abs().max()),
                      int((rank_destinations(tb, ext)
                           - rank_destinations_plain(tb, ext)).abs().max()))
            print(f"  counting at {big_t} tiles, {big_p} pairs "
                  f"({big_p // 1024} blocks): max |kernel - plain| = {err}")
            if err:
                raise AssertionError(f"counting kernels differ at {big_t} tiles")
        check_histogram_edges(dev, num_t)

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
        if not (err <= FWD_ATOL and mism == 0):
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
        fwd_mean, _ = time_forward(fields, pg, astart, tcount, ntx,
                                   "512²/100k")
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
    check_sharded_layout(dev)
    report["mesh_resolve"] = check_mesh_resolve(dev)
    report["hash_scatter"] = check_hash_scatter(dev)
    report.update(check_conv(dev))


def entry(fn_name):
    """The kernel library's C entry `fn_name`, called on the current
    stream: a kernel's own launch, without its wrapper's checks,
    allocations, cumsum and count."""
    from youreditableavatar_tpu_torch import _kernels

    fn = getattr(_kernels.library(), fn_name)

    def call(*args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
    return call


def kernel_name(key: str) -> str:
    """A profiler kernel name without its return type, namespace and
    argument list."""
    key = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return key.split("(")[0][:60]


def kernel_split(fn, iters=20):
    """{kernel name: device ms per call} of `fn` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            name = kernel_name(e.key)
            split[name] = (split.get(name, 0.0)
                           + e.self_device_time_total / iters / 1e3)
    return split


def time_layout(packed, budget, ntx, nty, what):
    """K2, K3a and K3b at one pair budget on one packed table: each
    checked bit for bit against its plain version; each kernel's own
    launch timed apart from its wrapper (inputs and scratch allocated once,
    CUDA events around LAYOUT_ITERS launches back to back: queued behind a
    sleep, so the device's time, and as issued, which the host can bound)
    beside the wrapper's time (events as issued) and torch.profiler's
    device time by kernel of the own launch. Returns {name: report
    entry}."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        composite_cuda as comp)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.counting import (
        aligned_starts_ext, rank_destinations, rank_destinations_plain,
        tile_histogram, tile_histogram_plain)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.expand_cuda import (
        expand_pairs_kernel, expand_pairs_plain)

    num_t = ntx * nty
    nbins = num_t + 1
    with torch.no_grad():
        tk, gk, nk = expand_pairs_kernel(packed, budget, ntx, nty, 32)
        tp, gp, np_ = expand_pairs_plain(packed, budget, ntx, nty, 32)
        hk = tile_histogram(tk, num_t)
        astart_ext = aligned_starts_ext(hk, num_t, comp.CHUNK,
                                        budget + num_t * comp.CHUNK)
        dk = rank_destinations(tk, astart_ext)
        errs = {
            "expand_pairs": max(int((tk - tp).abs().max()),
                                int((gk - gp).abs().max()),
                                abs(int(nk) - int(np_))),
            "tile_histogram": int((hk - tile_histogram_plain(tk, num_t))
                                  .abs().max()),
            "counting_layout": int((dk - rank_destinations_plain(
                tk, astart_ext)).abs().max()),
        }
        n, total = packed.shape[0], int(nk)
        cum = torch.cumsum(packed[:, 0].to(torch.int32), 0, dtype=torch.int32)
        tile, gauss, dst = (torch.empty_like(tk) for _ in range(3))
        counts = torch.zeros(nbins, dtype=torch.int32, device=tk.device)
        # Scratch as large as the first port's K3b needed, so that the same
        # calls time either kernel.
        scratch = torch.empty((budget // 1024) * nbins, dtype=torch.int32,
                              device=tk.device)
        expand, hist, ranks = (entry("yea_expand_pairs"),
                               entry("yea_tile_histogram"),
                               entry("yea_counting_layout"))
        own = {
            "expand_pairs": lambda: expand(
                packed.data_ptr(), cum.data_ptr(), n, tile.data_ptr(),
                gauss.data_ptr(), budget, ntx, nty, 32),
            "tile_histogram": lambda: hist(tk.data_ptr(), counts.data_ptr(),
                                           budget, nbins),
            "counting_layout": lambda: ranks(
                tk.data_ptr(), astart_ext.data_ptr(), scratch.data_ptr(),
                dst.data_ptr(), budget, nbins),
        }
        for fn in own.values():
            fn()
        if not (torch.equal(tile, tk) and torch.equal(gauss, gk)
                and torch.equal(counts, hk) and torch.equal(dst, dk)):
            errs["own launch"] = 1
        wrapped = {
            "expand_pairs": lambda: expand_pairs_kernel(packed, budget, ntx,
                                                        nty, 32),
            "tile_histogram": lambda: tile_histogram(tk, num_t),
            "counting_layout": lambda: rank_destinations(tk, astart_ext),
        }
        plain = {
            "expand_pairs": lambda: expand_pairs_plain(packed, budget, ntx,
                                                       nty, 32),
            "tile_histogram": lambda: tile_histogram_plain(tk, num_t),
            "counting_layout": lambda: rank_destinations_plain(tk, astart_ext),
        }
        bounds = {
            "expand_pairs": bound(packed.numel() * 4 + 2 * budget * 4 + 4,
                                  60 * min(total, budget)),
            "tile_histogram": bound(budget * 4 + nbins * 4, budget),
            "counting_layout": bound(2 * budget * 4 + nbins * 4, 3 * budget),
        }
        out = {}
        for name, fn in own.items():
            split = kernel_split(fn)
            out[name] = dict(
                max_abs_err=errs[name],
                kernel_ms=queued_ms(fn, LAYOUT_ITERS),
                issued_ms=device_ms(fn, LAYOUT_ITERS),
                ms=device_ms(wrapped[name], LAYOUT_ITERS),
                plain_ms=device_ms(plain[name], 5),
                bound=bounds[name], split=split)
        out["tile_histogram"]["library_ms"] = device_ms(
            lambda: torch.bincount(tk, minlength=nbins), LAYOUT_ITERS)
    print(f"  layout at the {what}'s budget {budget} ({budget // 1024} "
          f"blocks, {nbins} bins, {n} rows, pre-cull total {total}, "
          f"{int((tk < num_t).sum())} kept): max |kernel - plain| "
          f"{json.dumps(errs)}")
    for name, r in out.items():
        print(f"    {name}: own launch {r['kernel_ms']:.4f} ms (events over "
              f"{LAYOUT_ITERS} queued back to back; as issued "
              f"{r['issued_ms']:.4f}), wrapper {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.5f} ms by "
              f"{r['bound'][1]}; profiled device ms per launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["split"].items()))
    if any(errs.values()):
        raise AssertionError(f"layout kernels differ at the {what}'s budget")
    return out


def check_histogram_edges(dev, num_t):
    """K3a bit-equal to its plain version at its edges: a last CTA only
    partly filled (13 blocks of 1024 pairs), a single block, an input all
    sentinel, and bin counts up to MAX_BINS (one CTA an SM)."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import counting

    gen = torch.Generator(device=dev).manual_seed(4)
    cases = (("13 blocks", 13 * 1024, num_t, "random"),
             ("one block", 1024, num_t, "random"),
             ("all sentinel", PAIR_BUDGET, num_t, "sentinel"),
             ("40,000 tiles", 64 * 1024, 40_000, "random"),
             ("MAX_BINS", 64 * 1024, counting.MAX_BINS - 1, "random"))
    for what, p, tiles, kind in cases:
        if kind == "sentinel":
            ids = torch.full((p,), tiles, dtype=torch.int32, device=dev)
        else:
            ids = torch.randint(0, tiles + 1, (p,), dtype=torch.int32,
                                device=dev, generator=gen)
        err = int((counting.tile_histogram(ids, tiles)
                   - counting.tile_histogram_plain(ids, tiles)).abs().max())
        print(f"  tile_histogram, {what}: {p // 1024} blocks, {tiles + 1} "
              f"bins: max |kernel - plain| = {err}")
        if err:
            raise AssertionError(f"tile_histogram differs: {what}")


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


def time_forward(fields, pg, astart, tcount, ntx, what):
    """K1f's time with both statistics, with and without the checkpoint
    store. Returns (mean back to back, one-by-one times) with the store."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        composite_cuda as comp)

    out = {save: both_ms(lambda: comp._forward(
        fields, pg, astart, tcount, ntx, save)) for save in (True, False)}
    print(f"  composite_forward ({what}) with the checkpoint store: "
          f"{spread(*out[True])}; without: {spread(*out[False])}")
    return out[True]


def layout_stats(fields, pg, astart, tcount, ck, n_contrib, evals, ntx, nty):
    """The tile-depth line: pairs per tile, batches, evaluations, and the
    (pair, warp) sweeps the box cull leaves for the backward's 16×8 warp
    blocks and the forward's 8×4 ones."""
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

    def hits(bw, bh):  # (pair, warp) sweeps of bw × bh blocks in the box
        n = 0
        for x in range(0, 32, bw):
            for y in range(0, 32, bh):
                n += int((~((box[:, 1] < tx + x) | (box[:, 0] > tx + x + bw - 1)
                            | (box[:, 3] < ty + y)
                            | (box[:, 2] > ty + y + bh - 1))).sum())
        return n

    pairs = int(real.sum())
    print(f"  tile depth: {int(tcount.sum())} pairs over {c.numel()} tiles "
          f"(max {int(c.max())}, mean {float(c.mean()):.1f}, median "
          f"{float(c.median()):.0f}, {int((c == 0).sum())} empty); "
          f"{int(((c + 127) // 128).sum())} batches, {int(swept.sum())} swept "
          f"(deepest tile {int(swept.max())}); {evals} live (pair, pixel) "
          f"evaluations, {int(n_contrib.sum())} contributing; backward 16×8 "
          f"blocks: {8 * pairs} (pair, warp) sweeps, {hits(16, 8)} inside "
          f"the cull box; forward 8×4 blocks: {32 * pairs} sweeps, "
          f"{hits(8, 4)} inside the box")


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
        rk, fk, nk, ck = comp._forward_rows(rows, astart, tcount, ntx, True)
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

    time_gather(fields, pg, "512²/100k")
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


def kernel_ms(fn, iters=20):
    """Device time of `fn`'s kernels per call (torch.profiler's sum over
    `iters` calls): what the events' statistics read when the host keeps
    up, without the host's time when it does not."""
    return sum(kernel_split(fn, iters).values())


def time_gather(fields, pg, what):
    """The sharded step's row gather (`gather_pair_rows`: `index_select`)
    and its backward (the padding slots spread over dump rows and
    dropped): both statistics and the profiled kernel time; beside it
    `index_select`'s own backward (`index_add_`, every padding slot onto
    row 0), `index_add_` alone, and again with the padding slots spread
    over distinct rows; `fields[pg]`'s sort-based index backward."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        gather_pair_rows)

    g_rows = torch.randn((pg.shape[0], fields.shape[1]), device=fields.device)
    f = fields.detach().requires_grad_()
    gathered = gather_pair_rows(f, pg)
    selected = f.index_select(0, pg)
    indexed = f[pg.long()]
    pad = pg == 0
    spread_pg = torch.where(pad, torch.arange(pg.shape[0], device=pg.device,
                                              dtype=pg.dtype)
                            % fields.shape[0], pg)

    def bwd():
        return torch.autograd.grad(gathered, f, g_rows, retain_graph=True)

    def select_bwd():
        return torch.autograd.grad(selected, f, g_rows, retain_graph=True)

    def add(ids):
        return lambda: torch.zeros_like(fields).index_add_(0, ids, g_rows)

    gather_ms = device_ms(lambda: gather_pair_rows(fields, pg), 50)
    sort_ms = device_ms(lambda: torch.autograd.grad(
        indexed, f, g_rows, retain_graph=True), 5)
    print(f"  pair-row gather at {what} ({pg.shape[0]} rows of "
          f"{fields.shape[0]}, {int(pad.sum())} padding slots on row 0): "
          f"index_select {gather_ms:.4f} ms; its backward (padding spread "
          f"over dump rows): {spread(*both_ms(bwd))}, kernels "
          f"{kernel_ms(bwd):.4f} ms; index_select's own backward (every "
          f"padding slot onto row 0): {spread(*both_ms(select_bwd))}, kernels "
          f"{kernel_ms(select_bwd):.4f} ms; index_add_ alone: "
          f"{spread(*both_ms(add(pg)))}, kernels {kernel_ms(add(pg)):.4f} ms; "
          f"padding spread over distinct rows: "
          f"{spread(*both_ms(add(spread_pg)))}, kernels "
          f"{kernel_ms(add(spread_pg)):.4f} ms; fields[pg] backward "
          f"(sort-based index backward) {sort_ms:.4f} ms")


def sharded_scene(dev):
    """The `sharded` phase's scene: the 81,920-face icosphere (122,880
    Gaussians) and FIT_VIEWS ring views at WIDTH². Returns (binding,
    params, cameras, cfg, need): cfg's pair budget fits the most pairs a
    view needs (`need`)."""
    from youreditableavatar_tpu_torch.models.cameras import sample_ring_cameras
    from youreditableavatar_tpu_torch.models.tetgs import (
        build_tetgs, gaussian_arrays)
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        RasterizeConfig, count_pairs, fit_pair_budget)

    verts, faces = icosphere(FIT_SUBDIV)
    binding, params = build_tetgs(verts, faces, sh_levels=2, device=dev)
    cams = [c.raster_camera(dev) for c in sample_ring_cameras(
        radius=2.7, elevations=(10.0,), counts=(FIT_VIEWS,), height=HEIGHT,
        width=WIDTH)]
    cfg = RasterizeConfig(sh_degree=1)
    with torch.no_grad():
        g = gaussian_arrays(binding, params)
        need = max(int(count_pairs(*g, c, cfg)) for c in cams)
    return (binding, params, cams,
            dataclasses.replace(cfg, pair_budget=fit_pair_budget(need)), need)


def check_sharded_layout(dev):
    """K1f over direct rows at the sharded step's layout (view 0 of the
    `sharded` phase's scene, one band): against the plain version (images
    to FWD_ATOL, n_contrib equal, checkpoints bit-equal), with and without
    the store bit-equal; timed, and the row gather's backward timed at
    these shapes."""
    from youreditableavatar_tpu_torch.models.tetgs import gaussian_arrays
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        composite_cuda as comp)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.binning import (
        pack_depth_ordered)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.preprocess import (
        preprocess_gaussians)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        build_pair_layout_counting, gather_pair_rows)
    from youreditableavatar_tpu_torch.parallel.train_step import (
        _shard_proj_rows)

    binding, params, cams, cfg, _ = sharded_scene(dev)
    ntx = nty = WIDTH // 32
    with torch.no_grad():
        g = gaussian_arrays(binding, params)
        proj = _shard_proj_rows(preprocess_gaussians(
            *g, cams[0], cfg.sh_degree, 32, cfg.scale_mod,
            rect_mode=cfg.rect_mode), 0, nty, 32)
        fields, pg, astart, tcount, _ = build_pair_layout_counting(
            proj, ntx, nty, cfg.pair_budget, 32)
        rows = gather_pair_rows(fields, pg)
        rk, fk, nk, ck = comp._forward_rows(rows, astart, tcount, ntx, True)
        bare = comp._forward_rows(rows, astart, tcount, ntx, False)
        rp, fp, cp, ck_plain = comp.composite_tiles_pairs_plain(
            rows, astart, tcount, ntx, nty, return_checkpoints=True)
    err = max(float((rk - rp).abs().max()), float((fk - fp).abs().max()))
    same = all(torch.equal(a, b) for a, b in zip((rk, fk, nk), bare[:3]))
    print(f"  sharded step's layout (view 0: {int(tcount.sum())} pairs, "
          f"P_pad {rows.shape[0]}, deepest tile {int(tcount.max())}): K1f "
          f"over direct rows |kernel - plain| = {err:.3g} (atol {FWD_ATOL}), "
          f"n_contrib mismatches {int((nk != cp).sum())}; with and without "
          f"the store bit-equal: {same}")
    if not (err <= FWD_ATOL and torch.equal(nk, cp) and same):
        raise AssertionError("K1f over direct rows differs at the sharded "
                             "step's layout")
    check_checkpoints(ck, ck_plain, astart, "sharded layout vs plain")
    time_forward(rows, None, astart, tcount, ntx, "sharded layout")
    time_gather(fields, pg, "the sharded layout")
    time_layout(pack_depth_ordered(proj), cfg.pair_budget, ntx, nty,
                "sharded band")


def scatter_points(shape: str, gen) -> torch.Tensor:
    """(SCATTER_POINTS, 3) points in [0, 1]³ for K4's check: "uniform", or
    "shell" — a sphere shell of radius 0.225 about the centre (the spatial
    edit's 0.45 sphere in the field's unit cube), 0.003 thick, in tet-grid
    order (64³ cells, x fastest) as the isosurface's vertices come, so
    neighbouring rows share coarse corners."""
    if shape == "uniform":
        return torch.rand((SCATTER_POINTS, 3), generator=gen)
    d = torch.randn((SCATTER_POINTS, 3), generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    x = 0.5 + d * (0.225 + 0.003 * torch.randn((SCATTER_POINTS, 1), generator=gen))
    cell = torch.floor(x * SPATIAL_GRID).long()
    key = (cell[:, 2] * SPATIAL_GRID + cell[:, 1]) * SPATIAL_GRID + cell[:, 0]
    return x[torch.argsort(key, stable=True)]


def k4_repeats(idx: torch.Tensor, table_size: int):
    """K4's repeat test on its (L, R) ids, as the kernel sees them (rows
    level-major, 32 to a warp): the share of warps that aggregate (some
    valid row in lanes 0–23 equals the one eight lanes on) and the share
    of all valid rows' atomics that their aggregation saves."""
    levels = idx.shape[0]
    ok = ((idx >= 0) & (idx < table_size)).reshape(-1)
    key = (idx.to(torch.int64) + torch.arange(levels, device=idx.device)[:, None]
           * (table_size + 1)).reshape(-1)
    n = key.numel()
    tail = -(-n // 32) * 32 - n
    # Invalid rows (and the last warp's idle lanes) get keys of their own.
    alone = -1 - torch.arange(n + tail, device=idx.device)
    key = torch.where(torch.cat([ok, ok.new_zeros(tail)]),
                      torch.cat([key, key.new_zeros(tail)]), alone).reshape(-1, 32)
    ok = key >= 0
    fires = ((key[:, :24] == key[:, 8:]) & ok[:, :24]).any(1)
    srt = key.sort(1).values
    distinct = 1 + (srt[:, 1:] != srt[:, :-1]).sum(1) - (~ok).sum(1)
    saved = (ok.sum(1) - distinct)[fires].sum()
    return float(fires.float().mean()), float(saved / ok.sum().clamp(min=1))


def k4_traffic(step, what):
    """Run `step` once with K4's inputs read on the way (`k4_repeats` of
    every launch the encoding's backward makes), outside any timed or
    profiled window, and print them."""
    from youreditableavatar_tpu_torch.ops import hashgrid as hg

    real, seen = hg.hash_scatter_add, []

    def spy(idx, v0, v1, table_size):
        seen.append((tuple(idx.shape), *k4_repeats(idx, table_size)))
        return real(idx, v0, v1, table_size)

    hg.hash_scatter_add = spy
    try:
        step()
    finally:
        hg.hash_scatter_add = real
    print(f"  K4 traffic, {what}: per launch (levels × rows; share of warps "
          f"that aggregate; share of atomics saved) " + "; ".join(
              f"{s[0]}×{s[1]} {w:.3f} {v:.3f}" for s, w, v in seen))


def check_hash_scatter(dev):
    """K4 against its plain version: the corner rows of 65,536 points (a
    uniform and a sphere-shell shape) through the production
    HashGridConfig's 16 levels, normal values, one row in 16 the padding
    sentinel. The plain version sums sequentially on the CPU copy. Then
    the share of warps that aggregate, and the time split: the zero fill,
    dense levels 0–4 and hashed levels 5–15, each into a zeroed table."""
    from youreditableavatar_tpu_torch.ops import hashgrid as hg
    from youreditableavatar_tpu_torch.ops import hashgrid_cuda as hc

    cfg = hg.HashGridConfig()
    t = cfg.table_size
    dense = sum((r + 1) ** 3 <= t for r in cfg.level_resolutions())
    gen = torch.Generator().manual_seed(4)
    result = None
    for shape in ("uniform", "shell"):
        x = scatter_points(shape, gen)
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
        err = max(e for e, _ in errs)
        agg = [k4_repeats(idx_d[lo:hi], t) for lo, hi in ((0, dense), (dense, levels))]
        print(f"  hash_scatter, {shape} points: {levels} levels ({dense} "
              f"dense) × {rows} rows into {levels} × {t} × 2; max |card - cpu "
              f"plain| per level " + ", ".join(f"{e:.3g}" for e, _ in errs)
              + f"; worst level at {worst:.3f} of its tolerance "
              f"({SCATTER_RTOL_OF_MAX}·max|plain|); cpu plain {cpu_ms:.1f} ms; "
              f"warps that aggregate (atomics saved): dense levels "
              f"{agg[0][0]:.3f} ({agg[0][1]:.3f}), hashed {agg[1][0]:.3f} "
              f"({agg[1][1]:.3f})")
        if not worst <= 1.0:
            raise AssertionError("hash_scatter kernel differs from its plain version")
        uniq = [int(torch.unique(idx[l][idx[l] < t]).numel()) for l in range(levels)]

        def part(lo, hi):
            table = torch.zeros((hi - lo, t, 2), device=dev)
            return lambda: hc._scatter_into(
                idx_d[lo:hi], v0_d[lo:hi], v1_d[lo:hi], t, table)

        def med(fn, n=30):
            return statistics.median(each_device_ms(fn, n))

        times = each_device_ms(lambda: hc.hash_scatter_add(idx_d, v0_d, v1_d, t), 30)
        split = dict(zero=med(lambda: torch.zeros((levels, t, 2), device=dev)),
                     dense=med(part(0, dense)), hashed=med(part(dense, levels)))
        print(f"  hash_scatter, {shape} points: distinct rows per level "
              f"{uniq}; median {statistics.median(times):.4f} ms over 30 "
              f"launches (min {min(times):.4f}, max {max(times):.4f}), "
              f"zeroing included; split (medians): zero fill "
              f"{split['zero']:.4f} ms, dense levels 0–{dense - 1} "
              f"{split['dense']:.4f} ms, hashed levels {dense}–{levels - 1} "
              f"{split['hashed']:.4f} ms")
        if result is None:  # the check's shape: uniform points
            level = torch.arange(levels, device=dev)[:, None]
            flat = torch.where(idx_d < t, level * t + idx_d.long(),
                               torch.full_like(level, levels * t)).reshape(-1)
            vals = torch.stack([v0_d, v1_d], -1).reshape(-1, 2)
            result = dict(
                max_abs_err=err, ms=statistics.median(times),
                plain_ms=device_ms(lambda: hc.hash_scatter_add_plain(
                    idx_d, v0_d, v1_d, t), 10),
                library_ms=device_ms(lambda: torch.zeros(
                    (levels * t + 1, 2), device=dev).index_add_(0, flat, vals), 10),
                bound=bound(levels * rows * 12 + levels * t * 2 * 4,
                            2 * levels * rows),
            )
            print(f"  hash_scatter: bound {result['bound'][0]:.4f} ms by "
                  f"{result['bound'][1]}; plain version on the card "
                  f"{result['plain_ms']:.4f} ms; index_add_ "
                  f"{result['library_ms']:.4f} ms")
    return result


def sliver_rows(seed: int = 11, n: int = 3000, width: int = 500,
                height: int = 300) -> np.ndarray:
    """(2n, 9) f32 screen-space face rows against K5's cull box and its
    ties: slivers 1 to 400 px long and 1e-7 to 1 px across, at random
    angles and along the axes and diagonals, half of them with a vertex on
    a pixel centre, around and across a width × height image; every face
    listed twice, so the first copy must win every pixel."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform([-40, -40], [width + 40, height + 40], (n, 2))
    p0[: n // 2] = np.round(p0[: n // 2])
    ang = rng.uniform(0.0, 2 * np.pi, n)
    ang[::4] = rng.integers(0, 8, len(ang[::4])) * (np.pi / 4)
    length = 10.0 ** rng.uniform(0.0, 2.6, n)
    across = 10.0 ** rng.uniform(-7.0, 0.0, n)
    t = rng.uniform(-0.5, 1.5, n)
    e = np.stack([np.cos(ang), np.sin(ang)], 1)
    perp = np.stack([-e[:, 1], e[:, 0]], 1)
    p1 = p0 + length[:, None] * e
    p2 = p0 + (t * length)[:, None] * e + across[:, None] * perp
    z = rng.uniform(0.1, 0.9, (n, 3))
    rows = np.concatenate([p0, p1, p2, z], 1).astype(np.float32)
    return np.concatenate([rows, rows])


def mesh_resolve_layout(rows, width, height, budget, dev):
    """`resolve_tiles` arguments for screen-space face rows, binned as
    `tile_face_lists` bins a mesh's (non-degenerate faces only)."""
    from youreditableavatar_tpu_torch.ops.mesh_raster import raster

    rows = torch.as_tensor(rows, device=dev)
    x0, y0, x1, y1, x2, y2 = (rows[:, i] for i in range(6))
    ok = torch.abs((x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)) > 1e-12
    tiles, rect, ntx, nty = raster.bin_face_rows(rows, ok, width, height, 32)
    face_s, starts, counts = raster._expand_pairs(tiles, rect, ntx, nty, budget)
    return rows, face_s, starts, counts, ntx, nty, 32, width, height


def mesh_resolve_stats(args):
    """K5's work on a layout: pairs; (pair, quarter) and (pair, warp)
    sweeps whose face box meets the 16×16 quarter / 8×4 block (the CTA's
    and the warp's cull); and the (pair, pixel) evaluations that pass the
    inside test, which the bound counts."""
    from youreditableavatar_tpu_torch.ops.mesh_raster import raster

    rows, face_s, starts, counts, ntx, nty = args[:6]
    num_t = ntx * nty
    pairs = int(counts.sum())
    dev = rows.device
    tile = torch.repeat_interleave(torch.arange(num_t, device=dev),
                                   counts.long())
    face = face_s[:pairs].long()  # the tiles' lists, in tile order
    r = rows[face]
    d = (r[:, 2] - r[:, 0]) * (r[:, 5] - r[:, 1]) - (r[:, 3] - r[:, 1]) * (r[:, 4] - r[:, 0])
    live = torch.abs(d) > 1e-12
    box = raster.face_box_plain(r)
    tx = (tile % ntx).to(torch.float32)[:, None] * 32
    ty = torch.div(tile, ntx, rounding_mode="floor").to(torch.float32)[:, None] * 32

    def hits(bw, bh):
        k = torch.arange((32 // bw) * (32 // bh), device=dev)
        bx = tx + (k % (32 // bw)).to(torch.float32) * bw
        by = ty + torch.div(k, 32 // bw, rounding_mode="floor").to(torch.float32) * bh
        meet = ~((box[:, 1:2] < bx) | (box[:, 0:1] > bx + (bw - 1))
                 | (box[:, 3:4] < by) | (box[:, 2:3] > by + (bh - 1)))
        return int((meet & live[:, None]).sum())

    inside = 0
    p = torch.arange(1024, device=dev)
    for c in range(0, pairs, 4096):
        rc, dc = r[c:c + 4096], d[c:c + 4096][:, None]
        px = tx[c:c + 4096] + (p % 32).to(torch.float32)
        py = ty[c:c + 4096] + torch.div(p, 32, rounding_mode="floor").to(torch.float32)
        x0, y0, x1, y1, x2, y2 = (rc[:, i:i + 1] for i in range(6))
        inv_d = torch.where(dc.abs() > 1e-12, 1.0 / dc, torch.zeros_like(dc))
        l1 = ((px - x0) * (y2 - y0) - (py - y0) * (x2 - x0)) * inv_d
        l2 = ((py - y0) * (x1 - x0) - (px - x0) * (y1 - y0)) * inv_d
        l0 = 1.0 - l1 - l2
        inside += int(((l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                       & (dc.abs() > 1e-12)).sum())
    return dict(pairs=pairs, deepest=int(counts.max()) if num_t else 0,
                quarter_hits=hits(16, 16), warp_hits=hits(8, 4),
                inside=inside)


def check_mesh_resolve(dev):
    """K5 against its plain version, bit for bit: at the edit phase's
    shapes (the 81,920-face icosphere from the first ring view at 512²,
    default MeshRasterConfig), at 500×300 with every face twice (ties, a
    ragged edge), and on slivers listed twice (the cull box, ties). Its
    layout statistics, its time and its bound."""
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

        # Slivers (1e-7 to 1 px across) listed twice at 500×300.
        srows = sliver_rows()
        args3 = mesh_resolve_layout(srows, 500, 300, 1 << 20, dev)
        sk = raster.resolve_tiles(*args3)
        sp = raster.resolve_tiles_plain(*args3)
        same = all(torch.equal(a, b) for a, b in zip(sk, sp))
        st = mesh_resolve_stats(args3)
        print(f"  mesh_resolve on {len(srows)} sliver faces (each twice) at "
              f"500×300: {st['pairs']} pairs, {int((sk[1] >= 0).sum())} "
              f"covered pixels, bit-equal to the plain version: {same}; "
              f"largest visible face id {int(sk[1].max())}; (pair, warp) "
              f"sweeps in the box {st['warp_hits']} of {32 * st['pairs']}")
        if not (same and int(sk[1].max()) < len(srows) // 2):
            raise AssertionError("mesh_resolve differs on slivers")

        st = mesh_resolve_stats(args)
        moved = (rows.numel() * 4 + face_s.numel() * 4 + 2 * starts.numel() * 4
                 + WIDTH * HEIGHT * 16)
        dense = bound(moved, MESH_OPS_PER_EVAL * pairs * cfg.tile_size ** 2)
        out = dict(
            max_abs_err=err,
            ms=device_ms(lambda: raster.resolve_tiles(*args), 50),
            plain_ms=device_ms(lambda: raster.resolve_tiles_plain(*args), 3,
                               warmup=1),
            bound=bound(moved, MESH_OPS_PER_EVAL * st["inside"]),
        )
        times = each_device_ms(lambda: raster.resolve_tiles(*args), 30)
        print(f"  mesh_resolve layout: {st['pairs']} pairs, deepest tile "
              f"{st['deepest']}; (pair, quarter) sweeps in the box "
              f"{st['quarter_hits']} of {4 * st['pairs']} "
              f"({st['quarter_hits'] / (4 * st['pairs']):.4f}); (pair, warp) "
              f"sweeps in the box {st['warp_hits']} of {32 * st['pairs']} "
              f"({st['warp_hits'] / (32 * st['pairs']):.4f}); (pair, pixel) "
              f"evaluations inside {st['inside']}")
        print(f"  mesh_resolve: mean {out['ms']:.4f} ms over 50 launches back "
              f"to back; one by one median {statistics.median(times):.4f} (min "
              f"{min(times):.4f}); bound {out['bound'][0]:.5f} ms by "
              f"{out['bound'][1]} (the dense sweep's, every (pair, pixel) at "
              f"{MESH_OPS_PER_EVAL} ops: {dense[0]:.4f} ms); plain version on "
              f"the card {out['plain_ms']:.2f} ms")
        return out


def check_conv(dev):
    """K7 at CONV_SHAPES: forward and input gradient against f64 (cuDNN's
    `F.conv2d` through `sd_layers.conv2d_plain`), each within
    CONV_ERR_OF_CUDNN of cuDNN-f32's own error, two launches bit-equal;
    timed beside its plain decomposition and cuDNN in f32. Then the
    split-K pass alone against its plain, in-order sum, bit for bit."""
    from youreditableavatar_tpu_torch import _kernels
    from youreditableavatar_tpu_torch.guidance.sd_layers import conv2d_plain
    from youreditableavatar_tpu_torch.ops import conv_cuda as cc

    def err(got, ref):
        return float((got.double() - ref).abs().max())

    def input_grad(dy, w, x_shape, stride, pads):
        x = torch.zeros(x_shape, dtype=dy.dtype, device=dev,
                        requires_grad=True)
        with torch.enable_grad():
            y = conv2d_plain(x, w, None, stride, pads)
        return lambda: torch.autograd.grad(y, x, dy, retain_graph=True)[0]

    rows = {}
    for n, (what, x_shape, w_shape, stride, pads) in enumerate(CONV_SHAPES):
        g = torch.Generator(device=dev).manual_seed(20 + n)
        x = torch.randn(x_shape, generator=g, device=dev)
        w = torch.randn(w_shape, generator=g, device=dev) / (
            w_shape[0] * w_shape[1] * w_shape[2]) ** 0.5
        b = torch.randn((w_shape[3],), generator=g, device=dev) * 0.1
        with torch.no_grad():
            y = cc.conv2d_forward(x, w, b, stride, pads)
            same_f = torch.equal(y, cc.conv2d_forward(x, w, b, stride, pads))
            ref = conv2d_plain(x.double(), w.double(), b.double(), stride,
                               pads)
            fwd = (err(y, ref), err(conv2d_plain(x, w, b, stride, pads), ref))
        dy = torch.randn(y.shape, generator=g, device=dev)
        dx = cc.conv2d_input_grad(dy, w, x_shape, stride, pads)
        same_d = torch.equal(dx, cc.conv2d_input_grad(dy, w, x_shape, stride,
                                                      pads))
        cudnn_d = input_grad(dy, w, x_shape, stride, pads)
        ref = input_grad(dy.double(), w.double(), x_shape, stride, pads)()
        bwd = (err(dx, ref), err(cudnn_d(), ref))
        del ref
        bytes_moved = 4 * (x.numel() + w.numel() + y.numel())
        ops = 2 * y.numel() * w_shape[0] * w_shape[1] * w_shape[2]
        t = dict(
            forward=(device_ms(lambda: cc.conv2d_forward(x, w, b, stride,
                                                         pads), 20),
                     device_ms(lambda: cc.conv2d_forward_plain(
                         x, w, b, stride, pads), 3, warmup=1),
                     device_ms(lambda: conv2d_plain(x, w, b, stride, pads),
                               20)),
            input_grad=(device_ms(lambda: cc.conv2d_input_grad(
                dy, w, x_shape, stride, pads), 20),
                device_ms(lambda: cc.conv2d_input_grad_plain(
                    dy, w, x_shape, stride, pads), 3, warmup=1),
                device_ms(cudnn_d, 20)))
        bnd = bound(bytes_moved, ops)
        for name, (ek, e32), same in (("forward", fwd, same_f),
                                      ("input_grad", bwd, same_d)):
            ms, plain_ms, lib_ms = t[name]
            print(f"  conv_{name}, {what}: x {x_shape} w {w_shape} stride "
                  f"{stride} pads {pads}: max |K7 - f64| {ek:.3e}, cuDNN f32 "
                  f"{e32:.3e} (ratio {ek / e32 if e32 else float('inf'):.3f}, limit "
                  f"{CONV_ERR_OF_CUDNN}); two launches bit-equal {same}; "
                  f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, "
                  f"{bnd[0] / ms:.3f} of the bound {bnd[0]:.4f} ms by "
                  f"{bnd[1]}); plain {plain_ms:.3f} ms; cuDNN f32 "
                  f"{lib_ms:.4f} ms")
            if not (ek <= CONV_ERR_OF_CUDNN * e32 and same):
                raise AssertionError(f"conv_{name} at {what}: {ek:.3e} "
                                     f"against cuDNN f32's {e32:.3e}, "
                                     f"bit-equal {same}")
            row = rows.setdefault(f"conv_{name}", dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound=bnd))
            row["max_abs_err"] = max(row["max_abs_err"], ek)
        del x, w, b, y, dy, dx, cudnn_d
        torch.cuda.empty_cache()

    # The split-K pass at the UNet's 8² level, launched alone.
    _, x_shape, w_shape, stride, pads = CONV_SHAPES[CONV_SPLIT_K]
    oh, ow = cc.out_size(x_shape[1], x_shape[2], w_shape[0], w_shape[1],
                         stride, pads)
    m, n = x_shape[0] * oh * ow, w_shape[3]
    _, splits, _ = cc.plan(m, n, w_shape[0] * w_shape[1] * w_shape[2],
                           cc._sm_count(dev))
    if splits < 2:
        raise AssertionError(f"{CONV_SHAPES[CONV_SPLIT_K][0]} splits no K")
    g = torch.Generator(device=dev).manual_seed(30)
    ws = torch.randn((splits, m, n), generator=g, device=dev)
    b = torch.randn((n,), generator=g, device=dev)
    out = torch.empty((m, n), device=dev)

    def reduce():
        _kernels.launch("conv_reduce", "yea_conv_reduce", dev, ws.data_ptr(),
                        b.data_ptr(), out.data_ptr(), m * n, n, splits)

    def reduce_plain():
        acc = ws[0]
        for part in ws[1:]:
            acc = acc + part
        return acc + b

    reduce()
    plain = reduce_plain()
    e = float((out - plain).abs().max())
    rows["conv_reduce"] = dict(
        max_abs_err=e, ms=device_ms(reduce, 50),
        plain_ms=device_ms(reduce_plain, 20),
        library_ms=device_ms(lambda: ws.sum(0) + b, 20),
        bound=bound(4 * ((splits + 1) * m * n + n), splits * m * n))
    r = rows["conv_reduce"]
    print(f"  conv_reduce, {splits} splits of {m} × {n}: bit-equal to the "
          f"in-order sum {torch.equal(out, plain)}; {r['ms']:.4f} ms (bound "
          f"{r['bound'][0]:.4f} ms by {r['bound'][1]}); plain "
          f"{r['plain_ms']:.4f} ms; sum(0) + bias {r['library_ms']:.4f} ms")
    if not torch.equal(out, plain):
        raise AssertionError("conv_reduce differs from the in-order sum")
    return rows


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
    profile_window(step, iters=5, step_ms=median, watch=LAYOUT_WATCH)
    return median


def union_length(intervals):
    """Total length covered by (start, end) intervals: overlaps and
    repeats count once."""
    total, cur_start, cur_end = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def overlapped_by_name(events):
    """Per event name, the device time (µs) its (name, start, end) events
    spend under an earlier-starting event's interval: where the sum of
    kernel times double-counts the wall."""
    out: dict = {}
    reach = None
    for name, a, b in sorted(events, key=lambda e: (e[1], e[2])):
        if reach is not None and a < reach:
            out[name] = out.get(name, 0.0) + min(b, reach) - a
        reach = b if reach is None else max(reach, b)
    return out


def profile_window(step, iters, step_ms, watch=()):
    """Device time by kernel over a short steady window (torch.profiler),
    and the device's busy share of the window's wall time and of the
    unprofiled median step `step_ms` (the profiler slows the host). The
    busy time is the union of the device events' intervals (kernels,
    memcpys, memsets), printed beside the sum of their times, which counts
    overlapping work twice. For each name in `watch`, also every kernel
    whose name holds it, and their sum ("indexfunc": index_add_'s kernels;
    "scatter_kernel": K4's). → {"busy_ms", "sum_ms", "wall_ms",
    "busy_share"} per iteration, or None when nothing was recorded."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    # Device-side events only: user ranges (e.g. "Optimizer.step#Adam.step")
    # would count the kernels inside them a second time.
    kernels = [e for e in prof.key_averages()
               if e.device_type == cuda and not e.is_user_annotation]
    sum_us = sum(e.self_device_time_total for e in kernels)
    events = [(e.name, e.time_range.start, e.time_range.end, e.thread)
              for e in prof.events()
              if e.device_type == cuda and not e.is_user_annotation]
    busy_us = union_length([(a, b) for _, a, b, _ in events])
    if busy_us == 0:
        print("  profile: the profiler recorded no device time (not measured)")
        return None
    print(f"  profile over {iters} iterations: device busy {busy_us / iters / 1e3:.3f} "
          f"ms of {wall_us / iters / 1e3:.3f} ms wall per iteration "
          f"(busy share {busy_us / wall_us:.3f}; of the unprofiled median "
          f"{step_ms:.3f} ms: {busy_us / iters / 1e3 / step_ms:.3f}); "
          f"{len(kernels)} distinct "
          f"kernels, {sum(e.count for e in kernels) / iters:.0f} launches per "
          f"iteration; top device time per iteration:")
    streams = sorted({t for *_, t in events})
    spans = {(n, a, b) for n, a, b, _ in events}
    print(f"  busy time: union of {len(events)} device intervals "
          f"{busy_us / iters / 1e3:.3f} ms/iteration, share {busy_us / wall_us:.3f}; "
          f"sum of their times {sum(b - a for _, a, b, _ in events) / iters / 1e3:.3f} "
          f"ms, kernel table sum {sum_us / iters / 1e3:.3f} ms, share "
          f"{sum_us / wall_us:.3f}; {len(events) - len(spans)} repeated "
          f"intervals; streams {len(streams)}: " + "; ".join(
              f"{t} {sum(1 for *_, u in events if u == t)} events "
              f"{union_length([(a, b) for _, a, b, u in events if u == t]) / iters / 1e3:.3f} ms"
              for t in streams[:6]))
    over = overlapped_by_name([(n, a, b) for n, a, b, _ in events])
    if over:
        print("  overlapping device time per iteration by event: " + "; ".join(
            f"{n[:60]} {v / iters / 1e3:.3f} ms"
            for n, v in sorted(over.items(), key=lambda kv: -kv[1])[:6]))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / iters / 1e3:8.3f} ms "
              f"{e.count / iters:5.0f}× {e.key[:90]}")
    for name in watch:
        hit = [e for e in kernels if name in e.key.lower()]
        print(f"  kernels named '{name}': "
              f"{sum(e.self_device_time_total for e in hit) / iters / 1e3:.3f}"
              f" ms, {sum(e.count for e in hit) / iters:.0f} launches per "
              f"iteration: " + "; ".join(
                  f"{e.key[:60]} {e.self_device_time_total / iters / 1e3:.3f}"
                  f" ms ×{e.count / iters:.0f}" for e in hit))
    return {"busy_ms": busy_us / iters / 1e3, "sum_ms": sum_us / iters / 1e3,
            "wall_ms": wall_us / iters / 1e3, "busy_share": busy_us / wall_us}


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
    profile_window(lambda: step(0), iters=5, step_ms=median,
                   watch=LAYOUT_WATCH)
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
                   iters=5, step_ms=fit_ms, watch=LAYOUT_WATCH)
    print("  render_view:")
    profile_window(lambda: mesh_model.render_view(cam0), iters=5,
                   step_ms=statistics.median(view_ms))
    print("  refine step:")
    profile_window(lambda: refine.step(0), iters=5, step_ms=refine_ms,
                   watch=LAYOUT_WATCH)
    edit_options(dev, ebinding, eparams, verts, faces, editable, ring,
                 turntable, blends)
    return launches


def edit_options(dev, ebinding, eparams, verts, faces, editable, ring,
                 turntable, blends):
    """The edit stage's options at small depth: the inpaint with a
    HeuristicSegmenter (the edge fix of the joint front/back views), the
    refine with an LPIPS term, and LocalMeshEditing.localize on the
    icosphere from 3 ring views."""
    from youreditableavatar_tpu_torch import _kernels
    from youreditableavatar_tpu_torch.guidance.stub import StubInpainter
    from youreditableavatar_tpu_torch.models.textured_mesh import (
        TexturedMeshModel)
    from youreditableavatar_tpu_torch.ops.mesh_raster import (
        MeshRasterConfig, rasterize_mesh)
    from youreditableavatar_tpu_torch.stages.edit_texture import (
        InpaintConfig, InpaintTrainer, RefineConfig, RefineTrainer)
    from youreditableavatar_tpu_torch.stages.localization import (
        HeuristicSegmenter, LocalizationConfig, LocalMeshEditing)

    mcfg = MeshRasterConfig()

    class Counting(HeuristicSegmenter):
        """The stand-in segmenter, counting its calls and masked pixels."""

        def __init__(self, mode):
            super().__init__(mode)
            self.calls = []

        def segment(self, image, prompt):
            mask = super().segment(image, prompt)
            self.calls.append(int(mask.sum()))
            return mask

    seg = Counting("center")
    model = TexturedMeshModel(verts, faces, editable, mcfg, device=dev)
    a, b, c = EDIT_OPTION_LADDER
    inpaint = InpaintTrainer(
        ebinding, eparams.copy(), model, ring, StubInpainter(), "a red hat",
        "blurry", InpaintConfig(iters_first=a, iters_second=b, iters_rest=c),
        segmenter=seg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inpaint.inpaint_training(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_inpaint = time.perf_counter() - t0
    losses = [h["loss"] for h in inpaint.history]
    print(f"  inpaint with the segmenter edge fix: {len(ring)} views, ladder "
          f"{EDIT_OPTION_LADDER}, {t_inpaint:.2f} s; segmenter calls "
          f"{len(seg.calls)} (person pixels {seg.calls}); last fit loss per "
          f"view " + ", ".join(f"{l:.5f}" for l in losses) + f"; painted "
          f"vertices {int(model.painted.sum())}")
    if not (len(seg.calls) == 2 and all(seg.calls)
            and all(np.isfinite(losses)) and model.painted.sum() > 0):
        raise AssertionError("the inpaint's edge fix did not run as expected")

    refine = RefineTrainer(ebinding, inpaint.params, turntable, blends,
                           RefineConfig(num_iterations=EDIT_OPTION_REFINE,
                                        lambda_perceptual=0.1), device=dev)
    times, losses = [], []
    rng = np.random.default_rng(3)
    for _ in range(EDIT_OPTION_REFINE):
        vi = int(rng.integers(0, len(turntable)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(refine.step(vi)[0]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    refine_ms = statistics.median(times)
    print(f"  perceptual refine (lambda_perceptual 0.1, LPIPS at {WIDTH}²): "
          f"step median {refine_ms:.3f} ms over {EDIT_OPTION_REFINE} "
          f"synchronised steps (min {min(times):.3f}, max {max(times):.3f}); "
          f"losses {losses[0]:.5f} … {losses[-1]:.5f}")
    if not all(np.isfinite(losses)):
        raise AssertionError("a perceptual refine loss is not finite")
    profile_window(lambda: refine.step(0), iters=3, step_ms=refine_ms,
                   watch=LAYOUT_WATCH)

    # Localization: white background, grey coverage from each view's mesh
    # raster, the upper band segmented.
    cams = ring[:3]
    vt = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    ft = torch.as_tensor(faces, dtype=torch.int32, device=dev)
    images = []
    for cam in cams:
        fid = rasterize_mesh(vt, ft, cam.raster_camera(dev),
                             mcfg).face_id.cpu().numpy()
        img = np.ones((HEIGHT, WIDTH, 3), np.float32)
        img[fid >= 0] = 0.5
        images.append(img)
    loc = LocalMeshEditing(verts, faces, HeuristicSegmenter("upper"),
                           LocalizationConfig(mesh_cfg=mcfg), device=dev)
    before = _kernels.LAUNCHES["mesh_resolve"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = loc.localize(cams, images, "the hat")
    torch.cuda.synchronize()
    t_loc = (time.perf_counter() - t0) * 1e3
    k5 = _kernels.LAUNCHES["mesh_resolve"] - before
    fmask = info["editing_mask_faces"] > 0.5
    fz = verts[faces].mean(1)[:, 2]
    print(f"  localize on {len(faces)} faces from {len(cams)} views at "
          f"{WIDTH}²: {t_loc:.1f} ms (synchronised; mesh_resolve launches "
          f"{k5}); {int(fmask.sum())} faces and "
          f"{int(info['editing_mask'].sum())} vertices selected, mean face z "
          f"{fz[fmask].mean():.3f} against {fz.mean():.3f} overall")
    if not (k5 == len(cams) and 0 < fmask.sum() < len(faces)
            and fz[fmask].mean() > fz.mean()):
        raise AssertionError("the localization did not select the upper band")


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
                   step_ms=sdf_ms + 3 * normal_ms, watch=SPATIAL_WATCH)
    short_sdf = ShapeInitializer(field, geometry, dataclasses.replace(
        short.cfg, sdf_iters=5, normal_iters=0), device=dev)
    print("  shape init, 5 SDF steps:")
    profile_window(lambda: short_sdf.run(body, faces, seed=1), iters=1,
                   step_ms=5 * sdf_ms, watch=SPATIAL_WATCH)
    k4_traffic(lambda: ShapeInitializer(field, geometry, dataclasses.replace(
        short.cfg, normal_iters=1), device=dev).run(body, faces, seed=1),
        "shape init, 1 SDF step then 1 normal step")

    # ---- SDS geometry edit (stage 1), bench_spatial's operating point ----
    field, params, geometry, part, mt, edit_faces, t_part = edit_field(dev)
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
                       step_ms=median, watch=SPATIAL_WATCH)
        k4_traffic(lambda: trainer.train_step(seed=1), f"edit step from {start}")
    moved = float((trainer.params.grid.detach()
                   - trainer.frozen_params.grid).abs().sum())
    print(f"  parameters moved: Σ|Δ table| = {moved:.6g}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if not (np.isfinite(moved) and moved > 0):
        raise AssertionError("the edit did not move the parameters")
    return dict(kernels.LAUNCHES)


def edit_field(dev):
    """`scripts/bench_spatial.py`'s operating point at full width: a fresh
    sphere field (16 levels × 2^19), grid 64, the cap z > EDIT_CAP_Z of its
    isosurface partitioned. Returns (field, params, geometry, partition,
    isosurface, editable faces, partition seconds)."""
    from youreditableavatar_tpu_torch.models.geometry import TetGeometry
    from youreditableavatar_tpu_torch.models.sdf import SDFField, SDFFieldConfig

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
    return (field, params, geometry, part, mt, edit_faces,
            time.perf_counter() - t0)


def check_lpips(dev):
    """LPIPS on the card (f32, cuDNN TF32 off) against the plain path in
    f64 on the CPU at 1 × LPIPS_CHECK_SIZE² (same weights): the value
    within LPIPS_RTOL, the gradient with respect to `pred` within
    LPIPS_GRAD_RTOL_OF_MAX of its largest entry. Printed beside it, not
    held: the same gradient on the card with TF32 on, and the CPU's f32
    gradient with oneDNN's convolutions on and off. Then forward +
    backward timed at 1 × WIDTH². Returns the LPIPS module on the card."""
    from youreditableavatar_tpu_torch.ops.lpips import LPIPS, lpips

    gen = torch.Generator().manual_seed(7)
    pred, target = (torch.rand((1, LPIPS_CHECK_SIZE, LPIPS_CHECK_SIZE, 3),
                               generator=gen) for _ in range(2))
    lp_cpu = LPIPS(seed=0, device="cpu")

    def value_grad(where, dtype=torch.float32):
        vgg = [{k: v.to(where, dtype) for k, v in p.items()}
               for p in lp_cpu.vgg]
        heads = [h.to(where, dtype) for h in lp_cpu.heads]
        x = pred.to(where, dtype).detach().requires_grad_()
        val = lpips(vgg, heads, x, target.to(where, dtype))
        val.backward()
        return float(val.detach()), x.grad.cpu().double()

    v64, g64 = value_grad("cpu", torch.float64)
    scale = float(g64.abs().max())

    def grad_err(g):
        return float((g - g64).abs().max()) / scale

    vk, gk = value_grad(dev)
    rel, err_card = abs(vk - v64) / abs(v64), grad_err(gk)
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        err_tf32 = grad_err(value_grad(dev)[1])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    cpu = {}
    for onednn in (True, False):
        with torch.backends.mkldnn.flags(enabled=onednn):
            cpu[onednn] = grad_err(value_grad("cpu")[1])
    lp = LPIPS(seed=0, device=dev)
    big = [torch.rand((1, HEIGHT, WIDTH, 3), device=dev) for _ in range(2)]

    def fwd_bwd():
        x = big[0].detach().requires_grad_()
        lp(x, big[1]).backward()
    ms = each_device_ms(fwd_bwd, 10)
    print(f"  LPIPS at {LPIPS_CHECK_SIZE}², card f32 (cuDNN TF32 {tf32}) vs "
          f"CPU f64: value {vk:.6f} vs {v64:.6f} (relative {rel:.2e}, "
          f"tolerance {LPIPS_RTOL}); gradient max error of its largest "
          f"entry {err_card:.2e} (tolerance {LPIPS_GRAD_RTOL_OF_MAX}); not "
          f"held: card with TF32 on {err_tf32:.2e}, CPU f32 with oneDNN "
          f"{cpu[True]:.2e}, without {cpu[False]:.2e}; forward + backward "
          f"at 1 × {WIDTH}²: median {statistics.median(ms):.3f} ms of device "
          f"time (min {min(ms):.3f}, max {max(ms):.3f})")
    if not (rel <= LPIPS_RTOL and err_card <= LPIPS_GRAD_RTOL_OF_MAX):
        raise AssertionError("LPIPS on the card differs from the f64 path")
    return lp


def phase_du(dev, kernels):
    """The stage-1 edit in the "du" mode at full width: SDSDUGuidance with
    the stub prior and an LPIPS perceptual term, DU_STEPS steps from step
    0, refresh steps and pull steps timed apart."""
    from youreditableavatar_tpu_torch.data.camera_sampler import (
        RandomCameraConfig)
    from youreditableavatar_tpu_torch.guidance.prompts import PromptProcessor
    from youreditableavatar_tpu_torch.guidance.sds import (
        SDSDUConfig, SDSDUGuidance)
    from youreditableavatar_tpu_torch.guidance.stub import (
        StubDiffusionPrior, StubPromptEncoder)
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
    from youreditableavatar_tpu_torch.stages.spatial import (
        HumanEditConfig, HumanEditTrainer)

    lp = check_lpips(dev)
    field, params, geometry, part, mt, edit_faces, t_part = edit_field(dev)
    guidance = SDSDUGuidance(StubDiffusionPrior(device=dev),
                             SDSDUConfig(per_editing_step=DU_PER_EDIT),
                             perceptual_fn=lp)
    prompts = PromptProcessor("a red down jacket", "low quality",
                              StubPromptEncoder(device=dev),
                              cache_dir=str(kernels.BUILD_DIR
                                            / "text_embeddings"),
                              model_name="bench-stub")
    ecfg = HumanEditConfig(use_sds=False, camera=RandomCameraConfig(
        height=HEIGHT, width=WIDTH))
    mcfg = MeshRasterConfig()
    trainer = HumanEditTrainer(field, geometry, part, params, guidance,
                               prompts, prompts, ecfg, mcfg, device=dev)
    print(f"  du edit: isosurface {int(mt.num_faces)} faces, "
          f"{int(edit_faces.sum())} editable; partition_init {t_part:.2f} s; "
          f"per_editing_step {DU_PER_EDIT}, {ecfg.du_view_buckets} azimuth "
          f"buckets, LPIPS perceptual term")

    # Which steps refresh (maybe_refresh is called only when one is due)
    # and which bucket each step visits (from the sampled azimuth).
    refreshed, azimuths = [], []
    refresh, sample = guidance.maybe_refresh, trainer.sampler.sample

    def logged_refresh(*args, **kw):  # args 6, 7: the bucket, the step
        refreshed.append((args[7], args[6]))
        return refresh(*args, **kw)

    def logged_sample(step):
        batch = sample(step)
        azimuths.append(float(batch.azimuth_deg[0]))
        return batch

    guidance.maybe_refresh, trainer.sampler.sample = logged_refresh, logged_sample
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    recs, times = [], []
    for _ in range(DU_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs.append(trainer.train_step(seed=1))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    guidance.maybe_refresh, trainer.sampler.sample = refresh, sample

    buckets = [int(a % 360.0 / 360.0 * ecfg.du_view_buckets)
               % ecfg.du_view_buckets for a in azimuths]
    steps_refreshed = {st for st, _ in refreshed}
    due, seen = [], set()
    for st, b in enumerate(buckets):
        due.append(st % DU_PER_EDIT == 0 or b not in seen)
        seen.add(b)
    refresh_ms = [t for st, t in enumerate(times) if st in steps_refreshed]
    pull_ms = [t for st, t in enumerate(times) if st not in steps_refreshed]
    moved = float((trainer.params.grid.detach()
                   - trainer.frozen_params.grid).abs().sum())
    print(f"  du edit, {DU_STEPS} steps from step 0: refresh steps "
          f"{sorted(steps_refreshed)}: {stats_line(refresh_ms)}; pull steps: "
          f"{stats_line(pull_ms)}; loss first "
          f"{recs[0]['loss']:.4f} last {recs[-1]['loss']:.4f}; du_f "
          f"{recs[-1]['du_f']:.4f}, du_l1 {recs[-1]['du_l1']:.4f}, recon "
          f"{recs[-1]['recon']:.3g}, nc {recs[-1]['nc']:.5f}; buckets visited "
          f"{sorted(set(buckets))}, cache entries "
          f"{sorted(guidance.edited_images)}; launches "
          f"{json.dumps({k: launches[k] for k in ('hash_scatter', 'mesh_resolve')})}"
          f"; Σ|Δ table| {moved:.6g}; peak memory {peak:.0f} MiB")
    if not all(np.isfinite(v) for r in recs for v in r.values()):
        raise AssertionError("a non-finite du loss")
    if not (np.isfinite(moved) and moved > 0):
        raise AssertionError("the du edit did not move the parameters")
    if sorted(guidance.edited_images) != sorted(set(buckets)):
        raise AssertionError("the edit cache does not hold one entry per "
                             "bucket visited")
    if [st for st, d in enumerate(due) if d] != sorted(steps_refreshed):
        raise AssertionError("the edit cache did not refresh on the "
                             "per_editing_step cadence")
    if launches["hash_scatter"] != K4_PER_EDIT_STEP * DU_STEPS:
        raise AssertionError("hash_scatter did not launch 3 times per du step")
    if launches["mesh_resolve"] < DU_STEPS + len(steps_refreshed):
        raise AssertionError("a du step's normal maps skipped mesh_resolve")
    profile_window(lambda: trainer.train_step(seed=1), iters=5,
                   step_ms=statistics.median(times),
                   watch=("scatter_kernel", "resolve_kernel"))
    return launches


def stats_line(ms):
    """Median, count, min and max of step times in ms."""
    return (f"median {statistics.median(ms):.3f} ms over {len(ms)} (min "
            f"{min(ms):.3f}, max {max(ms):.3f})" if ms else "none")


def median_ms(fn, iters=5, warmup=1):
    """(median, min, max) device ms of `fn` over `iters` calls, each timed
    with CUDA events."""
    ms = each_device_ms(fn, iters, warmup=warmup)
    return statistics.median(ms), min(ms), max(ms)


def fmt_ms(m):
    return f"{m[0]:.3f} ms (min {m[1]:.3f}, max {m[2]:.3f})"


class sd_convolutions:
    """Context: `sd_layers.conv2d`'s CUDA calls counted (`flops`, 2·M·N·K
    each: torch's FLOP counter cannot see the K7 kernel's launches) and,
    with `cudnn=True`, run through `sd_layers.conv2d_plain` (cuDNN's
    `F.conv2d`) instead of K7: for an f64 reference, which K7 does not
    take, and for a TF32 control, whose convolutions then compute in
    TF32 as well."""

    def __init__(self, cudnn=False):
        self.cudnn, self.flops = cudnn, 0

    def __enter__(self):
        from youreditableavatar_tpu_torch.guidance.sd_layers import (
            conv2d_plain)
        from youreditableavatar_tpu_torch.ops import conv_cuda

        self._module, self._inner = conv_cuda, conv_cuda.conv2d
        run = conv2d_plain if self.cudnn else self._inner

        def conv2d(x, w, b, stride, pads):
            oh, ow = conv_cuda.out_size(x.shape[1], x.shape[2], w.shape[0],
                                        w.shape[1], stride, pads)
            self.flops += 2 * x.shape[0] * oh * ow * w.numel()
            return run(x, w, b, stride, pads)

        conv_cuda.conv2d = conv2d
        return self

    def __exit__(self, *exc):
        self._module.conv2d = self._inner
        return False


def flops_of(fn):
    """Matmul and convolution FLOPs of one call of `fn`, counted by
    torch.utils.flop_counter from the shapes of the ops it runs (and, for
    the K7 convolutions it cannot see, by `sd_convolutions`)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter, \
            sd_convolutions() as convs:
        fn()
    return counter.get_total_flops() + convs.flops


def tree_bytes(tree):
    from youreditableavatar_tpu_torch.guidance.sd_layers import tree_numel

    return 4 * tree_numel(tree)


def rel_err(got, ref):
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max())


def check_f64(name, run, params, rtol):
    """`run(params)` in f32 (TF32 off) and with TF32 on, each against the
    same computation in f64 on the card: the f32 error must stay within
    `rtol` of the f64 result's largest entry, the TF32 control must not."""
    from youreditableavatar_tpu_torch.guidance.sd_layers import (
        tree_leaves, tree_to)

    with torch.no_grad():
        y32 = run(params, torch.float32)
        p64 = tree_to(params, tree_leaves(params)[0].device, torch.float64)
        with sd_convolutions(cudnn=True):  # K7 takes f32 alone
            y64 = run(p64, torch.float64)
        del p64
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            # K7 computes in f32 whatever the flags say: the control's
            # convolutions go to cuDNN, in TF32.
            with sd_convolutions(cudnn=True):
                y_tf32 = run(params, torch.float32)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
    e32, etf = rel_err(y32, y64), rel_err(y_tf32, y64)
    print(f"  {name}: card f32 (TF32 off) vs card f64, max error of the "
          f"largest entry {e32:.3e} (limit {rtol:.0e}); control with TF32 "
          f"on {etf:.3e} (must exceed the limit)")
    if not e32 <= rtol:
        raise AssertionError(f"{name} in f32 differs from f64")
    if not etf > rtol:
        raise AssertionError(f"{name}: the TF32 control does not fail, so "
                             f"the limit cannot tell f32 from TF32")
    torch.cuda.empty_cache()


def no_network_grads(*trees):
    """The number of weights in `trees`; raises if any requires or holds a
    gradient."""
    from youreditableavatar_tpu_torch.guidance.sd_layers import tree_leaves

    leaves = [x for t in trees for x in tree_leaves(t)]
    if any(x.requires_grad or x.grad is not None for x in leaves):
        raise AssertionError("a network weight requires or holds a gradient")
    return sum(x.numel() for x in leaves)


def phase_sd15(dev, kernels):
    """The full-width SD1.5 stack (SD15_UNET, SD_VAE, SD15_CLIP, random
    weights) behind HumanEditTrainer at the du phase's operating point:
    SDS_STEPS SDS steps and SDS_STEPS du steps from step 0; the networks'
    times, the UNet's f32 bound, and f32 against f64 on the card."""
    from youreditableavatar_tpu_torch.data.camera_sampler import (
        RandomCameraConfig)
    from youreditableavatar_tpu_torch.guidance.clip_text import SD15_CLIP
    from youreditableavatar_tpu_torch.guidance.manifests import (
        clip_text_manifest, unet_manifest, vae_manifest)
    from youreditableavatar_tpu_torch.guidance.prompts import PromptProcessor
    from youreditableavatar_tpu_torch.guidance.sd15 import (
        CLIPPromptEncoder, SD15Prior)
    from youreditableavatar_tpu_torch.guidance.sd_layers import tree_numel
    from youreditableavatar_tpu_torch.guidance.sd_unet import (
        SD15_UNET, apply_unet)
    from youreditableavatar_tpu_torch.guidance.sd_vae import SD_VAE, vae_decode
    from youreditableavatar_tpu_torch.guidance.sds import (
        SDSConfig, SDSDUConfig, SDSDUGuidance, SDSGuidance)
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
    from youreditableavatar_tpu_torch.stages.spatial import (
        HumanEditConfig, HumanEditTrainer)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prior = SD15Prior.random_init(gen, SD15_UNET, SD_VAE, device=dev)
    enc = CLIPPromptEncoder.random_init(gen, SD15_CLIP, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    counts = {"unet": tree_numel(prior.unet_params),
              "vae": tree_numel(prior.vae_params),
              "clip": tree_numel(enc.params)}
    official = {k: sum(int(np.prod(s)) for s in m.values()) for k, m in (
        ("unet", unet_manifest(SD15_UNET)), ("vae", vae_manifest(SD_VAE)),
        ("clip", clip_text_manifest(SD15_CLIP)))}
    print(f"  SD1.5 random weights drawn on the card in {t_init:.2f} s: "
          f"{json.dumps(counts)} = {sum(counts.values()):,} parameters "
          f"({4 * sum(counts.values()) / 2**30:.2f} GiB f32); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if counts != official:
        raise AssertionError(f"parameter counts {counts} differ from the "
                             f"official checkpoints' {official}")

    # One UNet forward at CFG batch 2 on 64² latents and one VAE decode,
    # f32 against f64 on the card (TF32 on as the control).
    g = torch.Generator(device=dev).manual_seed(1)
    lat = SD_LATENT
    z = torch.randn((1, lat, lat, 4), generator=g, device=dev)
    t = torch.tensor([500], device=dev)
    cond, uncond = enc.encode(["a red down jacket"]), enc.encode([""])
    ctx2 = torch.cat([cond, uncond])
    z2, t2 = torch.cat([z, z]), torch.cat([t, t])
    check_f64("SD1.5 UNet forward (CFG batch 2, 64² latents)",
              lambda p, dt: apply_unet(p, z2.to(dt), t2, ctx2.to(dt),
                                       SD15_UNET),
              prior.unet_params, SD_F64_RTOL)
    check_f64("SD VAE decode (64² latents → 512²)",
              lambda p, dt: vae_decode(p, z.to(dt) / SD_VAE.scaling_factor,
                                       SD_VAE),
              prior.vae_params, SD_F64_RTOL)

    # The networks' device times and the UNet's f32 bound.
    unet_ms = median_ms(lambda: prior.predict_noise(z, t, cond, uncond))
    flops = flops_of(lambda: prior.predict_noise(z, t, cond, uncond))
    unet_bytes = tree_bytes(prior.unet_params) + 4 * (
        z2.numel() * 2 + ctx2.numel())
    ub = bound(unet_bytes, flops)
    img = torch.rand((1, HEIGHT, WIDTH, 3), generator=g, device=dev)

    def enc_fwd_bwd():
        x = img.detach().requires_grad_()
        prior.encode_images(x, g).square().sum().backward()
    vae_bwd_ms = median_ms(enc_fwd_bwd)
    vae_flops = flops_of(lambda: prior.encode_images(img, g))
    with torch.no_grad():
        dec_ms = median_ms(lambda: prior.decode_latents(z))
        dec_flops = flops_of(lambda: prior.decode_latents(z))
    clip_ms = median_ms(lambda: enc.encode(["a red down jacket", ""]))
    print(f"  device times (median of 5, CUDA events): UNet forward at CFG "
          f"batch 2, {lat}² latents {fmt_ms(unet_ms)}, {flops / 1e12:.3f} "
          f"TFLOP → f32 bound {ub[0]:.3f} ms ({ub[1]}; "
          f"{ub[0] / unet_ms[0]:.3f} of it, {flops / unet_ms[0] / 1e9:.1f} "
          f"TFLOP/s); VAE encode forward + backward at 1 × {WIDTH}² "
          f"{fmt_ms(vae_bwd_ms)} (forward {vae_flops / 1e12:.3f} TFLOP); "
          f"decode {fmt_ms(dec_ms)} ({dec_flops / 1e12:.3f} TFLOP, f32 bound "
          f"{bound(0, dec_flops)[0]:.3f} ms); CLIP encode of 2 prompts "
          f"{fmt_ms(clip_ms)}")

    # The spatial stage's SDS and du edits at full width.
    results = {}
    for mode in ("sds", "du"):
        field, params, geometry, part, mt, edit_faces, t_part = edit_field(dev)
        if mode == "sds":
            guidance = SDSGuidance(prior, SDSConfig())
        else:
            guidance = SDSDUGuidance(prior, SDSDUConfig(
                per_editing_step=DU_PER_EDIT))
        prompts = PromptProcessor(
            "a red down jacket", "low quality", enc,
            cache_dir=str(kernels.BUILD_DIR / "text_embeddings"),
            model_name="chip-sd15-random")
        ecfg = HumanEditConfig(
            use_sds=mode == "sds", du_view_buckets=1,
            camera=RandomCameraConfig(height=HEIGHT, width=WIDTH))
        trainer = HumanEditTrainer(field, geometry, part, params, guidance,
                                   prompts, prompts, ecfg, MeshRasterConfig(),
                                   device=dev)
        refreshes = []
        if mode == "du":
            refresh = guidance.maybe_refresh

            def logged_refresh(*args, **kw):  # args 7: the step
                refreshes.append(args[7])
                return refresh(*args, **kw)
            guidance.maybe_refresh = logged_refresh
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        recs, times = [], []
        for _ in range(SD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs.append(trainer.train_step(seed=1))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {k: kernels.LAUNCHES[k]
                    for k in ("hash_scatter", "mesh_resolve", "conv_forward",
                              "conv_input_grad", "conv_reduce")}
        peak = torch.cuda.max_memory_allocated() / 2**30
        moved = float((trainer.params.grid.detach()
                       - trainer.frozen_params.grid).abs().sum())
        n_weights = no_network_grads(prior.unet_params, prior.vae_params,
                                     enc.params)
        if mode == "sds":
            stat = f"steps: {stats_line(times)}"
        else:
            stat = (f"refresh steps {refreshes}: "
                    f"{stats_line([times[s] for s in refreshes])}; pull steps: "
                    f"{stats_line([x for s, x in enumerate(times) if s not in refreshes])}")
        key = "sds" if mode == "sds" else "du_f"
        print(f"  {mode} edit, {SD_STEPS} steps from step 0 ({int(mt.num_faces)}"
              f" faces, {int(edit_faces.sum())} editable): {stat}; loss first "
              f"{recs[0]['loss']:.4f} last {recs[-1]['loss']:.4f} ({key} "
              f"{recs[0][key]:.4f} → {recs[-1][key]:.4f}); Σ|Δ table| "
              f"{moved:.6g}; launches {json.dumps(launches)}; peak memory "
              f"{peak:.2f} GiB; no gradient on any of the {n_weights:,} "
              f"network weights")
        if not all(np.isfinite(v) for r in recs for v in r.values()):
            raise AssertionError(f"a non-finite {mode} loss")
        if not (np.isfinite(moved) and moved > 0):
            raise AssertionError(f"the {mode} edit did not move the field")
        if launches["hash_scatter"] != K4_PER_EDIT_STEP * SD_STEPS:
            raise AssertionError("hash_scatter did not launch 3 times a step")
        if mode == "sds" and not (launches["conv_forward"]
                                  and launches["conv_input_grad"]):
            raise AssertionError("the networks' convolutions did not run K7")
        if mode == "du" and refreshes != list(range(0, SD_STEPS, DU_PER_EDIT)):
            raise AssertionError(f"refreshes at steps {refreshes}")
        if mode == "sds":
            profile_window(lambda: trainer.train_step(seed=1), iters=3,
                           step_ms=statistics.median(times),
                           watch=("scatter_kernel", "resolve_kernel"))
        results[mode] = launches
        del trainer, guidance, field, params, geometry, part
        torch.cuda.empty_cache()
    return results["sds"]  # K7's main path; the du edit's launches printed




def phase_sdxl(dev, kernels):
    """The full-width SDXL + ControlNet-Union stack (SDXLPipelineConfig(),
    random weights; the text encoder built as the factory builds it):
    inpaint and img2img at 1024² (4 steps), then the edit phase's
    icosphere at 512² with this inpainter behind InpaintTrainer and
    prepare_refine_guidance(upscale_to_2048=True)."""
    from youreditableavatar_tpu_torch.guidance.clip_text import SD15_CLIP
    from youreditableavatar_tpu_torch.guidance.factory import BIGG_CLIP
    from youreditableavatar_tpu_torch.guidance.manifests import (
        clip_text_manifest, controlnet_union_manifest, unet_manifest,
        vae_manifest)
    from youreditableavatar_tpu_torch.guidance.sd15 import CLIPPromptEncoder
    from youreditableavatar_tpu_torch.guidance.sd_layers import tree_numel
    from youreditableavatar_tpu_torch.guidance.sd_unet import (
        apply_unet, init_unet_params)
    from youreditableavatar_tpu_torch.guidance.sd_vae import init_vae_params
    from youreditableavatar_tpu_torch.guidance.sdxl_controlnet import (
        apply_controlnet_union, init_controlnet_union_params)
    from youreditableavatar_tpu_torch.guidance.sdxl_pipeline import (
        CTRL_NORMAL, CTRL_REPAINT, SDXLControlNetUnionPipeline,
        SDXLPipelineConfig, SDXLTextEncoder)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = SDXLPipelineConfig()
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unet = init_unet_params(gen, cfg.unet)
    vae = init_vae_params(gen, cfg.vae)
    controlnet = init_controlnet_union_params(gen, cfg.controlnet)
    enc_l = CLIPPromptEncoder.random_init(gen, SD15_CLIP, device=dev)
    enc_g = CLIPPromptEncoder.random_init(gen, BIGG_CLIP, device=dev)
    proj_g = torch.randn((1280, 1280), generator=gen, device=dev) / 1280**0.5
    pipe = SDXLControlNetUnionPipeline(unet, vae, controlnet,
                                       SDXLTextEncoder(enc_l, enc_g, proj_g),
                                       cfg, device=dev)
    del unet, vae, controlnet
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    counts = {"unet": tree_numel(pipe.unet_params),
              "controlnet": tree_numel(pipe.controlnet_params),
              "vae": tree_numel(pipe.vae_params),
              "clip_l": tree_numel(enc_l.params),
              "clip_bigg": tree_numel(enc_g.params),
              "text_projection": proj_g.numel()}
    official = {k: sum(int(np.prod(s)) for s in m.values()) for k, m in (
        ("unet", unet_manifest(cfg.unet)),
        ("controlnet", controlnet_union_manifest(cfg.controlnet)),
        ("vae", vae_manifest(cfg.vae)),
        ("clip_l", clip_text_manifest(SD15_CLIP)),
        ("clip_bigg", clip_text_manifest(BIGG_CLIP)))}
    print(f"  SDXL random weights drawn on the card in {t_init:.2f} s: "
          f"{json.dumps(counts)} = {sum(counts.values()):,} parameters "
          f"({4 * sum(counts.values()) / 2**30:.2f} GiB f32); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if {k: counts[k] for k in official} != official:
        raise AssertionError(f"parameter counts {counts} differ from the "
                             f"official checkpoints' {official}")

    g = torch.Generator(device=dev).manual_seed(2)
    res = XL_SIZE
    text_ms = median_ms(lambda: pipe.text_encoder.encode_with_pooled(
        ["a red hat"]))
    image = torch.rand((res, res, 3), generator=g, device=dev)
    with torch.no_grad():
        enc_ms = median_ms(lambda: pipe._encode_image(image, g, None), 3)
        z0 = pipe._encode_image(image, g, None)
        dec_ms = median_ms(lambda: pipe._decode(z0), 3)
        cond, uncond = pipe._encode_prompt("a red hat", "")
        ctx2, pooled2 = pipe._cfg_batch(cond, uncond, 1)
        controls = [(CTRL_NORMAL, image[None]), (CTRL_REPAINT, image[None])]
        step_ms = median_ms(lambda: pipe._step(z0, 999, 749, ctx2, pooled2,
                                               controls), 3)
        step_flops = flops_of(lambda: pipe._step(z0, 999, 749, ctx2, pooled2,
                                                 controls))
        # The step's two networks apart, at the same CFG batch.
        z2 = torch.cat([z0, z0])
        tb = torch.full((2,), 999, device=dev)
        px = torch.tensor([res, res, 0, 0, res, res], dtype=torch.float32,
                          device=dev)[None].expand(2, 6)
        add = (pooled2, px)
        ctrl2 = [(c, torch.cat([im, im])) for c, im in controls]
        cn_fn = lambda: apply_controlnet_union(  # noqa: E731
            pipe.controlnet_params, z2, tb, ctx2, ctrl2, cfg.controlnet, add)
        cn_ms = median_ms(cn_fn, 3)
        cn_flops = flops_of(cn_fn)
        residuals = cn_fn()
        un_fn = lambda: apply_unet(pipe.unet_params, z2, tb, ctx2,  # noqa: E731
                                   cfg.unet, add, residuals)
        un_ms = median_ms(un_fn, 3)
        un_flops = flops_of(un_fn)
    step_bytes = tree_bytes(pipe.unet_params) + tree_bytes(
        pipe.controlnet_params)
    sb = bound(step_bytes, step_flops)
    print(f"  device times (median, CUDA events): a denoising step "
          f"(ControlNet + UNet at CFG batch 2, {res // 8}² latents, two "
          f"controls) {fmt_ms(step_ms)}, {step_flops / 1e12:.3f} TFLOP → f32 "
          f"bound {sb[0]:.3f} ms ({sb[1]}; {sb[0] / step_ms[0]:.3f} of it); "
          f"ControlNet alone {fmt_ms(cn_ms)} ({cn_flops / 1e12:.3f} TFLOP, "
          f"bound {bound(0, cn_flops)[0]:.3f} ms), UNet alone "
          f"{fmt_ms(un_ms)} ({un_flops / 1e12:.3f} TFLOP, bound "
          f"{bound(0, un_flops)[0]:.3f} ms); VAE encode at {res}² "
          f"{fmt_ms(enc_ms)}, decode {fmt_ms(dec_ms)}; text encoders (CLIP-L "
          f"+ bigG, one prompt) {fmt_ms(text_ms)}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_window(lambda: pipe._step(z0, 999, 749, ctx2, pooled2, controls),
                   iters=2, step_ms=step_ms[0])
    del residuals, z2, ctrl2

    # inpaint and img2img at 1024², cut to XL_STEPS steps.
    mask = torch.zeros((res, res), device=dev)
    mask[:, res // 2:] = 1.0
    normal = torch.rand((res, res, 3), generator=g, device=dev)
    seen = {}
    encode, decode = pipe._encode_image, pipe._decode

    def logged_encode(*args):
        seen["z_orig"] = encode(*args)
        return seen["z_orig"]

    def logged_decode(latents):
        seen["z"] = latents
        return decode(latents)
    pipe._encode_image, pipe._decode = logged_encode, logged_decode
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipe.inpaint(image, mask, normal, image, "a red hat", "blurry",
                       torch.Generator(device=dev).manual_seed(3),
                       steps=XL_STEPS)
    torch.cuda.synchronize()
    t_inpaint = time.perf_counter() - t0
    pipe._encode_image, pipe._decode = encode, decode
    # The mask's left half covers latent columns < res / 16: the last step
    # pins them to the encoded original exactly; in the image the decoder
    # (its mid-block attention sees every latent) leaves them near the
    # original's VAE round trip.
    keep = slice(0, res // 16)
    pinned = bool(torch.equal(seen["z"][:, :, keep], seen["z_orig"][:, :, keep]))
    with torch.no_grad():
        rt = pipe._decode(seen["z_orig"])
    keep_err = float((out[:, : res // 2 - 64] - rt[:, : res // 2 - 64]).abs().mean())
    edit_err = float((out[:, res // 2 + 64:] - rt[:, res // 2 + 64:]).abs().mean())
    t0 = time.perf_counter()
    out2 = pipe.img2img(image, image, "a red hat",
                        torch.Generator(device=dev).manual_seed(4),
                        strength=0.5, steps=XL_STEPS)
    torch.cuda.synchronize()
    t_img2img = time.perf_counter() - t0
    print(f"  inpaint at {res}², {XL_STEPS} steps, two controls: "
          f"{t_inpaint:.2f} s; unmasked latents equal the encoded original's: "
          f"{pinned}; mean |out − VAE round trip| "
          f"{keep_err:.4f} on the unmasked half, {edit_err:.4f} on the "
          f"masked half (64 px from the seam); img2img at strength 0.5, "
          f"{len(pipe._timesteps(XL_STEPS, 0.5)) - 1} steps: {t_img2img:.2f} "
          f"s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, o in (("inpaint", out), ("img2img", out2)):
        if tuple(o.shape) != (res, res, 3) or not bool(torch.isfinite(o).all()) \
                or float(o.min()) < 0 or float(o.max()) > 1:
            raise AssertionError(f"{name} output is not a finite image in "
                                 f"[0, 1]")
    if not (pinned and keep_err < edit_err):
        raise AssertionError("the unmasked half is not pinned to the VAE "
                             "round trip")
    del out, out2, rt, seen

    launches = edit_with_sdxl(dev, kernels, pipe)
    no_network_grads(pipe.unet_params, pipe.vae_params,
                     pipe.controlnet_params, enc_l.params, enc_g.params)
    return launches


def edit_with_sdxl(dev, kernels, pipe):
    """The edit phase's icosphere at 512² with the SDXL pipeline behind
    InpaintTrainer (2 ring views, ladder 2/1/1) and
    prepare_refine_guidance(upscale_to_2048=True) on one turntable view."""
    from youreditableavatar_tpu_torch.models.cameras import (
        sample_circle_cameras, sample_ring_cameras)
    from youreditableavatar_tpu_torch.models.tetgs import (
        build_tetgs, extract_keep_gaussians)
    from youreditableavatar_tpu_torch.models.tetgs_edit import build_edit_tetgs
    from youreditableavatar_tpu_torch.models.textured_mesh import (
        TexturedMeshModel)
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
    from youreditableavatar_tpu_torch.ops.sh import rgb_to_sh_dc
    from youreditableavatar_tpu_torch.stages.edit_texture import (
        InpaintConfig, InpaintTrainer)
    from youreditableavatar_tpu_torch.utils.graphics import inverse_sigmoid

    verts, faces = icosphere(FIT_SUBDIV)
    binding, params = build_tetgs(verts, faces, None, np.arange(len(faces)),
                                  sh_levels=2, device=dev)
    with torch.no_grad():
        params.sh_dc.copy_(rgb_to_sh_dc(torch.as_tensor(
            pattern_colors(binding.ori_points.cpu().numpy()),
            dtype=torch.float32, device=dev))[:, None, :])
        params.opacity_raw.fill_(float(inverse_sigmoid(torch.tensor(0.9))))
    in_cap = verts[faces].mean(1)[:, 2] > EDIT_CAP_Z
    keep = extract_keep_gaussians(binding, params, np.flatnonzero(~in_cap))
    used = np.unique(faces[in_cap])
    remap = np.zeros(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    ebinding, eparams = build_edit_tetgs(verts[used], remap[faces[in_cap]],
                                         keep, sh_levels=1, device=dev)
    mesh_model = TexturedMeshModel(verts, faces, verts[:, 2] > EDIT_CAP_Z,
                                   MeshRasterConfig(), device=dev)
    ring = sample_ring_cameras(counts=(2, 0, 0), height=HEIGHT, width=WIDTH)
    turntable = sample_circle_cameras(1, height=HEIGHT, width=WIDTH)
    a, b, c = XL_EDIT_LADDER
    cfg = InpaintConfig(iters_first=a, iters_second=b, iters_rest=c,
                        first_group=1, second_group=1,
                        inpaint_steps=XL_STEPS)
    inpaint = InpaintTrainer(ebinding, eparams, mesh_model, ring, pipe,
                             "a red hat", "blurry", cfg, device=dev)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inpaint.inpaint_training(torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    t_inpaint = time.perf_counter() - t0
    blends = inpaint.prepare_refine_guidance(
        turntable, torch.Generator(device=dev).manual_seed(6),
        upscale_to_2048=True)
    torch.cuda.synchronize()
    t_refine = time.perf_counter() - t0 - t_inpaint
    launches = dict(kernels.LAUNCHES)
    print(f"  edit with the SDXL inpainter at {WIDTH}² ({ebinding.n_edit} "
          f"edit disks): inpaint training over {len(ring)} views (one joint "
          f"front|back inpaint at {cfg.fb_res}×{2 * cfg.fb_res}, "
          f"{XL_STEPS} steps) {t_inpaint:.2f} s, losses "
          f"{[round(h['loss'], 5) for h in inpaint.history]}, "
          f"{int(mesh_model.painted.sum())} painted vertices; refine "
          f"guidance with the 2×2-crop upscale, {len(blends)} view "
          f"{t_refine:.2f} s, shape {blends[0].shape}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for blend in blends:
        if blend.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(blend).all() \
                or blend.min() < 0 or blend.max() > 1:
            raise AssertionError("the upscale refine's blend is not a "
                                 "finite image of the render's shape")
    if not all(np.isfinite(h["loss"]) for h in inpaint.history):
        raise AssertionError("a non-finite inpaint fit loss")
    for k in RENDER_KERNELS + ("mesh_resolve",):
        if not launches.get(k):
            raise AssertionError(f"{k} did not launch in the SDXL edit")
    return launches


def host_ms(fn, iters=5, warmup=1):
    """(median, min, max) host ms of `fn` over `iters` synchronised calls
    (work that ends on the host: a mask or box as numpy)."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out), min(out), max(out)


def phase_segment(dev, kernels):
    """The full LangSAM stack on random weights drawn on the card: SAM
    ViT-H at 1024² and GroundingDINO Swin-T at 800² (256 text tokens, 900
    queries, the hash tokenizer), each held in f32 against f64 on the card
    and timed, then one SAMSegmenter.segment through a DinoGrounder and
    LocalMeshEditing.localize on the edit phase's icosphere through it."""
    from youreditableavatar_tpu_torch.guidance import grounding_dino as gd
    from youreditableavatar_tpu_torch.guidance.manifests import sam_manifest
    from youreditableavatar_tpu_torch.guidance.sam import (
        SAM_VIT_H, SAMSegmenter, init_sam_params, sam_decode_masks,
        sam_encode_box, sam_encode_image)
    from youreditableavatar_tpu_torch.models.cameras import (
        sample_ring_cameras)
    from youreditableavatar_tpu_torch.ops.mesh_raster import (
        MeshRasterConfig, rasterize_mesh)
    from youreditableavatar_tpu_torch.stages.localization import (
        LocalizationConfig, LocalMeshEditing)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = SAM_VIT_H
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sam = init_sam_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    t_sam = time.perf_counter() - t0
    n_sam = no_network_grads(sam)
    official = sum(int(np.prod(v)) for v in sam_manifest(cfg).values())
    print(f"  SAM ViT-H random weights drawn on the card in {t_sam:.2f} s: "
          f"{n_sam:,} parameters ({4 * n_sam / 2**30:.2f} GiB f32; the "
          f"official checkpoint's {official:,})")
    if n_sam != official:
        raise AssertionError("SAM's parameter count differs from the "
                             "official checkpoint's")
    g = torch.Generator(device=dev).manual_seed(1)
    s = cfg.img_size
    img = torch.randn((1, s, s, 3), generator=g, device=dev)
    box = torch.tensor([[212.0, 96.0, 801.0, 917.0]], device=dev)

    def sam_logits(p, dt):
        emb = sam_encode_image(p, img.to(dt), cfg)
        return sam_decode_masks(p, emb, sam_encode_box(p, box.to(dt), s),
                                cfg)[0]

    check_f64("SAM ViT-H encoder + decoder mask logits (1024², one box)",
              sam_logits, sam, SEG_F64_RTOL)
    with torch.no_grad():
        enc_ms = median_ms(lambda: sam_encode_image(sam, img, cfg))
        enc_flops = flops_of(lambda: sam_encode_image(sam, img, cfg))
        emb = sam_encode_image(sam, img, cfg)
        toks = sam_encode_box(sam, box, s)
        dec_ms = median_ms(lambda: sam_decode_masks(sam, emb, toks, cfg))
    eb = bound(tree_bytes(sam["encoder"]) + 4 * img.numel(), enc_flops)
    print(f"  device times (median of 5, CUDA events): sam_encode_image at "
          f"1 × {s}² {fmt_ms(enc_ms)}, {enc_flops / 1e12:.3f} TFLOP → f32 "
          f"bound {eb[0]:.3f} ms ({eb[1]}; {eb[0] / enc_ms[0]:.3f} of it); "
          f"sam_decode_masks (one box, 4 masks at {4 * cfg.grid}²) "
          f"{fmt_ms(dec_ms)}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del emb, toks
    torch.cuda.empty_cache()

    gcfg = gd.SWIN_T_GDINO
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dino = gd.init_gdino_params(torch.Generator(device=dev).manual_seed(2),
                                gcfg)
    torch.cuda.synchronize()
    t_dino = time.perf_counter() - t0
    n_dino = no_network_grads(dino)
    print(f"  GroundingDINO Swin-T random weights drawn on the card in "
          f"{t_dino:.2f} s: {n_dino:,} parameters "
          f"({4 * n_dino / 2**30:.2f} GiB f32)")
    if n_dino != GDINO_SWIN_T_PARAMS:
        raise AssertionError(f"GroundingDINO's parameter count differs from "
                             f"the JAX tree's {GDINO_SWIN_T_PARAMS:,}")
    frame = torch.rand((SEG_DINO_SIZE, SEG_DINO_SIZE, 3), generator=g,
                       device=dev)
    tok, mask = gd.HashTokenizer(gcfg.vocab, gcfg.max_text_len)(
        "a red down jacket .")
    tok, mask = torch.tensor(tok, device=dev), torch.tensor(mask, device=dev)
    n_tok = int(mask.sum())
    # The f32 run's query selection is handed to the f64 and TF32 runs: a
    # near-tie among 13,294 scores would otherwise reorder the queries and
    # compare unrelated boxes.
    top_of = gd._top_queries
    picks = []

    def ground(p, dt):
        def top(score, k):
            picks.append(top_of(score, k))
            return picks[0]

        gd._top_queries = top
        try:
            return gd.gdino_ground(p, frame.to(dt), tok, mask, gcfg)
        finally:
            gd._top_queries = top_of

    check_f64("gdino_ground boxes (800², 256 tokens, 900 queries)",
              lambda p, dt: ground(p, dt)["boxes"], dino, SEG_F64_RTOL)
    check_f64("gdino_ground logits over the prompt's tokens",
              lambda p, dt: ground(p, dt)["logits"][:, :n_tok], dino,
              GDINO_LOGITS_F64_RTOL)
    own = picks[1]  # the f64 run's own selection
    print(f"  the f64 run's own top-900 against the f32 run's: "
          f"{int((own == picks[0]).sum())} ranks equal, "
          f"{len(set(own.tolist()) & set(picks[0].tolist()))} indices shared")
    with torch.no_grad():
        gd_ms = median_ms(lambda: gd.gdino_ground(dino, frame, tok, mask,
                                                  gcfg))
        gd_flops = flops_of(lambda: gd.gdino_ground(dino, frame, tok, mask,
                                                    gcfg))
        out = gd.gdino_ground(dino, frame, tok, mask, gcfg)
    if not all(bool(torch.isfinite(v).all()) for v in out.values()):
        raise AssertionError("gdino_ground gave non-finite values")
    levels = [(SEG_DINO_SIZE + 2 ** (3 + i) - 1) // 2 ** (3 + i)
              for i in range(3)]
    levels.append((levels[-1] + 1) // 2)
    print(f"  gdino_ground at {SEG_DINO_SIZE}² ({sum(x * x for x in levels):,}"
          f" pyramid tokens over levels {levels}): {fmt_ms(gd_ms)} "
          f"(median of 5, CUDA events), {gd_flops / 1e12:.3f} TFLOP of "
          f"matmuls and convolutions; best score "
          f"{float(out['scores'].max()):.4f}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out
    torch.cuda.empty_cache()

    # LangSAM: the GroundingDINO box, then SAM's mask (an untrained decoder:
    # box ∩ foreground), as the factory's "sam" backend configures it.
    grounder = gd.DinoGrounder(dino, gcfg, box_threshold=0.35,
                               image_size=SEG_DINO_SIZE, device=dev)
    seg = SAMSegmenter(sam, cfg, grounder=grounder, trust_decoder=False,
                       device=dev)
    verts, faces = icosphere(FIT_SUBDIV)
    mcfg = MeshRasterConfig()
    vt = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    ft = torch.as_tensor(faces, dtype=torch.int32, device=dev)
    cams = sample_ring_cameras(counts=EDIT_RING, height=HEIGHT,
                               width=WIDTH)[:3]
    images = []
    for cam in cams:
        fid = rasterize_mesh(vt, ft, cam.raster_camera(dev),
                             mcfg).face_id.cpu().numpy()
        im = np.ones((HEIGHT, WIDTH, 3), np.float32)
        im[fid >= 0] = 0.5
        images.append(im)
    box0 = grounder.ground(images[0], "the hat")
    seg_ms = host_ms(lambda: seg.segment(images[0], "the hat"))
    mask0 = seg.segment(images[0], "the hat").cpu().numpy()
    # The untrained decoder's mask is the grounded box ∩ the foreground.
    x0, y0, x1, y1 = box0.astype(int)
    expect = np.zeros((HEIGHT, WIDTH), bool)
    expect[y0:y1 + 1, x0:x1 + 1] = True
    expect &= ~(images[0] > 0.95).all(-1)
    print(f"  SAMSegmenter.segment with the DinoGrounder on a {WIDTH}² "
          f"probe view: {fmt_ms(seg_ms)} (median of 5, host clock, "
          f"synchronised); box {np.round(box0, 1).tolist()} (random "
          f"weights), {int(mask0.sum())} mask pixels")
    if not (mask0.dtype == bool and np.array_equal(mask0, expect)
            and np.isfinite(box0).all()):
        raise AssertionError("the LangSAM mask is not the box ∩ foreground")
    busy = profile_window(lambda: seg.segment(images[0], "the hat"),
                          iters=3, step_ms=seg_ms[0])
    loc = LocalMeshEditing(verts, faces, seg, LocalizationConfig(mesh_cfg=mcfg),
                           device=dev)
    kernels.reset_launches()
    loc_ms = host_ms(lambda: loc.localize(cams, images, "the hat"))
    info = loc.localize(cams, images, "the hat")
    k5 = kernels.LAUNCHES["mesh_resolve"]
    fmask = info["editing_mask_faces"] > 0.5
    print(f"  localize through LangSAM on {len(faces)} faces from "
          f"{len(cams)} views at {WIDTH}²: {fmt_ms(loc_ms)} (median of 5, "
          f"host clock); {int(fmask.sum())} faces and "
          f"{int(info['editing_mask'].sum())} vertices selected; "
          f"mesh_resolve launches {k5} over 7 calls; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (k5 == 7 * len(cams) and fmask.shape == (len(faces),)
            and info["editing_mask"].shape == (len(verts),)):
        raise AssertionError("localize did not run through the segmenter")
    del seg, grounder, loc, sam, dino
    torch.cuda.empty_cache()
    return {"mesh_resolve": k5, "busy": busy}


def phase_pipeline(dev, kernels):
    """run_synthetic_pipeline (cli/pipeline.py) on the card at production
    widths, cut in depth; each stage timed, its artifacts read back, every
    kernel's launches counted; then the spatial CLI's --validate on the
    produced checkpoint."""
    import tempfile

    from youreditableavatar_tpu_torch import native
    from youreditableavatar_tpu_torch.cli import pipeline as pl
    from youreditableavatar_tpu_torch.cli import train_spatial
    from youreditableavatar_tpu_torch.models.tetgs import load_tetgs
    from youreditableavatar_tpu_torch.stages import export

    scale = pl.PipelineScale(**PIPE_DEPTH)
    b = scale.budgets
    n_field = sum(x.numel() for x in pl._field(scale).init_params(
        0, device=dev).parameters())
    print(f"  SDF field {n_field:,} parameters; scale: grid "
          f"{scale.grid_res}, {scale.image_hw}², hash grid "
          f"{scale.hashgrid.n_levels} × 2^{scale.hashgrid.log2_hashmap_size}, "
          f"budgets {dataclasses.asdict(b)}, raster pair budget "
          f"{scale.raster.pair_budget}, mesh pair budget "
          f"{scale.mesh_raster.pair_budget}; depth {json.dumps(PIPE_DEPTH)}")
    _, _, nv, nf = pl.synthetic_body(scale.grid_res, dev)
    full = nv >= 8192 or nf >= 16384
    print(f"  synthetic body: marching tets at grid {scale.grid_res} gives "
          f"{nv} vertices and {nf} faces against the fixed budgets 8192 / "
          f"16384" + (": SATURATED, the body is cut at the budget"
                      if full else ": within them"))

    # Each stage's seconds, and the shape init's MeshSDF pool signs apart.
    sink: dict = {}
    wrapped = [(pl, "run_spatial_stage"), (pl, "run_init_texture_stage"),
               (pl, "run_edit_texture_stage"), (native.MeshSDF, "__call__")]
    saved = [getattr(m, n) for m, n in wrapped]

    def timed(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                sink.setdefault(key, []).append(time.perf_counter() - t0)
        return call

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".pipeline_") as out:
        for (m, n), fn in zip(wrapped, saved):
            setattr(m, n, timed(fn, n))
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            arts = pl.run_synthetic_pipeline(out, scale, device=dev)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            for (m, n), fn in zip(wrapped, saved):
                setattr(m, n, fn)
        launches = dict(kernels.LAUNCHES)
        sp = sink["run_spatial_stage"]
        signs = " / ".join(f"{t:.2f}" for t in sink["__call__"])
        print(f"  run_synthetic_pipeline {total:.2f} s: spatial init "
              f"{sp[0]:.2f} s, init texture + localization "
              f"{sink['run_init_texture_stage'][0]:.2f} s, spatial init + "
              f"edit {sp[1]:.2f} s (each shape init's MeshSDF signs of its "
              f"pool: {signs} s), edit texture "
              f"{sink['run_edit_texture_stage'][0]:.2f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"  kernel launches over the pipeline: {json.dumps(launches)}")
        missing = [k for k in PIPE_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"the pipeline never launched {missing}")

        init = export.load_init_mesh(arts["init_mesh"])
        region = export.load_editing_region_info(arts["editing_region_info"])
        edit = export.load_edit_mesh(arts["edit_mesh"])
        _, tparams, _ = load_tetgs(arts["tetgs_init"], device=dev)
        finals = sorted(os.listdir(arts["final_dir"]))
        print(f"  artifacts: init_mesh {init['vertices'].shape} vertices, "
              f"{init['faces'].shape} faces; editing_region_info "
              f"{int(region['editing_mask'].sum())} of "
              f"{len(region['editing_mask'])} vertices, "
              f"{int((region['editing_mask_faces'] > 0.5).sum())} faces; "
              f"edit_mesh {edit['vertices'].shape} vertices (keep "
              f"{int(edit['keep_vertices_num'])}), {edit['faces'].shape} "
              f"faces, {int(edit['editing_mask'].sum())} editable; "
              f"tetgs_init {tuple(tparams.delta.shape[:1])} Gaussians; "
              f"{len(finals)} final frames")
        if not (init["faces"].max() < len(init["vertices"])
                and edit["keep_vertices_num"] > 0
                and edit["editing_mask"].sum() > 0
                and len(finals) == scale.turntable_views):
            raise AssertionError("the pipeline's artifacts are incomplete")

        # The device's share of one edit-texture stage, re-run on the
        # pipeline's artifacts.
        edit_s = sink["run_edit_texture_stage"][0]
        busy = profile_window(
            lambda: pl.run_edit_texture_stage(
                os.path.join(out, "profiled"), arts["edit_mesh"],
                arts["tetgs_init"], "a red jacket", scale, device=dev),
            iters=1, step_ms=edit_s * 1e3)

        vdir = os.path.join(out, "cli")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_spatial.main(["--config", os.path.join(
            root, "configs", "geometry-init.yaml"), "--validate",
            "--ckpt", arts["ckpt"], "--out", vdir, "--device", str(dev)])
        torch.cuda.synchronize()
        frames = [f for f in os.listdir(os.path.join(vdir, "validation"))
                  if f.endswith(".png")]
        print(f"  train_spatial --validate on the produced checkpoint: "
              f"{len(frames)} frames in {time.perf_counter() - t0:.2f} s")
        if len(frames) != 8:
            raise AssertionError("the spatial CLI's --validate wrote "
                                 f"{len(frames)} frames")
    return {**launches, "busy": busy}


def phase_mesh(dev, kernels):
    """`models/mesh.Mesh` (UV atlas, tangents) and `ops/shape_loss`'s
    winding numbers on the 81,920-face icosphere."""
    from youreditableavatar_tpu_torch.models.mesh import Mesh
    from youreditableavatar_tpu_torch.ops.shape_loss import (
        default_chunk, winding_number)

    verts, faces = icosphere(FIT_SUBDIV)
    mesh = Mesh(verts.astype(np.float32), faces.astype(np.int64))
    t0 = time.perf_counter()
    mesh.unwrap_uv()
    t_uv = time.perf_counter() - t0
    tng = mesh.v_tng
    t_tng = time.perf_counter() - t0 - t_uv
    uv, ft = mesh.v_tex, mesh.t_tex_idx
    dots = float(np.abs(np.sum(tng * mesh.v_nrm, -1)).max())
    print(f"  Mesh on {len(faces)} faces: unwrap_uv {t_uv:.2f} s ({len(uv)} "
          f"atlas vertices, uv in [{uv.min():.4f}, {uv.max():.4f}]); tangents "
          f"{t_tng:.3f} s, max |t·n| {dots:.2e}")
    if not (uv.min() >= 0 and uv.max() <= 1 and ft.shape == faces.shape
            and dots < 1e-3):
        raise AssertionError("the UV atlas or its tangents are wrong")

    rng = np.random.default_rng(9)
    d = rng.normal(size=(WINDING_POINTS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.concatenate([rng.uniform(0.0, 0.7, WINDING_POINTS // 2),
                        rng.uniform(0.9, 1.5, WINDING_POINTS // 2)])
    pts = torch.as_tensor(d * r[:, None], dtype=torch.float32, device=dev)
    vt = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    ftt = torch.as_tensor(faces, dtype=torch.int32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    ms = device_ms(lambda: winding_number(pts, vt, ftt), 1, warmup=1)
    w = winding_number(pts, vt, ftt).cpu().numpy()
    half = WINDING_POINTS // 2
    err_in, err_out = np.abs(w[:half] - 1).max(), np.abs(w[half:]).max()
    print(f"  winding numbers of {WINDING_POINTS} points (half inside radius "
          f"0.7, half outside 0.9 of the 0.8 sphere) against {len(faces)} "
          f"faces: max |w - 1| inside {err_in:.2e}, max |w| outside "
          f"{err_out:.2e}; {ms:.3f} ms in chunks of {default_chunk(len(faces))}"
          f" points; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if not (err_in < WINDING_ATOL and err_out < WINDING_ATOL):
        raise AssertionError("winding numbers are not near 1 inside and 0 "
                             "outside")


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

    from youreditableavatar_tpu_torch.models.optimizer import (
        OptimizationParams, make_tetgs_optimizer)
    from youreditableavatar_tpu_torch.models.tetgs import (
        TetGSParams, gaussian_arrays)
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        render_gaussians)
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

        # The targets are the colour-pattern copy's renders; a colour
        # changes no pair count, so the scene's budget fits them.
        binding, params, cams, cfg, need = sharded_scene(dev)
        bg = torch.zeros(3, device=dev)
        with torch.no_grad():
            target = TetGSParams(**{k: v.detach().clone()
                                    for k, v in params.named_parameters()})
            target.sh_dc.copy_(rgb_to_sh_dc(torch.as_tensor(
                pattern_colors(binding.ori_points.cpu().numpy()),
                dtype=torch.float32, device=dev))[:, None, :])
            g = gaussian_arrays(binding, target)
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
        profile_window(lambda: step(params, batch), iters=3, step_ms=median,
                       watch=LAYOUT_WATCH)
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
    # No Pallas kernel: K7 replaces the JAX package's shifted matmuls.
    **{name: ("youreditableavatar_tpu_torch/csrc/conv.cu",
              "youreditableavatar_tpu/guidance/sd_layers.py:40")
       for name in ("conv_forward", "conv_input_grad", "conv_reduce")},
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


def main(argv) -> int:
    # `--phases a,b` runs only those phases after device and build (a
    # development or comparison run); the kernels line then has no
    # launches for the phases left out.
    only = None
    if argv[:1] == ["--phases"] and len(argv) == 2:
        only = argv[1].split(",")
    elif argv:
        print("usage: chip_smoke.py [--phases name,...]", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from youreditableavatar_tpu_torch import _kernels
    except ImportError as exc:  # the script alone, without the repository
        print(f"chip_smoke: the port does not import: {exc}", file=sys.stderr)
        return 1

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
        from youreditableavatar_tpu_torch.ops.gaussian_raster import (
            composite_cuda as comp)
        clusters = {f"{'indexed' if i else 'rows'}, store {int(s)}":
                    comp.forward_clusters(i, s)
                    for i in (True, False) for s in (True, False)}
        print(f"  K1f's 4-CTA clusters resident at once "
              f"(cudaOccupancyMaxActiveClusters): {json.dumps(clusters)}")

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
        "du": lambda: phase_du(dev, _kernels),
        "mesh": lambda: phase_mesh(dev, _kernels),
        "sd15": lambda: phase_sd15(dev, _kernels),
        "sdxl": lambda: phase_sdxl(dev, _kernels),
        "segment": lambda: phase_segment(dev, _kernels),
        "pipeline": lambda: phase_pipeline(dev, _kernels),
        "sharded": lambda: phase_sharded(dev, _kernels),
    }
    chosen = list(phases) if only is None else only
    unknown = sorted(set(chosen) - set(phases))
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}", file=sys.stderr)
        return 1
    results = {name: run_phase(name, phases[name], failures)
               for name in chosen}
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    # Each kernel's launches come from the run of its own main path.
    main_path = {"mesh_resolve": "edit", "hash_scatter": "spatial",
                 "composite_backward_pairs": "sharded", "conv_forward": "sd15",
                 "conv_input_grad": "sd15", "conv_reduce": "sd15"}

    kernels = []
    for name in _kernels.KERNEL_NAMES if "kernels" in results else ():
        r = report[name]
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (results.get(main_path.get(name, "fit")) or {}).get(name),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
            "kernel_ms": r.get("kernel_ms"),
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
