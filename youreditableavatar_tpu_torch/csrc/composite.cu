// Tile compositing on Hopper: forward (K1f), fused backward (K1b) and
// per-pair backward (K6).
//
// Replaces the Pallas kernels of youreditableavatar_tpu/ops/gaussian_raster/
// composite_pallas.py: the forward `_forward_kernel` (via `_forward_call`),
// the per-Gaussian backward `_backward_kernel_fused` (via
// `_backward_call_fused`) of `composite_tiles_pallas_fused`, and the per-pair
// backward `_backward_kernel` (via `_backward_call`) of the non-fused
// `composite_tiles_pallas`.
//
// What bounds them on the H100: f32 arithmetic, not bytes. At the 512²/100k
// render the forward meets 1.08e8 live (pair, pixel) combinations (counted
// by chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W), each an expf plus
// ~26 f32 operations (~43 µs at the 67 TFLOP/s f32 peak), against ~12.5 MB
// of field rows, pair ids and outputs (~4 µs at 3.35 TB/s). The backward
// does about twice the arithmetic per combination, plus 9 cross-thread
// sums per pair and, in K1b, 9 atomics per pair; K6 writes one 64-byte row
// per pair slot instead (~28 MB at 217,088 slots, ~8 µs).
//
// Design:
//  * One CTA per 32×32 tile, 256 threads × 4 pixels each (pixel p → x =
//    p % 32, y = p / 32). The tile's depth-ordered, 128-aligned pair range
//    is staged 128 pairs at a time into shared memory (structure of arrays,
//    so every thread reads the same pair as a broadcast). The forward reads
//    each staged row either as fields_ext[pg_padded[slot]] (K1f under K1b:
//    the (P_pad, 16) pair rows are never materialised) or directly as
//    rows[slot] (K1f under K6, whose caller gathered the rows): a template
//    flag picks the source, the rest of the kernel is one code.
//  * The whole tile stops when every pixel is done: `__syncthreads_or`
//    after each staged batch (it is also the barrier before restaging).
//  * The α / contrib / trigger decisions are one __device__ function,
//    `blend`, shared by all three kernels, so the backwards visit exactly
//    the pairs the forward counted. It repeats the plain PyTorch version's
//    f32 arithmetic op for op: this file is compiled with --fmad=false.
//  * Backward: the JAX design's forward-order sweep. With the saved colour
//    C and final T, the suffix S = C − prefix, so dL/dα needs only a
//    running prefix P·g. Per pair, each thread sums its 4 pixels, a warp
//    shuffle tree sums 32 threads, and the 8 warps' partials meet in shared
//    memory after each batch.
//    - K1b: one atomicAdd per field and pair into the zero-initialised
//      (N+1, 16) table (row = field 9, the row id). Float atomics make the
//      order of those sums vary from run to run.
//    - K6: the CTA writes each pair's 16-float gradient row into the pair's
//      own slot (slots are tile-exclusive: no atomics, and the same input
//      gives the same bits on every launch). Every slot of the tile's
//      aligned range is written, zeros past `count` and after the early
//      exit. Columns: 0-1 d mean = conic · Σ(dpower·dx, dpower·dy), 2-4
//      d conic (scaled −½, −1, −½), 5 d opacity, 6-8 d colour, 9-15 zero.
//    The TPU's bf16 mantissa splits (REDUCE_SPLIT), its SMEM scalar
//    streaming and its 128-lane row padding are not ported: all f32.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kPerThread = kPix / kThreads;  // 4 pixels per thread
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;  // pairs staged per batch
constexpr int kFields = 16;  // floats per fields_ext row
constexpr int kStaged = 10;  // mean x/y, conic a/b/c, opacity, r/g/b, row id
constexpr int kGrads = 9;
constexpr unsigned kFull = 0xffffffffu;
// Same f32 values as the Python constants 0.99, 1/255 and 1e-4.
constexpr float kAlphaClamp = (float)0.99;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kTEps = (float)1e-4;

struct Blend {
  float alpha, test_t, gauss, dx, dy;
  bool contrib, trigger;
};

// The compositing decision for one live pixel and one pair.
__device__ __forceinline__ Blend blend(float mx, float my, float ca, float cb,
                                       float cc, float op, float px, float py,
                                       float trans) {
  Blend b;
  b.dx = px - mx;
  b.dy = py - my;
  const float power =
      -0.5f * (ca * b.dx * b.dx + cc * b.dy * b.dy) - cb * b.dx * b.dy;
  b.gauss = expf(power);
  const float raw = op * b.gauss;
  b.alpha = raw < kAlphaClamp ? raw : kAlphaClamp;
  const bool ok = (power <= 0.0f) && (b.alpha >= kAlphaMin);
  b.test_t = trans * (1.0f - b.alpha);
  b.trigger = ok && (b.test_t < kTEps);
  b.contrib = ok && !b.trigger;
  return b;
}

// Stage pair slots [base, base + n) into sp[field][j]: the rows
// fields[pg[slot]] (kIndexed; an id out of range reads row 0, the zero row)
// or fields[slot] (direct; a slot out of range stages zeros).
template <bool kIndexed>
__device__ __forceinline__ void stage(const float* __restrict__ fields,
                                      const int* __restrict__ pg, int base,
                                      int n, int nrows,
                                      float (*sp)[kChunk]) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int row = kIndexed ? pg[base + j] : base + j;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a, c = a;
    if (static_cast<unsigned>(row) >= static_cast<unsigned>(nrows)) row = -1;
    if (kIndexed && row < 0) row = 0;
    if (row >= 0) {
      const float4* src = reinterpret_cast<const float4*>(
          fields + static_cast<size_t>(row) * kFields);
      a = src[0]; b = src[1]; c = src[2];
    }
    sp[0][j] = a.x; sp[1][j] = a.y; sp[2][j] = a.z; sp[3][j] = a.w;
    sp[4][j] = b.x; sp[5][j] = b.y; sp[6][j] = b.z; sp[7][j] = b.w;
    sp[8][j] = c.x; sp[9][j] = c.y;
  }
}

__device__ __forceinline__ void pixel_xy(int tile, int ntx, int k, float& px,
                                         float& py) {
  const int p = threadIdx.x + k * kThreads;
  px = static_cast<float>((tile % ntx) * kTile + p % kTile);
  py = static_cast<float>((tile / ntx) * kTile + p / kTile);
}

template <bool kIndexed>
__global__ void __launch_bounds__(kThreads)
forward_kernel(const float* __restrict__ fields, const int* __restrict__ pg,
               const int* __restrict__ starts, const int* __restrict__ counts,
               float* __restrict__ rgb, float* __restrict__ final_t,
               int* __restrict__ n_contrib, int ntx, int nrows) {
  __shared__ float sp[kStaged][kChunk];
  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];

  float px[kPerThread], py[kPerThread], trans[kPerThread];
  float cr[kPerThread], cg[kPerThread], cb[kPerThread];
  int cnt[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    pixel_xy(tile, ntx, k, px[k], py[k]);
    trans[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    cnt[k] = 0;
    done[k] = false;
  }

  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    stage<kIndexed>(fields, pg, start + c0, n, nrows, sp);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float mx = sp[0][j], my = sp[1][j];
      const float ca = sp[2][j], cbc = sp[3][j], cc = sp[4][j];
      const float op = sp[5][j];
      const float r = sp[6][j], g = sp[7][j], b = sp[8][j];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (done[k]) continue;
        const Blend o = blend(mx, my, ca, cbc, cc, op, px[k], py[k], trans[k]);
        if (o.contrib) {
          const float w = o.alpha * trans[k];
          cr[k] = cr[k] + w * r;
          cg[k] = cg[k] + w * g;
          cb[k] = cb[k] + w * b;
          trans[k] = o.test_t;
          cnt[k] += 1;
        }
        if (o.trigger) done[k] = true;
      }
    }
    bool live = false;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) live = live || !done[k];
    if (!__syncthreads_or(live)) break;
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    const size_t o = static_cast<size_t>(tile) * kPix + p;
    rgb[static_cast<size_t>(tile) * 3 * kPix + p] = cr[k];
    rgb[static_cast<size_t>(tile) * 3 * kPix + kPix + p] = cg[k];
    rgb[static_cast<size_t>(tile) * 3 * kPix + 2 * kPix + p] = cb[k];
    final_t[o] = trans[k];
    n_contrib[o] = cnt[k];
  }
}


// Per-pixel backward state of one thread's 4 pixels.
struct BwdPixels {
  float px[kPerThread], py[kPerThread], trans[kPerThread];
  float gr[kPerThread], gg[kPerThread], gb[kPerThread];
  float gt_tf[kPerThread], cg_img[kPerThread], pg_dot[kPerThread];
  bool done[kPerThread];
};

__device__ __forceinline__ void init_backward(
    BwdPixels& s, int tile, int ntx, const float* __restrict__ rgb,
    const float* __restrict__ final_t, const float* __restrict__ drgb,
    const float* __restrict__ dt) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    pixel_xy(tile, ntx, k, s.px[k], s.py[k]);
    const int p = threadIdx.x + k * kThreads;
    const size_t base3 = static_cast<size_t>(tile) * 3 * kPix + p;
    const size_t o = static_cast<size_t>(tile) * kPix + p;
    s.gr[k] = drgb[base3];
    s.gg[k] = drgb[base3 + kPix];
    s.gb[k] = drgb[base3 + 2 * kPix];
    s.gt_tf[k] = dt[o] * final_t[o];
    s.cg_img[k] = rgb[base3] * s.gr[k] + rgb[base3 + kPix] * s.gg[k] +
                  rgb[base3 + 2 * kPix] * s.gb[k];
    s.trans[k] = 1.0f;
    s.pg_dot[k] = 0.0f;
    s.done[k] = false;
  }
}

// The forward-order backward sweep over the n staged pairs: each warp's
// 9 pixel sums of pair j go to part[warp][field][j]. Returns whether any of
// this thread's pixels is still live.
__device__ __forceinline__ bool sweep_batch(BwdPixels& s, float (*sp)[kChunk],
                                            int n,
                                            float (*part)[kGrads][kChunk]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < n; ++j) {
    const float mx = sp[0][j], my = sp[1][j];
    const float ca = sp[2][j], cbc = sp[3][j], cc = sp[4][j];
    const float op = sp[5][j];
    const float r = sp[6][j], g = sp[7][j], b = sp[8][j];
    float acc[kGrads];
#pragma unroll
    for (int f = 0; f < kGrads; ++f) acc[f] = 0.0f;
    bool any = false;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (s.done[k]) continue;
      const Blend o =
          blend(mx, my, ca, cbc, cc, op, s.px[k], s.py[k], s.trans[k]);
      if (o.contrib) {
        const float w = o.alpha * s.trans[k];
        const float dot_cg = r * s.gr[k] + g * s.gg[k] + b * s.gb[k];
        s.pg_dot[k] = s.pg_dot[k] + w * dot_cg;
        // dL/dα = T·(c·g) − (S·g + gT·T_final)/(1 − α), S·g = C·g − P·g.
        float dalpha = s.trans[k] * dot_cg -
                       (s.cg_img[k] - s.pg_dot[k] + s.gt_tf[k]) /
                           (1.0f - o.alpha);
        if (!(op * o.gauss < kAlphaClamp)) dalpha = 0.0f;  // α clamped
        const float dpower = dalpha * op * o.gauss;
        const float dpdx = dpower * o.dx;
        const float dpdy = dpower * o.dy;
        acc[0] += dpdx;
        acc[1] += dpdy;
        acc[2] += dpdx * o.dx;
        acc[3] += dpdx * o.dy;
        acc[4] += dpdy * o.dy;
        acc[5] += dalpha * o.gauss;
        acc[6] += w * s.gr[k];
        acc[7] += w * s.gg[k];
        acc[8] += w * s.gb[k];
        s.trans[k] = o.test_t;
        any = true;
      }
      if (o.trigger) s.done[k] = true;
    }
    if (__any_sync(kFull, any)) {
#pragma unroll
      for (int f = 0; f < kGrads; ++f) {
        float v = acc[f];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(kFull, v, off);
        acc[f] = v;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < kGrads; ++f) part[warp][f][j] = acc[f];
    }
  }
  bool live = false;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) live = live || !s.done[k];
  return live;
}

// Field f of pair j summed over the 8 warps, in a fixed order, with the
// conic scales (−½, −1, −½ on fields 2..4).
__device__ __forceinline__ float pair_sum(float (*part)[kGrads][kChunk], int f,
                                          int j) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[w][f][j];
  if (f == 2 || f == 4) s *= -0.5f;
  if (f == 3) s = -s;
  return s;
}

__global__ void __launch_bounds__(kThreads)
backward_kernel(const float* __restrict__ fields, const int* __restrict__ pg,
                const int* __restrict__ starts, const int* __restrict__ counts,
                const float* __restrict__ rgb, const float* __restrict__ final_t,
                const float* __restrict__ drgb, const float* __restrict__ dt,
                float* __restrict__ dfields, int ntx, int nrows) {
  __shared__ float sp[kStaged][kChunk];
  __shared__ float part[kWarps][kGrads][kChunk];
  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  BwdPixels s;
  init_backward(s, tile, ntx, rgb, final_t, drgb, dt);

  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    stage<true>(fields, pg, start + c0, n, nrows, sp);
    __syncthreads();
    const bool live = sweep_batch(s, sp, n, part);
    __syncthreads();
    // Cross-warp sums, then one atomic per field and pair.
    for (int idx = threadIdx.x; idx < n * kGrads; idx += kThreads) {
      const int f = idx / n;
      const int j = idx - f * n;
      const float v = pair_sum(part, f, j);
      if (v != 0.0f) {
        const int gid = static_cast<int>(sp[9][j]);
        if (static_cast<unsigned>(gid) < static_cast<unsigned>(nrows))
          atomicAdd(&dfields[static_cast<size_t>(gid) * kFields + f], v);
      }
    }
    if (!__syncthreads_or(live)) break;
  }
}

// K6: the per-pair gradient rows (P_pad, 16) of `rows`, each written once
// into its own slot.
__global__ void __launch_bounds__(kThreads)
backward_pairs_kernel(const float* __restrict__ rows,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      const float* __restrict__ rgb,
                      const float* __restrict__ final_t,
                      const float* __restrict__ drgb,
                      const float* __restrict__ dt, float* __restrict__ drows,
                      int ntx, int nrows) {
  __shared__ float sp[kStaged][kChunk];
  __shared__ float part[kWarps][kGrads][kChunk];
  const int tile = blockIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int aligned = (count + kChunk - 1) / kChunk * kChunk;
  BwdPixels s;
  init_backward(s, tile, ntx, rgb, final_t, drgb, dt);

  int c0 = 0;
  for (; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    stage<false>(rows, nullptr, start + c0, n, nrows, sp);
    __syncthreads();
    const bool live = sweep_batch(s, sp, n, part);
    __syncthreads();
    // The batch's 128 slots × 16 columns, consecutive threads on
    // consecutive floats; slots past `count` get zero rows.
    for (int idx = threadIdx.x; idx < kChunk * kFields; idx += kThreads) {
      const int j = idx / kFields;
      const int f = idx - j * kFields;
      float v = 0.0f;
      if (j < n) {
        if (f == 0 || f == 1) {
          // d mean = conic · (Σ dpower·dx, Σ dpower·dy), the pair's conic.
          const float m0 = pair_sum(part, 0, j), m1 = pair_sum(part, 1, j);
          v = f == 0 ? sp[2][j] * m0 + sp[3][j] * m1
                     : sp[3][j] * m0 + sp[4][j] * m1;
        } else if (f < kGrads) {
          v = pair_sum(part, f, j);
        }
      }
      const int slot = start + c0 + j;
      if (static_cast<unsigned>(slot) < static_cast<unsigned>(nrows))
        drows[static_cast<size_t>(slot) * kFields + f] = v;
    }
    if (!__syncthreads_or(live)) {
      c0 += kChunk;
      break;
    }
  }
  // Early exit: the rest of the tile's range gets zero rows.
  for (int idx = c0 * kFields + threadIdx.x; idx < aligned * kFields;
       idx += kThreads) {
    const size_t slot = static_cast<size_t>(start) + idx / kFields;
    if (slot < static_cast<size_t>(nrows))
      drows[slot * kFields + idx % kFields] = 0.0f;
  }
}

}  // namespace

extern "C" int yea_composite_forward(const float* fields, const int* pg,
                                     const int* starts, const int* counts,
                                     float* rgb, float* final_t,
                                     int* n_contrib, int num_tiles, int ntx,
                                     int nrows, void* stream) {
  if (num_tiles > 0)
    forward_kernel<true><<<num_tiles, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        fields, pg, starts, counts, rgb, final_t, n_contrib, ntx, nrows);
  return cudaGetLastError();
}

extern "C" int yea_composite_forward_rows(const float* rows, const int* starts,
                                          const int* counts, float* rgb,
                                          float* final_t, int* n_contrib,
                                          int num_tiles, int ntx, int nrows,
                                          void* stream) {
  if (num_tiles > 0)
    forward_kernel<false><<<num_tiles, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        rows, nullptr, starts, counts, rgb, final_t, n_contrib, ntx, nrows);
  return cudaGetLastError();
}

extern "C" int yea_composite_backward(const float* fields, const int* pg,
                                      const int* starts, const int* counts,
                                      const float* rgb, const float* final_t,
                                      const float* drgb, const float* dt,
                                      float* dfields, int num_tiles, int ntx,
                                      int nrows, void* stream) {
  if (num_tiles > 0)
    backward_kernel<<<num_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        fields, pg, starts, counts, rgb, final_t, drgb, dt, dfields, ntx, nrows);
  return cudaGetLastError();
}

extern "C" int yea_composite_backward_pairs(const float* rows, const int* starts,
                                            const int* counts, const float* rgb,
                                            const float* final_t,
                                            const float* drgb, const float* dt,
                                            float* drows, int num_tiles,
                                            int ntx, int nrows, void* stream) {
  if (num_tiles > 0)
    backward_pairs_kernel<<<num_tiles, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        rows, starts, counts, rgb, final_t, drgb, dt, drows, ntx, nrows);
  return cudaGetLastError();
}
