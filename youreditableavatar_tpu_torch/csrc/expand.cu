// Depth-ordered (tile, gaussian) pair expansion with the exact cull (K2).
//
// Replaces the Pallas kernel of youreditableavatar_tpu/ops/gaussian_raster/
// expand_pallas.py (`expand_pairs_pallas` → `_expand_kernel`).
//
// What bounds it on the H100: per pair slot it reads one 64-byte packed
// row (mostly from L2: consecutive slots share an owner) and writes two
// int32, with ~60 f32 operations for the cull — bytes bound it, about
// 7.9 MB at the 512²/100k render (6.4 MB table + 1.5 MB of outputs),
// ~2.4 µs at 3.35 TB/s; the binary search over the cumsum adds ~17
// dependent L2 reads per slot, which is what the design leaves to later.
//
// Design: one thread per pair slot. The owner is the first Gaussian whose
// int32 inclusive cumsum of tiles_touched exceeds the slot (binary search;
// the TPU design's windowed one-hot MXU search and `_exact_sel` bf16
// splits exist only to move exact f32 through bf16 matmuls and are not
// ported). The tile and the cull repeat `binning.tile_and_keep`'s f32
// expression tree op for op; this file is compiled with --fmad=false so no
// multiply-add is contracted, and division stays IEEE, which keeps the
// output bit-identical to the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// min over d_free ∈ [lo, hi] of a_fix·d² + 2b·d·d_free + a_free·d_free².
__device__ __forceinline__ float edge_m(float d, float lo, float hi,
                                        float a_fix, float a_free, float b) {
  const float d_free = clip(-b * d / fmaxf(a_free, (float)1e-12), lo, hi);
  return a_fix * d * d + 2.0f * b * d * d_free + a_free * d_free * d_free;
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const float* __restrict__ packed, const int* __restrict__ cum,
              int n, int* __restrict__ tile_out, int* __restrict__ gauss_out,
              int p, int ntx, int nty, int tile_size) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= p) return;
  const int sentinel = ntx * nty;
  const int total = n > 0 ? cum[n - 1] : 0;
  if (slot >= total) {
    tile_out[slot] = sentinel;
    gauss_out[slot] = 0;
    return;
  }
  // First owner whose inclusive cumsum exceeds the slot.
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum[mid] > slot) hi = mid; else lo = mid + 1;
  }
  const float* row = packed + static_cast<size_t>(lo) * kCols;
  const float local = static_cast<float>(slot - (lo > 0 ? cum[lo - 1] : 0));

  const float rect_x = row[1], rect_y = row[2], rect_w = row[3];
  const float mx = row[5], my = row[6];
  const float ca = row[7], cb = row[8], cc = row[9];
  const float two_l = row[10];

  const float r = floorf(local / rect_w);
  const float tx = rect_x + local - r * rect_w;
  const float ty = rect_y + r;
  const float tile_f = ty * static_cast<float>(ntx) + tx;

  const float ts = static_cast<float>(tile_size);
  const float x0 = tx * ts - mx;
  const float x1 = x0 + (ts - 1.0f);
  const float y0 = ty * ts - my;
  const float y1 = y0 + (ts - 1.0f);
  const float m = fminf(
      fminf(edge_m(x0, y0, y1, ca, cc, cb), edge_m(x1, y0, y1, ca, cc, cb)),
      fminf(edge_m(y0, x0, x1, cc, ca, cb), edge_m(y1, x0, x1, cc, ca, cb)));
  const bool inside = (x0 <= 0.0f) && (x1 >= 0.0f) && (y0 <= 0.0f) && (y1 >= 0.0f);
  const bool keep = inside || (m <= two_l);
  tile_out[slot] = keep ? static_cast<int>(tile_f) : sentinel;
  gauss_out[slot] = keep ? static_cast<int>(row[4]) : 0;
}

}  // namespace

extern "C" int yea_expand_pairs(const float* packed, const int* cum, int n,
                                int* tile, int* gauss, int p, int ntx,
                                int nty, int tile_size, void* stream) {
  const int blocks = (p + kThreads - 1) / kThreads;
  if (blocks > 0)
    expand_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, cum, n, tile, gauss, p, ntx, nty, tile_size);
  return cudaGetLastError();
}
