// Depth-ordered (tile, gaussian) pair expansion with the exact cull (K2).
//
// Replaces the Pallas kernel of youreditableavatar_tpu/ops/gaussian_raster/
// expand_pallas.py (`expand_pairs_pallas` → `_expand_kernel`).
//
// What bounds it on the H100: per pair slot it writes two int32 and reads
// its owner's packed row, with ~60 f32 operations for the cull — bytes
// bound it, about 7.9 MB at the 512²/100k render (6.4 MB table + 1.5 MB of
// outputs), ~2.4 µs at 3.35 TB/s. What kept the first port far from that
// was finding each slot's owner: a 17-step binary search over the whole
// int32 cumsum in global memory, per slot.
//
// Design: one CTA per 1024 pair slots, one thread per slot. The table is
// in depth order with the rows that touch no tile last
// (`binning.pack_depth_ordered`), so every row before them owns at least
// one slot, and the owners of a block's slots form one contiguous window
// [lo, hi] of at most 1024 rows (the TPU kernel's windowed DMA rests on
// the same fact).
//  * A block whose first slot is at or past the pre-cull total writes its
//    sentinel tiles and zero ids with 16-byte stores and returns.
//  * Otherwise warp 0 finds lo (the owner of the first slot) and warp 1 hi
//    (the owner of the block's last slot below the total), each with a
//    32-way search: 32 probes a round, the next range from a ballot, four
//    rounds of L2 latency over a 100k-row table.
//  * The block stages the window's cumsum and the owners' fields (columns
//    1–10) in shared memory with coalesced loads; each thread finds its
//    owner by a binary search in shared memory and reads its fields there.
//    A window wider than 1024 rows (only where zero-pair rows are not all
//    at the tail) is staged in turns, so any table gives the same output.
// The TPU design's one-hot MXU selects and bf16 splits exist only to move
// exact f32 through bf16 matmuls and are not ported. The tile and the cull
// repeat `binning.tile_and_keep`'s f32 expression tree op for op; this
// file is compiled with --fmad=false so no multiply-add is contracted, and
// division stays IEEE, which keeps the output bit-identical to the plain
// PyTorch version (Gaussian id 0 on culled slots, the sentinel past the
// total). The cumsum stays outside the kernel, as in the JAX package.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;
constexpr int kSlots = 1024;  // pair slots per CTA, one thread each
constexpr int kFields = 10;   // packed columns 1..10 staged per owner

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// min over d_free ∈ [lo, hi] of a_fix·d² + 2b·d·d_free + a_free·d_free².
__device__ __forceinline__ float edge_m(float d, float lo, float hi,
                                        float a_fix, float a_free, float b) {
  const float d_free = clip(-b * d / fmaxf(a_free, (float)1e-12), lo, hi);
  return a_fix * d * d + 2.0f * b * d * d_free + a_free * d_free * d_free;
}

// Smallest i in [a, b) with cum[i] > key, for the whole warp; requires
// cum[b - 1] > key. Each round probes 32 evenly spaced positions and keeps
// the stretch between the last probe at or below the key and the next one.
__device__ int first_above(const int* __restrict__ cum, int a, int b, int key,
                           int lane) {
  while (b - a > 32) {
    const int step = (b - a + 31) / 32;
    const int pos = a + lane * step;
    const bool above = pos >= b || __ldg(cum + pos) > key;
    const int below = __popc(~__ballot_sync(0xffffffffu, above));
    if (below == 0) return a;
    const int na = a + (below - 1) * step + 1;
    b = min(a + below * step + 1, b);
    a = na;
  }
  const int pos = a + lane;
  const bool above = pos >= b || __ldg(cum + pos) > key;
  return a + __popc(~__ballot_sync(0xffffffffu, above));
}

__global__ void __launch_bounds__(kSlots)
expand_window_kernel(const float* __restrict__ packed,
                     const int* __restrict__ cum, int n,
                     int* __restrict__ tile_out, int* __restrict__ gauss_out,
                     int ntx, int nty, int tile_size) {
  __shared__ int s_cum[kSlots];
  __shared__ float s_rows[kFields][kSlots];
  __shared__ int s_span[2];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kSlots;
  const int sentinel = ntx * nty;
  const int total = n > 0 ? __ldg(cum + n - 1) : 0;
  if (first >= total) {
    if (tid < kSlots / 4) {
      reinterpret_cast<int4*>(tile_out + first)[tid] =
          make_int4(sentinel, sentinel, sentinel, sentinel);
      reinterpret_cast<int4*>(gauss_out + first)[tid] = make_int4(0, 0, 0, 0);
    }
    return;
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (warp < 2) {
    const int key = warp == 0 ? first : min(first + kSlots, total) - 1;
    const int owner = first_above(cum, 0, n, key, lane);
    if (lane == 0) s_span[warp] = owner;
  }
  __syncthreads();
  const int lo = s_span[0], hi = s_span[1];
  const int slot = first + tid;
  bool done = slot >= total;
  if (done) {
    tile_out[slot] = sentinel;
    gauss_out[slot] = 0;
  }
  for (int base = lo; base <= hi; base += kSlots) {
    const int width = min(kSlots, hi + 1 - base);
    if (tid < width) {
      s_cum[tid] = __ldg(cum + base + tid);
      const float4* row =
          reinterpret_cast<const float4*>(packed + static_cast<size_t>(base + tid) * kCols);
      const float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2);
      s_rows[0][tid] = q0.y;  // rect_x
      s_rows[1][tid] = q0.z;  // rect_y
      s_rows[2][tid] = q0.w;  // rect_w
      s_rows[3][tid] = q1.x;  // original index
      s_rows[4][tid] = q1.y;  // mean x
      s_rows[5][tid] = q1.z;  // mean y
      s_rows[6][tid] = q1.w;  // conic a
      s_rows[7][tid] = q2.x;  // conic b
      s_rows[8][tid] = q2.y;  // conic c
      s_rows[9][tid] = q2.z;  // 2·ln(255·op)
    }
    const int prev = base > 0 ? __ldg(cum + base - 1) : 0;
    __syncthreads();
    if (!done && slot < s_cum[width - 1]) {
      int a = 0, b = width - 1;  // first staged row whose cumsum exceeds the slot
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (s_cum[mid] > slot) b = mid; else a = mid + 1;
      }
      const float local = static_cast<float>(slot - (a > 0 ? s_cum[a - 1] : prev));
      auto field = [&](int c) { return s_rows[c - 1][a]; };  // column c
      const float rect_x = field(1), rect_y = field(2), rect_w = field(3);
      const float mx = field(5), my = field(6);
      const float ca = field(7), cb = field(8), cc = field(9);
      const float two_l = field(10);

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
      gauss_out[slot] = keep ? static_cast<int>(field(4)) : 0;
      done = true;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int yea_expand_pairs(const float* packed, const int* cum, int n,
                                int* tile, int* gauss, int p, int ntx,
                                int nty, int tile_size, void* stream) {
  if (p % kSlots != 0) return cudaErrorInvalidValue;
  const int blocks = p / kSlots;
  if (blocks > 0)
    expand_window_kernel<<<blocks, kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, cum, n, tile, gauss, ntx, nty, tile_size);
  return cudaGetLastError();
}
