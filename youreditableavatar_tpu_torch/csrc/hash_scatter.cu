// Hash-grid table gradient on Hopper (kernel K4).
//
// Replaces the Pallas kernel of youreditableavatar_tpu/ops/hashgrid_pallas.py
// (`_scatter_kernel`, called through `hash_scatter_add`): the backward of the
// multiresolution hash encoding scatters one (v0, v1) row per (point, corner,
// level) into the (L, T, 2) f32 table gradient,
//
//     out[l, idx[l, r], :] += (v0[l, r], v1[l, r]),
//
// dropping rows whose index is out of [0, T) (T is the padding sentinel).
//
// What bounds it on the H100: device-memory bytes — 12 bytes read a row
// (index + two values) and the table written once (64 MiB at the
// production 16 × 2^19 × 2 f32, larger than the 50 MB L2, zeroed by the
// caller); the adds are negligible as operations. What takes the time is
// the atomics: one 8-byte reduction a row at ~7·10¹⁰ a second, and on the
// coarse dense levels hundreds to thousands of rows onto one address.
//
// Design, from the measured split of the one-thread-a-row kernel (H100
// 80GB HBM3, 700 W; 16 × 524,288 rows): zero fill 0.030 ms, dense levels
// 0–4 0.046 ms (0.082 on points of a sphere shell in grid order, level 0
// alone 0.056), hashed levels 5–15 0.091 ms. One thread a row, as many
// CTAs as rows need, so the scheduler walks the rows level-major and each
// level's 4 MiB slice is hot in L2 while its rows land. Where neighbouring
// points share corners, a warp whose rows repeat — some row equals the
// one eight lanes on, the same corner of the next point — first sums its
// rows per address (`__match_any_sync` and a shuffle tree) and one lane
// adds each sum; a warp without repeats pays one shuffle and one vote.
// Tried and measured slower on the card, so not kept: shared-memory
// privatization of levels 0–1 (16 CTAs a level, flushed once a row), rows
// paired into float4 atomics, and persistent CTAs that zero each level in
// L2 just ahead of its adds (work tickets).
//
// Float atomics land in an order that changes from run to run, so the
// result matches a sequential sum to rounding, not bit for bit. The TPU
// kernel's VMEM-resident packed accumulator, SMEM row streams and
// double-buffered DMA have no counterpart: L2 and the atomics units do
// that job here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Sum `v` over the lanes whose key equals this lane's (`peers`); true on
// the lowest such lane, which then holds the sum (NVIDIA's reduce_peers:
// log2 of the group's size shuffle rounds).
__device__ __forceinline__ bool reduce_peers(unsigned peers, float2& v) {
  const int lane = threadIdx.x & 31;
  const bool leader = (__ffs(peers) - 1) == lane;
  unsigned rel = lane == 0 ? 0u : __popc(peers << (32 - lane));
  peers &= (0xfffffffeu << lane);  // the peers above this lane
  while (__any_sync(kFull, peers != 0u)) {
    const int next = __ffs(peers);
    const float a = __shfl_sync(kFull, v.x, (next - 1) & 31);
    const float b = __shfl_sync(kFull, v.y, (next - 1) & 31);
    if (next) {
      v.x += a;
      v.y += b;
    }
    peers &= __ballot_sync(kFull, !(rel & 1u));
    rel >>= 1;
  }
  return leader;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ idx, const float* __restrict__ v0,
               const float* __restrict__ v1, long long rows_per_level,
               long long total, int table_size, float2* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int row = -1, level = 0;
  float2 v = make_float2(0.0f, 0.0f);
  if (i < total) {
    row = idx[i];
    v = make_float2(v0[i], v1[i]);
    level = static_cast<int>(i / rows_per_level);
  }
  const bool ok = static_cast<unsigned>(row) < static_cast<unsigned>(table_size);
  // Rows r and r + 8 are one corner of two neighbouring points: the warp
  // aggregates only where some such pair is equal (a cheap test first).
  const int lane = threadIdx.x & 31;
  const int ahead = __shfl_down_sync(kFull, row, 8);
  bool lead = true;
  if (__any_sync(kFull, ok && lane < 24 && ahead == row)) {
    // every lane takes part in the match
    const unsigned long long key =
        ok ? (static_cast<unsigned long long>(level) << 32) | static_cast<unsigned>(row)
            : ~0ull - lane;  // alone in its group
    lead = reduce_peers(__match_any_sync(kFull, key), v);
  }
  if (ok && lead)
    atomicAdd(out + static_cast<long long>(level) * table_size + row, v);
}

}  // namespace

extern "C" int yea_hash_scatter(const int* idx, const float* v0,
                                const float* v1, int levels,
                                long long rows_per_level, int table_size,
                                float* out, void* stream) {
  const long long total = static_cast<long long>(levels) * rows_per_level;
  if (total > 0)
    scatter_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        idx, v0, v1, rows_per_level, total, table_size,
        reinterpret_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}
