// Counting-sort pair layout on Hopper (kernels K3a and K3b).
//
// Replaces the Pallas kernels of youreditableavatar_tpu/ops/gaussian_raster/
// counting.py: `tile_histogram` (_hist_kernel) and `counting_layout`
// (_dst_kernel).
//
// What bounds them on the H100: both move a few bytes per pair (one int32
// read, one int32 write) and do almost no arithmetic, so device-memory
// bytes bound them — at the 512²/100k render, 184,320 pairs are ~0.7 MB
// each way, a fraction of a microsecond at 3.35 TB/s, so in practice the
// launch and the block-level synchronisation dominate.
//
// Design:
//  * K3a: one CTA per 1024 pairs builds a shared-memory histogram with
//    shared-int atomics, then adds each non-zero bin to the global counts
//    with one atomicAdd. Integer sums are exact, so the result is bit-exact
//    whatever order the atomics land in.
//  * K3b: the rank of a pair must be stable in pair order and bit-identical
//    to the sort-based layout, so no atomics touch it:
//      (i)   per-block per-bin counts, stored as an (nblocks, nbins) matrix;
//      (ii)  one thread per bin scans its column over the blocks in order,
//            starting from aligned_start[bin] → each block's base per bin;
//      (iii) inside a block, `__match_any_sync` groups a warp's lanes by
//            bin and `__popc` of the lower-lane mask ranks them; the warps
//            then take their bins' running counts in warp order (one
//            barrier per warp), so ranks follow pair order exactly.
//    The TPU's one-hot MXU prefix sums have no counterpart here.
//  * The number of bins is a runtime argument (shared memory holds up to
//    58,112 int32 bins), so these serve tile grids past the TPU's 512.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;  // pairs per CTA
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

cudaError_t allow_shared(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

__device__ __forceinline__ void block_histogram(const int* tile, int p,
                                                int nbins, int* sh) {
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const int idx = blockIdx.x * kBlock + threadIdx.x;
  if (idx < p) {
    const int t = tile[idx];
    if (t >= 0 && t < nbins) atomicAdd(&sh[t], 1);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int* __restrict__ tile, int* __restrict__ counts, int p,
            int nbins) {
  extern __shared__ int sh[];
  block_histogram(tile, p, nbins, sh);
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    const int c = sh[i];
    if (c) atomicAdd(&counts[i], c);
  }
}

__global__ void __launch_bounds__(kThreads)
block_counts_kernel(const int* __restrict__ tile, int* __restrict__ mat,
                    int p, int nbins) {
  extern __shared__ int sh[];
  block_histogram(tile, p, nbins, sh);
  int* row = mat + static_cast<size_t>(blockIdx.x) * nbins;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) row[i] = sh[i];
}

// Column scan: mat[b, j] ← astart_ext[j] + Σ_{b' < b} count[b', j].
__global__ void column_scan_kernel(int* __restrict__ mat,
                                   const int* __restrict__ astart_ext,
                                   int nblocks, int nbins) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nbins) return;
  int run = astart_ext[j];
  for (int b = 0; b < nblocks; ++b) {
    int* cell = mat + static_cast<size_t>(b) * nbins + j;
    const int c = *cell;
    *cell = run;
    run += c;
  }
}

__global__ void __launch_bounds__(kThreads)
rank_dst_kernel(const int* __restrict__ tile, const int* __restrict__ base,
                int* __restrict__ dst, int p, int nbins) {
  extern __shared__ int run[];
  const int* row = base + static_cast<size_t>(blockIdx.x) * nbins;
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) run[i] = row[i];
  __syncthreads();

  const int idx = blockIdx.x * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int t = idx < p ? tile[idx] : -1;
  if (t >= nbins) t = -1;  // out-of-range ids take no slot (dst 0)
  const unsigned peers = __match_any_sync(0xffffffffu, t);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int leader = __ffs(peers) - 1;
  int d = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && t >= 0) {
      const int before = run[t];
      __syncwarp(peers);
      if (lane == leader) run[t] = before + __popc(peers);
      d = before + rank;
    }
    __syncthreads();
  }
  if (idx < p) dst[idx] = d;
}

}  // namespace

extern "C" int yea_tile_histogram(const int* tile, int* counts, int p,
                                  int nbins, void* stream) {
  const size_t smem = static_cast<size_t>(nbins) * sizeof(int);
  cudaError_t err = allow_shared(reinterpret_cast<const void*>(hist_kernel), smem);
  if (err != cudaSuccess) return err;
  const int nblocks = (p + kBlock - 1) / kBlock;
  if (nblocks > 0)
    hist_kernel<<<nblocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        tile, counts, p, nbins);
  return cudaGetLastError();
}

extern "C" int yea_counting_layout(const int* tile, const int* astart_ext,
                                   int* scratch, int* dst, int p, int nbins,
                                   void* stream) {
  const size_t smem = static_cast<size_t>(nbins) * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_shared(reinterpret_cast<const void*>(block_counts_kernel), smem);
  if (err != cudaSuccess) return err;
  err = allow_shared(reinterpret_cast<const void*>(rank_dst_kernel), smem);
  if (err != cudaSuccess) return err;
  const int nblocks = (p + kBlock - 1) / kBlock;
  if (nblocks == 0) return cudaGetLastError();
  block_counts_kernel<<<nblocks, kThreads, smem, s>>>(tile, scratch, p, nbins);
  column_scan_kernel<<<(nbins + 255) / 256, 256, 0, s>>>(scratch, astart_ext,
                                                         nblocks, nbins);
  rank_dst_kernel<<<nblocks, kThreads, smem, s>>>(tile, scratch, dst, p, nbins);
  return cudaGetLastError();
}
