// Counting-sort pair layout on Hopper (kernels K3a and K3b).
//
// Replaces the Pallas kernels of youreditableavatar_tpu/ops/gaussian_raster/
// counting.py: `tile_histogram` (_hist_kernel) and `counting_layout`
// (_dst_kernel).
//
// What bounds them on the H100: both move a few bytes per pair (one int32
// read, one int32 write) and do almost no arithmetic, so device-memory
// bytes bound them — at the 512²/100k render, 184,320 pairs are ~0.7 MB
// each way, a fraction of a microsecond at 3.35 TB/s. In practice
// latency dominates: K3b's chain of look-backs over the blocks, and each
// block's global loads and barriers.
//
// Design:
//  * K3a: one CTA of 1024 threads per 4096 pairs; each thread reads four
//    pairs with one int4 load into the CTA's shared histogram. A warp
//    whose 32 pairs share one bin — the sentinel's runs: culled slots and
//    the slots past the total — adds them with one shared atomic, not 32
//    (`__all_sync` against lane 0's bin; grouping every bin with
//    `__match_any_sync` measured slower than it saved on the render's
//    pairs, which are mostly distinct within a warp). Each non-zero bin
//    then takes one global atomicAdd. The C entry clears the counts with
//    one cudaMemsetAsync on the stream (no state kept between calls).
//    Integer sums are exact, so the result is bit-exact whatever order
//    the atomics land in. The global atomics never bounded this kernel:
//    it is latency — the block's load, the shared atomics and the
//    barriers. A thread-block cluster of up to 8 CTAs reduced over
//    distributed shared memory (one global atomic per bin per cluster)
//    measured slower: each cluster barrier costs about as much as this
//    kernel's whole body (PERF.md).
//  * K3b: the rank of a pair must be stable in pair order and bit-identical
//    to the sort-based layout, so no atomics touch it. One pass: the TPU
//    kernel carries a per-bin running count from one grid step to the
//    next; here that count is a per-bin decoupled look-back (Merrill &
//    Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
//    2016).
//      (i)   Each CTA takes its block of 1024 pairs from an atomic ticket,
//            so every block it waits for already runs: no deadlock. 512
//            threads, two pairs a thread: four CTAs share an SM.
//      (ii)  Inside the block, `__match_any_sync` groups a warp's lanes by
//            bin and `__popc` of the lower-lane mask ranks them. Each group
//            of 32 pairs writes its per-bin counts to shared memory; one
//            pass per bin over the 32 groups turns them into the groups'
//            exclusive offsets and the block's aggregate. Where 33 ints a
//            bin do not fit (past `kPerWarpBins`), a shared histogram and
//            the groups' counts taken in order (one barrier a group) do the
//            same.
//      (iii) Each bin's aggregate is published in a status word (flag in
//            the top 2 bits, count below 2^30); then one thread per bin
//            walks back over the predecessors' words, `kLookahead` loads in
//            flight, adding aggregates until it meets an inclusive prefix,
//            and publishes its own.
//      (iv)  dst = astart_ext[bin] + exclusive prefix + in-block rank.
//    The status words must read "not ready" at the start of every call:
//    the C entry clears them with one cudaMemsetAsync on the stream. That
//    keeps no state between calls, so any stream, budget or bin count, and
//    a captured CUDA graph replayed any number of times, see cleared
//    words; an epoch tag would need the words kept between calls and a
//    host counter baked into each launch. The last block publishes
//    nothing, so the array holds (blocks − 1) · bins words and the ticket.
//    The TPU's one-hot MXU prefix sums have no counterpart here.
//  * The number of bins is a runtime argument (shared memory holds up to
//    58,112 int32 bins), so these serve tile grids past the TPU's 512.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;  // pairs per CTA of K3b; p is a multiple of it
constexpr int kMaxShared = 232448;  // a CTA's shared memory on sm_90
// K3b: 512 threads a CTA, two pairs a thread, so that four CTAs share an
// SM and a budget of up to 528 blocks runs in one wave on 132 SMs.
constexpr int kRankThreads = 512;
constexpr int kGroups = kBlock / 32;  // the block's warp-wide groups of pairs
// Bins up to which the per-group counts (kGroups + 1 ints a bin) are kept
// in shared memory, so that two CTAs or more share an SM.
constexpr int kPerWarpBins = 112 * 1024 / ((kGroups + 1) * 4);
constexpr unsigned kAggregate = 1u << 30;  // status flags (top two bits)
constexpr unsigned kPrefix = 2u << 30;
constexpr unsigned kCountMask = (1u << 30) - 1u;
constexpr int kLookahead = 4;  // status words in flight per look-back step

// Raise a kernel's dynamic shared-memory cap to the whole CTA's, once per
// kernel and device in the process.
cudaError_t allow_shared(const void* fn, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxShared);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

// K3a: 1024 threads a CTA, four pairs a thread (one int4 load).
constexpr int kHistThreads = 1024;
constexpr int kHistBlock = 4 * kHistThreads;  // pairs per CTA

// `quads` = p / 4 int4 words of tile ids; a warp's lanes lie all inside
// or all past them (p is a multiple of 1024).
__global__ void __launch_bounds__(kHistThreads)
hist_kernel(const int4* __restrict__ tile, int* __restrict__ counts,
            int quads, int nbins) {
  extern __shared__ int sh[];
  for (int i = threadIdx.x; i < nbins; i += kHistThreads) sh[i] = 0;
  __syncthreads();
  const int q = blockIdx.x * kHistThreads + threadIdx.x;
  if (q < quads) {  // uniform over the warp
    const int4 v = tile[q];
    const int t[4] = {v.x, v.y, v.z, v.w};
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int bin = t[r] >= 0 && t[r] < nbins ? t[r] : -1;
      // A warp whose 32 pairs share one bin (the sentinel's runs) adds
      // them with one atomic; otherwise each lane adds its own.
      if (__all_sync(0xffffffffu, bin == __shfl_sync(0xffffffffu, bin, 0))) {
        if (lane == 0 && bin >= 0) atomicAdd(&sh[bin], 32);
      } else if (bin >= 0) {
        atomicAdd(&sh[bin], 1);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += kHistThreads) {
    const int c = sh[i];
    if (c) atomicAdd(&counts[i], c);
  }
}

// The status words carry their flag and count in one 32-bit word, written
// by one store and read by one load, and no other data rides on them: the
// look-back needs each word whole, not an order against other memory, so
// relaxed gpu-scope accesses suffice (release / acquire fences measured
// slower on the H100).
__device__ __forceinline__ void publish(unsigned* word, unsigned value) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" :: "l"(word), "r"(value)
               : "memory");
}

__device__ __forceinline__ unsigned observe(const unsigned* word) {
  unsigned value;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(value) : "l"(word)
               : "memory");
  return value;
}

// Pairs of bin j in the blocks before block b: walk back from b − 1 over
// the status words, kLookahead loads in flight a step, adding aggregates
// until an inclusive prefix; a word not yet published is waited on alone.
__device__ int exclusive_prefix(const unsigned* status, int b, int j,
                                int nbins) {
  int excl = 0, k = b - 1;
  while (k >= 0) {
    unsigned w[kLookahead];
#pragma unroll
    for (int i = 0; i < kLookahead; ++i)
      w[i] = k - i >= 0 ? observe(status + static_cast<size_t>(k - i) * nbins + j)
                        : kPrefix;
    int taken = 0;
    bool prefix = false;
#pragma unroll
    for (int i = 0; i < kLookahead; ++i) {
      const unsigned flag = w[i] & ~kCountMask;
      if (taken == i && !prefix && flag != 0) {
        excl += static_cast<int>(w[i] & kCountMask);
        taken = i + 1;
        prefix = flag == kPrefix;
      }
    }
    if (prefix) break;
    k -= taken;
    if (taken < kLookahead) {
      const unsigned* word = status + static_cast<size_t>(k) * nbins + j;
      while ((observe(word) & ~kCountMask) == 0) {
      }
    }
  }
  return excl;
}

// One CTA per block of kBlock pairs, in ticket order. kPerWarp: each group
// of 32 pairs (a warp's lanes in one round) counts its bins into shared
// memory, and one pass per bin over the groups gives their offsets;
// otherwise a shared histogram, and the groups take their bins' running
// counts in order, one barrier a group.
template <bool kPerWarp>
__global__ void __launch_bounds__(kRankThreads, 2048 / kRankThreads)
rank_lookback_kernel(const int* __restrict__ tile,
                     const int* __restrict__ astart_ext,
                     unsigned* __restrict__ status, int* __restrict__ dst,
                     int p, int nbins, int nblocks) {
  constexpr int kWarps = kRankThreads / 32;
  constexpr int kRounds = kBlock / kRankThreads;  // pairs a thread
  extern __shared__ int sh[];
  int* base = sh;         // per bin: the block's aggregate, then its base
  int* cnt = sh + nbins;  // kPerWarp: (kGroups, nbins) per-group counts
  const int tid = threadIdx.x;
  if (tid == 0) sh[0] = static_cast<int>(
      atomicAdd(status + static_cast<size_t>(nblocks - 1) * nbins, 1u));
  __syncthreads();
  const int b = sh[0];
  __syncthreads();
  for (int i = tid; i < (kPerWarp ? kGroups : 1) * nbins; i += kRankThreads)
    (kPerWarp ? cnt : base)[i] = 0;
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  int t[kRounds], rank[kRounds];
  unsigned peers[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int idx = b * kBlock + r * kRankThreads + tid;
    t[r] = idx < p ? tile[idx] : -1;
    if (t[r] < 0 || t[r] >= nbins) t[r] = -1;  // out of range: no slot (dst 0)
    peers[r] = __match_any_sync(0xffffffffu, t[r]);
    rank[r] = __popc(peers[r] & ((1u << lane) - 1u));
    if (t[r] >= 0 && lane == __ffs(peers[r]) - 1) {
      if (kPerWarp) cnt[(r * kWarps + warp) * nbins + t[r]] = __popc(peers[r]);
      else atomicAdd(&base[t[r]], __popc(peers[r]));
    }
  }
  __syncthreads();

  // Each bin's aggregate (kPerWarp: the groups' counts become their
  // exclusive offsets in place), published before any look-back.
  for (int j = tid; j < nbins; j += kRankThreads) {
    int agg = kPerWarp ? 0 : base[j];
    if (kPerWarp) {
      for (int g = 0; g < kGroups; ++g) {
        const int c = cnt[g * nbins + j];
        cnt[g * nbins + j] = agg;
        agg += c;
      }
      base[j] = agg;
    }
    if (b < nblocks - 1)
      publish(status + static_cast<size_t>(b) * nbins + j,
              (b == 0 ? kPrefix : kAggregate) | static_cast<unsigned>(agg));
  }
  for (int j = tid; j < nbins; j += kRankThreads) {
    int excl = 0;
    if (b > 0) {
      excl = exclusive_prefix(status, b, j, nbins);
      if (b < nblocks - 1)
        publish(status + static_cast<size_t>(b) * nbins + j,
                kPrefix | static_cast<unsigned>(excl + base[j]));
    }
    base[j] = astart_ext[j] + excl;
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    int d = 0;
    if (kPerWarp) {
      if (t[r] >= 0) d = base[t[r]] + cnt[(r * kWarps + warp) * nbins + t[r]] + rank[r];
    } else {
      for (int w = 0; w < kWarps; ++w) {
        if (warp == w && t[r] >= 0) {
          const int before = base[t[r]];
          __syncwarp(peers[r]);
          if (lane == __ffs(peers[r]) - 1) base[t[r]] = before + __popc(peers[r]);
          d = before + rank[r];
        }
        __syncthreads();
      }
    }
    const int idx = b * kBlock + r * kRankThreads + tid;
    if (idx < p) dst[idx] = d;
  }
}

template <bool kPerWarp>
cudaError_t launch_ranks(const int* tile, const int* astart_ext, int* status,
                         int* dst, int p, int nbins, cudaStream_t s) {
  static unsigned long long shared_set = 0;
  const int nblocks = (p + kBlock - 1) / kBlock;
  if (nblocks == 0) return cudaGetLastError();
  auto* kernel = rank_lookback_kernel<kPerWarp>;
  cudaError_t err = allow_shared(reinterpret_cast<const void*>(kernel),
                                 &shared_set);
  if (err != cudaSuccess) return err;
  const size_t words = static_cast<size_t>(nblocks - 1) * nbins + 1;
  err = cudaMemsetAsync(status, 0, words * sizeof(int), s);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(nbins) * (kPerWarp ? kGroups + 1 : 1)
                      * sizeof(int);
  kernel<<<nblocks, kRankThreads, smem, s>>>(
      tile, astart_ext, reinterpret_cast<unsigned*>(status), dst, p, nbins,
      nblocks);
  return cudaGetLastError();
}

}  // namespace

// counts (nbins int32) = pairs per bin of the (p,) tile ids, p a multiple
// of 1024 and `tile` 16-byte aligned; the counts are cleared here on the
// stream.
extern "C" int yea_tile_histogram(const int* tile, int* counts, int p,
                                  int nbins, void* stream) {
  static unsigned long long shared_set = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_shared(reinterpret_cast<const void*>(hist_kernel),
                                 &shared_set);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(counts, 0, static_cast<size_t>(nbins) * sizeof(int), s);
  if (err != cudaSuccess) return err;
  const int nblocks = (p + kHistBlock - 1) / kHistBlock;
  if (nblocks > 0)
    hist_kernel<<<nblocks, kHistThreads, static_cast<size_t>(nbins) * sizeof(int),
                  s>>>(reinterpret_cast<const int4*>(tile), counts, p / 4, nbins);
  return cudaGetLastError();
}

// `status` holds (p / 1024 − 1) · nbins + 1 words, cleared here on the
// stream; dst = astart_ext[bin] + the pair's stable rank among its bin's
// pairs, in pair order.
extern "C" int yea_counting_layout(const int* tile, const int* astart_ext,
                                   int* status, int* dst, int p, int nbins,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbins <= kPerWarpBins)
    return launch_ranks<true>(tile, astart_ext, status, dst, p, nbins, s);
  return launch_ranks<false>(tile, astart_ext, status, dst, p, nbins, s);
}
