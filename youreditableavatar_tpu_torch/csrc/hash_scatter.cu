// Hash-grid table gradient on Hopper (kernel K4).
//
// Replaces the Pallas kernel of youreditableavatar_tpu/ops/hashgrid_pallas.py
// (`_scatter_kernel`, called through `hash_scatter_add`): the backward of the
// multiresolution hash encoding scatters one (v0, v1) row per (point, corner,
// level) into the (L, T, 2) f32 table gradient,
//
//     out[l, idx[l, r], :] += (v0[l, r], v1[l, r]),
//
// dropping rows whose index equals T (padding).
//
// What bounds it on the H100: every row reads 12 bytes (index + two values)
// and adds 8 bytes into a table that is far larger than L2 at the
// production 16 × 2^19 × 2 f32 (64 MiB), so device-memory bytes bound it;
// the adds themselves are negligible.
//
// Design (the tiny-cuda-nn backward, not the TPU's): one thread per
// (level, row) loads the index, skips the padding sentinel and adds its two
// values with one 8-byte vector atomicAdd on global memory (sm_90), or two
// scalar atomics where the toolkit's headers lack the float2 overload. The
// caller zeroes the table. The TPU kernel's VMEM-resident packed
// accumulator, SMEM row streams and double-buffered DMA have no
// counterpart: L2 and the atomics units do that job here.
//
// Float atomics land in an order that changes from run to run, so the
// result matches a sequential sum to rounding, not bit for bit. The dense
// coarse levels (level 0 has (16+1)^3 = 4,913 rows) take hundreds of adds
// per address per launch; pre-aggregating them in shared memory is left for
// a later change.

#include <cuda_runtime.h>

#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 ||      \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 3))
#define YEA_VECTOR_ATOMICS 1
#else
#define YEA_VECTOR_ATOMICS 0
#endif

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ idx, const float* __restrict__ v0,
               const float* __restrict__ v1, long long rows_per_level,
               long long total, int table_size, float2* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int row = idx[i];
    if (row < 0 || row >= table_size) continue;  // padding sentinel
    const long long level = i / rows_per_level;
    float2* dst = out + level * table_size + row;
#if YEA_VECTOR_ATOMICS && defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    atomicAdd(dst, make_float2(v0[i], v1[i]));
#else
    atomicAdd(&dst->x, v0[i]);
    atomicAdd(&dst->y, v1[i]);
#endif
  }
}

}  // namespace

// 1 when the kernel adds with one float2 atomic per row, 0 with two floats.
extern "C" int yea_hash_scatter_vector_atomics() { return YEA_VECTOR_ATOMICS; }

extern "C" int yea_hash_scatter(const int* idx, const float* v0,
                                const float* v1, int levels,
                                long long rows_per_level, int table_size,
                                float* out, void* stream) {
  const long long total = static_cast<long long>(levels) * rows_per_level;
  if (total > 0) {
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
    scatter_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        idx, v0, v1, rows_per_level, total, table_size,
        reinterpret_cast<float2*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
