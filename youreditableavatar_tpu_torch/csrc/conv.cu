// f32 2-D convolution on Hopper as an implicit GEMM (kernel K7).
//
// Replaces no Pallas kernel: the JAX package spells the guidance networks'
// convolutions as shifted matmuls for XLA
// (youreditableavatar_tpu/guidance/sd_layers.py `conv2d`). Here they run as
// one hand-written implicit GEMM under `sd_layers.conv2d` for CUDA tensors,
// in two entry points that share their kernels:
//
//  * K7f, forward: C[M, N] = A[M, K] · B[K, N] with M = batch·Ho·Wo output
//    pixels, N = Cout and K = R·S·Cin. A row is gathered from the NHWC
//    activation (zero outside the image: SAME, VALID and asymmetric pads and
//    the stride live in the index arithmetic, no padded copy); B is the HWIO
//    weight read in place, a row-major (K, Cout) matrix.
//  * K7d, input gradient: stride 1 is the same GEMM over dY with the taps
//    flipped (R−1−r, S−1−s) and Cout as the reduction axis, the same HWIO
//    weight read transposed in place. Stride 2 splits dX by output parity
//    into four such sub-problems (phase split), each with its own taps and
//    gather, all in one launch (blockIdx.z).
//
// What bounds it on the H100: operations. The networks' shapes carry
// 2·M·N·K f32 operations against a few bytes each (K ≥ 288 on every shape
// that matters), so the least time is 2·M·N·K at 67 TFLOP/s. The
// configuration runs f32 with TF32 off, so the tensor cores are out: the
// kernel multiplies with FFMA alone, and the FFMA warps' issue slots are
// what there is to save.
//
// Kernels, by what the call shows (the wrapper chooses):
//  * `conv_ws_kernel`, warp-specialised, where the reduction channels are
//    a multiple of 32 (a K tile lies in one tap) and the output columns a
//    multiple of 4: every convolution of the networks but those of 3, 4, 8
//    or 16 reduction channels (conv_in, ControlNet's condition embedding)
//    and those with at most 8 outputs (121 of the SDS step's 126 forward
//    calls and 25 of its 28 input gradients).
//    - Block tiles of 128×128 (a producer warpgroup and two consumer
//      warpgroups, 384 threads, one block an SM) or 128×64 (one consumer
//      warpgroup, 256 threads, two blocks an SM), BK 32.
//    - The producer warpgroup issues every load of a K tile into a ring of
//      6 (128×128) or 4 (128×64) stages. B, a plain 2-D tile of the
//      (R·S·C, N) weight matrix, comes by one TMA copy from one thread:
//      K7f reads the HWIO weight as it lies, K7d its (R, S, Cout, Cin) copy
//      (made once per weight by the wrapper), so both read B N-major. A,
//      the gathered activation rows, comes by 16-byte cp.async copies (8 a
//      thread a tile, zero-filled outside the image), whose address
//      arithmetic is all the producer's. A stage's `full` mbarrier counts
//      the TMA's bytes and each producer thread's cp.async arrival
//      (`.noinc`).
//    - The consumer warps compute no address and issue no copy: wait on
//      `full`, read the stage, run FFMA into an 8×8 register tile, and
//      each warp arrives on the stage's `empty` mbarrier, which the
//      producer waits on before it reuses the stage. Their loop is 90%
//      FFMA (the tiled loop's 73–76%).
//    - `setmaxnreg` moves registers from the producer (40) to the
//      consumers (232 of 128×128's 168 a thread at launch; 216 of
//      128×64's 128): the 8×8 tile and its partial sums alone are 128.
//      Nothing on either path may trap: ptxas then gives the consumers no
//      more registers than the launch, and they spill.
//    - Shared memory: A K-contiguous, rows padded to BK + 4 floats, read
//      as float4 along K by rows tm + 16·i (a warp touches two rows,
//      conflict-free); B as the TMA writes it, rows of BN, a thread reading
//      columns g·BN/2 + 4·tn + (0..3) as two float4 a k.
//    - What bounds it now is inside the FFMA issue: at 1,980 MHz and
//      200–350 W the loop runs at 58–62% of 67 TFLOP/s. Halving its shared-
//      memory loads changed nothing. Suspected: register-bank conflicts (a
//      third of the FFMA read two register-file operands of one parity; the
//      B operand's is fixed by its LDS.128, the partial sum's is ptxas's).
//  * `conv_kernel`, the tiled loop for the rest (Cin 3, 4, 8 or 16): the
//    same tiles and register tile, every thread both copying and
//    computing through a four-stage cp.async ring, one barrier a K tile;
//    each element copies alone with its own tap, out-of-image and
//    out-of-range elements as zeros (cp.async's source size 0).
//  * `small_n_kernel`: at most 8 output channels (conv_in's input
//    gradient, conv_out, the VAE's 1×1 quant) take a warp an output pixel,
//    where a 64-wide tile would compute padding.
//  * Shape-adapted (the wrapper chooses from M, N, K as the call observes
//    them): tile shape and a split-K factor. Split-K writes partial sums to
//    a workspace the wrapper allocates; `reduce_kernel` adds them in split
//    order and adds the bias.
//
// Numerics, the same in both tiled kernels: each K tile's 32 products go
// into a fresh partial sum, one sequential FFMA chain in ascending k
// (tap-major, then channel), and the partials add into the output's sum in
// tile order: a two-level sum whose rounding error grows about 3× slower
// with K than one long chain, which keeps K7's error at or under cuDNN's
// own at the networks' shapes. The split partials are added in ascending
// split order, then the bias. None of it depends on which thread owns an
// element, so the warp-specialised kernel gives the tiled loop's bits. The
// small-N kernel's lanes each sum their channels in K order, then a fixed
// butterfly adds the lanes. No atomics, no tensor-core instruction, no
// operand narrower than f32: the result is the same bits on every run of a
// shape.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kMaxSubs = 4;
constexpr int kLdK = kBK + 4;  // K-contiguous rows, in floats

struct Sub {
  int M;                 // batch · out_h · out_w GEMM rows
  int out_h, out_w;      // the GEMM's row grid
  int pad_h, pad_w;      // gathered pixel = out · stride − pad + tap
  int taps_r, taps_s;    // taps of this sub-problem
  int w_r0, w_rstep;     // weight row of tap t: w_r0 + w_rstep · t
  int w_s0, w_sstep;     // weight column of tap t: w_s0 + w_sstep · t
  int o_stride, o_y, o_x;  // output pixel = out · o_stride + (o_y, o_x)
};

struct Params {
  const float* a;     // (batch, in_h, in_w, C) gathered operand
  const float* w;     // HWIO (wR, wS, wCin, wCout); for the warp-specialised
                      // K7d its (wR, wS, wCout, wCin) copy
  const float* bias;  // (N) or null
  float* out;         // (batch, full_h, full_w, N)
  float* ws;          // (splits, M, N) partial sums, when splits > 1
  int in_h, in_w, C;  // C: the reduction channels (Cin forward, Cout dgrad)
  int stride;
  int N;              // GEMM columns (Cout forward, Cin dgrad)
  int wR, wS, wCin, wCout;
  int full_h, full_w;
  int splits, kps;    // split-K factor and K tiles a split
  Sub sub[kMaxSubs];
};

// The warp-specialised kernel's parameters: the weight's tensor map rides
// in the kernel's parameter space (by value, so a CUDA graph keeps it).
struct WsParams {
  Params p;
  CUtensorMap wmap;
};

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

// The arrival of this thread's earlier cp.async copies, when they land.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete. (No trap on a long
// wait: a path that can trap shares its code with both roles, and ptxas
// then allocates the consumers no more registers than the launch gives.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

template <int BM, int BN, bool DGRAD>
struct Shape {
  static constexpr int kThreads = (BM / 8) * (BN / 8);
  static constexpr int kLdN = BN + 4;          // K7f's Cout-contiguous B rows
  static constexpr int kBFloats = DGRAD ? BN * kLdK : kBK * kLdN;
  static constexpr int kStageFloats = BM * kLdK + kBFloats;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4 + BM * 16;
};

// The warp-specialised kernel's block: BM = 128 rows, BN columns.
constexpr int kProducers = 128;  // one warpgroup
constexpr int kProducerRegs = 40;

template <int BN>
struct WsShape {
  static constexpr int kConsumers = 2 * BN;  // (128 / 8) · (BN / 8) threads
  static constexpr int kThreads = kProducers + kConsumers;
  static constexpr int kBlocks = BN == 128 ? 1 : 2;  // resident an SM
  // Registers a thread at launch (of 65,536 an SM), and the consumers'
  // once the producer has handed back all but kProducerRegs of its own.
  static constexpr int kLaunchRegs = 65536 / (kBlocks * kThreads) / 8 * 8;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads - kProducers * kProducerRegs) / kConsumers / 8 * 8;
  static constexpr int kStages = BN == 128 ? 6 : 4;
  static constexpr int kAFloats = 128 * kLdK;
  static constexpr int kBFloats = kBK * BN;  // dense: as the TMA writes it
  static constexpr int kStageFloats = kAFloats + kBFloats;
  static constexpr int kRowsOff = kStages * kStageFloats * 4;  // bytes
  static constexpr int kBarOff = kRowsOff + 128 * 16;
  // 128 bytes over: the base is rounded up to the TMA's 128-byte alignment.
  static constexpr int kSmemBytes = kBarOff + 2 * kStages * 8 + 128;
  static_assert(kAFloats * 4 % 128 == 0 && kStageFloats * 4 % 128 == 0,
                "every stage's B lies on the TMA's 128-byte alignment");
};

// Where the next K tile starts when it lies in one tap: channel c0 of tap
// (r, s). Loads walk the tiles in order, so it advances without division.
struct Cursor {
  int c0, r, s;
  __device__ __forceinline__ Cursor(int k0, int C, int taps_s) {
    const int rs = k0 / C;
    c0 = k0 - rs * C;
    r = rs / taps_s;
    s = rs - r * taps_s;
  }
  __device__ __forceinline__ void next(int C, int taps_s) {
    c0 += kBK;
    if (c0 == C) {
      c0 = 0;
      if (++s == taps_s) {
        s = 0;
        ++r;
      }
    }
  }
};

__device__ __forceinline__ Sub pick_sub(const Params& p, int i) {
  switch (i) {  // constant indices keep the parameters in param space
    case 0: return p.sub[0];
    case 1: return p.sub[1];
    case 2: return p.sub[2];
    default: return p.sub[3];
  }
}

// A block's gathered row `m`: first input pixel and the image's offset;
// rows past M gather nothing (their pixel lies far outside the image).
__device__ __forceinline__ int4 gather_row(const Params& p, const Sub& sb,
                                           int m) {
  if (m >= sb.M) return make_int4(-(1 << 29), -(1 << 29), 0, 0);
  const int hw = sb.out_h * sb.out_w;
  const int b = m / hw, rem = m - b * hw;
  const int oh = rem / sb.out_w, ow = rem - oh * sb.out_w;
  return make_int4(oh * p.stride - sb.pad_h, ow * p.stride - sb.pad_w,
                   b * p.in_h * p.in_w * p.C, 0);
}

// One thread's 8×8 register tile of the output: row m0 + tm + TMT·i,
// column `col(j)`; to the workspace of its split or, with the bias, to the
// output pixel.
template <int TMT, typename Col>
__device__ __forceinline__ void store_tile(const Params& p, const Sub& sb,
                                           int m0, int tm, int split,
                                           const float (&acc)[8][8], Col col) {
  const int hw = sb.out_h * sb.out_w;
  const bool add_bias = p.splits == 1 && p.bias != nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm + TMT * i;
    if (m >= sb.M) continue;
    float* dst;
    if (p.splits > 1) {
      dst = p.ws + (static_cast<long long>(split) * sb.M + m) * p.N;
    } else {
      const int b = m / hw, rem = m - b * hw;
      const int oh = rem / sb.out_w, ow = rem - oh * sb.out_w;
      const int y = oh * sb.o_stride + sb.o_y, x = ow * sb.o_stride + sb.o_x;
      dst = p.out + (static_cast<long long>(b * p.full_h + y) * p.full_w + x) * p.N;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col(j);
      if (c < p.N) dst[c] = add_bias ? acc[i][j] + p.bias[c] : acc[i][j];
    }
  }
}

// One K tile's products for a thread's 8×8 register tile: rows
// tm + TMT·i of A (K-contiguous rows of kLdK), columns of B — N-major (B row
// k at Bs + k·LDB): columns 4·tn + (0..3) and BN/2 + 4·tn + (0..3);
// K-major: column tn + (BN/8)·j at Bs + (tn + (BN/8)·j)·LDB. Each product sum
// runs in ascending k from its first product, one FFMA chain, into `part`.
template <int TMT, int BN, int LDB, bool KMAJOR>
__device__ __forceinline__ void tile_products(const float* As, const float* Bs,
                                              int tm, int tn,
                                              float (&part)[8][8]) {
  constexpr int TNT = BN / 8;
#pragma unroll
  for (int kq = 0; kq < kBK / 4; ++kq) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(As + (tm + TMT * i) * kLdK + kq * 4);
    if constexpr (KMAJOR) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bs + (tn + TNT * j) * LDB + kq * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = kq == 0 ? a[i].x * b[j].x : fmaf(a[i].x, b[j].x, part[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i].y, b[j].y, part[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i].z, b[j].z, part[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(a[i].w, b[j].w, part[i][j]);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bs + (kq * 4 + kk) * LDB + tn * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + BN / 2);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ai = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            part[i][j] = (kq == 0 && kk == 0) ? ai * b[j]
                                              : fmaf(ai, b[j], part[i][j]);
        }
      }
    }
  }
}

// ------------------------------------------------- the warp-specialised loop

template <int BN, bool DGRAD>
__global__ void __launch_bounds__(WsShape<BN>::kThreads, WsShape<BN>::kBlocks)
conv_ws_kernel(const __grid_constant__ WsParams q) {
  using S = WsShape<BN>;
  constexpr int TNT = BN / 8;  // consumer threads along N
  constexpr int TMT = 16;      // along M
  const Params& p = q.p;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Up to the TMA's 128-byte alignment, by an offset from the shared array
  // (so its loads stay shared-memory loads).
  unsigned char* base = smem_raw + ((128u - (smem_addr(smem_raw) & 127u)) & 127u);
  float* smem = reinterpret_cast<float*>(base);
  int4* rows = reinterpret_cast<int4*>(base + S::kRowsOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBarOff);
  uint64_t* empty = full + S::kStages;

  const int tid = threadIdx.x;
  const int sub_i = blockIdx.z / p.splits;
  const int split = blockIdx.z - sub_i * p.splits;
  const Sub sb = pick_sub(p, sub_i);
  const int m0 = blockIdx.x * 128;
  if (m0 >= sb.M) return;  // a smaller phase of the input gradient
  const int n0 = blockIdx.y * BN;
  const int K = sb.taps_r * sb.taps_s * p.C;
  const int ktiles = (K + kBK - 1) / kBK;
  const int kt0 = split * p.kps;
  const int nkt = max(0, min(ktiles, kt0 + p.kps) - kt0);

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], kProducers + 1);  // each cp.async thread + the TMA's
      mbar_init(&empty[s], S::kConsumers / 32);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < kProducers) {
    // Producer: the gather's address arithmetic, the copies, nothing else.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    rows[tid] = gather_row(p, sb, m0 + tid);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
    const int kq = tid % (kBK / 4);  // this thread's 16-byte column of A
    const int r0 = tid / (kBK / 4);
    Cursor at(kt0 * kBK, p.C, max(sb.taps_s, 1));
    int s = 0, round = 0;
    for (int t = 0; t < nkt; ++t) {
      if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
      float* As = smem + s * S::kStageFloats;
      float* Bs = As + S::kAFloats;
      if (tid == 0) {
        mbar_arrive_expect_tx(&full[s], S::kBFloats * 4);
        if constexpr (DGRAD) {
          // The (wR·wS·Cout, Cin) copy: the K tile is rows c0.. of its tap.
          const int wr = sb.w_r0 + sb.w_rstep * at.r, wc = sb.w_s0 + sb.w_sstep * at.s;
          tma_load_2d(Bs, &q.wmap, &full[s], n0, (wr * p.wS + wc) * p.C + at.c0);
        } else {
          tma_load_2d(Bs, &q.wmap, &full[s], n0, (kt0 + t) * kBK);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = r0 + 16 * i;
        const int4 rw = rows[row];
        const int ih = rw.x + at.r, iw = rw.y + at.s;
        const bool ok = static_cast<unsigned>(ih) < static_cast<unsigned>(p.in_h) &&
                        static_cast<unsigned>(iw) < static_cast<unsigned>(p.in_w);
        const float* src =
            ok ? p.a + rw.z + (ih * p.in_w + iw) * p.C + at.c0 + kq * 4 : p.a;
        cp_async16(As + row * kLdK + kq * 4, src, ok);
      }
      mbar_arrive_cp_async(&full[s]);
      at.next(p.C, sb.taps_s);
      if (++s == S::kStages) {
        s = 0;
        ++round;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // Consumers: wait, read shared memory, FFMA.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
    const int c = tid - kProducers;
    const int tn = c % TNT, tm = c / TNT;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    int s = 0, round = 0;
    for (int t = 0; t < nkt; ++t) {
      mbar_wait(&full[s], round & 1);
      const float* As = smem + s * S::kStageFloats;
      const float* Bs = As + S::kAFloats;
      float part[8][8];  // this K tile's sums
      tile_products<TMT, BN, BN, false>(As, Bs, tm, tn, part);
      __syncwarp();
      if ((c & 31) == 0) mbar_arrive(&empty[s]);  // this warp is done with it
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
      if (++s == S::kStages) {
        s = 0;
        ++round;
      }
    }
    store_tile<TMT>(p, sb, m0, tm, split, acc, [&](int j) {
      return n0 + (j / 4) * (BN / 2) + tn * 4 + (j % 4);
    });
  }
}

// ------------------------------------------------------- the tiled loop

// One K tile of A (BM × BK) and B into the stage at `As`, each element
// copied alone on its own tap: k = (r·taps_s + s)·C + c.
template <int BM, int BN, bool DGRAD>
__device__ __forceinline__ void load_tile(const Params& p, const Sub& sb,
                                          const int4* rows, float* As, int kt,
                                          int K, int n0) {
  using S = Shape<BM, BN, DGRAD>;
  constexpr int T = S::kThreads;
  float* Bs = As + BM * kLdK;
  const int tid = threadIdx.x;
  const int k0 = kt * kBK;
  const int C = p.C;
  const int kk = tid % kBK;
  const int k = k0 + kk;
  const bool kok = k < K;
  int r = 0, s = 0, c = 0;
  if (kok) {
    const int rs = k / C;
    c = k - rs * C;
    r = rs / sb.taps_s;
    s = rs - r * sb.taps_s;
  }
#pragma unroll 8
  for (int i = 0; i < BM * kBK / T; ++i) {
    const int row = tid / kBK + i * (T / kBK);
    const int4 rw = rows[row];
    const int ih = rw.x + r, iw = rw.y + s;
    const bool ok = kok &&
                    static_cast<unsigned>(ih) < static_cast<unsigned>(p.in_h) &&
                    static_cast<unsigned>(iw) < static_cast<unsigned>(p.in_w);
    const float* src = ok ? p.a + rw.z + (ih * p.in_w + iw) * C + c : p.a;
    cp_async4(As + row * kLdK + kk, src, ok);
  }
  if constexpr (DGRAD) {
    const int wr = sb.w_r0 + sb.w_rstep * r, wc = sb.w_s0 + sb.w_sstep * s;
    const long long tap = static_cast<long long>(wr * p.wS + wc) * p.wCin;
#pragma unroll 8
    for (int i = 0; i < BN * kBK / T; ++i) {
      const int n = tid / kBK + i * (T / kBK);
      const int col = n0 + n;
      const bool ok = kok && col < p.N;
      const float* src = ok ? p.w + (tap + col) * p.wCout + c : p.w;
      cp_async4(Bs + n * kLdK + kk, src, ok);
    }
  } else {
    // HWIO flattened is the (K, Cout) matrix: element (k, n) at k·Cout + n.
    if ((p.N & 3) == 0) {
      constexpr int QN = BN / 4;  // 16-byte copies a B row
      const int nq = tid % QN;
      const int col = n0 + nq * 4;
#pragma unroll
      for (int i = 0; i < kBK * QN / T; ++i) {
        const int kr = tid / QN + i * (T / QN);
        const int kg = k0 + kr;
        const bool ok = col < p.N && kg < K;
        const float* src = ok ? p.w + static_cast<long long>(kg) * p.N + col : p.w;
        cp_async16(Bs + kr * S::kLdN + nq * 4, src, ok);
      }
    } else {
      const int n = tid % BN;
      const int col = n0 + n;
#pragma unroll 8
      for (int i = 0; i < kBK * BN / T; ++i) {
        const int kr = tid / BN + i * (T / BN);
        const int kg = k0 + kr;
        const bool ok = col < p.N && kg < K;
        const float* src = ok ? p.w + static_cast<long long>(kg) * p.N + col : p.w;
        cp_async4(Bs + kr * S::kLdN + n, src, ok);
      }
    }
  }
}

template <int BM, int BN, bool DGRAD>
__global__ void __launch_bounds__(Shape<BM, BN, DGRAD>::kThreads, 1)
conv_kernel(const __grid_constant__ Params p) {
  using S = Shape<BM, BN, DGRAD>;
  constexpr int TNT = BN / 8;  // threads along N
  constexpr int TMT = BM / 8;  // threads along M
  extern __shared__ __align__(16) float smem[];
  int4* rows = reinterpret_cast<int4*>(smem + kStages * S::kStageFloats);

  const int tid = threadIdx.x;
  const int sub_i = blockIdx.z / p.splits;
  const int split = blockIdx.z - sub_i * p.splits;
  const Sub sb = pick_sub(p, sub_i);
  const int m0 = blockIdx.x * BM;
  if (m0 >= sb.M) return;  // a smaller phase of the input gradient
  const int n0 = blockIdx.y * BN;
  const int K = sb.taps_r * sb.taps_s * p.C;
  const int ktiles = (K + kBK - 1) / kBK;
  const int kt0 = split * p.kps;
  const int nkt = max(0, min(ktiles, kt0 + p.kps) - kt0);

  if (tid < BM) rows[tid] = gather_row(p, sb, m0 + tid);
  __syncthreads();

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt)
      load_tile<BM, BN, DGRAD>(p, sb, rows, smem + st * S::kStageFloats,
                               kt0 + st, K, n0);
    cp_async_commit();
  }

  const int tn = tid % TNT, tm = tid / TNT;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every thread is done with tile t − 1
    const int nt = t + kStages - 1;
    if (nt < nkt)
      load_tile<BM, BN, DGRAD>(p, sb, rows,
                               smem + (nt % kStages) * S::kStageFloats,
                               kt0 + nt, K, n0);
    cp_async_commit();
    const float* As = smem + (t % kStages) * S::kStageFloats;
    const float* Bs = As + BM * kLdK;
    float part[8][8];  // this K tile's sums
    tile_products<TMT, BN, (DGRAD ? kLdK : S::kLdN), DGRAD>(As, Bs, tm, tn, part);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
  }
  cp_async_wait<0>();

  store_tile<TMT>(p, sb, m0, tm, split, acc, [&](int j) {
    return DGRAD ? n0 + tn + TNT * j : n0 + (j / 4) * (BN / 2) + tn * 4 + (j % 4);
  });
}

// Outputs of at most kSmallN channels (conv_in's input gradient, the
// networks' conv_out and 1×1 quant convolutions), where a 64- or 128-wide
// tile would compute mostly padding: one warp an output pixel. Lane l sums
// channels l, l + 32, … of every tap in K order, each of the N outputs in
// its own FFMA chain; then a fixed butterfly adds the 32 lane sums (the
// same tree on every run), and lane 0 adds the bias and writes.
constexpr int kSmallN = 8;
constexpr int kSmallWarps = 8;

template <bool DGRAD>
__global__ void __launch_bounds__(32 * kSmallWarps)
small_n_kernel(const __grid_constant__ Params p) {
  const Sub sb = pick_sub(p, blockIdx.z);
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kSmallWarps + (threadIdx.x >> 5);
  if (m >= sb.M) return;  // a whole warp
  const int hw = sb.out_h * sb.out_w;
  const int b = m / hw, rem = m - b * hw;
  const int oh = rem / sb.out_w, ow = rem - oh * sb.out_w;
  const int C = p.C, N = p.N;
  float part[kSmallN];
#pragma unroll
  for (int n = 0; n < kSmallN; ++n) part[n] = 0.0f;
  for (int t = 0; t < sb.taps_r; ++t) {
    const int ih = oh * p.stride - sb.pad_h + t;
    if (static_cast<unsigned>(ih) >= static_cast<unsigned>(p.in_h)) continue;
    for (int u = 0; u < sb.taps_s; ++u) {
      const int iw = ow * p.stride - sb.pad_w + u;
      if (static_cast<unsigned>(iw) >= static_cast<unsigned>(p.in_w)) continue;
      const float* row = p.a + (static_cast<long long>(b * p.in_h + ih) * p.in_w + iw) * C;
      const int wr = sb.w_r0 + sb.w_rstep * t, wc = sb.w_s0 + sb.w_sstep * u;
      const float* tap = p.w + static_cast<long long>(wr * p.wS + wc) * p.wCin * p.wCout;
#pragma unroll 4
      for (int c = lane; c < C; c += 32) {
        const float av = row[c];
        float wv[kSmallN];
        if (!DGRAD && (N & 3) == 0) {
          // K7f: w[tap][c][0..N), 16-byte aligned rows
#pragma unroll
          for (int n = 0; n < kSmallN; n += 4)
            if (n < N) {
              const float4 q = *reinterpret_cast<const float4*>(tap + c * p.wCout + n);
              wv[n] = q.x, wv[n + 1] = q.y, wv[n + 2] = q.z, wv[n + 3] = q.w;
            }
        } else {
#pragma unroll
          for (int n = 0; n < kSmallN; ++n)
            // K7f: w[tap][c][n]; K7d: w[tap][n][c] (c runs over Cout).
            if (n < N) wv[n] = DGRAD ? tap[n * p.wCout + c] : tap[c * p.wCout + n];
        }
#pragma unroll
        for (int n = 0; n < kSmallN; ++n)
          if (n < N) part[n] = fmaf(av, wv[n], part[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kSmallN; ++n)
    if (n < N)  // the same N on every lane
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part[n] += __shfl_xor_sync(0xffffffffu, part[n], off);
  if (lane == 0) {
    const int y = oh * sb.o_stride + sb.o_y, x = ow * sb.o_stride + sb.o_x;
    float* dst = p.out + (static_cast<long long>(b * p.full_h + y) * p.full_w + x) * N;
#pragma unroll
    for (int n = 0; n < kSmallN; ++n)
      if (n < N) dst[n] = p.bias != nullptr ? part[n] + p.bias[n] : part[n];
  }
}

// Split-K's second pass: out = ((ws[0] + ws[1]) + …) + bias, in split order.
__global__ void reduce_kernel(const float* __restrict__ ws,
                              const float* __restrict__ bias,
                              float* __restrict__ out, long long mn, int n,
                              int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < mn; i += stride) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[s * mn + i];
    if (bias != nullptr) v += bias[i % n];
    out[i] = v;
  }
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled from libcuda, found through the runtime's entry-point
// query (nothing links libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// B's tensor map: the (wR·wS·C, N) weight matrix, boxes of BK rows × BN
// columns as they lie in shared memory; columns past N read as zeros. K7f:
// the HWIO weight itself; K7d: its (wR, wS, Cout, Cin) copy.
bool weight_map(CUtensorMap* map, const Params& p, int bn) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.N),
                              static_cast<cuuint64_t>(p.wR) * p.wS * p.C};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.N) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(bn), kBK};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p.w),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The dynamic shared-memory opt-in, once per kernel and device.
template <typename Kernel>
int set_smem(Kernel kernel, int smem, bool* ready) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  return 0;
}

template <int BN, bool DGRAD>
int launch_ws(const Params& p, dim3 grid, cudaStream_t stream) {
  using S = WsShape<BN>;
  static bool ready[64] = {};
  static int regs = -1;
  if (regs < 0) {
    // setmaxnreg moves registers inside the block's allocation at launch:
    // refuse a build whose allocation could not give the consumers theirs.
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, conv_ws_kernel<BN, DGRAD>);
    if (e != cudaSuccess) return static_cast<int>(e);
    regs = attr.numRegs;
  }
  if (regs < S::kLaunchRegs) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int e = set_smem(conv_ws_kernel<BN, DGRAD>, S::kSmemBytes, ready);
  if (e != 0) return e;
  WsParams q;
  q.p = p;
  if (!weight_map(&q.wmap, p, BN)) return static_cast<int>(cudaErrorInvalidValue);
  conv_ws_kernel<BN, DGRAD><<<grid, S::kThreads, S::kSmemBytes, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, bool DGRAD>
int launch_tiled(const Params& p, dim3 grid, cudaStream_t stream) {
  using S = Shape<BM, BN, DGRAD>;
  static bool ready[64] = {};
  const int e = set_smem(conv_kernel<BM, BN, DGRAD>, S::kSmemBytes, ready);
  if (e != 0) return e;
  conv_kernel<BM, BN, DGRAD><<<grid, S::kThreads, S::kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool DGRAD>
int launch_tile(int tile, bool ws, const Params& p, dim3 grid, cudaStream_t stream) {
  if (tile == 2) {
    if (p.N > kSmallN || p.splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    small_n_kernel<DGRAD><<<grid, 32 * kSmallWarps, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (ws) {
    // A K tile in one tap, 16-byte rows of A; B's rows 16-byte for the TMA.
    if (p.C % kBK != 0 || p.N % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return tile == 0 ? launch_ws<128, DGRAD>(p, grid, stream)
                     : launch_ws<64, DGRAD>(p, grid, stream);
  }
  return tile == 0 ? launch_tiled<128, 128, DGRAD>(p, grid, stream)
                   : launch_tiled<128, 64, DGRAD>(p, grid, stream);
}

}  // namespace

// tile: 0 → 128×128, 1 → 128×64, 2 → a warp a pixel (N ≤ 8). ws: the
// warp-specialised kernel (the reduction channels a multiple of 32, and
// forward Cout a multiple of 4), else the tiled loop. Grid: (M tiles of
// the largest sub-problem, N tiles, sub-problems × splits).
extern "C" int yea_conv(const void* params, int tile, int dgrad, int ws,
                        int grid_x, int grid_y, int grid_z, void* stream) {
  if (grid_x <= 0 || grid_y <= 0 || grid_z <= 0) return 0;
  const Params* p = static_cast<const Params*>(params);
  const dim3 grid(grid_x, grid_y, grid_z);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dgrad ? launch_tile<true>(tile, ws != 0, *p, grid, st)
               : launch_tile<false>(tile, ws != 0, *p, grid, st);
}

extern "C" int yea_conv_reduce(const float* ws, const float* bias, float* out,
                               long long mn, int n, int splits, void* stream) {
  if (mn <= 0) return 0;
  const int threads = 256;
  const long long want = (mn + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  reduce_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      ws, bias, out, mn, n, splits);
  return static_cast<int>(cudaGetLastError());
}
