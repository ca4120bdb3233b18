// f32 2-D convolution on Hopper as an implicit GEMM (kernel K7).
//
// Replaces no Pallas kernel: the JAX package spells the guidance networks'
// convolutions as shifted matmuls for XLA
// (youreditableavatar_tpu/guidance/sd_layers.py `conv2d`). Here they run as
// one hand-written implicit GEMM under `sd_layers.conv2d` for CUDA tensors,
// in two entry points that share one kernel:
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
// kernel multiplies with FFMA alone.
//
// Design:
//  * Block tiles of 128×128 (256 threads) or 128×64 (128 threads), BK 32;
//    each thread accumulates an 8×8 register tile with `fmaf`. A is kept
//    K-contiguous in shared memory (rows padded to BK + 4 floats), read as
//    float4 along K by rows tm + 16·i: a warp touches two or four
//    consecutive rows, conflict-free. K7f keeps B as it lies, Cout-
//    contiguous (rows of BN + 4), and a thread reads its columns
//    g·BN/2 + 4·tn + (0..3) as two float4 a k; K7d's B is K-contiguous
//    like A, its columns tn + (BN/8)·j.
//  * A four-stage cp.async ring in shared memory, one barrier a K tile.
//    Where the reduction channels are a multiple of 32 a K tile lies in one
//    tap, and A (and K7d's B) copy 16 bytes along the channels; otherwise
//    (Cin 3, 4, 8 or 16) each element copies alone with its own tap. K7f's
//    B copies 16 bytes along Cout where Cout is a multiple of 4, else 4.
//    Out-of-image and out-of-range elements copy as zeros (cp.async's
//    source size 0).
//  * Shape-adapted (the wrapper chooses from M, N, K as the call observes
//    them): tile shape and a split-K factor. Split-K writes partial sums to
//    a workspace the wrapper allocates; a second kernel adds them in split
//    order and adds the bias. At most 8 output channels (conv_in's input
//    gradient, conv_out, the VAE's 1×1 quant) take a warp an output pixel
//    instead (`small_n_kernel`): a 64-wide tile would compute padding.
//
// Numerics: in the tiles, each K tile's 32 products go into a fresh
// partial sum, one sequential FFMA chain in ascending k (tap-major, then
// channel), and the partials add into the output's sum in tile order: a
// two-level sum whose rounding error grows about 3× slower with K than one
// long chain, which keeps K7's error at or under cuDNN's own at the
// networks' shapes. The split partials are added in ascending split order,
// then the bias. The small-N kernel's lanes each sum their channels in K
// order, then a fixed butterfly adds the lanes. No atomics, no tensor-core
// instruction, no operand narrower than f32: the result is the same bits
// on every run of a shape.

#include <cuda_runtime.h>

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
  const float* w;     // HWIO (wR, wS, wCin, wCout)
  const float* bias;  // (N) or null
  float* out;         // (batch, full_h, full_w, N)
  float* ws;          // (splits, M, N) partial sums, when splits > 1
  int in_h, in_w, C;  // C: the reduction channels (Cin forward, Cout dgrad)
  int stride;
  int N;              // GEMM columns (Cout forward, Cin dgrad)
  int wS, wCin, wCout;
  int full_h, full_w;
  int splits, kps;    // split-K factor and K tiles a split
  Sub sub[kMaxSubs];
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BM, int BN, bool DGRAD>
struct Shape {
  static constexpr int kThreads = (BM / 8) * (BN / 8);
  static constexpr int kQuads = kBK / 4;       // 16-byte copies a K row
  static constexpr int kLdN = BN + 4;          // K7f's Cout-contiguous B rows
  static constexpr int kBFloats = DGRAD ? BN * kLdK : kBK * kLdN;
  static constexpr int kStageFloats = BM * kLdK + kBFloats;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4 + BM * 16;
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

// One K tile of A (BM × BK) and B into the stage at `As`; `at` is the
// tile's start where it lies in one tap (VEC).
template <int BM, int BN, bool DGRAD, bool VEC>
__device__ __forceinline__ void load_tile(const Params& p, const Sub& sb,
                                          const int4* rows, float* As, int kt,
                                          const Cursor& at, int K, int n0) {
  using S = Shape<BM, BN, DGRAD>;
  constexpr int T = S::kThreads, Q = S::kQuads;
  float* Bs = As + BM * kLdK;
  const int tid = threadIdx.x;
  const int k0 = kt * kBK;
  const int C = p.C;
  if constexpr (VEC) {
    // The tile lies in one tap: channels [c0, c0 + BK).
    const int c0 = at.c0, r = at.r, s = at.s;
    const int kq = tid % Q;
#pragma unroll
    for (int i = 0; i < BM * Q / T; ++i) {
      const int row = tid / Q + i * (T / Q);
      const int4 rw = rows[row];
      const int ih = rw.x + r, iw = rw.y + s;
      const bool ok = static_cast<unsigned>(ih) < static_cast<unsigned>(p.in_h) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(p.in_w);
      const float* src = ok ? p.a + rw.z + (ih * p.in_w + iw) * C + c0 + kq * 4 : p.a;
      cp_async16(As + row * kLdK + kq * 4, src, ok);
    }
    if constexpr (DGRAD) {
      const int wr = sb.w_r0 + sb.w_rstep * r, wc = sb.w_s0 + sb.w_sstep * s;
      const long long tap = static_cast<long long>(wr * p.wS + wc) * p.wCin;
#pragma unroll
      for (int i = 0; i < BN * Q / T; ++i) {
        const int n = tid / Q + i * (T / Q);
        const int col = n0 + n;
        const bool ok = col < p.N;
        const float* src = ok ? p.w + (tap + col) * p.wCout + c0 + kq * 4 : p.w;
        cp_async16(Bs + n * kLdK + kq * 4, src, ok);
      }
    }
  } else {
    // Each element on its own tap: k = (r·taps_s + s)·C + c.
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
    }
  }
  if constexpr (!DGRAD) {
    // HWIO flattened is the (K, Cout) matrix: element (k, n) at k·Cout + n.
    if ((p.N & 3) == 0) {
      constexpr int QN = BN / 4;  // 16-byte copies a B row
      const int nq = tid % QN;
      const int col = n0 + nq * 4;
#pragma unroll
      for (int i = 0; i < kBK * QN / T; ++i) {
        const int kk = tid / QN + i * (T / QN);
        const int k = k0 + kk;
        const bool ok = col < p.N && k < K;
        const float* src = ok ? p.w + static_cast<long long>(k) * p.N + col : p.w;
        cp_async16(Bs + kk * S::kLdN + nq * 4, src, ok);
      }
    } else {
      const int n = tid % BN;
      const int col = n0 + n;
#pragma unroll 8
      for (int i = 0; i < kBK * BN / T; ++i) {
        const int kk = tid / BN + i * (T / BN);
        const int k = k0 + kk;
        const bool ok = col < p.N && k < K;
        const float* src = ok ? p.w + static_cast<long long>(k) * p.N + col : p.w;
        cp_async4(Bs + kk * S::kLdN + n, src, ok);
      }
    }
  }
}

template <int BM, int BN, bool DGRAD, bool VEC>
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
  Sub sb;
  switch (sub_i) {  // constant indices keep the parameters in param space
    case 0: sb = p.sub[0]; break;
    case 1: sb = p.sub[1]; break;
    case 2: sb = p.sub[2]; break;
    default: sb = p.sub[3]; break;
  }
  const int m0 = blockIdx.x * BM;
  if (m0 >= sb.M) return;  // a smaller phase of the input gradient
  const int n0 = blockIdx.y * BN;
  const int K = sb.taps_r * sb.taps_s * p.C;
  const int ktiles = (K + kBK - 1) / kBK;
  const int kt0 = split * p.kps;
  const int nkt = max(0, min(ktiles, kt0 + p.kps) - kt0);

  // The block's gathered rows: first input pixel and the image's offset.
  const int hw = sb.out_h * sb.out_w;
  if (tid < BM) {
    const int m = m0 + tid;
    int4 rw = make_int4(-(1 << 29), -(1 << 29), 0, 0);
    if (m < sb.M) {
      const int b = m / hw, rem = m - b * hw;
      const int oh = rem / sb.out_w, ow = rem - oh * sb.out_w;
      rw = make_int4(oh * p.stride - sb.pad_h, ow * p.stride - sb.pad_w,
                     b * p.in_h * p.in_w * p.C, 0);
    }
    rows[tid] = rw;
  }
  __syncthreads();

  Cursor at(kt0 * kBK, p.C, max(sb.taps_s, 1));
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt) {
      load_tile<BM, BN, DGRAD, VEC>(p, sb, rows, smem + st * S::kStageFloats,
                                    kt0 + st, at, K, n0);
      if constexpr (VEC) at.next(p.C, sb.taps_s);
    }
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
    if (nt < nkt) {
      load_tile<BM, BN, DGRAD, VEC>(p, sb, rows,
                                    smem + (nt % kStages) * S::kStageFloats,
                                    kt0 + nt, at, K, n0);
      if constexpr (VEC) at.next(p.C, sb.taps_s);
    }
    cp_async_commit();
    const float* As = smem + (t % kStages) * S::kStageFloats;
    const float* Bs = As + BM * kLdK;
    float part[8][8];  // this K tile's sums; its first product starts each
#pragma unroll
    for (int kq = 0; kq < kBK / 4; ++kq) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (tm + TMT * i) * kLdK + kq * 4);
      if constexpr (DGRAD) {
        float4 b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = *reinterpret_cast<const float4*>(Bs + (tn + TNT * j) * kLdK + kq * 4);
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
          const float* brow = Bs + (kq * 4 + kk) * S::kLdN + tn * 4;
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
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
  }
  cp_async_wait<0>();

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
      const int col = DGRAD ? n0 + tn + TNT * j
                            : n0 + (j / 4) * (BN / 2) + tn * 4 + (j % 4);
      if (col < p.N) dst[col] = add_bias ? acc[i][j] + p.bias[col] : acc[i][j];
    }
  }
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
  Sub sb;
  switch (blockIdx.z) {
    case 0: sb = p.sub[0]; break;
    case 1: sb = p.sub[1]; break;
    case 2: sb = p.sub[2]; break;
    default: sb = p.sub[3]; break;
  }
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

template <int BM, int BN, bool DGRAD, bool VEC>
int launch(const Params& p, dim3 grid, cudaStream_t stream) {
  constexpr int smem = Shape<BM, BN, DGRAD>::kSmemBytes;
  static bool ready[64] = {};  // the shared-memory opt-in, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(conv_kernel<BM, BN, DGRAD, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev] = true;
  }
  conv_kernel<BM, BN, DGRAD, VEC>
      <<<grid, Shape<BM, BN, DGRAD>::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool DGRAD, bool VEC>
int launch_tile(int tile, const Params& p, dim3 grid, cudaStream_t stream) {
  if (tile == 2) {
    if (p.N > kSmallN || p.splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    small_n_kernel<DGRAD><<<grid, 32 * kSmallWarps, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  return tile == 0 ? launch<128, 128, DGRAD, VEC>(p, grid, stream)
                   : launch<128, 64, DGRAD, VEC>(p, grid, stream);
}

}  // namespace

// tile: 0 → 128×128, 1 → 128×64, 2 → a warp a pixel (N ≤ 8). vec: the
// reduction channels are a multiple of 32. Grid: (M tiles of the largest
// sub-problem, N tiles, sub-problems × splits).
extern "C" int yea_conv(const void* params, int tile, int dgrad, int vec,
                        int grid_x, int grid_y, int grid_z, void* stream) {
  if (grid_x <= 0 || grid_y <= 0 || grid_z <= 0) return 0;
  const Params* p = static_cast<const Params*>(params);
  const dim3 grid(grid_x, grid_y, grid_z);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dgrad)
    return vec ? launch_tile<true, true>(tile, *p, grid, st)
               : launch_tile<true, false>(tile, *p, grid, st);
  return vec ? launch_tile<false, true>(tile, *p, grid, st)
             : launch_tile<false, false>(tile, *p, grid, st);
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
