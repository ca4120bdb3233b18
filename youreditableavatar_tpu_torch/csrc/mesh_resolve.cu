// Per-tile z-buffer resolve of tile-binned mesh faces (K5).
//
// Replaces the Pallas kernel of youreditableavatar_tpu/ops/mesh_raster/
// raster.py (`_resolve_kernel`, called from `rasterize_mesh`).
//
// What it computes: for tile t, for each of its counts[t] faces in pair
// order, per pixel the affine barycentrics (l1, l2), l0 = 1 - l1 - l2, the
// inside test, z = z0·l0 + z1·l1 + z2·l2, and the update `inside ∧ z <
// best_z` — strict, so the earliest pair wins a tie. Pair order is the
// stable tile sort of face order, so among coplanar faces the lowest face
// index is kept.
//
// What bounds it on the H100: operations. Every (pair, pixel) evaluation is
// ~21 f32 operations against 36 bytes of face row per *pair*, shared by the
// tile's 1024 pixels; the outputs are 16 bytes per pixel. At 512² with the
// 81,920-face icosphere that is ~10⁸ evaluations against ~8 MB moved.
//
// Design: one CTA per tile, 256 threads, each owning 4 pixels (one per
// 8-row band, so a warp is one pixel row and stores coalesce). The running
// (z, face, l1, l2) stay in registers. Faces are staged 128 at a time into
// shared memory: thread j gathers pair j's face row through `face_s` and
// stores the per-face terms every pixel shares (edge differences, 1/d).
// Those terms are the same f32 operations the plain version performs, only
// hoisted, and this file is compiled with --fmad=false and IEEE division,
// so the result is bit-identical to the plain PyTorch version. No atomics:
// the output is deterministic. The TPU kernel's 128-aligned padded column
// layout and (8, 128) output tile exist for its DMA and vector registers
// and are not carried over: the kernel reads starts/counts, gathers rows
// directly, carries the face id as int32 and writes the image planes,
// masking the ragged edge itself.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kPerThread = kTile * kTile / kThreads;  // 4 pixels
constexpr int kStage = 128;
constexpr int kRowFloats = 9;  // x0 y0 x1 y1 x2 y2 z0 z1 z2
constexpr float kZFar = 3.4e38f;
constexpr float kDegenerate = 1e-12f;

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const float* __restrict__ rows, const int* __restrict__ face_s,
               const int* __restrict__ starts, const int* __restrict__ counts,
               int ntx, int width, int height, float* __restrict__ depth,
               int* __restrict__ face_id, float2* __restrict__ bary) {
  __shared__ float s_x0[kStage], s_y0[kStage];
  __shared__ float s_dx1[kStage], s_dy1[kStage];  // x1 - x0, y1 - y0
  __shared__ float s_dx2[kStage], s_dy2[kStage];  // x2 - x0, y2 - y0
  __shared__ float s_inv[kStage];
  __shared__ float s_z0[kStage], s_z1[kStage], s_z2[kStage];
  __shared__ int s_face[kStage];  // face index, −1 = degenerate (skipped)

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int base_x = (tile % ntx) * kTile;
  const int base_y = (tile / ntx) * kTile;

  const int col = tid % kTile;
  const int row0 = tid / kTile;  // 0..7; the thread's rows are row0 + 8k
  const float px = static_cast<float>(base_x + col);
  float py[kPerThread], bz[kPerThread], bu[kPerThread], bv[kPerThread];
  int bf[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    py[k] = static_cast<float>(base_y + row0 + (kThreads / kTile) * k);
    bz[k] = kZFar;
    bf[k] = -1;
    bu[k] = 0.0f;
    bv[k] = 0.0f;
  }

  for (int base = 0; base < count; base += kStage) {
    const int n = min(kStage, count - base);
    __syncthreads();  // the previous round's faces are consumed
    if (tid < n) {
      const int f = face_s[start + base + tid];
      const float* r = rows + static_cast<size_t>(f) * kRowFloats;
      const float x0 = r[0], y0 = r[1];
      const float dx1 = r[2] - x0, dy1 = r[3] - y0;
      const float dx2 = r[4] - x0, dy2 = r[5] - y0;
      const float d = dx1 * dy2 - dy1 * dx2;
      const bool ok = fabsf(d) > kDegenerate;
      s_x0[tid] = x0;
      s_y0[tid] = y0;
      s_dx1[tid] = dx1;
      s_dy1[tid] = dy1;
      s_dx2[tid] = dx2;
      s_dy2[tid] = dy2;
      s_inv[tid] = ok ? 1.0f / d : 0.0f;
      s_z0[tid] = r[6];
      s_z1[tid] = r[7];
      s_z2[tid] = r[8];
      s_face[tid] = ok ? f : -1;
    }
    __syncthreads();
    for (int g = 0; g < n; ++g) {
      const int f = s_face[g];
      if (f < 0) continue;  // uniform across the block
      const float x0 = s_x0[g], y0 = s_y0[g];
      const float dx1 = s_dx1[g], dy1 = s_dy1[g];
      const float dx2 = s_dx2[g], dy2 = s_dy2[g];
      const float inv_d = s_inv[g];
      const float z0 = s_z0[g], z1 = s_z1[g], z2 = s_z2[g];
      const float ex = px - x0;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float ey = py[k] - y0;
        const float l1 = (ex * dy2 - ey * dx2) * inv_d;
        const float l2 = (ey * dx1 - ex * dy1) * inv_d;
        const float l0 = 1.0f - l1 - l2;
        const float z = z0 * l0 + z1 * l1 + z2 * l2;
        const bool upd = (l0 >= 0.0f) && (l1 >= 0.0f) && (l2 >= 0.0f) &&
                         (z < bz[k]);
        bz[k] = upd ? z : bz[k];
        bf[k] = upd ? f : bf[k];
        bu[k] = upd ? l1 : bu[k];
        bv[k] = upd ? l2 : bv[k];
      }
    }
  }

  const int x = base_x + col;
  if (x >= width) return;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int y = base_y + row0 + (kThreads / kTile) * k;
    if (y >= height) continue;
    const size_t o = static_cast<size_t>(y) * width + x;
    depth[o] = bz[k];
    face_id[o] = bf[k];
    bary[o] = make_float2(bu[k], bv[k]);
  }
}

}  // namespace

extern "C" int yea_mesh_resolve(const float* rows, const int* face_s,
                                const int* starts, const int* counts,
                                int num_tiles, int ntx, int width, int height,
                                float* depth, int* face_id, float* bary,
                                void* stream) {
  if (num_tiles > 0)
    resolve_kernel<<<num_tiles, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        rows, face_s, starts, counts, ntx, width, height, depth, face_id,
        reinterpret_cast<float2*>(bary));
  return cudaGetLastError();
}
