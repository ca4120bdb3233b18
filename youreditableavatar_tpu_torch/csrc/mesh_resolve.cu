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
// What bounds it on the H100: bytes. The outputs are 16 bytes a pixel and
// the face rows 36 bytes a face (4 a pair for its id): ~8 MB at 512² with
// the 81,920-face icosphere, ~0.0024 ms. A face covers a few pixels there,
// so the (pair, pixel) evaluations that can pass the inside test are a
// small share of the ~10⁸ a tile-dense sweep makes (21 f32 ops each).
//
// Design: four CTAs per 32×32 tile, one per 16×16 quarter (the z-buffer
// has no rule that couples pixels, so the quarters need no cluster), 256
// threads, one pixel a thread, each warp an 8×4 block (two across, four
// down). Per stage of 128 pairs, thread j gathers pair j's face row
// through `face_s`, computes the per-face terms every pixel shares (edge
// differences, 1/d) and the face's conservative pixel box (`face_box`);
// the CTA keeps the faces whose box meets its quarter, in pair order (a
// ballot and a popc prefix over the four loading warps), and loads the
// next stage's rows while the kept ones are swept. Each warp tests 32 kept
// boxes at once against its block with a ballot and evaluates only the
// faces that meet it, lowest bit first, so pair order and the strict test
// are kept. The running (z, face, l1, l2) stay in registers. The hoisted
// terms are the same f32 operations the plain version performs, and this
// file is compiled with --fmad=false and IEEE division, so the result is
// bit-identical to the plain PyTorch version. No atomics: the output is
// deterministic. The TPU kernel's 128-aligned padded column layout and
// (8, 128) output tile exist for its DMA and vector registers and are not
// carried over: the kernel reads starts/counts, gathers rows directly,
// carries the face id as int32 and writes the image planes, masking the
// ragged edge itself.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kQuarter = kTile / 2;
constexpr int kQuarters = 4;
constexpr int kThreads = 256;
constexpr int kStage = 128;
constexpr int kWarpW = 8;  // one warp's pixel block: 8 × 4
constexpr int kWarpH = 4;
constexpr int kRowFloats = 9;  // x0 y0 x1 y1 x2 y2 z0 z1 z2
constexpr unsigned kFull = 0xffffffffu;
constexpr float kZFar = 3.4e38f;
constexpr float kDegenerate = 1e-12f;

// Pixel box (x_lo, x_hi, y_lo, y_hi) outside which no pixel passes the f32
// inside test of a face whose signed double area is d (its f32 value). In
// double, from a bound on the rounding of each barycentric: for a pixel in
// a tile that lists the face (within a tile of its bounding box), |px −
// x0| ≤ sx + 32 and |py − y0| ≤ sy + 32 (sx, sy the box's spans), and each
// computed l_k is off its exact value by at most E (below). A pixel whose
// computed l_k ≥ 0 for all k has exact λ_k ≥ −E, which is the triangle
// grown to v_k + E·(v_k − v_i) + E·(v_k − v_j): its box is the vertices'
// box widened by 2E·span, here doubled, plus a relative part for the
// rounding of the bounds to f32. A sliver (small |d| against the spans)
// gets a wide box; an infinite one (no cull) where the bound does not
// hold or anything is not finite. The plain version is
// `raster.face_box_plain`, line for line.
__device__ __forceinline__ float4 face_box(float x0, float y0, float x1,
                                           float y1, float x2, float y2,
                                           float d) {
  const float4 all = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  const double u = 5.9604644775390625e-8;  // 2^-24
  const double xl = fmin(fmin((double)x0, (double)x1), (double)x2);
  const double xh = fmax(fmax((double)x0, (double)x1), (double)x2);
  const double yl = fmin(fmin((double)y0, (double)y1), (double)y2);
  const double yh = fmax(fmax((double)y0, (double)y1), (double)y2);
  const double sx = xh - xl, sy = yh - yl;
  const double ad = fabs((double)d);
  if (!(ad > 0.0) || !(sx + sy < 1e30)) return all;  // NaN / inf too
  const double r = ((sx + 32.0) * sy + (sy + 32.0) * sx) / ad;
  const double ed = 4.01 * u * 2.0 * sx * sy / ad;  // relative error of d
  if (!(ed < 0.5)) return all;
  const double e12 = r * (6.02 * u + 2.0 * ed);
  const double e = 2.0 * e12 + 2.0 * u * (1.0 + 3.0 * r);
  const double mx = 4.0 * e * sx + 1e-6 * (fabs(xl) + fabs(xh)) + 1e-6;
  const double my = 4.0 * e * sy + 1e-6 * (fabs(yl) + fabs(yh)) + 1e-6;
  return make_float4(static_cast<float>(xl - mx), static_cast<float>(xh + mx),
                     static_cast<float>(yl - my), static_cast<float>(yh + my));
}

__device__ __forceinline__ bool meets(float4 b, float x0, float x1, float y0,
                                      float y1) {
  return !(b.y < x0 || b.x > x1 || b.w < y0 || b.z > y1);
}

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const float* __restrict__ rows, const int* __restrict__ face_s,
               const int* __restrict__ starts, const int* __restrict__ counts,
               int ntx, int width, int height, float* __restrict__ depth,
               int* __restrict__ face_id, float2* __restrict__ bary) {
  // The kept faces of a stage, compacted in pair order.
  __shared__ float s_x0[kStage], s_y0[kStage];
  __shared__ float s_dx1[kStage], s_dy1[kStage];  // x1 - x0, y1 - y0
  __shared__ float s_dx2[kStage], s_dy2[kStage];  // x2 - x0, y2 - y0
  __shared__ float s_inv[kStage];
  __shared__ float s_z0[kStage], s_z1[kStage], s_z2[kStage];
  __shared__ float4 s_box[kStage];
  __shared__ int s_face[kStage];
  __shared__ int s_kept[kStage / 32];

  const int tile = blockIdx.x / kQuarters;
  const int q = blockIdx.x % kQuarters;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = starts[tile];
  const int count = counts[tile];
  const int qx = (tile % ntx) * kTile + (q & 1) * kQuarter;
  const int qy = (tile / ntx) * kTile + (q >> 1) * kQuarter;
  const int bx = qx + (warp & 1) * kWarpW;
  const int by = qy + (warp >> 1) * kWarpH;
  const int x = bx + lane % kWarpW;
  const int y = by + lane / kWarpW;
  const float px = static_cast<float>(x), py = static_cast<float>(y);
  const float qx0 = qx, qx1 = qx + (kQuarter - 1);
  const float qy0 = qy, qy1 = qy + (kQuarter - 1);
  const float wx0 = bx, wx1 = bx + (kWarpW - 1);
  const float wy0 = by, wy1 = by + (kWarpH - 1);

  float bz = kZFar, bu = 0.0f, bv = 0.0f;
  int bf = -1;

  // Thread j < 128 loads pair j of each stage, a stage ahead.
  int f = -1;
  float r[kRowFloats];
  auto load = [&](int base) {
    f = -1;
    if (tid < kStage && base + tid < count) {
      f = face_s[start + base + tid];
      const float* src = rows + static_cast<size_t>(f) * kRowFloats;
#pragma unroll
      for (int k = 0; k < kRowFloats; ++k) r[k] = src[k];
    }
  };
  load(0);
  for (int base = 0; base < count; base += kStage) {
    // Per-face terms and box; the CTA keeps the faces that meet its quarter.
    bool keep = false;
    float dx1 = 0.0f, dy1 = 0.0f, dx2 = 0.0f, dy2 = 0.0f, inv_d = 0.0f;
    float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (f >= 0) {
      dx1 = r[2] - r[0];
      dy1 = r[3] - r[1];
      dx2 = r[4] - r[0];
      dy2 = r[5] - r[1];
      const float d = dx1 * dy2 - dy1 * dx2;
      if (fabsf(d) > kDegenerate) {  // degenerate faces are skipped
        inv_d = 1.0f / d;
        box = face_box(r[0], r[1], r[2], r[3], r[4], r[5], d);
        keep = meets(box, qx0, qx1, qy0, qy1);
      }
    }
    const unsigned m = __ballot_sync(kFull, keep);
    __syncthreads();  // the previous stage is swept: its slots are free
    if (tid < kStage && lane == 0) s_kept[warp] = __popc(m);
    __syncthreads();
    int pos = 0, kept = 0;
#pragma unroll
    for (int w = 0; w < kStage / 32; ++w) {
      pos += w < warp ? s_kept[w] : 0;
      kept += s_kept[w];
    }
    if (keep) {
      pos += __popc(m & ((1u << lane) - 1u));
      s_x0[pos] = r[0];
      s_y0[pos] = r[1];
      s_dx1[pos] = dx1;
      s_dy1[pos] = dy1;
      s_dx2[pos] = dx2;
      s_dy2[pos] = dy2;
      s_inv[pos] = inv_d;
      s_z0[pos] = r[6];
      s_z1[pos] = r[7];
      s_z2[pos] = r[8];
      s_box[pos] = box;
      s_face[pos] = f;
    }
    __syncthreads();
    load(base + kStage);  // the next stage's rows load during the sweep

    for (int j0 = 0; j0 < kept; j0 += 32) {
      const int j = j0 + lane;
      unsigned hit = __ballot_sync(
          kFull, j < kept && meets(s_box[j], wx0, wx1, wy0, wy1));
      while (hit != 0u) {
        const int g = j0 + __ffs(hit) - 1;
        hit &= hit - 1u;
        const float ex = px - s_x0[g];
        const float ey = py - s_y0[g];
        const float inv = s_inv[g];
        const float l1 = (ex * s_dy2[g] - ey * s_dx2[g]) * inv;
        const float l2 = (ey * s_dx1[g] - ex * s_dy1[g]) * inv;
        const float l0 = 1.0f - l1 - l2;
        const float z = s_z0[g] * l0 + s_z1[g] * l1 + s_z2[g] * l2;
        const bool upd = (l0 >= 0.0f) && (l1 >= 0.0f) && (l2 >= 0.0f) &&
                         (z < bz);
        bz = upd ? z : bz;
        bf = upd ? s_face[g] : bf;
        bu = upd ? l1 : bu;
        bv = upd ? l2 : bv;
      }
    }
  }

  if (x >= width || y >= height) return;
  const size_t o = static_cast<size_t>(y) * width + x;
  depth[o] = bz;
  face_id[o] = bf;
  bary[o] = make_float2(bu, bv);
}

}  // namespace

extern "C" int yea_mesh_resolve(const float* rows, const int* face_s,
                                const int* starts, const int* counts,
                                int num_tiles, int ntx, int width, int height,
                                float* depth, int* face_id, float* bary,
                                void* stream) {
  if (num_tiles > 0)
    resolve_kernel<<<num_tiles * kQuarters, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        rows, face_s, starts, counts, ntx, width, height, depth, face_id,
        reinterpret_cast<float2*>(bary));
  return cudaGetLastError();
}
