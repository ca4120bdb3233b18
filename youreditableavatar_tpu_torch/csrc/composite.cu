// Tile compositing on Hopper: forward (K1f), fused backward (K1b) and
// per-pair backward (K6).
//
// Replaces the Pallas kernels of youreditableavatar_tpu/ops/gaussian_raster/
// composite_pallas.py: the forward `_forward_kernel` (via `_forward_call`),
// the per-Gaussian backward `_backward_kernel_fused` (via
// `_backward_call_fused`) of `composite_tiles_pallas_fused`, and the per-pair
// backward `_backward_kernel` (via `_backward_call`) of the non-fused
// `composite_tiles_pallas`. On the TPU each runs one grid step per tile, in
// order on one core, and sweeps the tile's depth-ordered pairs against its
// 1,024 pixels.
//
// What bounds them on the H100: at the 512²/100k render (counted by
// chip_smoke.py) the tiles meet 1.08e8 live (pair, pixel) combinations, but
// only 7.1e6 of them contribute; their arithmetic (~27 f32 operations
// forward, ~60 backward) takes 3–6 µs at the 67 TFLOP/s f32 peak, less
// than the bytes: ~12.5 MB of field rows, pair ids and image planes
// forward, ~22 MB backward, plus ~29 MB of checkpoints (below), 12–20 µs
// at 3.35 TB/s. Two things kept a backward over one CTA per tile far from
// that, and a forward over one CTA per tile with 4 pixels a thread from its
// own: the tiles' depths are skewed (median 209 pairs, max 2,052), so the
// densest tiles ran alone at the end; and the Gaussians are small against a
// tile (3σ ≈ 6–11 px), so ~93% of the live combinations were evaluated for
// nothing.
//
// Forward (K1f): one thread-block cluster of 4 CTAs per 32×32 tile, CTA
// `rank` on the 16×16 quarter (rank & 1, rank >> 1), 256 threads × 1 pixel,
// each warp a compact 8×4 pixel block. Pixels are independent and depth is
// the only serial axis, so the split is over pixels: every pixel still
// takes the tile's pairs in depth order with the same f32 ops. Every CTA
// stages the tile's depth-ordered, 128-aligned pair range 128 pairs at a
// time into shared memory (the rows hit in L2 for the other three); each
// staged row is fields_ext[pg_padded[slot]] (K1f under K1b: the (P_pad, 16)
// pair rows are never materialised) or rows[slot] (K1f under K6, whose
// caller gathered the rows): a template flag picks the source, and the
// staging threads load the next batch's rows while the warps sweep. One
// thread per pair also computes its `cull_box` (below); a warp skips a
// pair, warp-uniformly, when its block misses the box or all its pixels
// are done — exact, since outside the box `blend` gives ok == false: no
// contrib, no trigger, no state change. Each lane tests one of 32 pairs
// against the block and a ballot leaves the warp the pairs that overlap
// (~20% at 512²/100k), which it takes two at a time: both α first (they do
// not read T, so their expf chains overlap), then each pair's step in
// depth order. The tile stops after the first batch that
// leaves none of its 1,024 pixels live, as before the split: each CTA ORs
// its own (`__syncthreads_or`), writes the flag into slot `rank` of every
// peer's shared memory (distributed shared memory, two buffers) and one
// `cluster.sync()` a batch makes the four flags visible; so all four CTAs
// sweep the same batches and reach the same barriers, a quarter whose
// pixels are done skipping every `blend`. A first `cluster.sync()`, before
// the sweep, makes sure every peer has started before its shared memory is
// written, and a last one keeps every CTA resident until no peer addresses
// its shared memory. When a
// backward will follow (a second template flag), each CTA saves its
// pixels' state at the start of every batch the tile sweeps — T, the
// colour prefix, and 2·n_contrib + done — into (P_pad/128, ·, 1024)
// buffers indexed by the batch's global number (slot / 128) and the tile
// pixel y·32 + x, and rank 0 the number of batches the tile swept.
//
// Backward (K1b, K6): one CTA per 128-slot batch, so the work is ~1,400
// equal CTAs instead of 256 skewed tiles. The CTA finds its tile by a binary
// search over the aligned starts, exits when the batch lies past the tile's
// pairs or after its early exit, and resumes each pixel from the batch's
// checkpoint. With the saved colour C and final T, the suffix S = C − P
// needs only the running prefix P·g, which starts at C_prefix·g.
//  * Each warp owns a compact 16×8 pixel block (each lane a 1×4 row), and
//    when the batch is staged one thread per pair computes a conservative
//    pixel box of the ellipse dᵀQd ≤ 2·ln(255·op) where α ≥ 1/255 can hold
//    (`cull_box`, in double, padded for the f32 rounding of `blend`). A
//    warp whose block misses the box, or whose pixels are all done, skips
//    the pair (warp-uniform): no expf, no shuffles, no stores. Every pair it
//    skips gives ok == false on all its pixels, so no decision changes.
//  * A warp with a contributing pixel sums its 9 per-pair terms with a
//    shuffle tree and marks the pair in a shared bit mask; the CTA then sums
//    the marked warps' partials per pair in a fixed warp order.
//    - K1b: two float4 atomics (columns 0–3, 4–7) and one scalar atomic per
//      pair into the zero-initialised (N+1, 16) table (row = field 9, the
//      row id). Float atomics make the order of the sums across batches
//      vary from run to run: K1b holds to a tolerance, not bits.
//    - K6: the pair's 16-float row into its own slot (slots belong to one
//      batch: no atomics, the same bits on every launch). Columns: 0-1 d mean
//      = conic · Σ(dpower·dx, dpower·dy), 2-4 d conic (scaled −½, −1, −½), 5 d
//      opacity, 6-8 d colour, 9-15 zero. Slots that get no contribution keep
//      the zeros the caller allocated.
// The α / contrib / trigger decisions are one __device__ function, `blend`,
// shared by all kernels; it repeats the plain PyTorch version's f32
// arithmetic op for op (this file is compiled with --fmad=false). The TPU's
// bf16 mantissa splits (REDUCE_SPLIT), SMEM scalar streaming and 128-lane
// row padding are not ported: all f32, and no tensor cores (the per-pair sums
// are ragged 128-pixel reductions, and TF32 would drop mantissa bits).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;
constexpr int kPix = kTile * kTile;
constexpr int kThreads = 256;
constexpr int kPerThread = kPix / kThreads;  // backward: 4 pixels a thread
constexpr int kWarps = kThreads / 32;
constexpr int kBlockW = 16;  // one backward warp's pixel block: 16 × 8
constexpr int kBlockH = 8;
constexpr int kChunk = 128;  // pairs per batch
constexpr int kFields = 16;  // floats per fields_ext row
constexpr int kState = 4;    // checkpointed floats per pixel: T, r, g, b
constexpr int kGrads = 9;
constexpr unsigned kFull = 0xffffffffu;
// Same f32 values as the Python constants 0.99, 1/255 and 1e-4.
constexpr float kAlphaClamp = (float)0.99;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kTEps = (float)1e-4;

struct Blend {
  float alpha, test_t, gauss, dx, dy;
  bool ok, contrib, trigger;
};

// The part of `blend` that does not read the transmittance.
__device__ __forceinline__ Blend blend_alpha(float mx, float my, float ca,
                                             float cb, float cc, float op,
                                             float px, float py) {
  Blend b;
  b.dx = px - mx;
  b.dy = py - my;
  const float power =
      -0.5f * (ca * b.dx * b.dx + cc * b.dy * b.dy) - cb * b.dx * b.dy;
  b.gauss = expf(power);
  const float raw = op * b.gauss;
  b.alpha = raw < kAlphaClamp ? raw : kAlphaClamp;
  b.ok = (power <= 0.0f) && (b.alpha >= kAlphaMin);
  return b;
}

// The rest: the decisions at transmittance `trans`.
__device__ __forceinline__ void blend_at(Blend& b, float trans) {
  b.test_t = trans * (1.0f - b.alpha);
  b.trigger = b.ok && (b.test_t < kTEps);
  b.contrib = b.ok && !b.trigger;
}

// The compositing decision for one live pixel and one pair.
__device__ __forceinline__ Blend blend(float mx, float my, float ca, float cb,
                                       float cc, float op, float px, float py,
                                       float trans) {
  Blend b = blend_alpha(mx, my, ca, cb, cc, op, px, py);
  blend_at(b, trans);
  return b;
}

// Pixel box (x_lo, x_hi, y_lo, y_hi) outside which `blend` gives ok ==
// false for this pair. α ≥ 1/255 needs dᵀQd ≤ t = 2·ln(255·op), Q the
// conic; the ellipse's half-widths are √(t·c/det) and √(t·a/det). In
// double; t grows by a relative margin for the f32 evaluation of `power`
// (its error is a few ulp of the terms, which reach t·ac/det on the
// ellipse) and the half-widths by 1 px plus a relative part for the f32
// rounding of px − mx. An infinite box (no cull) when det ≤ 0, a ≤ 0,
// op ≤ 1/255, the conic is nearly degenerate or anything is not finite.
// The plain PyTorch version is `cull_box_plain` in composite_cuda.py.
__device__ __forceinline__ float4 cull_box(float mx, float my, float ca,
                                           float cb, float cc, float op) {
  const float4 all = make_float4(-INFINITY, INFINITY, -INFINITY, INFINITY);
  const double a = ca, b = cb, c = cc;
  const double det = a * c - b * b;
  if (!(det > 0.0 && a > 0.0 && op > kAlphaMin)) return all;
  const double ratio = a * c / det;  // ≥ 1
  if (!(ratio < 1e5)) return all;
  const double t = fmax(2.0 * log(255.0 * static_cast<double>(op)), 0.0);
  const double te = (t * 1.0001 + 1e-5) * (1.0 + 4e-6 * ratio);
  const double hx = sqrt(te * c / det) + 1.0 + 1e-6 * fabs((double)mx);
  const double hy = sqrt(te * a / det) + 1.0 + 1e-6 * fabs((double)my);
  // A NaN mean gives NaN bounds, which cull nothing (the overlap test is
  // written so); an infinite one culls the pair, which no pixel can take.
  return make_float4(static_cast<float>(mx - hx), static_cast<float>(mx + hx),
                     static_cast<float>(my - hy), static_cast<float>(my + hy));
}

// The row of pair slot `slot`: fields[pg[slot]] (kIndexed; an id out of
// range reads row 0, the zero row) or fields[slot] (direct; a slot out of
// range reads zeros).
template <bool kIndexed>
__device__ __forceinline__ void load_row(const float* __restrict__ fields,
                                         const int* __restrict__ pg, int slot,
                                         int nrows, float4& a, float4& b,
                                         float4& c) {
  int row = kIndexed ? pg[slot] : slot;
  a = b = c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (static_cast<unsigned>(row) >= static_cast<unsigned>(nrows)) row = -1;
  if (kIndexed && row < 0) row = 0;
  if (row >= 0) {
    const float4* src = reinterpret_cast<const float4*>(
        fields + static_cast<size_t>(row) * kFields);
    a = src[0]; b = src[1]; c = src[2];
  }
}

constexpr int kCluster = 4;  // CTAs per tile in the forward: one quarter each
constexpr int kQuarter = kTile / 2;
constexpr int kFwdW = 8;  // one forward warp's pixel block: 8 × 4
constexpr int kFwdH = 4;

// K1f: one cluster of 4 CTAs per tile. CTA `rank` owns 16×16 quarter
// (rank & 1, rank >> 1) of the tile, each warp a compact 8×4 block, one
// pixel a thread.
template <bool kIndexed, bool kSave>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
forward_kernel(const float* __restrict__ fields, const int* __restrict__ pg,
               const int* __restrict__ starts, const int* __restrict__ counts,
               float* __restrict__ rgb, float* __restrict__ final_t,
               int* __restrict__ n_contrib, float* __restrict__ ckpt,
               int* __restrict__ ckpt_n, int* __restrict__ swept, int ntx,
               int nrows, int nbatches) {
  // Staged pairs: (mx, my, ca, cb), (cc, op, r, g), (b, row id, -, -).
  __shared__ float4 sp[3][kChunk];
  __shared__ float4 box[kChunk];
  __shared__ int flags[2][kCluster];  // the cluster's liveness, two buffers

  cg::cluster_group cluster = cg::this_cluster();
  const int tile = blockIdx.x / kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int start = starts[tile];
  const int count = counts[tile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bx = (rank & 1) * kQuarter + (warp & 1) * kFwdW;
  const int by = (rank >> 1) * kQuarter + (warp >> 1) * kFwdH;
  const int lx = bx + (lane % kFwdW), ly = by + lane / kFwdW;
  const int p0 = ly * kTile + lx;
  const float tx0 = static_cast<float>((tile % ntx) * kTile);
  const float ty0 = static_cast<float>((tile / ntx) * kTile);
  const float wx0 = tx0 + bx, wx1 = wx0 + (kFwdW - 1);
  const float wy0 = ty0 + by, wy1 = wy0 + (kFwdH - 1);
  const float px = tx0 + lx, py = ty0 + ly;

  float trans = 1.0f, cr = 0.0f, cgr = 0.0f, cb = 0.0f;
  int cnt = 0;
  bool done = false;

  // Thread j < 128 stages pair j of every batch, its row loaded a batch
  // ahead.
  float4 r0, r1, r2;
  if (threadIdx.x < kChunk && threadIdx.x < count)
    load_row<kIndexed>(fields, pg, start + threadIdx.x, nrows, r0, r1, r2);
  // Distributed shared memory is addressed only once every CTA of the
  // cluster is known to have started.
  cluster.sync();
  int nswept = 0;
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    if (kSave) {
      // Each pixel's state at the start of this batch.
      const int b = (start + c0) / kChunk;
      if (b < nbatches) {
        float* dst = ckpt + static_cast<size_t>(b) * kState * kPix + p0;
        dst[0] = trans;
        dst[kPix] = cr;
        dst[2 * kPix] = cgr;
        dst[3 * kPix] = cb;
        ckpt_n[static_cast<size_t>(b) * kPix + p0] = 2 * cnt + done;
      }
    }
    if (threadIdx.x < n) {
      sp[0][threadIdx.x] = r0;
      sp[1][threadIdx.x] = r1;
      sp[2][threadIdx.x] = r2;
      box[threadIdx.x] = cull_box(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y);
    }
    __syncthreads();
    // The next batch's rows load while this one is swept.
    if (threadIdx.x < kChunk && c0 + kChunk + threadIdx.x < count)
      load_row<kIndexed>(fields, pg, start + c0 + kChunk + threadIdx.x,
                         nrows, r0, r1, r2);

    bool warp_live = __any_sync(kFull, !done);
    for (int j0 = 0; j0 < n && warp_live; j0 += 32) {
      // Lane l tests pair j0 + l against the warp's block (a NaN bound
      // overlaps); the warp then sweeps the pairs that overlap, in order.
      bool meets = false;
      if (j0 + lane < n) {
        const float4 bb = box[j0 + lane];
        meets = !(bb.y < wx0 || bb.x > wx1 || bb.w < wy0 || bb.z > wy1);
      }
      // The α of two overlapping pairs at a time (it does not read T),
      // then each pair's step in depth order.
      auto alpha = [&](int j) {
        const float4 s0 = sp[0][j], s1 = sp[1][j];
        return blend_alpha(s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, px, py);
      };
      auto step = [&](int j, Blend& o) {
        if (done) return false;
        const float4 s1 = sp[1][j], s2 = sp[2][j];
        blend_at(o, trans);
        if (o.contrib) {
          const float w = o.alpha * trans;
          cr = cr + w * s1.z;
          cgr = cgr + w * s1.w;
          cb = cb + w * s2.x;
          trans = o.test_t;
          cnt += 1;
        }
        if (o.trigger) done = true;
        return o.trigger;
      };
      unsigned m = __ballot_sync(kFull, meets);
      while (m != 0u && warp_live) {
        const int ja = j0 + __ffs(m) - 1;
        m &= m - 1u;
        const bool two = m != 0u;
        const int jb = two ? j0 + __ffs(m) - 1 : ja;
        if (two) m &= m - 1u;
        Blend oa = alpha(ja), ob = alpha(jb);
        bool trig = step(ja, oa);
        if (two) trig = step(jb, ob) || trig;
        if (__any_sync(kFull, trig)) warp_live = __any_sync(kFull, !done);
      }
    }
    ++nswept;
    // The tile's stop rule over its four quarters: each CTA writes its
    // flag into slot `rank` of every peer's buffer, one cluster barrier,
    // then each reads its own four slots. Two buffers: a peer writes this
    // buffer again only after the next barrier, which every thread here
    // reaches after reading it.
    const int any = __syncthreads_or(!done);
    int* buf = flags[nswept & 1];
    if (threadIdx.x < kCluster)
      cluster.map_shared_rank(buf, threadIdx.x)[rank] = any != 0;
    cluster.sync();
    if (!(buf[0] | buf[1] | buf[2] | buf[3])) break;
  }
  // No CTA leaves while a peer may still address its shared memory.
  cluster.sync();
  if (kSave && rank == 0 && threadIdx.x == 0) swept[tile] = nswept;

  const size_t o = static_cast<size_t>(tile) * kPix + p0;
  const size_t o3 = static_cast<size_t>(tile) * 3 * kPix + p0;
  rgb[o3] = cr;
  rgb[o3 + kPix] = cgr;
  rgb[o3 + 2 * kPix] = cb;
  final_t[o] = trans;
  n_contrib[o] = cnt;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One backward CTA: batch `blockIdx.x` of the padded layout, i.e. slots
// [128·b, 128·b + 128). kPairs: K6 (direct rows in, one row per slot out);
// else K1b (rows through pg, atomics into the per-Gaussian table).
template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
backward_kernel(const float* __restrict__ fields, const int* __restrict__ pg,
                const int* __restrict__ starts, const int* __restrict__ counts,
                const float* __restrict__ ckpt, const int* __restrict__ ckpt_n,
                const int* __restrict__ swept, const float* __restrict__ rgb,
                const float* __restrict__ final_t,
                const float* __restrict__ drgb, const float* __restrict__ dt,
                float* __restrict__ out, int num_tiles, int ntx, int nrows) {
  // Staged pairs: (mx, my, ca, cb), (cc, op, r, g), (b, row id, -, -).
  __shared__ float4 sp[3][kChunk];
  __shared__ float4 box[kChunk];
  __shared__ float part[kWarps][kGrads][kChunk];
  __shared__ unsigned hit[kChunk];  // bit w: warp w has partials of pair j

  // The tile owning this batch: the last one whose start is ≤ its first
  // slot (empty tiles share their successor's start and come before it).
  const int b = blockIdx.x;
  const int slot0 = b * kChunk;
  int lo = 0, hi = num_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (starts[mid] <= slot0) lo = mid + 1; else hi = mid;
  }
  const int tile = lo - 1;
  if (tile < 0) return;
  const int c0 = slot0 - starts[tile];
  if (c0 >= counts[tile] || c0 / kChunk >= swept[tile]) return;
  const int n = min(kChunk, counts[tile] - c0);

  for (int j = threadIdx.x; j < kChunk; j += kThreads) {
    hit[j] = 0u;
    if (j < n) {
      float4 r0, r1, r2;
      load_row<!kPairs>(fields, pg, slot0 + j, nrows, r0, r1, r2);
      sp[0][j] = r0;
      sp[1][j] = r1;
      sp[2][j] = r2;
      box[j] = cull_box(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y);
    }
  }

  // This thread's 4 pixels: a 1×4 row of its warp's 16×8 block.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bx = (warp & 1) * kBlockW, by = (warp >> 1) * kBlockH;
  const int lx = bx + (lane & 3) * kPerThread, ly = by + (lane >> 2);
  const int p0 = ly * kTile + lx;
  const float tx0 = static_cast<float>((tile % ntx) * kTile);
  const float ty0 = static_cast<float>((tile / ntx) * kTile);
  const float wx0 = tx0 + bx, wx1 = wx0 + (kBlockW - 1);
  const float wy0 = ty0 + by, wy1 = wy0 + (kBlockH - 1);
  const float py = ty0 + ly;

  const size_t img = static_cast<size_t>(tile) * kPix + p0;
  const size_t img3 = static_cast<size_t>(tile) * 3 * kPix + p0;
  const size_t cp = static_cast<size_t>(b) * kState * kPix + p0;
  const float4 t4 = ld4(ckpt + cp), pr4 = ld4(ckpt + cp + kPix);
  const float4 pg4 = ld4(ckpt + cp + 2 * kPix), pb4 = ld4(ckpt + cp + 3 * kPix);
  const int4 n4 = *reinterpret_cast<const int4*>(ckpt_n + static_cast<size_t>(b) * kPix + p0);
  const float4 gr4 = ld4(drgb + img3), gg4 = ld4(drgb + img3 + kPix);
  const float4 gb4 = ld4(drgb + img3 + 2 * kPix), dt4 = ld4(dt + img);
  const float4 ft4 = ld4(final_t + img);
  const float4 cr4 = ld4(rgb + img3), cg4 = ld4(rgb + img3 + kPix);
  const float4 cb4 = ld4(rgb + img3 + 2 * kPix);
  const float tt[4] = {t4.x, t4.y, t4.z, t4.w};
  const float pr[4] = {pr4.x, pr4.y, pr4.z, pr4.w};
  const float pgc[4] = {pg4.x, pg4.y, pg4.z, pg4.w};
  const float pb[4] = {pb4.x, pb4.y, pb4.z, pb4.w};
  const int nn[4] = {n4.x, n4.y, n4.z, n4.w};
  const float g_r[4] = {gr4.x, gr4.y, gr4.z, gr4.w};
  const float g_g[4] = {gg4.x, gg4.y, gg4.z, gg4.w};
  const float g_b[4] = {gb4.x, gb4.y, gb4.z, gb4.w};
  const float dtt[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
  const float ft[4] = {ft4.x, ft4.y, ft4.z, ft4.w};
  const float c_r[4] = {cr4.x, cr4.y, cr4.z, cr4.w};
  const float c_g[4] = {cg4.x, cg4.y, cg4.z, cg4.w};
  const float c_b[4] = {cb4.x, cb4.y, cb4.z, cb4.w};

  float px[kPerThread], trans[kPerThread], gr[kPerThread], gg[kPerThread];
  float gb[kPerThread], gt_tf[kPerThread], cg_img[kPerThread];
  float pg_dot[kPerThread];
  bool done[kPerThread];
  bool mine = false;  // any of this thread's pixels still live
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    px[k] = tx0 + static_cast<float>(lx + k);
    trans[k] = tt[k];
    gr[k] = g_r[k];
    gg[k] = g_g[k];
    gb[k] = g_b[k];
    gt_tf[k] = dtt[k] * ft[k];
    cg_img[k] = c_r[k] * gr[k] + c_g[k] * gg[k] + c_b[k] * gb[k];
    // P·g at the batch start, from the forward's colour prefix.
    pg_dot[k] = pr[k] * gr[k] + pgc[k] * gg[k] + pb[k] * gb[k];
    done[k] = (nn[k] & 1) != 0;
    mine = mine || !done[k];
  }
  __syncthreads();

  bool warp_live = __any_sync(kFull, mine);
  for (int j = 0; j < n && warp_live; ++j) {
    const float4 bb = box[j];
    // Skip unless the block overlaps the box (a NaN bound overlaps).
    if (bb.y < wx0 || bb.x > wx1 || bb.w < wy0 || bb.z > wy1) continue;
    const float4 s0 = sp[0][j], s1 = sp[1][j], s2 = sp[2][j];
    const float op = s1.y;
    float acc[kGrads];
#pragma unroll
    for (int f = 0; f < kGrads; ++f) acc[f] = 0.0f;
    bool any = false, trig = false;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (done[k]) continue;
      const Blend o = blend(s0.x, s0.y, s0.z, s0.w, s1.x, op, px[k], py,
                            trans[k]);
      if (o.contrib) {
        const float w = o.alpha * trans[k];
        const float dot_cg = s1.z * gr[k] + s1.w * gg[k] + s2.x * gb[k];
        pg_dot[k] = pg_dot[k] + w * dot_cg;
        // dL/dα = T·(c·g) − (S·g + gT·T_final)/(1 − α), S·g = C·g − P·g.
        float dalpha = trans[k] * dot_cg -
                       (cg_img[k] - pg_dot[k] + gt_tf[k]) / (1.0f - o.alpha);
        if (!(op * o.gauss < kAlphaClamp)) dalpha = 0.0f;  // α clamped
        const float dpower = dalpha * op * o.gauss;
        const float dpdx = dpower * o.dx;
        const float dpdy = dpower * o.dy;
        acc[0] += dpdx;
        acc[1] += dpdy;
        acc[2] += dpdx * o.dx;
        acc[3] += dpdx * o.dy;
        acc[4] += dpdy * o.dy;
        acc[5] += dalpha * o.gauss;
        acc[6] += w * gr[k];
        acc[7] += w * gg[k];
        acc[8] += w * gb[k];
        trans[k] = o.test_t;
        any = true;
      }
      if (o.trigger) {
        done[k] = true;
        trig = true;
      }
    }
    if (__any_sync(kFull, any)) {
#pragma unroll
      for (int f = 0; f < kGrads; ++f) {
        float v = acc[f];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(kFull, v, off);
        acc[f] = v;
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kGrads; ++f) part[warp][f][j] = acc[f];
        atomicOr(&hit[j], 1u << warp);
      }
    }
    if (__any_sync(kFull, trig)) {
      bool live = false;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) live = live || !done[k];
      warp_live = __any_sync(kFull, live);
    }
  }
  __syncthreads();

  // Per pair: the marked warps' partials summed in warp order, with the
  // conic scales (−½, −1, −½ on fields 2..4).
  const int j = threadIdx.x;
  if (j >= n) return;
  const unsigned mask = hit[j];
  if (mask == 0u) return;  // no contribution: nothing to add or write
  float s[kGrads];
#pragma unroll
  for (int f = 0; f < kGrads; ++f) s[f] = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (mask & (1u << w)) {
#pragma unroll
      for (int f = 0; f < kGrads; ++f) s[f] += part[w][f][j];
    }
  }
  s[2] *= -0.5f;
  s[3] = -s[3];
  s[4] *= -0.5f;
  const float4 s0 = sp[0][j], s1 = sp[1][j];
  if (kPairs) {
    // d mean = conic · (Σ dpower·dx, Σ dpower·dy), the pair's own conic.
    const float m0 = s[0], m1 = s[1];
    float4* row = reinterpret_cast<float4*>(out + static_cast<size_t>(slot0 + j) * kFields);
    if (slot0 + j < nrows) {
      row[0] = make_float4(s0.z * m0 + s0.w * m1, s0.w * m0 + s1.x * m1,
                           s[2], s[3]);
      row[1] = make_float4(s[4], s[5], s[6], s[7]);
      row[2] = make_float4(s[8], 0.0f, 0.0f, 0.0f);
    }
  } else {
    const int gid = static_cast<int>(sp[2][j].y);
    if (static_cast<unsigned>(gid) >= static_cast<unsigned>(nrows)) return;
    float* dst = out + static_cast<size_t>(gid) * kFields;
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(s[0], s[1], s[2], s[3]));
    atomicAdd(reinterpret_cast<float4*>(dst + 4), make_float4(s[4], s[5], s[6], s[7]));
    atomicAdd(dst + 8, s[8]);
  }
}

}  // namespace

// K1f. `save`: also write the per-batch checkpoints (ckpt (nbatches, 4,
// 1024) f32, ckpt_n (nbatches, 1024) i32) and the swept counts (T,) i32
// that K1b / K6 resume from; `fields` are the per-Gaussian rows indexed
// through `pg` (indexed) or the gathered pair rows themselves.
extern "C" int yea_composite_forward(const float* fields, const int* pg,
                                     const int* starts, const int* counts,
                                     float* rgb, float* final_t,
                                     int* n_contrib, float* ckpt, int* ckpt_n,
                                     int* swept, int num_tiles, int ntx,
                                     int nrows, int nbatches, int indexed,
                                     int save, void* stream) {
  if (num_tiles > 0) {
    auto s = static_cast<cudaStream_t>(stream);
#define YEA_FWD(I, S)                                                       \
  forward_kernel<I, S><<<kCluster * num_tiles, kThreads, 0, s>>>(           \
      fields, pg, starts, counts, rgb, final_t, n_contrib, ckpt, ckpt_n,    \
      swept, ntx, nrows, nbatches)
    if (indexed && save) YEA_FWD(true, true);
    else if (indexed) YEA_FWD(true, false);
    else if (save) YEA_FWD(false, true);
    else YEA_FWD(false, false);
#undef YEA_FWD
  }
  return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters of K1f's cluster kernel, or −(CUDA error).
extern "C" int yea_composite_forward_clusters(int indexed, int save) {
  const void* fn =
      indexed ? (save ? reinterpret_cast<const void*>(forward_kernel<true, true>)
                      : reinterpret_cast<const void*>(forward_kernel<true, false>))
              : (save ? reinterpret_cast<const void*>(forward_kernel<false, true>)
                      : reinterpret_cast<const void*>(forward_kernel<false, false>));
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return n;
}

// K1b: raw per-Gaussian sums into the zeroed (nrows, 16) `dfields`.
extern "C" int yea_composite_backward(const float* fields, const int* pg,
                                      const int* starts, const int* counts,
                                      const float* ckpt, const int* ckpt_n,
                                      const int* swept, const float* rgb,
                                      const float* final_t, const float* drgb,
                                      const float* dt, float* dfields,
                                      int num_tiles, int nbatches, int ntx,
                                      int nrows, void* stream) {
  if (num_tiles > 0 && nbatches > 0)
    backward_kernel<false><<<nbatches, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        fields, pg, starts, counts, ckpt, ckpt_n, swept, rgb, final_t, drgb,
        dt, dfields, num_tiles, ntx, nrows);
  return static_cast<int>(cudaGetLastError());
}

// K6: one gradient row per pair slot into the zeroed (nrows, 16) `drows`.
extern "C" int yea_composite_backward_pairs(
    const float* rows, const int* starts, const int* counts,
    const float* ckpt, const int* ckpt_n, const int* swept, const float* rgb,
    const float* final_t, const float* drgb, const float* dt, float* drows,
    int num_tiles, int nbatches, int ntx, int nrows, void* stream) {
  if (num_tiles > 0 && nbatches > 0)
    backward_kernel<true><<<nbatches, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        rows, nullptr, starts, counts, ckpt, ckpt_n, swept, rgb, final_t,
        drgb, dt, drows, num_tiles, ntx, nrows);
  return static_cast<int>(cudaGetLastError());
}
