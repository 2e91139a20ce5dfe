// Record-space blend forward and backward for Hopper (sm_90a).
//
// Replaces vtgaussian_slam_tpu/ops/rasterizer/pallas_blend.py
//   K4 vtgs_blend_fwd <- blend_tiles / _blend_fwd_impl / _fwd_kernel
//   K5 vtgs_blend_bwd <- blend_tiles / _blend_bwd / _bwd_kernel
//
// Layouts (identical to the JAX package, except K5's output):
//   recs   (n_tiles, 16, mpt) f32 rows [mean2d.x mean2d.y conic.a conic.b
//          conic.c opacity colors(C <= 8) pad], depth-ordered per tile
//   counts (n_tiles,) i32
//   tids   null or (n_tiles,) i32 image tile per row, plus an int
//          tile_offset (a tile-sharded rank's range; walk.cuh:image_tile)
//   out    (n_tiles, 256, C) f32
//   g      (n_tiles, 256, C) f32 cotangent of out
//   K5 ->  (n_tiles, mpt, 16) f32 ROW-major per record [d mean2d (2),
//          d conic (3), d opacity, d colors (C), 0 ...]; the JAX kernel
//          writes (n_tiles, 16, mpt). Row-major lets the inverse-map gather
//          (binning.apply_slot_inverse) read one record's gradient as one
//          64-byte row. Records no pixel walked are zero.
//
// Both kernels: one CTA per 16x16 tile, one thread per pixel (256 threads),
// warp w on the 8 x 4 pixel block at (8 (w & 1), 4 (w >> 1)), records staged
// through shared memory a chunk at a time by cp.async. Pixels use GLOBAL
// coordinates and keep power <= 0 (the splat kernels keep <= 1e-3). A pixel
// stops at the first record whose transmittance after blending would fall
// below 1e-4 (not blended); the CTA leaves when all 256 pixels stopped.
// Every record carries a box bounding the pixels where alpha >= 1/255 can
// hold (`record_box`, from the conic alone), and a warp evaluates only the
// records whose box meets its block.
//
// K4, what bounds it on the H100: neither the bytes (the record rows, read
// once per tile, ~92 MB at room0 shapes, and 26 MB of output: ~35 us at 3.35
// TB/s) nor the operations (~0.11 ms at the fp32 peak, chip_smoke.py's
// bound) but the instruction slots and latency of the per-pair walk: under a
// tenth of the (pixel, record) pairs of a saturated 512-record tile blend,
// and a walk that evaluates every pair is one dependent chain per record
// with two branches, fed by 14 scalar shared-memory loads. What the design
// does about it (K1's, splat.cu, carried to record space; the list build is
// walk.cuh's `live_list`):
//  - the box cull removes the pairs: per chunk a lane tests one box per 32
//    records, a ballot and a popcount compact the warp's live records, in
//    record order, into a byte list padded to a whole group of 4;
//  - a pixel evaluates 4 live records at a time (alpha, the keep test and
//    the colour loads are independent of the walk's state) and blends them
//    front to back with selects, so the chain from one blend to the next is
//    T alone;
//  - records need no projection, so cp.async writes each 4-byte value
//    straight to its record-major place ([mx my a b] [c op col0 col1]
//    [col2 .. col5] [col6 col7]: a pair costs 4 vector loads, all lanes of
//    a warp on one address). Chunks of CH = 256 records go round a ring of
//    3 stages: while chunk i is walked, chunk i + 1 has arrived and every
//    thread takes the box of one of its records, and chunk i + 2 is in
//    flight; a chunk costs one block barrier. 53,280 B of dynamic shared
//    memory per CTA (set in the entry point) leave room for 4 CTAs per SM;
//  - the per-pair arithmetic is the simple walk's (dx = pixel - mean in
//    global coordinates on the raw means; only the box subtracts the tile
//    origin), each pixel blends the same records in the same order, and the
//    boxes drop only pairs the cuts drop: the output repeats, to the bit,
//    that of a walk which evaluates every pair. No atomics: a repeated
//    launch gives the same bits;
//  - a pixel's C sums leave as float4 stores where C is a multiple of 4 (a
//    warp's 8 x 4 block is four runs of 8 pixels x C floats).
//
// K5 replays the same walk and uses the suffix identity
//   dL/dalpha_k = T_k (g.c_k) - (G - H_k) / max(1 - alpha_k, 1e-6),
// G = sum_c g*out over all C channels, H_k the inclusive prefix of
// w_j (g.c_j), gated by kept & blended & not clamped (op*exp(power) <=
// 0.99). Per record it needs 6 + C sums over the tile's 256 pixels:
//   sum gp dx, sum gp dy, sum gp dx^2, sum gp dx dy, sum gp dy^2,
//   sum galpha exp(power), sum w g_c (C <= 8)       (gp = galpha * alpha)
//
// K5, what bounds it on the H100: not the bytes (~0.05 ms) and not the
// operations (~0.11 ms at the fp32 peak, chip_smoke.py's bound) but the
// issue slots and latency of the per-pair walk and of the 14 per-record
// pixel sums. What the design does about it (the template of splat.cu's
// backwards, carried to record space; the helpers are shared in walk.cuh):
//  - a warp evaluates only the records of a 16-record sub-chunk whose box
//    (`record_box`, K4's) meets its block;
//  - a pixel evaluates 4 live records at a time (alpha, g.c and
//    1 / (1 - alpha) are independent of the walk's state) and blends them
//    front to back with selects, so the chain between two blends is T and H;
//  - the pixel sums are two tensor-core products per warp and sub-chunk,
//      Mg = GP (16 records x 32 px) . PHI (32 x 8), PHI = [cx^2 cx*cy cy^2 cx cy 1 0 0]
//      Mw = W  (16 records x 32 px) . GC  (32 x 8), GC  = the C cotangent columns
//    (mma.sync m16n8k8, TF32 operands split a = hi + lo: GP . PHI as hi +
//    lo, PHI being exact; W . GC as hi.hi + hi.lo + lo.hi), cx, cy the
//    pixel's coordinates about the tile centre. The epilogue, one thread
//    per record, sums the 8 warps' partials in a fixed order and rebuilds
//    the dx / dy sums from the moments about the record mean (s_dx = M3 -
//    mx M5, s_dxx = M0 - 2 mx M3 + mx^2 M5, ...; sum galpha exp(power) =
//    M5 / op, since gp = galpha op exp(power) on every counted pair). No
//    warp shuffle tree and no float atomics: a repeated launch gives the
//    same bits;
//  - record rows arrive by cp.async, the next chunk's copies in flight
//    while this one is walked; warp 2 stages the next chunk while warp 0
//    runs the epilogue.
// The 14 partials per (warp, record) make shared memory the constraint:
// chunks of RCH = 32 records take 67,552 B per CTA (dynamic, set in the
// entry point), so 3 CTAs share an SM at ptxas' 78 registers; 64-record
// chunks would leave room for 2 (times in PERF.md).
#include "walk.cuh"

namespace {

using namespace vtgs;

constexpr int RECW = 16;
constexpr int CMAX = 8;

// The box of a record, (xlo, xhi, ylo, yhi) about its tile-local mean (mx,
// my), from the record alone: for the conic (a, b, c) with det = ac - b^2 >
// 0 the half-extents of Q <= r2 (walk.cuh, box_radius2) are sqrt(r2 c /
// det), sqrt(r2 a / det). det is lowered by a bound on its own rounding (a
// thin, ill-conditioned conic cancels in ac - b^2), which only widens the
// box. det <= 0 or an extent that is not finite: the whole tile (no cull).
// op < 1/255: empty.
__device__ __forceinline__ float4 record_box(float mx, float my, float ca,
                                             float cb, float cc, float op) {
  if (!(op >= ALPHA_MIN)) return make_float4(1e30f, -1e30f, 1e30f, -1e30f);
  const float r2 = box_radius2(op);
  const float ac = ca * cc, bb = cb * cb;
  const float det = (ac - bb) - 1e-6f * (fabsf(ac) + bb);
  const float hx = sqrtf(r2 * cc / det), hy = sqrtf(r2 * ca / det);
  const bool whole = !(det > 0.0f) || !(hx <= 3e38f) || !(hy <= 3e38f);
  return whole ? make_float4(-1e30f, 1e30f, -1e30f, 1e30f)
               : make_float4(mx - hx, mx + hx, my - hy, my + hy);
}

// ---- K4 --------------------------------------------------------------------
constexpr int CH = 256;             // records per K4 chunk
constexpr int NBUF = 3;             // K4's ring: walked, arrived, in flight
static_assert(CH % 32 == 0 && CH <= TPX, "a thread takes one box per chunk");
static_assert(CH <= 256 && NG == 4, "a group's 4 record indices are 4 bytes");

// One chunk of records as K4's walk reads it, record-major.
struct RecStage {
  float4 q[3][CH];   // [mx my ca cb] [cc op col0 col1] [col2 col3 col4 col5]
  float2 r[CH];      // [col6 col7]          (the mean in GLOBAL pixels)
};

struct FwdSmem {
  RecStage st[NBUF];
  float4 box[2][CH];                  // xlo xhi ylo yhi, tile-local
  unsigned live[NWARP][CH / 4 + 1];   // per warp: its live records of the chunk
};

// copy columns [c0, c0 + CH) of the first `rows` record rows of a tile to
// their record-major places; columns at or past count are zero-filled
__device__ __forceinline__ void copy_records(RecStage& st, const float* src,
                                             int rows, int mpt, int c0,
                                             int count, int p) {
  for (int i = p; i < rows * CH; i += TPX) {
    const int row = i / CH, col = i % CH;
    const bool ok = c0 + col < count;
    float* dst =
        row < 12 ? reinterpret_cast<float*>(&st.q[row >> 2][col]) + (row & 3)
                 : reinterpret_cast<float*>(&st.r[col]) + (row - 12);
    cp_async4(dst, src + (size_t)row * mpt + (ok ? c0 + col : 0), ok);
  }
  cp_async_commit();
}

__device__ __forceinline__ float4 stage_box(const RecStage& st, int k,
                                            float tox, float toy) {
  const float4 a = st.q[0][k];
  const float4 b = st.q[1][k];
  return record_box(a.x - tox, a.y - toy, a.z, a.w, b.x, b.y);
}

__global__ void __launch_bounds__(TPX, 4)
blend_fwd_kernel(const float* __restrict__ recs, const int* __restrict__ counts,
                 const int* __restrict__ tids, int mpt, int tiles_x,
                 int tile_offset, int C, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_buf[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_buf);
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31;
  const int count = counts[tile];
  const float* tr = recs + (size_t)tile * RECW * mpt;
  const int it = image_tile(tids, tile, tile_offset);
  const int tx0 = (it % tiles_x) * TILE, ty0 = (it / tiles_x) * TILE;
  const float tox = (float)tx0, toy = (float)ty0;
  const WarpBlock wb(warp, lane);
  // the pairs are evaluated in global pixel coordinates on the raw means
  const float px = (float)(tx0 + wb.pix % TILE);
  const float py = (float)(ty0 + wb.pix / TILE);
  const int rows = 6 + C;
  unsigned char* lst = reinterpret_cast<unsigned char*>(sm.live[warp]);

  if (count > 0) {
    copy_records(sm.st[0], tr, rows, mpt, 0, count, p);
    cp_async_wait_all();
  }
  __syncthreads();
  if (p < min(CH, count)) sm.box[0][p] = stage_box(sm.st[0], p, tox, toy);
  if (CH < count) {
    copy_records(sm.st[1], tr, rows, mpt, CH, count, p);
    cp_async_wait_all();
  }
  __syncthreads();

  float T = 1.0f;
  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.0f;
  bool done = false;
  int buf = 0, bb = 0;
  // at the top of each turn: chunk c0 is in st[buf] with its boxes in
  // box[bb], chunk c0 + CH has arrived in the next stage of the ring, and
  // the stage after that (chunk c0 - CH's) is free
  for (int c0 = 0; c0 < count; c0 += CH, bb ^= 1) {
    const int n = min(CH, count - c0);
    const int nxt = buf + 1 < NBUF ? buf + 1 : 0;
    const int aft = nxt + 1 < NBUF ? nxt + 1 : 0;
    if (c0 + 2 * CH < count)
      copy_records(sm.st[aft], tr, rows, mpt, c0 + 2 * CH, count, p);
    if (p < CH && c0 + CH + p < count)
      sm.box[bb ^ 1][p] = stage_box(sm.st[nxt], p, tox, toy);
    const RecStage& st = sm.st[buf];

    if (!__all_sync(FULL, done)) {
      // the chunk's records whose box meets this warp's block, compacted in
      // record order into the warp's list
      const int L = live_list(lst, sm.box[bb], n, wb, lane);
      for (int i0 = 0; i0 < L; i0 += NG) {
        if (__all_sync(FULL, done)) break;
        // evaluate NG live records independently, then blend them front to
        // back with selects, not branches: the chain from one blend to the
        // next is T alone
        const unsigned ks = *reinterpret_cast<const unsigned*>(lst + i0);
        float al[NG];
        bool kp[NG];
        float col[NG][CMAX];
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int k = (ks >> (8 * j)) & 0xffu;
          const float4 a = st.q[0][k];
          const float4 b = st.q[1][k];
          const float4 c4 = st.q[2][k];
          const float2 c2 = st.r[k];
          const float dx = px - a.x, dy = py - a.y;
          const float power =
              -0.5f * (a.z * dx * dx + b.x * dy * dy) - a.w * dx * dy;
          al[j] = fminf(ALPHA_MAX, b.y * expf(power));
          kp[j] = i0 + j < L && power <= 0.0f && al[j] >= ALPHA_MIN;
          col[j][0] = b.z;  col[j][1] = b.w;  col[j][2] = c4.x;
          col[j][3] = c4.y; col[j][4] = c4.z; col[j][5] = c4.w;
          col[j][6] = c2.x; col[j][7] = c2.y;
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const bool keep = kp[j] && !done;
          const float Ta = T * (1.0f - al[j]);
          const bool stop = keep && Ta < T_TERM;
          const bool blend = keep && !stop;
          done = done || stop;
          const float w = blend ? al[j] * T : 0.0f;
#pragma unroll
          for (int c = 0; c < CMAX; ++c) acc[c] += w * col[j][c];
          T = blend ? Ta : T;
        }
      }
    }
    cp_async_wait_all();   // the records of chunk c0 + 2 CH, for the next turn
    buf = nxt;
    // also the barrier that publishes box[bb ^ 1] and frees this chunk's stage
    if (__syncthreads_or(!done) == 0) break;
  }
  // channels at or past C summed whatever their stage held; they stay here
  float* o = out + ((size_t)tile * TPX + wb.pix) * C;
  if ((C & 3) == 0) {
    float4* o4 = reinterpret_cast<float4*>(o);
    o4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (C == CMAX) o4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < C) o[c] = acc[c];
  }
}

// ---- K5 --------------------------------------------------------------------
constexpr int RCH = 32;             // records per K5 chunk
constexpr int NPR = 6 + CMAX;       // per-record partials Mg[0:6], Mw[0:8]
constexpr int RROWS = 6 + CMAX;     // record rows the kernel reads at most
static_assert(RCH % SC == 0 && 2 * RCH <= TPX, "a chunk holds whole sub-chunks");

struct RecSmem {
  float4 s0[RCH];                   // mx my ca cb (mean tile-local, in pixels)
  float2 s1[RCH];                   // cc op
  float4 c0[RCH], c1[RCH];          // colors 0-3, 4-7 (0 at or past C)
  float4 box[RCH];                  // xlo xhi ylo yhi: where a pair can be kept
  float raw[2][RROWS * RCH];        // raw record rows, double buffered
  float2 pw[NWARP][SC * 32];        // per warp: (gp, w), [record][pixel ^ sw]
  float part[NWARP][RCH][NPR];      // per warp and record: Mg, Mw partials
  float phi[6][PST];                // PHI^T: [cx^2 cx*cy cy^2 cx cy 1] per pixel
  float gct[CMAX][PST];             // GC^T: the cotangent columns per pixel
};

// Stage record k of the raw chunk (6 + C, RCH), with its box.
__device__ __forceinline__ void stage_record(RecSmem& sm, const float* raw,
                                             int k, int C, float tox,
                                             float toy) {
  const float mx = raw[k] - tox, my = raw[RCH + k] - toy;
  const float ca = raw[2 * RCH + k], cb = raw[3 * RCH + k];
  const float cc = raw[4 * RCH + k], op = raw[5 * RCH + k];
  const float4 box = record_box(mx, my, ca, cb, cc, op);
  float col[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) col[c] = c < C ? raw[(6 + c) * RCH + k] : 0.0f;
  sm.s0[k] = make_float4(mx, my, ca, cb);
  sm.s1[k] = make_float2(cc, op);
  sm.c0[k] = make_float4(col[0], col[1], col[2], col[3]);
  sm.c1[k] = make_float4(col[4], col[5], col[6], col[7]);
  sm.box[k] = box;
}

__global__ void __launch_bounds__(TPX, 3)
blend_bwd_kernel(const float* __restrict__ recs, const int* __restrict__ counts,
                 const int* __restrict__ tids, const float* __restrict__ out,
                 const float* __restrict__ gin, int mpt, int tiles_x,
                 int tile_offset, int C, float* __restrict__ grad) {
  extern __shared__ __align__(16) unsigned char smem_buf[];
  RecSmem& sm = *reinterpret_cast<RecSmem*>(smem_buf);
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31;
  const int gq = lane >> 2, tq = lane & 3;   // mma group and thread in group
  const int count = counts[tile];
  const float* tr = recs + (size_t)tile * RECW * mpt;
  const int it = image_tile(tids, tile, tile_offset);
  const float tox = (float)((it % tiles_x) * TILE);
  const float toy = (float)((it / tiles_x) * TILE);
  const WarpBlock wb(warp, lane);
  const int rows = 6 + C;

  const float* gpix = gin + ((size_t)tile * TPX + wb.pix) * C;
  const float* opix = out + ((size_t)tile * TPX + wb.pix) * C;
  float g[CMAX];
  float GG = 0.0f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    g[c] = c < C ? gpix[c] : 0.0f;
    if (c < C) GG += g[c] * opix[c];
    sm.gct[c][wb.pix] = g[c];
  }
  {
    const float cx = wb.lx - 7.5f, cy = wb.ly - 7.5f;
    sm.phi[0][wb.pix] = cx * cx;
    sm.phi[1][wb.pix] = cx * cy;
    sm.phi[2][wb.pix] = cy * cy;
    sm.phi[3][wb.pix] = cx;
    sm.phi[4][wb.pix] = cy;
    sm.phi[5][wb.pix] = 1.0f;
  }
  if (count > 0) {
    copy_rows<RCH>(sm.raw[0], tr, rows, mpt, 0, count, p);
    cp_async_wait_all();
  }
  __syncthreads();

  float T = 1.0f, H = 0.0f;
  bool done = false;
  int written = 0;   // records [0, written) hold their gradient
  float2* pwb = sm.pw[warp];
  const char* pa_lane = reinterpret_cast<const char*>(pwb) + gq * 256 + tq * 8;
  const uint32_t swz = 32u * gq;
  int buf = 0;
  // the first chunk's stage; each later one is staged by warp 2 while the
  // first warp finishes the chunk before it
  constexpr int RSW = 2 * 32;   // first thread of the staging warp
  if (p < min(RCH, count)) stage_record(sm, sm.raw[0], p, C, tox, toy);
  __syncthreads();
  for (int c0 = 0; c0 < count; c0 += RCH, buf ^= 1) {
    const int n = min(RCH, count - c0);
    const bool more = c0 + RCH < count;
    if (more)
      copy_rows<RCH>(sm.raw[buf ^ 1], tr, rows, mpt, c0 + RCH, count, p);

    for (int k0 = 0; k0 < n; k0 += SC) {
      // the sub-chunk's records that one of this warp's 8 x 4 pixels can keep
      const bool in = lane < SC && k0 + lane < n && wb.meets(sm.box[k0 + lane]);
      const unsigned live = __ballot_sync(FULL, in);   // bit j: record k0 + j
      bool act = false;
      if (live != 0u && !__all_sync(FULL, done)) {
        unsigned m = live;
        while (m != 0u) {
          int kj[NG];
          float al[NG], ar[NG], gcv[NG], rom[NG];
          bool kp[NG];
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            kj[j] = m != 0u ? __ffs(m) - 1 : -1;
            m &= m - 1u;
            const int k = k0 + max(kj[j], 0);
            const float4 s0 = sm.s0[k];
            const float2 s1 = sm.s1[k];
            const float4 q0 = sm.c0[k], q1 = sm.c1[k];
            const float dx = wb.lx - s0.x, dy = wb.ly - s0.y;
            const float power = -0.5f * (s0.z * dx * dx + s1.x * dy * dy) -
                                s0.w * dx * dy;
            ar[j] = s1.y * expf(power);
            al[j] = fminf(ALPHA_MAX, ar[j]);
            kp[j] = kj[j] >= 0 && power <= 0.0f && al[j] >= ALPHA_MIN;
            gcv[j] = g[0] * q0.x + g[1] * q0.y + g[2] * q0.z + g[3] * q0.w +
                     g[4] * q1.x + g[5] * q1.y + g[6] * q1.z + g[7] * q1.w;
            rom[j] = __fdividef(1.0f, fmaxf(1.0f - al[j], 1e-6f));
          }
#pragma unroll
          for (int j = 0; j < NG; ++j) {
            if (kj[j] < 0) break;
            const bool keep = kp[j] && !done;
            const float Ta = T * (1.0f - al[j]);
            const bool stop = keep && Ta < T_TERM;
            const bool blend = keep && !stop;
            done = done || stop;
            const float w = blend ? al[j] * T : 0.0f;
            H += w * gcv[j];
            const float ga = (ar[j] > ALPHA_MAX)
                                 ? 0.0f
                                 : T * gcv[j] - (GG - H) * rom[j];
            const float gp = blend ? ga * al[j] : 0.0f;
            act = act || blend;
            T = blend ? Ta : T;
            pwb[pw_at(kj[j], lane)] = make_float2(gp, w);
          }
        }
      }
      // the per-record pixel sums of the sub-chunk over the warp's 32 pixels
      float mg[2][4] = {}, mw[3][4] = {};
      // lanes 8 ks .. 8 ks + 7 (pixel row ks of the block) are k-slice ks
      // of the products; one in which no pixel blended adds nothing
      const unsigned am = __ballot_sync(FULL, act);
      if (am != 0u) {
        __syncwarp();
        // rows of records the warp skipped hold stale values: read them as 0
        const bool r0 = (live >> gq) & 1u, r1 = (live >> (gq + 8)) & 1u;
        const float2 zero = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (((am >> (8 * ks)) & 0xffu) == 0u) continue;
          // pw_at(gq (+ 8), 8 ks + tq (+ 4)) in bytes: the swizzle of rows
          // gq and gq + 8 is 32 gq, the column's 8 tq stays clear of it
          const char* a0 = pa_lane + ((64u * ks) ^ swz);
          const char* a1 = pa_lane + ((64u * ks + 32u) ^ swz);
          const float2 e[4] = {
              r0 ? *reinterpret_cast<const float2*>(a0) : zero,
              r1 ? *reinterpret_cast<const float2*>(a0 + 2048) : zero,
              r0 ? *reinterpret_cast<const float2*>(a1) : zero,
              r1 ? *reinterpret_cast<const float2*>(a1 + 2048) : zero};
          // B: column gq of PHI and of GC at the pixels of lanes 8 ks + tq
          // and 8 ks + tq + 4
          const int px = (wb.by0 + ks) * TILE + wb.bx0 + tq;
          const uint32_t bp0 = gq < 6 ? __float_as_uint(sm.phi[gq][px]) : 0u;
          const uint32_t bp1 = gq < 6 ? __float_as_uint(sm.phi[gq][px + 4]) : 0u;
          uint32_t bgh0, bgl0, bgh1, bgl1;
          split_tf32(sm.gct[gq][px], bgh0, bgl0);
          split_tf32(sm.gct[gq][px + 4], bgh1, bgl1);
          uint32_t gh[4], gl[4], wh[4], wl[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_tf32(e[i].x, gh[i], gl[i]);
            split_tf32(e[i].y, wh[i], wl[i]);
          }
          mma_tf32(mg[0], gh, bp0, bp1);
          mma_tf32(mg[1], gl, bp0, bp1);
          mma_tf32(mw[0], wh, bgh0, bgh1);
          mma_tf32(mw[1], wh, bgl0, bgl1);
          mma_tf32(mw[2], wl, bgh0, bgh1);
        }
      }
      // D rows gq, gq + 8 (records), columns 2 tq, 2 tq + 1
      {
        float* r0 = sm.part[warp][k0 + gq];
        float* r1 = sm.part[warp][k0 + gq + 8];
        if (tq < 3) {   // Mg has 6 columns
          r0[2 * tq] = mg[1][0] + mg[0][0];
          r0[2 * tq + 1] = mg[1][1] + mg[0][1];
          r1[2 * tq] = mg[1][2] + mg[0][2];
          r1[2 * tq + 1] = mg[1][3] + mg[0][3];
        }
        r0[6 + 2 * tq] = (mw[2][0] + mw[1][0]) + mw[0][0];
        r0[7 + 2 * tq] = (mw[2][1] + mw[1][1]) + mw[0][1];
        r1[6 + 2 * tq] = (mw[2][2] + mw[1][2]) + mw[0][2];
        r1[7 + 2 * tq] = (mw[2][3] + mw[1][3]) + mw[0][3];
      }
      __syncwarp();   // the buffer is rewritten by the next sub-chunk
    }
    cp_async_wait_all();   // the next chunk's rows, for its stage below
    __syncthreads();

    // thread k finalizes record c0 + k: moments -> sums -> the row
    if (p < n) {
      float M[6], Wm[CMAX];
#pragma unroll
      for (int i = 0; i < CMAX; ++i) {
        float a = 0.0f, b = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < NWARP; ++w8) {
          if (i < 6) a += sm.part[w8][p][i];
          b += sm.part[w8][p][6 + i];
        }
        if (i < 6) M[i] = a;
        Wm[i] = b;
      }
      // from the raw rows: warp 2 is rewriting the stage meanwhile
      const float* raw = sm.raw[buf];
      const float ca = raw[2 * RCH + p], cb = raw[3 * RCH + p];
      const float cc = raw[4 * RCH + p], op = raw[5 * RCH + p];
      // record mean about the tile centre, in pixels
      const float mx = raw[p] - tox - 7.5f, my = raw[RCH + p] - toy - 7.5f;
      const float s_dx = M[3] - mx * M[5];
      const float s_dy = M[4] - my * M[5];
      const float s_dxx = M[0] - 2.0f * mx * M[3] + mx * mx * M[5];
      const float s_dxy = M[1] - my * M[3] - mx * M[4] + mx * my * M[5];
      const float s_dyy = M[2] - 2.0f * my * M[4] + my * my * M[5];
      // gp = galpha * op * exp(power) on every blended pair (clamped pairs
      // carry galpha = 0), so sum galpha exp(power) = M5 / op; op >= 1/255
      // wherever a pair was kept
      const float s_ge = op > 0.0f ? M[5] / op : 0.0f;
      float4* row = reinterpret_cast<float4*>(
          grad + ((size_t)tile * mpt + c0 + p) * RECW);
      row[0] = make_float4(ca * s_dx + cb * s_dy, cc * s_dy + cb * s_dx,
                           -0.5f * s_dxx, -s_dxy);
      row[1] = make_float4(-0.5f * s_dyy, s_ge, Wm[0], Wm[1]);
      row[2] = make_float4(Wm[2], Wm[3], Wm[4], Wm[5]);
      row[3] = make_float4(Wm[6], Wm[7], 0.0f, 0.0f);
    }
    // meanwhile warp 2 stages the next chunk's records
    if (more && p >= RSW && p < RSW + min(RCH, count - c0 - RCH))
      stage_record(sm, sm.raw[buf ^ 1], p - RSW, C, tox, toy);
    written = c0 + n;
    // the barrier that also frees the partials and this chunk's raw rows
    if (__syncthreads_or(!done) == 0) break;
  }
  // records the walk never reached (early exit, or past count) get zeros
  float* base = grad + (size_t)tile * mpt * RECW;
  for (int i = written * RECW + p; i < mpt * RECW; i += TPX) base[i] = 0.0f;
}

}  // namespace

extern "C" {

const char* vtgs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// tids: null, or (n_tiles,) i32 image tile per row; tile_offset: added to
// every row's tile (see walk.cuh:image_tile)
int vtgs_blend_fwd(const float* recs, const int* counts, const int* tids,
                   int n_tiles, int mpt, int tiles_x, int tile_offset,
                   int n_channels, float* out, void* stream) {
  if (n_channels < 1 || n_channels > CMAX) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(FwdSmem);
  const cudaError_t e = cudaFuncSetAttribute(
      blend_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  blend_fwd_kernel<<<n_tiles, TPX, smem, (cudaStream_t)stream>>>(
      recs, counts, tids, mpt, tiles_x, tile_offset, n_channels, out);
  return (int)cudaGetLastError();
}

int vtgs_blend_bwd(const float* recs, const int* counts, const int* tids,
                   const float* out, const float* g, int n_tiles, int mpt,
                   int tiles_x, int tile_offset, int n_channels, float* grad,
                   void* stream) {
  if (n_channels < 1 || n_channels > CMAX) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(RecSmem);
  const cudaError_t e = cudaFuncSetAttribute(
      blend_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  blend_bwd_kernel<<<n_tiles, TPX, smem, (cudaStream_t)stream>>>(
      recs, counts, tids, out, g, mpt, tiles_x, tile_offset, n_channels, grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
