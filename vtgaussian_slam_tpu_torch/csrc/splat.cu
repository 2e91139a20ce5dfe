// Fused splat kernels for Hopper (sm_90a): world-space slot records + pose
// -> composited tile image, and its two backward walks.
//
// Replaces vtgaussian_slam_tpu/ops/rasterizer/pallas_splat.py:
//   K1 vtgs_splat_fwd           <- _fwd_call / _fwd_kernel
//   K2 vtgs_splat_bwd_pose      <- _bwd_call / _bwd_kernel, mode "pose"
//   K3 vtgs_splat_bwd_vals_rows <- _bwd_call / _bwd_kernel, mode "vals_rows"
//   K6 vtgs_splat_bwd_all       <- _bwd_call / _bwd_kernel, mode "all"
//
// Layouts (identical to the JAX package):
//   slots  (n_tiles, 8, mpt) f32 rows [wx wy wz logit_op log_scale r g b]
//   counts (n_tiles,) i32 live slots per tile, depth-ordered
//   tids   null or (n_tiles,) i32 the image tile of each row, and an int
//          tile_offset added to it (two-class binning's tile subsets, a
//          tile-sharded rank's range; walk.cuh:image_tile); they move only
//          the pixel origin, the row addresses every operand
//   cp     (18,) f32 [R(9) t(3) fx fy cx cy 1.3*tanfovx 1.3*tanfovy]
//   out    (n_tiles, 8, 256) f32 channels (r g b z 1 z^2 T_end 0)
//   g      (n_tiles, 8, 256) f32 cotangent of out
//   K2 -> (n_tiles, 12) f32 per-tile partial [dR(9) dt(3)], summed by torch
//   K3 -> (n_tiles, mpt, 8) f32 rows [0 0 0 d logit_op d log_scale d rgb]
//   K6 -> (n_tiles, 8, mpt) f32 rows [d mean_cam(3) d logit_op d log_scale
//         d rgb(3)], the JAX layout; the wrapper contracts dR, dt and
//         rotates d mean_cam to world
//
// Design: one CTA per 16x16 tile, one thread per pixel (256 threads); warp
// w owns the 8 x 4 pixel block at (8 (w & 1), 4 (w >> 1)). Raw slot rows
// arrive by cp.async a chunk ahead of the walk. Each slot is projected once
// per tile (world->camera, isotropic EWA, sigmoid; `stage_slot`, shared by
// all four kernels) into shared memory, together with a box bounding the
// pixels where alpha >= 1/255 can hold, and a warp evaluates only the slots
// whose box meets its block. A pixel evaluates 4 live slots at a time (alpha
// is independent of the walk's state), then blends them front to back with
// selects rather than branches. It skips pairs with power > 1e-3 or alpha <
// 1/255, and stops at the first slot whose transmittance after blending
// would fall below 1e-4 (that slot is not blended). The CTA leaves when all
// 256 pixels stopped.
//
// K1, what bounds it on the H100: neither the bytes (each slot row is read
// once per tile, ~53 MB at room0 shapes, ~16 us at 3.35 TB/s) nor the
// operations (~0.11 ms at the fp32 peak, chip_smoke.py's bound) but the
// issue slots and latency of the per-pair walk: only ~9% of the
// (pixel, slot) pairs of a saturated 512-slot tile blend, and a walk that
// evaluates every pair is one dependent chain per slot with two branches.
// What the design does about it: the box cull removes the pairs (a lane
// tests one box per 32 slots, a ballot and a popcount compact the chunk's
// live slots, in slot order, into a per-warp byte list, so the walk reads 4
// indices with one load and only a chunk's last group is partial); the
// grouped select blend leaves T alone on the chain from one blend to the
// next; chunks of FCH = 256 slots with the raw rows and the projected stage
// both double buffered, so a chunk costs one block barrier, the next
// chunk's copies are in flight while this one is walked, and every warp
// projects FCH / 8 slots of the next chunk before it walks (no warp waits
// for another's projection). The forward holds only T and 6 sums per pixel:
// 64 registers and 47 KB of static shared memory, so 4 CTAs share an SM
// (measured: smaller chunks or 5 CTAs at 48 registers are slower, PERF.md).
// Blends are in slot order per pixel, no atomics: a repeated launch gives
// the same bits.
//
// The backwards (K2, K3, K6: one template, MODE 0 / 1 / 2) replay the same
// walk front to back and use the suffix identity
// dL/dalpha_k = T_k (g.c_k) - (G - H_k) / (1 - alpha_k), with
// G = sum_ch g*out and H_k the inclusive prefix of w_j (g.c_j).
//
// Their per-slot sums over the tile's pixels follow _bwd_kernel's algebra
// (pallas_splat.py: _phi_local, the M = phi^T g_power and g_eff @ weight
// contractions, which the TPU ran on its MXU) on the tensor cores, instead
// of a ballot and a 5-level warp-shuffle tree per value for every (warp,
// slot) some lane blended. Slots come 64 per chunk, 16 per sub-chunk. Each
// pixel writes two values per slot of the sub-chunk, gp = g_alpha * alpha
// and the blend weight w (0 where the pair was not blended), into its
// warp's [slot][pixel] buffer; the warp then takes, over its 32 pixels,
//   Mg = GP (16 slots x 32) . PHI (32 x 8), PHI = [cx^2 cx*cy cy^2 cx cy 1 0 0]
//   Mw = W  (16 slots x 32) . GC  (32 x 8), GC  = [g0 g1 g2 g3 g5 0 0 0]
// with mma.sync m16n8k8 (TF32 in, f32 accumulate), cx, cy the pixel's
// coordinates about the tile centre (lx - 7.5, ly - 7.5; exact in TF32).
// TF32 keeps 10 mantissa bits, so the f32 operands are split a = hi + lo:
// GP . PHI as hi + lo (PHI is exact), W . GC as hi.hi + hi.lo + lo.hi, each
// in its own accumulator. A pixel row of the block in which no pixel
// blended is skipped (its k-slice adds nothing), and so is a sub-chunk in
// which none did. The epilogue, once per slot, sums the 8 warps' partials in
// a fixed order and rebuilds the dx / dy sums from the moments about the
// slot mean (mx, my about the centre): s_dx = M3 - mx M5,
// s_dxx = M0 - 2 mx M3 + mx^2 M5, ...; sum g_alpha expp = M5 / op; then the
// conic, Jacobian and mean chain. K2's 12 pose sums go from the slot
// threads through shared memory to a fixed-order sum. No warp shuffle and
// no float atomics: results are deterministic.
//
// The backward walk is the forward's (box cull per 16-slot sub-chunk, 4
// slots at a time; g.c and 1 / (1 - alpha) are also independent of the
// walk's state, so its chain is T and H alone); warps 2-3 project the next
// chunk while warps 0-1 run the current one's epilogue.
//
// What bounds the backwards on the H100: like K1 neither the bytes nor the
// operations (~0.125 ms at the fp32 peak) but the issue slots and
// latency of the per-pair walk; the products come on top (PERF.md). ptxas
// (sm_90a, CUDA 12.8): 80 registers, so 3 CTAs share an SM, and ~74 KB of
// dynamic shared memory per CTA, set with cudaFuncSetAttribute in
// launch_bwd.
#include "walk.cuh"

namespace {

using namespace vtgs;

constexpr int NCH = 8;
constexpr float POWER_MAX = 1e-3f;  // pallas_splat keeps power <= 1e-3
constexpr float NEAR_CULL = 0.2f;
constexpr float DILATION = 0.3f;

struct Cam {
  float R[9], t[3];
  float fx, fy, cx, cy, limx, limy;
};

__device__ __forceinline__ Cam load_cam(const float* __restrict__ cp) {
  Cam c;
#pragma unroll
  for (int i = 0; i < 9; ++i) c.R[i] = cp[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) c.t[i] = cp[9 + i];
  c.fx = cp[12]; c.fy = cp[13]; c.cx = cp[14]; c.cy = cp[15];
  c.limx = cp[16]; c.limy = cp[17];
  return c;
}

// Per-slot projection: projection.py's isotropic path plus the
// world->camera transform (pallas_splat._project_chunk).
struct Proj {
  float wx, wy, wz, x, y, z, zs, iz, ux, uy, cux, cuy;
  float j00, j02, j11, j12, s2, ax, bxy, cy_, ca, cb, cc, m2x, m2y, sig, op;
  bool ok;
};

__device__ __forceinline__ Proj project(const float* __restrict__ ts, int mpt,
                                        int j, const Cam& c) {
  Proj p;
  p.wx = ts[j];
  p.wy = ts[mpt + j];
  p.wz = ts[2 * mpt + j];
  const float lo = ts[3 * mpt + j];
  const float ls = ts[4 * mpt + j];
  p.x = c.R[0] * p.wx + c.R[1] * p.wy + c.R[2] * p.wz + c.t[0];
  p.y = c.R[3] * p.wx + c.R[4] * p.wy + c.R[5] * p.wz + c.t[1];
  p.z = c.R[6] * p.wx + c.R[7] * p.wy + c.R[8] * p.wz + c.t[2];
  bool ok = p.z > NEAR_CULL;
  p.zs = ok ? p.z : 1.0f;
  p.iz = 1.0f / p.zs;
  p.ux = p.x * p.iz;
  p.uy = p.y * p.iz;
  p.cux = fminf(fmaxf(p.ux, -c.limx), c.limx);
  p.cuy = fminf(fmaxf(p.uy, -c.limy), c.limy);
  const float tx = p.cux * p.zs, ty = p.cuy * p.zs;
  const float iz2 = p.iz * p.iz;
  p.j00 = c.fx * p.iz;
  p.j02 = -c.fx * tx * iz2;
  p.j11 = c.fy * p.iz;
  p.j12 = -c.fy * ty * iz2;
  const float s = expf(ls);
  p.s2 = s * s;
  p.ax = p.j00 * p.j00 + p.j02 * p.j02;
  p.bxy = p.j02 * p.j12;
  p.cy_ = p.j11 * p.j11 + p.j12 * p.j12;
  const float v00 = p.s2 * p.ax + DILATION;
  const float v01 = p.s2 * p.bxy;
  const float v11 = p.s2 * p.cy_ + DILATION;
  const float det = v00 * v11 - v01 * v01;
  ok = ok && (det > 0.0f);
  const float idet = 1.0f / (det > 0.0f ? det : 1.0f);
  p.ca = v11 * idet;
  p.cb = -v01 * idet;
  p.cc = v00 * idet;
  p.m2x = ok ? c.fx * p.ux + c.cx - 0.5f : -1e6f;
  p.m2y = c.fy * p.uy + c.cy - 0.5f;
  p.sig = 1.0f / (1.0f + expf(-lo));
  p.op = ok ? p.sig : 0.0f;
  p.ok = ok;
  return p;
}

// One chunk of N slots as the walks read it: the projected values and the
// box bounding the pixels where one of the slot's pairs can be kept.
template <int N>
struct SlotStage {
  float4 s0[N];    // mx my ca cb   (mean in tile-local pixel coordinates)
  float2 s1[N];    // cc op
  float4 s2[N];    // r g b z
  float4 box[N];   // xlo xhi ylo yhi
};

// Project slot k of the raw chunk (8, N) into the walk's stage. The box:
// Q <= r2 (walk.cuh, box_radius2) is an ellipse whose x / y half-extents
// are sqrt(r2 v00) / sqrt(r2 v11) for the 2D covariance v; op < 1/255 (and
// every culled slot, whose op is 0) gets an empty box.
template <int N>
__device__ __forceinline__ void stage_slot(SlotStage<N>& st, const float* cam18,
                                           const float* raw, int k, float tox,
                                           float toy) {
  const Cam cam = load_cam(cam18);
  const Proj q = project(raw, N, k, cam);
  const float mx = q.m2x - tox, my = q.m2y - toy;
  float4 box = make_float4(1e30f, -1e30f, 1e30f, -1e30f);
  if (q.op >= ALPHA_MIN) {
    const float r2 = box_radius2(q.op);
    const float hx = sqrtf(r2 * (q.s2 * q.ax + DILATION));
    const float hy = sqrtf(r2 * (q.s2 * q.cy_ + DILATION));
    box = make_float4(mx - hx, mx + hx, my - hy, my + hy);
  }
  st.s0[k] = make_float4(mx, my, q.ca, q.cb);
  st.s1[k] = make_float2(q.cc, q.op);
  st.s2[k] = make_float4(raw[5 * N + k], raw[6 * N + k], raw[7 * N + k], q.z);
  st.box[k] = box;
}

// ---- K1 --------------------------------------------------------------------
constexpr int FCH = 256;             // slots per forward chunk
constexpr int FPW = FCH / NWARP;     // slots of the next chunk a warp projects
static_assert(FCH % 32 == 0 && FPW <= 32, "a lane votes on one box per word");

static_assert(FCH <= 256 && NG == 4, "a group's 4 slot indices are 4 bytes");

struct FwdSmem {
  SlotStage<FCH> st[2];              // projected chunks, double buffered
  float raw[2][8 * FCH];             // raw slot rows, double buffered
  unsigned live[NWARP][FCH / 4 + 1];  // per warp: its live slots of the chunk
  float cam[18];
};

// ---- the backwards' shared memory ------------------------------------------
constexpr int BCH = 64;   // slots staged per chunk in the backwards
constexpr int NP = 11;    // per-slot partials Mg[0:6], Mw[0:5] (odd stride:
                          // the epilogue's reads are conflict-free)
static_assert(BCH % SC == 0 && BCH <= TPX, "a chunk holds whole sub-chunks");

struct BwdSmem : SlotStage<BCH> {
  float raw[2][8 * BCH];            // raw slot rows, double buffered
  float2 pw[NWARP][SC * 32];        // per warp: (gp, w), [slot][pixel ^ sw]
  float part[NWARP][BCH][NP];       // per warp and slot: Mg, Mw partials
  float phi[6][PST];                // PHI^T: [cx^2 cx*cy cy^2 cx cy 1] per pixel
  float gct[5][PST];                // GC^T: [g0 g1 g2 g3 g5] per pixel
  float cam[18];
};

__global__ void __launch_bounds__(TPX, 4)
splat_fwd_kernel(const float* __restrict__ slots, const int* __restrict__ counts,
                 const int* __restrict__ tids, const float* __restrict__ cp,
                 int mpt, int tiles_x, int tile_offset,
                 float* __restrict__ out) {
  __shared__ __align__(16) FwdSmem sm;
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31;
  const int count = counts[tile];
  const float* ts = slots + (size_t)tile * 8 * mpt;
  const int it = image_tile(tids, tile, tile_offset);
  const float tox = (float)((it % tiles_x) * TILE);
  const float toy = (float)((it / tiles_x) * TILE);
  const WarpBlock wb(warp, lane);
  // lanes 0 .. FPW - 1 of each warp project slot sl of a chunk
  const bool proj = lane < FPW;
  const int sl = warp * FPW + lane;
  unsigned char* lst = reinterpret_cast<unsigned char*>(sm.live[warp]);

  if (p < 18) sm.cam[p] = cp[p];
  if (count > 0) {
    copy_rows<FCH>(sm.raw[0], ts, 8, mpt, 0, count, p);
    cp_async_wait_all();
  }
  __syncthreads();
  if (proj && sl < count) stage_slot(sm.st[0], sm.cam, sm.raw[0], sl, tox, toy);
  if (FCH < count) {
    copy_rows<FCH>(sm.raw[1], ts, 8, mpt, FCH, count, p);
    cp_async_wait_all();
  }
  __syncthreads();

  float T = 1.0f;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool done = false;
  int buf = 0;
  // at the top of each turn: chunk c0 is projected in st[buf], the raw rows
  // of chunk c0 + FCH have arrived in raw[buf ^ 1], and raw[buf] is free
  for (int c0 = 0; c0 < count; c0 += FCH, buf ^= 1) {
    const int n = min(FCH, count - c0);
    if (c0 + 2 * FCH < count)
      copy_rows<FCH>(sm.raw[buf], ts, 8, mpt, c0 + 2 * FCH, count, p);
    if (proj && c0 + FCH + sl < count)
      stage_slot(sm.st[buf ^ 1], sm.cam, sm.raw[buf ^ 1], sl, tox, toy);
    const SlotStage<FCH>& st = sm.st[buf];

    if (!__all_sync(FULL, done)) {
      // the chunk's slots whose box meets this warp's block, compacted in
      // slot order into the warp's list
      const int L = live_list(lst, st.box, n, wb, lane);
      for (int i0 = 0; i0 < L; i0 += NG) {
        if (__all_sync(FULL, done)) break;
        // evaluate NG live slots independently, then blend them front to
        // back with selects, not branches: the chain from one blend to the
        // next is T alone
        const unsigned ks = *reinterpret_cast<const unsigned*>(lst + i0);
        float al[NG];
        bool kp[NG];
        float4 cv[NG];
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const int k = (ks >> (8 * j)) & 0xffu;
          const float4 s0 = st.s0[k];
          const float2 s1 = st.s1[k];
          cv[j] = st.s2[k];
          const float dx = wb.lx - s0.x, dy = wb.ly - s0.y;
          const float power = -0.5f * (s0.z * dx * dx + s1.x * dy * dy) -
                              s0.w * dx * dy;
          al[j] = fminf(ALPHA_MAX, s1.y * expf(power));
          kp[j] = i0 + j < L && power <= POWER_MAX && al[j] >= ALPHA_MIN;
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          const bool keep = kp[j] && !done;
          const float Ta = T * (1.0f - al[j]);
          const bool stop = keep && Ta < T_TERM;
          const bool blend = keep && !stop;
          done = done || stop;
          const float w = blend ? al[j] * T : 0.0f;
          const float z = cv[j].w;
          acc[0] += w * cv[j].x;
          acc[1] += w * cv[j].y;
          acc[2] += w * cv[j].z;
          acc[3] += w * z;
          acc[4] += w;
          acc[5] += w * z * z;
          T = blend ? Ta : T;
        }
      }
    }
    cp_async_wait_all();   // the rows of chunk c0 + 2 FCH, for the next turn
    // also the barrier that publishes st[buf ^ 1] and frees st[buf]
    if (__syncthreads_or(!done) == 0) break;
  }
  float* o = out + (size_t)tile * NCH * TPX;
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) o[ch * TPX + wb.pix] = acc[ch];
  o[6 * TPX + wb.pix] = done ? 0.0f : T;   // final transmittance telemetry
  o[7 * TPX + wb.pix] = 0.0f;
}

// MODE 0: "pose" (K2), MODE 1: "vals_rows" (K3), MODE 2: "all" (K6): K2's
// per-slot chain to d mean_cam together with K3's per-slot values, written
// per slot instead of reduced per tile
template <int MODE>
__global__ void __launch_bounds__(TPX, 3)
splat_bwd_kernel(const float* __restrict__ slots, const int* __restrict__ counts,
                 const int* __restrict__ tids, const float* __restrict__ cp,
                 const float* __restrict__ out, const float* __restrict__ gin,
                 int mpt, int tiles_x, int tile_offset,
                 float* __restrict__ grad) {
  extern __shared__ __align__(16) unsigned char smem_buf[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_buf);
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31;
  const int gq = lane >> 2, tq = lane & 3;   // mma group and thread in group
  const int count = counts[tile];
  const float* ts = slots + (size_t)tile * 8 * mpt;
  const int it = image_tile(tids, tile, tile_offset);
  const float tox = (float)((it % tiles_x) * TILE);
  const float toy = (float)((it / tiles_x) * TILE);
  // warp w walks the 8 x 4 pixel block at (8 (w & 1), 4 (w >> 1))
  const int bx0 = 8 * (warp & 1), by0 = 4 * (warp >> 1);
  const int pix = (by0 + (lane >> 3)) * TILE + bx0 + (lane & 7);
  const float wx0 = (float)bx0, wx1 = wx0 + 7.0f;
  const float wy0 = (float)by0, wy1 = wy0 + 3.0f;
  const float lx = (float)(pix % TILE), ly = (float)(pix / TILE);

  const float* gt = gin + (size_t)tile * NCH * TPX;
  const float* ot = out + (size_t)tile * NCH * TPX;
  float gc[6];
  float GG = 0.0f;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const float gv = gt[ch * TPX + pix];
    GG += gv * ot[ch * TPX + pix];
    if (ch < 6) gc[ch] = gv;
  }

  {
    const float cx = lx - 7.5f, cy = ly - 7.5f;
    sm.phi[0][pix] = cx * cx;
    sm.phi[1][pix] = cx * cy;
    sm.phi[2][pix] = cy * cy;
    sm.phi[3][pix] = cx;
    sm.phi[4][pix] = cy;
    sm.phi[5][pix] = 1.0f;
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) sm.gct[ch][pix] = gc[ch < 4 ? ch : 5];
  }
  if (p < 18) sm.cam[p] = cp[p];
  if (count > 0) {
    copy_rows<BCH>(sm.raw[0], ts, 8, mpt, 0, count, p);
    cp_async_wait_all();
  }
  __syncthreads();

  float T = 1.0f, H = 0.0f;
  bool done = false;
  float red[12];   // K2: this slot thread's [dR dt] sums
#pragma unroll
  for (int i = 0; i < 12; ++i) red[i] = 0.0f;
  int written = 0;   // vals_rows, all: slots [0, written) hold their gradient
  float2* pwb = sm.pw[warp];
  const char* pa_lane = reinterpret_cast<const char*>(pwb) + gq * 256 + tq * 8;
  const uint32_t swz = 32u * gq;
  int buf = 0;
  // the first chunk's stage; each later one is staged by warps 2-3 while
  // warps 0-1 finish the chunk before it
  if (p < min(BCH, count)) stage_slot<BCH>(sm, sm.cam, sm.raw[0], p, tox, toy);
  __syncthreads();
  for (int c0 = 0; c0 < count; c0 += BCH, buf ^= 1) {
    const int n = min(BCH, count - c0);
    const bool more = c0 + BCH < count;
    if (more)
      copy_rows<BCH>(sm.raw[buf ^ 1], ts, 8, mpt, c0 + BCH, count, p);
    const float* raw = sm.raw[buf];

    for (int k0 = 0; k0 < n; k0 += SC) {
      // the sub-chunk's slots that one of this warp's 8 x 4 pixels can keep
      bool in = lane < SC && k0 + lane < n;
      if (in) {
        const float4 c = sm.box[k0 + lane];
        in = c.x <= wx1 && c.y >= wx0 && c.z <= wy1 && c.w >= wy0;
      }
      const unsigned live = __ballot_sync(FULL, in);   // bit j: slot k0 + j
      bool act = false;
      if (live != 0u && !__all_sync(FULL, done)) {
        unsigned m = live;
        while (m != 0u) {
          // evaluate NG slots independently (alpha, g.c, 1 / (1 - alpha)),
          // then blend them front to back with selects, not branches: the
          // chain from one blend to the next is T and H alone
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
            const float4 s2 = sm.s2[k];
            const float dx = lx - s0.x, dy = ly - s0.y;
            const float power = -0.5f * (s0.z * dx * dx + s1.x * dy * dy) -
                                s0.w * dx * dy;
            ar[j] = s1.y * expf(power);
            al[j] = fminf(ALPHA_MAX, ar[j]);
            kp[j] = kj[j] >= 0 && power <= POWER_MAX && al[j] >= ALPHA_MIN;
            const float z = s2.w;
            gcv[j] = gc[0] * s2.x + gc[1] * s2.y + gc[2] * s2.z + gc[3] * z +
                     gc[4] + gc[5] * z * z;
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
      // the per-slot pixel sums of the sub-chunk over the warp's 32 pixels
      float mg[2][4] = {}, mw[3][4] = {};
      // lanes 8 ks .. 8 ks + 7 (pixel row ks of the block) are k-slice ks
      // of the products; one in which no pixel blended adds nothing
      const unsigned am = __ballot_sync(FULL, act);
      if (am != 0u) {
        __syncwarp();
        // rows of slots the warp skipped hold stale values: read them as 0
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
          const int px = (by0 + ks) * TILE + bx0 + tq;
          const uint32_t bp0 = gq < 6 ? __float_as_uint(sm.phi[gq][px]) : 0u;
          const uint32_t bp1 = gq < 6 ? __float_as_uint(sm.phi[gq][px + 4]) : 0u;
          uint32_t bgh0, bgl0, bgh1, bgl1;
          split_tf32(gq < 5 ? sm.gct[gq][px] : 0.0f, bgh0, bgl0);
          split_tf32(gq < 5 ? sm.gct[gq][px + 4] : 0.0f, bgh1, bgl1);
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
      // D rows gq, gq + 8 (slots), columns 2 tq, 2 tq + 1
      if (tq < 3) {
        float* r0 = sm.part[warp][k0 + gq];
        float* r1 = sm.part[warp][k0 + gq + 8];
        r0[2 * tq] = mg[1][0] + mg[0][0];
        r0[2 * tq + 1] = mg[1][1] + mg[0][1];
        r1[2 * tq] = mg[1][2] + mg[0][2];
        r1[2 * tq + 1] = mg[1][3] + mg[0][3];
        r0[6 + 2 * tq] = (mw[2][0] + mw[1][0]) + mw[0][0];
        r1[6 + 2 * tq] = (mw[2][2] + mw[1][2]) + mw[0][2];
        if (tq < 2) {   // Mw has 5 columns
          r0[7 + 2 * tq] = (mw[2][1] + mw[1][1]) + mw[0][1];
          r1[7 + 2 * tq] = (mw[2][3] + mw[1][3]) + mw[0][3];
        }
      }
      __syncwarp();   // the buffer is rewritten by the next sub-chunk
    }
    cp_async_wait_all();   // the next chunk's rows, for its stage below
    __syncthreads();

    // thread k finalizes slot c0 + k: moments -> sums -> the conic chain
    if (p < n) {
      float M[6], Wm[5];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float a = 0.0f, b = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < NWARP; ++w8) {
          a += sm.part[w8][p][i];
          if (i < 5) b += sm.part[w8][p][6 + i];
        }
        M[i] = a;
        if (i < 5) Wm[i] = b;
      }
      const Cam cam = load_cam(sm.cam);
      const Proj q = project(raw, BCH, p, cam);
      const float okf = q.ok ? 1.0f : 0.0f;
      // slot mean about the tile centre, in pixels
      const float mx = q.m2x - tox - 7.5f, my = q.m2y - toy - 7.5f;
      const float s_dx = M[3] - mx * M[5];
      const float s_dy = M[4] - my * M[5];
      const float s_dxx = M[0] - 2.0f * mx * M[3] + mx * mx * M[5];
      const float s_dxy = M[1] - my * M[3] - mx * M[4] + mx * my * M[5];
      const float s_dyy = M[2] - 2.0f * my * M[4] + my * my * M[5];
      const float g_ca = -0.5f * s_dxx;
      const float g_cb = -s_dxy;
      const float g_cc = -0.5f * s_dyy;
      const float a0 = g_ca, a1 = 0.5f * g_cb, a2 = g_cc;
      const float ca0 = q.ca * a0 + q.cb * a1;
      const float ca1 = q.ca * a1 + q.cb * a2;
      const float cb0 = q.cb * a0 + q.cc * a1;
      const float cb1 = q.cb * a1 + q.cc * a2;
      const float g_v00 = -(ca0 * q.ca + ca1 * q.cb);
      const float g_v01 = -2.0f * (ca0 * q.cb + ca1 * q.cc);
      const float g_v11 = -(cb0 * q.cb + cb1 * q.cc);
      float g_lo = 0.0f, g_ls = 0.0f;
      if (MODE != 0) {
        // gp = g_alpha * op * expp on every blended pair (clamped pairs
        // carry g_alpha = 0), so sum g_alpha expp = M5 / op; op >= 1/255
        // wherever a pair was kept
        const float s_ge = q.op > 0.0f ? M[5] / q.op : 0.0f;
        g_lo = s_ge * q.sig * (1.0f - q.sig) * okf;
        g_ls = 2.0f * q.s2 * (g_v00 * q.ax + g_v01 * q.bxy + g_v11 * q.cy_) *
               okf;
      }
      if (MODE == 1) {
        float* row = grad + ((size_t)tile * mpt + c0 + p) * 8;
        row[0] = 0.0f;
        row[1] = 0.0f;
        row[2] = 0.0f;
        row[3] = g_lo;
        row[4] = g_ls;
        row[5] = Wm[0];
        row[6] = Wm[1];
        row[7] = Wm[2];
      } else {
        const float g_m2x = (q.ca * s_dx + q.cb * s_dy) * okf;
        const float g_m2y = q.cc * s_dy + q.cb * s_dx;
        const float g_z_cols = Wm[3] + 2.0f * q.z * Wm[4];
        const float g_j00 = 2.0f * q.s2 * q.j00 * g_v00;
        const float g_j02 = q.s2 * (2.0f * q.j02 * g_v00 + q.j12 * g_v01);
        const float g_j11 = 2.0f * q.s2 * q.j11 * g_v11;
        const float g_j12 = q.s2 * (2.0f * q.j12 * g_v11 + q.j02 * g_v01);
        const float iz = q.iz, zs = q.zs, iz2 = iz * iz;
        const float tx = q.cux * zs, ty = q.cuy * zs;
        float g_iz = cam.fx * g_j00 + cam.fy * g_j11 -
                     2.0f * cam.fx * tx * iz * g_j02 -
                     2.0f * cam.fy * ty * iz * g_j12;
        const float g_tx = -cam.fx * iz2 * g_j02;
        const float g_ty = -cam.fy * iz2 * g_j12;
        const float in_x = fabsf(q.ux) <= cam.limx ? 1.0f : 0.0f;
        const float in_y = fabsf(q.uy) <= cam.limy ? 1.0f : 0.0f;
        const float g_x = (g_tx * in_x + g_m2x * cam.fx * iz) * okf;
        const float g_y = (g_ty * in_y + g_m2y * cam.fy * iz) * okf;
        const float g_zs_tx = g_tx * (q.cux - in_x * q.ux);
        const float g_zs_ty = g_ty * (q.cuy - in_y * q.uy);
        g_iz = g_iz + g_m2x * cam.fx * q.x + g_m2y * cam.fy * q.y;
        const float g_zs = g_zs_tx + g_zs_ty - iz2 * g_iz;
        const float g_z = (g_zs + g_z_cols) * okf;
        if (MODE == 0) {
          const float gcam[3] = {g_x, g_y, g_z};
          const float mw3[3] = {q.wx, q.wy, q.wz};
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) red[i * 3 + j] += gcam[i] * mw3[j];
            red[9 + i] += gcam[i];
          }
        } else {
          float* col = grad + (size_t)tile * 8 * mpt + c0 + p;
          col[0] = g_x;
          col[mpt] = g_y;
          col[2 * mpt] = g_z;
          col[3 * mpt] = g_lo;
          col[4 * mpt] = g_ls;
          col[5 * mpt] = Wm[0];
          col[6 * mpt] = Wm[1];
          col[7 * mpt] = Wm[2];
        }
      }
    }
    // meanwhile warps 2-3 project the next chunk's slots
    if (more && p >= BCH && p < BCH + min(BCH, count - c0 - BCH))
      stage_slot<BCH>(sm, sm.cam, sm.raw[buf ^ 1], p - BCH, tox, toy);
    written = c0 + n;
    // the barrier that also frees the partials and this chunk's raw rows
    if (__syncthreads_or(!done) == 0) break;
  }

  // slots the walk never reached (early exit, or past count) get zeros
  if (MODE == 1) {
    float* base = grad + (size_t)tile * mpt * 8;
    for (int i = written * 8 + p; i < mpt * 8; i += TPX) base[i] = 0.0f;
  } else if (MODE == 2) {
    const int rest = mpt - written;
    float* base = grad + (size_t)tile * 8 * mpt + written;
    for (int i = p; i < 8 * rest; i += TPX)
      base[(i / rest) * mpt + i % rest] = 0.0f;
  } else {
    // once per tile: the slot threads' 12 pose sums, through the (now
    // free) gp / w buffers, summed in a fixed order
    float* pose = reinterpret_cast<float*>(sm.pw);
    if (p < BCH) {
#pragma unroll
      for (int i = 0; i < 12; ++i) pose[i * BCH + p] = red[i];
    }
    __syncthreads();
    if (p < 12) {
      float a = 0.0f;
      for (int k = 0; k < BCH; ++k) a += pose[p * BCH + k];
      grad[(size_t)tile * 12 + p] = a;
    }
  }
}

template <int MODE>
int launch_bwd(const float* slots, const int* counts, const int* tids,
               const float* cp, const float* out, const float* g, int n_tiles,
               int mpt, int tiles_x, int tile_offset, float* grad,
               void* stream) {
  const int smem = (int)sizeof(BwdSmem);
  const cudaError_t e = cudaFuncSetAttribute(
      splat_bwd_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  splat_bwd_kernel<MODE><<<n_tiles, TPX, smem, (cudaStream_t)stream>>>(
      slots, counts, tids, cp, out, g, mpt, tiles_x, tile_offset, grad);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vtgs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// tids: null, or (n_tiles,) i32 image tile per row; tile_offset: added to
// every row's tile (see walk.cuh:image_tile)
int vtgs_splat_fwd(const float* slots, const int* counts, const int* tids,
                   const float* cp, int n_tiles, int mpt, int tiles_x,
                   int tile_offset, float* out, void* stream) {
  splat_fwd_kernel<<<n_tiles, TPX, 0, (cudaStream_t)stream>>>(
      slots, counts, tids, cp, mpt, tiles_x, tile_offset, out);
  return (int)cudaGetLastError();
}

int vtgs_splat_bwd_pose(const float* slots, const int* counts, const int* tids,
                        const float* cp, const float* out, const float* g,
                        int n_tiles, int mpt, int tiles_x, int tile_offset,
                        float* partial, void* stream) {
  return launch_bwd<0>(slots, counts, tids, cp, out, g, n_tiles, mpt, tiles_x,
                        tile_offset, partial, stream);
}

int vtgs_splat_bwd_vals_rows(const float* slots, const int* counts,
                             const int* tids, const float* cp, const float* out,
                             const float* g, int n_tiles, int mpt, int tiles_x,
                             int tile_offset, float* rows, void* stream) {
  return launch_bwd<1>(slots, counts, tids, cp, out, g, n_tiles, mpt, tiles_x,
                        tile_offset, rows, stream);
}

int vtgs_splat_bwd_all(const float* slots, const int* counts, const int* tids,
                       const float* cp, const float* out, const float* g,
                       int n_tiles, int mpt, int tiles_x, int tile_offset,
                       float* grad, void* stream) {
  return launch_bwd<2>(slots, counts, tids, cp, out, g, n_tiles, mpt, tiles_x,
                        tile_offset, grad, stream);
}

}  // extern "C"
