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
//   out    (n_tiles, 256, C) f32
//   g      (n_tiles, 256, C) f32 cotangent of out
//   K5 ->  (n_tiles, mpt, 16) f32 ROW-major per record [d mean2d (2),
//          d conic (3), d opacity, d colors (C), 0 ...]; the JAX kernel
//          writes (n_tiles, 16, mpt). Row-major lets the inverse-map gather
//          (binning.apply_slot_inverse) read one record's gradient as one
//          64-byte row. Records no pixel walked are zero.
//
// Design: one CTA per 16x16 tile, one thread per pixel (256 threads);
// records are staged through shared memory CH slots at a time with
// coalesced row reads. Pixels use GLOBAL coordinates and keep power <= 0
// (the splat kernels keep <= 1e-3). A pixel stops at the first record whose
// transmittance after blending would fall below 1e-4 (not blended); the
// CTA leaves when all 256 pixels stopped.
//
// What bounds it on the H100: fp32 math and one exp per (pixel, record)
// pair walked; the record bytes (n_tiles * 16 * mpt * 4, ~106 MB at room0
// shapes, read once) take ~32 us at 3.35 TB/s. The simple design stages
// each chunk before walking it and pays one block barrier per chunk for the
// early exit.
//
// K5 replays the same walk and uses the suffix identity
//   dL/dalpha_k = T_k (g.c_k) - (G - H_k) / max(1 - alpha_k, 1e-6),
// G = sum_c g*out over all C channels, H_k the inclusive prefix of
// w_j (g.c_j), gated by kept & blended & not clamped (op*exp(power) <=
// 0.99). Per record, the sums over the tile's 256 pixels
//   [sum gp dx, sum gp dy, sum gp dx^2, sum gp dx dy, sum gp dy^2,
//    sum galpha exp(power), sum w g_c (C)]   (gp = galpha * alpha)
// are warp shuffle reductions (skipped when no lane of the warp blended the
// record) into shared memory, summed over the 8 warps in a fixed order, as
// K3 does: no atomics, so results are deterministic. The thread that owns a
// record then applies the conic chain and writes its row. K5 stages
// BCH = 64 records per chunk so the (8 warps x 14 sums x BCH) partials stay
// in 28 KB of static shared memory. Like K3 it is issue-bound on the walk's
// fp32 math and on the shuffle reductions of the blended records.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int TPX = TILE * TILE;
constexpr int RECW = 16;
constexpr int CMAX = 8;
constexpr int CH = 128;
constexpr int BCH = 64;             // records per K5 chunk
constexpr int NWARP = TPX / 32;
constexpr int NV = 6 + CMAX;        // K5 per-record pixel sums
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_TERM = 1e-4f;

__global__ void __launch_bounds__(TPX)
blend_fwd_kernel(const float* __restrict__ recs, const int* __restrict__ counts,
                 int mpt, int tiles_x, int C, float* __restrict__ out) {
  __shared__ float s[6 + CMAX][CH];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int count = counts[tile];
  const float* tr = recs + (size_t)tile * RECW * mpt;
  const float px = (float)((tile % tiles_x) * TILE + p % TILE);
  const float py = (float)((tile / tiles_x) * TILE + p / TILE);
  const int rows = 6 + C;

  float T = 1.0f;
  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.0f;
  bool done = false;
  for (int c0 = 0; c0 < count; c0 += CH) {
    const int n = min(CH, count - c0);
    for (int i = p; i < rows * CH; i += TPX) {
      const int r = i / CH, k = i % CH;
      if (k < n) s[r][k] = tr[r * mpt + c0 + k];
    }
    __syncthreads();
    if (!done) {
      for (int k = 0; k < n; ++k) {
        const float dx = px - s[0][k], dy = py - s[1][k];
        const float power =
            -0.5f * (s[2][k] * dx * dx + s[4][k] * dy * dy) - s[3][k] * dx * dy;
        const float alpha = fminf(ALPHA_MAX, s[5][k] * expf(power));
        if (!(power <= 0.0f && alpha >= ALPHA_MIN)) continue;
        const float Ta = T * (1.0f - alpha);
        if (Ta < T_TERM) {
          done = true;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < CMAX; ++c)
          if (c < C) acc[c] += w * s[6 + c][k];
        T = Ta;
      }
    }
    // also the barrier that frees the stage for the next chunk
    if (__syncthreads_or(!done) == 0) break;
  }
  float* o = out + ((size_t)tile * TPX + p) * C;
#pragma unroll
  for (int c = 0; c < CMAX; ++c)
    if (c < C) o[c] = acc[c];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(TPX)
blend_bwd_kernel(const float* __restrict__ recs, const int* __restrict__ counts,
                 const float* __restrict__ out, const float* __restrict__ gin,
                 int mpt, int tiles_x, int C, float* __restrict__ grad) {
  __shared__ float s[6 + CMAX][BCH];
  __shared__ float part[NWARP][NV][BCH];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31;
  const int count = counts[tile];
  const float* tr = recs + (size_t)tile * RECW * mpt;
  const float px = (float)((tile % tiles_x) * TILE + p % TILE);
  const float py = (float)((tile / tiles_x) * TILE + p / TILE);
  const int rows = 6 + C;

  const float* gp_ = gin + ((size_t)tile * TPX + p) * C;
  const float* op_ = out + ((size_t)tile * TPX + p) * C;
  float g[CMAX];
  float GG = 0.0f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    g[c] = c < C ? gp_[c] : 0.0f;
    if (c < C) GG += g[c] * op_[c];
  }

  float T = 1.0f, H = 0.0f;
  bool done = false;
  int written = 0;   // records [0, written) hold their gradient
  for (int c0 = 0; c0 < count; c0 += BCH) {
    const int n = min(BCH, count - c0);
    for (int i = p; i < rows * BCH; i += TPX) {
      const int r = i / BCH, k = i % BCH;
      if (k < n) s[r][k] = tr[r * mpt + c0 + k];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      float v[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = 0.0f;
      bool act = false;
      if (!done) {
        const float dx = px - s[0][k], dy = py - s[1][k];
        const float power =
            -0.5f * (s[2][k] * dx * dx + s[4][k] * dy * dy) - s[3][k] * dx * dy;
        const float expp = expf(power);
        const float araw = s[5][k] * expp;
        const float alpha = fminf(ALPHA_MAX, araw);
        if (power <= 0.0f && alpha >= ALPHA_MIN) {
          const float Ta = T * (1.0f - alpha);
          if (Ta < T_TERM) {
            done = true;
          } else {
            const float w = alpha * T;
            float Gc = 0.0f;
#pragma unroll
            for (int c = 0; c < CMAX; ++c)
              if (c < C) Gc += g[c] * s[6 + c][k];
            H += w * Gc;
            const float ga = (araw > ALPHA_MAX)
                                 ? 0.0f
                                 : T * Gc - (GG - H) / fmaxf(1.0f - alpha, 1e-6f);
            const float gp = ga * alpha;
            v[0] = gp * dx;
            v[1] = gp * dy;
            v[2] = gp * dx * dx;
            v[3] = gp * dx * dy;
            v[4] = gp * dy * dy;
            v[5] = ga * expp;
#pragma unroll
            for (int c = 0; c < CMAX; ++c) v[6 + c] = w * g[c];
            act = true;
            T = Ta;
          }
        }
      }
      const bool any = __ballot_sync(0xffffffffu, act) != 0u;
      if (any) {
#pragma unroll
        for (int i = 0; i < NV; ++i)
          if (i < rows) v[i] = warp_sum(v[i]);
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < NV; ++i)
          if (i < rows) part[warp][i][k] = v[i];
      }
    }
    __syncthreads();

    // thread k finalizes record c0 + k: the quadratic form -> mean / conic
    if (p < n) {
      float sum[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float a = 0.0f;
        if (i < rows) {
#pragma unroll
          for (int w8 = 0; w8 < NWARP; ++w8) a += part[w8][i][p];
        }
        sum[i] = a;
      }
      const float ca = s[2][p], cb = s[3][p], cc = s[4][p];
      float* row = grad + ((size_t)tile * mpt + c0 + p) * RECW;
      row[0] = ca * sum[0] + cb * sum[1];
      row[1] = cc * sum[1] + cb * sum[0];
      row[2] = -0.5f * sum[2];
      row[3] = -sum[3];
      row[4] = -0.5f * sum[4];
      row[5] = sum[5];
#pragma unroll
      for (int i = 6; i < RECW; ++i) row[i] = i < NV ? sum[i] : 0.0f;
    }
    written = c0 + n;
    // also the barrier that frees the stage and the partials
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

int vtgs_blend_fwd(const float* recs, const int* counts, int n_tiles, int mpt,
                   int tiles_x, int n_channels, float* out, void* stream) {
  if (n_channels < 1 || n_channels > CMAX) return (int)cudaErrorInvalidValue;
  blend_fwd_kernel<<<n_tiles, TPX, 0, (cudaStream_t)stream>>>(
      recs, counts, mpt, tiles_x, n_channels, out);
  return (int)cudaGetLastError();
}

int vtgs_blend_bwd(const float* recs, const int* counts, const float* out,
                   const float* g, int n_tiles, int mpt, int tiles_x,
                   int n_channels, float* grad, void* stream) {
  if (n_channels < 1 || n_channels > CMAX) return (int)cudaErrorInvalidValue;
  blend_bwd_kernel<<<n_tiles, TPX, 0, (cudaStream_t)stream>>>(
      recs, counts, out, g, mpt, tiles_x, n_channels, grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
