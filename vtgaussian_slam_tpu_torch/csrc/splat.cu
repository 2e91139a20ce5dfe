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
//   cp     (18,) f32 [R(9) t(3) fx fy cx cy 1.3*tanfovx 1.3*tanfovy]
//   out    (n_tiles, 8, 256) f32 channels (r g b z 1 z^2 T_end 0)
//   g      (n_tiles, 8, 256) f32 cotangent of out
//   K2 -> (n_tiles, 12) f32 per-tile partial [dR(9) dt(3)], summed by torch
//   K3 -> (n_tiles, mpt, 8) f32 rows [0 0 0 d logit_op d log_scale d rgb]
//   K6 -> (n_tiles, 8, mpt) f32 rows [d mean_cam(3) d logit_op d log_scale
//         d rgb(3)], the JAX layout; the wrapper contracts dR, dt and
//         rotates d mean_cam to world
//
// Design: one CTA per 16x16 tile, one thread per pixel (256 threads). Slot
// records are staged through shared memory CH at a time; the per-slot
// projection (world->camera, isotropic EWA, sigmoid) runs once per slot,
// cooperatively, one slot per thread. Each pixel then walks the chunk front
// to back: it skips pairs with power > 1e-3 or alpha < 1/255, and stops at
// the first slot whose transmittance after blending would fall below 1e-4
// (that slot is not blended). The CTA leaves when all 256 pixels stopped.
//
// The backwards (K2, K3, K6: one template, MODE 0 / 1 / 2) replay the same
// walk front to back and use the suffix identity
// dL/dalpha_k = T_k (g.c_k) - (G - H_k) / (1 - alpha_k), with
// G = sum_ch g*out and H_k the inclusive prefix of w_j (g.c_j). Per-slot
// sums over the tile's pixels are a warp shuffle reduction (skipped when no
// lane of the warp touched the slot) into shared memory, summed over the 8
// warps in a fixed order. No atomics: results are deterministic.
//
// What bounds it on the H100: the walk is issue-bound on fp32 math and
// exp per (pixel, slot) pair; slot bytes are read once per tile (at room0
// shapes ~53 MB, ~16 us at 3.35 TB/s) and stay far below the math. The
// simple design keeps the walk in registers and shared memory and pays one
// block-wide barrier per chunk for the early exit; it makes no attempt yet
// to overlap staging with the walk or to spread a tile over more threads.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int TPX = TILE * TILE;
constexpr int NCH = 8;
constexpr int CH = 128;           // slots staged per chunk
constexpr int NWARP = TPX / 32;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_TERM = 1e-4f;
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

// Shared-memory staging of one chunk: the per-slot values the walk reads.
struct Stage {
  float mx[CH], my[CH], ca[CH], cb[CH], cc[CH], op[CH], r[CH], g[CH], b[CH],
      z[CH];
};

__device__ __forceinline__ void stage_slot(Stage& s, const float* __restrict__ ts,
                                           int mpt, int c0, int k, const Cam& cam,
                                           float tox, float toy) {
  const Proj q = project(ts, mpt, c0 + k, cam);
  s.mx[k] = q.m2x - tox;   // slot mean in tile-local pixel coordinates
  s.my[k] = q.m2y - toy;
  s.ca[k] = q.ca;
  s.cb[k] = q.cb;
  s.cc[k] = q.cc;
  s.op[k] = q.op;
  s.r[k] = ts[5 * mpt + c0 + k];
  s.g[k] = ts[6 * mpt + c0 + k];
  s.b[k] = ts[7 * mpt + c0 + k];
  s.z[k] = q.z;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(TPX)
splat_fwd_kernel(const float* __restrict__ slots, const int* __restrict__ counts,
                 const float* __restrict__ cp, int mpt, int tiles_x,
                 float* __restrict__ out) {
  __shared__ Stage s;
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int count = counts[tile];
  const Cam cam = load_cam(cp);
  const float* ts = slots + (size_t)tile * 8 * mpt;
  const float tox = (float)((tile % tiles_x) * TILE);
  const float toy = (float)((tile / tiles_x) * TILE);
  const float lx = (float)(p % TILE), ly = (float)(p / TILE);

  float T = 1.0f;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool done = false;
  for (int c0 = 0; c0 < count; c0 += CH) {
    const int n = min(CH, count - c0);
    if (p < n) stage_slot(s, ts, mpt, c0, p, cam, tox, toy);
    __syncthreads();
    if (!done) {
      for (int k = 0; k < n; ++k) {
        const float dx = lx - s.mx[k], dy = ly - s.my[k];
        const float power =
            -0.5f * (s.ca[k] * dx * dx + s.cc[k] * dy * dy) - s.cb[k] * dx * dy;
        const float alpha = fminf(ALPHA_MAX, s.op[k] * expf(power));
        if (!(power <= POWER_MAX && alpha >= ALPHA_MIN)) continue;
        const float Ta = T * (1.0f - alpha);
        if (Ta < T_TERM) {
          done = true;
          break;
        }
        const float w = alpha * T;
        const float z = s.z[k];
        acc[0] += w * s.r[k];
        acc[1] += w * s.g[k];
        acc[2] += w * s.b[k];
        acc[3] += w * z;
        acc[4] += w;
        acc[5] += w * z * z;
        T = Ta;
      }
    }
    // also the barrier that frees the stage for the next chunk
    if (__syncthreads_or(!done) == 0) break;
  }
  float* o = out + (size_t)tile * NCH * TPX;
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) o[ch * TPX + p] = acc[ch];
  o[6 * TPX + p] = done ? 0.0f : T;   // final transmittance telemetry
  o[7 * TPX + p] = 0.0f;
}

// MODE 0: "pose" (K2), MODE 1: "vals_rows" (K3), MODE 2: "all" (K6): K2's
// per-slot chain to d mean_cam together with K3's per-slot values, written
// per slot instead of reduced per tile
template <int MODE>
__global__ void __launch_bounds__(TPX)
splat_bwd_kernel(const float* __restrict__ slots, const int* __restrict__ counts,
                 const float* __restrict__ cp, const float* __restrict__ out,
                 const float* __restrict__ gin, int mpt, int tiles_x,
                 float* __restrict__ grad) {
  // per-slot pixel sums:
  //   pose:      [sum gp dx, sum gp dy, sum gp dx^2, sum gp dx dy,
  //               sum gp dy^2, sum w (g3 + 2 z g5)]
  //   vals_rows: [sum gp dx^2, sum gp dx dy, sum gp dy^2,
  //               sum galpha expp, sum w g0, sum w g1, sum w g2]
  //   all:       the six of pose, then sum galpha expp, sum w g0..g2
  constexpr int NV = MODE == 0 ? 6 : (MODE == 1 ? 7 : 10);
  constexpr int I_GE = MODE == 1 ? 3 : 6;    // sum galpha expp
  constexpr int I_RGB = I_GE + 1;            // sum w g0..g2
  __shared__ Stage s;
  __shared__ float part[NWARP][NV][CH];
  __shared__ float red_s[NWARP][12];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31;
  const int count = counts[tile];
  const Cam cam = load_cam(cp);
  const float* ts = slots + (size_t)tile * 8 * mpt;
  const float tox = (float)((tile % tiles_x) * TILE);
  const float toy = (float)((tile / tiles_x) * TILE);
  const float lx = (float)(p % TILE), ly = (float)(p / TILE);

  const float* gt = gin + (size_t)tile * NCH * TPX;
  const float* ot = out + (size_t)tile * NCH * TPX;
  float gc[6];
  float GG = 0.0f;
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
    const float gv = gt[ch * TPX + p];
    GG += gv * ot[ch * TPX + p];
    if (ch < 6) gc[ch] = gv;
  }

  float T = 1.0f, H = 0.0f;
  bool done = false;
  float red[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) red[i] = 0.0f;
  int written = 0;   // vals_rows, all: slots [0, written) hold their gradient

  for (int c0 = 0; c0 < count; c0 += CH) {
    const int n = min(CH, count - c0);
    if (p < n) stage_slot(s, ts, mpt, c0, p, cam, tox, toy);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      float v[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = 0.0f;
      bool act = false;
      if (!done) {
        const float dx = lx - s.mx[k], dy = ly - s.my[k];
        const float power =
            -0.5f * (s.ca[k] * dx * dx + s.cc[k] * dy * dy) - s.cb[k] * dx * dy;
        const float expp = expf(power);
        const float araw = s.op[k] * expp;
        const float alpha = fminf(ALPHA_MAX, araw);
        if (power <= POWER_MAX && alpha >= ALPHA_MIN) {
          const float Ta = T * (1.0f - alpha);
          if (Ta < T_TERM) {
            done = true;
          } else {
            const float w = alpha * T;
            const float z = s.z[k];
            const float Gc = gc[0] * s.r[k] + gc[1] * s.g[k] + gc[2] * s.b[k] +
                             gc[3] * z + gc[4] + gc[5] * z * z;
            H += w * Gc;
            const float ga = (araw > ALPHA_MAX)
                                 ? 0.0f
                                 : T * Gc - (GG - H) / fmaxf(1.0f - alpha, 1e-6f);
            const float gp = ga * alpha;
            if (MODE != 1) {
              v[0] = gp * dx;
              v[1] = gp * dy;
              v[2] = gp * dx * dx;
              v[3] = gp * dx * dy;
              v[4] = gp * dy * dy;
              v[5] = w * (gc[3] + 2.0f * z * gc[5]);
            } else {
              v[0] = gp * dx * dx;
              v[1] = gp * dx * dy;
              v[2] = gp * dy * dy;
            }
            if (MODE != 0) {
              v[I_GE] = ga * expp;
              v[I_RGB] = w * gc[0];
              v[I_RGB + 1] = w * gc[1];
              v[I_RGB + 2] = w * gc[2];
            }
            act = true;
            T = Ta;
          }
        }
      }
      const bool any = __ballot_sync(0xffffffffu, act) != 0u;
      if (any) {
#pragma unroll
        for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < NV; ++i) part[warp][i][k] = v[i];
      }
    }
    __syncthreads();

    // thread k finalizes slot c0 + k: the conic -> covariance chain
    if (p < n) {
      float sum[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float a = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < NWARP; ++w8) a += part[w8][i][p];
        sum[i] = a;
      }
      const Proj q = project(ts, mpt, c0 + p, cam);
      const float okf = q.ok ? 1.0f : 0.0f;
      const int o = MODE == 1 ? 0 : 2;   // offset of the quadratic sums
      const float g_ca = -0.5f * sum[o + 0];
      const float g_cb = -sum[o + 1];
      const float g_cc = -0.5f * sum[o + 2];
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
        g_lo = sum[I_GE] * q.sig * (1.0f - q.sig) * okf;
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
        row[5] = sum[I_RGB];
        row[6] = sum[I_RGB + 1];
        row[7] = sum[I_RGB + 2];
      } else {
        const float s_dx = sum[0], s_dy = sum[1];
        const float g_m2x = (q.ca * s_dx + q.cb * s_dy) * okf;
        const float g_m2y = q.cc * s_dy + q.cb * s_dx;
        const float g_z_cols = sum[5];
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
          const float mw[3] = {q.wx, q.wy, q.wz};
#pragma unroll
          for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) red[i * 3 + j] += gcam[i] * mw[j];
            red[9 + i] += gcam[i];
          }
        } else {
          float* col = grad + (size_t)tile * 8 * mpt + c0 + p;
          col[0] = g_x;
          col[mpt] = g_y;
          col[2 * mpt] = g_z;
          col[3 * mpt] = g_lo;
          col[4 * mpt] = g_ls;
          col[5 * mpt] = sum[I_RGB];
          col[6 * mpt] = sum[I_RGB + 1];
          col[7 * mpt] = sum[I_RGB + 2];
        }
      }
    }
    written = c0 + n;
    // also the barrier that frees the stage and the partials
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
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const float v = warp_sum(red[i]);
      if (lane == 0) red_s[warp][i] = v;
    }
    __syncthreads();
    if (p < 12) {
      float a = 0.0f;
#pragma unroll
      for (int w8 = 0; w8 < NWARP; ++w8) a += red_s[w8][p];
      grad[(size_t)tile * 12 + p] = a;
    }
  }
}

}  // namespace

extern "C" {

const char* vtgs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int vtgs_splat_fwd(const float* slots, const int* counts, const float* cp,
                   int n_tiles, int mpt, int tiles_x, float* out, void* stream) {
  splat_fwd_kernel<<<n_tiles, TPX, 0, (cudaStream_t)stream>>>(
      slots, counts, cp, mpt, tiles_x, out);
  return (int)cudaGetLastError();
}

int vtgs_splat_bwd_pose(const float* slots, const int* counts, const float* cp,
                        const float* out, const float* g, int n_tiles, int mpt,
                        int tiles_x, float* partial, void* stream) {
  splat_bwd_kernel<0><<<n_tiles, TPX, 0, (cudaStream_t)stream>>>(
      slots, counts, cp, out, g, mpt, tiles_x, partial);
  return (int)cudaGetLastError();
}

int vtgs_splat_bwd_vals_rows(const float* slots, const int* counts,
                             const float* cp, const float* out, const float* g,
                             int n_tiles, int mpt, int tiles_x, float* rows,
                             void* stream) {
  splat_bwd_kernel<1><<<n_tiles, TPX, 0, (cudaStream_t)stream>>>(
      slots, counts, cp, out, g, mpt, tiles_x, rows);
  return (int)cudaGetLastError();
}

int vtgs_splat_bwd_all(const float* slots, const int* counts, const float* cp,
                       const float* out, const float* g, int n_tiles, int mpt,
                       int tiles_x, float* grad, void* stream) {
  splat_bwd_kernel<2><<<n_tiles, TPX, 0, (cudaStream_t)stream>>>(
      slots, counts, cp, out, g, mpt, tiles_x, grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
