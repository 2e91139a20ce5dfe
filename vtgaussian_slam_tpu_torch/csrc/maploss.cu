// The mapping loss and its gradient for Hopper (sm_90a): colour L1 + SSIM
// and the masked depth L1 of one render against its keyframe, in three
// launches (forward tiles, a fixed-order reduction, the backward scale).
//
// Replaces no TPU kernel: the JAX package leaves this loss to XLA
// (vtgaussian_slam_tpu/core/losses.py `loss_from_render`, mapping branch,
// and ops/ssim.py `ssim`). On the card the same mathematics as PyTorch ops
// made ~60 launches and autograd ~100 more per mapping iteration, and the
// SSIM window's upload from the host waited for the stream every time.
//
// What it computes (f32 throughout, as the plain path):
//   im_loss    = 0.8 mean|x - y| + 0.2 (1 - mean SSIM(x, y)) over 3 H W
//   depth_loss = sum |m (gd - d)| / max(sum m, 1),
//                m = (gd > 0) & !isnan(d) & !isnan(dsq - d*d)
//   loss       = w_im im_loss + w_d depth_loss
// SSIM: 11 x 11 separable Gaussian window (sigma 1.5, the taps below are
// the f32 values of ops/ssim.py:_gaussian_kernel1d), zero "same" padding,
// C1 = 0.01^2, C2 = 0.03^2, per channel. The gradient follows the plain
// path's conventions: abs'(0) = 0, nothing through a masked-out pixel, and
// none to dsq. With S = lum cs (lum = A1 / B1, cs = A2 / B2 over the
// blurred statistics mu_x, mu_y, E[x^2], E[y^2], E[xy]), the gradient of
// sum S with respect to x is B(a) + 2 x B(b) + y B(c), B the same blur
// (symmetric window, zero padding: its own transpose) and, per pixel,
//   a = dS/dmu_x   = cs (2 mu_y - 2 mu_x lum) / B1 + lum (2 mu_x cs - 2 mu_y) / B2
//   b = dS/dE[x^2] = -S / B2,   c = dS/dE[xy] = 2 lum / B2,
// each zero outside the image (the sum runs over the image's pixels only).
//
// Layouts: x, y (3, H, W) and d, dsq, gd (1, H, W) f32 with unit column
// stride and the channel / row strides given (the render's planes are
// views of the assembled tile image); the gradient planes g_im (3, H, W)
// and g_d (1, H, W) are written contiguous.
//
// What bounds it: the operations. The bytes are ~42 MB at 680 x 1200 (five
// input planes read, four gradient planes written, all of it L2-sized):
// ~13 us at 3.35 TB/s. The separable blurs of five statistics and of the
// three backward coefficients (22 taps each) and ~40 more operations a
// pixel and channel are ~1.1 GFLOP: ~16 us at 67 TFLOP/s. This simple
// design reads every tap from shared memory (one load a fused multiply-add,
// a quarter of the SM's FMA rate) and recomputes the halos, so it runs at
// several times that bound; it is a small part of a mapping iteration.
// What the design does about it: one pass over tiles keeps every
// intermediate in shared memory. A CTA owns a 32 x 32 output tile of one
// channel (grid tiles_x x tiles_y x 3; channel 0's CTAs also take the
// depth term): it loads x and y over the tile plus a 10-pixel halo, blurs
// the five statistics horizontally then vertically over the tile plus a
// 5-pixel halo, forms S, a, b and c there, blurs a, b, c back onto the
// tile and writes the gradient numerator dim_loss/dx (1/N included) and
// -sign(gd - d) m. Per-CTA partial sums (|x - y|, S, masked |gd - d|, the
// mask count) go to a (n_cta, 3) f32 table and an (n_cta,) i32 count; one
// CTA sums them in a fixed order (no float atomics: a repeated launch
// gives the same bits) into the loss scalars and max(sum m, 1). The
// backward is one elementwise pass that scales the numerators by the
// incoming scalar, the weights and 1 / max(sum m, 1), read on the device:
// nothing crosses to the host.
#include <cuda_runtime.h>

namespace {

constexpr int RAD = 5;                 // window radius: 11 taps
constexpr int TW = 32, TH = 32;        // output tile
constexpr int NT = 256;                // threads per CTA
constexpr int LW = TW + 4 * RAD, LH = TH + 4 * RAD;   // loaded: 52 x 52
constexpr int MW = TW + 2 * RAD, MH = TH + 2 * RAD;   // statistics: 42 x 42
constexpr int NRED = 1024;             // threads of the reduction CTA

// the f32 taps of ops/ssim.py:_gaussian_kernel1d(11, 1.5), symmetric
__device__ __forceinline__ float win(int k) {
  const int j = k <= RAD ? k : 2 * RAD - k;
  return j == 0 ? 0x1.0d956cp-10f
       : j == 1 ? 0x1.f1fe02p-8f
       : j == 2 ? 0x1.26eb18p-5f
       : j == 3 ? 0x1.bff0fep-4f
       : j == 4 ? 0x1.b43c40p-3f
                : 0x1.106560p-2f;
}

constexpr float C1 = 0.01f * 0.01f;
constexpr float C2 = 0.03f * 0.03f;

// shared memory (floats): x, y over the loaded region; the five
// horizontal sums over LH x MW (later a, b, c's horizontal sums over
// MH x TW); a, b, c over the statistics region
constexpr int SM_XY = LH * LW;
constexpr int SM_H = 5 * LH * MW;
constexpr int SM_ABC = 3 * MH * MW;
constexpr int SMEM_FLOATS = 2 * SM_XY + SM_H + SM_ABC;
static_assert(3 * MH * TW <= SM_H, "a, b, c's horizontal sums reuse SM_H");

__device__ __forceinline__ float warp_sum(float v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sgn(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

struct Planes {
  const float* x; const float* y; const float* d; const float* dsq;
  const float* gd;
  int x_cs, x_rs, y_cs, y_rs, d_rs, dsq_rs, gd_rs;
};

__global__ void __launch_bounds__(NT, 2)
map_loss_tile_kernel(Planes p, int H, int W, float* part, int* part_n,
                     float* g_im, float* g_d) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + SM_XY;
  float* sh = sy + SM_XY;
  float* sabc = sh + SM_H;
  const int tid = threadIdx.x;
  const int ch = blockIdx.z;
  const int ox = blockIdx.x * TW, oy = blockIdx.y * TH;
  const bool grad = g_im != nullptr;
  const long long plane = (long long)H * W;

  // x and y over the tile plus a 2 * RAD halo, zero outside the image
  const float* xc = p.x + (long long)ch * p.x_cs;
  const float* yc = p.y + (long long)ch * p.y_cs;
  for (int i = tid; i < LH * LW; i += NT) {
    const int ly = i / LW, lx = i - ly * LW;
    const int gy = oy - 2 * RAD + ly, gx = ox - 2 * RAD + lx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    sx[i] = in ? xc[(long long)gy * p.x_rs + gx] : 0.f;
    sy[i] = in ? yc[(long long)gy * p.y_rs + gx] : 0.f;
  }
  __syncthreads();

  // horizontal sums of x, y, x^2, y^2, xy over LH x MW
  for (int i = tid; i < LH * MW; i += NT) {
    const int ly = i / MW, mx = i - ly * MW;
    const float* px = sx + ly * LW + mx;
    const float* py = sy + ly * LW + mx;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
    #pragma unroll
    for (int k = 0; k <= 2 * RAD; ++k) {
      const float x = px[k], y = py[k], w = win(k);
      a0 = fmaf(w, x, a0);
      a1 = fmaf(w, y, a1);
      a2 = fmaf(w, x * x, a2);
      a3 = fmaf(w, y * y, a3);
      a4 = fmaf(w, x * y, a4);
    }
    sh[i] = a0;
    sh[LH * MW + i] = a1;
    sh[2 * LH * MW + i] = a2;
    sh[3 * LH * MW + i] = a3;
    sh[4 * LH * MW + i] = a4;
  }
  __syncthreads();

  // vertical sums: the statistics, S and (with the gradient) a, b, c over
  // the statistics region, or over the tile alone without it
  float l1 = 0.f, ss = 0.f, dsum = 0.f;
  int cnt = 0;
  const int rh = grad ? MH : TH, rw = grad ? MW : TW;
  const int r0 = grad ? 0 : RAD;        // region origin in MH x MW
  for (int i = tid; i < rh * rw; i += NT) {
    const int my = r0 + i / rw, mx = r0 + i % rw;
    float s[5];
    #pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float* col = sh + q * LH * MW + my * MW + mx;
      float acc = 0.f;
      #pragma unroll
      for (int k = 0; k <= 2 * RAD; ++k) acc = fmaf(win(k), col[k * MW], acc);
      s[q] = acc;
    }
    const float mu1 = s[0], mu2 = s[1];
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu12 = mu1 * mu2;
    const float s1 = s[2] - mu1_sq, s2 = s[3] - mu2_sq, s12 = s[4] - mu12;
    const float B2 = s1 + s2 + C2;
    const float cs = (2.f * s12 + C2) / B2;
    const float B1 = mu1_sq + mu2_sq + C1;
    const float lum = (2.f * mu12 + C1) / B1;
    const float S = lum * cs;
    const int gy = oy - RAD + my, gx = ox - RAD + mx;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bool inner = my >= RAD && my < RAD + TH && mx >= RAD && mx < RAD + TW;
    if (in && inner) ss += S;
    if (grad) {
      const int j = my * MW + mx;
      sabc[j] = in ? cs * (2.f * mu2 - 2.f * mu1 * lum) / B1
                     + lum * (2.f * mu1 * cs - 2.f * mu2) / B2 : 0.f;
      sabc[MH * MW + j] = in ? -S / B2 : 0.f;
      sabc[2 * MH * MW + j] = in ? 2.f * lum / B2 : 0.f;
    }
  }

  // |x - y| over the tile
  for (int i = tid; i < TH * TW; i += NT) {
    const int ty = i / TW, tx = i - ty * TW;
    if (oy + ty < H && ox + tx < W) {
      const int j = (ty + 2 * RAD) * LW + tx + 2 * RAD;
      l1 += fabsf(sx[j] - sy[j]);
    }
  }

  // the depth term, on channel 0's CTAs
  if (ch == 0) {
    for (int i = tid; i < TH * TW; i += NT) {
      const int gy = oy + i / TW, gx = ox + i % TW;
      if (gy >= H || gx >= W) continue;
      const float d = p.d[(long long)gy * p.d_rs + gx];
      const float dsq = p.dsq[(long long)gy * p.dsq_rs + gx];
      const float gd = p.gd[(long long)gy * p.gd_rs + gx];
      // the plain path's uncertainty, rounded as it rounds (no contraction)
      const float unc = __fsub_rn(dsq, __fmul_rn(d, d));
      const bool m = gd > 0.f && !isnan(d) && !isnan(unc);
      const float diff = m ? __fsub_rn(gd, d) : 0.f;
      dsum += fabsf(diff);
      cnt += m ? 1 : 0;
      if (grad) g_d[(long long)gy * W + gx] = -sgn(diff);
    }
  }

  if (grad) {
    __syncthreads();
    // a, b, c: horizontal sums over MH x TW (into the statistics' space)
    for (int i = tid; i < MH * TW; i += NT) {
      const int my = i / TW, tx = i - my * TW;
      #pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float* row = sabc + q * MH * MW + my * MW + tx;
        float acc = 0.f;
        #pragma unroll
        for (int k = 0; k <= 2 * RAD; ++k) acc = fmaf(win(k), row[k], acc);
        sh[q * MH * TW + i] = acc;
      }
    }
    __syncthreads();
    // vertical sums onto the tile, and the colour gradient
    const float inv_n = 1.f / (float)(3 * plane);
    float* gc = g_im + (long long)ch * plane;
    for (int i = tid; i < TH * TW; i += NT) {
      const int ty = i / TW, tx = i - ty * TW;
      const int gy = oy + ty, gx = ox + tx;
      if (gy >= H || gx >= W) continue;
      float bs[3];
      #pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float* col = sh + q * MH * TW + ty * TW + tx;
        float acc = 0.f;
        #pragma unroll
        for (int k = 0; k <= 2 * RAD; ++k) acc = fmaf(win(k), col[k * TW], acc);
        bs[q] = acc;
      }
      const int j = (ty + 2 * RAD) * LW + tx + 2 * RAD;
      const float x = sx[j], y = sy[j];
      const float dssim = bs[0] + 2.f * x * bs[1] + y * bs[2];
      gc[(long long)gy * W + gx] = (0.8f * sgn(x - y) - 0.2f * dssim) * inv_n;
    }
  }

  // the CTA's partial sums, in a fixed order
  __shared__ float red[NT / 32][3];
  __shared__ int red_n[NT / 32];
  l1 = warp_sum(l1);
  ss = warp_sum(ss);
  dsum = warp_sum(dsum);
  const int cw = (int)warp_sum_ll(cnt);
  const int lane = tid & 31, wid = tid >> 5;
  if (lane == 0) {
    red[wid][0] = l1; red[wid][1] = ss; red[wid][2] = dsum; red_n[wid] = cw;
  }
  __syncthreads();
  if (tid == 0) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f;
    int tn = 0;
    for (int w = 0; w < NT / 32; ++w) {
      t0 += red[w][0]; t1 += red[w][1]; t2 += red[w][2]; tn += red_n[w];
    }
    const int b = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                  + blockIdx.x;
    part[3 * b] = t0; part[3 * b + 1] = t1; part[3 * b + 2] = t2;
    part_n[b] = tn;
  }
}

// one CTA: the partials summed in a fixed order into the loss scalars
__global__ void __launch_bounds__(NRED)
map_loss_reduce_kernel(const float* part, const int* part_n, int n_part,
                       long long n_px, float w_im, float w_d, float* loss,
                       float* im_loss, float* depth_loss, float* denom) {
  const int tid = threadIdx.x;
  float l1 = 0.f, ss = 0.f, ds = 0.f;
  long long n = 0;
  for (int b = tid; b < n_part; b += NRED) {
    l1 += part[3 * b]; ss += part[3 * b + 1]; ds += part[3 * b + 2];
    n += part_n[b];
  }
  __shared__ float red[NRED / 32][3];
  __shared__ long long red_n[NRED / 32];
  l1 = warp_sum(l1); ss = warp_sum(ss); ds = warp_sum(ds);
  n = warp_sum_ll(n);
  const int lane = tid & 31, wid = tid >> 5;
  if (lane == 0) {
    red[wid][0] = l1; red[wid][1] = ss; red[wid][2] = ds; red_n[wid] = n;
  }
  __syncthreads();
  if (tid == 0) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f;
    long long tn = 0;
    for (int w = 0; w < NRED / 32; ++w) {
      t0 += red[w][0]; t1 += red[w][1]; t2 += red[w][2]; tn += red_n[w];
    }
    const float nf = (float)n_px;
    const float il = 0.8f * (t0 / nf) + 0.2f * (1.f - t1 / nf);
    const float den = (float)(tn > 0 ? tn : 1);
    const float dl = t2 / den;
    *loss = w_im * il + w_d * dl;
    *im_loss = il;
    *depth_loss = dl;
    *denom = den;
  }
}

// the backward: d im = g w_im g_im, d depth = g w_d g_d / max(sum m, 1)
__global__ void map_loss_bwd_kernel(const float* g, const float* denom,
                                    float w_im, float w_d, const float* g_im,
                                    const float* g_d, long long plane,
                                    float* d_im, float* d_depth) {
  const float gs = *g;
  const float s_im = gs * w_im, s_d = gs * w_d / *denom;
  const long long n = 4 * plane;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < 3 * plane) d_im[i] = s_im * g_im[i];
    else d_depth[i - 3 * plane] = s_d * g_d[i - 3 * plane];
  }
}

}  // namespace

extern "C" {

const char* vtgs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// strides: x (channel, row), y (channel, row), then the rows of d, dsq and
// gd; g_im / g_d null: the loss alone, no gradient written
int vtgs_map_loss_fwd(const float* x, const float* y, const float* d,
                      const float* dsq, const float* gd, int H, int W,
                      int x_cs, int x_rs, int y_cs, int y_rs, int d_rs,
                      int dsq_rs, int gd_rs, float w_im, float w_d,
                      float* part, int* part_n, float* g_im, float* g_d,
                      float* loss, float* im_loss, float* depth_loss,
                      float* denom, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      map_loss_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  Planes p{x, y, d, dsq, gd, x_cs, x_rs, y_cs, y_rs, d_rs, dsq_rs, gd_rs};
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, 3);
  cudaStream_t s = (cudaStream_t)stream;
  map_loss_tile_kernel<<<grid, NT, smem, s>>>(p, H, W, part, part_n, g_im,
                                               g_d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  map_loss_reduce_kernel<<<1, NRED, 0, s>>>(
      part, part_n, (int)(grid.x * grid.y * grid.z), 3LL * H * W, w_im, w_d,
      loss, im_loss, depth_loss, denom);
  return (int)cudaGetLastError();
}

int vtgs_map_loss_bwd(const float* g, const float* denom, float w_im,
                      float w_d, const float* g_im, const float* g_d, int H,
                      int W, float* d_im, float* d_depth, void* stream) {
  const long long plane = (long long)H * W;
  const long long need = (4 * plane + 255) / 256;
  const int blocks = (int)(need < 132 * 8 ? need : 132 * 8);
  map_loss_bwd_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      g, denom, w_im, w_d, g_im, g_d, plane, d_im, d_depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
