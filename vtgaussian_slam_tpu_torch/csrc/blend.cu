// Record-space blend forward for Hopper (sm_90a).
//
// Replaces vtgaussian_slam_tpu/ops/rasterizer/pallas_blend.py
//   K4 vtgs_blend_fwd <- blend_tiles / _blend_fwd_impl / _fwd_kernel
//
// Layouts (identical to the JAX package):
//   recs   (n_tiles, 16, mpt) f32 rows [mean2d.x mean2d.y conic.a conic.b
//          conic.c opacity colors(C <= 8) pad], depth-ordered per tile
//   counts (n_tiles,) i32
//   out    (n_tiles, 256, C) f32
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
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int TPX = TILE * TILE;
constexpr int RECW = 16;
constexpr int CMAX = 8;
constexpr int CH = 128;
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

}  // extern "C"
