// Row movement of the binned mapping renderer for Hopper (sm_90a): the
// slot gather from the (M, 8) field table into the per-slot planes that K1
// and K3 read (SG), and the slot-inverse sum that maps K3's per-slot
// gradient rows back onto the field table (SI).
//
// Replaces no TPU kernel: the JAX package leaves both to XLA
// (vtgaussian_slam_tpu/ops/rasterizer/binning.py `gather_channels` and
// `weighted_inverse`, called from core/map_cache.py `SplatBinned`). On the
// card the same PyTorch indexing made two full passes over the (T, mpt)
// table for the gather (a row gather of every slot, padding included, then
// a strided copy into planes) and, for the inverse, s2 row gathers, s2
// broadcast multiplies and s2 - 1 adds, each a full pass over (N, 8).
//
// SG: f8 (M, 8) f32 rows, tab (T, mpt) i64, counts (T,) i32 ->
//     planes (T, 8, mpt) f32: planes[t, c, j] = f8[tab[t, j], c] for
//     j < counts[t], and 0 past the count (K1 and K3 never read those
//     slots: walk.cuh copy_rows zero-fills them without a read).
// SI: rows (P, 8) f32, pos (N, s2) i64 in [0, P), w (N, s2) f32 ->
//     out (N, 8) f32: g = rows[pos[n, 0]] w[n, 0], then
//     g = g + rows[pos[n, k]] w[n, k] for k = 1 .. s2 - 1, every product
//     and sum rounded on its own (__fmul_rn, __fadd_rn: no contraction
//     into an FMA), which are the bits of `weighted_inverse` on the card.
//     A pad column (w 0) still reads the row at its position (0) and
//     multiplies it by 0, as PyTorch does, so the sign of a zero and a
//     non-finite row read the same.
//
// What bounds them on the H100: the bytes. SG reads one table entry (8 B)
// and one 32-byte row per live slot and writes 32 B per slot, padding
// included: at room0 shapes (3225 tiles, mpt 2048, ~2M live slots) ~0.29
// GB, ~0.09 ms at 3.35 TB/s, where the PyTorch pair moved ~200 B a slot
// (~1.3 GB). SI reads s2 positions, weights and rows and
// writes one row per Gaussian: ~208 B a Gaussian at s2 4, ~0.12 ms at
// N = 2M. The rows are gathered (random 32-byte rows), so what the design
// does about it is to make every access a full sector: a row is two
// 16-byte read-only loads, a warp's table reads and plane stores are each
// 128 contiguous bytes per channel, and SG's CTA that starts at or past
// its tile's count reads only the count and writes its zeros.
//
// Design. SG: one CTA per (tile, 256-slot chunk), one thread per slot; the
// thread writes its 8 values to the 8 planes, so neighbouring threads
// store neighbouring floats of one plane and the transpose needs no shared
// memory and no second pass. SI: one thread per Gaussian, s2 a runtime
// loop (span_cap 2 or 3), grid-strided. Neither uses atomics: a repeated
// launch gives the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;   // threads per CTA; SG: slots per chunk

__global__ void __launch_bounds__(NT)
    slot_gather_kernel(const float4* __restrict__ f8,
                       const long long* __restrict__ tab,
                       const int* __restrict__ counts, int mpt,
                       float* __restrict__ planes) {
  const int t = blockIdx.x;
  const int j = blockIdx.y * NT + threadIdx.x;
  if (j >= mpt) return;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
  if (j < __ldg(counts + t)) {
    const long long id = __ldg(tab + (size_t)t * mpt + j);
    a = __ldg(f8 + 2 * id);
    b = __ldg(f8 + 2 * id + 1);
  }
  float* out = planes + (size_t)t * 8 * mpt + j;
  out[0] = a.x;
  out[(size_t)mpt] = a.y;
  out[2 * (size_t)mpt] = a.z;
  out[3 * (size_t)mpt] = a.w;
  out[4 * (size_t)mpt] = b.x;
  out[5 * (size_t)mpt] = b.y;
  out[6 * (size_t)mpt] = b.z;
  out[7 * (size_t)mpt] = b.w;
}

__device__ __forceinline__ float4 mul4(float4 r, float w) {
  return make_float4(__fmul_rn(r.x, w), __fmul_rn(r.y, w), __fmul_rn(r.z, w),
                     __fmul_rn(r.w, w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__global__ void __launch_bounds__(NT)
    slot_inverse_kernel(const float4* __restrict__ rows,
                        const long long* __restrict__ pos,
                        const float* __restrict__ w, int s2, long long n,
                        float4* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
       i += (long long)gridDim.x * NT) {
    const long long* p = pos + i * s2;
    const float* wi = w + i * s2;
    long long r = __ldg(p);
    float wk = __ldg(wi);
    float4 lo = mul4(__ldg(rows + 2 * r), wk);
    float4 hi = mul4(__ldg(rows + 2 * r + 1), wk);
#pragma unroll 4
    for (int k = 1; k < s2; ++k) {
      r = __ldg(p + k);
      wk = __ldg(wi + k);
      lo = add4(lo, mul4(__ldg(rows + 2 * r), wk));
      hi = add4(hi, mul4(__ldg(rows + 2 * r + 1), wk));
    }
    out[2 * i] = lo;
    out[2 * i + 1] = hi;
  }
}

}  // namespace

extern "C" {

const char* vtgs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// f8 16-byte aligned (M, 8); tab (n_tiles, mpt); planes (n_tiles, 8, mpt)
int vtgs_slot_gather(const float* f8, const long long* tab, const int* counts,
                     int n_tiles, int mpt, float* planes, void* stream) {
  if (n_tiles <= 0 || mpt <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, (mpt + NT - 1) / NT);
  slot_gather_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(f8), tab, counts, mpt, planes);
  return (int)cudaGetLastError();
}

// rows 16-byte aligned (P, 8); pos, w (n, s2); out 16-byte aligned (n, 8)
int vtgs_slot_inverse(const float* rows, const long long* pos, const float* w,
                      int s2, long long n, float* out, void* stream) {
  if (n <= 0 || s2 <= 0) return (int)cudaErrorInvalidValue;
  const long long need = (n + NT - 1) / NT;
  const int blocks = (int)(need < 132 * 16 ? need : 132 * 16);
  slot_inverse_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(rows), pos, w, s2, n,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
