// What the tile walks of splat.cu and blend.cu share: the walk's constants,
// the cp.async staging of slot / record rows, the per-warp pixel block, its
// box test and the forwards' compacted list of a chunk's live entries, and
// the TF32 tensor-core helpers of the backwards.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace vtgs {

constexpr int TILE = 16;
constexpr int TPX = TILE * TILE;   // one thread per pixel
constexpr int NWARP = TPX / 32;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_TERM = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NG = 4;     // slots a pixel evaluates together (ILP)
constexpr int SC = 16;    // slots per backward sub-chunk: the mma's M
constexpr int PST = 260;  // row stride of the per-pixel B tables: 4 mod 32, so
                          // a B-fragment load (rows gq, columns tq) hits 32 banks

// Warp w walks the 8 x 4 pixel block at (8 (w & 1), 4 (w >> 1)) of the tile;
// lane l is the pixel (l & 7, l >> 3) of the block.
struct WarpBlock {
  int bx0, by0, pix;        // block origin and this lane's pixel, tile-local
  float x0, x1, y0, y1;     // the block's pixel-centre extent
  float lx, ly;             // this lane's pixel
  __device__ __forceinline__ WarpBlock(int warp, int lane) {
    bx0 = 8 * (warp & 1);
    by0 = 4 * (warp >> 1);
    pix = (by0 + (lane >> 3)) * TILE + bx0 + (lane & 7);
    x0 = (float)bx0;
    x1 = x0 + 7.0f;
    y0 = (float)by0;
    y1 = y0 + 3.0f;
    lx = (float)(pix % TILE);
    ly = (float)(pix / TILE);
  }
  // box = (xlo, xhi, ylo, yhi) in tile-local pixels: can one of the block's
  // pixels lie inside it? An empty box (lo > hi) meets nothing.
  __device__ __forceinline__ bool meets(const float4& box) const {
    return box.x <= x1 && box.y >= x0 && box.z <= y1 && box.w >= y0;
  }
};

// The image tile of operand row `row` (the CTA's blockIdx.x): tids[row] when
// the rows hold an arbitrary tile subset (two-class binning; null: the row
// itself), plus tile_offset (a tile-sharded rank's first tile), as
// pallas_splat._fwd_kernel reads `tid_ref[tl] + meta_ref[1]`. Only the
// pixel origin reads it: the row still addresses counts, slots / records,
// cotangents and outputs.
__device__ __forceinline__ int image_tile(const int* __restrict__ tids,
                                          int row, int tile_offset) {
  return (tids != nullptr ? tids[row] : row) + tile_offset;
}

// A pair is kept only where alpha = op exp(-Q/2) >= 1/255, i.e. where the
// conic form Q <= 2 ln(255 op). The walks test alpha in f32; the box pads the
// radius by 0.1% and 1e-4, far above that test's rounding, so every pair a
// box drops is one the cuts drop. Call it only for op >= 1/255.
__device__ __forceinline__ float box_radius2(float op) {
  return 2.0f * logf(255.0f * op) * 1.001f + 1e-4f;
}

// The forwards' cull (K1 over slots, K4 over records): the entries k < n of
// a chunk whose box meets the warp's block, compacted in entry order into
// the warp's byte list (so a chunk holds at most 256 entries) and padded with
// zeros to a whole group of NG; returns how many are live. A lane tests one
// box per 32 entries; a ballot and a popcount give each live entry its place.
// The walk then reads a group's NG indices with one load, and only a chunk's
// last group is partial.
__device__ __forceinline__ int live_list(unsigned char* lst, const float4* box,
                                         int n, const WarpBlock& wb, int lane) {
  int L = 0;
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int k = k0 + lane;
    const bool in = k < n && wb.meets(box[k]);
    const unsigned m = __ballot_sync(FULL, in);
    if (in) lst[L + __popc(m & ((1u << lane) - 1u))] = (unsigned char)k;
    L += __popc(m);
  }
  if (lane < NG) lst[L + lane] = 0;   // pads the last group
  __syncwarp();
  return L;
}

// column swizzle of row r of a warp's (gp, w) buffer: the walk's row stores
// and the A-fragment loads (rows gq, gq + 8; columns 8 ks + tq, + 4) are
// both free of bank conflicts
__device__ __forceinline__ int pw_at(int r, int c) {
  return r * 32 + (c ^ ((4 * r) & 31));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// copy columns [c0, c0 + N) of the first `rows` rows of a tile's (rows, mpt)
// table into dst (rows, N); columns at or past count are zero-filled
template <int N>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows, int mpt, int c0, int count,
                                          int p) {
  for (int i = p; i < rows * N; i += TPX) {
    const int row = i / N, col = i % N;
    const bool ok = c0 + col < count;
    cp_async4(dst + i, src + (size_t)row * mpt + (ok ? c0 + col : 0), ok);
  }
  cp_async_commit();
}

// a = hi + lo for the TF32 products: hi is a rounded to TF32 (to nearest,
// ties away from zero: the bits cvt.rna.tf32.f32 gives a finite a), lo =
// a - hi exactly; the mma reads the top 19 bits of lo, which leaves at
// most 2^-22 |a|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16x8, f32) += a (16x8, TF32, row-major) . b (8x8, TF32, col-major)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace vtgs
