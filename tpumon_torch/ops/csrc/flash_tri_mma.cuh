// Tensor-core pieces of the bf16 causal flash-attention backward kernels
// (flash_attention_tri_bwd.cu): staging of
// bf16 tiles into shared memory and warp-level mma.sync.m16n8k16 products
// with f32 accumulators.
//
// A CTA of 4 warps owns 64 rows; warp w owns rows 16 w .. 16 w + 15 and
// computes its products as 16 x 8 f32 tiles (the m16n8k16 C fragment:
// lane l holds rows l / 4 and l / 4 + 8, columns 2 (l % 4) and +1). A row
// is spread over the 4 lanes of a quad, so its softmax reduces over a
// group of 4 lanes (online_softmax.cuh). A score tile's C fragments are
// repacked in registers as the A fragments of the next product (P V,
// dS K, ...), rounded to bf16 on the way, as the reference rounds P and
// dS to the input type before those products.
//
// Shared tiles are bf16 with a row stride of COLS + 8 elements: rows stay
// 16-byte aligned for the staging stores, and the 8 rows one fragment
// load touches fall into distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpumon {
namespace flash {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps, 16 owned rows each

template <int COLS>
__host__ __device__ constexpr int ld() {
  return COLS + 8;
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }  // fragment row
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }          // fragment column pair

// d += a * b for one 16 x 8 x 16 tile: bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ROWS contiguous rows of COLS bf16 from device memory into shared memory
// with row stride LD, with 16-byte copies.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * COLS + c);
  }
}

// The same rows transposed: dst[c * LDT + r] = src[r][c]. Consecutive
// threads take consecutive rows, so their 2-byte stores are contiguous.
template <int ROWS, int COLS, int LDT>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* __restrict__ src) {
  for (int i = threadIdx.x; i < ROWS * (COLS / 8); i += kThreads) {
    const int r = i % ROWS, c = (i / ROWS) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * COLS + c);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * LDT + r] = e[j];
  }
}

// A fragment of the 16 x 16 block at rows r0.., columns k0.. of a shared
// row-major [*, LD] tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int r0, int k0) {
  const bf16* p = s + (r0 + lane_g()) * LD + k0 + 2 * lane_t();
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// c[n] += sum over k < 16 KC of A[row][k] * s[8 n + col][k]: A given as
// register fragments, B^T as the rows of a shared [*, LD] tile (B[k][col]
// = s[col][k], so s holds B "column-major", as mma's .col operand wants).
template <int NT, int KC, int LD>
__device__ __forceinline__ void mma_regs(float (&c)[NT][4], const uint32_t (&a)[KC][4],
                                         const bf16* s) {
  const bf16* p = s + lane_g() * LD + 2 * lane_t();
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* b = p + n * 8 * LD + kc * 16;
      mma16816(c[n], a[kc], ld32(b), ld32(b + 8));
    }
}

// The same with A read from rows r0.. of a shared row-major [*, LDA] tile.
template <int NT, int KC, int LDA, int LDB>
__device__ __forceinline__ void mma_smem(float (&c)[NT][4], const bf16* sa, int r0,
                                         const bf16* sb) {
  const bf16* p = sb + lane_g() * LDB + 2 * lane_t();
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4];
    load_a<LDA>(a, sa, r0, kc * 16);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* b = p + n * 8 * LDB + kc * 16;
      mma16816(c[n], a, ld32(b), ld32(b + 8));
    }
  }
}

// C fragments of a 16 x 8 NT tile, rounded to bf16, as the A fragments
// of a 16 x 16 (NT / 2) operand.
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    a[kc][0] = pack(c[2 * kc][0], c[2 * kc][1]);
    a[kc][1] = pack(c[2 * kc][2], c[2 * kc][3]);
    a[kc][2] = pack(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a[kc][3] = pack(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero_frags(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Store this warp's 16 x (8 NT) f32 tile, rows r0.. of a row-major
// [*, 8 NT] bf16 tensor, scaled by the per-row factors `mul` (row g, g+8).
template <int NT>
__device__ __forceinline__ void store(bf16* __restrict__ dst, int r0, const float (&c)[NT][4],
                                      float mul0 = 1.f, float mul1 = 1.f) {
  constexpr int kCols = NT * 8;
  bf16* row0 = dst + (size_t)(r0 + lane_g()) * kCols + 2 * lane_t();
  bf16* row1 = row0 + 8 * kCols;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(row0 + n * 8) = pack(c[n][0] * mul0, c[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(row1 + n * 8) = pack(c[n][2] * mul1, c[n][3] * mul1);
  }
}

}  // namespace tc
}  // namespace flash
}  // namespace tpumon
