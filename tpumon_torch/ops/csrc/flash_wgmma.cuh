// The tile layout and wgmma helpers shared by the bf16 flash kernels: the
// forward (flash_fwd.cuh) and the backward (flash_attention_tri_bwd.cu).
//
// A tile is ROWS consecutive rows of one bh's [T, HD] slice, in shared
// memory as TMA writes it: 64-column boxes of 128-byte swizzled rows
// (head dim 64: one box, 128: two, 256: four), or one box of 64-byte
// swizzled rows (head dim 32). The tensor maps are 3-d [BH, T, HD], so a
// tile that reaches past T (any T: the last tile of a ragged one) loads
// zeros there, not the next bh's rows. wgmma reads a
// tile two ways through its descriptor: K-major (the head dim is the
// product's depth: S = Q K^T, either side) and MN-major (the rows are the
// depth: V in P V, K in dS K, Q and dO in dS^T Q and P^T dO), so no tile
// is ever transposed by threads.
#pragma once

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace tpumon {
namespace flash {
namespace wg {

using bf16 = __nv_bfloat16;
using namespace hopper;

// Shared-memory layout of a ROWS-row tile at head dim HD.
template <int HD, int ROWS>
struct Tile {
  static_assert(HD == 32 || HD == 64 || HD == 128 || HD == 256, "head dim 32, 64, 128 or 256");
  static_assert(ROWS % 16 == 0 && ROWS <= 256, "TMA boxes of at most 256 rows");
  static constexpr int kRowBytes = HD >= 64 ? 128 : 64;  // swizzled row of a box
  static constexpr int kBoxCols = kRowBytes / 2;         // bf16 columns per TMA box
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kBoxBytes = ROWS * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;  // a multiple of 1024
  static constexpr int kGroupBytes = 8 * kRowBytes;  // 8-row group: the descriptors' stride
  static constexpr uint64_t kLayout = HD >= 64 ? kSwizzle128B : kSwizzle64B;
  static constexpr CUtensorMapSwizzle kSwizzle =
      HD >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

// The tile as a K-major operand (A or B): the 16 columns of head-dim
// slice kk, rows row0.. of the tile (the leading offset is unused when
// K-major).
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int row0, int kk) {
  using L = Tile<HD, ROWS>;
  const int col = kk * 16;
  return smem_desc(tile + (col / L::kBoxCols) * L::kBoxBytes + row0 * L::kRowBytes +
                       (col % L::kBoxCols) * 2,
                   16, L::kGroupBytes, L::kLayout);
}

// The tile as an MN-major B operand: rows 16 kk.. of the tile (the
// product's depth), the columns from col0 (a multiple of the box width) on:
// 64-column boxes kBoxBytes apart (leading), 8-row groups (stride).
template <int HD, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk, int col0 = 0) {
  using L = Tile<HD, ROWS>;
  return smem_desc(tile + (col0 / L::kBoxCols) * L::kBoxBytes + kk * 16 * L::kRowBytes,
                   L::kBoxBytes, L::kGroupBytes, L::kLayout);
}

// One tile starting at `row` of bh's [T, HD] slice; its bytes complete on
// `bar`.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int row, int bh) {
  using L = Tile<HD, ROWS>;
#pragma unroll
  for (int b = 0; b < L::kBoxes; ++b)
    tma_load_3d(dst + b * L::kBoxBytes, map, bar, b * L::kBoxCols, row, bh);
}

// The 3-d [BH, T, HD] bf16 map whose boxes are Tile<HD, ROWS>'s.
template <int HD, int ROWS>
inline bool tile_map(CUtensorMap* map, const void* p, int bh, int t) {
  using L = Tile<HD, ROWS>;
  return tensor_map_3d(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, HD, t, bh, L::kBoxCols,
                       ROWS, L::kSwizzle);
}

// D[64 x N] += A[64 x 16] B[16 x N], both K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128) wgmma_m64n128k16_ss(d, da, db, 1);
  else if constexpr (N == 64) wgmma_m64n64k16_ss(d, da, db, 1);
  else wgmma_m64n32k16_ss(d, da, db, 1);
}

// D[64 x N] = A B over the head dim, both K-major in shared memory: HD / 16
// k16 slices, the first overwriting D (its earlier values are no input).
template <int N, int HD, int ROWS_A, int ROWS_B>
__device__ __forceinline__ void wgmma_scores(float (&d)[N / 2], const uint8_t* a, int row0,
                                             const uint8_t* b) {
  if constexpr (N == 128)
    wgmma_m64n128k16_ss_zero(d, desc_kmajor<HD, ROWS_A>(a, row0, 0),
                             desc_kmajor<HD, ROWS_B>(b, 0, 0));
  else if constexpr (N == 64)
    wgmma_m64n64k16_ss_zero(d, desc_kmajor<HD, ROWS_A>(a, row0, 0),
                            desc_kmajor<HD, ROWS_B>(b, 0, 0));
  else
    wgmma_m64n32k16_ss_zero(d, desc_kmajor<HD, ROWS_A>(a, row0, 0),
                            desc_kmajor<HD, ROWS_B>(b, 0, 0));
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk)
    wgmma_ss<N>(d, desc_kmajor<HD, ROWS_A>(a, row0, kk), desc_kmajor<HD, ROWS_B>(b, 0, kk));
}

// D[64 x N] += A[64 x 16] B[16 x N], A from registers, B MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 256) wgmma_m64n256k16_rs(d, a, db, 1);
  else if constexpr (N == 128) wgmma_m64n128k16_rs(d, a, db, 1);
  else if constexpr (N == 64) wgmma_m64n64k16_rs(d, a, db, 1);
  else wgmma_m64n32k16_rs(d, a, db, 1);
}

// 2^x, flushing denormal results to 0 (one MUFU.EX2).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// An m64nN f32 accumulator as the register-A fragments of its N / 16
// column slices, rounded to bf16 pairwise: thread's s[4 j + 2 i + e] is
// row lane / 4 + 8 i (of its warp's 16), column 8 j + 2 (lane % 4) + e,
// which is where the m16n8k16 A fragment wants it.
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&p)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

}  // namespace wg
}  // namespace flash
}  // namespace tpumon
