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

// One tile starting at `row` of bh's [T, HD] slice (or, from a wider map,
// the HD columns from col0 on); its bytes complete on `bar`.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int row, int bh, int col0 = 0) {
  using L = Tile<HD, ROWS>;
#pragma unroll
  for (int b = 0; b < L::kBoxes; ++b)
    tma_load_3d(dst + b * L::kBoxBytes, map, bar, col0 + b * L::kBoxCols, row, bh);
}

// The 3-d [BH, T, D] bf16 map (D = HD, or a multiple of it whose HD-column
// chunks load as tiles) whose boxes are Tile<HD, ROWS>'s.
template <int HD, int ROWS>
inline bool tile_map(CUtensorMap* map, const void* p, int bh, int t, int d = HD) {
  using L = Tile<HD, ROWS>;
  return tensor_map_3d(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, d, t, bh, L::kBoxCols,
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

// --- The sliced route: head dims above 256 ------------------------------
//
// The head dim D is a multiple of kChunk = 256 (the wrapper zero-pads one
// between). A CTA owns one slice of the output's columns (forward: 256,
// backward: 128) and computes its scores over all of D: the operands of a
// score product stream in 256-column chunks, as Tile<256, 64>s read from
// the [BH, T, D] maps at column 256 c, and each chunk's wgmmas add into
// the same accumulator. A CTA has kThreads: warps 0-3 are one arithmetic
// warpgroup, lane 0 of warp 4 issues the loads. Loads stream as items
// through a ring of kSlots slots, each two tiles (A, B) and room for 64
// lse and 64 D values; item i sits in slot i % kSlots and waits on parity
// (i / kSlots) & 1, so the producer and the consumer count the same items
// in the same order and the ring's phases follow. A simple schedule, not
// a fast one: each chunk's product completes before the next is issued,
// and every slice recomputes the scores.
namespace wide {

constexpr int kThreads = 160;
constexpr int kRows = 64;     // rows of every tile: the q tile, the k tile
constexpr int kChunk = 256;   // columns of a streamed chunk
constexpr int kSlots = 3;
using LT = Tile<kChunk, kRows>;
constexpr int kSlotBytes = 2 * LT::kBytes + 1024;  // A, B, lse and D; 1024-aligned
constexpr int kSmem = kSlots * kSlotBytes + 2 * kSlots * 8 + 1024;

struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ uint8_t* a(int slot) const { return base + slot * kSlotBytes; }
  __device__ uint8_t* b(int slot) const { return a(slot) + LT::kBytes; }
  __device__ float* lse(int slot) const { return reinterpret_cast<float*>(b(slot) + LT::kBytes); }
  __device__ float* dvec(int slot) const { return lse(slot) + kRows; }
};

// The ring in dynamic shared memory, its barriers initialised (full: the
// producer's one arrival with the bytes; empty: lane 0 of each arithmetic
// warp). Block-collective.
__device__ __forceinline__ Ring ring_init(uint8_t* smem_raw) {
  Ring r;
  r.base = align1024(smem_raw);
  r.full = reinterpret_cast<uint64_t*>(r.base + kSlots * kSlotBytes);
  r.empty = r.full + kSlots;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer: item i's slot, once free.
__device__ __forceinline__ int acquire(const Ring& r, int i) {
  const int s = i % kSlots;
  mbar_wait(&r.empty[s], ((i / kSlots) & 1) ^ 1);
  return s;
}

// The consumer: item i's slot, once loaded.
__device__ __forceinline__ int ready(const Ring& r, int i) {
  const int s = i % kSlots;
  mbar_wait(&r.full[s], (i / kSlots) & 1);
  return s;
}

__device__ __forceinline__ void release(const Ring& r, int slot) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[slot]);
}

// The producer: rows `row_a` of map_a and `row_b` of map_b (null: A only),
// columns col.. of each, into item i's slot.
__device__ __forceinline__ void load_pair(const Ring& r, int i, const CUtensorMap* map_a,
                                          int row_a, const CUtensorMap* map_b, int row_b,
                                          int col, int bh) {
  const int s = acquire(r, i);
  mbar_expect_tx(&r.full[s], (map_b ? 2 : 1) * LT::kBytes);
  load_tile<kChunk, kRows>(r.a(s), map_a, &r.full[s], row_a, bh, col);
  if (map_b) load_tile<kChunk, kRows>(r.b(s), map_b, &r.full[s], row_b, bh, col);
}

// D[64 x 64] (+)= A_c B_c^T over one 256-column chunk, A and B K-major
// 64-row tiles; the first chunk's first k16 slice overwrites D.
__device__ __forceinline__ void scores_chunk(float (&d)[32], const uint8_t* a, const uint8_t* b,
                                             bool first) {
  if (first) {
    wgmma_scores<64, kChunk, kRows, kRows>(d, a, 0, b);
  } else {
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      wgmma_ss<64>(d, desc_kmajor<kChunk, kRows>(a, 0, kk), desc_kmajor<kChunk, kRows>(b, 0, kk));
  }
}

// The consumer: D = A B^T over all of D's nch chunks, items i.. (advanced
// past them), each chunk's product complete before its slot is released.
__device__ __forceinline__ void scores(const Ring& r, int& i, int nch, float (&d)[32]) {
  for (int c = 0; c < nch; ++c) {
    const int s = ready(r, i++);
    wgmma_fence();
    scores_chunk(d, r.a(s), r.b(s), c == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(d);
    release(r, s);
  }
}

}  // namespace wide

}  // namespace wg
}  // namespace flash
}  // namespace tpumon
