// Paged-attention decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpumon/ops/paged_attention.py::
// paged_attention (body _paged_kernel): one query token per sequence
// attends over its K/V rows, which live in fixed-size pages of a shared
// head-major pool [n_kv_heads, num_pages, page_size, head_dim] and are
// found through the sequence's page table. GQA is handled in the kernel
// (each kv head serves a group of query heads), the softmax is taken
// online over pages in table order, rows at or past the length are
// masked, and a length-0 sequence returns zeros.
//
// Bound: bytes. Each call must read every live K and V row once
// (2 * sum(lengths) * n_kv_heads * head_dim * elem bytes, ~268 MB at the
// production decode shape) and does ~2 FLOPs per byte, far below the
// ~295 FLOP/byte where Hopper's tensor cores would become the limit. So
// the design is about keeping enough bytes in flight on every SM.
//
// The design.
// - The page axis is split across CTAs: grid (splits, n_kv_heads, batch),
//   each CTA owns `pages_per_split` consecutive table entries of one
//   (sequence, kv head), so the card fills however long the longest
//   sequence is. The wrapper sizes the grid from static shapes (no read of
//   the lengths on the host); a split that starts at or past its
//   sequence's length returns at once.
// - One load warp walks the split's pages in table order and streams each
//   page as tiles of up to kRows rows of K and V through a ring of
//   `stages` shared-memory stages, by TMA over 3-d [kv head x page,
//   page_size, head_dim] tensor maps (any page size: a tile that reaches
//   past its page loads zeros there, not the next page's rows) with
//   swizzled rows (128-byte; 64 at bf16 head dim 32 and f32 16; 32 at bf16
//   16), so the consumers' ldmatrix reads are free of bank conflicts. Each
//   stage has a full and an empty mbarrier; nothing synchronises the CTA
//   per tile.
// - Head dims between instances (8, 24, 72, 96, 192, ...) run in the next
//   instance's tile (16, 32, 64, 128, 256). The tensor maps keep the pool's
//   true head dim as their inner extent, so TMA fills the tile's columns
//   past it with zeros and the pool is never copied; q is read and the
//   output written at the true head dim, and the scale is 1/sqrt(true head
//   dim). A row TMA cannot describe (a row stride that is not a multiple
//   of 16 bytes: bf16 head dim % 8, f32 % 4) is copied into the same
//   swizzled tile by the load warp's 32 lanes instead, zero past the head
//   dim and the page, each lane arriving on the stage's full barrier.
// - Four consumer warps split each tile's rows and each keeps its own
//   online softmax state over the keys it has seen, in f32. bf16: the
//   products run on tensor cores (mma.sync.m16n8k16) with the keys as M
//   and the query group, padded to 8, as N: S^T = K Q^T takes K by
//   ldmatrix and Q^T from registers (loaded once); P^T is the score
//   accumulator rounded to bf16 and transposed in registers (movmatrix);
//   O^T = V^T P^T takes V^T by ldmatrix.trans from the row-major tile.
//   f32: CUDA cores (tensor cores would round f32 to TF32), a lane per
//   head_dim / 32 columns (at head dim 16, lanes 16-31 hold zeros),
//   scores reduced over the warp.
// - Shared memory at head dim 256: 3 stages of 64 (bf16) or 32 (f32) rows
//   of K and V, 32 KB each, 192 KB in all. The f32 consumer's registers
//   hold q and the accumulator for 4 query heads at 8 columns a lane
//   there (a group tile of 4), against 8 heads at 4 columns below.
// - A GQA group above the group tile (8 query heads; f32 at head dim
//   256: 4) is cut into tiles: the grid's y axis runs over (kv head, group
//   tile), and each tile's CTAs read the kv head's pages for their query
//   heads (a group of 16 reads the pool twice, in one launch).
// - The end of a split: the four warps' states merge in shared memory in
//   warp order. A sequence with one live split writes its output; else
//   each split writes its partial (m, l, acc) in f32 to a workspace, and
//   the last CTA of the (sequence, kv head) to arrive, by an arrival
//   counter it resets to 0 itself, merges the partials in split order and
//   writes the output. The result does not depend on the order in which
//   CTAs finish, and one launch does it all.
//
// Numerics follow the reference: scores and softmax in f32 (exponentials
// in base 2 of pre-scaled scores, ex2.approx); masked scores are -1e30;
// the unnormalised probabilities are rounded to V's type before P V, their
// sum is not; a row whose sum is 0 returns zeros. A length is clamped to
// [0, max_pages * page_size] and a table entry into the pool, as the
// reference's mask and gather treat them. The V rows of masked keys are
// zeroed before P V, so rows past the length that hold anything (NaN
// included) do not reach the output.
//
// - A head dim above 256 takes the sliced route (WIDE): the output's
//   columns are cut into slices of kSlice = 256, one more grid axis (z:
//   sequence x slice), and each CTA owns one slice. Its scores still run
//   over the whole head dim: for each tile of rows the load warp streams
//   the K rows in 256-column chunks, then the slice's 256 columns of V,
//   each an item of its own ring slot (a slot is one 256-instance tile:
//   2 x stages slots, the 256 instance's bytes), and the consumers add
//   each chunk's products into the same score registers before the
//   softmax. Every slice computes the same scores in the same order, so
//   the slices' softmax states agree; each merges its own columns, with
//   its own workspace rows and arrival counters. q is read from device
//   memory chunk by chunk (it stays in L1), so no head dim is too wide for
//   shared memory or registers. K is read once per slice (from L2 for all
//   but the first): a simple schedule, not a fast one. A chunk's boxes
//   wholly past the head dim are not loaded, and its k-steps past the head
//   dim are not issued.
//
// Supported: float32 and bfloat16, any head_dim >= 1 (instances 16, 32,
// 64, 128 and 256: bf16's mma.sync takes 16 columns a k-step; above 256
// the 256 instance's tiles in slices), any GQA group, any page size. The Python wrapper (tpumon_torch/ops/
// paged_attention.py) checks shapes and types; the launcher below
// re-checks what it indexes by.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "online_softmax.cuh"

namespace {

using namespace tpumon::hopper;
using tpumon::kNegInf;
using tpumon::warp_sum;
using bf16 = __nv_bfloat16;

constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the load warp
constexpr int kMaxGroup = 8;                         // query heads per group tile, at most
constexpr int kMaxStages = 8;
constexpr int kDefaultStages = 3;
constexpr int kSlice = 256;  // output columns a CTA of the sliced route owns
constexpr float kLog2e = 1.4426950408889634f;

// A tile of up to kRows rows of one page, as TMA writes it: boxes of
// kBoxCols columns whose kRowBytes-byte rows are swizzled (the 16-byte
// chunk c of row r sits at chunk c ^ (r % 8) for 128-byte rows, c ^ (r / 2
// % 4) for 64-byte rows, c ^ (r / 4 % 2) for 32-byte rows), kRows rows
// apart. Consumer warp w reads rows w * kKeysPerWarp .. of it. kGroup:
// the query heads a CTA serves of its kv head's group.
template <typename T, int HD>
struct Tile {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128 || HD == 256,
                "head dim 16, 32, 64, 128 or 256");
  static constexpr int kElem = sizeof(T);
  static constexpr int kGroup = kElem == 4 && HD == 256 ? 4 : kMaxGroup;
  static constexpr int kRows = kElem == 2 ? 64 : 32;
  static constexpr int kKeysPerWarp = kRows / kConsumerWarps;  // bf16: one m16 tile
  static constexpr int kRowBytes = HD * kElem >= 128 ? 128 : HD * kElem >= 64 ? 64 : 32;
  static constexpr int kBoxCols = kRowBytes / kElem;
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kBoxBytes = kRows * kRowBytes;  // a multiple of 1024
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr CUtensorMapDataType kType =
      kElem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;

  // Byte offset of element (row, col) in the tile.
  __device__ static int offset(int row, int col) {
    const int chunk = (col % kBoxCols) * kElem / 16;
    const int swz = kRowBytes == 128 ? (row & 7) : kRowBytes == 64 ? ((row >> 1) & 3) : ((row >> 2) & 1);
    return (col / kBoxCols) * kBoxBytes + row * kRowBytes + ((chunk ^ swz) << 4) +
           (col * kElem) % 16;
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// 2^x, flushing denormal results to 0 (one MUFU.EX2).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The transpose of an 8x8 bf16 matrix held one pair a thread (row lane / 4,
// columns 2 (lane % 4) and + 1), in the same layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulated.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Params {
  const void* q;
  void* out;
  const int* table;
  const int* lengths;
  float* partials;  // [B, nkv, group tiles, splits] x tile stride x HD acc, then the (m, l) pairs
  int* counters;    // [B, nkv, group tiles] arrivals, 0 between launches
  const void* k_pages;  // the pools, read by the load warp where TMA is not used
  const void* v_pages;
  int num_heads, num_kv_heads, num_pages, page_size, max_pages;
  int head_dim;  // the pool's, at most the instance's HD
  int pages_per_split, tile_rows, stages;
  int manual;  // 1: the load warp copies the tiles (rows TMA cannot describe)
  float scale_log2;
};

// The tiles of one split in order: for each of its live pages, rows
// r0 = 0, tile_rows, ... below the page's live rows; fn(page index,
// r0, rows of the tile at or below the length, ring slot, parity).
template <typename Fn>
__device__ __forceinline__ void for_each_tile(const Params& p, int page0, int page1, int len,
                                              Fn&& fn) {
  int slot = 0;
  uint32_t parity = 0;
  for (int pg = page0; pg < page1; ++pg) {
    const int rows = min(p.page_size, len - pg * p.page_size);
    for (int r0 = 0; r0 < rows; r0 += p.tile_rows) {
      fn(pg, r0, min(p.tile_rows, rows - r0), slot, parity);
      if (++slot == p.stages) {
        slot = 0;
        parity ^= 1;
      }
    }
  }
}

// The sliced route's items of one split in order: for each tile of
// for_each_tile's, `per_tile` items (the K chunks, then the V slice), each
// in the next of `slots` ring slots; fn(page index, r0, rows of the tile
// at or below the length, item, slot, parity).
template <typename Fn>
__device__ __forceinline__ void for_each_item(const Params& p, int page0, int page1, int len,
                                              int per_tile, int slots, Fn&& fn) {
  int slot = 0;
  uint32_t parity = 0;
  for (int pg = page0; pg < page1; ++pg) {
    const int rows = min(p.page_size, len - pg * p.page_size);
    for (int r0 = 0; r0 < rows; r0 += p.tile_rows)
      for (int it = 0; it < per_tile; ++it) {
        fn(pg, r0, min(p.tile_rows, rows - r0), it, slot, parity);
        if (++slot == slots) {
          slot = 0;
          parity ^= 1;
        }
      }
  }
}

// One tile's online-softmax step and O^T += V^T P^T for a bf16 consumer
// warp, in consume_bf16's layouts: s holds the warp's S^T fragment (keys
// key0 + lane / 4 and + 8, raw scores), keys at or past `valid` are
// masked and their V values zeroed; m, l and o are the warp's state, vt
// the tile's V rows. key0 < valid: the warp's first key is live.
template <int HD>
__device__ __forceinline__ void softmax_pv_bf16(float (&s)[4], float (&o)[HD / 16][4],
                                                float (&m)[2], float (&l)[2], const uint8_t* vt,
                                                int key0, int valid, float scale_log2) {
  using L = Tile<bf16, HD>;
  const int lane = threadIdx.x & 31;
  const int quad = lane >> 2, t4 = lane & 3;
  const int k_lo = key0 + quad, k_hi = k_lo + 8;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    s[e] = k_lo < valid ? s[e] * scale_log2 : kNegInf;
    s[2 + e] = k_hi < valid ? s[2 + e] * scale_log2 : kNegInf;
  }
  float pr[4];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float mx = fmaxf(s[e], s[2 + e]);
#pragma unroll
    for (int o2 = 4; o2 < 32; o2 <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
    const float m_new = fmaxf(m[e], mx);
    const float alpha = ex2(m[e] - m_new);
    pr[e] = ex2(s[e] - m_new);
    pr[2 + e] = ex2(s[2 + e] - m_new);
    float sum = pr[e] + pr[2 + e];
#pragma unroll
    for (int o2 = 4; o2 < 32; o2 <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o2);
    l[e] = l[e] * alpha + sum;
    m[e] = m_new;
#pragma unroll
    for (int mt = 0; mt < HD / 16; ++mt) {
      o[mt][e] *= alpha;
      o[mt][2 + e] *= alpha;
    }
  }
  // P^T as the B fragment of O^T = V^T P^T: keys 2 t4 (+ 1) and + 8,
  // query lane / 4.
  const uint32_t pb0 = movmatrix_trans(pack_bf16(pr[0], pr[1]));
  const uint32_t pb1 = movmatrix_trans(pack_bf16(pr[2], pr[3]));
  // A thread's V^T fragment holds keys key0 + 2 t4 (+ 1) in a[0..1]
  // and those + 8 in a[2..3]; zero the masked ones' values.
  const bool partial = key0 + 16 > valid;
  const int kv = key0 + 2 * t4;
  const uint32_t mask_lo = (kv < valid ? 0x0000ffffu : 0u) | (kv + 1 < valid ? 0xffff0000u : 0u);
  const uint32_t mask_hi =
      (kv + 8 < valid ? 0x0000ffffu : 0u) | (kv + 9 < valid ? 0xffff0000u : 0u);
#pragma unroll
  for (int mt = 0; mt < HD / 16; ++mt) {
    uint32_t a[4];
    ldmatrix_x4_trans(a, vt + L::offset(key0 + (lane & 7) + (lane >> 4) * 8,
                                        16 * mt + ((lane >> 3) & 1) * 8));
    if (partial) {
      a[0] &= mask_lo;
      a[1] &= mask_lo;
      a[2] &= mask_hi;
      a[3] &= mask_hi;
    }
    mma_bf16(o[mt], a, pb0, pb1);
  }
}

// bf16 consumer warp w: keys w * 16 .. + 15 of every tile. Accumulator
// layouts (m16n8): s[0..1] is S^T[key lane / 4][query 2 (lane % 4) + e],
// s[2..3] the key + 8; o[mt] is O^T[head-dim row 16 mt + lane / 4 (+ 8 for
// o[mt][2..3])][query 2 (lane % 4) + e]. So a thread's softmax columns are
// queries 2 (lane % 4) and + 1, and a column reduces over the lanes that
// share lane % 4. On return ep_acc [w][query][d] and ep_m, ep_l hold the
// warp's state.
template <int HD>
__device__ __forceinline__ void consume_bf16(const Params& p, const uint8_t* ring,
                                             uint64_t* full, uint64_t* empty, int b, int head0,
                                             int gsz, int page0, int page1, int len,
                                             float* ep_acc, float (*ep_m)[kMaxGroup],
                                             float (*ep_l)[kMaxGroup]) {
  using L = Tile<bf16, HD>;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane >> 2, t4 = lane & 3;

  // Q^T as the B fragment of S^T = K Q^T: query head0 + lane / 4 (0 past
  // the group tile's gsz heads and past the head dim), head-dim pairs
  // 16 ks + 2 t4 and + 8.
  uint32_t qf[HD / 16][2];
  const int hd = p.head_dim;
  const uint16_t* qrow = static_cast<const uint16_t*>(p.q) +
                         ((size_t)b * p.num_heads + head0 + quad) * hd;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = 16 * ks + 8 * i + 2 * t4;
      const uint32_t lo = quad < gsz && c < hd ? qrow[c] : 0u;
      const uint32_t hi = quad < gsz && c + 1 < hd ? qrow[c + 1] : 0u;
      qf[ks][i] = lo | hi << 16;
    }

  float o[HD / 16][4];
#pragma unroll
  for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[mt][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int key0 = w * L::kKeysPerWarp;

  for_each_tile(p, page0, page1, len, [&](int, int, int valid, int slot, uint32_t parity) {
    mbar_wait(&full[slot], parity);
    if (key0 < valid) {  // warp-uniform
      const uint8_t* kt = ring + slot * 2 * L::kBytes;
      const uint8_t* vt = kt + L::kBytes;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, kt + L::offset(key0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                      16 * ks + (lane >> 4) * 8));
        mma_bf16(s, a, qf[ks][0], qf[ks][1]);
      }
      softmax_pv_bf16<HD>(s, o, m, l, vt, key0, valid, p.scale_log2);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  });

  if (quad == 0)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ep_m[w][2 * t4 + e] = m[e];
      ep_l[w][2 * t4 + e] = l[e];
    }
  named_sync(1, 32 * kConsumerWarps);  // every warp is done with the ring
  float* acc = ep_acc + w * kMaxGroup * HD;
#pragma unroll
  for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[(2 * t4 + (i & 1)) * HD + 16 * mt + quad + 8 * (i >> 1)] = o[mt][i];
}

// The f32 consumers' online-softmax step over a block of K keys (scores
// s[key][query head], pre-scaled, its first key live so each head's new
// max is a score) for the first gsz of G query heads: updates m and l,
// rescales o, and leaves P in s.
template <int K, int G, int C>
__device__ __forceinline__ void online_update_f32(float (&s)[K][G], float (&m)[G], float (&l)[G],
                                                  float (&o)[G][C], int gsz) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= gsz) continue;
    float mx = s[0][g];
#pragma unroll
    for (int kk = 1; kk < K; ++kk) mx = fmaxf(mx, s[kk][g]);
    const float m_new = fmaxf(m[g], mx);
    const float alpha = ex2(m[g] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      s[kk][g] = ex2(s[kk][g] - m_new);
      sum += s[kk][g];
    }
    l[g] = l[g] * alpha + sum;
    m[g] = m_new;
#pragma unroll
    for (int j = 0; j < C; ++j) o[g][j] *= alpha;
  }
}

// f32 consumer warp w: keys w * 8 .. + 7 of every tile, kSub at a time;
// lane owns head-dim columns kCols * lane .. + kCols - 1 (head dim 16:
// lanes 16-31 own none and hold zeros). Every lane holds the whole state.
template <int HD>
__device__ __forceinline__ void consume_f32(const Params& p, const uint8_t* ring,
                                            uint64_t* full, uint64_t* empty, int b, int head0,
                                            int gsz, int page0, int page1, int len,
                                            float* ep_acc, float (*ep_m)[kMaxGroup],
                                            float (*ep_l)[kMaxGroup]) {
  using L = Tile<float, HD>;
  constexpr int kG = L::kGroup;
  constexpr int kCols = HD >= 32 ? HD / 32 : 1;
  constexpr int kKeys = L::kKeysPerWarp;
  constexpr int kSub = kCols == 1 ? 8 : 4;  // keys a block: no instance spills
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = kCols * lane;
  const bool owns = col < HD;  // false only past head dim 16's columns
  const int hd = p.head_dim;

  auto load = [&](const uint8_t* tile, int row, float (&x)[kCols]) {
    if constexpr (kCols >= 4) {  // 16-byte chunks, each swizzled on its own
#pragma unroll
      for (int u = 0; u < kCols / 4; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(tile + L::offset(row, col + 4 * u));
        x[4 * u] = v.x, x[4 * u + 1] = v.y, x[4 * u + 2] = v.z, x[4 * u + 3] = v.w;
      }
    } else if constexpr (kCols == 2) {
      const float2 v = *reinterpret_cast<const float2*>(tile + L::offset(row, col));
      x[0] = v.x, x[1] = v.y;
    } else {
      x[0] = owns ? *reinterpret_cast<const float*>(tile + L::offset(row, owns ? col : 0)) : 0.f;
    }
  };

  float q[kG][kCols], o[kG][kCols], m[kG], l[kG];
  const float* qb = static_cast<const float*>(p.q) + ((size_t)b * p.num_heads + head0) * hd;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      q[g][j] = g < gsz && col + j < hd ? qb[g * hd + col + j] : 0.f;
      o[g][j] = 0.f;
    }
  }
  const int key0 = w * kKeys;

  for_each_tile(p, page0, page1, len, [&](int, int, int valid, int slot, uint32_t parity) {
    mbar_wait(&full[slot], parity);
    if (key0 < valid) {  // warp-uniform
      const uint8_t* kt = ring + slot * 2 * L::kBytes;
      const uint8_t* vt = kt + L::kBytes;
      const int n = min(kKeys, valid - key0);
      // kSub keys at a time, each block with a live first key (so m_new is
      // a score): their scores, the online update, then P V.
#pragma unroll 1
      for (int k0 = 0; k0 < n; k0 += kSub) {
        float s[kSub][kG];
#pragma unroll
        for (int kk = 0; kk < kSub; ++kk) {
          const bool live = k0 + kk < n;
          float x[kCols];
          if (live) load(kt, key0 + k0 + kk, x);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            s[kk][g] = kNegInf;
            if (live && g < gsz) {
              float d = 0.f;
#pragma unroll
              for (int j = 0; j < kCols; ++j) d = fmaf(q[g][j], x[j], d);
              s[kk][g] = warp_sum(d) * p.scale_log2;
            }
          }
        }
        online_update_f32(s, m, l, o, gsz);
#pragma unroll
        for (int kk = 0; kk < kSub; ++kk) {
          if (k0 + kk < n) {  // masked keys' V rows are never read
            float x[kCols];
            load(vt, key0 + k0 + kk, x);
#pragma unroll
            for (int g = 0; g < kG; ++g)
              if (g < gsz)
#pragma unroll
                for (int j = 0; j < kCols; ++j) o[g][j] = fmaf(s[kk][g], x[j], o[g][j]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  });

  if (lane == 0)
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      ep_m[w][g] = m[g];
      ep_l[w][g] = l[g];
    }
  named_sync(1, 32 * kConsumerWarps);  // every warp is done with the ring
  float* acc = ep_acc + w * kMaxGroup * HD;
  if (owns)
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[g * HD + col + j] = o[g][j];
}

// The sliced route's bf16 consumer warp w: keys w * 16 .. + 15 of every
// tile, as consume_bf16 at the 256 instance, but with the head dim in
// chunks: items 0 .. nch - 1 of a tile are its K rows' 256-column chunks,
// whose products add into one S^T accumulator (q's chunk read from device
// memory as each chunk's B fragments; k-steps past the head dim not
// issued), and item nch is the V rows' columns of this CTA's slice, for
// the softmax step and O^T = V^T P^T over the slice.
__device__ __forceinline__ void consume_bf16_wide(const Params& p, const uint8_t* ring,
                                                  uint64_t* full, uint64_t* empty, int b,
                                                  int head0, int gsz, int page0, int page1,
                                                  int len, float* ep_acc,
                                                  float (*ep_m)[kMaxGroup],
                                                  float (*ep_l)[kMaxGroup]) {
  using L = Tile<bf16, kSlice>;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad = lane >> 2, t4 = lane & 3;
  const int hd = p.head_dim;
  const int nch = (hd + kSlice - 1) / kSlice;
  const uint16_t* qrow = static_cast<const uint16_t*>(p.q) +
                         ((size_t)b * p.num_heads + head0 + quad) * hd;

  float o[kSlice / 16][4];
#pragma unroll
  for (int mt = 0; mt < kSlice / 16; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[mt][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[4];
  const int key0 = w * L::kKeysPerWarp;

  for_each_item(p, page0, page1, len, nch + 1, 2 * p.stages,
                [&](int, int, int valid, int it, int slot, uint32_t parity) {
    mbar_wait(&full[slot], parity);
    if (key0 < valid) {  // warp-uniform
      const uint8_t* tile = ring + slot * L::kBytes;
      if (it < nch) {  // a K chunk: S^T += K_c Q_c^T
        if (it == 0) s[0] = s[1] = s[2] = s[3] = 0.f;
        const int c0 = it * kSlice;
#pragma unroll
        for (int ks = 0; ks < kSlice / 16; ++ks) {
          if (c0 + 16 * ks >= hd) break;  // warp-uniform
          uint32_t qf[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = c0 + 16 * ks + 8 * i + 2 * t4;
            const uint32_t lo = quad < gsz && c < hd ? qrow[c] : 0u;
            const uint32_t hi = quad < gsz && c + 1 < hd ? qrow[c + 1] : 0u;
            qf[i] = lo | hi << 16;
          }
          uint32_t a[4];
          ldmatrix_x4(a, tile + L::offset(key0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          16 * ks + (lane >> 4) * 8));
          mma_bf16(s, a, qf[0], qf[1]);
        }
      } else {  // the V slice: the softmax step, then O^T += V^T P^T
        softmax_pv_bf16<kSlice>(s, o, m, l, tile, key0, valid, p.scale_log2);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  });

  if (quad == 0)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ep_m[w][2 * t4 + e] = m[e];
      ep_l[w][2 * t4 + e] = l[e];
    }
  named_sync(1, 32 * kConsumerWarps);  // every warp is done with the ring
  float* acc = ep_acc + w * kMaxGroup * kSlice;
#pragma unroll
  for (int mt = 0; mt < kSlice / 16; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[(2 * t4 + (i & 1)) * kSlice + 16 * mt + quad + 8 * (i >> 1)] = o[mt][i];
}

// The sliced route's f32 consumer warp w: keys w * 8 .. + 7 of every
// tile, as consume_f32 at the 256 instance (a lane owns 8 columns of a
// chunk, group tile 4), with the head dim in chunks: items 0 .. nch - 1
// add each key's partial dot products with q's chunk (read from device
// memory) into per-lane sums, which item nch, the V slice, reduces over
// the warp before the softmax step and P V over the slice's columns.
__device__ __forceinline__ void consume_f32_wide(const Params& p, const uint8_t* ring,
                                                 uint64_t* full, uint64_t* empty, int b,
                                                 int head0, int gsz, int page0, int page1,
                                                 int len, float* ep_acc,
                                                 float (*ep_m)[kMaxGroup],
                                                 float (*ep_l)[kMaxGroup]) {
  using L = Tile<float, kSlice>;
  constexpr int kG = L::kGroup;
  constexpr int kCols = kSlice / 32;
  constexpr int kKeys = L::kKeysPerWarp;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = kCols * lane;
  const int hd = p.head_dim;
  const int nch = (hd + kSlice - 1) / kSlice;

  auto load = [&](const uint8_t* tile, int row, float (&x)[kCols]) {
#pragma unroll
    for (int u = 0; u < kCols / 4; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(tile + L::offset(row, col + 4 * u));
      x[4 * u] = v.x, x[4 * u + 1] = v.y, x[4 * u + 2] = v.z, x[4 * u + 3] = v.w;
    }
  };

  float o[kG][kCols], d[kKeys][kG], m[kG], l[kG];
  const float* qb = static_cast<const float*>(p.q) + ((size_t)b * p.num_heads + head0) * hd;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[g][j] = 0.f;
  }
  const int key0 = w * kKeys;

  for_each_item(p, page0, page1, len, nch + 1, 2 * p.stages,
                [&](int, int, int valid, int it, int slot, uint32_t parity) {
    mbar_wait(&full[slot], parity);
    if (key0 < valid) {  // warp-uniform
      const uint8_t* tile = ring + slot * L::kBytes;
      const int n = min(kKeys, valid - key0);
      if (it < nch) {  // a K chunk: this lane's share of each key's dot products
        const int c = it * kSlice + col;
        float q[kG][kCols];
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            q[g][j] = g < gsz && c + j < hd ? qb[g * hd + c + j] : 0.f;
#pragma unroll
        for (int kk = 0; kk < kKeys; ++kk) {
          float x[kCols];
          if (kk < n) {
            load(tile, key0 + kk, x);
            // A box wholly past the head dim is not loaded, so its columns
            // hold what an earlier item or launch left there: 0 x NaN is
            // NaN, so they are zeroed, not only multiplied by q's zeros.
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              if (c + j >= hd) x[j] = 0.f;
          }
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            float acc = it == 0 ? 0.f : d[kk][g];
            if (kk < n)
#pragma unroll
              for (int j = 0; j < kCols; ++j) acc = fmaf(q[g][j], x[j], acc);
            d[kk][g] = acc;
          }
        }
      } else {  // the V slice: scores, the online update, then P V
        float s[kKeys][kG];
#pragma unroll
        for (int kk = 0; kk < kKeys; ++kk)
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            const float x = warp_sum(d[kk][g]) * p.scale_log2;
            s[kk][g] = kk < n && g < gsz ? x : kNegInf;
          }
        online_update_f32(s, m, l, o, gsz);
#pragma unroll
        for (int kk = 0; kk < kKeys; ++kk) {
          if (kk < n) {  // masked keys' V rows are never read
            float x[kCols];
            load(tile, key0 + kk, x);
#pragma unroll
            for (int g = 0; g < kG; ++g)
              if (g < gsz)
#pragma unroll
                for (int j = 0; j < kCols; ++j) o[g][j] = fmaf(s[kk][g], x[j], o[g][j]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  });

  if (lane == 0)
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      ep_m[w][g] = m[g];
      ep_l[w][g] = l[g];
    }
  named_sync(1, 32 * kConsumerWarps);  // every warp is done with the ring
  float* acc = ep_acc + w * kMaxGroup * kSlice;
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[g * kSlice + col + j] = o[g][j];
}

// The manual route: the load warp's lanes copy the tile of rows r0.. of
// one page (`src` points at the page's first row) into a stage in Tile's
// swizzled layout, 16 bytes at a time, zeros past the head dim and past
// the page; the tile's columns start at the row's column `col` (the
// sliced route's chunks).
template <typename T, int HD>
__device__ __forceinline__ void copy_tile(uint8_t* dst, const T* src, const Params& p, int r0,
                                          int lane, int col = 0) {
  using L = Tile<T, HD>;
  constexpr int kPer = 16 / L::kElem;  // elements in a 16-byte chunk
  constexpr int kChunks = HD / kPer;   // chunks in a row
  const int hd = p.head_dim;
  for (int i = lane; i < p.tile_rows * kChunks; i += 32) {
    const int r = i / kChunks, c0 = (i % kChunks) * kPer;
    alignas(16) T chunk[kPer];
    const bool live = r0 + r < p.page_size;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      chunk[e] = live && col + c0 + e < hd ? src[(size_t)(r0 + r) * hd + col + c0 + e]
                                           : from_float<T>(0.f);
    *reinterpret_cast<uint4*>(dst + L::offset(r, c0)) = *reinterpret_cast<const uint4*>(chunk);
  }
}

// grid (splits, n_kv_heads x group tiles, batch; WIDE: batch x slices),
// kThreads threads, 1024 + stages * 2 * Tile::kBytes bytes of dynamic
// shared memory (WIDE: 2 x stages slots of one tile each). tma_k / tma_v
// map the pools as [kv head x page, page_size, head_dim] in boxes of
// Tile's columns and tile_rows rows (unused when p.manual).
template <typename T, int HD, bool WIDE>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v, const Params p) {
  using L = Tile<T, HD>;
  static_assert(!WIDE || HD == kSlice, "the sliced route runs the 256 instance's tiles");
  constexpr int kSlots = WIDE ? 2 * kMaxStages : kMaxStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kSlots], empty[kSlots];
  __shared__ float ep_m[kConsumerWarps][kMaxGroup], ep_l[kConsumerWarps][kMaxGroup];
  __shared__ int is_last;
  uint8_t* ring = align1024(smem_raw);
  float* ep_acc = reinterpret_cast<float*>(ring);  // [warp][query][HD], once the ring is idle

  const int hd = p.head_dim;
  // WIDE: blockIdx.z is (sequence, slice); this CTA's columns col0 ..
  // col0 + cols - 1 of each head, W a head's room in the workspace.
  const int slices = WIDE ? (hd + kSlice - 1) / kSlice : 1;
  const int split = blockIdx.x, b = WIDE ? blockIdx.z / slices : blockIdx.z;
  const int col0 = WIDE ? (blockIdx.z % slices) * kSlice : 0;
  const int cols = WIDE ? min(kSlice, hd - col0) : hd;
  const int W = WIDE ? kSlice : hd;
  const int splits = gridDim.x;
  const int group = p.num_heads / p.num_kv_heads;
  // Group tile gt of kv head h: query heads head0 .. head0 + gsz - 1;
  // stride = min(group, kGroup), the tile's room in the workspace.
  const int gtiles = (group + L::kGroup - 1) / L::kGroup;
  const int h = blockIdx.y / gtiles, gt = blockIdx.y % gtiles;
  const int head0 = h * group + gt * L::kGroup;
  const int gsz = min(L::kGroup, group - gt * L::kGroup);
  const int stride = min(L::kGroup, group);
  // The reference masks key positions >= length over max_pages*page_size
  // rows, so a length outside [0, that] behaves as its clamp.
  const int len = min(max(p.lengths[b], 0), p.max_pages * p.page_size);
  const int n_pages = (len + p.page_size - 1) / p.page_size;
  const int n_live = (n_pages + p.pages_per_split - 1) / p.pages_per_split;
  T* out = static_cast<T*>(p.out) + ((size_t)b * p.num_heads + head0) * hd + col0;
  if (split >= n_live) {
    if (split == 0) {  // length 0
      if constexpr (WIDE) {
        for (int i = threadIdx.x; i < gsz * cols; i += kThreads)
          out[(i / cols) * hd + i % cols] = from_float<T>(0.f);
      } else {
        for (int i = threadIdx.x; i < gsz * hd; i += kThreads) out[i] = from_float<T>(0.f);
      }
    }
    return;
  }
  const int page0 = split * p.pages_per_split;
  const int page1 = min(page0 + p.pages_per_split, n_pages);
  const int n_slots = WIDE ? 2 * p.stages : p.stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < n_slots; ++s) {
      mbar_init(&full[s], p.manual ? 32 : 1);  // every lane of the load warp, or its TMA
      mbar_init(&empty[s], kConsumerWarps);    // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kConsumerWarps) {
    // The load warp: its lanes fetch 32 table entries at a time (clamped
    // into the pool, as the reference's gather clamps them), lane 0 issues
    // each tile's K and V boxes once its stage is free; on the manual
    // route every lane copies its share and arrives.
    const int* tab = p.table + (size_t)b * p.max_pages;
    int page_l = 0;
    auto page_of = [&](int pg, bool first) {
      if (first && (pg - page0) % 32 == 0) {
        const int mine = pg + lane;
        page_l = mine < page1 ? min(max(tab[mine], 0), p.num_pages - 1) : 0;
      }
      return __shfl_sync(0xffffffffu, page_l, (pg - page0) % 32);
    };
    if constexpr (WIDE) {
      // Items 0 .. nch - 1 of a tile: K's 256-column chunks; item nch: V's
      // columns of this slice. Boxes wholly past the head dim are left out.
      const int nch = slices;
      for_each_item(p, page0, page1, len, nch + 1, n_slots,
                    [&](int pg, int r0, int, int it, int slot, uint32_t parity) {
        const int page = page_of(pg, r0 == 0 && it == 0);
        mbar_wait(&empty[slot], parity ^ 1);
        uint8_t* dst = ring + slot * L::kBytes;
        const int outer = h * p.num_pages + page;
        const bool is_v = it == nch;
        const int col = is_v ? col0 : it * kSlice;
        if (p.manual) {
          const T* src = static_cast<const T*>(is_v ? p.v_pages : p.k_pages) +
                         (size_t)outer * p.page_size * hd;
          copy_tile<T, HD>(dst, src, p, r0, lane, col);
          mbar_arrive(&full[slot]);  // releases this lane's writes
        } else if (lane == 0) {
          const int boxes = min(L::kBoxes, (hd - col + L::kBoxCols - 1) / L::kBoxCols);
          mbar_expect_tx(&full[slot], (uint32_t)(boxes * p.tile_rows * L::kRowBytes));
          for (int bx = 0; bx < boxes; ++bx)
            tma_load_3d(dst + bx * L::kBoxBytes, is_v ? &tma_v : &tma_k, &full[slot],
                        col + bx * L::kBoxCols, r0, outer);
        }
        __syncwarp();
      });
    } else {
      const uint32_t tx = 2u * L::kBoxes * p.tile_rows * L::kRowBytes;
      for_each_tile(p, page0, page1, len, [&](int pg, int r0, int, int slot, uint32_t parity) {
        const int page = page_of(pg, r0 == 0);
        mbar_wait(&empty[slot], parity ^ 1);
        uint8_t* kt = ring + slot * 2 * L::kBytes;
        const int outer = h * p.num_pages + page;
        if (p.manual) {
          const size_t at = (size_t)outer * p.page_size * hd;
          copy_tile<T, HD>(kt, static_cast<const T*>(p.k_pages) + at, p, r0, lane);
          copy_tile<T, HD>(kt + L::kBytes, static_cast<const T*>(p.v_pages) + at, p, r0, lane);
          mbar_arrive(&full[slot]);  // releases this lane's writes
        } else if (lane == 0) {
          mbar_expect_tx(&full[slot], tx);
#pragma unroll
          for (int bx = 0; bx < L::kBoxes; ++bx) {
            tma_load_3d(kt + bx * L::kBoxBytes, &tma_k, &full[slot], bx * L::kBoxCols, r0, outer);
            tma_load_3d(kt + L::kBytes + bx * L::kBoxBytes, &tma_v, &full[slot],
                        bx * L::kBoxCols, r0, outer);
          }
        }
        __syncwarp();
      });
    }
  } else if constexpr (WIDE && sizeof(T) == 2) {
    consume_bf16_wide(p, ring, full, empty, b, head0, gsz, page0, page1, len, ep_acc, ep_m,
                      ep_l);
  } else if constexpr (WIDE) {
    consume_f32_wide(p, ring, full, empty, b, head0, gsz, page0, page1, len, ep_acc, ep_m,
                     ep_l);
  } else if constexpr (sizeof(T) == 2) {
    consume_bf16<HD>(p, ring, full, empty, b, head0, gsz, page0, page1, len, ep_acc, ep_m,
                     ep_l);
  } else {
    consume_f32<HD>(p, ring, full, empty, b, head0, gsz, page0, page1, len, ep_acc, ep_m, ep_l);
  }
  __syncthreads();

  // Merge the four warps' states, in warp order. Warp 0 saw the split's
  // first key, so mx is a score and sum > 0.
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;  // (sequence[, slice], kv head, group tile)
  const int part = bh * splits + split;
  float* part_acc = p.partials;
  float2* part_ml = reinterpret_cast<float2*>(p.partials + (size_t)gridDim.z * gridDim.y *
                                                               splits * stride * W);
  // Over the instance's HD columns a head (a power of two: the indices are
  // shifts), skipping those past this CTA's columns; o indexes the output,
  // a the workspace.
  for (int i = threadIdx.x; i < gsz * HD; i += kThreads) {
    const int g = i / HD, d = i % HD, o = g * hd + d, a = g * W + d;
    if (d >= cols) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) mx = fmaxf(mx, ep_m[w][g]);
    float sum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float e = ex2(ep_m[w][g] - mx);
      sum += ep_l[w][g] * e;
      acc += ep_acc[(w * kMaxGroup + g) * HD + d] * e;
    }
    if (n_live == 1) {
      out[o] = from_float<T>(acc / sum);
    } else {
      part_acc[(size_t)part * stride * W + a] = acc;
      if (d == 0) part_ml[(size_t)part * stride + g] = make_float2(mx, sum);
    }
  }
  if (n_live == 1) return;

  // The last split of (b[, slice], h, gt) to arrive merges the partials in
  // split order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&p.counters[bh], 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int first = bh * splits;
  for (int i = threadIdx.x; i < gsz * HD; i += kThreads) {
    const int g = i / HD, d = i % HD, o = g * hd + d, a = g * W + d;
    if (d >= cols) continue;
    float mx = kNegInf;
    for (int s = 0; s < n_live; ++s)
      mx = fmaxf(mx, __ldcg(&part_ml[(size_t)(first + s) * stride + g]).x);
    float sum = 0.f, acc = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float2 ml = __ldcg(&part_ml[(size_t)(first + s) * stride + g]);
      const float e = ex2(ml.x - mx);
      sum += ml.y * e;
      acc += __ldcg(&part_acc[(size_t)(first + s) * stride * W + a]) * e;
    }
    out[o] = from_float<T>(acc / sum);
  }
  if (threadIdx.x == 0) p.counters[bh] = 0;  // ready for the next launch
}

template <typename T, int HD>
int smem_bytes(int stages) {
  return 1024 + stages * 2 * Tile<T, HD>::kBytes;
}

// The instance a head dim runs at: the least of 16, 32, 64, 128, 256 not
// below it; above 256, 256 (the sliced route runs its tiles).
int instance(int head_dim) {
  for (int hd = 16; hd <= 256; hd *= 2)
    if (head_dim <= hd) return hd;
  return 256;
}

// The column slices a CTA's outputs are cut into: 1 up to 256.
int slices(int head_dim) { return (head_dim + kSlice - 1) / kSlice; }

template <typename T, int HD, bool WIDE = false>
cudaError_t launch(Params p, int batch, cudaStream_t stream) {
  using L = Tile<T, HD>;
  p.tile_rows = p.page_size < L::kRows ? p.page_size : L::kRows;
  // TMA needs a row stride that is a multiple of 16 bytes.
  p.manual = (p.head_dim * L::kElem) % 16 != 0;
  CUtensorMap maps[2] = {};
  if (!p.manual) {
    if (encoder() == nullptr) return cudaErrorSharedObjectInitFailed;
    const void* src[2] = {p.k_pages, p.v_pages};
    for (int i = 0; i < 2; ++i)
      if (!tensor_map_3d(&maps[i], src[i], L::kType, L::kElem, p.head_dim, p.page_size,
                         p.num_kv_heads * p.num_pages, L::kBoxCols, p.tile_rows, L::kSwizzle))
        return cudaErrorInvalidValue;
  }
  const int smem = smem_bytes<T, HD>(p.stages);
  cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T, HD, WIDE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  p.scale_log2 = kLog2e / sqrtf((float)p.head_dim);
  const int group = p.num_heads / p.num_kv_heads;
  const dim3 grid((p.max_pages + p.pages_per_split - 1) / p.pages_per_split,
                  p.num_kv_heads * ((group + L::kGroup - 1) / L::kGroup),
                  batch * (WIDE ? slices(p.head_dim) : 1));
  paged_attention_kernel<T, HD, WIDE><<<grid, kThreads, smem, stream>>>(maps[0], maps[1], p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const Params& p, int batch, cudaStream_t stream) {
  if (p.head_dim > kSlice) return launch<T, kSlice, true>(p, batch, stream);
  switch (instance(p.head_dim)) {
    case 16:
      return launch<T, 16>(p, batch, stream);
    case 32:
      return launch<T, 32>(p, batch, stream);
    case 64:
      return launch<T, 64>(p, batch, stream);
    case 128:
      return launch<T, 128>(p, batch, stream);
    case 256:
      return launch<T, 256>(p, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch_checked(const void* q, const void* k_pages, const void* v_pages, const void* table,
                   const void* lengths, void* out, int batch, int num_heads, int num_kv_heads,
                   int num_pages, int page_size, int max_pages, int head_dim, int dtype,
                   int pages_per_split, int stages, void* partials, void* counters,
                   void* stream) {
  if (batch < 1 || num_kv_heads < 1 || num_heads % num_kv_heads != 0 || num_pages < 1 ||
      page_size < 1 || max_pages < 1 || pages_per_split < 1 || stages < 2 ||
      stages > kMaxStages || head_dim < 1)
    return (int)cudaErrorInvalidValue;
  if (pages_per_split < max_pages && (partials == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q,
           out,
           static_cast<const int*>(table),
           static_cast<const int*>(lengths),
           static_cast<float*>(partials),
           static_cast<int*>(counters),
           k_pages,
           v_pages,
           num_heads,
           num_kv_heads,
           num_pages,
           page_size,
           max_pages,
           head_dim,
           pages_per_split,
           0,
           stages,
           0,
           0.f};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_hd<float>(p, batch, s);
    case 1:
      return (int)launch_hd<bf16>(p, batch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int config_smem(int head_dim, int stages) {
  switch (instance(head_dim)) {
    case 16:
      return smem_bytes<T, 16>(stages);
    case 32:
      return smem_bytes<T, 32>(stages);
    case 64:
      return smem_bytes<T, 64>(stages);
    case 128:
      return smem_bytes<T, 128>(stages);
    case 256:
      return smem_bytes<T, 256>(stages);
    default:
      return 0;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/out [batch, num_heads, head_dim];
// k_pages/v_pages [num_kv_heads, num_pages, page_size, head_dim], any
// head_dim >= 1; table [batch, max_pages] int32; lengths [batch] int32; all
// contiguous, 16-byte aligned, on the current device. One split per
// (sequence, kv head, group tile), the default ring: needs no workspace.
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// allocates nothing.
int tpumon_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                           const void* table, const void* lengths, void* out, int batch,
                           int num_heads, int num_kv_heads, int num_pages, int page_size,
                           int max_pages, int head_dim, int dtype, void* stream) {
  return launch_checked(q, k_pages, v_pages, table, lengths, out, batch, num_heads, num_kv_heads,
                        num_pages, page_size, max_pages, head_dim, dtype, max_pages,
                        kDefaultStages, nullptr, nullptr, stream);
}

// The same with the page axis split into ceil(max_pages / pages_per_split)
// CTAs per (sequence, kv head, group tile) and a ring of `stages` stages
// (0: the default). With group = num_heads / num_kv_heads, G the group
// tile (tpumon_paged_attention_config's out[3]), tiles = ceil(group / G)
// and stride = min(group, G), and S the column slices (out[5]: 1 up to
// head dim 256, else ceil(head_dim / 256)) of W columns (head_dim, or 256
// where S > 1): partials, f32, batch * S * num_kv_heads * tiles * splits *
// stride * (W + 2) values, any contents; counters, int32, batch * S *
// num_kv_heads * tiles values, all 0 (the kernel leaves them 0 again).
int tpumon_paged_attention_split(const void* q, const void* k_pages, const void* v_pages,
                                 const void* table, const void* lengths, void* out, int batch,
                                 int num_heads, int num_kv_heads, int num_pages, int page_size,
                                 int max_pages, int head_dim, int dtype, int pages_per_split,
                                 int stages, void* partials, void* counters, void* stream) {
  return launch_checked(q, k_pages, v_pages, table, lengths, out, batch, num_heads, num_kv_heads,
                        num_pages, page_size, max_pages, head_dim, dtype, pages_per_split,
                        stages == 0 ? kDefaultStages : stages, partials, counters, stream);
}

// The kernel's configuration at a head dim >= 1: out[0] its dynamic
// shared-memory bytes at `stages` stages (0: the default), out[1] the
// default stages, out[2] the rows of a stage at `page_size`, out[3] the
// group tile (query heads a CTA serves), out[4] the instance's head dim,
// out[5] the column slices (1 up to 256; above, the sliced route's).
// Returns cudaErrorInvalidValue for a head dim or dtype it does not take.
int tpumon_paged_attention_config(int head_dim, int dtype, int stages, int page_size, int* out) {
  const int st = stages == 0 ? kDefaultStages : stages;
  const int inst = instance(head_dim);
  int smem = 0, rows = 0, group = 0;
  if (head_dim >= 1 && dtype == 1) {
    rows = Tile<bf16, 32>::kRows;
    smem = config_smem<bf16>(head_dim, st);
    group = kMaxGroup;
  } else if (head_dim >= 1 && dtype == 0) {
    rows = Tile<float, 32>::kRows;
    smem = config_smem<float>(head_dim, st);
    group = inst == 256 ? Tile<float, 256>::kGroup : kMaxGroup;
  }
  if (smem == 0) return (int)cudaErrorInvalidValue;
  out[0] = smem;
  out[1] = kDefaultStages;
  out[2] = page_size < rows ? page_size : rows;
  out[3] = group;
  out[4] = inst;
  out[5] = slices(head_dim);
  return 0;
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
