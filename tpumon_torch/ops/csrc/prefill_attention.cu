// Chunk attention of the paged prefill for Hopper (sm_90a).
//
// Replaces no TPU kernel. The reference's chunk attention is XLA's dense
// attention over the whole table (tpumon/loadgen/paged_kv.py:122-, through
// serving.decoder_forward): it gathers every page of the sequence's
// table, copies K and V to every query head, and builds the chunk's
// [n_heads, P, max_pages x page] scores in device memory, whatever the
// chunk's end. This kernel computes the same function for one prompt
// chunk straight from the paged pool: q [1, P, n_heads, hd] at sequence
// rows start.. start + P - 1 attends causally over the rows 0..its own of
// the sequence, which live in the pages table[0..start / page] of the
// head-major pool [n_kv_heads, num_pages, page, hd].
//
// Bound: tensor-core operations at long starts, bytes at short ones. A
// chunk needs 4 hd flops a (row, key) pair a head, P start + P (P + 1) / 2
// pairs; at the serving cells' shape (32 query heads on 8 kv heads, hd
// 128, P = page = 1,024) that is 8.6 GFLOP at start 0 and 128.8 at start
// 7,168 (9 and 130 us at 989 TFLOP/s), against 21 and 50 MB of q, out
// and the live K/V rows read once (6 and 15 us at 3.35 TB/s).
//
// What the design does about it: flash_fwd.cuh's bf16 forward, causal,
// with three changes. One CTA owns one (query head, 128-row q tile) and
// loops itself over the 128-row k tiles up to its diagonal; a warp keeps
// TMA loads of the next K and V tiles in flight (2-stage rings,
// mbarriers) while two warpgroups run S = Q K^T and P V with wgmma, P fed
// from registers, the online softmax in f32 in wgmma's fragment layout,
// and the two warpgroups take turns issuing (ping-pong). Only wgmma
// reaches the tensor cores' full rate, and only with the operands on chip.
// - K and V through the table: tile j's TMA coordinate is page
//   table[(j kBN) / page] of kv head kvh, row (j kBN) % page, through the
//   decode kernel's 3-d [kv head x page, page, hd] view of the pool. A page
//   is a multiple of kBN, so a tile never crosses a page, and the pool is
//   read in place: no gather, no copy.
// - The diagonal at the chunk's offset: q tile i holds sequence rows q0 =
//   start + 128 i.. (start is a multiple of the page), so it sees the
//   q0 / kBN tiles below q0 unmasked (the earlier pages', then its own
//   page's) and masks its diagonal tile. No tile past the q tile's last
//   row is loaded: the chunk reads start + P rows at most, rounded up to
//   the tile.
// - GQA without a copy: query head h reads kv head h / (n_heads /
//   n_kv_heads). The grid runs a head's q tiles next to each other and the
//   heads of a kv head in turn, longest rows first, so the CTAs in flight
//   share few kv heads' K and V in L2.
// q is read through a 3-d [P, n_heads, hd] map in boxes of one head's 128
// rows, so the [1, P, n_heads, hd] projection is not transposed either;
// rows past P load as zeros and are not stored.
//
// Numerics: scores in f32 (the gather route rounds them to bf16 first)
// and the softmax in f32, exponentials in base 2 as flash_fwd.cuh's;
// masked scores are -1e30; the unnormalised probabilities are rounded to
// bf16 before P V, their row sum is not. Every row of the chunk is
// computed, padded rows included, as the gather route computes them.
//
// Supported: bfloat16, head dim 64 or 128, a page that is a multiple of
// 128, start a multiple of the page, 1 <= P <= page. The Python wrapper
// (tpumon_torch/ops/prefill_attention.py) checks shapes and types; the
// launcher re-checks what it indexes by.

#include "flash_fwd.cuh"

namespace tpumon {
namespace chunk {

using namespace hopper;
using namespace flash::wg;  // the ring, its loop and the tiles' layout

constexpr int kBN = 128;  // k rows per stage: a page is a multiple

// grid (ceil(P / 128), n_heads), 384 threads. tma_q maps q as [P, n_heads,
// HD] in boxes of one head's 128 rows; tma_k and tma_v map the layer's
// pool as [n_kv_heads x num_pages, page, HD] in 128-row boxes. The ring
// and the arithmetic warpgroups' loop are flash_fwd.cuh's (KvRing,
// load_kv, attend_kv); this kernel chooses the tiles, their loads and the
// mask.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
chunk_attention_kernel(const __grid_constant__ CUtensorMap tma_q,
                       const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v, const int* __restrict__ table,
                       bf16* __restrict__ out, int p, int n_heads, int group, int num_pages,
                       int page, int start, float scale_log2) {
  using LQ = Tile<HD, kBM>;
  extern __shared__ uint8_t smem_raw[];
  const auto ring = kv_ring_init<HD, kBN>(smem_raw);

  const int h = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // the q tile's first chunk row
  // k tiles through the q tile's diagonal: its rows start + r0.. see every
  // key below start + r0 + 128, and start + r0 is a multiple of kBN
  const int n_k = (start + r0) / kBN + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(ring.full_q, LQ::kBytes);
#pragma unroll
      for (int b = 0; b < LQ::kBoxes; ++b)
        tma_load_3d(ring.sq + b * LQ::kBoxBytes, &tma_q, ring.full_q, b * LQ::kBoxCols, h, r0);
      const int slab0 = (h / group) * num_pages;  // kv head h / group's first page
      // Tile j's page of the pool and its row there: one table read a tile.
      load_kv(ring, &tma_k, &tma_v, n_k,
              [&](const CUtensorMap* map, uint8_t* dst, uint64_t* bar, int j) {
                const int key = j * kBN;
                load_tile<HD, kBN>(dst, map, bar, key % page, slab0 + __ldg(table + key / page));
              });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMathRegs));
    const int wg = (warp >> 2) - 1;  // 64-row half of the q tile
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's first row
    const int tq = lane & 3;
    float o[HD / 2];  // O: m64n{HD} accumulator
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // Only the last tile, the diagonal one, holds keys past a row: its
    // first key is the q tile's first row, so column c is masked in row
    // `row` where c > row.
    attend_kv(ring, n_k, wg, o, [&](int j, float (&s)[kBN / 2], float (&alpha)[2]) {
      if (j == n_k - 1)
        softmax_step<true, true, kBN>(s, m, l, alpha, scale_log2, row, tq, kBN);
      else
        softmax_step<true, false, kBN>(s, m, l, alpha, scale_log2, row, tq, kBN);
    });

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + row + 8 * i;
      if (r >= p) continue;
      const float l_safe = l[i] == 0.f ? 1.f : l[i];
      const float inv = 1.f / l_safe;
      bf16* dst = out + (static_cast<size_t>(r) * n_heads + h) * HD + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
            pack_bf16(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
    }
  }
}

// q [P, n_heads, HD] bf16 as a 3-d map in boxes of (64 or 32 columns, one
// head, 128 rows): coordinates (column, head, row); rows past P load as
// zeros. In shared memory a box is 128 rows of the Tile's swizzled row.
template <int HD>
inline bool q_map(CUtensorMap* map, const void* q, int p, int n_heads) {
  using L = Tile<HD, kBM>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD), static_cast<cuuint64_t>(n_heads),
                              static_cast<cuuint64_t>(p)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(HD) * n_heads * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kBoxCols), 1,
                             static_cast<cuuint32_t>(kBM)};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(q), dims, strides,
                   box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, L::kSwizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* table, void* out,
                   int p, int n_heads, int n_kv_heads, int num_pages, int page, int start,
                   cudaStream_t stream) {
  constexpr int smem = KvRing<HD, kBN>::kBytes;
  if (encoder() == nullptr) return cudaErrorSharedObjectInitFailed;
  CUtensorMap maps[3];
  if (!q_map<HD>(&maps[0], q, p, n_heads) ||
      !tile_map<HD, kBN>(&maps[1], k, n_kv_heads * num_pages, page) ||
      !tile_map<HD, kBN>(&maps[2], v, n_kv_heads * num_pages, page))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(chunk_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p + kBM - 1) / kBM, n_heads);
  chunk_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], table, static_cast<bf16*>(out), p, n_heads,
      n_heads / n_kv_heads, num_pages, page, start, 1.4426950408889634f / sqrtf(HD));
  return cudaGetLastError();
}

}  // namespace chunk
}  // namespace tpumon

extern "C" {

// q/out [P, n_heads, head_dim] and the layer's pools k/v [n_kv_heads,
// num_pages, page, head_dim], bfloat16, contiguous, 16-byte aligned, on
// the current device; table [>= start / page + 1] int32 page ids on the
// device. head_dim 64 or 128; page a multiple of 128; start a multiple of
// page; 1 <= p <= page; n_heads a multiple of n_kv_heads. Launches on
// `stream` and returns cudaGetLastError() (0 on success); allocates
// nothing and reads nothing back.
int tpumon_prefill_attention(const void* q, const void* k, const void* v, const int* table,
                             void* out, int p, int n_heads, int n_kv_heads, int num_pages,
                             int page, int head_dim, int start, void* stream) {
  using namespace tpumon::chunk;
  if (p < 1 || p > page || page % kBN || start < 0 || start % page || n_kv_heads < 1 ||
      n_heads % n_kv_heads || num_pages < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return (int)launch<64>(q, k, v, table, out, p, n_heads, n_kv_heads, num_pages, page, start,
                             st);
    case 128:
      return (int)launch<128>(q, k, v, table, out, p, n_heads, n_kv_heads, num_pages, page,
                              start, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The kernel's configuration at head_dim (64 or 128) into out[4]: dynamic
// shared-memory bytes, K and V stages, q rows and k rows a tile.
int tpumon_prefill_attention_config(int head_dim, int* out) {
  using namespace tpumon::chunk;
  const int smem = head_dim == 64    ? KvRing<64, kBN>::kBytes
                   : head_dim == 128 ? KvRing<128, kBN>::kBytes
                                     : 0;
  if (smem == 0) return (int)cudaErrorInvalidValue;
  out[0] = smem;
  out[1] = kStages;
  out[2] = kBM;
  out[3] = kBN;
  return (int)cudaSuccess;
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
