// Paged-attention decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpumon/ops/paged_attention.py::
// paged_attention (body _paged_kernel): one query token per sequence
// attends over its K/V rows, which live in fixed-size pages of a shared
// head-major pool [n_kv_heads, num_pages, page_size, head_dim] and are
// found through the sequence's page table. GQA is handled in the
// kernel (each kv head serves a group of query heads), the softmax is
// taken online over pages in table order, rows at or past the length
// are masked, and a length-0 sequence returns zeros.
//
// Bound: bytes. Each layer call must read every live K and V row once
// (2 * sum(lengths) * n_kv_heads * head_dim * elem bytes, ~268 MB at the
// production decode shape) and does ~2 FLOPs per byte, far below the
// ~295 FLOP/byte where Hopper's tensor cores would become the limit.
//
// What this design does about it: it reads each live row exactly once,
// with 16-byte loads of contiguous page rows, and never touches a page at
// or past the sequence's length (the TPU kernel still DMAs those pages and
// only skips their compute). Scores, softmax and the accumulator stay in
// f32 in shared memory and registers; nothing intermediate goes to device
// memory. It is the simple design: one CTA per (sequence, kv head) walks
// the sequence's pages in order, staging 32 rows of K and V at a time in
// shared memory, with synchronous loads. That gives B * n_kv_heads CTAs
// (128 at the production shape, under one per SM), so the card is
// latency-bound well short of its memory rate. Splitting the page axis
// across CTAs with a merge pass, cp.async/TMA double buffering and tensor
// cores are the later redesign (ROADMAP queue 2).
//
// Supported: float32 and bfloat16, head_dim 32, 64 or 128, GQA group 1-8,
// any page size. The Python wrapper (tpumon_torch/ops/paged_attention.py)
// checks shapes and types; the launcher below re-checks what it indexes by.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace {

using tpumon::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;     // K/V rows staged per step: one per lane
constexpr int kMaxGroup = 8;  // query heads per kv head

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage `rows` contiguous rows of HD elements from device memory into an
// f32 shared tile of kTile rows with row stride LD; rows >= `rows` are
// zero-filled (a masked row's p is 0, and 0 * garbage could be NaN).
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src, int rows) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecPerRow = HD / kVec;
  for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    float* d = dst + r * LD + c;
    if (r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * HD + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = to_float(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = 0.f;
    }
  }
}

// grid (n_kv_heads, batch), kThreads threads. Warp w owns query rows
// g = w and w + kWarps of the group for the score/softmax phase (lane =
// key row of the staged tile); thread t owns output column t % HD of
// rows g = t / HD + j * (kThreads / HD) for the accumulate phase.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ table,
                       const int* __restrict__ lengths, T* __restrict__ out, int num_heads,
                       int num_kv_heads, int num_pages, int page_size, int max_pages,
                       float scale) {
  constexpr int kLdK = HD + 1;  // pad: the 32 lanes read 32 rows at one column
  constexpr int kThreadsPerCol = kThreads / HD;
  constexpr int kAccPerThread = (kMaxGroup + kThreadsPerCol - 1) / kThreadsPerCol;
  constexpr int kRowsPerWarp = kMaxGroup / kWarps;

  __shared__ float sq[kMaxGroup][HD];
  __shared__ float sk[kTile][kLdK];
  __shared__ float sv[kTile][HD];
  __shared__ float sp[kMaxGroup][kTile];
  __shared__ float s_alpha[kMaxGroup];
  __shared__ float s_l[kMaxGroup];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int group = num_heads / num_kv_heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = threadIdx.x % HD;
  const int g0 = threadIdx.x / HD;
  // The reference masks key positions >= length over max_pages*page_size
  // rows, so a length outside [0, that] behaves as its clamp.
  const int len = min(max(lengths[b], 0), max_pages * page_size);

  const T* qb = q + ((size_t)b * num_heads + (size_t)h * group) * HD;
  for (int i = threadIdx.x; i < group * HD; i += kThreads) sq[i / HD][i % HD] = to_float(qb[i]);

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m_run[j] = kNegInf;
    l_run[j] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) acc[j] = 0.f;

  const int n_pages = (len + page_size - 1) / page_size;
  for (int p = 0; p < n_pages; ++p) {
    // A table entry outside the pool is clamped, as the reference's
    // gather clamps it, instead of faulting the card.
    const int page = min(max(table[(size_t)b * max_pages + p], 0), num_pages - 1);
    const size_t page_off = ((size_t)h * num_pages + page) * page_size * HD;
    const int page_rows = min(page_size, len - p * page_size);  // >= 1
    for (int r0 = 0; r0 < page_rows; r0 += kTile) {
      const int rows = min(kTile, page_rows - r0);
      __syncthreads();  // the previous tile is consumed (first pass: sq is written)
      stage_tile<T, HD, kLdK>(&sk[0][0], k_pages + page_off + (size_t)r0 * HD, rows);
      stage_tile<T, HD, HD>(&sv[0][0], v_pages + page_off + (size_t)r0 * HD, rows);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int g = warp + j * kWarps;
        if (g < group) {  // warp-uniform
          float s = 0.f;
#pragma unroll 8
          for (int d = 0; d < HD; ++d) s += sq[g][d] * sk[lane][d];
          s = lane < rows ? s * scale : kNegInf;
          float alpha;
          sp[g][lane] = tpumon::online_softmax_update(s, m_run[j], l_run[j], alpha);
          if (lane == 0) s_alpha[g] = alpha;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kAccPerThread; ++j) {
        const int g = g0 + j * kThreadsPerCol;
        if (g < group) {
          float a = acc[j] * s_alpha[g];
#pragma unroll 8
          for (int r = 0; r < kTile; ++r) a += sp[g][r] * sv[r][col];
          acc[j] = a;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int g = warp + j * kWarps;
    if (g < group && lane == 0) s_l[g] = l_run[j];
  }
  __syncthreads();
  T* ob = out + ((size_t)b * num_heads + (size_t)h * group) * HD;
#pragma unroll
  for (int j = 0; j < kAccPerThread; ++j) {
    const int g = g0 + j * kThreadsPerCol;
    if (g < group) {
      const float l = s_l[g];
      ob[g * HD + col] = from_float<T>(l == 0.f ? 0.f : acc[j] / l);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, const int* table,
                   const int* lengths, void* out, int batch, int num_heads, int num_kv_heads,
                   int num_pages, int page_size, int max_pages, cudaStream_t stream) {
  const dim3 grid(num_kv_heads, batch);
  const float scale = 1.0f / sqrtf((float)HD);
  paged_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      table, lengths, static_cast<T*>(out), num_heads, num_kv_heads, num_pages, page_size,
      max_pages, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int head_dim, const void* q, const void* k_pages, const void* v_pages,
                      const int* table, const int* lengths, void* out, int batch, int num_heads,
                      int num_kv_heads, int num_pages, int page_size, int max_pages,
                      cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k_pages, v_pages, table, lengths, out, batch, num_heads,
                           num_kv_heads, num_pages, page_size, max_pages, stream);
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, table, lengths, out, batch, num_heads,
                           num_kv_heads, num_pages, page_size, max_pages, stream);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, table, lengths, out, batch, num_heads,
                            num_kv_heads, num_pages, page_size, max_pages, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/out [batch, num_heads, head_dim];
// k_pages/v_pages [num_kv_heads, num_pages, page_size, head_dim]; table
// [batch, max_pages] int32; lengths [batch] int32; all contiguous, 16-byte
// aligned, on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success); allocates nothing.
int tpumon_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                           const void* table, const void* lengths, void* out, int batch,
                           int num_heads, int num_kv_heads, int num_pages, int page_size,
                           int max_pages, int head_dim, int dtype, void* stream) {
  if (batch < 1 || num_kv_heads < 1 || num_heads % num_kv_heads != 0 ||
      num_heads / num_kv_heads > kMaxGroup || num_pages < 1 || page_size < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int* lens = static_cast<const int*>(lengths);
  switch (dtype) {
    case 0:
      return (int)launch_hd<float>(head_dim, q, k_pages, v_pages, tab, lens, out, batch,
                                   num_heads, num_kv_heads, num_pages, page_size, max_pages, s);
    case 1:
      return (int)launch_hd<__nv_bfloat16>(head_dim, q, k_pages, v_pages, tab, lens, out, batch,
                                           num_heads, num_kv_heads, num_pages, page_size,
                                           max_pages, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
