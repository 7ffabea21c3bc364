// Tiled GEMM for Hopper (sm_90a): C = A @ B and the int8 weight-only
// C = A @ (Q * scale), one templated kernel per arithmetic.
//
// Replaces two Pallas TPU kernels:
// - tpumon/ops/matmul.py::matmul (body _matmul_kernel): C[M,N] = A[M,K] @
//   B[K,N], f32 accumulation over the K steps, C in A's type;
// - tpumon/ops/quant_matmul.py::quantized_matmul_pallas (body
//   _q_matmul_kernel): B is int8 Q[K,N], widened to A's type on chip, and
//   the per-column scale[N] is applied once, to the f32 accumulator at
//   store, so Q crosses device memory at 1 byte per weight.
// The TPU kernels walk a sequential (M/bm, N/bn, K/bk) grid and carry the
// accumulator in VMEM scratch across the K steps. Here one CTA owns one
// 128 x 128 output tile and loops over K itself, so the accumulator lives
// in registers and nothing crosses CTAs.
//
// Bound: operations. At the burn's 4096^3 the product is 137.4 GFLOP
// (139 us at 989 TFLOP/s bf16) against 100.7 MB of bf16 inputs and output
// (30 us at 3.35 TB/s), or 83.9 MB with int8 weights (25 us).
//
// What this design does about it: the simple design, right first. bf16 A
// runs on tensor cores, mma.sync.m16n8k16 with f32 accumulators
// (flash_tri_mma.cuh): 4 warps, each a 64 x 64 quarter of the tile; the A
// and B tiles of one 32-deep K step are staged in shared memory with
// 16-byte loads (an int8 B tile is widened to bf16 on the way, exact for
// every int8), A fragments are read as 32-bit words and B fragments with
// ldmatrix.trans from the row-major B tile. f32 A runs on CUDA cores in
// f32 (tensor cores would round f32 inputs to TF32): 256 threads, each an
// 8 x 8 register tile, 8-deep K steps. Loads are synchronous with two
// barriers per K step; wgmma, TMA and a pipelined ring of tiles are the
// later redesign.
//
// Supported: A float32 or bfloat16; B of A's type, or int8 with a float32
// scale; M and N multiples of 128, K a multiple of 32. The Python wrappers
// (tpumon_torch/ops/matmul.py, quant_matmul.py) check shapes and types;
// the launchers re-check what they index by.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tri_mma.cuh"

namespace {

using tpumon::flash::tc::bf16;

constexpr int kTile = 128;  // output rows and columns per CTA
constexpr int kDepth = 32;  // K multiple the launchers accept

// --- bf16 A on tensor cores ---------------------------------------------

namespace tc = tpumon::flash::tc;

constexpr int kTcK = 32;                // K per step
constexpr int kLdA = kTcK + 8;          // shared A row stride (bf16)
constexpr int kLdB = kTile + 8;         // shared B row stride (bf16)

// Two 8 x 8 b16 matrices from shared memory, transposed: lanes 0-7 give
// the row addresses of the first, lanes 8-15 those of the second.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// One K step's B tile, kTcK rows of kTile columns, into sB as bf16.
__device__ __forceinline__ void stage_b(bf16* sb, const bf16* __restrict__ b, int n) {
  constexpr int kChunks = kTile / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTcK * kChunks; i += tc::kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    *reinterpret_cast<uint4*>(sb + r * kLdB + c) =
        *reinterpret_cast<const uint4*>(b + (size_t)r * n + c);
  }
}

__device__ __forceinline__ void stage_b(bf16* sb, const int8_t* __restrict__ b, int n) {
  constexpr int kChunks = kTile / 16;  // 16 int8 per 16-byte load
  for (int i = threadIdx.x; i < kTcK * kChunks; i += tc::kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(b + (size_t)r * n + c);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = tc::pack((float)e[2 * j], (float)e[2 * j + 1]);
    uint4* d = reinterpret_cast<uint4*>(sb + r * kLdB + c);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// grid (N / 128, M / 128), 128 threads. Warp w owns rows 64 (w / 2) and
// columns 64 (w % 2) of the tile: 4 x 8 fragments of 16 x 8.
template <typename BT, bool SCALE>
__global__ void __launch_bounds__(tc::kThreads)
gemm_tc_kernel(const bf16* __restrict__ a, const BT* __restrict__ b,
               const float* __restrict__ scale, bf16* __restrict__ c, int n, int k) {
  __shared__ __align__(16) bf16 sa[kTile * kLdA];
  __shared__ __align__(16) bf16 sb[kTcK * kLdB];

  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) tc::zero_frags(acc[i]);

  for (int k0 = 0; k0 < k; k0 += kTcK) {
    __syncthreads();  // the previous step's tiles are consumed
    constexpr int kChunks = kTcK / 8;
    for (int i = threadIdx.x; i < kTile * kChunks; i += tc::kThreads) {
      const int r = i / kChunks, col = (i % kChunks) * 8;
      *reinterpret_cast<uint4*>(sa + r * kLdA + col) =
          *reinterpret_cast<const uint4*>(a + (size_t)(m0 + r) * k + k0 + col);
    }
    stage_b(sb, b + (size_t)k0 * n + n0, n);
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < kTcK / 16; ++kc) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) tc::load_a<kLdA>(af[i], sa, wm + 16 * i, 16 * kc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, sb + (16 * kc + (lane & 15)) * kLdB + wn + 8 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) tc::mma16816(acc[i][j], af[i], b0, b1);
      }
    }
  }

  const int g = tc::lane_g(), t = tc::lane_t();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + wn + 8 * j + 2 * t;
    const float s0 = SCALE ? scale[col] : 1.f, s1 = SCALE ? scale[col + 1] : 1.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bf16* row = c + (size_t)(m0 + wm + 16 * i + g) * n + col;
      *reinterpret_cast<uint32_t*>(row) = tc::pack(acc[i][j][0] * s0, acc[i][j][1] * s1);
      *reinterpret_cast<uint32_t*>(row + 8 * (size_t)n) =
          tc::pack(acc[i][j][2] * s0, acc[i][j][3] * s1);
    }
  }
}

// --- f32 A on CUDA cores --------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32K = 8;          // K per step
constexpr int kLdF = kTile + 4;   // shared row stride (floats)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  return make_float4(x.x, x.y, x.z, x.w);
}

// grid (N / 128, M / 128), 256 threads. Thread (ty, tx) = (tid / 16,
// tid % 16) owns rows ty + 16 i and columns tx + 16 j, i, j < 8. A is
// staged transposed ([k][m]) so both operands are read along a row.
template <typename BT, bool SCALE>
__global__ void __launch_bounds__(kF32Threads)
gemm_f32_kernel(const float* __restrict__ a, const BT* __restrict__ b,
                const float* __restrict__ scale, float* __restrict__ c, int n, int k) {
  __shared__ __align__(16) float sa[kF32K * kLdF];
  __shared__ __align__(16) float sb[kF32K * kLdF];

  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int ar = threadIdx.x >> 1, ac = (threadIdx.x & 1) * 4;   // A: 128 rows x 2 float4
  const int br = threadIdx.x >> 5, bc = (threadIdx.x & 31) * 4;  // B: 8 rows x 32 float4

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kF32K) {
    const float4 av = load4(a + (size_t)(m0 + ar) * k + k0 + ac);
    const float4 bv = load4(b + (size_t)(k0 + br) * n + n0 + bc);
    __syncthreads();  // the previous step's tiles are consumed
    sa[(ac + 0) * kLdF + ar] = av.x;
    sa[(ac + 1) * kLdF + ar] = av.y;
    sa[(ac + 2) * kLdF + ar] = av.z;
    sa[(ac + 3) * kLdF + ar] = av.w;
    *reinterpret_cast<float4*>(sb + br * kLdF + bc) = bv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      float x[8], y[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = sa[kk * kLdF + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = sb[kk * kLdF + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + tx + 16 * j;
    const float s = SCALE ? scale[col] : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) c[(size_t)(m0 + ty + 16 * i) * n + col] = acc[i][j] * s;
  }
}

bool shapes_ok(int m, int n, int k) {
  return m > 0 && n > 0 && k > 0 && m % kTile == 0 && n % kTile == 0 && k % kDepth == 0;
}

dim3 grid_of(int m, int n) { return dim3(n / kTile, m / kTile); }

template <typename BT, bool SCALE>
cudaError_t launch_f32(const void* a, const void* b, const float* scale, void* c, int m, int n,
                       int k, cudaStream_t stream) {
  gemm_f32_kernel<BT, SCALE><<<grid_of(m, n), kF32Threads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const BT*>(b), scale, static_cast<float*>(c), n,
      k);
  return cudaGetLastError();
}

template <typename BT, bool SCALE>
cudaError_t launch_tc(const void* a, const void* b, const float* scale, void* c, int m, int n,
                      int k, cudaStream_t stream) {
  gemm_tc_kernel<BT, SCALE><<<grid_of(m, n), tc::kThreads, 0, stream>>>(
      static_cast<const bf16*>(a), static_cast<const BT*>(b), scale, static_cast<bf16*>(c), n,
      k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the type of a, b and c. a [m, k], b
// [k, n], c [m, n], all row-major, contiguous, 16-byte aligned, on the
// current device; m and n multiples of 128, k of 32. Launches on `stream`
// and returns cudaGetLastError() (0 on success); allocates nothing.
int tpumon_matmul(const void* a, const void* b, void* c, int m, int n, int k, int dtype,
                  void* stream) {
  if (!shapes_ok(m, n, k) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? (int)launch_f32<float, false>(a, b, nullptr, c, m, n, k, s)
                    : (int)launch_tc<bf16, false>(a, b, nullptr, c, m, n, k, s);
}

// The same with b an int8 q [k, n] and a float32 scale [n], applied once
// to each column's f32 accumulator before c is written in a's type.
int tpumon_quantized_matmul(const void* a, const void* q, const void* scale, void* c, int m,
                            int n, int k, int dtype, void* stream) {
  if (!shapes_ok(m, n, k) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  return dtype == 0 ? (int)launch_f32<int8_t, true>(a, q, sc, c, m, n, k, s)
                    : (int)launch_tc<int8_t, true>(a, q, sc, c, m, n, k, s);
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
