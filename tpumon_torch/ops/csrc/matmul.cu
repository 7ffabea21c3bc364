// Matrix products for Hopper (sm_90a): C = A @ B and the int8 weight-only
// C = A @ (Q * scale).
//
// Replaces two Pallas TPU kernels:
// - tpumon/ops/matmul.py::matmul (body _matmul_kernel): C[M,N] = A[M,K] @
//   B[K,N], f32 accumulation over the K steps, C in A's type;
// - tpumon/ops/quant_matmul.py::quantized_matmul_pallas (body
//   _q_matmul_kernel): B is int8 Q[K,N], widened to A's type on chip, and
//   the per-column scale[N] is applied once, to the f32 accumulator at
//   store, so Q crosses device memory at 1 byte per weight.
// The TPU kernels walk a sequential (M/bm, N/bn, K/bk) grid and carry the
// accumulator in VMEM scratch across the K steps. Here a CTA owns whole
// output tiles and loops over K itself, so the accumulator lives in
// registers and nothing crosses CTAs.
//
// Bound: operations. At the burn's 4096^3 the product is 137.4 GFLOP
// (139 us at 989 TFLOP/s bf16) against 100.7 MB of bf16 inputs and output
// (30 us at 3.35 TB/s), or 83.9 MB with int8 weights (25 us).
//
// What the design does about it (bf16 A): only wgmma reaches the tensor
// cores' full rate, and only if its operands arrive while it runs.
// - Persistent grid: one CTA per SM walks the 128 x 256 output tiles in a
//   grouped order (16 M tiles per N column), so the A and B panels in
//   flight stay in the 50 MB L2.
// - A ring of 4 64-deep K stages in shared memory (48 KB each for bf16 B),
//   filled by TMA under 128-byte swizzle, with a full and an empty
//   mbarrier per stage. Warp 0 of warpgroup 0 issues the loads (one thread)
//   and runs ahead of the arithmetic by up to the ring's depth, across
//   tiles, so the next tile's loads overlap this tile's epilogue.
// - Warpgroups 1 and 2 each own 64 rows of the tile: per stage four
//   wgmma.m64n256k16 (bf16 x bf16 -> f32, 128 accumulators a thread), A
//   K-major and B read MN-major from its row-major [K, N] tile through the
//   descriptor and the B-transpose immediate, so B is never transposed.
//   A stage is released once wgmma.wait_group has passed it; one group
//   stays in flight.
// - setmaxnreg moves registers from the loading warpgroup to the two
//   that hold accumulators.
// - The epilogue scales (int8) and rounds to bf16 in registers and stores
//   straight to C, clipped to N.
// Int8 B: TMA brings Q's stages at 1 byte per weight (4 stages of A and Q,
// 32 KB each, swizzled). The two arithmetic warpgroups widen the next
// stage's Q to bf16 (exact for every int8), half each, into one of three
// swizzled bf16 stages, while the tensor cores run this stage's wgmma;
// a fence.proxy.async and a 256-thread barrier hand it to the next step's
// wgmma, and one wgmma group stays in flight as for bf16 B. Widening in
// the arithmetic warps uses their idle issue slots; three warps of
// warpgroup 0 widening alone were slower (PERF.md, PR 4).
// Ragged edges: TMA zero-fills loads past M, N or K (a zero-filled K tail
// adds exact zeros) and the epilogue clips columns past N. C has whole
// 128-row tiles: the wrapper allocates M rounded up to 128 and returns the
// first M rows (a guard on each row's store slowed the int8 kernel's main
// loop by about 5% at 4096^3, PERF.md). TMA needs row strides that are
// multiples of 16 bytes: K and N multiples of 8 for bf16, N of 16 for int8
// Q (the Python wrapper zero-pads a shape that is not, and slices C back).
//
// f32 A runs on CUDA cores in f32 (tensor cores would round f32 inputs to
// TF32): 256 threads, each an 8 x 8 register tile of a 128 x 128 output
// tile, 8-deep K steps with synchronous loads; loads past M, N or K read
// zeros and stores past them are dropped, at any shape.
//
// Supported: A float32 or bfloat16; B of A's type, or int8 with a float32
// scale; any M, N, K >= 1 (bf16: K % 8 == 0, and N % 8 == 0, or N % 16 == 0
// with int8 Q). The Python wrappers (tpumon_torch/ops/matmul.py,
// quant_matmul.py) check shapes and types; the launchers re-check what
// they index by.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, the tensor-map encoder

namespace {

using namespace tpumon::hopper;
using bf16 = __nv_bfloat16;

constexpr int kTile = 128;  // the f32 kernel's output tile

// --- bf16 A on tensor cores: wgmma over a TMA-fed ring --------------------

constexpr int kBM = 128, kBN = 256, kBK = 64;  // CTA tile and K stage
constexpr int kGroupM = 16;                    // M tiles per N column
constexpr int kThreads = 384;                  // 3 warpgroups
constexpr int kABytes = kBM * kBK * 2;         // 16 KB, [128 m][64 k] swizzled
constexpr int kBBytes = kBK * kBN * 2;         // 32 KB, 4 x [64 k][64 n] swizzled
constexpr int kQBytes = kBK * kBN;             // 16 KB, 2 x [64 k][128 n] int8, swizzled
constexpr int kChunk = 64 * 128;               // bytes of one 64-row, 128-byte box

template <bool INT8>
struct Ring {
  // TMA stages: A with B, or A with Q.
  static constexpr int kStages = 4;
  static constexpr int kStageBytes = kABytes + (INT8 ? kQBytes : kBBytes);
  // INT8: bf16 stages written from Q's by the arithmetic warpgroups: one
  // read by the products in flight, one by those before them (one wgmma
  // group stays in flight), one being written.
  static constexpr int kWide = INT8 ? 3 : 0;
  static constexpr int kBarBytes = 2 * kStages * 8;
  // + 1024: the ring starts at the first 1024-byte boundary (128-byte
  // swizzle repeats every 1024 bytes and wgmma assumes that alignment).
  static constexpr int kSmem = kStages * kStageBytes + kWide * kBBytes + kBarBytes + 1024;
};

// Registers per thread after setmaxnreg: warpgroup 0 (loads), warpgroups
// 1-2 (accumulators). 128 + 2 x 128 threads fit 65,536: 40 + 2 x 232 <=
// 3 x 168, the count every thread starts with.
constexpr int kLoadRegs = 40, kMathRegs = 232;

// A: [128 m][64 k] K-major, 128-byte rows; 8-row groups 1024 bytes apart
// (the leading offset is unused when K fits one swizzle row).
__device__ __forceinline__ uint64_t desc_a(const bf16* p) { return smem_desc(p, 16, 1024); }

// B: MN-major, four [64 k][64 n] boxes of 128-byte rows: 64-column chunks
// kChunk bytes apart (leading), 8-row K groups 1024 bytes apart (stride).
__device__ __forceinline__ uint64_t desc_b(const bf16* p) { return smem_desc(p, kChunk, 1024); }

// Four int8 in a word to two bf16 pairs, exactly: each byte, made unsigned
// by its sign bit, goes into the mantissa of 2^23, and 2^23 + 128 comes off.
// The f32 result has at most 8 significant bits, so its low 16 bits are 0
// and its high half is the bf16: one byte permute packs two.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
                           8388736.f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632), __byte_perm(f[2], f[3], 0x7632));
}

// The arithmetic warpgroups' bar.sync (id 1; 0 is __syncthreads).
__device__ __forceinline__ void sync_math() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Warpgroup `half` widens its 128 columns of an int8 Q stage ([64 k][128 n]
// boxes) into a bf16 stage (four [64 k][64 n] boxes): 16 weights a
// segment, 4 segments a thread (t < 128), a segment to two 16-byte groups.
// Both stages are 128-byte swizzled (16-byte group ^ row % 8) and
// neighbouring threads take neighbouring rows, so each 8-thread phase of
// a 16-byte access touches 8 distinct banks. Ends with the fence that
// makes these generic-proxy writes visible to wgmma (async proxy).
__device__ __forceinline__ void widen_half(const uint8_t* q, uint8_t* b, int half, int t) {
  uint4 raw[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = t + 128 * u, row = i & 63, seg = i >> 6;  // seg < 8: 16-byte group
    raw[u] = *reinterpret_cast<const uint4*>(q + half * kChunk + row * 128 +
                                             ((seg ^ (row & 7)) << 4));
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = t + 128 * u, row = i & 63, seg = i >> 6;
    const int g = (seg & 3) * 2;  // first 16-byte group in the bf16 box
    uint8_t* dst = b + (2 * half + (seg >> 2)) * kChunk + row * 128;
    const uint2 w0 = widen4(raw[u].x), w1 = widen4(raw[u].y);
    const uint2 w2 = widen4(raw[u].z), w3 = widen4(raw[u].w);
    *reinterpret_cast<uint4*>(dst + ((g ^ (row & 7)) << 4)) = make_uint4(w0.x, w0.y, w1.x, w1.y);
    *reinterpret_cast<uint4*>(dst + (((g + 1) ^ (row & 7)) << 4)) =
        make_uint4(w2.x, w2.y, w3.x, w3.y);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Tile t of the grouped order: kGroupM M tiles down each N column.
__device__ __forceinline__ void tile_coords(int t, int mtiles, int ntiles, int& mt, int& nt) {
  const int per_group = kGroupM * ntiles;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(mtiles - first, kGroupM);
  const int r = t % per_group;
  mt = first + r % rows;
  nt = r / rows;
}

// Persistent: gridDim.x CTAs stride over the ceil(M/128) x ceil(N/256) tiles.
// Warpgroup 0: one thread issues the loads; warpgroups 1-2: the products
// (and, INT8, the widening) and the epilogue. tma_b maps B (bf16 [K, N],
// 64 x 64 boxes) or Q (int8 [K, N], 128 x 64 boxes), both swizzled. The
// stage index walks the ring with a phase bit that flips at every wrap.
template <bool INT8>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b, const float* __restrict__ scale,
                  bf16* __restrict__ c, int m, int n, int k) {
  using R = Ring<INT8>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* wide = ring + R::kStages * R::kStageBytes;  // INT8: widened bf16 stages
  uint64_t* full = reinterpret_cast<uint64_t*>(wide + R::kWide * kBBytes);
  uint64_t* empty = full + R::kStages;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each arithmetic warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int mtiles = (m + kBM - 1) / kBM, ntiles = (n + kBN - 1) / kBN;
  const int tiles = mtiles * ntiles, nk = (k + kBK - 1) / kBK;
  auto stage_a = [&](int s) { return reinterpret_cast<bf16*>(ring + s * R::kStageBytes); };
  // The second operand of TMA stage s: bf16 B, or int8 Q.
  auto stage_b = [&](int s) { return ring + s * R::kStageBytes + kABytes; };

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs));
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt;
        tile_coords(t, mtiles, ntiles, mt, nt);
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], R::kStageBytes);
          tma_load(stage_a(s), &tma_a, &full[s], kb * kBK, mt * kBM);
          constexpr int kBox = INT8 ? 128 : 64;  // columns per TMA box
          for (int j = 0; j < kBN / kBox; ++j)
            tma_load(stage_b(s) + j * kChunk, &tma_b, &full[s], nt * kBN + j * kBox, kb * kBK);
          if (++s == R::kStages) s = 0, phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMathRegs));
    const int wg = (warp >> 2) - 1;  // 64-row half of the tile
    const int t128 = threadIdx.x & 127;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mt, nt;
      tile_coords(t, mtiles, ntiles, mt, nt);
      if constexpr (INT8) {  // the tile's first bf16 stage
        sync_math();  // both warpgroups are past the last tile's products
        mbar_wait(&full[s], phase);
        widen_half(stage_b(s), wide, wg, t128);
        sync_math();
      }
      for (int kb = 0; kb < nk; ++kb) {
        if constexpr (!INT8) mbar_wait(&full[s], phase);
        const bf16* a = stage_a(s) + wg * 64 * kBK;
        const bf16* b = reinterpret_cast<const bf16*>(INT8 ? wide + (kb % 3) * kBBytes
                                                           : stage_b(s));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n256k16(acc, desc_a(a + kk * 16), desc_b(b + kk * 16 * 64),
                           (kb | kk) != 0);
        wgmma_commit();
        const int here = s;
        if (++s == R::kStages) s = 0, phase ^= 1;
        if constexpr (INT8) {
          // Widen the next stage while the tensor cores run this one.
          if (kb + 1 < nk) {
            mbar_wait(&full[s], phase);
            widen_half(stage_b(s), wide + ((kb + 1) % 3) * kBBytes, wg, t128);
          }
        }
        wgmma_wait<1>();  // the previous stage's products are done
        if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = here;
        // INT8: both warpgroups' halves of the next bf16 stage are written,
        // and their previous products are done, so that stage is free.
        if constexpr (INT8) sync_math();
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);

      // Accumulator d[4j + 2i + e] is row 16 (warp % 4) + lane / 4 + 8 i,
      // column 8 j + 2 (lane % 4) + e of this warpgroup's 64 x 256. N is
      // even (a multiple of 8), so a pair is in or out of C as a whole; C
      // has whole 128-row tiles (the rows past M are the caller's slack).
      const int row = mt * kBM + wg * 64 + (warp & 3) * 16 + (lane >> 2);
      bf16* out = c + static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = nt * kBN + 8 * j + 2 * (lane & 3);
        if (col < n) {
          float s0 = 1.f, s1 = 1.f;
          if constexpr (INT8) {
            const float2 sc = *reinterpret_cast<const float2*>(scale + col);
            s0 = sc.x, s1 = sc.y;
          }
          *reinterpret_cast<uint32_t*>(out + col) =
              pack_bf16(acc[4 * j] * s0, acc[4 * j + 1] * s1);
          *reinterpret_cast<uint32_t*>(out + 8 * static_cast<size_t>(n) + col) =
              pack_bf16(acc[4 * j + 2] * s0, acc[4 * j + 3] * s1);
        }
      }
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

// Columns col .. col + 3 of row `row` of a row-major [rows, cols] matrix,
// zeros outside it: one 16-byte (int8: 4-byte) load where all four lie
// inside and cols keeps rows aligned (cols % 4 == 0), else one at a time.
template <typename T>
__device__ __forceinline__ float4 load4_edge(const T* p, int row, int rows, int col, int cols) {
  if (row >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const T* r = p + (size_t)row * cols;
  if (col + 3 < cols && cols % 4 == 0) return load4(r + col);
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = col + e < cols ? static_cast<float>(r[col + e]) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// grid (ceil(N / 128), ceil(M / 128)), 256 threads. Thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty + 16 i and columns tx + 16 j, i, j < 8.
// A is staged transposed ([k][m]) so both operands are read along a row.
template <typename BT, bool SCALE>
__global__ void __launch_bounds__(kF32Threads)
gemm_f32_kernel(const float* __restrict__ a, const BT* __restrict__ b,
                const float* __restrict__ scale, float* __restrict__ c, int m, int n, int k) {
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
    const float4 av = load4_edge(a, m0 + ar, m, k0 + ac, k);
    const float4 bv = load4_edge(b, k0 + br, k, n0 + bc, n);
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
    if (col >= n) continue;
    const float s = SCALE ? scale[col] : 1.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (m0 + ty + 16 * i < m) c[(size_t)(m0 + ty + 16 * i) * n + col] = acc[i][j] * s;
  }
}

bool shapes_ok(int m, int n, int k) { return m > 0 && n > 0 && k > 0; }

// bf16 A: TMA's 16-byte row strides (A [m, k] and B [k, n] bf16, or Q
// [k, n] int8).
bool tma_ok(int n, int k, bool int8) { return k % 8 == 0 && n % (int8 ? 16 : 8) == 0; }

dim3 grid_of(int m, int n) { return dim3((n + kTile - 1) / kTile, (m + kTile - 1) / kTile); }

template <typename BT, bool SCALE>
cudaError_t launch_f32(const void* a, const void* b, const float* scale, void* c, int m, int n,
                       int k, cudaStream_t stream) {
  gemm_f32_kernel<BT, SCALE><<<grid_of(m, n), kF32Threads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const BT*>(b), scale, static_cast<float*>(c), m,
      n, k);
  return cudaGetLastError();
}

template <bool INT8>
cudaError_t launch_wgmma(const void* a, const void* b, const float* scale, void* c, int m, int n,
                         int k, cudaStream_t stream) {
  if (encoder() == nullptr) return cudaErrorSharedObjectInitFailed;
  CUtensorMap ta, tb;
  const bool ok =
      tensor_map(&ta, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, m, kBK, kBM,
                 CU_TENSOR_MAP_SWIZZLE_128B) &&
      (INT8 ? tensor_map(&tb, b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, k, 128, kBK,
                         CU_TENSOR_MAP_SWIZZLE_128B)
            : tensor_map(&tb, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, k, 64, kBK,
                         CU_TENSOR_MAP_SWIZZLE_128B));
  if (!ok) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gemm_wgmma_kernel<INT8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<INT8>::kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  gemm_wgmma_kernel<INT8><<<tiles < sms ? tiles : sms, kThreads, Ring<INT8>::kSmem, stream>>>(
      ta, tb, scale, static_cast<bf16*>(c), m, n, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, the type of a, b and c. a [m, k], b
// [k, n], c [m, n] (bf16: [m rounded up to 128, n], whose rows past m the
// kernel overwrites), all row-major, contiguous, 16-byte aligned, on the
// current device; m, n, k >= 1 (bf16: k and n multiples of 8). Launches on
// `stream` and returns cudaGetLastError() (0 on success); allocates
// nothing.
int tpumon_matmul(const void* a, const void* b, void* c, int m, int n, int k, int dtype,
                  void* stream) {
  if (!shapes_ok(m, n, k) || (dtype != 0 && dtype != 1) || (dtype == 1 && !tma_ok(n, k, false)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? (int)launch_f32<float, false>(a, b, nullptr, c, m, n, k, s)
                    : (int)launch_wgmma<false>(a, b, nullptr, c, m, n, k, s);
}

// The same with b an int8 q [k, n] and a float32 scale [n], applied once
// to each column's f32 accumulator before c is written in a's type (bf16:
// k a multiple of 8, n of 16).
int tpumon_quantized_matmul(const void* a, const void* q, const void* scale, void* c, int m,
                            int n, int k, int dtype, void* stream) {
  if (!shapes_ok(m, n, k) || (dtype != 0 && dtype != 1) || (dtype == 1 && !tma_ok(n, k, true)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  return dtype == 0 ? (int)launch_f32<int8_t, true>(a, q, sc, c, m, n, k, s)
                    : (int)launch_wgmma<true>(a, q, sc, c, m, n, k, s);
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
