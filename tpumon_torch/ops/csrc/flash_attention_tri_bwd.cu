// Causal flash-attention backward for Hopper (sm_90a): a dQ kernel and a
// dK/dV kernel.
//
// Replaces the Pallas TPU kernels of tpumon/ops/flash_attention.py::
// flash_attention_tri_bwd: _flash_tri_bwd_dq_kernel (dQ = sum over k
// tiles of dS K) and _flash_tri_bwd_dkv_kernel (dV = sum over q tiles of
// P^T dO, dK = sum of dS^T Q), with P = exp(S * scale - lse) rebuilt from
// the forward's lse, dP = dO V^T and dS = P * (dP - D) * scale, where
// D = rowsum(dO * O) is computed once outside the kernels. The TPU
// kernels walk the lower-triangle pairs row-major (dQ) and column-major
// (dK/dV) through prefetched index arrays and carry each accumulator in
// VMEM scratch across the sequential grid. Here each output tile is owned
// by one CTA that loops over its own pairs: dQ by (bh, 64-row q tile)
// over the k tiles at or below the diagonal, dK/dV by (bh, 64-row k tile)
// over the q tiles at or above it. No atomics, so the result is
// deterministic.
//
// Bound: at the training shape (BH 128, T 1024, D 128, bf16) the causal
// pairs need 3 products in the dQ pass (S, dP, dQ: 51.6 GFLOP) and 4 in
// the dK/dV pass (S, dP, dV, dK: 68.8 GFLOP) against 169 MB and 202 MB of
// inputs and outputs, so the bf16 tensor-core rate bounds both (52 us and
// 70 us at 989 TFLOP/s). The two-pass design recomputes S and dP in both
// passes: 7 products where a fused backward needs 5.
//
// What this design does about it: each K/V (dQ) or Q/dO (dK/dV) tile is
// read once per owned tile, every intermediate stays on chip, and no pair
// above the diagonal is touched. As in the forward there are two
// variants, both with synchronous loads:
// - bf16 (the training path): the *_tc_kernels, products on tensor cores
//   with mma.sync.m16n8k16 (flash_tri_mma.cuh). dQ streams 64-row k
//   tiles; dK/dV streams 32-row q tiles, which keeps its two 16 x D f32
//   accumulators per warp in registers. P and dS go from the score
//   accumulators to the next product's operand in registers; the tiles a
//   product reads along its other axis (K for dQ, Q and dO for dK/dV) are
//   staged a second time, transposed.
// - f32: products on CUDA cores in f32 (tensor cores would round f32 to
//   TF32), 32-row streamed tiles, bound by the f32 FMA rate.
// wgmma, TMA, double buffering and a fused one-pass backward are the
// later redesign.
//
// Numerics follow the reference: P and dS in f32, rounded to the input
// type right before their products (`pmat.astype(do.dtype)`,
// `ds.astype(k.dtype)`), f32 accumulators, outputs in the input type.
//
// Supported: float32 and bfloat16, head dim 32, 64 or 128, T a multiple
// of 64. The Python wrapper (tpumon_torch/ops/flash_attention.py) checks
// shapes and types; the launchers re-check what they index by.

#include "flash_tri_common.cuh"
#include "flash_tri_mma.cuh"

namespace {

using namespace tpumon::flash;

// f32: CUDA cores. grid (T / 64, BH). Owned rows: 64 query rows;
// streamed: 32 key rows.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_tri_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dvec,
                        float* __restrict__ dq, int t, float scale) {
  constexpr int LD = HD + 1;
  constexpr int kOut = HD / kColGroups;
  extern __shared__ float smem[];
  float* sq = smem;                // [kOwn][LD]
  float* sdo = sq + kOwn * LD;     // [kOwn][LD]
  float* sk = sdo + kOwn * LD;     // [kStream][LD]
  float* sv = sk + kStream * LD;   // [kStream][LD]
  float* sds = sv + kStream * LD;  // [kOwn][kLdP]: dS

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kOwn;  // longest rows first
  const size_t base = (size_t)bh * t * HD;
  const int tx = lane_tx(), ty = lane_ty();

  stage<HD, kOwn>(sq, q + base + (size_t)q0 * HD);
  stage<HD, kOwn>(sdo, dout + base + (size_t)q0 * HD);
  float lse_r[kRows], d_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t row = (size_t)bh * t + q0 + ty + kRowGroups * r;
    lse_r[r] = lse[row];
    d_r[r] = dvec[row];
  }
  float acc[kRows][kOut];
  zero(acc);

  const int n_k = (q0 + kOwn) / kStream;  // k tiles at or below the diagonal
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kStream;
    __syncthreads();  // the previous tile is consumed
    stage<HD, kStream>(sk, k + base + (size_t)k0 * HD);
    stage<HD, kStream>(sv, v + base + (size_t)k0 * HD);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    zero(s);
    zero(dp);
    mma<kRows, kCols, HD, LD, 1, LD, 1>(s, sq, sk);
    mma<kRows, kCols, HD, LD, 1, LD, 1>(dp, sdo, sv);
    const bool diag = k0 + kStream > q0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + ty + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kcol = tx + kColGroups * c;
        const bool masked = diag && k0 + kcol > qpos;
        const float p = masked ? 0.f : expf(s[r][c] * scale - lse_r[r]);
        const float ds = p * (dp[r][c] - d_r[r]) * scale;
        sds[(ty + kRowGroups * r) * kLdP + kcol] = ds;
      }
    }
    __syncthreads();
    mma<kRows, kOut, kStream, kLdP, 1, 1, LD>(acc, sds, sk);
  }
  store_rows<HD>(dq + base, q0, acc);
}

// f32: CUDA cores. grid (T / 64, BH). Owned rows: 64 key rows; streamed:
// 32 query rows. Products are computed transposed (rows = keys), so P^T
// and dS^T come straight out of the register tiles.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_tri_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         float* __restrict__ dk, float* __restrict__ dv, int t, float scale) {
  constexpr int LD = HD + 1;
  constexpr int kOut = HD / kColGroups;
  extern __shared__ float smem[];
  float* sk = smem;                  // [kOwn][LD]
  float* sv = sk + kOwn * LD;        // [kOwn][LD]
  float* sq = sv + kOwn * LD;        // [kStream][LD]
  float* sdo = sq + kStream * LD;    // [kStream][LD]
  float* spt = sdo + kStream * LD;   // [kOwn][kLdP]: P^T, then dS^T

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kOwn;  // k tile 0 has the most q tiles: first
  const size_t base = (size_t)bh * t * HD;
  const int tx = lane_tx(), ty = lane_ty();

  stage<HD, kOwn>(sk, k + base + (size_t)k0 * HD);
  stage<HD, kOwn>(sv, v + base + (size_t)k0 * HD);
  float acc_dk[kRows][kOut], acc_dv[kRows][kOut];
  zero(acc_dk);
  zero(acc_dv);

  for (int q0 = k0; q0 < t; q0 += kStream) {  // q tiles at or above the diagonal
    float lse_c[kCols], d_c[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const size_t row = (size_t)bh * t + q0 + tx + kColGroups * c;
      lse_c[c] = lse[row];
      d_c[c] = dvec[row];
    }
    __syncthreads();  // the previous tile is consumed
    stage<HD, kStream>(sq, q + base + (size_t)q0 * HD);
    stage<HD, kStream>(sdo, dout + base + (size_t)q0 * HD);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    zero(s);
    zero(dp);
    mma<kRows, kCols, HD, LD, 1, LD, 1>(s, sk, sq);   // S^T [key, query]
    mma<kRows, kCols, HD, LD, 1, LD, 1>(dp, sv, sdo); // dP^T
    const bool diag = q0 < k0 + kOwn;  // only these tiles hold queries before a key
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int kpos = k0 + ty + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int qcol = tx + kColGroups * c;
        const bool masked = diag && q0 + qcol < kpos;
        const float p = masked ? 0.f : expf(s[r][c] * scale - lse_c[c]);
        s[r][c] = p * (dp[r][c] - d_c[c]) * scale;  // dS^T, kept for the dK product
        spt[(ty + kRowGroups * r) * kLdP + qcol] = p;
      }
    }
    __syncthreads();
    mma<kRows, kOut, kStream, kLdP, 1, 1, LD>(acc_dv, spt, sdo);  // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        spt[(ty + kRowGroups * r) * kLdP + tx + kColGroups * c] = s[r][c];
    __syncthreads();
    mma<kRows, kOut, kStream, kLdP, 1, 1, LD>(acc_dk, spt, sq);  // dK += dS^T Q
  }
  store_rows<HD>(dk + base, k0, acc_dk);
  store_rows<HD>(dv + base, k0, acc_dv);
}

template <int HD>
constexpr int bwd_smem_bytes() {
  return ((2 * kOwn + 2 * kStream) * (HD + 1) + kOwn * kLdP) * (int)sizeof(float);
}

template <int HD>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* dvec, void* dq, int bh, int t,
                          float scale, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_tri_bwd_dq_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_tri_bwd_dq_kernel<HD><<<dim3(t / kOwn, bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dvec, static_cast<float*>(dq), t, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dvec, void* dk, void* dv, int bh,
                           int t, float scale, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_tri_bwd_dkv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_tri_bwd_dkv_kernel<HD><<<dim3(t / kOwn, bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dvec, static_cast<float*>(dk), static_cast<float*>(dv),
      t, scale);
  return cudaGetLastError();
}

// bf16: tensor cores. grid (T / 64, BH), 4 warps; warp w owns q rows
// 16 w.. of the CTA's 64. Per 64-row k tile: S = Q K^T and dP = dO V^T
// (mma, Q and dO fragments read from shared memory), P and dS in f32, dS
// repacked as bf16 A fragments, dQ += dS K against K staged transposed.
template <int HD>
__global__ void __launch_bounds__(tc::kThreads)
flash_tri_bwd_dq_tc_kernel(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
                           const tc::bf16* __restrict__ v, const tc::bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ dvec,
                           tc::bf16* __restrict__ dq, int t, float scale) {
  using namespace tc;
  constexpr int kBlk = 64;
  constexpr int LD = ld<HD>(), LDT = ld<kBlk>();
  constexpr int NS = kBlk / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* sq = reinterpret_cast<bf16*>(smem_bf16);  // [kBlk][LD]
  bf16* sdo = sq + kBlk * LD;                     // [kBlk][LD]
  bf16* sk = sdo + kBlk * LD;                     // [kBlk][LD]
  bf16* sv = sk + kBlk * LD;                      // [kBlk][LD]
  bf16* skt = sv + kBlk * LD;                     // [HD][LDT]: K transposed

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlk;  // longest rows first
  const size_t base = (size_t)bh * t * HD;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = lane_g(), tq = lane_t();

  stage_rows<kBlk, HD, LD>(sq, q + base + (size_t)q0 * HD);
  stage_rows<kBlk, HD, LD>(sdo, dout + base + (size_t)q0 * HD);
  float lse_r[2], d_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)bh * t + q0 + r0 + g + 8 * h;
    lse_r[h] = lse[row];
    d_r[h] = dvec[row];
  }
  float acc[NO][4];
  zero_frags(acc);
  for (int k0 = 0; k0 <= q0; k0 += kBlk) {
    __syncthreads();  // the previous tile is consumed (first pass: sq, sdo staged)
    stage_rows<kBlk, HD, LD>(sk, k + base + (size_t)k0 * HD);
    stage_rows<kBlk, HD, LD>(sv, v + base + (size_t)k0 * HD);
    stage_cols<kBlk, HD, LDT>(skt, k + base + (size_t)k0 * HD);
    __syncthreads();

    float s[NS][4], dp[NS][4];
    zero_frags(s);
    zero_frags(dp);
    mma_smem<NS, HD / 16, LD, LD>(s, sq, r0, sk);
    mma_smem<NS, HD / 16, LD, LD>(dp, sdo, r0, sv);
    const bool diag = k0 == q0;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool masked = diag && n * 8 + 2 * tq + (e & 1) > r0 + g + 8 * h;
        const float p = masked ? 0.f : expf(s[n][e] * scale - lse_r[h]);
        s[n][e] = p * (dp[n][e] - d_r[h]) * scale;  // dS
      }
    uint32_t da[NS / 2][4];
    to_a(da, s);  // dS rounded to bf16, as the reference's ds.astype(k.dtype)
    mma_regs<NO, NS / 2, LDT>(acc, da, skt);
  }
  store(dq + base + (size_t)q0 * HD, r0, acc);
}

// bf16: tensor cores. grid (T / 64, BH), 4 warps; warp w owns key rows
// 16 w.. of the CTA's 64. Per 32-row q tile: S^T = K Q^T and dP^T =
// V dO^T (rows = keys), P^T and dS^T in f32, repacked as bf16 A fragments,
// dV += P^T dO and dK += dS^T Q against dO and Q staged transposed.
template <int HD>
__global__ void __launch_bounds__(tc::kThreads)
flash_tri_bwd_dkv_tc_kernel(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
                            const tc::bf16* __restrict__ v, const tc::bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ dvec,
                            tc::bf16* __restrict__ dk, tc::bf16* __restrict__ dv, int t,
                            float scale) {
  using namespace tc;
  constexpr int kOwnRows = 64, kQ = 32;
  constexpr int LD = ld<HD>(), LDT = ld<kQ>();
  constexpr int NS = kQ / 8, NO = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* sk = reinterpret_cast<bf16*>(smem_bf16);  // [kOwnRows][LD]
  bf16* sv = sk + kOwnRows * LD;                  // [kOwnRows][LD]
  bf16* sq = sv + kOwnRows * LD;                  // [kQ][LD]
  bf16* sdo = sq + kQ * LD;                       // [kQ][LD]
  bf16* sqt = sdo + kQ * LD;                      // [HD][LDT]: Q transposed
  bf16* sdot = sqt + HD * LDT;                    // [HD][LDT]: dO transposed
  float* sl = reinterpret_cast<float*>(sdot + HD * LDT);  // [kQ] lse
  float* sd = sl + kQ;                                    // [kQ] D

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kOwnRows;  // k tile 0 has the most q tiles: first
  const size_t base = (size_t)bh * t * HD;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = lane_g(), tq = lane_t();

  stage_rows<kOwnRows, HD, LD>(sk, k + base + (size_t)k0 * HD);
  stage_rows<kOwnRows, HD, LD>(sv, v + base + (size_t)k0 * HD);
  float acc_dk[NO][4], acc_dv[NO][4];
  zero_frags(acc_dk);
  zero_frags(acc_dv);
  for (int q0 = k0; q0 < t; q0 += kQ) {  // q tiles at or above the diagonal
    __syncthreads();  // the previous tile is consumed (first pass: sk, sv staged)
    stage_rows<kQ, HD, LD>(sq, q + base + (size_t)q0 * HD);
    stage_rows<kQ, HD, LD>(sdo, dout + base + (size_t)q0 * HD);
    stage_cols<kQ, HD, LDT>(sqt, q + base + (size_t)q0 * HD);
    stage_cols<kQ, HD, LDT>(sdot, dout + base + (size_t)q0 * HD);
    if (threadIdx.x < kQ) {
      sl[threadIdx.x] = lse[(size_t)bh * t + q0 + threadIdx.x];
      sd[threadIdx.x] = dvec[(size_t)bh * t + q0 + threadIdx.x];
    }
    __syncthreads();

    float s[NS][4], dp[NS][4];
    zero_frags(s);
    zero_frags(dp);
    mma_smem<NS, HD / 16, LD, LD>(s, sk, r0, sq);    // S^T [key, query]
    mma_smem<NS, HD / 16, LD, LD>(dp, sv, r0, sdo);  // dP^T
    const bool diag = q0 < k0 + kOwnRows;  // only these tiles hold queries before a key
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * tq + (e & 1);
        const bool masked = diag && q0 + col < k0 + r0 + g + 8 * (e >> 1);
        const float p = masked ? 0.f : expf(s[n][e] * scale - sl[col]);
        s[n][e] = p;                                   // P^T
        dp[n][e] = p * (dp[n][e] - sd[col]) * scale;  // dS^T
      }
    uint32_t pa[NS / 2][4], da[NS / 2][4];
    to_a(pa, s);   // P^T rounded to bf16 (pmat.astype(do.dtype))
    to_a(da, dp);  // dS^T rounded to bf16 (ds.astype(q.dtype))
    mma_regs<NO, NS / 2, LDT>(acc_dv, pa, sdot);
    mma_regs<NO, NS / 2, LDT>(acc_dk, da, sqt);
  }
  store(dk + base + (size_t)k0 * HD, r0, acc_dk);
  store(dv + base + (size_t)k0 * HD, r0, acc_dv);
}

template <int HD>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* dvec, void* dq, int bh, int t,
                         float scale, cudaStream_t stream) {
  constexpr int smem = (4 * 64 * tc::ld<HD>() + HD * tc::ld<64>()) * (int)sizeof(tc::bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_tri_bwd_dq_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_tri_bwd_dq_tc_kernel<HD><<<dim3(t / 64, bh), tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout), lse, dvec,
      static_cast<tc::bf16*>(dq), t, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* dvec, void* dk, void* dv, int bh, int t,
                          float scale, cudaStream_t stream) {
  constexpr int smem =
      (2 * 64 * tc::ld<HD>() + 2 * 32 * tc::ld<HD>() + 2 * HD * tc::ld<32>()) *
          (int)sizeof(tc::bf16) +
      2 * 32 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_tri_bwd_dkv_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_tri_bwd_dkv_tc_kernel<HD><<<dim3(t / 64, bh), tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<const tc::bf16*>(dout), lse, dvec,
      static_cast<tc::bf16*>(dk), static_cast<tc::bf16*>(dv), t, scale);
  return cudaGetLastError();
}

}  // namespace

// Return LAUNCH##_F32(HD) (f32, CUDA cores) or LAUNCH##_TC(HD) (bf16,
// tensor cores) for the (dtype, head_dim) of the enclosing launcher, or
// cudaErrorInvalidValue for any other pair.
#define TPUMON_DISPATCH(LAUNCH)                                     \
  switch (dtype * 1000 + head_dim) {                                \
    case 32:                                                        \
      return (int)LAUNCH##_F32(32);                                 \
    case 64:                                                        \
      return (int)LAUNCH##_F32(64);                                 \
    case 128:                                                       \
      return (int)LAUNCH##_F32(128);                                \
    case 1032:                                                      \
      return (int)LAUNCH##_TC(32);                                  \
    case 1064:                                                      \
      return (int)LAUNCH##_TC(64);                                  \
    case 1128:                                                      \
      return (int)LAUNCH##_TC(128);                                 \
    default:                                                        \
      return (int)cudaErrorInvalidValue;                            \
  }

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/k/v/dout and the outputs
// [bh, t, head_dim]; lse and dvec [bh, t] float32; all contiguous,
// 16-byte aligned, on the current device; t a positive multiple of 64.
// Each launches one kernel on `stream` and returns cudaGetLastError() (0
// on success); neither allocates.
int tpumon_flash_tri_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dvec, void* dq, int bh, int t,
                            int head_dim, int dtype, float scale, void* stream) {
  if (bh < 1 || t < kOwn || t % kOwn != 0) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dvec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPUMON_DQ_F32(HD) launch_dq_f32<HD>(q, k, v, dout, l, d, dq, bh, t, scale, s)
#define TPUMON_DQ_TC(HD) launch_dq_tc<HD>(q, k, v, dout, l, d, dq, bh, t, scale, s)
  TPUMON_DISPATCH(TPUMON_DQ);
#undef TPUMON_DQ_F32
#undef TPUMON_DQ_TC
}

int tpumon_flash_tri_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* dvec, void* dk, void* dv, int bh, int t,
                             int head_dim, int dtype, float scale, void* stream) {
  if (bh < 1 || t < kOwn || t % kOwn != 0) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dvec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPUMON_DKV_F32(HD) \
  launch_dkv_f32<HD>(q, k, v, dout, l, d, dk, dv, bh, t, scale, s)
#define TPUMON_DKV_TC(HD) launch_dkv_tc<HD>(q, k, v, dout, l, d, dk, dv, bh, t, scale, s)
  TPUMON_DISPATCH(TPUMON_DKV);
#undef TPUMON_DKV_F32
#undef TPUMON_DKV_TC
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
