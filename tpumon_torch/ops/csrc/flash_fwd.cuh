// The flash-attention forward kernels, causal or not, shared by the
// triangle forward (flash_attention_tri_fwd.cu, causal, with the per-row
// logsumexp) and the rectangular forward (flash_attention.cu, either
// mask, no logsumexp).
//
// One CTA owns one (bh, 64-row q tile) and loops itself over the k tiles
// it needs: every k tile without the causal mask, those at or below its
// diagonal with it, so a causal CTA touches no tile above the diagonal.
// The row is complete when the loop ends; no state crosses CTAs. The
// simple design, with synchronous loads and no double buffering, in two
// variants:
// - bf16: flash_fwd_tc_kernel, 64-row k tiles, the products on tensor
//   cores with mma.sync.m16n8k16 (flash_tri_mma.cuh). Q's fragments stay
//   in registers, P goes from the score accumulators to the P V operand
//   without touching shared memory.
// - f32: flash_fwd_kernel, 32-row k tiles, the products on CUDA cores in
//   f32 (tensor cores would round f32 inputs to TF32), bound by the f32
//   FMA rate (67 TFLOP/s) and the shared-memory reads feeding it.
// wgmma, TMA and double-buffered tiles are the later redesign.
//
// Numerics follow the reference: scores and softmax in f32; masked scores
// are -1e30; the unnormalised probabilities are rounded to V's type
// before P V (as `p.astype(v.dtype)`), their row sum is not; a row whose
// sum is 0 returns zeros. The first k tile holds key 0, which every row
// sees, so each row's running max is a real score from the first step on
// and rows past the caller's real length (padding) stay finite.
//
// Supported: float32 and bfloat16, head dim 32, 64 or 128, T a multiple
// of 64. lse may be null (no logsumexp written).
#pragma once

#include "flash_tri_common.cuh"
#include "flash_tri_mma.cuh"

namespace tpumon {
namespace flash {

// f32: CUDA cores. grid (T / 64, BH), 128 threads, 32-row k tiles; the
// thread layout of flash_tri_common.cuh.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int t, float scale) {
  constexpr int LD = HD + 1;
  constexpr int kOut = HD / kColGroups;
  extern __shared__ float smem[];
  float* sq = smem;               // [kOwn][LD]
  float* sk = sq + kOwn * LD;     // [kStream][LD]
  float* sv = sk + kStream * LD;  // [kStream][LD]
  float* sp = sv + kStream * LD;  // [kOwn][kLdP]: P

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kOwn;  // longest rows first
  const size_t base = (size_t)bh * t * HD;
  const int tx = lane_tx(), ty = lane_ty();

  stage<HD, kOwn>(sq, q + base + (size_t)q0 * HD);

  float m[kRows], l[kRows], o[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  zero(o);

  // k tiles at or below the diagonal, or all of them
  const int n_k = CAUSAL ? (q0 + kOwn) / kStream : t / kStream;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kStream;
    __syncthreads();  // the previous tile is consumed
    stage<HD, kStream>(sk, k + base + (size_t)k0 * HD);
    stage<HD, kStream>(sv, v + base + (size_t)k0 * HD);
    __syncthreads();

    float s[kRows][kCols];
    zero(s);
    mma<kRows, kCols, HD, LD, 1, LD, 1>(s, sq, sk);
    const bool diag = CAUSAL && k0 + kStream > q0;  // only these tiles hold keys past a row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + ty + kRowGroups * r;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float x = s[r][c] * scale;
        s[r][c] = (diag && k0 + tx + kColGroups * c > qpos) ? kNegInf : x;
      }
      const float alpha = online_softmax_update_row<kColGroups, kCols>(s[r], m[r], l[r]);
#pragma unroll
      for (int c = 0; c < kOut; ++c) o[r][c] *= alpha;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        sp[(ty + kRowGroups * r) * kLdP + tx + kColGroups * c] = s[r][c];
    }
    __syncthreads();
    mma<kRows, kOut, kStream, kLdP, 1, 1, LD>(o, sp, sv);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < kOut; ++c) o[r][c] *= inv;
    if (lse != nullptr && tx == 0)
      lse[(size_t)bh * t + q0 + ty + kRowGroups * r] = m[r] + logf(l_safe);
  }
  store_rows<HD>(out + base, q0, o);
}

template <int HD, bool CAUSAL>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                           int bh, int t, float scale, cudaStream_t stream) {
  constexpr int LD = HD + 1;
  const int smem = ((kOwn + 2 * kStream) * LD + kOwn * kLdP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<HD, CAUSAL><<<dim3(t / kOwn, bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, t, scale);
  return cudaGetLastError();
}

// bf16: tensor cores. grid (T / 64, BH), 4 warps; warp w owns q rows
// 16 w.. of the CTA's 64 and keeps their Q fragments in registers. Per
// 64-row k tile: S = Q K^T (mma), the causal mask on the diagonal tile,
// online softmax over the quad holding each row, P repacked as bf16 A
// fragments, O += P V against V staged transposed.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(tc::kThreads)
flash_fwd_tc_kernel(const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
                    const tc::bf16* __restrict__ v, tc::bf16* __restrict__ out,
                    float* __restrict__ lse, int t, float scale) {
  using namespace tc;
  constexpr int kBlk = 64;  // q rows per CTA and k rows per step
  constexpr int LD = ld<HD>(), LDT = ld<kBlk>();
  constexpr int NS = kBlk / 8, NO = HD / 8;  // score and output n-tiles
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  bf16* sq = reinterpret_cast<bf16*>(smem_bf16);  // [kBlk][LD]
  bf16* sk = sq + kBlk * LD;                      // [kBlk][LD]
  bf16* svt = sk + kBlk * LD;                     // [HD][LDT]: V transposed

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlk;  // longest rows first
  const size_t base = (size_t)bh * t * HD;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int g = lane_g(), tq = lane_t();

  stage_rows<kBlk, HD, LD>(sq, q + base + (size_t)q0 * HD);
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) load_a<LD>(qa[kc], sq, r0, kc * 16);

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO][4];
  zero_frags(o);
  const int k_end = CAUSAL ? q0 + kBlk : t;  // past the diagonal tile, or all
  for (int k0 = 0; k0 < k_end; k0 += kBlk) {
    __syncthreads();  // the previous tile is consumed
    stage_rows<kBlk, HD, LD>(sk, k + base + (size_t)k0 * HD);
    stage_cols<kBlk, HD, LDT>(svt, v + base + (size_t)k0 * HD);
    __syncthreads();

    float s[NS][4];
    zero_frags(s);
    mma_regs<NS, HD / 16, LD>(s, qa, sk);
    const bool diag = CAUSAL && k0 == q0;  // tiles are square: only this one masks
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8
      const int row = r0 + g + 8 * h;
      float p[2 * NS];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[n][2 * h + e] * scale;
          p[2 * n + e] = (diag && n * 8 + 2 * tq + e > row) ? kNegInf : x;
        }
      const float alpha = online_softmax_update_row<4, 2 * NS>(p, m[h], l[h]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * h] *= alpha;
        o[n][2 * h + 1] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * h] = p[2 * n];
        s[n][2 * h + 1] = p[2 * n + 1];
      }
    }
    uint32_t pa[NS / 2][4];
    to_a(pa, s);  // P rounded to bf16, as the reference's p.astype(v.dtype)
    mma_regs<NO, NS / 2, LDT>(o, pa, svt);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    inv[h] = 1.f / l_safe;
    if (lse != nullptr && tq == 0) lse[(size_t)bh * t + q0 + r0 + g + 8 * h] = m[h] + logf(l_safe);
  }
  store(out + base + (size_t)q0 * HD, r0, o, inv[0], inv[1]);
}

template <int HD, bool CAUSAL>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, void* out, float* lse,
                          int bh, int t, float scale, cudaStream_t stream) {
  constexpr int smem = (2 * 64 * tc::ld<HD>() + HD * tc::ld<64>()) * (int)sizeof(tc::bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_tc_kernel<HD, CAUSAL><<<dim3(t / 64, bh), tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(out), lse, t, scale);
  return cudaGetLastError();
}

// dtype: 0 = float32 on CUDA cores (tensor cores would round f32 inputs
// to TF32), 1 = bfloat16 on tensor cores; head_dim 32, 64 or 128; t a
// positive multiple of 64. Returns cudaGetLastError() of the launch.
template <bool CAUSAL>
cudaError_t launch_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                       void* out, float* lse, int bh, int t, float scale, cudaStream_t stream) {
  if (bh < 1 || t < kOwn || t % kOwn != 0) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 32:
      return dtype == 0 ? launch_fwd_f32<32, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream)
                        : launch_fwd_tc<32, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream);
    case 64:
      return dtype == 0 ? launch_fwd_f32<64, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream)
                        : launch_fwd_tc<64, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream);
    case 128:
      return dtype == 0 ? launch_fwd_f32<128, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream)
                        : launch_fwd_tc<128, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace tpumon
