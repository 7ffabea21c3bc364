// The flash-attention forward kernels, causal or not, shared by the
// triangle forward (flash_attention_tri_fwd.cu, causal, with the per-row
// logsumexp) and the rectangular forward (flash_attention.cu, either
// mask, no logsumexp). Two kernels:
// - bf16: flash_fwd_wgmma_kernel, wgmma over a TMA-fed K/V ring (below).
// - f32: flash_fwd_kernel, the products on CUDA cores in f32 (tensor
//   cores would round f32 inputs to TF32): one CTA per (bh, 64-row q
//   tile), 32-row k tiles with synchronous loads, bound by the f32 FMA
//   rate (67 TFLOP/s) and the shared-memory reads feeding it.
//
// The bf16 design. A CTA owns one (bh, 128-row q tile) and loops itself
// over the 128-row k tiles it needs: all of them without the causal mask,
// those at or below its diagonal with it, so a causal CTA touches no tile
// above the diagonal and each row is complete when the loop ends; no
// state crosses CTAs. The grid runs a bh's q tiles next to each other,
// longest rows first, so the CTAs in flight share few bhs' K and V in L2
// (at BH 128 / T 1024 the whole K and V, 67 MB, does not fit its 50 MB),
// and the short causal tiles come last.
// - Warpgroup 0: one thread issues the TMA loads, Q once, then K and V
//   tiles into rings of kStages stages, each stage with a full and an
//   empty mbarrier, in the order the arithmetic needs them (K_j, then
//   V_{j-1}), running ahead by up to the ring's depth. setmaxnreg gives
//   its registers to the two arithmetic warpgroups.
// - Warpgroups 1 and 2 own 64 q rows each (wgmma's m64). For k tile j
//   they issue S_j = Q K_j^T (HD / 16 wgmma.m64n128k16, Q and K both
//   K-major in shared memory), then O += P_{j-1} V_{j-1} (8 register-A
//   wgmma.m64n{HD}k16: P never touches shared memory; V is read MN-major
//   from its row-major tile through the descriptor and the B-transpose
//   immediate, so nothing transposes it). They wait for S_j with P V in
//   flight and run S_j's online softmax while the tensor cores finish
//   P V, then wait for it, release its V stage, rescale O and pack P_j.
//   The two warpgroups take turns issuing (ping-pong over two named
//   barriers), so one's softmax also runs under the other's products.
// - The softmax works on the f32 accumulator in wgmma's fragment layout:
//   a thread holds two rows (lane / 4 and + 8 of its warp's 16), 32
//   scores of each, and a row's max and sum reduce over its quad of
//   lanes. The scores of 16 columns, rounded to bf16 pairwise, are the
//   A fragment of those columns for P V, in place.
// - Tiles of 128 rows sit in shared memory as TMA writes them
//   (flash_wgmma.cuh, shared with the backward). The tensor maps are 3-d
//   [BH, T, D], so a tile that reaches past T (T = 64 x odd) loads zeros
//   there, not the next bh's rows; out and lse are stored for rows below T only,
//   and without the mask the keys at or past T are masked (with it, no
//   real row sees them).
//
// Numerics follow the reference: scores and softmax in f32; masked
// scores are -1e30; the unnormalised probabilities are rounded to V's
// type before P V (as `p.astype(v.dtype)`), their row sum is not; a row
// whose sum is 0 returns zeros; lse = m + log(l) in f32. The bf16 kernel
// takes each exponential in base 2, ex2.approx of s x scale x log2(e) - m
// x scale x log2(e) (one FFMA; relative error about 2^-22, results below
// 2^-126 flushed to 0), and masks only the last k tile, the one that can
// hold masked keys. The first k tile holds key 0, which every row sees,
// so each row's running max is a real score from the first step on and
// rows past the caller's real length (padding) stay finite.
//
// Supported: float32 and bfloat16, head dim 32, 64 or 128, T a multiple
// of 64. lse may be null (no logsumexp written).
#pragma once

#include "flash_tri_common.cuh"
#include "flash_wgmma.cuh"

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

// --- bf16: wgmma over a TMA-fed K/V ring ---------------------------------

namespace wg {

constexpr int kBM = 128;        // q rows per CTA, 64 per arithmetic warpgroup
constexpr int kBN = 128;        // k rows per stage
constexpr int kStages = 2;      // K stages, and as many V stages
constexpr int kThreads = 384;   // 3 warpgroups
// Registers per thread after setmaxnreg: warpgroup 0 (loads), warpgroups
// 1-2 (S, O and P). 40 + 2 x 232 <= 3 x 168, the count every thread
// starts with under __launch_bounds__(384, 1).
constexpr int kLoadRegs = 40, kMathRegs = 232;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
using L128 = Tile<HD, kBN>;  // Q, K and V tiles

// Q, kStages K tiles, kStages V tiles, then the mbarriers: Q's, and a
// full and an empty one per K and per V stage. + 1024: the tiles start at
// the first 1024-byte boundary.
template <int HD>
constexpr int fwd_smem() {
  return (1 + 2 * kStages) * L128<HD>::kBytes + (1 + 4 * kStages) * 8 + 1024;
}

// The online-softmax step on this thread's S fragment: s[4 j + 2 i + e]
// is the raw score Q K^T of row `row + 8 i` (of the CTA's 128), column
// 8 j + 2 tq + e of the k tile. MASK (the last tile only): -1e30 at
// columns past the row (causal: the diagonal tile), or at or past `keys`
// (else: the real keys of a last tile that reaches past T). Updates m
// (in raw units) and l, leaves exp(scale (s - m)) = exp2(s scale log2(e)
// - m scale log2(e)) in s, one FFMA and one EX2 a score, and alpha =
// exp(scale (m_old - m_new)) per row. The max and sum run as 4 chains.
// Quad-collective.
template <bool CAUSAL, bool MASK>
__device__ __forceinline__ void softmax_step(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int row,
                                             int tq, int keys) {
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e;
          if (CAUSAL ? c > row + 8 * i : c >= keys) s[4 * j + 2 * i + e] = kNegInf;
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& c = mx[(2 * j + e) & 3];
        c = fmaxf(c, s[4 * j + 2 * i + e]);
      }
    const float m_new =
        fmaxf(m[i], group_max<4>(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))));
    const float mb = m_new * scale_log2;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = ex2(fmaf(x, scale_log2, -mb));
        sum[(2 * j + e) & 3] += x;
      }
    alpha[i] = ex2((m[i] - m_new) * scale_log2);
    l[i] = l[i] * alpha[i] + group_sum<4>((sum[0] + sum[1]) + (sum[2] + sum[3]));
    m[i] = m_new;
  }
}

// grid (ceil(T / 128), BH), 384 threads; tma_q/k/v map [BH, T, HD] bf16
// in 128-row boxes. Stage s of a ring is used by tiles s, s + kStages,
// ...: tile j waits on parity (j / kStages) & 1.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                       const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v, bf16* __restrict__ out,
                       float* __restrict__ lse, int t, float scale_log2) {
  using L = L128<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sk = sq + L::kBytes;
  uint8_t* sv = sk + kStages * L::kBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sv + kStages * L::kBytes);
  uint64_t* full_k = full_q + 1;
  uint64_t* empty_k = full_k + kStages;
  uint64_t* full_v = empty_k + kStages;
  uint64_t* empty_v = full_v + kStages;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest rows first
  // k tiles at or below the diagonal (tiles are square and aligned, so
  // the last is the diagonal one), or all of them
  const int n_k = CAUSAL ? q0 / kBN + 1 : (t + kBN - 1) / kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);  // lane 0 of each arithmetic warp
      mbar_init(&empty_v[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, L::kBytes);
      load_tile<HD, kBN>(sq, &tma_q, full_q, q0, bh);
      for (int j = 0; j <= n_k; ++j) {
        if (j < n_k) {  // K_j
          const int s = j % kStages;
          mbar_wait(&empty_k[s], ((j / kStages) & 1) ^ 1);
          mbar_expect_tx(&full_k[s], L::kBytes);
          load_tile<HD, kBN>(sk + s * L::kBytes, &tma_k, &full_k[s], j * kBN, bh);
        }
        if (j > 0) {  // V_{j-1}
          const int i = j - 1, s = i % kStages;
          mbar_wait(&empty_v[s], ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(&full_v[s], L::kBytes);
          load_tile<HD, kBN>(sv + s * L::kBytes, &tma_v, &full_v[s], i * kBN, bh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMathRegs));
    const int wg = (warp >> 2) - 1;  // 64-row half of the q tile
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's first row
    const int tq = lane & 3;
    float s[64];        // S: m64n128 accumulator
    float o[HD / 2];    // O: m64n{HD} accumulator
    uint32_t p[8][4];   // P: 8 k16 A fragments
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    // Only the last tile masks: the diagonal one (causal), or the one
    // that reaches past T.
    const int last_keys = t - (n_k - 1) * kBN;

    auto issue_s = [&](int j) {
      const int st = j % kStages;
      mbar_wait(&full_k[st], (j / kStages) & 1);
      const uint8_t* kt = sk + st * L::kBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n128k16_ss(s, desc_kmajor<HD, kBN>(sq, wg * 64, kk),
                            desc_kmajor<HD, kBN>(kt, 0, kk), kk != 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {
      const int st = j % kStages;
      mbar_wait(&full_v[st], (j / kStages) & 1);
      const uint8_t* vt = sv + st * L::kBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<HD>(o, p[kk], desc_mn<HD, kBN>(vt, kk));
      wgmma_commit();
    };
    auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    // Ping-pong: the two warpgroups take turns issuing their products, so
    // that one's softmax runs under the other's wgmma. Warpgroup wg issues
    // once barrier 1 + wg has the other's arrival, then arrives on the
    // other's. Warpgroup 0 goes first, and warpgroup 1 leaves out its last
    // arrival, so both barriers end balanced.
    auto my_turn = [&] { named_sync(1 + wg, 256); };
    auto their_turn = [&] { named_arrive(2 - wg, 256); };
    if (wg == 1) their_turn();
    auto softmax = [&](bool last) {
      if (last)
        softmax_step<CAUSAL, true>(s, m, l, alpha, scale_log2, row, tq, last_keys);
      else
        softmax_step<CAUSAL, false>(s, m, l, alpha, scale_log2, row, tq, kBN);
    };

    mbar_wait(full_q, 0);
    my_turn();
    issue_s(0);
    their_turn();
    wgmma_wait<0>();
    fence_operands(s);
    release(&empty_k[0]);
    softmax(n_k == 1);
    pack_frags<kBN>(p, s);  // O is 0: nothing to rescale
    for (int j = 1; j < n_k; ++j) {
      my_turn();
      issue_s(j);
      issue_pv(j - 1);
      their_turn();
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may be in flight
      fence_operands(s);
      release(&empty_k[j % kStages]);
      softmax(j == n_k - 1);
      wgmma_wait<0>();
      fence_operands(o);
      release(&empty_v[(j - 1) % kStages]);
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * jj + 2 * i] *= alpha[i];
          o[4 * jj + 2 * i + 1] *= alpha[i];
        }
      pack_frags<kBN>(p, s);
    }
    my_turn();
    issue_pv(n_k - 1);
    if (wg == 0) their_turn();
    wgmma_wait<0>();
    fence_operands(o);
    release(&empty_v[(n_k - 1) % kStages]);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + row + 8 * i;
      if (r >= t) continue;
      const float l_safe = l[i] == 0.f ? 1.f : l[i];
      const float inv = 1.f / l_safe;
      bf16* dst = out + (static_cast<size_t>(bh) * t + r) * HD + 2 * tq;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
            pack_bf16(o[4 * jj + 2 * i] * inv, o[4 * jj + 2 * i + 1] * inv);
      if (lse != nullptr && tq == 0)
        lse[static_cast<size_t>(bh) * t + r] = m[i] * scale_log2 * kLn2 + logf(l_safe);
    }
  }
}

}  // namespace wg

template <int HD, bool CAUSAL>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                             int bh, int t, float scale, cudaStream_t stream) {
  constexpr int smem = wg::fwd_smem<HD>();
  if (hopper::encoder() == nullptr) return cudaErrorSharedObjectInitFailed;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!wg::tile_map<HD, wg::kBN>(&maps[i], src[i], bh, t)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wg::flash_fwd_wgmma_kernel<HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + wg::kBM - 1) / wg::kBM, bh);
  wg::flash_fwd_wgmma_kernel<HD, CAUSAL><<<grid, wg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<wg::bf16*>(out), lse, t,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The bf16 kernel's configuration at head_dim (32, 64 or 128): out[0]
// dynamic shared-memory bytes, out[1] K and V stages, out[2] and out[3]
// the registers per thread after setmaxnreg (loads, arithmetic). Returns
// cudaErrorInvalidValue for another head dim.
inline cudaError_t fwd_config(int head_dim, int* out) {
  const int smem = head_dim == 32    ? wg::fwd_smem<32>()
                   : head_dim == 64  ? wg::fwd_smem<64>()
                   : head_dim == 128 ? wg::fwd_smem<128>()
                                     : 0;
  if (smem == 0) return cudaErrorInvalidValue;
  out[0] = smem;
  out[1] = wg::kStages;
  out[2] = wg::kLoadRegs;
  out[3] = wg::kMathRegs;
  return cudaSuccess;
}

// dtype: 0 = float32 on CUDA cores (tensor cores would round f32 inputs
// to TF32), 1 = bfloat16 on tensor cores (wgmma); head_dim 32, 64 or
// 128; t a positive multiple of 64. Returns cudaGetLastError() of the
// launch.
template <bool CAUSAL>
cudaError_t launch_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                       void* out, float* lse, int bh, int t, float scale, cudaStream_t stream) {
  if (bh < 1 || t < kOwn || t % kOwn != 0) return cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 32:
      return dtype == 0 ? launch_fwd_f32<32, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream)
                        : launch_fwd_wgmma<32, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream);
    case 64:
      return dtype == 0 ? launch_fwd_f32<64, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream)
                        : launch_fwd_wgmma<64, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream);
    case 128:
      return dtype == 0 ? launch_fwd_f32<128, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream)
                        : launch_fwd_wgmma<128, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace tpumon
