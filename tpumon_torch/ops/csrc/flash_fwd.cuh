// The flash-attention forward kernels, causal or not, shared by the
// triangle forward (flash_attention_tri_fwd.cu, causal, with the per-row
// logsumexp) and the rectangular forward (flash_attention.cu, either
// mask, no logsumexp). Two kernels:
// - bf16: flash_fwd_wgmma_kernel, wgmma over a TMA-fed K/V ring (below).
// - f32: flash_fwd_kernel, the products on CUDA cores in f32 (tensor
//   cores would round f32 inputs to TF32): one CTA per (bh, 64-row q
//   tile), 32-row k tiles with synchronous loads, bound by the f32 FMA
//   rate (67 TFLOP/s) and the shared-memory reads feeding it. Rows past
//   T are staged as zeros and never stored; without the mask, keys past T
//   are masked.
//
// The bf16 design. A CTA owns one (bh, 128-row q tile) and loops itself
// over the k tiles it needs (kBN rows: 128, or 64 at head dim 256, whose O
// accumulator takes 128 registers a thread and leaves room for a 64-wide
// S tile only; a 128-row Q tile and two stages each of 64-row K and V
// tiles fit 227 KB there): all of them without the causal mask,
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
//   they issue S_j = Q K_j^T (HD / 16 wgmma.m64n{kBN}k16, Q and K both
//   K-major in shared memory), then O += P_{j-1} V_{j-1} (kBN / 16
//   register-A wgmma.m64n{HD}k16: P never touches shared memory; V is read MN-major
//   from its row-major tile through the descriptor and the B-transpose
//   immediate, so nothing transposes it). They wait for S_j with P V in
//   flight and run S_j's online softmax while the tensor cores finish
//   P V, then wait for it, release its V stage, rescale O and pack P_j.
//   The two warpgroups take turns issuing (ping-pong over two named
//   barriers), so one's softmax also runs under the other's products.
// - The softmax works on the f32 accumulator in wgmma's fragment layout:
//   a thread holds two rows (lane / 4 and + 8 of its warp's 16), kBN / 4
//   scores of each, and a row's max and sum reduce over its quad of
//   lanes. The scores of 16 columns, rounded to bf16 pairwise, are the
//   A fragment of those columns for P V, in place.
// - Tiles sit in shared memory as TMA writes them (flash_wgmma.cuh,
//   shared with the backward). The tensor maps are 3-d [BH, T, D], so a
//   tile that reaches past T (any T) loads zeros there, not the next bh's
//   rows; out and lse are stored for rows below T only, and without the
//   mask the keys at or past T are masked (with it, no real row sees
//   them).
//
// Numerics follow the reference: scores and softmax in f32; masked
// scores are -1e30; the unnormalised probabilities are rounded to V's
// type before P V (as `p.astype(v.dtype)`), their row sum is not; a row
// whose sum is 0 returns zeros; lse = m + log(l) in f32. The bf16 kernel
// takes each exponential in base 2, ex2.approx of s x scale x log2(e) - m
// x scale x log2(e) (one FFMA; relative error about 2^-22, results below
// 2^-126 flushed to 0), and masks only the k tiles that can hold masked
// keys: the last (the one that reaches past T without the mask), or with
// it those that reach past a warpgroup's first row (at kBN 64 warpgroup
// 0's last tile lies wholly above its diagonal and adds exact zeros). The
// first k tile holds key 0, which every row sees,
// so each row's running max is a real score from the first step on and
// rows past the caller's real length (padding) stay finite.
//
// Head dims above 256: the sliced route (flash_wgmma.cuh's wide
// namespace; D a multiple of 256, the wrapper zero-pads one between). A
// CTA owns one (bh, 64-row q tile, slice of the output's columns: bf16
// 256, f32 128); for each k tile it computes S over all of D in chunks,
// Q's and K's chunks streamed together and their products added into one
// S, then the online-softmax step and O += P V over V's columns of the
// slice. Every slice takes the same chunks in the same order, so the
// slices' row max, sum and lse agree; only slice 0 writes lse. bf16: one
// arithmetic warpgroup and a load warp over a 3-slot TMA ring (64-row
// tiles), the O slice an m64n256 accumulator, S m64n64. f32: CUDA cores,
// 64 q rows, 32-row k tiles, 128-column chunks staged by the CTA. Q is
// read once per k tile: a simple schedule, not a fast one.
//
// Supported: float32 and bfloat16, head dim 32, 64, 128 or 256, or any
// multiple of 256 above it; any T >= 1. lse may be null (no logsumexp
// written).
#pragma once

#include "flash_tri_common.cuh"
#include "flash_wgmma.cuh"

namespace tpumon {
namespace flash {

// The f32 kernels' online-softmax step on one 32-row k tile's scores:
// scaled, masked where the tile can hold masked keys (causal: keys past
// the row, in a tile that reaches past q0; else keys at or past T, in a
// last tile that reaches past it), m and l updated, o rescaled and P
// written to sp ([kOwn][kLdP]).
template <bool CAUSAL, int OUT>
__device__ __forceinline__ void softmax_tile(float (&s)[kRows][kCols], float (&m)[kRows],
                                             float (&l)[kRows], float (&o)[kRows][OUT], float* sp,
                                             int q0, int k0, int t, float scale) {
  const int tx = lane_tx(), ty = lane_ty();
  const bool diag = CAUSAL && k0 + kStream > q0;  // only these tiles hold keys past a row
  const bool tail = !CAUSAL && k0 + kStream > t;  // keys past T (with the mask: past the row)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + ty + kRowGroups * r;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float x = s[r][c] * scale;
      const int kpos = k0 + tx + kColGroups * c;
      s[r][c] = (diag && kpos > qpos) || (tail && kpos >= t) ? kNegInf : x;
    }
    const float alpha = online_softmax_update_row<kColGroups, kCols>(s[r], m[r], l[r]);
#pragma unroll
    for (int c = 0; c < OUT; ++c) o[r][c] *= alpha;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      sp[(ty + kRowGroups * r) * kLdP + tx + kColGroups * c] = s[r][c];
  }
}

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

  stage<HD, kOwn>(sq, q + base + (size_t)q0 * HD, t - q0);

  float m[kRows], l[kRows], o[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  zero(o);

  // k tiles at or below the diagonal, or all of them, none wholly past T
  const int tiles = (t + kStream - 1) / kStream;
  const int n_k = CAUSAL ? min((q0 + kOwn) / kStream, tiles) : tiles;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kStream;
    __syncthreads();  // the previous tile is consumed
    stage<HD, kStream>(sk, k + base + (size_t)k0 * HD, t - k0);
    stage<HD, kStream>(sv, v + base + (size_t)k0 * HD, t - k0);
    __syncthreads();

    float s[kRows][kCols];
    zero(s);
    mma<kRows, kCols, HD, LD, 1, LD, 1>(s, sq, sk);
    softmax_tile<CAUSAL>(s, m, l, o, sp, q0, k0, t, scale);
    __syncthreads();
    mma<kRows, kOut, kStream, kLdP, 1, 1, LD>(o, sp, sv);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < kOut; ++c) o[r][c] *= inv;
    if (lse != nullptr && tx == 0 && q0 + ty + kRowGroups * r < t)
      lse[(size_t)bh * t + q0 + ty + kRowGroups * r] = m[r] + logf(l_safe);
  }
  store_rows<HD>(out + base, q0, t, o);
}

template <int HD, bool CAUSAL>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                           int bh, int t, float scale, cudaStream_t stream) {
  constexpr int LD = HD + 1;
  const int smem = ((kOwn + 2 * kStream) * LD + kOwn * kLdP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<HD, CAUSAL><<<dim3((t + kOwn - 1) / kOwn, bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, t, scale);
  return cudaGetLastError();
}

// f32, the sliced route: grid (ceil(T / 64) x slices, BH), 128 threads;
// a CTA owns q rows q0.. (the longest first; a bh's slices next to each
// other) and columns W slice.. of out; D = d, a multiple of W.
constexpr int kSliceF32 = 128;  // the f32 sliced route's output slice and S chunk

template <bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int t, int d, float scale) {
  constexpr int W = kSliceF32;
  constexpr int LD = W + 1;
  constexpr int kOut = W / kColGroups;
  extern __shared__ float smem[];
  float* sq = smem;               // [kOwn][LD]: Q's chunk
  float* sk = sq + kOwn * LD;     // [kStream][LD]: K's chunk, then V's slice
  float* sp = sk + kStream * LD;  // [kOwn][kLdP]: P

  const int slices = d / W, nch = d / W;
  const int bh = blockIdx.y, slice = blockIdx.x % slices;
  const int q0 = (gridDim.x / slices - 1 - blockIdx.x / slices) * kOwn;  // longest rows first
  const size_t base = (size_t)bh * t * d;
  const int tx = lane_tx(), ty = lane_ty();

  float m[kRows], l[kRows], o[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  zero(o);

  const int tiles = (t + kStream - 1) / kStream;
  const int n_k = CAUSAL ? min((q0 + kOwn) / kStream, tiles) : tiles;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kStream;
    float s[kRows][kCols];
    zero(s);
    for (int c = 0; c < nch; ++c) {  // S over all of D, chunk by chunk
      __syncthreads();  // the previous chunk (or P V) is consumed
      stage_cols<W, kOwn>(sq, q + base + (size_t)q0 * d + c * W, d, t - q0);
      stage_cols<W, kStream>(sk, k + base + (size_t)k0 * d + c * W, d, t - k0);
      __syncthreads();
      mma<kRows, kCols, W, LD, 1, LD, 1>(s, sq, sk);
    }
    __syncthreads();  // every chunk is consumed
    stage_cols<W, kStream>(sk, v + base + (size_t)k0 * d + slice * W, d, t - k0);
    softmax_tile<CAUSAL>(s, m, l, o, sp, q0, k0, t, scale);
    __syncthreads();
    mma<kRows, kOut, kStream, kLdP, 1, 1, LD>(o, sp, sk);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int c = 0; c < kOut; ++c) o[r][c] *= inv;
    if (lse != nullptr && slice == 0 && tx == 0 && q0 + ty + kRowGroups * r < t)
      lse[(size_t)bh * t + q0 + ty + kRowGroups * r] = m[r] + logf(l_safe);
  }
  store_cols<W>(out + base + slice * W, d, q0, t, o);
}

template <bool CAUSAL>
cudaError_t launch_fwd_wide_f32(const void* q, const void* k, const void* v, void* out,
                                float* lse, int bh, int t, int d, float scale,
                                cudaStream_t stream) {
  constexpr int LD = kSliceF32 + 1;
  const int smem = ((kOwn + kStream) * LD + kOwn * kLdP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_kernel<CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kOwn - 1) / kOwn * (d / kSliceF32), bh);
  flash_fwd_wide_kernel<CAUSAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, t, d, scale);
  return cudaGetLastError();
}

// --- bf16: wgmma over a TMA-fed K/V ring ---------------------------------

namespace wg {

constexpr int kBM = 128;        // q rows per CTA, 64 per arithmetic warpgroup
constexpr int kStages = 2;      // K stages, and as many V stages
constexpr int kThreads = 384;   // 3 warpgroups
// Registers per thread after setmaxnreg: warpgroup 0 (loads), warpgroups
// 1-2 (S, O and P). 40 + 2 x 232 <= 3 x 168, the count every thread
// starts with under __launch_bounds__(384, 1).
constexpr int kLoadRegs = 40, kMathRegs = 232;
constexpr float kLn2 = 0.6931471805599453f;

// k rows per stage: 128, or 64 at head dim 256 (its O accumulator holds
// 128 registers a thread, S 32 more at 64 columns).
template <int HD>
__host__ __device__ constexpr int k_rows() {
  return HD > 128 ? 64 : 128;
}


// The online-softmax step on this thread's S fragment of an N-column k
// tile: s[4 j + 2 i + e] is the raw score Q K^T of row `row + 8 i` (of the
// CTA's 128), column 8 j + 2 tq + e of the tile. MASK: -1e30 at columns
// past the row (causal: `rel` is the row's position less the tile's first
// key's), or at or past `keys` (else: the real keys of a last tile that
// reaches past T). Updates m (in raw units) and l, leaves exp(scale (s -
// m)) = exp2(s scale log2(e) - m scale log2(e)) in s, one FFMA and one EX2
// a score, and alpha = exp(scale (m_old - m_new)) per row. The max and sum
// run as 4 chains. Quad-collective.
template <bool CAUSAL, bool MASK, int N>
__device__ __forceinline__ void softmax_step(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2, int rel,
                                             int tq, int keys) {
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * tq + e;
          if (CAUSAL ? c > rel + 8 * i : c >= keys) s[4 * j + 2 * i + e] = kNegInf;
        }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
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
    for (int j = 0; j < N / 8; ++j)
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

// The K/V ring of the bf16 forward kernels (flash_fwd_wgmma_kernel here,
// chunk_attention_kernel in prefill_attention.cu), kBN k rows a stage: in
// dynamic shared memory the Q tile (kBM rows), kStages K tiles, kStages V
// tiles, then the mbarriers: Q's, and a full and an empty one per K and
// per V stage (+ 1024: the tiles start at the first 1024-byte boundary).
// Stage s of a ring holds tiles s, s + kStages, ...: tile j waits on
// parity (j / kStages) & 1.
template <int HD, int kBN>
struct KvRing {
  using LQ = Tile<HD, kBM>;
  using LK = Tile<HD, kBN>;
  static constexpr int kBytes =
      LQ::kBytes + 2 * kStages * LK::kBytes + (1 + 4 * kStages) * 8 + 1024;
  uint8_t* sq;
  uint8_t* sk;
  uint8_t* sv;
  uint64_t* full_q;
  uint64_t* full_k;
  uint64_t* empty_k;
  uint64_t* full_v;
  uint64_t* empty_v;
};

template <int HD>
constexpr int fwd_smem() {
  return KvRing<HD, k_rows<HD>()>::kBytes;
}

// The ring in dynamic shared memory, its barriers initialised (full: the
// load thread's one arrival with the bytes; empty: lane 0 of each
// arithmetic warp). Block-collective.
template <int HD, int kBN>
__device__ __forceinline__ KvRing<HD, kBN> kv_ring_init(uint8_t* smem_raw) {
  using R = KvRing<HD, kBN>;
  R r;
  r.sq = align1024(smem_raw);
  r.sk = r.sq + R::LQ::kBytes;
  r.sv = r.sk + kStages * R::LK::kBytes;
  r.full_q = reinterpret_cast<uint64_t*>(r.sv + kStages * R::LK::kBytes);
  r.full_k = r.full_q + 1;
  r.empty_k = r.full_k + kStages;
  r.full_v = r.empty_k + kStages;
  r.empty_v = r.full_v + kStages;
  if (threadIdx.x == 0) {
    mbar_init(r.full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&r.full_k[s], 1);
      mbar_init(&r.full_v[s], 1);
      mbar_init(&r.empty_k[s], 8);  // lane 0 of each arithmetic warp
      mbar_init(&r.empty_v[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The load thread, after Q: the K and V tiles 0..n_k-1 in the order the
// arithmetic needs them (K_j, then V_{j-1}), each into its stage once
// free, running ahead by up to the ring's depth. load(map, dst, bar, j)
// issues tile j of map (tma_k or tma_v) into dst, completing on bar,
// whose bytes are expected here.
template <int HD, int kBN, typename Load>
__device__ __forceinline__ void load_kv(const KvRing<HD, kBN>& r, const CUtensorMap* tma_k,
                                        const CUtensorMap* tma_v, int n_k, Load load) {
  using LK = Tile<HD, kBN>;
  for (int j = 0; j <= n_k; ++j) {
    if (j < n_k) {  // K_j
      const int s = j % kStages;
      mbar_wait(&r.empty_k[s], ((j / kStages) & 1) ^ 1);
      mbar_expect_tx(&r.full_k[s], LK::kBytes);
      load(tma_k, r.sk + s * LK::kBytes, &r.full_k[s], j);
    }
    if (j > 0) {  // V_{j-1}
      const int i = j - 1, s = i % kStages;
      mbar_wait(&r.empty_v[s], ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(&r.full_v[s], LK::kBytes);
      load(tma_v, r.sv + s * LK::kBytes, &r.full_v[s], i);
    }
  }
}

// Arithmetic warpgroup wg (q rows 64 wg.. of the tile) over the k tiles
// 0..n_k-1 (n_k >= 1) of the ring: S_j = Q K_j^T, tile j's online-softmax
// step, O += P_j V_j, in the ping-pong order of the file's note.
// softmax(j, s, alpha) runs the step on S_j with the caller's mask
// (softmax_step on the caller's m and l) and leaves alpha. Leaves the
// unnormalised O in o.
template <int HD, int kBN, typename Softmax>
__device__ __forceinline__ void attend_kv(const KvRing<HD, kBN>& r, int n_k, int wg,
                                          float (&o)[HD / 2], Softmax softmax) {
  using LK = Tile<HD, kBN>;
  const int lane = threadIdx.x & 31;
  float s[kBN / 2];         // S: m64n{kBN} accumulator
  uint32_t p[kBN / 16][4];  // P: kBN / 16 k16 A fragments
  float alpha[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  auto issue_s = [&](int j) {
    const int st = j % kStages;
    mbar_wait(&r.full_k[st], (j / kStages) & 1);
    const uint8_t* kt = r.sk + st * LK::kBytes;
    wgmma_fence();
    if constexpr (kBN == 128) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_m64n128k16_ss(s, desc_kmajor<HD, kBM>(r.sq, wg * 64, kk),
                            desc_kmajor<HD, kBN>(kt, 0, kk), kk != 0);
    } else {
      wgmma_scores<kBN, HD, kBM, kBN>(s, r.sq, wg * 64, kt);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int j) {
    const int st = j % kStages;
    mbar_wait(&r.full_v[st], (j / kStages) & 1);
    const uint8_t* vt = r.sv + st * LK::kBytes;
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

  mbar_wait(r.full_q, 0);
  my_turn();
  issue_s(0);
  their_turn();
  wgmma_wait<0>();
  fence_operands(s);
  release(&r.empty_k[0]);
  softmax(0, s, alpha);
  pack_frags<kBN>(p, s);  // O is 0: nothing to rescale
  for (int j = 1; j < n_k; ++j) {
    my_turn();
    issue_s(j);
    issue_pv(j - 1);
    their_turn();
    wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may be in flight
    fence_operands(s);
    release(&r.empty_k[j % kStages]);
    softmax(j, s, alpha);
    wgmma_wait<0>();
    fence_operands(o);
    release(&r.empty_v[(j - 1) % kStages]);
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
  release(&r.empty_v[(n_k - 1) % kStages]);
}

// grid (ceil(T / 128), BH), 384 threads; tma_q maps [BH, T, HD] bf16 in
// 128-row boxes, tma_k and tma_v in k_rows-row boxes.
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                       const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v, bf16* __restrict__ out,
                       float* __restrict__ lse, int t, float scale_log2) {
  constexpr int kBN = k_rows<HD>();
  using LQ = Tile<HD, kBM>;
  extern __shared__ uint8_t smem_raw[];
  const auto ring = kv_ring_init<HD, kBN>(smem_raw);

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // longest rows first
  // k tiles up to the diagonal of the CTA's last row (at kBN 128 the last
  // is the diagonal one), or all of them; none wholly past T
  const int tiles = (t + kBN - 1) / kBN;
  const int n_k = !CAUSAL        ? tiles
                  : kBN == kBM ? q0 / kBN + 1
                               : min((q0 + kBM) / kBN, tiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(ring.full_q, LQ::kBytes);
      load_tile<HD, kBM>(ring.sq, &tma_q, ring.full_q, q0, bh);
      load_kv(ring, &tma_k, &tma_v, n_k,
              [&](const CUtensorMap* map, uint8_t* dst, uint64_t* bar, int j) {
                load_tile<HD, kBN>(dst, map, bar, j * kBN, bh);
              });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMathRegs));
    const int wg = (warp >> 2) - 1;  // 64-row half of the q tile
    const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's first row
    const int tq = lane & 3;
    float o[HD / 2];  // O: m64n{HD} accumulator
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // Tile j holds masked keys for this warpgroup if it reaches past the
    // warpgroup's first row (causal) or past T: at kBN 128 only the last
    // (the diagonal one, or the one that reaches past T).
    const int last_keys = t - (n_k - 1) * kBN;
    attend_kv(ring, n_k, wg, o, [&](int j, float (&s)[kBN / 2], float (&alpha)[2]) {
      if constexpr (kBN == kBM) {
        if (j == n_k - 1)
          softmax_step<CAUSAL, true, kBN>(s, m, l, alpha, scale_log2, row, tq, last_keys);
        else
          softmax_step<CAUSAL, false, kBN>(s, m, l, alpha, scale_log2, row, tq, kBN);
      } else {
        const bool mask = CAUSAL ? (j + 1) * kBN > q0 + wg * 64 : (j + 1) * kBN > t;
        if (mask)
          softmax_step<CAUSAL, true, kBN>(s, m, l, alpha, scale_log2, q0 + row - j * kBN, tq,
                                          t - j * kBN);
        else
          softmax_step<CAUSAL, false, kBN>(s, m, l, alpha, scale_log2, row, tq, kBN);
      }
    });

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

// The sliced route: grid (ceil(T / 64) x D / 256, BH), wide::kThreads;
// maps [BH, T, D] bf16 in Tile<256, 64> boxes. The CTA owns q rows q0..
// (the longest first; a bh's slices next to each other) and out's columns
// 256 slice..; it walks the k tiles up to its diagonal (64-row tiles: the
// last is the diagonal one), or all of them. Items a k tile: its D / 256
// (Q, K) chunks, then V's slice.
template <bool CAUSAL>
__global__ void __launch_bounds__(wide::kThreads, 1)
flash_fwd_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                            const __grid_constant__ CUtensorMap tma_k,
                            const __grid_constant__ CUtensorMap tma_v, bf16* __restrict__ out,
                            float* __restrict__ lse, int t, int d, float scale_log2) {
  using namespace wide;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = ring_init(smem_raw);
  const int nch = d / kChunk, slices = d / kChunk;
  const int bh = blockIdx.y, slice = blockIdx.x % slices;
  const int q0 = (gridDim.x / slices - 1 - blockIdx.x / slices) * kRows;
  const int tiles = (t + kRows - 1) / kRows;
  const int n_k = CAUSAL ? q0 / kRows + 1 : tiles;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4) {
    if (lane == 0) {
      int i = 0;
      for (int j = 0; j < n_k; ++j) {
        for (int c = 0; c < nch; ++c, ++i)
          load_pair(ring, i, &tma_q, q0, &tma_k, j * kRows, c * kChunk, bh);
        load_pair(ring, i++, &tma_v, j * kRows, nullptr, 0, slice * kChunk, bh);
      }
    }
    return;
  }
  const int row = warp * 16 + (lane >> 2);  // this thread's first row of the q tile
  const int tq = lane & 3;
  float s[kRows / 2];      // S: m64n64 accumulator
  float o[kChunk / 2];     // O's slice: m64n256 accumulator
  uint32_t p[kRows / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int x = 0; x < kChunk / 2; ++x) o[x] = 0.f;

  int i = 0;
  for (int j = 0; j < n_k; ++j) {
    scores(ring, i, nch, s);
    if (j == n_k - 1)  // the diagonal tile, or the one that reaches past T
      softmax_step<CAUSAL, true, kRows>(s, m, l, alpha, scale_log2, row, tq, t - j * kRows);
    else
      softmax_step<CAUSAL, false, kRows>(s, m, l, alpha, scale_log2, row, tq, kRows);
#pragma unroll
    for (int jj = 0; jj < kChunk / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        o[4 * jj + 2 * e] *= alpha[e];
        o[4 * jj + 2 * e + 1] *= alpha[e];
      }
    pack_frags<kRows>(p, s);
    const int st = ready(ring, i++);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
      wgmma_rs<kChunk>(o, p[kk], desc_mn<kChunk, kRows>(ring.a(st), kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
    release(ring, st);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = q0 + row + 8 * e;
    if (r >= t) continue;
    const float l_safe = l[e] == 0.f ? 1.f : l[e];
    const float inv = 1.f / l_safe;
    bf16* dst = out + (static_cast<size_t>(bh) * t + r) * d + slice * kChunk + 2 * tq;
#pragma unroll
    for (int jj = 0; jj < kChunk / 8; ++jj)
      *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
          pack_bf16(o[4 * jj + 2 * e] * inv, o[4 * jj + 2 * e + 1] * inv);
    if (lse != nullptr && slice == 0 && tq == 0)
      lse[static_cast<size_t>(bh) * t + r] = m[e] * scale_log2 * kLn2 + logf(l_safe);
  }
}

}  // namespace wg

template <bool CAUSAL>
cudaError_t launch_fwd_wide_wgmma(const void* q, const void* k, const void* v, void* out,
                                  float* lse, int bh, int t, int d, float scale,
                                  cudaStream_t stream) {
  namespace W = wg::wide;
  if (hopper::encoder() == nullptr) return cudaErrorSharedObjectInitFailed;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int x = 0; x < 3; ++x)
    if (!wg::tile_map<W::kChunk, W::kRows>(&maps[x], src[x], bh, t, d))
      return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wg::flash_fwd_wide_wgmma_kernel<CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, W::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + W::kRows - 1) / W::kRows * (d / W::kChunk), bh);
  wg::flash_fwd_wide_wgmma_kernel<CAUSAL><<<grid, W::kThreads, W::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<wg::bf16*>(out), lse, t, d,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HD, bool CAUSAL>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                             int bh, int t, float scale, cudaStream_t stream) {
  constexpr int smem = wg::fwd_smem<HD>();
  if (hopper::encoder() == nullptr) return cudaErrorSharedObjectInitFailed;
  CUtensorMap maps[3];
  if (!wg::tile_map<HD, wg::kBM>(&maps[0], q, bh, t) ||
      !wg::tile_map<HD, wg::k_rows<HD>()>(&maps[1], k, bh, t) ||
      !wg::tile_map<HD, wg::k_rows<HD>()>(&maps[2], v, bh, t))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wg::flash_fwd_wgmma_kernel<HD, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + wg::kBM - 1) / wg::kBM, bh);
  wg::flash_fwd_wgmma_kernel<HD, CAUSAL><<<grid, wg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<wg::bf16*>(out), lse, t,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The bf16 kernel's configuration at head_dim (32, 64, 128 or 256; or a
// multiple of 256 above, the sliced route): out[0] dynamic shared-memory
// bytes, out[1] K and V stages (the sliced route: ring slots), out[2] and
// out[3] the registers per thread after setmaxnreg (loads, arithmetic; 0
// on the sliced route, which sets none: ptxas's count holds), out[4] the k
// rows of a stage. Returns cudaErrorInvalidValue for another head dim.
inline cudaError_t fwd_config(int head_dim, int* out) {
  if (head_dim > 256 && head_dim % wg::wide::kChunk == 0) {
    const int v[5] = {wg::wide::kSmem, wg::wide::kSlots, 0, 0, wg::wide::kRows};
    for (int x = 0; x < 5; ++x) out[x] = v[x];
    return cudaSuccess;
  }
  const int smem = head_dim == 32    ? wg::fwd_smem<32>()
                   : head_dim == 64  ? wg::fwd_smem<64>()
                   : head_dim == 128 ? wg::fwd_smem<128>()
                   : head_dim == 256 ? wg::fwd_smem<256>()
                                     : 0;
  if (smem == 0) return cudaErrorInvalidValue;
  out[0] = smem;
  out[1] = wg::kStages;
  out[2] = wg::kLoadRegs;
  out[3] = wg::kMathRegs;
  out[4] = head_dim > 128 ? wg::k_rows<256>() : wg::k_rows<128>();
  return cudaSuccess;
}

// dtype: 0 = float32 on CUDA cores (tensor cores would round f32 inputs
// to TF32), 1 = bfloat16 on tensor cores (wgmma); head_dim 32, 64, 128 or
// 256, or a multiple of 256 above (the sliced route); t >= 1. Returns
// cudaGetLastError() of the launch.
template <bool CAUSAL>
cudaError_t launch_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                       void* out, float* lse, int bh, int t, float scale, cudaStream_t stream) {
  if (bh < 1 || t < 1) return cudaErrorInvalidValue;
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
    case 256:
      return dtype == 0 ? launch_fwd_f32<256, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream)
                        : launch_fwd_wgmma<256, CAUSAL>(q, k, v, out, lse, bh, t, scale, stream);
    default:
      if (head_dim > 256 && head_dim % wg::wide::kChunk == 0)
        return dtype == 0
                   ? launch_fwd_wide_f32<CAUSAL>(q, k, v, out, lse, bh, t, head_dim, scale, stream)
                   : launch_fwd_wide_wgmma<CAUSAL>(q, k, v, out, lse, bh, t, head_dim, scale,
                                                   stream);
      return cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace tpumon
