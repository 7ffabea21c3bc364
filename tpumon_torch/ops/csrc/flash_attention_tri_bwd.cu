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
// by one CTA that loops over its own pairs: dQ by (bh, 128-row q tile)
// over the k tiles up to its diagonal, dK/dV by (bh, 128-row k tile) over
// the q tiles from its diagonal to T. No atomics, so the result is
// deterministic; the two passes match the reference's two pallas_calls.
//
// Bound: at the training shape (BH 128, T 1024, D 128, bf16) the causal
// pairs need 3 products in the dQ pass (S, dP, dQ: 51.6 GFLOP) and 4 in
// the dK/dV pass (S, dP, dV, dK: 68.8 GFLOP) against 169 MB and 202 MB of
// inputs and outputs, so the bf16 tensor-core rate bounds both (52 us and
// 70 us at 989 TFLOP/s; at BH 16 / T 8192, 417 us and 556 us). The
// two-pass design recomputes S and dP in both passes: 7 products where a
// fused backward needs 5.
//
// What this design does about it (bf16, the training path): only wgmma
// reaches the tensor cores' full rate, and only if its operands are on
// chip when it runs. Both kernels have the forward's shape
// (flash_fwd.cuh): 384 threads, one TMA thread in warpgroup 0 (setmaxnreg
// hands its registers to the others) and two arithmetic warpgroups of 64
// owned rows each (wgmma's m64).
// - The owned tiles (Q and dO for dQ, K and V for dK/dV) are loaded once;
//   the other side streams through a ring of 3 stages of 64-row tiles
//   (K and V for dQ; Q, dO and their 64 lse and D values, by a bulk copy,
//   for dK/dV), each stage with a full and an empty mbarrier, the loading
//   thread running ahead by the ring's depth.
// - The score products S = Q K^T and dP = dO V^T (dK/dV: S^T = K Q^T and
//   dP^T = V dO^T, the owned rows first) are wgmma.m64n64k16 with both
//   operands K-major in shared memory. P and dS are computed on the f32
//   accumulators in wgmma's fragment layout, rounded to bf16 pairwise
//   into register-A fragments, and the gradient products (dQ += dS K;
//   dV += P^T dO, dK += dS^T Q) are the register-A wgmma.m64n{HD}k16
//   with the streamed tile read MN-major through the descriptor: nothing
//   is staged twice or transposed by threads, and P and dS never touch
//   shared memory.
// - dQ: a warpgroup issues tile j's score products and tile j-1's
//   gradient product together, computes P_j and dS_j while the gradient
//   product runs, and releases tile j-1's stage when it completes; the
//   two warpgroups take turns issuing (ping-pong over two named
//   barriers), so one's elementwise work also runs under the other's
//   products.
// - dK/dV holds two m64n{HD} accumulators, and its registers (240 after
//   setmaxnreg) do not also hold a tile's scores while the previous
//   tile's fragments are in flight: a warpgroup runs tile j-1's gradient
//   products, then tile j's score products, then P_j and dS_j, so its
//   elementwise work runs under the other warpgroup's products. The
//   first k16 slice of each score product overwrites its accumulator
//   write-only (hopper.cuh), so the last tile's scores die once packed.
// - Only the warpgroup's diagonal tile is masked. dQ's warpgroup 0 needs
//   one k tile fewer than warpgroup 1, and dK/dV's warpgroup 1 one q tile
//   fewer than warpgroup 0 (its keys start 64 rows later); each still
//   waits for and releases every stage, so the ring's phases stay
//   balanced.
// - The grid runs a bh's tiles next to each other, longest first (dQ:
//   the last q tile; dK/dV: the first k tile), so the CTAs in flight
//   share few bhs' streamed tiles in L2.
// - Tiles sit in shared memory as TMA writes them (flash_wgmma.cuh); the
//   maps are 3-d [BH, T, D], so an owned 128-row tile that reaches past T
//   (T = 64 x odd) loads zeros there. A streamed 64-row tile never does,
//   and neither do dK/dV's lse and D copies. dQ's rows past T read lse
//   and D as 0 (zero rows then give dS = 0). Stores are clipped to T.
// The f32 kernels run the products on CUDA cores in f32 (tensor cores
// would round f32 to TF32): 64 owned rows, 32-row streamed tiles with
// synchronous loads, bound by the f32 FMA rate.
//
// Numerics follow the reference: S, P, dP and dS in f32, P and dS rounded
// to the input type right before their products (`pmat.astype(do.dtype)`,
// `ds.astype(k.dtype)`), f32 accumulators, outputs in the input type. The
// bf16 kernels take P as ex2.approx of a pre-scaled FFMA (prob; relative
// error about 2^-22, results below 2^-126 flushed to 0).
//
// Supported: float32 and bfloat16, head dim 32, 64 or 128, T a multiple
// of 64. The Python wrapper (tpumon_torch/ops/flash_attention.py) checks
// shapes and types; the launchers re-check what they index by.

#include "flash_tri_common.cuh"
#include "flash_wgmma.cuh"


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

// --- bf16: wgmma over TMA-fed rings ---------------------------------------

namespace hop {

using namespace tpumon::flash::wg;

constexpr int kOwn = 128;       // rows a CTA owns, 64 per arithmetic warpgroup
constexpr int kDqK = 64;        // dQ: key rows per streamed stage
constexpr int kDqStages = 3;    // dQ: K/V stages
constexpr int kDkvQ = 64;       // dK/dV: query rows per streamed stage
constexpr int kDkvStages = 3;   // dK/dV: Q/dO/lse/D stages
constexpr int kThreads = 384;   // 3 warpgroups
// Whether the arithmetic warpgroups take turns issuing (Turns): dQ 5-14%
// faster with, dK/dV 46-62% slower (PERF.md).
constexpr bool kDqPingPong = true, kDkvPingPong = false;
// Registers per thread after setmaxnreg: warpgroup 0 (loads), warpgroups
// 1-2 (the products' accumulators and the P/dS fragments). 24 + 2 x 240
// <= 3 x 168, the count every thread starts with under
// __launch_bounds__(384, 1).
constexpr int kLoadRegs = 24, kMathRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(64 % kDkvQ == 0, "T % 64 == 0: a streamed q tile never reaches past T");

// Shared memory, in order. dQ: Q and dO (kOwn rows each), kDqStages K
// tiles, as many V tiles, then the mbarriers: Q/dO's, and a full and an
// empty one per stage. dK/dV: K and V (kOwn rows), kDkvStages Q tiles,
// as many dO tiles, lse rows and D rows, then the mbarriers: K/V's, a full
// and an empty one per stage. + 1024: the tiles start at the first
// 1024-byte boundary (every tile is a multiple of 1024 bytes).
template <int HD>
constexpr int dq_smem() {
  return 2 * Tile<HD, kOwn>::kBytes + 2 * kDqStages * Tile<HD, kDqK>::kBytes +
         (1 + 2 * kDqStages) * 8 + 1024;
}
template <int HD>
constexpr int dkv_smem() {
  return 2 * Tile<HD, kOwn>::kBytes + 2 * kDkvStages * Tile<HD, kDkvQ>::kBytes +
         2 * kDkvStages * kDkvQ * 4 + (1 + 2 * kDkvStages) * 8 + 1024;
}

// P = exp(S scale - lse) = 2^(S scale log2(e) - lse log2(e)), as the
// forward takes it: one FFMA and one EX2 a score (scale log2(e) is
// loop-invariant, lse log2(e) one FMUL per row or column). expf of the
// plain version's own steps is 8-21% slower here and agrees no better:
// where P and dS round to bf16 otherwise than in the plain version, the
// scores' summation order decides (PERF.md).
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return ex2(fmaf(s, scale * kLog2e, -lse * kLog2e));
}

// dQ's P and dS on this thread's fragments of one k tile, in place: s
// holds S = Q K^T, dp holds dP = dO V^T; s[4 j + 2 i + e] is query row
// `rel + 8 i` relative to the tile's first key, key column 8 j + 2 tq + e.
// P (prob) is 0 at keys past the row when MASK; dS = P (dP - D) scale
// goes into dp.
template <bool MASK, int N>
__device__ __forceinline__ void dscores(const float (&s)[N / 2], float (&dp)[N / 2],
                                        const float (&lse)[2], const float (&d)[2], float scale,
                                        int rel, int tq) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        float p = prob(s[x], scale, lse[i]);
        if (MASK && 8 * j + 2 * tq + e > rel + 8 * i) p = 0.f;
        dp[x] = p * (dp[x] - d[i]) * scale;
      }
}

// dK/dV's P^T and dS^T on this thread's fragments of one q tile, in
// place: rows are keys, columns queries. s[4 j + 2 i + e] is key row
// `rel + 8 i` relative to the tile's first query, query column
// 8 j + 2 tq + e, whose lse and D the stage holds in shared memory. P^T
// goes into s (0 at queries before the key when MASK), dS^T into dp.
template <bool MASK, int N>
__device__ __forceinline__ void dscores_t(float (&s)[N / 2], float (&dp)[N / 2],
                                          const float* lse, const float* d, float scale, int rel,
                                          int tq) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * tq);
    const float2 dc = *reinterpret_cast<const float2*>(d + 8 * j + 2 * tq);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float le = e ? l.y : l.x, de = e ? dc.y : dc.x;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 4 * j + 2 * i + e;
        float p = prob(s[x], scale, le);
        if (MASK && 8 * j + 2 * tq + e < rel + 8 * i) p = 0.f;
        s[x] = p;
        dp[x] = p * (dp[x] - de) * scale;
      }
    }
  }
}

// Ping-pong: the two arithmetic warpgroups take turns issuing their
// products, so that one's elementwise work runs under the other's wgmma.
// Warpgroup w issues once named barrier 1 + w has the other's arrival
// (mine), then arrives on the other's (theirs). Both take `turns` turns,
// a tile a warpgroup does not need being an empty turn; warpgroup 0 goes
// first, and warpgroup 1 leaves out its last arrival, so both barriers
// end balanced. No-ops unless ON.
template <bool ON>
struct Turns {
  int w, left;
  __device__ __forceinline__ Turns(int wg, int turns) : w(wg), left(turns) {
    if (ON && w == 1) named_arrive(1, 256);
  }
  __device__ __forceinline__ void mine() const {
    if (ON) named_sync(1 + w, 256);
  }
  __device__ __forceinline__ void theirs() {
    if (ON && (--left > 0 || w == 0)) named_arrive(2 - w, 256);
  }
};

// Rows `row` and + 8 of the CTA's owned tile (starting at row0 of bh's
// slice) from an m64n{HD} accumulator, rounded to bf16; rows at or past
// T are not stored.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[HD / 2],
                                           int bh, int t, int row0, int row, int tq) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + row + 8 * i;
    if (r >= t) continue;
    bf16* p = dst + (static_cast<size_t>(bh) * t + r) * HD + 2 * tq;
#pragma unroll
    for (int jj = 0; jj < HD / 8; ++jj)
      *reinterpret_cast<uint32_t*>(p + 8 * jj) =
          pack_bf16(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
}

// dQ. grid (ceil(T / 128), BH), 384 threads; maps [BH, T, HD] bf16: Q and
// dO in kOwn-row boxes, K and V in kDqK-row boxes. The CTA owns q rows
// q0.. (longest rows first) and streams the k tiles up to its diagonal:
// warpgroup w, rows q0 + 64 w.., needs those up to its own last row and
// masks only the last of them. Stage s of the ring is used by tiles s,
// s + kDqStages, ...: tile j waits on parity (j / kDqStages) & 1.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tri_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                              const __grid_constant__ CUtensorMap tma_do,
                              const __grid_constant__ CUtensorMap tma_k,
                              const __grid_constant__ CUtensorMap tma_v,
                              const float* __restrict__ lse, const float* __restrict__ dvec,
                              bf16* __restrict__ dq, int t, float scale) {
  using LO = Tile<HD, kOwn>;
  using LS = Tile<HD, kDqK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sdo = sq + LO::kBytes;
  uint8_t* sk = sdo + LO::kBytes;
  uint8_t* sv = sk + kDqStages * LS::kBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sv + kDqStages * LS::kBytes);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kDqStages;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kOwn;  // the longest rows first
  const int tiles = (t + kDqK - 1) / kDqK;
  // k tiles warpgroup w needs: those up to the diagonal of its last row
  auto needed = [&](int w) { return min((q0 + 64 * (w + 1) + kDqK - 1) / kDqK, tiles); };
  const int n_k = needed(1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each arithmetic warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, 2 * LO::kBytes);
      load_tile<HD, kOwn>(sq, &tma_q, full_q, q0, bh);
      load_tile<HD, kOwn>(sdo, &tma_do, full_q, q0, bh);
      for (int j = 0; j < n_k; ++j) {
        const int s = j % kDqStages;
        mbar_wait(&empty[s], ((j / kDqStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * LS::kBytes);
        load_tile<HD, kDqK>(sk + s * LS::kBytes, &tma_k, &full[s], j * kDqK, bh);
        load_tile<HD, kDqK>(sv + s * LS::kBytes, &tma_v, &full[s], j * kDqK, bh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMathRegs));
    const int w = (warp >> 2) - 1;  // 64-row half of the q tile
    const int row = w * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's first row
    const int tq = lane & 3;
    const int n_w = needed(w);
    float lse_r[2], dd[2];  // per row; rows past T (padding of the tile) read 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + row + 8 * i;
      const size_t at = static_cast<size_t>(bh) * t + r;
      lse_r[i] = r < t ? lse[at] : 0.f;
      dd[i] = r < t ? dvec[at] : 0.f;
    }
    float s[kDqK / 2], dp[kDqK / 2];  // S and dP: m64n{kDqK} accumulators
    float acc[HD / 2];                // dQ: m64n{HD} accumulator
    uint32_t ds[kDqK / 16][4];        // dS: kDqK / 16 k16 A fragments
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    auto issue_sdp = [&](int j) {
      const int st = j % kDqStages;
      mbar_wait(&full[st], (j / kDqStages) & 1);
      const uint8_t* kt = sk + st * LS::kBytes;
      const uint8_t* vt = sv + st * LS::kBytes;
      wgmma_fence();
      wgmma_scores<kDqK, HD, kOwn, kDqK>(s, sq, w * 64, kt);
      wgmma_scores<kDqK, HD, kOwn, kDqK>(dp, sdo, w * 64, vt);
      wgmma_commit();
    };
    auto issue_dq = [&](int j) {
      const uint8_t* kt = sk + (j % kDqStages) * LS::kBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqK / 16; ++kk) wgmma_rs<HD>(acc, ds[kk], desc_mn<HD, kDqK>(kt, kk));
      wgmma_commit();
    };
    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(&empty[j % kDqStages]);
    };
    auto grads = [&](int j) {  // the warpgroup's last k tile holds its diagonal
      const int rel = q0 + row - j * kDqK;
      if (j == n_w - 1)
        dscores<true, kDqK>(s, dp, lse_r, dd, scale, rel, tq);
      else
        dscores<false, kDqK>(s, dp, lse_r, dd, scale, rel, tq);
    };

    Turns<kDqPingPong> turn(w, n_k + 1);
    mbar_wait(full_q, 0);
    turn.mine();
    issue_sdp(0);
    turn.theirs();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    grads(0);
    pack_frags<kDqK>(ds, dp);
    for (int j = 1; j < n_w; ++j) {
      turn.mine();
      issue_sdp(j);
      issue_dq(j - 1);
      turn.theirs();
      wgmma_wait<1>();  // S_j and dP_j are done; dS_{j-1} K_{j-1} may be in flight
      fence_operands(s);
      fence_operands(dp);
      grads(j);
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(ds);
      release(j - 1);
      pack_frags<kDqK>(ds, dp);
    }
    turn.mine();
    issue_dq(n_w - 1);
    turn.theirs();
    wgmma_wait<0>();
    fence_operands(acc);
    release(n_w - 1);
    for (int j = n_w; j < n_k; ++j) {  // tiles only the other warpgroup needs
      turn.mine();
      turn.theirs();
      mbar_wait(&full[j % kDqStages], (j / kDqStages) & 1);
      release(j);
    }
    store_rows<HD>(dq, acc, bh, t, q0, row, tq);
  }
}

// dK/dV. grid (ceil(T / 128), BH), 384 threads; maps [BH, T, HD] bf16: K
// and V in kOwn-row boxes, Q and dO in kDkvQ-row boxes; lse and dvec
// [BH, T] f32. The CTA owns key rows k0.. (the first k tile, which has the
// most q tiles, first) and streams the q tiles from its diagonal to T:
// warpgroup w, keys k0 + 64 w.., skips those wholly before its first key
// (releasing their stages) and masks those that reach before its last.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tri_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                               const __grid_constant__ CUtensorMap tma_do,
                               const __grid_constant__ CUtensorMap tma_k,
                               const __grid_constant__ CUtensorMap tma_v,
                               const float* __restrict__ lse, const float* __restrict__ dvec,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int t,
                               float scale) {
  using LO = Tile<HD, kOwn>;
  using LS = Tile<HD, kDkvQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + LO::kBytes;
  uint8_t* sq = sv + LO::kBytes;
  uint8_t* sdo = sq + kDkvStages * LS::kBytes;
  float* slse = reinterpret_cast<float*>(sdo + kDkvStages * LS::kBytes);
  float* sd = slse + kDkvStages * kDkvQ;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sd + kDkvStages * kDkvQ);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kDkvStages;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kOwn;  // the first k tile, the longest, first
  const int n_q = (t - k0) / kDkvQ;  // q tiles from the diagonal to T
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each arithmetic warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, 2 * LO::kBytes);
      load_tile<HD, kOwn>(sk, &tma_k, full_kv, k0, bh);
      load_tile<HD, kOwn>(sv, &tma_v, full_kv, k0, bh);
      for (int j = 0; j < n_q; ++j) {
        const int s = j % kDkvStages;
        const int q0 = k0 + j * kDkvQ;
        const size_t at = static_cast<size_t>(bh) * t + q0;
        mbar_wait(&empty[s], ((j / kDkvStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * LS::kBytes + 2 * kDkvQ * 4);
        load_tile<HD, kDkvQ>(sq + s * LS::kBytes, &tma_q, &full[s], q0, bh);
        load_tile<HD, kDkvQ>(sdo + s * LS::kBytes, &tma_do, &full[s], q0, bh);
        bulk_load(slse + s * kDkvQ, lse + at, kDkvQ * 4, &full[s]);
        bulk_load(sd + s * kDkvQ, dvec + at, kDkvQ * 4, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMathRegs));
    const int w = (warp >> 2) - 1;  // 64-row half of the k tile
    const int row = w * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's first key row
    const int tq = lane & 3;
    // q tiles wholly before the warpgroup's first key: nothing to add
    const int first = min(64 * w / kDkvQ, n_q);
    float s[kDkvQ / 2], dp[kDkvQ / 2];  // S^T and dP^T: m64n{kDkvQ} accumulators
    float acc_dk[HD / 2], acc_dv[HD / 2];  // m64n{HD} accumulators
    uint32_t pf[kDkvQ / 16][4], dsf[kDkvQ / 16][4];  // P^T, dS^T: k16 A fragments
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(&empty[j % kDkvStages]);
    };
    auto issue_sdp = [&](int j) {
      const int st = j % kDkvStages;
      mbar_wait(&full[st], (j / kDkvStages) & 1);
      const uint8_t* qt = sq + st * LS::kBytes;
      const uint8_t* dot = sdo + st * LS::kBytes;
      wgmma_fence();
      wgmma_scores<kDkvQ, HD, kOwn, kDkvQ>(s, sk, w * 64, qt);
      wgmma_scores<kDkvQ, HD, kOwn, kDkvQ>(dp, sv, w * 64, dot);
      wgmma_commit();
    };
    auto issue_dkv = [&](int j) {
      const int st = j % kDkvStages;
      const uint8_t* qt = sq + st * LS::kBytes;
      const uint8_t* dot = sdo + st * LS::kBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk)
        wgmma_rs<HD>(acc_dv, pf[kk], desc_mn<HD, kDkvQ>(dot, kk));
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk)
        wgmma_rs<HD>(acc_dk, dsf[kk], desc_mn<HD, kDkvQ>(qt, kk));
      wgmma_commit();
    };
    auto grads = [&](int j) {  // tiles that start before the warpgroup's last key are masked
      const int st = j % kDkvStages;
      const int rel = row - j * kDkvQ;
      if (j * kDkvQ < 64 * w + 64)
        dscores_t<true, kDkvQ>(s, dp, slse + st * kDkvQ, sd + st * kDkvQ, scale, rel, tq);
      else
        dscores_t<false, kDkvQ>(s, dp, slse + st * kDkvQ, sd + st * kDkvQ, scale, rel, tq);
    };
    auto pack = [&] {
      pack_frags<kDkvQ>(pf, s);
      pack_frags<kDkvQ>(dsf, dp);
    };

    Turns<kDkvPingPong> turn(w, n_q + 1);
    for (int j = 0; j < first; ++j) {
      turn.mine();
      turn.theirs();
      mbar_wait(&full[j % kDkvStages], (j / kDkvStages) & 1);
      release(j);
    }
    mbar_wait(full_kv, 0);
    for (int j = first; j < n_q; ++j) {
      turn.mine();
      if (j > first) {  // tile j-1's dK/dV products, then its stage back
        issue_dkv(j - 1);
        wgmma_wait<0>();
        fence_operands(acc_dk);
        fence_operands(acc_dv);
        release(j - 1);
      }
      issue_sdp(j);
      turn.theirs();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
      grads(j);
      pack();
    }
    turn.mine();
    if (first < n_q) issue_dkv(n_q - 1);
    turn.theirs();
    if (first < n_q) {
      wgmma_wait<0>();
      fence_operands(acc_dk);
      fence_operands(acc_dv);
      release(n_q - 1);
    }
    store_rows<HD>(dk, acc_dk, bh, t, k0, row, tq);
    store_rows<HD>(dv, acc_dv, bh, t, k0, row, tq);
  }
}

}  // namespace hop

template <int HD>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dvec, void* dq, int bh, int t,
                            float scale, cudaStream_t stream) {
  using namespace hop;
  constexpr int smem = dq_smem<HD>();
  if (encoder() == nullptr) return cudaErrorSharedObjectInitFailed;
  CUtensorMap maps[4];
  if (!tile_map<HD, kOwn>(&maps[0], q, bh, t) || !tile_map<HD, kOwn>(&maps[1], dout, bh, t) ||
      !tile_map<HD, kDqK>(&maps[2], k, bh, t) || !tile_map<HD, kDqK>(&maps[3], v, bh, t))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_tri_bwd_dq_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kOwn - 1) / kOwn, bh);  // a bh's tiles together
  flash_tri_bwd_dq_wgmma_kernel<HD><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dvec, static_cast<bf16*>(dq), t, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* dvec, void* dk, void* dv, int bh,
                             int t, float scale, cudaStream_t stream) {
  using namespace hop;
  constexpr int smem = dkv_smem<HD>();
  if (encoder() == nullptr) return cudaErrorSharedObjectInitFailed;
  CUtensorMap maps[4];
  if (!tile_map<HD, kDkvQ>(&maps[0], q, bh, t) || !tile_map<HD, kDkvQ>(&maps[1], dout, bh, t) ||
      !tile_map<HD, kOwn>(&maps[2], k, bh, t) || !tile_map<HD, kOwn>(&maps[3], v, bh, t))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_tri_bwd_dkv_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kOwn - 1) / kOwn, bh);  // a bh's tiles together
  flash_tri_bwd_dkv_wgmma_kernel<HD><<<grid, kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dvec, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t, scale);
  return cudaGetLastError();
}

// The bf16 kernels' configuration at head_dim (32, 64 or 128), into
// out[8]: dynamic shared-memory bytes (dQ, dK/dV), streamed stages (dQ,
// dK/dV), streamed tile rows (dQ's k tiles, dK/dV's q tiles), and the
// registers per thread after setmaxnreg (loads, arithmetic). Returns
// cudaErrorInvalidValue for another head dim.
template <int HD>
cudaError_t bwd_config(int* out) {
  using namespace hop;
  const int v[8] = {dq_smem<HD>(), dkv_smem<HD>(), kDqStages, kDkvStages,
                    kDqK,          kDkvQ,          kLoadRegs, kMathRegs};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
}

}  // namespace

// Return LAUNCH##_F32(HD) (f32, CUDA cores) or LAUNCH##_WGMMA(HD) (bf16,
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
      return (int)LAUNCH##_WGMMA(32);                                  \
    case 1064:                                                      \
      return (int)LAUNCH##_WGMMA(64);                                  \
    case 1128:                                                      \
      return (int)LAUNCH##_WGMMA(128);                                 \
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
#define TPUMON_DQ_WGMMA(HD) launch_dq_wgmma<HD>(q, k, v, dout, l, d, dq, bh, t, scale, s)
  TPUMON_DISPATCH(TPUMON_DQ);
#undef TPUMON_DQ_F32
#undef TPUMON_DQ_WGMMA
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
#define TPUMON_DKV_WGMMA(HD) \
  launch_dkv_wgmma<HD>(q, k, v, dout, l, d, dk, dv, bh, t, scale, s)
  TPUMON_DISPATCH(TPUMON_DKV);
#undef TPUMON_DKV_F32
#undef TPUMON_DKV_WGMMA
}

// The bf16 kernels' shared-memory bytes, stages, streamed tile rows and
// registers after setmaxnreg at head_dim, into out[8] (bwd_config).
int tpumon_flash_bwd_config(int head_dim, int* out) {
  switch (head_dim) {
    case 32:
      return (int)bwd_config<32>(out);
    case 64:
      return (int)bwd_config<64>(out);
    case 128:
      return (int)bwd_config<128>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
