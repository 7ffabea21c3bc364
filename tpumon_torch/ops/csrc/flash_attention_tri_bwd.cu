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
// - At head dim 256 (Cfg) the CTA owns 64 rows and the two warpgroups
//   split the output's columns, 128 each: an m64n256 accumulator is 128
//   registers a thread, so dK and dV together fit no warpgroup. Each
//   warpgroup computes the tile's S and dP over all 256 columns itself (2
//   score products a warpgroup where one would do: a simple schedule, not
//   a fast one), and two streamed stages fit 227 KB.
// - Only the warpgroup's diagonal tile is masked. dQ's warpgroup 0 needs
//   one k tile fewer than warpgroup 1, and dK/dV's warpgroup 1 one q tile
//   fewer than warpgroup 0 (its keys start 64 rows later); each still
//   waits for and releases every stage, so the ring's phases stay
//   balanced.
// - The grid runs a bh's tiles next to each other, longest first (dQ:
//   the last q tile; dK/dV: the first k tile), so the CTAs in flight
//   share few bhs' streamed tiles in L2.
// - Tiles sit in shared memory as TMA writes them (flash_wgmma.cuh); the
//   maps are 3-d [BH, T, D], so a tile that reaches past T (any T) loads
//   zeros there. dQ's rows past T read lse and D as 0 (zero rows then
//   give dS = 0); dK/dV's query rows past T get lse 1e30 (P = 0) and D 0,
//   written by the loading thread where the bulk copy would read past T.
//   Stores are clipped to T.
// The f32 kernels run the products on CUDA cores in f32 (tensor cores
// would round f32 to TF32): 64 owned rows, 32-row streamed tiles with
// synchronous loads (rows past T staged as zeros), bound by the f32 FMA
// rate; at head dim 256 the dK/dV kernel runs once per half of the
// columns (grid z), each recomputing S and dP.
//
// Numerics follow the reference: S, P, dP and dS in f32, P and dS rounded
// to the input type right before their products (`pmat.astype(do.dtype)`,
// `ds.astype(k.dtype)`), f32 accumulators, outputs in the input type. The
// bf16 kernels take P as ex2.approx of a pre-scaled FFMA (prob; relative
// error about 2^-22, results below 2^-126 flushed to 0).
//
// Head dims above 256 (D a multiple of 256; the wrapper zero-pads one
// between) take the sliced route: each CTA owns 64 rows and one 128-column
// slice of the output(s), and recomputes S and dP over all of D, streamed
// in chunks, as the forward's sliced route does (flash_fwd.cuh): bf16
// through flash_wgmma.cuh's item ring, one arithmetic warpgroup; f32 on
// CUDA cores with 128-column chunks. D stays the wrapper's, computed once.
//
// Supported: float32 and bfloat16, head dim 32, 64, 128 or 256, or a
// multiple of 256 above; any T >= 1. The Python wrapper (tpumon_torch/ops/flash_attention.py) checks
// shapes and types; the launchers re-check what they index by.

#include "flash_tri_common.cuh"
#include "flash_wgmma.cuh"


namespace {

using namespace tpumon::flash;

// The f32 dQ kernels' dS on one 32-row k tile, into sds ([kOwn][kLdP]):
// P = exp(S scale - lse), 0 at keys past the row in a tile that reaches
// past q0; dS = P (dP - D) scale.
__device__ __forceinline__ void dscores_tile(const float (&s)[kRows][kCols],
                                             const float (&dp)[kRows][kCols],
                                             const float (&lse_r)[kRows], const float (&d_r)[kRows],
                                             float* sds, int q0, int k0, float scale) {
  const int tx = lane_tx(), ty = lane_ty();
  const bool diag = k0 + kStream > q0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + ty + kRowGroups * r;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int kcol = tx + kColGroups * c;
      const bool masked = diag && k0 + kcol > qpos;
      const float p = masked ? 0.f : expf(s[r][c] * scale - lse_r[r]);
      sds[(ty + kRowGroups * r) * kLdP + kcol] = p * (dp[r][c] - d_r[r]) * scale;
    }
  }
}

// The f32 dK/dV kernels' P^T and dS^T on one 32-row q tile (rows keys):
// P^T into spt ([kOwn][kLdP]), 0 at queries before the key in a tile that
// starts before the CTA's last key and at queries past T; dS^T into s,
// kept for the dK product.
__device__ __forceinline__ void dscores_t_tile(float (&s)[kRows][kCols],
                                               const float (&dp)[kRows][kCols],
                                               const float (&lse_c)[kCols],
                                               const float (&d_c)[kCols], float* spt, int q0,
                                               int k0, int t, float scale) {
  const int tx = lane_tx(), ty = lane_ty();
  const bool diag = q0 < k0 + kOwn;  // only these tiles hold queries before a key
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kpos = k0 + ty + kRowGroups * r;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int qcol = tx + kColGroups * c;
      const bool masked = (diag && q0 + qcol < kpos) || q0 + qcol >= t;
      const float p = masked ? 0.f : expf(s[r][c] * scale - lse_c[c]);
      s[r][c] = p * (dp[r][c] - d_c[c]) * scale;
      spt[(ty + kRowGroups * r) * kLdP + qcol] = p;
    }
  }
}

// f32: CUDA cores. grid (ceil(T / 64), BH). Owned rows: 64 query rows;
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

  stage<HD, kOwn>(sq, q + base + (size_t)q0 * HD, t - q0);
  stage<HD, kOwn>(sdo, dout + base + (size_t)q0 * HD, t - q0);
  float lse_r[kRows], d_r[kRows];  // rows past T (not stored) read 0
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + ty + kRowGroups * r;
    lse_r[r] = qpos < t ? lse[(size_t)bh * t + qpos] : 0.f;
    d_r[r] = qpos < t ? dvec[(size_t)bh * t + qpos] : 0.f;
  }
  float acc[kRows][kOut];
  zero(acc);

  // k tiles at or below the diagonal, none wholly past T
  const int n_k = min((q0 + kOwn) / kStream, (t + kStream - 1) / kStream);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kStream;
    __syncthreads();  // the previous tile is consumed
    stage<HD, kStream>(sk, k + base + (size_t)k0 * HD, t - k0);
    stage<HD, kStream>(sv, v + base + (size_t)k0 * HD, t - k0);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    zero(s);
    zero(dp);
    mma<kRows, kCols, HD, LD, 1, LD, 1>(s, sq, sk);
    mma<kRows, kCols, HD, LD, 1, LD, 1>(dp, sdo, sv);
    dscores_tile(s, dp, lse_r, d_r, sds, q0, k0, scale);
    __syncthreads();
    mma<kRows, kOut, kStream, kLdP, 1, 1, LD>(acc, sds, sk);
  }
  store_rows<HD>(dq + base, q0, t, acc);
}

// Output columns a dK/dV CTA accumulates: all of them, or at head dim
// 256 one half (grid z), whose two accumulators of 4 x 16 a thread fit the
// registers where 4 x 32 would not; each half recomputes S and dP.
template <int HD>
__host__ __device__ constexpr int dkv_cols() {
  return HD > 128 ? HD / 2 : HD;
}

// f32: CUDA cores. grid (ceil(T / 64), BH, HD / dkv_cols). Owned rows: 64
// key rows; streamed: 32 query rows. Products are computed transposed
// (rows = keys), so P^T and dS^T come straight out of the register tiles.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_tri_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         float* __restrict__ dk, float* __restrict__ dv, int t, float scale) {
  constexpr int LD = HD + 1;
  constexpr int kOutCols = dkv_cols<HD>();
  constexpr int kOut = kOutCols / kColGroups;
  extern __shared__ float smem[];
  float* sk = smem;                  // [kOwn][LD]
  float* sv = sk + kOwn * LD;        // [kOwn][LD]
  float* sq = sv + kOwn * LD;        // [kStream][LD]
  float* sdo = sq + kStream * LD;    // [kStream][LD]
  float* spt = sdo + kStream * LD;   // [kOwn][kLdP]: P^T, then dS^T

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kOwn;  // k tile 0 has the most q tiles: first
  const int col0 = blockIdx.z * kOutCols;
  const size_t base = (size_t)bh * t * HD;
  const int tx = lane_tx(), ty = lane_ty();

  stage<HD, kOwn>(sk, k + base + (size_t)k0 * HD, t - k0);
  stage<HD, kOwn>(sv, v + base + (size_t)k0 * HD, t - k0);
  float acc_dk[kRows][kOut], acc_dv[kRows][kOut];
  zero(acc_dk);
  zero(acc_dv);

  for (int q0 = k0; q0 < t; q0 += kStream) {  // q tiles at or above the diagonal
    float lse_c[kCols], d_c[kCols];  // queries past T: P = 0 below
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int qpos = q0 + tx + kColGroups * c;
      lse_c[c] = qpos < t ? lse[(size_t)bh * t + qpos] : 0.f;
      d_c[c] = qpos < t ? dvec[(size_t)bh * t + qpos] : 0.f;
    }
    __syncthreads();  // the previous tile is consumed
    stage<HD, kStream>(sq, q + base + (size_t)q0 * HD, t - q0);
    stage<HD, kStream>(sdo, dout + base + (size_t)q0 * HD, t - q0);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
    zero(s);
    zero(dp);
    mma<kRows, kCols, HD, LD, 1, LD, 1>(s, sk, sq);   // S^T [key, query]
    mma<kRows, kCols, HD, LD, 1, LD, 1>(dp, sv, sdo); // dP^T
    dscores_t_tile(s, dp, lse_c, d_c, spt, q0, k0, t, scale);
    __syncthreads();
    mma<kRows, kOut, kStream, kLdP, 1, 1, LD>(acc_dv, spt, sdo + col0);  // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        spt[(ty + kRowGroups * r) * kLdP + tx + kColGroups * c] = s[r][c];
    __syncthreads();
    mma<kRows, kOut, kStream, kLdP, 1, 1, LD>(acc_dk, spt, sq + col0);  // dK += dS^T Q
  }
  store_rows<HD, kOutCols>(dk + base + col0, k0, t, acc_dk);
  store_rows<HD, kOutCols>(dv + base + col0, k0, t, acc_dv);
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
  flash_tri_bwd_dq_kernel<HD><<<dim3((t + kOwn - 1) / kOwn, bh), kThreads, smem, stream>>>(
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
  const dim3 grid((t + kOwn - 1) / kOwn, bh, HD / dkv_cols<HD>());
  flash_tri_bwd_dkv_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dvec, static_cast<float*>(dk), static_cast<float*>(dv),
      t, scale);
  return cudaGetLastError();
}

// f32, the sliced route (head dims above 256; D a multiple of 256): each
// CTA owns 64 rows and one 128-column slice of the output(s), and computes
// S and dP over all of D in 128-column chunks staged by the CTA. grid
// (ceil(T / 64) x D / 128, BH), 128 threads.
constexpr int kSliceF32 = 128;

template <int W>
constexpr int bwd_wide_smem_bytes() {
  return ((2 * kOwn + 2 * kStream) * (W + 1) + kOwn * kLdP) * (int)sizeof(float);
}

// dQ: owned 64 query rows q0.. (the longest first; a bh's slices next to
// each other), streamed 32 key rows; dQ's columns W slice...
__global__ void __launch_bounds__(kThreads)
flash_tri_bwd_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ dvec,
                             float* __restrict__ dq, int t, int d, float scale) {
  constexpr int W = kSliceF32;
  constexpr int LD = W + 1;
  constexpr int kOut = W / kColGroups;
  extern __shared__ float smem[];
  float* sq = smem;                // [kOwn][LD]: Q's chunk
  float* sdo = sq + kOwn * LD;     // [kOwn][LD]: dO's chunk
  float* sk = sdo + kOwn * LD;     // [kStream][LD]: K's chunk, then K's slice
  float* sv = sk + kStream * LD;   // [kStream][LD]: V's chunk
  float* sds = sv + kStream * LD;  // [kOwn][kLdP]: dS

  const int slices = d / W, nch = d / W;
  const int bh = blockIdx.y, slice = blockIdx.x % slices;
  const int q0 = (gridDim.x / slices - 1 - blockIdx.x / slices) * kOwn;
  const size_t base = (size_t)bh * t * d;
  const int tx = lane_tx(), ty = lane_ty();
  float lse_r[kRows], d_r[kRows];  // rows past T (not stored) read 0
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + ty + kRowGroups * r;
    lse_r[r] = qpos < t ? lse[(size_t)bh * t + qpos] : 0.f;
    d_r[r] = qpos < t ? dvec[(size_t)bh * t + qpos] : 0.f;
  }
  float acc[kRows][kOut];
  zero(acc);

  const int n_k = min((q0 + kOwn) / kStream, (t + kStream - 1) / kStream);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kStream;
    float s[kRows][kCols], dp[kRows][kCols];
    zero(s);
    zero(dp);
    for (int c = 0; c < nch; ++c) {  // S and dP over all of D, chunk by chunk
      __syncthreads();  // the previous chunk (or dS K) is consumed
      stage_cols<W, kOwn>(sq, q + base + (size_t)q0 * d + c * W, d, t - q0);
      stage_cols<W, kOwn>(sdo, dout + base + (size_t)q0 * d + c * W, d, t - q0);
      stage_cols<W, kStream>(sk, k + base + (size_t)k0 * d + c * W, d, t - k0);
      stage_cols<W, kStream>(sv, v + base + (size_t)k0 * d + c * W, d, t - k0);
      __syncthreads();
      mma<kRows, kCols, W, LD, 1, LD, 1>(s, sq, sk);
      mma<kRows, kCols, W, LD, 1, LD, 1>(dp, sdo, sv);
    }
    __syncthreads();  // every chunk is consumed
    stage_cols<W, kStream>(sk, k + base + (size_t)k0 * d + slice * W, d, t - k0);
    dscores_tile(s, dp, lse_r, d_r, sds, q0, k0, scale);
    __syncthreads();
    mma<kRows, kOut, kStream, kLdP, 1, 1, LD>(acc, sds, sk);
  }
  store_cols<W>(dq + base + slice * W, d, q0, t, acc);
}

// dK/dV: owned 64 key rows k0.. (the first k tile first; a bh's slices
// next to each other), streamed 32 query rows from the diagonal to T; dK's
// and dV's columns W slice...
__global__ void __launch_bounds__(kThreads)
flash_tri_bwd_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dvec,
                              float* __restrict__ dk, float* __restrict__ dv, int t, int d,
                              float scale) {
  constexpr int W = kSliceF32;
  constexpr int LD = W + 1;
  constexpr int kOut = W / kColGroups;
  extern __shared__ float smem[];
  float* sk = smem;                 // [kOwn][LD]: K's chunk
  float* sv = sk + kOwn * LD;       // [kOwn][LD]: V's chunk
  float* sq = sv + kOwn * LD;       // [kStream][LD]: Q's chunk, then Q's slice
  float* sdo = sq + kStream * LD;   // [kStream][LD]: dO's chunk, then dO's slice
  float* spt = sdo + kStream * LD;  // [kOwn][kLdP]: P^T, then dS^T

  const int slices = d / W, nch = d / W;
  const int bh = blockIdx.y, slice = blockIdx.x % slices;
  const int k0 = blockIdx.x / slices * kOwn;  // k tile 0 has the most q tiles: first
  const size_t base = (size_t)bh * t * d;
  const int tx = lane_tx(), ty = lane_ty();
  float acc_dk[kRows][kOut], acc_dv[kRows][kOut];
  zero(acc_dk);
  zero(acc_dv);

  for (int q0 = k0; q0 < t; q0 += kStream) {  // q tiles at or above the diagonal
    float lse_c[kCols], d_c[kCols];  // queries past T: P = 0 below
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int qpos = q0 + tx + kColGroups * c;
      lse_c[c] = qpos < t ? lse[(size_t)bh * t + qpos] : 0.f;
      d_c[c] = qpos < t ? dvec[(size_t)bh * t + qpos] : 0.f;
    }
    float s[kRows][kCols], dp[kRows][kCols];
    zero(s);
    zero(dp);
    for (int c = 0; c < nch; ++c) {  // S^T and dP^T over all of D
      __syncthreads();  // the previous chunk (or dS^T Q) is consumed
      stage_cols<W, kOwn>(sk, k + base + (size_t)k0 * d + c * W, d, t - k0);
      stage_cols<W, kOwn>(sv, v + base + (size_t)k0 * d + c * W, d, t - k0);
      stage_cols<W, kStream>(sq, q + base + (size_t)q0 * d + c * W, d, t - q0);
      stage_cols<W, kStream>(sdo, dout + base + (size_t)q0 * d + c * W, d, t - q0);
      __syncthreads();
      mma<kRows, kCols, W, LD, 1, LD, 1>(s, sk, sq);   // S^T [key, query]
      mma<kRows, kCols, W, LD, 1, LD, 1>(dp, sv, sdo); // dP^T
    }
    dscores_t_tile(s, dp, lse_c, d_c, spt, q0, k0, t, scale);
    __syncthreads();  // every chunk is consumed, P^T is written
    stage_cols<W, kStream>(sq, q + base + (size_t)q0 * d + slice * W, d, t - q0);
    stage_cols<W, kStream>(sdo, dout + base + (size_t)q0 * d + slice * W, d, t - q0);
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
  store_cols<W>(dk + base + slice * W, d, k0, t, acc_dk);
  store_cols<W>(dv + base + slice * W, d, k0, t, acc_dv);
}

cudaError_t launch_dq_wide_f32(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* dvec, void* dq, int bh, int t,
                               int d, float scale, cudaStream_t stream) {
  constexpr int smem = bwd_wide_smem_bytes<kSliceF32>();
  cudaError_t err = cudaFuncSetAttribute(flash_tri_bwd_dq_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kOwn - 1) / kOwn * (d / kSliceF32), bh);
  flash_tri_bwd_dq_wide_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dvec, static_cast<float*>(dq), t, d, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv_wide_f32(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* dvec, void* dk, void* dv, int bh,
                                int t, int d, float scale, cudaStream_t stream) {
  constexpr int smem = bwd_wide_smem_bytes<kSliceF32>();
  cudaError_t err = cudaFuncSetAttribute(flash_tri_bwd_dkv_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kOwn - 1) / kOwn * (d / kSliceF32), bh);
  flash_tri_bwd_dkv_wide_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dvec, static_cast<float*>(dk), static_cast<float*>(dv),
      t, d, scale);
  return cudaGetLastError();
}

// --- bf16: wgmma over TMA-fed rings ---------------------------------------

namespace hop {

using namespace tpumon::flash::wg;

constexpr int kDqK = 64;        // dQ: key rows per streamed stage
constexpr int kDkvQ = 64;       // dK/dV: query rows per streamed stage
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
// lse of a query row past T in dK/dV's stage: P = 2^(S scale log2(e) -
// 1e30 log2(e)) = 0, so the row adds nothing.
constexpr float kLsePastT = 1e30f;

// The tiling at head dim HD. Up to 128 the CTA owns 128 rows, 64 a
// warpgroup, and each warpgroup accumulates every output column. At 256
// an m64n256 accumulator takes 128 registers a thread, so dK and dV
// together would not fit one warpgroup: the CTA owns 64 rows, both
// warpgroups take the same rows, and warpgroup w accumulates the output's
// columns 128 w .. 128 w + 127 (each computes the tile's S and dP over all
// 256 columns itself). Two streamed stages fit 227 KB there, three below.
template <int HD>
struct Cfg {
  static constexpr bool kSplit = HD > 128;
  static constexpr int kOwn = kSplit ? 64 : 128;      // rows a CTA owns
  static constexpr int kCols = kSplit ? HD / 2 : HD;  // output columns a warpgroup accumulates
  static constexpr int kDqStages = kSplit ? 2 : 3;    // dQ: K/V stages
  static constexpr int kDkvStages = kSplit ? 2 : 3;   // dK/dV: Q/dO/lse/D stages
  // First owned row of warpgroup w, and its first output column.
  __device__ static int row0(int w) { return kSplit ? 0 : 64 * w; }
  __device__ static int col0(int w) { return kSplit ? kCols * w : 0; }
};

// Shared memory, in order. dQ: Q and dO (kOwn rows each), kStages K
// tiles, as many V tiles, then the mbarriers: Q/dO's, and a full and an
// empty one per stage. dK/dV: K and V (kOwn rows), kStages Q tiles, as
// many dO tiles, lse rows and D rows, then the mbarriers: K/V's, a full and
// an empty one per stage. + 1024: the tiles start at the first 1024-byte
// boundary (every tile is a multiple of 1024 bytes).
template <int HD>
constexpr int dq_smem() {
  using C = Cfg<HD>;
  return 2 * Tile<HD, C::kOwn>::kBytes + 2 * C::kDqStages * Tile<HD, kDqK>::kBytes +
         (1 + 2 * C::kDqStages) * 8 + 1024;
}
template <int HD>
constexpr int dkv_smem() {
  using C = Cfg<HD>;
  return 2 * Tile<HD, C::kOwn>::kBytes + 2 * C::kDkvStages * Tile<HD, kDkvQ>::kBytes +
         2 * C::kDkvStages * kDkvQ * 4 + (1 + 2 * C::kDkvStages) * 8 + 1024;
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
// slice) from an m64n{N} accumulator of the output's columns col0..,
// rounded to bf16; rows at or past T are not stored.
template <int HD, int N>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[N / 2],
                                           int bh, int t, int row0, int row, int tq, int col0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + row + 8 * i;
    if (r >= t) continue;
    bf16* p = dst + (static_cast<size_t>(bh) * t + r) * HD + col0 + 2 * tq;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
      *reinterpret_cast<uint32_t*>(p + 8 * jj) =
          pack_bf16(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
}

// dQ. grid (ceil(T / kOwn), BH), 384 threads; maps [BH, T, HD] bf16: Q and
// dO in kOwn-row boxes, K and V in kDqK-row boxes. The CTA owns q rows
// q0.. (longest rows first) and streams the k tiles up to its diagonal:
// warpgroup w, rows q0 + row0(w).., needs those up to its own last row and
// masks only the last of them. Stage s of the ring is used by tiles s,
// s + kStages, ...: tile j waits on parity (j / kStages) & 1.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tri_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                              const __grid_constant__ CUtensorMap tma_do,
                              const __grid_constant__ CUtensorMap tma_k,
                              const __grid_constant__ CUtensorMap tma_v,
                              const float* __restrict__ lse, const float* __restrict__ dvec,
                              bf16* __restrict__ dq, int t, float scale) {
  using C = Cfg<HD>;
  constexpr int kOwn = C::kOwn, kStages = C::kDqStages;
  using LO = Tile<HD, kOwn>;
  using LS = Tile<HD, kDqK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sdo = sq + LO::kBytes;
  uint8_t* sk = sdo + LO::kBytes;
  uint8_t* sv = sk + kStages * LS::kBytes;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sv + kStages * LS::kBytes);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kOwn;  // the longest rows first
  const int tiles = (t + kDqK - 1) / kDqK;
  // k tiles warpgroup w needs: those up to the diagonal of its last row
  auto needed = [&](int w) { return min((q0 + C::row0(w) + 64 + kDqK - 1) / kDqK, tiles); };
  const int n_k = needed(1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
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
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * LS::kBytes);
        load_tile<HD, kDqK>(sk + s * LS::kBytes, &tma_k, &full[s], j * kDqK, bh);
        load_tile<HD, kDqK>(sv + s * LS::kBytes, &tma_v, &full[s], j * kDqK, bh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMathRegs));
    const int w = (warp >> 2) - 1;  // 64-row half of the q tile, or column half
    const int row = C::row0(w) + (warp & 3) * 16 + (lane >> 2);  // this thread's first row
    const int col0 = C::col0(w);
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
    float acc[C::kCols / 2];          // dQ: m64n{kCols} accumulator
    uint32_t ds[kDqK / 16][4];        // dS: kDqK / 16 k16 A fragments
#pragma unroll
    for (int i = 0; i < C::kCols / 2; ++i) acc[i] = 0.f;

    auto issue_sdp = [&](int j) {
      const int st = j % kStages;
      mbar_wait(&full[st], (j / kStages) & 1);
      const uint8_t* kt = sk + st * LS::kBytes;
      const uint8_t* vt = sv + st * LS::kBytes;
      wgmma_fence();
      wgmma_scores<kDqK, HD, kOwn, kDqK>(s, sq, C::row0(w), kt);
      wgmma_scores<kDqK, HD, kOwn, kDqK>(dp, sdo, C::row0(w), vt);
      wgmma_commit();
    };
    auto issue_dq = [&](int j) {
      const uint8_t* kt = sk + (j % kStages) * LS::kBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqK / 16; ++kk)
        wgmma_rs<C::kCols>(acc, ds[kk], desc_mn<HD, kDqK>(kt, kk, col0));
      wgmma_commit();
    };
    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
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
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
      release(j);
    }
    store_rows<HD, C::kCols>(dq, acc, bh, t, q0, row, tq, col0);
  }
}

// dK/dV. grid (ceil(T / kOwn), BH), 384 threads; maps [BH, T, HD] bf16: K
// and V in kOwn-row boxes, Q and dO in kDkvQ-row boxes; lse and dvec
// [BH, T] f32. The CTA owns key rows k0.. (the first k tile, which has the
// most q tiles, first) and streams the q tiles from its diagonal to T:
// warpgroup w, keys k0 + row0(w).., skips those wholly before its first
// key (releasing their stages) and masks those that reach before its last.
// A stage's 64 lse and D values come by a bulk copy; a tile that reaches
// past T, or a T whose rows do not start 16-byte aligned, has them written
// by the loading thread instead (lse kLsePastT and D 0 past T).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tri_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                               const __grid_constant__ CUtensorMap tma_do,
                               const __grid_constant__ CUtensorMap tma_k,
                               const __grid_constant__ CUtensorMap tma_v,
                               const float* __restrict__ lse, const float* __restrict__ dvec,
                               bf16* __restrict__ dk, bf16* __restrict__ dv, int t,
                               float scale) {
  using C = Cfg<HD>;
  constexpr int kOwn = C::kOwn, kStages = C::kDkvStages;
  using LO = Tile<HD, kOwn>;
  using LS = Tile<HD, kDkvQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + LO::kBytes;
  uint8_t* sq = sv + LO::kBytes;
  uint8_t* sdo = sq + kStages * LS::kBytes;
  float* slse = reinterpret_cast<float*>(sdo + kStages * LS::kBytes);
  float* sd = slse + kStages * kDkvQ;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sd + kStages * kDkvQ);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kOwn;  // the first k tile, the longest, first
  const int n_q = (t - k0 + kDkvQ - 1) / kDkvQ;  // q tiles from the diagonal to T
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
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
        const int s = j % kStages;
        const int q0 = k0 + j * kDkvQ;
        const size_t at = static_cast<size_t>(bh) * t + q0;
        const bool bulk = q0 + kDkvQ <= t && t % 4 == 0;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        if (!bulk)  // before the arrival below, which releases these writes
          for (int i = 0; i < kDkvQ; ++i) {
            slse[s * kDkvQ + i] = q0 + i < t ? lse[at + i] : kLsePastT;
            sd[s * kDkvQ + i] = q0 + i < t ? dvec[at + i] : 0.f;
          }
        mbar_expect_tx(&full[s], 2 * LS::kBytes + (bulk ? 2 * kDkvQ * 4 : 0));
        load_tile<HD, kDkvQ>(sq + s * LS::kBytes, &tma_q, &full[s], q0, bh);
        load_tile<HD, kDkvQ>(sdo + s * LS::kBytes, &tma_do, &full[s], q0, bh);
        if (bulk) {
          bulk_load(slse + s * kDkvQ, lse + at, kDkvQ * 4, &full[s]);
          bulk_load(sd + s * kDkvQ, dvec + at, kDkvQ * 4, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMathRegs));
    const int w = (warp >> 2) - 1;  // 64-row half of the k tile, or column half
    const int row = C::row0(w) + (warp & 3) * 16 + (lane >> 2);  // this thread's first key row
    const int col0 = C::col0(w);
    const int tq = lane & 3;
    // q tiles wholly before the warpgroup's first key: nothing to add
    const int first = min(C::row0(w) / kDkvQ, n_q);
    float s[kDkvQ / 2], dp[kDkvQ / 2];  // S^T and dP^T: m64n{kDkvQ} accumulators
    float acc_dk[C::kCols / 2], acc_dv[C::kCols / 2];  // m64n{kCols} accumulators
    uint32_t pf[kDkvQ / 16][4], dsf[kDkvQ / 16][4];  // P^T, dS^T: k16 A fragments
#pragma unroll
    for (int i = 0; i < C::kCols / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
    };
    auto issue_sdp = [&](int j) {
      const int st = j % kStages;
      mbar_wait(&full[st], (j / kStages) & 1);
      const uint8_t* qt = sq + st * LS::kBytes;
      const uint8_t* dot = sdo + st * LS::kBytes;
      wgmma_fence();
      wgmma_scores<kDkvQ, HD, kOwn, kDkvQ>(s, sk, C::row0(w), qt);
      wgmma_scores<kDkvQ, HD, kOwn, kDkvQ>(dp, sv, C::row0(w), dot);
      wgmma_commit();
    };
    auto issue_dkv = [&](int j) {
      const int st = j % kStages;
      const uint8_t* qt = sq + st * LS::kBytes;
      const uint8_t* dot = sdo + st * LS::kBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk)
        wgmma_rs<C::kCols>(acc_dv, pf[kk], desc_mn<HD, kDkvQ>(dot, kk, col0));
#pragma unroll
      for (int kk = 0; kk < kDkvQ / 16; ++kk)
        wgmma_rs<C::kCols>(acc_dk, dsf[kk], desc_mn<HD, kDkvQ>(qt, kk, col0));
      wgmma_commit();
    };
    auto grads = [&](int j) {  // tiles that start before the warpgroup's last key are masked
      const int st = j % kStages;
      const int rel = row - j * kDkvQ;
      if (j * kDkvQ < C::row0(w) + 64)
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
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
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
    store_rows<HD, C::kCols>(dk, acc_dk, bh, t, k0, row, tq, col0);
    store_rows<HD, C::kCols>(dv, acc_dv, bh, t, k0, row, tq, col0);
  }
}

// --- The sliced route (head dims above 256; flash_wgmma.cuh's wide) -------
//
// D is a multiple of 256. A CTA owns 64 rows and one kWideCols-column slice
// of the output(s): dK and dV as two m64n128 accumulators fit one
// warpgroup's registers beside S, dP and their fragments, as at head dim
// 128. For each streamed tile the warpgroup computes S and dP over all of
// D, chunk by chunk (wide::scores), then P and dS, then the gradient
// products over the slice's columns, read MN-major from the 256-column
// chunk that holds them (a last item of the tile).
constexpr int kWideCols = 128;

// Rows `row` and + 8 of an owned tile (from row0 of bh's slice) of an
// m64n{kWideCols} accumulator, to columns col.. of a [BH, T, d] bf16
// tensor; rows at or past T are not stored.
__device__ __forceinline__ void store_wide(bf16* __restrict__ dst, const float (&acc)[kWideCols / 2],
                                           int bh, int t, int d, int row0, int row, int tq,
                                           int col) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + row + 8 * i;
    if (r >= t) continue;
    bf16* p = dst + (static_cast<size_t>(bh) * t + r) * d + col + 2 * tq;
#pragma unroll
    for (int jj = 0; jj < kWideCols / 8; ++jj)
      *reinterpret_cast<uint32_t*>(p + 8 * jj) =
          pack_bf16(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
  }
}

// dQ. grid (ceil(T / 64) x D / kWideCols, BH), wide::kThreads; maps
// [BH, T, D] bf16 in Tile<256, 64> boxes. The CTA owns q rows q0.. (the
// longest first; a bh's slices next to each other) and streams the k
// tiles up to its diagonal (64-row tiles: the last is the diagonal one).
// Items a k tile: D / 256 (Q, K) chunks, D / 256 (dO, V) chunks, then the
// K chunk that holds the slice.
__global__ void __launch_bounds__(wide::kThreads, 1)
flash_tri_bwd_dq_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                                   const __grid_constant__ CUtensorMap tma_do,
                                   const __grid_constant__ CUtensorMap tma_k,
                                   const __grid_constant__ CUtensorMap tma_v,
                                   const float* __restrict__ lse, const float* __restrict__ dvec,
                                   bf16* __restrict__ dq, int t, int d, float scale) {
  constexpr int R = wide::kRows, C = wide::kChunk;
  extern __shared__ uint8_t smem_raw[];
  const wide::Ring ring = wide::ring_init(smem_raw);
  const int nch = d / C, slices = d / kWideCols;
  const int bh = blockIdx.y, slice = blockIdx.x % slices;
  const int q0 = (gridDim.x / slices - 1 - blockIdx.x / slices) * R;
  const int n_k = q0 / R + 1;
  const int col = slice * kWideCols, col_in = col % C;  // dQ's first column, in its K chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4) {
    if (lane == 0) {
      int i = 0;
      for (int j = 0; j < n_k; ++j) {
        for (int c = 0; c < nch; ++c)
          wide::load_pair(ring, i++, &tma_q, q0, &tma_k, j * R, c * C, bh);
        for (int c = 0; c < nch; ++c)
          wide::load_pair(ring, i++, &tma_do, q0, &tma_v, j * R, c * C, bh);
        wide::load_pair(ring, i++, &tma_k, j * R, nullptr, 0, col - col_in, bh);
      }
    }
    return;
  }
  const int row = warp * 16 + (lane >> 2);  // this thread's first row of the q tile
  const int tq = lane & 3;
  float lse_r[2], dd[2];  // rows past T (padding of the tile) read 0
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = q0 + row + 8 * e;
    const size_t at = static_cast<size_t>(bh) * t + r;
    lse_r[e] = r < t ? lse[at] : 0.f;
    dd[e] = r < t ? dvec[at] : 0.f;
  }
  float s[R / 2], dp[R / 2];   // S and dP: m64n64 accumulators
  float acc[kWideCols / 2];    // dQ's slice: m64n128 accumulator
  uint32_t ds[R / 16][4];      // dS: k16 A fragments
#pragma unroll
  for (int x = 0; x < kWideCols / 2; ++x) acc[x] = 0.f;

  int i = 0;
  for (int j = 0; j < n_k; ++j) {
    wide::scores(ring, i, nch, s);
    wide::scores(ring, i, nch, dp);
    const int rel = q0 + row - j * R;
    if (j == n_k - 1)
      dscores<true, R>(s, dp, lse_r, dd, scale, rel, tq);
    else
      dscores<false, R>(s, dp, lse_r, dd, scale, rel, tq);
    pack_frags<R>(ds, dp);
    const int st = wide::ready(ring, i++);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
      wgmma_rs<kWideCols>(acc, ds[kk], desc_mn<C, R>(ring.a(st), kk, col_in));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    wide::release(ring, st);
  }
  store_wide(dq, acc, bh, t, d, q0, row, tq, col);
}

// dK/dV. grid (ceil(T / 64) x D / kWideCols, BH), wide::kThreads; maps as
// dQ's. The CTA owns key rows k0.. (the first k tile first; a bh's slices
// next to each other) and streams the q tiles from its diagonal to T (the
// first masked). Items a q tile: D / 256 (K, Q) chunks, D / 256 (V, dO)
// chunks, then the Q and dO chunks that hold the slice with the tile's 64
// lse and D values (a bulk copy; written by the loading thread where the
// tile reaches past T or T % 4 != 0: lse kLsePastT and D 0 past T).
__global__ void __launch_bounds__(wide::kThreads, 1)
flash_tri_bwd_dkv_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                                    const __grid_constant__ CUtensorMap tma_do,
                                    const __grid_constant__ CUtensorMap tma_k,
                                    const __grid_constant__ CUtensorMap tma_v,
                                    const float* __restrict__ lse, const float* __restrict__ dvec,
                                    bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int d,
                                    float scale) {
  constexpr int R = wide::kRows, C = wide::kChunk;
  extern __shared__ uint8_t smem_raw[];
  const wide::Ring ring = wide::ring_init(smem_raw);
  const int nch = d / C, slices = d / kWideCols;
  const int bh = blockIdx.y, slice = blockIdx.x % slices;
  const int k0 = blockIdx.x / slices * R;  // the first k tile, the longest, first
  const int n_q = (t - k0 + R - 1) / R;    // q tiles from the diagonal to T
  const int col = slice * kWideCols, col_in = col % C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4) {
    if (lane == 0) {
      int i = 0;
      for (int j = 0; j < n_q; ++j) {
        const int q0 = k0 + j * R;
        for (int c = 0; c < nch; ++c)
          wide::load_pair(ring, i++, &tma_k, k0, &tma_q, q0, c * C, bh);
        for (int c = 0; c < nch; ++c)
          wide::load_pair(ring, i++, &tma_v, k0, &tma_do, q0, c * C, bh);
        const int st = wide::acquire(ring, i++);
        const size_t at = static_cast<size_t>(bh) * t + q0;
        const bool bulk = q0 + R <= t && t % 4 == 0;
        float* sl = ring.lse(st);
        float* sd = ring.dvec(st);
        if (!bulk)  // before the arrival below, which releases these writes
          for (int x = 0; x < R; ++x) {
            sl[x] = q0 + x < t ? lse[at + x] : kLsePastT;
            sd[x] = q0 + x < t ? dvec[at + x] : 0.f;
          }
        mbar_expect_tx(&ring.full[st], 2 * wide::LT::kBytes + (bulk ? 2 * R * 4 : 0));
        load_tile<C, R>(ring.a(st), &tma_q, &ring.full[st], q0, bh, col - col_in);
        load_tile<C, R>(ring.b(st), &tma_do, &ring.full[st], q0, bh, col - col_in);
        if (bulk) {
          bulk_load(sl, lse + at, R * 4, &ring.full[st]);
          bulk_load(sd, dvec + at, R * 4, &ring.full[st]);
        }
      }
    }
    return;
  }
  const int row = warp * 16 + (lane >> 2);  // this thread's first key row of the k tile
  const int tq = lane & 3;
  float s[R / 2], dp[R / 2];  // S^T and dP^T: m64n64 accumulators
  float acc_dk[kWideCols / 2], acc_dv[kWideCols / 2];
  uint32_t pf[R / 16][4], dsf[R / 16][4];  // P^T, dS^T: k16 A fragments
#pragma unroll
  for (int x = 0; x < kWideCols / 2; ++x) acc_dk[x] = acc_dv[x] = 0.f;

  int i = 0;
  for (int j = 0; j < n_q; ++j) {
    wide::scores(ring, i, nch, s);
    wide::scores(ring, i, nch, dp);
    const int st = wide::ready(ring, i++);
    const int rel = row - j * R;
    if (j == 0)
      dscores_t<true, R>(s, dp, ring.lse(st), ring.dvec(st), scale, rel, tq);
    else
      dscores_t<false, R>(s, dp, ring.lse(st), ring.dvec(st), scale, rel, tq);
    pack_frags<R>(pf, s);
    pack_frags<R>(dsf, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
      wgmma_rs<kWideCols>(acc_dv, pf[kk], desc_mn<C, R>(ring.b(st), kk, col_in));
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
      wgmma_rs<kWideCols>(acc_dk, dsf[kk], desc_mn<C, R>(ring.a(st), kk, col_in));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc_dk);
    fence_operands(acc_dv);
    wide::release(ring, st);
  }
  store_wide(dk, acc_dk, bh, t, d, k0, row, tq, col);
  store_wide(dv, acc_dv, bh, t, d, k0, row, tq, col);
}

}  // namespace hop

// The sliced route's bf16 launchers: D a multiple of 256.
cudaError_t wide_maps(CUtensorMap (&maps)[4], const void* q, const void* dout, const void* k,
                      const void* v, int bh, int t, int d) {
  using namespace hop;
  if (encoder() == nullptr) return cudaErrorSharedObjectInitFailed;
  const void* src[4] = {q, dout, k, v};
  for (int x = 0; x < 4; ++x)
    if (!tile_map<wide::kChunk, wide::kRows>(&maps[x], src[x], bh, t, d))
      return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t launch_dq_wide_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* dvec, void* dq, int bh, int t,
                                 int d, float scale, cudaStream_t stream) {
  using namespace hop;
  CUtensorMap maps[4];
  cudaError_t err = wide_maps(maps, q, dout, k, v, bh, t, d);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_tri_bwd_dq_wide_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, wide::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + wide::kRows - 1) / wide::kRows * (d / kWideCols), bh);
  flash_tri_bwd_dq_wide_wgmma_kernel<<<grid, wide::kThreads, wide::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dvec, static_cast<bf16*>(dq), t, d, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv_wide_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* dvec, void* dk, void* dv,
                                  int bh, int t, int d, float scale, cudaStream_t stream) {
  using namespace hop;
  CUtensorMap maps[4];
  cudaError_t err = wide_maps(maps, q, dout, k, v, bh, t, d);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_tri_bwd_dkv_wide_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, wide::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + wide::kRows - 1) / wide::kRows * (d / kWideCols), bh);
  flash_tri_bwd_dkv_wide_wgmma_kernel<<<grid, wide::kThreads, wide::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dvec, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), t, d, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* dvec, void* dq, int bh, int t,
                            float scale, cudaStream_t stream) {
  using namespace hop;
  constexpr int smem = dq_smem<HD>();
  constexpr int kOwn = Cfg<HD>::kOwn;
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
  constexpr int kOwn = Cfg<HD>::kOwn;
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

// The sliced route's: its ring slots stream 64-row tiles, the CTA owns
// 64 rows, no setmaxnreg (0: ptxas's count holds).
cudaError_t bwd_config_wide(int* out) {
  using namespace hop;
  const int v[9] = {wide::kSmem, wide::kSmem, wide::kSlots, wide::kSlots, wide::kRows,
                    wide::kRows, 0,           0,           wide::kRows};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return cudaSuccess;
}

// The bf16 kernels' configuration at head_dim (32, 64, 128 or 256), into
// out[9]: dynamic shared-memory bytes (dQ, dK/dV), streamed stages (dQ,
// dK/dV), streamed tile rows (dQ's k tiles, dK/dV's q tiles), the
// registers per thread after setmaxnreg (loads, arithmetic) and the rows a
// CTA owns. Returns cudaErrorInvalidValue for another head dim.
template <int HD>
cudaError_t bwd_config(int* out) {
  using namespace hop;
  using C = Cfg<HD>;
  const int v[9] = {dq_smem<HD>(), dkv_smem<HD>(), C::kDqStages, C::kDkvStages, kDqK,
                    kDkvQ,         kLoadRegs,      kMathRegs,     C::kOwn};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
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
    case 256:                                                       \
      return (int)LAUNCH##_F32(256);                                \
    case 1032:                                                      \
      return (int)LAUNCH##_WGMMA(32);                               \
    case 1064:                                                      \
      return (int)LAUNCH##_WGMMA(64);                               \
    case 1128:                                                      \
      return (int)LAUNCH##_WGMMA(128);                              \
    case 1256:                                                      \
      return (int)LAUNCH##_WGMMA(256);                              \
    default:                                                        \
      return (int)cudaErrorInvalidValue;                            \
  }

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim 32, 64, 128 or 256, or a
// multiple of 256 above (the sliced route). q/k/v/dout and the outputs
// [bh, t, head_dim]; lse and dvec [bh, t] float32; all contiguous,
// 16-byte aligned, on the current device; t >= 1. Each launches one kernel
// on `stream` and returns cudaGetLastError() (0 on success); neither
// allocates.
int tpumon_flash_tri_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dvec, void* dq, int bh, int t,
                            int head_dim, int dtype, float scale, void* stream) {
  if (bh < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dvec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim > 256 && head_dim % 256 == 0 && (dtype == 0 || dtype == 1))
    return dtype == 0 ? (int)launch_dq_wide_f32(q, k, v, dout, l, d, dq, bh, t, head_dim, scale, s)
                      : (int)launch_dq_wide_wgmma(q, k, v, dout, l, d, dq, bh, t, head_dim, scale,
                                                  s);
#define TPUMON_DQ_F32(HD) launch_dq_f32<HD>(q, k, v, dout, l, d, dq, bh, t, scale, s)
#define TPUMON_DQ_WGMMA(HD) launch_dq_wgmma<HD>(q, k, v, dout, l, d, dq, bh, t, scale, s)
  TPUMON_DISPATCH(TPUMON_DQ);
#undef TPUMON_DQ_F32
#undef TPUMON_DQ_WGMMA
}

int tpumon_flash_tri_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* dvec, void* dk, void* dv, int bh, int t,
                             int head_dim, int dtype, float scale, void* stream) {
  if (bh < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dvec);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim > 256 && head_dim % 256 == 0 && (dtype == 0 || dtype == 1))
    return dtype == 0
               ? (int)launch_dkv_wide_f32(q, k, v, dout, l, d, dk, dv, bh, t, head_dim, scale, s)
               : (int)launch_dkv_wide_wgmma(q, k, v, dout, l, d, dk, dv, bh, t, head_dim, scale,
                                            s);
#define TPUMON_DKV_F32(HD) \
  launch_dkv_f32<HD>(q, k, v, dout, l, d, dk, dv, bh, t, scale, s)
#define TPUMON_DKV_WGMMA(HD) \
  launch_dkv_wgmma<HD>(q, k, v, dout, l, d, dk, dv, bh, t, scale, s)
  TPUMON_DISPATCH(TPUMON_DKV);
#undef TPUMON_DKV_F32
#undef TPUMON_DKV_WGMMA
}

// The bf16 kernels' shared-memory bytes, stages, streamed tile rows,
// registers after setmaxnreg and owned rows at head_dim, into out[9]
// (bwd_config).
int tpumon_flash_bwd_config(int head_dim, int* out) {
  if (head_dim > 256 && head_dim % 256 == 0) return (int)bwd_config_wide(out);
  switch (head_dim) {
    case 32:
      return (int)bwd_config<32>(out);
    case 64:
      return (int)bwd_config<64>(out);
    case 128:
      return (int)bwd_config<128>(out);
    case 256:
      return (int)bwd_config<256>(out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
