// Tiles, staging and the register-tiled product shared by the f32 causal
// flash-attention kernels (flash_attention_tri_fwd.cu and
// flash_attention_tri_bwd.cu); the bf16 kernels use flash_tri_mma.cuh.
//
// A CTA of kThreads = 128 threads owns kOwn = 64 rows (query rows in the
// forward and dQ kernels, key rows in the dK/dV kernel) and loops over the
// other side in steps of kStream = 32 rows. Tiles sit in shared memory
// with a row stride of HD + 1 floats: the odd stride puts the rows a warp
// reads at one column into distinct banks.
//
// Thread layout of every product: lane l of warp w has tx = l % 8 and
// ty = 4 w + l / 8. It owns rows ty + 16 r of its 64-row side and columns
// tx + 8 c of the other. The 8 lanes that share a row are consecutive, so
// a row's softmax reduces over a group of 8 lanes (online_softmax.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "online_softmax.cuh"

namespace tpumon {
namespace flash {

constexpr int kThreads = 128;
constexpr int kOwn = 64;     // rows a CTA owns
constexpr int kStream = 32;  // rows streamed per step
constexpr int kRowGroups = 16;
constexpr int kColGroups = 8;
constexpr int kRows = kOwn / kRowGroups;        // owned rows per thread: 4
constexpr int kCols = kStream / kColGroups;     // score columns per thread: 4
constexpr int kLdP = kStream + 1;               // row stride of a [kOwn, kStream] score tile

__device__ __forceinline__ int lane_tx() { return threadIdx.x & 7; }
__device__ __forceinline__ int lane_ty() { return (threadIdx.x >> 5) * 4 + ((threadIdx.x & 31) >> 3); }

// Copy ROWS contiguous rows of HD floats from device memory into shared
// memory with row stride HD + 1, with 16-byte loads.
template <int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src) {
  constexpr int kVecPerRow = HD / 4;
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + (size_t)r * HD + c);
    float* d = dst + r * (HD + 1) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// acc[r][c] += sum over k < K of A(ty + 16 r, k) * B(tx + 8 c, k), where
// A(m, k) = a[m * AM + k * AK] and B(n, k) = b[n * BN + k * BK] index
// shared memory. CUDA-core FMAs in f32.
template <int RM, int CN, int K, int AM, int AK, int BN, int BK>
__device__ __forceinline__ void mma(float (&acc)[RM][CN], const float* a, const float* b) {
  a += lane_ty() * AM;
  b += lane_tx() * BN;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[RM], bv[CN];
#pragma unroll
    for (int r = 0; r < RM; ++r) av[r] = a[r * kRowGroups * AM + k * AK];
#pragma unroll
    for (int c = 0; c < CN; ++c) bv[c] = b[c * kColGroups * BN + k * BK];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int RM, int CN>
__device__ __forceinline__ void zero(float (&acc)[RM][CN]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[r][c] = 0.f;
}

// Write this thread's [kRows, HD / 8] tile of an owned-row output to a
// row-major [*, HD] f32 tensor starting at row `row0`.
template <int HD>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int row0,
                                           const float (&acc)[kRows][HD / kColGroups]) {
  const int ty = lane_ty(), tx = lane_tx();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float* row = dst + (size_t)(row0 + ty + kRowGroups * r) * HD;
#pragma unroll
    for (int c = 0; c < HD / kColGroups; ++c) row[tx + kColGroups * c] = acc[r][c];
  }
}

}  // namespace flash
}  // namespace tpumon
