// Online-softmax numerics shared by the port's attention kernels.
//
// Counterpart of tpumon/ops/flash_attention.py::online_softmax_update,
// the update the reference's flash and paged Pallas kernels share: a
// running max m, a running denominator l and an f32 accumulator per
// query row, rescaled by alpha = exp(m_old - m_new) whenever a new block
// of scores raises the max. Masked scores are a large negative number
// (kNegInf, the reference's _NEG_INF), so exp() underflows them to 0.
//
// Two layouts: online_softmax_update takes one query row's block of
// scores one per lane across a warp (a block of 32 keys, the paged
// kernel); online_softmax_update_row takes a row spread over a group of
// lanes, several scores per lane (the flash kernels). The lanes reduce max
// and sum with shuffles; every lane of the row ends with the same m and l.
#pragma once

#include <cuda_runtime.h>

namespace tpumon {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One block update for the query row this warp owns. s is this lane's
// (scaled, masked) score; m and l are the row's running max and
// denominator, updated in place. Returns this lane's unnormalised
// probability exp(s - m_new); alpha receives exp(m_old - m_new), the
// factor the caller applies to the row's accumulator before adding
// p @ V. The block must hold at least one unmasked score, so m_new is a
// real score and masked lanes get p == 0. Warp-collective: call it from
// all 32 lanes.
__device__ __forceinline__ float online_softmax_update(float s, float& m, float& l,
                                                       float& alpha) {
  const float m_new = fmaxf(m, warp_max(s));
  const float p = expf(s - m_new);
  alpha = expf(m - m_new);
  l = l * alpha + warp_sum(p);
  m = m_new;
  return p;
}

// Max and sum over a group of W consecutive lanes (W a power of two that
// divides 32); every lane of the group ends with the group's result.
template <int W>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The same update for a query row whose block of scores is spread N per
// lane over a group of W consecutive lanes (the flash kernels' layout).
// s holds this lane's (scaled, masked) scores and is overwritten with its
// unnormalised probabilities exp(s - m_new); m and l are updated in
// place; the return value is alpha = exp(m_old - m_new). The same rule
// as above: the block must hold an unmasked score for the row, or m must
// already be a real score. Warp-collective.
template <int W, int N>
__device__ __forceinline__ float online_softmax_update_row(float (&s)[N], float& m, float& l) {
  float mx = s[0];
#pragma unroll
  for (int i = 1; i < N; ++i) mx = fmaxf(mx, s[i]);
  const float m_new = fmaxf(m, group_max<W>(mx));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = expf(s[i] - m_new);
    sum += s[i];
  }
  const float alpha = expf(m - m_new);
  l = l * alpha + group_sum<W>(sum);
  m = m_new;
  return alpha;
}

}  // namespace tpumon
