// Flash-attention forward for Hopper (sm_90a), causal or not.
//
// Replaces the Pallas TPU kernel tpumon/ops/flash_attention.py::
// flash_attention (body _flash_kernel): q/k/v [BH, T, D], out[i] =
// softmax(q_i K^T * scale) V in q's type, with or without the causal mask;
// a row whose softmax denominator is 0 returns zeros. The TPU kernel walks
// a rectangular (BH, T/block_q, T/block_k) grid with K innermost, carries
// its online-softmax state across the K steps in VMEM scratch, and skips
// the compute (not the DMA) of k blocks above the diagonal. Here one CTA
// owns one (bh, q tile) and loops itself over the k tiles: all of
// them without the mask, only those at or below its diagonal with it, so
// those above the diagonal are neither computed nor read.
//
// Bound: at the training shape (BH 128, T 1024, D 128, bf16) the inputs
// and output are 134.2 MB (40 us at 3.35 TB/s); the products are 68.7
// GFLOP without the mask (69 us at 989 TFLOP/s bf16) and 34.4 GFLOP with
// it (35 us), so operations bound the non-causal call and bytes the
// causal one.
//
// What this design does about it: the kernels of the triangle forward
// (flash_fwd.cuh), instantiated for either mask and without the
// logsumexp. The bf16 kernel keeps the tensor cores fed: TMA brings the
// next K and V tiles into 2-stage rings while two warpgroups run S = Q
// K^T and P V with wgmma (P from registers, V read MN-major through the
// descriptor), in turns (ping-pong), each overlapping one tile's
// softmax with its previous tile's P V and with the other's products. Q, the scores, the running max and denominator and the
// accumulator stay on chip, and each K/V tile is read once per 128-row q
// tile. Without the mask the keys past T of a last tile that reaches past
// it (T = 64 x odd) are masked; TMA zero-fills them within each bh.
//
// Supported: float32 and bfloat16, head dim 32, 64 or 128, T a multiple
// of 64. The Python wrapper (tpumon_torch/ops/flash_attention.py) checks
// shapes and types; the launcher re-checks what it indexes by.

#include "flash_fwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; causal: 0 or 1. q/k/v/out [bh, t,
// head_dim], contiguous, 16-byte aligned, on the current device; t a
// positive multiple of 64. Launches on `stream` and returns
// cudaGetLastError() (0 on success); allocates nothing.
int tpumon_flash_fwd(const void* q, const void* k, const void* v, void* out, int bh, int t,
                     int head_dim, int dtype, int causal, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return causal ? (int)tpumon::flash::launch_fwd<true>(dtype, head_dim, q, k, v, out, nullptr,
                                                       bh, t, scale, s)
                : (int)tpumon::flash::launch_fwd<false>(dtype, head_dim, q, k, v, out, nullptr,
                                                        bh, t, scale, s);
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
