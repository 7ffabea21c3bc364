// Causal flash-attention forward for Hopper (sm_90a), returning out and
// the per-row logsumexp.
//
// Replaces the Pallas TPU kernel tpumon/ops/flash_attention.py::
// flash_attention_tri_fwd (body _flash_tri_kernel): q/k/v [BH, T, D],
// out[i] = softmax(q_i K^T * scale, causal) V in q's type, and
// lse[i] = logsumexp of row i's scaled scores in f32, the residual the
// backward kernels rebuild P from. The TPU kernel walks only the
// lower-triangle (q block, k block) pairs through scalar-prefetched index
// arrays and carries its online-softmax state from pair to pair in VMEM
// scratch, relying on the sequential grid and on "diagonal last" to know
// when a row is complete. Here one CTA owns one (bh, q tile) and loops
// itself over the k tiles at or below its diagonal, so the row is
// complete when the loop ends; no state crosses CTAs.
//
// Bound: at the training shape (BH 128, T 1024, D 128, bf16) the causal
// pairs need 34.4 GFLOP and the inputs and outputs are 134.7 MB, so the
// card's bytes (40 us at 3.35 TB/s) and bf16 tensor-core rate (35 us at
// 989 TFLOP/s) bound it about equally.
//
// What this design does about it: flash_fwd.cuh's bf16 kernel, causal,
// with the logsumexp. Only wgmma reaches the tensor cores' full rate, and
// only if its operands are on chip when it runs: one CTA per (bh, 128-row
// q tile), a warp that keeps TMA loads of the next K and V tiles in
// flight (2-stage rings, mbarriers) while two warpgroups run S = Q K^T
// and P V with wgmma, P fed from registers and V read through the
// descriptor without a transpose. Each warpgroup runs one tile's online
// softmax under its previous tile's P V, and the two take turns issuing
// (ping-pong), so one's softmax also runs under the other's products.
// Each K/V tile is read once per q tile (T/128 times per bh; the grid
// runs a bh's q tiles together, so mostly from L2); Q, the scores, the
// running max and denominator and the output accumulator stay on chip,
// and no tile above the diagonal is touched. The f32 kernel (CUDA cores)
// is the same file's, as is the rectangular forward (flash_attention.cu).
//
// Supported: float32 and bfloat16, head dim 32, 64, 128 or 256, any T >= 1.
// The Python wrapper (tpumon_torch/ops/flash_attention.py) checks
// shapes and types; the launcher re-checks what it indexes by.

#include "flash_fwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out [bh, t, head_dim] and lse
// [bh, t] float32, all contiguous, 16-byte aligned, on the current device;
// t >= 1. Launches on `stream` and returns
// cudaGetLastError() (0 on success); allocates nothing.
int tpumon_flash_tri_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int bh, int t, int head_dim, int dtype, float scale, void* stream) {
  return (int)tpumon::flash::launch_fwd<true>(dtype, head_dim, q, k, v, out,
                                              static_cast<float*>(lse), bh, t, scale,
                                              static_cast<cudaStream_t>(stream));
}

// The bf16 kernel's shared-memory bytes, stages, registers after
// setmaxnreg and k rows a stage at head_dim, into out[5] (flash_fwd.cuh's
// fwd_config).
int tpumon_flash_fwd_config(int head_dim, int* out) {
  return (int)tpumon::flash::fwd_config(head_dim, out);
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
