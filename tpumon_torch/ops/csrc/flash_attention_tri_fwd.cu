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
// when a row is complete. Here one CTA owns one (bh, 64-row q tile) and
// loops itself over the k tiles at or below its diagonal, so the row is
// complete when the loop ends; no state crosses CTAs.
//
// Bound: at the training shape (BH 128, T 1024, D 128, bf16) the causal
// pairs need 34.4 GFLOP and the inputs and outputs are 134.7 MB, so the
// card's bytes (40 us at 3.35 TB/s) and bf16 tensor-core rate (35 us at
// 989 TFLOP/s) bound it about equally.
//
// What this design does about it: it reads each K/V tile once per q tile
// (T/64 times per bh, from L2 mostly), keeps Q, the scores, the running
// max/denominator and the output accumulator on chip, and touches no
// tile above the diagonal. The kernels (bf16 on tensor cores, f32 on CUDA
// cores) are flash_fwd.cuh's, instantiated causal with the logsumexp; the
// rectangular forward (flash_attention.cu) shares them.
//
// Supported: float32 and bfloat16, head dim 32, 64 or 128, T a multiple
// of 64. The Python wrapper (tpumon_torch/ops/flash_attention.py) checks
// shapes and types; the launcher re-checks what it indexes by.

#include "flash_fwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/k/v/out [bh, t, head_dim] and lse
// [bh, t] float32, all contiguous, 16-byte aligned, on the current device;
// t a positive multiple of 64. Launches on `stream` and returns
// cudaGetLastError() (0 on success); allocates nothing.
int tpumon_flash_tri_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int bh, int t, int head_dim, int dtype, float scale, void* stream) {
  return (int)tpumon::flash::launch_fwd<true>(dtype, head_dim, q, k, v, out,
                                              static_cast<float*>(lse), bh, t, scale,
                                              static_cast<cudaStream_t>(stream));
}

const char* tpumon_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
