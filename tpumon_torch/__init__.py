"""tpumon_torch — the PyTorch/CUDA port of tpumon's workload stack.

``tpumon/`` (JAX, Pallas kernels for the TPU) stays the reference; this
package mirrors its layout path for path so each module's counterpart is
found at the same relative path (``tpumon_torch/loadgen/serving.py`` ↔
``tpumon/loadgen/serving.py``). It imports ``torch`` and never ``jax`` or
``tpumon``: a GPU host need not have either. Pure-Python pieces it needs
from the reference (the Prometheus writer, ``quantiles``, the page
allocator) are copied, not imported.

What is ported so far: the serving engine as the reference builds it by
default — continuous batching over a dense KV cache or a paged KV pool
(whose decode attention runs through a hand-written CUDA kernel for
Hopper, ``tpumon_torch.ops.paged_attention``), fused block decode and
keyed temperature/top-k sampling on JAX's threefry (``tpumon_torch.prng``);
the burns and kernel measurements; and the single-GPU trainer, whose flash schedule runs causal attention
forward and backward through hand-written CUDA kernels
(``tpumon_torch.ops.flash_attention``), with checkpoints the engine serves;
the Mixture-of-Experts model family in both; the induction trainer; and
the workload self-report the monitor reads (``source: workload``).
Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel wrapper runs its plain PyTorch version instead.
"""
