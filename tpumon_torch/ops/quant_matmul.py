"""Int8 weight-only matrix product: the CUDA kernel's wrapper, its plain
version and the reference's fallback.

Counterpart of ``tpumon/ops/quant_matmul.py``. C[M, N] = A[M, K] @
(Q[K, N] * scale[N]): A is float32 or bfloat16, Q int8 and scale a float
per output column. The kernel (``csrc/matmul.cu``) reads Q at 1 byte per
weight, widens it to A's type on chip (exact for every int8) and applies
the scale once, to each column's f32 accumulator at store; C is in A's
type. Like the reference kernel it multiplies in A's type: bf16 A on
tensor cores (``wgmma``; Q's stages come by TMA and are widened in shared
memory), f32 A on CUDA cores.

The reference's ``quantized_matmul_pallas`` is named
``quantized_matmul_kernel`` here. It keeps the reference's contract (the
shapes divide the blocks, else ``ValueError``); on a CUDA tensor it
launches the kernel and counts the launch in
``quantized_matmul_kernel.launches``, on a CPU tensor it runs
``quantized_matmul_reference``, the plain version. ``quantized_matmul``
keeps the reference's fallback for shapes that do not tile (decode-sized
M): ``a @ (q.to(a.dtype) * scale.to(a.dtype))`` in plain torch, which is
the reference's own semantics there and launches no kernel.
"""

from __future__ import annotations

import torch

from tpumon_torch.ops.matmul import (
    check_blocks,
    check_operands,
    launch,
    on_cuda,
    output,
    padded_operands,
)


def _check(a, q, scale) -> None:
    check_operands(a, q, torch.int8)
    if scale.shape != (q.shape[1],) or not scale.is_floating_point():
        raise ValueError(f"scale must be a float [N={q.shape[1]}]; got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if scale.device != a.device:
        raise ValueError("scale must lie on a's device")


def quantized_matmul_reference(a: torch.Tensor, q: torch.Tensor,
                               scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: f32 product of a and the widened q,
    scaled per column once, returned in a's dtype."""
    return ((a.float() @ q.float()) * scale.float()).to(a.dtype)


def quantized_matmul_kernel(a: torch.Tensor, q: torch.Tensor,
                            scale: torch.Tensor, block_m: int = 1024,
                            block_n: int = 1024,
                            block_k: int = 512) -> torch.Tensor:
    """A[M,K] @ dequant(Q[K,N], scale[N]); the shapes must divide the
    blocks."""
    _check(a, q, scale)
    (m, k), n = a.shape, q.shape[1]
    check_blocks(m, k, n, block_m, block_n, block_k)
    scale = scale.to(torch.float32).contiguous()  # the kernel's scale type
    if not on_cuda(a, q, scale):
        return quantized_matmul_reference(a, q, scale)
    a, q, scale = padded_operands(a, q, scale)
    c = output(a, q.shape[1])
    launch("tpumon_quantized_matmul", (a, q, scale, c))
    quantized_matmul_kernel.launches += 1
    return c[:m] if c.shape[1] == n else c[:m, :n].contiguous()


quantized_matmul_kernel.launches = 0


def quantized_matmul(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     block_m: int = 1024, block_n: int = 1024,
                     block_k: int = 512) -> torch.Tensor:
    """The kernel when the shapes tile the blocks, the reference's plain
    dequantized product otherwise."""
    _check(a, q, scale)
    (m, k), n = a.shape, q.shape[1]
    if m % block_m == 0 and n % block_n == 0 and k % block_k == 0:
        return quantized_matmul_kernel(a, q, scale, block_m=block_m,
                                       block_n=block_n, block_k=block_k)
    return a @ (q.to(a.dtype) * scale.to(a.dtype))
