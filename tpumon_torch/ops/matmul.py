"""Tiled matrix product: the CUDA kernel's wrapper and its plain version.

Counterpart of ``tpumon/ops/matmul.py``, the MXU burn's hot op
(``loadgen.burn._mxu_burn_program(use_kernel=True)``). ``matmul(a, b)``
computes C[M, N] = A[M, K] @ B[K, N] with f32 accumulation, returned in
a's dtype (float32 or bfloat16). It keeps the reference's contract: M, N
and K must divide ``block_m``, ``block_n`` and ``block_k``, anything else
raises ``ValueError``. The blocks only set what is admitted: the kernel
(``csrc/matmul.cu``) tiles the product its own way (bf16: a persistent
grid of 128 x 256 output tiles, ``wgmma`` over a TMA-fed ring of 64-deep
K stages, ragged N and K edges zero-filled by TMA; f32: 128 x 128 tiles
on CUDA cores), so on a CUDA tensor M and N must also be multiples of 128
and K of 32.

On a CUDA tensor the wrapper launches the kernel and counts the launch in
``matmul.launches``; on a CPU tensor it runs ``matmul_reference``, the
plain version; any other device raises. ``csrc/matmul.cu`` also holds the
int8 weight-only product (``quant_matmul.py``), launched through the same
helpers.
"""

from __future__ import annotations

import ctypes

import torch

from tpumon_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_TILE = 128  # M and N multiples of it
KERNEL_DEPTH = 32  # K a multiple of it


def check_blocks(m: int, k: int, n: int, block_m: int, block_n: int,
                 block_k: int) -> None:
    """The reference's contract: the shapes divide the blocks."""
    if min(block_m, block_n, block_k) < 1 or (
            m % block_m or n % block_n or k % block_k):
        raise ValueError(
            f"shapes {(m, k, n)} must divide blocks "
            f"{(block_m, block_k, block_n)}")


def check_operands(a: torch.Tensor, b: torch.Tensor, b_dtype) -> None:
    """a [M, K] float32/bfloat16 and b [K, N] of ``b_dtype`` on one
    device; raises ValueError."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need a [M, K] and b [K, N]; got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype not in _DTYPES:
        raise ValueError(f"a must be float32 or bfloat16, not {a.dtype}")
    if b.dtype != b_dtype:
        raise ValueError(f"b must be {b_dtype}, not {b.dtype}")
    if a.device != b.device:
        raise ValueError("the operands must share one device")


def on_cuda(*tensors) -> bool:
    """False for CPU tensors (the plain versions run); True for CUDA
    tensors the kernel takes; raises for anything else."""
    a, b = tensors[:2]
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on cpu or cuda, not {a.device}")
    (m, k), n = a.shape, b.shape[1]
    if m % KERNEL_TILE or n % KERNEL_TILE or k % KERNEL_DEPTH:
        raise ValueError(
            f"the CUDA kernel takes M and N multiples of {KERNEL_TILE} and K "
            f"a multiple of {KERNEL_DEPTH}; got {(m, k, n)}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the CUDA kernel takes contiguous tensors only")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("the CUDA kernel needs 16-byte aligned tensors")
    return True


def launch(symbol: str, tensors) -> None:
    """Launch ``symbol`` of ``csrc/matmul.cu`` on ``tensors`` (a first, the
    output c last): its C signature is their pointers, then m, n, k, a's
    dtype code and the stream."""
    lib = _build.load("matmul")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    a, c = tensors[0], tensors[-1]
    (m, k), n = a.shape, c.shape[1]
    with torch.cuda.device(a.device):
        err = fn(*(x.data_ptr() for x in tensors), m, n, k, _DTYPES[a.dtype],
                 torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, err, f"{symbol} launch")


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the product in f32, returned in a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor, block_m: int = 1024,
           block_n: int = 1024, block_k: int = 512) -> torch.Tensor:
    """C = A @ B in a's dtype; a and b share a dtype and the shapes must
    divide the blocks."""
    check_operands(a, b, a.dtype)
    (m, k), n = a.shape, b.shape[1]
    check_blocks(m, k, n, block_m, block_n, block_k)
    if not on_cuda(a, b):
        return matmul_reference(a, b)
    c = torch.empty(m, n, dtype=a.dtype, device=a.device)
    launch("tpumon_matmul", (a, b, c))
    matmul.launches += 1
    return c


matmul.launches = 0
