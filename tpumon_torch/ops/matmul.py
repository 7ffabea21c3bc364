"""Tiled matrix product: the CUDA kernel's wrapper and its plain version.

Counterpart of ``tpumon/ops/matmul.py``, the MXU burn's hot op
(``loadgen.burn._mxu_burn_program(use_kernel=True)``). ``matmul(a, b)``
computes C[M, N] = A[M, K] @ B[K, N] with f32 accumulation, returned in
a's dtype (float32 or bfloat16). It keeps the reference's contract: M, N
and K must divide ``block_m``, ``block_n`` and ``block_k``, anything else
raises ``ValueError``. The blocks only set what is admitted: the kernel
(``csrc/matmul.cu``) tiles the product its own way (bf16: a persistent
grid of 128 x 256 output tiles, ``wgmma`` over a TMA-fed ring of 64-deep
K stages, the ragged M, N and K edges zero-filled by TMA; C allocated in
whole 128-row tiles and its first M rows returned, columns past N clipped
at store; f32: 128 x 128 tiles on CUDA cores, edges masked), so any shape
the blocks admit runs. TMA needs row strides that are multiples of 16
bytes: where a bf16 K or N is not a multiple of 8 (int8 Q: N of 16),
``padded_operands`` zero-pads the operands to the next such shape, the
same kernel runs there and C is sliced back (counted in
``matmul.padded``).

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
TMA_ALIGN = 8  # bf16 K and N multiples of it (16 bytes); int8 Q's N: 16
TILE_M = 128  # the bf16 kernel stores whole tiles of this many rows


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


def padded_operands(a: torch.Tensor, b: torch.Tensor, scale=None):
    """(a, b, scale) as the bf16 kernel takes them: K zero-padded to a
    multiple of TMA_ALIGN (a's columns, b's rows) and N to a multiple of
    TMA_ALIGN, or 16 for int8 b (b's columns, scale's entries), with
    nothing copied where the shape already is one. Zero rows and columns
    add exact zeros, so C's first N columns are the product's."""
    (_, k), n = a.shape, b.shape[1]
    align_n = 16 if b.dtype == torch.int8 else TMA_ALIGN
    pk, pn = -k % TMA_ALIGN, -n % align_n
    if a.dtype != torch.bfloat16 or not (pk or pn):
        return a, b, scale
    matmul.padded += 1
    a = torch.nn.functional.pad(a, (0, pk))
    b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    if scale is not None:
        scale = torch.nn.functional.pad(scale, (0, pn))
    return a, b, scale


def output(a: torch.Tensor, n: int) -> torch.Tensor:
    """C for the kernels: [M, N] in a's dtype, with M rounded up to
    TILE_M rows for the bf16 kernel, which stores whole tiles; the caller
    takes the first M rows (a contiguous view)."""
    m = a.shape[0]
    rows = -(-m // TILE_M) * TILE_M if a.dtype == torch.bfloat16 else m
    return torch.empty(rows, n, dtype=a.dtype, device=a.device)


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
    a, b, _ = padded_operands(a, b)
    c = output(a, b.shape[1])
    launch("tpumon_matmul", (a, b, c))
    matmul.launches += 1
    return c[:m] if c.shape[1] == n else c[:m, :n].contiguous()


matmul.launches = 0
matmul.padded = 0  # calls (either kernel) that went through padded_operands
