"""jax.random's Threefry draws, fused: the CUDA kernels' wrappers and their
plain versions.

The keyed sampler (``loadgen.serving.sample_tokens``) and the burns'
inputs (``loadgen.burn``) draw as the reference does, from threefry keys.
The plain versions are ``tpumon_torch.prng``'s torch functions, which the
CPU tests hold to ``jax.random`` bit for bit; in eager torch a normal
draw is ~200 elementwise launches over int64 words, and the sampler's
keys and Gumbel draw ~670. ``csrc/threefry.cu`` computes each draw in one
pass (one thread an element, the result written once) and gives the same
bits:

- ``threefry_keys``: ``fold_in`` and ``split``;
- ``threefry_draw``: ``random_bits``, ``uniform``, ``normal``,
  ``gumbel`` and ``randint`` (``randint`` after a ``split``);
- ``threefry_categorical``: ``categorical``, one CTA a row.

``permutation`` is ``split``, ``random_bits`` and a stable sort, as the
plain version. Keys are int64 tensors ``[..., 2]`` of uint32 words. On a
CUDA tensor a function launches the kernel and counts the launch in its
launcher's ``launches``; on a CPU tensor it runs the plain version; any
other device raises. Nothing reads back to the host.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpumon_torch import prng
from tpumon_torch.ops import _build

_BITS, _UNIFORM, _NORMAL, _GUMBEL, _RANDINT = range(5)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
           torch.int16: 3, torch.int32: 4, torch.int64: 5}
_VOID, _LL, _INT, _FLOAT, _UINT = (ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_float,
                                   ctypes.c_uint)


def _on_cuda(k: torch.Tensor) -> bool:
    """False for a CPU key (the plain version runs), True for a CUDA key
    the kernels take; raises for a malformed key or another device."""
    if k.dtype != torch.int64 or k.dim() < 1 or k.shape[-1] != 2:
        raise ValueError(f"a key is int64 [..., 2]; got {k.dtype} "
                         f"{tuple(k.shape)}")
    if k.device.type == "cpu":
        return False
    if k.device.type != "cuda":
        raise ValueError(f"threefry runs on cpu or cuda, not {k.device}")
    return True


def _call(symbol: str, argtypes: list, args: list, dev) -> None:
    """Launch ``symbol`` of ``csrc/threefry.cu`` on ``dev``'s current
    stream (appended as its last argument)."""
    lib = _build.load("threefry")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, _VOID]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, f"{symbol} launch")


def threefry_keys(keys: torch.Tensor, n: int, data=None,
                  broadcast: bool = False) -> torch.Tensor:
    """Keys [rows, n, 2] from ``keys`` [rows, 2] (``broadcast``: one key
    [2] for every row, rows then set by ``data``): split's counters 0 ..
    n - 1 when ``data`` is None, else fold_in's (0, data mod 2**32) with
    ``data`` an int or an int32/int64 tensor of rows * n elements."""
    if torch.is_tensor(data):
        kind = 1 if data.dtype == torch.int32 else 2
        ptr, scalar, rows = data.data_ptr(), 0, data.numel() // n
    else:
        kind = 0 if data is None else 3
        ptr, scalar, rows = None, int(data or 0), keys.shape[0]
    out = torch.empty(rows, n, 2, dtype=torch.int64, device=keys.device)
    if rows * n:
        _call("tpumon_threefry_keys",
              [_VOID, _LL, _VOID, _INT, _LL, _LL, _LL, _VOID],
              [keys.data_ptr(), 0 if broadcast else 2, ptr, kind,
               scalar & 0xFFFFFFFF, rows, n, out.data_ptr()], keys.device)
        threefry_keys.launches += 1
    return out


threefry_keys.launches = 0


def threefry_draw(keys: torch.Tensor, n: int, kind: int,
                  dtype: torch.dtype, lo: float = 0.0, scale: float = 1.0,
                  mul: float = 1.0, mask: int = 0, span: int = 0,
                  mult: int = 0, ilo: int = 0) -> torch.Tensor:
    """``n`` elements of ``dtype`` under each of ``keys`` [rows, 2]
    ([rows, 2, 2] for randint): out [rows, n]. The constants are the
    plain version's, computed on the host (see the callers)."""
    rows = keys.shape[0]
    out = torch.empty(rows, n, dtype=dtype, device=keys.device)
    if rows * n:
        _call("tpumon_threefry_draw",
              [_VOID, _LL, _LL, _INT, _INT, _FLOAT, _FLOAT, _FLOAT, _UINT,
               _UINT, _UINT, _UINT, _VOID],
              [keys.data_ptr(), rows, n, kind, _DTYPES[dtype], lo, scale,
               mul, mask, span, mult, ilo & 0xFFFFFFFF, out.data_ptr()],
              keys.device)
        threefry_draw.launches += 1
    return out


threefry_draw.launches = 0


def threefry_categorical(keys: torch.Tensor,
                         logits: torch.Tensor) -> torch.Tensor:
    """Per row of float32 ``logits`` [rows, V] under ``keys`` [rows, 2]:
    the first index of the largest gumbel + logit, int64 [rows]."""
    rows, v = logits.shape
    out = torch.empty(rows, dtype=torch.int64, device=keys.device)
    if rows * v:
        lo, scale = prng.uniform_consts(torch.finfo(torch.float32).tiny,
                                        1.0, torch.float32)
        _call("tpumon_threefry_categorical",
              [_VOID, _VOID, _LL, _LL, _FLOAT, _FLOAT, _VOID],
              [keys.data_ptr(), logits.data_ptr(), rows, v, lo, scale,
               out.data_ptr()], keys.device)
        threefry_categorical.launches += 1
    return out


threefry_categorical.launches = 0


def launch_counts() -> dict:
    """The three launchers' counts, by name."""
    return {f.__name__: f.launches for f in (threefry_keys, threefry_draw,
                                             threefry_categorical)}


def set_launch_counts(value: int = 0) -> None:
    for f in (threefry_keys, threefry_draw, threefry_categorical):
        f.launches = value


def _broadcast(a, b) -> tuple:
    """The broadcast of two shapes. (``torch.broadcast_shapes`` imports
    sympy on its first call, which took seconds of the first sampled
    token on the card.)"""
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + tuple(a), (1,) * (n - len(b)) + tuple(b)
    if any(x != y and 1 not in (x, y) for x, y in zip(a, b)):
        raise ValueError(f"shapes {a} and {b} do not broadcast")
    return tuple(y if x == 1 else x for x, y in zip(a, b))


def _rows(k: torch.Tensor) -> torch.Tensor:
    return k.reshape(-1, 2).contiguous()


def _float_draw(k, shape, kind, dtype, minval, maxval, mul=1.0):
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"draws float32 or bfloat16, not {dtype}")
    shape = tuple(shape)
    lo, scale = prng.uniform_consts(minval, maxval, dtype)
    out = threefry_draw(_rows(k), math.prod(shape), kind, dtype, lo, scale,
                        mul)
    return out.reshape(*k.shape[:-1], *shape)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``prng.torch_fold_in``: one key per element of ``data`` (an int, or
    an integer tensor broadcasting with ``k[..., 0]``)."""
    if not _on_cuda(k):
        return prng.torch_fold_in(k, data)
    if not torch.is_tensor(data):
        return threefry_keys(_rows(k), 1, int(data)).reshape(k.shape)
    if data.device != k.device:
        raise ValueError("the key and the data must share one device")
    shape = _broadcast(k.shape[:-1], data.shape)
    if data.dtype not in (torch.int32, torch.int64):
        data = data.long()
    data = data.expand(shape).contiguous()
    if k.dim() == 1:  # one key for every element: no copy of it
        out = threefry_keys(k.contiguous(), 1, data, broadcast=True)
    else:
        out = threefry_keys(_rows(k.expand(*shape, 2)), 1, data)
    return out.reshape(*shape, 2)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``prng.torch_split``: [..., n, 2]."""
    if not _on_cuda(k):
        return prng.torch_split(k, n)
    return threefry_keys(_rows(k), n).reshape(*k.shape[:-1], n, 2)


def random_bits(k: torch.Tensor, shape, width: int = 32) -> torch.Tensor:
    """``prng.torch_random_bits``: int64 [..., *shape]."""
    if not _on_cuda(k):
        return prng.torch_random_bits(k, shape, width)
    shape = tuple(shape)
    out = threefry_draw(_rows(k), math.prod(shape), _BITS, torch.int64,
                        mask=(1 << width) - 1)
    return out.reshape(*k.shape[:-1], *shape)


def randint(k: torch.Tensor, shape, lo: int, hi: int,
            dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``prng.torch_randint``: int8, int16, int32 or int64 on the card."""
    if not _on_cuda(k):
        return prng.torch_randint(k, shape, lo, hi, dtype)
    if dtype not in (torch.int8, torch.int16, torch.int32, torch.int64):
        raise ValueError(f"randint draws int8 .. int64 on the card, not "
                         f"{dtype}")
    lo, span, mult = prng.randint_consts(lo, hi, dtype)
    shape = tuple(shape)
    keys = threefry_keys(_rows(k), 2)  # split(k, 2) [rows, 2, 2]
    out = threefry_draw(keys, math.prod(shape), _RANDINT, dtype, span=span,
                        mult=mult, ilo=lo)
    return out.reshape(*k.shape[:-1], *shape)


def uniform(k: torch.Tensor, shape, dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``prng.uniform``."""
    if not _on_cuda(k):
        return prng.uniform(k, shape, dtype, minval, maxval)
    return _float_draw(k, shape, _UNIFORM, dtype, minval, maxval)


def normal(k: torch.Tensor, shape,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``prng.normal``: sqrt(2) * XLA's erf_inv of a uniform on (-1, 1)."""
    if not _on_cuda(k):
        return prng.normal(k, shape, dtype)
    return _float_draw(k, shape, _NORMAL, dtype, prng.normal_lo(dtype), 1.0,
                       prng._as(math.sqrt(2.0), dtype))


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """``prng.gumbel``: float32."""
    if not _on_cuda(k):
        return prng.gumbel(k, shape)
    return _float_draw(k, shape, _GUMBEL, torch.float32,
                       torch.finfo(torch.float32).tiny, 1.0)


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``prng.categorical``: int64 [...], one key [..., 2] per row of
    ``logits`` [..., V] (taken in float32, as the plain sum takes them)."""
    if not _on_cuda(k):
        return prng.categorical(k, logits)
    if logits.device != k.device:
        raise ValueError("the key and the logits must share one device")
    lead = _broadcast(k.shape[:-1], logits.shape[:-1])
    v = logits.shape[-1]
    out = threefry_categorical(
        _rows(k.expand(*lead, 2)),
        logits.float().expand(*lead, v).reshape(-1, v).contiguous())
    return out.reshape(lead)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``prng.permutation``: 0..n-1 stably sorted by 32-bit keys, in as
    many rounds as jax takes at n."""
    if not _on_cuda(k):
        return prng.permutation(k, n)
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1))
    for _ in range(rounds):
        k, sub = split(k, 2).unbind(0)
        x = x[torch.sort(random_bits(sub, (n,)), stable=True).indices]
    return x
