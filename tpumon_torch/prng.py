"""The port's own copy of the part of ``jax.random`` that it needs.

Reproduces, bit for bit, ``jax.random`` under
``jax_default_prng_impl=threefry2x32`` and
``jax_threefry_partitionable=True`` (both checked on jax 0.9.0): a key is
two ``uint32`` words, every draw is Threefry-2x32 (20 rounds, rotations
13, 15, 26, 6 / 17, 29, 16, 24) of the key over a 64-bit counter split
into (hi, lo) words. Implemented in ``numpy.uint32``, whose arithmetic
wraps mod 2**32 as the reference's does; no import of ``jax``.

- ``key(seed)``: ``PRNGKey``; a Python int seed is taken as int64 and
  cast to int32 as jax does with 64-bit types off, so the key is
  (0, seed mod 2**32).
- ``fold_in(key, data)``: Threefry of the key over the counter (0, data).
- ``split(key, n)``: key i is Threefry of the key over the counter
  (hi(i), lo(i)), the same as ``fold_in(key, i)``.
- ``random_bits(key, shape)``: 32-bit draws, the XOR of Threefry's two
  output words over the flat index of each element.
- ``randint(key, shape, lo, hi)``: two draws from ``split(key, 2)`` joined
  by jax's two-draw modulus: ((h mod s) * m + (l mod s)) mod s, every
  product and sum mod 2**32, with s = hi - lo and m = (2**16 mod s)**2
  mod 2**32 mod s (so m = 0 for every s above 2**16).

The same construction on torch tensors follows: ``torch_key``,
``torch_fold_in``, ``torch_split``, ``torch_random_bits`` and
``torch_randint``, with jax's ``uniform``, ``gumbel``, ``categorical``,
``normal`` and ``permutation`` on top. A key is an int64 tensor
``[..., 2]`` of uint32 words on the caller's device; no draw reads
anything back to the host. These are the plain versions of the fused
draws in ``tpumon_torch.ops.threefry`` (one CUDA launch a draw), which
the keyed sampler and the burns call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of keys (k0, k1) over counters (x0, x1); all
    ``uint32`` arrays that broadcast together."""
    k0, k1 = np.asarray(k0, np.uint32), np.asarray(k1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):  # numpy scalars warn where arrays wrap
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: uint32 [hi, lo]."""
    lo = np.int64(seed).astype(np.int32).view(np.uint32)
    return np.array([0, lo], np.uint32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The (hi, lo) words of 0 .. n - 1."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``."""
    y0, y1 = threefry2x32(k[0], k[1], np.uint32(0),
                          np.uint32(int(data) & 0xFFFFFFFF))
    return np.array([y0, y1], np.uint32)


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)``: uint32 [n, 2]."""
    return np.stack(threefry2x32(k[0], k[1], *_counters(n)), axis=1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(k, shape)`` (32-bit): uint32 of ``shape``. ``k``
    may also be [..., 2], a stack of keys, each drawing ``shape``."""
    shape = tuple(shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    k = np.asarray(k, np.uint32)
    lead = k.shape[:-1]
    k0, k1 = (k[..., j].reshape(*lead, 1) for j in (0, 1))
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return (y0 ^ y1).reshape(*lead, *shape)


def randint(k: np.ndarray, shape, lo: int, hi: int) -> np.ndarray:
    """``jax.random.randint(k, shape, lo, hi, jnp.int32)`` for int32 bounds
    with lo < hi: int32 of ``shape``."""
    if not -2**31 <= lo < hi <= 2**31 - 1:
        raise ValueError(f"need int32 bounds lo < hi; got {lo}, {hi}")
    higher, lower = random_bits(split(k, 2), shape)
    span = np.uint32(hi - lo)
    mult = np.uint32((2**16 % int(span)) ** 2 % 2**32 % int(span))
    off = ((higher % span) * mult + lower % span) % span
    return (off + np.uint32(lo & 0xFFFFFFFF)).view(np.int32)


# ---------------------------------------------------------------------------
# The same draws on device tensors. torch has no full uint32 arithmetic, so
# the words ride in int64 and are masked to 32 bits after every add and
# shift; an int64 right shift of a non-negative word is a logical one.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def torch_threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """``threefry2x32`` on int64 tensors (or ints) holding uint32 words,
    broadcasting together."""
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def torch_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 [2] tensor on ``device``
    (named by the caller: the draws run where their key lies)."""
    return torch.tensor(key(seed).astype(np.int64), device=device)


def torch_fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``; ``data`` an int or an integer
    tensor (each element taken mod 2**32, as jax takes it) that
    broadcasts with ``k[..., 0]``: one key per element."""
    if torch.is_tensor(data):
        data = data.long() & _M32
    else:
        data = int(data) & _M32
    y0, y1 = torch_threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def torch_split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(k, n)``: [..., n, 2]."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = torch_threefry2x32(k[..., 0, None], k[..., 1, None],
                                i >> 32, i & _M32)
    return torch.stack((y0, y1), dim=-1)


def torch_random_bits(k: torch.Tensor, shape, width: int = 32
                      ) -> torch.Tensor:
    """``jax.random.bits`` of ``width`` (8, 16 or 32) bits as int64 of
    [..., *shape] for keys [..., 2]: the low ``width`` bits of the XOR of
    Threefry's two words over each element's flat index."""
    shape = tuple(shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    y0, y1 = torch_threefry2x32(k[..., 0, None], k[..., 1, None],
                                i >> 32, i & _M32)
    return ((y0 ^ y1) & ((1 << width) - 1)).reshape(*k.shape[:-1], *shape)


def randint_consts(lo: int, hi: int,
                   dtype: torch.dtype) -> tuple[int, int, int]:
    """``randint``'s (lo, span, multiplier) for ``dtype``: a narrower
    integer type is drawn at int32 between bounds clipped to the type
    (``hi`` to its maximum + 1), as jax draws it."""
    if dtype != torch.int32:
        info = torch.iinfo(dtype)
        lo = min(max(lo, info.min), info.max)
        hi = min(max(hi, info.min), info.max + 1)
    if not -2**31 <= lo < hi <= 2**31 - 1:
        raise ValueError(f"need int32 bounds lo < hi; got {lo}, {hi}")
    span = hi - lo
    return lo, span, (2**16 % span) ** 2 % 2**32 % span


def torch_randint(k: torch.Tensor, shape, lo: int, hi: int,
                  dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``jax.random.randint(k, shape, lo, hi, dtype)``: ``randint``'s two
    32-bit draws and modulus on tensors, drawn at int32 and cast."""
    lo, span, mult = randint_consts(lo, hi, dtype)
    keys = torch_split(k, 2)
    higher = torch_random_bits(keys[..., 0, :], shape)
    lower = torch_random_bits(keys[..., 1, :], shape)
    off = ((((higher % span) * mult) & _M32) + lower % span) & _M32
    out = (off % span + lo) & _M32
    return torch.where(out >= 2**31, out - 2**32, out).to(dtype)


# jax.random.uniform draws the mantissa bits of a float in [1, 2): (type
# bits, mantissa bits, random bits drawn, the integer view, bits of 1.0).
_FLOAT_BITS = {torch.float32: (23, 32, torch.int32, 0x3F800000),
               torch.bfloat16: (7, 8, torch.int16, 0x3F80)}


def _as(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (a host constant, not a draw)."""
    return float(torch.tensor(value, dtype=dtype))


def uniform(k: torch.Tensor, shape, dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: (bits >> (drawn - mantissa)) | bits(1.0),
    viewed as a float in [1, 2), minus 1, scaled into [minval, maxval)
    and raised to ``minval``; every step rounds to ``dtype``, as XLA
    rounds it (bfloat16 draws 8 bits)."""
    nmant, drawn, itype, one = _FLOAT_BITS[dtype]
    bits = torch_random_bits(k, shape, drawn)
    floats = ((bits >> (drawn - nmant)) | one).to(itype).view(dtype) - 1
    lo, scale = uniform_consts(minval, maxval, dtype)
    return (floats * scale + lo).clamp_min(lo)


def uniform_consts(minval: float, maxval: float,
                   dtype: torch.dtype) -> tuple[float, float]:
    """``uniform``'s lo and scale (maxval - minval), each rounded to
    ``dtype``."""
    lo, hi = _as(minval, dtype), _as(maxval, dtype)
    return lo, _as(hi - lo, dtype)


# XLA's CPU emitter computes f32 log, log1p and erf_inv by polynomials of
# its own, with fused multiply-adds; a Horner step or an FMA here is one
# product and sum in float64, rounded once to float32. Valid for the
# inputs the draws give: positive normal floats for the log.
def _fma(a, b, c) -> torch.Tensor:
    if not torch.is_tensor(a):
        a, b = b, a
    return (a.double() * b + c).float()


_LOG_P = [_as(v, torch.float32) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1, _LOG_Q2 = _as(-2.12194440e-4, torch.float32), 0.693359375
_SQRT_HALF = _as(0.707106781186547524, torch.float32)


def _xla_log(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log (Cephes): the exponent split off, the mantissa moved
    to [sqrt(1/2), sqrt(2)) - 1, a degree-8 polynomial."""
    bits = v.view(torch.int32)
    e = ((bits >> 23) & 0xFF).float() - 126.0
    xm = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = xm < _SQRT_HALF
    x = (xm - 1.0) + torch.where(small, xm, 0.0)
    e = e - small.float()
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(p[0], x, p[1]), x, p[2])
    y1 = _fma(_fma(p[3], x, p[4]), x, p[5])
    y2 = _fma(_fma(p[6], x, p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    return _fma(e, _LOG_Q2, _fma(x2, -0.5, x) + y)


_LOG1P_NUM = [_as(v, torch.float32) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)]
_LOG1P_DEN = [_as(v, torch.float32) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)]
_LOG1P_SMALL = _as(0.41421356237309504880, torch.float32)


def _horner(x: torch.Tensor, coeffs: list) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log1p: Cephes' rational form for |x| < sqrt(2) - 1, the
    log of 1 + x above it."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma(x2, -0.5, small)
    return torch.where(x.abs() < _LOG1P_SMALL, small, _xla_log(x + 1.0))


_ERFINV_LT5 = [_as(v, torch.float32) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)]
_ERFINV_GE5 = [_as(v, torch.float32) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)]


def _xla_erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf_inv (Giles): w = -log1p(-x^2), a degree-8
    polynomial in w - 2.5 below 5 and sqrt(w) - 3 above, times x."""
    w = -_xla_log1p(x * -x)
    lt = w < 5.0
    # XLA's f32 sqrt is correctly rounded; torch's vectorised CPU sqrt is
    # not always (1 ulp off on some inputs). float64's, rounded once to
    # float32, is.
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, a, b))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low" (jax 0.9.0's
    default): -log(-log(uniform(tiny, 1)))."""
    u = uniform(k, shape, torch.float32, torch.finfo(torch.float32).tiny,
                1.0)
    return -_xla_log(-_xla_log(u))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of float32 logits
    [..., V], one key [..., 2] per row: the first index of the largest
    logit + gumbel(key, [V])."""
    return torch.argmax(gumbel(k, logits.shape[-1:]) + logits, dim=-1)


def normal_lo(dtype: torch.dtype) -> float:
    """The open interval's lower end: -1 plus ``dtype``'s epsilon at 1."""
    return -1.0 + (2.0**-24 if dtype == torch.float32 else 2.0**-8)


def normal(k: torch.Tensor, shape,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) * erf_inv(u), u uniform on the open
    interval (-1, 1) of ``dtype``; erf_inv in float32, as XLA computes
    it for bfloat16 too, and the product rounded to ``dtype``."""
    u = uniform(k, shape, dtype, normal_lo(dtype), 1.0)
    return _xla_erf_inv(u.float()).to(dtype) * _as(math.sqrt(2.0), dtype)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: 0..n-1 stably sorted by 32-bit
    keys, in as many rounds as jax takes at n (ceil(3 ln n / ln(2**32 -
    1))), each round drawing from the second half of a split."""
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1))
    for _ in range(rounds):
        k, sub = torch_split(k, 2).unbind(0)
        order = torch.sort(torch_random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
