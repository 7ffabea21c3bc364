"""Targeted burns and slope-timed kernel measurements on an NVIDIA GPU.

Counterpart of ``tpumon/loadgen/burn.py``: deterministic synthetic load
(matrix products, int8 weight-only products, paged-attention decode, a
memory fill) so the monitor's utilization and memory readings can be
checked against a known workload (``tpumon_torch.validate``), and the
kernels phase's measurements, each kernel against the library path it
replaces, slope-timed and guarded by the card's roofline.

What differs from the reference:

- Its ``use_pallas`` flag is ``use_kernel`` here and its result key
  ``pallas`` is ``kernel``; every other result key is the reference's.
  The kernel paths run the port's CUDA kernels (``ops/matmul.py``,
  ``ops/quant_matmul.py``, ``ops/paged_attention.py``); the library paths
  run plain torch where the reference runs XLA (``a @ b``, the per-call
  dequantized ``a @ w``, the dense-gather paged read).
- Inputs are the reference's draws: ``jax.random``'s threefry, normal,
  randint and permutation, bit for bit, from ``PRNGKey(seed)`` and the
  reference's chain of ``fold_in`` keys, one new key per call. On the
  card each draw is one fused launch (``ops.threefry``), as XLA fuses the
  reference's, so no host-to-device copy of an input lands inside a timed
  call and a 4096^2 input costs one pass over its bytes. The reference's
  key is ``PRNGKey(0)``: ``seed`` defaults to 0.
- A program is a Python loop of eager torch calls (the reference's jitted
  scan) that ends in a scalar; ``_sync`` fetches it with ``.item()``,
  which waits for the card. The timers read the host clock
  (``time.perf_counter``) around such a call, so they time finished
  device work.
- Entry points run on the card unless given ``device="cpu"`` and raise
  when there is no GPU. ``ici_burn`` rotates its buffer round a
  ``model.Mesh`` of devices by copies; on one card they are device-local.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpumon_torch import prng
from tpumon_torch.loadgen.model import init_params, map_params, resolve_device
from tpumon_torch.loadgen.paged_kv import init_pool, paged_decode_step
from tpumon_torch.loadgen.train import card_peaks
from tpumon_torch.ops.matmul import matmul
from tpumon_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_reference,
)
from tpumon_torch.ops.quant_matmul import quantized_matmul_kernel
from tpumon_torch.ops.threefry import (
    fold_in,
    normal,
    permutation,
    randint,
    split,
)


def _sync(x: torch.Tensor) -> float:
    """Wait for the card and fetch a burn's scalar: ``.item()``
    synchronises the stream, so a timer around it times finished work."""
    return float(x.item())


def _mxu_chain(a: torch.Tensor, b: torch.Tensor, iters: int,
               mm) -> torch.Tensor:
    """The reference's scan body, ``iters`` times: c = mm(a, b),
    renormalised by size (as the reference does, not by sqrt(size)) and
    carried in bf16 as the next a."""
    size = a.shape[0]
    for _ in range(iters):
        a = (mm(a, b) / size).to(torch.bfloat16)
    return a


def _mxu_inputs(key: torch.Tensor, size: int) -> tuple:
    """The bf16 burn's (a, b): the reference's bf16 normals under ``key``
    and fold_in(key, 1), on the key's device."""
    shape = (size, size)
    return (normal(key, shape, torch.bfloat16),
            normal(fold_in(key, 1), shape, torch.bfloat16))


def _mxu_burn_program(key: torch.Tensor, size: int, iters: int,
                      use_kernel: bool = False) -> torch.Tensor:
    """Chained bf16 matrix products, 2*size^3*iters FLOPs, through the
    GEMM kernel or torch.matmul, on inputs drawn from ``key`` (a
    ``prng.torch_key`` on the device to burn); returns the chain's f32
    sum (0-d)."""
    a, b = _mxu_inputs(key, size)
    mm = matmul if use_kernel else torch.matmul
    return _mxu_chain(a, b, iters, mm).float().sum()


def mxu_burn(seconds: float = 2.0, size: int = 4096, iters: int = 64,
             use_kernel: bool | None = None, seed: int = 0,
             device=None) -> dict:
    """Run matmul bursts for ~``seconds``; returns achieved TFLOP/s.

    The default, the library path (``torch.matmul``), mirrors the
    reference's default; ``use_kernel=True`` runs the GEMM kernel.
    """
    key = prng.torch_key(seed, resolve_device(device))
    if use_kernel is None:
        use_kernel = False
    _sync(_mxu_burn_program(key, size, iters, use_kernel))  # warm up
    flops_per_call = 2 * size**3 * iters
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _sync(_mxu_burn_program(fold_in(key, calls), size,
                                iters, use_kernel))
        calls += 1
    dt = time.perf_counter() - t0
    return {
        "calls": calls,
        "seconds": dt,
        "kernel": use_kernel,
        "tflops": flops_per_call * calls / dt / 1e12,
    }


def _dequant_matmul(a: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """The reference's library path: dequantize the weights, then a @ w.
    Eager torch dequantizes on every call (nothing hoists it out of the
    loop, which the reference ties q to the carry to prevent)."""
    return a @ (q.to(a.dtype) * scale.to(a.dtype))


def _int8_chain(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                iters: int, qmm) -> torch.Tensor:
    """The reference's int8 scan body: c = qmm(a, q, scale), renormalised
    by size and carried in bf16."""
    size = a.shape[0]
    for _ in range(iters):
        a = (qmm(a, q, scale) / size).to(torch.bfloat16)
    return a


def _int8_inputs(key: torch.Tensor, size: int) -> tuple:
    """The int8 burn's (a, q, scale), the reference's draws: bf16 normal
    activations under ``key``, int8 weights randint(-127, 128) under
    fold_in(key, 1), and a 1/127 per-column scale."""
    shape = (size, size)
    a = normal(key, shape, torch.bfloat16)
    q = randint(fold_in(key, 1), shape, -127, 128, torch.int8)
    scale = torch.full((size,), 1.0 / 127.0, dtype=torch.float32,
                       device=key.device)
    return a, q, scale


def _int8_burn_program(key: torch.Tensor, size: int, iters: int,
                       use_kernel: bool = False) -> torch.Tensor:
    """Chained int8-weight products, the serving engine's quantized hot
    op: bf16 activations, weights streamed as int8 plus a per-column
    scale, through the int8 GEMM kernel or the per-call dequantized
    ``a @ w``, on inputs drawn from ``key``."""
    a, q, scale = _int8_inputs(key, size)
    qmm = quantized_matmul_kernel if use_kernel else _dequant_matmul
    return _int8_chain(a, q, scale, iters, qmm).float().sum()


def int8_burn(seconds: float = 2.0, size: int = 4096, iters: int = 64,
              use_kernel: bool | None = None, seed: int = 0,
              device=None) -> dict:
    """Int8 weight-only matmul bursts; reports TFLOP/s and the effective
    int8 weight-streaming rate (the bandwidth decode is bound by).

    The default mirrors the reference's: the kernel on the card when
    ``size`` tiles its default blocks (a multiple of 1024), the library
    path otherwise.
    """
    dev = resolve_device(device)
    key = prng.torch_key(seed, dev)
    if use_kernel is None:
        use_kernel = dev.type == "cuda" and size % 1024 == 0
    _sync(_int8_burn_program(key, size, iters, use_kernel))
    flops_per_call = 2 * size**3 * iters
    weight_bytes_per_call = size * size * iters  # int8: 1 byte/weight
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _sync(_int8_burn_program(fold_in(key, calls), size,
                                 iters, use_kernel))
        calls += 1
    dt = time.perf_counter() - t0
    return {
        "calls": calls,
        "seconds": dt,
        "kernel": use_kernel,
        "tflops": flops_per_call * calls / dt / 1e12,
        "weight_gbps": weight_bytes_per_call * calls / dt / 1e9,
    }


def _paged_pool(key, batch, n_kv_heads, head_dim, page_size, context):
    """The reference's bf16 pool of batch * context / page_size pages
    (normals under ``key`` and fold_in(key, 1)) and its shuffled table
    (permutation under fold_in(key, 2): the fragmented layout a churned
    pool converges to), every sequence at ``context`` rows."""
    if context <= 0 or context % page_size:
        raise ValueError(f"context={context} must be a positive multiple of "
                         f"page_size={page_size}")
    max_pages = context // page_size
    num_pages = batch * max_pages
    shape = (n_kv_heads, num_pages, page_size, head_dim)
    k_pages = normal(key, shape, torch.bfloat16)
    v_pages = normal(fold_in(key, 1), shape, torch.bfloat16)
    table = permutation(fold_in(key, 2), num_pages).to(
        torch.int32).reshape(batch, max_pages)
    lengths = torch.full((batch,), context, dtype=torch.int32,
                         device=key.device)
    return k_pages, v_pages, table, lengths


def _paged_steps(step_keys, fn, pool, batch, n_heads,
                 head_dim) -> torch.Tensor:
    """One decode-attention call per key of ``step_keys`` [steps, 2], its
    q drawn under that key (so no result can be reused), summed into one
    f32 scalar. The steps' queries are drawn in one launch before the
    steps, the same bits as one draw per key."""
    qs = normal(step_keys, (batch, n_heads, head_dim), torch.bfloat16)
    total = torch.zeros((), dtype=torch.float32, device=step_keys.device)
    for q in qs:
        total += fn(q, *pool).float().sum()
    return total


def paged_burn(seconds: float = 2.0, batch: int = 16, n_heads: int = 32,
               n_kv_heads: int = 8, head_dim: int = 128,
               page_size: int = 128, context: int = 4096,
               use_kernel: bool | None = None, seed: int = 0,
               device=None) -> dict:
    """Paged-attention decode bursts over a shared page pool with a
    shuffled page table, through the paged-attention kernel or the
    dense-gather plain path; the default mirrors the reference's (the
    kernel on the card). Reports decode steps/s and the KV bytes the step
    streams."""
    dev = resolve_device(device)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    key = prng.torch_key(seed, dev)
    pool = _paged_pool(key, batch, n_kv_heads, head_dim, page_size, context)
    fn = paged_attention if use_kernel else paged_attention_reference
    inner_steps = 8

    def burst(call_key) -> float:
        return _sync(_paged_steps(split(call_key, inner_steps),
                                  fn, pool, batch, n_heads, head_dim))

    burst(key)  # warm up
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        burst(fold_in(key, 3 + calls))
        calls += 1
    dt = time.perf_counter() - t0
    steps = calls * inner_steps
    num_pages = pool[0].shape[1]
    kv_bytes_per_step = 2 * num_pages * page_size * n_kv_heads * head_dim * 2
    return {
        "calls": calls,
        "seconds": dt,
        "kernel": use_kernel,
        "decode_steps_per_sec": steps / dt,
        "kv_gbps": kv_bytes_per_step * steps / dt / 1e9,
    }


# ---------------------------------------------------------------------------
# Slope-timed kernel measurements (the kernels phase). The burns above are
# load generators; these time the same program at n and 4n inner
# iterations and take the difference, which cancels every per-call
# constant (input generation, the launch of the first kernel, the scalar
# fetch): only the marginal device work remains. Two guards:
#
#   1. Noise floor: each measurement's marginal duration must be at least
#      MIN_MARGINAL_S; below it the iteration count grows and the
#      measurement is redone.
#   2. Roofline: a rate above the card's peak for the arithmetic the path
#      runs (memory bytes/s for the paged phases, bf16 FLOP/s for the
#      products) is impossible, therefore noise: the measurement is
#      retried at a larger scale, and raises rather than publishes if it
#      persists.
#
# Every measure_* result carries "marginal_s", the resolved marginal
# duration.
# ---------------------------------------------------------------------------

#: Minimum marginal device time per slope measurement: the reference's
#: floor, kept. The host clock's noise around a synchronised call on the
#: card's host is not measured yet.
MIN_MARGINAL_S = 0.5

def _lookup_peak(column: str, device=None) -> float | None:
    """The card's dense peak per second for one column of
    ``train.NVIDIA_PEAKS`` ("bf16" FLOP/s, "int8" OP/s, "hbm" bytes/s), or
    None off the card or for an unknown card: the guards disengage rather
    than guess."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    peaks = card_peaks(torch.cuda.get_device_name(dev))
    return getattr(peaks, column) if peaks else None


def device_rooflines(device=None) -> dict:
    """The card's dense peaks: bf16 matmul TFLOP/s, int8 TOP/s, HBM GB/s
    (NVIDIA's data sheets); None-valued off the card or where the card is
    unknown."""
    bf16, int8, hbm = (_lookup_peak(c, device) for c in ("bf16", "int8",
                                                          "hbm"))
    return {
        "bf16_tflops": bf16 / 1e12 if bf16 else None,
        "int8_tops": int8 / 1e12 if int8 else None,
        "hbm_gbps": hbm / 1e9 if hbm else None,
    }


def _slope_time(run, n1: int, n2: int, reps: int = 3) -> float:
    """min-of-reps [t(n2) - t(n1)] in seconds."""

    def best(n: int) -> float:
        b = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            run(n)
            b = min(b, time.perf_counter() - t0)
        return b

    run(n1)  # warm both variants outside the timed reps
    run(n2)
    dt = best(n2) - best(n1)
    if dt <= 0:
        # A clamped dt would publish an absurd rate as if it were a win.
        raise RuntimeError(
            f"non-positive timing slope ({dt:.6f}s between {n1} and {n2} "
            "iters): measurement invalid on this device"
        )
    return dt


def _guarded_slope(
    run,
    iters: int,
    units_per_iter: float,
    peak_per_sec: float | None,
    what: str,
    reps: int = 3,
    min_marginal_s: float = MIN_MARGINAL_S,
    attempts: int = 3,
) -> tuple[float, int, float]:
    """Slope-time ``run`` at (n, 4n), growing n until the marginal
    duration clears the noise floor AND the computed rate sits within 2%
    of the roofline (data-sheet peaks are rounded). Returns
    (rate_per_sec, marginal_iters, marginal_seconds); raises if the
    guards can't be satisfied: an unresolvable measurement is never
    published.
    """
    last_err: Exception | None = None
    for _ in range(attempts):
        n1, n2 = iters, 4 * iters
        try:
            dt = _slope_time(run, n1, n2, reps)
        except RuntimeError as e:
            last_err = e
            iters *= 2
            continue
        marginal = n2 - n1
        rate = units_per_iter * marginal / dt
        if dt < min_marginal_s:
            # Below the noise floor: grow to clear it with ~30% headroom.
            last_err = RuntimeError(
                f"{what}: marginal {dt * 1e3:.0f} ms below the "
                f"{min_marginal_s * 1e3:.0f} ms noise floor"
            )
            iters = max(2 * iters, int(iters * 1.3 * min_marginal_s / dt) + 1)
            continue
        # 2% headroom over the nominal peak: data-sheet rooflines are
        # rounded; the guard exists to catch impossible rates.
        if peak_per_sec is not None and rate > 1.02 * peak_per_sec:
            last_err = RuntimeError(
                f"{what}: measured {rate:.3e}/s exceeds the device "
                f"roofline {peak_per_sec:.3e}/s by >2% — noise, not a win"
            )
            iters *= 2
            continue
        return rate, marginal, dt
    raise last_err or RuntimeError(f"{what}: slope measurement failed")


def measure_mxu_tflops(size: int = 4096, iters: int = 192,
                       use_kernel: bool = False, reps: int = 5,
                       seed: int = 0, device=None) -> dict:
    """Slope-timed bf16 matmul throughput (the GEMM kernel or
    torch.matmul), noise-floor- and roofline-guarded."""
    dev = resolve_device(device)
    key = prng.torch_key(seed, dev)

    def run(n: int):
        _sync(_mxu_burn_program(key, size, n, use_kernel))

    rate, _, dt = _guarded_slope(
        run,
        iters,
        units_per_iter=2 * size**3,
        peak_per_sec=_lookup_peak("bf16", dev),
        what=f"mxu_matmul[kernel={use_kernel}]",
        reps=reps,
    )
    return {
        "tflops": rate / 1e12,
        "kernel": use_kernel,
        "marginal_s": round(dt, 3),
    }


def measure_int8_tflops(size: int = 4096, iters: int = 192,
                        use_kernel: bool = True, reps: int = 5,
                        seed: int = 0, device=None) -> dict:
    """Slope-timed int8 weight-only matmul throughput, noise-floor- and
    roofline-guarded. Both paths multiply in bf16 (the kernel widens the
    int8 weights to the activations' type, as the reference kernel does;
    the library path dequantizes to bf16 first), so both are guarded by
    the bf16 peak.
    """
    dev = resolve_device(device)
    key = prng.torch_key(seed, dev)

    def run(n: int):
        _sync(_int8_burn_program(key, size, n, use_kernel))

    rate, _, dt = _guarded_slope(
        run,
        iters,
        units_per_iter=2 * size**3,
        peak_per_sec=_lookup_peak("bf16", dev),
        what=f"int8_matmul[kernel={use_kernel}]",
        reps=reps,
    )
    return {
        "tflops": rate / 1e12,
        # rate = 2*size^3 flops per iteration; weights are size^2 int8
        # bytes per iteration => bytes/s = rate / (2*size).
        "weight_gbps": rate / (2 * size) / 1e9,
        "kernel": use_kernel,
        "marginal_s": round(dt, 3),
    }


def _paged_measure_program(key, batch: int, n_heads: int,
                           n_kv_heads: int, head_dim: int, page_size: int,
                           context: int, steps: int,
                           use_kernel: bool) -> torch.Tensor:
    """Self-contained paged-decode burst, the reference's draws: pool and
    table from ``key`` (``_paged_pool``), the steps' queries under
    split(fold_in(key, 3), steps)."""
    pool = _paged_pool(key, batch, n_kv_heads, head_dim, page_size, context)
    fn = paged_attention if use_kernel else paged_attention_reference
    return _paged_steps(split(fold_in(key, 3), steps),
                        fn, pool, batch, n_heads, head_dim)


def measure_paged_gbps(
    batch: int = 16,
    n_heads: int = 32,
    n_kv_heads: int = 8,
    head_dim: int = 128,
    page_size: int = 128,
    context: int = 4096,
    use_kernel: bool = True,
    inner_steps: int = 96,
    reps: int = 5,
    seed: int = 0,
    device=None,
) -> dict:
    """Slope-timed paged-attention decode KV-streaming bandwidth (n -> 4n
    decode steps), noise-floor- and memory-roofline-guarded: the step
    must stream the whole KV pool (268 MB at the defaults), so a rate
    above the card's memory rate is impossible."""
    dev = resolve_device(device)
    key = prng.torch_key(seed, dev)

    def run(n: int):
        _sync(_paged_measure_program(
            key, batch, n_heads, n_kv_heads, head_dim, page_size, context,
            n, use_kernel))

    num_pages = batch * (context // page_size)
    kv_bytes_per_step = 2 * num_pages * page_size * n_kv_heads * head_dim * 2
    rate, _, dt = _guarded_slope(
        run,
        inner_steps,
        units_per_iter=kv_bytes_per_step,
        peak_per_sec=_lookup_peak("hbm", dev),
        what=f"paged_attention[kernel={use_kernel}]",
        reps=reps,
    )
    return {
        "kv_gbps": rate / 1e9,
        "decode_steps_per_sec": rate / kv_bytes_per_step,
        "kernel": use_kernel,
        "marginal_s": round(dt, 3),
    }


def _paged_engine_step_program(cfg, params, pool, last, positions, tables,
                               steps: int):
    """``steps`` engine decode steps (the serving step,
    ``paged_kv.paged_decode_step``, gather or kernel read path per
    ``cfg.paged_attn``) with the pool updated in place. Returns the last
    tokens and positions.

    Positions advance one row per step, like the engine's write cursor, so
    the scatter crosses page boundaries; they cycle within the last
    ``page_size + 1`` rows (a band that always holds one page boundary) so
    the context stays near its maximum.
    """
    ps = cfg.prefill_len
    hi = tables.shape[1] * ps - 2  # last position with a valid next row
    lo = max(hi - ps, 0)
    for _ in range(steps):
        logits = paged_decode_step(cfg, params, pool, last, positions, tables)
        positions = torch.where(positions >= hi, lo, positions + 1)
        last = logits.argmax(-1).to(torch.int32)
    return last, positions


def measure_paged_engine_step_ms(cfg, inner_steps: int = 24, reps: int = 3,
                                 seed: int = 0, device=None) -> dict:
    """Slope-timed device ms per engine paged-decode step at ``cfg``'s
    shape, with full scrambled page tables (every slot near max_seq
    context, tables a random permutation of the pool: the fully
    fragmented worst case). The weights are random from ``seed``, held in
    the compute dtype as the engine holds them. Isolates what the
    ``paged_attn`` read path buys at the step level."""
    dev = resolve_device(device)
    m = cfg.model
    ps = cfg.prefill_len
    max_pages = m.max_seq // ps
    num_pages = cfg.slots * max_pages + 1
    perm = np.random.default_rng(seed).permutation(np.arange(1, num_pages))
    tables = torch.as_tensor(
        perm[: cfg.slots * max_pages].reshape(cfg.slots, max_pages),
        dtype=torch.int32, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    params = map_params(init_params(m, gen), lambda t: t.to(m.torch_dtype))
    state = {
        "pool": init_pool(cfg, num_pages, dev),
        "last": torch.zeros(cfg.slots, dtype=torch.int32, device=dev),
        "positions": torch.full((cfg.slots,), m.max_seq - 2,
                                dtype=torch.int32, device=dev),
    }

    def run(n: int):
        last, positions = _paged_engine_step_program(
            cfg, params, state["pool"], state["last"], state["positions"],
            tables, n)
        _sync(last.sum())
        # Carry the tokens and positions, so reps keep walking pages.
        state["last"], state["positions"] = last, positions

    # Per step the attention read streams the full table width of KV per
    # layer; the weights are left out, so the reported GB/s is a lower
    # bound on the KV streaming rate.
    kv_bytes = (m.n_layers * 2 * cfg.slots * max_pages * ps
                * m.n_kv_heads * m.head_dim * m.torch_dtype.itemsize)
    rate, _, dt = _guarded_slope(
        run,
        inner_steps,
        units_per_iter=kv_bytes,
        peak_per_sec=_lookup_peak("hbm", dev),
        what=f"paged_engine_step[{cfg.paged_attn}]",
        reps=reps,
    )
    return {
        "ms_per_step": kv_bytes / rate * 1e3,
        "kv_gbps_floor": rate / 1e9,
        "paged_attn": cfg.paged_attn,
        "marginal_s": round(dt, 3),
    }


def hbm_fill(fraction: float = 0.5, hbm_bytes: int | None = None,
             device=None) -> list[torch.Tensor]:
    """Allocate ~``fraction`` of the card's memory (``hbm_bytes``, by
    default the card's total from ``torch.cuda.mem_get_info``) in 64 MB
    f32 chunks; the caller holds the list and drops it to free. Used to
    validate the monitor's memory reading."""
    dev = resolve_device(device)
    if hbm_bytes is None:
        if dev.type != "cuda":
            raise ValueError("hbm_fill needs hbm_bytes off the card")
        hbm_bytes = torch.cuda.mem_get_info(dev)[1]
    n = int(hbm_bytes * fraction) // 4
    chunk = 64 * 2**20 // 4  # 64 MB chunks avoid one giant allocation
    arrays = []
    remaining = n
    i = 0
    while remaining > 0:
        size = min(chunk, remaining)
        arrays.append(torch.full((size,), float(i), dtype=torch.float32,
                                 device=dev))
        remaining -= size
        i += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return arrays


def ici_burn(mesh, mb_per_shift: int = 64, iters: int = 8) -> dict:
    """Rotate a buffer round the devices of the mesh's first axis,
    ``iters`` times: each device's ``mb_per_shift`` MB block moves to the
    next device of the ring by a copy (the reference's ``ppermute`` over
    ICI). Returns {devices, bytes_shifted, seconds, gbps}, with
    ``bytes_shifted`` = devices x block bytes x iters as the reference
    counts it and the seconds from the first copy to the last one's
    completion. On cards of their own the copies ride NVLink or PCIe; on
    one card (a mesh that repeats it) every copy stays within the device,
    so ``gbps`` is the card's copy rate, not an interconnect's."""
    axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    devs = [mesh.device_list[mesh.index(**{axis: i})] for i in range(n)]
    floats = mb_per_shift * 2**20 // 4
    blocks = [torch.arange(i * floats, (i + 1) * floats, dtype=torch.float32,
                           device=d) for i, d in enumerate(devs)]
    for b in blocks:
        _sync(b[-1])
    t0 = time.perf_counter()
    for _ in range(iters):
        blocks = [blocks[(i - 1) % n].to(devs[i], copy=True)
                  for i in range(n)]
    for b in blocks:
        _sync(b[-1])
    dt = time.perf_counter() - t0
    total_bytes = n * floats * 4 * iters
    return {
        "devices": n,
        "bytes_shifted": total_bytes,
        "seconds": dt,
        "gbps": total_bytes / dt / 1e9,
    }
