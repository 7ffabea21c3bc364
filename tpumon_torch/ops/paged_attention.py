"""Paged-attention decode: the CUDA kernel's wrapper and its plain version.

Counterpart of ``tpumon/ops/paged_attention.py``. Sequences own lists of
fixed-size pages from a shared head-major pool ``[n_kv_heads, num_pages,
page_size, head_dim]``; the per-sequence page table is the indirection.
``paged_attention`` is the decode step (one query token per sequence):
on a CUDA tensor it launches ``csrc/paged_attention.cu``, which reads
each sequence's pages in place, split across CTAs of
``pages_per_split`` table entries whose partial softmax states merge in
the same launch — the gathered ``[B, S]`` context never exists in device
memory; on a CPU tensor it runs ``paged_attention_reference``, the plain
PyTorch version that mirrors the reference's dense-gather oracle step
for step (and is the engine's ``paged_attn="gather"`` read path).
"""

from __future__ import annotations

import ctypes

import torch

from tpumon_torch.ops import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_MAX_GROUP = 8
# The split rule (pages_per_split): about SPLIT_TARGET_CTAS CTAs a call
# (two resident on each of an H100's 132 SMs), none shorter than
# SPLIT_MIN_ROWS rows; a call whose tables hold no more than that keeps
# one split per (sequence, kv head). Measured against 2-8x as many CTAs
# (PERF.md §6, the paged kernel's variants): more, shorter splits cost
# each CTA's start and merge.
SPLIT_TARGET_CTAS = 256
SPLIT_MIN_ROWS = 256
# Rows of one ring stage of the kernel (csrc/paged_attention.cu
# Tile::kRows), at most a page: the tiles a split's pages stream in.
STAGE_ROWS = {torch.bfloat16: 64, torch.float32: 32}


def paged_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, page_table: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """Dense oracle: gather pages per sequence, plain softmax attention.

    Einsums in q's dtype, f32 softmax, rows of length 0 zeroed — the
    reference's ``paged_attention_reference`` step for step.
    """
    b, nh, hd = q.shape
    nkv, _, page_size, _ = k_pages.shape
    _, max_pages = page_table.shape
    s_max = max_pages * page_size
    idx = page_table.long()
    # [nkv, B, max_pages, page_size, hd] -> [B, S, nkv, hd]
    k = k_pages[:, idx].reshape(nkv, b, s_max, hd).permute(1, 2, 0, 3)
    v = v_pages[:, idx].reshape(nkv, b, s_max, hd).permute(1, 2, 0, 3)
    group = nh // nkv
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q, k).float() / hd**0.5
    kpos = torch.arange(s_max, dtype=torch.int32, device=q.device)
    mask = kpos[None, None] < lengths[:, None, None]
    s = torch.where(mask, s, _NEG_INF)
    # Fully-masked rows (length 0) produce uniform probs; zero them.
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    probs = torch.where(mask, probs, 0.0)
    return torch.einsum("bhk,bkhd->bhd", probs, v)


def pages_per_split(batch: int, n_kv_heads: int, max_pages: int,
                    page_size: int) -> int:
    """Table entries per CTA of the kernel, from static shapes alone (no
    read of the lengths): enough splits of each (sequence, kv head) for
    about SPLIT_TARGET_CTAS CTAs, each at least SPLIT_MIN_ROWS rows long.
    max_pages means one split."""
    min_pages = -(-SPLIT_MIN_ROWS // page_size)
    want = -(-SPLIT_TARGET_CTAS // (batch * n_kv_heads))
    return min(max_pages, max(min_pages, -(-max_pages // want)))


def _kernel():
    """The built library and its two launchers (one split per (sequence,
    kv head); split), with their C signatures set."""
    lib = _build.load("paged_attention")
    one, split = lib.tpumon_paged_attention, lib.tpumon_paged_attention_split
    if one.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # q, k, v, table, lengths, out; batch, heads, kv heads, pages,
        # page size, max pages, head dim, dtype; [pages per split, stages,
        # partials, counters;] stream.
        one.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
        split.argtypes = [ptr] * 6 + [i32] * 10 + [ptr] * 3
        one.restype = split.restype = i32
    return lib, one, split


def kernel_config(head_dim: int, dtype: torch.dtype, page_size: int,
                  stages: int = 0) -> dict:
    """The kernel's dynamic shared memory at ``stages`` ring stages (0: its
    default), its default stages and the rows of a stage at
    ``page_size``. Builds the library (needs nvcc)."""
    lib = _build.load("paged_attention")
    fn = lib.tpumon_paged_attention_config
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out = (ctypes.c_int * 3)()
    _build.check(lib, fn(head_dim, _DTYPES[dtype], stages, page_size,
                         ctypes.addressof(out)), "paged_attention config")
    return {"smem_bytes": out[0], "default_stages": out[1],
            "stage_rows": out[2]}


# Arrival counters of the split kernel, one int32 per (sequence, kv head),
# per (device, stream): zeroed once when made, left at 0 by every launch.
_counters: dict[tuple, torch.Tensor] = {}


def _arrival_counters(device: torch.device, stream, n: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _check(q, k_pages, v_pages, page_table, lengths) -> None:
    """Reject what neither version computes; raises ValueError."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(
            f"q must be [B, n_heads, hd] and the pools [n_kv_heads, pages, "
            f"page_size, hd]; got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    b, nh, hd = q.shape
    nkv, _, _, hd2 = k_pages.shape
    if v_pages.shape != k_pages.shape or hd2 != hd:
        raise ValueError(
            f"K/V pools must share a shape with q's head_dim; got q "
            f"{tuple(q.shape)}, k {tuple(k_pages.shape)}, "
            f"v {tuple(v_pages.shape)}")
    if nh % nkv:
        raise ValueError(f"n_heads={nh} is not a multiple of n_kv_heads={nkv}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or (
            v_pages.dtype != q.dtype):
        raise ValueError(
            f"q/k/v must all be float32 or bfloat16; got {q.dtype}, "
            f"{k_pages.dtype}, {v_pages.dtype}")
    if page_table.dim() != 2 or page_table.shape[0] != b or (
            page_table.dtype != torch.int32):
        raise ValueError(
            f"page_table must be int32 [B={b}, max_pages]; got "
            f"{page_table.dtype} {tuple(page_table.shape)}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(
            f"lengths must be int32 [B={b}]; got {lengths.dtype} "
            f"{tuple(lengths.shape)}")
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention takes contiguous tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_attention's tensors must share one device")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode-step attention over paged KV.

    q: [B, n_heads, hd] (one query token per sequence); k_pages/v_pages:
    [n_kv_heads, num_pages, page_size, hd] shared pool; page_table:
    [B, max_pages] int32 page ids per sequence in order (entries past the
    sequence's pages may be any valid id); lengths: [B] int32 context
    lengths. Returns [B, n_heads, hd]; a length-0 sequence gives zeros.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (and counts the launch in ``paged_attention.launches``) or
    raises — there is no fallback.
    """
    _check(q, k_pages, v_pages, page_table, lengths)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    return _launch(q, k_pages, v_pages, page_table, lengths)


def _launch(q, k_pages, v_pages, page_table, lengths, pages: int = 0,
            stages: int = 0) -> torch.Tensor:
    """The kernel on checked CUDA tensors: ``pages`` table entries per
    split (0: the ``pages_per_split`` rule) and ``stages`` ring stages (0:
    the kernel's default). One launch; no device-to-host copy."""
    b, nh, hd = q.shape
    nkv, num_pages, page_size, _ = k_pages.shape
    max_pages = page_table.shape[1]
    if hd not in KERNEL_HEAD_DIMS or nh // nkv > KERNEL_MAX_GROUP:
        raise ValueError(
            f"the CUDA kernel takes head_dim in {KERNEL_HEAD_DIMS} and GQA "
            f"groups of 1-{KERNEL_MAX_GROUP}; got head_dim={hd}, "
            f"group={nh // nkv}")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("the CUDA kernel needs 16-byte aligned q/k/v")
    out = torch.empty_like(q)
    if b == 0:
        return out
    pages = pages or pages_per_split(b, nkv, max_pages, page_size)
    lib, one, split = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                b, nh, nkv, num_pages, page_size, max_pages, hd,
                _DTYPES[q.dtype])
        if pages >= max_pages and stages == 0:
            err = one(*args, stream.cuda_stream)
        else:
            splits = -(-max_pages // pages)
            partials = torch.empty(b * splits * nh * (hd + 2),
                                   dtype=torch.float32, device=q.device)
            counters = _arrival_counters(q.device, stream, b * nkv)
            err = split(*args, pages, stages, partials.data_ptr(),
                        counters.data_ptr(), stream.cuda_stream)
    _build.check(lib, err, "paged_attention launch")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
