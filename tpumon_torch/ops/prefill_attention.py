"""Chunk attention of the paged prefill: the CUDA kernel's wrapper and its
plain version.

One prompt chunk, q ``[1, P, n_heads, hd]`` at sequence rows ``start ..
start + P - 1``, attends causally over its sequence's rows ``0 ..`` its
own, which live in the pages ``table_row[0 .. start // page]`` of the
layer's head-major pool ``[n_kv_heads, num_pages, page, hd]`` (the
chunk's own page already written). On a CUDA tensor
``prefill_attention`` launches ``csrc/prefill_attention.cu``, which reads
the pool in place through the table, only the pages up to the chunk's
own, and maps each query head to its kv head (no gather, no GQA copy, the
scores never in device memory); on a CPU tensor it runs
``prefill_attention_reference``, the plain PyTorch version: dense
attention over the gathered pages through the chunk's own, in the math of
the engine's gather route (``serving.decoder_forward``).

The kernel replaces no TPU kernel: the reference's chunk attention is
XLA's dense attention over the whole table (``tpumon/loadgen/paged_kv.py``
``paged_prefill``). Its bound and design are in the source's note. It has
instances for bfloat16 at head dims 64 and 128 with a page that is a
multiple of its 128-row K tile (``takes``); the engine routes a chunk
through it only there (``paged_kv.prefill_reads_kernel``), the same way
on the CPU and on the card.
"""

from __future__ import annotations

import ctypes

import torch

from tpumon_torch.ops import _build

_NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
K_TILE = 128  # rows of a K/V tile (csrc/prefill_attention.cu kBN)


def takes(dtype: torch.dtype, head_dim: int, page: int) -> bool:
    """Whether the kernel has an instance for a pool of this element type,
    head dim and page size."""
    return (dtype == torch.bfloat16 and head_dim in KERNEL_HEAD_DIMS
            and page % K_TILE == 0)


def prefill_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, table_row: torch.Tensor,
                                start: int) -> torch.Tensor:
    """Dense oracle over the pages through the chunk's own: gathered K and
    V repeated to every query head, scores in q's dtype then f32 over
    sqrt(hd), rows past each query's position at -1e30, f32 softmax
    rounded to q's dtype before P V."""
    _, p, nh, hd = q.shape
    nkv, _, page, _ = k_pool.shape
    n = start // page + 1  # pages through the chunk's own
    rows = table_row[:n].long()
    s = n * page
    k = k_pool[:, rows].reshape(nkv, s, hd).transpose(0, 1)[None]
    v = v_pool[:, rows].reshape(nkv, s, hd).transpose(0, 1)[None]
    if nh != nkv:
        k = torch.repeat_interleave(k, nh // nkv, dim=2)
        v = torch.repeat_interleave(v, nh // nkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / (hd**0.5)
    pos = start + torch.arange(p, device=q.device)
    key = torch.arange(s, device=q.device)
    mask = (key[None, :] <= pos[:, None])[None, None]  # [1, 1, P, S]
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check(q, k_pool, v_pool, table_row, start) -> None:
    """Reject what neither version computes; raises ValueError."""
    if q.dim() != 4 or q.shape[0] != 1 or k_pool.dim() != 4:
        raise ValueError(
            f"q must be [1, P, n_heads, hd] and the pools [n_kv_heads, pages, "
            f"page, hd]; got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    _, p, nh, hd = q.shape
    nkv, _, page, hd2 = k_pool.shape
    if v_pool.shape != k_pool.shape or hd2 != hd:
        raise ValueError(
            f"K/V pools must share a shape with q's head_dim; got q "
            f"{tuple(q.shape)}, k {tuple(k_pool.shape)}, "
            f"v {tuple(v_pool.shape)}")
    if nh % nkv:
        raise ValueError(f"n_heads={nh} is not a multiple of n_kv_heads={nkv}")
    if q.dtype not in (torch.float32, torch.bfloat16) or (
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype):
        raise ValueError(
            f"q/k/v must all be float32 or bfloat16; got {q.dtype}, "
            f"{k_pool.dtype}, {v_pool.dtype}")
    if table_row.dim() != 1 or table_row.dtype != torch.int32:
        raise ValueError(
            f"table_row must be int32 [max_pages]; got {table_row.dtype} "
            f"{tuple(table_row.shape)}")
    if not 1 <= p <= page:
        raise ValueError(f"the chunk's {p} rows must be 1 to the page's {page}")
    if start < 0 or start % page or start // page >= table_row.shape[0]:
        raise ValueError(
            f"start={start} must be a multiple of the page ({page}) inside "
            f"the table's {table_row.shape[0]} pages")
    tensors = (q, k_pool, v_pool, table_row)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("prefill_attention takes contiguous tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("prefill_attention's tensors must share one device")


def prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, table_row: torch.Tensor,
                      start: int) -> torch.Tensor:
    """One chunk's causal attention over its sequence's pages.

    q: [1, P, n_heads, hd], P <= page; k_pool/v_pool: one layer's pool
    [n_kv_heads, num_pages, page, hd], the chunk's rows already written;
    table_row: [max_pages] int32 page ids of the sequence on q's device;
    start: the chunk's first sequence row, a multiple of the page (a host
    int). Returns [1, P, n_heads, hd] in q's dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (and counts the launch in ``prefill_attention.launches``) or
    raises a ValueError where the kernel has no instance (``takes``):
    there is no fallback. Nothing is read back to the host.
    """
    _check(q, k_pool, v_pool, table_row, start)
    if q.device.type == "cpu":
        return prefill_attention_reference(q, k_pool, v_pool, table_row,
                                           start)
    if q.device.type != "cuda":
        raise ValueError(
            f"prefill_attention runs on cpu or cuda, not {q.device}")
    if not takes(q.dtype, q.shape[3], k_pool.shape[2]):
        raise ValueError(
            f"the CUDA kernel takes bfloat16 at head_dim {KERNEL_HEAD_DIMS} "
            f"with a page that is a multiple of {K_TILE}; got {q.dtype}, "
            f"head_dim {q.shape[3]}, page {k_pool.shape[2]}")
    return _launch(q, k_pool, v_pool, table_row, start)


def _kernel():
    """The built library and its launcher, with its C signature set."""
    lib = _build.load("prefill_attention")
    fn = lib.tpumon_prefill_attention
    if fn.argtypes is None:
        # q, k, v, table, out; P, heads, kv heads, pages, page, head dim,
        # start; stream.
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def kernel_config(head_dim: int) -> dict:
    """The kernel's dynamic shared memory, its K/V stages and its q and k
    tile rows at ``head_dim``. Builds the library (needs nvcc)."""
    lib = _build.load("prefill_attention")
    fn = lib.tpumon_prefill_attention_config
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    _build.check(lib, fn(head_dim, ctypes.addressof(out)),
                 "prefill_attention config")
    return {"smem_bytes": out[0], "stages": out[1], "q_rows": out[2],
            "k_rows": out[3]}


def _launch(q, k_pool, v_pool, table_row, start: int) -> torch.Tensor:
    """The kernel on checked CUDA tensors: one launch, no device-to-host
    copy."""
    _, p, nh, hd = q.shape
    nkv, num_pages, page, _ = k_pool.shape
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("the CUDA kernel needs 16-byte aligned q/k/v")
    out = torch.empty_like(q)
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 table_row.data_ptr(), out.data_ptr(), p, nh, nkv, num_pages,
                 page, hd, start, stream.cuda_stream)
    _build.check(lib, err, "prefill_attention launch")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
