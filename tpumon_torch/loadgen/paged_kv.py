"""Paged KV cache mode for the serving engine.

Counterpart of ``tpumon/loadgen/paged_kv.py``. Requests reserve fixed-size
pages (page == prefill chunk) from a shared head-major pool
``[layers, kv_heads, num_pages, page, hd]`` for their lifetime; per-slot
page tables are host-owned ints shipped as one ``[slots, max_pages]``
int32 device tensor. Decode attention has two read paths, selected by
``ServeConfig.paged_attn``: ``"gather"`` gathers the table's pages and
attends densely (the plain version); ``"kernel"`` routes the decode step
through ``tpumon_torch.ops.paged_attention``, the hand-written CUDA kernel
that reads pages in place. The append is the same batched scatter at
``(page, offset)`` per slot either way. ``paged_decode_block`` (T tokens a
slot, always the gather read) and ``paged_decode_rounds`` (fused block
decode: ``steps`` decode steps and samples, no host sync) complete the
reference's paged functions.

JAX donates the pool to each jitted call and gets it back; here the pool
dict's tensors are updated IN PLACE, so the paged functions return only
their logits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from tpumon_torch.ops.paged_attention import paged_attention


@dataclass
class PageAllocator:
    """Host-side refcounted free-list allocator over the shared pool.

    Pages are refcounted so a prefix cache can SHARE a cached prompt
    prefix's pages across requests (and pin them itself): alloc gives
    each page one reference, ``retain`` adds one per additional user, and
    ``release`` only returns a page to the free list when its last
    reference drops. The free-list order is the reference's exactly, so
    both packages hand out the same page ids.
    """

    num_pages: int
    _free: list[int] = field(default_factory=list)
    _refs: dict = field(default_factory=dict)

    def __post_init__(self):
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._refs = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """n fresh pages (refcount 1 each), or None if not enough free."""
        if n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        for pg in taken:
            self._refs[pg] = 1
        return taken

    def retain(self, pages: list[int]) -> None:
        """Add a reference per page (a new sharer)."""
        for pg in pages:
            self._refs[pg] += 1

    def release(self, pages: list[int]) -> None:
        """Drop a reference per page; last reference frees the page."""
        for pg in pages:
            left = self._refs[pg] - 1
            if left:
                self._refs[pg] = left
            else:
                del self._refs[pg]
                self._free.append(pg)


def init_pool(cfg, num_pages: int, device: str | torch.device) -> dict:
    """Zeroed compute-dtype pool ``{"k", "v"}``, each
    ``[layers, kv_heads, num_pages, page, hd]`` on ``device``."""
    if cfg.kv_dtype != "compute":
        raise NotImplementedError(
            "the int8 KV pool is not yet ported (ROADMAP queue 1 item 8)")
    m = cfg.model
    shape = (m.n_layers, m.n_kv_heads, num_pages, cfg.prefill_len,
             m.head_dim)
    return {"k": torch.zeros(shape, dtype=m.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=m.torch_dtype, device=device)}


def paged_prefill(cfg, params: dict, pool: dict, tokens: torch.Tensor,
                  length: int, page_id: int, table_row: torch.Tensor,
                  start: int) -> torch.Tensor:
    """One prompt chunk into fresh page ``page_id`` of one sequence.

    tokens: [page_size] int32 padded chunk; length: true tokens in this
    chunk; page_id: the fresh page this chunk fills; table_row:
    [max_pages] int32 — the sequence's table with page_id already at
    position start//page_size (later entries may be anything — masked);
    start: global row of the chunk's first token. Writes the chunk's K/V
    into the pool in place and returns logits[vocab] (f32) at local
    position length-1.
    """
    from tpumon_torch.loadgen.serving import decoder_forward

    m = cfg.model
    p = cfg.prefill_len  # == page_size
    dev = tokens.device
    nkv, hd = m.n_kv_heads, m.head_dim
    s_max = table_row.shape[0] * p
    rows = table_row.long()

    pos = start + torch.arange(p, dtype=torch.int32, device=dev)[None]
    row = torch.arange(s_max, dtype=torch.int32, device=dev)
    mask = (row[None, :] <= pos[0][:, None])[None, None]  # [1,1,P,S]

    def kv_update(li, k, v):
        # Write the chunk into its fresh page, then attend over the
        # sequence's pages (this chunk's page included).
        pool["k"][li, :, page_id] = k[0].transpose(0, 1)  # [nkv, ps, hd]
        pool["v"][li, :, page_id] = v[0].transpose(0, 1)
        ck = pool["k"][li][:, rows]  # [nkv, max_pages, ps, hd]
        cv = pool["v"][li][:, rows]
        ck = ck.reshape(nkv, s_max, hd).transpose(0, 1)[None]
        cv = cv.reshape(nkv, s_max, hd).transpose(0, 1)[None]
        return ck, cv  # [1, S, nkv, hd]

    x = decoder_forward(cfg, params, tokens[None], pos, mask, kv_update)
    last = x[0, length - 1]
    return (last @ params["lm_head"].to(m.torch_dtype)).float()


def paged_decode_step(cfg, params: dict, pool: dict,
                      last_tokens: torch.Tensor, positions: torch.Tensor,
                      tables: torch.Tensor) -> torch.Tensor:
    """Advance every slot one token over the paged pool.

    last_tokens/positions: [B] int32; tables: [B, max_pages] int32
    per-slot page tables. The new token's K/V is scattered (in place) to
    (tables[b, positions[b]//ps], positions[b]%ps); the page must
    already be reserved. Returns logits [B, vocab] (f32).

    ``cfg.paged_attn="kernel"`` swaps the gather read for the paged
    attention kernel; the scatter-write is identical either way.
    """
    from tpumon_torch.loadgen.serving import decoder_forward

    m = cfg.model
    ps = cfg.prefill_len
    s_max = tables.shape[1] * ps
    dev = tables.device

    page = torch.gather(tables, 1, (positions // ps)[:, None].long())[:, 0]
    page = page.long()
    off = (positions % ps).long()
    pos = positions[:, None]
    row = torch.arange(s_max, dtype=torch.int32, device=dev)
    mask = (row[None] <= positions[:, None])[:, None, None]  # [B,1,1,S]

    def scatter(li, k, v):
        # Batched scatter pool[li, :, page[b], off[b]] = kv[b] with the
        # value batch-first [B, nkv, hd], as in the reference. Torch puts
        # the broadcast batch dim where the adjacent index tensors sit
        # (not first, as numpy/JAX do when an int separates them), so
        # index a [pages, ps, nkv, hd] view of the layer instead.
        for name, new in (("k", k), ("v", v)):
            pool[name][li].permute(1, 2, 0, 3)[page, off] = new[:, 0]

    def kv_update(li, k, v):
        scatter(li, k, v)
        return _gather_context(pool, li, tables)  # [B, S, nkv, hd]

    attend = None
    if cfg.paged_attn == "kernel":
        lengths = positions + 1  # rows 0..positions inclusive

        def attend(li, q, k, v):
            scatter(li, k, v)
            out = paged_attention(q[:, 0], pool["k"][li], pool["v"][li],
                                  tables, lengths)
            return out[:, None]  # [B, 1, nh, hd]
    elif cfg.paged_attn != "gather":
        raise NotImplementedError(
            f"paged_attn={cfg.paged_attn!r} is not yet ported (ROADMAP "
            "queue 1 item 12)")

    x = decoder_forward(cfg, params, last_tokens[:, None], pos, mask,
                        kv_update, attend=attend)
    return (x[:, 0] @ params["lm_head"].to(m.torch_dtype)).float()


def _gather_context(pool: dict, li: int, tables: torch.Tensor):
    """Layer ``li``'s context through the tables: K and V as [B, S, nkv,
    hd], S = max_pages * page_size."""
    nkv, _, ps, hd = pool["k"].shape[1:]
    b, max_pages = tables.shape
    idx = tables.long()
    return tuple(
        pool[name][li][:, idx].reshape(nkv, b, max_pages * ps, hd)
        .permute(1, 2, 0, 3) for name in ("k", "v"))


def paged_decode_block(cfg, params: dict, pool: dict, tokens: torch.Tensor,
                       positions: torch.Tensor,
                       tables: torch.Tensor) -> torch.Tensor:
    """Advance every slot ``T`` tokens in one pass over the paged pool —
    the paged twin of ``speculative.decode_block``. tokens: [B, T]
    (tokens[:, 0] is the feed token at row ``positions``); returns f32
    logits [B, T, vocab], logits[:, t] predicting row positions + t + 1.

    Each token's K/V scatters (in place) to its own (page, offset)
    through the slot's table, so a block may cross a page boundary; rows
    clamp at the table's last row, and rows past a request's reservation
    land on the trash page its table holds there. A multi-token query
    always takes the gather read, as in the reference.
    """
    from tpumon_torch.loadgen.serving import decoder_forward

    m = cfg.model
    ps = cfg.prefill_len
    t_blk = tokens.shape[1]
    s_max = tables.shape[1] * ps
    dev = tokens.device
    pos = positions[:, None] + torch.arange(
        t_blk, dtype=torch.int32, device=dev)[None]
    pos = torch.clamp(pos, max=s_max - 1)  # [B, T]
    page = torch.gather(tables, 1, (pos // ps).long()).long()
    off = (pos % ps).long()
    row = torch.arange(s_max, dtype=torch.int32, device=dev)
    mask = (row[None, None] <= pos[:, :, None])[:, None]  # [B, 1, T, S]

    def kv_update(li, k, v):
        # One batched scatter per block position, in the reference's
        # order (K's positions, then V's), on the [pages, ps, nkv, hd]
        # view paged_decode_step writes through.
        for name, new in (("k", k), ("v", v)):
            view = pool[name][li].permute(1, 2, 0, 3)
            for tt in range(t_blk):
                view[page[:, tt], off[:, tt]] = new[:, tt]
        return _gather_context(pool, li, tables)

    x = decoder_forward(cfg, params, tokens, pos, mask, kv_update)
    return (x @ params["lm_head"].to(m.torch_dtype)).float()


def paged_decode_rounds(cfg, params: dict, pool: dict,
                        last_tokens: torch.Tensor, positions: torch.Tensor,
                        tables: torch.Tensor, base_key: torch.Tensor,
                        rids: torch.Tensor, ctr0: torch.Tensor,
                        temps: torch.Tensor, topks: torch.Tensor,
                        steps: int, seq_cap: int = 0) -> tuple:
    """``steps`` (paged_decode_step -> sample_tokens) pairs with no host
    sync — the paged twin of ``serving.decode_rounds``, over
    loop-invariant tables (pages are reserved for the whole request at
    admission; rows past the reservation land on the trash page).
    ``cfg.paged_attn="kernel"`` launches the paged-attention kernel once
    per layer and step. Positions clamp at ``seq_cap`` - 1 (0: max_seq).
    Returns (last tokens, positions, tokens [B, steps])."""
    from tpumon_torch.loadgen.serving import sample_tokens

    cap = seq_cap or cfg.model.max_seq
    out = []
    last, pos, ctr = last_tokens, positions, ctr0
    for _ in range(steps):
        logits = paged_decode_step(cfg, params, pool, last, pos, tables)
        last = sample_tokens(logits, base_key, rids, ctr, temps, topks)
        pos = torch.clamp(pos + 1, max=cap - 1)
        ctr = ctr + 1
        out.append(last)
    return last, pos, torch.stack(out, dim=1)
