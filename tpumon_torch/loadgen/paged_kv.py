"""Paged KV cache mode for the serving engine.

Counterpart of ``tpumon/loadgen/paged_kv.py``. Requests reserve fixed-size
pages (page == prefill chunk) from a shared head-major pool
``[layers, kv_heads, num_pages, page, hd]`` for their lifetime; per-slot
page tables are host-owned ints shipped as one ``[slots, max_pages]``
int32 device tensor. Decode attention has three read paths, selected by
``ServeConfig.paged_attn``: ``"gather"`` gathers the table's pages and
attends densely (the plain version); ``"kernel"`` routes the decode step
through ``tpumon_torch.ops.paged_attention``, the hand-written CUDA kernel
that reads pages in place; ``"ring"`` visits the table's pages one at a
time through the online-softmax accumulator
(``ring_attention.paged_ring_decode_attend``), the ring engine mode's read
path. The append is the same batched scatter at ``(page, offset)`` per
slot either way. Over a tensor-parallel mesh the pool is the list of the
shards' pools, each holding its n_kv_heads/tp heads on its device, and
every function here takes the shards' param and pool lists
(``serving.decoder_forward``); the page tables replicate. ``paged_decode_block`` (T tokens a
slot, always the gather read) and ``paged_decode_rounds`` (fused block
decode: ``steps`` decode steps and samples, no host sync) complete the
reference's paged functions. ``ServeConfig.kv_dtype="int8"`` gives an int8
pool with per-(row, kv head) f32 scales (``"ks"``/``"vs"``), quantized on
write and dequantized on the gather read; the kernel read path refuses it,
as the reference's does. ``PagePrefixCache`` shares a cached prompt
prefix's pages into new requests' tables, refcounted, with no copy.

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


def init_pool(cfg, num_pages: int, device: str | torch.device,
              kv_heads: int | None = None) -> dict:
    """Zeroed pool ``{"k", "v"}``, each ``[layers, kv_heads, num_pages,
    page, hd]`` on ``device``: the compute dtype, or (``kv_dtype="int8"``)
    int8 rows plus f32 scales ``{"ks", "vs"}`` of shape ``[layers,
    kv_heads, num_pages, page]``. ``kv_heads`` overrides the config's for
    one shard of a mesh."""
    m = cfg.model
    shape = (m.n_layers, kv_heads or m.n_kv_heads, num_pages,
             cfg.prefill_len, m.head_dim)
    if cfg.kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:-1], device=device),
                "vs": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=m.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=m.torch_dtype, device=device)}


def prefill_rows(table_row: torch.Tensor, page: int) -> int:
    """Rows of its sequence that one ``paged_prefill`` chunk gathers and
    attends over: every page of the table, whatever the chunk's end."""
    return table_row.shape[0] * page


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
    from tpumon_torch.loadgen.serving import (
        _kv_dequant,
        _kv_quant,
        _logits,
        _per_store,
        decoder_forward,
    )

    p = cfg.prefill_len  # == page_size
    dev = tokens.device
    s_max = prefill_rows(table_row, p)

    pos = start + torch.arange(p, dtype=torch.int32, device=dev)[None]
    row = torch.arange(s_max, dtype=torch.int32, device=dev)
    mask = (row[None, :] <= pos[0][:, None])[None, None]  # [1,1,P,S]

    def make(pool):
        rows = table_row.long().to(pool["k"].device)
        quant = "ks" in pool  # the int8 pool (init_pool)

        def kv_update(li, k, v):
            # Write the chunk into its fresh page, then attend over the
            # sequence's pages (this chunk's page included).
            nkv, hd = k.shape[2], k.shape[3]
            for name, sname, new in (("k", "ks", k), ("v", "vs", v)):
                if quant:
                    new, scale = _kv_quant(new)
                    pool[sname][li, :, page_id] = scale[0].transpose(0, 1)
                pool[name][li, :, page_id] = new[0].transpose(0, 1)
            ck = pool["k"][li][:, rows]  # [nkv, max_pages, ps, hd]
            cv = pool["v"][li][:, rows]
            if quant:
                ck = _kv_dequant(ck, pool["ks"][li][:, rows], k.dtype)
                cv = _kv_dequant(cv, pool["vs"][li][:, rows], v.dtype)
            ck = ck.reshape(nkv, s_max, hd).transpose(0, 1)[None]
            cv = cv.reshape(nkv, s_max, hd).transpose(0, 1)[None]
            return ck, cv  # [1, S, nkv, hd]
        return kv_update

    x = decoder_forward(cfg, params, tokens[None], pos, mask,
                        _per_store(pool, make))
    return _logits(cfg, params, x, (0, length - 1))


def paged_decode_step(cfg, params: dict, pool: dict,
                      last_tokens: torch.Tensor, positions: torch.Tensor,
                      tables: torch.Tensor) -> torch.Tensor:
    """Advance every slot one token over the paged pool.

    last_tokens/positions: [B] int32; tables: [B, max_pages] int32
    per-slot page tables. The new token's K/V is scattered (in place) to
    (tables[b, positions[b]//ps], positions[b]%ps); the page must
    already be reserved. Returns logits [B, vocab] (f32).

    ``cfg.paged_attn="kernel"`` swaps the gather read for the paged
    attention kernel, ``"ring"`` for the page-at-a-time online softmax of
    ``ring_attention.paged_ring_decode_attend``; the scatter-write is
    identical either way. Neither reads an int8 pool.
    """
    from tpumon_torch.loadgen.ring_attention import paged_ring_decode_attend
    from tpumon_torch.loadgen.serving import (
        _kv_quant,
        _logits,
        _per_store,
        decoder_forward,
    )

    ps = cfg.prefill_len
    s_max = tables.shape[1] * ps
    dev = tables.device
    if cfg.paged_attn not in ("gather", "kernel", "ring"):
        raise ValueError(f"unknown paged_attn {cfg.paged_attn!r}")
    quant = "ks" in (pool[0] if isinstance(pool, list) else pool)
    if quant and cfg.paged_attn != "gather":
        raise ValueError(
            f"paged_attn={cfg.paged_attn!r} cannot read a quantized (int8) "
            "pool; use the gather path or a compute-dtype pool")

    page_all = torch.gather(tables, 1,
                            (positions // ps)[:, None].long())[:, 0].long()
    off_all = (positions % ps).long()
    pos = positions[:, None]
    row = torch.arange(s_max, dtype=torch.int32, device=dev)
    mask = (row[None] <= positions[:, None])[:, None, None]  # [B,1,1,S]

    def make_scatter(pool):
        page, off = page_all.to(pool["k"].device), off_all.to(
            pool["k"].device)

        def scatter(li, k, v):
            # Batched scatter pool[li, :, page[b], off[b]] = kv[b] with the
            # value batch-first [B, nkv, hd], as in the reference. Torch
            # puts the broadcast batch dim where the adjacent index
            # tensors sit (not first, as numpy/JAX do when an int
            # separates them), so index a [pages, ps, nkv, hd] view of the
            # layer instead.
            for name, sname, new in (("k", "ks", k), ("v", "vs", v)):
                if quant:
                    new, scale = _kv_quant(new)
                    pool[sname][li].permute(1, 2, 0)[page, off] = (
                        scale[:, 0])
                pool[name][li].permute(1, 2, 0, 3)[page, off] = new[:, 0]
        return scatter

    def make_update(pool):
        scatter = make_scatter(pool)

        def kv_update(li, k, v):
            scatter(li, k, v)
            return _gather_context(pool, li, tables, k.dtype)
        return kv_update

    def make_attend(pool):
        scatter = make_scatter(pool)
        pdev = pool["k"].device
        tab, at = tables.to(pdev), positions.to(pdev)
        lengths = at + 1  # rows 0..positions inclusive

        def attend(li, q, k, v):
            scatter(li, k, v)
            if cfg.paged_attn == "ring":
                return paged_ring_decode_attend(
                    pool["k"][li], pool["v"][li], q, tab, at)
            out = paged_attention(q[:, 0], pool["k"][li], pool["v"][li],
                                  tab, lengths)
            return out[:, None]  # [B, 1, nh, hd]
        return attend

    if cfg.paged_attn == "gather":
        kv_update, attend = _per_store(pool, make_update), None
    else:
        kv_update, attend = None, _per_store(pool, make_attend)
    x = decoder_forward(cfg, params, last_tokens[:, None], pos, mask,
                        kv_update, attend=attend)
    return _logits(cfg, params, x, (slice(None), 0))


def _gather_context(pool: dict, li: int, tables: torch.Tensor, dt):
    """Layer ``li``'s context through the tables: K and V as [B, S, nkv,
    hd] in ``dt``, S = max_pages * page_size (an int8 pool dequantized)."""
    from tpumon_torch.loadgen.serving import _kv_dequant

    nkv, _, ps, hd = pool["k"].shape[1:]
    b, max_pages = tables.shape
    idx = tables.long().to(pool["k"].device)
    out = []
    for name, sname in (("k", "ks"), ("v", "vs")):
        ctx = pool[name][li][:, idx]  # [nkv, B, max_pages, ps, hd]
        if sname in pool:
            ctx = _kv_dequant(ctx, pool[sname][li][:, idx], dt)
        out.append(ctx.reshape(nkv, b, max_pages * ps, hd)
                   .permute(1, 2, 0, 3))
    return tuple(out)


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
    from tpumon_torch.loadgen.serving import (
        _kv_quant,
        _logits,
        _per_store,
        decoder_forward,
    )

    ps = cfg.prefill_len
    t_blk = tokens.shape[1]
    s_max = tables.shape[1] * ps
    dev = tokens.device
    pos = positions[:, None] + torch.arange(
        t_blk, dtype=torch.int32, device=dev)[None]
    pos = torch.clamp(pos, max=s_max - 1)  # [B, T]
    page_all = torch.gather(tables, 1, (pos // ps).long()).long()
    off_all = (pos % ps).long()
    row = torch.arange(s_max, dtype=torch.int32, device=dev)
    mask = (row[None, None] <= pos[:, :, None])[:, None]  # [B, 1, T, S]

    def make(pool):
        quant = "ks" in pool  # the int8 pool (init_pool)
        page, off = page_all.to(pool["k"].device), off_all.to(
            pool["k"].device)

        def kv_update(li, k, v):
            # One batched scatter per block position, in the reference's
            # order (K's positions, then V's), on the [pages, ps, nkv, hd]
            # view paged_decode_step writes through.
            for name, sname, new in (("k", "ks", k), ("v", "vs", v)):
                if quant:
                    new, scale = _kv_quant(new)  # scale: [B, T, nkv]
                    sview = pool[sname][li].permute(1, 2, 0)
                view = pool[name][li].permute(1, 2, 0, 3)
                for tt in range(t_blk):
                    if quant:
                        sview[page[:, tt], off[:, tt]] = scale[:, tt]
                    view[page[:, tt], off[:, tt]] = new[:, tt]
            return _gather_context(pool, li, tables, k.dtype)
        return kv_update

    x = decoder_forward(cfg, params, tokens, pos, mask,
                        _per_store(pool, make))
    return _logits(cfg, params, x)


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
    per layer and step ("ring": the ring read). Positions clamp at
    ``seq_cap`` - 1 (0: max_seq).
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


class PagePrefixCache:
    """Prefix caching for the paged layout: share pages, copy nothing.

    Because page == prefill chunk, a chunk-aligned prompt prefix is a whole
    number of pages: a later prompt that shares it points its page table
    at the SAME pages, and the allocator's refcounts keep a shared page
    alive until its last user (a cache entry or a live request) drops it.
    Keys are the exact token tuples of chunk-aligned STRICT prefixes (the
    chunk holding the prompt's last token is always recomputed). Bounded
    LRU; ``evict_one`` lets the engine reclaim pinned pages under pool
    pressure. The reference's class, line for line.
    """

    def __init__(self, chunk: int, allocator: PageAllocator,
                 max_entries: int = 16):
        from collections import OrderedDict

        self.chunk = chunk
        self.allocator = allocator
        self.max_entries = max_entries
        self._store: "OrderedDict[tuple, list[int]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.saved_tokens = 0
        self.page_bytes = 0  # set by the engine (pool bytes / page)

    def peek(self, prompt: list[int]) -> tuple[int, list[int]]:
        """(prefix_len, shared_pages) of the longest cached chunk-aligned
        strict prefix, with no retain, LRU touch or hit/miss count (the
        admission scheduler's probe). (0, []) on miss."""
        n = len(prompt)
        m = ((n - 1) // self.chunk) * self.chunk
        while m >= self.chunk:
            pages = self._store.get(tuple(prompt[:m]))
            if pages is not None:
                return m, list(pages)
            m -= self.chunk
        return 0, []

    def lookup(self, prompt: list[int]) -> tuple[int, list[int]]:
        """``peek`` plus the accounting: LRU touch, one retain of the
        shared pages for the caller (released at request completion),
        hit/miss and saved-token counters. (0, []) on miss."""
        m, pages = self.peek(prompt)
        if not m:
            self.misses += 1
            return 0, []
        self._store.move_to_end(tuple(prompt[:m]))
        self.allocator.retain(pages)
        self.hits += 1
        self.saved_tokens += m
        return m, pages

    def store(self, prompt: list[int], pages: list[int]) -> None:
        """Pin the chunk-aligned strict prefix's pages (``pages``: the
        request's full page list, one page per prefill chunk first). No-op
        if already cached or shorter than one chunk."""
        n = len(prompt)
        m = ((n - 1) // self.chunk) * self.chunk
        if m < self.chunk:
            return
        key = tuple(prompt[:m])
        if key in self._store:
            self._store.move_to_end(key)
            return
        pinned = pages[: m // self.chunk]
        self.allocator.retain(pinned)
        self._store[key] = list(pinned)
        while len(self._store) > self.max_entries:
            self.evict_one()

    def evict_one(self, protect: tuple | None = None) -> bool:
        """Drop the least-recently-used entry other than ``protect`` (its
        pages free once no live request shares them); False when nothing
        is evictable. The scheduler protects the queue head's own prefix,
        so freeing pages for the head cannot evict what it will share."""
        for key in self._store:
            if key != protect:
                pages = self._store.pop(key)
                self.allocator.release(pages)
                return True
        return False

    @property
    def entries(self) -> int:
        return len(self._store)

    def resident_bytes(self) -> int:
        pinned = {pg for pages in self._store.values() for pg in pages}
        return len(pinned) * self.page_bytes
