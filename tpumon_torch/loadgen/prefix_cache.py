"""Prefix caching for the dense KV cache: reuse prompt K/V across requests
that share a prefix.

Counterpart of ``tpumon/loadgen/prefix_cache.py``. After a prompt is
prefilled, the K/V rows of its chunk-aligned strict prefix are copied out
of its cache slot (``_extract``); a later prompt starting with the same
tokens copies them back into its own slot (``_restore``, one device copy
each way) and prefills only the tail. Keys are exact token tuples at chunk
boundaries, so a restored row is bit-identical to the prefill that wrote
it, and the chunk holding the prompt's last token is always recomputed,
so prefill still yields first-token logits. Entries pin device memory in
a bounded LRU. (The paged layout shares pages instead:
``paged_kv.PagePrefixCache``.)
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import torch


def _restore(cache_kv: torch.Tensor, slot: int, block: torch.Tensor) -> None:
    """Write ``block`` [layers, rows, nkv, hd] into rows 0..rows-1 of
    ``slot`` of cache_kv [layers, slots, seq, nkv, hd], in place."""
    cache_kv[:, slot, :block.shape[1]] = block


def _extract(cache_kv: torch.Tensor, slot: int, rows: int) -> torch.Tensor:
    """A copy of rows 0..rows-1 of ``slot`` -> [layers, rows, nkv, hd]."""
    return cache_kv[:, slot, :rows].clone()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class PrefixCache:
    """Bounded LRU of chunk-aligned prompt-prefix K/V blocks; ``chunk`` is
    the engine's prefill_len, keys ``tuple(prompt[:m])``, m a multiple of
    chunk."""

    chunk: int
    max_entries: int = 16
    _store: OrderedDict = field(default_factory=OrderedDict)
    hits: int = 0
    misses: int = 0
    saved_tokens: int = 0
    _resident: int = 0  # bytes, kept incrementally for /metrics readers

    def cached_prefix_len(self, prompt: list[int]) -> int:
        """Longest cached chunk-aligned strict prefix of ``prompt``."""
        n = len(prompt)
        m = ((n - 1) // self.chunk) * self.chunk
        while m >= self.chunk:
            if tuple(prompt[:m]) in self._store:
                return m
            m -= self.chunk
        return 0

    def peek(self, prompt: list[int]) -> int:
        """The prefix length ``restore`` would serve, with no LRU touch and
        no hit/miss count (the scheduler's side-effect-free probe)."""
        return self.cached_prefix_len(prompt)

    def restore(self, cache: dict, prompt: list[int], slot: int) -> int:
        """If a prefix of ``prompt`` is cached, copy it into ``slot`` of
        ``cache`` (in place) and return its length, else 0."""
        m = self.cached_prefix_len(prompt)
        if not m:
            self.misses += 1
            return 0
        key = tuple(prompt[:m])
        blocks = self._store[key]
        self._store.move_to_end(key)  # LRU touch
        for name in ("k", "v"):
            _restore(cache[name], slot, blocks[name])
        self.hits += 1
        self.saved_tokens += m
        return m

    def store(self, cache: dict, prompt: list[int], slot: int) -> None:
        """Snapshot the chunk-aligned strict prefix of ``prompt`` from
        ``slot`` (a no-op if already cached or shorter than one chunk)."""
        n = len(prompt)
        m = ((n - 1) // self.chunk) * self.chunk
        if m < self.chunk:
            return
        key = tuple(prompt[:m])
        if key in self._store:
            self._store.move_to_end(key)
            return
        blocks = {name: _extract(cache[name], slot, m)
                  for name in ("k", "v")}
        self._store[key] = blocks
        self._resident += sum(_nbytes(b) for b in blocks.values())
        while len(self._store) > self.max_entries:
            _, evicted = self._store.popitem(last=False)
            self._resident -= sum(_nbytes(b) for b in evicted.values())

    @property
    def entries(self) -> int:
        return len(self._store)

    def resident_bytes(self) -> int:
        return self._resident
