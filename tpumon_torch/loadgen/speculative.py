"""Multi-token decode over the dense cache: the speculative verify step.

Counterpart of ``tpumon/loadgen/speculative.py``: ``decode_block``, of
which ``serving.decode_step`` is the T = 1 case and which the speculative
engine (``serving.ServingEngine._spec_round``) runs as its verify step
over [feed, proposals], and ``greedy_accept_len``. A draft proposes
``spec_len`` tokens; the target scores them in one block; the longest
agreed prefix is accepted plus the target's own next token. Under greedy
decoding the output equals plain decode whatever the draft (exactly in
f32; in bf16 the block can reassociate a sum differently from a T = 1
step and flip an argmax near-tie). Rejected rows need no rollback: the
slot's position does not advance past them, the mask hides them and
later writes overwrite them.
"""

from __future__ import annotations

import torch


def decode_block(cfg, params: dict, cache: dict, tokens: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Advance every slot ``T`` tokens in one pass over the dense cache.

    tokens: [B, T] int32, B == slots (tokens[:, 0] is the feed token at
    row ``positions``); positions: [B] int32 start rows. Writes the
    block's K/V into the cache in place (quantized, with its scales, in the
    int8 layout) and returns the f32 logits [B, T,
    vocab], where logits[:, t] predicts row ``positions + t + 1``; the
    mask is ``row <= positions + t``. The write is
    ``lax.dynamic_update_slice``'s per slot: its start clamps to max_seq
    - T, so a block at a parked slot's row max_seq - 1 lands on the last
    T rows, as in the reference. Over a tensor-parallel mesh ``params`` and
    ``cache`` are the shards' lists (``serving.decoder_forward``).
    """
    from tpumon_torch.loadgen.serving import (
        _logits,
        _per_store,
        decoder_forward,
    )

    m = cfg.model
    b, t = tokens.shape
    dev = tokens.device
    steps = torch.arange(t, dtype=torch.int32, device=dev)
    pos = positions[:, None] + steps[None]  # [B, T]
    row = torch.arange(m.max_seq, dtype=torch.int32, device=dev)
    mask = (row[None, None] <= pos[:, :, None])[:, None]  # [B, 1, T, S]
    rows_all = (positions.long().clamp(0, m.max_seq - t)[:, None]
                + steps.long())
    slots_all = torch.arange(b, device=dev)[:, None]

    def make(cache):
        rows = rows_all.to(cache["k"].device)
        slots = slots_all.to(cache["k"].device)

        def kv_update(li, k, v):
            if "ks" in cache:  # the int8 cache layout (serving.init_cache)
                from tpumon_torch.loadgen.serving import (
                    _kv_dequant,
                    _kv_quant,
                )

                for name, sname, new in (("k", "ks", k), ("v", "vs", v)):
                    qx, sx = _kv_quant(new)
                    cache[name][li][slots, rows] = qx
                    cache[sname][li][slots, rows] = sx
                return (
                    _kv_dequant(cache["k"][li], cache["ks"][li], k.dtype),
                    _kv_dequant(cache["v"][li], cache["vs"][li], v.dtype))
            cache["k"][li][slots, rows] = k
            cache["v"][li][slots, rows] = v
            return cache["k"][li], cache["v"][li]  # [B, S, nkv, hd]
        return kv_update

    x = decoder_forward(cfg, params, tokens, pos, mask,
                        _per_store(cache, make))
    return _logits(cfg, params, x)


def greedy_accept_len(proposed: list[int], target: list[int]) -> int:
    """Longest prefix of the draft proposals the target's greedy choice
    agrees with (target[i]: the target's argmax after proposed[:i])."""
    a = 0
    while a < len(proposed) and proposed[a] == target[a]:
        a += 1
    return a
