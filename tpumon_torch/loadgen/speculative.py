"""Multi-token decode over the dense cache.

Counterpart of the part of ``tpumon/loadgen/speculative.py`` that the
plain decode path runs: ``decode_block``, of which ``serving.decode_step``
is the T = 1 case, and the two-line ``greedy_accept_len``. The
speculative engine itself (draft proposals, the verify round) is not yet
ported (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import torch


def decode_block(cfg, params: dict, cache: dict, tokens: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Advance every slot ``T`` tokens in one pass over the dense cache.

    tokens: [B, T] int32, B == slots (tokens[:, 0] is the feed token at
    row ``positions``); positions: [B] int32 start rows. Writes the
    block's K/V into the cache in place and returns the f32 logits [B, T,
    vocab], where logits[:, t] predicts row ``positions + t + 1``; the
    mask is ``row <= positions + t``. The write is
    ``lax.dynamic_update_slice``'s per slot: its start clamps to max_seq
    - T, so a block at a parked slot's row max_seq - 1 lands on the last
    T rows, as in the reference.
    """
    from tpumon_torch.loadgen.serving import decoder_forward

    m = cfg.model
    b, t = tokens.shape
    dev = tokens.device
    steps = torch.arange(t, dtype=torch.int32, device=dev)
    pos = positions[:, None] + steps[None]  # [B, T]
    row = torch.arange(m.max_seq, dtype=torch.int32, device=dev)
    mask = (row[None, None] <= pos[:, :, None])[:, None]  # [B, 1, T, S]
    rows = positions.long().clamp(0, m.max_seq - t)[:, None] + steps.long()
    slots = torch.arange(b, device=dev)[:, None]

    def kv_update(li, k, v):
        cache["k"][li][slots, rows] = k
        cache["v"][li][slots, rows] = v
        return cache["k"][li], cache["v"][li]  # [B, S, nkv, hd]

    x = decoder_forward(cfg, params, tokens, pos, mask, kv_update)
    return (x @ params["lm_head"].to(m.torch_dtype)).float()


def greedy_accept_len(proposed: list[int], target: list[int]) -> int:
    """Longest prefix of the draft proposals the target's greedy choice
    agrees with (target[i]: the target's argmax after proposed[:i])."""
    a = 0
    while a < len(proposed) and proposed[a] == target[a]:
        a += 1
    return a
