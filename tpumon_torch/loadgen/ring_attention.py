"""The online-softmax block update, the plain attention oracle and the
paged ring decode read.

Counterpart of three pieces of ``tpumon/loadgen/ring_attention.py``:
``_block_attend``, one online-softmax accumulation step (``loadgen.model``'s
``attention="chunked"`` streams K/V blocks through it, and so does the
ring read below, with a per-row query offset); ``reference_attention``,
plain full-sequence softmax attention; and ``paged_ring_decode_attend``,
the serving engine's ring read path (``ServeConfig.paged_attn="ring"``).
The sequence-parallel ring and zigzag training schedules are multi-GPU
work, not yet ported (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

_NEG_INF = float("-inf")


def _block_attend(q, k, v, q_off, k_off, scale, causal, m, l, o):
    """One online-softmax accumulation step.

    q: [B, Tq, H, D], k/v: [B, Tk, H, D]; m/l: [B, H, Tq] f32; o: [B, Tq,
    H, D] f32. q_off/k_off are the blocks' global sequence offsets (ints),
    except that q_off may also be a [B] tensor — per-slot decode
    frontiers, the paged ring read — which masks per batch row. Masked
    scores are -inf and every exponent of one is guarded to 0, so a fully
    masked row keeps m = -inf and contributes nothing. Returns (m, l, o).
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        rows = torch.arange(tq, device=q.device)[:, None]
        kpos = k_off + torch.arange(tk, device=q.device)[None, :]
        if isinstance(q_off, torch.Tensor) and q_off.ndim == 1:
            keep = (q_off[:, None, None] + rows >= kpos)[:, None]
        else:
            keep = (q_off + rows >= kpos)[None, None]
        s = torch.where(keep, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))  # [B, H, Tq]
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.where(torch.isneginf(s), 0.0, torch.exp(s - m_safe[..., None]))
    corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    l_new = l * corr + p.sum(-1)
    # corr: [B, H, Tq] -> broadcast over o's [B, Tq, H, D] layout.
    o_new = o * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float())
    return m_new, l_new, o_new


def reference_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Plain full-sequence softmax attention (the correctness oracle);
    q/k/v [B, T, H, D], returned in q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / d**0.5
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None, None], s, _NEG_INF)
    probs = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def paged_ring_decode_attend(pk: torch.Tensor, pv: torch.Tensor,
                             q: torch.Tensor, tables: torch.Tensor,
                             positions: torch.Tensor) -> torch.Tensor:
    """Single-query decode attention over one layer of a paged pool, the
    table's pages visited one logical page at a time through the
    online-softmax accumulator: the engine's ring read path
    (``ServeConfig.paged_attn="ring"``), the reference's block order and
    accumulation. Not bitwise equal to the gather read (the online
    softmax reassociates the reduction).

    pk/pv: [nkv, num_pages, ps, hd]; q: [B, 1, nh, hd]; tables: [B,
    max_pages]; positions: [B] decode frontiers. Rows past a slot's
    frontier — every unreserved logical page too, whose table entry points
    at the trash page — are masked per batch row by the [B] ``q_off`` form
    of ``_block_attend``. Returns [B, 1, nh, hd] in q's dtype.
    """
    nkv, _, ps, hd = pk.shape
    b, _, nh, _ = q.shape
    kv_rep = nh // nkv
    scale = 1.0 / hd**0.5
    m = torch.full((b, nh, 1), _NEG_INF, device=q.device)
    el = torch.zeros((b, nh, 1), device=q.device)
    o = torch.zeros((b, 1, nh, hd), device=q.device)
    idx = tables.long()
    for j in range(idx.shape[1]):  # one logical page of every slot
        kb = pk[:, idx[:, j]].permute(1, 2, 0, 3)  # [B, ps, nkv, hd]
        vb = pv[:, idx[:, j]].permute(1, 2, 0, 3)
        if kv_rep > 1:
            kb = torch.repeat_interleave(kb, kv_rep, dim=2)
            vb = torch.repeat_interleave(vb, kv_rep, dim=2)
        m, el, o = _block_attend(q, kb, vb, positions, j * ps, scale, True,
                                 m, el, o)
    # Every slot attends at least its own frontier row, so l > 0.
    return (o / el.transpose(1, 2)[..., None]).to(q.dtype)
