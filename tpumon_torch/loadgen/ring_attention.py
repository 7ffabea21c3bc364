"""The online-softmax block update and the plain attention oracle.

Counterpart of the two pieces of ``tpumon/loadgen/ring_attention.py``
that the single-GPU chunked training schedule needs: ``_block_attend``,
one online-softmax accumulation step (``loadgen.model``'s
``attention="chunked"`` streams K/V blocks through it), and
``reference_attention``, plain full-sequence softmax attention. The ring
and zigzag schedules and the paged ring decode are multi-GPU work, not yet
ported (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import torch

_NEG_INF = float("-inf")


def _block_attend(q, k, v, q_off, k_off, scale, causal, m, l, o):
    """One online-softmax accumulation step.

    q: [B, Tq, H, D], k/v: [B, Tk, H, D]; m/l: [B, H, Tq] f32; o: [B, Tq,
    H, D] f32. q_off/k_off are the blocks' global sequence offsets (ints;
    the reference's per-row [B] q_off serves the paged ring decode, not
    ported). Masked scores are -inf and every exponent of one is guarded
    to 0, so a fully masked row keeps m = -inf and contributes nothing.
    Returns (m, l, o).
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qpos = q_off + torch.arange(tq, device=q.device)[:, None]
        kpos = k_off + torch.arange(tk, device=q.device)[None, :]
        s = torch.where((qpos >= kpos)[None, None], s, _NEG_INF)
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
