"""Ring attention: sequence-parallel attention over the devices of a mesh.

Counterpart of ``tpumon/loadgen/ring_attention.py``: ``_block_attend``,
one online-softmax accumulation step (``loadgen.model``'s
``attention="chunked"`` streams K/V blocks through it, and so do the rings
below); ``reference_attention``, plain full-sequence softmax attention;
``paged_ring_decode_attend``, the serving engine's ring read path
(``ServeConfig.paged_attn="ring"``); and the sequence-parallel schedules,
``ring_attention`` (contiguous blocks) and ``zigzag_ring_attention`` (the
load-balanced causal layout: device i holds half-blocks i and 2n-1-i, see
``zigzag_indices``), with their inner bodies ``ring_attend_inner`` and
``zigzag_attend_inner``, which ``sp_train`` calls per layer.

The reference runs each inner body inside a ``shard_map``, one program per
device, and rotates K/V with ``lax.ppermute``. Here one controller holds
every device's blocks: the inner bodies take the lists of each device's
local q/k/v blocks and return the list of outputs, each block's Q stays on
its device, and at each step device ``my`` receives the K/V block of
device ``my - 1`` by ``.to()``, the same rotation, which autograd follows
backwards. On one card (a mesh that repeats it) every copy is
device-local. The block update is plain torch, as it is jnp in the
reference, outside any Pallas kernel.
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


def _seq_devices(mesh, axis: str) -> list:
    """The devices along ``axis`` of ``mesh`` (coordinate 0 elsewhere)."""
    return [mesh.device_list[mesh.index(**{axis: i})]
            for i in range(mesh.shape[axis])]


def _split_seq(x: torch.Tensor, devs: list) -> list:
    """x [B, T, ...] cut into len(devs) sequence blocks, one on each."""
    n = len(devs)
    if x.shape[1] % n:
        raise ValueError(f"the sequence length {x.shape[1]} does not split "
                         f"over {n} devices")
    tb = x.shape[1] // n
    return [x[:, i * tb:(i + 1) * tb].to(d) for i, d in enumerate(devs)]


def _widen(x: torch.Tensor, kv_rep: int) -> torch.Tensor:
    return torch.repeat_interleave(x, kv_rep, dim=2) if kv_rep > 1 else x


def _rotate(blocks: list) -> list:
    """One step of the ring: device ``my`` receives device ``my - 1``'s
    block (the reference's ppermute over (i, i + 1))."""
    n = len(blocks)
    return [blocks[(my - 1) % n].to(blocks[my].device) for my in range(n)]


def _finish(m_l_o, dtype) -> torch.Tensor:
    _, el, o = m_l_o
    l_safe = torch.where(el == 0.0, 1.0, el)  # [B, H, Tq]
    return (o / l_safe.transpose(1, 2)[..., None]).to(dtype)


def _fresh(q: torch.Tensor, rows: int) -> tuple:
    b, _, h, d = q.shape
    return (torch.full((b, h, rows), _NEG_INF, device=q.device),
            torch.zeros((b, h, rows), device=q.device),
            torch.zeros((b, rows, h, d), device=q.device))


def ring_attend_inner(q_blks: list, k_blks: list, v_blks: list,
                      causal: bool = True, kv_rep: int = 1) -> list:
    """Ring attention over the devices' local blocks, one list entry a
    device in ring order: each [B, T/n, H, D] q block (kv heads for k/v)
    attends every K/V block as the blocks rotate round the ring, through
    the online-softmax update in f32. ``kv_rep``: the GQA widening,
    applied locally at each use, so the narrow nkv-head K/V is what
    rotates. Returns each device's output block in q's dtype."""
    n = len(q_blks)
    tq, d = q_blks[0].shape[1], q_blks[0].shape[3]
    scale = 1.0 / d**0.5
    acc = [_fresh(q, tq) for q in q_blks]
    k_cur, v_cur = list(k_blks), list(v_blks)
    for step in range(n):
        for my in range(n):
            j = (my - step) % n  # block j visits device my at this step
            acc[my] = _block_attend(
                q_blks[my], _widen(k_cur[my], kv_rep),
                _widen(v_cur[my], kv_rep), my * tq, j * tq, scale, causal,
                *acc[my])
        if step != n - 1:
            k_cur, v_cur = _rotate(k_cur), _rotate(v_cur)
    return [_finish(a, q.dtype) for a, q in zip(acc, q_blks)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "seq", causal: bool = True) -> torch.Tensor:
    """Attention with q/k/v [B, T, H, D] split over ``axis`` on the
    sequence dimension (T divisible by the axis size): each block on its
    device of the axis, ``ring_attend_inner``, and the output blocks put
    back together on q's device."""
    devs = _seq_devices(mesh, axis)
    outs = ring_attend_inner(*(_split_seq(x, devs) for x in (q, k, v)),
                             causal=causal)
    return torch.cat([o.to(q.device) for o in outs], dim=1)


# ---------------------------------------------------------------------------
# Zigzag schedule: load-balanced causal ring attention. Under a causal mask
# the plain ring's last device is needed in every step and its first in
# one; the zigzag layout gives device i one early and one late half-block
# (i and 2n-1-i of the sequence cut into 2n), so every device has about
# the same causally live (q half, k half) pairs at every step.
# ---------------------------------------------------------------------------


def zigzag_indices(t: int, n: int) -> torch.Tensor:
    """Gather indices mapping a contiguous sequence to zigzag order:
    ``x[:, zigzag_indices(t, n)]`` puts the rows so that an even split over
    n devices gives device i the half-blocks (i, 2n-1-i). 2n must divide
    t (ValueError otherwise)."""
    if t % (2 * n):
        raise ValueError(
            f"zigzag layout needs 2*n ({2 * n}) to divide t ({t})")
    hb = t // (2 * n)
    order: list[int] = []
    for i in range(n):
        order.extend(range(i * hb, (i + 1) * hb))
        order.extend(range((2 * n - 1 - i) * hb, (2 * n - i) * hb))
    return torch.tensor(order, dtype=torch.long)


def zigzag_inverse(t: int, n: int) -> torch.Tensor:
    """Inverse permutation: zigzag order back to contiguous."""
    return torch.argsort(zigzag_indices(t, n))


def zigzag_attend_inner(q_blks: list, k_blks: list, v_blks: list,
                        kv_rep: int = 1) -> list:
    """Causal ring attention over zigzag blocks, one list entry a device:
    device ``my``'s [B, 2hb, H, D] block holds the half-blocks (my,
    2n-1-my). At each step each q half attends the visiting K/V halves it
    can see causally (an early q half never sees a late k half; a pair is
    live when its k half starts at or before its q half's last row), so
    skipped pairs cost nothing. Returns each device's output block, in
    the same layout and q's dtype."""
    n = len(q_blks)
    tq, d = q_blks[0].shape[1], q_blks[0].shape[3]
    hb = tq // 2
    scale = 1.0 / d**0.5
    acc = [{"a": _fresh(q, hb), "b": _fresh(q, hb)} for q in q_blks]
    k_cur, v_cur = list(k_blks), list(v_blks)
    for step in range(n):
        for my in range(n):
            j = (my - step) % n  # owner of the visiting K/V
            q_a, q_b = q_blks[my][:, :hb], q_blks[my][:, hb:]
            k_a, k_b = k_cur[my][:, :hb], k_cur[my][:, hb:]
            v_a, v_b = v_cur[my][:, :hb], v_cur[my][:, hb:]
            qa_off, qb_off = my * hb, (2 * n - 1 - my) * hb
            ka_off, kb_off = j * hb, (2 * n - 1 - j) * hb
            for q_half, q_off, tag, kvs in (
                    (q_a, qa_off, "a", ((k_a, v_a, ka_off),)),
                    (q_b, qb_off, "b", ((k_a, v_a, ka_off),
                                        (k_b, v_b, kb_off)))):
                for k_half, v_half, k_off in kvs:
                    if k_off <= q_off + hb - 1:  # causally live
                        acc[my][tag] = _block_attend(
                            q_half, _widen(k_half, kv_rep),
                            _widen(v_half, kv_rep), q_off, k_off, scale,
                            True, *acc[my][tag])
        if step != n - 1:
            k_cur, v_cur = _rotate(k_cur), _rotate(v_cur)
    return [torch.cat([_finish(a["a"], q.dtype), _finish(a["b"], q.dtype)],
                      dim=1) for a, q in zip(acc, q_blks)]


def zigzag_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mesh, axis: str = "seq") -> torch.Tensor:
    """Causal ring attention over zigzag-ordered q/k/v [B, T, H, D] (the
    sequence axis already in ``zigzag_indices`` order, 2n dividing T),
    split over ``axis``; the output comes back in the same zigzag layout,
    on q's device:

        zi = zigzag_indices(t, n)
        out = zigzag_ring_attention(q[:, zi], k[:, zi], v[:, zi], mesh)
        out = out[:, zigzag_inverse(t, n)]
    """
    n = mesh.shape[axis]
    if q.shape[1] % (2 * n):
        raise ValueError(
            f"zigzag ring attention needs 2*n ({2 * n}) to divide the "
            f"sequence length ({q.shape[1]})")
    devs = _seq_devices(mesh, axis)
    outs = zigzag_attend_inner(*(_split_seq(x, devs) for x in (q, k, v)))
    return torch.cat([o.to(q.device) for o in outs], dim=1)
