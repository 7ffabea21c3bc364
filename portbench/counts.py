"""The yardstick's arithmetic: peaks, operations and bytes.

Frozen copies, so a later change to the program cannot move the
benchmark's ruler: the card peaks and training FLOPs per token of
``tpumon_torch/loadgen/train.py`` (``NVIDIA_PEAKS``, ``card_peaks``,
``flops_per_token``), and the flash and paged-attention bounds of
``chip_smoke.py`` (``FLASH_WORK``, ``flash_ops``, ``flash_bounds``, the
bytes rule of ``time_paged_case``). Every bound counts each input byte
read once and each output byte written once.

Sizes come in as a ``Sizes`` tuple, built from a configuration file by
its family's ``sizes`` (``portbench.models.sizes`` for Llama's); the
FLOP counts here are the Llama family's. Nothing here imports the
program.
"""

from __future__ import annotations

from typing import NamedTuple

# Dense peaks of NVIDIA cards from their data sheets, first match of the
# device name wins: (name contains, variant, bf16 TFLOP/s on tensor cores,
# f32 TFLOP/s on CUDA cores, memory TB/s, int8 TOP/s on tensor cores).
NVIDIA_PEAKS = (
    ("H200", "H200 SXM", 989.0, 67.0, 4.8, 1979.0),
    ("H100 PCIE", "H100 PCIe", 756.0, 51.0, 2.0, 1513.0),
    ("H100 NVL", "H100 NVL", 835.0, 60.0, 3.9, 1670.0),
    ("H100", "H100 SXM", 989.0, 67.0, 3.35, 1979.0),
)


class CardPeaks(NamedTuple):
    """A card's dense peaks, per second: bf16 and f32 FLOP/s, memory
    bytes/s, int8 OP/s."""

    variant: str
    bf16: float
    f32: float
    hbm: float
    int8: float


def card_peaks(kind: str) -> CardPeaks | None:
    """The peaks of a device name such as ``torch.cuda.get_device_name()``,
    or None if unknown."""
    up = kind.upper()
    for needle, variant, bf16, f32, tbps, int8 in NVIDIA_PEAKS:
        if needle in up:
            return CardPeaks(variant, bf16 * 1e12, f32 * 1e12, tbps * 1e12,
                             int8 * 1e12)
    return None


class Sizes(NamedTuple):
    """The widths the counts need, from a configuration file."""

    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    n_experts: int = 0


def layer_params(s: Sizes) -> int:
    """Parameters of one layer that every token multiplies (MoE: the
    router and ONE top-1 expert)."""
    ffn = (s.d_model * s.n_experts + 2 * s.d_model * s.d_ff
           if s.n_experts else 3 * s.d_model * s.d_ff)
    return (s.d_model * (s.n_heads + 2 * s.n_kv_heads) * s.head_dim
            + s.n_heads * s.head_dim * s.d_model + ffn + 2 * s.d_model)


def flops_per_token(s: Sizes, seq: int) -> float:
    """Training FLOPs per token: the standard 6·N (fwd 2N + bwd 4N over
    all parameters) plus the attention term 12·L·s·d (score+value
    matmuls, fwd+bwd, across layers at sequence length s)."""
    n_params = (s.vocab * s.d_model * 2 + s.n_layers * layer_params(s)
                + s.d_model)
    return 6.0 * n_params + 12.0 * s.n_layers * seq * s.d_model


def serve_flops(s: Sizes, prefill_chunks, decode_contexts,
                emitted: int) -> float:
    """Model FLOPs of served work. ``prefill_chunks``: (start, length)
    of each prompt chunk, its tokens at positions start..start+length-1,
    each attending its causal context; ``decode_contexts``: the context
    rows of each decode token; ``emitted``: tokens whose logits the
    head computed (the first token of each request and every decode
    token). Per token 2·N over the layers, and attention's two products
    at 2·ctx·head_dim FLOPs per head each; per emitted token the head's
    2·d·V. Padded rows of a chunk count nothing."""
    per_tok = 2.0 * s.n_layers * layer_params(s)
    attn = 4.0 * s.n_layers * s.n_heads * s.head_dim  # x context rows
    total = 0.0
    for start, length in prefill_chunks:
        ctx_rows = length * start + length * (length + 1) / 2
        total += length * per_tok + attn * ctx_rows
    for ctx in decode_contexts:
        total += per_tok + attn * ctx
    return total + 2.0 * s.d_model * s.vocab * emitted


def paged_call_bound_s(s: Sizes, contexts, max_pages: int, elem: int,
                       bw: float, peak: float) -> float:
    """Least time of one paged-attention call (one layer) over the live
    sequences' ``contexts`` (K/V rows each): q and out, the K/V rows of
    the live lengths, their page tables and lengths, each moved once,
    over the memory rate; or its two products over the peak rate,
    whichever is longer (chip_smoke's ``time_paged_case`` rule)."""
    b = len(contexts)
    rows = sum(contexts)
    kv_bytes = 2 * rows * s.n_kv_heads * s.head_dim * elem
    io_bytes = 2 * b * s.n_heads * s.head_dim * elem + b * max_pages * 4 + b * 4
    ops = 4 * rows * s.n_heads * s.head_dim
    return max((kv_bytes + io_bytes) / bw, ops / peak)


# Per flash kernel: (products over the causal pairs, [BH, T, D] tensors
# and [BH, T] f32 rows read or written).
FLASH_WORK = {"flash_attention_tri_fwd": (2, 4, 1),
              "flash_attention_tri_bwd_dq": (3, 5, 2),
              "flash_attention_tri_bwd_dkv": (4, 6, 2)}


def flash_ops(bh, t, hd) -> dict:
    """FLOPs per kernel: its causal products, T(T+1)/2 pairs per bh and
    2 * hd FLOPs per pair per product."""
    pairs = bh * t * (t + 1) // 2
    return {name: products * 2 * hd * pairs
            for name, (products, _, _) in FLASH_WORK.items()}


def flash_bounds(bh, t, hd, elem, bw, peak) -> dict:
    """Least time per kernel, ms: the larger of its bytes (each input read
    once, each output written once) over the memory rate and its FLOPs
    (flash_ops) over the peak rate, with which of the two bounds it."""
    tensor, row = bh * t * hd * elem, bh * t * 4
    ops = flash_ops(bh, t, hd)
    out = {}
    for name, (_, tensors, rows) in FLASH_WORK.items():
        t_bytes = (tensors * tensor + rows * row) / bw * 1e3
        out[name] = max((t_bytes, "bytes"), (ops[name] / peak * 1e3,
                                             "operations"))
    return out
