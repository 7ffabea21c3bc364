"""The plain reference of DeepSeek-V2 (V2-Lite): float32 PyTorch.

Multi-head latent attention in its expanded form and DeepSeekMoE, as the
DeepSeek-V2 paper (arXiv:2405.04434, sections 2.1 and 2.2) and the
model's published configuration describe them, with no query
compression (``q_lora_rank`` null). Per layer, x the residual stream and
every RMSNorm at ``eps``:

- h = RMSNorm(x); q = h·W_q, per head [q_nope ‖ q_pe]; h·W_kva =
  [c ‖ k_pe]; c′ = RMSNorm(c; kv_a_norm); c′·W_kvb, per head
  [k_nope ‖ v]. q_pe and k_pe (one for all heads) rotate at the token's
  position under YaRN's frequencies. Each head scores (q_nope·k_nope +
  q_pe·k_pe) · s, s = (nope + rope)^-1/2 · mscale(factor,
  mscale_all_dim)², softmax over the causal keys, weighs v; W_o brings
  the heads back, added to x.
- h = RMSNorm(x); the first ``first_dense`` layers add SwiGLU(h); every
  later one adds Σ over the top ``top_k`` of softmax(h·W_r) of p_e ·
  SwiGLU_e(h) (no renormalisation, nothing dropped), each expert run on
  the tokens routed to it, plus the shared SwiGLU of width n_shared ×
  ff.

Weights are the program's tree (``families/deepseek_v2.py``), in any
dtype, used in float32: an expert is its group of ``w_gate_up`` (gate
columns, then up) and ``w_down``; the shared SwiGLU is the shared groups
side by side. Departures from the published model, noted: the rope dims
rotate by halves, where the checkpoint stores them interleaved (with
random weights, a fixed permutation of those weight columns); there is
no multi-token prediction and no auxiliary loss, which V2-Lite has
neither of at inference. It imports ``torch`` alone, and no kernel,
cache or batching of the program.

``Precision`` picks the arithmetic of every product: float32 with TF32
off (the reference), or each operand rounded to float8 e4m3 under a
per-tensor scale first (the lower-precision control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3


def strict_f32() -> None:
    """Float32 products stay float32 on the GPU (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    """The products' arithmetic: ``"f32"`` or ``"fp8"``."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "f32":
            return x
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.cast(a) @ self.cast(b)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def correction_dim(rotations: float, dim: int, base: float,
                   original: int) -> float:
    """The rope dim at which a frequency turns ``rotations`` times over
    the original context."""
    return dim * math.log(original / (rotations * 2 * math.pi)) / (
        2 * math.log(base))


def ramp_range(cfg: dict) -> tuple[int, int]:
    """(low, high) frequency indices of YaRN's blend."""
    dim, base, orig = cfg["rope_dim"], cfg["theta"], cfg["original"]
    low = math.floor(correction_dim(cfg["beta_fast"], dim, base, orig))
    high = math.ceil(correction_dim(cfg["beta_slow"], dim, base, orig))
    return max(low, 0), min(high, dim - 1)


def inv_freq(cfg: dict) -> torch.Tensor:
    """YaRN's rotary frequencies: theta's below ``low``, theta's over the
    factor above ``high``, a linear blend between."""
    dim = cfg["rope_dim"]
    extra = 1.0 / cfg["theta"] ** (torch.arange(0, dim, 2).double() / dim)
    low, high = ramp_range(cfg)
    ramp = ((torch.arange(dim // 2).double() - low)
            / max(high - low, 1e-3)).clamp(0, 1)
    return (extra / cfg["factor"] * ramp + extra * (1 - ramp)).float()


def softmax_scale(cfg: dict) -> float:
    m = yarn_mscale(cfg["factor"], cfg["mscale_all_dim"])
    return (cfg["nope"] + cfg["rope_dim"]) ** -0.5 * m * m


def rope(x: torch.Tensor, positions: torch.Tensor, cfg: dict):
    """x [..., T, H, D] rotated at ``positions`` [T] by halves under YaRN's
    frequencies, cos and sin times mscale(mscale) / mscale(all dims)."""
    freqs = inv_freq(cfg).to(x.device)
    ang = positions.float()[:, None] * freqs[None]
    k = yarn_mscale(cfg["factor"], cfg["mscale"]) / yarn_mscale(
        cfg["factor"], cfg["mscale_all_dim"])
    cos, sin = (torch.cos(ang) * k)[:, None], (torch.sin(ang) * k)[:, None]
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(x, w: dict, positions, cfg: dict, prec: Precision,
              q_block: int) -> torch.Tensor:
    """The latent attention of x [B, T, d] in the expanded form; returns
    its W_o output [B, T, d]."""
    b, t, _ = x.shape
    nh, dn, dr = cfg["heads"], cfg["nope"], cfg["rope_dim"]
    rank = cfg["rank"]
    q = prec.mm(x, w["wq"]).reshape(b, t, nh, dn + dr)
    ckv = prec.mm(x, w["wkv_a"])
    c = kv_norm(ckv[..., :rank], w["kv_a_norm"], cfg["eps"])
    k_pe = rope(ckv[..., None, rank:], positions, cfg)  # [B, T, 1, dr]
    kv = prec.mm(c, w["wkv_b"]).reshape(b, t, nh, -1)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_nope, q_pe = q[..., :dn], rope(q[..., dn:], positions, cfg)
    qh = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)  # [B, H, T, D]
    kh = torch.cat([k_nope, k_pe.expand(b, t, nh, dr)], dim=-1).transpose(
        1, 2)
    vh = v.transpose(1, 2)
    s = softmax_scale(cfg)
    out = []
    for s0 in range(0, t, q_block):
        e = min(t, s0 + q_block)
        scores = prec.mm(qh[:, :, s0:e], kh[:, :, :e].transpose(-1, -2)) * s
        rows = torch.arange(s0, e, device=x.device)[:, None]
        cols = torch.arange(e, device=x.device)[None]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        out.append(prec.mm(torch.softmax(scores, dim=-1), vh[:, :, :e]))
    att = torch.cat(out, dim=2).transpose(1, 2).reshape(b, t, -1)
    return prec.mm(att, w["wo"])


def kv_norm(c: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The latent's RMSNorm (kv_a_layernorm)."""
    return rms_norm(c, w, eps)


def swiglu(x, w_gate, w_up, w_down, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def gates(x, router, cfg: dict, prec: Precision):
    """(gates [N, k], experts [N, k]): the top k of the softmax over the
    experts, not renormalised."""
    probs = torch.softmax(prec.mm(x, router), dim=-1)
    return torch.topk(probs, cfg["top_k"], dim=-1)


def shared_ffn(x, e: dict, cfg: dict, prec: Precision) -> torch.Tensor:
    """The shared experts as one SwiGLU of width n_shared × ff."""
    ff, first = cfg["expert_ff"], cfg["experts"]
    gu = e["w_gate_up"][first:]  # [S, d, 2·ff]
    w_gate = torch.cat(list(gu[..., :ff]), dim=1)
    w_up = torch.cat(list(gu[..., ff:]), dim=1)
    w_down = torch.cat(list(e["w_down"][first:]), dim=0)
    return swiglu(x, w_gate, w_up, w_down, prec)


def moe(x, e: dict, cfg: dict, prec: Precision) -> torch.Tensor:
    """DeepSeekMoE on x [N, d]: each expert over the tokens routed to it,
    weighted by their gates, plus the shared experts."""
    ff = cfg["expert_ff"]
    gate, expert = gates(x, e["router"], cfg, prec)
    y = torch.zeros_like(x)
    for i in range(cfg["experts"]):
        tok, slot = (expert == i).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = e["w_gate_up"][i]
        out = swiglu(x[tok], gu[:, :ff], gu[:, ff:], e["w_down"][i], prec)
        y.index_add_(0, tok, out * gate[tok, slot, None])
    return y + shared_ffn(x, e, cfg, prec)


def layer(x, w: dict, positions, cfg: dict, prec: Precision,
          q_block: int) -> torch.Tensor:
    """One decoder layer on x [B, T, d] (float32)."""
    b, t, d = x.shape
    x = x + attention(rms_norm(x, w["attn_norm"], cfg["eps"]), w, positions,
                      cfg, prec, q_block)
    h = rms_norm(x, w["mlp_norm"], cfg["eps"])
    if "experts" in w:
        return x + moe(h.reshape(b * t, d), w["experts"], cfg, prec).reshape(
            b, t, d)
    return x + swiglu(h, w["w_gate"], w["w_up"], w["w_down"], prec)


def hidden(params: dict, tokens: torch.Tensor, cfg: dict,
           prec: Precision | None = None,
           q_block: int = 1024) -> torch.Tensor:
    """Final-norm hidden states [B, T, d] of tokens [B, T]."""
    prec = prec or Precision()
    x = params["embed"][tokens].float()
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for w in params["layers"]:
        x = layer(x, w, positions, cfg, prec, q_block)
    return rms_norm(x, params["final_norm"], cfg["eps"])


def logits(params: dict, h: torch.Tensor, prec: Precision | None = None):
    return (prec or Precision()).mm(h, params["lm_head"])
