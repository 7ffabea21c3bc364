"""The plain reference: a Llama-style decoder in float32 PyTorch.

RMSNorm, rotary embedding over halves of each head, grouped-query
attention with a causal softmax, a SwiGLU feed-forward and an untied head,
as the Mistral-7B and DeepSeek-LLM-7B configurations describe them. The
weights are a tree of the same names as the program's (``embed``,
``layers``, ``final_norm``, ``lm_head``), given in any dtype and used in
float32. It imports ``torch`` alone, and no kernel, cache or batching of
the program.

``Precision`` picks the arithmetic of every product: float32 with TF32
off (the reference), or each operand rounded to float8 e4m3 under a
per-tensor scale first (the lower-precision control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
        # The rounding passes no gradient of its own (straight through).
        return x + (q - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.cast(a) @ self.cast(b)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding of x [..., T, H, D] at ``positions`` [T]: the
    first half of each head rotates against the second."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions.float()[:, None] * freqs[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, prec: Precision, q_block: int) -> torch.Tensor:
    """Causal attention of q [B, T, H, D] over k, v [B, T, Hkv, D], query
    rows in blocks of ``q_block``, each against the keys it may see."""
    b, t, h, d = q.shape
    group = h // k.shape[2]
    k = k.repeat_interleave(group, dim=2).transpose(1, 2)  # [B, H, T, D]
    v = v.repeat_interleave(group, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = []
    for s in range(0, t, q_block):
        e = min(t, s + q_block)
        scores = prec.mm(q[:, :, s:e], k[:, :, :e].transpose(-1, -2))
        scores = scores / d ** 0.5
        rows = torch.arange(s, e, device=q.device)[:, None]
        cols = torch.arange(e, device=q.device)[None]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        out.append(prec.mm(torch.softmax(scores, dim=-1), v[:, :, :e]))
    return torch.cat(out, dim=2).transpose(1, 2)  # [B, T, H, D]


def layer(x, w: dict, positions, cfg: dict, prec: Precision,
          q_block: int) -> torch.Tensor:
    """One decoder layer on x [B, T, d] (float32)."""
    b, t, _ = x.shape
    hd = cfg["head_dim"]
    h = rms_norm(x, w["attn_norm"], cfg["eps"])
    q = prec.mm(h, w["wq"]).reshape(b, t, -1, hd)
    k = prec.mm(h, w["wk"]).reshape(b, t, -1, hd)
    v = prec.mm(h, w["wv"]).reshape(b, t, -1, hd)
    q, k = rope(q, positions, cfg["theta"]), rope(k, positions, cfg["theta"])
    att = attention(q, k, v, prec, q_block).reshape(b, t, -1)
    x = x + prec.mm(att, w["wo"])
    h = rms_norm(x, w["mlp_norm"], cfg["eps"])
    ff = F.silu(prec.mm(h, w["w_gate"])) * prec.mm(h, w["w_up"])
    return x + prec.mm(ff, w["w_down"])


def hidden(params: dict, tokens: torch.Tensor, cfg: dict,
           prec: Precision | None = None, q_block: int = 1024,
           remat: bool = False) -> torch.Tensor:
    """Final-norm hidden states [B, T, d] of tokens [B, T]; ``remat``
    recomputes each layer in the backward pass instead of keeping its
    activations."""
    prec = prec or Precision()
    x = params["embed"][tokens].float()
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for w in params["layers"]:
        if remat:
            x = checkpoint(layer, x, w, positions, cfg, prec, q_block,
                           use_reentrant=False)
        else:
            x = layer(x, w, positions, cfg, prec, q_block)
    return rms_norm(x, params["final_norm"], cfg["eps"])


def logits(params: dict, h: torch.Tensor, prec: Precision | None = None):
    return (prec or Precision()).mm(h, params["lm_head"])


def loss(params: dict, tokens: torch.Tensor, cfg: dict,
         prec: Precision | None = None, q_block: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens [B, T + 1]."""
    h = hidden(params, tokens[:, :-1], cfg, prec, q_block, remat=True)
    lg = logits(params, h, prec)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def leaves(params: dict) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, names as ``portbench.models``
    gives them."""
    out = [("embed", params["embed"])]
    for li, w in enumerate(params["layers"]):
        out += [(f"layers.{li}.{k}", v) for k, v in w.items()]
    return out + [("final_norm", params["final_norm"]),
                  ("lm_head", params["lm_head"])]


def value_and_grad(params: dict, tokens: torch.Tensor, cfg: dict,
                   prec: Precision | None = None, q_block: int = 1024):
    """(loss, {leaf name: gradient}) for float32 leaves."""
    named = leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    try:
        value = loss(params, tokens, cfg, prec, q_block)
        grads = torch.autograd.grad(value, [p for _, p in named])
    finally:
        for _, p in named:
            p.requires_grad_(False)
    return value.detach(), dict(zip((n for n, _ in named), grads))
