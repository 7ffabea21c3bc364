"""Configuration files and seeded weights, shared by both sides.

A configuration file (``configs/<name>.json``) holds the model's
published ``config.json`` keys as the benchmark runs them, plus
``published`` (the source's values of the keys it changed), ``assumed``
(sizes the source does not fix) and per-use groups (``serving``,
``training``). ``sizes`` reads the widths from it; the Llama family
(``families/llama.py``) names it and the weights below.

Weights are drawn on the device from the seed, one ``torch.randn`` per
kind of tensor over all layers (a ``[layers, in, out]`` block sliced into
per-layer views), in the dtype they are used in, scaled as the program's
``init_params`` scales them (fan-in ``1/sqrt(in)``, embedding 0.02).
Each kind draws from its own generator, so a reference can draw one kind
again without the others. Nothing here imports the program.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from portbench.counts import Sizes

ROOT = Path(__file__).resolve().parent

# Per-layer weight kinds: (name, rows, columns) as functions of the sizes.
LAYER_KINDS = (
    ("wq", lambda s: s.d_model, lambda s: s.n_heads * s.head_dim),
    ("wk", lambda s: s.d_model, lambda s: s.n_kv_heads * s.head_dim),
    ("wv", lambda s: s.d_model, lambda s: s.n_kv_heads * s.head_dim),
    ("wo", lambda s: s.n_heads * s.head_dim, lambda s: s.d_model),
    ("w_gate", lambda s: s.d_model, lambda s: s.d_ff),
    ("w_up", lambda s: s.d_model, lambda s: s.d_ff),
    ("w_down", lambda s: s.d_ff, lambda s: s.d_model),
)
NORMS = ("attn_norm", "mlp_norm")
KINDS = tuple(k for k, _, _ in LAYER_KINDS) + ("embed", "lm_head")


def load_config(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "configs" / f"{name}.json").read_text())


def sizes(cfg: dict) -> Sizes:
    """The widths of a configuration file (Hugging Face key names)."""
    heads = cfg["num_attention_heads"]
    return Sizes(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=heads,
        n_kv_heads=cfg.get("num_key_value_heads") or heads,
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
        d_ff=cfg["intermediate_size"], n_experts=0)


def kind_seed(seed: int, kind: str) -> int:
    """The generator seed of one weight kind: a 63-bit mix of the run's
    seed and the kind's place in ``KINDS``."""
    return (seed * 0x9E3779B97F4A7C15 + 1 + KINDS.index(kind)) % (1 << 63)


def draw_kind(s: Sizes, seed: int, kind: str, device, dtype) -> torch.Tensor:
    """One weight kind for every layer, ``[layers, in, out]`` (embedding
    ``[vocab, d]``, head ``[d, vocab]``), drawn in ``dtype`` and
    scaled."""
    gen = torch.Generator(device=device).manual_seed(kind_seed(seed, kind))
    if kind == "embed":
        shape, scale = (s.vocab, s.d_model), 0.02
    elif kind == "lm_head":
        shape, scale = (s.d_model, s.vocab), s.d_model ** -0.5
    else:
        _, rows, cols = next(k for k in LAYER_KINDS if k[0] == kind)
        shape = (s.n_layers, rows(s), cols(s))
        scale = rows(s) ** -0.5
    return torch.randn(shape, generator=gen, device=device,
                       dtype=dtype).mul_(scale)


def make_params(s: Sizes, seed: int, device, dtype) -> dict:
    """The program's parameter tree (``embed``, ``layers``, ``final_norm``,
    ``lm_head``; per layer the norms and the projections) as views of
    the drawn kinds."""
    drawn = {k: draw_kind(s, seed, k, device, dtype) for k in KINDS}
    ones = torch.ones((2 * s.n_layers + 1, s.d_model), device=device,
                      dtype=dtype)
    layers = []
    for li in range(s.n_layers):
        layer = {"attn_norm": ones[2 * li], "mlp_norm": ones[2 * li + 1]}
        layer.update({k: drawn[k][li] for k, _, _ in LAYER_KINDS})
        layers.append(layer)
    return {"embed": drawn["embed"], "layers": layers,
            "final_norm": ones[-1], "lm_head": drawn["lm_head"]}


def initial_leaves(s: Sizes, seed: int, device, dtype):
    """Yield (leaf name, initial value) for every leaf, drawn again from
    the seed kind by kind, so only one kind's block is live at a time
    (norms: ones)."""
    for name in ("final_norm",) + tuple(
            f"layers.{li}.{k}" for li in range(s.n_layers) for k in NORMS):
        yield name, torch.ones((s.d_model,), device=device, dtype=dtype)
    for kind in KINDS:
        block = draw_kind(s, seed, kind, device, dtype)
        if kind in ("embed", "lm_head"):
            yield kind, block
        else:
            for li in range(s.n_layers):
                yield f"layers.{li}.{kind}", block[li]
        del block


def token_batch(seed: int, step: int, batch: int, length: int, vocab: int,
                device) -> torch.Tensor:
    """int64 ``[batch, length]`` token ids for training step ``step``,
    drawn on the device from the seed."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 0xD1B54A32D192ED03 + 7919 * step + 12345) % (1 << 63))
    return torch.randint(0, vocab, (batch, length), generator=gen,
                         device=device)
