"""The DeepSeek-V2 family: multi-head latent attention (no query
compression) under YaRN, a leading dense SwiGLU, then DeepSeekMoE layers
of routed top-k and shared SwiGLU experts, an untied head (DeepSeek-V2-
Lite). Served only: ``flops_per_token`` (training) raises.

Weights are drawn on the device from the seed, one ``torch.randn`` per
kind of tensor over all the layers that have it (``KINDS``), in the
dtype they are used in, fan-in scaled (embedding 0.02), as
``portbench.models`` draws the Llama family's; norms are ones. The tree
is the program's (``tpumon_torch.loadgen.model`` ``init_params`` of a
latent config): an expert is one group of ``w_gate_up`` [d, 2·ff] (gate
columns, then up) and ``w_down`` [ff, d], the shared experts the last
groups. Nothing here imports the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench import program_deepseek_v2
from portbench.reference import deepseek_v2 as reference


class Sizes(NamedTuple):
    """The widths the counts need, from a configuration file, and the
    serving engine's decode batch (``slots``) as the file's
    ``serving.engine`` group sets it."""

    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    d_ff: int
    expert_d_ff: int
    n_experts: int
    top_k: int
    n_shared: int
    first_dense: int
    slots: int

    @property
    def head_dim(self) -> int:
        """A query and key head's width, nope + rope."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_width(self) -> int:
        """A latent cache row's width, rank + rope."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def routed_layers(self) -> int:
        return self.n_layers - self.first_dense


def sizes(cfg: dict) -> Sizes:
    engine = cfg.get("serving", {}).get("engine", {})
    return Sizes(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], d_ff=cfg["intermediate_size"],
        expert_d_ff=cfg["moe_intermediate_size"],
        n_experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"],
        n_shared=cfg["n_shared_experts"],
        first_dense=cfg["first_k_dense_replace"],
        slots=engine.get("slots", 0))


model_config = program_deepseek_v2.model_config

# Weight kinds: (name, layers that have it, shape of one layer's).
KINDS = (
    ("embed", None, lambda s: (s.vocab, s.d_model)),
    ("lm_head", None, lambda s: (s.d_model, s.vocab)),
    ("wq", "all", lambda s: (s.d_model, s.n_heads * s.head_dim)),
    ("wkv_a", "all", lambda s: (s.d_model, s.latent_width)),
    ("wkv_b", "all", lambda s: (s.kv_lora_rank, s.n_heads * (
        s.qk_nope_head_dim + s.v_head_dim))),
    ("wo", "all", lambda s: (s.n_heads * s.v_head_dim, s.d_model)),
    ("w_gate", "dense", lambda s: (s.d_model, s.d_ff)),
    ("w_up", "dense", lambda s: (s.d_model, s.d_ff)),
    ("w_down", "dense", lambda s: (s.d_ff, s.d_model)),
    ("router", "routed", lambda s: (s.d_model, s.n_experts)),
    ("w_gate_up", "routed", lambda s: (
        s.n_experts + s.n_shared, s.d_model, 2 * s.expert_d_ff)),
    ("expert_down", "routed", lambda s: (
        s.n_experts + s.n_shared, s.expert_d_ff, s.d_model)),
)


def kind_seed(seed: int, kind: str) -> int:
    """The generator seed of one weight kind: a 63-bit mix of the run's
    seed and the kind's place in ``KINDS``."""
    place = [k for k, _, _ in KINDS].index(kind)
    return (seed * 0x9E3779B97F4A7C15 + 1 + place) % (1 << 63)


def _count(s: Sizes, where) -> int | None:
    return {None: None, "all": s.n_layers, "dense": s.first_dense,
            "routed": s.routed_layers}[where]


def draw_kind(s: Sizes, seed: int, kind: str, device, dtype) -> torch.Tensor:
    """One weight kind for every layer that has it, ``[layers, *shape]``
    (embedding and head: ``shape``), drawn in ``dtype`` and scaled by the
    fan-in (the rows of one matrix; embedding 0.02)."""
    _, where, shape = next(k for k in KINDS if k[0] == kind)
    one = shape(s)
    layers = _count(s, where)
    full = one if layers is None else (layers, *one)
    scale = 0.02 if kind == "embed" else one[-2] ** -0.5
    gen = torch.Generator(device=device).manual_seed(kind_seed(seed, kind))
    return torch.randn(full, generator=gen, device=device,
                       dtype=dtype).mul_(scale)


def make_params(s: Sizes, seed: int, device, dtype) -> dict:
    """The program's parameter tree as views of the drawn kinds."""
    drawn = {k: draw_kind(s, seed, k, device, dtype) for k, _, _ in KINDS}
    ones = torch.ones((2 * s.n_layers + 1, s.d_model), device=device,
                      dtype=dtype)
    kv_norms = torch.ones((s.n_layers, s.kv_lora_rank), device=device,
                          dtype=dtype)
    layers = []
    for li in range(s.n_layers):
        layer = {"attn_norm": ones[2 * li], "mlp_norm": ones[2 * li + 1],
                 "kv_a_norm": kv_norms[li]}
        layer.update({k: drawn[k][li] for k in ("wq", "wkv_a", "wkv_b",
                                                "wo")})
        if li < s.first_dense:
            layer.update({k: drawn[k][li]
                          for k in ("w_gate", "w_up", "w_down")})
        else:
            r = li - s.first_dense
            layer["experts"] = {"router": drawn["router"][r],
                                "w_gate_up": drawn["w_gate_up"][r],
                                "w_down": drawn["expert_down"][r]}
        layers.append(layer)
    return {"embed": drawn["embed"], "layers": layers,
            "final_norm": ones[-1], "lm_head": drawn["lm_head"]}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def initial_leaves(s: Sizes, seed: int, device, dtype):
    """Yield (leaf name, initial value) of every leaf."""
    yield from _leaves(make_params(s, seed, device, dtype))


def n_params(s: Sizes) -> int:
    """Parameters of the tree (norms included)."""
    total = 2 * s.vocab * s.d_model + s.d_model
    for kind, where, shape in KINDS[2:]:
        n = 1
        for dim in shape(s):
            n *= dim
        total += _count(s, where) * n
    return total + s.n_layers * (2 * s.d_model + s.kv_lora_rank)


def ref_cfg(s: Sizes, cfg: dict) -> dict:
    """The settings ``reference/deepseek_v2.py`` reads."""
    yarn = cfg["rope_scaling"]
    return {"eps": float(cfg["rms_norm_eps"]),
            "theta": float(cfg["rope_theta"]), "heads": s.n_heads,
            "nope": s.qk_nope_head_dim, "rope_dim": s.qk_rope_head_dim,
            "rank": s.kv_lora_rank, "factor": float(yarn["factor"]),
            "original": int(yarn["original_max_position_embeddings"]),
            "beta_fast": float(yarn["beta_fast"]),
            "beta_slow": float(yarn["beta_slow"]),
            "mscale": float(yarn["mscale"]),
            "mscale_all_dim": float(yarn["mscale_all_dim"]),
            "top_k": s.top_k, "experts": s.n_experts,
            "expert_ff": s.expert_d_ff}


def token_params(s: Sizes) -> int:
    """Parameters every token multiplies, all layers (a routed layer: the
    router, its top k experts and the shared ones)."""
    attn = s.d_model * (s.n_heads * s.head_dim + s.latent_width) + (
        s.kv_lora_rank * s.n_heads * (s.qk_nope_head_dim + s.v_head_dim)
        + s.n_heads * s.v_head_dim * s.d_model)
    dense = 3 * s.d_model * s.d_ff
    routed = s.d_model * s.n_experts + 3 * s.d_model * s.expert_d_ff * (
        s.top_k + s.n_shared)
    return (s.n_layers * attn + s.first_dense * dense
            + s.routed_layers * routed)


def serve_flops(s: Sizes, prefill_chunks, decode_contexts,
                emitted: int) -> float:
    """Model FLOPs of served work (``counts.serve_flops``'s arguments):
    per token 2 · ``token_params``, attention's two products over its
    causal context per head, 2·ctx·(nope + rope) and 2·ctx·v FLOPs (the
    expanded form), and per emitted token the head's 2·d·V."""
    per_tok = 2.0 * token_params(s)
    attn = 2.0 * s.n_layers * s.n_heads * (s.head_dim + s.v_head_dim)
    total = 0.0
    for start, length in prefill_chunks:
        ctx_rows = length * start + length * (length + 1) / 2
        total += length * per_tok + attn * ctx_rows
    for ctx in decode_contexts:
        total += per_tok + attn * ctx
    return total + 2.0 * s.d_model * s.vocab * emitted


def flops_per_token(s: Sizes, seq: int) -> float:
    raise NotImplementedError("the DeepSeek-V2 family is served only")


def latent_call_bound_s(s: Sizes, contexts, max_pages: int, elem: int,
                        bw: float, peak: float) -> float:
    """Least time of one absorbed latent decode call (one layer) over the
    live sequences' ``contexts`` (rows each): each live latent row
    (rank + rope wide) read once, q and out (heads × that width each),
    the page tables and lengths, over the memory rate; or the scores' and
    the values' products at heads × (rank + rope) over the peak rate,
    whichever is longer."""
    b, rows, w = len(contexts), sum(contexts), s.latent_width
    moved = (rows * w * elem + 2 * b * s.n_heads * w * elem
             + b * max_pages * 4 + b * 4)
    ops = 2 * 2 * rows * s.n_heads * w
    return max(moved / bw, ops / peak)


def expert_call_bound_s(s: Sizes, tokens: int, rows: int, elem: int,
                        bw: float, peak: float) -> float:
    """Least time of one routed layer's expert products over ``tokens``
    live tokens of a call that routes ``rows`` rows: 6·d·ff FLOPs a
    (token, expert) pair, top k routed and the shared ones, over the peak
    rate; or the three weight matrices of the shared experts and of the
    most routed experts ``rows`` rows reach, min(E, k · rows), read once,
    with the tokens' activations in and out, over the memory rate,
    whichever is longer."""
    ops = 6.0 * s.d_model * s.expert_d_ff * tokens * (s.top_k + s.n_shared)
    experts = min(s.n_experts, s.top_k * rows) + s.n_shared
    moved = (experts * 3 * s.d_model * s.expert_d_ff
             + 2 * tokens * s.d_model) * elem
    return max(ops / peak, moved / bw)


__all__ = ["sizes", "model_config", "make_params", "initial_leaves",
           "reference", "ref_cfg", "serve_flops", "flops_per_token",
           "latent_call_bound_s", "expert_call_bound_s"]
