"""The Llama family: RMSNorm, rotary attention over grouped KV heads, a
SwiGLU feed-forward and an untied head (Mistral-7B, DeepSeek-LLM-7B).
Its functions are the harness's own, named here; ``ref_cfg``, the
settings its reference reads, is the family's alone."""

from portbench import counts, models, program
from portbench.counts import Sizes
from portbench.reference import llama as reference

sizes = models.sizes
model_config = program.model_config
make_params = models.make_params
initial_leaves = models.initial_leaves
serve_flops = counts.serve_flops
flops_per_token = counts.flops_per_token


def ref_cfg(s: Sizes, cfg: dict) -> dict:
    """The settings ``reference/llama.py`` reads."""
    return {"head_dim": s.head_dim, "eps": float(cfg["rms_norm_eps"]),
            "theta": float(cfg["rope_theta"])}


__all__ = ["sizes", "model_config", "make_params", "initial_leaves",
           "reference", "ref_cfg", "serve_flops", "flops_per_token"]
