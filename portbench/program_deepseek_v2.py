"""The program under test for the DeepSeek-V2 family: its configuration
keys on the port's ``LatentModelConfig`` (latent attention, YaRN, the
routed top-k FFN), with ``extra`` (its field names) on top. A setting
the program cannot represent is refused, never dropped."""

from __future__ import annotations

from portbench.program import PORT_NORM_EPS, _fields

# Hugging Face config key -> LatentModelConfig field.
HF_TO_MODEL = {
    "vocab_size": "vocab", "hidden_size": "d_model",
    "num_hidden_layers": "n_layers", "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads", "intermediate_size": "d_ff",
    "rope_theta": "rope_theta", "torch_dtype": "compute_dtype",
    "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "n_routed_experts": "routed_experts",
    "num_experts_per_tok": "experts_per_token",
    "moe_intermediate_size": "expert_d_ff",
    "n_shared_experts": "shared_experts",
    "first_k_dense_replace": "first_dense_layers",
}
# rope_scaling key -> LatentModelConfig field (YaRN).
YARN_TO_MODEL = {
    "factor": "yarn_factor",
    "original_max_position_embeddings": "yarn_original_max_pos",
    "beta_fast": "yarn_beta_fast", "beta_slow": "yarn_beta_slow",
    "mscale": "yarn_mscale", "mscale_all_dim": "yarn_mscale_all_dim",
}
# Keys whose published value is the only one the program computes.
FIXED = {"q_lora_rank": None, "scoring_func": "softmax",
         "topk_method": "greedy", "norm_topk_prob": False,
         "routed_scaling_factor": 1, "moe_layer_freq": 1,
         "rms_norm_eps": PORT_NORM_EPS, "attention_bias": False,
         "tie_word_embeddings": False, "hidden_act": "silu"}


def model_config(cfg: dict, extra: dict):
    """The port's ``LatentModelConfig`` for a DeepSeek-V2 configuration
    file."""
    from tpumon_torch.loadgen.model import LatentModelConfig

    for key, value in FIXED.items():
        if cfg.get(key, value) != value:
            raise ValueError(f"the port computes {key}={value!r} only; the "
                             f"configuration asks for {cfg[key]!r}")
    yarn = cfg.get("rope_scaling") or {}
    if yarn and yarn.get("type") != "yarn":
        raise ValueError(f"rope_scaling {yarn.get('type')!r}: the port has "
                         "YaRN alone")
    unknown = set(extra) - _fields(LatentModelConfig)
    if unknown:
        raise ValueError(
            f"LatentModelConfig has no fields {sorted(unknown)}")
    kw = {field: cfg[key] for key, field in HF_TO_MODEL.items() if key in cfg}
    kw.update({field: yarn[key] for key, field in YARN_TO_MODEL.items()
               if key in yarn})
    kw.update(extra)
    return LatentModelConfig(**kw)
