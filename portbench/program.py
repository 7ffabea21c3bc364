"""The program under test, as the drivers build it from the data files.

Maps a configuration file's Hugging Face keys onto the port's
``ModelConfig`` and takes every further setting from the configuration's
and the traffic mix's groups by the program's own field names, so a new
model or mix that sets another field needs no code here. A setting the
program cannot represent is refused, never dropped.
"""

from __future__ import annotations

import dataclasses

# Hugging Face config key -> ModelConfig field.
HF_TO_MODEL = {
    "vocab_size": "vocab", "hidden_size": "d_model",
    "num_hidden_layers": "n_layers", "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads", "intermediate_size": "d_ff",
    "rope_theta": "rope_theta", "torch_dtype": "compute_dtype",
}
# The port's RMSNorm epsilon, fixed in its code (model._rms_norm).
PORT_NORM_EPS = 1e-6


def _fields(cls) -> set:
    return {f.name for f in dataclasses.fields(cls)}


def model_config(cfg: dict, extra: dict):
    """The port's ``ModelConfig`` for a configuration file of the Llama
    family, with ``extra`` (ModelConfig field names: ``max_seq``,
    ``attention``, ...) on top."""
    from tpumon_torch.loadgen.model import ModelConfig

    names = _fields(ModelConfig)
    kw = {field: cfg[key] for key, field in HF_TO_MODEL.items()
          if key in cfg and field in names}
    if cfg.get("rms_norm_eps", PORT_NORM_EPS) != PORT_NORM_EPS:
        raise ValueError(
            f"the port's RMSNorm epsilon is {PORT_NORM_EPS}; the "
            f"configuration asks for {cfg['rms_norm_eps']}")
    unknown = set(extra) - names
    if unknown:
        raise ValueError(f"ModelConfig has no fields {sorted(unknown)}")
    kw.update(extra)
    model = ModelConfig(**kw)
    hd = cfg.get("head_dim")
    if hd and hd != model.head_dim:
        raise ValueError(f"head_dim {hd} is not hidden_size / heads")
    return model


def serve_config(model, settings: dict):
    """The port's ``ServeConfig`` over ``model`` with ``settings`` (its
    field names)."""
    from tpumon_torch.loadgen.serving import ServeConfig

    unknown = set(settings) - _fields(ServeConfig)
    if unknown:
        raise ValueError(f"ServeConfig has no fields {sorted(unknown)}")
    return ServeConfig(model=model, **settings)


def build_kernels(device) -> None:
    """Build every CUDA kernel of the program before anything is timed
    (a no-op once built in this checkout)."""
    import torch

    if torch.device(device).type == "cuda":
        from tpumon_torch.ops import _build

        _build.build_all()
