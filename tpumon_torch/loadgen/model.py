"""Mini Llama-style decoder-only transformer: config, params, RMSNorm.

The PyTorch counterpart of ``tpumon/loadgen/model.py`` for the serving
path: ``ModelConfig`` (dense family), ``init_params`` (the same param
tree and shapes, drawn from a ``torch.Generator``), ``_rms_norm`` and
``params_from_jax``, which bridges a JAX param pytree (as numpy arrays)
onto a device so both packages can run identical weights. Params are a
plain dict of tensors — the JAX pytree's exact structure — so the
serving code reads ``params["layers"][li]["wq"]`` in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class ModelConfig:
    vocab: int = 512
    d_model: int = 256
    n_layers: int = 2
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1024
    max_seq: int = 256
    rope_theta: float = 10000.0
    compute_dtype: str = "bfloat16"
    # Mixture-of-Experts family: not yet ported (ROADMAP queue 1 item 8).
    # The reference's training-only fields (remat, attention schedule)
    # come with the training slice.
    n_experts: int = 0

    def __post_init__(self) -> None:
        if self.n_experts < 0:
            raise ValueError(f"n_experts must be >= 0, got {self.n_experts}")
        if self.n_experts:
            raise NotImplementedError(
                "the MoE model family (n_experts>0) is not yet ported "
                "(ROADMAP queue 1 item 8)")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.d_model % self.n_heads or self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"d_model={self.d_model} must split into n_heads="
                f"{self.n_heads}, and n_heads into n_kv_heads="
                f"{self.n_kv_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Initialize a param dict (float32 master weights) on
    ``generator.device`` — the reference's tree and shapes, the same
    scales (fan-in ``1/sqrt(shape[0])``, embed 0.02), drawn from a
    ``torch.Generator`` (so not the JAX values: tests bridge those with
    ``params_from_jax``)."""
    dev = generator.device

    def dense(shape, scale=None):
        scale = scale if scale is not None else (1.0 / shape[0]) ** 0.5
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * scale

    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "attn_norm": torch.ones((cfg.d_model,), device=dev),
            "wq": dense((cfg.d_model, nh * hd)),
            "wk": dense((cfg.d_model, nkv * hd)),
            "wv": dense((cfg.d_model, nkv * hd)),
            "wo": dense((nh * hd, cfg.d_model)),
            "mlp_norm": torch.ones((cfg.d_model,), device=dev),
            "w_gate": dense((cfg.d_model, cfg.d_ff)),
            "w_up": dense((cfg.d_model, cfg.d_ff)),
            "w_down": dense((cfg.d_ff, cfg.d_model)),
        })
    return {
        "embed": dense((cfg.vocab, cfg.d_model), scale=0.02),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), device=dev),
        "lm_head": dense((cfg.d_model, cfg.vocab)),
    }


def map_params(params, fn):
    """Apply ``fn`` to every tensor of a param tree (dicts and lists)."""
    if isinstance(params, dict):
        return {k: map_params(v, fn) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_params(v, fn) for v in params]
    return fn(params)


def params_from_jax(tree, device: str | torch.device = "cpu",
                    dtype: torch.dtype = torch.float32) -> dict:
    """The JAX param pytree, given as numpy arrays (``jax.tree.map(
    np.asarray, params)``), as this package's param dict on ``device``
    in ``dtype``. Structure and shapes carry over unchanged."""
    return map_params(
        tree, lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype))


def param_bytes(params) -> int:
    """Resident weight bytes of a param tree."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_bytes(v) for v in params)
    return params.numel() * params.element_size()


def _rms_norm(x: torch.Tensor, weight: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    # Same promotion as the reference: normalize in f32, cast back to
    # x.dtype, THEN scale by the weight in x.dtype.
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)
