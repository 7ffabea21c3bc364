"""Mini Llama-style decoder-only transformer: config, params, the training
forward pass and its attention schedules.

The PyTorch counterpart of ``tpumon/loadgen/model.py`` for one device:
``ModelConfig`` (dense family), ``init_params`` (the same param tree and
shapes, drawn from a ``torch.Generator``), ``params_from_jax``, which
bridges a JAX param pytree (as numpy arrays) onto a device so both
packages can run identical weights, and the training path: ``forward``,
``loss_fn`` and ``sgd_train_step`` with the three attention schedules
(``naive``, ``chunked`` and ``flash``, the last through the hand-written
CUDA kernels of ``tpumon_torch.ops.flash_attention``) and per-layer
``remat``, for the dense Llama-style family and the Mixture-of-Experts
family (``n_experts > 0``: each layer's SwiGLU becomes the routed expert
FFN of ``tpumon_torch.loadgen.moe``). Params are a plain dict of tensors
(the JAX pytree's exact structure), so the code reads
``params["layers"][li]["wq"]`` in both packages. ``LatentModelConfig``
(DeepSeek-V2: latent attention, YaRN, the routed top-k FFN; no
counterpart in the reference package) has a tree of its own
(``init_params``), its rotary frequencies and score scale
(``rope_inv_freq``, ``latent_softmax_scale``), and is served only
(``serving.latent_forward``): the training paths refuse it.

The mesh: ``Mesh`` names a set of devices over named axes ("data",
"model", "seq", "pipe", "expert"), as ``jax.sharding.Mesh`` does, for ONE
controller process; a device may repeat, so dp x tp runs on one card (or
on the CPU) through the same code as on many. ``PARAM_SPECS`` and
``param_shardings`` are the reference's Megatron split, ``shard_params``
applies a spec tree (one param dict per device, each leaf its block as its
own allocation on that device), and ``all_reduce_sum`` and
``gather_vocab`` are the two collectives XLA inserts there: the sum of
row-parallel partials and the gather of vocab-split logits.
``replica_meshes`` carves the devices into dp tensor-parallel submeshes
(mesh serving).

Training over a mesh: ``make_sharded_train_step`` is the dp x tp SGD step.
Tokens split over "data", each device runs its shard's heads and FFN
columns (``mesh_loss``), and autograd follows the ``.to()`` copies between
devices, so one backward pass covers every shard. ``mesh_value_and_grad``
then sums each block's gradient over the devices that hold it (the psum
over "data" XLA inserts) and ``mesh_sgd_step`` applies the same update to
every copy, so replicas stay bit-identical. ``shard_views`` gives the same
blocks as differentiable views of one full param tree (the loss functions
take either), and ``unshard_params`` puts the blocks back together. The
sequence-parallel step (``sp_train``), the pipeline (``pipeline``) and the
sharded MoE step (``moe.make_sharded_moe_step``) run on the same pieces.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpumon_torch.loadgen.moe import (
    MoEConfig,
    TopKConfig,
    expert_block_outputs,
    init_moe_params,
    init_topk_params,
    moe_ffn,
    route,
)
from tpumon_torch.loadgen.ring_attention import _block_attend
from tpumon_torch.ops.flash_attention import (
    flash_attention_tri_bwd,
    flash_attention_tri_fwd,
)
from tpumon_torch.tracing import profiler_span


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
    # Per-layer rematerialization: the backward pass recomputes each
    # layer's activations (torch.utils.checkpoint) instead of keeping them.
    remat: bool = False
    # Attention schedule: "naive" materializes [B, H, T, T] scores;
    # "chunked" streams K/V in attn_block_k-row blocks with an online
    # softmax (O(T * block) attention memory); "flash" runs both passes
    # through the causal flash CUDA kernels (attn_block_k sets the block
    # grid T pads to).
    attention: str = "naive"
    attn_block_k: int = 512
    # Mixture-of-Experts family: n_experts>0 replaces each layer's SwiGLU
    # with a top-1 routed expert FFN (loadgen.moe), in training and in
    # every serving mode (decoder_forward routes at full capacity). 0 = the
    # dense Llama-style family.
    n_experts: int = 0
    moe_capacity_factor: float = 1.25
    # Latent attention and the routed top-k FFN are LatentModelConfig's
    # (DeepSeek-V2); a config of this class has neither.
    kv_lora_rank = 0
    routed_experts = 0

    def __post_init__(self) -> None:
        if self.attention not in ("naive", "chunked", "flash"):
            raise ValueError(f"unknown attention schedule {self.attention!r}")
        if self.attn_block_k < 1:
            raise ValueError(
                f"attn_block_k must be >= 1, got {self.attn_block_k}")
        if self.n_experts < 0:
            raise ValueError(f"n_experts must be >= 0, got {self.n_experts}")
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


@dataclass(frozen=True)
class LatentModelConfig(ModelConfig):
    """DeepSeek-V2's model, served only: latent attention (MLA) in place
    of the GQA projections, YaRN on its rope dims, and the routed top-k
    FFN (DeepSeekMoE). ``n_kv_heads`` is ``n_heads``; ``d_ff`` the width
    of the dense layers before ``first_dense_layers``."""

    # Latent attention (MLA): a query head is [nope ‖ rope] wide; the
    # cache holds one [kv_lora_rank ‖ rope] row a token and layer (the
    # normed latent and the roped key part every head shares), from which
    # W_kvb gives each head its nope key and its v_head_dim value.
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN on the latent model's rope dims (yarn_factor > 1; 1 = plain
    # RoPE): the blend of interpolated and original frequencies between
    # the correction dims of beta_fast and beta_slow rotations over
    # yarn_original_max_pos, and the attention scale's mscale².
    yarn_factor: float = 1.0
    yarn_original_max_pos: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    # Routed FFN (DeepSeekMoE): routed_experts > 0 gives
    # every layer from first_dense_layers on a dropless softmax top-k of
    # SwiGLU experts of width expert_d_ff plus shared_experts more that
    # every token takes at gate 1 (moe.TopKConfig); the layers before
    # keep the SwiGLU of width d_ff.
    routed_experts: int = 0
    experts_per_token: int = 0
    expert_d_ff: int = 0
    shared_experts: int = 0
    first_dense_layers: int = 0

    def __post_init__(self) -> None:
        super().__post_init__()
        if min(self.kv_lora_rank, self.qk_nope_head_dim,
               self.qk_rope_head_dim, self.v_head_dim) < 1:
            raise ValueError("latent attention needs kv_lora_rank, "
                             "qk_nope_head_dim, qk_rope_head_dim and "
                             "v_head_dim")
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even (rotate-half)")
        if self.routed_experts:
            if self.n_experts:
                raise ValueError("routed_experts (top-k) and n_experts "
                                 "(top-1) are two FFN families; set one")
            if not (1 <= self.experts_per_token <= self.routed_experts
                    and self.expert_d_ff >= 1 and self.shared_experts >= 0
                    and 0 <= self.first_dense_layers <= self.n_layers):
                raise ValueError(
                    f"routed FFN: experts_per_token="
                    f"{self.experts_per_token} of routed_experts="
                    f"{self.routed_experts}, expert_d_ff="
                    f"{self.expert_d_ff}, shared_experts="
                    f"{self.shared_experts}, first_dense_layers="
                    f"{self.first_dense_layers} of {self.n_layers}")

    @property
    def latent_width(self) -> int:
        """Width of a latent cache row: kv_lora_rank + qk_rope_head_dim."""
        return self.kv_lora_rank + self.qk_rope_head_dim


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

    if cfg.kv_lora_rank:
        return _init_latent_params(cfg, dense, generator)
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": torch.ones((cfg.d_model,), device=dev),
            "wq": dense((cfg.d_model, nh * hd)),
            "wk": dense((cfg.d_model, nkv * hd)),
            "wv": dense((cfg.d_model, nkv * hd)),
            "wo": dense((nh * hd, cfg.d_model)),
            "mlp_norm": torch.ones((cfg.d_model,), device=dev),
        }
        if cfg.n_experts:
            layer["moe"] = init_moe_params(_moe_config(cfg), generator)
        else:
            layer.update({
                "w_gate": dense((cfg.d_model, cfg.d_ff)),
                "w_up": dense((cfg.d_model, cfg.d_ff)),
                "w_down": dense((cfg.d_ff, cfg.d_model)),
            })
        layers.append(layer)
    return {
        "embed": dense((cfg.vocab, cfg.d_model), scale=0.02),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), device=dev),
        "lm_head": dense((cfg.d_model, cfg.vocab)),
    }


def _init_latent_params(cfg: LatentModelConfig, dense, generator) -> dict:
    """The latent model's tree (DeepSeek-V2): per layer ``wq`` [d, nh ×
    (nope + rope)], ``wkv_a`` [d, rank + rope], ``kv_a_norm`` [rank],
    ``wkv_b`` [rank, nh × (nope + v)] (each head's nope key columns, then
    its value columns), ``wo`` [nh × v, d], the two norms, and either the
    dense SwiGLU (``w_gate``, ``w_up``, ``w_down``) or ``experts``
    (``moe.init_topk_params``)."""
    dev = generator.device
    d, nh, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    layers = []
    for li in range(cfg.n_layers):
        layer = {
            "attn_norm": torch.ones((d,), device=dev),
            "wq": dense((d, nh * (dn + dr))),
            "wkv_a": dense((d, r + dr)),
            "kv_a_norm": torch.ones((r,), device=dev),
            "wkv_b": dense((r, nh * (dn + dv))),
            "wo": dense((nh * dv, d)),
            "mlp_norm": torch.ones((d,), device=dev),
        }
        if routed_layer(cfg, li):
            layer["experts"] = init_topk_params(topk_config(cfg), generator)
        else:
            layer.update({"w_gate": dense((d, cfg.d_ff)),
                          "w_up": dense((d, cfg.d_ff)),
                          "w_down": dense((cfg.d_ff, d))})
        layers.append(layer)
    return {
        "embed": dense((cfg.vocab, d), scale=0.02),
        "layers": layers,
        "final_norm": torch.ones((d,), device=dev),
        "lm_head": dense((d, cfg.vocab)),
    }


def routed_layer(cfg: LatentModelConfig, li: int) -> bool:
    """Whether layer ``li`` of a routed-FFN model has experts."""
    return bool(cfg.routed_experts) and li >= cfg.first_dense_layers


def topk_config(cfg: LatentModelConfig) -> TopKConfig:
    """The routed FFN's settings of a model config."""
    return TopKConfig(d_model=cfg.d_model, d_ff=cfg.expert_d_ff,
                      n_experts=cfg.routed_experts,
                      top_k=cfg.experts_per_token,
                      n_shared=cfg.shared_experts)


def yarn_get_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: 0.1 · mscale · ln(factor) + 1 (1 at
    factor 1)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(cfg: LatentModelConfig) -> tuple[int, int]:
    """(low, high): the rope frequency indices between which YaRN blends
    the original frequencies into the interpolated ones, floor and ceil
    of dim · ln(original / (beta · 2π)) / (2 ln theta) at beta_fast and
    beta_slow, clamped to the dims."""
    dim = cfg.qk_rope_head_dim

    def at(beta):
        return dim * math.log(cfg.yarn_original_max_pos / (
            beta * 2 * math.pi)) / (2 * math.log(cfg.rope_theta))

    return (max(math.floor(at(cfg.yarn_beta_fast)), 0),
            min(math.ceil(at(cfg.yarn_beta_slow)), dim - 1))


def rope_inv_freq(cfg: LatentModelConfig, device) -> torch.Tensor:
    """f32 [rope dims / 2]: the latent model's rotary frequencies, theta's
    alone or (YaRN) blended by a linear ramp over the correction range:
    the original frequency below ``low``, the interpolated one (over the
    factor) above ``high``."""
    dim = cfg.qk_rope_head_dim
    extra = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=device) / dim))
    if cfg.yarn_factor <= 1.0:
        return extra
    low, high = yarn_correction_range(cfg)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low)
                       / max(high - low, 1e-3), 0.0, 1.0)
    return extra / cfg.yarn_factor * ramp + extra * (1.0 - ramp)


def rope_cos_sin_scale(cfg: LatentModelConfig) -> float:
    """YaRN's factor on cos and sin: mscale(mscale) / mscale(all dims)."""
    return (yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale)
            / yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))


def latent_softmax_scale(cfg: LatentModelConfig) -> float:
    """The latent attention's score scale s: (nope + rope)^-1/2, times
    mscale(all dims)² under YaRN."""
    m = yarn_get_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def refuse_latent(cfg: ModelConfig, what: str) -> None:
    """Raise ValueError where ``what`` (a training path) meets a model it
    does not run: latent attention or the routed top-k FFN."""
    if cfg.kv_lora_rank:
        raise ValueError(
            f"{what} does not run latent attention (kv_lora_rank="
            f"{cfg.kv_lora_rank}) or the routed top-k FFN (routed_experts="
            f"{cfg.routed_experts}): such a model (DeepSeek-V2) is served "
            "only, on the paged layout")


def map_params(params, fn):
    """Apply ``fn`` to every leaf of a param tree (dicts and lists); a
    quantized weight (``quant.QTensor``) is one leaf."""
    if isinstance(params, dict):
        return {k: map_params(v, fn) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_params(v, fn) for v in params]
    return fn(params)


def params_from_jax(tree, device: str | torch.device = "cpu",
                    dtype: torch.dtype = torch.float32) -> dict:
    """The JAX param pytree, given as numpy arrays (``jax.tree.map(
    np.asarray, params)``), as this package's param dict on ``device``
    in ``dtype``. Structure and shapes carry over unchanged; a quantized
    leaf of the reference (a ``QTensor`` of numpy ``q`` and ``scale``)
    becomes the port's ``QTensor`` with its int8 codes and f32 scales."""
    from tpumon_torch.loadgen.quant import QTensor

    def leaf(a):
        if hasattr(a, "q") and hasattr(a, "scale"):
            return QTensor(
                q=torch.from_numpy(np.array(a.q, dtype=np.int8)).to(device),
                scale=torch.from_numpy(
                    np.array(a.scale, dtype=np.float32)).to(device))
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    return map_params(tree, leaf)


def param_leaves(params) -> list:
    """Every leaf of a param tree, in the tree's order (a ``QTensor`` is
    one leaf)."""
    if isinstance(params, dict):
        return [x for v in params.values() for x in param_leaves(v)]
    if isinstance(params, (list, tuple)):
        return [x for v in params for x in param_leaves(v)]
    return [params]


def leaf_bytes(leaf) -> int:
    """Resident bytes of one leaf (a ``QTensor``: int8 codes + f32
    scales)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.nbytes


def param_bytes(params) -> int:
    """Resident weight bytes of a param tree."""
    return sum(leaf_bytes(p) for p in param_leaves(params))


def _rms_norm(x: torch.Tensor, weight: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    # Same promotion as the reference: normalize in f32, cast back to
    # x.dtype, THEN scale by the weight in x.dtype.
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def visible_devices(device=None) -> list[torch.device]:
    """The devices a mesh spreads over when none are named: every CUDA
    device torch sees (``resolve_device``'s rule for the default), or
    ``device`` alone when it is a CPU or names its index (``cuda:1``)."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return [device]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another; raises when CUDA is asked for (or implied) and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on a GPU; pass device='cpu' "
            "explicitly to run the plain versions")
    return device


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _rope(x: torch.Tensor, theta: float,
          positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotary embedding over the last dim (halves, in f32); x: [B, T, H,
    D]. ``positions`` [T] overrides the default 0..T-1."""
    _, t, _, d = x.shape
    freqs = 1.0 / (theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=x.device) / d))
    if positions is None:
        positions = torch.arange(t, dtype=torch.float32, device=x.device)
    angles = positions.float()[:, None] * freqs[None, :]  # [T, D/2]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


_NEG_INF = -1e30


def _chunked_attention_core(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, block_k: int) -> torch.Tensor:
    """Causal attention with K/V streamed in blocks (online softmax).

    q/k/v: [B, T, H, D] (RoPE'd, GQA-widened). The reference's schedule:
    q in at most 8 large blocks (multiples of block_k rows), each
    accumulating through ``_block_attend`` over only the k blocks at or
    below its diagonal. Each block step is checkpointed, so the backward
    pass recomputes its probabilities instead of storing them: peak
    attention memory stays O(T * block_k)."""
    b, t, h, d = q.shape
    dtype = q.dtype
    bk = block_k
    nq = min(8, -(-t // bk))
    bq = -(-t // (nq * bk)) * bk  # q block rows, a multiple of bk
    nq = -(-t // bq)
    if nq * bq - t:
        q = F.pad(q, (0, 0, 0, 0, 0, nq * bq - t))
    nk = -(-t // bk)
    if nk * bk - t:
        # Padded K rows have positions >= t > every real q position, so
        # the causal test masks them; padded q rows are sliced off.
        k = F.pad(k, (0, 0, 0, 0, 0, nk * bk - t))
        v = F.pad(v, (0, 0, 0, 0, 0, nk * bk - t))
    scale = 1.0 / d**0.5

    outs = []
    for i in range(nq):
        q0 = i * bq
        q_i = q[:, q0:q0 + bq]
        nkj = min(nk, -(-(q0 + bq) // bk))  # causal horizon of this q block
        m = torch.full((b, h, bq), float("-inf"), device=q.device)
        el = torch.zeros((b, h, bq), device=q.device)
        o = torch.zeros((b, bq, h, d), device=q.device)
        for j in range(nkj):
            k_j, v_j = k[:, j * bk:(j + 1) * bk], v[:, j * bk:(j + 1) * bk]
            m, el, o = checkpoint(_block_attend, q_i, k_j, v_j, q0, j * bk,
                                  scale, True, m, el, o, use_reentrant=False)
        l_safe = torch.where(el == 0.0, 1.0, el)
        outs.append((o / l_safe.transpose(1, 2)[..., None]).to(dtype))
    return torch.cat(outs, dim=1)[:, :t]


def _flash_block(block_k: int, t: int) -> int:
    """Block grid T pads to: attn_block_k clamped down to a multiple of
    128, and down again to the 128-aligned sequence length (a short
    sequence pads to one small block, not a full 512-row one)."""
    blk = max(128, (block_k // 128) * 128)
    return min(blk, -(-t // 128) * 128)


def _flash_fwd(q, k, v, block_k):
    """Forward through the flash kernel; returns (out [B, t, H, D],
    residuals). T pads to the block grid: padded K rows sit after every
    real row, so no real query attends them, and padded query rows are
    sliced off."""
    b, t, h, d = q.shape
    blk = _flash_block(block_k, t)
    tp = -(-t // blk) * blk
    if tp != t:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, tp - t)) for x in (q, k, v))

    def fold(x):
        # contiguous: at batch 1 the reshape is a strided view.
        return x.transpose(1, 2).reshape(b * h, tp, d).contiguous()

    qf, kf, vf = fold(q), fold(k), fold(v)
    out_p, lse = flash_attention_tri_fwd(qf, kf, vf, block=blk)
    out = out_p.reshape(b, h, tp, d).transpose(1, 2)[:, :t].contiguous()
    # Residuals: q/k/v folded and padded (the backward kernels take that
    # layout), the UNFOLDED output (live downstream anyway, re-folded in
    # the backward) and lse, one f32 per row.
    return out, (qf, kf, vf, out, lse)


def _flash_bwd(block_k, res, g):
    """Backward through the two flash backward kernels."""
    qf, kf, vf, out, lse = res
    b, t, h, d = g.shape
    bh, tp, _ = qf.shape

    def refold(x):
        # [B, t, H, D] -> folded, zero-padded [BH, Tp, D]. Padded rows of
        # the cotangent are 0, so dK/dV take nothing from them, and the
        # padded rows of `out` only enter D = rowsum(dO * O), which those
        # zero rows annihilate.
        xf = x.transpose(1, 2).reshape(bh, t, d)
        if tp != t:
            xf = F.pad(xf, (0, 0, 0, tp - t))
        return xf.contiguous()

    dq, dk, dv = flash_attention_tri_bwd(
        qf, kf, vf, refold(out), lse, refold(g),
        block=_flash_block(block_k, t))

    def unfold(x):
        return x.reshape(b, h, tp, d).transpose(1, 2)[:, :t]

    return unfold(dq), unfold(dk), unfold(dv)


class _FlashAttentionCore(torch.autograd.Function):
    """Causal attention through the flash kernels: forward via
    ``flash_attention_tri_fwd``, backward via the two-pass
    ``flash_attention_tri_bwd`` (P rebuilt from the saved lse). q/k/v:
    [B, T, H, D], GQA-widened."""

    @staticmethod
    def forward(ctx, q, k, v, block_k):
        out, res = _flash_fwd(q, k, v, block_k)
        ctx.save_for_backward(*res)
        ctx.block_k = block_k
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = _flash_bwd(ctx.block_k, ctx.saved_tensors, g)
        return dq, dk, dv, None


def _qkv(cfg: ModelConfig, layer: dict, x: torch.Tensor,
         positions: torch.Tensor | None = None) -> tuple:
    """The attention sublayer's projections and RoPE: (q [B, T, nh, hd],
    k and v [B, T, nkv, hd]), the heads those of ``layer``'s weights (a
    tensor-parallel shard holds nh/tp and nkv/tp of them)."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    dt = x.dtype
    q = (x @ layer["wq"].to(dt)).reshape(b, t, -1, hd)
    k = (x @ layer["wk"].to(dt)).reshape(b, t, -1, hd)
    v = (x @ layer["wv"].to(dt)).reshape(b, t, -1, hd)
    q = _rope(q, cfg.rope_theta, positions=positions)
    k = _rope(k, cfg.rope_theta, positions=positions)
    return q, k, v


def _core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
          v: torch.Tensor) -> torch.Tensor:
    """The configured causal core over one block of whole sequences:
    GQA widening, then flash, chunked or naive; [B, T, nh, hd]."""
    t, nh, hd = q.shape[1:]
    nkv = k.shape[2]
    if nkv != nh:  # grouped-query attention: each kv head serves a group
        k = torch.repeat_interleave(k, nh // nkv, dim=2)
        v = torch.repeat_interleave(v, nh // nkv, dim=2)
    if cfg.attention == "flash":
        return _FlashAttentionCore.apply(q, k, v, cfg.attn_block_k)
    if cfg.attention == "chunked" and t > cfg.attn_block_k:
        return _chunked_attention_core(q, k, v, cfg.attn_block_k)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / hd**0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal[None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _mlp(cfg: ModelConfig, layer: dict, x: torch.Tensor) -> torch.Tensor:
    """The dense SwiGLU FFN (over a tensor-parallel shard's weights, the
    shard's row-parallel partial)."""
    dt = x.dtype
    h = F.silu(x @ layer["w_gate"].to(dt)) * (x @ layer["w_up"].to(dt))
    return h @ layer["w_down"].to(dt)


def _moe_config(cfg: ModelConfig) -> MoEConfig:
    return MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                     n_experts=cfg.n_experts,
                     capacity_factor=cfg.moe_capacity_factor)


def _moe_mlp(cfg: ModelConfig, moe_params: dict, x: torch.Tensor,
             full_capacity: bool = False,
             expert_offset: int = 0) -> torch.Tensor:
    """Routed expert FFN over [B, T, D]: flattens the tokens, routes them
    through ``moe.moe_ffn`` (top-1, fixed capacity, or G with
    ``full_capacity``: no drops) and restores the shape. Every leaf but
    the f32 router is taken in the compute dtype first (a quantized one
    dequantized), as the reference casts them; the products then run in
    f32 and the result comes back in the compute dtype. A tensor-parallel
    shard's block of experts starts at ``expert_offset``."""
    b, t, d = x.shape
    dt = x.dtype
    params = {k: v if k == "router" else v.to(dt)
              for k, v in moe_params.items()}
    out = moe_ffn(_moe_config(cfg), params, x.reshape(b * t, d),
                  capacity=b * t if full_capacity else None,
                  expert_offset=expert_offset)
    return out.reshape(b, t, d).to(dt)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``; with ``cfg.remat`` its activations are not kept but
    recomputed in the backward pass (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint`` of each layer). Every layer loop, on
    one device or over a mesh, goes through here."""
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _mesh_layer(cfg: ModelConfig, layers: dict, x: dict, pos: dict,
                ring=None) -> dict:
    """One transformer layer over a grid of cells (d, r, s): batch rows d
    and sequence block s through tensor-parallel shard r, whose weights
    are ``layers[d, r, s]``, activation ``x[d, r, s]`` [B/dp, T/sp, D] and
    positions ``pos[d, r, s]`` (None: 0..T-1). Each sublayer's
    row-parallel partials of one (d, s) line meet in ``all_reduce_sum``
    over "model" and are added to the residual. Attention: with one
    sequence block each (d, r) runs ``cfg.attention`` over whole
    sequences (flash: the kernels, one call a shard); with more,
    ``ring(qs, ks, vs)`` takes the blocks' (q, unwidened k, v) of one
    (d, r) line and returns their outputs. A MoE layer routes the whole
    batch at once (``_moe_layer``). Returns the new activations and
    leaves ``x`` as it was, so a recomputing backward (``_remat``) reads
    the same inputs. One cell is the single-device layer
    (``_layer_block``)."""
    dp, tp, sp = (1 + max(c[i] for c in x) for i in range(3))

    def residual(x, parts):
        out = {}
        for d in range(dp):
            for s in range(sp):
                sums = all_reduce_sum([parts[d, r, s] for r in range(tp)])
                for r in range(tp):
                    out[d, r, s] = x[d, r, s] + sums[r]
        return out

    def attn_weights(d, r, s):
        # With fewer kv heads than shards a shard's "model" block of wk/wv
        # holds part of a kv head: it reads the kv heads its query heads
        # use from its neighbours' blocks (an all-gather of the weight
        # columns, as XLA's global product reads them).
        own = layers[d, r, s]
        if cfg.n_kv_heads % tp == 0:
            return own
        dev = x[d, r, s].device
        return {**own, **{w: _kv_columns(
            cfg, tp, r, lambda r2, w=w: layers[d, r2, s][w].to(dev))
            for w in ("wk", "wv")}}

    parts = {}
    for d in range(dp):
        for r in range(tp):
            qkv = [_qkv(cfg, attn_weights(d, r, s),
                        _rms_norm(x[d, r, s], layers[d, r, s]["attn_norm"]),
                        pos[d, r, s]) for s in range(sp)]
            outs = ([_core(cfg, *qkv[0])] if ring is None
                    else ring(*zip(*qkv)))
            for s, out in enumerate(outs):
                h = x[d, r, s]
                parts[d, r, s] = out.reshape(*h.shape[:2], -1) @ layers[
                    d, r, s]["wo"].to(h.dtype)
    x = residual(x, parts)
    if "moe" in layers[0, 0, 0]:
        if sp > 1:
            raise ValueError("the MoE family does not run over a "
                             "sequence axis")
        parts = _moe_layer(cfg, layers, x, dp, tp)
    else:
        parts = {c: _mlp(cfg, layers[c], _rms_norm(x[c],
                                                   layers[c]["mlp_norm"]))
                 for c in x}
    return residual(x, parts)


def _layer_block(cfg: ModelConfig, x: torch.Tensor,
                 layer: dict) -> torch.Tensor:
    """One transformer layer on one device: ``_mesh_layer`` over a single
    cell."""
    one = (0, 0, 0)
    return _mesh_layer(cfg, {one: layer}, {one: x}, {one: None})[one]


def forward(cfg: ModelConfig, params: dict,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] float32."""
    refuse_latent(cfg, "the training forward")
    dt = cfg.torch_dtype
    x = params["embed"].to(dt)[tokens.long()]
    for layer in params["layers"]:
        x = _remat(cfg, _layer_block, cfg, x, layer)
    x = _rms_norm(x, params["final_norm"])
    return (x @ params["lm_head"].to(dt)).float()


def _token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each position's cross-entropy [B, T] of [B, T, V] logits against
    [B, T] targets."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def next_token_nll(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of [B, T, V] logits against [B, T] targets."""
    return _token_nll(logits, targets).mean()


def loss_fn(cfg: ModelConfig, params: dict,
            tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over a [B, T] batch."""
    logits = forward(cfg, params, tokens[:, :-1])
    return next_token_nll(logits, tokens[:, 1:])


def value_and_grad(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """(loss, grads in the order of ``param_leaves(params)``). The params
    track gradients only for this call."""
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with profiler_span("train.forward"):
            loss = loss_fn(cfg, params, tokens)
        with profiler_span("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads
    finally:
        for p in leaves:
            p.requires_grad_(False)


def sgd_train_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   lr: float = 1e-3) -> tuple[dict, torch.Tensor]:
    """One SGD step; returns (params, loss). Unlike the reference, which
    returns new arrays, it updates the f32 master params IN PLACE (under
    ``torch.no_grad()``), so no second copy of the weights is live; the
    returned dict is ``params`` itself."""
    refuse_latent(cfg, "sgd_train_step")
    loss, grads = value_and_grad(cfg, params, tokens)
    with torch.no_grad(), profiler_span("train.update"):
        for p, g in zip(param_leaves(params), grads):
            p.sub_(lr * g)
    return params, loss


# ---------------------------------------------------------------------------
# The mesh: tensor parallel over "model", replicated elsewhere
# ---------------------------------------------------------------------------


class Mesh:
    """Devices laid out over named axes: the counterpart of
    ``jax.sharding.Mesh`` for one controller. ``devices`` is array-like
    with one dimension per axis name (a device may repeat); ``shape`` maps
    each axis name to its size, read as ``mesh.shape["model"]`` and
    ``mesh.shape.get("data", 1)``."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        given = np.asarray(devices, dtype=object)
        if given.ndim != len(axis_names):
            raise ValueError(f"devices of shape {given.shape} do not match "
                             f"the axes {tuple(axis_names)}")
        self.devices = np.empty(given.shape, dtype=object)
        for idx, d in np.ndenumerate(given):
            self.devices[idx] = torch.device(d)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, given.shape))

    @property
    def device_list(self) -> list[torch.device]:
        """The devices in row-major order (shard order)."""
        return list(self.devices.flat)

    def coords(self, i: int) -> dict:
        """{axis name: coordinate} of the ``i``-th device of
        ``device_list``."""
        at = np.unravel_index(i, self.devices.shape)
        return {a: int(c) for a, c in zip(self.axis_names, at)}

    def index(self, **coords: int) -> int:
        """The place in ``device_list`` of the device at ``coords``. An
        axis left out is at 0, and so must be one the mesh lacks (its size
        is 1)."""
        stray = {a: c for a, c in coords.items()
                 if a not in self.shape and c}
        if stray:
            raise ValueError(f"the mesh has no axes {sorted(stray)}; its "
                             f"axes are {self.axis_names}")
        return int(np.ravel_multi_index(
            tuple(coords.get(a, 0) for a in self.axis_names),
            self.devices.shape))

    def model_index(self, i: int) -> int:
        """The "model" coordinate of the ``i``-th device of
        ``device_list`` (0 on a mesh without that axis)."""
        return self.coords(i).get("model", 0)


# The reference's Megatron split: column-parallel wq/wk/wv/w_gate/w_up and
# lm_head (their output columns over "model"), row-parallel wo/w_down (their
# input rows), the MoE experts over "model" (expert parallelism on the tp
# axis), everything else replicated. A spec names each dim's mesh axis.
PARAM_SPECS = {
    "embed": (None, None),
    "final_norm": (None,),
    "lm_head": (None, "model"),
    "attn_norm": (None,),
    "mlp_norm": (None,),
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "wo": ("model", None),
    "w_gate": (None, "model"),
    "w_up": (None, "model"),
    "w_down": ("model", None),
    "router": (None, None),
    "w_in": ("model", None, None),
    "w_out": ("model", None, None),
}


def param_shardings(mesh: Mesh, params, _name: str = ""):
    """The spec tree of ``params`` (the mesh only fixes the axis names).
    A quantized weight (``quant.QTensor``) gets a QTensor of specs: its
    int8 ``q`` keeps the weight's spec, and its per-output-channel
    ``scale`` takes the spec of the weight's last axis, so
    column-parallel weights get split scales and row-parallel ones
    replicated scales, as in the reference."""
    from tpumon_torch.loadgen.quant import QTensor

    del mesh
    if isinstance(params, dict):
        return {k: param_shardings(None, v, k) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [param_shardings(None, v, _name) for v in params]
    spec = PARAM_SPECS.get(_name, ())
    if isinstance(params, QTensor):
        return QTensor(q=spec, scale=(spec[-1],) if spec else ())
    return spec


def _check_moe_tp(cfg: ModelConfig, mesh: Mesh) -> None:
    """Experts shard over the "model" axis, so the expert count must
    divide it."""
    tp = mesh.shape.get("model", 1) if hasattr(mesh, "shape") else 1
    if cfg.n_experts and cfg.n_experts % tp:
        raise ValueError(
            f"n_experts={cfg.n_experts} must be divisible by the mesh's "
            f"'model' axis ({tp}) — experts shard over it")


def _block(t: torch.Tensor, spec: tuple, coords: dict,
           mesh: Mesh) -> torch.Tensor:
    """The block of ``t`` that the device at ``coords`` holds under
    ``spec`` (each dim named by a mesh axis split evenly over it), as a
    view."""
    for axis, name in enumerate(spec):
        if name is None or name not in mesh.shape:
            continue
        n = mesh.shape[name]
        if t.shape[axis] % n:
            raise ValueError(
                f"a weight dim of {t.shape[axis]} does not split over "
                f"{'tp' if name == 'model' else name}={n}")
        size = t.shape[axis] // n
        t = t.narrow(axis, coords[name] * size, size)
    return t


def _spec_map(params, specs, fn, name: str = ""):
    """``fn(leaf, spec, name)`` over a param tree and its spec tree (a
    spec is a tuple, so tuples are leaves here); a quantized weight gets
    its ``q`` and ``scale`` mapped each under its own spec, with name
    None."""
    from tpumon_torch.loadgen.quant import QTensor

    if isinstance(params, dict):
        return {k: _spec_map(v, specs[k], fn, k) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_spec_map(v, s, fn, name) for v, s in zip(params, specs)]
    if isinstance(params, QTensor):
        return QTensor(q=fn(params.q, specs.q, None),
                       scale=fn(params.scale, specs.scale, None))
    return fn(params, specs, name)


def shard_params(mesh: Mesh, params: dict, dtype: torch.dtype | None = None,
                 specs=None) -> list:
    """One param dict per device of ``mesh`` (``device_list`` order), each
    holding its block of every weight under ``specs`` (default
    ``param_shardings``: the "model" split) as its own allocation on its
    device, even where devices repeat. ``dtype`` casts every float leaf
    but the MoE router (f32, as the reference routes); a quantized weight
    keeps its int8 codes and f32 scales."""
    specs = param_shardings(mesh, params) if specs is None else specs

    def place(i, device):
        coords = mesh.coords(i)

        def leaf(t, spec, name):
            # A quantized weight's parts (name None) keep their types.
            dt = (torch.float32 if name == "router" else
                  dtype if name is not None and t.is_floating_point()
                  else None)
            blk = _block(t, spec, coords, mesh)
            return torch.empty(blk.shape, dtype=dt or blk.dtype,
                               device=device).copy_(blk)

        return _spec_map(params, specs, leaf)

    return [place(i, dev) for i, dev in enumerate(mesh.device_list)]


def shard_views(mesh: Mesh, params: dict, specs=None) -> list:
    """``shard_params``'s blocks as differentiable views of one full
    param tree: a gradient taken through them lands on ``params`` itself,
    summed over every device that reads a block (the psum of a replicated
    weight). On a device that already holds the tree nothing is copied."""
    specs = param_shardings(mesh, params) if specs is None else specs
    return [_spec_map(params, specs, lambda t, spec, _, c=mesh.coords(i),
                      d=dev: _block(t, spec, c, mesh).to(d))
            for i, dev in enumerate(mesh.device_list)]


def unshard_params(mesh: Mesh, placed: list, specs=None):
    """The full tree from per-device blocks (``shard_params``' layout):
    each leaf's blocks concatenated along its split dims, read from the
    devices at coordinate 0 of every axis its spec does not name, on the
    first device. ``specs`` default: ``param_shardings``."""
    specs = param_shardings(mesh, placed[0]) if specs is None else specs
    home = mesh.device_list[0]
    leaves = [param_leaves(p) for p in placed]
    return _regroup(placed[0], [
        _gather_leaf(mesh, [ls[j] for ls in leaves], spec, home)
        for j, spec in enumerate(_spec_leaves(specs))])


def _gather_leaf(mesh: Mesh, blocks: list, spec: tuple, home,
                 fixed: dict | None = None) -> torch.Tensor:
    """One leaf put back together from its per-device ``blocks`` (device
    order): concatenated along each dim that ``spec`` names, in axis
    order."""
    fixed = dict(fixed or {})
    for axis, name in enumerate(spec):
        if name in mesh.shape and name not in fixed:
            return torch.cat([
                _gather_leaf(mesh, blocks, spec, home, {**fixed, name: c})
                for c in range(mesh.shape[name])], dim=axis)
    return blocks[mesh.index(**fixed)].to(home)


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in ``param_leaves`` order."""
    if isinstance(specs, dict):
        return [x for v in specs.values() for x in _spec_leaves(v)]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


def replicated_specs(params):
    """The spec tree that replicates every leaf of ``params``."""
    return map_params(params, lambda t: (None,) * t.dim())


def mesh_value_and_grad(mesh: Mesh, placed: list, specs, loss_fn):
    """(loss, grads) of ``loss_fn(placed)`` over per-device param blocks:
    one backward pass through every shard (autograd follows the ``.to()``
    copies between devices), then each block's gradient summed, in device
    order, over the devices that hold that block (those that agree on
    every axis its spec names: the psum over "data" and the other
    replicated axes). ``grads`` is one list per device in
    ``param_leaves`` order, each entry that block's summed gradient on
    that device (zeros where no device read it)."""
    leaves = [param_leaves(p) for p in placed]
    flat = [x for ls in leaves for x in ls]
    for x in flat:
        x.requires_grad_(True)
    try:
        loss = loss_fn(placed)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for x in flat:
            x.requires_grad_(False)
    n = len(leaves[0])
    per_dev = [got[i * n:(i + 1) * n] for i in range(len(placed))]
    coords = [mesh.coords(i) for i in range(len(placed))]
    grads = [[None] * n for _ in placed]
    for j, spec in enumerate(_spec_leaves(specs)):
        named = [a for a in spec if a in mesh.shape]
        groups: dict = {}
        for i, c in enumerate(coords):
            groups.setdefault(tuple(c[a] for a in named), []).append(i)
        for members in groups.values():
            total = None
            for i in members:
                g = per_dev[i][j]
                if g is not None:
                    total = g if total is None else total + g.to(total.device)
            if total is None:
                total = torch.zeros_like(leaves[members[0]][j])
            for i in members:
                grads[i][j] = total.to(leaves[i][j].device)
    return loss.detach(), grads


def mesh_sgd_step(mesh: Mesh, placed: list, specs, loss_fn,
                  lr: float = 1e-3):
    """One SGD step over per-device param blocks: ``mesh_value_and_grad``,
    then every copy of a block updated in place by the same summed
    gradient, so replicas stay bit-identical. Returns (placed, loss)."""
    loss, grads = mesh_value_and_grad(mesh, placed, specs, loss_fn)
    with torch.no_grad():
        for p, gs in zip(placed, grads):
            for x, g in zip(param_leaves(p), gs):
                x.sub_(lr * g)
    return placed, loss


def mesh_loss(cfg: ModelConfig, views: list, mesh: Mesh,
              inputs: torch.Tensor, labels: torch.Tensor,
              positions: torch.Tensor | None = None,
              data_axis: str | None = "data", seq_axis: str | None = None,
              ring=None) -> torch.Tensor:
    """Mean next-token NLL of ``labels`` [B, T] given ``inputs`` [B, T]
    over a mesh of (``data_axis``, "model", ``seq_axis``), any of them
    absent; ``views`` holds each device's param blocks (``shard_params`` or
    ``shard_views`` under ``param_shardings``).

    Device (d, r, s) runs batch rows d and sequence block s through shard
    r's heads, FFN columns or experts, one ``_mesh_layer`` a layer (under
    ``_remat``), with ``ring`` as it takes it (``sp_train``'s ring or
    zigzag when there is a sequence axis); the vocab-split logits meet in
    ``gather_vocab``, and the loss is the sum of every (d, s) block's NLL
    over the token count, on the first device. ``positions`` [T]: each
    row's global position (default 0..T-1)."""
    dp = mesh.shape[data_axis] if data_axis else 1
    tp = mesh.shape.get("model", 1)
    sp = mesh.shape[seq_axis] if seq_axis else 1
    unused = set(mesh.axis_names) - {data_axis, "model", seq_axis}
    if unused:
        raise ValueError(f"mesh axes {sorted(unused)} carry nothing here")
    b, t = inputs.shape
    if b % dp or t % sp:
        raise ValueError(f"a [{b}, {t}] batch does not split over "
                         f"data={dp} x seq={sp}")
    bd, ts = b // dp, t // sp
    dt = cfg.torch_dtype
    if positions is None:
        positions = torch.arange(t)

    def at(d, r, s):
        return mesh.index(**{data_axis or "data": d, "model": r,
                             seq_axis or "seq": s})

    devs = mesh.device_list
    cells = [(d, r, s) for d in range(dp) for r in range(tp)
             for s in range(sp)]
    x, pos = {}, {}
    for d, r, s in cells:
        i = at(d, r, s)
        blk = inputs[d * bd:(d + 1) * bd, s * ts:(s + 1) * ts]
        x[d, r, s] = views[i]["embed"].to(dt)[blk.to(devs[i]).long()]
        pos[d, r, s] = positions[s * ts:(s + 1) * ts].to(devs[i])
    for li in range(len(views[0]["layers"])):
        layers = {c: views[at(*c)]["layers"][li] for c in cells}
        x = _remat(cfg, _mesh_layer, cfg, layers, x, pos, ring)
    home = devs[0]
    total = None
    for d in range(dp):
        for s in range(sp):
            logits = gather_vocab([
                _rms_norm(x[d, r, s], views[at(d, r, s)]["final_norm"])
                @ views[at(d, r, s)]["lm_head"].to(dt)
                for r in range(tp)]).float()
            lab = labels[d * bd:(d + 1) * bd, s * ts:(s + 1) * ts]
            nll = _token_nll(logits, lab.to(logits.device)).sum().to(home)
            total = nll if total is None else total + nll
    return total / (b * t)


def _kv_columns(cfg: ModelConfig, tp: int, r: int, block) -> torch.Tensor:
    """The columns of wk (or wv) that shard ``r``'s query heads read, cut
    from the weight's "model" blocks (``block(r2)``: block r2 on shard r's
    device; only the blocks that hold those columns are read)."""
    hd, group = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    qh = cfg.n_heads // tp
    lo = (r * qh // group) * hd
    hi = (((r + 1) * qh - 1) // group + 1) * hd
    blk = cfg.n_kv_heads * hd // tp
    first, last = lo // blk, (hi - 1) // blk
    cols = torch.cat([block(r2) for r2 in range(first, last + 1)], dim=1)
    return cols[:, lo - first * blk:hi - first * blk]


def _moe_layer(cfg: ModelConfig, layers: dict, x: dict, dp: int,
               tp: int) -> dict:
    """The MoE FFN of one layer over a (data, model) grid of cells
    (``_mesh_layer``'s): the whole batch routed at once by the first
    cell's router (capacity from the global token count), each "model"
    shard's block of experts run over every data row's tokens that it
    owns; {(d, r, 0): partial [B/dp, T, D]}, zeros for tokens routed to
    other shards."""
    dt = x[0, 0, 0].dtype
    hm = {(d, r): _rms_norm(x[d, r, 0], layers[d, r, 0]["mlp_norm"])
          for d in range(dp) for r in range(tp)}
    bd, t, dm = hm[0, 0].shape
    home = hm[0, 0].device
    router = layers[0, 0, 0]["moe"]["router"]
    tokens = torch.cat([hm[d, 0].reshape(-1, dm).to(home)
                        for d in range(dp)])
    assign = route(router, tokens, _moe_config(cfg).capacity(len(tokens)))
    e_loc = cfg.n_experts // tp
    parts = {}
    for d in range(dp):
        rows = slice(d * bd * t, (d + 1) * bd * t)
        for r in range(tp):
            moe = layers[d, r, 0]["moe"]
            out = expert_block_outputs(
                {k: v.to(dt) for k, v in moe.items() if k != "router"},
                hm[d, r].reshape(-1, dm), assign, rows, r * e_loc)
            parts[d, r, 0] = out.reshape(bd, t, dm).to(dt)
    return parts


def make_sharded_train_step(cfg: ModelConfig, mesh: Mesh, params: dict):
    """The dp x tp SGD step (lr 1e-3) over a ("data", "model") mesh;
    returns (step_fn, placed).

    ``placed`` holds each device's blocks of ``params`` under
    ``PARAM_SPECS`` (``shard_params``: f32 masters, each its own
    allocation). ``step_fn(placed, tokens)`` splits the [B, T+1] tokens
    over "data", runs ``mesh_loss`` and updates every copy in place by its
    block's gradient summed over "data" (``mesh_sgd_step``); it returns
    (placed, loss). ``step_fn.specs`` is the spec tree of ``placed``."""
    refuse_latent(cfg, "make_sharded_train_step")
    _check_moe_tp(cfg, mesh)
    specs = param_shardings(mesh, params)
    placed = shard_params(mesh, params, specs=specs)
    data = "data" if "data" in mesh.shape else None

    def step(p, tokens):
        return mesh_sgd_step(mesh, p, specs, lambda v: mesh_loss(
            cfg, v, mesh, tokens[:, :-1], tokens[:, 1:], data_axis=data))

    step.specs = specs
    return step, placed


def _regroup(tree, flat: list):
    """``flat`` (``param_leaves`` order) in ``tree``'s structure."""
    it = iter(flat)
    return map_params(tree, lambda _: next(it))


def all_reduce_sum(parts: list) -> list:
    """The psum over "model" that XLA inserts after a row-parallel
    product: the shards' partials summed in shard order on shard 0's
    device, the result copied back to each shard's device. One card holds
    every shard when the mesh repeats it, and the sum is then local."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total.to(p.device) for p in parts]


def gather_vocab(parts: list) -> torch.Tensor:
    """The all-gather of vocab-split logits (``lm_head`` is
    column-parallel): the shards' slices concatenated in shard order on
    shard 0's device."""
    home = parts[0].device
    return torch.cat([p.to(home) for p in parts], dim=-1)


def replica_meshes(dp: int, tp: int, dense: bool = False,
                   devices=None) -> list:
    """Carve the devices into ``dp`` disjoint tensor-parallel submeshes,
    one per data-parallel replica: the replica's Mesh over its own ``tp``
    contiguous devices, or None when tp == 1 (a plain single-device
    engine). ``dense`` picks the dense serving path's ("data", "model")
    axes (a data axis of 1); paged serving is tensor-parallel only, over a
    bare ("model",) axis. ``devices`` None: ``visible_devices()``. Raises
    ValueError when dp*tp does not tile the device count (the reference's
    text)."""
    devices = list(visible_devices() if devices is None else devices)
    ndev = len(devices)
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh shape dp×tp must be >= 1x1, got {dp}x{tp}")
    if dp * tp > ndev or ndev % (dp * tp):
        raise ValueError(
            f"mesh shape dp×tp = {dp}x{tp} needs {dp * tp} devices but "
            f"{ndev} are visible — dp*tp must divide the device count")
    out = []
    for d in range(dp):
        devs = devices[d * tp:(d + 1) * tp]
        if tp == 1:
            out.append(None)
        elif dense:
            out.append(Mesh([devs], ("data", "model")))
        else:
            out.append(Mesh(devs, ("model",)))
    return out
