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
``params["layers"][li]["wq"]`` in both packages.

The mesh (serving over a dp x tp layout): ``Mesh`` names a set of devices
over the axes "data" and "model", as ``jax.sharding.Mesh`` does, for ONE
controller process; a device may repeat, so dp x tp runs on one card (or
on the CPU) through the same code as on many. ``PARAM_SPECS`` and
``param_shardings`` are the reference's Megatron split, ``shard_params``
applies it (one param dict per shard, each its own allocation on its
shard's device), and ``all_reduce_sum`` and ``gather_vocab`` are the two
collectives XLA inserts there: the sum of row-parallel partials and the
gather of vocab-split logits. ``replica_meshes`` carves the devices into
dp tensor-parallel submeshes. The mesh-sharded train step is multi-GPU
work, not yet ported (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpumon_torch.loadgen.moe import MoEConfig, init_moe_params, moe_ffn
from tpumon_torch.loadgen.ring_attention import _block_attend
from tpumon_torch.ops.flash_attention import (
    flash_attention_tri_bwd,
    flash_attention_tri_fwd,
)


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
    device torch sees (``resolve_device``'s rule for the default), or the
    one CPU device when ``device`` is a CPU."""
    device = resolve_device(device)
    if device.type != "cuda":
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


def _attention(cfg: ModelConfig, layer: dict, x: torch.Tensor,
               positions: torch.Tensor | None = None) -> torch.Tensor:
    """One attention sublayer: projections, RoPE, GQA widening, the
    configured causal core, and wo."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ layer["wq"].to(dt)).reshape(b, t, nh, hd)
    k = (x @ layer["wk"].to(dt)).reshape(b, t, nkv, hd)
    v = (x @ layer["wv"].to(dt)).reshape(b, t, nkv, hd)
    q = _rope(q, cfg.rope_theta, positions=positions)
    k = _rope(k, cfg.rope_theta, positions=positions)
    if nkv != nh:  # grouped-query attention: each kv head serves a group
        k = torch.repeat_interleave(k, nh // nkv, dim=2)
        v = torch.repeat_interleave(v, nh // nkv, dim=2)
    if cfg.attention == "flash":
        out = _FlashAttentionCore.apply(q, k, v, cfg.attn_block_k)
    elif cfg.attention == "chunked" and t > cfg.attn_block_k:
        out = _chunked_attention_core(q, k, v, cfg.attn_block_k)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / hd**0.5
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        scores = torch.where(causal[None, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(b, t, nh * hd) @ layer["wo"].to(dt)


def _mlp(cfg: ModelConfig, layer: dict, x: torch.Tensor) -> torch.Tensor:
    if "moe" in layer:
        return _moe_mlp(cfg, layer["moe"], x)
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


def _layer_block(cfg: ModelConfig, x: torch.Tensor,
                 layer: dict) -> torch.Tensor:
    x = x + _attention(cfg, layer, _rms_norm(x, layer["attn_norm"]))
    return x + _mlp(cfg, layer, _rms_norm(x, layer["mlp_norm"]))


def forward(cfg: ModelConfig, params: dict,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] float32."""
    dt = cfg.torch_dtype
    x = params["embed"].to(dt)[tokens.long()]
    for layer in params["layers"]:
        if cfg.remat:
            x = checkpoint(_layer_block, cfg, x, layer, use_reentrant=False)
        else:
            x = _layer_block(cfg, x, layer)
    x = _rms_norm(x, params["final_norm"])
    return (x @ params["lm_head"].to(dt)).float()


def next_token_nll(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of [B, T, V] logits against [B, T] targets."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean()


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
        loss = loss_fn(cfg, params, tokens)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)


def sgd_train_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   lr: float = 1e-3) -> tuple[dict, torch.Tensor]:
    """One SGD step; returns (params, loss). Unlike the reference, which
    returns new arrays, it updates the f32 master params IN PLACE (under
    ``torch.no_grad()``), so no second copy of the weights is live; the
    returned dict is ``params`` itself."""
    loss, grads = value_and_grad(cfg, params, tokens)
    with torch.no_grad():
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

    def model_index(self, i: int) -> int:
        """The "model" coordinate of the ``i``-th device of
        ``device_list``."""
        coords = np.unravel_index(i, self.devices.shape)
        return int(coords[self.axis_names.index("model")])


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


def _take_shard(t: torch.Tensor, spec: tuple, r: int, tp: int, device,
                dtype) -> torch.Tensor:
    """Shard ``r`` of ``tp`` of ``t`` under ``spec`` as a fresh allocation
    on ``device`` (``dtype`` None: t's own)."""
    if "model" in spec:
        axis = spec.index("model")
        if t.shape[axis] % tp:
            raise ValueError(
                f"a weight dim of {t.shape[axis]} does not split over "
                f"tp={tp}")
        n = t.shape[axis] // tp
        t = t.narrow(axis, r * n, n)
    out = torch.empty(t.shape, dtype=dtype or t.dtype, device=device)
    return out.copy_(t)


def shard_params(mesh: Mesh, params: dict,
                 dtype: torch.dtype | None = None) -> list:
    """One param dict per device of ``mesh`` (``device_list`` order), each
    holding its "model" shard of every weight (``param_shardings``) as its
    own allocation on its device, even where devices repeat. ``dtype``
    casts every float leaf but the MoE router (f32, as the reference
    routes); a quantized weight keeps its int8 codes and f32 scales."""
    from tpumon_torch.loadgen.quant import QTensor

    specs = param_shardings(mesh, params)
    tp = mesh.shape.get("model", 1)

    def split(tree, spec, r, device, name=""):
        if isinstance(tree, dict):
            return {k: split(v, spec[k], r, device, k)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [split(v, s, r, device) for v, s in zip(tree, spec)]
        if isinstance(tree, QTensor):
            return QTensor(
                q=_take_shard(tree.q, spec.q, r, tp, device, None),
                scale=_take_shard(tree.scale, spec.scale, r, tp, device,
                                  None))
        dt = torch.float32 if name == "router" else dtype
        return _take_shard(tree, spec, r, tp, device, dt)

    return [split(params, specs, mesh.model_index(i), dev)
            for i, dev in enumerate(mesh.device_list)]


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
