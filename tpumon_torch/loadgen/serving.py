"""JetStream-style serving engine on PyTorch: continuous batching over a
dense KV cache or a paged KV pool + /metrics.

Counterpart of ``tpumon/loadgen/serving.py``: a continuous-batching
engine that exposes the same JetStream-compatible Prometheus families as
the reference — TTFT histogram, token/request counters, queue and slot
gauges, ``tpumon_serving_*`` latency gauges — so the unchanged monitor
(tpumon/collectors/serving.py) scrapes it over HTTP exactly as it scrapes
the JAX loadgen.

Ported here: both KV layouts (the dense cache of this module and the
paged pool of ``tpumon_torch.loadgen.paged_kv``, with both paged decode
read paths: ``gather`` and the CUDA ``kernel``), fused block decode
(``decode_block``), keyed temperature/top-k sampling (the reference's
threefry draws, fused on the card by ``tpumon_torch.ops.threefry``), the
interleaved chunked-prefill and the sequential schedulers, cancellation,
backpressure, per-tenant accounting, speculative decoding (self draft,
layer-truncated draft, prompt lookup; dense and paged), prefix caching
(dense snapshot/restore, paged page sharing), int8 weights
(``tpumon_torch.loadgen.quant``) and the int8 KV cache and pool, the
actuator verbs (``set_shed``, ``nudge_capacity``, the slice drain and
requeue, ``adopt``/``evict_all``), serving a trainer checkpoint
(``ckpt_dir``), the /metrics + /generate server, the arrival loop and
``start_background``, the MoE model family (``decoder_forward`` routes
at full capacity, so every mode emits the same tokens) and the workload
self-report (``engine.reporter``, ``tpumon_torch.loadgen.report``), and
mesh serving: ``ServingEngine(mesh=...)`` is tensor-parallel over its
mesh's "model" axis (``model.shard_params``, dense and paged, int8
weights, block decode, paged speculation, MoE), ``MeshServingEngine`` puts
``mesh_dp`` such replicas behind the reference's affinity router, and
``make_serving_engine`` picks the shape from the config; the ring engine
mode (``ring_stripes``, ``paged_attn="ring"``) admits contexts up to
``ring_stripes`` x max_seq. The defaults are the reference's:
``kv_layout="dense"``, ``paged_attn="gather"``.

A mesh here is one controller over a list of devices that may repeat
(``model.Mesh``): each shard runs its heads and FFN columns on its own
device, and the row-parallel partials meet in ``model.all_reduce_sum``,
where XLA inserts its psum. On one card the shards share it and the sum is
device-local.

Host-mirror discipline as in the reference: positions are mirrored on the
host, so a decode step (or a fused block of ``decode_block`` steps) costs
exactly ONE device→host sync (the sampled tokens' ``.tolist()``); so does
a speculative round (its proposals and the verify argmax together).
"""

from __future__ import annotations

import itertools
import queue
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace as dc_replace
from functools import partial

import torch
import torch.nn.functional as F

from tpumon_torch import prng
from tpumon_torch.loadgen.checkpoint import (
    restore_checkpoint,
    saved_model_config,
)
from tpumon_torch.loadgen.model import (
    LatentModelConfig,
    ModelConfig,
    _check_moe_tp,
    _moe_mlp,
    _rms_norm,
    all_reduce_sum,
    gather_vocab,
    init_params,
    leaf_bytes,
    param_bytes,
    param_leaves,
    replica_meshes,
    resolve_device,
    rope_cos_sin_scale,
    rope_inv_freq,
    routed_layer,
    shard_params,
    topk_config,
    visible_devices,
)
from tpumon_torch.loadgen.moe import topk_ffn
from tpumon_torch.loadgen.paged_kv import (
    PageAllocator,
    PagePrefixCache,
    init_pool,
    paged_decode_block,
    paged_decode_rounds,
    paged_decode_step,
    paged_prefill,
    prefill_rows,
)
from tpumon_torch.loadgen.prefix_cache import PrefixCache
from tpumon_torch.loadgen.prompt_lookup import ngram_propose
from tpumon_torch.loadgen.quant import QTensor, quantize_params
from tpumon_torch.loadgen.speculative import decode_block, greedy_accept_len
from tpumon_torch.metrics_text import MetricsWriter
from tpumon_torch.ops import threefry
from tpumon_torch.tracing import profiler_span, quantiles

# TTFT histogram bucket upper bounds, seconds (JetStream buckets are
# seconds; the serving distiller converts quantiles to ms).
TTFT_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

# Ceiling on any per-tenant admission-shed fraction (set_shed clamps to
# it): the engine never sheds a whole tenant, so some live traffic always
# survives to show recovery.
SHED_CAP = 0.95


@dataclass(frozen=True)
class ServeConfig:
    """The reference's ServeConfig, field for field, with its
    defaults."""

    model: ModelConfig = field(default_factory=ModelConfig)
    slots: int = 4  # concurrent decode slots (continuous batching)
    prefill_len: int = 64  # static prompt padding length == page size
    # MoE prefill-chunk cap: serving routes MoE layers at full capacity
    # (C = the chunk's G tokens, so every mode emits the same tokens), so
    # a chunk's expert products run over E x G rows and the reference's
    # dispatch/combine tensors are [G, E, G]. The engine refuses MoE
    # configs whose prefill_len exceeds the cap (the reference's message).
    moe_prefill_max_chunk: int = 256
    # Weight-only quantization: None (compute dtype) or "int8"
    # (tpumon_torch.loadgen.quant).
    quantize: str | None = None
    # Speculative decoding: spec_len proposals a round, verified in one
    # target block (speculative.decode_block / paged_decode_block, the
    # gather read); 0 = off. draft_model None = self-speculation; a
    # layer-truncated draft_model shares the target's bottom layers.
    # spec_source="prompt" proposes by n-gram lookup in the request's own
    # context (prompt_lookup), searching its last spec_ngram_window
    # tokens (0 = all).
    spec_len: int = 0
    draft_model: ModelConfig | None = None
    spec_source: str = "draft"
    spec_ngram_window: int = 1024
    # Prefix caching: LRU entries of chunk-aligned prompt-prefix K/V; 0 =
    # off. Dense: snapshot and restore by copy (prefix_cache); paged:
    # shared refcounted pages (paged_kv.PagePrefixCache).
    prefix_cache_entries: int = 0
    # KV layout: "dense" reserves slots*max_seq rows (init_cache);
    # "paged" reserves prefill_len-row pages per request from a shared
    # pool (tpumon_torch.loadgen.paged_kv).
    kv_layout: str = "dense"
    pool_pages: int = 0  # 0 = the dense equivalent, slots*max_pages + 1
    # Paged read path: "gather" (plain torch: gather the table's pages,
    # attend densely), "kernel" (tpumon_torch.ops.paged_attention, the
    # CUDA kernel on a GPU; its plain version on the CPU) or "ring"
    # (ring_attention.paged_ring_decode_attend: the table's pages one at a
    # time through the online-softmax accumulator). It chooses the
    # prefill chunk's read as well: "kernel" reads it through
    # tpumon_torch.ops.prefill_attention (the pages up to the chunk's own)
    # where that kernel takes the pool (bf16, head dim 64 or 128, a page
    # that is a multiple of 128; paged_kv.prefill_reads_kernel); every
    # other pool, and "gather" and "ring", gather the whole table.
    paged_attn: str = "gather"
    # Fused plain decode: this many (decode step -> sample) pairs per
    # engine step with one device→host sync (decode_rounds /
    # paged_decode_rounds); 1 = off.
    decode_block: int = 1
    # KV element type: "compute", or "int8" with a per-(row, kv head) f32
    # scale (the dense cache and the paged pool; not the kernel read path).
    kv_dtype: str = "compute"
    # Admission scheduler: "interleaved" spends at most
    # prefill_chunk_budget prefill chunks per step before the decode
    # batch; "sequential" runs a request's whole chunked prefill inline
    # at admission (the stop-the-world baseline). Token streams are
    # identical either way: sampling is keyed per (request id, token
    # index), never per engine step.
    scheduler: str = "interleaved"
    prefill_chunk_budget: int = 1
    # Paged admission lookahead (0 = strict FIFO) and its aging bound.
    admit_lookahead: int = 0
    admit_max_skips: int = 8
    # dp×tp mesh serving (MeshServingEngine): mesh_dp data-parallel
    # replicas behind the affinity router, each tensor-parallel over its
    # own mesh_tp devices; 1×1 = the plain engine. dp*tp must divide the
    # device count. Every request's stream stays a pure function of
    # (seed, prompt, params) across layouts (the router owns the rids).
    mesh_dp: int = 1
    mesh_tp: int = 1
    # Ring-attention engine mode (0 = off, >= 2 = stripes): the page
    # tables widen to ring_stripes x the flat capacity, so admission rises
    # from max_seq - 1 to ring_stripes * max_seq - 1 tokens. The paged
    # functions take their geometry from the table's width, so the math
    # is a flat paged engine's of max_seq = the ring's capacity. Requires
    # kv_layout="paged"; composes with neither speculation nor the kernel.
    ring_stripes: int = 0


def default_engine_config() -> ServeConfig:
    """The small demo model an engine runs when no config is given."""
    return ServeConfig(
        model=ModelConfig(vocab=512, d_model=128, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=256, max_seq=128),
        slots=4, prefill_len=16,
    )


def _place(params, device, dt, name: str = ""):
    """A param tree on ``device`` in the compute dtype ``dt``; a quantized
    weight keeps its int8 codes and f32 scales, and the MoE router stays
    f32 (the reference routes in f32: a bf16 router would route
    otherwise)."""
    if isinstance(params, dict):
        return {k: _place(v, device, dt, k) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_place(v, device, dt) for v in params]
    if isinstance(params, QTensor):
        return params.to_device(device)
    return params.to(device=device,
                     dtype=torch.float32 if name == "router" else dt)


def _rope_at(x: torch.Tensor, positions: torch.Tensor,
             theta: float) -> torch.Tensor:
    """Rotary embedding at explicit positions; x: [B, T, H, D],
    positions: [B, T] (int). Halves (not interleaved), in f32."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions.float()[..., None] * freqs  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _gqa_repeat(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    nkv = kv.shape[-2]
    return kv if nkv == n_heads else torch.repeat_interleave(
        kv, n_heads // nkv, dim=-2)


def decoder_forward(cfg: ServeConfig, params: dict, tokens: torch.Tensor,
                    pos: torch.Tensor, mask: torch.Tensor,
                    kv_update, attend=None) -> torch.Tensor:
    """The ONE transformer body shared by every serving path; the paths
    differ only in how K/V is stored and read back, which ``kv_update``
    abstracts.

    tokens: [B, T] int; pos: [B, T] int global row positions; mask:
    [B, 1, T, S] over the context rows kv_update returns;
    kv_update(li, k, v): write the block's K/V ([B, T, nkv, hd]) into
    layer li's store and return the full context (ck, cv) as
    [B, S, nkv, hd]. Returns final-norm hidden states [B, T, D].

    attend(li, q, k, v), when given, REPLACES kv_update + the in-body
    attention for every layer: it writes the block's K/V and returns the
    attention output [B, T, n_heads, hd] directly (the
    ``paged_attn="kernel"`` and ``"ring"`` paths; ``mask`` is then unused
    — they mask by sequence length — and may be None).

    Over a tensor-parallel mesh ``params`` is the list of shard param
    dicts (``model.shard_params``) and ``kv_update`` / ``attend`` the
    lists of each shard's callables over its own store: shard r runs its
    n_heads/tp query heads, n_kv_heads/tp kv heads and d_ff/tp FFN
    columns (or its block of experts) on its device, and the two
    row-parallel products of each layer are summed by
    ``model.all_reduce_sum``. Returns then the list of every shard's
    hidden states (replicated; ``_logits`` gathers the vocab split).
    """
    m = cfg.model
    dt = m.torch_dtype
    sharded = isinstance(params, list)
    shards = params if sharded else [params]
    updates = kv_update if sharded else [kv_update]
    attends = attend if sharded or attend is None else [attend]
    tp = len(shards)
    nh, nkv, hd = m.n_heads // tp, m.n_kv_heads // tp, m.head_dim
    b, t = tokens.shape
    devs = [sh["embed"].device for sh in shards]
    poss = [pos.to(d) for d in devs]
    masks = [None if mask is None else mask.to(d) for d in devs]
    xs = [sh["embed"].to(dt)[tokens.to(d).long()]  # [B, T, D]
          for sh, d in zip(shards, devs)]
    for li in range(len(shards[0]["layers"])):
        parts = []
        for r, sh in enumerate(shards):
            layer = sh["layers"][li]
            h = _rms_norm(xs[r], layer["attn_norm"])
            q = _rope_at((h @ layer["wq"].to(dt)).reshape(b, t, nh, hd),
                         poss[r], m.rope_theta)
            k = _rope_at((h @ layer["wk"].to(dt)).reshape(b, t, nkv, hd),
                         poss[r], m.rope_theta)
            v = (h @ layer["wv"].to(dt)).reshape(b, t, nkv, hd)
            if attends is not None:
                att = attends[r](li, q, k, v).reshape(b, t, nh * hd)
            else:
                ck, cv = updates[r](li, k, v)
                kr, vr = _gqa_repeat(ck, nh), _gqa_repeat(cv, nh)
                scores = torch.einsum("bqhd,bkhd->bhqk", q, kr).float()
                scores = scores / (hd**0.5)
                scores = torch.where(masks[r], scores, -1e30)
                probs = torch.softmax(scores, dim=-1).to(dt)
                att = torch.einsum(
                    "bhqk,bkhd->bqhd", probs, vr).reshape(b, t, nh * hd)
            parts.append(att @ layer["wo"].to(dt))
        xs = [x + a for x, a in zip(xs, all_reduce_sum(parts))]
        parts = []
        for r, sh in enumerate(shards):
            layer = sh["layers"][li]
            hm = _rms_norm(xs[r], layer["mlp_norm"])
            if "moe" in layer:
                # The MoE family at FULL capacity (no drops): a capacity
                # set by the batch's shape would route the same sequence
                # differently through chunked prefill, step decode, fused
                # blocks and the speculative verify; full capacity makes
                # every mode emit the same tokens. A shard holds a block
                # of the experts; the others' tokens come back as zeros.
                parts.append(_moe_mlp(
                    m, layer["moe"], hm, full_capacity=True,
                    expert_offset=r * (m.n_experts // tp)))
            else:
                gate = F.silu(hm @ layer["w_gate"].to(dt))
                parts.append((gate * (hm @ layer["w_up"].to(dt)))
                             @ layer["w_down"].to(dt))
        xs = [x + a for x, a in zip(xs, all_reduce_sum(parts))]
    out = [_rms_norm(x, sh["final_norm"]) for x, sh in zip(xs, shards)]
    return out if sharded else out[0]


_INV_FREQ: dict = {}


def _rotate_half(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of x [..., D] by halves, in f32, given cos and sin
    [..., D/2] broadcast against x's halves."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _latent_cos_sin(m: LatentModelConfig, pos: torch.Tensor) -> tuple:
    """cos and sin [B, T, 1, rope dims / 2] at positions [B, T] under the
    model's rotary frequencies (YaRN's where it has them) and YaRN's
    factor on both."""
    key = (m, pos.device)
    inv = _INV_FREQ.get(key)
    if inv is None:
        inv = _INV_FREQ[key] = rope_inv_freq(m, pos.device)
    angles = (pos.float()[..., None] * inv)[:, :, None, :]
    scale = rope_cos_sin_scale(m)
    if scale != 1.0:
        return torch.cos(angles) * scale, torch.sin(angles) * scale
    return torch.cos(angles), torch.sin(angles)


def latent_forward(cfg: ServeConfig, params: dict, tokens: torch.Tensor,
                   pos: torch.Tensor, attend,
                   moe_rows: torch.Tensor | None = None) -> torch.Tensor:
    """The latent model's body (DeepSeek-V2: MLA, the routed top-k FFN),
    on one device; returns the final-norm hidden states [B, T, D].

    tokens, pos: [B, T]. Per layer h = RMSNorm(x); q = h·W_q, per head
    [nope ‖ rope]; h·W_kva = [c ‖ k_pe], and the store's row is
    [RMSNorm(c; kv_a_norm) ‖ k_pe] with q's and k_pe's rope parts rotated
    (by halves) at each token's position. ``attend(li, layer, q_nope,
    q_pe, row)`` writes ``row`` [B, T, rank + rope] into layer li's store
    and returns the heads' outputs [B, T, heads, v] (the paged functions:
    expanded over the chunk's pages in prefill, absorbed through the paged
    kernel in decode); W_o takes them back to the residual. The FFN is the
    dense SwiGLU or, from ``first_dense_layers`` on, ``moe.topk_ffn``,
    which adds each expert's rows and calls to ``moe_rows[i]`` [2,
    experts] of the i-th routed layer when given. Spans:
    ``serve.latent_attn`` around ``attend``, ``serve.moe`` around the
    routed FFN."""
    m = cfg.model
    dt = m.torch_dtype
    b, t = tokens.shape
    nh, dn, rank = m.n_heads, m.qk_nope_head_dim, m.kv_lora_rank
    cos, sin = _latent_cos_sin(m, pos)
    topk = topk_config(m)
    x = params["embed"].to(dt)[tokens.long()]
    routed = 0
    for li, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["attn_norm"])
        q = (h @ layer["wq"].to(dt)).view(b, t, nh, -1)
        ckv = h @ layer["wkv_a"].to(dt)
        k_pe = _rotate_half(ckv[:, :, None, rank:], cos, sin)
        row = torch.cat([_rms_norm(ckv[..., :rank], layer["kv_a_norm"]),
                         k_pe[:, :, 0]], dim=-1)
        q_pe = _rotate_half(q[..., dn:], cos, sin)
        with profiler_span("serve.latent_attn"):
            att = attend(li, layer, q[..., :dn], q_pe, row)
        x = x + att.reshape(b, t, -1) @ layer["wo"].to(dt)
        h = _rms_norm(x, layer["mlp_norm"])
        if routed_layer(m, li):
            with profiler_span("serve.moe"):
                y = topk_ffn(topk, layer["experts"], h.view(b * t, -1),
                             counts=None if moe_rows is None
                             else moe_rows[routed])
            routed += 1
            x = x + y.view(b, t, -1)
        else:
            gate = F.silu(h @ layer["w_gate"].to(dt))
            x = x + (gate * (h @ layer["w_up"].to(dt))) @ layer[
                "w_down"].to(dt)
    return _rms_norm(x, params["final_norm"])


def _logits(cfg: ServeConfig, params, x, index=()) -> torch.Tensor:
    """f32 logits of the hidden states ``x[index]``; over a mesh (``x``
    the shards' list) each shard's slice of the vocab, gathered on the
    first shard's device (``model.gather_vocab``)."""
    dt = cfg.model.torch_dtype
    if isinstance(params, list):
        return gather_vocab([h[index] @ sh["lm_head"].to(dt)
                             for h, sh in zip(x, params)]).float()
    return (x[index] @ params["lm_head"].to(dt)).float()


def _per_store(store, make):
    """``make(store)``: the kv_update (or attend) over one KV store; over
    a mesh (``store`` the shards' list) one per shard."""
    return [make(st) for st in store] if isinstance(store, list) else (
        make(store))


def init_cache(cfg: ServeConfig, device, slots: int | None = None,
               kv_heads: int | None = None) -> dict:
    """The dense KV cache ``{"k", "v"}``, each ``[layers, slots, max_seq,
    kv_heads, head_dim]``, zeroed, on ``device``: the compute dtype, or
    (``kv_dtype="int8"``) int8 rows plus f32 scales ``{"ks", "vs"}`` of
    shape ``[layers, slots, max_seq, kv_heads]``. ``slots`` and
    ``kv_heads`` override the config's for one shard of a mesh."""
    m = cfg.model
    shape = (m.n_layers, slots or cfg.slots, m.max_seq,
             kv_heads or m.n_kv_heads, m.head_dim)
    if cfg.kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "ks": torch.zeros(shape[:-1], device=device),
                "vs": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, dtype=m.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=m.torch_dtype, device=device)}


def _kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of each (..., head) row over head_dim,
    in the reference's op order (f32, round half to even), so codes and
    scales equal the reference's bit for bit."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor, dt) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dt)


def prefill(cfg: ServeConfig, params: dict, cache: dict,
            tokens: torch.Tensor, length: int, slot: int,
            start: int = 0) -> torch.Tensor:
    """One padded prompt chunk into cache slot ``slot``, in place.

    tokens: [prefill_len] int32 (padded); length: true tokens in this
    chunk; start: the cache row the chunk begins at. The chunk attends to
    every row of the slot's cache under ``row <= start + i``, so a long
    prompt runs as ceil(n/prefill_len) fixed-shape calls. The write is
    ``lax.dynamic_update_slice``'s: its start clamps to max_seq -
    prefill_len, so a last chunk that would run past the cache lands
    shifted back (the reference's rows, exactly). Returns the f32 logits
    [vocab] at local position length - 1.
    """
    m = cfg.model
    p = cfg.prefill_len
    dev = tokens.device
    pos = start + torch.arange(p, dtype=torch.int32, device=dev)[None]
    row = torch.arange(m.max_seq, dtype=torch.int32, device=dev)
    mask = (row[None, :] <= pos[0][:, None])[None, None]  # [1,1,P,S]
    s0 = min(max(start, 0), m.max_seq - p)

    def make(cache):
        def kv_update(li, k, v):
            if "ks" in cache:  # the int8 layout (init_cache)
                for name, sname, new in (("k", "ks", k), ("v", "vs", v)):
                    qx, sx = _kv_quant(new)
                    cache[name][li, slot, s0:s0 + p] = qx[0]
                    cache[sname][li, slot, s0:s0 + p] = sx[0]
                return tuple(
                    _kv_dequant(cache[name][li, slot],
                                cache[sname][li, slot], new.dtype)[None]
                    for name, sname, new in (("k", "ks", k),
                                             ("v", "vs", v)))
            cache["k"][li, slot, s0:s0 + p] = k[0]
            cache["v"][li, slot, s0:s0 + p] = v[0]
            return cache["k"][li, slot][None], cache["v"][li, slot][None]
        return kv_update

    x = decoder_forward(cfg, params, tokens[None], pos, mask,
                        _per_store(cache, make))
    return _logits(cfg, params, x, (0, length - 1))


def decode_step(cfg: ServeConfig, params: dict, cache: dict,
                last_tokens: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Advance every slot one token over the dense cache (in place):
    last_tokens/positions [B] int32, B == slots; returns the f32 logits
    [B, vocab]. The T == 1 case of ``speculative.decode_block``."""
    return decode_block(cfg, params, cache, last_tokens[:, None],
                        positions)[:, 0]


def decode_rounds(cfg: ServeConfig, params: dict, cache: dict,
                  last_tokens: torch.Tensor, positions: torch.Tensor,
                  base_key: torch.Tensor, rids: torch.Tensor,
                  ctr0: torch.Tensor, temps: torch.Tensor,
                  topks: torch.Tensor, steps: int, decode=None) -> tuple:
    """``steps`` (decode_step -> sample_tokens) pairs over the dense cache
    with no host sync: rids [B] and ctr0 [B] carry each request's (id,
    next token index), the index advancing by one a step, so the block
    emits the per-step stream. Positions clamp at max_seq - 1. ``decode``
    (params, cache, last, positions) -> logits replaces decode_step (the
    mesh's data-parallel step). Returns (last tokens, positions, tokens
    [B, steps] in emission order)."""
    decode = decode or partial(decode_step, cfg)
    out = []
    last, pos, ctr = last_tokens, positions, ctr0
    for _ in range(steps):
        logits = decode(params, cache, last, pos)
        last = sample_tokens(logits, base_key, rids, ctr, temps, topks)
        pos = torch.clamp(pos + 1, max=cfg.model.max_seq - 1)
        ctr = ctr + 1
        out.append(last)
    return last, pos, torch.stack(out, dim=1)


def sample_tokens(logits: torch.Tensor, base_key: torch.Tensor,
                  rids: torch.Tensor, ctrs: torch.Tensor,
                  temps: torch.Tensor, topk: torch.Tensor) -> torch.Tensor:
    """Per-slot token selection for the batch, on the logits' device, with
    no host sync: the reference's ``sample_tokens`` draw for draw.

    logits [B, V] f32; rids [B] request ids; ctrs [B] per-request token
    indices; temps [B] (<= 0: greedy argmax); topk [B] (0: the whole
    vocab). Each row keeps the logits at or above its k-th largest,
    divides them by max(temp, 1e-6) and draws ``categorical`` under the
    key fold_in(fold_in(base_key, rid), ctr): JAX's threefry and Gumbel
    bits (``ops.threefry``: on the card, two key launches and one
    categorical launch), so a request's stream is a pure function of
    (seed, prompt, params), whatever the schedule, the slot or
    ``decode_block``. Returns int32 [B].
    """
    v = logits.shape[-1]
    logits = logits.float()
    keys = threefry.fold_in(threefry.fold_in(base_key, rids), ctrs)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_idx = (torch.where(topk > 0, topk, v) - 1).clamp(0, v - 1).long()
    thresh = sorted_desc.gather(-1, k_idx[:, None])
    masked = torch.where(logits >= thresh, logits, -1e30)
    scaled = masked / temps.float().clamp_min(1e-6)[:, None]
    sampled = threefry.categorical(keys, scaled)
    return torch.where(temps > 0, sampled, torch.argmax(logits, dim=-1)
                       ).to(torch.int32)


# ---------------------------------------------------------------------------
# Sharded serving: tensor-parallel dense decode over a mesh
# ---------------------------------------------------------------------------


def make_sharded_serving(cfg: ServeConfig, mesh, params: dict):
    """Prefill, decode and fused block decode tensor-parallel over mesh
    axis "model", data-parallel over "data", on the dense cache.

    The reference's Megatron split (``model.PARAM_SPECS``): each device
    holds its block of kv heads, attention is local per head, the
    row-parallel products meet in ``model.all_reduce_sum``, and the
    vocab-split logits in ``model.gather_vocab``. The cache splits on its
    kv-head axis over "model" (each shard's appends are device-local) and
    on its slot axis over "data": the slots of data row d decode on that
    row's shards. Logits come back replicated on the mesh's first device
    for sampling. Requires ``n_kv_heads % tp == 0`` and ``slots % dp ==
    0``. Returns (prefill_fn, decode_fn, placed params — one dict per
    device —, placed cache — one dict per device —, rounds_fn)."""
    tp = mesh.shape["model"]
    dp = mesh.shape.get("data", 1)
    if cfg.model.n_kv_heads % tp:
        raise ValueError(f"n_kv_heads={cfg.model.n_kv_heads} not "
                         f"divisible by tp={tp}")
    _check_moe_tp(cfg.model, mesh)
    if cfg.slots % dp:
        raise ValueError(f"slots={cfg.slots} not divisible by dp={dp}")
    per = cfg.slots // dp
    devs = mesh.device_list
    placed = shard_params(mesh, params, cfg.model.torch_dtype)
    placed_cache = [init_cache(cfg, d, slots=per,
                               kv_heads=cfg.model.n_kv_heads // tp)
                    for d in devs]

    def row(d):  # data row d's shards, in "model" order
        return slice(d * tp, (d + 1) * tp)

    def prefill_fn(cache, tokens, length, slot, start=0):
        d, local = divmod(slot, per)
        return prefill(cfg, placed[row(d)], cache[row(d)], tokens, length,
                       local, start).to(devs[0])

    def decode_fn(cache, last_tokens, positions):
        return torch.cat([
            decode_step(cfg, placed[row(d)], cache[row(d)],
                        last_tokens[d * per:(d + 1) * per],
                        positions[d * per:(d + 1) * per]).to(devs[0])
            for d in range(dp)])

    def rounds_fn(cache, last_tokens, positions, base_key, rids, ctr0,
                  temps, topks, steps):
        return decode_rounds(
            cfg, placed, cache, last_tokens, positions, base_key, rids,
            ctr0, temps, topks, steps,
            decode=lambda _p, c, last, pos: decode_fn(c, last, pos))

    return prefill_fn, decode_fn, placed, placed_cache, rounds_fn


# ---------------------------------------------------------------------------
# Host-side engine
# ---------------------------------------------------------------------------


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    enqueued: float
    temperature: float = 0.0  # 0 = greedy (deterministic)
    top_k: int = 0  # 0 = full vocab
    # Multi-tenant attribution: per-tenant latency/goodput accounting
    # ("" = untagged, excluded from per-tenant metrics).
    tenant: str = ""
    # Terminal status, set exactly once when the request leaves the
    # engine: "completed" | "rejected" | "cancelled" | "shed" ("" in
    # flight). "shed" is the actuation layer's admission shed, never
    # counted as a rejection.
    status: str = ""
    # Placement domain (engine.slices, round-robin at slot assignment);
    # None untracked.
    slice: str | None = None
    # Times a slice drain aborted this request mid-flight and re-admitted
    # it, and the stream tokens delivered before the latest requeue: the
    # re-run regenerates the same prefix (keyed sampling), which must not
    # reach the stream twice.
    requeues: int = 0
    _replay_n: int = 0
    ttft_s: float | None = None
    first_tok_t: float | None = None  # monotonic at first emit (TPOT)
    # TTFT less the engine steps that ran this request's prefill chunks
    # (the last one up to the first token): the wait for a slot, pages
    # or a chunk turn. Set with ttft_s; _service_s sums those steps.
    queue_wait_s: float | None = None
    _service_s: float = 0.0
    output: list[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    # Streaming: tokens are pushed here as they are emitted (None = end
    # of stream). Created by submit(stream=True).
    stream: "object | None" = None
    # Generation ends early when an emitted token is in stop_tokens
    # (the EOS contract; the stop token is included in output).
    stop_tokens: tuple = ()
    cancelled: threading.Event = field(default_factory=threading.Event)

    def cancel(self) -> None:
        """Ask the engine to drop this request at its next step — frees
        the slot and its KV pages."""
        self.cancelled.set()

    def emit(self, tokens: list[int]) -> None:
        for t in tokens:
            self.output.append(t)
            if self.stream is not None and len(self.output) > self._replay_n:
                self.stream.put(t)

    def hit_stop(self) -> bool:
        return bool(self.stop_tokens) and bool(self.output) and (
            self.output[-1] in self.stop_tokens)

    def finish_stream(self) -> None:
        if self.stream is not None:
            self.stream.put(None)


@dataclass
class _TenantStats:
    """Per-tenant serving accounting (guarded by the engine lock);
    latency samples carry their observation time so the quantile gauges
    cover a recency window."""

    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    cancelled: int = 0
    shed: int = 0  # admission sheds (set_shed), never rejections
    tokens: int = 0
    ttft: deque = field(default_factory=lambda: deque(maxlen=512))
    tpot: deque = field(default_factory=lambda: deque(maxlen=512))


@dataclass
class _PrefillWork:
    """Per-slot chunked-prefill progress: which target chunk runs next,
    how far the draft model's own prefill got, the slot's page
    reservation and table (paged), and the final chunk's logits. A slot
    holding one is occupied but not yet decoding."""

    req: Request
    n: int                      # prompt length (tokens)
    next_c0: int                # next target chunk's start row
    draft_c0: int = 0           # next draft chunk's start row (spec)
    logits: torch.Tensor | None = None   # final-chunk logits
    pages: list[int] | None = None       # paged: full reservation
    shared_n: int = 0           # paged: chunks served from shared pages
    table_row: torch.Tensor | None = None  # paged: this slot's table


class ServingEngine:
    """Continuous-batching engine over the dense KV cache or the paged KV
    pool: submit() from any thread, step() (or the arrival loop) drives
    prefill/decode; /metrics-ready exposition from metrics_text().

    ``mesh`` (a ``model.Mesh``) makes the whole loop tensor-parallel over
    its "model" axis: ``params`` then holds one shard dict per device,
    the dense cache splits on its kv-head axis over "model" and on slots
    over "data" (``make_sharded_serving``), the paged pool on its kv-head
    axis (a tp-only mesh). The engine's own state (positions, sampling
    settings, logits) lives on the mesh's first device."""

    def __init__(self, cfg: ServeConfig | None = None,
                 params: dict | None = None, seed: int = 0,
                 max_queue: int = 64, ckpt_dir: str | None = None,
                 quantize: str | None = None, device=None, mesh=None):
        if cfg is None and ckpt_dir:
            # No explicit config: adopt the checkpoint's own architecture,
            # so the engine serves the trained weights instead of falling
            # back to a mismatched default init.
            saved = saved_model_config(ckpt_dir)
            if saved is not None:
                cfg = ServeConfig(model=saved, slots=4,
                                  prefill_len=min(16, saved.max_seq // 2))
        self.cfg = cfg or default_engine_config()
        if quantize is not None:
            self.cfg = dc_replace(self.cfg, quantize=quantize)
        self._validate(mesh)
        self.mesh = mesh
        self.device = resolve_device(
            device if mesh is None else mesh.device_list[0])
        m = self.cfg.model
        dev = self.device
        # The admission and position ceiling: ring engines stripe
        # ring_stripes x max_seq rows, so every completion check, position
        # clamp and submit()'s refusal read _seq_cap; the paged functions
        # take all geometry from the (widened) tables' width.
        self._seq_cap = max(1, self.cfg.ring_stripes or 1) * m.max_seq
        self.ckpt_step: int | None = None
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = init_params(m, gen)
            if ckpt_dir:
                # Serve trained weights: resume from the trainer's
                # checkpoint (tpumon_torch.loadgen.train) when the
                # architecture matches; otherwise keep the fresh init
                # (best-effort, like the reference), and say so.
                restored = restore_checkpoint(ckpt_dir, like=params, cfg=m)
                if restored is not None:
                    params, self.ckpt_step = restored
                else:
                    print(f"serving: no compatible checkpoint in "
                          f"{ckpt_dir!r}; serving FRESH INIT weights",
                          file=sys.stderr)
        if self.cfg.quantize == "int8":
            # Quantize after any checkpoint restore and before the cast
            # below: the codes are the reference's from the same f32
            # weights.
            params = quantize_params(params)
        elif self.cfg.quantize is not None:
            raise ValueError(f"unknown quantize mode {self.cfg.quantize!r}")

        # Weights are cast to the compute dtype once, here — the same
        # values the reference's per-call ``.astype(dt)`` produces — so
        # the weight_bytes gauge reports what is actually resident. Over a
        # mesh each device gets its own shard (model.shard_params).
        self.paged = self.cfg.kv_layout == "paged"
        self.cache = None
        self._prefill = partial(prefill, self.cfg)
        self._decode = partial(decode_step, self.cfg)
        self._decode_rounds = partial(decode_rounds, self.cfg)
        if mesh is None:
            self.params = _place(params, dev, m.torch_dtype)
        elif self.paged:
            self.params = shard_params(mesh, params, m.torch_dtype)
        else:
            pre_fn, dec_fn, self.params, self.cache, rounds_fn = (
                make_sharded_serving(self.cfg, mesh, params))
            # The engine's call signatures, the params argument ignored
            # (the shards are placed).
            self._prefill = (lambda _p, cache, toks, ln, slot, start:
                             pre_fn(cache, toks, ln, slot, start))
            self._decode = (lambda _p, cache, last, positions:
                            dec_fn(cache, last, positions))
            self._decode_rounds = (
                lambda _p, cache, *args, steps: rounds_fn(
                    cache, *args, steps))
        self.spec_len = self.cfg.spec_len
        self.draft_params = None
        self._draft_pos = [0] * self.cfg.slots
        if self.spec_len and self.cfg.spec_source == "draft":
            self._init_draft(seed)
        self.spec_rounds_total = 0
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.prefix_cache = None
        if self.paged:
            p = self.cfg.prefill_len
            # Ring mode widens each slot's table to the ring's capacity.
            self._max_pages = -(-self._seq_cap // p)
            pool_pages = self.cfg.pool_pages or (
                self.cfg.slots * self._max_pages + 1)
            if pool_pages < 2:
                raise ValueError("pool_pages must be >= 2")
            if mesh is None:
                self.pool = init_pool(self.cfg, pool_pages, dev)
            else:  # one pool per shard, its kv heads on its device
                nkv = m.n_kv_heads // mesh.shape["model"]
                self.pool = [init_pool(self.cfg, pool_pages, d, kv_heads=nkv)
                             for d in mesh.device_list]
            self.allocator = PageAllocator(pool_pages)
            # Page 0 is the permanent trash page: freed and mid-prefill
            # slots' tables point at it so their garbage batched-decode
            # writes can never corrupt pages reallocated to live requests.
            trash = self.allocator.alloc(1)
            assert trash == [0]
            if self.cfg.prefix_cache_entries:
                # Page == prefill chunk, so a cached prefix is shared by
                # pointing new requests' tables at its pages: no copy.
                self.prefix_cache = PagePrefixCache(
                    chunk=p, allocator=self.allocator,
                    max_entries=self.cfg.prefix_cache_entries)
                self.prefix_cache.page_bytes = sum(
                    leaf_bytes(t) for t in self.pool.values()) // pool_pages
            self._slot_pages: list[list[int]] = [
                [] for _ in range(self.cfg.slots)]
            self._tables_host = [
                [0] * self._max_pages for _ in range(self.cfg.slots)]
            self._tables_dev = torch.zeros(
                (self.cfg.slots, self._max_pages), dtype=torch.int32,
                device=dev)
            self._tables_dirty = False
        else:
            if mesh is None:
                self.cache = init_cache(self.cfg, dev)
            if self.cfg.prefix_cache_entries:
                self.prefix_cache = PrefixCache(
                    chunk=self.cfg.prefill_len,
                    max_entries=self.cfg.prefix_cache_entries)
        slots = self.cfg.slots
        self.positions = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._host_positions = [0] * slots  # mirror, avoids syncs
        self.last_tokens = torch.zeros((slots,), dtype=torch.int32,
                                       device=dev)
        self._host_last = [0] * slots  # mirror of last_tokens
        # Per-slot sampling state on the device (set at admission): the
        # settings, and the request id and next token index that key each
        # draw with _sample_key (sample_tokens), never the engine step.
        self.temps = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self.topks = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.rids = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.tok_ctrs = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._sample_key = prng.torch_key(seed ^ 0x7A11, dev)
        self._slots: list[Request | None] = [None] * self.cfg.slots
        self._prefill_work: list[_PrefillWork | None] = (
            [None] * self.cfg.slots)
        self._prefill_rr = 0  # round-robin cursor over in-prefill slots
        # Lookahead aging (guarded by _lock).
        self._head_skips = 0
        self._head_rid = -1
        self._queue: deque[Request] = deque()
        self.max_queue = max_queue
        self._rid = itertools.count()
        self._lock = threading.Lock()
        # metrics state (guarded by _lock)
        self.tokens_total = 0
        self.requests_total = 0
        self.rejected_total = 0
        self.cancelled_total = 0
        self.completed_total = 0
        self.decode_steps_total = 0
        # Rows the attention reads, from the host values that size each
        # call: every prefill chunk's gathered rows and the rows below its
        # end; every decode call's rows over all batch rows and over the
        # active slots alone (parked and free slots read for nothing).
        self.prefill_rows_gathered = 0
        self.prefill_rows_needed = 0
        self.decode_rows_read = 0
        self.decode_rows_live = 0
        # The routed FFN's (token, expert) pairs (rows computed x top k,
        # summed over the routed layers) and, on the device, each routed
        # layer's rows per expert and the calls that reached each expert
        # ([routed layers, 2, experts], moe.topk_ffn's counts), added to
        # in the step and read by no step.
        self.moe_pairs_routed = 0
        self.moe_rows = None
        if m.routed_experts:
            self.moe_rows = torch.zeros(
                (sum(routed_layer(m, li) for li in range(m.n_layers)), 2,
                 m.routed_experts), dtype=torch.int64, device=dev)
        # This step's start, and the requests one of whose prefill chunks
        # ran in it (id -> Request): Request.queue_wait_s's accounting.
        self._step_t0 = time.monotonic()
        self._chunked: dict[int, Request] = {}
        self._ttft_counts = [0] * len(TTFT_BUCKETS_S)
        self._ttft_inf = 0
        self._ttft_sum = 0.0
        self._ttft_recent: deque[float] = deque(maxlen=512)
        self._tpot_recent: deque[float] = deque(maxlen=512)
        self.tenants: dict[str, _TenantStats] = {}
        self.tenant_window_s = 60.0
        # Actuation surface (guarded by _lock): per-tenant shed fractions
        # ("*" = every tenant without its own) and their deterministic
        # pacing accumulators; placement domains (set_slices), attributed
        # round-robin at slot assignment, and the drained ones.
        self._shed: dict[str, float] = {}
        self._shed_acc: dict[str, float] = {}
        self.shed_total = 0
        self.requeued_total = 0
        self.slices: tuple[str, ...] = ()
        self._slice_rr = 0
        self._drained: set[str] = set()
        # Optional report.WorkloadReporter: when attached, step() time
        # counts as declared device activity (source: workload in the
        # monitor's counter chain).
        self.reporter = None

    def _validate(self, mesh) -> None:
        """The reference's composition rules and messages, checked before
        any device work."""
        cfg = self.cfg
        if cfg.kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {cfg.kv_layout!r}")
        if cfg.spec_len < 0:
            raise ValueError(f"spec_len must be >= 0, got {cfg.spec_len}")
        if cfg.spec_source not in ("draft", "prompt"):
            raise ValueError(f"unknown spec_source {cfg.spec_source!r}")
        if cfg.spec_source == "prompt" and cfg.draft_model:
            raise ValueError(
                "spec_source='prompt' proposes from the request context "
                "— a draft_model has no role (drop one of the two)")
        if cfg.pool_pages and cfg.kv_layout != "paged":
            raise ValueError(
                "pool_pages requires kv_layout='paged' (a dense cache "
                "has no page pool to size)")
        if cfg.model.kv_lora_rank:
            self._validate_latent(mesh)
        if mesh is not None:
            self._validate_mesh(mesh)
        if cfg.model.n_experts and cfg.prefill_len > cfg.moe_prefill_max_chunk:
            raise ValueError(
                f"MoE serving at prefill_len={cfg.prefill_len} would "
                f"materialize O(G²·E) routing tensors per chunk "
                f"(full-capacity routing, ServeConfig.moe_prefill_max_chunk "
                f"doc): cap is {cfg.moe_prefill_max_chunk} tokens — "
                "lower prefill_len (long prompts run as multiple chunks) "
                "or raise moe_prefill_max_chunk knowingly")
        if cfg.decode_block < 1:
            raise ValueError(
                f"decode_block must be >= 1, got {cfg.decode_block}")
        if cfg.scheduler not in ("interleaved", "sequential"):
            raise ValueError(f"unknown scheduler {cfg.scheduler!r}")
        if cfg.prefill_chunk_budget < 1:
            raise ValueError(
                f"prefill_chunk_budget must be >= 1, got "
                f"{cfg.prefill_chunk_budget}")
        if cfg.admit_lookahead < 0:
            raise ValueError(
                f"admit_lookahead must be >= 0, got {cfg.admit_lookahead}")
        if cfg.admit_lookahead and cfg.kv_layout != "paged":
            raise ValueError(
                "admit_lookahead requires kv_layout='paged' (dense "
                "admission never blocks on pages, so the lookahead "
                "window would silently do nothing)")
        if cfg.admit_max_skips < 1:
            raise ValueError(
                f"admit_max_skips must be >= 1, got {cfg.admit_max_skips}")
        if cfg.kv_dtype not in ("compute", "int8"):
            raise ValueError(f"unknown kv_dtype {cfg.kv_dtype!r}")
        if cfg.paged_attn not in ("gather", "kernel", "ring"):
            raise ValueError(f"unknown paged_attn {cfg.paged_attn!r}")
        if cfg.paged_attn == "kernel" and (
                cfg.kv_layout != "paged" or cfg.kv_dtype == "int8"):
            raise ValueError(
                "paged_attn='kernel' requires kv_layout='paged' with "
                "kv_dtype='compute' (the kernel reads bf16/f32 pages, "
                "not the int8 pool)")
        if cfg.paged_attn == "ring" and (
                cfg.kv_layout != "paged" or cfg.kv_dtype == "int8"):
            raise ValueError(
                "paged_attn='ring' requires kv_layout='paged' with "
                "kv_dtype='compute' (the blockwise ring accumulator "
                "streams compute-dtype pages, not the int8 pool)")
        if cfg.mesh_dp < 1 or cfg.mesh_tp < 1:
            raise ValueError(
                f"mesh_dp/mesh_tp must be >= 1, got "
                f"{cfg.mesh_dp}x{cfg.mesh_tp}")
        if cfg.mesh_dp * cfg.mesh_tp > 1:
            raise ValueError(
                "ServeConfig.mesh_dp/mesh_tp describe a dp×tp mesh "
                "engine — construct a MeshServingEngine (or pass "
                "--loadgen-mesh dp,tp), not a plain ServingEngine")
        if cfg.ring_stripes:
            if cfg.ring_stripes < 2:
                raise ValueError(
                    f"ring_stripes must be 0 (off) or >= 2, got "
                    f"{cfg.ring_stripes} (one stripe IS the flat layout)")
            if cfg.kv_layout != "paged":
                raise ValueError(
                    "ring_stripes requires kv_layout='paged' (ring mode "
                    "pages KV block-wise around the tp ring — a dense "
                    "cache has no pages to stripe)")
            if cfg.spec_len:
                raise ValueError(
                    "ring_stripes does not compose with speculative "
                    "decoding (the draft cache is one stripe wide; a "
                    "ring-admitted context would overrun it)")
            if cfg.paged_attn == "kernel":
                raise ValueError(
                    "ring_stripes does not compose with "
                    "paged_attn='kernel' (the kernel's geometry is pinned "
                    "to one device's stripe); use the gather or ring "
                    "read path")
        if cfg.kv_dtype == "int8" and (
                mesh is not None
                or ((cfg.spec_len or cfg.prefix_cache_entries)
                    and cfg.kv_layout != "paged")):
            raise ValueError(
                "kv_dtype='int8' composes with the dense engine (with "
                "decode_block and int8 weights) and the full paged "
                "engine (incl. prefix caching and speculative "
                "decoding) — not with a mesh, or with the DENSE "
                "layout's speculative/prefix cache surgery")

    def _validate_latent(self, mesh) -> None:
        """A latent model (DeepSeek-V2) is served by one device's paged
        engine, a step at a time, its decode read by ``paged_attention``
        (``paged_attn="kernel"``; its plain version off the card)."""
        cfg = self.cfg
        bad = [what for what, on in (
            (f"kv_layout={cfg.kv_layout!r}", cfg.kv_layout != "paged"),
            (f"paged_attn={cfg.paged_attn!r}", cfg.paged_attn != "kernel"),
            ("ring_stripes", bool(cfg.ring_stripes)),
            ("speculative decoding", bool(cfg.spec_len)),
            ("decode_block > 1", cfg.decode_block > 1),
            ("prefix caching", bool(cfg.prefix_cache_entries)),
            ("kv_dtype='int8'", cfg.kv_dtype == "int8"),
            (f"quantize={cfg.quantize!r}", cfg.quantize is not None),
            ("a mesh", mesh is not None)) if on]
        if bad:
            raise ValueError(
                "latent attention and the routed top-k FFN (DeepSeek-V2) "
                "are served on one device's paged layout with "
                "paged_attn='kernel', a step at a time: not with "
                + ", ".join(bad))

    def _validate_mesh(self, mesh) -> None:
        """The reference's rules for a tensor-parallel engine."""
        cfg = self.cfg
        if cfg.prefix_cache_entries:
            raise ValueError(
                "a tensor-parallel mesh does not compose with prefix "
                "caching (host-side cache surgery on sharded buffers)")
        if cfg.spec_len and cfg.kv_layout != "paged":
            raise ValueError(
                "over a mesh, speculative decoding composes with the "
                "PAGED layout; dense-layout spec is single-device only")
        if cfg.paged_attn == "kernel":
            raise ValueError(
                "paged_attn='kernel' is single-device (the kernel reads "
                "one device's whole pool); use the gather path over a "
                "mesh")
        tp = mesh.shape["model"]
        dp = mesh.shape.get("data", 1)
        if cfg.kv_layout == "paged" and dp != 1:
            raise ValueError(
                "paged serving over a mesh is tensor-parallel only "
                f"(axis 'model'); got data={dp} — slots batch via "
                "continuous batching, not a data axis")
        if cfg.model.n_kv_heads % tp:
            raise ValueError(
                f"n_kv_heads={cfg.model.n_kv_heads} not divisible by "
                f"tp={tp}")
        _check_moe_tp(cfg.model, mesh)

    def _init_draft(self, seed: int) -> None:
        """The draft model of ``spec_source="draft"``: the target itself
        (self-speculation), a layer-truncated draft sharing the target's
        bottom layers, embedding and head, or a distinct model drawn from
        ``seed + 1``, with its own dense cache."""
        m = self.cfg.model
        dm = self.cfg.draft_model or m
        if dm.vocab != m.vocab or dm.max_seq != m.max_seq:
            raise ValueError(
                "draft_model must share vocab and max_seq with the "
                f"target (draft {dm.vocab}/{dm.max_seq} vs "
                f"target {m.vocab}/{m.max_seq})")
        if self.cfg.draft_model is not None and dm.n_layers >= m.n_layers:
            raise ValueError(
                f"draft_model must be shallower than the target "
                f"({dm.n_layers} >= {m.n_layers} layers; use "
                "draft_model=None for self-speculation)")
        self._draft_scfg = ServeConfig(model=dm, slots=self.cfg.slots,
                                       prefill_len=self.cfg.prefill_len)
        mesh = self.mesh
        if self.cfg.draft_model is None:
            self.draft_params = self.params  # self-speculation
        elif dm == dc_replace(m, n_layers=dm.n_layers):
            # The target's bottom layers, embedding and head, re-sliced
            # from the placed target (each shard's, over a mesh): aliases,
            # no second copy.
            self.draft_params = _per_store(self.params, lambda sh: {
                "embed": sh["embed"],
                "layers": sh["layers"][:dm.n_layers],
                "final_norm": sh["final_norm"],
                "lm_head": sh["lm_head"],
            })
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed + 1)
            drawn = init_params(dm, gen)
            self.draft_params = (
                _place(drawn, self.device, dm.torch_dtype) if mesh is None
                else shard_params(mesh, drawn, dm.torch_dtype))
        if mesh is None:
            self.draft_cache = init_cache(self._draft_scfg, self.device)
        else:  # the draft's dense cache splits on its kv-head axis
            nkv = dm.n_kv_heads // mesh.shape["model"]
            self.draft_cache = [
                init_cache(self._draft_scfg, d, kv_heads=nkv)
                for d in mesh.device_list]

    def _h2d(self, values: list) -> torch.Tensor:
        """int32 host list (or list of lists) -> device tensor without a
        stream sync (the source is staged at once; the copy stays
        stream-ordered)."""
        return torch.tensor(values, dtype=torch.int32).to(
            self.device, non_blocking=True)

    # -- submission ---------------------------------------------------------

    def _tenant_locked(self, req: Request) -> "_TenantStats | None":
        """The request's tenant stats record (caller holds the lock);
        None for untagged requests."""
        if not req.tenant:
            return None
        st = self.tenants.get(req.tenant)
        if st is None:
            st = self.tenants[req.tenant] = _TenantStats()
        return st

    def submit(self, prompt: list[int], max_new: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               stream: bool = False,
               stop_tokens: tuple = (), tenant: str = "",
               rid: int | None = None) -> Request:
        """Enqueue a request. A tenant under a shed fraction (set_shed)
        has that share of its submissions shed (status="shed"). When the
        queue is full, or the prompt is over the sequence capacity
        (max_seq-1 rows), or (paged) its page reservation could never fit
        the pool, the request is rejected immediately (status="rejected",
        done set, output empty). temperature 0 = greedy; top_k 0 = the
        whole vocab."""
        m = self.cfg.model
        max_new = max(0, int(max_new))
        prompt = [t % m.vocab for t in prompt]
        over_cap = len(prompt) > self._seq_cap - 1
        req = Request(rid=rid if rid is not None else next(self._rid),
                      prompt=prompt or [0],
                      max_new=max_new, enqueued=time.monotonic(),
                      temperature=float(temperature), top_k=int(top_k),
                      stream=queue.Queue() if stream else None,
                      stop_tokens=tuple(int(t) for t in stop_tokens),
                      tenant=str(tenant))
        infeasible = over_cap or (self.paged and self._pages_needed(
            req) > self.allocator.num_pages - 1)
        with self._lock:
            # Cancelled entries must not consume queue capacity.
            self._purge_cancelled_locked()
            tst = self._tenant_locked(req)
            if tst is not None:
                tst.submitted += 1
            # The shed pacing: the fraction accumulates per tenant and
            # sheds on overflow, so fraction f sheds exactly round(n*f) of
            # n submissions, with no RNG.
            frac = (self._shed[req.tenant] if req.tenant in self._shed
                    else self._shed.get("*", 0.0))
            if frac > 0.0:
                acc = self._shed_acc.get(req.tenant, 0.0) + frac
                if acc >= 1.0:
                    self._shed_acc[req.tenant] = acc - 1.0
                    self.shed_total += 1
                    if tst is not None:
                        tst.shed += 1
                    req.status = "shed"
                    req.finish_stream()
                    req.done.set()
                    return req
                self._shed_acc[req.tenant] = acc
            if len(self._queue) >= self.max_queue or infeasible:
                self.rejected_total += 1
                if tst is not None:
                    tst.rejected += 1
                req.status = "rejected"
                req.finish_stream()
                req.done.set()
                return req
            self._queue.append(req)
            self.requests_total += 1
        return req

    # -- actuation surface (the verbs tpumon.actuate drives) ----------------

    def set_shed(self, tenant: str, fraction: float) -> float:
        """Set the admission-shed fraction for ``tenant`` ("*" = every
        tenant without its own entry); <= 0 removes the throttle. Clamped
        to SHED_CAP. Returns the effective fraction."""
        frac = min(float(fraction), SHED_CAP)
        with self._lock:
            if frac <= 0.0:
                self._shed.pop(tenant, None)
                if tenant == "*":
                    # "*"-paced tenants accumulate under their own names:
                    # drop every accumulator no tenant throttle owns, so
                    # the next episode starts afresh.
                    for t in [t for t in self._shed_acc
                              if t not in self._shed]:
                        self._shed_acc.pop(t, None)
                else:
                    self._shed_acc.pop(tenant, None)
                return 0.0
            self._shed[tenant] = frac
            return frac

    def shed_fractions(self) -> dict[str, float]:
        with self._lock:
            return dict(self._shed)

    def nudge_capacity(self, prefill_budget: int | None = None,
                       admit_lookahead: int | None = None) -> dict:
        """Adjust the scheduler knobs live: prefill chunks per step and
        (paged engines only) the admission lookahead; both are read afresh
        each step. Returns the effective values."""
        kw = {}
        if prefill_budget is not None:
            kw["prefill_chunk_budget"] = max(1, int(prefill_budget))
        if admit_lookahead is not None and self.paged:
            kw["admit_lookahead"] = max(0, int(admit_lookahead))
        if kw:
            self.cfg = dc_replace(self.cfg, **kw)
        return {"prefill_budget": self.cfg.prefill_chunk_budget,
                "admit_lookahead": self.cfg.admit_lookahead}

    def set_slices(self, names) -> None:
        """Declare the placement domains requests are attributed to
        (round-robin at slot assignment); drain marks of domains that no
        longer exist are dropped."""
        with self._lock:
            self.slices = tuple(str(n) for n in names)
            self._slice_rr = 0
            self._drained &= set(self.slices)

    def drain_slice(self, name: str) -> None:
        """Mark a placement domain drained: its in-flight requests abort
        and requeue at the next step, and new placements avoid it until
        ``undrain_slice``."""
        with self._lock:
            self._drained.add(str(name))

    def undrain_slice(self, name: str) -> None:
        with self._lock:
            self._drained.discard(str(name))

    def drained_slices(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._drained))

    def _requeue_slot(self, slot: int) -> None:
        """Abort the slot's request mid-flight, free the slot (and its
        pages) and re-admit the request at the queue HEAD. The re-run
        regenerates the same tokens (sampling is keyed per (rid, token
        index)); ``_replay_n`` keeps delivered stream tokens from reaching
        the consumer twice."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._prefill_work[slot] = None
        self._release_slot_pages(slot)
        req.slice = None
        req.requeues += 1
        req._replay_n = max(req._replay_n, len(req.output))
        req.output = []
        with self._lock:
            self.requeued_total += 1
            self._queue.appendleft(req)

    def load(self) -> int:
        """Queued + in-flight request count."""
        with self._lock:
            qd = len(self._queue)
        return qd + sum(1 for s in self._slots if s is not None)

    def prefix_hit_len(self, prompt: list[int]) -> int:
        """Longest cached chunk-aligned prefix (tokens) this engine holds
        for ``prompt``, with no side effect; 0 with no prefix cache."""
        if self.prefix_cache is None:
            return 0
        got = self.prefix_cache.peek(prompt)
        return int(got[0] if isinstance(got, tuple) else got)

    def adopt(self, req: Request) -> None:
        """Take an existing Request at the queue head without minting a
        new rid, so its re-run replays the same stream; no counter is
        charged (the original submit was)."""
        with self._lock:
            self._queue.appendleft(req)

    def evict_all(self) -> "list[Request]":
        """Abort-and-requeue every in-flight slot (``_requeue_slot``'s
        replay contract) and hand back the whole queue, leaving the engine
        empty."""
        for slot in range(self.cfg.slots):
            if self._slots[slot] is not None:
                self._requeue_slot(slot)
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
        return out

    # -- engine loop --------------------------------------------------------

    def _observe_ttft(self, dt_s: float) -> None:
        for i, bound in enumerate(TTFT_BUCKETS_S):
            if dt_s <= bound:
                self._ttft_counts[i] += 1
                break
        else:
            self._ttft_inf += 1
        self._ttft_sum += dt_s
        self._ttft_recent.append(dt_s)

    def _pages_needed(self, req: Request) -> int:
        """Worst-case page reservation: KV rows 0..prompt+max_new-1,
        capped by the max_seq-1 position clamp."""
        rows = len(req.prompt) + req.max_new
        return max(1, min(-(-rows // self.cfg.prefill_len),
                          self._max_pages))

    def _purge_cancelled_locked(self) -> None:
        """Drop cancelled requests anywhere in the queue (caller holds
        the lock), counted as cancellations."""
        if not any(r.cancelled.is_set() for r in self._queue):
            return
        kept: deque[Request] = deque()
        for r in self._queue:
            if r.cancelled.is_set():
                self.cancelled_total += 1
                tst = self._tenant_locked(r)
                if tst is not None:
                    tst.cancelled += 1
                r.status = "cancelled"
                r.finish_stream()
                r.done.set()
            else:
                kept.append(r)
        self._queue = kept

    def _sync_tables(self) -> None:
        """Upload the host page tables when admission changed them."""
        if self._tables_dirty:
            with profiler_span("serve.admit"):
                self._tables_dev = self._h2d(self._tables_host)
            self._tables_dirty = False

    def _reserve_next_locked(self) -> tuple[Request, list, int] | None:
        """Pick the next admissible queued request (caller holds the
        lock; paged only): probe the head, then — bounded lookahead — up to
        ``admit_lookahead`` requests behind it, admitting the first whose
        page reservation succeeds. Probes use the prefix cache's
        side-effect-free ``peek``; ``lookup`` (retain, hit/miss, LRU) runs
        only for the request admitted. The head alone may evict cache
        entries under pool pressure, never its own peeked prefix. Every
        queue-jump past a blocked head bumps ``_head_skips``; at
        ``admit_max_skips`` the window collapses to the head alone until
        it admits. Returns (request, pages, shared chunks) or None."""
        if self._queue[0].rid != self._head_rid:
            self._head_rid = self._queue[0].rid
            self._head_skips = 0
        aged_out = self._head_skips >= self.cfg.admit_max_skips
        window = 1 if aged_out else 1 + self.cfg.admit_lookahead
        for i, cand in enumerate(self._queue):
            if i >= window:
                break
            shared: list[int] = []
            if self.prefix_cache is not None:
                _, shared = self.prefix_cache.peek(cand.prompt)
            need = self._pages_needed(cand) - len(shared)
            pages = self.allocator.alloc(need)
            if i == 0:
                protect = tuple(cand.prompt[:len(shared)
                                            * self.cfg.prefill_len])
                while pages is None and (
                        self.prefix_cache is not None
                        and self.prefix_cache.evict_one(
                            protect=protect or None)):
                    # The protected key is the longest cached prefix, so
                    # (shared, need) cannot change under eviction.
                    pages = self.allocator.alloc(need)
            if pages is None:
                continue
            if self.prefix_cache is not None:
                _, shared = self.prefix_cache.lookup(cand.prompt)
            if i == 0:
                self._queue.popleft()
                self._head_skips = 0
            else:
                del self._queue[i]
                self._head_skips += 1
            return cand, shared + pages, len(shared)
        return None

    def _admit(self) -> None:
        """Assign queued requests to free slots (paged: reserving pages,
        shared prefix pages first); the prefill chunks themselves run in
        ``_prefill_tick``, or inline under ``scheduler="sequential"``."""
        with self._lock:
            self._purge_cancelled_locked()
        for slot in range(self.cfg.slots):
            if self._slots[slot] is not None:
                continue
            with self._lock:
                if not self._queue:
                    return
                if self.paged:
                    picked = self._reserve_next_locked()
                    if picked is None:
                        return  # head (and window) blocked on pages
                    req, pages, shared_n = picked
                else:
                    req, pages, shared_n = self._queue.popleft(), None, 0
            self._assign_slot(slot, req, pages, shared_n)
            if self.cfg.scheduler == "sequential":
                self._drain_prefill_slot(slot)

    def _assign_slot(self, slot: int, req: Request, pages: list | None,
                     shared_n: int) -> None:
        """Install ``req`` into ``slot`` in the in-prefill state: its
        placement domain, page table (paged) or dense prefix restore, the
        prefill work record, and the parking of the slot's position."""
        p = self.cfg.prefill_len
        if self.slices and req.slice is None:
            # Round-robin over the undrained domains; with every domain
            # drained, place anyway (refusing would wedge the queue).
            avail = [s for s in self.slices if s not in self._drained]
            pool = avail or list(self.slices)
            req.slice = pool[self._slice_rr % len(pool)]
            self._slice_rr += 1
        work = _PrefillWork(req=req, n=len(req.prompt),
                            next_c0=shared_n * p, pages=pages,
                            shared_n=shared_n)
        if self.paged:
            self._slot_pages[slot] = pages
            trow = self._tables_host[slot]
            for i in range(self._max_pages):
                trow[i] = pages[i] if i < len(pages) else 0
            self._tables_dirty = True
            work.table_row = self._h2d(trow)
        elif self.prefix_cache is not None:
            # The dense restore is one device copy, run at assignment.
            work.next_c0 = self.prefix_cache.restore(
                self.cache, req.prompt, slot)
        self._slots[slot] = req
        self._prefill_work[slot] = work
        # Park the slot's position on the last row while prefill is in
        # flight: batched decode still computes this slot (and writes
        # garbage K/V at its position). Row max_seq-1 is never a prompt
        # row and is rewritten in the same dispatch that first attends it.
        park = self._seq_cap - 1
        self.positions[slot] = park
        self._host_positions[slot] = park

    def _drain_prefill_slot(self, slot: int) -> None:
        """Run this slot's remaining prefill chunks to completion (the
        sequential scheduler's inline admission)."""
        while self._prefill_work[slot] is not None:
            self._prefill_chunk(slot)

    def _prefill_tick(self) -> None:
        """Interleaved scheduler: spend up to ``prefill_chunk_budget``
        prefill chunks, round-robin over in-prefill slots. With no
        decodable slot the budget stretches to one full round, so every
        in-prefill slot advances a chunk."""
        if self.cfg.scheduler != "interleaved":
            return
        nslots = self.cfg.slots
        decoding = any(
            self._slots[s] is not None and self._prefill_work[s] is None
            for s in range(nslots))
        budget = self.cfg.prefill_chunk_budget
        if not decoding:
            budget = max(
                budget,
                sum(1 for w in self._prefill_work if w is not None))
        while budget > 0:
            pending = [s for s in range(nslots)
                       if self._prefill_work[s] is not None]
            if not pending:
                return
            slot = min(pending,
                       key=lambda s: (s - self._prefill_rr) % nslots)
            self._prefill_chunk(slot)
            self._prefill_rr = (slot + 1) % nslots
            budget -= 1

    def _prefill_chunk(self, slot: int) -> None:
        """One prefill chunk for ``slot``: target chunks first, then (draft
        speculation) the draft model's own chunks, shared prefix chunks
        included (the draft cache is never shared). Completing the last
        chunk pins the prefix in the prefix cache, samples the first token
        and flips the slot to decoding."""
        work = self._prefill_work[slot]
        req = work.req
        p = self.cfg.prefill_len
        draft_mode = self.spec_len and self.cfg.spec_source == "draft"
        self._chunked[id(req)] = req
        with profiler_span("serve.chunk"):
            if work.next_c0 < work.n:
                c0 = work.next_c0
                chunk = req.prompt[c0:c0 + p]
                ln = len(chunk)
                toks = self._h2d(chunk + [0] * (p - ln))
                if self.paged:
                    gathered = prefill_rows(self.cfg, self.pool,
                                            work.table_row, c0)
                    work.logits = paged_prefill(
                        self.cfg, self.params, self.pool, toks, ln,
                        work.pages[c0 // p], work.table_row, c0,
                        moe_rows=self.moe_rows)
                    self._count_routed(ln)
                else:
                    gathered = self.cfg.model.max_seq  # the slot's cache
                    work.logits = self._prefill(self.params, self.cache,
                                                toks, ln, slot, c0)
                work.next_c0 = c0 + p
                with self._lock:
                    self.prefill_rows_gathered += gathered
                    self.prefill_rows_needed += c0 + ln
            elif draft_mode and work.draft_c0 < work.n:
                c0 = work.draft_c0
                chunk = req.prompt[c0:c0 + p]
                ln = len(chunk)
                prefill(self._draft_scfg, self.draft_params,
                        self.draft_cache, self._h2d(chunk + [0] * (p - ln)),
                        ln, slot, c0)
                work.draft_c0 = c0 + p
        if work.next_c0 < work.n or (
                draft_mode and work.draft_c0 < work.n):
            return
        # Pin the prefix for later sharers only now that its K/V exists.
        if self.prefix_cache is not None:
            if self.paged:
                self.prefix_cache.store(req.prompt, work.pages)
            else:
                self.prefix_cache.store(self.cache, req.prompt, slot)
        if draft_mode:
            self._draft_pos[slot] = work.n
        self._prefill_work[slot] = None
        with profiler_span("serve.first_token"):
            self._after_prefill(slot, req, work.n, work.logits)

    def _after_prefill(self, slot: int, req: Request, n: int,
                       logits: torch.Tensor) -> None:
        """Sample the first token (index 0 of the request's stream, keyed
        by its rid) and install the request for decoding. A requeued
        re-run keeps the TTFT of its first admission."""
        dev = self.device
        first = int(sample_tokens(
            logits[None], self._sample_key, self._h2d([req.rid]),
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.tensor([req.temperature]).to(dev, non_blocking=True),
            self._h2d([req.top_k]))[0])
        now = time.monotonic()
        with self._lock:
            if req.ttft_s is None:
                req.ttft_s = now - req.enqueued
                req.first_tok_t = now
                req.queue_wait_s = req.ttft_s - (
                    req._service_s + now - self._step_t0)
                self._observe_ttft(req.ttft_s)
                tst = self._tenant_locked(req)
                if tst is not None:
                    tst.ttft.append((now, req.ttft_s))
            req.emit([first])
            self.tokens_total += 1
        self._slots[slot] = req
        self.positions[slot] = n
        self._host_positions[slot] = n
        self.last_tokens[slot] = first
        self._host_last[slot] = first
        self.temps[slot] = req.temperature
        self.topks[slot] = req.top_k
        self.rids[slot] = req.rid
        self.tok_ctrs[slot] = 1  # index 0 spent
        if len(req.output) >= req.max_new + 1 or req.hit_stop():
            self._complete(slot)

    def _release_slot_pages(self, slot: int) -> None:
        if self.paged:
            # Free the pages and park the slot's table on the trash page
            # so its garbage batched-decode writes can't corrupt pages
            # reallocated to live requests.
            self.allocator.release(self._slot_pages[slot])
            self._slot_pages[slot] = []
            self._tables_host[slot] = [0] * self._max_pages
            self._tables_dirty = True

    def _complete(self, slot: int) -> None:
        req = self._slots[slot]
        assert req is not None
        self._slots[slot] = None
        self._release_slot_pages(slot)
        req.status = "completed"
        with self._lock:
            self.completed_total += 1
            tst = self._tenant_locked(req)
            if tst is not None:
                tst.completed += 1
                tst.tokens += len(req.output)
            if req.first_tok_t is not None and len(req.output) > 1:
                tpot = ((time.monotonic() - req.first_tok_t)
                        / (len(req.output) - 1))
                self._tpot_recent.append(tpot)
                if tst is not None:
                    tst.tpot.append((time.monotonic(), tpot))
        req.finish_stream()
        req.done.set()

    def _abort_prefill(self, slot: int) -> None:
        """Cancellation observed while the slot was still prefilling:
        release the reservation and count a cancellation."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._prefill_work[slot] = None
        self._release_slot_pages(slot)
        req.status = "cancelled"
        with self._lock:
            self.cancelled_total += 1
            tst = self._tenant_locked(req)
            if tst is not None:
                tst.cancelled += 1
        req.finish_stream()
        req.done.set()

    def step(self) -> bool:
        """Admit + prefill tick + one decode step (plain, fused block or
        speculative round); returns True if any work remains. With a
        ``reporter`` attached, the step counts as declared device work: it
        ends in the decode's one device->host sync, so its wall time
        covers the device work it queued."""
        with profiler_span("serve.engine_step"):
            if self.reporter is not None:
                with self.reporter.device_work():
                    return self._step_inner()
            return self._step_inner()

    def _step_inner(self) -> bool:
        self._step_t0 = time.monotonic()
        with profiler_span("serve.admit"):
            self._admit()
            # Cancelled mid-flight requests free their slot (and pages)
            # before the prefill tick, so a dead request's chunks never
            # consume the step's budget.
            for slot in range(self.cfg.slots):
                req = self._slots[slot]
                if req is not None and req.cancelled.is_set():
                    if self._prefill_work[slot] is not None:
                        self._abort_prefill(slot)
                    else:
                        self._complete(slot)
            # Drain sweep: requests placed on a drained domain abort and
            # requeue, every step while the mark persists; with no
            # undrained domain to requeue to, nothing is swept.
            if self._drained:
                with self._lock:
                    drained = set(self._drained)
                    has_home = any(s not in drained for s in self.slices)
                if drained and has_home:
                    for slot in range(self.cfg.slots):
                        req = self._slots[slot]
                        if req is not None and req.slice in drained:
                            self._requeue_slot(slot)
        self._prefill_tick()
        # Decode batch: slots mid-prefill are excluded (the batched step
        # computes them as garbage the host ignores, like free slots).
        in_prefill = any(w is not None for w in self._prefill_work)
        active = [s for s in range(self.cfg.slots)
                  if self._slots[s] is not None
                  and self._prefill_work[s] is None]
        if active:
            # A speculative round needs room for spec_len+1 rows in every
            # active slot, one greedy slot to profit, and (dense only) no
            # slot mid-prefill: the dense verify's clamped block write
            # could land on rows a parked slot's prefill filled. Else the
            # plain step.
            if (self.spec_len
                    and (self.paged or not in_prefill)
                    and any(self._slots[s].temperature <= 0
                            for s in active)
                    and all(self._host_positions[s]
                            <= self._seq_cap - 2 - self.spec_len
                            for s in active)):
                self._spec_round(active)
            else:
                self._plain_step(active)
        # A request still in prefill whose chunk ran in this step waited
        # on nothing during it.
        step_s = time.monotonic() - self._step_t0
        for req in self._chunked.values():
            if req.ttft_s is None:
                req._service_s += step_s
        self._chunked.clear()
        with self._lock:
            pending = bool(self._queue)
        return pending or any(s is not None for s in self._slots)

    def _decode_rows(self, active: list[int], rounds: int = 1,
                     whole: bool = False) -> tuple[int, int]:
        """(rows read over every batch row, rows read over the active
        slots) by the attention of ``rounds`` decode rounds from the
        slots' positions: rows 0..position for the paged kernel and ring
        read (their ``positions + 1`` lengths); every row for the gather
        read, the dense cache, or ``whole``."""
        if self.paged and self.cfg.paged_attn != "gather" and not whole:
            cap = self._seq_cap - 1
            pos = self._host_positions
            if rounds == 1:
                return (sum(pos) + len(pos),
                        sum(pos[s] for s in active) + len(active))

            def rows(p: int) -> int:
                return sum(min(p + r, cap) + 1 for r in range(rounds))
            return (sum(rows(p) for p in pos),
                    sum(rows(pos[s]) for s in active))
        width = rounds * (self._max_pages * self.cfg.prefill_len
                          if self.paged else self.cfg.model.max_seq)
        return width * self.cfg.slots, width * len(active)

    def _count_routed(self, rows: int) -> None:
        """Count the (token, expert) pairs of ``rows`` tokens through every
        routed layer (``moe_pairs_routed``)."""
        if self.moe_rows is not None:
            with self._lock:
                self.moe_pairs_routed += (rows * self.moe_rows.shape[0]
                                          * self.cfg.model.experts_per_token)

    def _plain_step(self, active: list[int]) -> None:
        # Fused block decode when configured and every active slot has
        # cache room for the whole block (else the single step below).
        n = self.cfg.decode_block
        if n > 1 and all(self._host_positions[s] <= self._seq_cap - 1 - n
                         for s in active):
            self._block_step(active, n)
            return
        with profiler_span("serve.decode_launch"):
            read, live = self._decode_rows(active)
            if self.paged:
                self._sync_tables()
                logits = paged_decode_step(
                    self.cfg, self.params, self.pool, self.last_tokens,
                    self.positions, self._tables_dev, moe_rows=self.moe_rows)
                self._count_routed(self.cfg.slots)
            else:
                logits = self._decode(self.params, self.cache,
                                      self.last_tokens, self.positions)
            nxt = sample_tokens(logits, self._sample_key, self.rids,
                                self.tok_ctrs, self.temps, self.topks)
            self.tok_ctrs = self.tok_ctrs + 1
            self.last_tokens = nxt
            self.positions = torch.clamp(self.positions + 1,
                                         max=self._seq_cap - 1)
        # ONE device→host sync per step; positions tracked host-side, for
        # every slot as the device advances them.
        with profiler_span("serve.sync"):
            nxt_host = nxt.tolist()
        with profiler_span("serve.emit"):
            self._host_last = list(nxt_host)
            self._host_positions = [min(p + 1, self._seq_cap - 1)
                                    for p in self._host_positions]
            with self._lock:
                self.decode_steps_total += 1
                self.tokens_total += len(active)
                self.decode_rows_read += read
                self.decode_rows_live += live
            for slot in active:
                req = self._slots[slot]
                req.emit([nxt_host[slot]])
                if (len(req.output) >= req.max_new + 1
                        or req.hit_stop()
                        or self._host_positions[slot]
                        >= self._seq_cap - 1):
                    self._complete(slot)

    def _block_step(self, active: list[int], n: int) -> None:
        """One fused block of n decode steps and samples (decode_rounds or
        paged_decode_rounds), ONE device→host sync. Each slot's tokens
        replay in order up to its own stop; tokens generated past it are
        discarded (the block-decode trade), and their sampling indices are
        never used again by that request."""
        with profiler_span("serve.decode_launch"):
            read, live = self._decode_rows(active, n)
            if self.paged:
                self._sync_tables()
                self.last_tokens, self.positions, toks = (
                    paged_decode_rounds(
                        self.cfg, self.params, self.pool, self.last_tokens,
                        self.positions, self._tables_dev, self._sample_key,
                        self.rids, self.tok_ctrs, self.temps, self.topks,
                        steps=n, seq_cap=self._seq_cap))
            else:
                self.last_tokens, self.positions, toks = (
                    self._decode_rounds(
                        self.params, self.cache, self.last_tokens,
                        self.positions, self._sample_key, self.rids,
                        self.tok_ctrs, self.temps, self.topks, steps=n))
            self.tok_ctrs = self.tok_ctrs + n
        with profiler_span("serve.sync"):
            toks_host = toks.tolist()  # [B, n]
        with profiler_span("serve.emit"):
            emitted = 0
            cap = self._seq_cap - 1
            with self._lock:
                self.decode_steps_total += n
                self.decode_rows_read += read
                self.decode_rows_live += live
            for slot in active:
                req = self._slots[slot]
                pos = self._host_positions[slot]
                for tok in toks_host[slot]:
                    req.emit([tok])
                    emitted += 1
                    pos = min(pos + 1, cap)
                    if (len(req.output) >= req.max_new + 1
                            or req.hit_stop() or pos >= cap):
                        self._complete(slot)
                        break
            # Every slot advanced n rows on the device, clamped.
            self._host_positions = [min(p + n, cap)
                                    for p in self._host_positions]
            self._host_last = [row[-1] for row in toks_host]
            with self._lock:
                self.tokens_total += emitted

    def _seq_token(self, req: Request, i: int) -> int:
        """Token at sequence index ``i``: prompt, then emitted output."""
        n = len(req.prompt)
        return req.prompt[i] if i < n else req.output[i - n]

    def _spec_round(self, active: list[int]) -> None:
        """One speculative round: spec_len draft steps (or prompt-lookup
        proposals) + one verify block; each greedy slot accepts its longest
        agreed prefix plus the target's own next token, each sampled slot
        emits one token drawn from the verified logits (plain decode for
        it)."""
        with profiler_span("serve.decode_launch"):
            if self.cfg.spec_source == "prompt":
                prop_h = self._prompt_proposals()
                proposed = self._h2d(prop_h)
            else:
                proposed, prop_h = self._draft_proposals(active), None
            host = self._spec_verify(active, proposed, fetch_proposed=(
                prop_h is None))
        with profiler_span("serve.sync"):
            fetched = torch.cat(host, dim=1).tolist()  # the one sync
        with profiler_span("serve.emit"):
            self._spec_emit(active, fetched, host[0].shape[1], prop_h)

    def _draft_proposals(self, active: list[int]) -> torch.Tensor:
        """The draft model's spec_len greedy proposals [B, spec_len], its
        cache first caught up to the target frontier."""
        cfg, params, cache = self._draft_scfg, self.draft_params, (
            self.draft_cache)
        # Catch the draft cache up to the target frontier first: plain
        # steps advance a sequence without touching the draft cache.
        deficit = max(
            self._host_positions[s] - self._draft_pos[s] for s in active)
        for d in range(deficit):
            toks, rows = [], []
            for s in range(self.cfg.slots):
                req = self._slots[s]
                p_s = self._host_positions[s]
                f = self._draft_pos[s] + d
                if (req is not None and self._prefill_work[s] is None
                        and f < p_s):
                    toks.append(self._seq_token(req, f))
                    rows.append(f)
                else:
                    # Caught up, empty or mid-prefill: rewrite the row the
                    # proposal loop writes first anyway (idempotent).
                    toks.append(self._host_last[s])
                    rows.append(p_s)
            decode_step(cfg, params, cache, self._h2d(toks),
                        self._h2d(rows))
        dt_tok = self.last_tokens
        dpos = self.positions
        drafts = []
        for _ in range(self.spec_len):
            dlogits = decode_step(cfg, params, cache, dt_tok, dpos)
            dt_tok = torch.argmax(dlogits, dim=-1).to(torch.int32)
            drafts.append(dt_tok)
            dpos = dpos + 1
        # One more draft step feeding the last proposal, so the draft
        # cache holds its K/V when every proposal is accepted.
        decode_step(cfg, params, cache, dt_tok, dpos)
        return torch.stack(drafts, dim=1)

    def _prompt_proposals(self) -> list[list[int]]:
        """Prompt-lookup proposals: host-side n-grams from each request's
        own context (``ngram_propose``), no draft model; the verify and
        acceptance are the draft round's."""
        g = self.spec_len
        prop_rows = []
        for s in range(self.cfg.slots):
            req = self._slots[s]
            if req is None:
                prop_rows.append([0] * g)
            else:
                prop_rows.append(
                    ngram_propose(req.prompt + req.output, g,
                                  window=self.cfg.spec_ngram_window))
        return prop_rows

    def _spec_verify(self, active: list[int], proposed: torch.Tensor,
                     fetch_proposed: bool) -> list[torch.Tensor]:
        """One target verify block over [feed, proposals]; returns what
        the round's one device→host sync fetches: the verify argmax
        [B, g+1], then the proposals when the proposer has no host copy,
        then (a sampled slot sharing the round) a draw from the verified
        logits [B, 1]."""
        ver_in = torch.cat([self.last_tokens[:, None], proposed], dim=1)
        if self.paged:
            self._sync_tables()
            vlogits = paged_decode_block(self.cfg, self.params, self.pool,
                                         ver_in, self.positions,
                                         self._tables_dev)
        else:
            vlogits = decode_block(self.cfg, self.params, self.cache,
                                   ver_in, self.positions)
        tgt = torch.argmax(vlogits, dim=-1).to(torch.int32)  # [B, g+1]
        host = [tgt, proposed] if fetch_proposed else [tgt]
        # The sampler (a full-vocab sort for top-k) runs only when a
        # sampled slot shares the round.
        if any(self._slots[s].temperature > 0 for s in active):
            host.append(sample_tokens(vlogits[:, 0], self._sample_key,
                                      self.rids, self.tok_ctrs,
                                      self.temps, self.topks)[:, None])
        return host

    def _spec_emit(self, active: list[int], fetched: list, width: int,
                   prop_h: list | None) -> None:
        """Greedy-prefix acceptance plus the target's token, sampled slots
        their draw, from the fetched rows (``width``: the verify argmax's
        columns; ``prop_h``: the proposals' host copy, else fetched)."""
        g = self.spec_len
        tgt_h = [row[:width] for row in fetched]
        if prop_h is None:
            prop_h = [row[width:width + g] for row in fetched]
        any_temp = any(self._slots[s].temperature > 0 for s in active)
        samp_h = [row[-1] for row in fetched] if any_temp else None
        emitted_n = accepted_n = proposed_n = 0
        for slot in active:
            req = self._slots[slot]
            if req.temperature > 0:
                a = 0
                emitted = [samp_h[slot]]
            else:
                a = greedy_accept_len(prop_h[slot], tgt_h[slot])
                emitted = prop_h[slot][:a] + [tgt_h[slot][a]]
                proposed_n += g
            accepted_n += a
            room = req.max_new + 1 - len(req.output)
            emitted = emitted[:room]  # room >= 1: full slots completed
            if req.stop_tokens:
                for si, tok in enumerate(emitted):
                    if tok in req.stop_tokens:
                        emitted = emitted[:si + 1]
                        break
            req.emit(emitted)
            self._host_positions[slot] += len(emitted)
            self._host_last[slot] = emitted[-1]
            self._draft_pos[slot] = self._host_positions[slot]
            emitted_n += len(emitted)
            if (len(req.output) >= req.max_new + 1
                    or req.hit_stop()
                    or self._host_positions[slot] >= self._seq_cap - 1):
                self._complete(slot)
        self.positions = self._h2d(self._host_positions)
        self.last_tokens = self._h2d(self._host_last)
        # Greedy slots advanced by their accepted length, sampled ones by
        # one: len(output) is the next sample index either way.
        self.tok_ctrs = self._h2d(
            [len(r.output) if (r := self._slots[s]) is not None else 0
             for s in range(self.cfg.slots)])
        read, live = self._decode_rows(active, whole=True)
        with self._lock:
            self.decode_steps_total += 1
            self.decode_rows_read += read
            self.decode_rows_live += live
            self.spec_rounds_total += 1
            self.spec_proposed_total += proposed_n
            self.spec_accepted_total += accepted_n
            self.tokens_total += emitted_n

    def drain(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return

    # -- metrics ------------------------------------------------------------

    def _stats_snapshot(self) -> dict:
        """Raw metrics state as one dict (the reference's snapshot keys),
        rendered by ``_render_serving_metrics``."""
        with self._lock:
            snap = {
                "tokens": self.tokens_total,
                "requests": self.requests_total,
                "completed": self.completed_total,
                "steps": self.decode_steps_total,
                "queue": len(self._queue),
                "rejected": self.rejected_total,
                "cancelled": self.cancelled_total,
                "shed": self.shed_total,
                "requeued": self.requeued_total,
                "ttft_counts": list(self._ttft_counts),
                "ttft_inf": self._ttft_inf,
                "ttft_sum": self._ttft_sum,
                "free": sum(1 for s in self._slots if s is None),
                "in_prefill": sum(
                    1 for w in self._prefill_work if w is not None),
                "ttft_recent": list(self._ttft_recent),
                "tpot_recent": list(self._tpot_recent),
                "spec_rounds": self.spec_rounds_total,
                "spec_proposed": self.spec_proposed_total,
                "spec_accepted": self.spec_accepted_total,
                "tenant_window_s": self.tenant_window_s,
                "tenants": {
                    name: {
                        "submitted": st.submitted,
                        "completed": st.completed,
                        "rejected": st.rejected,
                        "cancelled": st.cancelled,
                        "shed": st.shed,
                        "tokens": st.tokens,
                        "ttft": list(st.ttft),
                        "tpot": list(st.tpot),
                    }
                    for name, st in self.tenants.items()
                },
            }
            if self.paged:
                snap["kv_pages_total"] = self.allocator.num_pages - 1
                snap["kv_pages_free"] = self.allocator.free_pages
            else:
                snap["kv_pages_total"] = snap["kv_pages_free"] = None
        weight_bytes = param_bytes(self.params)
        if self.draft_params is not None and (
                self.draft_params is not self.params):
            # A distinct draft's weights are resident too, but only its
            # leaves that are not the target's own tensors (a truncated
            # draft aliases them).
            target = {id(x) for x in param_leaves(self.params)}
            weight_bytes += sum(leaf_bytes(x)
                                for x in param_leaves(self.draft_params)
                                if id(x) not in target)
        snap["weight_bytes"] = weight_bytes
        if self.prefix_cache is not None:
            pc = self.prefix_cache
            snap["prefix"] = {"hits": pc.hits, "misses": pc.misses,
                              "saved_tokens": pc.saved_tokens,
                              "bytes": pc.resident_bytes()}
        else:
            snap["prefix"] = None
        return snap

    def metrics_text(self) -> str:
        return _render_serving_metrics(self._stats_snapshot())


def _merge_serving_snapshots(snaps: "list[dict]") -> dict:
    """Sum dp-replica snapshots into one fleet snapshot: counters and
    gauge counts add, latency windows concatenate (quantiles are
    order-independent), per-tenant series merge with their observation
    times, so the recency window still applies."""
    out = dict(snaps[0])
    out["tenants"] = {
        name: dict(row, ttft=list(row["ttft"]), tpot=list(row["tpot"]))
        for name, row in snaps[0]["tenants"].items()
    }
    for s in snaps[1:]:
        for k in ("tokens", "requests", "completed", "steps", "queue",
                  "rejected", "cancelled", "shed", "requeued", "ttft_inf",
                  "ttft_sum", "free", "in_prefill", "spec_rounds",
                  "spec_proposed", "spec_accepted", "weight_bytes"):
            out[k] += s[k]
        out["ttft_counts"] = [
            a + b for a, b in zip(out["ttft_counts"], s["ttft_counts"])]
        for k in ("kv_pages_total", "kv_pages_free"):
            if s[k] is not None:
                out[k] = (out[k] or 0) + s[k]
        out["ttft_recent"] = out["ttft_recent"] + s["ttft_recent"]
        out["tpot_recent"] = out["tpot_recent"] + s["tpot_recent"]
        if s["prefix"] is not None:
            if out["prefix"] is None:
                out["prefix"] = dict(s["prefix"])
            else:
                out["prefix"] = {
                    k: out["prefix"][k] + v for k, v in s["prefix"].items()}
        for name, row in s["tenants"].items():
            mine = out["tenants"].get(name)
            if mine is None:
                out["tenants"][name] = dict(
                    row, ttft=list(row["ttft"]), tpot=list(row["tpot"]))
                continue
            for k in ("submitted", "completed", "rejected", "cancelled",
                      "shed", "tokens"):
                mine[k] += row[k]
            mine["ttft"] = list(mine["ttft"]) + list(row["ttft"])
            mine["tpot"] = list(mine["tpot"]) + list(row["tpot"])
    return out


def _render_serving_metrics(snap: dict,
                            replica_rows: "list[tuple] | None" = None
                            ) -> str:
    """Render one (possibly merged) stats snapshot as the /metrics
    exposition — the reference's renderer line for line, so the text is
    identical for equal snapshots. ``replica_rows`` — (replica,
    slots_free, queue, ttft_p95_ms, tpot_p95_ms) per dp replica — adds
    the ``tpumon_serving_replica_*`` gauge family of the mesh engine; None
    omits it."""
    tokens = snap["tokens"]
    requests = snap["requests"]
    completed = snap["completed"]
    steps = snap["steps"]
    queue = snap["queue"]
    rejected = snap["rejected"]
    cancelled = snap["cancelled"]
    shed = snap["shed"]
    requeued = snap["requeued"]
    counts = snap["ttft_counts"]
    inf = snap["ttft_inf"]
    ttft_sum = snap["ttft_sum"]
    free = snap["free"]
    in_prefill = snap["in_prefill"]
    ttft_recent = snap["ttft_recent"]
    tpot_recent = snap["tpot_recent"]
    spec_rounds = snap["spec_rounds"]
    spec_proposed = snap["spec_proposed"]
    spec_accepted = snap["spec_accepted"]
    now_mono = time.monotonic()
    tw = snap["tenant_window_s"]
    tenant_rows = [
        (
            name,
            row["submitted"], row["completed"], row["rejected"],
            row["cancelled"], row["shed"], row["tokens"],
            [v for t, v in row["ttft"] if now_mono - t <= tw],
            [v for t, v in row["tpot"] if now_mono - t <= tw],
        )
        for name, row in sorted(snap["tenants"].items())
    ]
    w = MetricsWriter()
    w.counter("jetstream_generate_tokens",
              "tokens generated (prefill first-token + decode)"
              ).add(value=tokens)
    w.counter("jetstream_request_count", "requests submitted"
              ).add(value=requests)
    w.counter("tpumon_serving_requests_completed", "requests finished"
              ).add(value=completed)
    w.counter("tpumon_serving_requests_rejected",
              "requests dropped by queue backpressure"
              ).add(value=rejected)
    w.counter("tpumon_serving_requests_cancelled",
              "requests cancelled before their first token "
              "(while queued or mid-prefill)"
              ).add(value=cancelled)
    w.counter("tpumon_serving_requests_shed",
              "requests shed at admission by the actuation layer "
              "(tpumon.actuate; a remedial drop, never an error)"
              ).add(value=shed)
    w.counter("tpumon_serving_requests_requeued",
              "in-flight requests aborted and re-admitted by a "
              "slice drain (tpumon.actuate)"
              ).add(value=requeued)
    w.counter("tpumon_serving_decode_steps", "fused decode steps"
              ).add(value=steps)
    w.gauge("jetstream_queue_size", "requests waiting for a slot"
            ).add(value=queue)
    w.gauge("jetstream_slots_available", "free decode slots"
            ).add(value=free)
    w.gauge("tpumon_serving_slots_prefill",
            "slots mid-chunked-prefill (admitted, not yet decoding)"
            ).add(value=in_prefill)
    # Per-request latency quantiles over a recent window: TTFT from
    # enqueue to first token, TPOT decode seconds per token after it.
    for fam, series, unit in (
        ("tpumon_serving_ttft", ttft_recent, 1e3),
        ("tpumon_serving_tpot", tpot_recent, 1e3),
    ):
        q = quantiles(series)
        if q is not None:
            w.gauge(fam + "_p50_ms",
                    "recent-window per-request p50"
                    ).add(value=round(q[0] * unit, 3))
            w.gauge(fam + "_p95_ms",
                    "recent-window per-request p95"
                    ).add(value=round(q[1] * unit, 3))
    if tenant_rows:
        reqs = w.counter("tpumon_serving_tenant_requests",
                         "requests submitted per tenant")
        comp = w.counter("tpumon_serving_tenant_completed",
                         "requests finished per tenant")
        rej = w.counter("tpumon_serving_tenant_rejected",
                        "requests dropped by backpressure per tenant")
        canc = w.counter("tpumon_serving_tenant_cancelled",
                         "requests cancelled per tenant")
        shd = w.counter("tpumon_serving_tenant_shed",
                        "requests shed at admission per tenant "
                        "(excluded from error-rate math — a shed "
                        "is the remedy, not the fault)")
        toks = w.counter("tpumon_serving_tenant_tokens",
                         "tokens emitted per tenant")
        tg: dict[str, object] = {}
        for fam in ("tpumon_serving_tenant_ttft_p50_ms",
                    "tpumon_serving_tenant_ttft_p95_ms",
                    "tpumon_serving_tenant_tpot_p50_ms",
                    "tpumon_serving_tenant_tpot_p95_ms"):
            tg[fam] = w.gauge(
                fam, "recent-window per-tenant latency quantile")
        for (name, sub, done, rj, cn, sh, tk, ttfts, tpots) in tenant_rows:
            labels = {"tenant": name}
            reqs.add(labels, sub)
            comp.add(labels, done)
            rej.add(labels, rj)
            canc.add(labels, cn)
            shd.add(labels, sh)
            toks.add(labels, tk)
            for fam_base, series in (
                ("tpumon_serving_tenant_ttft", ttfts),
                ("tpumon_serving_tenant_tpot", tpots),
            ):
                q = quantiles(series)
                if q is not None:
                    tg[fam_base + "_p50_ms"].add(
                        labels, round(q[0] * 1e3, 3))
                    tg[fam_base + "_p95_ms"].add(
                        labels, round(q[1] * 1e3, 3))
    w.gauge("tpumon_serving_weight_bytes",
            "resident model weight bytes (int8 when quantized)"
            ).add(value=snap["weight_bytes"])
    w.counter("tpumon_serving_spec_rounds",
              "speculative decode rounds (0 when disabled)"
              ).add(value=spec_rounds)
    w.counter("tpumon_serving_spec_proposed",
              "draft tokens proposed").add(value=spec_proposed)
    w.counter("tpumon_serving_spec_accepted",
              "draft tokens the target verify accepted"
              ).add(value=spec_accepted)
    if snap["kv_pages_total"] is not None:
        w.gauge("tpumon_serving_kv_pages_total",
                "shared KV pool pages (excl. the trash page)"
                ).add(value=snap["kv_pages_total"])
        w.gauge("tpumon_serving_kv_pages_free",
                "KV pool pages not reserved by admitted requests"
                ).add(value=snap["kv_pages_free"])
    if snap["prefix"] is not None:
        pc = snap["prefix"]
        w.counter("tpumon_serving_prefix_hits",
                  "admissions served a cached prompt prefix"
                  ).add(value=pc["hits"])
        w.counter("tpumon_serving_prefix_misses",
                  "admissions with no cached prefix").add(value=pc["misses"])
        w.counter("tpumon_serving_prefix_saved_tokens",
                  "prompt tokens whose prefill was skipped"
                  ).add(value=pc["saved_tokens"])
        w.gauge("tpumon_serving_prefix_bytes",
                "HBM pinned by cached prefix K/V"
                ).add(value=pc["bytes"])
    if replica_rows is not None:
        # The mesh engine's per-replica family: the collector distills it
        # into per-replica series, so an SLO can target one dp replica.
        rg = {}
        for fam, help_ in (
            ("tpumon_serving_replica_slots_available",
             "free decode slots per dp replica"),
            ("tpumon_serving_replica_queue_size",
             "requests waiting per dp replica (router-assigned)"),
            ("tpumon_serving_replica_ttft_p95_ms",
             "recent-window TTFT p95 per dp replica"),
            ("tpumon_serving_replica_tpot_p95_ms",
             "recent-window TPOT p95 per dp replica"),
        ):
            rg[fam] = w.gauge(fam, help_)
        for (replica, slots_free, rq, ttft_p95, tpot_p95) in replica_rows:
            labels = {"replica": replica}
            rg["tpumon_serving_replica_slots_available"].add(
                labels, slots_free)
            rg["tpumon_serving_replica_queue_size"].add(labels, rq)
            if ttft_p95 is not None:
                rg["tpumon_serving_replica_ttft_p95_ms"].add(
                    labels, round(ttft_p95, 3))
            if tpot_p95 is not None:
                rg["tpumon_serving_replica_tpot_p95_ms"].add(
                    labels, round(tpot_p95, 3))
    lines = [w.render().rstrip("\n")]
    lines.append("# TYPE jetstream_time_to_first_token histogram")
    cum = 0
    for bound, c in zip(TTFT_BUCKETS_S, counts):
        cum += c
        lines.append(
            f'jetstream_time_to_first_token_bucket{{le="{bound}"}} {cum}')
    total = cum + inf
    lines.append(
        f'jetstream_time_to_first_token_bucket{{le="+Inf"}} {total}')
    lines.append(f"jetstream_time_to_first_token_sum {ttft_sum:.6f}")
    lines.append(f"jetstream_time_to_first_token_count {total}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# dp×tp mesh serving: replicated engines behind an affinity router
# ---------------------------------------------------------------------------


class MeshServingEngine:
    """``mesh_dp`` data-parallel replicas — each a plain ServingEngine,
    its scheduler unchanged, tensor-parallel over its own ``mesh_tp``
    devices (``model.replica_meshes``) — behind the reference's topology-
    and prefix-affinity-aware router, in this one process.

    Routing: a request goes to the replica with the longest cached prefix
    of its prompt, ties broken by least load (queued + in flight), then
    by lowest replica index (the contiguous device order). The router
    mints the rids (children take ``submit(rid=...)``) and every replica
    shares seed and params, so a request's sampled stream is a pure
    function of (seed, prompt, params) on whichever replica it lands.

    The dp replica ids ("r0".."r<dp-1>") are the placement domains:
    ``drain_slice("r1")`` stops admission there and moves its queued and
    in-flight work to live replicas by ``evict_all`` / ``adopt`` (rid and
    delivered-stream watermark kept, so the re-run replays the same
    tokens). With every replica drained the router rejects new work.

    ``devices`` lists the devices the replicas take in order (a device
    may repeat: dp x tp on one card); None takes ``visible_devices(device)``
    — every CUDA device, or ``device`` alone when it is a CPU or names its
    index."""

    def __init__(self, cfg: ServeConfig | None = None,
                 params: dict | None = None, seed: int = 0,
                 max_queue: int = 64, ckpt_dir: str | None = None,
                 quantize: str | None = None, devices=None, device=None):
        self.cfg = cfg or default_engine_config()
        dp, tp = self.cfg.mesh_dp, self.cfg.mesh_tp
        devices = list(visible_devices(device) if devices is None
                       else devices)
        # Validates the shape against the device count (the reference's
        # text, which both CLIs report).
        meshes = replica_meshes(dp, tp, dense=self.cfg.kv_layout != "paged",
                                devices=devices)
        child_cfg = dc_replace(self.cfg, mesh_dp=1, mesh_tp=1)
        self.replica_ids: tuple[str, ...] = tuple(
            f"r{d}" for d in range(dp))
        # Children share (seed, params): identical weights on every
        # replica is the identical-stream precondition (params None: each
        # child draws them from the same seed).
        self.replicas: list[ServingEngine] = [
            ServingEngine(cfg=child_cfg, params=params, seed=seed,
                          max_queue=max_queue, ckpt_dir=ckpt_dir,
                          quantize=quantize, device=devices[d * tp],
                          mesh=meshes[d])
            for d in range(dp)
        ]
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._drained: set[str] = set()
        self.slices: tuple[str, ...] = self.replica_ids
        self.router_rejected = 0

    # -- admission / routing ------------------------------------------------

    def _live(self) -> "list[int]":
        with self._lock:
            drained = set(self._drained)
        return [i for i, name in enumerate(self.replica_ids)
                if name not in drained]

    def _route(self, prompt: list[int], live: "list[int]") -> ServingEngine:
        best_i = live[0]
        best = (-self.replicas[best_i].prefix_hit_len(prompt),
                self.replicas[best_i].load())
        for i in live[1:]:
            eng = self.replicas[i]
            key = (-eng.prefix_hit_len(prompt), eng.load())
            if key < best:
                best, best_i = key, i
        return self.replicas[best_i]

    def submit(self, prompt: list[int], max_new: int = 16,
               temperature: float = 0.0, top_k: int = 0,
               stream: bool = False, stop_tokens=(),
               tenant: str = "", rid: int | None = None) -> Request:
        """Route one request to a dp replica (affinity → load → index) and
        submit it there with a router-minted rid; ServingEngine.submit's
        contract. With every replica drained the request is rejected
        here."""
        live = self._live()
        if not live:
            req = Request(
                rid=rid if rid is not None else next(self._rid),
                prompt=[t % self.cfg.model.vocab for t in prompt] or [0],
                max_new=max(0, int(max_new)), enqueued=time.monotonic(),
                temperature=float(temperature), top_k=int(top_k),
                stream=queue.Queue() if stream else None,
                stop_tokens=tuple(int(t) for t in stop_tokens),
                tenant=str(tenant))
            with self._lock:
                self.router_rejected += 1
            req.status = "rejected"
            req.finish_stream()
            req.done.set()
            return req
        eng = self._route(list(prompt), live)
        return eng.submit(prompt, max_new=max_new, temperature=temperature,
                          top_k=top_k, stream=stream,
                          stop_tokens=stop_tokens, tenant=tenant,
                          rid=rid if rid is not None else next(self._rid))

    # -- engine loop --------------------------------------------------------

    def step(self) -> bool:
        """One scheduler step on every replica, drained ones included
        (their remaining work must still finish when no live replica took
        it). True if any replica has work left."""
        progressed = False
        for eng in self.replicas:
            progressed = eng.step() or progressed
        return progressed

    def drain(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return

    # -- actuation surface (tpumon_torch.actuate) ---------------------------

    def set_shed(self, tenant: str, fraction: float) -> float:
        got = 0.0
        for eng in self.replicas:
            got = eng.set_shed(tenant, fraction)
        return got

    def shed_fractions(self) -> dict[str, float]:
        return self.replicas[0].shed_fractions()

    def nudge_capacity(self, prefill_budget: int | None = None,
                       admit_lookahead: int | None = None) -> dict:
        out: dict = {}
        for eng in self.replicas:
            out = eng.nudge_capacity(prefill_budget=prefill_budget,
                                     admit_lookahead=admit_lookahead)
        return out

    def set_slices(self, names) -> None:
        """The placement domains here are the replica ids, fixed at
        construction; a sync only prunes drain marks of names that no
        longer exist, as ServingEngine.set_slices does."""
        with self._lock:
            self.slices = tuple(str(n) for n in names)
            self._drained &= set(self.slices)

    def drain_slice(self, name: str) -> None:
        """Drain one dp replica: the router stops admitting to it, and its
        queued and in-flight requests move to the least loaded live
        replicas (``evict_all`` / ``adopt``). With no live replica left
        the work stays and finishes where it is."""
        name = str(name)
        with self._lock:
            self._drained.add(name)
        if name not in self.replica_ids:
            return
        live = self._live()
        if not live:
            return
        evicted = self.replicas[self.replica_ids.index(name)].evict_all()
        # adopt() pushes at the queue head: reversed keeps the evicted
        # order (requeued in-flight first, then the queue) on each target.
        for req in reversed(evicted):
            target = min(live, key=lambda i: self.replicas[i].load())
            self.replicas[target].adopt(req)

    def undrain_slice(self, name: str) -> None:
        with self._lock:
            self._drained.discard(str(name))

    def drained_slices(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._drained))

    # -- shared-surface passthroughs ----------------------------------------

    @property
    def paged(self) -> bool:
        return self.replicas[0].paged

    @property
    def params(self) -> dict:
        return self.replicas[0].params

    @property
    def prefix_cache(self):
        return self.replicas[0].prefix_cache

    @property
    def reporter(self):
        return self.replicas[0].reporter

    @reporter.setter
    def reporter(self, value) -> None:
        for eng in self.replicas:
            eng.reporter = value

    @property
    def tokens_total(self) -> int:
        return sum(e.tokens_total for e in self.replicas)

    @property
    def requests_total(self) -> int:
        return sum(e.requests_total for e in self.replicas)

    @property
    def completed_total(self) -> int:
        return sum(e.completed_total for e in self.replicas)

    @property
    def rejected_total(self) -> int:
        return self.router_rejected + sum(
            e.rejected_total for e in self.replicas)

    @property
    def requeued_total(self) -> int:
        return sum(e.requeued_total for e in self.replicas)

    # -- metrics ------------------------------------------------------------

    def metrics_text(self) -> str:
        """One merged /metrics page for the mesh — fleet counters summed,
        latency quantiles over every replica's recent window — plus the
        ``tpumon_serving_replica_*`` family per replica."""
        snaps = [eng._stats_snapshot() for eng in self.replicas]
        rows = []
        for name, snap in zip(self.replica_ids, snaps):
            tq = quantiles(snap["ttft_recent"])
            pq = quantiles(snap["tpot_recent"])
            rows.append((name, snap["free"], snap["queue"],
                         None if tq is None else tq[1] * 1e3,
                         None if pq is None else pq[1] * 1e3))
        merged = _merge_serving_snapshots(snaps)
        with self._lock:
            merged["rejected"] += self.router_rejected
        return _render_serving_metrics(merged, replica_rows=rows)


def make_serving_engine(cfg: ServeConfig | None = None, **kw):
    """The engine the config asks for: a MeshServingEngine when
    mesh_dp×mesh_tp describes a real mesh, a plain ServingEngine
    otherwise (``devices`` dropped, ``device`` kept)."""
    cfg = cfg or default_engine_config()
    if cfg.mesh_dp * cfg.mesh_tp > 1:
        return MeshServingEngine(cfg=cfg, **kw)
    kw.pop("devices", None)
    return ServingEngine(cfg=cfg, **kw)


# ---------------------------------------------------------------------------
# /metrics HTTP endpoint + arrival loop
# ---------------------------------------------------------------------------


def start_metrics_server(engine: ServingEngine, port: int = 0,
                         host: str = "127.0.0.1"):
    """Serve /metrics and /generate; returns (server, port).

    /generate is the inference API (the engine loop must be running —
    the arrival loop or any thread calling step()):
      GET /generate?prompt=1,2,3&max_new=8            → JSON when done
      GET /generate?prompt=1,2,3&max_new=8&stream=1   → SSE, one
          ``data: <token>`` event per token as it is emitted, then
          ``event: done``.
    ``temperature``, ``top_k`` and ``stop`` (comma-separated token ids)
    are optional query parameters. Runs in a daemon thread; call
    server.shutdown() THEN server.server_close() to stop."""
    import json as _json
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            path, _, query = self.path.partition("?")
            if path == "/metrics":
                self._send(200, engine.metrics_text().encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/generate":
                self._generate(urllib.parse.parse_qs(query))
            else:
                self.send_error(404)

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _generate(self, q):
            try:
                prompt = [int(t) for t in q["prompt"][0].split(",") if t]
                max_new = int(q.get("max_new", ["16"])[0])
                temp = float(q.get("temperature", ["0"])[0])
                top_k = int(q.get("top_k", ["0"])[0])
                stops = tuple(
                    int(t) for t in q.get("stop", [""])[0].split(",") if t)
            except (KeyError, ValueError):
                self._send(400, b'{"error": "bad prompt/max_new"}',
                           "application/json")
                return
            streaming = q.get("stream", ["0"])[0] not in ("0", "")
            req = engine.submit(prompt, max_new=max_new, temperature=temp,
                                top_k=top_k, stream=streaming,
                                stop_tokens=stops)
            if req.done.is_set() and not req.output:
                # Queue-full backpressure must be visible to clients.
                self._send(429, b'{"error": "queue full"}',
                           "application/json")
                return
            if not streaming:
                if not req.done.wait(timeout=60):
                    req.cancel()  # stop generating for a timed-out call
                    self._send(504, b'{"error": "timeout"}',
                               "application/json")
                    return
                body = _json.dumps({
                    "rid": req.rid, "tokens": req.output,
                    "ttft_ms": None if req.ttft_s is None
                    else req.ttft_s * 1e3,
                }).encode()
                self._send(200, body, "application/json")
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                while True:
                    try:
                        tok = req.stream.get(timeout=60)
                    except queue.Empty:
                        self.wfile.write(
                            b'event: error\ndata: {"error": "stalled"}'
                            b"\n\n")
                        self.wfile.flush()
                        req.cancel()
                        return
                    if tok is None:
                        self.wfile.write(b"event: done\ndata: {}\n\n")
                        self.wfile.flush()
                        return
                    self.wfile.write(f"data: {tok}\n\n".encode())
                    self.wfile.flush()
            except OSError:
                # Client went away: cancel so the engine frees the slot
                # instead of generating into a dead socket.
                req.cancel()
                return

        def log_message(self, *a):  # quiet
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


@dataclass
class ArrivalSource:
    """One Poisson arrival process for ``ArrivalPump``: ``rate(rel_t)``
    arrivals/sec (<= 0 pauses), ``fire(rel_t)`` submits one request,
    ``interval(rate)`` draws the next gap in seconds."""

    rate: object  # Callable[[float], float]
    fire: object  # Callable[[float], None]
    interval: object  # Callable[[float], float]
    next_at: float = 0.0  # absolute monotonic due time (pump-owned)
    paused: bool = False  # rate() was <= 0 last pass (pump-owned)


class ArrivalPump:
    """Drain every source's due arrivals, step the engine, and sleep
    only while idle (the reference's pump, unchanged)."""

    def __init__(self, engine: ServingEngine,
                 sources: "list[ArrivalSource]", step=None):
        self.engine = engine
        self.sources = list(sources)
        self.step = step if step is not None else engine.step

    def run(self, stop: threading.Event, duration: float = 0.0) -> None:
        t0 = time.monotonic()
        for s in self.sources:
            s.next_at = t0
        while not stop.is_set():
            now = time.monotonic()
            rel = now - t0
            if duration and rel >= duration:
                return
            for s in self.sources:
                while True:
                    rate = s.rate(rel)
                    if rate <= 0:
                        s.paused = True
                        break
                    if s.paused:
                        # Re-anchor so a pause produces zero arrivals.
                        s.paused = False
                        s.next_at = max(s.next_at, now)
                    if now < s.next_at:
                        break
                    s.fire(rel)
                    s.next_at += s.interval(rate)
            if not self.step():
                waits = [
                    max(0.0, s.next_at - now)
                    for s in self.sources if s.rate(rel) > 0
                ]
                time.sleep(0.05 if not waits else min(0.05, min(waits)))


def _arrival_loop(engine: ServingEngine, rps: float, max_new: int,
                  stop: threading.Event, duration: float = 0.0,
                  seed: int = 0, temperature: float = 0.0,
                  top_k: int = 0) -> None:
    """Poisson-ish synthetic request arrivals + engine stepping until
    ``stop`` is set (or ``duration`` seconds elapse, if nonzero). With a
    prefix cache every prompt starts with the same two-chunk system
    prompt, so the cache hits. The RNG draw order per arrival (prompt
    length, tail tokens, then the exponential gap) is the reference's, so
    seeded runs replay the same prompts."""
    import random

    rng = random.Random(seed)
    shared: list[int] = []
    if engine.prefix_cache is not None:
        srng = random.Random(seed ^ 0x5A5)
        shared = [srng.randrange(engine.cfg.model.vocab)
                  for _ in range(2 * engine.cfg.prefill_len)]

    def fire(_rel: float) -> None:
        n = rng.randint(2, engine.cfg.prefill_len)
        tail = [rng.randrange(engine.cfg.model.vocab) for _ in range(n)]
        engine.submit(shared + tail, max_new=max_new,
                      temperature=temperature, top_k=top_k)

    src = ArrivalSource(rate=lambda _t: rps, fire=fire,
                        interval=rng.expovariate)
    ArrivalPump(engine, [src]).run(stop, duration=duration)


class BackgroundStop(threading.Event):
    """The stop event ``start_background`` returns: ``set()`` ends the
    arrival loop, and ``join()`` waits until it has ended and closed the
    /metrics listener, so the caller can exit with no engine step still
    running in the daemon thread (one torch op running while the
    interpreter exits aborts the process)."""

    def __init__(self):
        super().__init__()
        self.thread: threading.Thread | None = None

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the loop's thread; True once it has ended."""
        if self.thread is not None:
            self.thread.join(timeout)
        return self.thread is None or not self.thread.is_alive()


def start_background(rps: float = 0.5, max_new: int = 16,
                     cfg: ServeConfig | None = None, port: int = 0,
                     seed: int = 0, ckpt_dir: str | None = None,
                     quantize: str | None = None,
                     spec_len: int = 0, prefix_cache: int = 0,
                     kv_layout: str = "dense", pool_pages: int = 0,
                     decode_block: int = 1, kv_dtype: str = "compute",
                     paged_attn: str = "gather",
                     spec_source: str = "draft",
                     scheduler: str = "interleaved",
                     prefill_budget: int = 1,
                     admit_lookahead: int = 0,
                     mesh_dp: int = 1, mesh_tp: int = 1,
                     ring_stripes: int = 0, device=None):
    """Run the serving loadgen inside this process: the arrival loop in a
    daemon thread + the /metrics endpoint. Returns (engine, url,
    stop_event); setting the event ends the loop and closes the listener,
    and its ``join()`` waits for that (``BackgroundStop``). The
    reference's signature, plus ``device`` (as for ``ServingEngine``; a
    mesh spreads over ``visible_devices(device)``). mesh_dp×mesh_tp > 1
    builds a MeshServingEngine (``make_serving_engine``)."""
    if cfg is None and (spec_len or prefix_cache or pool_pages
                        or kv_layout != "dense" or decode_block != 1
                        or kv_dtype != "compute"
                        or paged_attn != "gather"
                        or spec_source != "draft"
                        or scheduler != "interleaved"
                        or prefill_budget != 1
                        or admit_lookahead != 0
                        or mesh_dp != 1 or mesh_tp != 1
                        or ring_stripes != 0):
        # Keep the checkpoint-architecture adoption the engine would do
        # for a bare ckpt_dir.
        base = None
        if ckpt_dir:
            saved = saved_model_config(ckpt_dir)
            if saved is not None:
                base = ServeConfig(model=saved, slots=4,
                                   prefill_len=min(16, saved.max_seq // 2))
        cfg = dc_replace(
            base or default_engine_config(), spec_len=spec_len,
            prefix_cache_entries=prefix_cache,
            kv_layout=kv_layout, pool_pages=pool_pages,
            decode_block=decode_block, kv_dtype=kv_dtype,
            paged_attn=paged_attn, spec_source=spec_source,
            scheduler=scheduler, prefill_chunk_budget=prefill_budget,
            admit_lookahead=admit_lookahead,
            mesh_dp=mesh_dp, mesh_tp=mesh_tp, ring_stripes=ring_stripes)
    engine = make_serving_engine(cfg=cfg, ckpt_dir=ckpt_dir,
                                 quantize=quantize, device=device)
    server, bound = start_metrics_server(engine, port=port)
    stop = BackgroundStop()

    def _run():
        try:
            _arrival_loop(engine, rps, max_new, stop, seed=seed)
        finally:
            server.shutdown()
            server.server_close()

    stop.thread = threading.Thread(target=_run, daemon=True)
    stop.thread.start()
    return engine, f"http://127.0.0.1:{bound}/metrics", stop


def main(argv: list[str] | None = None) -> int:
    """``python -m tpumon_torch.loadgen.serving`` — run the serving
    loadgen on the GPU: synthetic request arrivals + /metrics for tpumon
    to scrape. Same flags and defaults as ``python -m
    tpumon.loadgen.serving`` (dense layout, gather read path, the
    workload self-report on), plus ``--device``; ``--mesh DP,TP`` spreads
    over every visible device of ``--device``'s kind."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--port", type=int, default=9105)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--quant", choices=["int8"], default=None,
                    help="weight-only quantization "
                         "(tpumon_torch.loadgen.quant)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling cutoff (0 = full vocab)")
    ap.add_argument("--rps", type=float, default=2.0,
                    help="synthetic request arrival rate")
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--duration", type=float, default=0.0,
                    help="seconds to run; 0 = forever")
    ap.add_argument("--spec-len", type=int, default=0,
                    help="speculative decoding: draft tokens per round "
                         "(0 = off)")
    ap.add_argument("--spec-draft-layers", type=int, default=0,
                    help="draft model layer count (0 = self-speculation: "
                         "the draft shares the target weights)")
    ap.add_argument("--spec-source", choices=["draft", "prompt"],
                    default="draft",
                    help="'prompt': n-gram prompt-lookup proposals from "
                         "the request's own context, no draft model")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="prompt-prefix KV cache LRU entries (0 = off)")
    ap.add_argument("--kv-dtype", choices=["compute", "int8"],
                    default="compute",
                    help="KV cache element type; int8 halves the resident "
                         "cache (dense cache or paged pool, gather read)")
    ap.add_argument("--decode-block", type=int, default=1,
                    help="fuse N plain-decode steps into one block with "
                         "one device->host sync (dense or paged KV; "
                         "1 = off)")
    ap.add_argument("--kv-layout", choices=["dense", "paged"],
                    default="dense",
                    help="paged: per-request page reservation from a "
                         "shared pool instead of slots*max_seq rows")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="paged pool size in pages (0 = dense "
                         "equivalent; smaller = real memory savings "
                         "with admission backpressure)")
    ap.add_argument("--paged-attn", choices=["gather", "kernel", "ring"],
                    default="gather",
                    help="paged decode read path: the plain torch gather, "
                         "the hand-written CUDA paged-attention kernel, or "
                         "blockwise ring attention paging KV page by page "
                         "(long-context ring layouts)")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="serve over a dp×tp device mesh: DP "
                         "data-parallel replicas behind the affinity "
                         "router, each tensor-parallel over TP devices")
    ap.add_argument("--ring-attn", type=int, default=0, metavar="N",
                    help="ring-attention engine mode: admit prompts up "
                         "to N x max_seq by paging KV block-wise "
                         "(requires --kv-layout paged; 0 = off)")
    ap.add_argument("--scheduler", choices=["interleaved", "sequential"],
                    default="interleaved",
                    help="admission scheduler: interleaved chunked "
                         "prefill or the sequential stop-the-world "
                         "baseline")
    ap.add_argument("--prefill-budget", type=int, default=1,
                    help="prefill chunk dispatches per engine step "
                         "under the interleaved scheduler")
    ap.add_argument("--admit-lookahead", type=int, default=0,
                    help="paged admission: probe this many requests "
                         "behind a page-blocked queue head (0 = strict "
                         "FIFO)")
    ap.add_argument("--experts", type=int, default=0,
                    help="serve the MoE model family: this many "
                         "top-1-routed experts per layer (0 = dense; "
                         "full-capacity routing in serving so every "
                         "decode mode stays token-identical)")
    ap.add_argument("--no-report", action="store_true",
                    help="disable the workload self-report (HBM "
                         "footprint + activity to the monitor's "
                         "source:workload channel)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises when no "
                         "GPU is present)")
    args = ap.parse_args(argv)
    if args.spec_draft_layers and not args.spec_len:
        ap.error("--spec-draft-layers requires --spec-len > 0")
    if args.spec_source == "prompt" and args.spec_draft_layers:
        ap.error("--spec-source prompt proposes from context; drop "
                 "--spec-draft-layers")
    if args.spec_source == "prompt" and not args.spec_len:
        ap.error("--spec-source prompt requires --spec-len > 0 "
                 "(speculation is otherwise off and the flag would "
                 "silently do nothing)")
    if args.spec_draft_layers >= 4:  # the CLI model's n_layers below
        ap.error("--spec-draft-layers must be < 4 (the target's depth)")
    if args.spec_len < 0:
        ap.error("--spec-len must be >= 0")
    if args.pool_pages and args.kv_layout != "paged":
        ap.error("--pool-pages requires --kv-layout paged")
    if args.prefill_budget < 1:
        ap.error("--prefill-budget must be >= 1")
    if args.admit_lookahead and args.kv_layout != "paged":
        ap.error("--admit-lookahead requires --kv-layout paged (dense "
                 "admission never blocks on pages)")
    if args.paged_attn == "kernel" and (
            args.kv_layout != "paged" or args.kv_dtype == "int8"):
        ap.error("--paged-attn kernel requires --kv-layout paged with "
                 "--kv-dtype compute (the kernel reads bf16/f32 pages)")
    mesh_dp = mesh_tp = 1
    if args.mesh is not None:
        try:
            mesh_dp, mesh_tp = (int(x) for x in args.mesh.split(","))
        except ValueError:
            ap.error(f"--mesh wants DP,TP (two integers), got "
                     f"{args.mesh!r}")
        if mesh_dp < 1 or mesh_tp < 1:
            ap.error(f"--mesh shape must be >= 1,1, got {args.mesh}")
    if args.ring_attn and args.ring_attn < 2:
        ap.error("--ring-attn N needs N >= 2 stripes (1 stripe IS the "
                 "flat layout; pass 0 to disable)")
    if args.ring_attn and args.kv_layout != "paged":
        ap.error("--ring-attn requires --kv-layout paged (the ring "
                 "pages KV block-wise; a dense cache has no pages)")

    model = ModelConfig(vocab=2048, d_model=256, n_layers=4, n_heads=8,
                        n_kv_heads=4, d_ff=1024, max_seq=256,
                        n_experts=args.experts)
    draft = (dc_replace(model, n_layers=args.spec_draft_layers)
             if args.spec_draft_layers else None)
    try:
        engine = make_serving_engine(cfg=ServeConfig(
            model=model, slots=args.slots, prefill_len=32,
            quantize=args.quant, spec_len=args.spec_len, draft_model=draft,
            spec_source=args.spec_source,
            prefix_cache_entries=args.prefix_cache, kv_dtype=args.kv_dtype,
            kv_layout=args.kv_layout, pool_pages=args.pool_pages,
            decode_block=args.decode_block, paged_attn=args.paged_attn,
            scheduler=args.scheduler,
            prefill_chunk_budget=args.prefill_budget,
            admit_lookahead=args.admit_lookahead,
            mesh_dp=mesh_dp, mesh_tp=mesh_tp, ring_stripes=args.ring_attn,
        ), device=args.device)
    except ValueError as e:
        # Mesh shapes that do not divide the device count, ring modes
        # that do not compose: config errors, reported as such.
        ap.error(str(e))
    server, port = start_metrics_server(engine, args.port)
    print(f"serving loadgen: /metrics on :{port} "
          f"(point TPUMON_SERVING_TARGETS=http://127.0.0.1:{port}/metrics)",
          flush=True)
    reporter = None
    if not args.no_report:
        from tpumon_torch.loadgen.report import WorkloadReporter

        reporter = WorkloadReporter(name="serve").start()
        engine.reporter = reporter
    try:
        _arrival_loop(engine, args.rps, args.max_new, threading.Event(),
                      duration=args.duration, temperature=args.temperature,
                      top_k=args.top_k)
    except KeyboardInterrupt:
        pass
    finally:
        if reporter is not None:
            reporter.stop()
        server.shutdown()
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
