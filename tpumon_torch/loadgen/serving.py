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
backpressure, per-tenant accounting, serving a trainer checkpoint
(``ckpt_dir``), the /metrics + /generate server and the arrival loop. The
defaults are the reference's: ``kv_layout="dense"``,
``paged_attn="gather"``. Everything else the reference engine does
(speculative decoding, prefix caching, int8 weights and KV, MoE, the mesh
engine, the actuator verbs) raises "not yet ported" when asked for
(ROADMAP queue 1).

Host-mirror discipline as in the reference: positions are mirrored on the
host, so a decode step (or a fused block of ``decode_block`` steps) costs
exactly ONE device→host sync (the sampled tokens' ``.tolist()``).
"""

from __future__ import annotations

import itertools
import queue
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from tpumon_torch import prng
from tpumon_torch.loadgen.checkpoint import (
    restore_checkpoint,
    saved_model_config,
)
from tpumon_torch.loadgen.model import (
    ModelConfig,
    _rms_norm,
    init_params,
    map_params,
    param_bytes,
    resolve_device,
)
from tpumon_torch.loadgen.paged_kv import (
    PageAllocator,
    init_pool,
    paged_decode_rounds,
    paged_decode_step,
    paged_prefill,
)
from tpumon_torch.metrics_text import MetricsWriter
from tpumon_torch.ops import threefry
from tpumon_torch.tracing import quantiles

# TTFT histogram bucket upper bounds, seconds (JetStream buckets are
# seconds; the serving distiller converts quantiles to ms).
TTFT_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)


@dataclass(frozen=True)
class ServeConfig:
    """The reference's ServeConfig, field for field, with its defaults;
    the engine raises "not yet ported" when a field outside the port is
    set (``_check_ported``)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    slots: int = 4  # concurrent decode slots (continuous batching)
    prefill_len: int = 64  # static prompt padding length == page size
    moe_prefill_max_chunk: int = 256
    quantize: str | None = None
    spec_len: int = 0
    draft_model: ModelConfig | None = None
    spec_source: str = "draft"
    spec_ngram_window: int = 1024
    prefix_cache_entries: int = 0
    # KV layout: "dense" reserves slots*max_seq rows (init_cache);
    # "paged" reserves prefill_len-row pages per request from a shared
    # pool (tpumon_torch.loadgen.paged_kv).
    kv_layout: str = "dense"
    pool_pages: int = 0  # 0 = the dense equivalent, slots*max_pages + 1
    # Paged decode read path: "gather" (plain torch: gather the table's
    # pages, attend densely) or "kernel" (tpumon_torch.ops.paged_attention,
    # the CUDA kernel on a GPU; its plain version on the CPU).
    paged_attn: str = "gather"
    # Fused plain decode: this many (decode step -> sample) pairs per
    # engine step with one device→host sync (decode_rounds /
    # paged_decode_rounds); 1 = off.
    decode_block: int = 1
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
    mesh_dp: int = 1
    mesh_tp: int = 1
    ring_stripes: int = 0


# (field, the value the port serves, the ROADMAP item that ports the rest)
_NOT_PORTED = (
    ("quantize", None, "queue 1 item 8"),
    ("spec_len", 0, "queue 1 item 8"),
    ("draft_model", None, "queue 1 item 8"),
    ("spec_source", "draft", "queue 1 item 8"),
    ("prefix_cache_entries", 0, "queue 1 item 8"),
    ("kv_dtype", "compute", "queue 1 item 8"),
    ("mesh_dp", 1, "queue 1 item 12"),
    ("mesh_tp", 1, "queue 1 item 12"),
    ("ring_stripes", 0, "queue 1 item 12"),
)


def _check_ported(cfg: ServeConfig) -> None:
    for name, supported, item in _NOT_PORTED:
        got = getattr(cfg, name)
        if got != supported:
            raise NotImplementedError(
                f"ServeConfig.{name}={got!r} is not yet ported (ROADMAP "
                f"{item}); the port serves {name}={supported!r}")
    if cfg.paged_attn == "ring":
        raise NotImplementedError(
            "paged_attn='ring' is not yet ported (ROADMAP queue 1 item 12)")


def default_engine_config() -> ServeConfig:
    """The small demo model an engine runs when no config is given."""
    return ServeConfig(
        model=ModelConfig(vocab=512, d_model=128, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=256, max_seq=128),
        slots=4, prefill_len=16,
    )


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
    ``paged_attn="kernel"`` path; ``mask`` is then unused — the kernel
    masks by sequence length).
    """
    m = cfg.model
    dt = m.torch_dtype
    nh, nkv, hd = m.n_heads, m.n_kv_heads, m.head_dim
    b, t = tokens.shape
    x = params["embed"].to(dt)[tokens.long()]  # [B, T, D]
    for li, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["attn_norm"])
        q = _rope_at((h @ layer["wq"].to(dt)).reshape(b, t, nh, hd),
                     pos, m.rope_theta)
        k = _rope_at((h @ layer["wk"].to(dt)).reshape(b, t, nkv, hd),
                     pos, m.rope_theta)
        v = (h @ layer["wv"].to(dt)).reshape(b, t, nkv, hd)
        if attend is not None:
            att = attend(li, q, k, v).reshape(b, t, nh * hd)
        else:
            ck, cv = kv_update(li, k, v)
            kr, vr = _gqa_repeat(ck, nh), _gqa_repeat(cv, nh)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, kr).float()
            scores = scores / (hd**0.5)
            scores = torch.where(mask, scores, -1e30)
            probs = torch.softmax(scores, dim=-1).to(dt)
            att = torch.einsum(
                "bhqk,bkhd->bqhd", probs, vr).reshape(b, t, nh * hd)
        x = x + att @ layer["wo"].to(dt)
        hm = _rms_norm(x, layer["mlp_norm"])
        gate = F.silu(hm @ layer["w_gate"].to(dt))
        x = x + (gate * (hm @ layer["w_up"].to(dt))) @ layer["w_down"].to(dt)
    return _rms_norm(x, params["final_norm"])


def init_cache(cfg: ServeConfig, device) -> dict:
    """The dense KV cache ``{"k", "v"}``, each ``[layers, slots, max_seq,
    kv_heads, head_dim]`` in the compute dtype, zeroed, on ``device``."""
    if cfg.kv_dtype != "compute":
        raise NotImplementedError(
            "the int8 KV cache is not yet ported (ROADMAP queue 1 item 8)")
    m = cfg.model
    shape = (m.n_layers, cfg.slots, m.max_seq, m.n_kv_heads, m.head_dim)
    return {"k": torch.zeros(shape, dtype=m.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=m.torch_dtype, device=device)}


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

    def kv_update(li, k, v):
        cache["k"][li, slot, s0:s0 + p] = k[0]
        cache["v"][li, slot, s0:s0 + p] = v[0]
        return cache["k"][li, slot][None], cache["v"][li, slot][None]

    x = decoder_forward(cfg, params, tokens[None], pos, mask, kv_update)
    return (x[0, length - 1] @ params["lm_head"].to(m.torch_dtype)).float()


def decode_step(cfg: ServeConfig, params: dict, cache: dict,
                last_tokens: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Advance every slot one token over the dense cache (in place):
    last_tokens/positions [B] int32, B == slots; returns the f32 logits
    [B, vocab]. The T == 1 case of ``speculative.decode_block``."""
    from tpumon_torch.loadgen.speculative import decode_block

    return decode_block(cfg, params, cache, last_tokens[:, None],
                        positions)[:, 0]


def decode_rounds(cfg: ServeConfig, params: dict, cache: dict,
                  last_tokens: torch.Tensor, positions: torch.Tensor,
                  base_key: torch.Tensor, rids: torch.Tensor,
                  ctr0: torch.Tensor, temps: torch.Tensor,
                  topks: torch.Tensor, steps: int) -> tuple:
    """``steps`` (decode_step -> sample_tokens) pairs over the dense cache
    with no host sync: rids [B] and ctr0 [B] carry each request's (id,
    next token index), the index advancing by one a step, so the block
    emits the per-step stream. Positions clamp at max_seq - 1. Returns
    (last tokens, positions, tokens [B, steps] in emission order)."""
    out = []
    last, pos, ctr = last_tokens, positions, ctr0
    for _ in range(steps):
        logits = decode_step(cfg, params, cache, last, pos)
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
    # engine: "completed" | "rejected" | "cancelled" ("" in flight).
    status: str = ""
    ttft_s: float | None = None
    first_tok_t: float | None = None  # monotonic at first emit (TPOT)
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
            if self.stream is not None:
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
    shed: int = 0  # admission sheds: the actuator verbs are not yet ported
    tokens: int = 0
    ttft: deque = field(default_factory=lambda: deque(maxlen=512))
    tpot: deque = field(default_factory=lambda: deque(maxlen=512))


@dataclass
class _PrefillWork:
    """Per-slot chunked-prefill progress: which chunk runs next, the
    slot's page reservation and table (paged), and the final chunk's
    logits. A slot holding one is occupied but not yet decoding."""

    req: Request
    n: int                      # prompt length (tokens)
    next_c0: int                # next chunk's start row
    logits: torch.Tensor | None = None   # final-chunk logits
    pages: list[int] | None = None       # paged: full reservation
    table_row: torch.Tensor | None = None  # paged: this slot's table


class ServingEngine:
    """Continuous-batching engine over the dense KV cache or the paged KV
    pool: submit() from any thread, step() (or the arrival loop) drives
    prefill/decode; /metrics-ready exposition from metrics_text()."""

    def __init__(self, cfg: ServeConfig | None = None,
                 params: dict | None = None, seed: int = 0,
                 max_queue: int = 64, ckpt_dir: str | None = None,
                 device=None):
        if cfg is None and ckpt_dir:
            # No explicit config: adopt the checkpoint's own architecture,
            # so the engine serves the trained weights instead of falling
            # back to a mismatched default init.
            saved = saved_model_config(ckpt_dir)
            if saved is not None:
                cfg = ServeConfig(model=saved, slots=4,
                                  prefill_len=min(16, saved.max_seq // 2))
        self.cfg = cfg or default_engine_config()
        _check_ported(self.cfg)
        if self.cfg.kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {self.cfg.kv_layout!r}")
        if self.cfg.pool_pages and self.cfg.kv_layout != "paged":
            raise ValueError(
                "pool_pages requires kv_layout='paged' (a dense cache "
                "has no page pool to size)")
        if self.cfg.decode_block < 1:
            raise ValueError(
                f"decode_block must be >= 1, got {self.cfg.decode_block}")
        if self.cfg.paged_attn not in ("gather", "kernel"):
            raise ValueError(f"unknown paged_attn {self.cfg.paged_attn!r}")
        if self.cfg.paged_attn == "kernel" and self.cfg.kv_layout != "paged":
            raise ValueError(
                "paged_attn='kernel' requires kv_layout='paged' (the "
                "kernel reads pages)")
        if self.cfg.scheduler not in ("interleaved", "sequential"):
            raise ValueError(f"unknown scheduler {self.cfg.scheduler!r}")
        if self.cfg.prefill_chunk_budget < 1:
            raise ValueError(
                f"prefill_chunk_budget must be >= 1, got "
                f"{self.cfg.prefill_chunk_budget}")
        if self.cfg.admit_lookahead < 0:
            raise ValueError(
                f"admit_lookahead must be >= 0, got "
                f"{self.cfg.admit_lookahead}")
        if self.cfg.admit_lookahead and self.cfg.kv_layout != "paged":
            raise ValueError(
                "admit_lookahead requires kv_layout='paged' (dense "
                "admission never blocks on pages)")
        if self.cfg.admit_max_skips < 1:
            raise ValueError(
                f"admit_max_skips must be >= 1, got "
                f"{self.cfg.admit_max_skips}")
        self.device = resolve_device(device)
        m = self.cfg.model
        dev = self.device
        self._seq_cap = m.max_seq
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
        # Weights are cast to the compute dtype once, here — the same
        # values the reference's per-call ``.astype(dt)`` produces — so
        # the weight_bytes gauge reports what is actually resident.
        self.params = map_params(
            params, lambda t: t.to(device=dev, dtype=m.torch_dtype))
        self.paged = self.cfg.kv_layout == "paged"
        self.cache = None
        if self.paged:
            p = self.cfg.prefill_len
            self._max_pages = -(-self._seq_cap // p)
            pool_pages = self.cfg.pool_pages or (
                self.cfg.slots * self._max_pages + 1)
            if pool_pages < 2:
                raise ValueError("pool_pages must be >= 2")
            self.pool = init_pool(self.cfg, pool_pages, dev)
            self.allocator = PageAllocator(pool_pages)
            # Page 0 is the permanent trash page: freed and mid-prefill
            # slots' tables point at it so their garbage batched-decode
            # writes can never corrupt pages reallocated to live requests.
            trash = self.allocator.alloc(1)
            assert trash == [0]
            self._slot_pages: list[list[int]] = [
                [] for _ in range(self.cfg.slots)]
            self._tables_host = [
                [0] * self._max_pages for _ in range(self.cfg.slots)]
            self._tables_dev = torch.zeros(
                (self.cfg.slots, self._max_pages), dtype=torch.int32,
                device=dev)
            self._tables_dirty = False
        else:
            self.cache = init_cache(self.cfg, dev)
        slots = self.cfg.slots
        self.positions = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._host_positions = [0] * slots  # mirror, avoids syncs
        self.last_tokens = torch.zeros((slots,), dtype=torch.int32,
                                       device=dev)
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
        self._ttft_counts = [0] * len(TTFT_BUCKETS_S)
        self._ttft_inf = 0
        self._ttft_sum = 0.0
        self._ttft_recent: deque[float] = deque(maxlen=512)
        self._tpot_recent: deque[float] = deque(maxlen=512)
        self.tenants: dict[str, _TenantStats] = {}
        self.tenant_window_s = 60.0

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
        """Enqueue a request. When the queue is full, or the prompt is
        over the sequence capacity (max_seq-1 rows), or (paged) its page
        reservation could never fit the pool, the request is rejected
        immediately (status="rejected", done set, output empty).
        temperature 0 = greedy; top_k 0 = the whole vocab."""
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
            self._tables_dev = self._h2d(self._tables_host)
            self._tables_dirty = False

    def _reserve_next_locked(self) -> tuple[Request, list] | None:
        """Pick the next admissible queued request (caller holds the
        lock; paged only): probe the head, then — bounded lookahead — up to
        ``admit_lookahead`` requests behind it, admitting the first whose
        page reservation succeeds. Every queue-jump past a blocked head
        bumps ``_head_skips``; at ``admit_max_skips`` the window
        collapses to the head alone until it admits. Returns (request,
        pages) or None when nothing fits."""
        if self._queue[0].rid != self._head_rid:
            self._head_rid = self._queue[0].rid
            self._head_skips = 0
        aged_out = self._head_skips >= self.cfg.admit_max_skips
        window = 1 if aged_out else 1 + self.cfg.admit_lookahead
        for i, cand in enumerate(self._queue):
            if i >= window:
                break
            pages = self.allocator.alloc(self._pages_needed(cand))
            if pages is None:
                continue
            if i == 0:
                self._queue.popleft()
                self._head_skips = 0
            else:
                del self._queue[i]
                self._head_skips += 1
            return cand, pages
        return None

    def _admit(self) -> None:
        """Assign queued requests to free slots (paged: reserving pages);
        the prefill chunks themselves run in ``_prefill_tick``, or inline
        under ``scheduler="sequential"``."""
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
                    req, pages = picked
                else:
                    req, pages = self._queue.popleft(), None
            self._assign_slot(slot, req, pages)
            if self.cfg.scheduler == "sequential":
                self._drain_prefill_slot(slot)

    def _assign_slot(self, slot: int, req: Request,
                     pages: list | None) -> None:
        """Install ``req`` into ``slot`` in the in-prefill state: page
        table (paged), prefill work record, and the parking of the slot's
        position."""
        work = _PrefillWork(req=req, n=len(req.prompt), next_c0=0,
                            pages=pages)
        if self.paged:
            self._slot_pages[slot] = pages
            trow = self._tables_host[slot]
            for i in range(self._max_pages):
                trow[i] = pages[i] if i < len(pages) else 0
            self._tables_dirty = True
            work.table_row = self._h2d(trow)
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
        """One prefill chunk for ``slot``; completing the last chunk
        samples the first token and flips the slot to decoding."""
        work = self._prefill_work[slot]
        req = work.req
        p = self.cfg.prefill_len
        c0 = work.next_c0
        chunk = req.prompt[c0:c0 + p]
        ln = len(chunk)
        toks = self._h2d(chunk + [0] * (p - ln))
        if self.paged:
            work.logits = paged_prefill(
                self.cfg, self.params, self.pool, toks, ln,
                work.pages[c0 // p], work.table_row, c0)
        else:
            work.logits = prefill(self.cfg, self.params, self.cache, toks,
                                  ln, slot, c0)
        work.next_c0 = c0 + p
        if work.next_c0 < work.n:
            return
        self._prefill_work[slot] = None
        self._after_prefill(slot, req, work.n, work.logits)

    def _after_prefill(self, slot: int, req: Request, n: int,
                       logits: torch.Tensor) -> None:
        """Sample the first token (index 0 of the request's stream, keyed
        by its rid) and install the request for decoding."""
        dev = self.device
        first = int(sample_tokens(
            logits[None], self._sample_key, self._h2d([req.rid]),
            torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.tensor([req.temperature]).to(dev, non_blocking=True),
            self._h2d([req.top_k]))[0])
        now = time.monotonic()
        with self._lock:
            req.ttft_s = now - req.enqueued
            req.first_tok_t = now
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
        """Admit + prefill tick + one decode step; returns True if any
        work remains."""
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
        self._prefill_tick()
        # Decode batch: slots mid-prefill are excluded (the batched step
        # computes them as garbage the host ignores, like free slots).
        active = [s for s in range(self.cfg.slots)
                  if self._slots[s] is not None
                  and self._prefill_work[s] is None]
        if active:
            self._plain_step(active)
        with self._lock:
            pending = bool(self._queue)
        return pending or any(s is not None for s in self._slots)

    def _plain_step(self, active: list[int]) -> None:
        # Fused block decode when configured and every active slot has
        # cache room for the whole block (else the single step below).
        n = self.cfg.decode_block
        if n > 1 and all(self._host_positions[s] <= self._seq_cap - 1 - n
                         for s in active):
            self._block_step(active, n)
            return
        if self.paged:
            self._sync_tables()
            logits = paged_decode_step(
                self.cfg, self.params, self.pool, self.last_tokens,
                self.positions, self._tables_dev)
        else:
            logits = decode_step(self.cfg, self.params, self.cache,
                                 self.last_tokens, self.positions)
        nxt = sample_tokens(logits, self._sample_key, self.rids,
                            self.tok_ctrs, self.temps, self.topks)
        self.tok_ctrs = self.tok_ctrs + 1
        self.last_tokens = nxt
        self.positions = torch.clamp(self.positions + 1,
                                     max=self._seq_cap - 1)
        # ONE device→host sync per step; positions tracked host-side.
        nxt_host = nxt.tolist()
        with self._lock:
            self.decode_steps_total += 1
            self.tokens_total += len(active)
        for slot in active:
            req = self._slots[slot]
            req.emit([nxt_host[slot]])
            self._host_positions[slot] = min(
                self._host_positions[slot] + 1, self._seq_cap - 1)
            if (len(req.output) >= req.max_new + 1
                    or req.hit_stop()
                    or self._host_positions[slot] >= self._seq_cap - 1):
                self._complete(slot)

    def _block_step(self, active: list[int], n: int) -> None:
        """One fused block of n decode steps and samples (decode_rounds or
        paged_decode_rounds), ONE device→host sync. Each slot's tokens
        replay in order up to its own stop; tokens generated past it are
        discarded (the block-decode trade), and their sampling indices are
        never used again by that request."""
        if self.paged:
            self._sync_tables()
            self.last_tokens, self.positions, toks = paged_decode_rounds(
                self.cfg, self.params, self.pool, self.last_tokens,
                self.positions, self._tables_dev, self._sample_key,
                self.rids, self.tok_ctrs, self.temps, self.topks, steps=n,
                seq_cap=self._seq_cap)
        else:
            self.last_tokens, self.positions, toks = decode_rounds(
                self.cfg, self.params, self.cache, self.last_tokens,
                self.positions, self._sample_key, self.rids,
                self.tok_ctrs, self.temps, self.topks, steps=n)
        self.tok_ctrs = self.tok_ctrs + n
        toks_host = toks.tolist()  # [B, n]
        emitted = 0
        with self._lock:
            self.decode_steps_total += n
        for slot in active:
            req = self._slots[slot]
            for tok in toks_host[slot]:
                req.emit([tok])
                emitted += 1
                self._host_positions[slot] = min(
                    self._host_positions[slot] + 1, self._seq_cap - 1)
                if (len(req.output) >= req.max_new + 1
                        or req.hit_stop()
                        or self._host_positions[slot]
                        >= self._seq_cap - 1):
                    self._complete(slot)
                    break
        with self._lock:
            self.tokens_total += emitted

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
                "shed": 0,
                "requeued": 0,
                "ttft_counts": list(self._ttft_counts),
                "ttft_inf": self._ttft_inf,
                "ttft_sum": self._ttft_sum,
                "free": sum(1 for s in self._slots if s is None),
                "in_prefill": sum(
                    1 for w in self._prefill_work if w is not None),
                "ttft_recent": list(self._ttft_recent),
                "tpot_recent": list(self._tpot_recent),
                "spec_rounds": 0,
                "spec_proposed": 0,
                "spec_accepted": 0,
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
        snap["weight_bytes"] = param_bytes(self.params)
        snap["prefix"] = None
        return snap

    def metrics_text(self) -> str:
        return _render_serving_metrics(self._stats_snapshot())


def _render_serving_metrics(snap: dict) -> str:
    """Render one stats snapshot as the /metrics exposition — the
    reference's renderer line for line (without the mesh engine's
    per-replica family), so the text is identical for equal snapshots."""
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
    ``stop`` is set (or ``duration`` seconds elapse, if nonzero). The
    RNG draw order per arrival (prompt length, tail tokens, then the
    exponential gap) is the reference's, so seeded runs replay the same
    prompts."""
    import random

    rng = random.Random(seed)

    def fire(_rel: float) -> None:
        n = rng.randint(2, engine.cfg.prefill_len)
        tail = [rng.randrange(engine.cfg.model.vocab) for _ in range(n)]
        engine.submit(tail, max_new=max_new, temperature=temperature,
                      top_k=top_k)

    src = ArrivalSource(rate=lambda _t: rps, fire=fire,
                        interval=rng.expovariate)
    ArrivalPump(engine, [src]).run(stop, duration=duration)


def main(argv: list[str] | None = None) -> int:
    """``python -m tpumon_torch.loadgen.serving`` — run the serving
    loadgen on the GPU: synthetic request arrivals + /metrics for tpumon
    to scrape. Same flags and defaults as ``python -m
    tpumon.loadgen.serving`` (dense layout, gather read path); a flag
    asking for anything the port does not have yet exits with "not yet
    ported"."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--port", type=int, default=9105)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--quant", choices=["int8"], default=None,
                    help="weight-only quantization (not yet ported)")
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
                    help="speculative decoding (not yet ported)")
    ap.add_argument("--spec-draft-layers", type=int, default=0,
                    help="draft model layer count (not yet ported)")
    ap.add_argument("--spec-source", choices=["draft", "prompt"],
                    default="draft",
                    help="speculative proposal source (not yet ported)")
    ap.add_argument("--prefix-cache", type=int, default=0,
                    help="prompt-prefix KV cache entries (not yet ported)")
    ap.add_argument("--kv-dtype", choices=["compute", "int8"],
                    default="compute",
                    help="KV cache element type (int8 not yet ported)")
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
                    help="paged decode read path: the plain torch gather "
                         "or the hand-written CUDA paged-attention "
                         "kernel ('ring' not yet ported)")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="dp×tp mesh serving (not yet ported)")
    ap.add_argument("--ring-attn", type=int, default=0, metavar="N",
                    help="ring-attention engine mode (not yet ported)")
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
                    help="MoE model family (not yet ported; 0 = dense)")
    ap.add_argument("--no-report", action="store_true",
                    help="accepted for flag parity; the workload "
                         "self-report is not yet ported")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises when no "
                         "GPU is present)")
    args = ap.parse_args(argv)
    not_ported = [
        (args.quant is not None, "--quant"),
        (args.spec_len != 0, "--spec-len"),
        (args.spec_draft_layers != 0, "--spec-draft-layers"),
        (args.spec_source != "draft", "--spec-source"),
        (args.prefix_cache != 0, "--prefix-cache"),
        (args.kv_dtype != "compute", "--kv-dtype int8"),
        (args.paged_attn == "ring", "--paged-attn ring"),
        (args.mesh is not None, "--mesh"),
        (args.ring_attn != 0, "--ring-attn"),
        (args.experts != 0, "--experts"),
    ]
    for asked, flag in not_ported:
        if asked:
            ap.error(f"{flag} is not yet ported (ROADMAP queue 1)")
    if args.pool_pages and args.kv_layout != "paged":
        ap.error("--pool-pages requires --kv-layout paged")
    if args.prefill_budget < 1:
        ap.error("--prefill-budget must be >= 1")
    if args.admit_lookahead and args.kv_layout != "paged":
        ap.error("--admit-lookahead requires --kv-layout paged (dense "
                 "admission never blocks on pages)")
    if args.paged_attn == "kernel" and args.kv_layout != "paged":
        ap.error("--paged-attn kernel requires --kv-layout paged (the "
                 "kernel reads pages)")

    model = ModelConfig(vocab=2048, d_model=256, n_layers=4, n_heads=8,
                        n_kv_heads=4, d_ff=1024, max_seq=256)
    try:
        engine = ServingEngine(cfg=ServeConfig(
            model=model, slots=args.slots, prefill_len=32,
            kv_layout=args.kv_layout, pool_pages=args.pool_pages,
            decode_block=args.decode_block, paged_attn=args.paged_attn,
            scheduler=args.scheduler,
            prefill_chunk_budget=args.prefill_budget,
            admit_lookahead=args.admit_lookahead,
        ), device=args.device)
    except ValueError as e:
        ap.error(str(e))
    server, port = start_metrics_server(engine, args.port)
    print(f"serving loadgen: /metrics on :{port} "
          f"(point TPUMON_SERVING_TARGETS=http://127.0.0.1:{port}/metrics)",
          flush=True)
    try:
        _arrival_loop(engine, args.rps, args.max_new, threading.Event(),
                      duration=args.duration, temperature=args.temperature,
                      top_k=args.top_k)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
