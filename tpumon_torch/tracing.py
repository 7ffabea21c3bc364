"""Self-tracing data plane: spans, a bounded ring, native histograms.

The reference monitor's only introspection is ``console.error`` on
scrape failures (monitor_server.js:34,50 — SURVEY §5.1); tpumon already
counts its own samples and request latencies, but none of that can
answer *where a tick's milliseconds went*. This module is the Dapper-
style answer, sized for an always-on monitor:

- ``SpanTracer``: an allocation-light span recorder. Every unit of
  data-plane work — a ``tick_fast`` root, each ``collect.<source>``,
  alert evaluation, history recording, SSE delta computation, every
  HTTP request — opens a span (``with tracer.span(...)``). Parent/child
  nesting rides a ``contextvars.ContextVar`` so concurrent asyncio
  tasks (an HTTP request interleaving with a tick) nest correctly.
- Completed spans land in a **bounded ring** (``--trace-ring``, default
  4096): O(1) per span, overwrite-oldest, never allocates after warmup
  beyond the span objects themselves. ``trace_ring=0`` disables
  recording entirely (a shared no-op span; the bench's comparison
  baseline).
- ``LatencyHistogram``: native Prometheus histograms (cumulative
  ``le``-bucketed counts + ``_sum`` + ``_count``) per stage and per
  HTTP route — the exporter renders them as genuine
  ``tpumon_stage_duration_seconds_*`` / ``tpumon_http_request_duration_
  seconds_*`` triples, replacing gauge-only latency reporting, so
  PromQL ``histogram_quantile`` works against the monitor itself.
- ``export_chrome()``: the ring as Chrome trace-event JSON
  (``ph``/``ts``/``dur``/``pid``/``tid``), loadable in Perfetto or
  ``chrome://tracing`` — ``GET /api/trace/export`` serves it live.
- ``profiler_span()``: the spans of the serving engine's and the
  trainer's stages, which go into a running ``torch.profiler`` trace
  beside the device's kernels (on its clock), and cost one flag read
  while no profiler runs. They keep no ring of their own.

Clocking: one ``perf_counter`` pair per span; wall-clock timestamps are
derived from a single (wall, perf) anchor taken at tracer construction,
so child spans always nest inside their parent's interval exactly.

Fleet tracing: spans can carry a **trace id** that crosses
process boundaries — stamped into the optional trailing trace context
of TPWK/TPWD/TPWQ/TPWR frames (tpumon_torch.protowire) and the
``X-Tpumon-Trace`` HTTP header — so a leaf's ``fed.push`` and the
root's ``fed.render`` are one tree. Each node ships only its own
completed trace-correlated spans upstream (a bounded ``outbox``, never
the raw ring), and the root assembles them onto its own clock with
per-link offsets estimated from frame send/recv timestamp pairs
(tpumon_torch.federation — no wall-clock trust).
"""

from __future__ import annotations

import contextvars
import random
import sys
import time

# Prometheus-style log-spaced bounds (seconds). 100 µs floor: the data
# plane's cheapest stages (history record, delta diff) land there; 10 s
# ceiling covers a collect that rode its deadline out.
HIST_BOUNDS: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Current OPEN span for parent attribution (and trace-id inheritance).
# ContextVar, not a plain stack: each asyncio task runs in its own
# context copy, so an HTTP request span interleaving with a tick span
# cannot adopt its children.
_CURRENT: contextvars.ContextVar["_Span | None"] = contextvars.ContextVar(
    "tpumon_current_span", default=None
)

# Bound on distinct HTTP-route histogram keys: routes are a small fixed
# set by construction (the server never keys on unmatched paths), but a
# histogram map must stay bounded even if that invariant slips.
MAX_HTTP_ROUTES = 64
OTHER_ROUTE = "(other)"

# Fleet-tracing bounds: completed trace-correlated spans queued for the
# uplink (outbox) and remote spans buffered for root assembly. Both
# overwrite-oldest — a wedged uplink or a chatty subtree can never grow
# the tracer's footprint.
OUTBOX_CAP = 256
REMOTE_CAP = 4096

# The cross-node federation stage names (docs/observability.md
# "Distributed tracing" table; pinned by the tpulint registry pass).
# fed.push/fed.collect/fed.encode run on the sending tier each tick;
# fed.accept/fed.ingest/fed.decode/fed.rollup/fed.land on the receiving
# hub per stream/frame; fed.query wraps a pushed-down TPWQ answer;
# fed.render is the root tick stage that lands fleet freshness.
FED_STAGES: tuple[str, ...] = (
    "fed.push",
    "fed.collect",
    "fed.encode",
    "fed.accept",
    "fed.ingest",
    "fed.decode",
    "fed.rollup",
    "fed.land",
    "fed.query",
    "fed.render",
)


def format_trace_header(ctx: tuple[int, int, str]) -> str:
    """``X-Tpumon-Trace`` header value: ``<trace>-<parent sid>-<origin>``
    (ids lower-hex, origin a node name — never contains ``-``-free
    guarantees, so parsing splits at most twice)."""
    tid, psid, origin = ctx
    return f"{tid:x}-{psid:x}-{origin}"


def current_ctx_header() -> str | None:
    """The innermost open span's fleet context as an ``X-Tpumon-Trace``
    value, or None when the caller isn't inside a fleet trace — how
    outbound HTTP hops (peer fan-out) propagate without holding a
    tracer reference. ContextVars ride ``asyncio.to_thread``, so this
    works from fetch worker threads too."""
    cur = _CURRENT.get()
    if cur is None or cur.trace is None:
        return None
    return format_trace_header((cur.trace, cur.sid, cur.tracer.node))


def parse_trace_header(value: str | None) -> tuple[int, int, str] | None:
    """Inverse of format_trace_header; None on anything malformed (an
    unparseable header is dropped, never an error — tracing is advisory)."""
    if not value:
        return None
    parts = value.split("-", 2)
    if len(parts) != 3 or not parts[2] or len(parts[2]) > 128:
        return None
    try:
        return int(parts[0], 16), int(parts[1], 16), parts[2]
    except ValueError:
        return None


def quantiles(xs) -> tuple[float, float, float] | None:
    """(p50, p95, max) from one sort — the single-pass-per-render
    replacement for calling ``statistics.median`` per field."""
    if not xs:
        return None
    s = sorted(xs)
    n = len(s)
    return s[int(0.50 * (n - 1))], s[int(0.95 * (n - 1))], s[-1]


class LatencyHistogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics)."""

    __slots__ = ("counts", "sum", "count")
    bounds = HIST_BOUNDS

    def __init__(self) -> None:
        self.counts = [0] * len(HIST_BOUNDS)  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, seconds: float) -> None:
        self.sum += seconds
        self.count += 1
        for i, bound in enumerate(HIST_BOUNDS):
            if seconds <= bound:
                self.counts[i] += 1
                return
        # beyond the last bound: only the +Inf bucket (== count) sees it

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le, cumulative_count)] — excludes the +Inf bucket, whose
        cumulative count is ``self.count`` by definition."""
        out = []
        acc = 0
        for bound, n in zip(HIST_BOUNDS, self.counts):
            acc += n
            out.append((bound, acc))
        return out


class _Span:
    """One traced interval; a context manager recorded on exit."""

    __slots__ = (
        "tracer", "sid", "parent", "name", "cat", "track",
        "t0", "dur_ms", "tags", "trace", "remote_parent",
        "_token", "_mark",
    )

    def __init__(self, tracer: "SpanTracer", name: str, cat: str, track: str):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.tags: dict | None = None
        # Fleet-trace linkage: ``trace`` is the cross-node trace id
        # (None = purely local span, never shipped), ``remote_parent``
        # is (origin node, parent sid on that node) for spans continuing
        # a context that arrived over the wire.
        self.trace: int | None = None
        self.remote_parent: tuple[str, int] | None = None

    def tag(self, **kw) -> None:
        if self.tags is None:
            self.tags = kw
        else:
            self.tags.update(kw)

    def __enter__(self) -> "_Span":
        tr = self.tracer
        tr._seq += 1
        self.sid = tr._seq
        cur = _CURRENT.get()
        self.parent = cur.sid if cur is not None else None
        if self.trace is None and cur is not None:
            self.trace = cur.trace  # inherit the enclosing trace id
        self._token = _CURRENT.set(self)
        self._mark = tr._n  # ring position at start: children gather range
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.dur_ms = (time.perf_counter() - self.t0) * 1e3
        _CURRENT.reset(self._token)
        if et is not None:
            self.tag(error=et.__name__)
        self.tracer._record(self)
        return False


class _NoopSpan:
    """Shared do-nothing span for a disabled tracer."""

    __slots__ = ()

    def tag(self, **kw) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        return False


_NOOP = _NoopSpan()


def profiler_span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    torch profiler runs in this process, else the shared no-op span.

    The range lands in the profiler's own trace, so it shares a clock with
    the device events that trace holds (the benchmark's slice, a ``GET
    /api/profile`` capture). With no profiler running it costs a dict
    lookup and one attribute read, where ``record_function`` itself costs
    microseconds; and it never imports torch, so the monitor-only paths
    keep importing this module without it (no torch loaded, no profiler
    running)."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return _NOOP
    return prof.record_function(name)


class SpanTracer:
    """Always-on span recorder over a bounded ring.

    ``capacity=0`` disables: ``span()`` hands back a shared no-op and
    nothing is recorded — the zero-overhead baseline the bench's
    ``observability`` phase compares against.
    """

    def __init__(self, capacity: int = 4096, node: str = "local"):
        self.capacity = max(0, int(capacity))
        # This process's federation node name — stamped on every span
        # shipped upstream and into wire/header trace contexts. The app
        # wiring overwrites it once the federation config is known.
        self.node = node
        self._ring: list = [None] * self.capacity
        self._n = 0  # spans recorded (monotonic)
        self._seq = 0  # span ids (monotonic; enter-ordered)
        # Fleet tracing: completed trace-correlated spans awaiting the
        # next uplink tick (bounded; drained by FederationUplink), and
        # remote spans received from downstream tiers (bounded; the
        # root's assembly buffer).
        self.outbox: list[dict] = []
        self.outbox_dropped = 0
        self.remote: list[dict] = []
        self.remote_dropped = 0
        # Wall-clock anchor: wall = anchor_wall + (perf - anchor_perf).
        self._anchor_wall = time.time()
        self._anchor_perf = time.perf_counter()
        # Per-stage Prometheus histograms (cat: tick/stage/collect) and
        # bounded recent-duration windows for the /api/trace p50/p95/max
        # summary (histograms answer PromQL; the recent window answers
        # "now", without bucket-interpolation error).
        self.stage_hist: dict[str, LatencyHistogram] = {}
        self._stage_recent: dict[str, list] = {}
        self.http_hist: dict[str, LatencyHistogram] = {}
        self._http_recent: dict[str, list] = {}
        # Compact summary of the last completed tick_fast (the SSE
        # timeline strip's payload): {"total_ms", "stages": [...]}.
        self.last_tick: dict | None = None

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    @property
    def recorded(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def span(
        self,
        name: str,
        cat: str = "stage",
        track: str = "sampler",
        trace: int | None = None,
        remote: tuple[int, int, str] | None = None,
    ):
        """Open a span. ``trace`` starts/joins a fleet trace explicitly;
        ``remote`` is a wire/header context (trace id, parent sid,
        origin node) — the span joins that trace with a cross-node
        parent link. Without either, the trace id (if any) is inherited
        from the enclosing span."""
        if not self.capacity:
            return _NOOP
        sp = _Span(self, name, cat, track)
        if remote is not None:
            tid, psid, origin = remote
            sp.trace = tid
            sp.remote_parent = (origin, psid)
        elif trace is not None:
            sp.trace = trace
        return sp

    # ------------------------- fleet tracing -------------------------

    @staticmethod
    def new_trace() -> int:
        """A fresh 63-bit trace id (wire varints stay short; nonzero so
        'no trace' needs no sentinel)."""
        return random.getrandbits(63) | 1

    def current_ctx(self) -> tuple[int, int, str] | None:
        """(trace id, span id, node) of the innermost open span, if it
        belongs to a fleet trace — what gets stamped into outgoing
        frames and X-Tpumon-Trace headers."""
        cur = _CURRENT.get()
        if cur is None or cur.trace is None:
            return None
        return cur.trace, cur.sid, self.node

    def ensure_trace(self) -> tuple[int, int, str] | None:
        """Attach a fresh trace id to the innermost open span (no-op if
        it already has one) and return its context — how a request
        handler opts its already-open http span into fleet propagation."""
        if not self.capacity:
            return None
        cur = _CURRENT.get()
        if cur is None:
            return None
        if cur.trace is None:
            cur.trace = self.new_trace()
        return cur.trace, cur.sid, self.node

    def record(
        self,
        name: str,
        cat: str = "stage",
        track: str = "sampler",
        t0: float | None = None,
        dur_ms: float = 0.0,
        trace: int | None = None,
        remote_parent: tuple[str, int] | None = None,
        parent: int | None = None,
        **tags,
    ) -> int:
        """Record an already-completed span with explicit timing —
        for work whose trace context is only known after the fact (a
        hub decoding a frame learns the sender's context from its
        trailer). ``t0`` is a perf_counter mark; returns the span id
        (0 when disabled)."""
        if not self.capacity:
            return 0
        sp = _Span(self, name, cat, track)
        self._seq += 1
        sp.sid = self._seq
        sp.parent = parent
        sp.trace = trace
        sp.remote_parent = remote_parent
        sp.t0 = time.perf_counter() if t0 is None else t0
        sp.dur_ms = dur_ms
        if tags:
            sp.tags = tags
        self._record(sp)
        return sp.sid

    def drain_outbox(self, limit: int = 128) -> list[dict]:
        """Up to ``limit`` queued outbound spans, oldest first — one
        uplink tick's TPWS payload. Never returns raw ring contents."""
        if not self.outbox:
            return []
        out = self.outbox[:limit]
        del self.outbox[:limit]
        return out

    def add_remote(self, spans) -> None:
        """Buffer spans relayed from a downstream tier (already in the
        outbox JSON shape). Bounded overwrite-oldest."""
        for s in spans:
            if not isinstance(s, dict) or "name" not in s or "node" not in s:
                continue
            self.remote.append(s)
        if len(self.remote) > REMOTE_CAP:
            self.remote_dropped += len(self.remote) - REMOTE_CAP
            del self.remote[: len(self.remote) - REMOTE_CAP]

    def fleet_spans(
        self, offsets: dict[str, float] | None = None, limit: int = 2048
    ) -> list[dict]:
        """Local + remote trace-correlated spans as one list, remote
        timestamps shifted onto THIS node's clock by per-origin offsets
        (seconds, ``origin_clock - local_clock``; tpumon_torch.federation
        estimates them from frame send/recv pairs). Sorted by ts."""
        offsets = offsets or {}
        out = []
        for s in self._spans_newest_last(self.capacity or 1):
            if s.trace is None:
                continue
            out.append(self._span_json(s))
        for r in self.remote:
            j = dict(r)
            off = offsets.get(j.get("node"))
            if off is not None and isinstance(j.get("ts"), (int, float)):
                j["ts"] = round(j["ts"] - off, 6)
                j["clock_adjusted"] = True
            out.append(j)
        out.sort(key=lambda j: j.get("ts") or 0)
        return out[-limit:]

    def _wall(self, perf_t: float) -> float:
        return self._anchor_wall + (perf_t - self._anchor_perf)

    @staticmethod
    def _recent_push(window: list, dur_ms: float, cap: int = 256) -> None:
        # Bounded append-only-then-shift window; a plain list beats a
        # deque for the sorted() pass the summary does per render.
        window.append(dur_ms)
        if len(window) > cap:
            del window[: len(window) - cap]

    def _record(self, span: _Span) -> None:
        self._ring[self._n % self.capacity] = span
        self._n += 1
        dur_s = span.dur_ms / 1e3
        if span.cat in ("tick", "stage", "collect"):
            hist = self.stage_hist.get(span.name)
            if hist is None:
                hist = self.stage_hist[span.name] = LatencyHistogram()
            hist.observe(dur_s)
            self._recent_push(
                self._stage_recent.setdefault(span.name, []), span.dur_ms
            )
        elif span.cat == "http":
            route = (span.tags or {}).get("route") or OTHER_ROUTE
            if route not in self.http_hist and len(self.http_hist) >= MAX_HTTP_ROUTES:
                route = OTHER_ROUTE
            hist = self.http_hist.get(route)
            if hist is None:
                hist = self.http_hist[route] = LatencyHistogram()
            hist.observe(dur_s)
            self._recent_push(
                self._http_recent.setdefault(route, []), span.dur_ms
            )
        if span.trace is not None:
            # Queue for the uplink: completed spans only, compact JSON
            # shape, bounded. Purely local spans (trace None) never
            # leave the process.
            self.outbox.append(self._span_json(span))
            if len(self.outbox) > OUTBOX_CAP:
                self.outbox_dropped += len(self.outbox) - OUTBOX_CAP
                del self.outbox[: len(self.outbox) - OUTBOX_CAP]
        if span.cat == "tick" and span.name == "tick_fast":
            self.last_tick = self._tick_summary(span)

    def _tick_summary(self, root: _Span) -> dict:
        """Direct children of a just-closed tick root, gathered from the
        ring slice recorded during it — O(children), no full-ring walk.
        If the tick itself overflowed the ring (tiny capacity), the
        oldest children are gone; the summary is still bounded-correct."""
        stages = []
        lo = max(root._mark, self._n - self.capacity)
        for i in range(lo, self._n):
            s = self._ring[i % self.capacity]
            if s is not None and s is not root and s.parent == root.sid:
                stages.append({"name": s.name, "ms": round(s.dur_ms, 3)})
        return {
            "ts": round(self._wall(root.t0), 3),
            "total_ms": round(root.dur_ms, 3),
            "stages": stages,
        }

    # ----------------------------- views -----------------------------

    def _spans_newest_last(self, limit: int) -> list:
        live = min(self._n, self.capacity)
        take = min(limit, live)
        return [
            self._ring[i % self.capacity]
            for i in range(self._n - take, self._n)
        ]

    def _span_json(self, s: _Span) -> dict:
        out = {
            "sid": s.sid,
            "parent": s.parent,
            "name": s.name,
            "cat": s.cat,
            "track": s.track,
            "ts": round(self._wall(s.t0), 6),
            "dur_ms": round(s.dur_ms, 3),
        }
        if s.trace is not None:
            # Hex string, not an int: trace ids are 63-bit and JS
            # number precision stops at 2**53 (dashboard.js reads this).
            out["trace"] = format(s.trace, "x")
            out["node"] = self.node
        if s.remote_parent is not None:
            out["rp"] = [s.remote_parent[0], s.remote_parent[1]]
        if s.tags:
            out["tags"] = s.tags
        return out

    @staticmethod
    def _summary(hists: dict, recents: dict) -> dict:
        out = {}
        for name, hist in sorted(hists.items()):
            q = quantiles(recents.get(name) or ())
            out[name] = {
                "count": hist.count,
                "total_ms": round(hist.sum * 1e3, 3),
                "p50_ms": round(q[0], 3) if q else None,
                "p95_ms": round(q[1], 3) if q else None,
                "max_ms": round(q[2], 3) if q else None,
            }
        return out

    def stage_summary(self) -> dict:
        """Per-stage p50/p95/max over the recent window + lifetime
        count/total — the /api/trace "stages" table."""
        return self._summary(self.stage_hist, self._stage_recent)

    def http_summary(self) -> dict:
        return self._summary(self.http_hist, self._http_recent)

    def to_json(self, spans: int = 120) -> dict:
        return {
            "enabled": self.enabled,
            "capacity": self.capacity,
            "recorded": self._n,
            "dropped": self.dropped,
            "node": self.node,
            "outbox": len(self.outbox),
            "outbox_dropped": self.outbox_dropped,
            "remote": len(self.remote),
            "remote_dropped": self.remote_dropped,
            "stages": self.stage_summary(),
            "http": self.http_summary(),
            "last_tick": self.last_tick,
            "spans": [self._span_json(s) for s in self._spans_newest_last(spans)],
        }

    def export_chrome(
        self, fleet: bool = False, offsets: dict[str, float] | None = None
    ) -> dict:
        """The ring as Chrome trace-event JSON (Perfetto /
        ``chrome://tracing`` loadable): ``X`` complete events with
        microsecond ``ts``/``dur``, one ``tid`` per logical track, and
        ``M`` metadata naming the process and tracks. Span ids ride
        ``args`` so tooling (and tests) can check parent/child nesting
        without relying on time containment alone.

        One *process* per node: the local node is always pid 1 and its
        name is stamped into the process metadata (a multi-node export
        must never collapse into one anonymous ``pid 1`` track);
        ``fleet=True`` adds the buffered remote spans, each node its own
        pid, timestamps shifted onto this node's clock by ``offsets``."""
        events: list[dict] = []
        pids: dict[str, int] = {}
        tids: dict[tuple[str, str], int] = {}

        def _pid(node: str) -> int:
            pid = pids.get(node)
            if pid is None:
                pid = pids[node] = len(pids) + 1
                events.append({
                    "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                    "args": {"name": f"tpumon:{node}"},
                })
            return pid

        def _tid(node: str, track: str) -> int:
            key = (node, track)
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = sum(1 for k in tids if k[0] == node) + 1
                events.append({
                    "ph": "M", "pid": pids[node], "tid": tid,
                    "name": "thread_name", "args": {"name": track},
                })
            return tid

        _pid(self.node)  # local process claims pid 1 before any remote
        rows = [
            self._span_json(s)
            for s in self._spans_newest_last(self.capacity or 1)
        ]
        if fleet:
            offsets = offsets or {}
            for r in self.remote:
                j = dict(r)
                off = offsets.get(j.get("node"))
                if off is not None and isinstance(j.get("ts"), (int, float)):
                    j["ts"] = j["ts"] - off
                rows.append(j)
        for j in rows:
            node = j.get("node") or self.node
            args = {
                "sid": j.get("sid"), "parent": j.get("parent"),
                **(j.get("tags") or {}),
            }
            if j.get("trace"):
                args["trace"] = j["trace"]
            if j.get("rp"):
                args["remote_parent"] = j["rp"]
            pid = _pid(node)
            events.append({
                "ph": "X",
                "pid": pid,
                "tid": _tid(node, j.get("track") or "remote"),
                "name": j["name"],
                "cat": j.get("cat", "stage"),
                "ts": round((j.get("ts") or 0) * 1e6, 1),
                "dur": round((j.get("dur_ms") or 0) * 1e3, 1),
                "args": args,
            })
        return {"displayTimeUnit": "ms", "traceEvents": events}


# ------------------------------ CLI ------------------------------


def _fmt_ms(v) -> str:
    return f"{v:.2f}" if isinstance(v, (int, float)) else "–"


def render_trace_summary(trace: dict) -> str:
    """Terminal rendering of an /api/trace payload (``tpumon trace``)."""
    lines = [
        f"trace ring: {trace.get('recorded', 0)} spans recorded, "
        f"capacity {trace.get('capacity', 0)}, "
        f"dropped {trace.get('dropped', 0)}"
        + ("" if trace.get("enabled", True) else " (DISABLED)")
    ]
    tick = trace.get("last_tick")
    if tick:
        cells = " · ".join(
            f"{s['name']} {_fmt_ms(s['ms'])}" for s in tick.get("stages", [])
        )
        lines.append(f"last tick: {_fmt_ms(tick.get('total_ms'))} ms ({cells})")
    for title, table in (("stage", trace.get("stages") or {}),
                         ("http", trace.get("http") or {})):
        if not table:
            continue
        lines.append(f"{'':2}{title:<24} {'count':>8} {'p50 ms':>9} "
                     f"{'p95 ms':>9} {'max ms':>9}")
        for name, row in table.items():
            lines.append(
                f"{'':2}{name:<24} {row['count']:>8} "
                f"{_fmt_ms(row['p50_ms']):>9} {_fmt_ms(row['p95_ms']):>9} "
                f"{_fmt_ms(row['max_ms']):>9}"
            )
    fleet = trace.get("fleet")
    if fleet:
        fresh = fleet.get("freshness") or {}
        if fresh:
            lines.append(
                f"{'':2}{'node':<24} {'freshness ms':>12} {'offset ms':>10}"
            )
            for node, row in sorted(fresh.items()):
                lines.append(
                    f"{'':2}{node:<24} {_fmt_ms(row.get('ms')):>12} "
                    f"{_fmt_ms(row.get('offset_ms')):>10}"
                )
        spans = fleet.get("spans") or []
        nodes = {s.get("node") for s in spans if s.get("node")}
        lines.append(
            f"fleet: {len(spans)} trace-correlated spans from "
            f"{len(nodes)} node(s)"
        )
    prof = trace.get("profile") or {}
    last = prof.get("last")
    if last:
        lines.append(f"latest device profile: {last.get('dir')} ({last.get('hint')})")
    return "\n".join(lines)


def trace_cli(argv: list[str]) -> int:
    """``tpumon trace`` — dump/summarize a running server's span ring.

    usage: tpumon trace [--url HOST:8888] [--export FILE] [--spans N]
                        [--fleet]

    --fleet assembles the federation view: per-leaf freshness and the
    cross-node span buffer (clock-shifted onto the queried node), and
    makes --export emit one Perfetto process track per node.
    """
    import json
    import sys
    import urllib.request

    url = "127.0.0.1:8888"
    export_path = None
    show_spans = 0
    fleet = False
    it = iter(argv)
    for a in it:
        if a == "--url":
            url = next(it, url)
        elif a == "--export":
            export_path = next(it, None)
            if not export_path:
                print("--export requires a file path", file=sys.stderr)
                return 2
        elif a == "--spans":
            show_spans = int(next(it, "20") or 20)
        elif a == "--fleet":
            fleet = True
        elif a in ("-h", "--help"):
            print(trace_cli.__doc__)
            return 0
        else:
            print(f"unknown argument {a!r}", file=sys.stderr)
            return 2
    if "://" not in url:
        url = f"http://{url}"
    url = url.rstrip("/")
    qs = "?fleet=1" if fleet else ""

    def get(path: str):
        with urllib.request.urlopen(f"{url}{path}", timeout=10) as r:
            return json.load(r)

    try:
        if export_path:
            chrome = get(f"/api/trace/export{qs}")
            with open(export_path, "w") as f:
                json.dump(chrome, f)
            n = sum(1 for e in chrome["traceEvents"] if e["ph"] == "X")
            pids = {
                e["pid"] for e in chrome["traceEvents"] if e["ph"] == "X"
            }
            print(
                f"wrote {n} spans ({len(pids)} node track(s)) to "
                f"{export_path} — load in https://ui.perfetto.dev or "
                "chrome://tracing"
            )
            return 0
        trace = get(f"/api/trace{qs}")
    except OSError as e:
        print(f"tpumon at {url} unreachable: {e}", file=sys.stderr)
        return 1
    print(render_trace_summary(trace))
    if show_spans:
        spans = trace.get("spans") or []
        if show_spans > len(spans):
            # /api/trace ships a bounded recent window; the full ring
            # is only reachable via the export.
            print(
                f"(showing last {len(spans)} of "
                f"{trace.get('recorded', len(spans))} recorded — use "
                "--export for the full ring)"
            )
        for s in spans[-show_spans:]:
            tags = s.get("tags") or {}
            cells = " ".join(f"{k}={v}" for k, v in tags.items())
            print(
                f"  {s['ts']:.3f} {s['name']:<20} {s['dur_ms']:>9.3f} ms"
                + (f"  {cells}" if cells else "")
            )
    return 0
