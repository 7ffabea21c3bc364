"""Asyncio HTTP server + JSON API router (a copy of ``tpumon/server.py``:
the same routes and payloads; ``/api/profile`` captures through
``torch.profiler`` and the dashboard is the port's own ``web/`` copy).

Reference parity (monitor_server.js:240-299): same-origin dashboard +
JSON API on one port (default 8888), CORS ``*`` with OPTIONS preflight
(:244-248), 404 for unknown routes (:290), handler exceptions → 500 with
a JSON error body (:292-294).

Route map (SURVEY §2.3, re-keyed for TPU):
  /, /monitor.html      dashboard HTML (cached, mtime-refreshed)
  /logo.svg             original tpumon logo
  /api/host/metrics     host cards
  /api/accel/metrics    per-chip TPU metrics + slice rollup (north star;
                        replaces /api/gpu/metrics)
  /api/gpu/metrics      reference-shaped compat view over the same chips
  /api/k8s/pods         pod table
  /api/history          curves from the in-process TSDB; ?window=30m|3h|24h
                        selects the span (mid/coarse ring tiers beyond
                        30 min); ?series=<glob> restricts to matching
                        series (e.g. series=chip.* for the per-chip
                        drill-down curves at 256 chips)
  /api/query            instant query in the in-tree PromQL subset
                        (tpumon_torch.query, docs/query.md): ?query=<expr>
                        [&time=<ts>]; ?fleet=1 on an aggregator or root
                        plans a DISTRIBUTED evaluation over the
                        federation tree (partial aggregates merged,
                        dark subtrees degrade to an explicit partial
                        marker); bare GET returns engine info
  /api/query_range      the same expressions on a step grid:
                        ?query=<expr>&window=30m&step=30s[&end=<ts>] —
                        per-(series, window) point fetches are shared
                        across grid steps
  /api/alerts           last alert evaluation (sampler-owned, not
                        recomputed per request — fixes SURVEY §5.2),
                        + silenced list and active silences
  /api/slo              SLO objectives (tpumon_torch.slo, docs/slo.md):
                        per-objective error-budget remaining and
                        multi-window burn rates with firing state —
                        empty "slos" list when none are configured
  /api/actuate          actuation engine (tpumon_torch.actuate,
                        docs/actuation.md): per-policy state
                        (idle/armed/fired), guard counters, dry-run
                        flags and the last journaled transition —
                        empty "policies" list when none are configured
  /api/silence          POST {"key": <prefix>, "duration": "1h"} mutes
                        matching alerts (buckets + webhooks; timeline
                        still records); /api/unsilence removes a mute
  /api/serving          JetStream/MaxText panels
  /api/topology         slice views
  /api/health           per-source health + self stats
  /api/accel/wire       compact columnar chip snapshot — the federation
                        wire format peers fetch (tpumon_torch.topology); with
                        ``Accept: application/x-tpumon-wire`` the same
                        columns are served as the binary frame
                        (tpumon_torch.protowire, docs/perf.md "ingest spine")
                        — JSON stays the default for pre-binary peers
  /api/stream           Server-Sent Events: realtime snapshot pushed on
                        every sampler tick (the dashboard upgrades from
                        5s polling to ~1s push when available)
  /api/profile          GET ?seconds=N: capture a torch.profiler device
                        trace of this process (SURVEY §5.1); without
                        ?seconds returns capture status
  /api/trace            self-trace: recent data-plane spans + per-stage
                        p50/p95/max summary (tpumon_torch.tracing,
                        docs/observability.md)
  /api/trace/export     the span ring as Chrome trace-event JSON —
                        loadable in Perfetto / chrome://tracing
  /api/events           structured event journal (tpumon_torch.events,
                        docs/events.md): alert fired/resolved, breaker
                        transitions, chaos injections, anomaly fires,
                        peer up/down — ?after=<cursor>&kind=&severity=
                        &since=&limit= filters, cursor-paginated
  /api/federation       aggregator-tree fleet view (the federation tree,
                        docs/federation.md): per-downstream stream
                        state, the failure-domain-aware slice table
                        (ok/dark/unreachable) and fleet totals; on a
                        standalone instance reports role "standalone"
  /api/federation/ingest  POST (long-lived, chunked): the push-based
                        federation wire — downstream leaves/aggregators
                        stream columnar delta frames (protowire
                        TPWK/TPWD) up the tree; 404 unless this
                        instance is an aggregator or root
  /metrics              in-tree Prometheus exporter

The reference's ``/danyichun`` path-prefix file read (monitor_server.js:
266-270, a path-traversal risk) is deliberately NOT reproduced (SURVEY
§2.1).

The HTTP layer is a deliberately small stdlib-only implementation:
HTTP/1.1, GET/HEAD/OPTIONS, Connection: close. Handlers never block —
all state comes from the background sampler's snapshots, so request
latency is O(json.dumps), which is what makes the scrape→render p50
metric beat a collect-on-request design.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import os
import time
import urllib.parse
from collections import deque
from dataclasses import dataclass, field

from tpumon_torch.config import Config, parse_duration
from tpumon_torch.deltas import diff
from tpumon_torch.events import KINDS, SEVERITIES
from tpumon_torch.exporter import render_exporter
from tpumon_torch.history import HistoryService
from tpumon_torch.profiler import ProfileBusy, ProfilerService
from tpumon_torch.protowire import WIRE_FRAME_CTYPE, encode_wire_frame
from tpumon_torch.query import QueryError
from tpumon_torch.sampler import Sampler
from tpumon_torch.snapshot import ExporterCache, RenderCache
from tpumon_torch.topology import attribute_pods, chips_to_wire
from tpumon_torch.tracing import parse_trace_header, quantiles

WEB_DIR = os.path.join(os.path.dirname(__file__), "web")

# Sections the realtime push payload reads — the SSE frame epoch is the
# version over these, so a frame is only "new" when one of them moved.
# "events" rides along: the payload carries the journal's recent tail,
# so a breaker transition or anomaly fire reaches the dashboard's event
# feed as a delta frame on the very next tick.
# With tracing enabled the server adds "samples" (bumped on every poll)
# so the per-tick trace timeline the payload carries refreshes even
# when no data section moved; with tracing off the payload has no
# per-tick content, so unchanged data must keep producing heartbeats.
# "actuate" rides the same way: a policy firing reaches the
# dashboard's Actuation card as a delta frame on the very next tick.
RT_SECTIONS = ("host", "accel", "k8s", "alerts", "events", "actuate")

# Per-SSE-client send-queue depth, in frames. The broadcaster renders
# each tick's frame bytes once and put_nowait()s them into every
# connected client's bounded queue; a consumer that falls this many
# frames behind is dropped-and-resynced (queue cleared, next frame
# forced to a keyframe) instead of its TCP backpressure stalling the
# fan-out for everyone else.
SSE_QUEUE_FRAMES = 8


def parse_query(query: str) -> dict[str, str]:
    return dict(kv.split("=", 1) for kv in query.split("&") if "=" in kv)


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


_STATUS_TEXT = {
    200: "OK",
    204: "No Content",
    304: "Not Modified",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    409: "Conflict",
    500: "Internal Server Error",
    503: "Service Unavailable",
}


@dataclass
class StaticFile:
    path: str
    content_type: str
    _cache: tuple[float, bytes] | None = field(default=None, repr=False)

    def read(self) -> bytes:
        mtime = os.path.getmtime(self.path)
        if self._cache is None or self._cache[0] != mtime:
            with open(self.path, "rb") as f:
                self._cache = (mtime, f.read())
        return self._cache[1]


class MonitorServer:
    def __init__(self, cfg: Config, sampler: Sampler, history: HistoryService):
        self.cfg = cfg
        self.sampler = sampler
        self.history = history
        self._server: asyncio.Server | None = None
        # Live client connections: keep-alive sockets and long-lived
        # streams (SSE, federation ingest) outlive individual requests,
        # so stop() must close them too — a "stopped" server that kept
        # answering warm connections would fake peer liveness.
        self._client_writers: set = set()
        self.request_latencies_ms: deque = deque(maxlen=2048)
        self.per_path_latencies_ms: dict[str, deque] = {}
        self._dashboard = StaticFile(
            os.path.join(WEB_DIR, "dashboard.html"), "text/html; charset=utf-8"
        )
        self._logo = StaticFile(os.path.join(WEB_DIR, "logo.svg"), "image/svg+xml")
        self._chartcore = StaticFile(
            os.path.join(WEB_DIR, "chartcore.js"),
            "application/javascript; charset=utf-8",
        )
        self._dashboard_js = StaticFile(
            os.path.join(WEB_DIR, "dashboard.js"),
            "application/javascript; charset=utf-8",
        )
        # Eager: construction is cheap (no torch import) and /api/trace +
        # the tpumon_profile_* metrics read its status before any
        # capture has been requested. Captures are journal events.
        self._profiler = ProfilerService(journal=sampler.journal)
        # Crash-safe history snapshotter (tpumon_torch.history), attached by
        # app.run when --history-snapshot is configured so /api/health
        # can report save/skip counters and the active format.
        self.snapshotter = None
        # Epoch-keyed render caches (tpumon_torch.snapshot): requests between
        # sampler ticks are served pre-serialized bytes; the version
        # doubles as a strong ETag for 304s. The exporter cache reuses
        # unchanged metric-family blocks across ticks.
        self.cache = RenderCache(sampler.clock)
        self.exporter_cache = ExporterCache(sampler.clock)
        # route -> (dep sections, payload function) for the cacheable
        # JSON GET routes. /api/health and /api/history are handled
        # specially (per-request data / query params); /metrics rides
        # the exporter cache.
        self._cached_routes: dict = {
            "/api/host/metrics": (("host",), self._api_host),
            "/api/accel/metrics": (("accel", "k8s"), self._api_accel),
            "/api/accel/wire": (("accel",), self._api_accel_wire),
            "/api/gpu/metrics": (("accel",), self._api_gpu_compat),
            "/api/k8s/pods": (("k8s", "accel"), self._api_pods),
            "/api/alerts": (("alerts",), self._api_alerts),
            "/api/serving": (("serving",), self._api_serving),
            "/api/topology": (
                ("accel",),
                lambda: {"slices": [v.to_json() for v in self.sampler.slices()]},
            ),
            # Self-trace summary: the span data changes with collection
            # activity, so "samples" (bumped every poll) is the honest
            # version — between ticks every request reuses the render.
            "/api/trace": (("samples",), self._api_trace),
            # Fleet view of the aggregator tree (federation):
            # "federation" moves as downstream frames land; "samples"
            # keeps uplink/staleness stats fresh per tick. Standalone
            # instances render once ("standalone") and cache forever.
            "/api/federation": (("federation", "samples"), self._api_federation),
            # SLO burn-down view (tpumon_torch.slo, docs/slo.md): "slo"
            # bumps only when an objective's published budget/burn/
            # alert state moved, so a polling dashboard reuses the
            # bytes between changes. Renders {"slos": []} once and
            # caches forever when no objectives are configured.
            "/api/slo": (("slo",), self._api_slo),
            # Actuation engine (tpumon_torch.actuate, docs/actuation.md):
            # "actuate" bumps only when a policy's published state/
            # value/last-transition row moved. Renders
            # {"policies": []} once and caches forever when no
            # policies are configured.
            "/api/actuate": (("actuate",), self._api_actuate),
        }
        # SSE epoch sections (see RT_SECTIONS): the trace strip rides
        # the payload only when tracing is on, and only then may the
        # frame epoch advance with collection activity alone.
        self._rt_sections = RT_SECTIONS + (
            ("samples",) if sampler.tracer.enabled else ()
        )
        # Known-route set for http-span tagging: error statuses on
        # unregistered paths must share one histogram key, or a URL
        # scanner (404s; 401s when auth is on) could grow the per-route
        # label set to its cap and pin junk there forever.
        self._route_set = frozenset(self.routes())
        # Shared SSE frame state: the payload/patch for the current
        # epoch is computed ONCE per tick no matter how many stream
        # clients are attached (each gets the same bytes).
        self._sse = {
            "ver": -1, "payload": None,
            "prev_ver": -1, "prev_payload": None,
            "key_bytes": None, "patch_bytes": None,
        }
        # SSE fan-out state: one broadcaster task feeds every client's
        # bounded queue (see SSE_QUEUE_FRAMES); connection handlers only
        # dequeue and write. Lazily started with the first client,
        # exits when the last one leaves.
        self._sse_clients: dict[int, dict] = {}
        self._sse_next_id = 0
        self._sse_broadcaster: asyncio.Task | None = None
        self.sse_overruns = 0  # slow-consumer drop-and-resync episodes

    # ------------------------------ handlers ------------------------------

    def _api_host(self) -> dict:
        s = self.sampler.sample_of("host")
        return {
            **self.sampler.host_data(),
            # NIC byte rates (the host's DCN-traffic proxy); present
            # once two samples have established a delta.
            "net_rates": self.sampler.net_rates,
            "health": s.health_json() if s else {"ok": False, "error": "not sampled"},
        }

    def _api_accel(self) -> dict:
        chips = self.sampler.chips()
        rates = self.sampler.ici_rates
        owners = attribute_pods(chips, self.sampler.pods())
        chip_json = []
        for c in chips:
            d = c.to_json()
            d.update(rates.get(c.chip_id, {}))
            d["pod"] = owners.get(c.chip_id)
            chip_json.append(d)
        s = self.sampler.sample_of("accel")
        return {
            "chips": chip_json,
            "slices": [v.to_json() for v in self.sampler.slices()],
            # Slice-level libtpu SDK extras (HLO queue depth, DCN/collective
            # latency percentiles) when the real collector exposes them.
            "runtime": getattr(self.sampler.accel, "last_extras", None) or {},
            "health": s.health_json() if s else {"ok": False, "error": "not sampled"},
        }

    def _api_gpu_compat(self) -> list[dict]:
        """Reference-shaped view (monitor_server.js:90): lets clients
        written against the reference's /api/gpu/metrics keep working.
        GPU-family chips render with the reference's own
        vocabulary — their rows read exactly like nvidia-smi output."""
        out = []
        for c in self.sampler.chips():
            out.append(
                {
                    "name": f"{'GPU' if c.accel_kind == 'gpu' else 'TPU'} "
                    f"{c.kind} {c.chip_id}",
                    "utilization": round(c.mxu_duty_pct, 1)
                    if c.mxu_duty_pct is not None
                    else None,
                    "memoryUsed": round(c.hbm_used / 2**20)
                    if c.hbm_used is not None
                    else None,
                    "memoryTotal": round(c.hbm_total / 2**20)
                    if c.hbm_total is not None
                    else None,
                    "temperature": c.temp_c,
                }
            )
        return out

    def _api_pods(self) -> dict:
        s = self.sampler.sample_of("k8s")
        # Copies: handlers must not write into sampler-owned pod dicts.
        pods = [dict(p) for p in self.sampler.pods()]
        # Reverse attribution: how many live chips each TPU pod owns.
        owners = attribute_pods(self.sampler.chips(), pods)
        counts: dict[str, int] = {}
        for owner in owners.values():
            counts[owner] = counts.get(owner, 0) + 1
        for p in pods:
            p["chips"] = counts.get(f"{p.get('namespace')}/{p.get('name')}", 0)
        return {
            "pods": pods,
            "health": s.health_json() if s else {"ok": False, "error": "not sampled"},
        }

    def _api_alerts(self) -> dict:
        engine = self.sampler.engine
        return {
            **engine.last,
            "evaluated_at": engine.last_ts,
            "events": engine.recent_events(50),
            "silenced": engine.last_silenced,
            "silences": [
                {"key": k, "until": until} for k, until in sorted(engine.silences.items())
            ],
        }

    def _api_serving(self) -> dict:
        s = self.sampler.sample_of("serving")
        return {
            "targets": self.sampler.serving_data(),
            "health": s.health_json() if s else {"ok": False, "error": "not sampled"},
        }

    def _api_accel_wire(self) -> dict:
        """Compact columnar chip snapshot for peer federation
        (tpumon_torch.collectors.accel_peers): positional rows instead of
        per-chip key/value dicts — a fraction of the bytes and parse
        work of /api/accel/metrics at 256 chips."""
        return chips_to_wire(self.sampler.chips())

    def _api_federation(self) -> dict:
        """Aggregator-tree status (the federation tree): this node's
        role, uplink stream state, per-downstream fan-in state, the
        failure-domain-aware slice table and fleet totals."""
        hub = getattr(self.sampler, "federation", None)
        uplink = getattr(self.sampler, "uplink", None)
        out: dict = {
            "role": self.cfg.federation_role
            or ("leaf" if uplink is not None else "standalone"),
        }
        if uplink is not None:
            out["uplink"] = uplink.to_json()
        if hub is not None:
            out.update(hub.to_json())
        leader = getattr(self.sampler, "leader", None)
        if leader is not None:
            out["leader"] = leader.to_json()
        return out

    def _api_slo(self) -> dict:
        """SLO objectives (tpumon_torch.slo): budget remaining + fast/slow
        burn rates per objective; an empty list when none configured
        (the route always answers — the lint's liveness contract)."""
        slo = self.sampler.slo
        if slo is None:
            return {"slos": [], "evaluated_at": None}
        return slo.to_json()

    def _api_actuate(self) -> dict:
        """Actuation engine (tpumon_torch.actuate): per-policy state machine
        rows, guard counters and the last journaled transition; an
        empty policy list when none configured (the route always
        answers — the lint's liveness contract)."""
        actuate = self.sampler.actuate
        if actuate is None:
            return {"policies": [], "evaluated_at": None}
        return actuate.to_json()

    def _api_trace(self) -> dict:
        """Self-trace view: ring stats, per-stage p50/p95/max, per-route
        HTTP latency summary, the last tick's stage breakdown, recent
        spans — plus the device profiler's status (the latest
        torch.profiler capture is the trace's deep-dive link)."""
        out = self.sampler.tracer.to_json()
        out["profile"] = self._profiler.status()
        return out

    def _events_request(
        self, query: str, if_none_match: str | None
    ) -> tuple[int, str, bytes, dict]:
        """GET /api/events: cursor-paginated, filtered journal page,
        served through the epoch render cache on the "events" section —
        between journal changes every request (incl. a pollling CLI)
        reuses the same bytes. Query-derived cache keys are evictable;
        a relative ``since`` quantizes to a 10 s grid so a polling
        client doesn't cycle the eviction cap."""
        params = parse_query(query)
        try:
            after = int(params["after"]) if "after" in params else None
            limit = min(1000, max(1, int(params.get("limit", "100"))))
        except ValueError:
            raise HttpError(400, "after/limit want integers")
        kind = params.get("kind")
        if kind is not None and kind not in KINDS:
            raise HttpError(400, f"unknown kind {kind!r}; known: {list(KINDS)}")
        severity = params.get("severity")
        if severity is not None and severity not in SEVERITIES:
            raise HttpError(
                400, f"unknown severity {severity!r}; known: {list(SEVERITIES)}"
            )
        since = None
        if "since" in params:
            raw = params["since"]
            try:
                since = float(raw)  # absolute unix timestamp
            except ValueError:
                dur = parse_duration(raw, default=-1.0)
                if dur <= 0:
                    raise HttpError(400, f"bad since {raw!r} (ts or '10m')")
                since = round((time.time() - dur) / 10.0) * 10.0
        journal = self.sampler.journal

        def build() -> bytes:
            events = journal.query(
                after=after, kind=kind, severity=severity,
                since=since, limit=limit,
            )
            cursor = (
                events[-1]["seq"]
                if events
                else (after if after is not None else journal.seq)
            )
            return json.dumps(
                {"events": events, "cursor": cursor, **journal.to_json()}
            ).encode()

        key = (
            f"/api/events?a={after}&k={kind}&s={severity}"
            f"&t={since or ''}&n={limit}"
        )
        return self._etagged(key, ("events",), build, if_none_match, evictable=True)

    # ------------------------- query engine routes -------------------------

    async def _query_request(
        self, query: str, if_none_match: str | None, auth: str | None
    ) -> tuple[int, str, bytes, dict]:
        """GET /api/query: one instant evaluation (tpumon_torch.query).
        Local evaluations ride the epoch render cache ("samples" moves
        once per tick, so a polling dashboard reuses the bytes between
        ticks) with the expression in the evictable cache key; fleet
        evaluations await remote partials and are never cached."""
        params = parse_query(query)
        src = params.get("query")
        engine = self.sampler.query
        if src is None:
            # Bare GET: engine info (functions, rules, cache stats) —
            # the discoverability payload, and what keeps the
            # registered-routes-answer lint meaningful.
            return self._etagged(
                "/api/query#info",
                ("samples",),
                lambda: json.dumps(engine.to_json()).encode(),
                if_none_match,
            )
        src = urllib.parse.unquote_plus(src)
        at = None
        if "time" in params:
            try:
                at = float(params["time"])
            except ValueError:
                raise HttpError(400, f"bad time {params['time']!r}")
        if params.get("fleet") in ("1", "true"):
            # A fleet query fans TPWQ sub-queries across the whole tree
            # per request with no cache — expensive like /api/profile,
            # and gated the same way when a token is configured.
            self._check_auth(auth)
            hub = getattr(self.sampler, "federation", None)
            if hub is None:
                raise HttpError(
                    400,
                    "fleet=1 needs federation_role aggregator|root "
                    "(this node has no downstream tree)",
                )
            # Opt this request's open http span into fleet tracing: the
            # span gains a trace id (keeping one that arrived via
            # X-Tpumon-Trace) and every TPWQ pushed below carries it —
            # the whole fan-out becomes one cross-node trace.
            self.sampler.tracer.ensure_trace()
            try:
                payload = await hub.fleet_query(
                    src, at=at, timeout_s=self.cfg.query_fleet_timeout_s
                )
            except QueryError as e:
                raise HttpError(400, str(e))
            return 200, "application/json", json.dumps(payload).encode(), {}
        try:
            return self._etagged(
                f"/api/query?q={src}&t={'' if at is None else at}",
                ("samples",),
                lambda: json.dumps(engine.instant(src, at=at)).encode(),
                if_none_match,
                evictable=True,
            )
        except QueryError as e:
            raise HttpError(400, str(e))

    def _query_range_request(
        self, query: str, if_none_match: str | None
    ) -> tuple[int, str, bytes, dict]:
        """GET /api/query_range: step-grid evaluation over the trailing
        window, same caching contract as /api/history (window clamped
        to the ring's retention; key evictable)."""
        params = parse_query(query)
        src = params.get("query")
        engine = self.sampler.query
        if src is None:
            return self._etagged(
                "/api/query#info",
                ("samples",),
                lambda: json.dumps(engine.to_json()).encode(),
                if_none_match,
            )
        src = urllib.parse.unquote_plus(src)
        window_s = parse_duration(params.get("window", "30m"), default=-1.0)
        step_s = parse_duration(params.get("step", "30s"), default=-1.0)
        if window_s <= 0:
            raise HttpError(400, f"bad window {params.get('window')!r}")
        if step_s <= 0:
            raise HttpError(400, f"bad step {params.get('step')!r}")
        window_s = self.history.clamp_window(window_s)
        end = None
        if "end" in params:
            try:
                end = float(params["end"])
            except ValueError:
                raise HttpError(400, f"bad end {params['end']!r}")
        try:
            return self._etagged(
                f"/api/query_range?q={src}&w={window_s}&s={step_s}"
                f"&e={'' if end is None else end}",
                ("samples",),
                lambda: json.dumps(
                    engine.range_query(src, window_s, step_s, end=end)
                ).encode(),
                if_none_match,
                evictable=True,
            )
        except QueryError as e:
            raise HttpError(400, str(e))

    def realtime_payload(self) -> dict:
        """The push payload: everything the dashboard's fast loop needs."""
        return {
            "host": self._api_host(),
            "accel": self._api_accel(),
            "alerts": {
                sev: len(items)
                for sev, items in self.sampler.engine.last.items()
                if isinstance(items, list)
            },
            # Last tick's stage timeline (tpumon_torch.tracing) — the
            # dashboard's self-trace strip; None when tracing is off.
            "trace": self.sampler.tracer.last_tick,
            # Journal tail for the live event feed: bounded, so the
            # steady-state delta is one shifted 20-row window at most.
            "events": {
                "seq": self.sampler.journal.seq,
                "recent": self.sampler.journal.recent(20),
            },
            # Actuation card (tpumon_torch.actuate): the full /api/actuate
            # body — small (a row per policy) and delta-friendly (rows
            # only change on state/value transitions).
            "actuate": self._api_actuate(),
        }

    # ------------------------------ SSE stream -----------------------------

    def _sse_frame(self, client_ver: int, force_key: bool) -> tuple[bytes, int, bool]:
        """One frame for a client last synced at ``client_ver``.

        Returns (frame bytes sans SSE framing, new client version,
        was_keyframe). The per-epoch payload, keyframe bytes and delta
        bytes are shared across every connected client — the tick, not
        the client count, is the unit of serialization work.
        """
        st = self._sse
        tr = self.sampler.tracer
        ver = self.sampler.clock.version_of(*self._rt_sections)
        if st["ver"] != ver:
            # Per-tick shared work: build the payload once for every
            # connected client ("sse" span — the fan-out's unit cost).
            with tr.span("sse", track="sse"):
                st["prev_ver"], st["prev_payload"] = st["ver"], st["payload"]
                st["ver"], st["payload"] = ver, self.realtime_payload()
                st["key_bytes"] = None
                st["patch_bytes"] = None
        if client_ver == ver and not force_key:
            # Nothing new since this client's last frame: heartbeat.
            return (
                json.dumps({"epoch": ver, "prev": ver, "patch": None}).encode(),
                ver,
                False,
            )
        if not force_key and client_ver == st["prev_ver"] and st["prev_payload"] is not None:
            if st["patch_bytes"] is None:
                with tr.span("delta", track="sse"):
                    patch = diff(st["prev_payload"], st["payload"])
                    st["patch_bytes"] = json.dumps(
                        {"epoch": ver, "prev": st["prev_ver"], "patch": patch}
                    ).encode()
            return st["patch_bytes"], ver, False
        # New client, gap, or scheduled keyframe: full snapshot.
        if st["key_bytes"] is None:
            with tr.span("sse", track="sse"):
                st["key_bytes"] = json.dumps(
                    {"epoch": ver, "key": st["payload"]}
                ).encode()
        return st["key_bytes"], ver, True

    async def _sse_broadcast(self) -> None:
        """The fan-out loop: once per sampler tick, render each frame's
        bytes ONCE (shared via the ``_sse`` memo) and enqueue them to
        every connected client. put_nowait never blocks, so one client
        with a full TCP window cannot stall the tick for the rest —
        its queue is cleared, the overrun counted, and its next frame
        forced to a keyframe (the same resync contract a reconnect or
        epoch gap gets)."""
        interval = max(0.25, self.cfg.sample_interval_s)
        keyframe_every = max(1, self.cfg.sse_keyframe_every)
        while self._sse_clients:
            for c in list(self._sse_clients.values()):
                frame, ver, was_key = self._sse_frame(
                    c["ver"],
                    force_key=c["needs_key"]
                    or c["since_key"] >= keyframe_every,
                )
                try:
                    c["queue"].put_nowait(frame)
                except asyncio.QueueFull:
                    while not c["queue"].empty():
                        c["queue"].get_nowait()
                    c["needs_key"] = True
                    self.sse_overruns += 1
                    continue  # client_ver unchanged: it never got this
                c["ver"] = ver
                c["needs_key"] = False
                c["since_key"] = 1 if was_key else c["since_key"] + 1
            # Wake on the next sampler tick; the timeout keeps streams
            # heartbeating when the sampler loops aren't running
            # (primed-only test servers, wedged fast loop).
            await self.sampler.wait_tick(timeout_s=max(2 * interval, 2.0))

    async def _stream(self, writer: asyncio.StreamWriter) -> None:
        """SSE connection handler: delta frames keyed by snapshot epoch.

        Protocol (applied by web/dashboard.js):
          {"epoch": E, "key": {...}}              keyframe (full payload)
          {"epoch": E, "prev": P, "patch": node}  delta from epoch P
          {"epoch": E, "prev": E, "patch": null}  heartbeat (no change)
        A client whose last epoch isn't the frame's ``prev`` detects the
        gap and resyncs (reconnect → immediate keyframe); keyframes also
        recur every ``sse_keyframe_every`` frames so a silently desynced
        consumer is bounded.

        Frames are produced by the shared ``_sse_broadcast`` task; this
        handler writes the first keyframe synchronously (a new client
        must not wait out a tick to paint) then drains its queue.
        """
        head = (
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: text/event-stream\r\n"
            "Cache-Control: no-cache\r\n"
            "Access-Control-Allow-Origin: *\r\n"
            "Connection: close\r\n\r\n"
        )
        writer.write(head.encode("latin-1"))
        await writer.drain()
        cid = self._sse_next_id
        self._sse_next_id += 1
        client = {
            "queue": asyncio.Queue(maxsize=SSE_QUEUE_FRAMES),
            "ver": -1,
            "since_key": 1,
            "needs_key": False,
        }
        # Register BEFORE the first write: the broadcaster only runs at
        # this handler's next await, by which point the immediate
        # keyframe below has already settled this client's epoch.
        self._sse_clients[cid] = client
        if self._sse_broadcaster is None or self._sse_broadcaster.done():
            self._sse_broadcaster = asyncio.create_task(
                self._sse_broadcast())
        try:
            frame, client["ver"], _ = self._sse_frame(-1, force_key=True)
            writer.write(b"data: " + frame + b"\n\n")
            await writer.drain()
            while True:
                frame = await client["queue"].get()
                writer.write(b"data: " + frame + b"\n\n")
                await writer.drain()  # raises once the client is gone
        finally:
            self._sse_clients.pop(cid, None)

    def _api_health(self) -> dict:
        q_all = quantiles(self.request_latencies_ms)
        per_path = {}
        for path, d in sorted(self.per_path_latencies_ms.items()):
            q = quantiles(d)
            if q is not None:
                per_path[path] = {
                    "requests": len(d),
                    "latency_p50_ms": round(q[0], 3),
                    "latency_p95_ms": round(q[1], 3),
                }
        return {
            **self.sampler.health_json(),
            # Active fault-injection spec (tpumon_torch.collectors.chaos) — a
            # soak run must be unmistakable as such in every health view.
            **({"chaos": self.cfg.chaos} if self.cfg.chaos else {}),
            "http": {
                "requests": len(self.request_latencies_ms),
                "latency_p50_ms": round(q_all[0], 3) if q_all else None,
                "latency_p95_ms": round(q_all[1], 3) if q_all else None,
                "per_path": per_path,
                # SSE slow-consumer drop-and-resync episodes (bounded
                # per-client queues; see _sse_broadcast).
                "sse_overruns": self.sse_overruns,
                "sse_clients": len(self._sse_clients),
            },
            # Fast-path health: how much render work the epoch caches
            # absorbed (tpumon_torch.snapshot; pinned by tests/test_fastpath).
            "render_cache": self.cache.to_json(),
            "exporter_cache": self.exporter_cache.to_json(),
            # Crash-safe history snapshot state incl. the idle-skip
            # counter (saves skipped because nothing was recorded).
            **(
                {"history_snapshot": self.snapshotter.to_json()}
                if self.snapshotter is not None
                else {}
            ),
        }

    async def _api_profile(self, query: str) -> dict:
        try:
            import torch  # noqa: F401 — capture needs it; fail before starting
        except ImportError:
            raise HttpError(503, "profiling requires torch")
        params = parse_query(query)
        if "seconds" not in params:
            return self._profiler.status()
        try:
            seconds = float(params["seconds"])
        except ValueError:
            raise HttpError(400, f"bad seconds value {params['seconds']!r}")
        try:
            return await self._profiler.capture(seconds)
        except ProfileBusy as e:
            raise HttpError(409, str(e))
        except RuntimeError as e:  # an activity asked for has no device
            raise HttpError(503, str(e))

    def _handle_post(self, path: str, body: bytes) -> tuple[int, str, bytes]:
        """POST routes: alert silences (Alertmanager-style mutes)."""
        if path not in ("/api/silence", "/api/unsilence"):
            raise HttpError(405, "method not allowed")
        try:
            data = json.loads(body or b"{}")
        except json.JSONDecodeError as e:
            raise HttpError(400, f"bad JSON body: {e}")
        key = data.get("key")
        if not key or not isinstance(key, str):
            raise HttpError(400, 'body wants {"key": "<alert key prefix>", ...}')
        if path == "/api/unsilence":
            removed = self.sampler.engine.unsilence(key)
            payload = {"unsilenced": key, "existed": removed}
        else:
            duration = parse_duration(data.get("duration", "1h"), default=-1.0)
            if duration <= 0:
                raise HttpError(400, f"bad duration {data.get('duration')!r}")
            until = self.sampler.engine.silence(key, duration)
            payload = {"silenced": key, "until": until}
        # The mutation happened outside the sampler's evaluation loop:
        # invalidate the cached /api/alerts render immediately — and the
        # events section too (silence/unsilence are journal events).
        self.sampler.mark_alerts_dirty()
        self.sampler.mark_events_dirty()
        return 200, "application/json", json.dumps(payload).encode()

    def _check_auth(self, auth: str | None) -> None:
        """Bearer-token gate for mutating/expensive routes. No token
        configured => open (reference parity); configured => constant-time
        comparison against `Authorization: Bearer <token>`."""
        token = self.cfg.auth_token
        if not token:
            return
        scheme, _, presented = (auth or "").partition(" ")
        # Bytes comparison: compare_digest on str raises TypeError for
        # non-ASCII input (the header arrives latin-1-decoded), which
        # would turn a bad credential into a 500 instead of a 401.
        if scheme.lower() != "bearer" or not hmac.compare_digest(
            presented.strip().encode("utf-8", "surrogateescape"),
            token.encode("utf-8"),
        ):
            raise HttpError(401, "authorization required (Bearer token)")

    async def handle(
        self,
        method: str,
        path: str,
        query: str = "",
        body: bytes = b"",
        auth: str | None = None,
        accept: str | None = None,
    ) -> tuple[int, str, bytes]:
        """Route a request; returns (status, content_type, body)."""
        status, ctype, body, _headers = await self.handle_ex(
            method, path, query, body, auth=auth, accept=accept
        )
        return status, ctype, body

    def _etagged(
        self, key: str, sections: tuple[str, ...], build, if_none_match: str | None,
        ctype: str = "application/json", evictable: bool = False,
    ) -> tuple[int, str, bytes, dict]:
        """Serve a route from the epoch render cache with ETag/304.

        ``build`` runs only when one of ``sections`` changed since the
        last render; between ticks every request gets the same bytes,
        and a client presenting the current ETag gets an empty 304.
        ``evictable`` marks request-derived keys (history windows) that
        live under the cache's bounded-eviction cap.

        The returned headers carry a private ``X-Tpumon-Cache`` entry
        (hit/miss for THIS request — derived synchronously around the
        cache call, so concurrent requests can't cross-attribute) that
        ``handle_ex`` pops into the http span before responding.
        """
        renders0 = self.cache.renders
        body, etag = self.cache.get(key, sections, build, evictable=evictable)
        outcome = "miss" if self.cache.renders > renders0 else "hit"
        if if_none_match is not None and if_none_match == etag:
            return 304, ctype, b"", {"ETag": etag, "X-Tpumon-Cache": outcome}
        return 200, ctype, body, {"ETag": etag, "X-Tpumon-Cache": outcome}

    def routes(self) -> tuple[str, ...]:
        """Every route this server answers — the registry the
        route-table lint (tests/test_routes_doc.py) checks against the
        README and this module's docstring, so a new endpoint cannot
        ship undocumented."""
        return tuple(
            sorted(
                set(self._cached_routes)
                | {
                    "/", "/monitor.html", "/index.html", "/dashboard",
                    "/logo.svg", "/chartcore.js", "/dashboard.js",
                    "/metrics", "/api/health", "/api/history",
                    "/api/query", "/api/query_range",
                    "/api/events", "/api/federation/ingest",
                    "/api/profile", "/api/stream", "/api/trace/export",
                    "/api/silence", "/api/unsilence",
                }
            )
        )

    async def handle_ex(
        self,
        method: str,
        path: str,
        query: str = "",
        body: bytes = b"",
        auth: str | None = None,
        if_none_match: str | None = None,
        accept: str | None = None,
        trace: str | None = None,
    ) -> tuple[int, str, bytes, dict]:
        """Route a request; returns (status, content_type, body,
        extra response headers). Every request is bracketed by an
        "http" span tagged with route/status/bytes and whether the
        epoch render cache absorbed it. ``trace`` is a raw
        ``X-Tpumon-Trace`` header value: when present (and parseable)
        the span joins that fleet trace with a cross-node parent link,
        so an HTTP hop between tpumon nodes is one tree with the
        caller's spans."""
        tr = self.sampler.tracer
        with tr.span(
            "http", cat="http", track="http",
            remote=parse_trace_header(trace),
        ) as sp:
            try:
                status, ctype, rbody, headers = await self._route(
                    method, path, query, body, auth, if_none_match, accept
                )
            except HttpError as e:
                # Errors on unregistered paths share one histogram key
                # (this includes pre-routing 401s when auth is on): a
                # URL scanner must not grow the per-route table.
                sp.tag(
                    route=path if path in self._route_set else "(unmatched)",
                    method=method,
                    status=e.status,
                )
                raise
            except Exception:
                # Handler bug: _client turns this into a 500. The span
                # must still carry route/status or the request would
                # hide under "(other)" in the very histograms meant to
                # diagnose it (the span's own error tag records the
                # exception type).
                sp.tag(
                    route=path if path in self._route_set else "(unmatched)",
                    method=method,
                    status=500,
                )
                raise
            # Cache attribution comes from THIS request's _etagged call
            # (a private header popped before the response goes out) —
            # diffing the global hit/render counters would misattribute
            # under concurrent requests suspended mid-route.
            cache_state = headers.pop("X-Tpumon-Cache", None)
            sp.tag(route=path, method=method, status=status, bytes=len(rbody))
            if cache_state:
                sp.tag(cache=cache_state)
        return status, ctype, rbody, headers

    async def _route(
        self,
        method: str,
        path: str,
        query: str,
        body: bytes,
        auth: str | None,
        if_none_match: str | None,
        accept: str | None = None,
    ) -> tuple[int, str, bytes, dict]:
        if method == "POST":
            self._check_auth(auth)
            return (*self._handle_post(path, body), {})
        if (
            path == "/api/accel/wire"
            and self.cfg.wire_binary
            and accept is not None
            and WIRE_FRAME_CTYPE in accept
        ):
            # Binary representation of the federation wire (negotiated,
            # never the default: a client that didn't ask gets JSON).
            # Its own cache key — the bytes differ per representation —
            # and the key is baked into the ETag, so a client switching
            # representations can't get a wrong 304.
            def build() -> bytes:
                w = chips_to_wire(self.sampler.chips())
                return encode_wire_frame(w["v"], w["fields"], w["rows"])

            return self._etagged(
                "/api/accel/wire#bin", ("accel",), build, if_none_match,
                ctype=WIRE_FRAME_CTYPE,
            )
        if path in ("/", "/monitor.html", "/index.html", "/dashboard"):
            return 200, self._dashboard.content_type, self._dashboard.read(), {}
        if path == "/logo.svg":
            return 200, self._logo.content_type, self._logo.read(), {}
        if path == "/chartcore.js":
            return 200, self._chartcore.content_type, self._chartcore.read(), {}
        if path == "/dashboard.js":
            return 200, self._dashboard_js.content_type, self._dashboard_js.read(), {}
        if path == "/metrics":
            return self._etagged(
                "/metrics",
                ("host", "accel", "k8s", "serving", "alerts", "samples"),
                lambda: render_exporter(
                    self.sampler,
                    cache=self.exporter_cache,
                    profiler=self._profiler,
                ),
                if_none_match,
                ctype="text/plain; version=0.0.4; charset=utf-8",
            )

        if (
            path == "/api/trace"
            and parse_query(query).get("fleet") in ("1", "true")
        ):
            # Fleet assembly: the base self-trace payload
            # plus the hub's federation block — per-origin freshness,
            # clock offsets, and the cross-node span buffer shifted
            # onto this node's clock. Uncached like the export: a
            # debugging view whose value is being exactly current.
            hub = getattr(self.sampler, "federation", None)
            if hub is None:
                raise HttpError(
                    400,
                    "fleet=1 needs federation_role aggregator|root "
                    "(this node assembles no downstream spans)",
                )
            payload = self._api_trace()
            payload["fleet"] = hub.fleet_trace_json()
            return 200, "application/json", json.dumps(payload).encode(), {}

        cached = self._cached_routes.get(path)
        if cached is not None:
            sections, payload_fn = cached
            return self._etagged(
                path,
                sections,
                lambda: json.dumps(payload_fn()).encode(),
                if_none_match,
            )

        if path == "/api/events":
            return self._events_request(query, if_none_match)
        if path == "/api/query":
            return await self._query_request(query, if_none_match, auth)
        if path == "/api/query_range":
            return self._query_range_request(query, if_none_match)

        payload = None
        if path == "/api/history":
            params = parse_query(query)
            window_s = None
            if "window" in params:
                window_s = parse_duration(params["window"], default=-1.0)
                if window_s <= 0:
                    raise HttpError(400, f"bad window {params['window']!r}")
            series = params.get("series")
            if series is not None:
                series = urllib.parse.unquote(series)
                if not series or len(series) > 120 or not all(
                    ch.isalnum() or ch in "._*?[]-/:" for ch in series
                ):
                    raise HttpError(400, f"bad series glob {series!r}")
            # The payload is a pure function of the ring's contents,
            # which only grow when a tick records ("samples" moves on
            # every poll) — cacheable per window. Quantize the clamped
            # window to its render-step grid (step_for targets ~60
            # points, so windows within one step render identically
            # anyway): arbitrary ?window= values collapse onto a few
            # keys instead of cycling the bounded eviction. The BODY is
            # built from the same quantized window, so key ⇔ payload
            # stays exact.
            wq = None
            if window_s:
                w = self.history.clamp_window(window_s)
                step = self.history.step_for(w)
                wq = max(60.0, round(w / step) * step)
            return self._etagged(
                f"/api/history?w={wq or ''}&s={series or ''}",
                ("samples",),
                lambda: json.dumps(
                    self.history.snapshot_ring(window_s=wq, series=series)
                ).encode(),
                if_none_match,
                evictable=True,
            )
        elif path == "/api/health":
            payload = self._api_health()
        elif path == "/api/trace/export":
            # Perfetto/chrome://tracing-loadable dump of the span ring.
            # Not cached: the export is a debugging artifact fetched
            # rarely, and its value is being exactly current. ?fleet=1
            # adds the buffered remote spans, one Perfetto process
            # track per node, clock-shifted via the hub's offsets.
            if parse_query(query).get("fleet") in ("1", "true"):
                hub = getattr(self.sampler, "federation", None)
                if hub is None:
                    raise HttpError(
                        400,
                        "fleet=1 needs federation_role aggregator|root "
                        "(this node assembles no downstream spans)",
                    )
                payload = self.sampler.tracer.export_chrome(
                    fleet=True, offsets=hub.clock_offsets
                )
            else:
                payload = self.sampler.tracer.export_chrome()
        elif path == "/api/profile":
            self._check_auth(auth)  # capture burns device time; gate it
            payload = await self._api_profile(query)
        if payload is None:
            raise HttpError(404, "Not Found")
        return 200, "application/json", json.dumps(payload).encode(), {}

    # ---------------------------- HTTP plumbing ----------------------------

    async def _client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._client_writers.add(writer)
        try:
            # Serve requests until the client stops asking to keep the
            # connection open (or an idle keep-alive socket times out):
            # federating peers revalidate every tick, so re-handshaking
            # TCP per poll would tax exactly the hottest clients.
            while await self._serve_one(reader, writer):
                pass
        except (asyncio.TimeoutError, ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._client_writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _serve_one(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> bool:
        """Read and answer ONE request; returns True to hold the
        connection for another (the client explicitly sent
        ``Connection: keep-alive`` on a plain GET/HEAD)."""
        request_line = await asyncio.wait_for(reader.readline(), timeout=10)
        # Latency clock starts AFTER the request line arrives: on a
        # keep-alive connection the wait above is client think-time
        # (a federating peer's whole tick interval), not our latency.
        t0 = time.monotonic()
        if not request_line:
            return False
        try:
            method, target, _version = request_line.decode("latin-1").split()
        except ValueError:
            return False
        # Drain headers; Content-Length is the only one routing needs
        # (POST bodies for the silence routes).
        content_length = 0
        origin = host_hdr = auth_hdr = inm_hdr = accept_hdr = None
        conn_hdr = te_hdr = node_hdr = tier_hdr = trace_hdr = None
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout=10)
            if line in (b"\r\n", b"\n", b""):
                break
            lower = line.lower()
            if lower.startswith(b"content-length:"):
                try:
                    content_length = int(line.split(b":", 1)[1])
                except ValueError:
                    pass
            elif lower.startswith(b"origin:"):
                origin = line.split(b":", 1)[1].strip().decode("latin-1")
            elif lower.startswith(b"host:"):
                host_hdr = line.split(b":", 1)[1].strip().decode("latin-1")
            elif lower.startswith(b"authorization:"):
                auth_hdr = line.split(b":", 1)[1].strip().decode("latin-1")
            elif lower.startswith(b"if-none-match:"):
                inm_hdr = line.split(b":", 1)[1].strip().decode("latin-1")
            elif lower.startswith(b"accept:"):
                accept_hdr = line.split(b":", 1)[1].strip().decode("latin-1")
            elif lower.startswith(b"connection:"):
                conn_hdr = line.split(b":", 1)[1].strip().decode("latin-1")
            elif lower.startswith(b"transfer-encoding:"):
                te_hdr = line.split(b":", 1)[1].strip().decode("latin-1")
            elif lower.startswith(b"x-tpumon-node:"):
                node_hdr = line.split(b":", 1)[1].strip().decode("latin-1")
            elif lower.startswith(b"x-tpumon-tier:"):
                tier_hdr = line.split(b":", 1)[1].strip().decode("latin-1")
            elif lower.startswith(b"x-tpumon-trace:"):
                trace_hdr = line.split(b":", 1)[1].strip().decode("latin-1")
        # Query stripped from routing (monitor_server.js:250) but kept
        # for the routes that take parameters (/api/profile).
        path, _, query = target.partition("?")

        if method == "OPTIONS":
            await self._respond(writer, 204, "text/plain", b"")
            return False
        if method == "GET" and path == "/api/stream":
            try:
                await self._stream(writer)
            except (ConnectionError, asyncio.CancelledError, OSError):
                pass
            return False
        if method == "POST" and path == "/api/federation/ingest":
            # Push-based federation (the federation tree): a downstream
            # node streams delta frames over a long-lived chunked POST.
            # Handled upstream of handle_ex — the body IS the stream —
            # so the POST auth gate and the cross-origin guard both
            # apply HERE (forged frames would land straight in the
            # fleet view, TSDB and journal otherwise; uplinks send the
            # configured token as a Bearer header).
            try:
                self._check_auth(auth_hdr)
            except HttpError as e:
                await self._respond(
                    writer, e.status, "application/json",
                    json.dumps({"error": e.message}).encode(),
                )
                return False
            if origin and host_hdr:
                origin_host = urllib.parse.urlsplit(origin).netloc
                if origin_host != host_hdr:
                    await self._respond(
                        writer, 403, "application/json",
                        json.dumps(
                            {"error": f"cross-origin POST from {origin} refused"}
                        ).encode(),
                    )
                    return False
            hub = getattr(self.sampler, "federation", None)
            if hub is None:
                await self._respond(
                    writer, 404, "application/json",
                    json.dumps(
                        {"error": "not an aggregator (federation_role unset)"}
                    ).encode(),
                )
                return False
            await hub.handle_ingest(
                reader, writer, node=node_hdr, tier=tier_hdr,
                chunked="chunked" in (te_hdr or "").lower(),
                trace=parse_trace_header(trace_hdr),
            )
            return False
        if method not in ("GET", "HEAD", "POST"):
            await self._respond(
                writer,
                405,
                "application/json",
                json.dumps({"error": "method not allowed"}).encode(),
            )
            return False
        # CSRF guard for the state-mutating POST routes: a browser
        # always sends Origin on cross-origin POSTs; reject any whose
        # host differs from the Host we're being addressed as.
        # Non-browser clients (curl, scripts) send no Origin and pass.
        if method == "POST" and origin and host_hdr:
            # "Origin: null" (sandboxed iframe, data: URL) and
            # unparsable origins are cross-origin too — anything that
            # is present but doesn't match Host is refused.
            origin_host = urllib.parse.urlsplit(origin).netloc
            if origin_host != host_hdr:
                await self._respond(
                    writer,
                    403,
                    "application/json",
                    json.dumps(
                        {"error": f"cross-origin POST from {origin} refused"}
                    ).encode(),
                )
                return False
        req_body = b""
        if method == "POST" and 0 < content_length <= 65536:
            req_body = await asyncio.wait_for(
                reader.readexactly(content_length), timeout=10
            )
        headers: dict = {}
        try:
            status, ctype, body, headers = await self.handle_ex(
                method, path, query, req_body, auth=auth_hdr,
                if_none_match=inm_hdr, accept=accept_hdr, trace=trace_hdr,
            )
        except HttpError as e:
            status, ctype = e.status, "application/json"
            body = json.dumps({"error": e.message}).encode()
        except Exception as e:  # 500-with-JSON (monitor_server.js:292-294)
            status, ctype = 500, "application/json"
            body = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
        if method == "HEAD":
            body = b""
        # Persistent connections only when explicitly requested (the
        # peer federation fetcher does): every pre-existing client gets
        # the old Connection: close behavior unchanged.
        keep_alive = (
            method in ("GET", "HEAD")
            and conn_hdr is not None
            and "keep-alive" in conn_hdr.lower()
        )
        await self._respond(writer, status, ctype, body, headers, keep_alive=keep_alive)
        ms = (time.monotonic() - t0) * 1e3
        self.request_latencies_ms.append(ms)
        # Per-path stats only for served routes: keying on raw client
        # paths would let a URL scanner grow the dict without bound.
        if status != 404:
            self.per_path_latencies_ms.setdefault(
                path, deque(maxlen=512)
            ).append(ms)
        if self.cfg.access_log:
            print(f"{method} {path} {status} {ms:.2f}ms", flush=True)
        return keep_alive

    async def _respond(
        self,
        writer: asyncio.StreamWriter,
        status: int,
        ctype: str,
        body: bytes,
        headers: dict | None = None,
        keep_alive: bool = False,
    ) -> None:
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        head = (
            f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Unknown')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"{extra}"
            # CORS parity with the reference (monitor_server.js:244-248)
            "Access-Control-Allow-Origin: *\r\n"
            "Access-Control-Allow-Methods: GET, POST, OPTIONS\r\n"
            "Access-Control-Allow-Headers: Content-Type\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            "\r\n"
        )
        writer.write(head.encode("latin-1") + body)
        await writer.drain()

    # ------------------------------ lifecycle ------------------------------

    def _ssl_context(self):
        """Server-side TLS: terminate HTTPS on the
        listener when --tls-cert is configured, so the SLO/alerting
        surface isn't plaintext. tls_key defaults to tls_cert (one
        combined PEM). Returns None when TLS is off."""
        if not self.cfg.tls_cert:
            if self.cfg.tls_key:
                raise ValueError(
                    "tls_key is set but tls_cert is not — the server "
                    "cannot terminate TLS without a certificate")
            return None
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(
            self.cfg.tls_cert, self.cfg.tls_key or self.cfg.tls_cert)
        return ctx

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._client, host=self.cfg.host, port=self.cfg.port,
            ssl=self._ssl_context(),
        )

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        # The SSE broadcaster dies first (it sleeps up to a heartbeat
        # interval between fan-outs; letting it linger past stop would
        # leave a pending task when the loop closes).
        if self._sse_broadcaster is not None:
            self._sse_broadcaster.cancel()
            try:
                await self._sse_broadcaster
            except (asyncio.CancelledError, Exception):
                pass
            self._sse_broadcaster = None
        # Client writers close BEFORE wait_closed(): on Python >= 3.12.1
        # wait_closed() waits for connection handlers too, and the
        # long-lived streams (SSE, federation ingest) would hold it
        # open indefinitely otherwise.
        for w in list(self._client_writers):
            try:
                w.close()
            except Exception:
                pass
        self._client_writers.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
