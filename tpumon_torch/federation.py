"""Hierarchical federation: a push-based aggregator tree (a copy of
``tpumon/federation.py`` with the imports rewritten).

The flat peer fan-out (tpumon_torch.collectors.accel_peers) polls every peer
from one instance and tops out around the 256-chip wire format — fine
for one pod, wrong for a pod-of-pods fleet. This module is the scale
step: a three-tier tree

    leaf monitors  →  slice aggregators  →  fleet root

where the data flows UP by push, not by poll. Each downstream node
holds one long-lived chunked POST to its upstream's
``/api/federation/ingest`` route and streams columnar **delta frames**
(tpumon_torch.protowire DeltaStreamEncoder: a baseline keyframe, then
per-tick changed-columns diffs with row masks — steady state ships only
the cells that moved). Tiers differ in WHAT they ship:

- a **leaf** pushes its chip table (topology.WIRE_FIELDS rows — the
  same columns /api/accel/wire serves);
- an **aggregator** ingests leaf frames, materializes chips through the
  zero-copy batch path (topology.chips_from_columns →
  RingHistory.record_batch), computes per-slice rollups (mean/max/p95
  duty, HBM, temp) at ingest, and pushes SLICE-level rows upstream —
  so the root never stores 2048 fine-grained chip series, only
  ``slice.<id>.*`` rollup series that downsample into the TSDB
  mid/coarse tiers like any other series;
- the **root** ingests slice rows and serves the fleet view
  (``GET /api/federation``).

Failure domains ride the same tree. A leaf whose stream goes silent for
``federation_dark_after_s`` is marked **dark** at its aggregator: its
slices flip to ``health="dark"`` (propagated upstream in the slice
rows) and a serious ``federation`` event fires. An aggregator that goes
silent at the root marks its whole subtree **unreachable** — the root
can therefore tell "slice 3 is dark" (its aggregator says so) from
"the aggregator is partitioned" (the root observed the silence itself).

Resync mirrors the SSE client protocol (docs/perf.md): any gap — an
aggregator restart, a dropped connection, a delta the decoder refuses —
tears down the stream, and the reconnecting uplink always opens with a
keyframe. No replay, no duplicated points: the keyframe re-baselines
state, and history landings only ever append the new frame's timestamp.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import random
import time
import urllib.parse

from tpumon_torch import tsdb
from tpumon_torch.collectors import Collector, Sample
from tpumon_torch.protowire import (
    DELTA_STREAM_CTYPE,
    QUERY_REQ_MAGIC,
    QUERY_RES_MAGIC,
    TRACE_SPANS_MAGIC,
    DeltaStreamDecoder,
    DeltaStreamEncoder,
    decode_query_request,
    decode_query_result,
    decode_trace_spans,
    decode_varint,
    encode_query_request,
    encode_query_result,
    encode_trace_spans,
    encode_varint,
)
from tpumon_torch.query import QueryError
from tpumon_torch.resilience import decorrelated_jitter
from tpumon_torch.tracing import format_trace_header
from tpumon_torch.topology import (
    WIRE_VERSION,
    ChipSample,
    chips_from_columns,
    chips_to_wire,
    slice_views,
)

INGEST_PATH = "/api/federation/ingest"

# Slice-rollup wire schema (aggregator → root frames). Same contract
# style as topology.WIRE_FIELDS: order is the wire layout, append new
# fields at the END, bump the version only on incompatible changes.
SLICE_WIRE_VERSION = 1
SLICE_FIELDS: tuple[str, ...] = (
    "slice_id",
    "node",      # which downstream reported it (failure-domain identity)
    "kind",
    "chips",
    "hosts",
    "duty_mean",
    "duty_max",
    "duty_p95",
    "hbm_mean",
    "temp_mean",
    "temp_max",
    "health",    # "ok" | "dark" | "unreachable"
    "ts",        # the sample's own timestamp (not receipt time)
    # Appended later: accelerator family of the slice's chips
    # ("tpu" | "gpu"). Pre-upgrade aggregators omit it; readers default
    # absent to "tpu" (FederationHub.slices) — append-only, old peers
    # decode unchanged.
    "accel_kind",
)

# slice-row key -> history series suffix: the rollup series an
# aggregator or root lands per ingested frame (slice.<id>.<suffix>), which
# downsample into the TSDB mid/coarse tiers at append like any series.
ROLLUP_SERIES: tuple[tuple[str, str], ...] = (
    ("duty_mean", "duty"),
    ("duty_max", "duty_max"),
    ("duty_p95", "duty_p95"),
    ("hbm_mean", "hbm"),
    ("temp_mean", "temp"),
    ("temp_max", "temp_max"),
    ("chips", "chips"),
)

_MAX_RECORD = 16 * 1024 * 1024  # one frame can never plausibly exceed this

# Fleet-tracing bounds. OFFSET_WINDOW: per-link send/recv
# timestamp deltas kept for the clock-offset estimate — the minimum of
# the window is the least-delayed frame, so offset ≈ -min(delta) with
# network/tick jitter filtered out. RELAY_CAP bounds spans an
# aggregator buffers for upstream relay; FRESH_NODES_MAX bounds the
# per-origin freshness/offset tables (origin names arrive over the
# wire from subtrees — the tables must stay bounded even against a
# malicious or miswired downstream, same rule as Hub.MAX_NODES).
OFFSET_WINDOW = 64
RELAY_CAP = 512
RELAY_PER_TICK = 256
FRESH_NODES_MAX = 1024

# Float metric fields the uplink quantizes to f32 before encoding
# (tsdb.quantize_val — the same round-trip the TSDB applies at append
# anyway): an exactly-f32 column rides the delta wire at half width
# (protowire _CT_F32). Identity, capacity and timestamp fields are
# untouched.
_F32_CHIP_FIELDS = frozenset({"mxu_duty_pct", "temp_c"})
_F32_SLICE_FIELDS = frozenset(
    {"duty_mean", "duty_max", "duty_p95", "hbm_mean", "temp_mean", "temp_max"}
)


def _quantize_rows(fields: list[str], rows: list[list], which: frozenset) -> None:
    f32 = tsdb.quantize_val
    for ci, f in enumerate(fields):
        if f in which:
            for row in rows:
                if row[ci] is not None:
                    row[ci] = f32(row[ci])


def slice_rollup_rows(
    chips: list[ChipSample], node: str, ts: float, health: str = "ok"
) -> list[dict]:
    """Per-slice rollup rows for a chip set — the aggregator tier's
    upstream payload and fleet-view unit. Statistics come from
    topology.SliceView (mean/max/p95), so the rollup math lives next to
    the topology model it aggregates."""
    rows = []
    for v in slice_views(chips):
        rows.append(
            {
                "slice_id": v.slice_id,
                "node": node,
                "kind": v.chips[0].kind if v.chips else None,
                "chips": v.reporting_chips,
                "hosts": len(v.hosts),
                "duty_mean": v.mean("mxu_duty_pct"),
                "duty_max": v.max("mxu_duty_pct"),
                "duty_p95": v.p95("mxu_duty_pct"),
                "hbm_mean": v.mean("hbm_pct"),
                "temp_mean": v.mean("temp_c"),
                "temp_max": v.max("temp_c"),
                "health": health,
                "ts": ts,
                "accel_kind": v.accel_kind or "tpu",
            }
        )
    return rows


def _rows_to_wire(rows: list[dict]) -> list[list]:
    return [[r.get(f) for f in SLICE_FIELDS] for r in rows]


def split_records(buf: bytearray) -> list[bytes]:
    """Split complete varint-length-prefixed records off the front of
    ``buf`` (mutates it). Incomplete tails stay buffered; a malformed
    or implausibly-sized prefix raises ValueError (the ingest side
    answers 400 and drops the stream — sender resyncs)."""
    out: list[bytes] = []
    pos = 0
    n = len(buf)
    while pos < n:
        try:
            ln, p2 = decode_varint(bytes(buf[pos : pos + 10]), 0)
        except ValueError:
            if n - pos >= 10:
                raise  # 10 bytes is a full varint: this one is garbage
            break  # genuinely incomplete: wait for more bytes
        if ln > _MAX_RECORD:
            raise ValueError(f"implausible stream record size {ln}")
        if pos + p2 + ln > n:
            break
        out.append(bytes(buf[pos + p2 : pos + p2 + ln]))
        pos += p2 + ln
    del buf[:pos]
    return out


class NodeState:
    """One downstream node's fan-in state at an aggregator or root."""

    __slots__ = (
        "node", "tier", "status", "connected", "decoder", "chips",
        "slice_rows", "last_ts", "last_wall", "frames", "keyframes",
        "resyncs", "bytes", "lagging", "conn", "error", "generation",
        "writer", "wlock", "query_results", "off_win", "offset_s",
    )

    def __init__(self, node: str, tier: str):
        self.node = node
        self.tier = tier  # "leaf" (chip rows) | "aggregator" (slice rows)
        self.status = "ok"
        self.connected = False
        self.decoder = DeltaStreamDecoder()
        self.chips: list[ChipSample] = []
        self.slice_rows: list[dict] = []
        self.last_ts: float | None = None
        self.last_wall: float | None = None
        self.frames = 0
        self.keyframes = 0
        self.resyncs = 0
        self.bytes = 0
        self.lagging = False
        self.conn: object | None = None  # current connection token
        self.error: str | None = None
        # Highest leadership generation stamped on this node's frames
        # (0 = unfenced / pre-upgrade peer; tpumon_torch.leader).
        self.generation = 0
        # Live ingest-stream writer + its write lock — the hub's
        # query push-down channel (TPWQ frames flow DOWN the same
        # socket the delta frames flow up; cleared on disconnect).
        self.writer: asyncio.StreamWriter | None = None
        self.wlock: asyncio.Lock | None = None
        self.query_results = 0  # TPWR partial-result frames received
        # Clock-offset estimation: recv_wall - frame_ts for
        # the last OFFSET_WINDOW data frames. Every delta is
        # (local_clock - sender_clock) + transit delay with delay >= 0,
        # so offset_s = sender - local ≈ -min(window) — the least-
        # delayed frame carries the purest skew reading. No wall-clock
        # trust: the estimate survives a sender whose NTP is hours off.
        self.off_win: list[float] = []
        self.offset_s: float | None = None

    def to_json(self) -> dict:
        return {
            "tier": self.tier,
            "status": self.status,
            "connected": self.connected,
            "frames": self.frames,
            "keyframes": self.keyframes,
            "resyncs": self.resyncs,
            "bytes": self.bytes,
            "slices": len(self.slice_rows),
            "chips": len(self.chips),
            "last_ts": self.last_ts,
            "age_s": (
                round(time.monotonic() - self.last_wall, 3)
                if self.last_wall is not None
                else None
            ),
            "generation": self.generation,
            "offset_ms": (
                round(self.offset_s * 1e3, 3)
                if self.offset_s is not None
                else None
            ),
            **({"error": self.error} if self.error else {}),
        }


class FederationHub:
    """Aggregator- or root-side fan-in: ingests downstream delta streams,
    lands rollups in the TSDB, and owns the failure-domain health view.

    Created by tpumon_torch.app.build when ``federation_role`` is
    ``aggregator`` or ``root`` and bound to the sampler (history,
    journal, epoch clock) once it exists. All ingest work runs on the
    event loop — one task per downstream connection."""

    # Bound on distinct downstream nodes: the table is keyed on the
    # client-supplied X-Tpumon-Node header, so without a cap any client
    # could grow it (and the fleet view) without limit — same rule as
    # the server's per-path latency table.
    MAX_NODES = 256

    def __init__(self, node: str, role: str = "aggregator", dark_after_s: float = 5.0):
        self.node = node
        self.role = role
        self.dark_after_s = max(0.25, dark_after_s)
        # A dark, disconnected node is eventually FORGOTTEN (renamed or
        # decommissioned leaves must not pin stale slices in the fleet
        # view forever); generous so a long outage still reads as dark,
        # not as absent.
        self.forget_after_s = max(600.0, 24 * self.dark_after_s)
        self.nodes: dict[str, NodeState] = {}
        self.sampler = None
        self.history = None
        self.journal = None
        self.clock = None
        # Root HA (tpumon_torch.leader): the root's LeaderLease — observes
        # generations on ingested frames (fencing heal path) and stamps
        # pushed TPWQ sub-queries. Aggregators have no lease; they
        # relay the newest generation their own uplink has seen via
        # ``gen_source`` (wired by tpumon_torch.app.build).
        self.lease = None
        self.gen_source = None
        # Aggregator-with-local-chips case: the merged collector
        # stashes the LOCAL chips here so upstream rollups cover them
        # without double-counting the hub's own downstream chips.
        self.local_chips: list[ChipSample] = []
        self.frames = 0
        # Distributed-query plumbing (docs/query.md): in-flight TPWQ
        # sub-queries awaiting a downstream TPWR, keyed by qid.
        self._qid = 0
        self._pending: dict[int, asyncio.Future] = {}
        # Journal hygiene: partial answers and per-node sub-query
        # timeouts record on TRANSITIONS only (a dashboard polling a
        # tree with one dark leaf must not flood the bounded event
        # ring with an identical event per poll — same contract as the
        # peer/federation kinds).
        self._partial_missing: frozenset = frozenset()
        self._timeout_logged: set[str] = set()
        # Fleet tracing (docs/observability.md "Distributed
        # tracing"): per-origin clock offsets in SECONDS
        # (origin_clock - local_clock; direct children measured from
        # frame send/recv pairs, grandchildren composed from TPWS
        # offsets_s relays), spans buffered for upstream relay at a
        # non-root tier, the latest per-origin end-to-end freshness
        # snapshot, and the last ingested frame's trace context (the
        # root tick's fed.render span links to it, then clears it).
        self.clock_offsets: dict[str, float] = {}
        self.span_relay: list[dict] = []
        self.spans_relayed = 0
        self.freshness_now: dict[str, dict] = {}
        self.last_ingest_ctx: tuple[int, int] | None = None

    def bind(self, sampler) -> None:
        self.sampler = sampler
        self.history = sampler.history
        self.journal = sampler.journal
        self.clock = sampler.clock

    def _tracer(self):
        """The bound sampler's SpanTracer, or None pre-bind — every
        tracing touch point goes through here so a hub exercised
        standalone (tests) never trips on a missing sampler."""
        return getattr(self.sampler, "tracer", None)

    def _bump(self) -> None:
        """Advance the "federation" dirty section — every mutation of
        the published fleet view (frames landing, connect/disconnect,
        dark flips, forgotten nodes) must ride with one of these, or
        /api/federation and the exporter's federation block serve
        stale bytes (tpulint sections.publish-without-bump)."""
        if self.clock is not None:
            self.clock.bump("federation")

    def generation(self) -> int:
        """The leadership generation this tier stamps on pushed TPWQ
        sub-queries: its own lease at a root, the newest token its
        uplink has seen at an aggregator, 0 (unfenced) otherwise."""
        if self.lease is not None:
            return self.lease.generation
        if self.gen_source is not None:
            return self.gen_source()
        return 0

    def _observe_generation(self, gen: int, source: str) -> None:
        if gen > 0 and self.lease is not None:
            self.lease.observe(gen, source)

    # ------------------------------ ingest ------------------------------

    async def handle_ingest(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        node: str | None,
        tier: str | None,
        chunked: bool,
        trace: tuple[int, int, str] | None = None,
    ) -> None:
        """Serve one long-lived downstream push stream. Frames are
        decoded and landed as they arrive; the HTTP response is only
        written when the stream ends (200) or a frame is refused (400 —
        the sender reconnects and resyncs with a keyframe)."""
        peer = writer.get_extra_info("peername")
        node = node or (f"{peer[0]}:{peer[1]}" if peer else "unknown")
        tier = tier if tier in ("leaf", "aggregator") else "leaf"
        ns = self.nodes.get(node)
        if ns is None:
            if len(self.nodes) >= self.MAX_NODES:
                with contextlib.suppress(Exception):
                    body = json.dumps(
                        {"error": f"node table full ({self.MAX_NODES})"}
                    ).encode()
                    writer.write(
                        (
                            "HTTP/1.1 400 Bad Request\r\n"
                            "Content-Type: application/json\r\n"
                            f"Content-Length: {len(body)}\r\n"
                            "Connection: close\r\n\r\n"
                        ).encode("latin-1")
                        + body
                    )
                    await writer.drain()
                return
            ns = self.nodes[node] = NodeState(node, tier)
            if self.journal is not None:
                self.journal.record(
                    "federation", "info", node,
                    f"downstream {tier} {node} connected",
                )
        else:
            ns.tier = tier
            ns.resyncs += 1
        token = object()
        ns.conn = token  # a reconnect supersedes the old stream
        ns.connected = True
        ns.decoder = DeltaStreamDecoder()  # new stream ⇒ fresh baseline
        # Query push-down rides this same socket (server→client bytes
        # on the open POST; the uplink's reader task parses them as
        # varint records).
        ns.writer = writer
        ns.wlock = asyncio.Lock()
        # Connection state is part of the published fleet view
        # (NodeState.to_json "connected"): a connect that lands before
        # the first frame must re-render /api/federation too.
        self._bump()
        tr = self._tracer()
        if trace is not None and tr is not None and tr.enabled:
            # fed.accept: one marker span per accepted stream, remote-
            # parented on the uplink's X-Tpumon-Trace context — NOT an
            # open-ended span over the long-lived POST (which would
            # never close and never land; per-frame work is fed.ingest).
            tid, psid, origin = trace
            tr.record(
                "fed.accept", cat="http", track="http",
                trace=tid, remote_parent=(origin, psid),
                node=ns.node, tier=tier, route=INGEST_PATH,
            )
        status, err = 200, None
        buf = bytearray()
        try:
            while True:
                data = await asyncio.wait_for(
                    self._read_some(reader, chunked), timeout=60
                )
                if data is None:
                    break  # orderly end of stream
                if ns.conn is not token:
                    return  # superseded by a newer connection: bow out
                buf += data
                for frame in split_records(buf):
                    ns.bytes += len(frame)
                    self._ingest_frame(ns, frame)
        except ValueError as e:
            status, err = 400, f"{type(e).__name__}: {e}"
            ns.error = err
            if self.journal is not None:
                self.journal.record(
                    "federation", "minor", node,
                    f"refused frame from {node}: {e} (stream dropped, "
                    f"sender resyncs via keyframe)",
                )
        except (asyncio.TimeoutError, ConnectionError, asyncio.IncompleteReadError):
            pass  # connection-level failure: staleness marks it dark
        finally:
            if ns.conn is token:
                ns.connected = False
                ns.writer = None
                ns.wlock = None
                self._bump()
        with contextlib.suppress(Exception):
            body = (
                b"{}" if err is None
                else json.dumps({"error": err}).encode()
            )
            writer.write(
                (
                    f"HTTP/1.1 {status} {'OK' if status == 200 else 'Bad Request'}\r\n"
                    "Content-Type: application/json\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode("latin-1")
                + body
            )
            await writer.drain()

    async def _read_some(
        self, reader: asyncio.StreamReader, chunked: bool
    ) -> bytes | None:
        """One read step: a chunk (chunked transfer) or a raw segment
        (Connection-close framing). None = orderly end of stream."""
        if not chunked:
            data = await reader.read(65536)
            return data or None
        line = await reader.readline()
        if not line:
            return None
        try:
            size = int(line.split(b";")[0].strip() or b"x", 16)
        except ValueError:
            raise ValueError("bad chunk header")
        if size > _MAX_RECORD:
            raise ValueError(f"implausible chunk size {size}")
        if size == 0:
            with contextlib.suppress(Exception):
                await reader.readline()  # trailing CRLF
            return None
        data = await reader.readexactly(size)
        await reader.readexactly(2)  # CRLF
        return data

    def _ingest_frame(self, ns: NodeState, frame: bytes) -> None:
        if frame[:4] == QUERY_RES_MAGIC:
            # A downstream's answer to a pushed sub-query: resolve the
            # waiting future; never touches the delta decoder or the
            # node's data-liveness clock (a node answering queries but
            # sending no data frames still goes dark honestly).
            qid, partial, error, payload, rgen, _rtrace = decode_query_result(
                frame
            )
            ns.query_results += 1
            self._observe_generation(rgen, ns.node)
            fut = self._pending.get(qid)
            if fut is not None and not fut.done():
                fut.set_result((partial, error, payload))
            return
        if frame[:4] == TRACE_SPANS_MAGIC:
            # Completed spans (and composed clock offsets) relayed from
            # a downstream tier. Advisory, like TPWR: never touches the
            # delta decoder or the liveness clock.
            self._ingest_spans(ns, decode_trace_spans(frame))
            return
        t_start = time.perf_counter()
        res = ns.decoder.apply(frame)  # ValueError → caller answers 400
        t_decode = time.perf_counter()
        self.frames += 1
        ns.frames += 1
        if res["key"]:
            ns.keyframes += 1
        gen = res.get("generation") or 0
        if gen:
            ns.generation = gen
            # Heal path: a downstream that already follows a newer
            # leader fences a stale root through its own frames.
            self._observe_generation(gen, ns.node)
        ns.last_ts = res["ts"]
        ns.last_wall = time.monotonic()
        ns.error = None
        if ns.status != "ok":
            ns.status = "ok"
            if self.journal is not None:
                self.journal.record(
                    "federation", "info", ns.node,
                    f"downstream {ns.node} recovered (keyframe resync)",
                )
        if ns.tier == "aggregator":
            # Slice-level rows from a lower aggregator.
            fields = res["fields"]
            ns.slice_rows = [
                dict(zip(fields, row)) for row in zip(*res["cols"])
            ] if res["cols"] else []
            ns.chips = []
        else:
            # Chip-level rows from a leaf: the zero-parse batch
            # path — columns → positional ChipSamples, rollups at
            # ingest, one record_batch per frame.
            chips = chips_from_columns(res["fields"], res["cols"])
            ns.chips = chips
            ns.slice_rows = slice_rollup_rows(chips, ns.node, res["ts"])
        t_rollup = time.perf_counter()
        self._record_rollups(ns.slice_rows, res["ts"])
        recv_wall = time.time()
        self._observe_offset(ns, res["ts"], recv_wall)
        self._record_freshness(ns, res["ts"], recv_wall)
        self._trace_ingest(ns, res.get("trace"), t_start, t_decode, t_rollup)
        # Rollup lag: frames landing long after their sample time mean
        # the tree is buffering somewhere — one event per transition.
        lag = recv_wall - res["ts"]
        if lag > self.dark_after_s:
            if not ns.lagging:
                ns.lagging = True
                if self.journal is not None:
                    self.journal.record(
                        "federation", "minor", ns.node,
                        f"rollup lag: {ns.node} frames arriving "
                        f"{lag:.1f}s after their sample time",
                        lag_s=round(lag, 2),
                    )
        elif lag < self.dark_after_s / 2:
            ns.lagging = False
        self._bump()

    def _record_rollups(self, rows: list[dict], ts: float) -> None:
        """Land slice rollups in the TSDB through the batch path: one
        record_batch per frame, series named slice.<node>.<id>.<stat>.
        The reporting node is part of the key because slice ids are
        only unique WITHIN a leaf (two leaves can both run a
        "slice-0") — node-qualified series keep per-series timestamps
        monotonic (one writer each), so appends stay on the fast
        path and curves never interleave unrelated slices."""
        if self.history is None or not rows:
            return
        batch = []
        for r in rows:
            sid = r.get("slice_id")
            if not sid:
                continue
            node = r.get("node") or "unknown"
            # Dark/unreachable rows carry LAST-KNOWN metrics for the
            # fleet view — landing those again at fresh timestamps
            # would flat-line the series indistinguishably from a live
            # slice. An outage is an honest gap in the rollup curves.
            if (r.get("health") or "ok") != "ok":
                continue
            for key, suffix in ROLLUP_SERIES:
                v = r.get(key)
                if v is not None:
                    batch.append((f"slice.{node}.{sid}.{suffix}", v))
        if batch:
            self.history.record_batch(batch, ts=ts)

    # ------------------------- fleet tracing ----------------------------
    #
    # docs/observability.md "Distributed tracing": the hub
    # side of cross-node span assembly. Data frames double as clock
    # probes (send/recv timestamp pairs per link), TPWS records relay
    # completed downstream spans plus the sender's own composed offset
    # table, and every landed frame records the per-origin end-to-end
    # freshness series — the latter ALWAYS, tracing on or off (direct
    # children need no TPWS; grandchild offsets compose only while the
    # subtree relays them, i.e. while tracing is on down there).

    def _observe_offset(
        self, ns: NodeState, frame_ts: float, recv_wall: float
    ) -> None:
        win = ns.off_win
        win.append(recv_wall - frame_ts)
        if len(win) > OFFSET_WINDOW:
            del win[: len(win) - OFFSET_WINDOW]
        ns.offset_s = -min(win)
        if ns.node in self.clock_offsets or len(self.clock_offsets) < FRESH_NODES_MAX:
            self.clock_offsets[ns.node] = ns.offset_s

    def _record_freshness(
        self, ns: NodeState, frame_ts: float, recv_wall: float
    ) -> None:
        """Land ``fed.<origin>.freshness_ms`` for every origin node the
        frame carried fresh rows for: the age of the origin's newest
        sample once it became visible HERE, with the origin's clock
        skew corrected via the estimated offset. Leaf frames speak for
        their sender; aggregator frames carry per-row origin nodes and
        origin-stamped timestamps, so one root frame refreshes a whole
        subtree's series. Dark rows (last-known, re-shipped) are
        skipped — an outage is an honest gap, same rule as rollups."""
        if ns.tier == "leaf" or not ns.slice_rows:
            origin_ts = {ns.node: frame_ts}
        else:
            origin_ts = {}
            for r in ns.slice_rows:
                if (r.get("health") or "ok") != "ok":
                    continue
                node, ts = r.get("node"), r.get("ts")
                if node and isinstance(ts, (int, float)):
                    prev = origin_ts.get(node)
                    origin_ts[node] = ts if prev is None else max(prev, ts)
        batch = []
        for node, ts in origin_ts.items():
            off = self.clock_offsets.get(node)
            if off is None:
                # No composed estimate for this origin yet: correct by
                # the direct link's skew alone (exact when origin IS
                # the direct child; a bounded approximation deeper).
                off = ns.offset_s or 0.0
            ms = max(0.0, (recv_wall - (ts - off)) * 1e3)
            if node in self.freshness_now or len(self.freshness_now) < FRESH_NODES_MAX:
                self.freshness_now[node] = {
                    "ms": round(ms, 3),
                    "offset_ms": round(off * 1e3, 3),
                    "via": ns.node,
                    "tier": ns.tier,
                }
                batch.append((f"fed.{node}.freshness_ms", ms))
        if batch and self.history is not None:
            self.history.record_batch(batch, ts=recv_wall)

    def _ingest_spans(self, ns: NodeState, payload: dict) -> None:
        spans = [s for s in payload.get("spans") or [] if isinstance(s, dict)]
        tr = self._tracer()
        if tr is not None and tr.enabled:
            tr.add_remote(spans)
        # Compose the sender's offset table onto THIS clock: it
        # measured off(X rel sender); this link measured
        # off(sender rel me); the sum is off(X rel me).
        base = self.clock_offsets.get(ns.node, ns.offset_s or 0.0)
        for origin, off in (payload.get("offsets_s") or {}).items():
            if not isinstance(origin, str) or not isinstance(off, (int, float)):
                continue
            if origin in self.clock_offsets or len(self.clock_offsets) < FRESH_NODES_MAX:
                self.clock_offsets[origin] = off + base
        if self.role != "root" and spans:
            # Relay upstream (bounded): the root is the assembly point;
            # an intermediate tier forwards what its subtree shipped.
            self.span_relay.extend(spans)
            if len(self.span_relay) > RELAY_CAP:
                del self.span_relay[: len(self.span_relay) - RELAY_CAP]

    def _trace_ingest(
        self,
        ns: NodeState,
        rctx: tuple[int, int, str] | None,
        t_start: float,
        t_decode: float,
        t_rollup: float,
    ) -> None:
        """Retrofit spans onto a landed frame whose trailer carried a
        trace context — the sender's fed.push becomes this fed.ingest's
        remote parent. Recorded AFTER the fact because the context is
        only known once the frame decoded. A closed per-frame span
        (cat="http", route-tagged) is what puts the federation ingest
        route in the /api/trace per-route p95 table — the long-lived
        POST itself never completes, so an open-ended request span
        would never land (the bug this closes)."""
        if rctx is None:
            return
        tr = self._tracer()
        if tr is None or not tr.enabled:
            return
        tid, psid, origin = rctx
        now = time.perf_counter()
        sid = tr.record(
            "fed.ingest", cat="http", track="http",
            t0=t_start, dur_ms=(now - t_start) * 1e3,
            trace=tid, remote_parent=(origin, psid),
            route=INGEST_PATH, node=ns.node,
        )
        tr.record(
            "fed.decode", t0=t_start, dur_ms=(t_decode - t_start) * 1e3,
            trace=tid, parent=sid,
        )
        tr.record(
            "fed.rollup", t0=t_decode, dur_ms=(t_rollup - t_decode) * 1e3,
            trace=tid, parent=sid,
        )
        tr.record(
            "fed.land", t0=t_rollup, dur_ms=(now - t_rollup) * 1e3,
            trace=tid, parent=sid,
        )
        self.last_ingest_ctx = (tid, sid)

    def fleet_trace_json(self) -> dict:
        """The ``/api/trace?fleet=1`` federation block: per-origin
        freshness + offsets, and the assembled cross-node span buffer
        shifted onto this node's clock."""
        tr = self._tracer()
        return {
            "node": self.node,
            "role": self.role,
            "freshness": {
                n: dict(row) for n, row in sorted(self.freshness_now.items())
            },
            "offsets_s": {
                n: round(v, 6) for n, v in sorted(self.clock_offsets.items())
            },
            "relay_pending": len(self.span_relay),
            "spans": (
                tr.fleet_spans(self.clock_offsets)
                if tr is not None and tr.enabled
                else []
            ),
        }

    # ----------------------- distributed queries ------------------------
    #
    # The Monarch-style push-down (docs/query.md): a fleet query is a
    # top-level aggregation; every tier evaluates the inner expression
    # over ITS OWN data only and ships mergeable partial-aggregate
    # state upstream — group sums/counts/min/max, topk row sets,
    # quantile sketches — never raw points. The hub pushes TPWQ frames
    # down the open ingest streams and merges the TPWR answers with its
    # local partial; the root additionally finalizes. A silent or dark
    # downstream degrades the answer to an explicit ``partial`` marker
    # plus a ``query`` journal event instead of an error.

    def _query_exclude(self):
        """Series this node must NOT contribute to a fleet partial:
        everything it LANDED from downstream rather than originated —
        slice.* rollups (hub-landed by construction) and per-chip
        series for downstream chips (the merged accel view records
        them locally too). Without this an aggregator double-counts
        every leaf it serves."""
        downstream: set[str] = set()
        for ns in self.nodes.values():
            for c in ns.chips:
                downstream.add(c.chip_id)

        def exclude(family: str, labels: dict) -> bool:
            if family.startswith("slice."):
                return True
            cid = labels.get("chip")
            return cid is not None and cid in downstream

        return exclude

    async def _push_query(
        self, ns: NodeState, expr: str, at: float, timeout_s: float
    ):
        """One TPWQ→TPWR round trip to one downstream; returns the
        decoded (partial, error, payload) or None on timeout/transport
        failure (the caller marks the node missing)."""
        self._qid += 1
        qid = self._qid
        # Trace propagation: if the caller runs inside a fleet-traced
        # span (the /api/query handler's http span after ensure_trace),
        # its context rides the TPWQ trailer — contextvars survive the
        # asyncio.gather fan-out, so every sub-query carries the same
        # trace id. Untraced callers stamp nothing (zero wire bytes).
        tr = self._tracer()
        ctx = tr.current_ctx() if tr is not None and tr.enabled else None
        frame = encode_query_request(
            qid, expr, at, timeout_s, generation=self.generation(), trace=ctx
        )
        rec = encode_varint(len(frame)) + frame
        fut = asyncio.get_running_loop().create_future()
        self._pending[qid] = fut
        try:
            writer, lock = ns.writer, ns.wlock
            if writer is None or lock is None:
                return None
            async with lock:
                writer.write(rec)
                await writer.drain()
            return await asyncio.wait_for(fut, timeout_s)
        except (asyncio.TimeoutError, ConnectionError, OSError):
            if self.journal is not None and ns.node not in self._timeout_logged:
                # Transition only: a node that keeps timing out while a
                # dashboard polls is ONE incident, not one per query.
                self._timeout_logged.add(ns.node)
                self.journal.record(
                    "query", "minor", ns.node,
                    f"fleet sub-query to {ns.node} timed out after "
                    f"{timeout_s:.2f}s (answer degrades to partial)",
                    timeout_s=round(timeout_s, 3),
                )
            return None
        finally:
            self._pending.pop(qid, None)

    async def fleet_partial(
        self, expr: str, at: float, timeout_s: float
    ) -> tuple[dict, list[str]]:
        """Evaluate a fleet query to PARTIAL state at this tier: push
        the sub-query to every connected downstream, merge their
        partials with the local one. Returns (merged partial state,
        missing node names). Raises QueryError on an undistributable
        expression (surfaces as 400 at the root)."""
        engine = self.sampler.query if self.sampler is not None else None
        if engine is None:
            raise QueryError("query engine unavailable (hub not bound)")
        self.check_staleness()
        targets: list[NodeState] = []
        missing: list[str] = []
        for name in sorted(self.nodes):
            ns = self.nodes[name]
            if ns.connected and ns.writer is not None:
                targets.append(ns)
            else:
                missing.append(name)
        # Local partial FIRST: a parse/plan error must fail fast before
        # any downstream work, and the local state is always available.
        parts: list[dict] = [
            engine.partial_eval(expr, at=at, exclude=self._query_exclude())
        ]
        if targets:
            child_timeout = max(0.25, timeout_s * 0.8)
            replies = await asyncio.gather(
                *(self._push_query(ns, expr, at, child_timeout) for ns in targets)
            )
            for ns, reply in zip(targets, replies):
                if reply is None:
                    missing.append(ns.node)
                    continue
                self._timeout_logged.discard(ns.node)  # re-arm the log
                partial_flag, error, payload = reply
                if error is not None:
                    missing.append(ns.node)
                    if self.journal is not None:
                        self.journal.record(
                            "query", "minor", ns.node,
                            f"fleet sub-query failed at {ns.node}: {error}",
                        )
                    continue
                sub = payload.get("partial")
                if sub:
                    parts.append(sub)
                missing.extend(
                    f"{ns.node}/{m}" for m in payload.get("missing") or []
                )
        return engine.merge_partials(parts), missing

    async def fleet_query(
        self, expr: str, at: float | None = None, timeout_s: float = 2.0
    ) -> dict:
        """Root entry point (GET /api/query?fleet=1): plan, push down,
        merge, finalize. A degraded answer carries ``partial: true`` +
        the missing subtree names — explicitly partial, never silently
        wrong, never an error."""
        at = time.time() if at is None else at
        engine = self.sampler.query
        partial, missing = await self.fleet_partial(expr, at, timeout_s)
        out = {
            "result_type": "vector",
            "at": round(at, 3),
            "result": engine.finalize(partial),
            "fleet": True,
            "node": self.node,
            "nodes": len(self.nodes),
        }
        if missing:
            out["partial"] = True
            out["missing"] = sorted(set(missing))
        # Degradation journals on TRANSITIONS of the missing set — a
        # steady dark leaf under a polling dashboard is one incident,
        # and recovery back to full answers closes it.
        missing_now = frozenset(out.get("missing") or ())
        if missing_now != self._partial_missing and self.journal is not None:
            if missing_now:
                self.journal.record(
                    "query", "minor", "query",
                    f"fleet query answered partial: missing "
                    f"{', '.join(sorted(missing_now))}",
                    expr=expr[:120],
                )
            else:
                self.journal.record(
                    "query", "info", "query",
                    "fleet queries answering in full again",
                )
        self._partial_missing = missing_now
        return out

    # ------------------------------ views -------------------------------

    def check_staleness(self) -> None:
        """Flip silent downstreams to dark — and eventually forget
        dark, disconnected ones — called once per sampler tick (the
        merged collector) and before every fleet-view render."""
        now = time.monotonic()
        for name in list(self.nodes):
            ns = self.nodes[name]
            if (
                ns.status != "ok"
                and not ns.connected
                and ns.last_wall is not None
                and now - ns.last_wall > self.forget_after_s
            ):
                del self.nodes[name]
                if self.journal is not None:
                    self.journal.record(
                        "federation", "info", name,
                        f"downstream {name} forgotten after "
                        f"{(now - ns.last_wall) / 60:.0f}min dark",
                    )
                self._bump()
                continue
            if (
                ns.status == "ok"
                and ns.last_wall is not None
                and now - ns.last_wall > self.dark_after_s
            ):
                ns.status = "down"
                dark = sorted({r.get("slice_id") for r in ns.slice_rows if r})
                if self.journal is not None:
                    self.journal.record(
                        "federation", "serious", ns.node,
                        f"downstream {ns.tier} {ns.node} dark: no frames "
                        f"for {now - ns.last_wall:.1f}s"
                        + (f" (slices {', '.join(map(str, dark))})" if dark else ""),
                    )
                self._bump()

    def chips(self) -> list[ChipSample]:
        """Fresh downstream chips (leaf-tier nodes only; dark nodes'
        chips drop out — exactly what slice alerting should see)."""
        out: list[ChipSample] = []
        for node in sorted(self.nodes):
            ns = self.nodes[node]
            if ns.status == "ok" and ns.chips:
                out.extend(ns.chips)
        return out

    def slices(self) -> list[dict]:
        """The failure-domain-aware slice table. Rows from a dark LEAF
        keep their last metrics but health="dark"; rows from a dark
        AGGREGATOR become health="unreachable" — the root can tell a
        reported-dark slice from a partitioned aggregator subtree."""
        out: list[dict] = []
        for node in sorted(self.nodes):
            ns = self.nodes[node]
            for r in ns.slice_rows:
                row = dict(r)
                if ns.status != "ok":
                    row["health"] = (
                        "unreachable" if ns.tier == "aggregator" else "dark"
                    )
                # Pre-accel_kind peers (old SLICE_FIELDS layout) ship
                # rows without the appended column: they federate
                # unchanged and read as the pre-upgrade default.
                if not row.get("accel_kind"):
                    row["accel_kind"] = "tpu"
                out.append(row)
        return out

    def upstream_rows(self, ts: float) -> list[list]:
        """The slice-level wire rows this tier pushes to ITS upstream:
        every downstream slice (dark/unreachable markers included) plus
        rollups of any local chips the merged collector stashed."""
        rows = self.slices()
        if self.local_chips:
            rows += slice_rollup_rows(self.local_chips, self.node, ts)
        return _rows_to_wire(rows)

    def fleet(self) -> dict:
        slices = self.slices()
        chips = sum(r.get("chips") or 0 for r in slices)
        duty = [
            (r["duty_mean"], r.get("chips") or 0)
            for r in slices
            if r.get("duty_mean") is not None
        ]
        wsum = sum(n for _, n in duty)
        # Per-accelerator-family partition of the fleet: one
        # root view spanning TPU pods and GPU nodes must say how much
        # of each it spans (the dashboard's per-kind fleet chips).
        by_accel: dict[str, dict] = {}
        for r in slices:
            k = r.get("accel_kind") or "tpu"
            ent = by_accel.setdefault(k, {"slices": 0, "chips": 0})
            ent["slices"] += 1
            ent["chips"] += r.get("chips") or 0
        return {
            "slices": len(slices),
            "chips": chips,
            "dark_slices": sum(1 for r in slices if r.get("health") == "dark"),
            "unreachable_slices": sum(
                1 for r in slices if r.get("health") == "unreachable"
            ),
            "duty_mean": (
                round(sum(d * n for d, n in duty) / wsum, 3) if wsum else None
            ),
            "by_accel": by_accel,
        }

    def to_json(self) -> dict:
        self.check_staleness()
        return {
            "node": self.node,
            "nodes": {n: ns.to_json() for n, ns in sorted(self.nodes.items())},
            "slices": self.slices(),
            "fleet": self.fleet(),
            "frames": self.frames,
            "freshness": {
                n: dict(row) for n, row in sorted(self.freshness_now.items())
            },
        }

    def health_json(self) -> dict:
        ok = sum(1 for ns in self.nodes.values() if ns.status == "ok")
        return {
            "nodes": len(self.nodes),
            "nodes_ok": ok,
            "frames": self.frames,
            "dark_slices": sum(
                1 for r in self.slices() if r.get("health") != "ok"
            ),
        }


class HubMergedCollector:
    """Accel wrapper at an aggregator: merges the hub's downstream
    chips into the local view each tick (the local collector, when any,
    runs unchanged underneath). Dark downstreams degrade the sample's
    error note — never its ok bit, so the accel breaker can't lock out
    local collection because a *remote* leaf went silent."""

    name = "accel"

    def __init__(self, local: Collector | None, hub: FederationHub):
        self.local = local
        self.hub = hub

    def set_journal(self, journal) -> None:
        if self.local is not None and hasattr(self.local, "set_journal"):
            self.local.set_journal(journal)

    def stop(self) -> None:
        """Forward owner-stop to the wrapped local collector."""
        if self.local is not None and hasattr(self.local, "stop"):
            self.local.stop()

    async def collect(self) -> Sample:
        self.hub.check_staleness()
        chips: list[ChipSample] = []
        errors: list[str] = []
        ok = True
        if self.local is not None:
            s = await self.local.collect()
            ok = s.ok
            chips.extend(s.data or [])
            if s.error:
                errors.append(s.error)
        self.hub.local_chips = list(chips)
        seen = {c.chip_id for c in chips}
        for c in self.hub.chips():
            if c.chip_id not in seen:
                chips.append(c)
                seen.add(c.chip_id)
        for node, ns in sorted(self.hub.nodes.items()):
            if ns.status != "ok":
                errors.append(f"downstream {node} dark")
        return Sample(
            source=self.name, ok=ok, data=chips,
            error="; ".join(errors) or None,
        )


class FederationUplink:
    """Downstream side of the tree: one long-lived chunked POST to the
    upstream's /api/federation/ingest, one delta frame per sampler tick
    (leaves push chip rows, aggregators push slice rows). Reconnects
    with decorrelated-jitter backoff (a root failover must not trigger
    a synchronized reconnect herd), and — because the encoder resets on
    every reconnect — always resyncs with a keyframe.

    Root HA: ``url`` may carry a comma-separated primary +
    standby upstream. The uplink streams to one upstream at a time and
    rotates to the next on connection loss — failover IS a reconnect,
    so the standby root rebuilds this node's fan-in state entirely from
    the opening keyframe, exactly like any resync."""

    def __init__(
        self,
        sampler,
        url: str,
        node: str,
        tier: str = "leaf",
        hub: FederationHub | None = None,
        keyframe_every: int = 30,
        backoff_max_s: float = 5.0,
        auth_token: str | None = None,
        rng: random.Random | None = None,
    ):
        self.sampler = sampler
        self.urls: list[str] = []
        for u in (p.strip() for p in str(url).split(",") if p.strip()):
            base = u if u.startswith(("http://", "https://")) else f"http://{u}"
            self.urls.append(base.rstrip("/"))
        if not self.urls:
            raise ValueError("federate_up: no upstream address")
        self._active = 0
        self._last_idx: int | None = None  # upstream of last live stream
        self.node = node
        self.tier = tier
        self.hub = hub
        self.enc = DeltaStreamEncoder(keyframe_every=keyframe_every)
        self.backoff_max_s = backoff_max_s
        self._backoff = 0.25
        self._rng = rng or random.Random()
        # Bearer token for the upstream's POST auth gate — trees are
        # normally deployed with one fleet-wide auth_token, so the
        # node's own token is what app.build passes here.
        self.auth_token = auth_token
        self.connected = False
        self.connects = 0
        self.resyncs = 0
        self.failovers = 0  # streams established to a DIFFERENT upstream
        # Highest leadership generation seen on TPWQ frames from any
        # upstream (tpumon_torch.leader). Stamped back onto pushed frames so
        # a stale root ingesting this stream observes the newer token,
        # and used to refuse older-generation fleet queries outright.
        self.gen_seen = 0
        self.queries_fenced = 0
        # Chaos partition faults (mode "partition", source "uplink"):
        # frames are encoded then silently dropped — the socket stays
        # open, so the upstream sees silence (dark after dark_after_s),
        # not a disconnect; on heal the seq gap forces a keyframe
        # resync. Lease expiry distinct from clean disconnect.
        self.faults: list = []
        self.frames_dropped = 0
        self._partition_logged = False
        # Distributed-query service stats: TPWQ sub-queries answered on
        # this stream and the TPWR bytes shipped — the "never raw
        # points" bound the fed-query soak pins.
        self.queries_answered = 0
        self.query_bytes = 0
        # Fleet-tracing stats: spans shipped upstream in TPWS records
        # and the wire bytes they cost (0 while tracing is off — the
        # bench's zero-added-bytes assert reads these).
        self.spans_shipped = 0
        self.trace_bytes = 0
        self.last_error: str | None = None
        self._task: asyncio.Task | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._was_down = False

    @property
    def url(self) -> str:
        """The upstream this uplink is (re)connecting to right now."""
        return self.urls[self._active]

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._task
            self._task = None
        if self._writer is not None:
            with contextlib.suppress(Exception):
                self._writer.close()
            self._writer = None
        self.connected = False

    def resync(self) -> None:
        """Force a reconnect (tests/bench): the next frame after the
        re-established stream is a keyframe."""
        if self._writer is not None:
            with contextlib.suppress(Exception):
                self._writer.close()

    def _payload(self, ts: float) -> tuple[int, list[str], list[list]]:
        if self.tier == "aggregator" and self.hub is not None:
            rows = self.hub.upstream_rows(ts)
            _quantize_rows(list(SLICE_FIELDS), rows, _F32_SLICE_FIELDS)
            return SLICE_WIRE_VERSION, list(SLICE_FIELDS), rows
        w = chips_to_wire(self.sampler.chips())
        # Metric floats ship f32-exact so their columns take the
        # half-width delta coding (rows are freshly built — safe to
        # quantize in place).
        _quantize_rows(w["fields"], w["rows"], _F32_CHIP_FIELDS)
        return w["v"], w["fields"], w["rows"]

    async def _run(self) -> None:
        journal = self.sampler.journal
        while True:
            try:
                await self._stream_once(journal)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                self.connected = False
                err = f"{type(e).__name__}: {e}"
                if self.last_error != err or not self._was_down:
                    self.last_error = err
                if not self._was_down:
                    self._was_down = True
                    journal.record(
                        "federation", "serious", self.node,
                        f"uplink to {self.url} lost: {err} (reconnecting; "
                        f"resync will open with a keyframe)",
                    )
            # Dual-homed failover: every failed attempt rotates to the
            # next upstream, so a dead primary is abandoned within one
            # backoff and a dead standby never blocks returning to the
            # primary.
            if len(self.urls) > 1:
                self._active = (self._active + 1) % len(self.urls)
            await asyncio.sleep(self._backoff)
            self._backoff = decorrelated_jitter(
                self._backoff, base_s=0.25, cap_s=self.backoff_max_s,
                rng=self._rng,
            )

    async def _stream_once(self, journal) -> None:
        parts = urllib.parse.urlsplit(self.url)
        tls = parts.scheme == "https"
        reader, writer = await asyncio.open_connection(
            parts.hostname,
            parts.port or (443 if tls else 80),
            ssl=True if tls else None,
        )
        self._writer = writer
        try:
            auth = (
                f"Authorization: Bearer {self.auth_token}\r\n"
                if self.auth_token
                else ""
            )
            # Stream-scope trace context: a fresh trace id
            # with parent span 0 — "this stream's root at the origin".
            # The upstream's fed.accept span joins it; per-frame traces
            # ride the frame trailers instead. Absent while tracing is
            # off: the request bytes stay pre-upgrade identical.
            tr0 = getattr(self.sampler, "tracer", None)
            thdr = (
                "X-Tpumon-Trace: "
                f"{format_trace_header((tr0.new_trace(), 0, tr0.node))}\r\n"
                if tr0 is not None and tr0.enabled
                else ""
            )
            writer.write(
                (
                    f"POST {INGEST_PATH} HTTP/1.1\r\n"
                    f"Host: {parts.netloc}\r\n"
                    f"Content-Type: {DELTA_STREAM_CTYPE}\r\n"
                    "Transfer-Encoding: chunked\r\n"
                    f"{auth}"
                    f"{thdr}"
                    f"X-Tpumon-Node: {self.node}\r\n"
                    f"X-Tpumon-Tier: {self.tier}\r\n\r\n"
                ).encode("latin-1")
            )
            await writer.drain()
            self.enc.reset()  # reconnect ⇒ next frame is a keyframe
            # A successfully-established stream re-arms the fast retry:
            # without this, transient blips over a long uptime would
            # ratchet every future reconnect to backoff_max_s.
            self._backoff = 0.25
            self.connects += 1
            self.connected = True
            if self._last_idx is not None and self._last_idx != self._active:
                self.failovers += 1
                journal.record(
                    "federation", "serious", self.node,
                    f"uplink failed over to {self.url} "
                    f"(upstream {self._active + 1}/{len(self.urls)}; "
                    f"keyframe resync rebuilds fan-in state there)",
                )
            self._last_idx = self._active
            if self.connects == 1:
                journal.record(
                    "federation", "info", self.node,
                    f"uplink established: pushing {self.tier} delta "
                    f"frames to {self.url}",
                )
            if self._was_down:
                self._was_down = False
                self.resyncs += 1
                journal.record(
                    "federation", "info", self.node,
                    f"uplink to {self.url} re-established "
                    f"(keyframe resync)",
                )
            # Frame cadence: one per tick, but never a gap longer than
            # ~2 s — a slow-ticking leaf (interval 10 s) still
            # heartbeats (empty ~30 B deltas), so the upstream's
            # dark_after_s staleness check is independent of every
            # downstream's sample interval (no dark/recovered flap).
            interval = max(0.25, self.sampler.cfg.sample_interval_s)
            heartbeat = min(2.0, max(2 * interval, 0.25))
            # Reader side: the upstream either pushes TPWQ sub-query
            # frames down this socket (answered inline as interleaved
            # TPWR records) or writes an HTTP response to END the
            # stream — the reader task owns both cases and closes the
            # writer on stream end so the tick loop fails fast.
            wlock = asyncio.Lock()
            qtask = asyncio.create_task(
                self._serve_queries(reader, writer, wlock)
            )
            tr = getattr(self.sampler, "tracer", None)
            try:
                while True:
                    ts = time.time()
                    if tr is not None and tr.enabled:
                        # One fleet trace per pushed frame: fed.push
                        # roots it, fed.collect/fed.encode nest inside,
                        # and the frame trailer carries the context so
                        # the upstream's fed.ingest joins the tree.
                        with tr.span(
                            "fed.push", track="uplink", trace=tr.new_trace()
                        ) as sp:
                            sp.tag(upstream=self.url)
                            with tr.span("fed.collect", track="uplink"):
                                v, fields, rows = self._payload(ts)
                            self.enc.generation = self.gen_seen
                            self.enc.trace = (sp.trace, sp.sid, tr.node)
                            with tr.span("fed.encode", track="uplink"):
                                frame, _was_key = self.enc.encode(
                                    v, fields, rows, ts
                                )
                    else:
                        v, fields, rows = self._payload(ts)
                        self.enc.generation = self.gen_seen
                        self.enc.trace = None  # off ⇒ zero added wire bytes
                        frame, _was_key = self.enc.encode(v, fields, rows, ts)
                    rec = encode_varint(len(frame)) + frame
                    # Piggyback this tick's completed spans (the
                    # fed.push that just closed is in the outbox now).
                    rec += self._trace_record(tr)
                    if self._partitioned(journal):
                        # Blackholed link: the frame is consumed (seq
                        # advances) but never written — on heal the
                        # upstream refuses the gap and this uplink
                        # resyncs with a keyframe.
                        self.frames_dropped += 1
                    else:
                        async with wlock:
                            writer.write(b"%x\r\n" % len(rec) + rec + b"\r\n")
                            await writer.drain()
                    if qtask.done():
                        exc = qtask.exception()
                        raise exc if exc is not None else ConnectionError(
                            "upstream ended stream"
                        )
                    await self.sampler.wait_tick(timeout_s=heartbeat)
            finally:
                qtask.cancel()
                with contextlib.suppress(asyncio.CancelledError, Exception):
                    await qtask
        finally:
            self._writer = None
            self.connected = False
            with contextlib.suppress(Exception):
                writer.close()

    def _trace_record(self, tr) -> bytes:
        """The piggybacked TPWS record for one tick: this node's own
        completed trace-correlated spans, anything its subtree relayed
        through the hub, and — at an aggregator — the hub's composed
        clock-offset table (how the root learns grandchild offsets).
        b"" when tracing is off or nothing is queued, so the stream
        stays bit-identical to a pre-trace peer's."""
        if tr is None or not tr.enabled:
            return b""
        spans = tr.drain_outbox()
        offsets: dict[str, float] = {}
        if self.hub is not None:
            relay = self.hub.span_relay[:RELAY_PER_TICK]
            del self.hub.span_relay[:RELAY_PER_TICK]
            self.hub.spans_relayed += len(relay)
            spans += relay
            offsets = {
                n: round(v, 6) for n, v in self.hub.clock_offsets.items()
            }
        if not spans:
            return b""
        try:
            frame = encode_trace_spans(
                {"node": self.node, "spans": spans, "offsets_s": offsets}
            )
        except ValueError:
            return b""  # oversize relay burst: drop it (advisory data)
        out = encode_varint(len(frame)) + frame
        self.spans_shipped += len(spans)
        self.trace_bytes += len(out)
        return out

    def _partitioned(self, journal) -> bool:
        """True while a chaos ``partition`` fault blackholes this link.
        Journals the transition only (an hour-long partition is one
        event, not one per tick) — same hygiene as ChaosCollector."""
        hit = False
        for f in self.faults:
            if f.mode == "partition" and self._rng.random() < f.param:
                hit = True
                break
        if hit and not self._partition_logged:
            self._partition_logged = True
            journal.record(
                "chaos", "minor", self.node,
                f"uplink partition: dropping frames to {self.url} "
                f"(socket stays open — upstream sees silence, not a "
                f"disconnect)",
                mode="partition",
            )
        elif not hit:
            self._partition_logged = False
        return hit

    async def _serve_queries(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        wlock: asyncio.Lock,
    ) -> None:
        """Read the upstream side of the uplink socket: TPWQ sub-query
        records are evaluated (locally at a leaf; fanned further down
        through this node's own hub at an aggregator) and answered as
        interleaved chunked TPWR records; anything else — an HTTP
        response, garbage — means the stream is over, so the writer is
        closed to fail the tick loop promptly."""
        buf = bytearray()
        try:
            while True:
                data = await reader.read(65536)
                if not data:
                    raise ConnectionError("upstream closed connection")
                buf += data
                try:
                    records = split_records(buf)
                except ValueError:
                    raise ConnectionError("upstream ended stream")
                for rec in records:
                    if rec[:4] != QUERY_REQ_MAGIC:
                        raise ConnectionError("upstream ended stream")
                    (
                        qid, expr, at, timeout_s, qgen, qtrace,
                    ) = decode_query_request(rec)
                    if qgen > self.gen_seen:
                        self.gen_seen = qgen
                    # A traced sub-query answers inside a fed.query
                    # span remote-parented on the asker's context; the
                    # TPWR trailer echoes THIS span's context back and
                    # the completed span ships upstream via TPWS.
                    tr = getattr(self.sampler, "tracer", None)
                    span_cm = (
                        tr.span("fed.query", track="uplink", remote=qtrace)
                        if qtrace is not None and tr is not None and tr.enabled
                        else contextlib.nullcontext()
                    )
                    with span_cm as sp:
                        rctx = None
                        if sp is not None:
                            sp.tag(expr=expr[:80])
                            rctx = (sp.trace, sp.sid, tr.node)
                        if 0 < qgen < self.gen_seen:
                            # Fencing: a root stamping an older
                            # generation has been superseded — refuse
                            # the query rather than hand a deposed root
                            # the fleet state an actuation decision
                            # would need. Unstamped (generation-0)
                            # queries are pre-upgrade roots and pass
                            # unchanged.
                            self.queries_fenced += 1
                            reply = encode_query_result(
                                qid, None,
                                error=(
                                    f"stale generation {qgen} < "
                                    f"{self.gen_seen} (fenced)"
                                ),
                                generation=self.gen_seen,
                                trace=rctx,
                            )
                        else:
                            reply = await self._answer_query(
                                qid, expr, at, timeout_s, trace=rctx
                            )
                    out = encode_varint(len(reply)) + reply
                    self.queries_answered += 1
                    self.query_bytes += len(out)
                    if self._partitioned(self.sampler.journal):
                        continue  # blackholed link swallows the answer
                    async with wlock:
                        writer.write(b"%x\r\n" % len(out) + out + b"\r\n")
                        await writer.drain()
        finally:
            with contextlib.suppress(Exception):
                writer.close()

    async def _answer_query(
        self,
        qid: int,
        expr: str,
        at: float,
        timeout_s: float,
        trace: tuple[int, int, str] | None = None,
    ) -> bytes:
        """One TPWQ → TPWR: partial-evaluate over local data (and, at an
        aggregator, this node's own subtree). Evaluation failures ship
        as explicit error results — the upstream degrades to partial
        instead of tearing the stream down. ``trace`` is the answering
        fed.query span's context, echoed on every TPWR shape (success,
        partial, error) so the asker can link the reply."""
        try:
            engine = getattr(self.sampler, "query", None)
            if engine is None:
                raise QueryError("query engine unavailable")
            if self.hub is not None:
                partial, missing = await self.hub.fleet_partial(
                    expr, at, max(0.25, timeout_s * 0.8)
                )
                return encode_query_result(
                    qid,
                    {"partial": partial, "missing": missing},
                    partial=bool(missing),
                    generation=self.gen_seen,
                    trace=trace,
                )
            partial = engine.partial_eval(expr, at=at)
            return encode_query_result(
                qid, {"partial": partial, "missing": []},
                generation=self.gen_seen,
                trace=trace,
            )
        except Exception as e:
            return encode_query_result(
                qid, None, error=f"{type(e).__name__}: {e}",
                generation=self.gen_seen,
                trace=trace,
            )

    def to_json(self) -> dict:
        st = self.enc.stats
        return {
            "url": self.url,
            "urls": list(self.urls),
            "tier": self.tier,
            "connected": self.connected,
            "connects": self.connects,
            "resyncs": self.resyncs,
            "failovers": self.failovers,
            "gen_seen": self.gen_seen,
            "queries_fenced": self.queries_fenced,
            "frames_dropped": self.frames_dropped,
            "frames": st["frames"],
            "keyframes": st["keyframes"],
            "bytes": st["bytes"],
            "delta_frames": st["delta_frames"],
            "delta_bytes": st["delta_bytes"],
            "keyframe_bytes": st["keyframe_bytes"],
            "queries_answered": self.queries_answered,
            "query_bytes": self.query_bytes,
            "spans_shipped": self.spans_shipped,
            "trace_bytes": self.trace_bytes,
            **({"last_error": self.last_error} if self.last_error else {}),
        }
