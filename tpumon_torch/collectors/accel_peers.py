"""Peer federation: merge chips from other tpumon instances.

The reference is strictly single-host for realtime metrics — multi-node
visibility exists only through Prometheus aggregation of per-node
exporters (SURVEY §2.5). tpumon keeps that path (PromQL over per-host
`tpu_*` series) **and** adds a realtime one: an instance configured with
``peers`` fetches each peer's chip snapshot in parallel and merges their
chips with its own, so one dashboard shows a whole v5p slice live with
per-chip resolution and no Prometheus in the loop (BASELINE config 5).

Scaling (docs/perf.md): the fan-out is bounded (``fanout`` worker
threads in flight at once — a 64-peer fleet must not spawn 64 threads
per tick), each peer is fetched over the compact columnar wire format
(``/api/accel/wire``, tpumon_torch.topology.chips_to_wire — positional rows
instead of per-chip key/value dicts), and the merge is incremental
per-peer: parsed chips are kept per peer and each tick revalidates them
with ``If-None-Match`` against the peer's epoch ETag, so a peer whose
accel section did not change between ticks costs a 304 and zero
re-parsing instead of a full payload. Peers predating the wire route
are detected once (404) and fetched via ``/api/accel/metrics`` forever
after — mixed-version fleets federate fine.

Fan-out budgeting: ``peer_timeout_s`` is the whole fan-out's wall
budget, and every peer gets an **independent deadline slice** of it
(budget / number-of-waves, clamped to what remains of the budget when
its turn comes) — one hung peer burns only its own slice, never the
window the peers queued behind it needed. Fetches also reuse
**keep-alive connections** across ticks (the tpumon server honors
``Connection: keep-alive``): the steady-state revalidation poll costs
one request on a warm socket, not a TCP handshake per peer per tick;
a stale socket (server restarted, idle timeout) retries once on a
fresh connection before the peer counts as down.

Peer chips keep their original chip_id/host/slice identity; cumulative
ICI counters survive the merge, so the local sampler computes peer ICI
rates exactly as it does for local chips. An unreachable peer degrades
that peer only (its chips drop out, which is precisely what slice-failure
alerting should see).
"""

from __future__ import annotations

import asyncio
import http.client
import json
import random
import urllib.parse
from dataclasses import dataclass, field

from tpumon_torch.collectors import Collector, Sample
from tpumon_torch.resilience import decorrelated_jitter
from tpumon_torch.protowire import (
    WIRE_FRAME_CTYPE,
    WIRE_FRAME_MAGIC,
    decode_wire_frame,
)
from tpumon_torch.topology import (
    WIRE_VERSION,
    ChipSample,
    chips_from_columns,
    wire_columns,
)
from tpumon_torch.tracing import current_ctx_header


# Down-peer retry pacing (decorrelated jitter, tpumon_torch.resilience): a
# failed peer is NOT re-fetched every tick — each failure schedules the
# next attempt uniform-at-random up to 3x the previous delay, capped
# fleet-safe so a recovered peer is rediscovered within ~PEER_RETRY_CAP_S
# worst case. Without this, 64 monitors polling a restarted peer hammer
# it in lockstep on its first healthy tick (the reconnect stampede).
PEER_RETRY_BASE_S = 0.5
PEER_RETRY_CAP_S = 8.0


def normalize_base_url(url: str) -> str:
    """`host:port` or full URL → scheme-qualified base with no trailing slash."""
    base = url if url.startswith(("http://", "https://")) else f"http://{url}"
    return base.rstrip("/")


def chip_from_json(d: dict) -> ChipSample:
    """Inverse of ChipSample.to_json (hbm_pct and rates are derived)."""
    return ChipSample(
        chip_id=d["chip"],
        host=d.get("host", ""),
        slice_id=d.get("slice", "slice-0"),
        index=int(d.get("index", 0)),
        kind=d.get("kind", "unknown"),
        coords=tuple(d.get("coords") or ()),
        mxu_duty_pct=d.get("mxu_duty_pct"),
        hbm_used=d.get("hbm_used"),
        hbm_total=d.get("hbm_total"),
        temp_c=d.get("temp_c"),
        ici_tx_bytes=d.get("ici_tx_bytes"),
        ici_rx_bytes=d.get("ici_rx_bytes"),
        ici_link_up=d.get("ici_link_up"),
        ici_link_health=d.get("ici_link_health"),
        throttle_score=d.get("throttle_score"),
        counter_source=d.get("counter_source"),
        # Pre-accel_kind peers omit the key: their chips read as TPU
        # (the pre-upgrade meaning of every chip in the fleet).
        accel_kind=d.get("accel_kind") or "tpu",
    )


@dataclass
class PeerFederatedCollector:
    """Wraps a local accel collector and merges peer instances' chips."""

    local: Collector | None
    peers: tuple[str, ...] = ()
    name: str = "accel"
    timeout_s: float = 3.0
    # At most this many peer fetches (worker threads) in flight at once
    # (Config.peer_fanout).
    fanout: int = 16
    # Ask peers for the columnar binary frame (Accept:
    # application/x-tpumon-wire). The response is sniffed, not assumed:
    # a pre-binary peer ignores the Accept header and answers JSON,
    # which parses exactly as before — negotiation costs nothing.
    wire_binary: bool = True
    last_peer_status: dict[str, str] = field(default_factory=dict)
    # Event journal (tpumon_torch.events), wired by the sampler: peer up/down
    # and wire-fallback transitions become durable ``peer`` events.
    journal: object = field(default=None, repr=False)

    def set_journal(self, journal) -> None:
        self.journal = journal

    def _state(self) -> dict:
        """Per-peer incremental-merge state, created lazily so tests
        that build the collector without __init__ still work:
        etags (last seen epoch ETag), chips (last parsed list, reused
        verbatim on 304), wire (peer speaks /api/accel/wire), conns
        (keep-alive HTTP connections reused across ticks)."""
        st = self.__dict__.get("_peer_state")
        if st is None:
            st = self.__dict__["_peer_state"] = {
                "etags": {},
                "chips": {},
                "wire": {},
                "conns": {},
                # journal-transition tracking: last ok/err per peer and
                # which peers' wire-fallback has already been recorded
                "ok": {},
                "wire_logged": set(),
                # down-peer retry gates: url -> (loop.time to retry at,
                # previous backoff delay) — decorrelated jitter
                "retry": {},
                "rng": random.Random(),
            }
        return st

    def _drop_conn(self, url: str) -> None:
        conn = self._state()["conns"].pop(url, None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def _request(
        self, url: str, path: str, headers: dict, timeout_s: float
    ) -> tuple[int, bytes, object]:
        """One GET on the peer's keep-alive connection; returns
        (status, body, response headers). A REUSED socket that fails
        before any response (peer restarted, idle-closed) retries once
        on a fresh connection — a cold-connection failure or a timeout
        propagates immediately (retrying a timeout would double the
        peer's deadline slice)."""
        conns = self._state()["conns"]
        base = normalize_base_url(url)
        parts = urllib.parse.urlsplit(base)
        for attempt in (0, 1):
            conn = conns.get(url)
            if conn is None:
                cls = (
                    http.client.HTTPSConnection
                    if parts.scheme == "https"
                    else http.client.HTTPConnection
                )
                conn = conns[url] = cls(
                    parts.hostname, parts.port, timeout=timeout_s
                )
            reused = conn.sock is not None
            if reused:
                conn.sock.settimeout(timeout_s)
            else:
                conn.timeout = timeout_s
            try:
                conn.request(
                    "GET", path, headers={"Connection": "keep-alive", **headers}
                )
                r = conn.getresponse()
                body = r.read()
            except (TimeoutError, OSError, http.client.HTTPException) as e:
                self._drop_conn(url)
                stale = reused and isinstance(
                    e,
                    (
                        http.client.BadStatusLine,
                        http.client.CannotSendRequest,
                        ConnectionResetError,
                        BrokenPipeError,
                    ),
                )
                if attempt == 0 and stale:
                    continue  # stale keep-alive socket: one fresh retry
                raise
            if r.will_close:
                self._drop_conn(url)
            return r.status, body, r.headers
        raise RuntimeError("unreachable")  # pragma: no cover

    def _fetch_peer(self, url: str, timeout_s: float | None = None) -> list[ChipSample]:
        """Blocking fetch+parse of one peer (runs on a worker thread)
        within its deadline slice. 304 returns the peer's cached parsed
        chips untouched. Wire fetches ask for the binary frame via
        Accept and sniff the response — binary-speaking peers answer
        the columnar frame (decoded straight to columns, zero per-chip
        dicts), JSON-only peers answer JSON and parse exactly as
        before."""
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        st = self._state()
        use_wire = st["wire"].get(url, True)
        path = "/api/accel/wire" if use_wire else "/api/accel/metrics"
        headers = {}
        etag = st["etags"].get(url)
        if etag:
            headers["If-None-Match"] = etag
        if use_wire and self.wire_binary:
            headers["Accept"] = WIRE_FRAME_CTYPE
        # Fleet tracing: when this fetch runs inside a fleet-traced
        # span, the peer joins the same trace (its http span remote-
        # parents onto ours). Absent otherwise — no bytes added.
        trace_hdr = current_ctx_header()
        if trace_hdr:
            headers["X-Tpumon-Trace"] = trace_hdr
        status, body, rheaders = self._request(url, path, headers, timeout_s)
        if status == 304:
            return st["chips"].get(url, [])
        if status == 404 and use_wire:
            # Pre-wire peer: remember and fall back to the dict route.
            st["wire"][url] = False
            st["etags"].pop(url, None)
            return self._fetch_peer(url, timeout_s)
        if status != 200:
            raise RuntimeError(f"peer answered HTTP {status}")
        new_etag = rheaders.get("ETag")
        if use_wire:
            try:
                if body[: len(WIRE_FRAME_MAGIC)] == WIRE_FRAME_MAGIC:
                    v, fields, cols = decode_wire_frame(body)
                    if v != WIRE_VERSION:
                        raise ValueError(f"wire version {v}")
                    chips = chips_from_columns(fields, cols)
                else:
                    chips = chips_from_columns(*wire_columns(json.loads(body)))
            except ValueError:
                # Incompatible WIRE_VERSION from a future peer: fall
                # back to the stable dict route, like the 404 path.
                st["wire"][url] = False
                st["etags"].pop(url, None)
                return self._fetch_peer(url, timeout_s)
        else:
            chips = [
                chip_from_json(d) for d in json.loads(body).get("chips", [])
            ]
        if new_etag:
            st["etags"][url] = new_etag
        st["chips"][url] = chips
        return chips

    def _journal_peer(self, url: str, ok: bool, st: dict) -> None:
        """Record peer up/down + wire-fallback TRANSITIONS (never the
        steady state) — runs on the event loop after the fan-out, so
        journal appends don't happen from fetch worker threads."""
        if self.journal is None:
            st["ok"][url] = ok
            return
        was = st["ok"].get(url)
        if not ok and was is not False:
            self.journal.record(
                "peer", "serious", url,
                f"peer down: {self.last_peer_status.get(url, 'unreachable')}"
                + (" (its chips drop from the merged view)" if was else ""),
            )
        elif ok and was is False:
            self.journal.record("peer", "info", url, "peer recovered")
        st["ok"][url] = ok
        if st["wire"].get(url) is False and url not in st["wire_logged"]:
            st["wire_logged"].add(url)
            self.journal.record(
                "peer", "minor", url,
                "pre-wire peer: fell back to /api/accel/metrics "
                "(full-dict fetches from now on)",
            )

    async def _peer_chips(
        self, url: str, timeout_s: float | None = None
    ) -> tuple[str, list[ChipSample] | None]:
        try:
            return url, await asyncio.to_thread(self._fetch_peer, url, timeout_s)
        except Exception as e:
            self.last_peer_status[url] = f"{type(e).__name__}: {e}"
            return url, None

    async def collect(self) -> Sample:
        fanout = max(1, getattr(self, "fanout", 16))
        sem = asyncio.Semaphore(fanout)
        # Independent deadline slices: timeout_s is the WHOLE fan-out's
        # wall budget. With W waves of `fanout` concurrent fetches each
        # peer's slice is budget/W, clamped to what's left of the
        # budget when its slot frees up — a hung peer eats only its own
        # slice, and a backlogged tick fails the stragglers fast
        # instead of letting the fan-out overhang into the next tick.
        budget = max(0.1, self.timeout_s)
        waves = max(1, -(-len(self.peers) // fanout))
        slice_s = budget / waves
        loop = asyncio.get_running_loop()
        t_deadline = loop.time() + budget
        st_retry = self._state()["retry"]
        rng = self._state()["rng"]

        async def bounded(url: str) -> tuple[str, list[ChipSample] | None]:
            gate = st_retry.get(url)
            if gate is not None and loop.time() < gate[0]:
                # Down peer inside its jittered retry window: skip the
                # fetch entirely (its last error stands) — the herd
                # control that keeps a fleet from re-polling a dead
                # peer in lockstep every tick.
                return url, None
            async with sem:
                remaining = t_deadline - loop.time()
                if remaining <= 0.01:
                    self.last_peer_status[url] = "fan-out budget exhausted"
                    return url, None
                res = await self._peer_chips(url, min(slice_s, remaining))
                if res[1] is None:
                    prev = gate[1] if gate is not None else 0.0
                    delay = decorrelated_jitter(
                        prev, base_s=PEER_RETRY_BASE_S,
                        cap_s=PEER_RETRY_CAP_S, rng=rng,
                    )
                    st_retry[url] = (loop.time() + delay, delay)
                else:
                    st_retry.pop(url, None)
                return res

        tasks = [asyncio.ensure_future(bounded(u)) for u in self.peers]
        local_sample = None
        if self.local is not None:
            local_sample = await self.local.collect()

        # Fetch AND parse run inside each worker thread, so peers'
        # parse work already overlaps; gather just collects the
        # (url, chips) results.
        by_url: dict[str, list[ChipSample] | None] = dict(
            await asyncio.gather(*tasks)
        )

        chips: list[ChipSample] = []
        errors: list[str] = []
        if local_sample is not None:
            chips.extend(local_sample.data or [])
            if local_sample.error:
                errors.append(f"local: {local_sample.error}")
        seen = {c.chip_id for c in chips}
        st = self._state()
        # Assemble in configured peer order (stable chip ordering keeps
        # the SSE delta stream's positional list patches small).
        for url in self.peers:
            peer_chips = by_url.get(url)
            self._journal_peer(url, peer_chips is not None, st)
            if peer_chips is None:
                errors.append(f"peer {url}: {self.last_peer_status.get(url)}")
                continue
            self.last_peer_status[url] = "ok"
            for c in peer_chips:
                if c.chip_id not in seen:  # local identity wins on overlap
                    chips.append(c)
                    seen.add(c.chip_id)
        return Sample(
            source=self.name,
            ok=not errors,
            data=chips,
            error="; ".join(errors) or None,
        )
