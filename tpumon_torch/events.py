"""Structured event journal: the cluster's durable "what happened" record.

Until now every subsystem kept its lifecycle moments in private,
transient state: the alert engine's fired/resolved deque vanished on
restart, breaker transitions lived only as current state in
/api/health, chaos injections and peer fallbacks weren't recorded at
all. Prometheus-style monitors treat events/annotations as first-class
(PAPERS.md: Prometheus annotations, Monarch's exemplars); MPM-style
fleet monitors correlate incidents through exactly this kind of
journal. This module is that record, sized for an always-on monitor:

- ``EventJournal``: an append-only **bounded ring** (``events_ring``
  config / ``--events-ring``, default 4096, overwrite-oldest) with one
  entry point — ``record(kind, severity, source, msg, **attrs)`` —
  called from every subsystem with a lifecycle moment: alert engine
  fired/resolved (tpumon_torch.alerts, which now stores its timeline HERE
  instead of a private deque), circuit-breaker transitions and loop
  watchdogs (tpumon_torch.sampler), chaos injections (collectors.chaos),
  peer up/down/wire-fallback (collectors.accel_peers), history/state
  snapshot restores (tpumon_torch.history / tpumon_torch.app), profiler captures
  (tpumon_torch.profiler), silences and server start (tpumon_torch.server/app).
  Every event carries a monotonic ``seq`` — the cursor /api/events
  paginates on — and lifetime per-(kind, severity) counters back the
  ``tpumon_events_total`` exporter family.
- ``EventLog``: crash-safe JSONL persistence on the HistorySnapshotter
  cadence — the whole ring is written atomically (tmp + fsync + rename,
  tpumon_torch.history.atomic_write_text) every ``events_interval_s``, one
  JSON event per line behind a meta header, and restored at startup so
  a monitor restart doesn't erase the incident record. Sequence numbers
  survive the round trip, so a client's cursor stays valid across a
  restart.
- ``events_cli``: ``tpumon events`` — tail the journal of a running
  server, ``--follow`` live over the delta SSE stream (reusing
  tpumon_torch.deltas.apply_delta client-side), ``--json`` for scripts.

Event kinds are a CLOSED set (``KINDS``): ``record()`` rejects unknown
kinds, and tests/test_events_doc.py lints that every kind recorded
anywhere in the tree is documented in README.md and docs/events.md —
an event vocabulary that drifts from its docs fails CI.
"""

from __future__ import annotations

import asyncio
import json
import time
from collections import deque

# The closed event vocabulary. Adding a kind means documenting it in
# README.md's event table and docs/events.md (tests/test_events_doc.py
# enforces both directions).
KINDS = (
    "actuate",    # actuation engine: policy armed / fired / reverted /
                  # suppressed / rate-limited, actuator bound
                  # (tpumon_torch.actuate)
    "alert",      # alert engine: fired / resolved (tpumon_torch.alerts)
    "anomaly",    # EWMA detector fired / cleared (tpumon_torch.anomaly)
    "breaker",    # circuit-breaker state transition (tpumon_torch.sampler)
    "chaos",      # injected fault (tpumon_torch.collectors.chaos)
    "config",     # monitor configured / reconfigured (tpumon_torch.sampler)
    "federation", # aggregator tree: tier up/down, keyframe resync,
                  # rollup lag (tpumon_torch.federation)
    "history",    # history/state/journal snapshot save+restore moments
    "leader",     # root HA leadership: promoted / demoted / fenced,
                  # peer journal reconciled (tpumon_torch.leader)
    "peer",       # federation peer up / down / wire-fallback
    "profile",    # jax.profiler device capture (tpumon_torch.profiler)
    "query",      # query engine: rejected recording rule, distributed
                  # sub-query timeout, partial-merge degraded
                  # (tpumon_torch.query / tpumon_torch.federation)
    "server",     # HTTP server lifecycle (tpumon_torch.app)
    "silence",    # alert silence added / removed (tpumon_torch.alerts)
    "slo",        # SLO engine: burn-rate alert fired / resolved,
                  # rejected objective (tpumon_torch.slo)
    "watchdog",   # sampler loop overrun / swallowed exception
)

SEVERITIES = ("info", "minor", "serious", "critical")

JOURNAL_VERSION = 1


class EventJournal:
    """Append-only bounded event ring with monotonic sequence numbers.

    O(1) per record; the ring overwrites oldest-first, lifetime
    ``counts`` keep the Prometheus counters honest across overwrite.
    Appends may come from worker threads (peer fetches, snapshot
    writers) — deque.append and the counter update are atomic enough
    under the GIL; the *section-version bump* that makes new events
    visible to the render caches stays on the event loop
    (Sampler._publish_events / mark_events_dirty).
    """

    MIN_CAPACITY = 16  # a ring too small to hold one alert lifecycle is a bug

    def __init__(self, capacity: int = 4096):
        self.capacity = max(self.MIN_CAPACITY, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._recorded = 0

        self.counts: dict[tuple[str, str], int] = {}

    @property
    def seq(self) -> int:
        """Sequence number of the newest event (0 = empty journal)."""
        return self._seq

    @property
    def recorded(self) -> int:
        """Lifetime events recorded (including restored ones)."""
        return self._recorded

    @property
    def dropped(self) -> int:
        """Events the bounded ring has overwritten."""
        return max(0, self._recorded - len(self._ring))

    def record(
        self,
        kind: str,
        severity: str,
        source: str,
        msg: str,
        ts: float | None = None,
        **attrs,
    ) -> dict:
        """Append one event; returns the stored dict (with its seq).

        ``kind`` must be in KINDS and ``severity`` in SEVERITIES — an
        unknown kind is a programming error (and would ship
        undocumented), so it raises instead of passing through.
        ``attrs`` ride flat on the event; None values are dropped.
        """
        if kind not in KINDS:
            raise ValueError(f"unknown event kind {kind!r}; known: {KINDS}")
        if severity not in SEVERITIES:
            raise ValueError(
                f"unknown event severity {severity!r}; known: {SEVERITIES}"
            )
        self._seq += 1
        ev = {
            "seq": self._seq,
            "ts": round(time.time() if ts is None else ts, 3),
            "kind": kind,
            "severity": severity,
            "source": source,
            "msg": msg,
        }
        for k, v in attrs.items():
            if v is not None:
                ev[k] = v
        self._ring.append(ev)
        self._recorded += 1
        key = (kind, severity)
        self.counts[key] = self.counts.get(key, 0) + 1
        return ev

    # ------------------------------ views ------------------------------

    def events(self) -> list[dict]:
        """The whole ring, oldest first."""
        return list(self._ring)

    def recent(self, n: int = 50, kind: str | None = None) -> list[dict]:
        """Newest-first tail, optionally filtered by kind — O(matched +
        skipped), walked from the new end."""
        out: list[dict] = []
        for ev in reversed(self._ring):
            if kind is not None and ev.get("kind") != kind:
                continue
            out.append(ev)
            if len(out) >= n:
                break
        return out

    def after(self, seq: int, kind: str | None = None) -> list[dict]:
        """Events with seq > ``seq``, oldest first — O(new), walked from
        the new end (the ring is seq-ordered). The notifier's per-tick
        "what's new" query."""
        out: list[dict] = []
        for ev in reversed(self._ring):
            if ev["seq"] <= seq:
                break
            if kind is None or ev.get("kind") == kind:
                out.append(ev)
        out.reverse()
        return out

    def query(
        self,
        after: int | None = None,
        kind: str | None = None,
        severity: str | None = None,
        since: float | None = None,
        limit: int = 100,
    ) -> list[dict]:
        """Filtered page, ascending by seq (the /api/events contract).

        With ``after`` (a cursor): the FIRST ``limit`` matches past it —
        forward pagination walks the journal oldest→newest without
        skipping. Without: the LAST ``limit`` matches (the tail a human
        asks for first).
        """
        matched = [
            ev
            for ev in self._ring
            if (after is None or ev["seq"] > after)
            and (kind is None or ev.get("kind") == kind)
            and (severity is None or ev.get("severity") == severity)
            and (since is None or ev.get("ts", 0) >= since)
        ]
        return matched[:limit] if after is not None else matched[-limit:]

    # --------------------------- restore path ---------------------------

    def ingest(self, events: list) -> int:
        """Merge restored events (JSONL restore, alert-state restore)
        into the ring: dedup by seq, keep seq order, advance the
        counter past the restored maximum. Malformed entries are
        skipped — a half-written line must not poison the restore.
        Returns the number of events added."""
        existing = {ev["seq"] for ev in self._ring}
        added: list[dict] = []
        for raw in events or []:
            if not isinstance(raw, dict):
                continue
            try:
                seq = int(raw["seq"])
                ts = float(raw.get("ts", 0.0))
            except (KeyError, TypeError, ValueError):
                continue
            if seq in existing:
                continue
            kind = raw.get("kind", "alert")  # pre-journal alert timelines
            severity = raw.get("severity", "info")
            if kind not in KINDS or severity not in SEVERITIES:
                continue
            ev = {
                **raw,
                "seq": seq,
                "ts": ts,
                "kind": kind,
                "severity": severity,
                "source": raw.get("source", "alerts"),
                "msg": raw.get("msg", raw.get("title", "")),
            }
            existing.add(seq)
            added.append(ev)
        if not added:
            return 0
        merged = sorted([*self._ring, *added], key=lambda ev: ev["seq"])
        self._ring = deque(merged, maxlen=self.capacity)
        self._recorded += len(added)
        self._seq = max(self._seq, merged[-1]["seq"])
        for ev in added:
            key = (ev["kind"], ev["severity"])
            self.counts[key] = self.counts.get(key, 0) + 1
        return len(added)

    def to_json(self) -> dict:
        return {
            "seq": self._seq,
            "recorded": self._recorded,
            "dropped": self.dropped,
            "capacity": self.capacity,
        }


# ----------------------------- persistence -----------------------------


class EventLog:
    """Crash-safe JSONL persistence for an EventJournal.

    Same shape as tpumon_torch.history.HistorySnapshotter: a periodic atomic
    snapshot (the whole ring, one JSON event per line behind a meta
    header) plus restore-on-start — the journal is bounded, so a full
    rewrite per cadence is O(ring), and atomic replace means a crash
    mid-write leaves the previous file intact (no torn tail lines to
    repair). Events are a log: restore keeps everything the file holds,
    no staleness cutoff — yesterday's incident record is the point.
    """

    def __init__(self, journal: EventJournal, path: str, interval_s: float = 30.0):
        self.journal = journal
        self.path = path
        self.interval_s = interval_s
        self.last_save_ts: float | None = None
        self.last_error: str | None = None
        self._task: asyncio.Task | None = None

    def _snapshot_text(self) -> str:
        head = {
            "_journal": JOURNAL_VERSION,
            "saved_at": round(time.time(), 3),
            "seq": self.journal.seq,
        }
        lines = [json.dumps(head, separators=(",", ":"))]
        lines.extend(
            json.dumps(ev, separators=(",", ":")) for ev in self.journal.events()
        )
        return "\n".join(lines) + "\n"

    def save(self) -> bool:
        """Snapshot + write in one call (tests, shutdown); the live
        periodic path is save_async()."""
        return self._write(self._snapshot_text())

    async def save_async(self) -> bool:
        """Serialize on the event loop (the ring is only appended there
        or by GIL-atomic thread appends), write in a worker thread."""
        text = self._snapshot_text()
        return await asyncio.to_thread(self._write, text)

    def _write(self, text: str) -> bool:
        from tpumon_torch.history import atomic_write_text

        try:
            atomic_write_text(self.path, text)
        except OSError as e:
            self.last_error = str(e)
            return False
        self.last_save_ts = time.time()
        self.last_error = None
        return True

    def restore(self) -> bool:
        """Best-effort warm start: parse the JSONL file into the
        journal. False (restoring nothing) on a missing/corrupt file or
        wrong version; individually-malformed lines are skipped."""
        try:
            with open(self.path) as f:
                lines = f.read().splitlines()
        except OSError as e:
            self.last_error = str(e)
            return False
        if not lines:
            return False
        try:
            head = json.loads(lines[0])
        except json.JSONDecodeError as e:
            self.last_error = f"bad journal header: {e}"
            return False
        if not isinstance(head, dict) or head.get("_journal") != JOURNAL_VERSION:
            return False
        events = []
        for line in lines[1:]:
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn line: keep what parses
        self.journal.ingest(events)
        # The saved seq high-water mark survives even if the newest
        # events were lost: cursors handed out before the crash stay
        # monotonic (never re-issued for different events).
        try:
            self.journal._seq = max(self.journal._seq, int(head.get("seq", 0)))
        except (TypeError, ValueError):
            pass
        return True

    def to_json(self) -> dict:
        return {
            "path": self.path,
            "interval_s": self.interval_s,
            "last_save_ts": self.last_save_ts,
            "last_error": self.last_error,
        }

    # ---------------------------- lifecycle ----------------------------

    async def start(self) -> None:
        async def loop() -> None:
            while True:
                await asyncio.sleep(self.interval_s)
                try:
                    await self.save_async()
                except Exception as e:  # never let the snapshot loop die
                    self.last_error = str(e)

        self._task = asyncio.create_task(loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        try:
            await self.save_async()  # final snapshot
        except Exception as e:
            self.last_error = str(e)


# ------------------------------ CLI ------------------------------


_SEV_MARK = {"info": "·", "minor": "🟡", "serious": "🟠", "critical": "🔴"}


def render_event_line(ev: dict) -> str:
    """One journal event as a terminal line (``tpumon events``)."""
    t = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0)))
    mark = _SEV_MARK.get(ev.get("severity", ""), "·")
    return (
        f"{t} {mark} {ev.get('kind', '?'):<9} "
        f"{ev.get('source', ''):<12} {ev.get('msg', '')}"
    )


def events_cli(argv: list[str]) -> int:
    """``tpumon events`` — tail a running server's event journal.

    usage: tpumon events [--url HOST:8888] [-n N] [--kind KIND]
                         [--severity SEV] [--follow] [--json]

    --follow keeps the tail live over the delta SSE stream (/api/stream)
    — frames are epoch-keyed patches applied client-side, so following
    costs the server no extra render work.
    """
    import sys
    import urllib.request

    from tpumon_torch.deltas import apply_delta

    url = "127.0.0.1:8888"
    limit = 40
    kind = severity = None
    follow = as_json = False
    it = iter(argv)
    for a in it:
        if a == "--url":
            url = next(it, url)
        elif a in ("-n", "--lines"):
            raw = next(it, "40") or "40"
            if not raw.isdigit():
                print(f"{a} wants an integer, got {raw!r}", file=sys.stderr)
                return 2
            limit = int(raw)
        elif a == "--kind":
            kind = next(it, None)
            if kind not in KINDS:
                print(f"unknown kind {kind!r}; known: {', '.join(KINDS)}",
                      file=sys.stderr)
                return 2
        elif a == "--severity":
            severity = next(it, None)
            if severity not in SEVERITIES:
                print(
                    f"unknown severity {severity!r}; known: "
                    f"{', '.join(SEVERITIES)}",
                    file=sys.stderr,
                )
                return 2
        elif a == "--follow":
            follow = True
        elif a == "--json":
            as_json = True
        elif a in ("-h", "--help"):
            print(events_cli.__doc__)
            return 0
        else:
            print(f"unknown argument {a!r}", file=sys.stderr)
            return 2
    if "://" not in url:
        url = f"http://{url}"
    url = url.rstrip("/")

    def emit(ev: dict) -> None:
        print(json.dumps(ev) if as_json else render_event_line(ev), flush=True)

    query = f"limit={limit}"
    if kind:
        query += f"&kind={kind}"
    if severity:
        query += f"&severity={severity}"
    try:
        with urllib.request.urlopen(f"{url}/api/events?{query}", timeout=10) as r:
            page = json.load(r)
    except OSError as e:
        print(f"tpumon at {url} unreachable: {e}", file=sys.stderr)
        return 1
    last_seq = 0
    for ev in page.get("events", []):
        emit(ev)
        last_seq = max(last_seq, ev.get("seq", 0))
    if not follow:
        return 0

    def matches(ev: dict) -> bool:
        if kind and ev.get("kind") != kind:
            return False
        if severity and ev.get("severity") != severity:
            return False
        return True

    # Follow mode: reconstruct the realtime payload from SSE keyframes +
    # patches; new journal entries ride its bounded "events.recent"
    # window. A detected gap reconnects (first frame is a keyframe).
    while True:
        state = None
        epoch = -1
        try:
            with urllib.request.urlopen(f"{url}/api/stream", timeout=60) as r:
                for raw in r:
                    if not raw.startswith(b"data: "):
                        continue
                    frame = json.loads(raw[6:])
                    if "key" in frame:
                        state = frame["key"]
                        epoch = frame["epoch"]
                    elif frame.get("prev") == epoch and state is not None:
                        epoch = frame["epoch"]
                        if frame.get("patch") is not None:
                            state = apply_delta(state, frame["patch"])
                    else:
                        break  # gap: reconnect for a fresh keyframe
                    recent = ((state or {}).get("events") or {}).get("recent") or []
                    for ev in sorted(recent, key=lambda e: e.get("seq", 0)):
                        if ev.get("seq", 0) > last_seq and matches(ev):
                            emit(ev)
                            last_seq = ev["seq"]
        except KeyboardInterrupt:
            return 0
        except OSError as e:
            print(f"stream lost ({e}); retrying", file=sys.stderr)
            time.sleep(1.0)
