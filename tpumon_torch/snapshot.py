"""Snapshot epochs, dirty-section versioning, and the render cache.

The monitoring data plane used to do O(chips × clients) work: every
consumer of the realtime state — the JSON routes, the SSE stream, the
Prometheus exporter, peer aggregators — re-serialized the entire
snapshot on every request, even though the state only changes when the
sampler ticks. This module makes the *tick* the unit of work instead of
the request:

- ``EpochClock``: a monotonic snapshot epoch. Every time the sampler
  publishes new data for a section (host / accel / k8s / serving /
  alerts) the epoch advances and that section's version is set to it.
  A section whose data did not change keeps its old version — "dirty"
  is data-driven, not tick-driven.
- ``RenderCache``: per-route serialized bytes keyed on the version of
  the sections the route reads. Any number of requests between ticks
  are served the *same* bytes with zero re-serialization, and the
  version doubles as a strong ETag so HTTP clients (dashboards, peer
  aggregators, Prometheus via a caching proxy) get 304s for free.
- ``ExporterCache``: the same idea at metric-family granularity — the
  Prometheus text rebuilds only the blocks whose section version moved
  (a k8s tick does not re-render 256 chips' worth of gauge lines).

Hit/render counters are first-class so tests pin the fast path by
*counting* renders, not by timing them (tests/test_fastpath.py).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass

# The dirty-trackable sections of the snapshot. "samples" is a
# pseudo-section bumped on every publish regardless of data equality —
# it versions things that move with collection activity itself
# (tpumon_samples_total, latency stats) rather than with the data.
# "events" versions the structured event journal (tpumon_torch.events):
# bumped once per tick when the journal grew, plus immediately on
# out-of-tick mutations (silence POSTs, profiler captures).
# "federation" versions the aggregator tree's fan-in state
# (tpumon_torch.federation): bumped as downstream delta frames land and on
# dark/recover transitions, so /api/federation re-renders only when
# the fleet view actually moved.
# "slo" versions the SLO engine's published view (tpumon_torch.slo): bumped
# once per tick when an objective's budget/burn/alert state moved, so
# /api/slo and the tpumon_slo_* exporter block re-render only then.
# "actuate" versions the actuation engine's published view
# (tpumon_torch.actuate): bumped when a policy's state/value/action record
# moved, so /api/actuate, the SSE actuation card and the
# tpumon_actuate_* exporter block re-render only then.
SECTIONS = (
    "host", "accel", "k8s", "serving", "alerts", "samples", "events",
    "federation", "slo", "actuate",
)


class EpochClock:
    """Monotonic snapshot epoch with per-section dirty versions.

    ``epoch`` only ever advances; ``versions[s]`` is the epoch at which
    section ``s`` last changed. ``version_of(*sections)`` is the cache
    key for anything derived from those sections: it changes iff any of
    them changed.
    """

    def __init__(self) -> None:
        self.epoch: int = 0
        self.versions: dict[str, int] = {s: 0 for s in SECTIONS}

    def bump(self, section: str) -> int:
        self.epoch += 1
        self.versions[section] = self.epoch
        return self.epoch

    def version_of(self, *sections: str) -> int:
        return max(self.versions[s] for s in sections)

    def to_json(self) -> dict:
        return {"epoch": self.epoch, "sections": dict(self.versions)}


@dataclass
class _Entry:
    version: int
    body: bytes
    etag: str


class RenderCache:
    """Serialized-bytes cache keyed on (route, dep-section versions).

    ``get(key, sections, build)`` returns ``(body, etag)``; ``build``
    runs only when one of the route's sections changed since the last
    render. The etag is strong (identical bytes ⇔ identical etag for a
    given key), derived from the dep version — cheap to compare against
    ``If-None-Match`` for a 304.
    """

    # Cap on REQUEST-DERIVED keys (``evictable=True`` — e.g. per-window
    # history renders): arbitrary query values must never grow the cache
    # unboundedly, and their eviction must never expel the fixed route
    # entries (which are a small static set by construction and are only
    # ever *replaced* when their version moves — so a fixed route's ETag
    # is honestly strong: same ETag ⇔ same bytes).
    MAX_EVICTABLE = 16

    def __init__(self, clock: EpochClock):
        self.clock = clock
        self._entries: dict[str, _Entry] = {}
        self._evictable: list[str] = []  # insertion order of evictable keys
        # Per-process boot nonce in every ETag: the epoch counter starts
        # at 0 each process with deterministic early ticks, so without
        # this a client (e.g. a federating aggregator sending
        # If-None-Match) could get a wrong 304 across a server restart
        # and serve the pre-restart data forever.
        self._boot = uuid.uuid4().hex[:8]
        self.renders = 0  # builds (cache misses)
        self.hits = 0  # served straight from cached bytes

    def get(
        self, key: str, sections: tuple[str, ...], build, evictable: bool = False
    ) -> tuple[bytes, str]:
        ver = self.clock.version_of(*sections)
        ent = self._entries.get(key)
        if ent is not None and ent.version == ver:
            self.hits += 1
            return ent.body, ent.etag
        body = build()
        if isinstance(body, str):
            body = body.encode()
        self.renders += 1
        if evictable and key not in self._entries:
            if len(self._evictable) >= self.MAX_EVICTABLE:
                self._entries.pop(self._evictable.pop(0), None)
            self._evictable.append(key)
        ent = _Entry(
            version=ver,
            body=body,
            etag=f'"{key.strip("/")}-{self._boot}-{ver}"',
        )
        self._entries[key] = ent
        return ent.body, ent.etag

    def to_json(self) -> dict:
        total = self.renders + self.hits
        return {
            "renders": self.renders,
            "hits": self.hits,
            "hit_pct": round(100.0 * self.hits / total, 1) if total else None,
            "entries": len(self._entries),
        }


class ExporterCache:
    """Per-section Prometheus text blocks, rebuilt only when their
    section version moved. The exporter's render functions are pure
    over the sampler's snapshot, so a block whose inputs did not change
    renders to identical text — reuse it instead of re-walking 256
    chips of gauges because one pod changed phase.
    """

    def __init__(self, clock: EpochClock):
        self.clock = clock
        self._blocks: dict[str, tuple[int, str]] = {}
        self.renders: dict[str, int] = {}
        self.hits: dict[str, int] = {}

    def block(self, name: str, sections: tuple[str, ...], build) -> str:
        ver = self.clock.version_of(*sections)
        cached = self._blocks.get(name)
        if cached is not None and cached[0] == ver:
            self.hits[name] = self.hits.get(name, 0) + 1
            return cached[1]
        text = build()
        self.renders[name] = self.renders.get(name, 0) + 1
        self._blocks[name] = (ver, text)
        return text

    def to_json(self) -> dict:
        return {
            "renders": dict(self.renders),
            "hits": dict(self.hits),
        }
