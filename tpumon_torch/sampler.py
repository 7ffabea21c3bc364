"""Background sampler: the single owner of all monitoring state.

The reference collects synchronously inside each HTTP request handler —
three blocking shell-outs per /api/alerts hit (monitor_server.js:283-286)
— and keeps pod-transition state in a module global mutated per request
(monitor_server.js:157,235), which SURVEY §5.2 identifies as a data race
between concurrent pollers. tpumon inverts this: one asyncio sampler
collects on fixed cadences, owns the alert engine and ring history, and
publishes immutable-ish snapshots; HTTP handlers only read. Transition
detection becomes independent of client polling (SURVEY §2.2 note).

The sampler also keeps self-metrics (per-source sample counts, latencies,
consecutive failures) — the §5.1 "measure our own pipeline" requirement
behind the scrape→render p50 metric.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass, field

from tpumon_torch import tsdb
from tpumon_torch.actuate import ActuationEngine, parse_actuations
from tpumon_torch.alerts import AlertEngine
from tpumon_torch.anomaly import AnomalyBank, AnomalyConfig
from tpumon_torch.collectors import Collector, Sample, run_collector
from tpumon_torch.config import Config
from tpumon_torch.events import EventJournal
from tpumon_torch.history import RingHistory
from tpumon_torch.query import QueryEngine, QueryError, RecordingRule, RuleSet
from tpumon_torch.resilience import DEADLINE_ERROR, CircuitBreaker, LoopWatchdog
from tpumon_torch.slo import SLOEngine, parse_slos
from tpumon_torch.snapshot import EpochClock
from tpumon_torch.topology import ChipSample, attribute_pods, slice_views
from tpumon_torch.tracing import SpanTracer, quantiles


@dataclass
class SourceStats:
    samples: int = 0
    failures: int = 0
    consecutive_failures: int = 0
    deadline_exceeded: int = 0  # failures that were deadline expiries
    skipped: int = 0  # polls the circuit breaker suppressed
    latencies_ms: deque = field(default_factory=lambda: deque(maxlen=512))

    def record(self, s: Sample) -> None:
        self.samples += 1
        self.latencies_ms.append(s.latency_ms)
        if s.ok:
            self.consecutive_failures = 0
        else:
            self.failures += 1
            self.consecutive_failures += 1
            if s.error and s.error.startswith(DEADLINE_ERROR):
                self.deadline_exceeded += 1

    def latency_summary(self) -> tuple[float, float, float] | None:
        """(p50, p95, max) over the window, computed in ONE sorted pass
        — callers render all three per tick, so sorting the 512-entry
        deque once replaces three statistics.median-style walks."""
        return quantiles(self.latencies_ms)

    def p50_ms(self) -> float | None:
        q = self.latency_summary()
        return q[0] if q else None

    def to_json(self) -> dict:
        q = self.latency_summary()
        return {
            "samples": self.samples,
            "failures": self.failures,
            "consecutive_failures": self.consecutive_failures,
            "deadline_exceeded": self.deadline_exceeded,
            "skipped": self.skipped,
            "latency_p50_ms": round(q[0], 3) if q else 0.0,
            "latency_p95_ms": round(q[1], 3) if q else 0.0,
            "latency_max_ms": round(q[2], 3) if q else 0.0,
        }


class Sampler:
    def __init__(
        self,
        cfg: Config,
        host: Collector | None = None,
        accel: Collector | None = None,
        k8s: Collector | None = None,
        serving: Collector | None = None,
        history: RingHistory | None = None,
        engine: AlertEngine | None = None,
        notifier=None,
    ):
        self.cfg = cfg
        self.host = host
        self.accel = accel
        self.k8s = k8s
        self.serving = serving
        self.history = history if history is not None else RingHistory(cfg.history_window_s)
        # Structured event journal (tpumon_torch.events): the single
        # append-only record every subsystem's lifecycle moments land in
        # — alert fired/resolved, breaker transitions, watchdog overruns,
        # chaos injections, peer up/down, anomaly fires. Bounded ring
        # (--events-ring); /api/events, the SSE feed and
        # tpumon_events_total all read it.
        self.journal = EventJournal(cfg.events_ring)
        self._published_events_seq = 0
        self.engine = engine or AlertEngine(cfg.thresholds, journal=self.journal)
        if self.engine.journal is not self.journal:
            # Pre-built engine (tpumon_torch.app.build, tests): its timeline
            # must land in the shared journal, not a private one.
            self.engine.bind_journal(self.journal)
        # EWMA drift detectors (tpumon_torch.anomaly) over fleet-level series:
        # mean duty, mean HBM%, tick duration, per-source scrape p95.
        self.anomaly: AnomalyBank | None = (
            AnomalyBank(
                self.journal,
                AnomalyConfig(
                    alpha=cfg.anomaly_alpha,
                    z_fire=cfg.anomaly_z_fire,
                    z_clear=cfg.anomaly_z_clear,
                    warmup=cfg.anomaly_warmup,
                ),
            )
            if cfg.anomaly_detect
            else None
        )
        # Webhook sink (tpumon_torch.notify.WebhookNotifier or None). The
        # sampler is the single dispatcher: events restored from a state
        # snapshot are marked already-notified so restarts don't re-page.
        self.notifier = notifier
        self._notified_seq = 0

        self.latest: dict[str, Sample] = {}
        self.stats: dict[str, SourceStats] = {}
        # Always-on span tracer (tpumon_torch.tracing): a bounded ring of
        # data-plane spans — ticks, per-collector collects, alert/
        # history stages — behind /api/trace, /api/trace/export and the
        # tpumon_stage_duration_seconds histograms. trace_ring=0
        # disables (spans become shared no-ops).
        self.tracer = SpanTracer(cfg.trace_ring)
        # Per-source circuit breakers (tpumon_torch.resilience): a repeatedly-
        # failing source is probed on a backoff cadence instead of paying
        # a full deadline's worth of tick budget every interval.
        # breaker_failures=0 disables breaking entirely.
        self.breakers: dict[str, CircuitBreaker] = {}
        # Per-loop watchdogs: tick lag/skew + swallowed exceptions.
        self.watchdogs: dict[str, LoopWatchdog] = {}
        # Wedged-orphan registry (tpumon_torch.resilience.collect_bounded): a
        # source whose deadline-abandoned collect is STILL alive (pinned
        # in a worker thread cancellation can't interrupt) is refused new
        # polls, so it holds at most one shared-executor thread.
        self._orphans: dict[str, asyncio.Task] = {}
        # Per-chip history bookkeeping (--history-per-chip): which chips
        # hold chip.<id>.* ring series, and which the cap refused.
        self._perchip_tracked: set[str] = set()
        self._perchip_skipped: set[str] = set()
        # Serving tenants whose label can't name a series (dots) —
        # journaled once each, never silently dropped.
        self._tenant_skipped: set[str] = set()
        # Batch-ingest handle caches (ROADMAP item 5 / docs/perf.md
        # "ingest spine"): series are resolved ONCE — per-chip series
        # names are formatted once per chip ever (not 4 f-strings per
        # chip per tick) and the resolved RingSeries handles feed
        # history.record_batch directly. Invalidated when the ring's
        # generation moves (snapshot restore replaced series objects).
        self._hist_gen: int | None = None
        # chip_id -> [names tuple, [handle-or-None x4]] (handles resolve
        # lazily per metric so a never-reporting metric never creates an
        # empty series — same behavior as the old record(None) skip).
        self._perchip_handles: dict[str, list] = {}
        self._fleet_handles: dict = {}
        # One-shot out-of-order journalling (a misbehaving clock must
        # show up, not silently degrade append cost). No baseline
        # needed: restore paths never bump the ring's counter, so any
        # nonzero count is live-tick disorder.
        self._ooo_logged = False
        self.ici_rates: dict[str, dict] = {}  # chip_id -> {tx_bps, rx_bps}
        self._prev_ici: dict[str, tuple[float, int, int]] = {}  # chip -> (ts, tx, rx)
        # Last-known accelerator family per slice id and per chip id:
        # an expected-but-absent slice (or a chip whose
        # collector failed a scrape) has no current sample to take a
        # family from, but the `accel` label must not flip to "tpu"
        # across an outage — that would fork the exporter's Prometheus
        # series identity, and silently empty `{accel="gpu"}` query/
        # alert matchers over still-in-lookback chip series, exactly
        # when the operator is debugging the GPU outage.
        self._slice_accel_kinds: dict[str, str] = {}
        self._chip_accel_kinds: dict[str, str] = {}
        # Host NIC rates — the DCN-traffic proxy (SURVEY §5.8: ICI
        # within a slice, DCN across hosts).
        self.net_rates: dict = {}  # {rx_bps, tx_bps} once two samples exist
        self._prev_net: tuple[float, int, int] | None = None  # (ts, rx, tx)
        self._tasks: list[asyncio.Task] = []
        self.started_at = time.time()
        # Snapshot epoch + per-section dirty versions (tpumon_torch.snapshot):
        # the render caches and the delta SSE stream key off this. A
        # section only bumps when its published data actually changed,
        # so consumers of unchanged sections reuse their last render.
        self.clock = EpochClock()
        self._alerts_fp: tuple | None = None
        self._prev_extras: dict[str, dict | None] = {}
        # Tick broadcast for push consumers (the SSE stream): rotated
        # and set at the end of every fast tick.
        self._tick_fired = asyncio.Event()
        # Previous fast-tick duration — the anomaly detector's tick_ms
        # series (a tick can't observe its own total mid-flight) — and
        # the fleet means _record_history stashes for it per tick.
        self._last_tick_ms: float | None = None
        self._fleet_duty: float | None = None
        self._fleet_hbm: float | None = None
        # Hierarchical federation (tpumon_torch.federation): tpumon_torch.app.build
        # attaches a FederationHub here when this instance is an
        # aggregator or root (downstream delta streams fan in through it)
        # and a FederationUplink when --federate-up is configured (this
        # instance pushes delta frames to its upstream). Both are None
        # on a standalone monitor.
        self.federation = None
        self.uplink = None
        # Root-HA leadership lease (tpumon_torch.leader): tpumon_torch.app.build
        # attaches a LeaderLease when this root has a standby peer
        # configured. None everywhere else — the actuation engine's
        # leader_check below treats None as "always leader", so
        # standalone and single-root deployments actuate exactly as
        # before.
        self.leader = None
        # In-tree query engine (tpumon_torch.query, docs/query.md): one per
        # process, over this sampler's ring — /api/query[_range], the
        # expression alert rules' vocabulary, the `tpumon query` CLI
        # and the distributed federation planner all go through it.
        # The augmenter wires pod attribution in as a derived label
        # (``by (pod)`` over chip series) without the engine importing
        # any collector.
        self.query = QueryEngine(
            self.history,
            default_range_s=cfg.query_default_range_s,
            lookback_s=cfg.query_lookback_s,
            augment=self._query_augmenter,
        )
        rules: list[RecordingRule] = []
        for text in cfg.recording_rules:
            try:
                rules.append(RecordingRule(text))
            except QueryError as e:
                # A bad rule must be an incident, not a silent no-op:
                # the operator configured an aggregate that will never
                # be maintained.
                self.journal.record(
                    "query", "serious", "query",
                    f"recording rule {text!r} rejected: {e}", rule=text,
                )
        # SLO engine (tpumon_torch.slo, docs/slo.md): error budgets +
        # multi-window burn-rate alerts over compiled query-language
        # expressions, evaluated per fast tick. None when no objectives
        # are configured. A rejected objective is an incident — the
        # operator declared an SLO that will never be watched.
        self.slo: SLOEngine | None = None
        slo_specs, slo_errors = parse_slos(cfg.slos)
        for err in slo_errors:
            self.journal.record(
                "slo", "serious", "slo", f"slo objective rejected: {err}",
            )
        if slo_specs:
            self.slo = SLOEngine(
                slo_specs, self.query, self.history, self.journal)
            # The burn/budget windows ride the recording-rule store:
            # every avg_over_time the engine re-evaluates per tick is
            # an O(sub-buckets) head-state merge, never a point walk —
            # which is what holds slo_eval_overhead_tick_pct ≤ 2%.
            for text in self.slo.rule_texts():
                rules.append(RecordingRule(text))
        # Actuation engine (tpumon_torch.actuate, docs/actuation.md): guarded
        # policies over the same compiled-expression machinery, driving
        # a bound serving engine (tpumon_torch.app wires --serve-loadgen;
        # unbound = journal-intent-only). A rejected policy is an
        # incident — the operator declared a remedy that will never run.
        self.actuate: ActuationEngine | None = None
        act_specs, act_errors = parse_actuations(cfg.actuations)
        for err in act_errors:
            self.journal.record(
                "actuate", "serious", "actuate",
                f"actuation policy rejected: {err}",
            )
        if act_specs:
            self.actuate = ActuationEngine(
                act_specs, self.query, self.history, self.journal,
                dark_slices=self._dark_slices,
                placement_domains=self._placement_domains,
                dry_run=cfg.actuate_dry_run,
                max_actions=cfg.actuate_max_actions,
                window_s=cfg.actuate_window_s,
                shed_max_fraction=cfg.shed_max_fraction,
                # Closure, not a bound value: app.build attaches the
                # lease AFTER the sampler is constructed, and leadership
                # must be asked at fire time, not engine-build time.
                leader_check=lambda: (self.leader.is_leader()
                                      if self.leader is not None
                                      else True),
            )
            # Trend conditions (avg_over_time(queue_depth[w])) ride the
            # recording-rule store like the SLO windows — bench.py's
            # ``actuate`` phase pins the ≤1% tick bound this buys.
            for text in self.actuate.rule_texts():
                rules.append(RecordingRule(text))
            if self.slo is not None:
                # slo.<name>.paging is recorded for actuation
                # conditions only — see SLOEngine.record_paging.
                self.slo.record_paging = True
        if rules:
            self.history.set_recording_rules(RuleSet(rules))
        # Chaos wrappers and peer federations record their own journal
        # events; hand them the shared journal (duck-typed so the
        # collector layer stays import-free of the sampler).
        for c in (host, accel, k8s, serving):
            if c is not None and hasattr(c, "set_journal"):
                c.set_journal(self.journal)

    def _dark_slices(self) -> list[str] | None:
        """Placement domains the federation tree currently marks
        dark/unreachable — the drain policies' trigger input (recorded
        as the ``federation.dark`` series each actuation tick). None on
        a standalone monitor (no hub): the actuation engine then skips
        the per-tick series record entirely — a monitor with no fleet
        must not pay for (or fake) a fleet series on every tick."""
        hub = self.federation
        if hub is None:
            return None
        return sorted({
            str(r.get("slice_id"))
            for r in hub.slices()
            if r.get("slice_id") and r.get("health") != "ok"
        })

    def _placement_domains(self) -> list[str] | None:
        """ALL fleet placement domains — dark or not — the actuation
        engine syncs into the serving engine (set_slices) so requests
        carry a slice attribution before any drain fires. A bound MESH
        serving engine overrides everything: its dp replica ids ARE the
        placement domains (``drain_slice("r1")`` must hit a replica the
        router actually routes around, not a topology slice name the
        mesh knows nothing about). Otherwise federated: the hub's slice
        namespace (the same names `_dark_slices` reports, so drain
        targets always match). Standalone: the local accel topology's
        slice ids. None/[] = nothing known yet (the engine keeps its
        last synced namespace)."""
        act = self.actuate
        eng = (getattr(act.actuator, "engine", None)
               if act is not None and act.actuator is not None else None)
        replica_ids = getattr(eng, "replica_ids", None)
        if replica_ids:
            return list(replica_ids)
        hub = self.federation
        if hub is not None:
            return sorted({
                str(r.get("slice_id"))
                for r in hub.slices()
                if r.get("slice_id")
            })
        return sorted({v.slice_id for v in self.slices() if v.slice_id})

    def _query_augmenter(self):
        """Per-evaluation label hook for the query engine: chip-family
        labels gain ``pod`` from the current pod→chip attribution and
        ``accel`` from the chip's accelerator family (the
        label ``by (accel)`` group-bys and ``{accel="gpu"}`` matchers
        resolve against); slice-family labels gain ``accel`` from the
        federation hub's slice table. Each map is computed at most once
        per evaluation, and only when a matched series actually carries
        the triggering label (the walks are O(chips)/O(slices);
        per-tick evaluations over serving/slo series must not pay them
        — bench.py's ``slo`` phase pins that)."""
        owners_box: list[dict] = []
        kinds_box: list[dict] = []
        slice_kinds_box: list[dict] = []

        def augment(family: str, labels: dict) -> None:
            cid = labels.get("chip")
            if cid is not None:
                if not owners_box:
                    chips = self.chips()
                    owners_box.append(attribute_pods(chips, self.pods()))
                    # Fold this tick's chips into the last-known-family
                    # memory and label from THAT: a chip whose
                    # collector failed this scrape keeps its family
                    # while its series are within query lookback
                    # (never-seen chips read as the "tpu" default).
                    for c in chips:
                        self._chip_accel_kinds[c.chip_id] = c.accel_kind
                    kinds_box.append(self._chip_accel_kinds)
                pod = owners_box[0].get(cid)
                if pod is not None:
                    labels["pod"] = pod
                labels["accel"] = kinds_box[0].get(cid, "tpu")
                return
            sid = labels.get("slice")
            if sid is not None and self.federation is not None:
                if not slice_kinds_box:
                    slice_kinds_box.append({
                        (r.get("node"), str(r.get("slice_id"))):
                            r.get("accel_kind") or "tpu"
                        for r in self.federation.slices()
                    })
                labels["accel"] = slice_kinds_box[0].get(
                    (labels.get("node"), sid), "tpu"
                )

        return augment

    @property
    def epoch(self) -> int:
        return self.clock.epoch

    async def wait_tick(self, timeout_s: float | None = None) -> bool:
        """Block until the next fast tick completes (True) or the
        timeout expires (False). Each caller sees every tick: the event
        is rotated, not cleared, so there is no missed-wakeup race."""
        ev = self._tick_fired
        if timeout_s is None:
            await ev.wait()
            return True
        try:
            await asyncio.wait_for(ev.wait(), timeout_s)
            return True
        except asyncio.TimeoutError:
            return False

    # ------------------------- snapshot accessors -------------------------

    def sample_of(self, source: str) -> Sample | None:
        return self.latest.get(source)

    def chips(self) -> list[ChipSample]:
        s = self.latest.get("accel")
        return list(s.data) if s and s.data else []

    def slices(self):
        views = slice_views(self.chips(), self.cfg.expected_slice_chips)
        for v in views:
            if v.accel_kind is not None:
                self._slice_accel_kinds[v.slice_id] = v.accel_kind
        return views

    def slice_accel_kind(self, slice_id: str) -> str:
        """Stable accelerator family for a slice: its chips' family
        while reporting, the last-known family across an outage, and
        the pre-accel_kind default ("tpu") for a slice that never
        reported in this process's lifetime."""
        return self._slice_accel_kinds.get(slice_id, "tpu")

    def pods(self) -> list[dict]:
        s = self.latest.get("k8s")
        return list(s.data) if s and s.data else []

    def host_data(self) -> dict:
        s = self.latest.get("host")
        return dict(s.data) if s and s.data else {}

    def serving_data(self) -> list[dict]:
        s = self.latest.get("serving")
        return list(s.data) if s and s.data else []

    def health_json(self) -> dict:
        return {
            "uptime_s": round(time.time() - self.started_at, 1),
            "snapshot": self.clock.to_json(),
            "events": self.journal.to_json(),
            # Columnar history store health (tpumon_torch.tsdb): series/point
            # counts, resident bytes, and the per-chip cap's effect.
            "history": {
                "series": len(self.history.series),
                "points": self.history.count_points(),
                "resident_bytes": self.history.resident_bytes(),
                "per_chip_cap": self.cfg.history_per_chip,
                "per_chip_tracked": len(self._perchip_tracked),
                "per_chip_skipped": len(self._perchip_skipped),
                # Ingest spine health (docs/perf.md): whether the native
                # append/downsample kernel is active (False = bit-exact
                # Python fallback) and, when it failed to build or load,
                # why; and how many live appends arrived with a
                # backwards timestamp (each one degrades that append to
                # an O(series) sorted insert — see the one-shot
                # "history" journal event).
                "ingest_kernel": tsdb.kernel() is not None,
                "ingest_kernel_error": tsdb.kernel_status()["error"],
                "out_of_order_appends": self.history.out_of_order,
            },
            **(
                {"anomaly": self.anomaly.to_json()}
                if self.anomaly is not None and self.anomaly.detectors
                else {}
            ),
            # SLO engine summary (tpumon_torch.slo): objective count + which
            # burn windows are currently firing; the full budget/burn
            # table lives on /api/slo.
            **(
                {
                    "slo": {
                        "objectives": len(self.slo.compiled),
                        "firing": [
                            f"{r['name']}/{r['window']}"
                            for r in self.slo.alert_rows()
                        ],
                    }
                }
                if self.slo is not None
                else {}
            ),
            # Actuation engine summary (tpumon_torch.actuate): policy count +
            # which policies currently hold a fired action; the full
            # state table lives on /api/actuate.
            **(
                {
                    "actuate": {
                        "policies": len(self.actuate.policies),
                        "dry_run": self.actuate.dry_run,
                        "engine_bound": self.actuate.actuator is not None,
                        "fired": [
                            p.spec.name for p in self.actuate.policies
                            if p.state == "fired"
                        ],
                    }
                }
                if self.actuate is not None
                else {}
            ),
            # Aggregator-tree health (tpumon_torch.federation): downstream
            # fan-in counts when this node aggregates, uplink stream
            # state when it pushes. Absent on standalone monitors.
            **(
                {
                    "federation": {
                        **(
                            self.federation.health_json()
                            if self.federation is not None
                            else {}
                        ),
                        **(
                            {"uplink": self.uplink.to_json()}
                            if self.uplink is not None
                            else {}
                        ),
                        # Root-HA heartbeat channel: the standby peer's
                        # LeaderLease polls exactly this block (node,
                        # leader, generation) to decide promotion —
                        # tpumon_torch.leader._poll_cycle.
                        **(
                            {"leader": self.leader.to_json()}
                            if self.leader is not None
                            else {}
                        ),
                    }
                }
                if (self.federation is not None or self.uplink is not None
                    or self.leader is not None)
                else {}
            ),
            **(
                {"webhooks": self.notifier.to_json()}
                if self.notifier is not None
                else {}
            ),
            "sources": {
                name: {
                    **(self.latest[name].health_json() if name in self.latest else {}),
                    **(self.stats[name].to_json() if name in self.stats else {}),
                    **(
                        {"breaker": self.breakers[name].to_json()}
                        if name in self.breakers
                        else {}
                    ),
                }
                for name in ("host", "accel", "k8s", "serving")
                if name in self.latest or name in self.stats
            },
            "loops": {
                name: wd.to_json() for name, wd in self.watchdogs.items()
            },
        }

    # ----------------------------- sampling -------------------------------

    def _deadline_for(self, name: str) -> float | None:
        d = self.cfg.collect_deadlines.get(name, self.cfg.collect_deadline_s)
        return d if d and d > 0 else None

    def _breaker_for(self, name: str) -> CircuitBreaker | None:
        if self.cfg.breaker_failures <= 0:
            return None
        br = self.breakers.get(name)
        if br is None:
            br = self.breakers[name] = CircuitBreaker(
                failure_threshold=self.cfg.breaker_failures,
                base_backoff_s=self.cfg.breaker_backoff_s,
                max_backoff_s=self.cfg.breaker_backoff_max_s,
            )
        return br

    def _journal_breaker(self, name: str, prev: str, br: CircuitBreaker) -> None:
        """One breaker state transition -> one journal event. Severity
        tracks the direction: open = the monitor just went blind on a
        source (serious); half-open probe minor; close info."""
        sev = {"open": "serious", "half_open": "minor", "closed": "info"}.get(
            br.state, "minor"
        )
        detail = (
            f" after {br.consecutive_failures} consecutive failures"
            if br.state == "open"
            else ""
        )
        self.journal.record(
            "breaker", sev, name,
            f"breaker {prev} → {br.state}{detail}",
            state=br.state,
            consecutive_failures=br.consecutive_failures or None,
        )

    async def _run(self, c: Collector | None) -> Sample | None:
        if c is None:
            return None
        br = self._breaker_for(c.name)
        prev_breaker = br.state if br is not None else None
        # The collect span brackets exactly what collect_bounded does —
        # the collection attempt plus breaker accounting — tagged with
        # the outcome (ok / error / deadline / skipped) and the breaker
        # state, so a trace answers "which source ate the tick".
        with self.tracer.span(f"collect.{c.name}", cat="collect") as sp:
            if br is not None and not br.allow():
                # Open breaker mid-backoff: skip the poll entirely. The
                # last degraded Sample stays published (its ts shows
                # staleness); the skip is counted so /api/health shows
                # the reduced rate.
                self.stats.setdefault(c.name, SourceStats()).skipped += 1
                sp.tag(outcome="skipped", breaker=br.state)
                return None
            s = await run_collector(
                c, deadline_s=self._deadline_for(c.name), orphans=self._orphans
            )
            if br is not None:
                br.record(s.ok)
            outcome = "ok"
            if not s.ok:
                outcome = (
                    "deadline"
                    if s.error and s.error.startswith(DEADLINE_ERROR)
                    else "error"
                )
            sp.tag(ok=s.ok, outcome=outcome)
            if br is not None:
                sp.tag(breaker=br.state)
        if br is not None and br.state != prev_breaker:
            self._journal_breaker(c.name, prev_breaker, br)
        prev = self.latest.get(s.source)
        self.latest[s.source] = s
        self.stats.setdefault(s.source, SourceStats()).record(s)
        # Dirty-section tracking: bump the section's version only when
        # the published view changed — a k8s poll returning the same
        # pods leaves every /api/k8s consumer on its cached bytes.
        # Failures always bump (rare, and their health must propagate).
        # Collector side-channel extras (accel_jax.last_extras: HLO
        # queue depth, DCN latency percentiles) are served by the same
        # cached routes, so they are part of the fingerprint too.
        extras = getattr(c, "last_extras", None)
        if (
            prev is None
            or not s.ok
            or not prev.ok
            or s.data != prev.data
            or s.error != prev.error
            or s.notes != prev.notes
            or extras != self._prev_extras.get(s.source)
        ):
            self.clock.bump(s.source)
        self._prev_extras[s.source] = dict(extras) if extras else extras
        # Collection activity itself (sample counters, latency stats)
        # is versioned separately so self-metrics stay live even when
        # every data section is static.
        self.clock.bump("samples")
        return s

    def _update_ici_rates(self, chips: list[ChipSample], ts: float) -> None:
        # Prune chips that stopped reporting (dead host) so aggregate ICI
        # traffic drops instead of carrying their last rate forever.
        present = {c.chip_id for c in chips}
        for gone in [cid for cid in self.ici_rates if cid not in present]:
            del self.ici_rates[gone]
        for gone in [cid for cid in self._prev_ici if cid not in present]:
            del self._prev_ici[gone]
        for c in chips:
            if c.ici_tx_bytes is None:
                continue
            prev = self._prev_ici.get(c.chip_id)
            if prev is not None:
                dt_s = ts - prev[0]
                if dt_s > 0:
                    tx = max(0.0, (c.ici_tx_bytes - prev[1]) / dt_s)
                    rx = max(0.0, ((c.ici_rx_bytes or 0) - prev[2]) / dt_s)
                    self.ici_rates[c.chip_id] = {
                        "tx_bps": round(tx, 1),
                        "rx_bps": round(rx, 1),
                    }
            self._prev_ici[c.chip_id] = (ts, c.ici_tx_bytes, c.ici_rx_bytes or 0)

    def _update_net_rates(self, host: dict, ts: float) -> None:
        net = host.get("net") or {}
        rx, tx = net.get("rx_bytes"), net.get("tx_bytes")
        if rx is None or tx is None:
            self.net_rates = {}
            self._prev_net = None
            return
        prev = self._prev_net
        if prev is not None:
            dt_s = ts - prev[0]
            if dt_s > 0:
                self.net_rates = {
                    "rx_bps": max(0.0, (rx - prev[1]) / dt_s),
                    "tx_bps": max(0.0, (tx - prev[2]) / dt_s),
                }
        self._prev_net = (ts, rx, tx)

    def _fleet_handle(self, name: str):
        h = self._fleet_handles.get(name)
        if h is None:
            h = self._fleet_handles[name] = self.history.handle(name)
        return h

    def _record_history(self, ts: float) -> None:
        """Build the tick's history batch — fleet aggregates, serving
        aggregates and per-chip drill-down series — and land it in ONE
        record_batch call (docs/perf.md "ingest spine"): series handles
        are cached across ticks, value quantization and downsample
        accumulation amortize per batch, and the ring's mutation counter
        moves once per tick (the snapshotter's dirty-skip granularity)."""
        if self.history.generation != self._hist_gen:
            # Snapshot restore replaced the series objects: re-resolve.
            self._hist_gen = self.history.generation
            self._perchip_handles.clear()
            self._fleet_handles.clear()
        batch: list = []
        add = batch.append
        handle = self._fleet_handle
        host = self.host_data()
        if host:
            # Resolve handles only for present values: a source that
            # never reports a metric must not grow an empty series
            # (record(None) never created one either).
            for name, v in (
                ("cpu", (host.get("cpu") or {}).get("percent")),
                ("memory", (host.get("memory") or {}).get("percent")),
                ("disk", (host.get("disk") or {}).get("percent")),
            ):
                if v is not None:
                    add((handle(name), v))
            self._update_net_rates(host, ts)
            if self.net_rates:
                add((handle("dcn"), self.net_rates["tx_bps"]))
        chips = self.chips()
        self._fleet_duty = self._fleet_hbm = None
        if chips:
            duty = [c.mxu_duty_pct for c in chips if c.mxu_duty_pct is not None]
            hbm = [c.hbm_pct for c in chips if c.hbm_pct is not None]
            temp = [c.temp_c for c in chips if c.temp_c is not None]
            if duty:
                # Stashed for the anomaly detectors: _anomaly_series
                # reuses this tick's means instead of re-walking chips.
                self._fleet_duty = sum(duty) / len(duty)
                add((handle("mxu"), self._fleet_duty))
            if hbm:
                self._fleet_hbm = sum(hbm) / len(hbm)
                add((handle("hbm"), self._fleet_hbm))
            if temp:
                add((handle("temp"), sum(temp) / len(temp)))
            if self.ici_rates:
                tx_total = sum(r["tx_bps"] for r in self.ici_rates.values())
                add((handle("ici"), tx_total))
            # Worst-of-fleet SDK scores (0-10): a single degrading link /
            # throttling chip must show in the fleet curve, so max, not
            # mean.
            health = [
                c.ici_link_health for c in chips
                if c.ici_link_health is not None
            ]
            if health:
                add((handle("ici_health_max"), max(health)))
            throttle = [
                c.throttle_score for c in chips if c.throttle_score is not None
            ]
            if throttle:
                add((handle("throttle_max"), max(throttle)))
            self._record_per_chip(chips, batch)
        serving = self.serving_data()

        def mean(vals):
            return sum(vals) / len(vals)

        # (target field, history series, cross-target reducer)
        for key, name, agg in (
            ("tokens_per_sec", "tokens_per_sec", sum),
            ("ttft_p50_ms", "ttft_p50_ms", mean),
            # Scheduler pressure (the SLO-soak inputs): waiting
            # requests across targets and the worst per-request decode
            # cadence — a prefill/decode interference regression shows
            # here before it shows in throughput.
            ("queue_depth", "queue_depth", sum),
            ("tpot_p95_ms", "tpot_p95_ms", max),
            ("train_loss", "train_loss", mean),
            ("train_tokens_per_sec", "train_tokens_per_sec", sum),
            ("spec_accept_pct", "spec_accept_pct", mean),
            ("prefix_hit_pct", "prefix_hit_pct", mean),
            ("kv_pages_used_pct", "kv_pool_pct", max),  # tightest pool
        ):
            vals = [s[key] for s in serving if s.get(key) is not None]
            if vals:
                add((handle(name), agg(vals)))
        # Per-tenant serving series (the SLO engine's denominators):
        # serving.<tenant>.{ttft_p95_ms,tpot_p95_ms,goodput_rps,
        # error_rate}, queryable via {tenant="..."} matchers
        # (query.parse_series_name derives the label from the naming
        # contract). Latency worst-of-targets, goodput summed, error
        # rate worst-of-targets — one tenant's regression must not be
        # averaged away by a healthy replica.
        tenant_vals: dict[tuple[str, str], list[float]] = {}
        for s in serving:
            for tenant, row in (s.get("tenants") or {}).items():
                if "." in tenant or not tenant:
                    # A dot would mis-split serving.<tenant>.<metric>
                    # (the traffic simulator validates; a foreign serving
                    # stack may not). Skipping silently would let an
                    # SLO over this tenant never fire — journal it
                    # once per tenant.
                    if tenant not in self._tenant_skipped:
                        self._tenant_skipped.add(tenant)
                        self.journal.record(
                            "slo", "minor", "serving",
                            f"serving tenant label {tenant!r} is not "
                            f"dot-free: its serving.<tenant>.* series "
                            f"cannot be recorded, SLOs over it will "
                            f"never fire",
                            tenant=tenant,
                        )
                    continue
                for key in ("ttft_p95_ms", "tpot_p95_ms",
                            "goodput_rps", "error_rate"):
                    v = row.get(key)
                    if v is not None:
                        tenant_vals.setdefault((tenant, key), []).append(v)
        for (tenant, key), vals in tenant_vals.items():
            agg = sum if key == "goodput_rps" else max
            add((handle(f"serving.{tenant}.{key}"), agg(vals)))
        # Per-replica serving series (mesh serving, docs/perf.md "Mesh
        # serving"): serving.<replica>.* rides the same serving.<label>
        # naming contract as the tenant series (replica ids r0..rN are
        # dot-free by construction), so the SLO engine can hold one dp
        # replica to its own objective. Latency/queue worst-of-targets,
        # free slots summed.
        replica_vals: dict[tuple[str, str], list[float]] = {}
        for s in serving:
            for rep, row in (s.get("replicas") or {}).items():
                if "." in rep or not rep:
                    continue
                for key in ("ttft_p95_ms", "tpot_p95_ms",
                            "queue_depth", "slots_available"):
                    v = row.get(key)
                    if v is not None:
                        replica_vals.setdefault((rep, key), []).append(v)
        for (rep, key), vals in replica_vals.items():
            agg = sum if key == "slots_available" else max
            add((handle(f"serving.{rep}.{key}"), agg(vals)))
        if batch:
            self.history.record_batch(batch, ts=ts)
        self._journal_out_of_order()

    def _journal_out_of_order(self) -> None:
        """One journal event the FIRST time the ring records an
        out-of-order timestamp (restore paths never bump the counter,
        so any nonzero count is live disorder): a backwards clock
        degrades append to the O(series) sorted-insert path, which must
        be an incident, not a silent slowdown. The running count stays
        in /api/health."""
        ooo = self.history.out_of_order
        if ooo and not self._ooo_logged:
            self._ooo_logged = True
            self.journal.record(
                "history", "minor", "history",
                f"out-of-order history timestamps detected ({ooo} so "
                f"far): check the host clock — appends degrade to "
                f"sorted inserts",
                count=ooo,
            )

    def _record_per_chip(self, chips: list[ChipSample], batch: list) -> None:
        """Per-chip drill-down series (chip.<id>.{mxu,hbm,temp,link}),
        bounded: at most ``history_per_chip`` chips get series (first
        seen wins — stable across ticks), the rest are counted so the
        cap is visible in /api/health instead of silently eating data.
        Series names are formatted and resolved once per chip EVER
        (cached handle tuples — not 4 f-strings per chip per tick); the
        values ride the tick's shared record_batch, whose one-kernel-
        call downsample accumulation is what holds this sub-ms at
        v5p-256 (4 × 256 series per tick)."""
        cap = self.cfg.history_per_chip
        if cap <= 0:
            return
        tracked = self._perchip_tracked
        handles = self._perchip_handles
        hist_handle = self.history.handle
        add = batch.append
        for c in chips:
            cid = c.chip_id
            if cid not in tracked:
                if len(tracked) >= cap:
                    self._perchip_skipped.add(cid)
                    continue
                tracked.add(cid)
            entry = handles.get(cid)
            if entry is None:
                entry = handles[cid] = [
                    (
                        f"chip.{cid}.mxu",
                        f"chip.{cid}.hbm",
                        f"chip.{cid}.temp",
                        f"chip.{cid}.link",
                    ),
                    [None, None, None, None],
                ]
            names, hs = entry
            # Handles resolve lazily per metric so a metric the backend
            # never reports never creates an empty series.
            v = c.mxu_duty_pct
            if v is not None:
                h = hs[0]
                if h is None:
                    h = hs[0] = hist_handle(names[0])
                add((h, v))
            v = c.hbm_pct
            if v is not None:
                h = hs[1]
                if h is None:
                    h = hs[1] = hist_handle(names[1])
                add((h, v))
            v = c.temp_c
            if v is not None:
                h = hs[2]
                if h is None:
                    h = hs[2] = hist_handle(names[2])
                add((h, v))
            # SDK health score (x10 so the drill-down shares the
            # 0-100% chart scale: 70 = score 7).
            v = c.ici_link_health
            if v is not None:
                h = hs[3]
                if h is None:
                    h = hs[3] = hist_handle(names[3])
                add((h, v * 10))

    def source_health(self) -> list[dict]:
        """Per-source pipeline health for the ``source-down`` alert rule
        and /api/health consumers: latest ok/error + breaker state."""
        out = []
        for name in ("host", "accel", "k8s", "serving"):
            s = self.latest.get(name)
            st = self.stats.get(name)
            if s is None and st is None:
                continue
            br = self.breakers.get(name)
            out.append(
                {
                    "source": name,
                    "ok": bool(s.ok) if s is not None else False,
                    "error": s.error if s is not None else None,
                    "consecutive_failures": st.consecutive_failures if st else 0,
                    "breaker": br.state if br is not None else "closed",
                }
            )
        return out

    def _evaluate_alerts(self) -> None:
        # Pod rules only run on a healthy scrape: a failed scrape must not
        # wipe transition state (restarts/recoveries during the outage
        # would otherwise go unalerted).
        k8s_sample = self.latest.get("k8s")
        self.engine.evaluate(
            host=self.host_data() or None,
            chips=self.chips(),
            slices=self.slices(),
            pods=self.pods() if (k8s_sample is not None and k8s_sample.ok) else None,
            serving=self.serving_data() or None,
            sources=self.source_health(),
            anomalies=self.anomaly.active() if self.anomaly is not None else None,
            slos=self.slo.alert_rows() if self.slo is not None else None,
        )
        self._notify_new_events()
        # Alerts section fingerprint: timeline position, the active set
        # WITH descs (descs refresh with live values while firing), and
        # the silence table. ``evaluated_at`` deliberately excluded —
        # it advances at cache granularity (docs/perf.md).
        fp = (
            self.engine.timeline_seq,
            tuple(
                sorted(
                    (k, a.get("desc"))
                    for k, a in self.engine._active_keys.items()
                )
            ),
            tuple(sorted(self.engine.silences.items())),
        )
        if fp != self._alerts_fp:
            self._alerts_fp = fp
            self.clock.bump("alerts")

    def mark_alerts_dirty(self) -> None:
        """Force the next /api/alerts render (silence POSTs mutate the
        engine outside the evaluation loop)."""
        self._alerts_fp = None
        self.clock.bump("alerts")

    def mark_events_dirty(self) -> None:
        """Bump the "events" section immediately (journal mutations that
        happen outside the tick loop: silence POSTs, profiler captures)
        so the next /api/events render and SSE frame see them."""
        self._published_events_seq = self.journal.seq
        self.clock.bump("events")

    def _publish_events(self) -> None:
        """Per-tick journal publish: one section bump per tick no matter
        how many events the tick recorded — cache- and delta-friendly,
        and the "events" stage span brackets exactly this cost."""
        if self.journal.seq != self._published_events_seq:
            self.mark_events_dirty()

    def _anomaly_series(self) -> dict[str, float | None]:
        """The EWMA detectors' inputs for this tick: the fleet-mean duty
        and HBM% _record_history just computed (stashed, not re-walked),
        the previous tick's duration, and each source's recent scrape
        p95 (last 64 samples via one C-speed list copy + bounded sort —
        the detector must stay sub-percent of the tick; bench.py's
        ``events`` phase pins it)."""
        series: dict[str, float | None] = {
            "duty": self._fleet_duty,
            "hbm": self._fleet_hbm,
            "tick_ms": self._last_tick_ms,
        }
        for name, st in self.stats.items():
            lat = st.latencies_ms
            if len(lat) >= 8:
                q = quantiles(list(lat)[-64:])
                if q is not None:
                    series[f"scrape_p95.{name}"] = q[1]
        return series

    def mark_events_notified(self) -> None:
        """Treat every event currently on the timeline as delivered —
        called after a state restore so historical events don't re-page."""
        self._notified_seq = self.journal.seq

    def _notify_new_events(self) -> None:
        if self.notifier is None:
            return
        new = self.journal.after(self._notified_seq, kind="alert")
        if not new:
            return
        self._notified_seq = max(e.get("seq", 0) for e in new)
        # Silenced *fires* stay on the timeline but must not page — the
        # engine re-fires them as fresh events if they outlive the
        # silence. Resolutions deliver even under a silence (close the
        # loop for incidents that paged) unless the engine marked the
        # whole incident suppressed (its fire never paged).
        def deliverable(e: dict) -> bool:
            if e.get("state") == "resolved":
                return not e.get("suppressed")
            return not self.engine.is_silenced(e.get("key", ""))

        new = [e for e in new if deliverable(e)]
        if not new:
            return
        try:
            self.notifier.notify(new)
        except RuntimeError:
            pass  # no running loop (sync test context): skip delivery

    async def tick_fast(self) -> None:
        """Host + accel sampling, history recording, alert evaluation.

        Sequential awaits, not asyncio.gather: task creation costs more
        than both collectors combined (~0.45 ms vs ~0.09 ms measured on
        a 1-core host — the dominant term of the exporter samples/sec
        metric), and the host read is far too cheap for overlapping it
        with the accel source to ever pay that back.
        """
        ts = time.time()
        t0 = time.perf_counter()
        tr = self.tracer
        with tr.span("tick_fast", cat="tick"):
            await self._run(self.host)
            t_accel = time.perf_counter()
            await self._run(self.accel)
            hub = self.federation
            if hub is not None and hub.last_ingest_ctx is not None:
                # fed.render: the hub-bearing tick that
                # folded freshly-ingested downstream state into the
                # published view, retrofitted onto the newest ingested
                # frame's trace — the terminal span of that frame's
                # leaf-to-here journey. Consumed once: quiet ticks must
                # not chain renders onto a long-gone frame.
                tid, psid = hub.last_ingest_ctx
                hub.last_ingest_ctx = None
                tr.record(
                    "fed.render",
                    t0=t_accel,
                    dur_ms=(time.perf_counter() - t_accel) * 1e3,
                    trace=tid,
                    parent=psid,
                )
            self._update_ici_rates(self.chips(), ts)
            with tr.span("history"):
                self._record_history(ts)
            # Drift detection BEFORE alert evaluation: an anomaly that
            # fires this tick alerts this tick.
            if self.anomaly is not None:
                with tr.span("anomaly"):
                    self.anomaly.observe(self._anomaly_series(), ts)
            # SLO evaluation after history (this tick's serving series
            # are in the ring) and before alerts (a burn alert that
            # fires this tick pages this tick). The section bumps only
            # when the published budget/burn/alert view moved.
            if self.slo is not None:
                with tr.span("slo"):
                    if self.slo.observe(ts):
                        self.clock.bump("slo")
            # Actuation AFTER the SLO engine (its page-state series is
            # this tick's — a policy keyed on it acts the same tick the
            # page fires) and before alerts/events so every transition
            # it journals publishes this tick.
            if self.actuate is not None:
                with tr.span("actuate"):
                    if self.actuate.observe(ts):
                        self.clock.bump("actuate")
            with tr.span("alerts"):
                self._evaluate_alerts()
            # Journal publish: everything the tick recorded (breaker
            # transitions, anomaly fires, alert timeline) becomes
            # visible to /api/events, the SSE feed and the exporter in
            # one section bump.
            with tr.span("events"):
                self._publish_events()
        self._last_tick_ms = (time.perf_counter() - t0) * 1e3
        # Broadcast tick completion (rotate-then-set: every waiter on
        # the old event wakes; new waiters queue on the fresh one).
        # Outside the tick span: waiters run after the span closed, so
        # the SSE payload they build sees this tick's summary.
        fired, self._tick_fired = self._tick_fired, asyncio.Event()
        fired.set()

    async def tick_pods(self) -> None:
        with self.tracer.span("tick_pods", cat="tick"):
            await self._run(self.k8s)
        self._publish_events()  # breaker events from the slow loop

    async def tick_serving(self) -> None:
        with self.tracer.span("tick_serving", cat="tick"):
            await self._run(self.serving)
        self._publish_events()

    async def tick_all(self) -> None:
        await self.tick_pods()
        await self.tick_serving()
        await self.tick_fast()

    # ----------------------------- lifecycle -------------------------------

    async def _loop(self, fn, interval_s: float, name: str) -> None:
        wd = self.watchdogs.setdefault(
            name, LoopWatchdog(name=name, interval_s=interval_s)
        )
        overrun_logged = False
        while True:
            t0 = time.monotonic()
            err = None
            try:
                await fn()
            except Exception as e:
                # Collectors already degrade; never kill the loop — but
                # a swallowed exception here is a *pipeline* bug (alert
                # evaluation, history recording), so the watchdog counts
                # it instead of the old silent ``pass``.
                err = f"{type(e).__name__}: {e}"
            elapsed = time.monotonic() - t0
            wd.tick(elapsed, err)
            # Lifecycle moments worth a durable record: a swallowed
            # pipeline exception always; tick overrun (past 50% of the
            # interval) only on ENTERING the overrun state — a
            # persistently slow loop is one incident, not an event per
            # tick flooding alert history out of the shared ring (the
            # journal keeps incidents, not noise; mild/ongoing lag is
            # the watchdog counters' job). Recovery re-arms the log.
            if err is not None:
                self.journal.record(
                    "watchdog", "serious", name,
                    f"{name} loop swallowed exception: {err}", error=err,
                )
            elif elapsed > interval_s * 1.5:
                if not overrun_logged:
                    overrun_logged = True
                    self.journal.record(
                        "watchdog", "minor", name,
                        f"{name} tick overran: {elapsed * 1e3:.0f}ms against "
                        f"a {interval_s * 1e3:.0f}ms interval",
                        lag_ms=round((elapsed - interval_s) * 1e3, 1),
                    )
            elif elapsed <= interval_s:
                overrun_logged = False
            await asyncio.sleep(max(0.05, interval_s - elapsed))

    async def start(self) -> None:
        await self.tick_all()  # prime state before serving
        self._tasks = [
            asyncio.create_task(
                self._loop(self.tick_fast, self.cfg.sample_interval_s, "fast")
            ),
        ]
        if self.k8s is not None:
            self._tasks.append(
                asyncio.create_task(
                    self._loop(self.tick_pods, self.cfg.pods_interval_s, "pods")
                )
            )
        if self.serving is not None:
            self._tasks.append(
                asyncio.create_task(
                    self._loop(self.tick_serving, self.cfg.serving_interval_s, "serving")
                )
            )

    async def stop(self) -> None:
        # The uplink stops first: it waits on tick events the stopping
        # loops will never fire again.
        if self.uplink is not None:
            await self.uplink.stop()
        if self.leader is not None:
            await self.leader.stop()
        # Tick loops stop first — a tick firing during notifier.close()
        # would schedule a dispatch task nobody awaits.
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks = []
        if self.notifier is not None:
            await self.notifier.close()
        # Collectors with background resources stop with their owner
        # (the k8s watch mode holds a thread + live HTTP stream; chaos
        # wrappers and the federation merge forward the stop): a
        # stopped sampler must not leave watcher threads holding
        # sockets. Found by tpulint's stoppable-not-stopped pass.
        # Off-loop: a stop may join a thread that is blocked in a
        # network read (PodWatcher.stop's bounded join) — that wait
        # must not freeze the event loop mid-shutdown.
        for c in (self.host, self.accel, self.k8s, self.serving):
            c_stop = getattr(c, "stop", None)
            if c_stop is not None:
                try:
                    await asyncio.to_thread(c_stop)
                except Exception:
                    pass  # shutdown must not die on a wedged collector
