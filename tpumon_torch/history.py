"""History: the in-process ring/TSDB store behind /api/history.

Reference parity (monitor_server.js:117-154 ``getHistoryMetrics``): 30-min
window / 30-s step curves for cpu, memory, disk and accelerator series,
rendered as ``{labels: [HH:mm], data: [...]}`` per series (SURVEY §2.3).

Differences (deliberate, SURVEY §3.3 + §5.8):
- The reference delegated history to an **external Prometheus** (six
  sequential PromQL range queries, empty series on outage,
  monitor_server.js:117-154). That sidecar dependency is retired: the
  sampler records every series into the in-process columnar TSDB each
  tick, /api/history renders directly from it, and rich expressions run
  through the in-tree query engine (tpumon_torch.query, ``/api/query``,
  docs/query.md). ``prometheus_url`` is accepted but deprecated (a
  warning, not a behavior).
- ``gpuTemp`` was collected but never rendered by the reference
  (monitor_server.js:134 vs monitor.html:523-526); here temperature is a
  first-class rendered series.
- Values are numbers, not toFixed(1) strings (SURVEY §2.1 quirk, fixed).
- Storage is the columnar time-series core (tpumon_torch.tsdb): typed-array
  head columns + Gorilla-style compressed chunks in three retention
  tiers (fine / mid / coarse), ~8-20x smaller resident history than
  the tuple-deque rings it replaced — which is what lets the sampler
  keep per-chip series at the 256-chip federation scale (docs/perf.md
  "History engine").
"""

from __future__ import annotations

import asyncio
import bisect
import contextlib
import fnmatch
import json
import os
import sys
import tempfile
import time
from array import array

from tpumon_torch import tsdb

# The fleet series contract /api/history serves (SURVEY §5.8 re-keying).
# Keys are the ring series the sampler records each tick; values are the
# *equivalent PromQL* over tpumon's own /metrics exporter — kept as
# documentation for deployments that also scrape us with an external
# Prometheus, and as the provenance of each series' aggregation choice.
# In-process, these names evaluate directly (tpumon_torch.query:
# ``avg_over_time(mxu[5m])``, ``topk(5, rate(chip.hbm))``, ...).
PROM_QUERIES: dict[str, str] = {
    "cpu": "avg(tpumon_host_cpu_pct)",
    "memory": "avg(tpumon_host_memory_pct)",
    "disk": "avg(tpumon_host_disk_pct)",
    "mxu": "avg(tpu_mxu_duty_cycle_pct)",
    "hbm": "avg(tpu_hbm_used_pct)",
    "temp": "avg(tpu_temp_celsius)",
    "ici": "sum(rate(tpu_ici_tx_bytes_total[1m]))",
    # Cross-host DCN traffic proxy: NIC tx rate summed over hosts.
    "dcn": "sum(rate(tpumon_host_net_tx_bytes_total[1m]))",
    # Worst-of-fleet libtpu SDK scores (0-10): max so one degrading
    # link / throttling chip shows in the fleet curve.
    "ici_health_max": "max(tpu_ici_link_health_score)",
    "throttle_max": "max(tpu_throttle_score)",
    "tokens_per_sec": "sum(tpumon_serving_tokens_per_sec)",
    "ttft_p50_ms": "avg(tpumon_serving_ttft_p50_ms)",
    # Scheduler pressure (docs/perf.md "Continuous-batching scheduler"):
    # waiting requests across targets, and the worst per-request decode
    # cadence — the SLO-soak inputs for the serving alert layer.
    "queue_depth": "sum(jetstream_queue_size)",
    "tpot_p95_ms": "max(tpumon_serving_tpot_p95_ms)",
    # The `> 0` clause drops idle samples instead of producing 0/0
    # NaN points (which would serialize as invalid JSON).
    "spec_accept_pct": (
        "100 * sum(rate(tpumon_serving_spec_accepted[5m])) "
        "/ (sum(rate(tpumon_serving_spec_proposed[5m])) > 0)"
    ),
    "kv_pool_pct": (
        "max(100 * (tpumon_serving_kv_pages_total "
        "- tpumon_serving_kv_pages_free) / tpumon_serving_kv_pages_total)"
    ),
    "prefix_hit_pct": (
        "100 * sum(rate(tpumon_serving_prefix_hits[5m])) "
        "/ ((sum(rate(tpumon_serving_prefix_hits[5m])) "
        "+ sum(rate(tpumon_serving_prefix_misses[5m]))) > 0)"
    ),
    # Direct trainer series preferred; tpumon's re-export (distinct name,
    # tpumon_torch/exporter.py) is the fallback when Prometheus only scrapes us.
    # Limitation: PromQL `or` is all-or-nothing — in a mixed deployment
    # where Prometheus reaches some trainers directly and others only via
    # the re-export, the left side wins and re-export-only trainers drop
    # out of the aggregate. Scrape uniformly (all direct or all via
    # tpumon) for exact aggregates.
    "train_loss": "avg(tpumon_train_loss) or avg(tpumon_monitor_train_loss)",
    "train_tokens_per_sec": (
        "sum(rate(tpumon_train_tokens_total[1m])) or "
        "sum(rate(tpumon_monitor_train_tokens_total[1m]))"
    ),
}


def format_hhmm(ts: float) -> str:
    return time.strftime("%H:%M", time.localtime(ts))


def format_label(ts: float, window_s: float) -> str:
    """HH:MM for intraday windows; month-day prefix once a window is long
    enough that the same wall-clock time appears twice."""
    if window_s > 12 * 3600:
        return time.strftime("%m-%d %H:%M", time.localtime(ts))
    return format_hhmm(ts)


class RingSeries:
    """One bounded time series over the columnar core (tpumon_torch.tsdb):
    a fine tier of raw ms-quantized points in typed-array columns +
    compressed sealed chunks, an optional mid tier of ``mid_step_s``
    bucket means, and an optional coarse tier of ``coarse_step_s``
    bucket means retained for ``long_window_s`` — long-range charts
    without keeping every 1 s sample for a day, at ~2-12 resident
    bytes/point instead of the old tuple-deque's ~120.

    ``points`` and ``coarse`` keep their deque-shaped API (len/iter/
    index/extend) as views over the tiers; ``version`` bumps on every
    mutation and keys the render memo (RingHistory.snapshot_series).
    """

    __slots__ = (
        "window_s", "long_window_s", "coarse_step_s", "fine", "down",
        "_mid", "_coarse", "version", "slot", "rec",
    )

    def __init__(
        self,
        window_s: float,
        long_window_s: float = 0.0,  # <= window_s => fine tier only
        coarse_step_s: float = 60.0,
        mid_step_s: float = 0.0,  # 0 => no mid tier
        mid_window_s: float = 0.0,
        slot_stores: tuple | None = None,  # (slot, mid store, coarse store)
    ):
        self.window_s = window_s
        self.long_window_s = long_window_s
        self.coarse_step_s = coarse_step_s
        self.fine = tsdb.Tier(window_s)
        self.down: list[tsdb.Downsample] = []  # finest -> coarsest
        # Ring-owned series are slot-backed: their downsample
        # accumulators live in the ring's contiguous AccumStore columns
        # so RingHistory.record_batch updates every series' buckets in
        # one kernel call per tick. Standalone series (slot is None)
        # keep plain object-held accumulators.
        self.slot = slot_stores[0] if slot_stores else None
        mid_store = slot_stores[1] if slot_stores else None
        coarse_store = slot_stores[2] if slot_stores else None
        self._mid = None
        if mid_step_s > 0 and mid_window_s > window_s:
            self._mid = (
                tsdb.SlotDownsample(mid_store, self.slot, mid_window_s)
                if mid_store is not None
                else tsdb.Downsample(mid_step_s, mid_window_s)
            )
            self.down.append(self._mid)
        # The coarse tier exists even when disabled for accumulation
        # (long_window_s <= window_s): restore paths may extend it
        # directly, and merged_points must then still serve it.
        coarse_window = max(long_window_s, window_s)
        self._coarse = (
            tsdb.SlotDownsample(coarse_store, self.slot, coarse_window)
            if coarse_store is not None
            else tsdb.Downsample(coarse_step_s, coarse_window)
        )
        self.down.append(self._coarse)
        self.version = 0
        # Recording-rule accumulators (tpumon_torch.query.RuleAccum) for the
        # registered rules whose family matches this series' name —
        # None when no rule matches, so the per-append guard is one
        # attribute load on the unmatched (common) path.
        self.rec = None

    def __repr__(self) -> str:
        return (
            f"RingSeries(window_s={self.window_s}, "
            f"long_window_s={self.long_window_s}, points={len(self.fine)})"
        )

    @property
    def points(self) -> tsdb.PointsView:
        return tsdb.PointsView(self.fine, on_write=self._bump)

    @property
    def coarse(self) -> tsdb.PointsView:
        return tsdb.PointsView(self._coarse.tier, on_write=self._bump)

    def _bump(self) -> None:
        self.version += 1

    def add(self, ts: float, value: float) -> None:
        ts = tsdb.quantize_ts(ts)
        value = tsdb.quantize_val(value)
        self.fine.append(ts, value)
        if self._mid is not None:
            self._mid.observe(ts, value)
        if self.long_window_s > self.window_s:
            self._coarse.observe(ts, value)
        if self.rec is not None:
            for a in self.rec:
                a.observe(ts, value)
        self.version += 1

    def add_batch(self, ts_list, values) -> bool:
        """Append N (ts, value) pairs in one call: one quantize pass,
        slice-extend into the head columns, downsample accumulation per
        batch — the per-point interpreter work of add() amortizes to
        near zero (native kernel) or a few C-array ops (fallback).
        Returns True on the batch path; False when the batch was out of
        order and fell back to per-point sorted inserts (same end state,
        O(tier) cost — callers count it)."""
        n = len(ts_list)
        if not n:
            return True
        ts_q, val_q, ordered = tsdb.quantize_batch(
            ts_list, values, self.fine.last_ts()
        )
        if not ordered:
            for t, v in zip(ts_list, values):
                self.add(t, float(v))
            return False
        self.fine.append_batch(ts_q, val_q)
        if self._mid is not None:
            self._mid.observe_batch(ts_q, val_q)
        if self.long_window_s > self.window_s:
            self._coarse.observe_batch(ts_q, val_q)
        if self.rec is not None:
            # val_q is the array('f') column: values observed by the
            # rule accumulators are exactly the stored (f32) values.
            for a in self.rec:
                obs = a.observe
                for i in range(n):
                    obs(ts_q[i], val_q[i])
        self.version += 1
        return True

    def _fine_since(self, start: float) -> list[tuple[float, float]]:
        """Fine points with ts >= start — O(log chunks + matched):
        bisect over the sealed-chunk time index, decode only the
        overlap (tsdb.Tier.since)."""
        return self.fine.since(start)

    def merged_points(self, window_s: float, end: float) -> list[tuple[float, float]]:
        """Points covering [end - window_s, end]: downsampled tiers for
        the span older than the fine tier, fine points (raw) for the
        recent span (tsdb.merged)."""
        return tsdb.merged(self.fine, self.down, window_s, end)

    def last_ts(self) -> float | None:
        candidates = [self.fine.last_ts()] + [d.tier.last_ts() for d in self.down]
        ts = [c for c in candidates if c is not None]
        return max(ts) if ts else None

    def resident_bytes(self) -> int:
        return self.fine.resident_bytes() + sum(
            d.tier.resident_bytes() for d in self.down
        )

    def count_points(self) -> int:
        return self.fine.approx_len() + sum(
            d.tier.approx_len() for d in self.down
        )

    def resample(
        self,
        step_s: float,
        end: float | None = None,
        window_s: float | None = None,
    ) -> tuple[list[float], list[float]]:
        """Downsample to a fixed step grid (last-value-wins per bucket)."""
        window_s = window_s if window_s is not None else self.window_s
        if end is None:
            end = self.last_ts()
            if end is None:
                return [], []
        pts = (
            self.merged_points(window_s, end)
            if window_s > self.window_s
            else self._fine_since(end - window_s)
        )
        if not pts:
            return [], []
        start = max(pts[0][0], end - window_s)
        times = [t for t, _ in pts]
        grid: list[float] = []
        vals: list[float] = []
        t = start
        while t <= end + 1e-9:
            i = bisect.bisect_right(times, t) - 1
            if i >= 0:
                grid.append(t)
                vals.append(pts[i][1])
            t += step_s
        # The grid is start-anchored; when end isn't a whole step away it
        # would miss the newest sample — a monitor must show the freshest
        # value, so close the grid at end.
        if grid and end - grid[-1] > 1e-9:
            grid.append(end)
            vals.append(pts[-1][1])
        return grid, vals


class RingHistory:
    """Named ring-buffer series, fed by the sampler each tick.

    ``mutations`` counts every write — the history snapshotter's dirty
    check (an idle cadence skips the disk write entirely), and the
    per-series ``version`` keys a bounded resample memo so an epoch
    render-cache miss on one window does not re-walk series that did
    not move (tpumon_torch.server serves multiple clamped windows per tick).
    """

    _MEMO_CAP = 4096  # (name, step, window) keys; cleared when full

    def __init__(
        self,
        window_s: float = 1800,
        long_window_s: float = 24 * 3600,
        coarse_step_s: float = 60.0,
        mid_step_s: float = 30.0,
        mid_window_s: float = 6 * 3600,
    ):
        self.window_s = window_s
        self.long_window_s = max(long_window_s, window_s)
        self.coarse_step_s = coarse_step_s
        self.mid_step_s = mid_step_s
        # The mid tier never outlives the coarse one.
        self.mid_window_s = min(mid_window_s, self.long_window_s)
        self.series: dict[str, RingSeries] = {}
        self.mutations = 0
        # Live-path out-of-order appends (a backwards clock): counted
        # here (surfaced in /api/health history stats + a one-shot
        # journal event via the sampler) — restore paths replay ordered
        # dumps and never bump this.
        self.out_of_order = 0
        # Bumped whenever series OBJECTS are replaced (snapshot restore)
        # so callers holding resolved series handles (the sampler's
        # per-chip cache) know to re-resolve.
        self.generation = 0
        # Slot-backed downsample accumulator columns shared by every
        # ring-owned series: RingHistory.record_batch updates all open
        # buckets in one accum_many call per tick (tpumon_torch.tsdb).
        self._mid_enabled = mid_step_s > 0 and self.mid_window_s > window_s
        self._mid_store = (
            tsdb.AccumStore(mid_step_s) if self._mid_enabled else None
        )
        self._coarse_store = tsdb.AccumStore(coarse_step_s)
        self._slot_series: list[RingSeries] = []
        self._memo: dict[tuple, tuple[int, dict]] = {}
        # Registered recording rules (tpumon_torch.query.RuleSet): append-time
        # aggregate accumulators attached per matching series. None =
        # no rules, zero per-append cost.
        self.rules = None

    def set_recording_rules(self, ruleset) -> None:
        """Register recording rules (tpumon_torch.query.RuleSet) and attach
        accumulators to every existing matching series. Accumulation
        starts NOW — history is not backfilled (the same contract as
        Prometheus recording rules)."""
        self.rules = ruleset
        for name, s in self.series.items():
            s.rec = (
                ruleset.attach(name, ring_slot=s.slot)
                if ruleset is not None
                else None
            )

    def _make_series(self, name: str) -> RingSeries:
        if self._mid_store is not None:
            slot = self._mid_store.add_slot()
            assert self._coarse_store.add_slot() == slot
        else:
            slot = self._coarse_store.add_slot()
        s = RingSeries(
            window_s=self.window_s,
            long_window_s=self.long_window_s,
            coarse_step_s=self.coarse_step_s,
            mid_step_s=self.mid_step_s,
            mid_window_s=self.mid_window_s,
            slot_stores=(slot, self._mid_store, self._coarse_store),
        )
        if self.rules is not None:
            s.rec = self.rules.attach(name, ring_slot=s.slot)
        self._slot_series.append(s)
        return s

    def handle(self, name: str) -> RingSeries:
        """Resolve (creating if absent) a series once; callers on the
        per-tick hot path keep the handle and pass it to record_batch
        instead of paying a dict lookup per series per tick. Handles go
        stale when ``generation`` moves (snapshot restore replaced the
        series objects) — re-resolve then."""
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = self._make_series(name)
        return s

    def record(self, name: str, value: float | None, ts: float | None = None) -> None:
        """Record one point — the thin per-point shim over the batch
        machinery (same quantization, same ordering fallback), kept for
        callers without a batch to amortize."""
        if value is None:
            return
        ts = time.time() if ts is None else ts
        s = self.handle(name)
        lt = s.fine.last_ts()
        if lt is not None and tsdb.quantize_ts(ts) < lt:
            self.out_of_order += 1
        s.add(ts, float(value))
        self.mutations += 1

    def record_batch(self, points, ts: float | None = None) -> None:
        """Record one point for MANY series at a shared timestamp — the
        sampler's per-tick shape (fleet aggregates + 4 series × every
        tracked chip). ``points`` holds (name-or-handle, value) pairs;
        None values are skipped (same contract as record()).

        The hot loop touches each series only for its two head-column
        appends and a seal check; value quantization is one vectorized
        pass, downsample bucket accumulation is one accum_many call per
        tier level (native kernel when built), and eviction is paced
        (Tier.maybe_evict) instead of per point. ``mutations`` bumps
        ONCE per batch — the snapshotter's dirty-skip sees "a tick
        happened", not one bump per series — while each touched series'
        ``version`` still bumps so the per-series resample memo stays
        correct."""
        ts = time.time() if ts is None else ts
        tsq = tsdb.quantize_ts(ts)
        get = self.series.get
        fast: list[RingSeries] = []
        vals: list[float] = []
        slow: list[tuple[RingSeries, float]] = []
        fast_append = fast.append
        vals_append = vals.append
        touched = False
        # Single pass: the head-column appends happen inline (array('f')
        # applies the f32 quantization itself, identically to
        # quantize_val), values are collected raw for the one vectorized
        # accum_many pass below. ~10 bytecodes of per-series work — the
        # rest of the per-point cost lives in C.
        for name, v in points:
            if v is None:
                continue
            if type(name) is str:
                # get() first: the hot path is an existing series, and
                # handle() is only needed to create missing ones.
                s = get(name)
                if s is None:
                    s = self.handle(name)
            else:
                s = name
            f = s.fine
            lt = f._last_ts
            if (lt is None or tsq >= lt) and s.slot is not None:
                f._last_ts = tsq
                f.head_ts.append(tsq)
                f.head_val.append(v)
                if len(f.head_ts) >= f.seal_points:
                    f.seal()
                    f.evict(tsq)
                else:
                    due = f._evict_due
                    if due is None or tsq >= due:
                        f.evict(tsq)
                        f._evict_due = tsq + f.window_s * 0.0625
                s.version += 1
                fast_append(s)
                vals_append(v)
                continue
            if lt is not None and tsq < lt:
                self.out_of_order += 1
            slow.append((s, float(v)))
        if fast:
            self._accum_many(tsq, array("f", vals), fast)
            touched = True
        for s, v in slow:
            s.add(ts, v)
            touched = True
        if touched:
            self.mutations += 1

    def _accum_many(self, tsq: float, val_q, series_list) -> None:
        """Per-batch downsample + recording-rule accumulation for
        slot-backed series: one accum_many call per tier level over the
        shared state columns (closed buckets appended through each
        series' own downsample tier, f32-quantized exactly like
        Downsample.flush), then one rule-store call per registered
        recording rule over the SAME slots/values arrays — matched
        series update their open sub-bucket summaries in the kernel,
        unmatched series cost a slot_map lookup (tpumon_torch.query)."""
        levels: list[tuple[tsdb.AccumStore, str]] = []
        if self._mid_store is not None:
            levels.append((self._mid_store, "_mid"))
        if self.long_window_s > self.window_s:
            levels.append((self._coarse_store, "_coarse"))
        if not levels and self.rules is None:
            return
        slots = array("i", [s.slot for s in series_list])
        by_slot = self._slot_series
        for store, attr in levels:
            for slot, fts, fmean in tsdb.accum_many(tsq, val_q, slots, store):
                d = getattr(by_slot[slot], attr)
                d.tier.append(fts, tsdb.quantize_val(fmean))
        if self.rules is not None:
            self.rules.accum_batch(tsq, val_q, slots)

    def record_series(self, name: str, ts_list, values) -> None:
        """Record N (ts, value) pairs into ONE series in a single call
        (RingSeries.add_batch): the bulk shape — replaying a restore,
        ingesting a peer's backlog, the bench's ingest phase."""
        s = self.handle(name)
        if not s.add_batch(ts_list, values):
            self.out_of_order += 1
        self.mutations += 1

    def resident_bytes(self) -> int:
        return sum(s.resident_bytes() for s in self.series.values())

    def count_points(self) -> int:
        return sum(s.count_points() for s in self.series.values())

    def restore_coarse(self, name: str, points: list[tuple[float, float]]) -> None:
        """Seed a series' coarse tier from a state snapshot (tpumon_torch.state).
        Caller guarantees points are time-ordered and predate any fine
        points subsequently replayed through record()."""
        if not points:
            return
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = self._make_series(name)
        s.coarse.extend((float(t), float(v)) for t, v in points)
        self.mutations += 1

    # --------------- crash-safe persistence (dump/load) ----------------

    def dump_points(self) -> dict[str, list[list[float]]]:
        """Fine-tier raw points per series, JSON-shaped. Decodes via
        Tier.dump (cache-bypassing): the state checkpoint walks every
        series every save and must not pin decoded chunks resident."""
        return {
            name: [[round(t, 3), v] for t, v in s.fine.dump()]
            for name, s in self.series.items()
        }

    def dump_coarse(self) -> dict[str, list[list[float]]]:
        """Coarse-tier (bucket-mean) points per series, JSON-shaped.
        Series with no coarse data are omitted."""
        out = {}
        for name, s in self.series.items():
            pts = s._coarse.tier.dump()
            if pts:
                out[name] = [[round(t, 3), v] for t, v in pts]
        return out

    def load_points(
        self,
        points: dict,
        coarse: dict | None = None,
        now: float | None = None,
    ) -> None:
        """Restore dumped fine + coarse tiers into this (assumed-fresh)
        ring. Raises TypeError/ValueError/AttributeError on malformed
        input — callers decide whether a bad snapshot is fatal.

        Window cutoffs are applied against ``now``; replaying fine
        points through record() re-derives every coarse bucket the fine
        points touch — including a *partial* re-derivation of the bucket
        the oldest fine point lands mid-way in — so restored coarse
        entries stop at that bucket's START boundary, or the seam bucket
        would appear twice with the partial mean shadowing the correct
        full-bucket mean.
        """
        now = time.time() if now is None else now
        cutoff = now - self.window_s
        # Per-series (ts, value) columns: the replay below feeds each
        # series through the batch ingest path in one call instead of a
        # record() per point — dump files are time-ordered per series,
        # so the ordered fast path applies (and a disordered file still
        # restores via add_batch's per-point fallback).
        fine: dict[str, tuple[list[float], list[float]]] = {}
        for name, pts in points.items():
            ts_col, val_col = fine.setdefault(str(name), ([], []))
            for t, v in pts:
                t = float(t)
                if t >= cutoff:
                    ts_col.append(t)
                    val_col.append(float(v))
        long_cutoff = now - self.long_window_s
        coarse_ok = {
            str(name): [
                (float(t), float(v)) for t, v in pts if float(t) >= long_cutoff
            ]
            for name, pts in (coarse or {}).items()
        }
        step = self.coarse_step_s
        oldest_fine = {
            name: min(ts_col) for name, (ts_col, _) in fine.items() if ts_col
        }
        for name, pts in coarse_ok.items():
            bound = oldest_fine.get(name)
            bucket_start = None if bound is None else (bound // step) * step
            self.restore_coarse(
                name,
                [p for p in pts if bucket_start is None or p[0] < bucket_start],
            )
        for name, (ts_col, val_col) in fine.items():
            if not ts_col:
                continue
            self.handle(name).add_batch(ts_col, val_col)
            self.mutations += 1
        self.generation += 1

    def snapshot_series(
        self, name: str, step_s: float, window_s: float | None = None
    ) -> dict:
        s = self.series.get(name)
        if s is None:
            return {"labels": [], "data": []}
        window = window_s if window_s is not None else self.window_s
        # Resample memo keyed on the series' own version: a request
        # that misses the epoch render cache (new window, or another
        # section ticked) re-renders ONLY the series that moved since
        # their last resample at this (step, window). Callers treat the
        # payload as immutable (it goes straight to json.dumps).
        key = (name, step_s, window)
        hit = self._memo.get(key)
        if hit is not None and hit[0] == s.version:
            return hit[1]
        grid, vals = s.resample(step_s, window_s=window)
        out = {
            "labels": [format_label(t, window) for t in grid],
            "data": [round(v, 2) for v in vals],
        }
        if len(self._memo) >= self._MEMO_CAP:
            self._memo.clear()
        self._memo[key] = (s.version, out)
        return out


def atomic_write_text(path: str, text: str) -> None:
    """tmp-in-same-dir + fsync + rename: a crash mid-write leaves the
    previous file intact. Raises OSError on failure. Shared by the
    JSON state snapshots here/tpumon_torch.state and the JSONL event journal
    (tpumon_torch.events.EventLog)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".tpumon-hist.", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_json(path: str, obj: dict) -> None:
    """Atomic JSON dump (see atomic_write_text)."""
    atomic_write_text(path, json.dumps(obj, separators=(",", ":")))


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Atomic binary write (see atomic_write_text) — the v2 history
    snapshot format (tpumon_torch.tsdb.dump_snapshot) rides this."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".tpumon-hist.", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


HISTORY_SNAPSHOT_VERSION = 1  # the legacy full-JSON format (read-only path)


class HistorySnapshotter:
    """Crash-safe ring history: periodic atomic snapshot of all tiers
    to disk, restore-on-start — a monitor restart no longer erases the
    cluster's recent past even without Prometheus or a full state_path
    checkpoint (tpumon_torch.state covers alerts + pods; this is the
    history-only, always-cheap subset).

    The default on-disk format is the v2 binary one
    (tpumon_torch.tsdb.dump_snapshot): magic + version header, sealed chunks
    written verbatim — ~10x cheaper to write and restore than the v1
    full-JSON dump, which remains readable (``restore`` sniffs the
    magic) so pre-existing snapshot files warm-start the new store.
    A mutation ("dirty") check skips the periodic write entirely when
    nothing was recorded since the last save; skips are counted and
    surfaced in /api/health.
    """

    def __init__(
        self,
        ring: RingHistory,
        path: str,
        interval_s: float = 30.0,
        journal=None,
        fmt: str = "binary",
    ):
        if fmt not in ("binary", "json"):
            raise ValueError(f"unknown history snapshot format {fmt!r}")
        self.ring = ring
        self.path = path
        self.interval_s = interval_s
        self.format = fmt
        # Optional event journal (tpumon_torch.events): restore success and
        # save-failure transitions are lifecycle moments worth keeping.
        self.journal = journal
        self.last_save_ts: float | None = None
        self.last_error: str | None = None
        self.saves = 0
        self.skipped_unchanged = 0
        self._saved_mutations: int | None = None
        self._task: asyncio.Task | None = None

    def save(self) -> bool:
        """Snapshot + write in one call, unconditionally. Only safe
        where nothing is concurrently mutating the ring (tests,
        shutdown after loops stopped); the live periodic path is
        save_async()."""
        return self._write(*self._snapshot())

    async def save_async(self) -> bool:
        """Snapshot on the event loop — the ring is only mutated there,
        so this never races a tick — then write the frozen blob in a
        worker thread. An unchanged ring (no record() since the last
        save) skips the write: idle clusters stop rewriting the same
        bytes every cadence."""
        if self._saved_mutations == self.ring.mutations:
            self.skipped_unchanged += 1
            return True
        blob, saved_at, mutations = self._snapshot()
        ok = await asyncio.to_thread(self._write, blob, saved_at, mutations)
        return ok

    def _snapshot(self) -> tuple[bytes | dict, float, int]:
        saved_at = time.time()
        mutations = self.ring.mutations
        if self.format == "binary":
            return tsdb.dump_snapshot(self.ring.series, saved_at), saved_at, mutations
        return (
            {
                "version": HISTORY_SNAPSHOT_VERSION,
                "saved_at": saved_at,
                "points": self.ring.dump_points(),
                "coarse": self.ring.dump_coarse(),
            },
            saved_at,
            mutations,
        )

    def _write(self, state: bytes | dict, saved_at: float, mutations: int) -> bool:
        try:
            if isinstance(state, bytes):
                atomic_write_bytes(self.path, state)
            else:
                atomic_write_json(self.path, state)
        except OSError as e:
            # Journal only the TRANSITION into failure — a full disk
            # must not generate one event per 30 s cadence forever.
            if self.journal is not None and self.last_error is None:
                self.journal.record(
                    "history", "serious", "history",
                    f"history snapshot write failing: {e}", path=self.path,
                )
            self.last_error = str(e)
            return False
        self.last_save_ts = saved_at
        self.last_error = None
        self.saves += 1
        self._saved_mutations = mutations
        return True

    def _refuse(self, why: str) -> bool:
        """A snapshot file that exists but cannot be used: record why
        (journal + last_error) and start fresh — never crash the
        server over a torn restore file."""
        self.last_error = why
        if self.journal is not None:
            self.journal.record(
                "history", "serious", "history",
                f"history snapshot refused: {why}", path=self.path,
            )
        return False

    def restore(self) -> bool:
        """Best-effort warm start; False (restoring nothing) on a
        missing, corrupt, wrong-version or stale snapshot. Binary (v2)
        and legacy JSON (v1) files are both readable; the ring is only
        mutated after the whole file parsed clean."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError as e:
            self.last_error = str(e)
            return False
        if raw[: len(tsdb.MAGIC)] == tsdb.MAGIC:
            return self._restore_binary(raw)
        return self._restore_json(raw)

    def _stale(self, saved_at: float, now: float) -> bool:
        # A snapshot older than the ring's long window holds nothing
        # servable — the cutoff tracks the configured window, not a
        # fixed day, so a 72 h ring keeps a 30 h-old snapshot.
        return now - saved_at > self.ring.long_window_s

    def _restore_binary(self, raw: bytes) -> bool:
        now = time.time()
        try:
            saved_at, dumps = tsdb.load_snapshot(raw)
        except ValueError as e:
            return self._refuse(f"corrupt binary snapshot: {e}")
        if self._stale(saved_at, now):
            return False
        ring = self.ring
        replay_fine: dict[str, list] = {}
        replay_coarse: dict[str, list] = {}
        for d in dumps:
            s = ring._make_series(d["name"])
            if self._adoptable(s, d):
                self._adopt(s, d, now)
                if s.count_points() or any(x.bn for x in s.down):
                    ring.series[d["name"]] = s
            else:
                # Tier geometry changed since the file was written
                # (config edit): decode and replay instead of adopting.
                replay_fine[d["name"]] = tsdb.tier_points(d["fine"])
                if d["down"]:
                    replay_coarse[d["name"]] = tsdb.tier_points(
                        d["down"][-1]["tier"]
                    )
        if replay_fine or replay_coarse:
            ring.load_points(replay_fine, replay_coarse, now=now)
        ring.mutations += 1
        # Series objects were replaced wholesale: handles cached by the
        # sampler's batch path must re-resolve.
        ring.generation += 1
        ring._memo.clear()
        if self.journal is not None:
            self.journal.record(
                "history", "info", "history",
                f"restored {len(dumps)} history series from {self.path}",
                path=self.path,
            )
        return True

    @staticmethod
    def _adoptable(s: RingSeries, d: dict) -> bool:
        if s.fine.window_s != d["fine"]["window_s"]:
            return False
        if len(s.down) != len(d["down"]):
            return False
        return all(
            ds.step_s == dd["step_s"] and ds.tier.window_s == dd["tier"]["window_s"]
            for ds, dd in zip(s.down, d["down"])
        )

    @staticmethod
    def _adopt(s: RingSeries, d: dict, now: float) -> None:
        """Move a parsed tier dump into a fresh series verbatim (chunks
        stay compressed), then apply retention against ``now``."""

        def fill(tier: tsdb.Tier, td: dict) -> None:
            tier.chunks = td["chunks"]
            tier.head_ts = td["head_ts"]
            tier.head_val = td["head_val"]
            tier.sync_last()
            tier.evict(now)

        fill(s.fine, d["fine"])
        for ds, dd in zip(s.down, d["down"]):
            fill(ds.tier, dd["tier"])
            ds.bucket = dd["bucket"]
            ds.bsum = dd["bsum"]
            ds.bn = dd["bn"]
        s.version += 1

    def _restore_json(self, raw: bytes) -> bool:
        try:
            state = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            self.last_error = str(e)
            return False
        if not isinstance(state, dict) or state.get("version") != HISTORY_SNAPSHOT_VERSION:
            return False
        saved_at = state.get("saved_at")
        now = time.time()
        if not isinstance(saved_at, (int, float)) or self._stale(saved_at, now):
            return False
        try:
            self.ring.load_points(
                state.get("points") or {}, state.get("coarse") or {}, now=now
            )
        except (AttributeError, KeyError, TypeError, ValueError) as e:
            self.last_error = f"malformed snapshot: {e}"
            return False
        if self.journal is not None:
            self.journal.record(
                "history", "info", "history",
                f"restored {len(state.get('points') or {})} history series "
                f"from {self.path}",
                path=self.path,
            )
        return True

    def to_json(self) -> dict:
        return {
            "path": self.path,
            "format": self.format,
            "interval_s": self.interval_s,
            "last_save_ts": self.last_save_ts,
            "last_error": self.last_error,
            "saves": self.saves,
            "skipped_unchanged": self.skipped_unchanged,
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


class HistoryService:
    """Serves the /api/history contract from the in-process ring/TSDB.

    The external-Prometheus path is retired (the paper's fourth
    collector, monitor_server.js:117-154): the sampler records every
    contract series each tick, so history is always local — and rich
    expressions over the same store go through the in-tree query
    engine (tpumon_torch.query, ``/api/query``). ``prometheus_url`` is kept
    as an accepted-but-deprecated knob so existing configs load."""

    def __init__(
        self,
        ring: RingHistory,
        prometheus_url: str | None = None,
        window_s: float = 1800,
        step_s: float = 30,
    ):
        self.ring = ring
        self.window_s = window_s
        self.step_s = step_s
        # Retired dependency: warn once, then behave exactly like an
        # unconfigured instance (the ring serves this contract;
        # there is no Prometheus collector).
        self.prometheus_deprecated = bool(prometheus_url)
        if prometheus_url:
            print(
                "tpumon: prometheus_url is deprecated and ignored — "
                "/api/history serves the in-process TSDB and rich "
                "queries run in-tree via /api/query (docs/query.md)",
                file=sys.stderr,
                flush=True,
            )

    def clamp_window(self, window_s: float) -> float:
        return min(max(window_s, 60.0), self.ring.long_window_s)

    def step_for(self, window_s: float) -> float:
        """Step targeting ~60 rendered points, never finer than the
        configured base step (the reference's 30 s)."""
        if window_s <= self.window_s:
            return self.step_s
        return max(self.step_s, round(window_s / 60.0))

    @staticmethod
    def _matches(name: str, series: str | None) -> bool:
        """``?series=`` glob filter (fnmatch: * ? [..]); None => all.
        Matched against the full internal series name — fleet series
        ("cpu", "mxu") and per-chip ("chip.<id>.<metric>") alike, so
        ``series=chip.*`` selects the drill-down curves only."""
        return series is None or fnmatch.fnmatchcase(name, series)

    def snapshot_ring(
        self, window_s: float | None = None, series: str | None = None
    ) -> dict:
        """Ring-only /api/history payload, synchronously — the fast
        path the server's epoch render cache serves when no Prometheus
        is configured (the payload is then a pure function of the ring,
        so repeated same-tick requests reuse the serialized bytes).
        ``series`` (a glob) restricts to matching series — the per-chip
        drill-down fetch at 256 chips asks for ``chip.<id>.*`` instead
        of the whole fleet payload."""
        window = self.clamp_window(window_s) if window_s else self.window_s
        step = self.step_for(window)
        out: dict = {"source": "ring", "window_s": window, "step_s": step}
        if series is not None:
            out["series"] = series
        for name in PROM_QUERIES:
            if self._matches(name, series):
                out[name] = self.ring.snapshot_series(name, step, window_s=window)
        # Ring-only per-chip series (chip.<id>.<field>) for the per-chip
        # drill-down charts, and per-slice rollup series
        # (slice.<id>.<stat>) landed by the federation hub at ingest
        # (tpumon_torch.federation — an aggregator's or root's group-by-slice
        # curves); Prometheus equivalents are labelled series the
        # client can also get via its own PromQL if deployed.
        self._add_prefixed(out, "per_chip", "chip.", step, window, series)
        self._add_prefixed(out, "per_slice", "slice.", step, window, series)
        return out

    def _add_prefixed(
        self,
        out: dict,
        key: str,
        prefix: str,
        step: float,
        window: float,
        series: str | None = None,
    ) -> None:
        got: dict[str, dict] = {}
        for name in self.ring.series:
            if name.startswith(prefix) and self._matches(name, series):
                got[name[len(prefix) :]] = self.ring.snapshot_series(
                    name, step, window_s=window
                )
        if got:
            out[key] = got

    async def snapshot(
        self, window_s: float | None = None, series: str | None = None
    ) -> dict:
        """Async alias kept for callers written against the old
        Prometheus-or-ring contract; the answer is always the ring."""
        return self.snapshot_ring(window_s=window_s, series=series)
