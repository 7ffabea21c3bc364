"""In-tree Prometheus exporter (a copy of ``tpumon/exporter.py``; the text
it renders is the reference's, apart from the profiler's help line).

Replaces the reference's out-of-tree exporter fleet — node-exporter :9100,
DCGM exporter :9400 and its DCGM_FI_DEV_* series (README.md:130-136,
monitor_server.js:128-134) — with one in-process ``/metrics`` endpoint
publishing:

- ``tpu_*``       per-chip gauges/counters (labels: chip, host, slice,
  kind, accel — the accelerator family, "tpu" | "gpu"; GPU chips ride
  the same families under the docs/federation.md normalization)
- ``tpumon_host_*``  host gauges (so history PromQL needs no node-exporter)
- ``tpumon_*``       self-metrics (sample counts/latency — SURVEY §5.1)
- ``tpumon_serving_*`` distilled serving signals per target

These are exactly the series tpumon_torch.history.PROM_QUERIES re-keys onto
(SURVEY §5.8).

Fast path: the render is split into per-section blocks (host / accel /
pods / serving / self) keyed on the sampler's dirty-section versions
(tpumon_torch.snapshot.ExporterCache). A scrape between ticks reuses every
block; a tick that only changed pods re-renders the pods block, not 256
chips' worth of gauge lines. Within one epoch the text is byte-stable —
``tpumon_uptime_seconds`` advances at tick granularity, a deliberate
trade documented in docs/perf.md.
"""

from __future__ import annotations

import time

from tpumon_torch.metrics_text import MetricsWriter
from tpumon_torch.sampler import Sampler
from tpumon_torch.snapshot import ExporterCache


def _render_host(sampler: Sampler) -> str:
    w = MetricsWriter()
    host = sampler.host_data()
    if not host:
        return ""
    cpu = host.get("cpu") or {}
    mem = host.get("memory") or {}
    disk = host.get("disk") or {}
    g = w.gauge("tpumon_host_cpu_pct", "Host CPU utilization percent")
    if cpu.get("percent") is not None:
        g.add({}, cpu["percent"])
    g = w.gauge("tpumon_host_load1", "Host 1-minute load average")
    if cpu.get("load_1min") is not None:
        g.add({}, cpu["load_1min"])
    g = w.gauge("tpumon_host_memory_pct", "Host memory used percent")
    if mem.get("percent") is not None:
        g.add({}, mem["percent"])
    g = w.gauge("tpumon_host_memory_used_bytes", "Host memory used bytes")
    if mem.get("used") is not None:
        g.add({}, mem["used"])
    g = w.gauge("tpumon_host_disk_pct", "Disk used percent per mount")
    for mount, d in (disk.get("mounts") or {}).items():
        if d.get("percent") is not None:
            g.add({"mount": mount}, d["percent"])
    net = host.get("net") or {}
    if net.get("interfaces"):
        rxc = w.counter(
            "tpumon_host_net_rx_bytes_total",
            "Cumulative NIC bytes received (DCN-traffic proxy)",
        )
        txc = w.counter(
            "tpumon_host_net_tx_bytes_total",
            "Cumulative NIC bytes transmitted (DCN-traffic proxy)",
        )
        for iface, d in net["interfaces"].items():
            rxc.add({"iface": iface}, d["rx_bytes"])
            txc.add({"iface": iface}, d["tx_bytes"])
    return w.render()


def _render_accel(sampler: Sampler) -> str:
    """Chips + libtpu SDK extras + slice rollups — the O(chips) block."""
    w = MetricsWriter()
    chips = sampler.chips()
    if chips:
        # Family names stay the TPU-native spellings (renaming would
        # break every recorded series and shipped Grafana board); GPU
        # chips ride the same families under the normalization of
        # docs/federation.md "Mixed fleets" (SM%→duty, VRAM→HBM,
        # NVLink→ICI), distinguished by the ``accel`` label.
        duty = w.gauge(
            "tpu_mxu_duty_cycle_pct",
            "TensorCore/MXU (GPU: SM) duty cycle percent",
        )
        used = w.gauge("tpu_hbm_used_bytes", "HBM/VRAM bytes in use")
        total = w.gauge("tpu_hbm_total_bytes", "HBM/VRAM capacity bytes")
        used_pct = w.gauge("tpu_hbm_used_pct", "HBM/VRAM used percent")
        temp = w.gauge("tpu_temp_celsius", "Chip temperature")
        tx = w.counter(
            "tpu_ici_tx_bytes_total",
            "Cumulative ICI (GPU: NVLink) bytes transmitted",
        )
        rx = w.counter(
            "tpu_ici_rx_bytes_total",
            "Cumulative ICI (GPU: NVLink) bytes received",
        )
        link = w.gauge("tpu_ici_link_up", "ICI/NVLink link state (1=up)")
        ici_health = w.gauge(
            "tpu_ici_link_health_score",
            "Worst ICI/NVLink link health per chip (0 healthy .. 10 unusable)",
        )
        throttle = w.gauge(
            "tpu_throttle_score", "TPU throttle score (0 .. 10 = 100% throttled)"
        )
        for c in chips:
            labels = {
                "chip": c.chip_id,
                "host": c.host,
                "slice": c.slice_id,
                "kind": c.kind,
                "accel": c.accel_kind,
            }
            if c.mxu_duty_pct is not None:
                duty.add(labels, c.mxu_duty_pct)
            if c.hbm_used is not None:
                used.add(labels, c.hbm_used)
            if c.hbm_total is not None:
                total.add(labels, c.hbm_total)
            if c.hbm_pct is not None:
                used_pct.add(labels, c.hbm_pct)
            if c.temp_c is not None:
                temp.add(labels, c.temp_c)
            if c.ici_tx_bytes is not None:
                tx.add(labels, c.ici_tx_bytes)
            if c.ici_rx_bytes is not None:
                rx.add(labels, c.ici_rx_bytes)
            if c.ici_link_up is not None:
                link.add(labels, 1.0 if c.ici_link_up else 0.0)
            if c.ici_link_health is not None:
                ici_health.add(labels, c.ici_link_health)
            if c.throttle_score is not None:
                throttle.add(labels, c.throttle_score)

    # ---- libtpu SDK slice-level extras (accel collector "runtime") ----
    # HLO queue depth per core + {buffer transfer, collective e2e, HLO
    # execution, host<->device} latency percentiles, re-exported so
    # Prometheus can record them (the SDK only reports current values).
    extras = getattr(sampler.accel, "last_extras", None) or {}
    queue_sizes = extras.get("hlo_queue_size") or {}
    if queue_sizes:
        qg = w.gauge(
            "tpu_hlo_queue_size", "Enqueued-not-dequeued HLOs per core"
        )
        for core, size in sorted(queue_sizes.items()):
            qg.add({"core": str(core)}, float(size))
    for family in (
        "buffer_transfer_latency",
        "collective_e2e_latency",
        "hlo_execution_timing",
        "host_to_device_transfer_latency",
        "device_to_host_transfer_latency",
    ):
        table = extras.get(family) or {}
        if not table:
            continue
        fg = w.gauge(
            f"tpu_{family}_us",
            f"libtpu {family.replace('_', ' ')} percentiles (microseconds)",
        )
        mg = w.gauge(
            f"tpu_{family}_us_mean",
            f"libtpu {family.replace('_', ' ')} mean (microseconds)",
        )
        for label, pcts in sorted(table.items()):
            for q, val in pcts.items():
                # "mean" is not a quantile; Prometheus treats the
                # "quantile" label as a summary-type convention, so the
                # mean rides its own series instead.
                if q == "mean":
                    mg.add({"bucket": str(label)}, float(val))
                else:
                    fg.add({"bucket": str(label), "quantile": q}, float(val))

    # ---- slices ----
    slices = sampler.slices()
    if slices:
        reporting = w.gauge("tpu_slice_reporting_chips", "Chips currently reporting")
        expected = w.gauge("tpu_slice_expected_chips", "Chips expected in slice")
        for s in slices:
            # The accel label must be PRESENT and STABLE even for an
            # expected-but-absent slice (no chips to take a family
            # from): flipping the label across an outage would fork
            # the Prometheus series identity exactly when an absence
            # alert needs reporting_chips to read 0 on the same
            # series. The sampler remembers each slice's last-known
            # family; never-seen slices read as the "tpu" default.
            labels = {
                "slice": s.slice_id,
                "accel": s.accel_kind or sampler.slice_accel_kind(s.slice_id),
            }
            reporting.add(labels, s.reporting_chips)
            if s.expected_chips is not None:
                expected.add(labels, s.expected_chips)
    return w.render() if w.families else ""


def _render_pods(sampler: Sampler) -> str:
    w = MetricsWriter()
    pods = sampler.pods()
    if not pods:
        return ""
    phase_counts: dict[str, int] = {}
    for p in pods:
        phase_counts[p.get("status", "Unknown")] = (
            phase_counts.get(p.get("status", "Unknown"), 0) + 1
        )
    g = w.gauge("tpumon_pods_by_phase", "Pod count per phase")
    for phase, n in sorted(phase_counts.items()):
        g.add({"phase": phase}, n)
    return w.render()


def _render_serving(sampler: Sampler) -> str:
    w = MetricsWriter()
    serving = sampler.serving_data()
    if not serving:
        return ""
    tps = w.gauge("tpumon_serving_tokens_per_sec", "Generated tokens/sec")
    ttft = w.gauge("tpumon_serving_ttft_p50_ms", "TTFT p50 in ms")
    queue = w.gauge("tpumon_serving_queue_depth", "Request queue depth")
    up = w.gauge("tpumon_serving_up", "Serving target scrape success")
    for s in serving:
        labels = {"target": s.get("target", "")}
        up.add(labels, 1.0 if s.get("ok") else 0.0)
        if s.get("tokens_per_sec") is not None:
            tps.add(labels, s["tokens_per_sec"])
        if s.get("ttft_p50_ms") is not None:
            ttft.add(labels, s["ttft_p50_ms"])
        if s.get("queue_depth") is not None:
            queue.add(labels, s["queue_depth"])
    # Training targets re-exported (one-stop Prometheus scrape when
    # Prometheus doesn't reach each trainer directly). Distinct
    # tpumon_monitor_train_* names: re-using the trainers' own
    # tpumon_train_* names would double-count in deployments where
    # Prometheus scrapes both; PROM_QUERIES prefers the direct series
    # and falls back to these via PromQL `or`.
    if any(s.get("train_step") is not None for s in serving):
        step = w.gauge("tpumon_monitor_train_step", "Training step (re-exported)")
        loss = w.gauge("tpumon_monitor_train_loss", "Training loss (re-exported)")
        tokens = w.counter(
            "tpumon_monitor_train_tokens_total", "Trained tokens (re-exported)"
        )
        goodput = w.gauge(
            "tpumon_monitor_train_goodput_pct", "Training goodput percent"
        )
        mfu = w.gauge(
            "tpumon_monitor_train_mfu_pct",
            "Training model-FLOPs utilization percent",
        )
        for s in serving:
            if s.get("train_step") is None:
                continue
            labels = {"target": s.get("target", "")}
            step.add(labels, s["train_step"])
            if s.get("train_loss") is not None:
                loss.add(labels, s["train_loss"])
            if s.get("train_tokens_total") is not None:
                tokens.add(labels, s["train_tokens_total"])
            if s.get("train_goodput_pct") is not None:
                goodput.add(labels, s["train_goodput_pct"])
            if s.get("train_mfu_pct") is not None:
                mfu.add(labels, s["train_mfu_pct"])
    return w.render()


def _render_self(sampler: Sampler) -> str:
    """Self metrics + resilience + uptime — versioned on collection
    activity ("samples"), so it re-renders whenever any source polled."""
    w = MetricsWriter()
    samples = w.counter("tpumon_samples_total", "Collection attempts per source")
    failures = w.counter("tpumon_sample_failures_total", "Failed collections")
    deadline = w.counter(
        "tpumon_collect_deadline_exceeded_total",
        "Collections that hit their wall-clock deadline",
    )
    skipped = w.counter(
        "tpumon_collect_skipped_total",
        "Polls suppressed by an open circuit breaker",
    )
    lat = w.gauge("tpumon_sample_latency_p50_ms", "Collection latency p50 (ms)")
    lat95 = w.gauge("tpumon_sample_latency_p95_ms", "Collection latency p95 (ms)")
    ok = w.gauge("tpumon_source_up", "Source healthy (1=ok)")
    for name, st in sorted(sampler.stats.items()):
        labels = {"source": name}
        samples.add(labels, st.samples)
        failures.add(labels, st.failures)
        deadline.add(labels, st.deadline_exceeded)
        skipped.add(labels, st.skipped)
        q = st.latency_summary()  # p50/p95/max in one pass per render
        if q is not None:
            lat.add(labels, round(q[0], 3))
            lat95.add(labels, round(q[1], 3))
        latest = sampler.latest.get(name)
        if latest is not None:
            ok.add(labels, 1.0 if latest.ok else 0.0)

    # ---- resilience (tpumon_torch.resilience) ----
    if sampler.breakers:
        state_g = w.gauge(
            "tpumon_source_breaker_state",
            "Circuit breaker state per source (0=closed 1=half_open 2=open)",
        )
        opened = w.counter(
            "tpumon_source_breaker_opened_total",
            "Times the breaker opened (entered backoff) per source",
        )
        state_code = {"closed": 0.0, "half_open": 1.0, "open": 2.0}
        for name, br in sorted(sampler.breakers.items()):
            labels = {"source": name}
            state_g.add(labels, state_code.get(br.state, 2.0))
            opened.add(labels, br.opened_count)
    if sampler.watchdogs:
        ticks = w.counter("tpumon_loop_ticks_total", "Sampler loop iterations")
        lagged = w.counter(
            "tpumon_loop_lagged_ticks_total",
            "Loop iterations that overran their interval",
        )
        excs = w.counter(
            "tpumon_loop_exceptions_total",
            "Exceptions swallowed by a sampler loop (pipeline bugs)",
        )
        lag_max = w.gauge(
            "tpumon_loop_max_lag_seconds", "Worst observed tick overrun"
        )
        for name, wd in sorted(sampler.watchdogs.items()):
            labels = {"loop": name}
            ticks.add(labels, wd.ticks)
            lagged.add(labels, wd.lagged_ticks)
            excs.add(labels, wd.exceptions)
            lag_max.add(labels, round(wd.max_lag_s, 3))

    g = w.gauge("tpumon_snapshot_epoch", "Monotonic snapshot epoch")
    g.add({}, sampler.clock.epoch)
    g = w.gauge("tpumon_uptime_seconds", "Monitor uptime")
    g.add({}, round(time.time() - sampler.started_at, 1))
    return w.render()


def _render_trace(sampler: Sampler, profiler=None) -> str:
    """Self-trace block (tpumon_torch.tracing): genuine Prometheus histogram
    triples — cumulative le-labelled ``_bucket`` + ``_sum`` + ``_count``
    — per data-plane stage and per HTTP route, replacing gauge-only
    latency reporting so ``histogram_quantile`` works against the
    monitor itself. Plus span-ring accounting and the device profiler's
    capture counters."""
    w = MetricsWriter()
    tracer = getattr(sampler, "tracer", None)
    if tracer is not None and tracer.enabled:
        stage = w.histogram(
            "tpumon_stage_duration_seconds",
            "Data-plane stage duration (ticks, per-source collects, "
            "alert eval, history record, SSE delta)",
        )
        for name, hist in sorted(tracer.stage_hist.items()):
            stage.add_histogram(
                {"stage": name}, hist.cumulative(), hist.count, hist.sum
            )
        http = w.histogram(
            "tpumon_http_request_duration_seconds",
            "HTTP request duration per route",
        )
        for route, hist in sorted(tracer.http_hist.items()):
            http.add_histogram(
                {"route": route}, hist.cumulative(), hist.count, hist.sum
            )
        g = w.counter("tpumon_trace_spans_total", "Spans recorded by the tracer")
        g.add({}, tracer.recorded)
        g = w.counter(
            "tpumon_trace_spans_dropped_total",
            "Spans overwritten by the bounded ring",
        )
        g.add({}, tracer.dropped)
    if profiler is not None:
        g = w.counter(
            "tpumon_profile_captures_total",
            "torch.profiler device-trace captures served via /api/profile",
        )
        g.add({}, profiler.captures)
        g = w.gauge(
            "tpumon_profile_busy", "A profile capture is in progress (1=busy)"
        )
        g.add({}, 1.0 if profiler.busy else 0.0)
    return w.render() if w.families else ""


def _render_federation(sampler: Sampler) -> str:
    """Aggregator-tree block (tpumon_torch.federation): per-downstream
    freshness and liveness, fleet-level dark/unreachable counts, and the
    uplink's wire accounting — the gauges an operator pages off when a
    subtree goes quiet. Rendered on the "federation" dirty section (plus
    "samples" so age gauges advance per tick); absent entirely on standalone monitors. The
    family names below are documented in docs/federation.md — the
    tpulint registry pass pins that."""
    hub = getattr(sampler, "federation", None)
    uplink = getattr(sampler, "uplink", None)
    leader = getattr(sampler, "leader", None)
    if hub is None and uplink is None and leader is None:
        return ""
    w = MetricsWriter()
    if leader is not None:
        g = w.gauge(
            "tpumon_federation_leader",
            "This root holds an unexpired leadership lease (1=leader)",
        )
        g.add({}, 1.0 if leader.is_leader() else 0.0)
        g = w.gauge(
            "tpumon_federation_generation",
            "Highest leadership fencing token this root has observed",
        )
        g.add({}, leader.generation)
        c = w.counter(
            "tpumon_federation_failovers_total",
            "Promotions that replaced a previous leader (bootstrap excluded)",
        )
        c.add({}, leader.failovers)
    if hub is not None:
        hub.check_staleness()  # dark flips land before the render
        up = w.gauge(
            "tpumon_federation_downstream_up",
            "Downstream node streaming fresh frames (1=ok, 0=dark/unreachable)",
        )
        age = w.gauge(
            "tpumon_federation_downstream_age_seconds",
            "Seconds since the last frame landed from this downstream",
        )
        frames = w.counter(
            "tpumon_federation_downstream_frames_total",
            "Delta frames ingested per downstream node",
        )
        fbytes = w.counter(
            "tpumon_federation_downstream_bytes_total",
            "Wire bytes ingested per downstream node",
        )
        for node, ns in sorted(hub.nodes.items()):
            labels = {"node": node, "tier": ns.tier}
            up.add(labels, 1.0 if ns.status == "ok" else 0.0)
            if ns.last_wall is not None:
                age.add(labels, round(time.monotonic() - ns.last_wall, 3))
            frames.add(labels, ns.frames)
            fbytes.add(labels, ns.bytes)
        if hub.freshness_now:
            # End-to-end freshness: age of each ORIGIN
            # node's newest sample when it landed here, clock-offset
            # corrected — keyed per origin, not per direct downstream,
            # so a root exports one series per leaf it can see.
            fr = w.gauge(
                "tpumon_federation_freshness_ms",
                "Milliseconds from an origin node's newest sample to it "
                "landing at this node (clock-offset corrected)",
            )
            for node, row in sorted(hub.freshness_now.items()):
                fr.add({"node": node, "tier": row.get("tier") or ""},
                       row.get("ms"))
        fleet = hub.fleet()
        g = w.gauge(
            "tpumon_federation_fleet_slices", "Slices in the fleet view"
        )
        g.add({}, fleet["slices"])
        g = w.gauge(
            "tpumon_federation_fleet_chips", "Reporting chips in the fleet view"
        )
        g.add({}, fleet["chips"])
        g = w.gauge(
            "tpumon_federation_dark_slices",
            "Slices whose leaf went silent (reported dark by its aggregator)",
        )
        g.add({}, fleet["dark_slices"])
        g = w.gauge(
            "tpumon_federation_unreachable_slices",
            "Slices behind a partitioned aggregator subtree",
        )
        g.add({}, fleet["unreachable_slices"])
    if uplink is not None:
        st = uplink.enc.stats
        g = w.gauge(
            "tpumon_federation_uplink_connected",
            "Upstream push stream established (1=connected)",
        )
        g.add({}, 1.0 if uplink.connected else 0.0)
        c = w.counter(
            "tpumon_federation_uplink_frames_total",
            "Delta frames pushed upstream",
        )
        c.add({}, st["frames"])
        c = w.counter(
            "tpumon_federation_uplink_bytes_total",
            "Wire bytes pushed upstream (keyframes + deltas)",
        )
        c.add({}, st["bytes"])
        c = w.counter(
            "tpumon_federation_uplink_delta_bytes_total",
            "Wire bytes pushed upstream in delta frames (the steady state)",
        )
        c.add({}, st["delta_bytes"])
        c = w.counter(
            "tpumon_federation_uplink_resyncs_total",
            "Keyframe resyncs after a lost upstream connection",
        )
        c.add({}, uplink.resyncs)
    return w.render() if w.families else ""


def _render_slo(sampler: Sampler) -> str:
    """SLO block (tpumon_torch.slo, docs/slo.md): per-objective error-budget
    remaining, instantaneous bad fraction, and the fast/slow burn rates
    with their firing state — the gauges an external pager or Grafana
    burn-down panel consumes. Absent entirely when no objectives are
    configured. Family names are documented in docs/slo.md's metrics
    table, which the tpulint registry pass pins."""
    slo = getattr(sampler, "slo", None)
    if slo is None:
        return ""
    rows = slo.exporter_rows()
    if not rows:
        return ""
    w = MetricsWriter()
    target = w.gauge("tpumon_slo_target", "Configured objective target")
    remaining = w.gauge(
        "tpumon_slo_budget_remaining",
        "Error budget remaining over the SLO window (1=untouched, "
        "<0=exhausted)",
    )
    bad = w.gauge(
        "tpumon_slo_bad_fraction",
        "Instantaneous bad-event fraction (this tick's slo.<name>.bad)",
    )
    burn = w.gauge(
        "tpumon_slo_burn_rate",
        "Error-budget burn rate per alert window (multiples of the "
        "budget-neutral rate; labels: slo, window=fast|slow, span=short|long)",
    )
    firing = w.gauge(
        "tpumon_slo_burn_firing",
        "Burn-rate alert state per window pair (1=firing)",
    )
    for row in rows:
        labels = {"slo": row["name"]}
        if row.get("tenant"):
            labels["tenant"] = row["tenant"]
        target.add(labels, row["target"])
        rem = (row.get("budget") or {}).get("remaining")
        if rem is not None:
            remaining.add(labels, rem)
        if row.get("bad") is not None:
            bad.add(labels, row["bad"])
        for speed, b in (row.get("burn") or {}).items():
            for span in ("short", "long"):
                if b.get(span) is not None:
                    burn.add({**labels, "window": speed, "span": span},
                             b[span])
            firing.add({**labels, "window": speed},
                       1.0 if b.get("firing") else 0.0)
    return w.render()


def _render_actuate(sampler: Sampler) -> str:
    """Actuation block (tpumon_torch.actuate, docs/actuation.md): per-policy
    state machine position + lifetime transition counters, plus the
    engine's global guard state — what an operator graphs to answer
    "is the monitor acting, and how often is the rate limit biting".
    Absent entirely when no policies are configured. Family names are
    documented in docs/actuation.md's metrics table, which the tpulint
    registry pass pins."""
    actuate = getattr(sampler, "actuate", None)
    if actuate is None:
        return ""
    rows = actuate.exporter_rows()
    if not rows:
        return ""
    w = MetricsWriter()
    state = w.gauge(
        "tpumon_actuate_policy_state",
        "Policy state machine position (0=idle, 1=armed, 2=fired)",
    )
    dry = w.gauge(
        "tpumon_actuate_policy_dry_run",
        "1 when the policy journals intent without acting",
    )
    fired = w.counter(
        "tpumon_actuate_fired_total", "Actions performed (or, dry-run, "
        "intended) per policy",
    )
    reverted = w.counter(
        "tpumon_actuate_reverted_total",
        "Automatic reverts after the triggering condition cleared",
    )
    suppressed = w.counter(
        "tpumon_actuate_suppressed_total",
        "Fire attempts suppressed by the per-policy cooldown",
    )
    limited = w.counter(
        "tpumon_actuate_rate_limited_total",
        "Fire attempts refused by the global actions-per-window limit",
    )
    for row in rows:
        labels = {"policy": row["name"], "action": row["action"]}
        state.add(labels,
                  {"idle": 0.0, "armed": 1.0, "fired": 2.0}[row["state"]])
        dry.add(labels, 1.0 if row["dry_run"] else 0.0)
        fired.add(labels, row["fired"])
        reverted.add(labels, row["reverted"])
        suppressed.add(labels, row["suppressed"])
        limited.add(labels, row["rate_limited"])
    g = w.gauge(
        "tpumon_actuate_actions_in_window",
        "Performed actions inside the current rate-limit window "
        "(at max_actions the engine refuses new fires)",
    )
    g.add({}, actuate.actions_in_window)
    return w.render()


def _render_events(sampler: Sampler) -> str:
    """Event journal + anomaly detector block (tpumon_torch.events /
    tpumon_torch.anomaly): lifetime per-(kind, severity) event counters —
    ``increase(tpumon_events_total{severity="serious"}[5m])`` is the
    Grafana annotations query — ring-overwrite accounting, and the
    per-series anomaly state gauge."""
    journal = getattr(sampler, "journal", None)
    if journal is None:
        return ""
    w = MetricsWriter()
    if journal.counts:
        c = w.counter(
            "tpumon_events_total",
            "Structured journal events recorded, by kind and severity",
        )
        for (kind, sev), n in sorted(journal.counts.items()):
            c.add({"kind": kind, "severity": sev}, n)
        d = w.counter(
            "tpumon_events_dropped_total",
            "Journal events overwritten by the bounded ring",
        )
        d.add({}, journal.dropped)
    bank = getattr(sampler, "anomaly", None)
    if bank is not None and bank.detectors:
        g = w.gauge(
            "tpumon_anomaly_active",
            "EWMA anomaly detector state per series (1=anomalous)",
        )
        for name, det in sorted(bank.detectors.items()):
            g.add({"series": name}, 1.0 if det.state == "anomalous" else 0.0)
    return w.render() if w.families else ""


# section name -> (dep sections, renderer). "samples" (a pseudo-section
# bumped on every poll) keeps activity-derived blocks live even when
# the data sections are static.
EXPORTER_SECTIONS: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("host", ("host",)),
    ("accel", ("accel",)),
    ("pods", ("k8s",)),
    ("serving", ("serving",)),
    ("self", ("host", "accel", "k8s", "serving", "alerts", "samples")),
    ("trace", ("samples",)),
    # SLO budget/burn gauges move only when the published SLO view does.
    ("slo", ("slo",)),
    # Actuation policy gauges move only when a policy row does.
    ("actuate", ("actuate",)),
    # Journal counters + anomaly gauges move only when the journal does.
    ("events", ("events",)),
    # Aggregator-tree gauges: "federation" moves as downstream frames
    # land / nodes flip dark; "samples" keeps the per-downstream age
    # and uplink counters fresh each tick even when no frame landed.
    ("federation", ("federation", "samples")),
)

_RENDERERS = {
    "host": _render_host,
    "accel": _render_accel,
    "pods": _render_pods,
    "serving": _render_serving,
    "self": _render_self,
    "slo": _render_slo,
    "actuate": _render_actuate,
    "events": _render_events,
    "federation": _render_federation,
}


def render_exporter(
    sampler: Sampler, cache: ExporterCache | None = None, profiler=None
) -> str:
    """Full exposition text. With ``cache`` (the server's persistent
    ExporterCache) only sections whose versions moved re-render; without
    it every block renders fresh (tests, one-shot tools). ``profiler``
    (the server's ProfilerService, when wired) adds the
    tpumon_profile_* series to the trace block."""
    blocks: list[str] = []
    for name, deps in EXPORTER_SECTIONS:
        if name == "trace":
            fn = lambda s: _render_trace(s, profiler)  # noqa: E731
        else:
            fn = _RENDERERS[name]
        if cache is not None:
            text = cache.block(name, deps, lambda fn=fn: fn(sampler))
        else:
            text = fn(sampler)
        if text:
            blocks.append(text)
    return "".join(blocks)
