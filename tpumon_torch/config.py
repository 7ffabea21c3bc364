"""Typed configuration for tpumon.

The reference has zero configurability: two hardcoded constants
(``PORT = 8888``, ``PROMETHEUS_URL``, monitor_server.js:10-11), a hardcoded
8-core CPU divisor (monitor_server.js:76) and magic-number alert thresholds
(monitor_server.js:163-184). tpumon replaces that with a small typed config
loaded from defaults <- optional JSON/TOML file <- TPUMON_* environment
variables, covering everything SURVEY.md §5.6 calls for: port, Prometheus
URL, core count (auto-detected), thresholds, enabled collectors and
topology expectations.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Mapping

from tpumon_torch.collectors.workload import DEFAULT_DIR as _WORKLOAD_DEFAULT_DIR

_DURATION_RE = re.compile(r"^(\d+)([smhd])$")
_DURATION_UNITS = {"s": 1, "m": 60, "h": 3600, "d": 86400}


def parse_duration(text: str | int | float, default: float | None = None) -> float:
    """Parse ``"30m"``-style durations into seconds.

    Same grammar as the reference's parseDuration (monitor_server.js:54-63:
    regex ``(\\d+)([smhd])``), but a bad input raises (or returns an explicit
    caller-provided default) instead of silently becoming 1800.
    """
    if isinstance(text, (int, float)):
        return float(text)
    m = _DURATION_RE.match(text.strip())
    if not m:
        if default is not None:
            return default
        raise ValueError(f"invalid duration {text!r} (want e.g. '30s', '30m', '1h')")
    return float(int(m.group(1)) * _DURATION_UNITS[m.group(2)])


@dataclass(frozen=True)
class TriLevel:
    """A minor/serious/critical threshold triple.

    Mirrors the reference's three severity buckets (monitor_server.js:159-238,
    README.md:58-64). ``minor`` may be None for signals that only have
    serious/critical levels (e.g. temperature, monitor_server.js:183-184).
    """

    minor: float | None
    serious: float
    critical: float

    def severity(self, value: float) -> str | None:
        """Classify a value; returns 'minor' | 'serious' | 'critical' | None."""
        if value > self.critical:
            return "critical"
        if value > self.serious:
            return "serious"
        if self.minor is not None and value > self.minor:
            return "minor"
        return None


@dataclass(frozen=True)
class Thresholds:
    """Alert thresholds, re-keyed for TPU per SURVEY.md §2.2.

    cpu/memory/disk keep the reference's 70/85/95 (monitor_server.js:163-175).
    GPU-mem% becomes per-chip HBM% (reference checked device 0 only,
    monitor_server.js:178-182); GPU temp becomes chip temp 75/85
    (monitor_server.js:183-184). MXU duty-cycle gets *idle* rules instead of
    high-usage rules (a busy MXU is healthy; a claimed-busy job on an idle
    MXU is not) plus the TPU-only ICI/slice rules.
    """

    cpu_pct: TriLevel = TriLevel(70, 85, 95)
    memory_pct: TriLevel = TriLevel(70, 85, 95)
    disk_pct: TriLevel = TriLevel(70, 85, 95)
    hbm_pct: TriLevel = TriLevel(70, 85, 95)
    temp_c: TriLevel = TriLevel(None, 75, 85)
    # A chip whose HBM is heavily committed but whose MXU duty-cycle sits
    # below this for the whole observation window is likely a wedged/stalled
    # job (serious).
    mxu_idle_pct: float = 5.0
    mxu_idle_hbm_gate_pct: float = 50.0
    # A training target whose step counter hasn't advanced for this long
    # is stalled (serious) — wedged collective, input starvation, or a
    # checkpoint write that never returns. 0 disables.
    train_stall_s: float = 120.0
    # Paged-serving KV pool occupancy (reserved pages / pool): high
    # occupancy means admissions are about to queue on KV memory.
    kv_pool_pct: TriLevel = TriLevel(None, 85, 95)
    # libtpu SDK per-chip scores, both scaled 0-10 (PROBE_libtpu.md).
    # ICI link health: 1-5 transient problem (minor), 6-9 persistent
    # minor problem (serious); 10 = unusable, covered by the critical
    # link-down rule. Throttle: score N means throttled by N*10%.
    ici_health_score: TriLevel = TriLevel(0, 5, 9)
    throttle_score: TriLevel = TriLevel(0, 4, 7)
    # Anti-flap holds (Prometheus "for" / "keep_firing_for" semantics):
    # a condition must hold fire_hold_s before the alert fires, and must
    # stay clear resolve_hold_s before it resolves. 0/0 = the reference's
    # instant per-evaluation behavior (its 1-sample alerts flap at every
    # threshold crossing).
    fire_hold_s: float = 0.0
    resolve_hold_s: float = 0.0


@dataclass(frozen=True)
class Config:
    # --- serving ---
    port: int = 8888  # same default as the reference (monitor_server.js:10)
    host: str = "0.0.0.0"
    # Server-side TLS: PEM certificate chain + key
    # terminating HTTPS on the listener, so the SLO/alerting surface —
    # and eventually the actuation routes — isn't plaintext on the pod
    # network. tls_key defaults to tls_cert (single combined PEM).
    # Uplinks already speak https:// in federate_up; with these set the
    # server side can terminate them.
    tls_cert: str | None = None
    tls_key: str | None = None

    # --- history (reference: 30m window / 30s step, monitor_server.js:38) ---
    # DEPRECATED: the external-Prometheus history path is retired — the
    # in-process TSDB + query engine (tpumon.query, docs/query.md)
    # serve /api/history and /api/query. Accepted so old configs load;
    # a deprecation warning is printed, nothing is queried.
    prometheus_url: str | None = None
    history_window_s: float = 30 * 60
    history_step_s: float = 30
    # Long-range tier: /api/history?window= up to this span, served from
    # coarse (bucket-mean) ring data when Prometheus is absent.
    history_long_window_s: float = 24 * 3600
    history_coarse_step_s: float = 60
    # Mid retention tier (tpumon.tsdb): bucket means between the fine
    # ring and the coarse tier, so multi-hour windows render at 30 s
    # resolution instead of the coarse step. 0 disables.
    history_mid_step_s: float = 30
    history_mid_window_s: float = 6 * 3600
    # Per-chip history: the sampler records chip.<id>.{mxu,hbm,temp,link}
    # series for up to this many chips (drill-down curves via
    # /api/history?series=chip.* — holds at v5p-256 thanks to the
    # columnar store). 0 disables per-chip history entirely; chips
    # beyond the cap are counted, not silently dropped (/api/health).
    history_per_chip: int = 256
    # On-disk format for history_snapshot_path writes: "binary" (the v2
    # chunk-verbatim format, ~10x cheaper) or "json" (the v1 format).
    # Restore reads either, whatever this is set to.
    history_snapshot_format: str = "binary"

    # --- sampling (replaces per-request execSync collection, SURVEY §3.2) ---
    sample_interval_s: float = 1.0
    pods_interval_s: float = 5.0
    serving_interval_s: float = 5.0

    # --- resilience (tpumon.resilience; SURVEY §7 hardened) ---
    # Wall-clock bound on any one collect(): a hung collector (stuck
    # kubectl, wedged gRPC channel) degrades to a deadline-exceeded
    # Sample instead of freezing the sampler loop. 0 disables.
    collect_deadline_s: float = 10.0
    # Per-source overrides, e.g. {"k8s": 30, "host": 2}.
    collect_deadlines: Mapping[str, float] = field(default_factory=dict)
    # Circuit breaker: after this many consecutive failures a source is
    # probed on an exponential-backoff cadence (base..max, ±20% jitter)
    # instead of at full rate. breaker_failures=0 disables breaking.
    breaker_failures: int = 3
    breaker_backoff_s: float = 5.0
    breaker_backoff_max_s: float = 300.0
    # --- self-tracing (tpumon.tracing; docs/observability.md) ---
    # Bounded span-ring capacity for the always-on data-plane tracer
    # behind /api/trace, /api/trace/export and the
    # tpumon_stage_duration_seconds histograms. 0 disables tracing
    # entirely (the bench's overhead baseline).
    trace_ring: int = 4096

    # --- structured event journal (tpumon.events; docs/events.md) ---
    # Bounded ring of lifecycle events (alert fired/resolved, breaker
    # transitions, chaos injections, anomaly fires, ...) behind
    # /api/events, the SSE event feed and tpumon_events_total. Values
    # below 16 clamp up — a ring too small for one alert lifecycle
    # would break the timeline.
    events_ring: int = 4096
    # JSONL persistence path for the journal (crash-safe atomic
    # rewrites on events_interval_s, restored at startup so cursors and
    # the incident record survive restarts). None disables.
    events_path: str | None = None
    events_interval_s: float = 30.0

    # --- EWMA anomaly detection (tpumon.anomaly; docs/events.md) ---
    # Per-series drift detectors over fleet duty/HBM, tick duration and
    # per-source scrape p95: z-score gate with hysteresis, emitting
    # ``anomaly`` journal events and a minor ``anomaly.<series>`` alert.
    anomaly_detect: bool = True
    anomaly_alpha: float = 0.05
    anomaly_z_fire: float = 4.0
    anomaly_z_clear: float = 1.5
    anomaly_warmup: int = 30

    # Chaos fault injection ("mode:source:param,..." —
    # tpumon.collectors.chaos; "" = no faults). Example:
    # "hang:accel:0.1,err:k8s:0.3,slow:host:200".
    chaos: str = ""
    # Optional seed for reproducible chaos soaks.
    chaos_seed: int | None = None

    # --- crash-safe history (tpumon.history.HistorySnapshotter) ---
    # Path for the periodic ring+coarse history snapshot; restored at
    # startup so a monitor restart doesn't erase the recent past. None
    # disables (state_path already covers history when configured).
    history_snapshot_path: str | None = None
    history_snapshot_interval_s: float = 30.0

    # --- collectors ---
    collectors: tuple[str, ...] = ("host", "accel", "k8s", "serving")
    # accel backend: "auto" | "cuda" (the in-process NVML collector,
    # tpumon_torch.collectors.accel_cuda; "auto" builds it too) |
    # "fake:<topology>" | "none", plus "gpufake:<topology>" (dgx-a100-8 /
    # dgx-h100-8 / superpod-32), "nvidia-smi[:<path>]" (CSV shell-out),
    # "dcgm:<url>" (DCGM-exporter scrape) — all normalize into the same
    # ChipSample schema with accel_kind="gpu". The reference's "jax" is
    # refused with a pointer to "cuda".
    accel_backend: str = "auto"
    # host cpu count: 0 => auto-detect (reference hardcoded 8, monitor_server.js:76)
    cpu_count: int = 0
    disk_mounts: tuple[str, ...] = ("/",)
    # k8s: "auto" tries in-cluster API then kubectl; "api" | "watch"
    # (live watch stream — catches sub-sample pod flaps) | "kubectl" |
    # "fake" | "none"
    k8s_mode: str = "auto"
    k8s_api_url: str | None = None
    # JetStream / MaxText /metrics scrape targets (SURVEY §5.7)
    serving_targets: tuple[str, ...] = ()
    # Peer tpumon instances whose chips are merged into this one's view
    # (realtime multi-host federation, BASELINE config 5)
    peers: tuple[str, ...] = ()
    # Federation fan-out bound: at most this many peer fetches in
    # flight at once (a 64-peer fleet must not spawn 64 worker threads
    # per tick) — see tpumon.collectors.accel_peers.
    peer_fanout: int = 16
    # Per-peer HTTP timeout for federation fetches.
    peer_timeout_s: float = 3.0
    # Binary peer wire (docs/perf.md "ingest spine"): serve and request
    # the columnar binary frame on /api/accel/wire (negotiated by
    # Accept header; JSON remains the default representation so
    # pre-binary peers keep federating). Off = JSON-only, both ways.
    wire_binary: bool = True
    # --- hierarchical federation (tpumon.federation, docs/federation.md) ---
    # Role in the aggregator tree: "" standalone (the default — no tree
    # behavior at all), "leaf" (pushes chip-level delta frames to
    # federate_up), "aggregator" (ingests downstream frames on
    # /api/federation/ingest, computes slice rollups, pushes SLICE-level
    # rows to federate_up), "root" (ingest + rollups only, the fleet
    # view). federate_up set with no role implies "leaf".
    federation_role: str = ""
    # Upstream aggregator base URL this instance pushes delta frames to
    # (long-lived chunked POST — push-based, the upstream never polls).
    # Dual-homed HA: a comma-separated second address is the standby
    # upstream — the uplink rotates to it on any stream failure and the
    # reconnect keyframe rebuilds the new upstream's fan-in state.
    federate_up: str | None = None
    # Node identity in upstream views/events; default = hostname.
    federation_node: str | None = None
    # Uplink keyframe cadence (the sse_keyframe_every idea applied to
    # the federation wire): a full keyframe every N frames bounds how
    # long a silently-desynced aggregator can stay wrong. Reconnects
    # always start with a keyframe regardless.
    federation_keyframe_every: int = 30
    # A downstream node whose stream has been silent this long is
    # marked dark: its slices flip to health="dark" in the fleet view
    # and a serious ``federation`` event fires.
    federation_dark_after_s: float = 5.0
    # --- root HA (tpumon.leader, docs/federation.md "Root HA") ---
    # Base URL of this root's peer root. Set on BOTH roots (each points
    # at the other); enables the leadership lease + heartbeat poll +
    # journal reconciliation. Leaves/aggregators reach both roots via a
    # comma-separated dual-homed federate_up instead.
    federation_peer: str = ""
    # Leadership lease length: a root whose event loop stops renewing
    # for this long self-fences (refuses to actuate); the standby
    # promotes after 2x this of peer silence.
    federation_lease_s: float = 2.0
    # Bootstrap asymmetry: exactly one root sets this, and it claims
    # generation 1 on its first peer probe instead of waiting out a
    # silence window. A restarting root always defers to an observed
    # leader regardless.
    federation_initial_leader: bool = False
    # Native TSDB append/downsample kernel (tpumon/native/tsdbkern.cpp):
    # off forces the bit-exact pure-Python ingest path even when the
    # shared library is built.
    ingest_kernel: bool = True

    # --- in-tree query engine (tpumon.query; docs/query.md) ---
    # Recording rules: ``family[window]`` range selectors (e.g.
    # "chip.mxu[5m]") whose count/sum/min/max/rate/quantile aggregates
    # are maintained incrementally AT APPEND TIME — an instant
    # *_over_time / rate read over a registered (family, window) is an
    # O(1) head-state merge, never a point walk.
    recording_rules: tuple[str, ...] = ()
    # Default window when a range function omits [w]: rate(chip.hbm)
    # reads the last query_default_range.
    query_default_range_s: float = 60.0
    # Instant-selector staleness bound: a series with no point newer
    # than this is absent from instant vectors (Prometheus lookback).
    query_lookback_s: float = 300.0
    # Wall budget for one distributed (fleet=1) query across the
    # federation tree; silent/dark nodes past it degrade the answer to
    # an explicit partial instead of an error.
    query_fleet_timeout_s: float = 2.0

    # --- SLO objectives (tpumon.slo; docs/slo.md) ---
    # Each entry: {"name", "expr", "target", "window", "tenant"?,
    # "fast"?/"slow"? window pairs, "fast_burn"?/"slow_burn"?/
    # "clear_ratio"?}. ``expr`` is the bad-event condition in the query
    # language; the engine records slo.<name>.bad per tick and serves
    # multi-window burn-rate alerts from it (GET /api/slo,
    # tpumon_slo_* gauges, `tpumon slo`). As an env/CLI value the list
    # is JSON (TPUMON_SLOS='[{"name": ...}]').
    slos: tuple = ()

    # --- SLO-driven actuation (tpumon.actuate; docs/actuation.md) ---
    # Each entry: {"name", "when", "action": "shed"|"capacity"|"drain",
    # per-action params, "clear"?, "cooldown_s"?, "fire_hold"?,
    # "clear_hold"?, "dry_run"?}. ``when`` is a query-language
    # condition (like the SLO bad-event expressions); the engine
    # evaluates every policy once per fast tick and drives the bound
    # actuator through journaled, guarded transitions. As an env/CLI
    # value the list is JSON (TPUMON_ACTUATIONS='[{"name": ...}]').
    actuations: tuple = ()
    # Global dry-run: every policy journals intent without acting
    # (per-policy "dry_run" does the same for one policy).
    actuate_dry_run: bool = False
    # Global guard: at most this many performed actions per
    # actuate_window_s across ALL policies — a misconfigured policy set
    # cannot thrash the serving engine. Reverts are never rate-limited.
    actuate_max_actions: int = 10
    actuate_window_s: float = 60.0
    # Hard cap any shed policy's fraction is clamped to — a
    # misconfigured policy can never shed a whole tenant (the serving
    # engine holds its own last-resort ceiling on top).
    shed_max_fraction: float = 0.5

    # --- SSE delta stream (tpumon.server, docs/perf.md) ---
    # The /api/stream push emits delta frames (only changed fields,
    # keyed by snapshot epoch); a full keyframe recurs every this many
    # frames so a desynced client is bounded. 1 = keyframe-only (the
    # pre-delta wire behavior, at full-payload cost per frame).
    sse_keyframe_every: int = 30
    # Directory where workloads self-report HBM/activity
    # (tpumon.collectors.workload) — the explicitly-labeled fallback
    # counter source when every platform source is dark. "" disables.
    # Default is uid-suffixed and ownership-checked (multi-user /tmp).
    workload_dir: str = _WORKLOAD_DEFAULT_DIR

    # --- topology expectations (for slice-failure alerting, SURVEY §2.2) ---
    # e.g. {"slice-0": 8} => alert critical if fewer chips report
    expected_slice_chips: Mapping[str, int] = field(default_factory=dict)

    # --- checkpoint/resume (SURVEY §5.4; tpumon.state) ---
    # Path for the monitor-state snapshot (ring history, alert timeline,
    # pod-transition baseline). None => reference behavior: state dies
    # with the process (monitor_server.js:157).
    state_path: str | None = None
    state_interval_s: float = 60.0

    # --- alert webhook sinks (tpumon.notify; reference has no alert
    # delivery — alerts live only as long as a browser polls) ---
    # URLs receive fired/resolved events as JSON POSTs; prefix "slack+"
    # (or use a hooks.slack.com URL) for Slack-message payloads.
    alert_webhooks: tuple[str, ...] = ()
    webhook_min_severity: str = "minor"  # minor | serious | critical
    webhook_timeout_s: float = 5.0

    # Per-request access logging (method path status ms) — SURVEY §5.1.
    access_log: bool = False

    # Bearer token gating the mutating/expensive routes (POST
    # /api/silence, /api/unsilence; GET /api/profile; GET
    # /api/query?fleet=1 — a distributed query fans sub-queries across
    # the whole federation tree per request). None (default)
    # keeps those routes open — reference parity (monitor_server.js:
    # 244-248 serves everything unauthenticated) — but the reference has
    # no mutating routes, so deployments that page off tpumon alerts
    # should set a token (TPUMON_AUTH_TOKEN) so network reach doesn't
    # equal silence-my-pager.
    auth_token: str | None = None

    thresholds: Thresholds = field(default_factory=Thresholds)

    def effective_cpu_count(self) -> int:
        return self.cpu_count or os.cpu_count() or 1


# Keys accepted from file / env and how to coerce them.
_SCALAR_FIELDS: dict[str, type] = {
    "port": int,
    "host": str,
    "prometheus_url": str,
    "sample_interval_s": float,
    "pods_interval_s": float,
    "serving_interval_s": float,
    "accel_backend": str,
    "cpu_count": int,
    "k8s_mode": str,
    "k8s_api_url": str,
    "state_path": str,
    "state_interval_s": float,
    "collect_deadline_s": float,
    "breaker_failures": int,
    "breaker_backoff_s": float,
    "breaker_backoff_max_s": float,
    "trace_ring": int,
    "events_ring": int,
    "events_path": str,
    "events_interval_s": float,
    "anomaly_detect": lambda v: str(v).lower() in ("1", "true", "yes", "on"),
    "anomaly_alpha": float,
    "anomaly_z_fire": float,
    "anomaly_z_clear": float,
    "anomaly_warmup": int,
    "chaos": str,
    "chaos_seed": int,
    "history_snapshot_path": str,
    "history_snapshot_interval_s": float,
    "history_snapshot_format": str,
    "history_per_chip": int,
    "peer_fanout": int,
    "peer_timeout_s": float,
    "wire_binary": lambda v: str(v).lower() in ("1", "true", "yes", "on"),
    "federation_role": str,
    "federate_up": str,
    "federation_node": str,
    "federation_keyframe_every": int,
    "federation_dark_after_s": float,
    "federation_peer": str,
    "federation_lease_s": float,
    "federation_initial_leader":
        lambda v: str(v).lower() in ("1", "true", "yes", "on"),
    "ingest_kernel": lambda v: str(v).lower() in ("1", "true", "yes", "on"),
    "query_fleet_timeout_s": float,
    "sse_keyframe_every": int,
    "actuate_dry_run": lambda v: str(v).lower() in ("1", "true", "yes", "on"),
    "actuate_max_actions": int,
    "actuate_window_s": float,
    "shed_max_fraction": float,
    "webhook_min_severity": str,
    "webhook_timeout_s": float,
    "access_log": lambda v: str(v).lower() in ("1", "true", "yes", "on"),
    "auth_token": str,
    "workload_dir": str,
    "tls_cert": str,
    "tls_key": str,
}
# Config-file/env key -> Config field for duration-valued settings
# ("30m"-style strings accepted via parse_duration).
_DURATION_KEYS = {
    "history_window": "history_window_s",
    "history_step": "history_step_s",
    "history_long_window": "history_long_window_s",
    "history_coarse_step": "history_coarse_step_s",
    "history_mid_step": "history_mid_step_s",
    "history_mid_window": "history_mid_window_s",
    "query_default_range": "query_default_range_s",
    "query_lookback": "query_lookback_s",
}
_LIST_FIELDS = {
    "collectors", "disk_mounts", "serving_targets", "peers",
    "alert_webhooks", "recording_rules",
}


def _coerce_thresholds(raw: Mapping[str, Any], base: Thresholds) -> Thresholds:
    kw: dict[str, Any] = {}
    for f in dataclasses.fields(Thresholds):
        if f.name not in raw:
            continue
        v = raw[f.name]
        is_trilevel = f.type in ("TriLevel", TriLevel)
        if isinstance(v, (list, tuple)):
            if not is_trilevel:
                raise ValueError(f"threshold {f.name}: want a single number, got {v!r}")
            if len(v) == 3:
                kw[f.name] = TriLevel(v[0], v[1], v[2])
            elif len(v) == 2:
                kw[f.name] = TriLevel(None, v[0], v[1])
            else:
                raise ValueError(f"threshold {f.name}: want 2 or 3 values, got {v!r}")
        elif is_trilevel:
            raise ValueError(
                f"threshold {f.name}: want [minor, serious, critical] or "
                f"[serious, critical], got {v!r}"
            )
        else:
            kw[f.name] = float(v)
    return dataclasses.replace(base, **kw) if kw else base


def _apply_mapping(cfg_kw: dict[str, Any], raw: Mapping[str, Any]) -> None:
    for key, value in raw.items():
        if key.startswith("_"):  # comment keys in config files
            continue
        if key in _SCALAR_FIELDS:
            cfg_kw[key] = None if value is None else _SCALAR_FIELDS[key](value)
        elif key in _DURATION_KEYS:
            cfg_kw[_DURATION_KEYS[key]] = parse_duration(value)
        elif key in _LIST_FIELDS:
            if isinstance(value, str):
                value = [v.strip() for v in value.split(",") if v.strip()]
            cfg_kw[key] = tuple(value)
        elif key == "expected_slice_chips":
            cfg_kw[key] = {str(k): int(v) for k, v in value.items()}
        elif key == "collect_deadlines":
            cfg_kw[key] = {str(k): float(v) for k, v in value.items()}
        elif key in ("slos", "actuations"):
            # SLO objectives (tpumon.slo, docs/slo.md) and actuation
            # policies (tpumon.actuate, docs/actuation.md): lists of
            # objects in config files; env/CLI pass the list as JSON.
            # Structural validation happens in slo.parse_slos /
            # actuate.parse_actuations at startup (per-entry,
            # journaled) — here we only coerce.
            if isinstance(value, str):
                value = json.loads(value) if value.strip() else []
            if not isinstance(value, (list, tuple)):
                raise ValueError(
                    f"{key}: want a list of objects, got {value!r}")
            cfg_kw[key] = tuple(value)
        elif key == "thresholds":
            cfg_kw["_thresholds_raw"] = value
        else:
            raise ValueError(f"unknown config key {key!r}")


def load_config(
    path: str | None = None,
    env: Mapping[str, str] | None = None,
    overrides: Mapping[str, Any] | None = None,
) -> Config:
    """Build a Config from defaults <- file <- env <- explicit overrides."""
    env = os.environ if env is None else env
    kw: dict[str, Any] = {}

    path = path or env.get("TPUMON_CONFIG")
    if path:
        with open(path, "rb") as f:
            if path.endswith(".toml"):
                import tomllib

                raw = tomllib.load(f)
            else:
                raw = json.load(f)
        _apply_mapping(kw, raw)

    env_raw: dict[str, Any] = {}
    for env_key, value in env.items():
        if not env_key.startswith("TPUMON_") or env_key == "TPUMON_CONFIG":
            continue
        key = env_key[len("TPUMON_") :].lower()
        env_raw[key] = value
    if env_raw:
        # Env values arrive as strings; mapping-valued keys as JSON.
        if "expected_slice_chips" in env_raw:
            env_raw["expected_slice_chips"] = json.loads(env_raw["expected_slice_chips"])
        if "collect_deadlines" in env_raw:
            env_raw["collect_deadlines"] = json.loads(env_raw["collect_deadlines"])
        if "thresholds" in env_raw:
            env_raw["thresholds"] = json.loads(env_raw["thresholds"])
        _apply_mapping(kw, env_raw)

    if overrides:
        _apply_mapping(kw, overrides)

    thresholds_raw = kw.pop("_thresholds_raw", None)
    cfg = Config(**kw)
    if thresholds_raw:
        cfg = dataclasses.replace(
            cfg, thresholds=_coerce_thresholds(thresholds_raw, cfg.thresholds)
        )
    return cfg
