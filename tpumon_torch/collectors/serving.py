"""LLM serving-metrics ingest (JetStream / MaxText).

The reference's tech-stack README names vLLM metric collection
(README.md:73) but ships no code for it (SURVEY §5.7); serving is only
visible as pods + GPU counters. tpumon makes serving ingest real and
TPU-native: scrape the Prometheus ``/metrics`` endpoints of JetStream /
MaxText JAX-serving processes and distill the panels the dashboard needs
— TTFT, token throughput, queue depth, request rate (BASELINE config 4).

Metric-name mapping is table-driven because serving stacks drift; each
target is matched against known families with sensible fallbacks, and
unknown deployments degrade to "target reachable, no recognized metrics"
rather than erroring.
"""

from __future__ import annotations

import asyncio
import time
import urllib.request
from dataclasses import dataclass, field

from tpumon_torch.collectors import Sample
from tpumon_torch.metrics_text import (
    histogram_quantile,
    parse_metrics_text,
    samples_by_name,
)

# Known metric families, in preference order per signal.
# JetStream server: https://github.com/AI-Hypercomputer/JetStream (public
# metric names); vLLM names kept as a compatibility fallback.
TTFT_HISTOGRAMS = (
    "jetstream_time_to_first_token",
    "jetstream_time_to_first_token_seconds",
    "vllm:time_to_first_token_seconds",
)
TPOT_HISTOGRAMS = (
    "jetstream_time_per_output_token",
    "vllm:time_per_output_token_seconds",
)
TOKEN_COUNTERS = (
    "jetstream_total_tokens_in_current_batch",
    "jetstream_generate_tokens",
    "jetstream_total_output_tokens",
    "vllm:generation_tokens",
)
QUEUE_GAUGES = (
    "jetstream_queue_size",
    "jetstream_transfer_backlog",
    "jetstream_prefill_backlog_size",
    "vllm:num_requests_waiting",
)
REQUEST_COUNTERS = (
    "jetstream_request_count",
    "jetstream_num_requests",
    "jetstream_request_success_count",
    "vllm:request_success",
)
SLOTS_GAUGES = (
    "jetstream_slots_used_percentage",
    "jetstream_slots_available",
)

# Training-job telemetry (tpumon.loadgen.train publishes these; any
# trainer exporting the same families joins the training panel).
TRAIN_GAUGES = {
    "train_step": "tpumon_train_step",
    "train_loss": "tpumon_train_loss",
    "train_goodput_pct": "tpumon_train_goodput_pct",
    "train_ckpt_step": "tpumon_train_checkpoint_step",
    "train_mfu_pct": "tpumon_train_mfu_pct",
}
TRAIN_STEP_TIME = "tpumon_train_step_time_seconds"
TRAIN_TOKEN_COUNTER = "tpumon_train_tokens_total"


def _sum_samples(by_name: dict, names: tuple[str, ...]) -> tuple[str, float] | None:
    """Sum a family's samples (all label sets), trying each known name
    and its prometheus-client counter form ``<name>_total`` — real
    JetStream/vLLM deployments expose counters with the _total suffix
    (pinned by the golden fixtures in tests/fixtures/)."""
    for name in names:
        for candidate in (name, name + "_total"):
            if candidate in by_name:
                return candidate, sum(s.value for s in by_name[candidate])
    return None


def _histogram_p(by_name: dict, names: tuple[str, ...], q: float):
    for name in names:
        bucket = by_name.get(name + "_bucket")
        if bucket:
            val = histogram_quantile(bucket, q)
            if val is not None:
                return name, val
    return None


def distill_serving_metrics(
    text: str, prev: dict | None = None, now: float | None = None
) -> dict:
    """Distill one target's exposition text into dashboard-ready fields.

    ``prev`` is the previous distilled dict (for counter-rate computation
    between scrapes).
    """
    now = time.time() if now is None else now
    by_name = samples_by_name(parse_metrics_text(text))
    out: dict = {"ts": now, "raw_families": len(by_name)}

    ttft = _histogram_p(by_name, TTFT_HISTOGRAMS, 0.5)
    if ttft:
        name, val = ttft
        # JetStream buckets are seconds; report ms.
        out["ttft_p50_ms"] = val * 1e3
        p99 = _histogram_p(by_name, TTFT_HISTOGRAMS, 0.99)
        if p99:
            out["ttft_p99_ms"] = p99[1] * 1e3
    tpot = _histogram_p(by_name, TPOT_HISTOGRAMS, 0.5)
    if tpot:
        out["tpot_p50_ms"] = tpot[1] * 1e3
    # Engine-native per-request quantile gauges (tpumon.loadgen.serving
    # metrics_text): recent-window TTFT/TPOT p50/p95 plus the scheduler
    # state — queue depth is above via QUEUE_GAUGES; in-prefill slots
    # are the interleaved scheduler's "admitted, not yet decoding"
    # count. Gauges win over the histogram-derived quantiles when both
    # are present (exact per-request sorts beat bucket interpolation).
    for metric, field_name in (
        ("tpumon_serving_ttft_p50_ms", "ttft_p50_ms"),
        ("tpumon_serving_ttft_p95_ms", "ttft_p95_ms"),
        ("tpumon_serving_tpot_p50_ms", "tpot_p50_ms"),
        ("tpumon_serving_tpot_p95_ms", "tpot_p95_ms"),
        ("tpumon_serving_slots_prefill", "slots_prefill"),
    ):
        got = _sum_samples(by_name, (metric,))
        if got:
            out[field_name] = got[1]

    tokens = _sum_samples(by_name, TOKEN_COUNTERS)
    if tokens:
        out["tokens_total"] = tokens[1]
        if prev and "tokens_total" in prev and prev["ts"] < now:
            delta = tokens[1] - prev["tokens_total"]
            if delta >= 0:
                out["tokens_per_sec"] = delta / (now - prev["ts"])

    requests = _sum_samples(by_name, REQUEST_COUNTERS)
    if requests:
        out["requests_total"] = requests[1]
        if prev and "requests_total" in prev and prev["ts"] < now:
            delta = requests[1] - prev["requests_total"]
            if delta >= 0:
                out["requests_per_sec"] = delta / (now - prev["ts"])

    queue = _sum_samples(by_name, QUEUE_GAUGES)
    if queue:
        out["queue_depth"] = queue[1]
    slots = _sum_samples(by_name, SLOTS_GAUGES)
    if slots:
        out["slots"] = slots[1]
    weights = _sum_samples(by_name, ("tpumon_serving_weight_bytes",))
    if weights:
        out["weight_bytes"] = weights[1]  # drops ~4x when served int8
    # Speculative decoding acceptance (tpumon.loadgen.speculative):
    # windowed between scrapes via counter deltas (so the value tracks
    # CURRENT acceptance, matching the PromQL rate-ratio semantics of
    # the history series); lifetime ratio on the first scrape. Idle
    # windows (no new proposals) omit the field rather than repeat a
    # stale number.
    spec_prop = _sum_samples(by_name, ("tpumon_serving_spec_proposed",))
    spec_acc = _sum_samples(by_name, ("tpumon_serving_spec_accepted",))
    if spec_prop and spec_acc:
        out["spec_proposed_total"] = spec_prop[1]
        out["spec_accepted_total"] = spec_acc[1]
        if prev and "spec_proposed_total" in prev:
            dp = spec_prop[1] - prev["spec_proposed_total"]
            da = spec_acc[1] - prev["spec_accepted_total"]
            if dp > 0 and 0 <= da <= dp:
                out["spec_accept_pct"] = 100.0 * da / dp
        elif spec_prop[1] > 0:
            out["spec_accept_pct"] = 100.0 * spec_acc[1] / spec_prop[1]
    # Prefix-cache hit rate (tpumon.loadgen.prefix_cache / the paged
    # page-sharing cache): windowed like spec acceptance — the value
    # tracks CURRENT traffic, not the lifetime average.
    pf_hits = _sum_samples(by_name, ("tpumon_serving_prefix_hits",))
    pf_miss = _sum_samples(by_name, ("tpumon_serving_prefix_misses",))
    if pf_hits and pf_miss:
        out["prefix_hits_total"] = pf_hits[1]
        out["prefix_misses_total"] = pf_miss[1]
        if prev and "prefix_hits_total" in prev:
            dh = pf_hits[1] - prev["prefix_hits_total"]
            dm = pf_miss[1] - prev["prefix_misses_total"]
            if dh >= 0 and dm >= 0 and dh + dm > 0:
                out["prefix_hit_pct"] = 100.0 * dh / (dh + dm)
        elif pf_hits[1] + pf_miss[1] > 0:
            out["prefix_hit_pct"] = (
                100.0 * pf_hits[1] / (pf_hits[1] + pf_miss[1]))
    # Paged KV pool occupancy (tpumon.loadgen.paged_kv): reserved pages
    # over the pool — the engine's KV-memory pressure signal.
    pg_total = _sum_samples(by_name, ("tpumon_serving_kv_pages_total",))
    pg_free = _sum_samples(by_name, ("tpumon_serving_kv_pages_free",))
    if pg_total and pg_total[1] > 0 and pg_free:
        out["kv_pages_total"] = pg_total[1]
        out["kv_pages_used_pct"] = (
            100.0 * (pg_total[1] - pg_free[1]) / pg_total[1])

    # Per-tenant serving signals (tpumon.loadgen.traffic / ServingEngine
    # tenant accounting): the SLO engine's raw material. Latency
    # quantiles copy through; goodput (completed req/s) and error rate
    # (rejected / submitted) are windowed between scrapes via counter
    # deltas, so they track CURRENT traffic like the other rates here.
    tenants: dict[str, dict] = {}
    for metric, field_name in (
        ("tpumon_serving_tenant_ttft_p50_ms", "ttft_p50_ms"),
        ("tpumon_serving_tenant_ttft_p95_ms", "ttft_p95_ms"),
        ("tpumon_serving_tenant_tpot_p50_ms", "tpot_p50_ms"),
        ("tpumon_serving_tenant_tpot_p95_ms", "tpot_p95_ms"),
        ("tpumon_serving_tenant_requests", "requests_total"),
        ("tpumon_serving_tenant_completed", "completed_total"),
        ("tpumon_serving_tenant_rejected", "rejected_total"),
        ("tpumon_serving_tenant_shed", "shed_total"),
    ):
        for candidate in (metric, metric + "_total"):
            for s in by_name.get(candidate, ()):
                tenant = s.labels.get("tenant")
                if tenant:
                    tenants.setdefault(tenant, {})[field_name] = s.value
            if candidate in by_name:
                break
    if tenants:
        prev_tenants = (prev or {}).get("tenants") or {}
        for tenant, row in tenants.items():
            was = prev_tenants.get(tenant)
            dt = (now - prev["ts"]) if prev and prev.get("ts") else 0.0
            if was and dt > 0 and "completed_total" in row and (
                    "completed_total" in was):
                dc = row["completed_total"] - was["completed_total"]
                if dc >= 0:
                    row["goodput_rps"] = dc / dt
            if was and "requests_total" in row and "requests_total" in was:
                dreq = row["requests_total"] - was["requests_total"]
                drej = (row.get("rejected_total", 0)
                        - was.get("rejected_total", 0))
                # Sheds leave BOTH sides of the error-rate fraction
                # (tpumon.actuate): a shed is the remedy for an SLO
                # burn — counting it as an error would re-fire the
                # very SLO that triggered the shed, and leaving it in
                # the denominator would dilute the real error rate of
                # the traffic that actually ran.
                dshed = (row.get("shed_total", 0)
                         - was.get("shed_total", 0))
                deff = dreq - max(0, dshed)
                if deff > 0 and 0 <= drej <= deff:
                    row["error_rate"] = drej / deff
                elif deff == 0 and drej == 0:
                    # Idle window: no submissions, nothing erred.
                    row["error_rate"] = 0.0
        out["tenants"] = tenants

    # Per-replica mesh-serving gauges (tpumon.loadgen.serving
    # MeshServingEngine, docs/perf.md "Mesh serving"): one row per dp
    # replica — free slots, router-assigned queue depth and the
    # recent-window latency p95s — distilled verbatim so the sampler
    # can land serving.<replica>.* TSDB series for per-replica SLOs
    # and the actuation drain verbs.
    replicas: dict[str, dict] = {}
    for metric, field_name in (
        ("tpumon_serving_replica_slots_available", "slots_available"),
        ("tpumon_serving_replica_queue_size", "queue_depth"),
        ("tpumon_serving_replica_ttft_p95_ms", "ttft_p95_ms"),
        ("tpumon_serving_replica_tpot_p95_ms", "tpot_p95_ms"),
    ):
        for s in by_name.get(metric, ()):
            replica = s.labels.get("replica")
            if replica:
                replicas.setdefault(replica, {})[field_name] = s.value
    if replicas:
        out["replicas"] = replicas

    # Training targets (tpumon_train_* families).
    for field_name, metric in TRAIN_GAUGES.items():
        got = _sum_samples(by_name, (metric,))
        if got:
            out[field_name] = got[1]
    step_time = _sum_samples(by_name, (TRAIN_STEP_TIME,))
    if step_time:
        out["train_step_time_ms"] = step_time[1] * 1e3
    train_tokens = _sum_samples(by_name, (TRAIN_TOKEN_COUNTER,))
    if train_tokens:
        out["train_tokens_total"] = train_tokens[1]
        if prev and "train_tokens_total" in prev and prev["ts"] < now:
            delta = train_tokens[1] - prev["train_tokens_total"]
            if delta >= 0:
                out["train_tokens_per_sec"] = delta / (now - prev["ts"])
    return out


def _fake_exposition(now: float | None = None) -> str:
    """Synthetic JetStream /metrics for demo mode: counters advance with
    wall time so rates and quantiles look alive (exercises the same
    distillation path as a real target)."""
    import math

    t = time.time() if now is None else now
    tokens = int(900 * t + 4000 * math.sin(t / 60))  # ~900 tok/s ± wobble
    requests = int(t / 2)
    queue = max(0, int(6 + 5 * math.sin(t / 45)))
    # TTFT histogram drifting between ~40 and ~90 ms p50
    shift = (math.sin(t / 120) + 1) / 2  # 0..1
    b1 = int(2000 + 500 * (1 - shift))
    b2 = int(5500 + 1500 * (1 - shift))
    total = 8000
    return f"""\
# TYPE jetstream_time_to_first_token histogram
jetstream_time_to_first_token_bucket{{le="0.025"}} {b1}
jetstream_time_to_first_token_bucket{{le="0.05"}} {b2}
jetstream_time_to_first_token_bucket{{le="0.1"}} {int(total * 0.97)}
jetstream_time_to_first_token_bucket{{le="0.5"}} {total}
jetstream_time_to_first_token_bucket{{le="+Inf"}} {total}
# TYPE jetstream_generate_tokens counter
jetstream_generate_tokens {tokens}
# TYPE jetstream_request_count counter
jetstream_request_count {requests}
# TYPE jetstream_queue_size gauge
jetstream_queue_size {queue}
# accepted integrates its wobbling rate so the counter stays monotonic
# (rate()-safe); kv_pages_free floors at 15/96 so demo occupancy never
# crosses the 85% pressure alert threshold (no demo alert flapping).
# TYPE tpumon_serving_spec_proposed counter
tpumon_serving_spec_proposed {int(t * 40)}
# TYPE tpumon_serving_spec_accepted counter
tpumon_serving_spec_accepted {int(35.2 * t - 180 * math.cos(t / 75))}
# TYPE tpumon_serving_kv_pages_total gauge
tpumon_serving_kv_pages_total 96
# TYPE tpumon_serving_kv_pages_free gauge
tpumon_serving_kv_pages_free {max(15, int(45 + 28 * math.sin(t / 50)))}
"""


def _fake_train_exposition(now: float | None = None) -> str:
    """Synthetic trainer /metrics for demo mode: a 2k-step epoch loop
    with decaying loss, steady step time, periodic checkpoints."""
    import math

    t = time.time() if now is None else now
    step = int(t / 0.4) % 2000  # ~2.5 steps/s, "epoch" wraps
    loss = 6.0 * math.exp(-step / 600) + 1.8 + 0.05 * math.sin(t / 7)
    tokens = int(t * 1280)  # batch*seq per step at the same cadence
    return f"""\
# TYPE tpumon_train_step gauge
tpumon_train_step {step}
# TYPE tpumon_train_loss gauge
tpumon_train_loss {loss:.4f}
# TYPE tpumon_train_step_time_seconds gauge
tpumon_train_step_time_seconds {0.4 + 0.02 * math.sin(t / 11):.4f}
# TYPE tpumon_train_tokens_total counter
tpumon_train_tokens_total {tokens}
# TYPE tpumon_train_goodput_pct gauge
tpumon_train_goodput_pct {92 + 4 * math.sin(t / 90):.2f}
# TYPE tpumon_train_mfu_pct gauge
tpumon_train_mfu_pct {46 + 3 * math.sin(t / 60):.2f}
# TYPE tpumon_train_checkpoint_step gauge
tpumon_train_checkpoint_step {max(0, (step // 100) * 100)}
"""


@dataclass
class ServingCollector:
    targets: tuple[str, ...] = ()
    name: str = "serving"
    timeout_s: float = 3.0
    _prev: dict[str, dict] = field(default_factory=dict)

    def _fetch(self, url: str) -> str:
        if url == "fake:trainer":
            return _fake_train_exposition()
        if url.startswith("fake:"):
            return _fake_exposition()
        if not url.startswith(("http://", "https://")):
            url = f"http://{url}"
        if not url.rstrip("/").endswith("/metrics"):
            url = url.rstrip("/") + "/metrics"
        with urllib.request.urlopen(url, timeout=self.timeout_s) as r:
            return r.read().decode("utf-8", errors="replace")

    async def _collect_one(self, target: str) -> dict:
        try:
            text = await asyncio.to_thread(self._fetch, target)
            distilled = distill_serving_metrics(text, prev=self._prev.get(target))
            self._prev[target] = distilled
            return {"target": target, "ok": True, **distilled}
        except Exception as e:
            return {
                "target": target,
                "ok": False,
                "error": f"{type(e).__name__}: {e}",
            }

    async def collect(self) -> Sample:
        if not self.targets:
            return Sample(
                source=self.name, ok=True, data=[], error="no serving targets configured"
            )
        results = await asyncio.gather(*(self._collect_one(t) for t in self.targets))
        ok = all(r.get("ok") for r in results)
        errors = "; ".join(
            f"{r['target']}: {r['error']}" for r in results if not r.get("ok")
        )
        return Sample(source=self.name, ok=ok, data=list(results), error=errors or None)
