"""The port's sampler and the engines it drives against the reference's.

Two Samplers, the port's and the reference's, tick in lockstep over the
same fake collectors (each package's own fake accelerator collector, and
host and serving sources that give both the same readings a tick) with
a patched clock: ``time.time`` is the tick's wall clock, and
``time.perf_counter`` and ``time.monotonic`` advance a fixed step a call,
so the tick durations and scrape latencies the anomaly detectors read
are the same in both. Recording rules, an SLO and two actuation policies
are configured; each package's ActuationEngine drives its own serving
engine (the port's on the CPU, the reference's in JAX). After every tick
the ring's series, the event journal (alert timeline, SLO, anomaly and
actuation events), the alert state, the SLO budgets and burns, the
anomaly detectors, the actuation table, the engines' shed and
capacity values, the tracer's stage table and the section deltas must be
equal, and so must the journal and history files a restart reads.
"""

import asyncio
import itertools
import json
import threading
import time

import numpy as np
import pytest

from tests.test_host_collector import STAT_T1, make_proc
from tests.torch_parity import bridged_params
from tpumon import actuate as ref_actuate
from tpumon import collectors as ref_collectors
from tpumon import deltas as ref_deltas
from tpumon import sampler as ref_sampler
from tpumon.events import EventLog as RefEventLog
from tpumon.history import HistorySnapshotter as RefSnapshotter
from tpumon.collectors import accel_fake as ref_accel_fake
from tpumon.collectors import gpu_fake as ref_gpu_fake
from tpumon.collectors import host as ref_host
from tpumon.config import load_config as ref_load_config
from tpumon.loadgen import serving as jax_serving
from tpumon.loadgen.model import ModelConfig as JaxModelConfig
from tpumon_torch import actuate, collectors, deltas, sampler
from tpumon_torch.events import EventLog
from tpumon_torch.history import HistorySnapshotter
from tpumon_torch.collectors import accel_fake, gpu_fake, host
from tpumon_torch.config import load_config
from tpumon_torch.loadgen import serving
from tpumon_torch.loadgen.model import ModelConfig, params_from_jax

T0 = 1_700_000_430.0  # fake:+faults' chip 3 link episode starts at tick 30
TICKS = 60
STORM = range(20, 38)  # ticks the serving stub reports an overload

SLOS = [{"name": "chat_ttft", "tenant": "chat",
         "expr": 'serving.ttft_p95_ms{tenant="chat"} > 500',
         "target": 0.99, "window": "1h", "fast": ["5s", "20s"],
         "slow": ["10s", "40s"]}]
ACTUATIONS = [
    {"name": "shed_chat", "when": 'slo.paging{slo="chat_ttft"} > 0',
     "action": "shed", "tenant": "chat", "fraction": 0.5, "cooldown_s": 0,
     "fire_hold": 1, "clear_hold": 3},
    {"name": "grow_budget", "when": "avg_over_time(queue_depth[10s]) > 10",
     "action": "capacity", "prefill_budget": 4, "cooldown_s": 0,
     "fire_hold": 2, "clear_hold": 2},
]
SMALL = dict(vocab=128, d_model=64, n_layers=1, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=64, compute_dtype="float32")

PORT = dict(load_config=load_config, Sampler=sampler.Sampler,
            Sample=collectors.Sample, fake=accel_fake.FakeTpuCollector,
            gpufake=gpu_fake.FakeGpuCollector,
            EngineActuator=actuate.EngineActuator)
REF = dict(load_config=ref_load_config, Sampler=ref_sampler.Sampler,
           Sample=ref_collectors.Sample,
           fake=ref_accel_fake.FakeTpuCollector,
           gpufake=ref_gpu_fake.FakeGpuCollector,
           EngineActuator=ref_actuate.EngineActuator)


class Clock:
    """The tick's wall clock, and a step-a-call perf/monotonic clock for
    the test's thread (other threads of the process read the real one)."""

    def __init__(self):
        self.now = T0
        self._calls = itertools.count()
        self._owner = threading.get_ident()
        self._real = time.perf_counter

    def wall(self) -> float:
        return self.now

    def step(self) -> float:
        if threading.get_ident() != self._owner:
            return self._real()
        return next(self._calls) * 0.0005


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "time", c.wall)
    monkeypatch.setattr(time, "perf_counter", c.step)
    monkeypatch.setattr(time, "monotonic", c.step)
    return c


class StubHost:
    """Host readings that move with the tick: cpu, memory, disk, net."""

    name = "host"

    def __init__(self, pkg, clock):
        self.pkg, self.clock = pkg, clock

    async def collect(self):
        k = self.clock.now - T0
        data = {
            "cpu": {"load_1min": 1.5, "cores": 8,
                    "percent": round(30 + 20 * np.sin(k / 7), 1)},
            "memory": {"total": 64 << 30, "used": int((20 + k) * 2**28),
                       "available": 1 << 30,
                       "percent": round(30 + k / 3, 1)},
            "disk": {"total": 1 << 40, "used": 1 << 39, "percent": 50.0},
            "net": {"rx_bytes": int(1e9 + 3e6 * k), "tx_bytes": int(2e9 + 5e6 * k)},
        }
        return self.pkg["Sample"](source="host", ok=True, data=data,
                                  ts=self.clock.now)


class StubServing:
    """One serving target whose chat tenant overloads during STORM."""

    name = "serving"

    def __init__(self, pkg, clock):
        self.pkg, self.clock = pkg, clock

    async def collect(self):
        k = int(self.clock.now - T0)
        storm = k in STORM
        row = {
            "target": "http://stub/metrics", "ok": True,
            "tokens_per_sec": 1000.0 + 7.5 * k - (400.0 if storm else 0.0),
            "ttft_p50_ms": 900.0 if storm else 120.0 + k % 5,
            "queue_depth": 30.0 if storm else float(k % 3),
            "tpot_p95_ms": 40.0 + (k % 4),
            "kv_pages_used_pct": 50.0 + k % 10,
            "tenants": {
                "chat": {"ttft_p95_ms": 1200.0 if storm else 150.0,
                         "tpot_p95_ms": 45.0, "goodput_rps": 3.0,
                         "error_rate": 0.1 if storm else 0.0},
                "rag": {"ttft_p95_ms": 300.0, "tpot_p95_ms": 50.0,
                        "goodput_rps": 1.0, "error_rate": 0.0},
                "bad.tenant": {"ttft_p95_ms": 1.0},
            },
        }
        return self.pkg["Sample"](source="serving", ok=True, data=[row],
                                  ts=self.clock.now)


@pytest.fixture(scope="module")
def weights():
    return bridged_params(JaxModelConfig(**SMALL), seed=5)


def engines(weights):
    """(port engine on the CPU, reference engine), same weights."""
    kw = {"slots": 2, "prefill_len": 8}
    return (serving.ServingEngine(
                cfg=serving.ServeConfig(model=ModelConfig(**SMALL), **kw),
                params=params_from_jax(weights[1]), seed=3, device="cpu"),
            jax_serving.ServingEngine(
                cfg=jax_serving.ServeConfig(model=JaxModelConfig(**SMALL),
                                            **kw),
                params=weights[0], seed=3))


def build(pkg, backend: str, clock, engine):
    cfg = pkg["load_config"](env={
        "TPUMON_COLLECTORS": "host,accel,serving",
        "TPUMON_ACCEL_BACKEND": backend,
        "TPUMON_RECORDING_RULES": "chip.mxu[5m],chip.hbm[5m]",
        "TPUMON_HISTORY_PER_CHIP": "6",
        "TPUMON_SLOS": json.dumps(SLOS),
        "TPUMON_ACTUATIONS": json.dumps(ACTUATIONS),
        "TPUMON_ANOMALY_WARMUP": "10",
        "TPUMON_ANOMALY_Z_FIRE": "2.5",
        # Collect unbounded: a deadline would put asyncio timers on the
        # patched monotonic clock.
        "TPUMON_COLLECT_DEADLINE_S": "0",
    })
    kind, spec = backend.split(":", 1)
    faults = spec.endswith("+faults")
    accel = pkg[kind](topology=spec.removesuffix("+faults"),
                      fault_episodes=faults, clock=clock.wall)
    s = pkg["Sampler"](cfg, host=StubHost(pkg, clock), accel=accel,
                       serving=StubServing(pkg, clock))
    s.actuate.bind_engine(engine)
    return s


def state(s, engine) -> dict:
    """Everything the lockstep compares, from one sampler and its engine."""
    return {
        "series": sorted(s.history.series),
        "points": s.history.dump_points(),
        "coarse": s.history.dump_coarse(),
        "events": s.journal.events(),
        "alerts": s.engine.to_state(),
        "active": sorted(s.engine._active_keys),
        "slo": s.slo.to_json(),
        "anomaly": s.anomaly.to_json(),
        "actuate": s.actuate.to_json(),
        "shed": dict(engine._shed),
        "capacity": (engine.cfg.prefill_chunk_budget,
                     engine.cfg.admit_lookahead),
        "net": s.net_rates, "ici": s.ici_rates,
        "tracked": sorted(s._perchip_tracked),
        "skipped": sorted(s._perchip_skipped),
        "epoch": s.clock.to_json(),
        "stages": s.tracer.stage_summary(),
    }


@pytest.mark.parametrize("backend", ["fake:v5e-8", "fake:v5e-8+faults",
                                     "gpufake:dgx-h100-8"])
def test_lockstep_sampler_equals_reference(weights, clock, tmp_path,
                                           backend):
    port_engine, ref_engine = engines(weights)
    port = build(PORT, backend, clock, port_engine)
    ref = build(REF, backend, clock, ref_engine)
    assert isinstance(port.actuate.actuator, actuate.EngineActuator)
    assert port.actuate.actuator.engine is port_engine

    async def run():
        prev = None
        for tick in range(TICKS):
            clock.now = T0 + tick
            await port.tick_all()
            await ref.tick_all()
            a, b = (json.loads(json.dumps(state(*x)))
                    for x in ((port, port_engine), (ref, ref_engine)))
            assert a == b, f"tick {tick}: " + ", ".join(
                k for k in a if a[k] != b[k])
            if prev is not None:  # the SSE stream's section deltas
                d = deltas.diff(prev, a)
                assert d == ref_deltas.diff(prev, b)
                assert deltas.apply_delta(json.loads(json.dumps(prev)),
                                          d) == a
            prev = a

    asyncio.run(run())
    # The scenario reached every engine under comparison.
    kinds = {e["kind"] for e in port.journal.events()}
    assert {"alert", "slo", "actuate", "anomaly"} <= kinds, kinds
    fired = [e for e in port.journal.events()
             if e["kind"] == "actuate" and e.get("state") == "fired"]
    assert {e["policy"] for e in fired} == {"shed_chat", "grow_budget"}
    assert port.history.rules is not None
    h_port, h_ref = port.health_json(), ref.health_json()
    for key in ("snapshot", "events", "anomaly", "slo", "actuate"):
        assert h_port[key] == h_ref[key], key
    assert h_port["history"]["ingest_kernel"] is True
    assert h_port["history"]["ingest_kernel_error"] is None
    # What a restart restores from: the journal's JSONL and the ring's
    # binary snapshot, byte for byte.
    files = []
    for log, snap, s in ((EventLog, HistorySnapshotter, port),
                         (RefEventLog, RefSnapshotter, ref)):
        d = tmp_path / type(s).__module__
        d.mkdir()
        assert log(s.journal, str(d / "events.jsonl")).save()
        assert snap(s.history, str(d / "history.bin")).save()
        files.append([(d / f).read_bytes()
                      for f in ("events.jsonl", "history.bin")])
    assert files[0] == files[1]


@pytest.mark.parametrize("verbs", [
    [("shed", "chat", 0.5), ("shed", "*", 0.99), ("capacity",),
     ("nudge", 3, 2), ("capacity",), ("unshed", "chat"),
     ("set_slices", ["s0", "s1"]), ("drain", "s1"), ("undrain", "s1")],
])
def test_port_engine_actuator_equals_reference(weights, verbs):
    """The port's EngineActuator on the port's engine and the
    reference's on the JAX engine: every verb returns the same value and
    leaves the same shed, capacity and drain state."""
    port_engine, ref_engine = engines(weights)
    a = actuate.EngineActuator(port_engine)
    b = ref_actuate.EngineActuator(ref_engine)
    for name, *args in verbs:
        assert getattr(a, name)(*args) == getattr(b, name)(*args), name
        assert port_engine._shed == ref_engine._shed
        assert port_engine._drained == ref_engine._drained
        assert port_engine.slices == ref_engine.slices
        assert a.capacity() == b.capacity()


@pytest.mark.parametrize("use_native", [False, True])
def test_host_collector_equals_reference(tmp_path, use_native):
    """Both packages' HostCollector over the same /proc fixture: cpu
    (first sample and the delta after it), memory and net are equal;
    disk is read from the same mount."""
    proc = make_proc(tmp_path)
    kw = dict(cpu_count=8, proc_root=proc, disk_mounts=(str(tmp_path),),
              use_native=use_native)
    a, b = host.HostCollector(**kw), ref_host.HostCollector(**kw)
    assert a.native_active == b.native_active
    for _ in range(2):
        sa, sb = asyncio.run(a.collect()), asyncio.run(b.collect())
        assert sa.ok and sb.ok
        for key in ("cpu", "memory", "net"):
            assert sa.data[key] == sb.data[key], key
        assert sa.data["disk"]["total"] == sb.data["disk"]["total"]
        (tmp_path / "stat").write_text(STAT_T1)


SAMPLER_FIELDS = ("history_per_chip", "recording_rules", "slos", "actuations",
                  "anomaly_detect", "anomaly_alpha", "anomaly_z_fire",
                  "anomaly_z_clear", "anomaly_warmup", "events_ring",
                  "ingest_kernel", "trace_ring", "sample_interval_s",
                  "serving_interval_s", "history_window_s",
                  "collect_deadline_s", "breaker_failures", "thresholds",
                  "actuate_dry_run", "actuate_max_actions",
                  "actuate_window_s", "shed_max_fraction")


@pytest.mark.parametrize("env", [
    {},
    {"TPUMON_HISTORY_PER_CHIP": "256", "TPUMON_INGEST_KERNEL": "off",
     "TPUMON_RECORDING_RULES": "chip.mxu[5m], chip.hbm[5m]",
     "TPUMON_EVENTS_RING": "64", "TPUMON_ANOMALY_DETECT": "0",
     "TPUMON_ANOMALY_Z_FIRE": "3.5", "TPUMON_SLOS": json.dumps(SLOS),
     "TPUMON_ACTUATIONS": json.dumps(ACTUATIONS),
     "TPUMON_SERVING_INTERVAL_S": "1"},
])
def test_config_the_sampler_reads_parses_as_the_reference(env):
    """Every Config field the sampler and its engines read parses to the
    reference's value from the same environment."""
    a, b = load_config(env=env), ref_load_config(env=env)
    for name in SAMPLER_FIELDS:
        assert repr(getattr(a, name)) == repr(getattr(b, name)), name
