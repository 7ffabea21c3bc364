"""The port's collector layer against the reference's, on the same inputs.

``tpumon_torch`` carries copies of the monitor's modules that touch no
JAX (``resilience``, ``collectors``, ``topology``, ``config``, the GPU
collectors and fakes, the serving collector, the parser half of
``metrics_text`` and the reader half of ``collectors/workload``) and its
own accelerator factory. Each case below runs the same inputs through
both packages and compares the results as plain data: chips by their
JSON, dataclasses field by field.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import random

import pytest

pytest.importorskip("torch")

from tests.test_gpu_collector import DCGM_OUTPUT, SMI_OUTPUT  # noqa: E402
from tpumon import config as ref_config  # noqa: E402
from tpumon import metrics_text as ref_text  # noqa: E402
from tpumon import resilience as ref_res  # noqa: E402
from tpumon import topology as ref_topo  # noqa: E402
from tpumon.collectors import accel as ref_accel  # noqa: E402
from tpumon.collectors import accel_fake as ref_fake  # noqa: E402
from tpumon.collectors import gpu as ref_gpu  # noqa: E402
from tpumon.collectors import gpu_fake as ref_gpu_fake  # noqa: E402
from tpumon.collectors import run_collector as ref_run  # noqa: E402
from tpumon.collectors import serving as ref_serving  # noqa: E402
from tpumon.collectors import workload as ref_workload  # noqa: E402
from tpumon_torch import config as port_config  # noqa: E402
from tpumon_torch import metrics_text as port_text  # noqa: E402
from tpumon_torch import resilience as port_res  # noqa: E402
from tpumon_torch import topology as port_topo  # noqa: E402
from tpumon_torch.collectors import accel as port_accel  # noqa: E402
from tpumon_torch.collectors import accel_fake as port_fake  # noqa: E402
from tpumon_torch.collectors import gpu as port_gpu  # noqa: E402
from tpumon_torch.collectors import gpu_fake as port_gpu_fake  # noqa: E402
from tpumon_torch.collectors import run_collector as port_run  # noqa: E402
from tpumon_torch.collectors import serving as port_serving  # noqa: E402
from tpumon_torch.collectors import workload as port_workload  # noqa: E402
from tpumon_torch.collectors.accel_cuda import CudaGpuCollector  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig  # noqa: E402
from tpumon_torch.loadgen.report import WorkloadReporter  # noqa: E402
from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine  # noqa: E402

T0 = 1_753_900_000.0  # the pinned clock of the fake collectors


def plain(x):
    """Chips, samples and other dataclasses as comparable plain data."""
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if hasattr(x, "to_json"):
        return x.to_json()
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


# ------------------------------------------------------------ topology

def chips(topo, mod=port_topo, n=6):
    """A mixed list of chips over two slices and three hosts."""
    out = []
    for i in range(n):
        out.append(mod.ChipSample(
            chip_id=f"h{i % 3}/chip-{i}", host=f"h{i % 3}",
            slice_id=f"s{i % 2}", index=i, kind=topo,
            coords=(i, i % 2), mxu_duty_pct=None if i == 2 else 10.0 * i,
            hbm_used=i * 2**30, hbm_total=16 * 2**30,
            temp_c=40.0 + i, ici_tx_bytes=i * 1000, ici_rx_bytes=None,
            ici_link_up=i != 4, ici_link_health=7 if i == 4 else 0,
            throttle_score=i % 3, counter_source="nvml",
            accel_kind="gpu" if i % 2 else "tpu"))
    return out


def test_chip_json_and_derived_fields():
    got, want = chips("h100"), chips("h100", ref_topo)
    assert plain(got) == plain(want)
    assert [c.hbm_pct for c in got] == [c.hbm_pct for c in want]


def test_wire_round_trip():
    ref_chips = chips("v5e", ref_topo)
    payload = port_topo.chips_to_wire(chips("v5e"))
    assert payload == ref_topo.chips_to_wire(ref_chips)
    assert port_topo.wire_columns(payload) == ref_topo.wire_columns(payload)
    assert plain(port_topo.chips_from_wire(payload)) == plain(ref_chips)
    # A sender with an extra field and one missing: the tolerant path.
    fields = [f for f in payload["fields"] if f != "temp_c"] + ["future"]
    rows = [[v for f, v in zip(payload["fields"], r) if f != "temp_c"]
            + ["x"] for r in payload["rows"]]
    odd = {"v": payload["v"], "fields": fields, "rows": rows}
    assert plain(port_topo.chips_from_wire(odd)) == plain(
        ref_topo.chips_from_wire(odd))
    with pytest.raises(ValueError):
        port_topo.chips_from_wire({"v": 999, "fields": [], "rows": []})


def test_slice_views_and_pods():
    expected = {"s0": 4, "s1": 3, "s9": 2}
    got = port_topo.slice_views(chips("v5p"), expected)
    want = ref_topo.slice_views(chips("v5p", ref_topo), expected)
    assert [v.to_json() for v in got] == [v.to_json() for v in want]
    for attr in ("mxu_duty_pct", "hbm_used", "temp_c"):
        assert [(v.mean(attr), v.max(attr), v.p95(attr)) for v in got] == [
            (v.mean(attr), v.max(attr), v.p95(attr)) for v in want]
    pods = [{"node": "h0", "namespace": "a", "name": "p", "tpu_request": 1},
            {"node": "h0", "namespace": "a", "name": "q", "tpu_request": 2},
            {"node": "h1", "namespace": "b", "name": "r", "tpu_request": 4}]
    assert port_topo.attribute_pods(chips("v5p"), pods) == \
        ref_topo.attribute_pods(chips("v5p", ref_topo), pods)


@pytest.mark.parametrize("kind", ["TPU v5 lite", "TPU v5p", "TPU v4",
                                  "TPU v6 lite", "NVIDIA H100 80GB HBM3"])
def test_kind_vocabulary(kind):
    assert port_topo.normalize_chip_kind(kind) == \
        ref_topo.normalize_chip_kind(kind)
    assert port_gpu.normalize_gpu_kind(kind) == \
        ref_gpu.normalize_gpu_kind(kind)
    for family in ("tpu", "gpu", None):
        assert port_topo.accel_terms(family) == ref_topo.accel_terms(family)


# ------------------------------------------------------------ resilience

class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def breaker_trace(mod) -> list:
    """A breaker through closed -> open -> half-open -> open (doubled
    backoff) -> half-open -> closed under a fake clock and seeded rng:
    each poll is (allowed, state after) with the outcome recorded only
    when allowed."""
    clock = Clock()
    b = mod.CircuitBreaker(failure_threshold=2, base_backoff_s=4.0,
                           max_backoff_s=10.0, clock=clock,
                           rng=random.Random(7))
    trace = []
    for step in ("fail", "fail", "fail", "wait", "fail", "wait", "fail",
                 "wait", "ok", "fail"):
        if step == "wait":
            clock.t += 6.0
            continue
        allowed = b.allow()
        if allowed:
            b.record(step == "ok")
        trace.append((step, allowed, b.to_json()))
    return trace


def test_circuit_breaker_transitions():
    got = breaker_trace(port_res)
    assert got == breaker_trace(ref_res)
    assert [t[2]["state"] for t in got] == [
        "closed", "open", "open", "open", "open", "closed", "closed"]
    assert [t[1] for t in got] == [True, True, False, True, False, True,
                                   True]


def test_decorrelated_jitter_and_watchdog():
    got = [port_res.decorrelated_jitter(p, rng=random.Random(3))
           for p in (0.1, 1.0, 4.0, 100.0)]
    want = [ref_res.decorrelated_jitter(p, rng=random.Random(3))
            for p in (0.1, 1.0, 4.0, 100.0)]
    assert got == want
    dogs = []
    for mod in (port_res, ref_res):
        w = mod.LoopWatchdog(name="accel", interval_s=1.0)
        for elapsed, err in ((0.5, None), (1.7, "boom"), (0.2, "again"),
                             (0.3, None)):
            w.tick(elapsed, err)
        d = w.to_json()
        d.pop("last_tick_ts")
        dogs.append(d)
    assert dogs[0] == dogs[1]


class Hang:
    name = "hang"

    async def collect(self):
        await asyncio.sleep(30)


class Boom:
    name = "boom"

    async def collect(self):
        raise OSError("no such device")


@pytest.mark.parametrize("collector", [Hang, Boom])
def test_deadline_and_degraded_samples(collector):
    """run_collector under a 0.05 s deadline: a hung collect degrades to
    "deadline exceeded", a raising one to its error; a wedged orphan
    refuses the next attempt."""
    async def go(run, res):
        orphans = {}
        s1 = await run(collector(), deadline_s=0.05, orphans=orphans)
        s2 = await run(collector(), deadline_s=0.05, orphans=orphans)
        for t in orphans.values():
            t.cancel()
        return [(s.source, s.ok, s.data, s.error) for s in (s1, s2)], \
            res.DEADLINE_ERROR

    got = asyncio.run(go(port_run, port_res))
    want = asyncio.run(go(ref_run, ref_res))
    assert got == want


# ------------------------------------------------------------ parsers

def test_nvidia_smi_and_dcgm_parsers():
    assert plain(port_gpu.parse_nvidia_smi_csv(SMI_OUTPUT, "n1")) == plain(
        ref_gpu.parse_nvidia_smi_csv(SMI_OUTPUT, "n1"))
    assert plain(port_gpu.parse_dcgm_text(DCGM_OUTPUT, "n0")) == plain(
        ref_gpu.parse_dcgm_text(DCGM_OUTPUT, "n0"))
    assert port_gpu.SMI_ARGS == ref_gpu.SMI_ARGS


def test_metrics_text_parser():
    text = ref_serving._fake_exposition(now=T0) + (
        'x_total{a="q\\"uote",b="new\\nline"} +Inf\nbad line\n'
        "y NaN 1700000000\n")
    got, want = (port_text.parse_metrics_text(text),
                 ref_text.parse_metrics_text(text))
    assert [(s.name, s.labels, repr(s.value)) for s in got] == [
        (s.name, s.labels, repr(s.value)) for s in want]
    by_got = port_text.samples_by_name(got)
    by_want = ref_text.samples_by_name(want)
    assert sorted(by_got) == sorted(by_want)
    for q in (0.5, 0.9, 0.99):
        for name in by_want:
            if name.endswith("_bucket"):
                assert port_text.histogram_quantile(by_got[name], q) == \
                    ref_text.histogram_quantile(by_want[name], q)


# ------------------------------------------------------------ fakes

@pytest.mark.parametrize("topology", ["v5e-1", "v5e-8", "v5p-8",
                                      "v5p-64"])
def test_fake_tpu_collector_at_a_pinned_clock(topology):
    kw = dict(topology=topology, clock=lambda: T0, fault_episodes=True)
    got = port_fake.FakeTpuCollector(**kw)
    want = ref_fake.FakeTpuCollector(**kw)
    for c in (got, want):
        c.kill_host(f"{c.host_prefix}-1")
        c.set_override(f"{c.host_prefix}-0/chip-0", temp_c=99.0)
    assert plain(asyncio.run(got.collect()).data) == plain(
        asyncio.run(want.collect()).data)


@pytest.mark.parametrize("topology", sorted(
    ref_gpu_fake.GPU_FAKE_TOPOLOGIES))
def test_fake_gpu_collector_at_a_pinned_clock(topology):
    kw = dict(topology=topology, clock=lambda: T0 + 17, fault_episodes=True)
    got = port_gpu_fake.FakeGpuCollector(**kw)
    want = ref_gpu_fake.FakeGpuCollector(**kw)
    assert plain(got.chips()) == plain(want.chips())
    assert port_gpu_fake.VRAM_BYTES_BY_KIND == ref_gpu_fake.VRAM_BYTES_BY_KIND


# ------------------------------------------------------------ config

CONFIG_ENVS = {
    "defaults": {},
    "file_overrides": {"TPUMON_ACCEL_BACKEND": "fake:v5e-8",
                       "TPUMON_PORT": "9100"},
    "lists": {"TPUMON_SERVING_TARGETS": "http://a:9000, http://b:9000"},
    "scalar_threshold": {"TPUMON_THRESHOLDS": json.dumps(
        {"mxu_idle_pct": 2.5})},
    "long_window": {"TPUMON_HISTORY_LONG_WINDOW": "48h",
                    "TPUMON_HISTORY_COARSE_STEP": "2m"},
    "trilevels": {"TPUMON_THRESHOLDS": json.dumps(
        {"cpu_pct": [60, 80, 90], "temp_c": [70, 80]})},
}
CONFIG_ERRORS = {
    "unknown_key": {"TPUMON_NO_SUCH_KEY": "1"},
    "scalar_trilevel": {"TPUMON_THRESHOLDS": json.dumps({"cpu_pct": 90})},
    "long_trilevel": {"TPUMON_THRESHOLDS": json.dumps(
        {"mxu_idle_pct": [1, 2, 3]})},
}


@pytest.mark.parametrize("case", sorted(CONFIG_ENVS))
def test_load_config_field_by_field(case, tmp_path):
    env = CONFIG_ENVS[case]
    path = None
    if case == "file_overrides":
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({
            "port": 9000, "history_window": "1h",
            "collectors": ["host", "accel"],
            "thresholds": {"cpu_pct": [60, 80, 90], "temp_c": [70, 80]},
            "expected_slice_chips": {"slice-0": 8}}))
        path = str(path)
    got = port_config.load_config(path=path, env=env)
    want = ref_config.load_config(path=path, env=env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.effective_cpu_count() == want.effective_cpu_count()


@pytest.mark.parametrize("case", sorted(CONFIG_ERRORS))
def test_load_config_refuses_as_the_reference(case):
    env = CONFIG_ERRORS[case]
    with pytest.raises(ValueError) as ref_err:
        ref_config.load_config(env=env)
    with pytest.raises(ValueError) as port_err:
        port_config.load_config(env=env)
    assert str(port_err.value) == str(ref_err.value)


# ------------------------------------------------------------ factory

@pytest.mark.parametrize("backend", [
    "none", "fake:v5e-8", "fake:v5p-8@leaf+faults", "gpufake:dgx-h100-8",
    "gpufake:superpod-32@n+faults", "nvidia-smi", "nvidia-smi:/opt/smi",
    "dcgm:127.0.0.1:9400"])
def test_factory_dispatch_as_the_reference(backend):
    cfg = port_config.load_config(env={"TPUMON_ACCEL_BACKEND": backend})
    got = port_accel.make_accel_collector(cfg)
    want = ref_accel.make_accel_collector(
        ref_config.load_config(env={"TPUMON_ACCEL_BACKEND": backend}))
    assert type(got).__name__ == type(want).__name__
    fields = [f.name for f in dataclasses.fields(want)
              if f.name not in ("clock", "host", "hostname")]
    assert {f: getattr(got, f) for f in fields} == {
        f: getattr(want, f) for f in fields}


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_factory_builds_the_nvml_collector(backend, tmp_path):
    cfg = port_config.load_config(env={"TPUMON_ACCEL_BACKEND": backend,
                                       "TPUMON_WORKLOAD_DIR": str(tmp_path)})
    c = port_accel.make_accel_collector(cfg)
    assert isinstance(c, CudaGpuCollector)
    assert c.workload_dir == str(tmp_path)


def test_factory_refuses_jax_peers_and_unknown():
    with pytest.raises(ValueError, match="use 'cuda'"):
        port_accel.make_accel_collector(
            port_config.load_config(env={"TPUMON_ACCEL_BACKEND": "jax"}))
    with pytest.raises(ValueError, match="unknown accel backend"):
        port_accel.make_accel_collector(
            port_config.load_config(env={"TPUMON_ACCEL_BACKEND": "tpu"}))
    # Peers are no longer refused: the local collector (none here) is
    # wrapped in the port's peer collector, as the reference does.
    from tpumon_torch.collectors.accel_peers import PeerFederatedCollector

    cfg = port_config.load_config(env={"TPUMON_ACCEL_BACKEND": "none",
                                       "TPUMON_PEERS": "http://a:8899"})
    fed = port_accel.make_accel_collector(cfg)
    assert isinstance(fed, PeerFederatedCollector)
    assert fed.peers == ("http://a:8899",)


# ------------------------------------------------------------ serving

@pytest.fixture(scope="module")
def engine_texts():
    """The port engine's /metrics after serving three requests, in the
    modes validate's serving check scrapes: dense, speculative, paged."""
    model = ModelConfig(vocab=64, d_model=32, n_layers=1, n_heads=2,
                        n_kv_heads=1, d_ff=64, max_seq=64)
    out = {}
    for label, kw in (("dense", {}), ("spec", {"spec_len": 3}),
                      ("paged", {"kv_layout": "paged", "pool_pages": 9})):
        eng = ServingEngine(cfg=ServeConfig(model=model, slots=2,
                                            prefill_len=8, **kw),
                            device="cpu")
        for p in ([3, 1, 4], [9, 2], [5, 3, 5, 8]):
            eng.submit(p, max_new=4)
        eng.drain()
        out[label] = eng.metrics_text()
    return out


@pytest.mark.parametrize("mode", ["dense", "spec", "paged"])
def test_distill_serving_metrics_of_the_port_engine(engine_texts, mode):
    text = engine_texts[mode]
    got = port_serving.distill_serving_metrics(text, now=T0)
    want = ref_serving.distill_serving_metrics(text, now=T0)
    assert got == want
    assert got["tokens_total"] > 0
    # Counter rates between two scrapes.
    assert port_serving.distill_serving_metrics(text, prev=got, now=T0 + 2) \
        == ref_serving.distill_serving_metrics(text, prev=want, now=T0 + 2)


def test_serving_collector_fake_targets(monkeypatch):
    monkeypatch.setattr(ref_serving.time, "time", lambda: T0)
    targets = ("fake:jetstream", "fake:trainer")
    got = asyncio.run(port_serving.ServingCollector(targets=targets)
                      .collect())
    want = asyncio.run(ref_serving.ServingCollector(targets=targets)
                       .collect())
    assert got.data == want.data
    assert (got.ok, got.error) == (want.ok, want.error)


# ------------------------------------------------------------ workload

def test_workload_reader_as_the_reference(tmp_path):
    """Files of the port's WorkloadReporter and hand-written ones (a second
    workload on device 0, a stale one, a torn one) read the same through
    both packages' readers."""
    d = tmp_path / "w"
    rep = WorkloadReporter(name="validate", directory=str(d))
    rep.write_once(interval_s=1.0)
    port_workload.write_report(str(d), "serve", [
        {"index": 0, "hbm_used": 5, "hbm_total": 9, "busy_frac": 0.75},
        {"index": 1, "hbm_used": 2, "hbm_total": 9, "busy_frac": 0.5}],
        pid=11, now=T0)
    port_workload.write_report(str(d), "train", [
        {"index": 0, "hbm_used": 3, "hbm_total": 12, "busy_frac": 0.5}],
        pid=12, now=T0 - 1)
    port_workload.write_report(str(d), "old", [
        {"index": 0, "hbm_used": 1}], pid=13, now=T0 - 60)
    (d / "torn-14.json").write_text("{")
    for now in (T0, T0 + 5):
        got = port_workload.read_reports(str(d), now=now)
        want = ref_workload.read_reports(str(d), now=now)
        assert got == want
        assert port_workload.merge_reports(got) == \
            ref_workload.merge_reports(want)
        src = [mod.WorkloadFileSource(directory=str(d), clock=lambda: now)
               for mod in (port_workload, ref_workload)]
        assert src[0].snapshot() == src[1].snapshot()
        assert src[0].snapshot() == src[1].snapshot()  # the cached path
    assert port_workload.MAX_AGE_S == ref_workload.MAX_AGE_S
