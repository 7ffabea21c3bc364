"""The port's multi-tenant traffic simulator against the JAX reference's.

Both packages' ``TrafficSim`` over the same recording stub engine: every
tenant's arrival schedule (its prompts, max_new, temperature, and the
exponential gaps drawn in between, in the pump's order) and the diurnal
rate curve equal the reference's for the same seed, as do ``to_json``
and the validation errors. Over the port's real engine (CPU, tiny
model) the simulator drives tagged traffic into the per-tenant /metrics
families, and ``start_traffic_background`` serves them over HTTP.
"""

import time
import urllib.request
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from tpumon.loadgen import traffic as jax_traffic  # noqa: E402
from tpumon_torch.loadgen import serving, traffic  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig  # noqa: E402


class StubEngine:
    """Records submissions; never holds work (step() -> False)."""

    def __init__(self, vocab=512, prefill_len=16):
        self.cfg = SimpleNamespace(
            model=SimpleNamespace(vocab=vocab), prefill_len=prefill_len)
        self.submitted = []

    def submit(self, prompt, max_new=16, temperature=0.0, top_k=0,
               tenant=""):
        self.submitted.append((tenant, tuple(prompt), max_new, temperature))
        return SimpleNamespace(tenant=tenant)

    def step(self):
        return False


def specs(mod):
    return [mod.TenantSpec(name="chat", scenario="chat", rps=5.0,
                           diurnal_amp=0.6, diurnal_period_s=40.0),
            mod.TenantSpec(name="rag", scenario="rag", rps=1.0,
                           prompt_chunks=4),
            mod.TenantSpec(name="batch", scenario="batch", rps=0.5,
                           max_new=9, temperature=0.3)]


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_arrival_schedules_equal_reference(seed):
    """Each tenant's k-th arrival (prompt, max_new, temperature) and the
    gap after it, drawn as the pump draws them (fire, then interval),
    equal the reference's; so does the rate at every probed time."""
    sims = [mod.TrafficSim(StubEngine(), specs(mod), seed=seed,
                           time_scale=2.0)
            for mod in (jax_traffic, traffic)]
    gaps = [[], []]
    for _ in range(30):
        for i, sim in enumerate(sims):
            for src, name in zip(sim.pump.sources, sim.tenants):
                rate = src.rate(3.7)
                src.fire(0.0)
                gaps[i].append((name, rate, src.interval(rate)))
    assert gaps[0] == gaps[1]
    assert sims[0].engine.submitted == sims[1].engine.submitted
    for t in (0.0, 5.0, 10.0, 17.5, 30.0):
        assert [s.rate(t) for s in sims[1].pump.sources] == [
            s.rate(t) for s in sims[0].pump.sources]
    sims[0].degrade(3.0)
    sims[1].degrade(3.0)
    assert sims[1].to_json() == sims[0].to_json()
    assert sims[1].to_json()["stall_s"] == traffic.TrafficSim.MAX_STALL_S


def test_validation_errors_equal_reference():
    for tenants in ([], [SimpleNamespace(name="a")] * 2,
                    ["a.b"], [""], ["x"]):
        errs = []
        for mod in (jax_traffic, traffic):
            ts = [mod.TenantSpec(name=t) if isinstance(t, str) else t
                  for t in tenants]
            if tenants == ["x"]:
                ts = [mod.TenantSpec(name="x", scenario="video")]
            with pytest.raises(ValueError) as e:
                mod.TrafficSim(StubEngine(), ts)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def small_config(**kw):
    return serving.ServeConfig(
        model=ModelConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq=128,
                          compute_dtype="float32"),
        slots=4, prefill_len=8, **kw)


def test_sim_over_the_port_engine_fills_tenant_families():
    eng = serving.ServingEngine(cfg=small_config(prefix_cache_entries=4),
                                device="cpu")
    tenants = [traffic.TenantSpec(name="chat", rps=40.0, max_new=3),
               traffic.TenantSpec(name="rag", scenario="rag", rps=20.0,
                                  prompt_chunks=3, max_new=2)]
    sim = traffic.TrafficSim(eng, tenants, seed=1, keep_requests=10_000)
    eng.set_shed("chat", 0.5)
    sim.run(duration=1.0)
    eng.drain()
    chat = sim.tenants["chat"].requests
    assert sim.tenants["chat"].submitted >= 4
    assert sum(r.status == "shed" for r in chat) == len(chat) // 2
    assert all(r.status == "completed" for r in sim.tenants["rag"].requests)
    assert eng.prefix_cache.hits > 0  # the rag tenant's shared prefix
    text = eng.metrics_text()
    for fam in ("tpumon_serving_tenant_requests", "tpumon_serving_tenant_shed",
                "tpumon_serving_tenant_ttft_p50_ms"):
        assert f'{fam}{{tenant="rag"}}' in text
    assert 'tpumon_serving_tenant_shed{tenant="chat"}' in text


def test_start_traffic_background_serves_metrics_and_stops():
    tenants = [traffic.TenantSpec(name="chat", rps=30.0, max_new=2)]
    engine, sim, url, stop = traffic.start_traffic_background(
        tenants, cfg=small_config(), seed=2, device="cpu")
    try:
        deadline = time.monotonic() + 30
        while engine.completed_total == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        with urllib.request.urlopen(url, timeout=10) as resp:
            text = resp.read().decode()
        assert 'tpumon_serving_tenant_completed{tenant="chat"}' in text
    finally:
        stop.set()
        sim._thread.join(timeout=10)
    assert not sim._thread.is_alive()
    assert sim.to_json()["tenants"]["chat"]["submitted"] >= 1
