"""The port's actuator verbs against the JAX reference engine's.

Shed pacing (``set_shed``: per tenant and "*", the SHED_CAP clamp, the
accumulator reset) gives the reference's status for every submission and
the same counters; a slice drain mid-flight requeues the drained
requests, whose streams equal the undrained run's and the reference's
(greedy and sampled, dense and paged), with each token streamed once;
``evict_all`` on one engine and ``adopt`` on another give the same
streams; ``nudge_capacity`` returns the reference's values and takes
effect on the next step; the unchanged ``tpumon.actuate.EngineActuator``
drives the port's engine through all seven verbs; ``start_background``
serves /metrics with the shed and requeue counters counting for real.
"""

import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_parity import bridged_params  # noqa: E402
from tpumon.actuate import EngineActuator  # noqa: E402
from tpumon.collectors.serving import distill_serving_metrics  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch.loadgen import serving  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig, params_from_jax  # noqa: E402

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=64, compute_dtype="float32")
PS = 8
SEED = 3
_rng = np.random.default_rng(71)
PROMPTS = [[int(t) for t in _rng.integers(0, 128, n)]
           for n in (5, 12, 20, 9, 3, 14)]
MAX_NEW = [12, 9, 6, 10, 8, 7]
SAMPLING = [(0.0, 0), (0.8, 0), (0.0, 0), (0.8, 5), (0.0, 0), (0.8, 0)]


@pytest.fixture(scope="module")
def weights():
    return bridged_params(JaxModelConfig(**SMALL), seed=5)


def engines(weights, **kw):
    kw = {"slots": 2, "prefill_len": PS, **kw}
    return (jax_serving.ServingEngine(
                cfg=jax_serving.ServeConfig(model=JaxModelConfig(**SMALL),
                                            **kw),
                params=weights[0], seed=SEED),
            serving.ServingEngine(
                cfg=serving.ServeConfig(model=ModelConfig(**SMALL), **kw),
                params=params_from_jax(weights[1]), seed=SEED,
                device="cpu"))


def test_shed_pacing_matches_reference(weights):
    """A script of set_shed calls and tagged submissions: every status,
    the returned fractions and every counter equal the reference's, and
    fraction f sheds round(n*f) of a tenant's n submissions."""
    ref, eng = engines(weights, **{"slots": 2})
    for e in (ref, eng):
        e.max_queue = 1000
    script = [("set", "chat", 0.5), ("sub", "chat", 10),
              ("set", "*", 0.25), ("sub", "batch", 8), ("sub", "chat", 3),
              ("set", "chat", 2.0), ("sub", "chat", 20),
              ("set", "chat", 0.0), ("sub", "chat", 4),
              ("set", "*", -1), ("sub", "batch", 4), ("sub", "", 3),
              ("set", "*", 0.5), ("sub", "", 4), ("set", "*", 0)]
    statuses = {id(ref): [], id(eng): []}
    for op, tenant, arg in script:
        got = []
        for e in (ref, eng):
            if op == "set":
                got.append(e.set_shed(tenant, arg))
            else:
                for i in range(arg):
                    statuses[id(e)].append(e.submit(
                        [1, 2, 3], max_new=1, tenant=tenant).status)
                got.append(e.shed_fractions())
        assert got[0] == got[1], (op, tenant, arg)
    assert statuses[id(eng)] == statuses[id(ref)]
    assert statuses[id(eng)][:10].count("shed") == 5  # round(10 * 0.5)
    assert eng.set_shed("x", 5.0) == serving.SHED_CAP
    for key in ("shed", "rejected", "requests"):
        assert eng._stats_snapshot()[key] == ref._stats_snapshot()[key]
    tj = ref._stats_snapshot()["tenants"]
    tt = eng._stats_snapshot()["tenants"]
    assert {k: (v["shed"], v["submitted"]) for k, v in tt.items()} == {
        k: (v["shed"], v["submitted"]) for k, v in tj.items()}
    text = eng.metrics_text()
    assert f'tpumon_serving_requests_shed {eng.shed_total}' in text
    assert 'tpumon_serving_tenant_shed{tenant="chat"}' in text
    assert distill_serving_metrics(text, now=1.0)["tokens_total"] == 0


def run_drained(engine, drain_after, stream=False):
    """Serve PROMPTS over slices a/b; drain slice a after ``drain_after``
    steps (never when None), undrain it once the rest is served."""
    engine.set_slices(["a", "b"])
    reqs = [engine.submit(p, max_new=n, temperature=t, top_k=k,
                          stream=stream)
            for p, n, (t, k) in zip(PROMPTS, MAX_NEW, SAMPLING)]
    for i in range(200):
        if i == drain_after:
            engine.drain_slice("a")
        if not engine.step():
            break
        if drain_after is not None and i == drain_after + 8:
            engine.undrain_slice("a")
    assert all(r.status == "completed" for r in reqs)
    return reqs


@pytest.mark.parametrize("layout", [{}, {"kv_layout": "paged"},
                                    {"kv_layout": "paged",
                                     "paged_attn": "kernel",
                                     "decode_block": 4}])
def test_drain_requeue_streams_match_undrained_and_reference(weights,
                                                             layout):
    ref, eng = engines(weights, **layout)
    _, plain = engines(weights, **layout)
    want = [r.output for r in run_drained(plain, None)]
    got = run_drained(eng, 1, stream=True)
    jgot = run_drained(ref, 1)
    assert [r.output for r in got] == want == [r.output for r in jgot]
    assert eng.requeued_total == ref.requeued_total > 0
    assert [r.requeues for r in got] == [r.requeues for r in jgot]
    assert eng.decode_steps_total == ref.decode_steps_total
    # Each token reaches the stream once, requeues or not.
    for r in got:
        seen = []
        while (tok := r.stream.get(timeout=1)) is not None:
            seen.append(tok)
        assert seen == r.output
    text = eng.metrics_text()
    assert f"tpumon_serving_requests_requeued {eng.requeued_total}" in text


def test_all_slices_drained_places_anyway_and_sweeps_nothing(weights):
    ref, eng = engines(weights)
    for e in (ref, eng):
        e.set_slices(["a"])
        e.drain_slice("a")
        r = e.submit(PROMPTS[0], max_new=3)
        e.drain()
        assert r.status == "completed" and r.slice == "a"
        assert e.requeued_total == 0
        assert e.drained_slices() == ("a",)
        e.set_slices(["b"])  # renaming drops the stale mark
        assert e.drained_slices() == ()


def test_evict_all_then_adopt_gives_the_same_streams(weights):
    ref, eng = engines(weights, kv_layout="paged")
    _, second = engines(weights, kv_layout="paged")
    _, plain = engines(weights, kv_layout="paged")
    want = [plain.submit(p, max_new=n, temperature=t, top_k=k)
            for p, n, (t, k) in zip(PROMPTS, MAX_NEW, SAMPLING)]
    plain.drain()
    evicted = {}
    for e in (ref, eng):
        reqs = [e.submit(p, max_new=n, temperature=t, top_k=k)
                for p, n, (t, k) in zip(PROMPTS, MAX_NEW, SAMPLING)]
        for _ in range(4):
            e.step()
        out = e.evict_all()
        assert e.load() == 0 and not e.step()
        evicted[id(e)] = ([r.rid for r in out], reqs)
    assert evicted[id(eng)][0] == evicted[id(ref)][0]
    assert eng.requeued_total == ref.requeued_total > 0
    rids, reqs = evicted[id(eng)]
    by_rid = {r.rid: r for r in reqs}
    for rid in reversed(rids):  # adopt at the head: keep the order
        second.adopt(by_rid[rid])
    assert second.load() == len(rids) and second.requests_total == 0
    second.drain()
    assert [r.output for r in reqs] == [r.output for r in want]


def test_nudge_capacity_takes_effect_on_the_next_step(weights):
    for layout in ({}, {"kv_layout": "paged"}):
        ref, eng = engines(weights, **layout)
        for args in ({"prefill_budget": 3}, {"admit_lookahead": 2},
                     {"prefill_budget": 0, "admit_lookahead": -4}, {}):
            assert eng.nudge_capacity(**args) == ref.nudge_capacity(**args)
    _, eng = engines(weights, slots=4)
    long = [eng.submit(p, max_new=2) for p in PROMPTS[1:3]]
    eng.step()  # budget 1 while a slot decodes: chunk counts advance
    eng.nudge_capacity(prefill_budget=4)
    before = [w.next_c0 for w in eng._prefill_work if w is not None]
    eng.step()
    after = [w.next_c0 for w in eng._prefill_work if w is not None]
    assert eng.cfg.prefill_chunk_budget == 4
    assert sum(after) - sum(before) >= 2 * PS or len(after) < len(before)
    eng.drain()
    assert all(r.status == "completed" for r in long)


def test_engine_actuator_drives_the_port_engine(weights):
    """tpumon.actuate's EngineActuator, unchanged, over the port's
    engine: every verb lands."""
    _, eng = engines(weights, kv_layout="paged")
    act = EngineActuator(eng)
    assert act.shed("chat", 0.5) == 0.5
    assert eng.shed_fractions() == {"chat": 0.5}
    act.unshed("chat")
    assert eng.shed_fractions() == {}
    assert act.capacity() == {"prefill_budget": 1, "admit_lookahead": 0}
    assert act.nudge(prefill_budget=2, admit_lookahead=3) == {
        "prefill_budget": 2, "admit_lookahead": 3}
    act.set_slices(["s0", "s1"])
    act.drain("s0")
    assert eng.drained_slices() == ("s0",)
    act.undrain("s0")
    assert eng.drained_slices() == ()
    r = eng.submit(PROMPTS[0], max_new=2)
    eng.drain()
    assert r.status == "completed" and r.slice in ("s0", "s1")


def test_start_background_serves_metrics_and_stops(weights):
    engine, url, stop = serving.start_background(
        rps=50.0, max_new=2, port=0, prefix_cache=2, device="cpu")
    try:
        assert engine.prefix_cache is not None
        engine.set_shed("*", 0.5)
        reqs = [engine.submit([1, 2, 3], max_new=1, tenant="t")
                for _ in range(4)]
        assert [r.status for r in reqs].count("shed") == 2
        assert all(r.done.wait(timeout=30) for r in reqs)
        with urllib.request.urlopen(url, timeout=10) as resp:
            text = resp.read().decode()
        # The arrival loop's own (untagged) requests are shed-paced too,
        # and race the scrape: tenant "t"'s count is the exact one.
        assert 'tpumon_serving_tenant_shed{tenant="t"} 2' in text
        assert "tpumon_serving_requests_shed " in text
        assert "tpumon_serving_prefix_hits" in text
    finally:
        stop.set()
