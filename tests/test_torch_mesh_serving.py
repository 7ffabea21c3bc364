"""The port's mesh serving against the JAX reference on one controller.

The golden matrix of ``tests/test_scheduler.py`` (dp×tp layouts x dense
and paged, block decode, speculation): on the reference's weights (f32,
``params_from_jax``) every request's stream, greedy and seeded, must be
IDENTICAL to the JAX reference's 1×1 engine's. The JAX side runs on its
conftest's 8 CPU devices; the port's side on ``[cpu] * 8``, the same code
that runs dp×tp on one card. Then the mesh validation and the factory
(``tests/test_scheduler.py::TestMeshConfigValidation``), the drain cases of
``tests/test_serving_sharded.py::TestMeshEngineDrain`` (streams held to the
reference's single engine), and the merged /metrics page with its
``tpumon_serving_replica_*`` family.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from tests.torch_parity import bridged_params  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch.actuate import EngineActuator  # noqa: E402
from tpumon_torch.loadgen import serving  # noqa: E402
from tpumon_torch.loadgen.model import (  # noqa: E402
    ModelConfig,
    params_from_jax,
    replica_meshes,
)
from tpumon_torch.loadgen.serving import (  # noqa: E402
    MeshServingEngine,
    ServeConfig,
    ServingEngine,
    make_serving_engine,
)
from tpumon_torch.metrics_text import (  # noqa: E402
    parse_metrics_text,
    samples_by_name,
)

CPU8 = [torch.device("cpu")] * 8
# tests/test_scheduler.py's MODEL, MESH_MODEL (vocab 96: every sharded dim
# divides 2) and TRACE: chunked long prompts, short ones, two sampled.
MODEL = dict(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=96, compute_dtype="float32")
MESH_MODEL = dict(MODEL, vocab=96)
TRACE = [
    ([(7 * i + 3) % 97 for i in range(37)], 6, 0.0, 0),
    ([5, 1, 88], 8, 0.0, 0),
    ([(3 * i + 11) % 97 for i in range(21)], 5, 1.0, 8),
    ([9, 2, 6, 5], 7, 0.0, 0),
    ([(11 * i + 2) % 97 for i in range(49)], 4, 0.0, 0),
    ([4, 4, 2], 6, 0.7, 12),
    ([8, 1, 8, 2, 8], 6, 0.0, 0),
]
# The reference's golden-matrix layouts (tests/test_scheduler.py:415-424).
LAYOUTS = [
    (2, 2, dict()),
    (4, 1, dict()),
    (2, 2, dict(kv_layout="paged")),
    (4, 1, dict(kv_layout="paged")),
    (2, 2, dict(kv_layout="paged", decode_block=4)),
    (4, 1, dict(decode_block=4)),
    (2, 2, dict(kv_layout="paged", spec_len=2)),
    (4, 1, dict(spec_len=2)),
]


@pytest.fixture(scope="module")
def mesh_weights():
    return bridged_params(JaxModelConfig(**MESH_MODEL), seed=5)


@pytest.fixture(scope="module")
def reference(mesh_weights):
    """The JAX reference's 1×1 streams (its own init at seed 5 — the
    weights ``mesh_weights`` carries)."""
    eng = jax_serving.make_serving_engine(jax_serving.ServeConfig(
        model=JaxModelConfig(**MESH_MODEL), slots=2, prefill_len=8),
        seed=5)
    reqs = [eng.submit(p, max_new=mx, temperature=t, top_k=k)
            for p, mx, t, k in TRACE]
    eng.drain()
    return [r.output for r in reqs]


def run_mesh_trace(tree, dp, tp, **over):
    eng = make_serving_engine(ServeConfig(
        model=ModelConfig(**MESH_MODEL), slots=over.pop("slots", 2),
        prefill_len=8, mesh_dp=dp, mesh_tp=tp, **over),
        params=params_from_jax(tree), seed=5, devices=CPU8, device="cpu")
    reqs = [eng.submit(p, max_new=mx, temperature=t, top_k=k)
            for p, mx, t, k in TRACE]
    eng.drain()
    assert all(r.done.is_set() for r in reqs)
    return eng, [r.output for r in reqs]


def test_one_by_one_streams_equal_reference(mesh_weights, reference):
    eng, got = run_mesh_trace(mesh_weights[1], 1, 1)
    assert isinstance(eng, ServingEngine)
    assert got == reference


@pytest.mark.parametrize("dp,tp,over", LAYOUTS, ids=lambda v: (
    "-".join(f"{k}={x}" for k, x in v.items()) or "dense"
    if isinstance(v, dict) else str(v)))
def test_stream_matches_reference_single_device(mesh_weights, reference, dp,
                                                tp, over):
    eng, got = run_mesh_trace(mesh_weights[1], dp, tp, **over)
    assert isinstance(eng, MeshServingEngine)
    assert eng.replica_ids == tuple(f"r{d}" for d in range(dp))
    assert got == reference
    if tp > 1:  # each replica is tensor-parallel over its own 2 devices
        assert all(isinstance(r.params, list) and len(r.params) == tp
                   for r in eng.replicas)


# ---------------------------------------------------------------------------
# Validation and the factory (tests/test_scheduler.py:484-523)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over,msg", [
    (dict(mesh_dp=0), "mesh_dp"),
    (dict(mesh_dp=2), "MeshServingEngine"),
    (dict(ring_stripes=1), "ring_stripes"),
    (dict(ring_stripes=2), "paged"),  # dense has no pages
    (dict(ring_stripes=2, kv_layout="paged", spec_len=2), "speculative"),
    (dict(ring_stripes=2, kv_layout="paged", paged_attn="kernel"),
     "kernel"),
    (dict(kv_layout="paged", paged_attn="ring", kv_dtype="int8"), "ring"),
])
def test_plain_engine_rejects_as_reference(over, msg):
    for make in (
            lambda: ServingEngine(ServeConfig(model=ModelConfig(**MODEL),
                                              **over), device="cpu"),
            lambda: jax_serving.ServingEngine(jax_serving.ServeConfig(
                model=JaxModelConfig(**MODEL), **over))):
        with pytest.raises(ValueError, match=msg):
            make()


def test_mesh_shape_must_divide_device_count():
    cfg = ServeConfig(model=ModelConfig(**MESH_MODEL), slots=2,
                      prefill_len=8, mesh_dp=3, mesh_tp=1)
    # 8 devices: 3x1 neither fills nor tiles them.
    with pytest.raises(ValueError, match="divide the device count"):
        MeshServingEngine(cfg, devices=CPU8)
    # No device list on the CPU: the one CPU device is all there is, as
    # for the reference on a one-device host.
    with pytest.raises(ValueError, match="divide the device count"):
        MeshServingEngine(dataclasses.replace(cfg, mesh_dp=1, mesh_tp=2),
                          device="cpu")
    with pytest.raises(ValueError, match="divide"):
        replica_meshes(2, 1, devices=[torch.device("cpu")])


def test_factory_picks_engine_shape():
    cfg = ServeConfig(model=ModelConfig(**MESH_MODEL), slots=2,
                      prefill_len=8)
    assert isinstance(make_serving_engine(cfg, devices=CPU8, device="cpu"),
                      ServingEngine)
    eng = make_serving_engine(dataclasses.replace(cfg, mesh_dp=2, mesh_tp=1),
                              devices=CPU8)
    assert isinstance(eng, MeshServingEngine)
    assert eng.replica_ids == ("r0", "r1")
    # Each replica's state is its own allocation, even on one device.
    a, b = (r.params["layers"][0]["wq"] for r in eng.replicas)
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)


def test_replica_meshes_carve_contiguous_devices():
    devs = [torch.device("cpu", i) for i in range(8)]
    dense = replica_meshes(2, 2, dense=True, devices=devs)
    assert [m.shape for m in dense] == [{"data": 1, "model": 2}] * 2
    assert dense[1].device_list == devs[2:4]
    paged = replica_meshes(4, 2, devices=devs)
    assert [m.axis_names for m in paged] == [("model",)] * 4
    assert paged[3].device_list == devs[6:8]
    assert replica_meshes(4, 1, devices=devs) == [None] * 4


# ---------------------------------------------------------------------------
# Drain over the mesh engine (tests/test_serving_sharded.py:269-347)
# ---------------------------------------------------------------------------

# tests/test_serving_sharded.py's CFG.
SHARDED = dict(vocab=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=128, max_seq=32, compute_dtype="float32")
DRAIN_PROMPTS = [[9, 4, 77, 3], [1, 2, 3], [5, 5, 5, 5, 5], [8, 1, 8]]


@pytest.fixture(scope="module")
def drain_weights():
    return bridged_params(JaxModelConfig(**SHARDED), seed=7)


def submit_all(eng):
    return [eng.submit(p, max_new=6, temperature=(1.0 if i == 1 else 0.0),
                       top_k=(8 if i == 1 else 0))
            for i, p in enumerate(DRAIN_PROMPTS)]


def mesh_engine(tree, dp=2, tp=1):
    return MeshServingEngine(ServeConfig(
        model=ModelConfig(**SHARDED), slots=2, prefill_len=8, mesh_dp=dp,
        mesh_tp=tp), params=params_from_jax(tree), seed=7, devices=CPU8)


def test_drain_moves_work_and_streams_equal_reference(drain_weights):
    single = jax_serving.ServingEngine(jax_serving.ServeConfig(
        model=JaxModelConfig(**SHARDED), slots=2, prefill_len=8), seed=7)
    ref = submit_all(single)
    single.drain()

    eng = mesh_engine(drain_weights[1])
    reqs = submit_all(eng)
    for _ in range(2):  # some requests mid-flight on both replicas
        eng.step()
    assert any(s is not None for s in eng.replicas[0]._slots)
    eng.drain_slice("r0")
    assert eng.drained_slices() == ("r0",)
    r0 = eng.replicas[0]
    assert len(r0._queue) == 0 and all(s is None for s in r0._slots)
    probe = eng.submit([4, 2], max_new=2)  # routes around r0
    assert len(r0._queue) == 0 and probe.status != "rejected"
    eng.drain()
    assert all(r.done.is_set() for r in reqs + [probe])
    assert eng.requeued_total > 0
    assert [r.output for r in reqs] == [r.output for r in ref]


def test_all_drained_rejects_then_undrain_recovers(drain_weights):
    eng = mesh_engine(drain_weights[1])
    eng.drain_slice("r0")
    eng.drain_slice("r1")
    r = eng.submit([1, 2, 3], max_new=2)
    assert r.status == "rejected" and r.done.is_set()
    assert eng.rejected_total == 1
    eng.undrain_slice("r1")
    r2 = eng.submit([1, 2, 3], max_new=2)
    eng.drain()
    assert r2.status == "completed"
    assert len(eng.replicas[0]._queue) == 0  # r1 served it


def test_engine_actuator_verbs_hit_replicas(drain_weights):
    eng = mesh_engine(drain_weights[1])
    act = EngineActuator(eng)
    act.drain("r1")
    assert eng.drained_slices() == ("r1",)
    act.undrain("r1")
    assert eng.drained_slices() == ()
    assert act.shed("batch", 0.5) == 0.5
    assert all(e.shed_fractions() == {"batch": 0.5} for e in eng.replicas)
    act.unshed("batch")
    assert act.nudge(prefill_budget=3)["prefill_budget"] == 3
    assert all(e.cfg.prefill_chunk_budget == 3 for e in eng.replicas)
    act.drain("r0")
    act.set_slices(["r1"])  # prunes the stale drain mark
    assert eng.drained_slices() == ()


def test_tp_replicas_drain_and_route(drain_weights):
    """dp 2 x tp 2: the drained replica's work replays on a tensor-parallel
    replica to the same streams."""
    single = jax_serving.ServingEngine(jax_serving.ServeConfig(
        model=JaxModelConfig(**SHARDED), slots=2, prefill_len=8), seed=7)
    ref = submit_all(single)
    single.drain()
    eng = mesh_engine(drain_weights[1], tp=2)
    reqs = submit_all(eng)
    eng.step()
    eng.drain_slice("r1")
    eng.drain()
    assert [r.output for r in reqs] == [r.output for r in ref]


# ---------------------------------------------------------------------------
# The merged /metrics page
# ---------------------------------------------------------------------------


def test_merged_page_carries_both_replicas(drain_weights):
    eng = mesh_engine(drain_weights[1])
    reqs = submit_all(eng)
    eng.drain()
    assert all(r.status == "completed" for r in reqs)
    by = samples_by_name(parse_metrics_text(eng.metrics_text()))
    for fam in ("tpumon_serving_replica_slots_available",
                "tpumon_serving_replica_queue_size",
                "tpumon_serving_replica_ttft_p95_ms"):
        assert sorted(s.labels["replica"] for s in by[fam]) == ["r0", "r1"]
    (tokens,) = by["jetstream_generate_tokens"]
    assert tokens.value == sum(e.tokens_total for e in eng.replicas)
    assert tokens.value == eng.tokens_total == sum(len(r.output)
                                                   for r in reqs)


def test_merge_and_render_equal_reference():
    """The same replica snapshots merge and render to the reference's
    text, per-replica rows included."""
    import time

    now = time.monotonic()

    def snap(k):
        return {
            "tokens": 10 * k, "requests": k, "completed": k, "steps": 3 * k,
            "queue": k, "rejected": 0, "cancelled": 0, "shed": 0,
            "requeued": k, "ttft_counts": [k] + [0] * 10, "ttft_inf": 0,
            "ttft_sum": 0.01 * k, "free": 1, "in_prefill": 0,
            "ttft_recent": [0.001 * k], "tpot_recent": [0.002 * k],
            "spec_rounds": 0, "spec_proposed": 0, "spec_accepted": 0,
            "tenant_window_s": 60.0,
            "tenants": {"chat": {"submitted": k, "completed": k,
                                 "rejected": 0, "cancelled": 0, "shed": 0,
                                 "tokens": 10 * k, "ttft": [(now, 0.01)],
                                 "tpot": [(now, 0.002)]}},
            "weight_bytes": 1 << 20, "kv_pages_total": 8,
            "kv_pages_free": 8 - k, "prefix": None,
        }

    snaps = [snap(1), snap(2)]
    rows = [("r0", 1, 1, 1.0, 2.0), ("r1", 1, 2, None, 4.0)]
    got = serving._render_serving_metrics(
        serving._merge_serving_snapshots(snaps), replica_rows=rows)
    want = jax_serving._render_serving_metrics(
        jax_serving._merge_serving_snapshots(snaps), replica_rows=rows)
    assert got == want
    assert 'tpumon_serving_replica_queue_size{replica="r1"} 2' in got
