"""The benchmark's reduction of the program's own spans
(``portbench/inside.py``) on hand-made profiler events, the metrics read
from it and from the engine's counters, the ``decode_host_ms.serve``
reader, and a tiny cell run through ``inside.run_cell`` on the CPU.
"""

import pytest

from portbench import inside, run, trace


class Ev:
    """A profiler event as ``kineto_results.events()`` gives one."""

    def __init__(self, name, t0, dur, dev=False, corr=0, annotation=False):
        self._name, self._t0, self._dur = name, t0, dur
        self._dev, self._corr, self._ann = dev, corr, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._ann

    def activity_type(self):
        return "gpu_user_annotation" if self._ann and self._dev else "cpu_op"


def span(name, t0, dur):
    return Ev(name, t0, dur, annotation=True)


def call(corr, t0, name="cudaLaunchKernel"):
    return Ev(name, t0, 5, corr=corr)


def op(corr, t0, dur, name="kernel"):
    return Ev(name, t0, dur, dev=True, corr=corr)


EVENTS = [
    span(trace.SLICE, 0, 1000),
    span("serve.engine_step", 100, 500),
    span("serve.chunk", 120, 80),
    span("serve.prefill_chunk", 125, 65),   # the driver's, inside chunk
    span("serve.decode_launch", 300, 100),
    call(1, 130),                 # in the chunk (and the driver's span)
    op(1, 210, 50),
    Ev("serve.chunk", 210, 50, dev=True, annotation=True),  # device copy
    call(2, 310),                 # in decode_launch
    op(2, 420, 50),
    call(3, 350, "cuLaunchKernel"),  # another thread, same span on the clock
    op(3, 480, 20),
    call(4, 500, "cudaGraphLaunch"),  # engine_step alone: one launch
    op(4, 600, 10), op(4, 610, 10), op(4, 620, 20),
    Ev("aten::mm", 520, 5, corr=5),   # an op's id is not a runtime call's
    call(5, 50),                  # outside every program span
    op(5, 60, 30),
    call(6, 900),
    op(6, 990, 30),               # cut by the slice's end: not counted
    op(7, 700, 10),               # its runtime call is not in the trace
]


def test_device_time_and_launches_by_innermost_program_span():
    r = inside.reduce_program_spans(EVENTS)
    sp = r["spans"]
    ns = 1e-9
    assert "serve.prefill_chunk" not in sp
    assert sp["serve.chunk"]["self_device_s"] == pytest.approx(50 * ns)
    assert sp["serve.chunk"]["self_launches"] == 1
    assert sp["serve.decode_launch"]["self_device_s"] == pytest.approx(70 * ns)
    assert sp["serve.decode_launch"]["self_launches"] == 2
    step = sp["serve.engine_step"]
    assert step["self_device_s"] == pytest.approx(40 * ns)
    assert step["self_launches"] == 1  # the graph's three kernels
    assert step["device_s"] == pytest.approx(160 * ns)
    assert step["launches"] == 4
    assert step["n"] == 1 and step["host_s"] == [pytest.approx(500 * ns)]
    assert r["device_s"] == pytest.approx(200 * ns)
    assert r["uncovered"] == {"device_s": pytest.approx(40 * ns),
                              "launches": 2, "unlinked": 1}
    assert r["window_s"] == pytest.approx(1000 * ns)
    rec = {"kind": "serve", "on_card": True, "program_spans": r}
    assert inside.program_span_share(rec) == pytest.approx(80.0)
    assert inside.launches_per_step(rec) == 4
    assert inside.chunk_device_ms(rec) == pytest.approx(50e-6)


def test_no_slice_reduces_to_nothing():
    assert inside.reduce_program_spans(EVENTS[1:]) == {}


def serve_rec(**kw):
    rec = {"kind": "serve", "on_card": True,
           "engine_counters": {
               "start": dict(prefill_rows_gathered=100,
                             prefill_rows_needed=10, decode_rows_read=1000,
                             decode_rows_live=900),
               "stop": dict(prefill_rows_gathered=500,
                            prefill_rows_needed=110, decode_rows_read=3000,
                            decode_rows_live=1900)},
           "queue_wait_ms": [float(x) for x in range(1, 101)],
           "program_spans": inside.reduce_program_spans(EVENTS)}
    rec.update(kw)
    return rec


def test_counter_and_queue_wait_metrics():
    rec = serve_rec()
    r = inside.READERS
    assert r["prefill_rows_useful.serve"](rec) == pytest.approx(25.0)
    assert r["decode_rows_useful.serve"](rec) == pytest.approx(50.0)
    assert r["queue_wait_p95_ms.serve"](rec) == pytest.approx(95.05)


def test_train_metrics_read_each_phase_per_step():
    ns = 1000
    events = [span(trace.SLICE, 0, 100 * ns)]
    for k in range(2):  # two steps: forward 10, backward 20, update 3
        t = 10 * ns + k * 40 * ns
        for i, (name, dur) in enumerate((("train.forward", 10),
                                         ("train.backward", 20),
                                         ("train.update", 3))):
            a = t + sum((10, 20, 3)[:i]) * ns
            corr = 10 * k + i + 1
            events += [span(name, a, dur * ns), call(corr, a + 1),
                       op(corr, a + 2, dur * ns - 5)]
    rec = {"kind": "train", "on_card": True,
           "program_spans": inside.reduce_program_spans(events)}
    r = inside.READERS
    assert r["forward_ms.train"](rec) == pytest.approx((10 * ns - 5) * 1e-6)
    assert r["backward_ms.train"](rec) == pytest.approx((20 * ns - 5) * 1e-6)
    assert r["update_ms.train"](rec) == pytest.approx((3 * ns - 5) * 1e-6)
    assert r["program_span_share"](rec) == pytest.approx(100.0)
    assert r["chunk_device_ms.serve"](rec) is None


@pytest.mark.parametrize("name", sorted(inside.READERS))
def test_every_reader_is_none_off_the_card_or_without_its_key(name):
    read = inside.READERS[name]
    kind = "train" if name.endswith(".train") else "serve"
    full = serve_rec(kind=kind)
    assert read({**full, "on_card": False}) is None
    bare = {"kind": kind, "on_card": True}
    assert read(bare) is None
    other = "serve" if kind == "train" else "train"
    if name != "program_span_share":
        assert read({**full, "kind": other}) is None


def test_decode_host_ms_reads_the_program_span_in_the_slice():
    read = run.reader("decode_host_ms.serve")
    rec = {"kind": "serve", "on_card": True, "slice": {"spans": {
        "serve.decode_launch": [0.004, 0.008, 0.006],
        "serve.step": [0.06]}}}
    assert read(rec) == pytest.approx(6.0)
    assert read({**rec, "on_card": False}) is None
    assert read({**rec, "kind": "train"}) is None
    assert read({"kind": "serve", "on_card": True,
                 "slice": {"spans": {"serve.step": [0.06]}}}) is None
    assert read({"kind": "serve", "on_card": True}) is None


def test_engine_counters_none_without_them():
    class Old:
        _lock = __import__("threading").Lock()
    assert inside.engine_counters(Old()) is None


def test_a_tiny_cell_run_with_the_program_keys(tmp_path, monkeypatch):
    from portbench.tests.conftest import make_tiny

    monkeypatch.setattr(trace, "SLICE_S", 0.3)
    bench, root, pkg = make_tiny(tmp_path)
    runs = inside.run_cell(bench, "tiny.serve", 2**31 + 5, 1.0, "cpu",
                           root, pkg)
    plain, rec = runs["untraced"], runs["traced"]
    # The untraced window: the spans timed on the host clock, the
    # counters advanced over it, a queue wait for each TTFT.
    assert {"serve.engine_step", "serve.decode_launch",
            "serve.sync"} <= set(plain["host_s"])
    c = plain["engine_counters"]
    assert c["stop"]["decode_rows_read"] > c["start"]["decode_rows_read"]
    assert len(plain["queue_wait_s"]) == len(plain["ttft_ms"])
    assert all(0 <= w * 1e3 <= t for w, t in zip(
        sorted(plain["queue_wait_s"]), sorted(plain["ttft_ms"])))
    # The traced window: the counters over the slice, the spans reduced.
    c = rec["engine_counters"]
    assert all(c["stop"][k] >= c["start"][k] for k in inside.ROW_COUNTERS)
    assert rec["queue_wait_ms"] and len(rec["queue_wait_ms"]) == len(
        rec["ttft_ms"])
    assert max(rec["queue_wait_ms"]) <= max(rec["ttft_ms"])
    spans = rec["program_spans"]["spans"]
    assert spans["serve.engine_step"]["n"] > 0
    assert spans["serve.decode_launch"]["n"] > 0
    # Off the card every metric reads None; the summary still reads.
    assert all(f(rec) is None for f in inside.READERS.values())
    out = inside.summary(runs)
    assert out["untraced"]["decode_rows_useful"] is not None
    assert 0 < out["untraced"]["prefill_rows_useful"] <= 100
    assert out["untraced"]["host_ms_p50"]["serve.engine_step"] > 0
    runs = inside.run_cell(bench, "tiny.train", 7, 1.0, "cpu", root, pkg)
    assert {"train.forward", "train.backward", "train.update"} <= set(
        runs["traced"]["program_spans"]["spans"])
    assert set(runs["untraced"]["host_s"]) == {
        "train.forward", "train.backward", "train.update"}
    assert inside.summary(runs)["untraced"]["tokens_per_s"] > 0


def test_host_timed_leaves_the_program_as_it_was():
    from tpumon_torch.loadgen import model, serving
    from tpumon_torch.tracing import profiler_span

    with inside.host_timed() as clock:
        assert serving.profiler_span is clock
        with model.profiler_span("train.update"):
            pass
    assert serving.profiler_span is model.profiler_span is profiler_span
    assert len(clock.seconds["train.update"]) == 1
