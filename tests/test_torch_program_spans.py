"""The program's own spans and counters (``tracing.profiler_span`` in the
serving engine and the trainer), on the CPU.

Under ``torch.profiler`` a tiny paged engine's steps open the serving
spans, nested as the engine's layers are, and a training step opens its
three; with no profiler running nothing enters ``record_function``. The
engine's row counters and each request's ``queue_wait_s`` are pinned on
hand-counted schedules.
"""

import pytest

torch = pytest.importorskip("torch")

from tpumon_torch import tracing  # noqa: E402
from tpumon_torch.loadgen import model as tmodel  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig  # noqa: E402
from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine  # noqa: E402

SMALL = dict(vocab=128, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=64, compute_dtype="float32")
PAGE = 8
SERVE_SPANS = ("serve.engine_step", "serve.admit", "serve.chunk",
               "serve.first_token", "serve.decode_launch", "serve.sync",
               "serve.emit")
TRAIN_SPANS = ("train.forward", "train.backward", "train.update")


def engine(slots=2, paged_attn="kernel", **kw):
    cfg = ServeConfig(model=ModelConfig(**SMALL), slots=slots,
                      prefill_len=PAGE, kv_layout="paged",
                      paged_attn=paged_attn, **kw)
    return ServingEngine(cfg, seed=0, device="cpu")


def two_requests(eng):
    """A: 3 prompt tokens (one chunk), 3 new; B: 10 (two chunks), 2 new."""
    a = eng.submit(list(range(1, 4)), max_new=3)
    b = eng.submit(list(range(1, 11)), max_new=2)
    steps = 0
    while eng.step():
        steps += 1
    return a, b, steps + 1


def train_step():
    cfg = ModelConfig(**SMALL)
    gen = torch.Generator().manual_seed(0)
    params = tmodel.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (2, 17), generator=gen)
    return tmodel.sgd_train_step(cfg, params, tokens)


def host_spans(prof, prefix):
    """(start, end, name) of the profiler's host ranges named ``prefix``*."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefix) and "CPU" in str(e.device_type()):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
    return sorted(out)


def within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_no_profiler_gives_the_shared_noop_and_never_record_function(
        monkeypatch):
    calls = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    assert tracing.profiler_span("serve.x") is tracing._NOOP
    a, b, _ = two_requests(engine())
    train_step()
    assert a.status == b.status == "completed"
    assert calls == []
    # The same code under a profiler does enter it (the counter counts).
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert not isinstance(tracing.profiler_span("serve.x"),
                              type(tracing._NOOP))
        two_requests(engine())
        train_step()
    assert set(SERVE_SPANS + TRAIN_SPANS) <= set(calls)


def test_profiler_span_needs_no_torch_import(monkeypatch):
    monkeypatch.delitem(__import__("sys").modules, "torch.autograd.profiler")
    assert tracing.profiler_span("serve.x") is tracing._NOOP


@pytest.mark.parametrize("paged_attn", ["kernel", "gather"])
def test_engine_spans_nest_as_the_layers(paged_attn):
    eng = engine(paged_attn=paged_attn)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, _, steps = two_requests(eng)
    spans = host_spans(prof, "serve.")
    names = [s[2] for s in spans]
    assert set(names) == set(SERVE_SPANS)
    step_spans = [s for s in spans if s[2] == "serve.engine_step"]
    assert len(step_spans) == steps == 3
    for s in spans:
        if s[2] != "serve.engine_step":
            assert any(within(s, st) for st in step_spans), s
    # One chunk a span: A's, then B's two; a first token for each request.
    assert names.count("serve.chunk") == 3
    assert names.count("serve.first_token") == 2
    firsts = [s for s in spans if s[2] == "serve.first_token"]
    for c in (s for s in spans if s[2] == "serve.chunk"):
        assert not any(within(f, c) for f in firsts)
    # Each decode: the launch, then the sync, then the emission.
    for st in step_spans:
        inside = [s for s in spans if within(s, st)]
        launch, sync, emit = (
            [s for s in inside if s[2] == n]
            for n in ("serve.decode_launch", "serve.sync", "serve.emit"))
        assert len(launch) == len(sync) == len(emit) == 1
        assert launch[0][1] <= sync[0][0] and sync[0][1] <= emit[0][0]


def test_trainer_spans_in_order():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train_step()
    spans = host_spans(prof, "train.")
    assert [s[2] for s in spans] == list(TRAIN_SPANS)
    assert spans[0][1] <= spans[1][0] and spans[1][1] <= spans[2][0]


def test_row_counters_on_a_hand_counted_schedule():
    eng = engine()
    a, b, steps = two_requests(eng)
    assert [len(a.output), len(b.output)] == [4, 3] and steps == 3
    # Chunks A(0, 3), B(0, 8), B(8, 2), each gathering the whole table of
    # max_seq / page = 8 pages.
    assert eng.prefill_rows_gathered == 3 * (SMALL["max_seq"] // PAGE) * PAGE
    assert eng.prefill_rows_needed == 3 + 8 + 10
    # Step 1: A decodes from row 3, B parked mid-prefill at seq_cap - 1;
    # step 2: A from 4, B from 10 (its last chunk ran); step 3: 5 and 11.
    assert eng.decode_rows_read == (4 + 64) + (5 + 11) + (6 + 12)
    assert eng.decode_rows_live == 4 + (5 + 11) + (6 + 12)


def test_free_slots_read_from_where_the_device_moved_them():
    eng = engine()
    eng.submit([1, 2, 3], max_new=1)   # done in its first decode step
    c = eng.submit([5, 6, 7], max_new=4)
    eng.step()  # both prefill; decode from row 3 in both slots
    eng.step()  # slot 0 free: its position moved on with the batch
    assert eng._host_positions[0] == 5 and eng._host_positions[1] == 5
    eng.drain()
    assert c.status == "completed"
    assert eng.decode_rows_read == sum(
        2 * (p + 1) for p in range(3, 3 + eng.decode_steps_total))


def test_gather_read_counts_every_row():
    eng = engine(paged_attn="gather")
    two_requests(eng)
    width = SMALL["max_seq"]
    assert eng.decode_rows_read == 3 * 2 * width
    assert eng.decode_rows_live == (1 + 2 + 2) * width


def test_block_decode_counts_each_round():
    eng = engine(decode_block=2)
    r = eng.submit([1, 2, 3], max_new=4)
    eng.drain()
    assert r.status == "completed" and eng.decode_steps_total == 4
    # Two blocks of two rounds, from rows 3 and 5; the free slot 1 sits at
    # row 0 until it moves on with the batch.
    assert eng.decode_rows_live == (4 + 5) + (6 + 7)
    assert eng.decode_rows_read == eng.decode_rows_live + (1 + 2) + (3 + 4)


def test_queue_wait_is_the_ttft_a_slot_was_not_serving_it():
    eng = engine(slots=1)
    first = eng.submit([1, 2, 3], max_new=6)
    second = eng.submit([4, 5, 6], max_new=2)
    eng.drain()
    for r in (first, second):
        assert r.status == "completed"
        assert 0.0 <= r.queue_wait_s <= r.ttft_s
    # The second waits in the queue while the first holds the one slot.
    service = first.ttft_s - first.queue_wait_s
    assert second.queue_wait_s >= service
    assert second.queue_wait_s >= first.ttft_s


def test_speculative_rounds_take_the_same_spans():
    eng = engine(spec_len=2, spec_source="prompt")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r = eng.submit([1, 2, 3, 1, 2, 3, 1, 2], max_new=6)
        eng.drain()
    assert r.status == "completed" and eng.spec_rounds_total > 0
    names = {s[2] for s in host_spans(prof, "serve.")}
    assert names == set(SERVE_SPANS)
    assert eng.decode_rows_read == eng.decode_steps_total * 2 * 64
