"""What the program's own spans and counters say about a traced slice.

The program (``tpumon_torch``) opens ``torch.profiler.record_function``
ranges at its layer boundaries while a profiler runs
(``tracing.profiler_span``): in the serving engine ``serve.engine_step``,
``serve.admit``, ``serve.chunk``, ``serve.first_token``,
``serve.decode_launch``, ``serve.sync`` and ``serve.emit``; in the trainer
``train.forward``, ``train.backward`` and ``train.update``. The serving
engine also counts the rows its attention reads (``ROW_COUNTERS``) and
keeps each request's ``queue_wait_s``.

``reduce_program_spans`` reduces a slice's raw profiler events to the
device time and the launches of each program span: every device operation
is linked to the runtime call that enqueued it by its correlation id, and
the call's start on the host clock falls inside the innermost program span
around it, whatever the thread (autograd launches the backward from a
thread of its own). A graph launch is one launch. Only operations wholly
inside the slice count, as in ``trace.reduce_events``; what no program
span covers is reported beside the spans.

``serve_record`` and ``train_record`` give the record keys that these
readings add to a run's record, and ``READERS`` the metrics that read
them (``decode_host_ms.serve``, a cell metric, reads the slice's span
durations that ``trace.reduce_events`` already keeps). The cells' drivers do not write these keys yet; ``python3 -m
portbench.inside`` runs a cell with them, on the card: one window with no
profiler (the program's spans timed on the host clock, the counters and
queue waits read over it), then one traced window as the benchmark's:

    python3 -m portbench.inside --workload mistral7b.serve.chat \\
        --seed 12345 --seconds 45
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from portbench import stats, trace

# The benchmark's own spans (drivers/*.py), which wrap the program's calls
# from outside; every other serve./train. range is the program's.
DRIVER_SPANS = frozenset({"serve.step", "serve.prefill_chunk",
                          "serve.decode", "serve.sample", "train.step",
                          "train.feed"})
ROW_COUNTERS = ("prefill_rows_gathered", "prefill_rows_needed",
                "decode_rows_read", "decode_rows_live")


def is_program_span(name: str) -> bool:
    return name.startswith(("serve.", "train.")) and name not in DRIVER_SPANS


def _is_runtime_call(ev) -> bool:
    """A host-side CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ``cudaGraphLaunch``, ...),
    whose correlation id its device operations carry."""
    return ev.name().startswith("cu") and not ev.is_user_annotation()


def _entry() -> dict:
    return {"n": 0, "host_s": [], "self_device_s": 0.0, "self_launches": 0,
            "device_s": 0.0, "launches": 0}


def reduce_program_spans(events) -> dict:
    """Per program span name: ``n`` (ranges starting in the slice), their
    host durations ``host_s``, and the device seconds and launches of the
    operations launched inside them, with the innermost span alone
    (``self_device_s``, ``self_launches``) and with every span around the
    launch (``device_s``, ``launches``). ``uncovered`` holds the device
    seconds and launches that no program span covers (``unlinked``: those
    whose runtime call is not in the trace); ``device_s`` the device
    seconds of every operation wholly inside the slice."""
    slice_ev = [e for e in events
                if e.name() == trace.SLICE and not trace._is_device(e)]
    if not slice_ev:
        return {}
    s0 = slice_ev[0].start_ns()
    s1 = s0 + slice_ev[0].duration_ns()
    calls, spans, launched = {}, [], {}
    for e in events:
        if trace._is_device(e):
            if trace._is_span(e):
                continue
            a, d = e.start_ns(), e.duration_ns()
            if a >= s0 and a + d <= s1:
                corr = e.correlation_id()
                launched[corr] = launched.get(corr, 0) + d
        elif is_program_span(e.name()):
            a = e.start_ns()
            spans.append((a, a + e.duration_ns(), e.name()))
        elif _is_runtime_call(e):
            calls[e.correlation_id()] = e.start_ns()
    out = {name: _entry() for _, _, name in spans}
    for a, b, name in spans:
        if s0 <= a <= s1:
            out[name]["n"] += 1
            out[name]["host_s"].append((b - a) * 1e-9)
    uncovered = {"device_s": 0.0, "launches": 0, "unlinked": 0}
    linked = sorted((t, d) for corr, d in launched.items()
                    if (t := calls.get(corr)) is not None)
    unlinked = [d for corr, d in launched.items() if corr not in calls]
    uncovered["unlinked"] = len(unlinked)
    uncovered["device_s"] += sum(unlinked) * 1e-9
    uncovered["launches"] += len(unlinked)
    spans.sort()
    active: list = []
    i = 0
    for t, d in linked:
        while i < len(spans) and spans[i][0] <= t:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] >= t]
        if not active:
            uncovered["device_s"] += d * 1e-9
            uncovered["launches"] += 1
            continue
        inner = min(active, key=lambda s: s[1] - s[0])[2]
        out[inner]["self_device_s"] += d * 1e-9
        out[inner]["self_launches"] += 1
        for name in {s[2] for s in active}:
            out[name]["device_s"] += d * 1e-9
            out[name]["launches"] += 1
    return {"window_s": (s1 - s0) * 1e-9,
            "device_s": sum(launched.values()) * 1e-9,
            "spans": out, "uncovered": uncovered}


def engine_counters(engine) -> dict | None:
    """The serving engine's row counters, or None where the program has
    none (a parent commit)."""
    try:
        with engine._lock:
            return {k: int(getattr(engine, k)) for k in ROW_COUNTERS}
    except AttributeError:
        return None


def serve_record(start: dict | None, stop: dict | None, events,
                 queue_wait_s) -> dict:
    """The record keys of a serving run: the counters read at the slice's
    start and stop, the window's per-request ``queue_wait_s`` (the requests
    whose first token falls in the window, as ``ttft_ms`` has them; None
    where the program keeps none) and the program spans' reduction."""
    rec = {"program_spans": reduce_program_spans(events)}
    if start is not None and stop is not None:
        rec["engine_counters"] = {"start": start, "stop": stop}
    waits = [w for w in queue_wait_s if w is not None]
    if waits:
        rec["queue_wait_ms"] = [w * 1e3 for w in waits]
    return rec


def train_record(events) -> dict:
    return {"program_spans": reduce_program_spans(events)}


# -- the metrics these keys give (None off the card or without the key) --

def _spans(rec, kind):
    ps = rec.get("program_spans")
    if rec.get("kind") != kind or not rec.get("on_card") or not ps:
        return None
    return ps["spans"]


def _counted(rec, num: str, den: str):
    c = rec.get("engine_counters")
    if rec.get("kind") != "serve" or not rec.get("on_card") or not c:
        return None
    d = {k: c["stop"][k] - c["start"][k] for k in (num, den)}
    return 100.0 * d[num] / d[den] if d[den] else None


def queue_wait_p95_ms(rec):
    """p95 of the window's per-request queue wait (ms)."""
    if rec.get("kind") != "serve" or not rec.get("on_card"):
        return None
    return stats.percentile(rec.get("queue_wait_ms") or [], 95)


def _per_span_ms(rec, kind, name, key="self_device_s"):
    spans = _spans(rec, kind)
    s = (spans or {}).get(name)
    if not s or not s["n"]:
        return None
    return s[key] / s["n"] * 1e3


def chunk_device_ms(rec):
    """Device time launched inside ``serve.chunk`` per chunk (ms)."""
    return _per_span_ms(rec, "serve", "serve.chunk")


def launches_per_step(rec):
    """Launches inside ``serve.engine_step`` per step."""
    spans = _spans(rec, "serve")
    s = (spans or {}).get("serve.engine_step")
    return s["launches"] / s["n"] if s and s["n"] else None


def prefill_rows_useful(rec):
    return _counted(rec, "prefill_rows_needed", "prefill_rows_gathered")


def decode_rows_useful(rec):
    return _counted(rec, "decode_rows_live", "decode_rows_read")


def program_span_share(rec):
    """Share of the slice's device time that a program span covers (%)."""
    ps = rec.get("program_spans")
    if not rec.get("on_card") or not ps or not ps["device_s"]:
        return None
    return 100.0 * (1.0 - ps["uncovered"]["device_s"] / ps["device_s"])


READERS = {
    "queue_wait_p95_ms.serve": queue_wait_p95_ms,
    "chunk_device_ms.serve": chunk_device_ms,
    "prefill_rows_useful.serve": prefill_rows_useful,
    "launches_per_step.serve": launches_per_step,
    "decode_rows_useful.serve": decode_rows_useful,
    "forward_ms.train": lambda r: _per_span_ms(r, "train", "train.forward",
                                               "device_s"),
    "backward_ms.train": lambda r: _per_span_ms(r, "train",
                                                "train.backward",
                                                "device_s"),
    "update_ms.train": lambda r: _per_span_ms(r, "train", "train.update",
                                              "device_s"),
    "program_span_share": program_span_share,
}


# -- a cell run with these keys -------------------------------------------

class _Watched(trace.Slice):
    """The benchmark's slice, also reading the engine's counters at its
    start and stop and the clock at the window's start."""

    bench = None
    last = None

    def warm(self) -> None:
        super().warm()
        _Watched.last = self
        self.t_window = time.monotonic()

    def start(self) -> None:
        self.counters = [self._read()]
        super().start()

    def stop(self) -> None:
        super().stop()
        self.counters.append(self._read())

    def _read(self):
        engine = getattr(_Watched.bench, "engine", None)
        return engine_counters(engine) if engine is not None else None


class _HostClock:
    """Stands in for the program's ``profiler_span`` in a window with no
    profiler: times each span on the host clock, by name."""

    def __init__(self):
        self.seconds: dict = {}

    def __call__(self, name: str):
        return _Timed(self.seconds.setdefault(name, []))


class _Timed:
    __slots__ = ("into", "t0")

    def __init__(self, into: list):
        self.into = into

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.into.append(time.perf_counter() - self.t0)
        return False


@contextlib.contextmanager
def host_timed():
    """Time the program's spans on the host clock while no profiler runs
    (a program without them is left as it is)."""
    from tpumon_torch.loadgen import model, serving

    clock = _HostClock()
    mods = [m for m in (model, serving) if hasattr(m, "profiler_span")]
    kept = [m.profiler_span for m in mods]
    for m in mods:
        m.profiler_span = clock
    try:
        yield clock
    finally:
        for m, f in zip(mods, kept):
            m.profiler_span = f


def _window_reqs(b, t0: float, t1: float) -> list:
    """The requests whose first token falls in [t0, t1] (``ttft_ms``'s
    population)."""
    reqs = [r["req"] for r in b.done] + [r for _, r in b.live.values()]
    return [r for r in reqs
            if r.first_tok_t is not None and t0 <= r.first_tok_t <= t1]


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             device="cuda", root=None, pkg=None) -> dict:
    """Set a cell up, run one window with no profiler (the program's spans
    timed on the host clock, its counters read around the window), then
    one traced window with the program spans' keys. Returns
    ``{"untraced": {...}, "traced": record}`` (no check)."""
    import importlib

    from portbench import run

    root, pkg = root or run.ROOT, pkg or run.PKG
    cell = run.named(bench["workloads"], cell_name)
    cfg = run.load_json(root / run.named(
        bench["configs"], cell["config"])["file"])
    mix = run.load_json(pkg / "traffic" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    b = driver.Bench(cfg, mix, seed, device)
    b.setup()
    engine = getattr(b, "engine", None)
    before = engine_counters(engine) if engine is not None else None
    with host_timed() as clock:
        t0 = time.monotonic()
        plain = b.window(seconds, False)
    plain["host_s"] = clock.seconds
    if b.kind == "serve":
        plain["engine_counters"] = {"start": before,
                                    "stop": engine_counters(engine)}
        plain["queue_wait_s"] = [getattr(r, "queue_wait_s", None) for r in
                                 _window_reqs(b, t0, t0 + plain["window_s"])]
    _Watched.bench = b
    kept = trace.Slice
    trace.Slice = _Watched
    try:
        rec = b.window(seconds, True)
    finally:
        trace.Slice = kept
    sl = _Watched.last
    rec["on_card"] = str(device).startswith("cuda")
    if b.kind == "serve":
        waits = [getattr(r, "queue_wait_s", None) for r in _window_reqs(
            b, sl.t_window, sl.t_window + rec["window_s"])]
        rec.update(serve_record(sl.counters[0], sl.counters[-1], sl.events,
                                waits))
    else:
        rec.update(train_record(sl.events))
    return {"untraced": plain, "traced": rec}


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds a ``profiler_span`` costs with no profiler
    running and under one (CPU activity), per ``with`` block; None where
    the program has none."""
    import torch

    try:
        from tpumon_torch.tracing import profiler_span
    except ImportError:
        return None

    def loop(k):
        t = time.perf_counter()
        for _ in range(k):
            with profiler_span("serve.cost"):
                pass
        return (time.perf_counter() - t) / k * 1e6

    off = loop(n)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = loop(n // 10)
    return {"off_us": off, "on_us": on}


def _p(values, q=50, scale=1.0):
    v = stats.percentile(values or [], q)
    return None if v is None else v * scale


def summary(runs: dict) -> dict:
    """The numbers ``main`` prints: the untraced window's step time, tails,
    counters and spans' host medians; the traced window's metrics, step
    times inside and outside the slice, and the spans' reduction."""
    from portbench import run

    plain, rec = runs["untraced"], runs["traced"]
    out = {"metrics": {k: f(rec) for k, f in READERS.items()}}
    if rec["kind"] == "serve":
        out["metrics"]["decode_host_ms.serve"] = run.reader(
            "decode_host_ms.serve")(rec)
    u = {"host_ms_p50": {k: _p(v, 50, 1e3)
                         for k, v in plain["host_s"].items()}}
    if rec["kind"] == "serve":
        c = plain.get("engine_counters") or {}
        counted = {"kind": "serve", "on_card": True, "engine_counters": (
            c if c.get("start") and c.get("stop") else None)}
        waits = [w * 1e3 for w in plain["queue_wait_s"] if w is not None]
        u.update(step_p50_ms=_p(plain["steps_ms"]),
                 ttft_p95_ms=_p(plain["ttft_ms"], 95),
                 tpot_p95_ms=_p(plain["tpot_ms"], 95),
                 tokens_per_s=plain["tokens"] / plain["window_s"],
                 queue_wait_p95_ms=_p(waits, 95),
                 prefill_rows_useful=prefill_rows_useful(counted),
                 decode_rows_useful=decode_rows_useful(counted))
        out["traced"] = {
            "ttft_p95_ms": _p(rec["ttft_ms"], 95),
            "step_p50_ms_outside_slice": _p(rec["steps_ms"]),
            "step_p50_ms_inside_slice": _p(
                rec["slice"]["spans"].get("serve.step"), 50, 1e3)}
    else:
        u["tokens_per_s"] = plain["tokens"] / plain["window_s"]
        out["traced"] = {"tokens_per_s": rec["tokens"] / rec["window_s"]}
    out["untraced"] = u
    sl = rec["slice"]
    out["slice"] = {"window_s": sl["window_s"], "busy_s": sl["busy_s"],
                    "idle_gaps": sl["idle_gaps"]}
    ps = rec["program_spans"]
    out["program_spans"] = {
        "device_s": ps["device_s"], "uncovered": ps["uncovered"],
        "spans": {k: {**v, "host_s": sum(v["host_s"])}
                  for k, v in ps["spans"].items()}}
    return out


def main(argv=None) -> int:
    from portbench import run

    run.cache_bytecode()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.inside")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.inside: needs a CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    runs = run_cell(bench, args.workload, args.seed % (1 << 63),
                    args.seconds)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0), **summary(runs),
           "span_cost": span_cost_us()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
