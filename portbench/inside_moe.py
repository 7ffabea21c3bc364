"""What the routed FFN's counters say about a traced slice of a cell.

    python3 -m portbench.inside_moe --workload dsv2lite.serve.sharegpt \\
        --seed 12345 --seconds 45

runs the cell's set-up and one traced window as the benchmark does, and
reads the serving engine's routed counters at the slice's start and stop
only: ``moe_rows`` on the device ([routed layers, 2, experts]: each
expert's rows, and the calls that gave it any) and, on the host,
``moe_pairs_routed`` and ``decode_steps_total``; the prefill chunks count
into counters of their own. A routed layer's calls in the slice are its
decode steps and its prefill chunks. It prints one JSON line: per kind
of call and routed layer, whether every call reached every expert, the
fewest calls an expert was reached in, the share of (call, expert) pairs
with rows, the rows of the busiest expert over the mean; the pairs
routed; the slice's counts of
the program's ``serve.engine_step`` and ``serve.sync`` spans; and the
cell's per-layer metrics read from the record. No check is made.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from portbench import run, trace


class _Counted(trace.Slice):
    """The benchmark's slice, reading the engine's routed counters at its
    start and stop, outside the profiled time. Its prefill chunks count
    into counters of their own (``prefill_rows``), so the decode steps'
    and the chunks' calls are told apart."""

    engine = None
    prefill_rows = None
    last = None

    def start(self) -> None:
        self.counters = [self._read()]
        _Counted.last = self
        super().start()

    def stop(self) -> None:
        super().stop()
        self.counters.append(self._read())

    def _read(self) -> dict:
        e = _Counted.engine
        with e._lock:
            host = {"pairs": e.moe_pairs_routed,
                    "decode_steps": e.decode_steps_total}
        return {**host, "rows": e.moe_rows.tolist(),
                "prefill": _Counted.prefill_rows.tolist()}


def routed_layers(start: list, stop: list, calls: int) -> list:
    """Per routed layer, from the counters [2, experts] at a slice's start
    and stop over ``calls`` calls: whether every call reached every
    expert, the fewest calls an expert was reached in, the rows, the share
    of (call, expert) pairs with rows, and the busiest expert's rows over
    the mean."""
    layers = []
    for a, b in zip(start, stop):
        rows = [y - x for x, y in zip(a[0], b[0])]
        reached = [y - x for x, y in zip(a[1], b[1])]
        mean = sum(rows) / len(rows)
        layers.append({"every_call_every_expert": min(reached) == calls,
                       "fewest_calls_reached": min(reached),
                       "rows": sum(rows),
                       "reached_share": sum(reached) / (len(reached) * calls)
                       if calls else None,
                       "max_over_mean": max(rows) / mean if mean else None})
    return layers


def routed_summary(start: dict, stop: dict, chunks: int) -> dict:
    """The counters' differences over a slice with ``chunks`` prefill
    chunks in it: the decode steps' calls and the chunks' apart."""
    steps = stop["decode_steps"] - start["decode_steps"]
    return {"pairs_routed": stop["pairs"] - start["pairs"],
            "decode": {"calls": steps, "layers": routed_layers(
                start["rows"], stop["rows"], steps)},
            "prefill": {"calls": chunks, "layers": routed_layers(
                start["prefill"], stop["prefill"], chunks)}}


def main(argv=None) -> int:
    run.cache_bytecode()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.inside_moe")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.inside_moe: needs a CUDA device", file=sys.stderr)
        return 2
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell = run.named(bench["workloads"], args.workload)
    cfg = run.load_json(run.ROOT / run.named(
        bench["configs"], cell["config"])["file"])
    mix = run.load_json(run.PKG / "traffic" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    b = driver.Bench(cfg, mix, args.seed % (1 << 63), "cuda")
    b.setup()
    _Counted.engine = b.engine
    _Counted.prefill_rows = torch.zeros_like(b.engine.moe_rows)
    from tpumon_torch.loadgen import serving

    prefill = serving.paged_prefill

    def own_counters(*a, **k):
        return prefill(*a, **{**k, "moe_rows": _Counted.prefill_rows})

    kept = trace.Slice
    trace.Slice = _Counted
    serving.paged_prefill = own_counters
    try:
        rec = b.window(args.seconds, True)
    finally:
        trace.Slice = kept
        serving.paged_prefill = prefill
    rec["on_card"] = True
    from portbench.counts import card_peaks

    rec["peaks"] = card_peaks(torch.cuda.get_device_name(0))
    counters = _Counted.last.counters
    spans = rec["slice"]["spans"]
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "routed": routed_summary(counters[0], counters[-1],
                                    len(rec["slice_work"]["chunks"])),
           "spans_in_slice": {name: len(spans.get(name, [])) for name in (
               "serve.engine_step", "serve.sync", "serve.decode_launch",
               "serve.moe", "serve.latent_attn")},
           "metrics": {m["name"]: run.reader(m["name"])(rec)
                       for m in run.cell_metrics(bench, args.workload,
                                                 True)},
           "busy_s": rec["slice"]["busy_s"],
           "window_s": rec["slice"]["window_s"],
           "device_ops": rec["slice"]["device_ops"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
