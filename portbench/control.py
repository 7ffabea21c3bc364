"""Readings of the lower-precision control and the planted faults.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \\
        --seconds 10

runs the cell on each seed as ``portbench.run`` does (set-up, a window of
the given seconds, the state freed) and prints, per seed, one JSON line
of the numbers compared: the program's, and the control's, the reference
computed one precision below the configuration's (float8 e4m3 products
for bfloat16) in the program's place. For a training cell it also reads
the planted fault "half the batch left out, the mean over the rest" in
the reference put in the program's place; "the state left unchanged"
reads 1 by the measure and needs no run. The benchmark's own runs never
run this; its readings set the upper ends of ``limits/<cell>.json``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from portbench.run import ROOT, PKG, load_json, named


def readings(bench: dict, cell_name: str, seed: int, seconds: float,
             device, root=ROOT, pkg=PKG) -> dict:
    cell = named(bench["workloads"], cell_name)
    cfg = load_json(root / named(bench["configs"], cell["config"])["file"])
    mix = load_json(pkg / "traffic" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    b = driver.Bench(cfg, mix, seed, device)
    b.setup()
    b.window(seconds, False)
    b.release()
    if b.kind == "serve":
        got = b.check(control=True)
        return {"program": {"logit_gap": got["logit_gap"]},
                "control": {"logit_gap": got["control_logit_gap"]}}
    prog, ctl, half = b.against_reference(
        [{}, {"prec": "fp8"}, {"half_batch": True}])
    return {"program": prog, "control": ctl, "half_batch": half}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        out = readings(bench, args.workload, seed, args.seconds, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
