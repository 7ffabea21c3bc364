"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell names a configuration
(``configs/<config>.json``, through ``BENCHMARK.json``'s ``file``) and a
traffic mix (``traffic/<mix>.json``); the mix names its driver
(``drivers/<driver>.py``), which builds the program from those files,
warms it up (set-up), runs the measured window and, once the window has
closed, the program's state freed and the memory peak read, compares
what the window produced with the plain reference. Each metric of the
cell is read from the run's record by ``metrics/<metric>.py``; the
limits of the comparison are ``limits/<cell>.json``. So a new model, mix,
metric or cell is new files and entries, with no edit here.

The last line of standard output is the result, one JSON object; the
numbers compared, each with its limit, are also the last lines of
standard error. Without a CUDA device (or with fewer than the cell asks
for) it prints no result and exits 2. It exits 3, with no result, if
JAX or the JAX package got loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# Top-level module names that may not be loaded: JAX, its libraries, and
# the JAX package the port was made from (compared whole, so the port's
# own name, which begins with it, is allowed).
FORBIDDEN = ("jax", "jaxlib", "flax", "tpumon")


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def named(items: list, name: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no entry named {name!r}")


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metric entries a run of ``cell`` reports: its end-to-end ones
    untraced, its per-layer ones traced."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str, pkg: Path = PKG):
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden(modules) -> list[str]:
    """The forbidden top-level names among module names."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def loaded_forbidden() -> list[str]:
    return forbidden(list(sys.modules))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number with a limit at or
    under it; a number without a limit, or one that is not finite, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        lim = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": lim}
        ok = ok and lim is not None and math.isfinite(value) and value <= lim
    return ok and bool(out), out


def execute(bench: dict, cell_name: str, seed: int, seconds: float,
            traced: bool, device, root: Path = ROOT, pkg: Path = PKG,
            t_start: float | None = None, log=None) -> dict:
    """Run one cell and return the result (and, under ``record``, the
    run's record). Off a CUDA device the result holds no metric."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.monotonic() if t_start is None else t_start
    cell = named(bench["workloads"], cell_name)
    cfg = load_json(root / named(bench["configs"], cell["config"])["file"])
    mix = load_json(pkg / "traffic" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    on_card = torch.device(device).type == "cuda"
    b = driver.Bench(cfg, mix, seed, device)
    marks = [("start", t_start), ("imports", time.monotonic())]
    b.setup(lambda name: marks.append((name, time.monotonic())))
    setup_s = time.monotonic() - t_start - b.check_s
    log(f"portbench: set-up {setup_s:.3f} s (check readings "
        f"{b.check_s:.3f} s apart)")
    log("portbench: set-up parts " + ", ".join(
        f"{name} {t - t0:.3f}" for (_, t0), (name, t) in zip(marks, marks[1:])))
    if on_card:
        torch.cuda.synchronize()
    rec = b.window(seconds, traced)
    rec["setup_s"] = setup_s
    rec["on_card"] = on_card
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if on_card else 0}
    if on_card:
        from portbench.counts import card_peaks

        rec["peaks"] = card_peaks(dev["kind"])
    b.release()
    t = time.monotonic()
    numbers = b.check()
    log(f"portbench: check {time.monotonic() - t:.3f} s")
    lim_path = pkg / "limits" / f"{cell_name}.json"
    limits = load_json(lim_path) if lim_path.exists() else {}
    correct, check = judge(numbers, limits)
    metrics = {}
    for m in cell_metrics(bench, cell_name, traced) if on_card else []:
        value = reader(m["name"], pkg)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": dev}
    sl = rec.get("slice")
    if traced and on_card and sl:
        dev["busy_s"] = sl["busy_s"]
        dev["window_s"] = sl["window_s"]
        result["breakdown"] = {"device_ops": sl["device_ops"],
                               "idle_gaps": sl["idle_gaps"]}
    result["check"] = check
    result["record"] = rec
    return result


def cache_bytecode(root: Path = ROOT) -> None:
    """Keep the bytecode of every module this process imports under the
    checkout (``.cache/pycache``), so that only a checkout's first run
    compiles it. Torch alone is some 2,000 modules, which take seconds
    of host time to compile, and some machines install it without
    bytecode and set ``PYTHONDONTWRITEBYTECODE``."""
    sys.pycache_prefix = str(root / ".cache" / "pycache")
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    cache_bytecode()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = named(bench["workloads"], args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine shows {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    import tpumon_torch  # noqa: F401  (the program must be in the checkout)

    result = execute(bench, args.workload, args.seed % (1 << 63),
                     args.seconds, bool(args.trace), "cuda",
                     t_start=T_START)
    result.pop("record")
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
