"""engine_step_p50_ms.serve: median of the benchmark's host-clock span
around each engine.step() call of the traced run's window, the profiled
slice left out."""

from portbench.stats import percentile


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return percentile(rec["steps_ms"], 50)
