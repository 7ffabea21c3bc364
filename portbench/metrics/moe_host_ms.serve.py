"""moe_host_ms.serve: median host duration of the program's own
``serve.moe`` span (one routed layer's FFN launched: router, grouped
expert products, combine) over the traced slice (ms). Read from inside
the program: its span's durations in the slice's reduction; None where
the program opens no such span."""

from portbench.stats import percentile


def read(rec):
    sl = rec.get("slice")
    if rec.get("kind") != "serve" or not rec.get("on_card") or not sl:
        return None
    durations = sl["spans"].get("serve.moe")
    return percentile(durations, 50) * 1e3 if durations else None
