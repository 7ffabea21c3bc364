"""flash_roofline.train: the least time of every flash launch in the
traced slice (counts.flash_bounds at the step's shape: batch x heads,
the sequence, the head dim) over the launches' device time (%)."""

from portbench.counts import flash_bounds
from portbench.kernels import flash_kind


def read(rec):
    sl, peaks, s = rec.get("slice"), rec.get("peaks"), rec.get("sizes")
    if rec.get("kind") != "train" or not rec.get("on_card") or not (
            sl and peaks):
        return None
    bounds = flash_bounds(rec["batch"] * s.n_heads, rec["seq"], s.head_dim,
                          rec["elem"], peaks.hbm, peaks.bf16)
    least = spent = 0.0
    seen = set()
    for name, (count, t) in sl["ops"].items():
        kind = flash_kind(name)
        if kind is None:
            continue
        seen.add(kind)
        least += count * bounds[kind][0] * 1e-3
        spent += t
    if seen != set(bounds) or not spent:
        return None
    return 100.0 * least / spent
