"""serve_mfu: model FLOPs of the tokens prefilled (at their true
lengths) and emitted in the traced slice (the record's family's
serve_flops) over the slice times the card's bf16 peak (%)."""

from portbench import families
from portbench.kernels import decode_rounds


def read(rec):
    work, sl, peaks = rec.get("slice_work"), rec.get("slice"), rec.get("peaks")
    if rec.get("kind") != "serve" or not rec.get("on_card") or not (
            work and sl and peaks):
        return None
    firsts = sum(1 for step in work["steps"] for _, o, _ in step if o == 0)
    if not work["prefill_seen"] or (firsts and not work["chunks"]):
        return None  # prefill chunks ran but were not counted
    ctx = [c for step in work["steps"] for calls in decode_rounds(step)
           for c in calls]
    emitted = sum(o2 - o for step in work["steps"] for _, o, o2 in step)
    flops = families.of(rec).serve_flops(rec["sizes"], work["chunks"], ctx,
                                         emitted)
    return 100.0 * flops / (sl["window_s"] * peaks.bf16)
