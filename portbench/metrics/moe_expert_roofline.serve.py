"""moe_expert_roofline.serve: the least time of the routed layers'
expert products in the traced slice over their device time (%).

A call is one routed layer's FFN over one prefill chunk (its ``length``
tokens, each a row) or one decode step (its decoding requests live,
``slots`` rows routed); its bound is the family's
``expert_call_bound_s``: the live pairs' FLOPs, or the weights of the
shared experts and of the most routed experts its rows reach read once.
A decode step's rows reach every expert (the engine's counters, PERF.md
§6); a chunk's reach fewer than that most, so its weight reads
are counted high. The products are the grouped GEMMs of
``torch._grouped_mm`` (CUTLASS on sm_90, two a call: gate and up, then
down) and their set-up kernels, found by name; None when the GEMMs are
not two a routed layer a call."""

from portbench import families
from portbench.kernels import decode_rounds

EXPERT_GEMM = "GroupProblemShape"
EXPERT_PREP = "prepare_grouped_gemm_data"


def read(rec):
    work, sl, peaks = rec.get("slice_work"), rec.get("slice"), rec.get("peaks")
    s = rec.get("sizes")
    if rec.get("kind") != "serve" or not rec.get("on_card") or not (
            work and sl and peaks and work["prefill_seen"]):
        return None
    bound = getattr(families.of(rec), "expert_call_bound_s", None)
    if bound is None:
        return None
    calls = [(length, length) for _, length in work["chunks"]]
    calls += [(len(contexts), s.slots) for step in work["steps"]
              for contexts in decode_rounds(step)]
    least = sum(s.routed_layers * bound(s, tokens, rows, rec["elem"],
                                        peaks.hbm, peaks.bf16)
                for tokens, rows in calls)
    gemms = sum(c for name, (c, _) in sl["ops"].items()
                if EXPERT_GEMM in name)
    spent = sum(t for name, (_, t) in sl["ops"].items()
                if EXPERT_GEMM in name or EXPERT_PREP in name)
    if not calls or gemms != 2 * s.routed_layers * len(calls) or not spent:
        return None
    return 100.0 * least / spent
