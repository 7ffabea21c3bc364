"""paged_attn_roofline.serve: the least time of every paged-attention
call in the traced slice over the paged kernel's device time (%). A
call is one layer of one decode step; its bound counts q, out and the
K/V rows of the live sequences' lengths, read once
(counts.paged_call_bound_s), the lengths taken per step from the
requests' tokens."""

from portbench.counts import paged_call_bound_s
from portbench.kernels import decode_rounds, is_paged


def read(rec):
    work, sl, peaks = rec.get("slice_work"), rec.get("slice"), rec.get("peaks")
    s = rec.get("sizes")
    if rec.get("kind") != "serve" or not rec.get("on_card") or not (
            work and sl and peaks):
        return None
    least, calls = 0.0, 0
    for step in work["steps"]:
        for contexts in decode_rounds(step):
            least += s.n_layers * paged_call_bound_s(
                s, contexts, rec["max_pages"], rec["elem"], peaks.hbm,
                peaks.bf16)
            calls += s.n_layers
    count = sum(c for name, (c, _) in sl["ops"].items() if is_paged(name))
    spent = sum(t for name, (_, t) in sl["ops"].items() if is_paged(name))
    if not calls or count != calls or not spent:
        return None  # launches do not match the decode calls counted
    return 100.0 * least / spent
