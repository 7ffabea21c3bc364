"""latent_attn_roofline.serve: the least time of every latent decode call
in the traced slice over the paged kernel's device time (%). A call is
one layer of one decode step, the absorbed read of the latent pool as K
and as V at once; its bound (the family's ``latent_call_bound_s``) reads
each live latent row once, with q, out, tables and lengths, the lengths
taken per step from the requests' tokens. None for a family without
that bound, or when the paged launches are not layers x calls."""

from portbench import families
from portbench.kernels import decode_rounds, is_paged


def read(rec):
    work, sl, peaks = rec.get("slice_work"), rec.get("slice"), rec.get("peaks")
    s = rec.get("sizes")
    if rec.get("kind") != "serve" or not rec.get("on_card") or not (
            work and sl and peaks):
        return None
    bound = getattr(families.of(rec), "latent_call_bound_s", None)
    if bound is None:
        return None
    least, calls = 0.0, 0
    for step in work["steps"]:
        for contexts in decode_rounds(step):
            least += s.n_layers * bound(s, contexts, rec["max_pages"],
                                        rec["elem"], peaks.hbm, peaks.bf16)
            calls += s.n_layers
    count = sum(c for name, (c, _) in sl["ops"].items() if is_paged(name))
    spent = sum(t for name, (_, t) in sl["ops"].items() if is_paged(name))
    if not calls or count != calls or not spent:
        return None  # launches do not match the decode calls counted
    return 100.0 * least / spent
