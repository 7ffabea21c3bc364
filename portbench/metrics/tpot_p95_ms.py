"""tpot_p95_ms: 95th percentile, over every request completed in the
window, of its mean gap between output tokens (host clock)."""

from portbench.stats import percentile


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return percentile(rec["tpot_ms"], 95)
