"""ttft_p95_ms: 95th percentile, over every request whose first token
falls in the window, of submission to first token (host clock)."""

from portbench.stats import percentile


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return percentile(rec["ttft_ms"], 95)
