"""Latency summaries (copy of ``quantiles`` from ``tpumon/tracing.py``;
the span tracer itself belongs to the monitor core, not yet ported)."""

from __future__ import annotations


def quantiles(xs) -> tuple[float, float, float] | None:
    """(p50, p95, max) from one sort — the single-pass-per-render
    replacement for calling ``statistics.median`` per field."""
    if not xs:
        return None
    s = sorted(xs)
    n = len(s)
    return s[int(0.50 * (n - 1))], s[int(0.95 * (n - 1))], s[-1]
