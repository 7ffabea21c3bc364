"""Collector layer (the reference's L1, SURVEY.md §1).

The reference collects synchronously per HTTP request — three blocking
``execSync`` shell-outs on the Node event loop (monitor_server.js:72,85,99).
tpumon collectors are instead invoked by a background sampler
(tpumon.sampler) on fixed cadences; each returns a Sample envelope that
carries explicit health (ok / error / latency) so degraded sources are
distinguishable from genuinely-empty data (SURVEY §7 "honest degraded
modes").

Collectors expose an async ``collect()``; anything that must block (file
IO is cheap enough inline; subprocess fallbacks use asyncio subprocesses)
must not stall the event loop.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

from tpumon_torch.resilience import DEADLINE_ERROR, DeadlineExceeded, collect_bounded


@dataclass
class Sample:
    """Result envelope for one collection attempt."""

    source: str
    ok: bool
    data: Any
    error: str | None = None
    ts: float = field(default_factory=time.time)
    latency_ms: float = 0.0
    # Non-error caveats about the source (e.g. "temp_c unavailable on
    # this platform") — shown in /api/health and the dashboard health
    # strip without flipping ok to False.
    notes: list[str] = field(default_factory=list)

    def health_json(self) -> dict:
        return {
            "source": self.source,
            "ok": self.ok,
            "error": self.error,
            "ts": self.ts,
            "latency_ms": round(self.latency_ms, 3),
            "notes": self.notes,
        }


@runtime_checkable
class Collector(Protocol):
    name: str

    async def collect(self) -> Sample: ...


async def run_collector(
    c: Collector, deadline_s: float | None = None, orphans: dict | None = None
) -> Sample:
    """Invoke a collector, timing it and converting exceptions to a
    degraded Sample (the reference's silent-degradation contract,
    monitor_server.js:80,94,113 — but with the error recorded).

    With ``deadline_s``, the collect is wall-clock bounded
    (tpumon.resilience.collect_bounded): a hung collector degrades to an
    ``error="deadline exceeded"`` Sample at the deadline instead of
    blocking the sampler loop forever, and the orphaned task is
    cancelled/reaped so it cannot leak. ``orphans`` (caller-owned) caps
    a wedged source at one outstanding orphan — see collect_bounded.
    """
    t0 = time.monotonic()
    try:
        if deadline_s is not None and deadline_s > 0:
            s = await collect_bounded(c, deadline_s, orphans=orphans)
        else:
            s = await c.collect()
    except DeadlineExceeded as e:
        s = Sample(source=c.name, ok=False, data=None, error=f"{DEADLINE_ERROR}: {e}")
    except Exception as e:  # degrade, never crash the sampler
        s = Sample(source=c.name, ok=False, data=None, error=f"{type(e).__name__}: {e}")
    s.latency_ms = (time.monotonic() - t0) * 1e3
    return s
