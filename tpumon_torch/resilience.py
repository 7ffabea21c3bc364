"""Resilience substrate: deadlines, circuit breakers, loop watchdogs.

The data plane's honest-degraded-modes contract (SURVEY §7) only covered
collectors that *raise*: run_collector converts exceptions to degraded
Samples. A collector that **hangs** — stuck kubectl child, wedged libtpu
gRPC channel, DNS stall inside a thread-offloaded urllib call — blocked
the sequential tick loop indefinitely, freezing history, alerting and
every other source behind it. This module closes that gap:

- ``collect_bounded``: bounds one ``collect()`` with a wall-clock
  deadline. On expiry the caller gets ``DeadlineExceeded`` immediately;
  the orphaned task is cancelled and reaped via callback, never awaited
  — a task that ignores cancellation (e.g. wedged in a worker thread)
  cannot re-block the loop, it just drains when it eventually dies.
- ``CircuitBreaker``: per-source closed / open / half-open state with
  exponential backoff + jitter. After ``failure_threshold`` consecutive
  failures the source is probed at a decaying cadence instead of full
  rate, so a dead kubectl doesn't burn a subprocess (and a deadline's
  worth of tick budget) every second. Jitter keeps a fleet of monitors
  from re-probing a shared dependency in lockstep.
- ``LoopWatchdog``: tick lag/skew and swallowed-exception accounting for
  the sampler loops — ``except Exception: pass`` kept the loop alive
  but silently; now every swallow is counted and the last error kept.

All three surface through /api/health, the /metrics exporter and the
``source-down`` alert rule (tpumon.alerts), so degraded sources page
instead of silently going stale.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field

DEADLINE_ERROR = "deadline exceeded"


def decorrelated_jitter(
    prev_s: float,
    base_s: float = 0.25,
    cap_s: float = 5.0,
    rng: random.Random | None = None,
) -> float:
    """Next retry delay, AWS-style decorrelated jitter:
    ``min(cap, uniform(base, prev * 3))``.

    Pure exponential backoff keeps a fleet in lockstep: when a shared
    upstream (a federation root, a polled peer) dies, every client's
    retry clock started at the same instant, so the root's replacement
    takes the whole herd's reconnects simultaneously — at 64 leaves
    that synchronized stampede IS the second outage. Decorrelating off
    the *previous* delay spreads retries across the full [base, cap]
    window within a couple of rounds while keeping the mean growth
    exponential, and the cap bounds worst-case reconnect latency
    fleet-wide (tests/test_federation_ha.py pins the spread)."""
    r = rng if rng is not None else random
    lo = max(0.001, base_s)
    hi = max(lo, prev_s * 3.0)
    return min(max(0.001, cap_s), r.uniform(lo, hi))


class DeadlineExceeded(Exception):
    """A collect() exceeded its wall-clock deadline."""


def _reap(task: asyncio.Task) -> None:
    # Retrieve the orphan's outcome so the loop never logs
    # "exception was never retrieved" for a collector that dies after
    # its deadline already degraded the sample.
    if not task.cancelled():
        task.exception()


async def collect_bounded(collector, deadline_s: float,
                          orphans: dict | None = None):
    """``await collector.collect()`` bounded by ``deadline_s``.

    Unlike bare ``asyncio.wait_for`` — which *awaits the cancellation*,
    so a task that swallows CancelledError (or is pinned in a wedged
    worker thread) hangs the caller anyway — this returns control at the
    deadline unconditionally: the orphan is cancelled, handed a reaper
    callback, and abandoned.

    ``orphans`` (a caller-owned {source-name: task} dict) contains the
    blast radius of a *wedged* orphan: cancellation cannot interrupt a
    thread stuck in blocking I/O (kubectl on dead NFS, urllib on a
    black-holed apiserver), so each abandoned collect can pin one
    shared-executor thread. While a source's previous orphan is still
    alive, a new collect is refused outright — one wedged source holds
    at most ONE executor thread, instead of leaking one per breaker
    probe until every other source's to_thread calls starve.
    """
    name = getattr(collector, "name", "?")
    if orphans is not None:
        prev = orphans.get(name)
        if prev is not None:
            if not prev.done():
                raise DeadlineExceeded(
                    f"{name}.collect() previous attempt still wedged past "
                    f"its deadline; refusing to stack another"
                )
            orphans.pop(name, None)
    task = asyncio.ensure_future(collector.collect())
    try:
        done, _ = await asyncio.wait({task}, timeout=deadline_s)
    except asyncio.CancelledError:
        # The CALLER was cancelled (sampler shutdown mid-collect):
        # asyncio.wait — unlike wait_for — does not cancel its futures,
        # so the in-flight collect must be cancelled and reaped here too
        # or it outlives the sampler.
        task.cancel()
        task.add_done_callback(_reap)
        raise
    if done:
        return task.result()  # raises the collector's own exception, if any
    task.cancel()
    task.add_done_callback(_reap)
    if orphans is not None:
        orphans[name] = task
    raise DeadlineExceeded(
        f"{name}.collect() exceeded {deadline_s:g}s deadline"
    )


# ------------------------------ breaker --------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclass
class CircuitBreaker:
    """Per-source poll gate: closed (full rate) → open (backoff) →
    half-open (single probe) → closed on success / re-open on failure
    with doubled backoff.

    Clock-injectable (monotonic seconds) and rng-injectable so tests
    drive the full lifecycle deterministically.
    """

    failure_threshold: int = 3
    base_backoff_s: float = 5.0
    max_backoff_s: float = 300.0
    jitter_frac: float = 0.2
    clock: object = time.monotonic
    rng: random.Random = field(default_factory=random.Random)

    state: str = CLOSED
    consecutive_failures: int = 0
    opened_count: int = 0  # total closed/half-open -> open transitions
    _backoff_s: float = field(default=0.0, repr=False)
    _next_probe: float = field(default=0.0, repr=False)

    def allow(self, now: float | None = None) -> bool:
        """May the caller poll the source right now? An OPEN breaker
        whose backoff elapsed transitions to HALF_OPEN and admits this
        one call as the probe; a HALF_OPEN breaker (probe outstanding)
        admits nothing until record() settles it."""
        if self.state == CLOSED:
            return True
        if self.state == HALF_OPEN:
            return False
        now = self.clock() if now is None else now
        if now >= self._next_probe:
            self.state = HALF_OPEN
            return True
        return False

    def record(self, ok: bool, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        if ok:
            self.state = CLOSED
            self.consecutive_failures = 0
            self._backoff_s = 0.0
            return
        self.consecutive_failures += 1
        if self.state == HALF_OPEN:
            # Failed probe: decay further (capped exponential).
            self._open(now, min(self._backoff_s * 2, self.max_backoff_s))
        elif (
            self.state == CLOSED
            and self.consecutive_failures >= self.failure_threshold
        ):
            self._open(now, self.base_backoff_s)

    def _open(self, now: float, backoff_s: float) -> None:
        self.state = OPEN
        self.opened_count += 1
        self._backoff_s = backoff_s
        # ±jitter_frac so a monitor fleet doesn't re-probe a shared
        # dependency (apiserver, Prometheus) in lockstep.
        jitter = 1.0 + self.rng.uniform(-self.jitter_frac, self.jitter_frac)
        self._next_probe = now + backoff_s * jitter

    def retry_in_s(self, now: float | None = None) -> float | None:
        if self.state != OPEN:
            return None
        now = self.clock() if now is None else now
        return max(0.0, self._next_probe - now)

    def to_json(self) -> dict:
        out = {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "opened_count": self.opened_count,
        }
        retry = self.retry_in_s()
        if retry is not None:
            out["retry_in_s"] = round(retry, 3)
        return out


# ------------------------------ watchdog -------------------------------

@dataclass
class LoopWatchdog:
    """Accounting for one sampler loop: tick durations, lag (a tick that
    overran its interval, skewing the cadence) and swallowed exceptions
    — the loop's ``except Exception`` is no longer a silent ``pass``."""

    name: str
    interval_s: float
    ticks: int = 0
    lagged_ticks: int = 0
    exceptions: int = 0
    consecutive_exceptions: int = 0
    last_error: str | None = None
    last_tick_ts: float | None = None
    max_lag_s: float = 0.0
    last_duration_s: float | None = None

    def tick(self, elapsed_s: float, error: str | None = None) -> None:
        self.ticks += 1
        self.last_tick_ts = time.time()
        self.last_duration_s = elapsed_s
        lag = elapsed_s - self.interval_s
        if lag > 0:
            self.lagged_ticks += 1
            self.max_lag_s = max(self.max_lag_s, lag)
        if error is not None:
            self.exceptions += 1
            self.consecutive_exceptions += 1
            self.last_error = error
        else:
            self.consecutive_exceptions = 0

    def to_json(self) -> dict:
        last = self.last_duration_s
        return {
            "interval_s": self.interval_s,
            "ticks": self.ticks,
            "lagged_ticks": self.lagged_ticks,
            "max_lag_s": round(self.max_lag_s, 3),
            "exceptions": self.exceptions,
            "consecutive_exceptions": self.consecutive_exceptions,
            "last_error": self.last_error,
            "last_tick_ts": self.last_tick_ts,
            "last_duration_ms": round(last * 1e3, 3) if last is not None else None,
        }
