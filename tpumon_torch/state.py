"""Checkpoint/resume of monitor state (SURVEY §5.4).

The reference keeps all server state in one in-memory module global that
a restart wipes (``lastPodStates``, monitor_server.js:157), and delegates
durable history entirely to Prometheus (README.md:37-39) — in the
no-Prometheus degraded mode a restart therefore loses the 30-minute
history window and the pod-transition baseline (so a pod that restarted
*while the monitor was down* goes unalerted).

tpumon closes that gap: a ``StateStore`` snapshots the stateful parts of
the sampler — ring-buffer history, alert event timeline, active alert
keys and the pod-transition baseline — to a JSON file, written atomically
(tmp + rename), on a periodic cadence and at shutdown, and restores them
at startup. The monitor stays logically stateless (losing the file only
degrades to the reference's re-learn-on-restart behavior); the file is a
warm-start cache, never a source of truth.
"""

from __future__ import annotations

import asyncio
import json
import time

from tpumon_torch.history import atomic_write_json
from tpumon_torch.sampler import Sampler

STATE_VERSION = 1

# Restored events/points older than the history window are dropped on
# load; a snapshot this stale is not worth resuming from at all.
MAX_SNAPSHOT_AGE_S = 24 * 3600


def snapshot_state(sampler: Sampler) -> dict:
    """Serialize the stateful parts of a sampler to a JSON-able dict."""
    return {
        "version": STATE_VERSION,
        "saved_at": time.time(),
        "history": sampler.history.dump_points(),
        # Coarse long-window tier (bucket means) — kept separately so the
        # 24 h view also survives a restart.
        "history_coarse": sampler.history.dump_coarse(),
        "alerts": sampler.engine.to_state(),
    }


def restore_state(sampler: Sampler, state: dict) -> bool:
    """Load a snapshot into a sampler. Returns False (and restores
    nothing) if the snapshot is unusable: wrong version, malformed, or
    older than MAX_SNAPSHOT_AGE_S."""
    if not isinstance(state, dict) or state.get("version") != STATE_VERSION:
        return False
    now = time.time()
    saved_at = state.get("saved_at")
    if not isinstance(saved_at, (int, float)) or now - saved_at > MAX_SNAPSHOT_AGE_S:
        return False
    # Parse and validate everything into temporaries first; mutate the
    # sampler only after the whole snapshot proved well-formed (a partial
    # restore would leave history without its matching alert baseline).
    try:
        # Probe-parse the history tiers before touching the ring: a
        # malformed point must not abort mid-restore. The real restore
        # (window cutoffs + the coarse/fine seam rule) lives in
        # RingHistory.load_points.
        points = {
            str(name): [(float(t), float(v)) for t, v in pts]
            for name, pts in state["history"].items()
        }
        coarse = {
            str(name): [(float(t), float(v)) for t, v in pts]
            for name, pts in (state.get("history_coarse") or {}).items()
        }
        alerts = state["alerts"]
        last_pods = alerts.get("last_pods")
        alert_state = {
            "last_pods": dict(last_pods) if last_pods is not None else None,
            "active_keys": dict(alerts.get("active_keys") or {}),
            "events": list(alerts.get("events") or []),
        }
    except (AttributeError, KeyError, TypeError, ValueError):
        return False
    sampler.history.load_points(points, coarse, now=now)
    sampler.engine.load_state(alert_state)
    # Restored timeline events were delivered (or intentionally not) in a
    # previous life — never re-page them through the webhook notifier.
    sampler.mark_events_notified()
    return True


class StateStore:
    """Atomic file-backed snapshot of sampler state."""

    def __init__(self, path: str, interval_s: float = 60.0):
        self.path = path
        self.interval_s = interval_s
        self.last_save_ts: float | None = None
        self.last_error: str | None = None
        self._task: asyncio.Task | None = None

    def save(self, sampler: Sampler) -> bool:
        """Snapshot + write in one call. Only safe where nothing is
        concurrently mutating the sampler (tests, shutdown after loops
        stopped); the live periodic path is save_async()."""
        return self._write(snapshot_state(sampler))

    async def save_async(self, sampler: Sampler) -> bool:
        """Snapshot on the event loop — the sampler's structures are only
        mutated there, so this never races a tick — then write the frozen
        dict in a worker thread."""
        state = snapshot_state(sampler)
        return await asyncio.to_thread(self._write, state)

    def _write(self, state: dict) -> bool:
        """Write a snapshot atomically (tmp + fsync + rename,
        tpumon_torch.history.atomic_write_json) — a crash mid-write leaves the
        previous snapshot."""
        try:
            atomic_write_json(self.path, state)
        except OSError as e:
            self.last_error = str(e)
            return False
        self.last_save_ts = state["saved_at"]
        self.last_error = None
        return True

    def restore_into(self, sampler: Sampler) -> bool:
        """Load the snapshot file into the sampler; False on any failure
        (missing/corrupt/stale file — the warm start is best-effort)."""
        try:
            with open(self.path) as f:
                state = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            self.last_error = str(e)
            return False
        return restore_state(sampler, state)

    # ---------------------------- lifecycle ----------------------------

    async def start(self, sampler: Sampler) -> None:
        async def loop() -> None:
            while True:
                await asyncio.sleep(self.interval_s)
                try:
                    await self.save_async(sampler)
                except Exception as e:  # never let the snapshot loop die
                    self.last_error = str(e)

        self._task = asyncio.create_task(loop())

    async def stop(self, sampler: Sampler) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        try:
            await self.save_async(sampler)  # final snapshot
        except Exception as e:
            self.last_error = str(e)
