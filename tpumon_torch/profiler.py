"""On-demand device trace capture (SURVEY §5.1), on ``torch.profiler``.

The counterpart of ``tpumon/profiler.py``, which records a jax.profiler
trace. ``GET /api/profile?seconds=N`` runs ``torch.profiler.profile`` for
N seconds over whatever this process is running on the card — the
``--serve-loadgen`` engine, a burn, or an embedding application's own
work — and writes the Chrome trace (``export_chrome_trace``) into the
capture directory as ``trace.json``: open it in Perfetto or
chrome://tracing, or count its CUDA kernel events, to turn "SM duty is
low" into "see *why*".

The activities are explicit: CPU and CUDA by default. A capture that asks
for CUDA when ``torch.cuda.is_available()`` is false fails before it
starts; it never records CPU alone in its place. CUPTI's CUDA activity is
process-wide, so kernels launched from other threads (the engine's pump)
are in the trace; CPU op events may come only from the capturing thread.

One capture at a time (one profiler per process); the capture runs in a
worker thread so the event loop keeps serving. ``ProfileBusy``,
``status()``, ``history``, ``captures`` and the summary's keys are the
reference's.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
import time
from collections import deque

ACTIVITIES = ("cpu", "cuda")
TRACE_FILE = "trace.json"


class ProfileBusy(Exception):
    """A capture is already in progress."""


def torch_activities(names) -> list:
    """``torch.profiler.ProfilerActivity`` members for ``names`` ("cpu",
    "cuda"); raises RuntimeError when CUDA is asked for and absent."""
    import torch

    table = {"cpu": torch.profiler.ProfilerActivity.CPU,
             "cuda": torch.profiler.ProfilerActivity.CUDA}
    unknown = [n for n in names if n not in table]
    if unknown or not names:
        raise ValueError(f"profiler activities {list(names)!r}: want a "
                         f"non-empty subset of {sorted(table)}")
    if "cuda" in names and not torch.cuda.is_available():
        raise RuntimeError(
            "profiler activity 'cuda' needs a CUDA device and none is "
            "available; ask for activities=('cpu',) to trace the host alone")
    return [table[n] for n in names]


class ProfilerService:
    HISTORY = 5  # capture summaries kept (newest first in status())

    def __init__(
        self,
        base_dir: str | None = None,
        max_seconds: float = 30.0,
        journal=None,
        activities: tuple[str, ...] = ACTIVITIES,
    ):
        self.base_dir = base_dir or os.path.join(
            tempfile.gettempdir(), "tpumon-profiles"
        )
        self.max_seconds = max_seconds
        self.activities = tuple(activities)
        # Optional event journal (tpumon_torch.events): each capture is a
        # lifecycle moment worth a durable record.
        self.journal = journal
        self._busy = False
        self.last: dict | None = None  # last capture summary
        # Bounded capture history + lifetime counter: observability for
        # the observability tool (exported as tpumon_profile_captures_
        # total / tpumon_profile_busy; history rides /api/trace).
        self.history: deque = deque(maxlen=self.HISTORY)
        self.captures = 0

    @property
    def busy(self) -> bool:
        return self._busy

    def _capture_sync(self, seconds: float, log_dir: str, activities) -> dict:
        import torch

        t0 = time.time()
        with torch.profiler.profile(activities=activities) as prof:
            time.sleep(seconds)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
        files = []
        for root, _dirs, names in os.walk(log_dir):
            for name in names:
                p = os.path.join(root, name)
                files.append(
                    {
                        "file": os.path.relpath(p, log_dir),
                        "bytes": os.path.getsize(p),
                    }
                )
        return {
            "dir": log_dir,
            "seconds": round(time.time() - t0, 3),
            "files": sorted(files, key=lambda f: f["file"]),
            "total_bytes": sum(f["bytes"] for f in files),
            "captured_at": t0,
            "hint": f"open {TRACE_FILE} in https://ui.perfetto.dev or "
            "chrome://tracing",
        }

    async def capture(self, seconds: float) -> dict:
        """Capture a trace for ``seconds`` (clamped to [0.1, max_seconds]).
        Raises ProfileBusy if a capture is already running, RuntimeError
        if an activity asked for has no device."""
        if self._busy:
            raise ProfileBusy("a profile capture is already in progress")
        activities = torch_activities(self.activities)
        seconds = min(max(seconds, 0.1), self.max_seconds)
        log_dir = os.path.join(
            self.base_dir, time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        )
        os.makedirs(log_dir, exist_ok=True)
        # _busy is only touched on the event loop; the thread below never
        # writes it, so this check-then-set cannot race.
        self._busy = True
        try:
            result = await asyncio.to_thread(
                self._capture_sync, seconds, log_dir, activities)
        finally:
            self._busy = False
        self.last = result
        self.history.appendleft(result)
        self.captures += 1
        if self.journal is not None:
            self.journal.record(
                "profile", "info", "profiler",
                f"captured {result['seconds']:.1f}s device trace "
                f"({result['total_bytes']} bytes) -> {result['dir']}",
                dir=result["dir"], bytes=result["total_bytes"],
            )
        return result

    def status(self) -> dict:
        return {
            "busy": self._busy,
            "base_dir": self.base_dir,
            "max_seconds": self.max_seconds,
            "captures": self.captures,
            "last": self.last,
            "history": list(self.history),
        }
