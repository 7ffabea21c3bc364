"""Workload-side self-reporting: publish device memory footprint and
activity.

Counterpart of ``tpumon/loadgen/report.py`` for a PyTorch process on
NVIDIA GPUs. The files go through this package's copy of the channel's
writer (``tpumon_torch.collectors.workload``), in the format and directory
the unchanged monitor reads (``source: workload``). A workload wraps its
device work::

    reporter = WorkloadReporter(name="train")
    reporter.start()
    ...
    with reporter.device_work():
        loss = step(...).item()   # ends in a device->host sync
    ...
    reporter.stop()

and a background thread writes a report file every ``interval_s``:

- ``hbm_used``: the bytes of the tensors this process holds on each
  device (``torch.cuda.memory_allocated``, the analogue of the
  reference's ``jax.live_arrays``).
- ``busy_frac``: fraction of the last interval spent inside
  ``device_work()`` blocks, the workload's own duty-cycle proxy. Torch
  queues device work asynchronously, so a block must end in a sync (the
  engine's step ends in its one ``.tolist()``, the trainer's step in the
  loss's ``.item()``) for its wall time to cover the device time; it is
  labeled ``source: workload`` downstream because it is the workload's
  declared activity, not a hardware counter.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from tpumon_torch.collectors.workload import (
    DEFAULT_DIR,
    remove_report,
    write_report,
)


def _smi_indices(n: int) -> list[int]:
    """nvidia-smi's index of each torch device 0..n-1. nvidia-smi (and the
    monitor's nvidia-smi backend) numbers the cards by PCI bus id; CUDA
    numbers them so only under ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` (its
    default, FASTEST_FIRST, may not). So a device's index is its rank by
    PCI bus id among the visible devices, taken through
    ``CUDA_VISIBLE_DEVICES`` when that lists integer indices (which name
    nvidia-smi's cards under PCI_BUS_ID order)."""
    keys = []
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        keys.append((getattr(p, "pci_domain_id", 0),
                     getattr(p, "pci_bus_id", i),
                     getattr(p, "pci_device_id", 0)))
    rank = [0] * n
    for r, i in enumerate(sorted(range(n), key=keys.__getitem__)):
        rank[i] = r
    listed = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
    try:
        visible = sorted(int(v) for v in listed[:n])
    except ValueError:  # unset, UUIDs or MIG names: the ranks stand
        return rank
    return [visible[r] for r in rank] if len(visible) == n else rank


def footprint_by_device() -> dict[int, dict]:
    """Allocated device bytes per GPU for this process, keyed by
    nvidia-smi's index (``_smi_indices``).

    ``hbm_used`` is ``torch.cuda.memory_allocated(i)``: the bytes of live
    tensors, without the caching allocator's free blocks. ``hbm_total`` is
    the device's memory (``get_device_properties(i).total_memory``, what
    ``torch.cuda.mem_get_info(i)[1]`` gives, read without creating a CUDA
    context on a device the process does not use). Every visible device
    reports, one with nothing allocated as an explicit 0: the monitor needs
    a 0 baseline, not absence. A device whose numbers cannot be read keeps
    that baseline, and one raising does not cost the others theirs.
    """
    out: dict[int, dict] = {}
    if not torch.cuda.is_available():
        return out
    n = torch.cuda.device_count()
    try:
        indices = _smi_indices(n)
    except RuntimeError:
        indices = list(range(n))
    for i, idx in enumerate(indices):
        ent = out.setdefault(idx, {"hbm_used": 0, "hbm_total": None})
        try:
            ent["hbm_used"] = int(torch.cuda.memory_allocated(i))
            ent["hbm_total"] = int(
                torch.cuda.get_device_properties(i).total_memory)
        except RuntimeError:
            continue
    return out


class WorkloadReporter:
    """Background self-report writer; safe to start/stop repeatedly."""

    def __init__(
        self,
        name: str = "loadgen",
        directory: str | None = None,
        interval_s: float = 1.0,
    ) -> None:
        self.name = name
        self.directory = directory or DEFAULT_DIR
        self.interval_s = interval_s
        self._busy_s = 0.0
        # Open device_work intervals keyed by thread ident: one reporter
        # may be shared by several worker threads, and a single slot would
        # let them overwrite each other's start stamp.
        self._busy_since: dict[int, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---- activity accounting ----

    @contextlib.contextmanager
    def device_work(self):
        """Mark device-busy time. Concurrent blocks from different threads
        each get their own interval; overlapping intervals sum (busy_frac
        is clamped to 1.0), "any thread kept the device busy"."""
        ident = threading.get_ident()
        with self._lock:
            self._busy_since[ident] = time.monotonic()
        try:
            yield
        finally:
            t1 = time.monotonic()
            with self._lock:
                # Charge from the stored stamp, not the block start: a
                # drain mid-block already counted the earlier slice and
                # advanced the stamp.
                since = self._busy_since.pop(ident, None)
                if since is not None:
                    self._busy_s += t1 - since

    def _drain_busy(self, now: float) -> float:
        """Busy seconds accumulated since the last drain, counting a
        still-open device_work block up to ``now``."""
        with self._lock:
            busy = self._busy_s
            self._busy_s = 0.0
            for ident, since in self._busy_since.items():
                busy += now - since
                self._busy_since[ident] = now
        return busy

    # ---- report loop ----

    def write_once(self, interval_s: float | None = None) -> str:
        """One report write (also the unit the tests drive directly)."""
        now = time.monotonic()
        interval = interval_s if interval_s is not None else self.interval_s
        busy = self._drain_busy(now)
        frac = max(0.0, min(1.0, busy / interval)) if interval > 0 else 0.0
        devices = []
        for idx, ent in sorted(footprint_by_device().items()):
            devices.append(
                {
                    "index": idx,
                    "hbm_used": ent["hbm_used"],
                    "hbm_total": ent["hbm_total"],
                    "busy_frac": round(frac, 4),
                }
            )
        return write_report(self.directory, self.name, devices)

    def _loop(self) -> None:
        last = time.monotonic()
        while not self._stop.wait(self.interval_s):
            now = time.monotonic()
            try:
                self.write_once(interval_s=max(1e-3, now - last))
            except Exception:  # noqa: BLE001 (reporting must never take
                pass           # down the workload)
            last = now

    def start(self) -> "WorkloadReporter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"tpumon-report-{self.name}",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        remove_report(self.directory, self.name)

    def __enter__(self) -> "WorkloadReporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
