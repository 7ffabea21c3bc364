"""The workload self-report channel (``source: workload``).

A copy of ``tpumon/collectors/workload.py``: one small JSON file per
workload process in a shared directory, written atomically (tmp + rename)
by ``tpumon_torch.loadgen.report.WorkloadReporter`` and read back by
``WorkloadFileSource``, the lowest-ranked counter source of the port's
NVML collector (``tpumon_torch.collectors.accel_cuda``). The unchanged
monitor's collector reads the same files (``read_reports``), so the
directory, the file name, the format and the ownership rule are the
reference's exactly. Entries older than ``MAX_AGE_S`` are ignored, so a
killed workload disappears from the monitor within seconds.

File format (version 1)::

    {"v": 1, "name": "train", "pid": 1234, "ts": 1753900000.0,
     "devices": [{"index": 0, "hbm_used": 2147483648,
                  "hbm_total": 85520809984, "busy_frac": 0.93}]}
"""

from __future__ import annotations

import json
import os
import stat
import time
from dataclasses import dataclass, field

#: Default shared directory for workload report files, uid-suffixed so a
#: multi-user host's users can't collide or squat each other's channel
#: (the monitor's default: its Config.workload_dir, TPUMON_WORKLOAD_DIR).
DEFAULT_DIR = f"/tmp/tpumon-workload-{os.getuid()}" if hasattr(os, "getuid") \
    else "/tmp/tpumon-workload"

#: Reports older than this are a dead/stalled workload and are ignored.
MAX_AGE_S = 10.0

REPORT_VERSION = 1


def _owned_by_us(path: str, want_dir: bool = False) -> bool:
    """True iff ``path`` is a real file/directory (never a symlink) owned
    by this process's uid: the channel's trust boundary. lstat, not stat:
    another user could pre-create the predictable /tmp path as a symlink
    into a victim-owned tree. ``want_dir`` requires a directory (the
    channel root); otherwise a regular file (one report)."""
    if not hasattr(os, "getuid"):
        return True  # no POSIX ownership model; nothing to check
    try:
        st = os.lstat(path)
    except OSError:
        return False
    mode = st.st_mode
    kind_ok = stat.S_ISDIR(mode) if want_dir else stat.S_ISREG(mode)
    return kind_ok and st.st_uid == os.getuid()


def write_report(
    directory: str,
    name: str,
    devices: list[dict],
    pid: int | None = None,
    now: float | None = None,
) -> str:
    """Atomically write one workload's report; returns the file path.

    Atomic (tmp + rename on the same filesystem) so the collector never
    reads a half-written JSON.
    """
    pid = os.getpid() if pid is None else pid
    now = time.time() if now is None else now
    os.makedirs(directory, mode=0o700, exist_ok=True)
    if not _owned_by_us(directory, want_dir=True):
        raise PermissionError(
            f"workload report dir {directory!r} is not owned by this "
            "user — refusing to write into a squattable channel"
        )
    path = os.path.join(directory, f"{name}-{pid}.json")
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(
            {
                "v": REPORT_VERSION,
                "name": name,
                "pid": pid,
                "ts": now,
                "devices": devices,
            },
            f,
        )
    os.replace(tmp, path)
    return path


def remove_report(directory: str, name: str, pid: int | None = None) -> None:
    """Best-effort cleanup on workload shutdown (staleness also covers an
    unclean exit)."""
    pid = os.getpid() if pid is None else pid
    try:
        os.unlink(os.path.join(directory, f"{name}-{pid}.json"))
    except OSError:
        pass


def read_reports(
    directory: str, now: float | None = None, max_age_s: float = MAX_AGE_S
) -> list[dict]:
    """All fresh, well-formed reports in the directory. Corrupt or stale
    files are skipped (a monitor must not crash on a torn write or a
    dead workload's leftovers)."""
    now = time.time() if now is None else now
    out: list[dict] = []
    if not _owned_by_us(directory, want_dir=True):
        return out  # absent, or another user's dir: no trusted reports
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for fname in sorted(names):
        if not fname.endswith(".json"):
            continue
        fpath = os.path.join(directory, fname)
        if not _owned_by_us(fpath):
            continue
        try:
            with open(fpath) as f:
                rep = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(rep, dict) or rep.get("v") != REPORT_VERSION:
            continue
        ts = rep.get("ts")
        if not isinstance(ts, (int, float)) or now - ts > max_age_s:
            continue
        if not isinstance(rep.get("devices"), list):
            continue
        out.append(rep)
    return out


def merge_reports(reports: list[dict]) -> dict[int, dict]:
    """Merge per-process reports into one view per device index.

    Several workloads can share a chip (e.g. a trainer and the serving
    engine): HBM footprints add; busy fractions add but cap at 1.0 (two
    processes can't make one chip more than fully busy).
    """
    merged: dict[int, dict] = {}
    for rep in reports:
        for dev in rep["devices"]:
            idx = dev.get("index")
            if not isinstance(idx, int):
                continue
            m = merged.setdefault(
                idx,
                {"hbm_used": None, "hbm_total": None, "busy_frac": None,
                 "workloads": []},
            )
            hbm = dev.get("hbm_used")
            if isinstance(hbm, (int, float)):
                m["hbm_used"] = int((m["hbm_used"] or 0) + hbm)
            total = dev.get("hbm_total")
            if isinstance(total, (int, float)):
                m["hbm_total"] = max(int(total), m["hbm_total"] or 0)
            busy = dev.get("busy_frac")
            if isinstance(busy, (int, float)):
                m["busy_frac"] = min(1.0, (m["busy_frac"] or 0.0) + busy)
            wname = str(rep.get("name", "?"))
            if wname not in m["workloads"]:
                m["workloads"].append(wname)
    return merged


@dataclass
class WorkloadFileSource:
    """Collector-side reader. ``snapshot()`` is synchronous — a handful
    of tiny local file stats is cheaper than a thread hop, and the tick
    path must stay lean (BENCH_r02 sampler-rate lesson). Parsed reports
    are cached per (path, mtime, size) so an unchanged file costs one
    stat per tick, not a JSON parse."""

    directory: str = DEFAULT_DIR
    max_age_s: float = MAX_AGE_S
    clock: object = field(default=time.time, repr=False)
    _cache: dict = field(default_factory=dict, repr=False)

    def _read_cached(self, fpath: str) -> dict | None:
        # lstat, same trust boundary as read_reports: a symlink planted
        # in the channel must not let the collector ingest (or cache)
        # some other user-owned JSON it points at.
        try:
            st = os.lstat(fpath)
        except OSError:
            self._cache.pop(fpath, None)
            return None
        if not stat.S_ISREG(st.st_mode) or (
            hasattr(os, "getuid") and st.st_uid != os.getuid()
        ):
            return None
        key = (st.st_mtime_ns, st.st_size)
        hit = self._cache.get(fpath)
        if hit is not None and hit[0] == key:
            return hit[1]
        try:
            with open(fpath) as f:
                rep = json.load(f)
        except (OSError, ValueError):
            rep = None
        if not (
            isinstance(rep, dict)
            and rep.get("v") == REPORT_VERSION
            and isinstance(rep.get("ts"), (int, float))
            and isinstance(rep.get("devices"), list)
        ):
            rep = None
        self._cache[fpath] = (key, rep)
        return rep

    def snapshot(self) -> dict[int, dict]:
        now = self.clock()
        if not _owned_by_us(self.directory, want_dir=True):
            return {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return {}
        live = set()
        fresh: list[dict] = []
        for fname in sorted(names):
            if not fname.endswith(".json"):
                continue
            fpath = os.path.join(self.directory, fname)
            live.add(fpath)
            rep = self._read_cached(fpath)
            if rep is not None and now - rep["ts"] <= self.max_age_s:
                fresh.append(rep)
        for gone in [p for p in self._cache if p not in live]:
            del self._cache[gone]
        return merge_reports(fresh)
