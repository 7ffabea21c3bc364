"""The workload self-report channel, writer side (``source: workload``).

A copy of the writer half of ``tpumon/collectors/workload.py``: one small
JSON file per workload process in a shared directory, written atomically
(tmp + rename) by ``tpumon_torch.loadgen.report.WorkloadReporter``. The
unchanged monitor's collector reads these files (``read_reports``), so the
directory, the file name, the format and the ownership rule are the
reference's exactly.

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

#: Default shared directory for workload report files, uid-suffixed so a
#: multi-user host's users can't collide or squat each other's channel
#: (the monitor's default: its Config.workload_dir, TPUMON_WORKLOAD_DIR).
DEFAULT_DIR = f"/tmp/tpumon-workload-{os.getuid()}" if hasattr(os, "getuid") \
    else "/tmp/tpumon-workload"

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
