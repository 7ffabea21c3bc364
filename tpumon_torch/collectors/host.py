"""Host metrics collector: CPU, memory, disk.

Reference parity (monitor_server.js:66-81 ``getHostMetrics``):
- CPU: the reference divides 1-min loadavg by a hardcoded 8 cores
  (monitor_server.js:76). tpumon reports both a real utilization percent
  computed from /proc/stat jiffy deltas between samples *and* the loadavg,
  with the core count auto-detected (SURVEY §5.6).
- Memory: /proc/meminfo MemTotal/MemAvailable (monitor_server.js:69-71).
- Disk: the reference shells out ``df -B1 /`` (monitor_server.js:72);
  tpumon uses os.statvfs directly — no subprocess.

Shape of the returned data matches the reference contract (SURVEY §2.3
/api/host/metrics) with numbers, not stringified floats: the reference
returns percent fields as toFixed(1) strings (monitor_server.js:76-78), a
quirk SURVEY §2.1 says to fix.

Fast path: when the native shim (tpumon_torch/native/hostmon.cpp) is built, the
raw /proc reads + parses happen in C++ in a single call; the Python layer
only computes deltas and percentages. Each sub-source still degrades
independently, and the pure-Python reader remains the fallback.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from tpumon_torch.collectors import Sample


def _read_proc_stat_cpu(text: str) -> tuple[int, int]:
    """Return (busy_jiffies, total_jiffies) from the aggregate 'cpu ' line."""
    for line in text.splitlines():
        if line.startswith("cpu "):
            parts = [int(x) for x in line.split()[1:]]
            # user nice system idle iowait irq softirq steal [guest guest_nice]
            idle = parts[3] + (parts[4] if len(parts) > 4 else 0)
            total = sum(parts[:8])
            return total - idle, total
    raise ValueError("no aggregate 'cpu' line in /proc/stat")


def parse_meminfo(text: str) -> dict[str, int]:
    """Parse /proc/meminfo into {key: bytes}."""
    out: dict[str, int] = {}
    for line in text.splitlines():
        if ":" not in line:
            continue
        key, _, rest = line.partition(":")
        fields = rest.split()
        if not fields:
            continue
        val = int(fields[0])
        if len(fields) > 1 and fields[1] == "kB":
            val *= 1024
        out[key.strip()] = val
    return out


def parse_net_dev(text: str) -> dict[str, tuple[int, int]]:
    """Parse /proc/net/dev into {iface: (rx_bytes, tx_bytes)}.

    The loopback interface is excluded: for a multi-host TPU deployment
    the NIC counters are the host's DCN-traffic proxy (SURVEY §5.8 —
    ICI within a slice, DCN across hosts), and lo traffic would swamp
    the signal with scrape-loop chatter."""
    out: dict[str, tuple[int, int]] = {}
    for line in text.splitlines():
        if ":" not in line:
            continue
        iface, _, rest = line.partition(":")
        iface = iface.strip()
        if iface == "lo":
            continue
        fields = rest.split()
        if len(fields) < 10:
            continue
        try:
            out[iface] = (int(fields[0]), int(fields[8]))
        except ValueError:
            continue
    return out


@dataclass
class HostCollector:
    name: str = "host"
    cpu_count: int = 0
    disk_mounts: tuple[str, ...] = ("/",)
    proc_root: str = "/proc"  # overridable for golden-input tests
    use_native: bool = True

    _last_cpu: tuple[int, int] | None = None
    _native: object = field(default=None, repr=False)
    native_active: bool = field(default=False, repr=False)

    def __post_init__(self) -> None:
        self.cpu_count = self.cpu_count or os.cpu_count() or 1
        if self.use_native:
            try:
                from tpumon_torch.native import make_reader

                self._native = make_reader(
                    proc_root=self.proc_root, mount=self.disk_mounts[0]
                )
            except Exception:
                self._native = None
            self.native_active = self._native is not None

    # -- sub-collectors; each degrades independently (monitor_server.js:80) --

    def _cpu_pct_from_jiffies(self, busy: int, total: int, load1: float) -> float:
        pct = None
        if self._last_cpu is not None:
            dbusy = busy - self._last_cpu[0]
            dtotal = total - self._last_cpu[1]
            if dtotal > 0:
                pct = 100.0 * dbusy / dtotal
        self._last_cpu = (busy, total)
        if pct is None:
            # First sample: fall back to the reference's load-based estimate,
            # but with the detected core count (monitor_server.js:76).
            pct = min(100.0, 100.0 * load1 / self.cpu_count)
        return pct

    def _cpu(self, ns: dict | None) -> dict:
        if ns is not None and ns["ok_cpu"]:
            load1 = ns["load1"]
            busy, total = ns["cpu_busy_jiffies"], ns["cpu_total_jiffies"]
        else:
            with open(os.path.join(self.proc_root, "loadavg")) as f:
                load1 = float(f.read().split()[0])
            with open(os.path.join(self.proc_root, "stat")) as f:
                busy, total = _read_proc_stat_cpu(f.read())
        return {
            "load_1min": load1,
            "cores": self.cpu_count,
            "percent": round(self._cpu_pct_from_jiffies(busy, total, load1), 1),
        }

    def _memory(self, ns: dict | None) -> dict:
        if ns is not None and ns["ok_mem"]:
            total, avail = ns["mem_total"], ns["mem_available"]
        else:
            with open(os.path.join(self.proc_root, "meminfo")) as f:
                mi = parse_meminfo(f.read())
            total = mi["MemTotal"]
            avail = mi.get("MemAvailable", mi.get("MemFree", 0))
        used = total - avail
        return {
            "total": total,
            "used": used,
            "available": avail,
            "percent": round(100.0 * used / total, 1) if total else None,
        }

    def _disk_one(self, mount: str) -> dict:
        st = os.statvfs(mount)
        total = st.f_blocks * st.f_frsize
        used = total - st.f_bfree * st.f_frsize
        return {
            "total": total,
            "used": used,
            "percent": round(100.0 * used / total, 1) if total else None,
        }

    def _disk(self, ns: dict | None) -> dict:
        mounts: dict[str, dict] = {}
        if ns is not None and ns["ok_disk"]:
            total, used = ns["disk_total"], ns["disk_used"]
            mounts[self.disk_mounts[0]] = {
                "total": total,
                "used": used,
                "percent": round(100.0 * used / total, 1) if total else None,
            }
            rest = self.disk_mounts[1:]
        else:
            rest = self.disk_mounts
        for mount in rest:
            mounts[mount] = self._disk_one(mount)
        primary = mounts[self.disk_mounts[0]]
        return {**primary, "mounts": mounts}

    def _net(self, ns: dict | None) -> dict:
        with open(os.path.join(self.proc_root, "net", "dev")) as f:
            ifaces = parse_net_dev(f.read())
        return {
            "rx_bytes": sum(rx for rx, _ in ifaces.values()),
            "tx_bytes": sum(tx for _, tx in ifaces.values()),
            "interfaces": {
                name: {"rx_bytes": rx, "tx_bytes": tx}
                for name, (rx, tx) in sorted(ifaces.items())
            },
        }

    async def collect(self) -> Sample:
        ns = None
        if self._native is not None:
            try:
                ns = self._native.sample()
            except Exception:
                ns = None
        data: dict = {}
        errors: list[str] = []
        for key, fn in (("cpu", self._cpu), ("memory", self._memory),
                        ("disk", self._disk), ("net", self._net)):
            try:
                data[key] = fn(ns)
            except Exception as e:
                data[key] = {}
                errors.append(f"{key}: {type(e).__name__}: {e}")
        return Sample(
            source=self.name,
            ok=not errors,
            data=data,
            error="; ".join(errors) or None,
        )
