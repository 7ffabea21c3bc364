"""GPU collector family.

The reference paper's accelerator path is NVIDIA-native: its L1b
collector shells out to ``nvidia-smi --query-gpu=... --format=csv``
(monitor_server.js:83-95) and its L0 deployment scrapes a DCGM exporter
(:9400, DCGM_FI_DEV_* series). tpumon replaced that wholesale with TPU
collectors; this module re-admits it as *diversity* — both sources
normalize into the same accelerator-generic ``ChipSample`` the TPU
collectors produce, so GPU nodes federate into the same tree, answer
the same queries and render in the same dashboard:

    SM util %                  -> mxu_duty_pct
    framebuffer (VRAM) used    -> hbm_used / hbm_total
    NVLink tx/rx byte counters -> ici_tx_bytes / ici_rx_bytes
    XID errors / link state    -> ici_link_health / ici_link_up
    (provenance)               -> counter_source "nvidia-smi" | "dcgm"
    (family)                   -> accel_kind "gpu"

Both collectors are honest-degraded like every existing source: a
missing binary / unreachable exporter is a ``Sample(ok=False, error=…)``
— never a crash, never a silent empty list (the reference's
"nvidia-smi absent => []" mode, but with the reason recorded).
"""

from __future__ import annotations

import asyncio
import re
import socket
import urllib.request
from dataclasses import dataclass

from tpumon_torch.collectors import Sample
from tpumon_torch.metrics_text import parse_metrics_text
from tpumon_torch.topology import ChipSample

# The query columns (order is the CSV parse contract below) — a
# superset of the reference's ``name, utilization.gpu, memory.used,
# memory.total, temperature.gpu`` (monitor_server.js:85).
SMI_QUERY_FIELDS = (
    "index",
    "name",
    "utilization.gpu",
    "memory.used",
    "memory.total",
    "temperature.gpu",
)
SMI_ARGS = (
    f"--query-gpu={','.join(SMI_QUERY_FIELDS)}",
    "--format=csv,noheader,nounits",
)


_GPU_KIND_RE = re.compile(
    r"(?<![a-z0-9])"
    r"(h200|h100|a100|l40s|l40|a10g|a10|v100|t4|l4)"
    r"(?![a-z0-9])"
)


def normalize_gpu_kind(name: str) -> str:
    """Map an nvidia-smi/DCGM product string ("NVIDIA A100-SXM4-80GB",
    "NVIDIA H100 80GB HBM3") to a short kind — the GPU analogue of
    topology.normalize_chip_kind. Token-bounded match so "L40S" never
    reads as "l4" (and longer parts are tried first)."""
    m = _GPU_KIND_RE.search(name.lower())
    if m:
        return m.group(1)
    return name.strip() or "gpu"


def _maybe_float(s: str) -> float | None:
    """nvidia-smi prints "[N/A]" / "N/A" for unsupported fields —
    that is an honest None, not a zero."""
    s = s.strip()
    if not s or "n/a" in s.lower():
        return None
    try:
        return float(s)
    except ValueError:
        return None


def parse_nvidia_smi_csv(
    text: str, host: str, slice_id: str = "gpu-0"
) -> list[ChipSample]:
    """Parse ``nvidia-smi --query-gpu=… --format=csv,noheader,nounits``
    output (SMI_QUERY_FIELDS order) into ChipSamples. Memory comes back
    in MiB (nounits); rows that don't parse are skipped rather than
    poisoning the sample — the reference's CSV parse did the same by
    construction (monitor_server.js:88-93)."""
    out: list[ChipSample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        parts = [p.strip() for p in line.split(",")]
        if len(parts) < len(SMI_QUERY_FIELDS):
            continue
        idx_f = _maybe_float(parts[0])
        if idx_f is None:
            continue
        index = int(idx_f)
        kind = normalize_gpu_kind(parts[1])
        util = _maybe_float(parts[2])
        mem_used = _maybe_float(parts[3])
        mem_total = _maybe_float(parts[4])
        temp = _maybe_float(parts[5])
        out.append(
            ChipSample(
                chip_id=f"{host}/gpu-{index}",
                host=host,
                slice_id=slice_id,
                index=index,
                kind=kind,
                mxu_duty_pct=util,
                hbm_used=int(mem_used * 2**20) if mem_used is not None else None,
                hbm_total=(
                    int(mem_total * 2**20) if mem_total is not None else None
                ),
                temp_c=temp,
                counter_source="nvidia-smi",
                accel_kind="gpu",
            )
        )
    return out


@dataclass
class NvidiaSmiCollector:
    """Shells out to nvidia-smi per tick (async subprocess — the
    reference did this with a blocking execSync on its event loop,
    monitor_server.js:85). The host identity is this node's hostname so
    federated GPU chips are globally unique, like every TPU source."""

    name: str = "accel"
    smi_path: str = "nvidia-smi"
    # Default slice namespace is the GPU family's own ("gpu-0", like
    # gpu_fake) — NOT the TPU default "slice-0": a peer-merged view
    # holding both families must never collapse them into one mixed
    # SliceView (topology.SliceView.accel_kind assumes one family per
    # slice).
    slice_id: str = "gpu-0"
    host: str = ""

    def __post_init__(self) -> None:
        self.host = self.host or socket.gethostname()

    async def collect(self) -> Sample:
        try:
            proc = await asyncio.create_subprocess_exec(
                self.smi_path,
                *SMI_ARGS,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE,
            )
            stdout, stderr = await proc.communicate()
        except FileNotFoundError:
            return Sample(
                source=self.name, ok=False, data=[],
                error=f"{self.smi_path} not found (no NVIDIA driver?)",
            )
        except OSError as e:
            return Sample(
                source=self.name, ok=False, data=[],
                error=f"{self.smi_path}: {type(e).__name__}: {e}",
            )
        if proc.returncode != 0:
            msg = (stderr or stdout).decode("utf-8", "replace").strip()
            return Sample(
                source=self.name, ok=False, data=[],
                error=f"{self.smi_path} exit {proc.returncode}: {msg[:160]}",
            )
        chips = parse_nvidia_smi_csv(
            stdout.decode("utf-8", "replace"), self.host, self.slice_id
        )
        return Sample(source=self.name, ok=True, data=chips)


# ------------------------------ DCGM -----------------------------------

# DCGM exporter family names (the L0 deployment's :9400 scrape,
# README.md:130-136 of the reference) -> ChipSample normalization.
_DCGM_UTIL = "DCGM_FI_DEV_GPU_UTIL"            # SM util %
_DCGM_FB_USED = "DCGM_FI_DEV_FB_USED"          # MiB
_DCGM_FB_FREE = "DCGM_FI_DEV_FB_FREE"          # MiB
_DCGM_TEMP = "DCGM_FI_DEV_GPU_TEMP"            # °C
_DCGM_NVLINK_TX = "DCGM_FI_PROF_NVLINK_TX_BYTES"  # cumulative bytes
_DCGM_NVLINK_RX = "DCGM_FI_PROF_NVLINK_RX_BYTES"
_DCGM_XID = "DCGM_FI_DEV_XID_ERRORS"           # last XID code (0 = none)

# XID codes that indicate interconnect/bus hardware trouble — the only
# ones mapped onto the ici_link_health score. DCGM reports the LAST
# XID observed (it persists until driver reload), and most codes are
# benign application-level events (13/31/43: a user process crashed),
# so mapping every non-zero XID would raise a perpetual serious alert
# on a healthy GPU. Finer per-code taxonomy is a ROADMAP follow-up.
_XID_LINK_CODES = frozenset({62, 74, 79})  # NVLink errors, GPU off bus


def parse_dcgm_text(
    text: str, default_host: str = "", slice_id: str = "gpu-0"
) -> list[ChipSample]:
    """Parse DCGM-exporter Prometheus exposition into ChipSamples, one
    per distinct ``gpu`` label per host. Host identity prefers the
    exporter's ``Hostname`` label (multi-node scrapes) and falls back
    to ``default_host``. An NVLink/bus XID error (_XID_LINK_CODES)
    degrades the link health score — the nearest NVLink-health
    analogue DCGM exports; other XIDs (mostly application-level) leave
    it healthy rather than paging forever on the last crashed job."""
    per: dict[tuple[str, str], dict] = {}
    for s in parse_metrics_text(text):
        gpu = s.labels.get("gpu")
        if gpu is None:
            continue
        host = s.labels.get("Hostname") or default_host
        d = per.setdefault((host, gpu), {})
        if "model" not in d and s.labels.get("modelName"):
            d["model"] = s.labels["modelName"]
        d.setdefault(s.name, s.value)
    out: list[ChipSample] = []
    for (host, gpu), d in sorted(per.items()):
        fb_used = d.get(_DCGM_FB_USED)
        fb_free = d.get(_DCGM_FB_FREE)
        fb_total = (
            fb_used + fb_free
            if fb_used is not None and fb_free is not None
            else None
        )
        xid = d.get(_DCGM_XID)
        out.append(
            ChipSample(
                chip_id=f"{host}/gpu-{gpu}" if host else f"gpu-{gpu}",
                host=host,
                slice_id=slice_id,
                index=int(gpu) if gpu.isdigit() else 0,
                kind=normalize_gpu_kind(d.get("model", "gpu")),
                mxu_duty_pct=d.get(_DCGM_UTIL),
                hbm_used=int(fb_used * 2**20) if fb_used is not None else None,
                hbm_total=int(fb_total * 2**20) if fb_total is not None else None,
                temp_c=d.get(_DCGM_TEMP),
                ici_tx_bytes=(
                    int(d[_DCGM_NVLINK_TX]) if _DCGM_NVLINK_TX in d else None
                ),
                ici_rx_bytes=(
                    int(d[_DCGM_NVLINK_RX]) if _DCGM_NVLINK_RX in d else None
                ),
                ici_link_health=(
                    None
                    if xid is None
                    else (7 if int(xid) in _XID_LINK_CODES else 0)
                ),
                counter_source="dcgm",
                accel_kind="gpu",
            )
        )
    return out


@dataclass
class DcgmCollector:
    """Scrapes a DCGM exporter's /metrics (the reference's L0 data
    path) and normalizes into ChipSamples. The fetch runs on a worker
    thread (urllib is blocking), same idiom as the serving collector."""

    url: str = "http://127.0.0.1:9400/metrics"
    name: str = "accel"
    slice_id: str = "gpu-0"  # GPU-family namespace, like NvidiaSmiCollector
    timeout_s: float = 3.0
    host: str = ""

    def __post_init__(self) -> None:
        self.host = self.host or socket.gethostname()
        if not self.url.startswith(("http://", "https://")):
            self.url = f"http://{self.url}"
        if not self.url.rstrip("/").endswith("/metrics"):
            self.url = self.url.rstrip("/") + "/metrics"

    def _fetch(self) -> str:
        with urllib.request.urlopen(self.url, timeout=self.timeout_s) as r:
            return r.read().decode("utf-8", "replace")

    async def collect(self) -> Sample:
        try:
            text = await asyncio.to_thread(self._fetch)
        except Exception as e:
            return Sample(
                source=self.name, ok=False, data=[],
                error=f"dcgm {self.url}: {type(e).__name__}: {e}",
            )
        chips = parse_dcgm_text(text, self.host, self.slice_id)
        if not chips:
            return Sample(
                source=self.name, ok=False, data=[],
                error=f"dcgm {self.url}: no DCGM_FI_* gpu series in scrape",
            )
        return Sample(source=self.name, ok=True, data=chips)
