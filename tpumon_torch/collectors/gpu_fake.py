"""Fake GPU accelerator source.

The GPU twin of tpumon.collectors.accel_fake: synthetic per-GPU
ChipSamples in DGX-node shapes (single-node ``dgx-a100-8`` /
``dgx-h100-8``, multi-node ``superpod-32``) so the whole
accelerator-generic pipeline — wire, federation, queries `by (accel)`,
exporter `accel` label, dashboard — is testable with zero GPUs. This is
the reference's own scenario (an NVIDIA host fleet,
monitor_server.js:83-95) readmitted as the second accelerator family
behind the same ChipSample normalization:

    SM util %        -> mxu_duty_pct
    VRAM used/total  -> hbm_used / hbm_total
    NVLink tx/rx     -> ici_tx_bytes / ici_rx_bytes
    NVLink/XID state -> ici_link_up / ici_link_health

Deterministic given (topology, time), same fault-injection hooks
(``kill_host`` / ``set_override`` / ``fault_episodes``) as the TPU
fake, so every existing soak pattern ports over unchanged.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

from tpumon_torch.collectors import Sample
from tpumon_torch.topology import ChipSample

# topology name -> (kind, n_hosts, gpus_per_host, hosts_per_slice).
# Same tuple contract as accel_fake.FAKE_TOPOLOGIES; a "slice" for the
# GPU family is the scheduling partition (the node for a single DGX,
# a rail-aligned node group in a SuperPOD) — the federation rollup key.
GPU_FAKE_TOPOLOGIES: dict[str, tuple[str, int, int, int]] = {
    "dgx-a100-8": ("a100", 1, 8, 1),
    "dgx-h100-8": ("h100", 1, 8, 1),
    # Multi-node shape: 4 DGX H100 nodes, 2-node partitions — two
    # slices (slice-0.0 / slice-0.1) so group-by-slice rollups and the
    # dark-node soak have real GPU values to chew on.
    "superpod-32": ("h100", 4, 8, 2),
}

# VRAM bytes per GPU by kind (SXM parts: A100 80 GiB, H100 80 GiB).
VRAM_BYTES_BY_KIND: dict[str, int] = {
    "a100": 80 * 1024**3,
    "h100": 80 * 1024**3,
}


@dataclass
class FakeGpuCollector:
    """Synthetic GPU metrics for a named DGX/SuperPOD topology."""

    topology: str = "dgx-a100-8"
    # Distinct default namespace from the TPU fake's "slice-0": a GPU
    # partition is not part of a TPU slice, and an aggregator merging
    # both families' chips into its local view must not collapse them
    # into one mixed rollup.
    slice_id: str = "gpu-0"
    host_prefix: str = "gpu-node"
    name: str = "accel"
    clock: object = time.time  # injectable for deterministic tests
    dead_hosts: set[str] = field(default_factory=set)
    overrides: dict[str, dict] = field(default_factory=dict)
    # Periodic fault episodes (demo mode, `gpufake:<topo>+faults`):
    # one GPU's NVLink degrades for ~60s every ~8 min — the same
    # cadence as the TPU fake so mixed demos degrade in both families.
    fault_episodes: bool = False

    def __post_init__(self) -> None:
        if self.topology not in GPU_FAKE_TOPOLOGIES:
            raise ValueError(
                f"unknown fake GPU topology {self.topology!r}; "
                f"known: {sorted(GPU_FAKE_TOPOLOGIES)}"
            )

    # -- fault injection -------------------------------------------------
    def kill_host(self, host: str) -> None:
        self.dead_hosts.add(host)

    def revive_host(self, host: str) -> None:
        self.dead_hosts.discard(host)

    def set_override(self, chip_id: str, **fields) -> None:
        self.overrides.setdefault(chip_id, {}).update(fields)

    # --------------------------------------------------------------------
    def chips(self) -> list[ChipSample]:
        kind, n_hosts, per_host, hosts_per_slice = GPU_FAKE_TOPOLOGIES[
            self.topology
        ]
        multi_slice = hosts_per_slice < n_hosts
        vram_total = VRAM_BYTES_BY_KIND[kind]
        t = self.clock()
        out: list[ChipSample] = []
        for h in range(n_hosts):
            host = f"{self.host_prefix}-{h}"
            if host in self.dead_hosts:
                continue
            slice_id = (
                f"{self.slice_id}.{h // hosts_per_slice}"
                if multi_slice
                else self.slice_id
            )
            for i in range(per_host):
                g = h * per_host + i
                phase = 0.9 * g
                # GPU workloads swing harder than TPU pods (per-node
                # jobs come and go); different periods keep mixed
                # fleets visually distinguishable in demos.
                duty = 60 + 30 * math.sin(t / 29 + phase) + 5 * math.sin(t / 7 + g)
                vram_frac = 0.6 + 0.3 * math.sin(t / 47 + phase / 2)
                temp = 40 + 25 * (duty / 100) + 2 * math.sin(t / 61 + g)
                # Cumulative NVLink counters: closed-form integral of a
                # smooth ~1.5 GB/s rate, consistent between samples.
                cumulative = int(1.5e9 * (t + 37 * (1 - math.cos(t / 37 + phase))))
                link_health = 0
                if self.fault_episodes and g == 3 and (t % 480) < 60:
                    link_health = 7  # persistent NVLink problem -> serious
                sample = ChipSample(
                    chip_id=f"{host}/gpu-{i}",
                    host=host,
                    slice_id=slice_id,
                    index=i,
                    kind=kind,
                    coords=(i, h, 0),
                    mxu_duty_pct=max(0.0, min(100.0, duty)),
                    hbm_used=int(vram_total * max(0.02, min(0.98, vram_frac))),
                    hbm_total=vram_total,
                    temp_c=round(temp, 1),
                    ici_tx_bytes=cumulative,
                    ici_rx_bytes=int(cumulative * 0.95),
                    ici_link_up=True,
                    ici_link_health=link_health,
                    accel_kind="gpu",
                )
                ov = self.overrides.get(sample.chip_id)
                if ov:
                    sample = ChipSample(**{**sample.__dict__, **ov})
                out.append(sample)
        return out

    async def collect(self) -> Sample:
        return Sample(source=self.name, ok=True, data=self.chips())
