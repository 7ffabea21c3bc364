"""Fake TPU accelerator source.

SURVEY.md §7 step 2: a synthetic per-chip source producing v5e-1 / v5e-8 /
v5p-64 shapes so the whole pipeline (API, exporter, alerts, UI, multi-host
aggregation) is testable with zero accelerators — the TPU analogue of the
reference's implicit "no nvidia-smi present" mode (monitor_server.js:94),
but generative instead of empty.

Deterministic given (topology, time): values are smooth functions of t so
history charts look plausible, and per-chip phase offsets make chips
distinguishable. Supports fault injection (``kill_host`` /
``set_override``) for the §4.4 multi-node simulation tests.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

from tpumon_torch.collectors import Sample
from tpumon_torch.topology import HBM_BYTES_BY_KIND, ChipSample

# topology name -> (kind, n_hosts, chips_per_host, hosts_per_slice)
# hosts_per_slice == n_hosts => the whole topology is one slice (the
# original shapes); smaller => a pod-of-pods: chips carry per-slice
# labels (slice-0.0, slice-0.1, ...) so group-by-slice rollups — the
# federation tree's aggregation keys (tpumon.federation) — have real
# values to group on.
FAKE_TOPOLOGIES: dict[str, tuple[str, int, int, int]] = {
    "v5e-1": ("v5e", 1, 1, 1),
    "v5e-4": ("v5e", 1, 4, 1),
    "v5e-8": ("v5e", 1, 8, 1),
    "v5p-8": ("v5p", 2, 4, 2),
    "v5p-64": ("v5p", 16, 4, 16),  # v5p: 4 chips per host VM
    # Production-scale shapes for the data-plane fast-path benchmarks
    # (bench.py fastpath/federation phases, docs/perf.md): the render
    # and delta-SSE costs are O(chips), so these pin 128/256-chip costs.
    "v5p-128": ("v5p", 32, 4, 32),
    "v5p-256": ("v5p", 64, 4, 64),
    # Pod-of-pods shapes (ROADMAP item 2 / docs/federation.md): 2 and 8
    # v5p-256 slices — the fake fleet geometry behind the federation
    # tree bench and soak (a leaf monitor usually runs one 256-chip
    # slice; v5p-2048 in ONE instance is the degenerate flat baseline).
    "v5p-512": ("v5p", 128, 4, 64),
    "v5p-2048": ("v5p", 512, 4, 64),
}


@dataclass
class FakeTpuCollector:
    """Synthetic TPU chip metrics for a named topology."""

    topology: str = "v5e-8"
    slice_id: str = "slice-0"
    host_prefix: str = "tpu-host"
    name: str = "accel"
    clock: object = time.time  # injectable for deterministic tests
    dead_hosts: set[str] = field(default_factory=set)
    overrides: dict[str, dict] = field(default_factory=dict)  # chip_id -> field overrides
    # Periodic fault episodes (demo mode, `fake:<topo>+faults`): one
    # chip's ICI link degrades for ~60s every ~8 min and another
    # throttles for ~45s every ~11 min, so the degradation UI and the
    # fire->resolve alert lifecycle exercise themselves continuously.
    fault_episodes: bool = False

    def __post_init__(self) -> None:
        if self.topology not in FAKE_TOPOLOGIES:
            raise ValueError(
                f"unknown fake topology {self.topology!r}; "
                f"known: {sorted(FAKE_TOPOLOGIES)}"
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
        kind, n_hosts, per_host, hosts_per_slice = FAKE_TOPOLOGIES[self.topology]
        multi_slice = hosts_per_slice < n_hosts
        hbm_total = HBM_BYTES_BY_KIND[kind]
        t = self.clock()
        out: list[ChipSample] = []
        for h in range(n_hosts):
            host = f"{self.host_prefix}-{h}"
            if host in self.dead_hosts:
                continue
            # Pod-of-pods: each hosts_per_slice-host group is its own
            # slice (slice labels are the federation rollup keys);
            # single-slice topologies keep the configured slice_id
            # verbatim (back-compat with every existing test/config).
            slice_id = (
                f"{self.slice_id}.{h // hosts_per_slice}"
                if multi_slice
                else self.slice_id
            )
            for i in range(per_host):
                g = h * per_host + i  # global index => phase offset
                phase = 0.7 * g
                duty = 55 + 35 * math.sin(t / 37 + phase) + 5 * math.sin(t / 5 + g)
                hbm_frac = 0.55 + 0.25 * math.sin(t / 53 + phase / 2)
                temp = 45 + 18 * (duty / 100) + 2 * math.sin(t / 71 + g)
                # Cumulative ICI counters: closed-form integral of a smooth
                # ~2 GB/s rate ∫2e9·(1+sin(t/41+φ))dt so deltas are consistent
                # between successive samples.
                cumulative = int(2e9 * (t + 41 * (1 - math.cos(t / 41 + phase))))
                link_health = 0
                throttle = 0
                if self.fault_episodes:
                    if g == 3 and (t % 480) < 60:
                        link_health = 7  # persistent problem -> serious
                    if g == 5 and (t % 660) < 45:
                        # Thresholds.throttle_score = TriLevel(0, 4, 7) uses
                        # strict '>', so 5 is the lowest serious-severity score.
                        throttle = 5  # ~50% throttled -> serious
                sample = ChipSample(
                    chip_id=f"{host}/chip-{i}",
                    host=host,
                    slice_id=slice_id,
                    index=i,
                    kind=kind,
                    coords=(g % 4, g // 4, 0),
                    mxu_duty_pct=max(0.0, min(100.0, duty)),
                    hbm_used=int(hbm_total * max(0.02, min(0.98, hbm_frac))),
                    hbm_total=hbm_total,
                    temp_c=round(temp, 1),
                    ici_tx_bytes=cumulative,
                    ici_rx_bytes=int(cumulative * 0.97),
                    ici_link_up=True,
                    # Healthy outside episodes; tests/demos also inject
                    # degradation via set_override (PROBE_libtpu.md scale).
                    ici_link_health=link_health,
                    throttle_score=throttle,
                )
                ov = self.overrides.get(sample.chip_id)
                if ov:
                    sample = ChipSample(**{**sample.__dict__, **ov})
                out.append(sample)
        return out

    async def collect(self) -> Sample:
        return Sample(source=self.name, ok=True, data=self.chips())
