"""Chip -> host -> slice topology model.

The reference models accelerators as a flat list of GPUs on one host
(monitor_server.js:90: ``{name, utilization, memoryUsed, memoryTotal,
temperature}`` parsed from nvidia-smi CSV). SURVEY.md §7 ("Hard parts")
calls out that this doesn't survive contact with multi-host TPU slices, so
topology is first-class here: every chip sample carries its host and slice
identity, and slice-level views (chip counts, aggregate duty cycle, missing
chips) are derived, not stored.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping

# Known TPU generations -> HBM bytes per chip. Used by the fake backend and
# as a fallback when the real backend can report chip kind but not HBM
# capacity. Public figures (v5e: 16 GiB, v5p: 95 GiB, v4: 32 GiB, v6e: 32 GiB).
HBM_BYTES_BY_KIND: dict[str, int] = {
    "v4": 32 * 1024**3,
    "v5e": 16 * 1024**3,
    "v5p": 95 * 1024**3,
    "v6e": 32 * 1024**3,
}

# Accelerator-family display vocabulary: the JSON keys stay
# the TPU-native names everywhere (`mxu_duty_pct`, `hbm_*`, `ici_*` —
# renaming them would break every wire/payload contract), but anything
# HUMAN-facing (dashboard rows, alert text, the CLI table) renders the
# family's own terms. The normalization back to the reference's GPU
# vocabulary (monitor_server.js:83-95) is documented in
# docs/federation.md "Mixed fleets".
ACCEL_TERMS: dict[str, dict[str, str]] = {
    "tpu": {"duty": "MXU", "mem": "HBM", "link": "ICI"},
    "gpu": {"duty": "SM", "mem": "VRAM", "link": "NVLink"},
}


def accel_terms(accel_kind: str | None) -> dict[str, str]:
    """Display terms for an accelerator family; unknown kinds read as
    TPU (the pre-`accel_kind` default everywhere else)."""
    return ACCEL_TERMS.get(accel_kind or "tpu", ACCEL_TERMS["tpu"])


def normalize_chip_kind(device_kind: str) -> str:
    """Map a raw device-kind string (e.g. 'TPU v5 lite') to a short kind."""
    k = device_kind.lower()
    if "v5 lite" in k or "v5e" in k or "v5litepod" in k:
        return "v5e"
    if "v5p" in k or "v5" in k:
        return "v5p"
    if "v6" in k or "trillium" in k:
        return "v6e"
    if "v4" in k:
        return "v4"
    return device_kind


@dataclass(frozen=True)
class ChipSample:
    """One chip's metrics at one instant.

    TPU-native replacement for the reference's per-GPU record
    (monitor_server.js:90): SM-util% -> MXU duty-cycle %, VRAM -> HBM,
    plus ICI link counters and topology identity.
    Fields that a backend cannot measure are None — "unknown" is expressed
    explicitly rather than as 0 (SURVEY §7: honest degraded modes).
    """

    chip_id: str  # globally unique, e.g. "host-0/chip-3"
    host: str
    slice_id: str
    index: int  # chip index within its host
    kind: str  # "v5e", "v5p", ...
    coords: tuple[int, ...] = ()
    mxu_duty_pct: float | None = None
    hbm_used: int | None = None
    hbm_total: int | None = None
    temp_c: float | None = None
    ici_tx_bytes: int | None = None  # cumulative counters
    ici_rx_bytes: int | None = None
    ici_link_up: bool | None = None
    # libtpu SDK signals (PROBE_libtpu.md): worst ICI link score for this
    # chip (0 healthy .. 10 unusable) and throttle score (0 .. 10 = 100%).
    ici_link_health: int | None = None
    throttle_score: int | None = None
    # Provenance of the duty/HBM counters, e.g. "sdk", "grpc", "pjrt",
    # "workload" (self-reported), "nvidia-smi", "dcgm", "fake", or a
    # "+"-joined mix — surfaced in /api/accel/metrics and the dashboard
    # health strip so a reader can always tell a hardware counter from a
    # workload's declaration.
    counter_source: str | None = None
    # Accelerator family ("tpu" | "gpu"). GPU chips carry the SAME
    # metric fields under the TPU-native names (SM-util% in
    # mxu_duty_pct, VRAM in hbm_*, NVLink counters in ici_*; see
    # docs/federation.md "Mixed fleets") — this field is what lets
    # rollups, queries (`by (accel)`), the exporter's `accel` label and
    # the UI tell the families apart. Appended LAST so the wire layout
    # stays append-only (pre-upgrade peers decode unchanged; their rows
    # default here, to "tpu").
    accel_kind: str = "tpu"

    @property
    def hbm_pct(self) -> float | None:
        if self.hbm_used is None or not self.hbm_total:
            return None
        return 100.0 * self.hbm_used / self.hbm_total

    def to_json(self) -> dict:
        d = {
            "chip": self.chip_id,
            "host": self.host,
            "slice": self.slice_id,
            "index": self.index,
            "kind": self.kind,
            "coords": list(self.coords),
            "mxu_duty_pct": self.mxu_duty_pct,
            "hbm_used": self.hbm_used,
            "hbm_total": self.hbm_total,
            "hbm_pct": self.hbm_pct,
            "temp_c": self.temp_c,
            "ici_tx_bytes": self.ici_tx_bytes,
            "ici_rx_bytes": self.ici_rx_bytes,
            "ici_link_up": self.ici_link_up,
            "ici_link_health": self.ici_link_health,
            "throttle_score": self.throttle_score,
            "counter_source": self.counter_source,
            "accel_kind": self.accel_kind,
        }
        return d


@dataclass
class SliceView:
    """Derived per-slice aggregate."""

    slice_id: str
    hosts: list[str]
    chips: list[ChipSample]
    expected_chips: int | None = None

    @property
    def reporting_chips(self) -> int:
        return len(self.chips)

    @property
    def missing_chips(self) -> int:
        if self.expected_chips is None:
            return 0
        return max(0, self.expected_chips - len(self.chips))

    @property
    def accel_kind(self) -> str | None:
        """The slice's accelerator family — None when no chips report
        (an expected-but-absent slice has no family to claim). Slices
        never mix families (they are per-leaf groupings), so the first
        chip speaks for all."""
        return self.chips[0].accel_kind if self.chips else None

    def _vals(self, attr: str) -> list[float]:
        return [v for c in self.chips if (v := getattr(c, attr)) is not None]

    def mean(self, attr: str) -> float | None:
        vals = self._vals(attr)
        return sum(vals) / len(vals) if vals else None

    def max(self, attr: str) -> float | None:
        vals = self._vals(attr)
        return max(vals) if vals else None

    def p95(self, attr: str) -> float | None:
        """Nearest-rank p95 over the slice's reporting chips — the
        aggregator-tier rollup statistic (tpumon.federation): a single
        hot chip must survive the mean without requiring the root to
        keep per-chip series."""
        vals = sorted(self._vals(attr))
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(0.95 * (len(vals) - 1) + 0.5))]

    def to_json(self) -> dict:
        return {
            "slice": self.slice_id,
            "hosts": sorted(self.hosts),
            "reporting_chips": self.reporting_chips,
            "expected_chips": self.expected_chips,
            "missing_chips": self.missing_chips,
            "mean_mxu_duty_pct": self.mean("mxu_duty_pct"),
            "mean_hbm_pct": self.mean("hbm_pct"),
            "accel_kind": self.accel_kind,
        }


# Columnar federation wire format (tpumon.collectors.accel_peers /
# /api/accel/wire): field names once, positional rows per chip — at 256
# chips the repeated per-chip JSON keys of to_json() dominate the
# payload, so the wire form is a fraction of the bytes and parse work.
# hbm_pct is derived, never shipped. Order is the contract: append new
# fields at the END and bump WIRE_VERSION only on incompatible changes
# (readers zip fields by the *sender's* field list, so old readers
# ignore unknown trailing fields and old senders simply omit them).
WIRE_VERSION = 1
WIRE_FIELDS: tuple[str, ...] = (
    "chip_id",
    "host",
    "slice_id",
    "index",
    "kind",
    "coords",
    "mxu_duty_pct",
    "hbm_used",
    "hbm_total",
    "temp_c",
    "ici_tx_bytes",
    "ici_rx_bytes",
    "ici_link_up",
    "ici_link_health",
    "throttle_score",
    "counter_source",
    "accel_kind",
)


def chips_to_wire(chips: Iterable[ChipSample]) -> dict:
    """Compact columnar snapshot: {"v", "fields", "rows"}."""
    return {
        "v": WIRE_VERSION,
        "fields": list(WIRE_FIELDS),
        "rows": [
            [
                list(v) if isinstance(v := getattr(c, f), tuple) else v
                for f in WIRE_FIELDS
            ]
            for c in chips
        ],
    }


def wire_columns(payload: dict) -> tuple[list[str], list[list]]:
    """Columns-out variant of chips_from_wire: the sender's field list
    plus one value column per field — no per-chip dicts, no ChipSample
    construction. The zero-parse federation path (accel_peers) ingests
    these columns directly; chips_from_columns materializes samples
    when the merged view needs them. Raises ValueError on an
    incompatible ``v`` (same contract as chips_from_wire)."""
    v = payload.get("v")
    if v != WIRE_VERSION:
        raise ValueError(f"wire version {v!r} != supported {WIRE_VERSION}")
    fields = list(payload.get("fields") or ())
    rows = payload.get("rows") or ()
    if not rows:
        return fields, [[] for _ in fields]
    return fields, [list(col) for col in zip(*rows)]


def chips_from_columns(fields: list[str], cols: list[list]) -> list[ChipSample]:
    """Materialize ChipSamples from per-field columns. The common case
    (sender speaks exactly this build's WIRE_FIELDS) constructs
    positionally — no per-chip kwargs dict; mixed-version senders take
    the tolerant path: unknown names dropped, missing fields defaulted,
    positions always tracking the SENDER's layout."""
    if not cols or not cols[0]:
        return []
    if fields == list(WIRE_FIELDS):
        return [
            ChipSample(
                row[0], row[1], row[2], int(row[3]), row[4],
                tuple(row[5] or ()), *row[6:],
            )
            for row in zip(*cols)
        ]
    out: list[ChipSample] = []
    for row in zip(*cols):
        kw = {f: val for f, val in zip(fields, row) if f in _WIRE_FIELD_SET}
        if "coords" in kw:
            kw["coords"] = tuple(kw["coords"] or ())
        if "index" in kw:
            kw["index"] = int(kw["index"])
        out.append(ChipSample(**kw))
    return out


def chips_from_wire(payload: dict) -> list[ChipSample]:
    """Inverse of chips_to_wire. Tolerant of senders with fewer or more
    fields than this build knows: rows are zipped against the sender's
    FULL field list (positions must track the sender's own layout —
    filtering before the zip would shift values into the wrong fields),
    then unknown names are dropped. An incompatible ``v`` fails loudly
    so the WIRE_VERSION escape hatch actually works."""
    return chips_from_columns(*wire_columns(payload))


_WIRE_FIELD_SET = frozenset(WIRE_FIELDS)


def attribute_pods(
    chips: Iterable[ChipSample], pods: Iterable[Mapping] | None
) -> dict[str, str]:
    """chip_id -> "namespace/name" of the TPU-requesting pod on the chip's
    host. On GKE a TPU host's chips are device-plugin-assigned to the pod
    that requested ``google.com/tpu`` on that node; with several such pods
    on one node, chips are split in index order proportional to each pod's
    request (the device plugin's assignment isn't observable from here, so
    this is the best-effort view; one-pod-per-host — the common case — is
    exact)."""
    chips = list(chips)
    by_node: dict[str, list[Mapping]] = {}
    for p in pods or []:
        if (p.get("tpu_request") or 0) > 0 and p.get("node"):
            by_node.setdefault(p["node"], []).append(p)
    out: dict[str, str] = {}
    for node, cands in by_node.items():
        cands.sort(key=lambda p: (p.get("namespace", ""), p.get("name", "")))
        node_chips = sorted(
            (c for c in chips if c.host == node), key=lambda c: c.index
        )
        if not node_chips:
            continue
        slots: list[str] = []
        for p in cands:
            slots += [f"{p.get('namespace')}/{p.get('name')}"] * int(
                p.get("tpu_request") or 0
            )
        # Slots are indexed by the chip's own host-local index, not its
        # position among *reporting* chips — if low-index chips stop
        # reporting, the survivors must keep their original owner instead
        # of shifting onto the first pod's slots. Chips beyond the host's
        # total requested count are unowned (clamping them to the last
        # pod would misdirect alerts).
        for c in node_chips:
            if 0 <= c.index < len(slots):
                out[c.chip_id] = slots[c.index]
    return out


def slice_views(
    chips: Iterable[ChipSample], expected: Mapping[str, int] | None = None
) -> list[SliceView]:
    """Group chip samples into per-slice views (chip->host->slice rollup)."""
    expected = expected or {}
    by_slice: dict[str, SliceView] = {}
    for c in chips:
        view = by_slice.get(c.slice_id)
        if view is None:
            view = by_slice[c.slice_id] = SliceView(
                slice_id=c.slice_id,
                hosts=[],
                chips=[],
                expected_chips=expected.get(c.slice_id),
            )
        view.chips.append(c)
        if c.host not in view.hosts:
            view.hosts.append(c.host)
    # Slices that are expected but entirely absent still get a (empty) view
    # so the alert engine can flag them.
    for slice_id, n in expected.items():
        if slice_id not in by_slice:
            by_slice[slice_id] = SliceView(
                slice_id=slice_id, hosts=[], chips=[], expected_chips=n
            )
    return [by_slice[k] for k in sorted(by_slice)]
