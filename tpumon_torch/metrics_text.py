"""Prometheus text-exposition writer (copy of ``tpumon/metrics_text.py``'s
writer side: ``format_value``, ``MetricFamily``, ``MetricsWriter``).

Copied rather than imported so the port never loads ``tpumon``; the
rendered text is byte-identical, which the parity tests pin.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def format_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if isinstance(v, bool):
        return "1" if v else "0"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


@dataclass
class MetricFamily:
    name: str
    mtype: str  # "gauge" | "counter" | "histogram" | "untyped"
    help: str = ""
    # (labels, value) pairs, or (labels, value, name-suffix) triples —
    # the suffix form carries histogram series ("_bucket"/"_sum"/
    # "_count") under one TYPE header.
    samples: list[tuple] = field(default_factory=list)

    def add(self, labels: dict[str, str] | None = None, value: float = 0.0) -> None:
        self.samples.append((labels or {}, value))

    def add_series(
        self, suffix: str, labels: dict[str, str] | None, value: float
    ) -> None:
        self.samples.append((labels or {}, value, suffix))

    def add_histogram(
        self,
        labels: dict[str, str],
        cumulative: list[tuple[float, int]],
        total_count: int,
        total_sum: float,
    ) -> None:
        """Emit a full Prometheus histogram: cumulative le-labelled
        ``_bucket`` series (``cumulative`` excludes +Inf, which is
        appended as ``total_count``), plus ``_sum`` and ``_count``."""
        for le, cum in cumulative:
            self.add_series("_bucket", {**labels, "le": format_value(le)}, cum)
        self.add_series("_bucket", {**labels, "le": "+Inf"}, total_count)
        self.add_series("_sum", labels, total_sum)
        self.add_series("_count", labels, total_count)


class MetricsWriter:
    def __init__(self) -> None:
        self.families: list[MetricFamily] = []

    def family(self, name: str, mtype: str, help: str = "") -> MetricFamily:
        fam = MetricFamily(name=name, mtype=mtype, help=help)
        self.families.append(fam)
        return fam

    def gauge(self, name: str, help: str = "") -> MetricFamily:
        return self.family(name, "gauge", help)

    def counter(self, name: str, help: str = "") -> MetricFamily:
        return self.family(name, "counter", help)

    def histogram(self, name: str, help: str = "") -> MetricFamily:
        return self.family(name, "histogram", help)

    def render(self) -> str:
        lines: list[str] = []
        for fam in self.families:
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.mtype}")
            for sample in fam.samples:
                labels, value = sample[0], sample[1]
                name = fam.name + (sample[2] if len(sample) > 2 else "")
                if labels:
                    inner = ",".join(
                        f'{k}="{_escape_label_value(str(v))}"' for k, v in labels.items()
                    )
                    lines.append(f"{name}{{{inner}}} {format_value(value)}")
                else:
                    lines.append(f"{name} {format_value(value)}")
        return "\n".join(lines) + "\n"
