"""Prometheus text-exposition format: writer and parser (a copy of
``tpumon/metrics_text.py``).

Writer: ``format_value``, ``MetricFamily``, ``MetricsWriter``, which render
the port's ``/metrics`` families. Parser: ``parse_metrics_text``,
``samples_by_name`` and ``histogram_quantile``, which back the serving
collector (``tpumon_torch.collectors.serving``) and the DCGM scrape
(``tpumon_torch.collectors.gpu``).

Copied rather than imported so the port never loads ``tpumon``; the
rendered text and the parsed samples are the reference's, which the
parity tests pin.
"""

from __future__ import annotations

import math
import re
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


# --------------------------------------------------------------------------
# Parser
# --------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    if text == "NaN":
        return math.nan
    return float(text)


@dataclass
class ParsedSample:
    name: str
    labels: dict[str, str]
    value: float


def parse_metrics_text(text: str) -> list[ParsedSample]:
    """Parse Prometheus exposition text into a flat sample list."""
    out: list[ParsedSample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        labels: dict[str, str] = {}
        if m.group("labels"):
            for lm in _LABEL_RE.finditer(m.group("labels")):
                labels[lm.group(1)] = _unescape(lm.group(2))
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            continue
        out.append(ParsedSample(name=m.group("name"), labels=labels, value=value))
    return out


def samples_by_name(samples: list[ParsedSample]) -> dict[str, list[ParsedSample]]:
    by: dict[str, list[ParsedSample]] = {}
    for s in samples:
        by.setdefault(s.name, []).append(s)
    return by


def histogram_quantile(
    samples: list[ParsedSample], q: float
) -> float | None:
    """Estimate a quantile from _bucket samples (cumulative, le-labelled),
    linearly interpolating within the bucket — same approach as PromQL's
    histogram_quantile."""
    buckets: list[tuple[float, float]] = []
    for s in samples:
        le = s.labels.get("le")
        if le is None:
            continue
        buckets.append((_parse_value(le), s.value))
    if not buckets:
        return None
    buckets.sort(key=lambda b: b[0])
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_count = 0.0, 0.0
    for le, count in buckets:
        if count >= rank:
            if math.isinf(le):
                return prev_le if prev_le > 0 else None
            if count == prev_count:
                return le
            frac = (rank - prev_count) / (count - prev_count)
            return prev_le + (le - prev_le) * frac
        prev_le, prev_count = le, count
    return buckets[-1][0] if not math.isinf(buckets[-1][0]) else prev_le
