"""EWMA anomaly detection: catch drifts before thresholds trip.

The alert engine (tpumon_torch.alerts) fires on absolute thresholds — HBM
above 85%, CPU above 95% — which means a slow leak is invisible until
the moment it becomes an incident. This module watches *drift*: each
monitored series keeps an exponentially-weighted moving mean and
variance (the RiskMetrics recursion), and a sample whose z-score
against that baseline clears a gate is an anomaly — recorded in the
event journal (kind ``anomaly``) and surfaced as a minor
``anomaly.<series>`` alert, hours before the hard threshold would have
paged.

Detector per series, three guards against noise:

- **warmup**: no verdicts until ``warmup`` samples establish a
  baseline (a fresh monitor must not page on its first minute).
- **z-score hysteresis**: fire at ``|z| >= z_fire`` (default 4σ),
  clear only once ``|z| <= z_clear`` (default 1.5σ) — the band between
  the two is sticky, so a value oscillating around the fire line
  produces one incident, not a fired/cleared stream.
- **hold counts**: the gate must hold for ``fire_hold`` consecutive
  samples to fire and ``clear_hold`` to clear — single-sample spikes
  (a GC pause, one slow scrape) don't page.

The baseline keeps absorbing samples *while anomalous* (alpha-weighted)
— a sustained shift becomes the new normal and the anomaly clears once
the series stabilizes, rather than pinning "anomalous" forever. A
``min_sigma`` floor keeps a near-constant series (fake backends, idle
chips) from turning numeric dust into infinite z-scores.

The sampler feeds fleet-level series each fast tick (tpumon_torch.sampler
``_anomaly_series``): mean chip duty cycle, mean HBM%, the previous
tick's duration, and each source's recent scrape p95 — the signals
whose slow sag/creep SURVEY §2.2 calls out as invisible to threshold
rules. Tuning knobs ride the config (``anomaly_*`` keys; docs/events.md
says how to tune them).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class AnomalyConfig:
    alpha: float = 0.05       # EWMA weight: ~20-sample memory
    z_fire: float = 4.0       # enter-anomaly gate (σ)
    z_clear: float = 1.5      # exit-anomaly gate (σ); must be < z_fire
    warmup: int = 30          # samples before any verdict
    fire_hold: int = 3        # consecutive over-gate samples to fire
    clear_hold: int = 5       # consecutive under-gate samples to clear
    min_sigma: float = 0.5    # σ floor (pct points / ms) for flat series


class EwmaDetector:
    """One series' EWMA mean/variance state machine."""

    __slots__ = (
        "name", "cfg", "mean", "var", "n", "state",
        "_over", "_under", "last_z", "last_value", "since",
    )

    def __init__(self, name: str, cfg: AnomalyConfig | None = None):
        self.name = name
        self.cfg = cfg or AnomalyConfig()
        self.mean: float | None = None
        self.var = 0.0
        self.n = 0
        self.state = "normal"  # "normal" | "anomalous"
        self._over = 0
        self._under = 0
        self.last_z = 0.0
        self.last_value: float | None = None
        self.since: float | None = None  # ts the current anomaly fired

    @property
    def sigma(self) -> float:
        return max(math.sqrt(max(self.var, 0.0)), self.cfg.min_sigma)

    def update(self, value: float, ts: float | None = None) -> str | None:
        """Feed one sample; returns "fired" / "cleared" on a state
        transition, else None. Scoring happens against the baseline
        *before* this sample is absorbed into it."""
        cfg = self.cfg
        ts = time.time() if ts is None else ts
        if self.mean is None:
            self.mean = float(value)
            self.n = 1
            self.last_value = float(value)
            return None
        z = (value - self.mean) / self.sigma
        transition: str | None = None
        if self.n >= cfg.warmup:
            if self.state == "normal":
                if abs(z) >= cfg.z_fire:
                    self._over += 1
                    if self._over >= cfg.fire_hold:
                        self.state = "anomalous"
                        self.since = ts
                        self._over = 0
                        transition = "fired"
                else:
                    self._over = 0
            else:
                if abs(z) <= cfg.z_clear:
                    self._under += 1
                    if self._under >= cfg.clear_hold:
                        self.state = "normal"
                        self.since = None
                        self._under = 0
                        transition = "cleared"
                else:
                    self._under = 0
        # Absorb AFTER scoring. One exception: while NORMAL with the
        # fire gate held open (a pending fire accumulating fire_hold
        # evidence), the baseline freezes — otherwise the EWMA variance
        # inflates fast enough to pull z back under the gate before the
        # hold completes, and a clean step change never fires. Once
        # anomalous, absorption resumes so a sustained shift converges
        # to the new normal and the anomaly can clear (module doc).
        pending_fire = (
            self.state == "normal"
            and self.n >= cfg.warmup
            and abs(z) >= cfg.z_fire
            and transition is None
        )
        if not pending_fire:
            d = value - self.mean
            self.mean += cfg.alpha * d
            self.var = (1.0 - cfg.alpha) * (self.var + cfg.alpha * d * d)
        self.n += 1
        self.last_z = z
        self.last_value = float(value)
        return transition

    def to_json(self) -> dict:
        return {
            "state": self.state,
            "n": self.n,
            "mean": round(self.mean, 3) if self.mean is not None else None,
            "sigma": round(self.sigma, 3),
            "z": round(self.last_z, 2),
            **({"since": self.since} if self.since is not None else {}),
        }


class AnomalyBank:
    """Detectors keyed by series name, journal-wired.

    ``observe({series: value}, ts)`` routes each value to its detector
    (created on first sight) and records ``anomaly`` events on
    fire (minor) / clear (info). ``active()`` is the live view the
    alert engine turns into minor ``anomaly.<series>`` alerts.
    """

    def __init__(self, journal=None, cfg: AnomalyConfig | None = None):
        self.journal = journal
        self.cfg = cfg or AnomalyConfig()
        self.detectors: dict[str, EwmaDetector] = {}

    def observe(self, series: dict[str, float | None], ts: float | None = None) -> list[dict]:
        """Feed one tick's samples; returns the transitions as
        ``[{"series", "transition", "z", "value", "mean"}]``."""
        ts = time.time() if ts is None else ts
        transitions: list[dict] = []
        for name, value in series.items():
            if value is None:
                continue
            det = self.detectors.get(name)
            if det is None:
                det = self.detectors[name] = EwmaDetector(name, self.cfg)
            tr = det.update(float(value), ts)
            if tr is None:
                continue
            info = {
                "series": name,
                "transition": tr,
                "z": round(det.last_z, 2),
                "value": round(float(value), 3),
                "mean": round(det.mean or 0.0, 3),
            }
            transitions.append(info)
            if self.journal is not None:
                if tr == "fired":
                    self.journal.record(
                        "anomaly", "minor", name,
                        f"{name} drifting: {value:.2f} vs EWMA mean "
                        f"{det.mean:.2f} (z={det.last_z:.1f})",
                        ts=ts, series=name, z=info["z"],
                        value=info["value"], mean=info["mean"],
                    )
                else:
                    self.journal.record(
                        "anomaly", "info", name,
                        f"{name} back to baseline "
                        f"({value:.2f}, z={det.last_z:.1f})",
                        ts=ts, series=name, z=info["z"],
                        value=info["value"], mean=info["mean"],
                    )
        return transitions

    def active(self) -> list[dict]:
        """Currently-anomalous series, for the alert engine."""
        out = []
        for det in self.detectors.values():
            if det.state != "anomalous":
                continue
            out.append(
                {
                    "series": det.name,
                    "z": round(det.last_z, 2),
                    "value": round(det.last_value or 0.0, 3),
                    "mean": round(det.mean or 0.0, 3),
                    "since": det.since,
                }
            )
        return sorted(out, key=lambda a: a["series"])

    def to_json(self) -> dict:
        return {name: det.to_json() for name, det in sorted(self.detectors.items())}
