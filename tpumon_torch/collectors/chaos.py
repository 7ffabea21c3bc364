"""Chaos-injection wrapper collector.

A monitor's degraded modes are claims until something exercises them
against the *live* server — the reference had no way to make kubectl
hang or nvidia-smi lie on demand, so its failure handling shipped
untested (SURVEY §7). ``ChaosCollector`` wraps any real collector and
injects configurable faults:

  hang     collect() never returns (sleeps far past any deadline) —
           exercises the resilience deadline + orphan reaping
  err      collect() raises — exercises degraded Samples + the breaker
  slow     fixed added latency (param = milliseconds, always applied)
  corrupt  the real Sample's payload is truncated / has keys dropped —
           exercises partial-payload tolerance downstream
  flap     a two-state Markov toggle between healthy and erroring
           (param = per-collect switch probability) — exercises the
           breaker's open → half-open → closed lifecycle
  partition  blackholes a federation LINK (param = per-frame drop
           probability; 1.0 = total blackhole): frames are consumed
           and silently dropped while the socket stays open, so the
           remote side sees *silence* — dark marking and lease expiry
           — rather than a clean disconnect. Targets the link sources
           ``uplink`` (federation push stream) and ``leader`` (root HA
           heartbeat), not a collector.

Spec grammar (config key ``chaos`` / CLI ``--chaos``), comma-separated
``mode:source:param`` clauses::

    --chaos hang:accel:0.1,err:k8s:0.3,slow:host:200,flap:serving:0.5
    --chaos partition:uplink:1.0,partition:leader:1.0

Probabilistic faults (hang/err/corrupt) roll an injected seeded RNG per
collect, so soak tests are reproducible. Faults are mutable at runtime
(``set_faults`` / clearing the list) so tests lift them mid-run and
assert recovery.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field

from tpumon_torch.collectors import Collector, Sample

FAULT_MODES = ("hang", "err", "slow", "corrupt", "flap", "partition")

# Link (non-collector) chaos targets: `partition` applies to these, and
# only `partition` does — app.build routes their faults to the
# FederationUplink / LeaderLease instead of a ChaosCollector wrap.
LINK_SOURCES = ("uplink", "leader")

# How long a "hang" sleeps: effectively forever relative to any sane
# deadline, but finite so an un-deadlined test can't wedge the suite.
HANG_S = 3600.0


class ChaosError(Exception):
    """The injected failure (distinguishable from real collector errors
    in degraded Samples: ``ChaosError: injected error``)."""


@dataclass
class Fault:
    mode: str  # one of FAULT_MODES
    param: float  # probability (hang/err/corrupt/flap) or ms (slow)

    def __post_init__(self) -> None:
        if self.mode not in FAULT_MODES:
            raise ValueError(
                f"unknown chaos mode {self.mode!r}; known: {FAULT_MODES}"
            )
        if self.param < 0:
            raise ValueError(f"chaos {self.mode}: negative param {self.param}")
        if self.mode != "slow" and self.param > 1:
            raise ValueError(
                f"chaos {self.mode}: param is a probability, got {self.param}"
            )


def parse_chaos_spec(spec: str) -> dict[str, list[Fault]]:
    """``"hang:accel:0.1,err:k8s:0.3"`` -> {"accel": [Fault(hang, .1)],
    "k8s": [Fault(err, .3)]}. Raises ValueError on malformed clauses so
    a typo'd --chaos fails at startup, not silently no-ops."""
    out: dict[str, list[Fault]] = {}
    for clause in (c.strip() for c in spec.split(",") if c.strip()):
        parts = clause.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"bad chaos clause {clause!r} (want mode:source:param)"
            )
        mode, source, param = parts
        try:
            value = float(param)
        except ValueError:
            raise ValueError(f"bad chaos param {param!r} in {clause!r}")
        out.setdefault(source, []).append(Fault(mode=mode, param=value))
    return out


def split_link_faults(spec: str) -> tuple[dict[str, list[Fault]], dict[str, list[Fault]]]:
    """Partition a parsed --chaos spec into (collector faults, link
    faults). Link sources (``uplink``, ``leader``) accept only the
    ``partition`` mode, and ``partition`` only applies to link sources
    — either mismatch raises, so a typo'd clause fails at startup
    instead of silently injecting nothing."""
    by_source = parse_chaos_spec(spec)
    coll: dict[str, list[Fault]] = {}
    link: dict[str, list[Fault]] = {}
    for source, faults in by_source.items():
        if source in LINK_SOURCES:
            bad = [f.mode for f in faults if f.mode != "partition"]
            if bad:
                raise ValueError(
                    f"chaos {bad[0]!r} cannot target link source "
                    f"{source!r} (links take only 'partition')"
                )
            link[source] = faults
        else:
            bad = [f.mode for f in faults if f.mode == "partition"]
            if bad:
                raise ValueError(
                    f"chaos 'partition' targets a federation link "
                    f"({', '.join(LINK_SOURCES)}), not collector "
                    f"{source!r}"
                )
            coll[source] = faults
    return coll, link


def _corrupt(data, rng: random.Random):
    """Mangle a payload the way real half-broken sources do: drop items
    from lists, drop keys from dicts — never invent values. Downstream
    must treat what remains as truth and what's missing as absent."""
    if isinstance(data, list) and data:
        keep = [d for d in data if rng.random() < 0.5]
        return [
            _corrupt(d, rng) if isinstance(d, dict) else d for d in keep
        ]
    if isinstance(data, dict) and data:
        dropped = rng.choice(sorted(data, key=str))
        return {k: v for k, v in data.items() if k != dropped}
    return data


@dataclass
class ChaosCollector:
    """Wraps ``inner`` and injects the listed faults into its collects."""

    inner: Collector
    faults: list[Fault] = field(default_factory=list)
    seed: int | None = None
    rng: random.Random = field(default=None)  # injectable for tests
    # Event journal (tpumon_torch.events): injections are recorded so a chaos
    # soak's /api/events replay shows WHAT was injected next to the
    # degraded samples it caused. Wired by the sampler (set_journal).
    journal: object = field(default=None, repr=False)
    # flap state: True while the toggle is in its erroring phase
    _flap_down: bool = field(default=False, repr=False)

    def __post_init__(self) -> None:
        if self.rng is None:
            self.rng = random.Random(self.seed)

    @property
    def name(self) -> str:
        return self.inner.name

    def set_journal(self, journal) -> None:
        self.journal = journal
        inner_set = getattr(self.inner, "set_journal", None)
        if inner_set is not None:  # chaos may wrap a peer federation
            inner_set(journal)

    def stop(self) -> None:
        """Forward owner-stop to the wrapped collector (the k8s watch
        thread must stop even when its collector is chaos-wrapped)."""
        inner_stop = getattr(self.inner, "stop", None)
        if inner_stop is not None:
            inner_stop()

    def _note(self, msg: str, **attrs) -> None:
        if self.journal is not None:
            self.journal.record("chaos", "minor", self.name, msg, **attrs)

    def set_faults(self, faults: list[Fault]) -> None:
        """Replace the active fault set (tests lift faults mid-soak)."""
        self.faults = list(faults)

    def _fault(self, mode: str) -> Fault | None:
        for f in self.faults:
            if f.mode == mode:
                return f
        return None

    async def collect(self) -> Sample:
        f = self._fault("flap")
        if f is not None:
            if self.rng.random() < f.param:
                self._flap_down = not self._flap_down
                # Journal only the TRANSITION: a flap held down for 30
                # collects is one event, not 30.
                self._note(
                    f"flap toggled {'down' if self._flap_down else 'up'}",
                    mode="flap",
                )
            if self._flap_down:
                raise ChaosError("injected flap error")
        f = self._fault("hang")
        if f is not None and self.rng.random() < f.param:
            self._note("injected hang (collect will ride out its deadline)",
                       mode="hang")
            await asyncio.sleep(HANG_S)
            raise ChaosError("injected hang expired")  # un-deadlined runs
        f = self._fault("err")
        if f is not None and self.rng.random() < f.param:
            self._note("injected collect error", mode="err")
            raise ChaosError("injected error")
        f = self._fault("slow")
        if f is not None:
            await asyncio.sleep(f.param / 1e3)
        s = await self.inner.collect()
        f = self._fault("corrupt")
        if f is not None and self.rng.random() < f.param:
            self._note("injected payload corruption", mode="corrupt")
            s = Sample(
                source=s.source,
                ok=s.ok,
                data=_corrupt(s.data, self.rng),
                error=s.error,
                ts=s.ts,
                latency_ms=s.latency_ms,
                notes=[*s.notes, "chaos: payload corrupted"],
            )
        return s


def wrap_collectors(
    collectors: dict[str, Collector | None],
    spec: str | dict[str, list[Fault]],
    seed: int | None = None,
) -> dict[str, Collector | None]:
    """Wrap each named collector that the spec targets; unknown source
    names raise (a typo'd --chaos must not silently test nothing).
    ``spec`` is the raw grammar string or an already-split fault dict
    (app.build splits link faults off first — split_link_faults)."""
    faults_by_source = (
        dict(spec) if isinstance(spec, dict) else parse_chaos_spec(spec)
    )
    unknown = set(faults_by_source) - set(collectors)
    if unknown:
        raise ValueError(
            f"chaos spec targets unknown source(s) {sorted(unknown)}; "
            f"known: {sorted(collectors)}"
        )
    disabled = sorted(
        n for n in faults_by_source if collectors.get(n) is None
    )
    if disabled:
        raise ValueError(
            f"chaos spec targets disabled source(s) {disabled} — the "
            f"collector isn't configured, so the fault would inject "
            f"nothing"
        )
    out: dict[str, Collector | None] = {}
    for name, c in collectors.items():
        faults = faults_by_source.get(name)
        if c is not None and faults:
            out[name] = ChaosCollector(inner=c, faults=faults, seed=seed)
        else:
            out[name] = c
    return out
