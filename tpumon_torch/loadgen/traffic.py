"""Multi-tenant traffic simulator: production-shaped load for the serving
engine.

Counterpart of ``tpumon/loadgen/traffic.py``, over the port's
``ArrivalPump``/``ArrivalSource``: several tenants share one engine, each
with its own Poisson arrival rate, deterministic diurnal swing
(``diurnal_amp``/``diurnal_period_s``; ``time_scale`` compresses
simulated days), prompt shape and sampling temperature (the ``chat``,
``rag`` and ``batch`` scenario presets). Every request carries its
``tenant`` tag into the engine's ``tpumon_serving_tenant_*`` families.
Each tenant draws from ``random.Random(seed ^ crc32(name))``, the
reference's seeding, so a tenant's k-th request is the reference's k-th
request, and adding a tenant never perturbs another's stream.
``degrade(stall_s)`` stalls every engine step (the serving-path fault the
reference's SLO soak injects) without disturbing the arrival schedule.
"""

from __future__ import annotations

import math
import random
import threading
import time
import zlib
from dataclasses import dataclass, field

from tpumon_torch.loadgen.serving import ArrivalPump, ArrivalSource

SCENARIOS = ("chat", "rag", "batch")

# Scenario presets: (prompt_chunks, max_new, temperature). ``chat`` is
# short-prompt/short-answer and latency-sensitive; ``rag`` front-loads
# long prefix-shared prompts (32 chunks of prefill_len tokens — the
# retrieval context); ``batch`` is offline bulk generation where only
# throughput matters. Specs may override any of the three.
_PRESETS: dict[str, tuple[int, int, float]] = {
    "chat": (1, 16, 0.7),
    "rag": (32, 32, 0.0),
    "batch": (1, 64, 0.0),
}


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic shape. ``rps`` is the Poisson base rate;
    the effective rate at sim-time t is
    ``rps * (1 + diurnal_amp * sin(2π t / diurnal_period_s))`` (clamped
    at 0) — a deterministic diurnal profile, not noise, so two seeded
    runs see identical rate curves. Fields at their 0/None defaults
    adopt the scenario preset."""

    name: str
    scenario: str = "chat"
    rps: float = 1.0
    diurnal_amp: float = 0.0
    diurnal_period_s: float = 86400.0
    prompt_chunks: int = 0  # prompt length in prefill_len chunks
    max_new: int = 0
    temperature: float | None = None

    def resolved(self) -> tuple[int, int, float]:
        if self.scenario not in _PRESETS:
            raise ValueError(
                f"unknown scenario {self.scenario!r} (want one of "
                f"{', '.join(SCENARIOS)})")
        chunks, max_new, temp = _PRESETS[self.scenario]
        return (
            self.prompt_chunks or chunks,
            self.max_new or max_new,
            self.temperature if self.temperature is not None else temp,
        )


@dataclass
class _TenantState:
    spec: TenantSpec
    rng: object
    shared: list[int]
    submitted: int = 0
    requests: list = field(default_factory=list)


class TrafficSim:
    """Multi-tenant scenario driver over one ``ServingEngine``.

    Owns one seeded RNG per tenant (``seed`` xor a CRC of the tenant
    name, so adding a tenant never perturbs another tenant's stream)
    and one ``ArrivalSource`` per tenant over the shared pump. The
    engine is duck-typed: anything with ``cfg``, ``submit`` and
    ``step`` works, which is what keeps the seeded-replay tests free of
    a real model."""

    def __init__(self, engine, tenants: list[TenantSpec], seed: int = 0,
                 time_scale: float = 1.0, keep_requests: int = 0):
        if not tenants:
            raise ValueError("TrafficSim needs at least one TenantSpec")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        for name in names:
            # Dot-free by the series-naming contract: a dotted tenant
            # would mis-split serving.<tenant>.<metric> and the sampler
            # would never land its series — the SLO over it could
            # silently never fire.
            if not name or "." in name:
                raise ValueError(
                    f"tenant name {name!r} must be non-empty and "
                    f"dot-free (it names serving.<tenant>.* series)")
        self.engine = engine
        self.seed = seed
        self.time_scale = time_scale
        # Bound on retained Request handles per tenant (tests/bench
        # read completion stats from them); 0 keeps none.
        self.keep_requests = keep_requests
        self._stall_s = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.tenants: dict[str, _TenantState] = {}
        for spec in tenants:
            spec.resolved()  # validate scenario up front
            rng = random.Random(seed ^ zlib.crc32(spec.name.encode()))
            chunks, _, _ = spec.resolved()
            p = engine.cfg.prefill_len
            # rag-style tenants share a per-tenant retrieval prefix of
            # chunks-1 chunks (chunk-aligned, so the prefix cache's
            # chunk-granular keys actually hit); the tail chunk is
            # per-request. Single-chunk tenants have no shared prefix.
            shared = (
                [rng.randrange(engine.cfg.model.vocab)
                 for _ in range((chunks - 1) * p)]
                if chunks > 1 else []
            )
            self.tenants[spec.name] = _TenantState(
                spec=spec, rng=rng, shared=shared)
        self.pump = ArrivalPump(
            engine, [self._source(st) for st in self.tenants.values()],
            step=self._step)

    # ------------------------------ driving ------------------------------

    def _rate_fn(self, spec: TenantSpec):
        def rate(rel_t: float) -> float:
            if spec.diurnal_amp <= 0:
                return spec.rps
            phase = (2.0 * math.pi * (rel_t * self.time_scale)
                     / spec.diurnal_period_s)
            return max(0.0, spec.rps * (
                1.0 + spec.diurnal_amp * math.sin(phase)))

        return rate

    def _source(self, st: _TenantState) -> ArrivalSource:
        return ArrivalSource(
            rate=self._rate_fn(st.spec),
            fire=lambda _rel, st=st: self.fire(st.spec.name),
            interval=st.rng.expovariate,
        )

    def fire(self, tenant: str):
        """Submit one request for ``tenant`` (the pump's per-arrival
        callback; also callable directly — the seeded-replay tests
        drive it without a clock). Returns the Request."""
        st = self.tenants[tenant]
        chunks, max_new, temp = st.spec.resolved()
        p = self.engine.cfg.prefill_len
        vocab = self.engine.cfg.model.vocab
        tail_n = st.rng.randint(2, p)
        prompt = st.shared + [st.rng.randrange(vocab) for _ in range(tail_n)]
        req = self.engine.submit(
            prompt, max_new=max_new, temperature=temp,
            tenant=st.spec.name)
        st.submitted += 1
        if self.keep_requests:
            st.requests.append(req)
            del st.requests[:-self.keep_requests]
        return req

    # Per-step stall ceiling: a stalled step must stay short enough
    # that stop() joins promptly and arrivals keep draining.
    MAX_STALL_S = 1.0

    def _step(self) -> bool:
        stall = self._stall_s
        if stall > 0:
            # The scheduler-degradation knob: every engine step pays a
            # fixed stall, so queues grow and TTFT/TPOT balloon — the
            # serving-path fault of the closed-loop SLO soak.
            time.sleep(stall)
        return self.engine.step()

    def degrade(self, stall_s: float) -> None:
        """Set the per-step stall (seconds); 0 removes the fault.
        Clamped to MAX_STALL_S (1 s) at SET time so the reported state
        is the effective fault, not a silently-milder one."""
        self._stall_s = max(0.0, min(float(stall_s), self.MAX_STALL_S))

    @property
    def degraded(self) -> bool:
        return self._stall_s > 0

    # ----------------------------- lifecycle -----------------------------

    def run(self, duration: float = 0.0) -> None:
        """Drive arrivals + engine steps inline until ``duration``
        elapses (0 = until ``stop()``)."""
        self.pump.run(self._stop, duration=duration)

    def start(self) -> "TrafficSim":
        """Run in a daemon thread; ``stop()`` joins it."""
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def to_json(self) -> dict:
        return {
            "degraded": self.degraded,
            "stall_s": self._stall_s,
            "tenants": {
                name: {
                    "scenario": st.spec.scenario,
                    "rps": st.spec.rps,
                    "submitted": st.submitted,
                }
                for name, st in sorted(self.tenants.items())
            },
        }


def start_traffic_background(
    tenants: list[TenantSpec], cfg=None, port: int = 0, seed: int = 0,
    time_scale: float = 1.0, device=None,
):
    """Engine + /metrics endpoint + traffic sim, all in-process: the
    multi-tenant analogue of ``serving.start_background``. Returns
    ``(engine, sim, url, stop)``; setting ``stop`` ends the sim thread and
    closes the metrics listener. ``device`` as for ``ServingEngine``."""
    from tpumon_torch.loadgen.serving import (
        ServingEngine,
        start_metrics_server,
    )

    engine = ServingEngine(cfg=cfg, seed=seed, device=device)
    server, bound = start_metrics_server(engine, port=port)
    sim = TrafficSim(engine, tenants, seed=seed, time_scale=time_scale)

    def _run():
        try:
            sim.run()
        finally:
            server.shutdown()
            server.server_close()

    sim._thread = threading.Thread(target=_run, daemon=True)
    sim._thread.start()
    return engine, sim, f"http://127.0.0.1:{bound}/metrics", sim._stop
