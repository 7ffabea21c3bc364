"""Actuation engine: SLO-driven policies that drive the serving engine.

Everything before this module observes; the paper's L0 world ended at a
human watching alert badges and turning knobs (PAPER.md — the dashboard
modal IS the end of the pipeline). This module closes the loop
(ROADMAP item 4): declarative policies consume the monitor's own
signals — SLO page state, queue-depth trends, dark slices — and drive
the serving engine through a narrow, journaled actuator interface, so a
page-able outage becomes a TTFT blip with no human in the loop.

- **Policies** are declared in config (``actuations: [{name, when,
  action, ...}]``). ``when`` is a query-language condition (compiled
  ONCE, like the SLO bad-event expressions — docs/query.md), evaluated
  once per fast tick over the monitor's own TSDB: e.g.
  ``slo.paging{slo="chat_ttft"} > 0`` (the SLO engine's page-state
  series) or ``avg_over_time(queue_depth[30s]) > 8`` (a recording-rule
  trend, never a point walk — ``rule_texts`` registers the windows).
- **Action families** (docs/actuation.md has the catalog):
  ``shed`` — per-tenant admission throttling: shed requests complete
  with a distinct ``shed`` terminal status that is NEVER distilled into
  the tenant's error rate (counting the remedy as an error would latch
  the very SLO that triggered it), and the fraction is doubly capped
  (config ``shed_max_fraction``, engine ``SHED_CAP``);
  ``capacity`` — nudge the scheduler's prefill chunk budget and paged
  admit-lookahead window, reverting to the pre-fire baseline;
  ``drain`` — drain-and-requeue off a dark slice: when federation
  marks a placement domain dark, its in-flight requests abort and
  re-admit through the prefix cache so recomputation is prefix-cheap.
- **The engine itself is guarded** (robustness is the point): per-policy
  cooldowns and fire/clear hysteresis (consecutive-tick holds, like
  tpumon_torch.anomaly), a global performed-actions-per-window rate limit (a
  misconfigured policy set cannot thrash the engine; reverts are never
  rate-limited), ``dry_run`` that journals intent without acting, and
  automatic revert once the triggering condition clears.

Every transition — armed / fired / reverted / suppressed (cooldown) /
rate-limited — lands in the event journal (kind ``actuate``) with the
triggering expression and observed value. Surfaces: ``GET
/api/actuate`` on its own epoch-cache section, the dashboard Actuation
card (SSE realtime payload), ``tpumon_actuate_*`` exporter gauges, and
the closed-loop soak (tests/test_actuate_soak.py): fault → burn page →
journaled actuation → measurably faster recovery than the un-actuated
soak → revert, asserted in journal seq order.
"""

from __future__ import annotations

import re
import time
from collections import deque
from dataclasses import dataclass

from tpumon_torch.query import (
    Bin,
    Num,
    QueryError,
    Selector,
    parse,
    parse_range,
)
from tpumon_torch.slo import _fmt_s

ACTIONS = ("shed", "capacity", "drain")

# Dot-free and expression-safe (the name rides journal attrs and the
# per-policy exporter label).
_NAME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_-]*$")

DEFAULT_COOLDOWN_S = 30.0
DEFAULT_FIRE_HOLD = 2
DEFAULT_CLEAR_HOLD = 2

# Ring series the engine records each tick when the dark-slice
# provider reports a fleet (a wired federation hub; a None result
# means standalone — nothing recorded): the count of federation-dark
# placement domains, so a drain policy's condition
# (``federation.dark > 0``) reads live fleet state through the query
# engine like any other series.
DARK_SERIES = "federation.dark"

_CMP_OPS = (">", "<", ">=", "<=", "==", "!=")


def _walk(node):
    """Every node of a compiled query AST (Selector/Call/Agg/Bin/Neg
    leaves and branches)."""
    yield node
    for attr in ("args", "lhs", "rhs", "arg"):
        v = getattr(node, attr, None)
        if v is None:
            continue
        if isinstance(v, list):
            for c in v:
                yield from _walk(c)
        else:
            yield from _walk(v)


def _dur(v, what: str) -> float:
    """Duration: a bare number (seconds) or a duration literal."""
    try:
        return float(v)
    except (TypeError, ValueError):
        pass
    try:
        return parse_range(str(v))
    except QueryError as e:
        raise ValueError(f"{what}: {e}")


@dataclass(frozen=True)
class ActuationSpec:
    """One policy, validated. Action-specific params ride flat."""

    name: str
    when: str
    action: str
    clear: str = ""
    cooldown_s: float = DEFAULT_COOLDOWN_S
    fire_hold: int = DEFAULT_FIRE_HOLD
    clear_hold: int = DEFAULT_CLEAR_HOLD
    dry_run: bool = False
    # shed
    tenant: str = "*"
    fraction: float = 0.25
    # capacity (0 / -1 = leave that knob alone)
    prefill_budget: int = 0
    admit_lookahead: int = -1
    # drain ("" = every slice the federation currently marks dark)
    slice: str = ""

    _BASE_KEYS = frozenset({
        "name", "when", "action", "clear", "cooldown_s", "fire_hold",
        "clear_hold", "dry_run",
    })
    _ACTION_KEYS = {
        "shed": frozenset({"tenant", "fraction"}),
        "capacity": frozenset({"prefill_budget", "admit_lookahead"}),
        "drain": frozenset({"slice"}),
    }

    @classmethod
    def parse(cls, raw: dict) -> "ActuationSpec":
        """Build a spec from one ``actuations`` config entry; raises
        ValueError with an operator-readable message (a misdeclared
        policy must be an incident, not a silent no-op — the sampler
        journals it)."""
        if not isinstance(raw, dict):
            raise ValueError(f"actuation entry must be an object, got {raw!r}")
        name = str(raw.get("name") or "")
        if not _NAME_RE.match(name):
            raise ValueError(
                f"actuation name {name!r} must match {_NAME_RE.pattern}")
        when = str(raw.get("when") or "")
        try:
            parse(when)
        except QueryError as e:
            raise ValueError(f"actuation {name}: bad when {when!r}: {e}")
        clear = str(raw.get("clear") or "")
        if clear:
            try:
                parse(clear)
            except QueryError as e:
                raise ValueError(
                    f"actuation {name}: bad clear {clear!r}: {e}")
        action = str(raw.get("action") or "")
        if action not in ACTIONS:
            raise ValueError(
                f"actuation {name}: unknown action {action!r} "
                f"(want one of {', '.join(ACTIONS)})")
        known = cls._BASE_KEYS | cls._ACTION_KEYS[action]
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"actuation {name}: unknown keys {sorted(unknown)} for "
                f"action {action!r}")
        cooldown_s = _dur(raw.get("cooldown_s", DEFAULT_COOLDOWN_S),
                          f"actuation {name} cooldown_s")
        if cooldown_s < 0:
            raise ValueError(f"actuation {name}: cooldown_s must be >= 0")
        holds = {}
        for key, default in (("fire_hold", DEFAULT_FIRE_HOLD),
                             ("clear_hold", DEFAULT_CLEAR_HOLD)):
            try:
                holds[key] = int(raw.get(key, default))
            except (TypeError, ValueError):
                raise ValueError(
                    f"actuation {name}: bad {key} {raw.get(key)!r}")
            if holds[key] < 1:
                raise ValueError(f"actuation {name}: {key} must be >= 1")
        kw: dict = {}
        if action == "shed":
            tenant = str(raw.get("tenant", "*") or "*")
            try:
                fraction = float(raw.get("fraction", 0.25))
            except (TypeError, ValueError):
                raise ValueError(
                    f"actuation {name}: bad fraction {raw.get('fraction')!r}")
            if not 0.0 < fraction <= 1.0:
                raise ValueError(
                    f"actuation {name}: fraction must be in (0, 1], got "
                    f"{fraction} (1.0 still clamps to the shed caps)")
            kw.update(tenant=tenant, fraction=fraction)
        elif action == "capacity":
            try:
                budget = int(raw.get("prefill_budget", 0))
                look = int(raw.get("admit_lookahead", -1))
            except (TypeError, ValueError):
                raise ValueError(
                    f"actuation {name}: prefill_budget/admit_lookahead "
                    f"want integers")
            if budget <= 0 and look < 0:
                raise ValueError(
                    f"actuation {name}: capacity wants prefill_budget "
                    f">= 1 and/or admit_lookahead >= 0")
            kw.update(prefill_budget=max(0, budget), admit_lookahead=look)
        else:  # drain
            kw.update(slice=str(raw.get("slice", "") or ""))
        return cls(
            name=name, when=when, action=action, clear=clear,
            cooldown_s=cooldown_s, dry_run=bool(raw.get("dry_run", False)),
            **holds, **kw,
        )


def parse_actuations(raw_entries) -> tuple[list[ActuationSpec], list[str]]:
    """(valid specs, error strings) from the ``actuations`` config
    value — one bad policy must not take down the rest."""
    specs: list[ActuationSpec] = []
    errors: list[str] = []
    for raw in raw_entries or ():
        try:
            specs.append(ActuationSpec.parse(raw))
        except ValueError as e:
            errors.append(str(e))
    names = [s.name for s in specs]
    for dup in sorted({n for n in names if names.count(n) > 1}):
        errors.append(f"duplicate actuation name {dup!r}")
        specs = [s for s in specs if s.name != dup]
    return specs, errors


# ------------------------------ actuators ------------------------------


class EngineActuator:
    """The narrow interface the policy engine drives a ServingEngine
    through — seven verbs, nothing else. Keeping the surface this small
    is the robustness contract: a policy cannot reach into scheduler
    internals, only through the engine's own clamped, locked entry
    points (set_shed's SHED_CAP, nudge_capacity's floors)."""

    def __init__(self, engine):
        self.engine = engine

    def shed(self, tenant: str, fraction: float) -> float:
        return self.engine.set_shed(tenant, fraction)

    def unshed(self, tenant: str) -> None:
        self.engine.set_shed(tenant, 0.0)

    def capacity(self) -> dict:
        cfg = self.engine.cfg
        return {"prefill_budget": cfg.prefill_chunk_budget,
                "admit_lookahead": cfg.admit_lookahead}

    def nudge(self, prefill_budget=None, admit_lookahead=None) -> dict:
        return self.engine.nudge_capacity(
            prefill_budget=prefill_budget, admit_lookahead=admit_lookahead)

    def drain(self, slice_id: str) -> None:
        self.engine.drain_slice(slice_id)

    def undrain(self, slice_id: str) -> None:
        self.engine.undrain_slice(slice_id)

    def set_slices(self, names) -> None:
        """Declare the placement domains requests are attributed to —
        the drain family's prerequisite (a request with no domain can
        never be drained off one). The policy engine keeps this synced
        to the fleet's slice namespace; see observe()."""
        self.engine.set_slices(names)


# ------------------------------- engine --------------------------------


class _Policy:
    """Per-spec live state: the compiled condition, the fire/clear
    hysteresis counters, guard bookkeeping and the cached /api row."""

    def __init__(self, spec: ActuationSpec):
        self.spec = spec
        self.when_node = parse(spec.when)
        self.clear_node = parse(spec.clear) if spec.clear else None
        self.state = "idle"  # idle | armed | fired
        self.hold = 0          # consecutive ticks the condition held
        self.clear_count = 0   # consecutive clearing ticks while fired
        self.last_fired_ts: float | None = None
        self.fired = 0
        self.reverted = 0
        self.suppressed = 0
        self.rate_limited = 0
        self.fenced = 0
        # One journal event per suppression/rate-limit/fencing EPISODE
        # (the armed policy retries every tick; flooding the bounded
        # journal with per-tick repeats would evict real incidents).
        self.suppress_logged = False
        self.limit_logged = False
        self.fence_logged = False
        self.last_value: float | None = None
        self.last = ""          # "<transition> · <detail>" for the card
        self.last_ts: float | None = None
        self.drained: list[str] = []        # slices this policy drained
        self.row: dict | None = None        # cached /api/actuate row


class ActuationEngine:
    """Per-tick policy evaluator over one sampler's query engine.

    ``observe(ts)`` records the dark-slice count series, evaluates
    every compiled condition once against a shared context, runs each
    policy's guarded state machine (journaling every transition), and
    returns True when the published /api/actuate payload changed (the
    sampler bumps the "actuate" dirty section on that)."""

    def __init__(self, specs, query, history, journal, *,
                 actuator=None, dark_slices=None, placement_domains=None,
                 dry_run: bool = False,
                 max_actions: int = 10, window_s: float = 60.0,
                 shed_max_fraction: float = 0.5,
                 leader_check=None):
        self.query = query
        self.history = history
        self.journal = journal
        self.actuator = actuator
        # Root-HA fencing (tpumon_torch.leader): callable -> bool asked at
        # every FIRE decision. None means "no HA deployment here" —
        # standalone monitors always actuate. A False answer fences the
        # fire (journaled once per episode); the policy stays armed and
        # fires for real if leadership arrives while the condition still
        # holds. Reverts are deliberately NOT fenced: un-shedding is the
        # safe direction, and a demoted root must be able to release
        # remedies it applied while it led — the hazard the fence exists
        # for is two roots BOTH shedding, never both un-shedding.
        self.leader_check = leader_check
        # Last leadership answer published: a flip with no policy
        # transition must still count as a payload change, or the
        # cached /api/actuate render keeps saying "leader": true on a
        # root that just fenced itself (observe()).
        self._last_leader: bool | None = None
        self.dark_slices = dark_slices  # callable -> iterable of slice ids
        # callable -> iterable of ALL fleet placement domains (dark or
        # not) — kept synced into the engine so requests are attributed
        # to domains BEFORE a drain ever fires (a request with no
        # domain can never be drained off one).
        self.placement_domains = placement_domains
        self.dry_run = bool(dry_run)
        self.max_actions = max(1, int(max_actions))
        self.window_s = max(1.0, float(window_s))
        self.shed_max_fraction = min(1.0, max(0.0, float(shed_max_fraction)))
        self.policies = [_Policy(s) for s in specs]
        # Live shed fractions per tenant, per POLICY: the engine's
        # set_shed holds one fraction per tenant, so overlapping shed
        # policies (a mild slow-burn shed and an aggressive fast-page
        # shed on the same tenant) must combine here — the tenant sheds
        # at the max of every fired policy's fraction, and a revert
        # relaxes to the remaining max instead of removing the throttle
        # out from under a policy that is still fired.
        self._tenant_sheds: dict[str, dict[str, float]] = {}
        # Capacity nudges combine the same way: the TRUE pre-actuation
        # baseline is captured once, when the first capacity policy
        # fires (a later policy reading act.capacity() would capture
        # the first one's nudged values and "restore" to them forever),
        # and live nudges are held per policy in fire order so a revert
        # re-layers the remaining fired policies over the baseline
        # instead of yanking capacity out from under them.
        self._capacity_base: dict | None = None
        self._capacity_nudges: dict[str, dict] = {}
        # Drained slices are refcounted by policy name: a slice stays
        # drained until the LAST policy holding it reverts (one
        # policy's clear must not undrain a slice another still-fired
        # policy drained).
        self._drain_holds: dict[str, set[str]] = {}
        # Timestamps of PERFORMED actions (dry-run journals consume no
        # budget) — the global rate limiter's window.
        self._action_ts: deque[float] = deque()
        self._dark_handle = None
        self._darks: list[str] = []
        self._synced_domains: tuple[str, ...] | None = None
        # Whether anything here READS fleet darkness: a drain policy's
        # target set, or a condition on the federation.dark family. A
        # shed/capacity-only policy set must not pay the per-tick
        # hub.slices() walk + TSDB append for a series nothing reads.
        fams = {
            n.family
            for pol in self.policies
            for root in (pol.when_node, pol.clear_node)
            if root is not None
            for n in _walk(root)
            if isinstance(n, Selector)
        }
        self._wants_dark = (
            DARK_SERIES in fams
            or any(p.spec.action == "drain" for p in self.policies))
        self.evaluated_at: float | None = None
        self._payload: dict | None = None

    # ----------------------------- binding -----------------------------

    def bind_engine(self, engine) -> None:
        """Attach an in-process ServingEngine behind the narrow
        actuator interface (tpumon_torch.app wires --serve-loadgen here)."""
        self.bind_actuator(EngineActuator(engine))

    def bind_actuator(self, actuator) -> None:
        self.actuator = actuator
        self.journal.record(
            "actuate", "info", "actuate",
            f"actuator bound: {type(actuator).__name__} drives "
            f"{len(self.policies)} policies"
            + (" (DRY-RUN: intent only)" if self.dry_run else ""),
            state="bound",
        )

    def rule_texts(self) -> list[str]:
        """Recording rules for every plain range selector a condition
        reads (``avg_over_time(queue_depth[30s])`` → ``queue_depth
        [30s]``): registered by the sampler so per-tick trend reads are
        O(sub-buckets) head-state merges, never point walks — the
        bench.py ``actuate`` phase pins the ≤1% tick bound this buys.
        Matcher-carrying selectors register their FAMILY's rule (rules
        are per-family but keep per-matched-series state, so a
        ``{tenant="chat"}`` read rides them too — the same way slo.py's
        windows ride the family-wide ``slo.bad[w]`` rules)."""
        out: set[str] = set()
        for pol in self.policies:
            for root in (pol.when_node, pol.clear_node):
                if root is None:
                    continue
                for n in _walk(root):
                    if isinstance(n, Selector) and n.range_s:
                        out.add(f"{n.family}[{_fmt_s(n.range_s)}]")
        return sorted(out)

    # ---------------------------- evaluation ----------------------------

    def _observed(self, pol: _Policy, ctx) -> float | None:
        """The condition's observed value for journaling: the
        non-constant side of a comparison, collapsed to one number.
        Computed only when a transition journals — never on the
        steady-state tick, whose whole cost must stay at ONE condition
        eval per policy (bench.py's ``actuate`` phase pins ≤1% of a
        v5p-256 tick; a per-tick value refresh would re-materialize
        every expression's vector and roughly triple the stage)."""
        node = pol.when_node
        if not (isinstance(node, Bin) and node.op in _CMP_OPS):
            return None
        for side in (node.lhs, node.rhs):
            if isinstance(side, Num):
                continue
            try:
                v = self.query.eval_compiled(side, ctx=ctx)
            except QueryError:
                return None
            if isinstance(v, list):
                vals = [x for _, x in v if x is not None and x == x]
                if not vals:
                    return None
                v = sum(vals) / len(vals)
            if v is None or v != v:
                return None
            return round(float(v), 4)
        return None

    def _data_absent(self, node, ctx) -> bool:
        """True when the expression's data side reads no samples at
        all — distinct from present-but-false. Used only on FIRED
        policies with an explicit ``clear``: `_cond` maps absent data
        to False for both expressions (absent never *actuates*), which
        would wedge the policy fired forever once its series vanishes
        (collector dies, source drains) — a when-only policy in the
        same situation reverts via ``not when``. Same staleness class
        slo.py hardens (a firing alert must resolve when all window
        data vanishes); the safe direction for a remedy is revert."""
        if isinstance(node, Bin) and node.op in _CMP_OPS:
            sides = [s for s in (node.lhs, node.rhs)
                     if not isinstance(s, Num)]
            if not sides:
                return False  # constants are never absent
        else:
            sides = [node]
        for side in sides:
            try:
                v = self.query.eval_compiled(side, ctx=ctx)
            except QueryError:
                continue  # broken reads as absent
            if isinstance(v, list):
                if any(x is not None and x == x for _, x in v):
                    return False
            elif v is not None and v == v:
                return False
        return True

    def _effective_dry(self, pol: _Policy) -> bool:
        return self.dry_run or pol.spec.dry_run or self.actuator is None

    def _prune_actions(self, ts: float) -> None:
        while self._action_ts and ts - self._action_ts[0] > self.window_s:
            self._action_ts.popleft()

    def _detail(self, pol: _Policy, perform: bool) -> str:
        """Describe — and with ``perform`` actually execute — the
        policy's action. The dry-run path journals exactly this string
        with ``perform=False``, so intent and act read identically."""
        spec = pol.spec
        act = self.actuator
        if spec.action == "shed":
            frac = min(spec.fraction, self.shed_max_fraction)
            if perform:
                sheds = self._tenant_sheds.setdefault(spec.tenant, {})
                sheds[spec.name] = frac
                frac = act.shed(spec.tenant, max(sheds.values()))
            return f"shed tenant {spec.tenant} at {frac:.2f}"
        if spec.action == "capacity":
            budget = spec.prefill_budget or None
            look = spec.admit_lookahead if spec.admit_lookahead >= 0 else None
            if perform:
                if self._capacity_base is None:
                    self._capacity_base = act.capacity()
                # Re-fires move to the back of the layering order.
                self._capacity_nudges.pop(spec.name, None)
                self._capacity_nudges[spec.name] = {
                    "prefill_budget": budget, "admit_lookahead": look}
                eff = act.nudge(prefill_budget=budget, admit_lookahead=look)
                return (f"capacity -> prefill_budget "
                        f"{eff['prefill_budget']}, admit_lookahead "
                        f"{eff['admit_lookahead']}")
            return (f"capacity -> prefill_budget {budget or '(keep)'}, "
                    f"admit_lookahead {'(keep)' if look is None else look}")
        # drain: explicit slice, else whatever federation marks dark NOW
        targets = [spec.slice] if spec.slice else list(self._darks)
        if perform:
            for s in targets:
                holders = self._drain_holds.setdefault(s, set())
                if not holders:
                    act.drain(s)
                holders.add(spec.name)
            pol.drained = targets
        return f"drain slice(s): {', '.join(targets) or '(none dark)'}"

    def _revert_detail(self, pol: _Policy, perform: bool) -> str:
        spec = pol.spec
        act = self.actuator
        if spec.action == "shed":
            if perform:
                sheds = self._tenant_sheds.get(spec.tenant, {})
                sheds.pop(spec.name, None)
                if sheds:
                    # Another fired policy still sheds this tenant:
                    # relax to the remaining max, don't remove.
                    frac = max(sheds.values())
                    act.shed(spec.tenant, frac)
                    return (f"shed tenant {spec.tenant} relaxed to "
                            f"{frac:.2f} ({len(sheds)} polic"
                            f"{'y' if len(sheds) == 1 else 'ies'} "
                            f"still shedding)")
                self._tenant_sheds.pop(spec.tenant, None)
                act.unshed(spec.tenant)
            return f"unshed tenant {spec.tenant}"
        if spec.action == "capacity":
            base = self._capacity_base
            if perform:
                self._capacity_nudges.pop(spec.name, None)
                if base:
                    act.nudge(**base)
                    # Other fired capacity policies re-layer over the
                    # baseline in fire order — their nudges survive
                    # this policy's revert.
                    for kw in self._capacity_nudges.values():
                        act.nudge(**kw)
                if self._capacity_nudges:
                    n = len(self._capacity_nudges)
                    return (f"capacity restored to {base} then "
                            f"re-layered ({n} polic"
                            f"{'y' if n == 1 else 'ies'} still nudging)")
                self._capacity_base = None
            return f"capacity restored to {base or '(baseline unknown)'}"
        targets = list(pol.drained)
        if perform:
            kept: list[str] = []
            for s in targets:
                holders = self._drain_holds.get(s)
                if holders is not None:
                    holders.discard(spec.name)
                    if holders:
                        kept.append(s)
                        continue
                    self._drain_holds.pop(s, None)
                act.undrain(s)
            pol.drained = []
            if kept:
                undrained = [s for s in targets if s not in kept]
                return (f"undrain slice(s): "
                        f"{', '.join(undrained) or '(none)'} "
                        f"(still drained by other policies: "
                        f"{', '.join(kept)})")
        pol.drained = []
        return f"undrain slice(s): {', '.join(targets) or '(none)'}"

    def _journal(self, pol: _Policy, state: str, sev: str, detail: str,
                 ts: float, dry: bool, ctx=None) -> None:
        if ctx is not None:
            pol.last_value = self._observed(pol, ctx)
        self.journal.record(
            "actuate", sev, "actuate",
            f"policy {pol.spec.name} {state}"
            + (" (dry-run)" if dry and state in ("fired", "reverted")
               else "")
            + f": {detail}",
            ts=ts,
            policy=pol.spec.name,
            action=pol.spec.action,
            state=state,
            expr=pol.spec.when,
            value=pol.last_value,
            dry_run=True if dry else None,
        )
        pol.last = f"{state} · {detail}"
        pol.last_ts = ts

    def _sync_domains(self, ts: float) -> None:
        """Keep the engine's placement-domain namespace synced to the
        fleet's, so requests carry a slice attribution BEFORE any drain
        fires. Only when a live (non-dry) drain policy exists — dry-run
        deployments provably change no engine state — and only on
        change (set_slices resets attribution round-robin)."""
        setter = getattr(self.actuator, "set_slices", None)
        if self.placement_domains is None or setter is None:
            return
        if not any(p.spec.action == "drain" and not self._effective_dry(p)
                   for p in self.policies):
            return
        doms = self.placement_domains()
        doms = tuple(sorted({str(d) for d in doms})) if doms else ()
        # An empty read (fleet view warming up, every leaf silent)
        # keeps the last known namespace — dropping attribution
        # mid-outage would make the outage undrainable.
        if not doms or doms == self._synced_domains:
            return
        setter(doms)
        self._synced_domains = doms
        self.journal.record(
            "actuate", "info", "actuate",
            f"placement domains synced: {len(doms)} "
            f"({', '.join(doms[:8])}{', …' if len(doms) > 8 else ''})",
            ts=ts, state="domains",
        )

    def observe(self, ts: float | None = None) -> bool:
        ts = time.time() if ts is None else ts
        changed = False
        # Leadership rides the published payload (to_json "leader"):
        # losing or gaining the lease re-renders /api/actuate even when
        # no policy moved this tick.
        lead = self._is_leader()
        if lead != self._last_leader:
            self._last_leader = lead
            changed = True
        # Dark-slice count series FIRST, so this very tick's drain
        # conditions read current fleet state. A None provider result
        # means "no fleet here" (standalone monitor, no federation
        # hub): skip the record — the per-tick append is nearly half
        # the stage cost, and an absent series and a 0.0 read alike
        # under `federation.dark > 0` (absent never fires). The
        # provider is not even CALLED unless a policy reads darkness
        # (_wants_dark): shed/capacity-only sets skip the walk too.
        darks = (self.dark_slices()
                 if self.dark_slices is not None and self._wants_dark
                 else None)
        if darks is not None:
            self._darks = sorted(darks)
            if self._dark_handle is None or (
                    self.history.series.get(DARK_SERIES)
                    is not self._dark_handle):
                self._dark_handle = self.history.handle(DARK_SERIES)
            self.history.record_batch(
                [(self._dark_handle, float(len(self._darks)))], ts=ts)
        self._sync_domains(ts)
        self._prune_actions(ts)
        ctx = self.query.context(at=ts)
        # Condition results memoized by expression TEXT for this tick:
        # real policy sets share trigger expressions (every per-tenant
        # shed keyed on the same page-state read), so each distinct
        # condition is evaluated once per tick no matter how many
        # policies gate on it.
        cond_memo: dict[str, bool] = {}
        for pol in self.policies:
            if self._step_policy(pol, ctx, ts, cond_memo):
                changed = True
                pol.row = None
        for pol in self.policies:
            if pol.row is None:
                spec = pol.spec
                pol.row = {
                    "name": spec.name,
                    "action": spec.action,
                    "when": spec.when,
                    "state": pol.state,
                    "dry_run": self._effective_dry(pol),
                    "value": pol.last_value,
                    "last": pol.last,
                    "last_ts": pol.last_ts,
                    "fired": pol.fired,
                    "reverted": pol.reverted,
                    "suppressed": pol.suppressed,
                    "rate_limited": pol.rate_limited,
                    "fenced": pol.fenced,
                }
        first = self._payload is None
        self.evaluated_at = ts
        if changed or first:
            self._payload = {"policies": [p.row for p in self.policies]}
        return changed or first

    def _is_leader(self) -> bool:
        """May this engine perform (or even dry-journal) a FIRE right
        now? True with no leader_check wired — fencing is an HA-root
        concern only."""
        return self.leader_check is None or bool(self.leader_check())

    def _cond(self, node, text: str, ctx, memo: dict) -> bool:
        try:
            return memo[text]
        except KeyError:
            pass
        try:
            v = self.query.eval_condition(node, ctx=ctx)
        except QueryError:
            v = False  # absent/broken data never actuates
        memo[text] = v
        return v

    def _step_policy(self, pol: _Policy, ctx, ts: float,
                     memo: dict) -> bool:
        """One tick of one policy's guarded state machine; returns True
        when its published row changed."""
        spec = pol.spec
        cond = self._cond(pol.when_node, spec.when, ctx, memo)
        changed = False
        dry = self._effective_dry(pol)

        if pol.state == "idle":
            if cond:
                pol.state = "armed"
                pol.hold = 1
                pol.suppress_logged = pol.limit_logged = False
                pol.fence_logged = False
                self._journal(pol, "armed", "info",
                              f"condition holds: {spec.when}", ts, dry,
                              ctx=ctx)
                changed = True
        elif pol.state == "armed":
            if not cond:
                pol.state = "idle"
                pol.hold = 0
                changed = True
            else:
                pol.hold += 1
        if pol.state == "armed" and pol.hold >= spec.fire_hold:
            in_cooldown = (
                pol.last_fired_ts is not None
                and ts - pol.last_fired_ts < spec.cooldown_s)
            if not self._is_leader():
                # Fencing precedes every other fire gate INCLUDING the
                # dry-run path: a standby root runs the same policy set
                # (so promotion inherits armed state instantly) but must
                # not even dry-fire — the journal would read as a second
                # root acting. Episode-logged like suppression; the
                # policy stays armed and fires on the first tick after
                # promotion if the condition still holds.
                if not pol.fence_logged:
                    pol.fence_logged = True
                    pol.fenced += 1
                    self._journal(
                        pol, "fenced", "serious",
                        "not fleet leader (leadership lease lost, "
                        "expired, or never held): refusing to actuate",
                        ts, dry, ctx=ctx)
                    changed = True
            elif in_cooldown:
                if not pol.suppress_logged:
                    pol.suppress_logged = True
                    pol.suppressed += 1
                    left = spec.cooldown_s - (ts - pol.last_fired_ts)
                    self._journal(
                        pol, "suppressed", "minor",
                        f"cooldown: {left:.1f}s of {spec.cooldown_s:g}s "
                        f"remain", ts, dry, ctx=ctx)
                    changed = True
            elif not dry and len(self._action_ts) >= self.max_actions:
                if not pol.limit_logged:
                    pol.limit_logged = True
                    pol.rate_limited += 1
                    self._journal(
                        pol, "rate-limited", "minor",
                        f"global budget spent: {len(self._action_ts)} "
                        f"actions in the last {self.window_s:g}s "
                        f"(max {self.max_actions})", ts, dry, ctx=ctx)
                    changed = True
            else:
                detail = self._detail(pol, perform=not dry)
                if not dry:
                    self._action_ts.append(ts)
                pol.state = "fired"
                pol.fired += 1
                pol.last_fired_ts = ts
                pol.clear_count = 0
                self._journal(pol, "fired", "serious", detail, ts, dry,
                              ctx=ctx)
                changed = True
        elif pol.state == "fired":
            # The explicit clear expression is consumed ONLY here, so
            # it is evaluated only while fired — an idle policy's
            # steady-state tick stays at ONE condition eval (the cost
            # contract bench.py's ``actuate`` phase pins).
            if pol.clear_node is not None:
                clearing = self._cond(pol.clear_node, spec.clear, ctx,
                                      memo)
                if not clearing and self._data_absent(pol.clear_node,
                                                      ctx):
                    # The explicit clear reads NO data at all: treat
                    # as clearing (through the normal clear_hold)
                    # instead of holding the remedy applied forever on
                    # a vanished source — see _data_absent.
                    clearing = True
            else:
                clearing = not cond
            if clearing:
                pol.clear_count += 1
                if pol.clear_count >= spec.clear_hold:
                    detail = self._revert_detail(pol, perform=not dry)
                    pol.state = "idle"
                    pol.hold = 0
                    pol.reverted += 1
                    self._journal(pol, "reverted", "info", detail, ts, dry,
                                  ctx=ctx)
                    changed = True
            else:
                pol.clear_count = 0
        return changed

    # ------------------------------ outputs ------------------------------

    @property
    def actions_in_window(self) -> int:
        """Performed actions inside the current rate-limit window —
        the exporter reads this scalar without building the payload."""
        return len(self._action_ts)

    def to_json(self) -> dict:
        return {
            "policies": list((self._payload or {}).get("policies") or []),
            "dry_run": self.dry_run,
            "engine_bound": self.actuator is not None,
            "max_actions": self.max_actions,
            "window_s": self.window_s,
            "actions_in_window": self.actions_in_window,
            "leader": self._is_leader(),
            "evaluated_at": self.evaluated_at,
        }

    def exporter_rows(self) -> list[dict]:
        """Flat per-policy rows for the tpumon_actuate_* block."""
        return list((self._payload or {}).get("policies") or [])
