"""SLO engine: error budgets + multi-window multi-burn-rate alerts.

The monitor's alerting so far is *level*-based: a gauge crossed a
threshold **now**. A latency SLO burns toward breach long before any
single reading looks alarming — and pages on a 5-minute blip it should
have ignored. This module closes that gap with the Google-SRE
multi-window multi-burn-rate recipe (SRE Workbook ch. 5), built on the
in-tree query engine (tpumon_torch.query, docs/query.md):

- **Objectives** are declared in config (``slos: [{name, tenant, expr,
  target, window}]``). ``expr`` is the *bad-event condition*, written
  in the query language over the monitor's own TSDB series (typically
  the per-tenant ``serving.<tenant>.*`` series the traffic-driven
  engine lands — e.g. ``serving.ttft_p95_ms{tenant="chat"} > 250``).
  Each tick the compiled condition evaluates to a bad fraction in
  [0, 1] that is RECORDED as a ``slo.<name>.bad`` TSDB series — the
  raw material every window aggregate reads.
- **Burn rates** are compiled query expressions over that series
  (``avg_over_time(slo.bad{slo="x"}[5m]) / budget``), compiled ONCE
  per config — no hand-rolled rule closures — and re-evaluated on a
  short-window/24 cadence (a burn rate over a w-second window moves at
  w-granularity; the cadence bounds alert latency at ~4% of the short
  window while keeping per-tick cost flat). The window aggregates ride
  the recording-rule store (the sampler registers ``slo.bad[w]`` rules
  for every declared window), so each read is an O(sub-buckets)
  head-state merge, never a point walk.
  Two alert speeds, each gated on BOTH its windows (the short window
  suppresses flap, the long window proves it's real): the *fast* pair
  (5m/1h at 14.4× budget burn) pages, the *slow* pair (30m/6h at 6×)
  files a ticket. Windows derive from the SLO period by the SRE-
  workbook ratios (period/720 and /120, each with a 1/12 short window)
  and may be overridden per objective — the closed-loop soak runs
  second-scale windows. Clearing takes *either* window dropping below
  ``clear_ratio`` × threshold — recovery hysteresis, so a burn
  hovering at the line doesn't flap.
- **Error budget**: 1 − (bad fraction over the whole SLO window) /
  (1 − target); negative = exhausted. Windows longer than the ring's
  retention average over what exists (warmup semantics — tested).

Outputs: an ``slo`` journal event per fire/resolve, alert rows the
AlertEngine serves (fast → critical page, slow → minor ticket),
``GET /api/slo`` on its own epoch-cache section, ``tpumon_slo_*``
exporter gauges, the dashboard burn-down card, and ``tpumon slo``
(this module's CLI). docs/slo.md has the math and the soak walkthrough.
"""

from __future__ import annotations

import json
import re
import sys
import time
from dataclasses import dataclass

from tpumon_torch.query import QueryError, parse, parse_range

# SRE-workbook defaults: 14.4× burn over 5m/1h pages (2% of a 30d
# budget in one hour), 6× over 30m/6h tickets (5% in six hours).
DEFAULT_FAST_BURN = 14.4
DEFAULT_SLOW_BURN = 6.0
DEFAULT_CLEAR_RATIO = 0.9

# Dot-free (the ``slo.<name>.bad`` series name and its derived {slo=}
# label both split on dots) and expression-safe.
_NAME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_-]*$")

SPEEDS = ("fast", "slow")


def _fmt_s(w: float) -> str:
    """Seconds as a plain-decimal duration literal — ``{:g}`` would
    produce exponent notation for month-scale windows, which the
    duration grammar rejects."""
    text = f"{w:.6f}".rstrip("0").rstrip(".")
    return f"{text}s"


def _dur(v, what: str) -> float:
    try:
        s = parse_range(str(v))
    except QueryError as e:
        raise ValueError(f"{what}: {e}")
    if s <= 0:
        raise ValueError(f"{what}: want a positive duration, got {v!r}")
    return s


@dataclass(frozen=True)
class SLOSpec:
    """One objective, validated. ``windows[speed]`` is the (short_s,
    long_s) burn-window pair; ``burns[speed]`` its fire threshold."""

    name: str
    expr: str
    target: float
    window_s: float
    tenant: str = ""
    fast: tuple[float, float] = (300.0, 3600.0)
    slow: tuple[float, float] = (1800.0, 21600.0)
    fast_burn: float = DEFAULT_FAST_BURN
    slow_burn: float = DEFAULT_SLOW_BURN
    clear_ratio: float = DEFAULT_CLEAR_RATIO

    @property
    def budget_fraction(self) -> float:
        return 1.0 - self.target

    def windows(self, speed: str) -> tuple[float, float]:
        return self.fast if speed == "fast" else self.slow

    def burn_threshold(self, speed: str) -> float:
        return self.fast_burn if speed == "fast" else self.slow_burn

    @classmethod
    def parse(cls, raw: dict) -> "SLOSpec":
        """Build a spec from one ``slos`` config entry; raises
        ValueError with an operator-readable message on any problem
        (a misdeclared objective must be an incident, not a silent
        no-op — the sampler journals it)."""
        if not isinstance(raw, dict):
            raise ValueError(f"slo entry must be an object, got {raw!r}")
        name = str(raw.get("name") or "")
        if not _NAME_RE.match(name):
            raise ValueError(
                f"slo name {name!r} must match {_NAME_RE.pattern} "
                f"(it names the slo.<name>.bad series)")
        expr = str(raw.get("expr") or "")
        try:
            parse(expr)
        except QueryError as e:
            raise ValueError(f"slo {name}: bad expr {expr!r}: {e}")
        try:
            target = float(raw.get("target", 0.0))
        except (TypeError, ValueError):
            raise ValueError(f"slo {name}: bad target {raw.get('target')!r}")
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"slo {name}: target must be in (0, 1), got {target} "
                f"(0.99 = 99% of events good)")
        window_s = _dur(raw.get("window", "30d"), f"slo {name} window")
        # Burn windows: explicit ["5m","1h"] pairs, else the SRE-
        # workbook derivation from the SLO period (for 30d: 5m/1h fast,
        # 30m/6h slow).
        pairs: dict[str, tuple[float, float]] = {}
        for speed, divisor in (("fast", 720.0), ("slow", 120.0)):
            given = raw.get(speed)
            if given is not None:
                if not (isinstance(given, (list, tuple)) and len(given) == 2):
                    raise ValueError(
                        f"slo {name}: {speed} wants [short, long] "
                        f"durations, got {given!r}")
                short = _dur(given[0], f"slo {name} {speed} short")
                long_ = _dur(given[1], f"slo {name} {speed} long")
            else:
                long_ = window_s / divisor
                short = long_ / 12.0
            if short >= long_:
                raise ValueError(
                    f"slo {name}: {speed} short window ({short:g}s) must "
                    f"be below its long window ({long_:g}s)")
            pairs[speed] = (short, long_)
        extra = {}
        for key, default in (
            ("fast_burn", DEFAULT_FAST_BURN),
            ("slow_burn", DEFAULT_SLOW_BURN),
            ("clear_ratio", DEFAULT_CLEAR_RATIO),
        ):
            try:
                extra[key] = float(raw.get(key, default))
            except (TypeError, ValueError):
                raise ValueError(f"slo {name}: bad {key} {raw.get(key)!r}")
            if extra[key] <= 0:
                raise ValueError(f"slo {name}: {key} must be positive")
        if extra["clear_ratio"] > 1.0:
            raise ValueError(
                f"slo {name}: clear_ratio must be <= 1 (clearing above "
                f"the fire threshold would never clear)")
        known = {
            "name", "expr", "target", "window", "tenant", "fast", "slow",
            "fast_burn", "slow_burn", "clear_ratio",
        }
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"slo {name}: unknown keys {sorted(unknown)}")
        return cls(
            name=name, expr=expr, target=target, window_s=window_s,
            tenant=str(raw.get("tenant") or ""),
            fast=pairs["fast"], slow=pairs["slow"], **extra,
        )


def _is_condition(node) -> bool:
    """True when the expression's root is a comparison (possibly under
    and/or): its value is boolean — present/true means the tick is bad.
    Anything else is read as a bad *fraction* (e.g. an error-rate
    series already in [0, 1])."""
    from tpumon_torch.query import Bin

    if isinstance(node, Bin):
        if node.op in ("and", "or"):
            return _is_condition(node.lhs) or _is_condition(node.rhs)
        return node.op in (">", "<", ">=", "<=", "==", "!=")
    return False


class _Compiled:
    """Per-spec compiled artifacts: the bad-event condition, the four
    burn-window aggregates and the budget aggregate — all parsed ONCE
    at construction (the no-hardcoded-rule-closures contract)."""

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.bad_node = parse(spec.expr)
        self.condition = _is_condition(self.bad_node)
        # Fraction-mode staleness bound: a per-tick bad-fraction sample
        # read from data older than the objective's shortest burn
        # window is not a current observation — it reads as absent
        # (unknown), so a vanished source's windows actually drain and
        # a firing alert resolves instead of paging on the engine's
        # 5-minute default lookback forever. Condition mode keeps the
        # default lookback: its absent-never-fires contract already
        # fails safe, and Prometheus-style staleness there matches the
        # alert engine's comparison semantics.
        self.stale_s = min(spec.fast[0], spec.slow[0])
        self.series = f"slo.{spec.name}.bad"
        self.handle = None  # resolved lazily against the live ring
        # Page-state series (the actuation engine's trigger,
        # docs/actuation.md): slo.<name>.paging is 1.0 while the FAST
        # window pair burns (the paging pair — slow tickets don't
        # actuate), 0.0 otherwise, recorded every tick so a policy
        # condition like ``slo.paging{slo="x"} > 0`` reads live state
        # rather than the alert engine's internals.
        self.page_series = f"slo.{spec.name}.paging"
        self.page_handle = None
        sel = f'slo.bad{{slo="{spec.name}"}}'
        self.window_nodes = {
            speed: tuple(
                parse(f"avg_over_time({sel}[{_fmt_s(w)}])")
                for w in spec.windows(speed)
            )
            for speed in SPEEDS
        }
        self.budget_node = parse(
            f"avg_over_time({sel}[{_fmt_s(spec.window_s)}])")
        # speed -> firing state (the engine's hysteresis memory).
        self.firing = {speed: False for speed in SPEEDS}
        # Window-evaluation cadence (docs/slo.md): a burn rate over a
        # w-second window moves at w-granularity, so re-evaluating each
        # pair every short/24 seconds loses nothing (alert latency is
        # bounded by ~4% of the short window) and keeps the per-tick
        # cost flat no matter how slow the ticks' windows are. 0 =
        # evaluate on the next observe.
        self.next_eval = {speed: 0.0 for speed in SPEEDS}
        self.next_budget = 0.0
        self.burn: dict[str, dict] = {
            speed: {
                "short_s": spec.windows(speed)[0],
                "long_s": spec.windows(speed)[1],
                "threshold": spec.burn_threshold(speed),
                "short": None,
                "long": None,
                "firing": False,
            }
            for speed in SPEEDS
        }
        self.budget = {"bad_fraction": None, "used": None, "remaining": None}
        self.last_bad: float | None = None
        self.row: dict | None = None  # cached /api/slo row


def _first_value(v) -> float | None:
    """Collapse an eval result to one number: the slo.bad selector
    matches exactly one series, so a vector has 0 or 1 elements."""
    if isinstance(v, list):
        return v[0][1] if v else None
    if v is None or v != v:  # None / NaN
        return None
    return float(v)


class SLOEngine:
    """Per-tick evaluator over one sampler's query engine + ring.

    ``observe(ts)`` records each objective's bad fraction, re-evaluates
    the compiled burn-rate expressions, runs the both-windows-must-fire
    / either-window-clears state machine, journals ``slo`` events on
    transitions, and returns True when the published /api/slo payload
    changed (the sampler bumps the "slo" dirty section on that)."""

    def __init__(self, specs: list[SLOSpec], query, history, journal):
        self.query = query
        self.history = history
        self.journal = journal
        self.compiled = [_Compiled(s) for s in specs]
        # The slo.<name>.paging series exists FOR actuation conditions
        # (docs/actuation.md); the sampler flips this on when policies
        # are configured — a monitor with SLOs but no actuations must
        # not pay a per-objective TSDB append every tick for a series
        # nothing reads.
        self.record_paging = False
        self.evaluated_at: float | None = None
        self._payload: dict | None = None

    def rule_texts(self) -> list[str]:
        """Recording rules covering every burn/budget window over the
        ``slo.bad`` family: registered by the sampler alongside the
        config's own rules, so the per-tick ``avg_over_time`` reads are
        O(sub-buckets) head-state merges at any window length instead
        of point walks (the append-time-aggregation contract;
        bench.py's ``slo`` phase pins the ≤2% tick overhead this
        buys)."""
        windows: set[float] = set()
        for c in self.compiled:
            for speed in SPEEDS:
                windows.update(c.spec.windows(speed))
            windows.add(c.spec.window_s)
        return [f"slo.bad[{_fmt_s(w)}]" for w in sorted(windows)]

    # ----------------------------- evaluation -----------------------------

    def _bad_fraction(self, c: _Compiled, ctx) -> float | None:
        if c.condition:
            # Boolean semantics with the alert engine's None contract:
            # a condition over absent data never fires (0.0 = good).
            # eval_condition short-circuits the selector-vs-constant
            # shape without materializing label vectors — the per-tick
            # hot path the ≤2% eval-overhead bound budgets for.
            try:
                return 1.0 if self.query.eval_condition(
                    c.bad_node, ctx=ctx) else 0.0
            except QueryError:
                return None
        ctx.lookback_s = c.stale_s  # see _Compiled.stale_s
        try:
            v = self.query.eval_compiled(c.bad_node, ctx=ctx)
        except QueryError:
            return None
        finally:
            ctx.lookback_s = None
        # Fraction semantics: no data is *unknown*, not good.
        if isinstance(v, list):
            vals = [x for _, x in v if x is not None and x == x]
            if not vals:
                return None
            v = sum(vals) / len(vals)
        if v is None or v != v:
            return None
        return min(1.0, max(0.0, float(v)))

    def _avg(self, c: _Compiled, node, ctx) -> float | None:
        try:
            return _first_value(self.query.eval_compiled(node, ctx=ctx))
        except QueryError:
            return None

    def observe(self, ts: float | None = None) -> bool:
        ts = time.time() if ts is None else ts
        # One evaluation context for the whole tick: the pod-attribution
        # augmenter builds once, and point fetches are shared across
        # every compiled expression at this instant.
        ctx = self.query.context(at=ts)
        batch = []
        changed = False
        for c in self.compiled:
            bad = self._bad_fraction(c, ctx)
            if bad != c.last_bad:
                c.last_bad = bad
                changed = True
                c.row = None
            if bad is not None:
                if c.handle is None or (
                        self.history.series.get(c.series) is not c.handle):
                    # Lazy + restore-safe: a snapshot restore replaces
                    # series objects (same contract as the sampler's
                    # handle caches).
                    c.handle = self.history.handle(c.series)
                batch.append((c.handle, bad))
        if batch:
            self.history.record_batch(batch, ts=ts)
        for c in self.compiled:
            spec = c.spec
            budget_frac = spec.budget_fraction
            for speed in SPEEDS:
                if ts < c.next_eval[speed]:
                    continue
                short_w = spec.windows(speed)[0]
                short_node, long_node = c.window_nodes[speed]
                short_avg = self._avg(c, short_node, ctx)
                long_avg = self._avg(c, long_node, ctx)
                # The cadence clock only starts once data exists: a
                # warmup eval over an empty series retries next tick
                # (cheap — no matching series) instead of holding the
                # None verdict for a whole cadence period.
                if short_avg is not None or long_avg is not None:
                    c.next_eval[speed] = ts + short_w / 24.0
                short_burn = (
                    None if short_avg is None else short_avg / budget_frac)
                long_burn = (
                    None if long_avg is None else long_avg / budget_frac)
                thr = spec.burn_threshold(speed)
                clear_thr = thr * spec.clear_ratio
                was = c.firing[speed]
                if not was:
                    # Both windows must exceed the threshold to fire —
                    # the short window proves it's current, the long
                    # window proves it's sustained.
                    if (short_burn is not None and long_burn is not None
                            and short_burn >= thr and long_burn >= thr):
                        c.firing[speed] = True
                        self._journal(c, speed, "fired",
                                      short_burn, long_burn, thr)
                else:
                    # Either window dropping below clear_ratio × the
                    # threshold clears (recovery hysteresis: between
                    # clear and fire the alert holds its state).
                    if (short_burn is not None and long_burn is not None
                            and (short_burn < clear_thr
                                 or long_burn < clear_thr)):
                        c.firing[speed] = False
                        self._journal(c, speed, "resolved",
                                      short_burn, long_burn, thr)
                    elif short_burn is None and long_burn is None:
                        # Both windows drained with no data at all (a
                        # fraction-mode objective whose source series
                        # vanished): no evidence of burn remains, so
                        # resolve instead of paging forever on stale
                        # state — the source-down / target-unreachable
                        # alerts own the outage story.
                        c.firing[speed] = False
                        self._journal(c, speed, "resolved",
                                      0.0, 0.0, thr)
                b = c.burn[speed]
                new = (_r(short_burn), _r(long_burn), c.firing[speed])
                if (b["short"], b["long"], b["firing"]) != new:
                    b["short"], b["long"], b["firing"] = new
                    changed = True
                    c.row = None
            if ts >= c.next_budget:
                # Budget moves at SLO-window granularity: the slow
                # pair's cadence is plenty. Same warmup rule as the
                # window pairs: no data, no cadence hold.
                window_avg = self._avg(c, c.budget_node, ctx)
                if window_avg is not None:
                    c.next_budget = ts + spec.slow[0] / 24.0
                used = (
                    None if window_avg is None else window_avg / budget_frac)
                new_budget = {
                    "bad_fraction": _r(window_avg),
                    "used": _r(used),
                    "remaining": None if used is None else _r(1.0 - used),
                }
                if new_budget != c.budget:
                    c.budget = new_budget
                    changed = True
                    c.row = None
            if c.row is None:
                c.row = {
                    "name": spec.name,
                    "tenant": spec.tenant,
                    "expr": spec.expr,
                    "target": spec.target,
                    "window_s": spec.window_s,
                    "bad": _r(c.last_bad),
                    "budget": c.budget,
                    "burn": c.burn,
                }
        # Page-state series AFTER the burn state machine so the value
        # reflects THIS tick's verdict (recording it with the bad batch
        # above would lag the fire/clear by one tick — an actuation
        # policy keyed on it would shed one tick late, and keep
        # shedding one tick past recovery).
        page_batch = []
        if self.record_paging:
            for c in self.compiled:
                if c.page_handle is None or (
                        self.history.series.get(c.page_series)
                        is not c.page_handle):
                    c.page_handle = self.history.handle(c.page_series)
                page_batch.append(
                    (c.page_handle, 1.0 if c.firing["fast"] else 0.0))
        if page_batch:
            self.history.record_batch(page_batch, ts=ts)
        first = self._payload is None
        self.evaluated_at = ts
        if changed or first:
            self._payload = {"slos": [c.row for c in self.compiled]}
        return changed or first

    def _journal(self, c: _Compiled, speed: str, state: str,
                 short_burn: float, long_burn: float, thr: float) -> None:
        spec = c.spec
        sev = ("critical" if speed == "fast" else "minor")
        if state == "resolved":
            sev = "info"
        self.journal.record(
            "slo", sev, "slo",
            f"SLO {spec.name} {speed}-window burn {state}: "
            f"{short_burn:.1f}x/{long_burn:.1f}x vs {thr:g}x budget burn",
            slo=spec.name,
            tenant=spec.tenant or None,
            window=speed,
            state=state,
            burn_short=round(short_burn, 3),
            burn_long=round(long_burn, 3),
            threshold=thr,
        )

    # ------------------------------ outputs -------------------------------

    def to_json(self) -> dict:
        return {
            "slos": list((self._payload or {}).get("slos") or []),
            "evaluated_at": self.evaluated_at,
        }

    def alert_rows(self) -> list[dict]:
        """Currently-firing burn windows for the AlertEngine: one row
        per (objective, speed), fast pages, slow tickets."""
        rows = []
        for c in self.compiled:
            for speed in SPEEDS:
                if not c.firing[speed]:
                    continue
                short_w, long_w = c.spec.windows(speed)
                rows.append({
                    "name": c.spec.name,
                    "tenant": c.spec.tenant,
                    "window": speed,
                    "short_s": short_w,
                    "long_s": long_w,
                    "threshold": c.spec.burn_threshold(speed),
                })
        return rows

    def exporter_rows(self) -> list[dict]:
        """Flat per-objective numbers for the tpumon_slo_* block."""
        out = []
        for row in (self._payload or {}).get("slos") or []:
            out.append(row)
        return out


def _r(v: float | None) -> float | None:
    return None if v is None else round(v, 4)


def parse_slos(raw_entries) -> tuple[list[SLOSpec], list[str]]:
    """(valid specs, error strings) from the ``slos`` config value —
    one bad objective must not take down the rest."""
    specs: list[SLOSpec] = []
    errors: list[str] = []
    for raw in raw_entries or ():
        try:
            specs.append(SLOSpec.parse(raw))
        except ValueError as e:
            errors.append(str(e))
    names = [s.name for s in specs]
    for dup in sorted({n for n in names if names.count(n) > 1}):
        errors.append(f"duplicate slo name {dup!r}")
        specs = [s for s in specs if s.name != dup]
    return specs, errors


# -------------------------------- CLI ----------------------------------


def slo_cli(argv: list[str]) -> int:
    """``tpumon slo`` — objectives, budget remaining and current burn
    rates from a running server's /api/slo."""
    import urllib.request

    url = "http://127.0.0.1:8888"
    as_json = False
    it = iter(argv)
    for a in it:
        if a == "--url":
            url = next(it, url)
        elif a == "--json":
            as_json = True
        elif a in ("-h", "--help"):
            print(
                "usage: python -m tpumon slo [--url HOST:8888] [--json]\n"
                "Objectives, error-budget remaining and fast/slow burn\n"
                "rates from GET /api/slo (docs/slo.md)."
            )
            return 0
        else:
            print(f"unknown argument {a!r}", file=sys.stderr)
            return 2
    if not url.startswith(("http://", "https://")):
        url = f"http://{url}"
    try:
        with urllib.request.urlopen(
            f"{url.rstrip('/')}/api/slo", timeout=10
        ) as r:
            payload = json.load(r)
    except Exception as e:
        print(f"slo: fetch failed: {e}", file=sys.stderr)
        return 1
    if as_json:
        print(json.dumps(payload, indent=1))
        return 0
    rows = payload.get("slos") or []
    if not rows:
        print("no SLOs configured (config key `slos`, docs/slo.md)")
        return 0

    def fmt_burn(b: dict) -> str:
        s, l = b.get("short"), b.get("long")
        txt = (f"{s:.1f}x/" if s is not None else "–/") + (
            f"{l:.1f}x" if l is not None else "–")
        return txt + (" FIRING" if b.get("firing") else "")

    print(f"{'NAME':<20} {'TENANT':<10} {'TARGET':>7} {'BUDGET':>8} "
          f"{'FAST':>16} {'SLOW':>16}")
    for row in rows:
        rem = (row.get("budget") or {}).get("remaining")
        print(
            f"{row['name']:<20} {row.get('tenant') or '–':<10} "
            f"{row['target'] * 100:>6.2f}% "
            f"{'–' if rem is None else f'{rem * 100:.1f}%':>8} "
            f"{fmt_burn(row['burn']['fast']):>16} "
            f"{fmt_burn(row['burn']['slow']):>16}"
        )
    firing = [
        f"{row['name']}/{speed}"
        for row in rows for speed in SPEEDS
        if row["burn"][speed].get("firing")
    ]
    if firing:
        print(f"burning: {', '.join(firing)}")
    return 0
