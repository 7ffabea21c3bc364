"""In-tree PromQL-subset query engine over the columnar TSDB.

The paper's fourth collector was an external Prometheus doing instant +
range queries (monitor_server.js:14-63,117-154); until this module we
mirrored that dependency — rich questions about the monitor's own data
required deploying a second monitoring system next to the monitor. This
is the replacement (ROADMAP item 1): a small expression language that
evaluates **directly over tpumon_torch.tsdb sealed chunks** (window seeks
ride ``Tier.since``'s bisect — O(log chunks + matched)), with three
layers on top:

- **Topology labels from series names.** The ring's flat series names
  already encode the topology: ``chip.<id>.<metric>`` becomes family
  ``chip.<metric>`` with labels ``chip``/``host`` (plus ``pod`` and the
  accelerator family ``accel`` — "tpu" | "gpu" — when the sampler's
  augmenter hook is wired), ``slice.<node>.<id>.<stat>`` becomes
  ``slice.<stat>`` with labels ``node``/``slice`` (and ``accel`` at a
  federation hub), and fleet series (``cpu``, ``mxu``, ...) are
  label-less families. ``by (label)`` grouping and ``{label="..."}``
  matchers work over exactly these; ``topk``/``bottomk`` additionally
  accept ``by`` for per-group ranking (``topk(5, rate(chip.hbm)) by
  (accel)``).
- **Incremental recording rules** (``recording_rules`` config):
  a registered ``family[window]`` selector maintains running aggregates
  — count/sum/min/max, rate endpoints, reset-aware increase — in
  per-series sub-bucket summary rows updated **at append time**, one
  native call per tick for ALL rules (the tsdb ``accum_many`` idea
  applied to query aggregates; bit-exact Python fallback). An instant
  ``*_over_time``/``rate`` read over a registered (family, window) is
  then an O(sub-buckets) merge of head-row state, never a point walk.
- **Distributed (fleet) evaluation** over the federation tree
  (tpumon_torch.federation): the root plans a top-level aggregation, pushes
  the sub-query down the existing uplink streams (protowire TPWQ/TPWR
  frames), and merges **partial aggregates** — mergeable
  sum/count/min/max states, topk row sets, and a fixed-bucket mergeable
  histogram sketch (QSketch) for quantiles — so ``topk(5,
  rate(chip.hbm))`` over a v5p-2048 fleet never ships raw points
  upstream. ``partial_eval`` / ``merge_partials`` / ``finalize`` are
  the three phases; the transport lives in tpumon_torch.federation.

Grammar (docs/query.md has the full table)::

    expr      := or  ;  or := and ('or' and)*  ;  and := cmp ('and' cmp)*
    cmp       := sum (('>'|'<'|'>='|'<='|'=='|'!=') sum)?
    sum       := term (('+'|'-') term)*  ;  term := unary (('*'|'/') unary)*
    unary     := '-' unary | atom
    atom      := NUMBER | '(' expr ')' | agg | call | selector
    agg       := AGGOP by? '(' args ')' by?       -- avg by (host) (v)
    call      := FUNC '(' args ')'                -- rate(chip.hbm[1m])
    selector  := NAME matchers? range?            -- chip.mxu{host="h0"}[5m]

Functions: ``rate increase avg_over_time min_over_time max_over_time
sum_over_time count_over_time quantile_over_time``; aggregations:
``sum avg min max count quantile topk bottomk`` (all accept ``by``).
Comparisons filter vectors (Prometheus semantics); on scalars they
yield 1.0/0.0. The same AST doubles as the alert engine's rule
compiler (``compile_env``): threshold rules are expressions over a
flat ``chip.hbm``-style environment, compiled once per config.

Defined semantics (the golden parity tests pin the engine bit-compatible
against a brute-force reference over tests/fixtures/tsdb_fuzz.json):
window functions read the closed interval ``[t-w, t]``; ``increase``
sums deltas with counter-reset handling (a drop contributes the new
value); ``rate`` divides by the actual first→last span, not the window;
quantiles interpolate linearly at rank ``q*(n-1)``; selectors return
series sorted by name and aggregations fold in that order.
"""

from __future__ import annotations

import json
import re
import sys
import time
from array import array
from bisect import bisect_left, bisect_right

# ----------------------------- registries ------------------------------

# Range functions: FUNC(sel[window]) (+ a leading scalar for quantile_*).
RANGE_FUNCTIONS: tuple[str, ...] = (
    "rate",
    "increase",
    "avg_over_time",
    "min_over_time",
    "max_over_time",
    "sum_over_time",
    "count_over_time",
    "quantile_over_time",
)
# Cross-series aggregations (accept ``by (label, ...)``).
AGG_OPS: tuple[str, ...] = (
    "sum",
    "avg",
    "min",
    "max",
    "count",
    "quantile",
    "topk",
    "bottomk",
)
# The documented function vocabulary — tools/tpulint's registry pass
# pins every name here against docs/query.md's function table.
FUNCTIONS: tuple[str, ...] = RANGE_FUNCTIONS + AGG_OPS

_KEYWORDS = frozenset({"and", "or", "by"})

DEFAULT_RANGE_S = 60.0  # rate(chip.hbm) without [w] reads the last minute
DEFAULT_LOOKBACK_S = 300.0  # instant selector staleness bound


class QueryError(ValueError):
    """Malformed expression or unevaluable query (HTTP 400)."""


# ------------------------------- lexer ---------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<op>>=|<=|==|!=|=~|[-+*/(),{}=<>\[\]])
    """,
    re.X,
)

_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)([smhd]?)$")
_DUR_UNITS = {"": 1.0, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def _lex(src: str) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise QueryError(f"bad character {src[pos]!r} at offset {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


def parse_range(text: str) -> float:
    """``[30m]``-style duration (bare numbers are seconds)."""
    m = _DUR_RE.match(text.strip())
    if not m:
        raise QueryError(f"bad range duration {text!r} (want e.g. 30s, 5m)")
    return float(m.group(1)) * _DUR_UNITS[m.group(2)]


# -------------------------------- AST ----------------------------------


class Num:
    __slots__ = ("v",)

    def __init__(self, v: float):
        self.v = v


class Selector:
    __slots__ = ("family", "matchers", "range_s")

    def __init__(self, family: str, matchers, range_s: float | None):
        self.family = family
        self.matchers = matchers  # tuple of (label, op, value)
        self.range_s = range_s


class Call:
    __slots__ = ("fn", "args")

    def __init__(self, fn: str, args: list):
        self.fn = fn
        self.args = args


class Agg:
    __slots__ = ("op", "by", "args")

    def __init__(self, op: str, by: tuple[str, ...], args: list):
        self.op = op
        self.by = by
        self.args = args


class Bin:
    __slots__ = ("op", "lhs", "rhs")

    def __init__(self, op: str, lhs, rhs):
        self.op = op
        self.lhs = lhs
        self.rhs = rhs


class Neg:
    __slots__ = ("arg",)

    def __init__(self, arg):
        self.arg = arg


def _const_value(node) -> float | None:
    """The node's compile-time constant value (Num, possibly under
    Neg), or None when it isn't one — the eval_condition fast path's
    shape test."""
    if isinstance(node, Num):
        return node.v
    if isinstance(node, Neg):
        v = _const_value(node.arg)
        return None if v is None else -v
    return None


class _Parser:
    def __init__(self, src: str):
        self.src = src
        self.toks = _lex(src)
        self.i = 0

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> None:
        kind, val = self.next()
        if val != text:
            raise QueryError(
                f"expected {text!r}, got {val or 'end of input'!r} "
                f"in {self.src!r}"
            )

    def parse(self):
        e = self.expr()
        if self.peek()[0] != "eof":
            raise QueryError(f"trailing input at {self.peek()[1]!r}")
        return e

    def expr(self):
        return self._or()

    def _or(self):
        e = self._and()
        while self.peek() == ("name", "or"):
            self.next()
            e = Bin("or", e, self._and())
        return e

    def _and(self):
        e = self._cmp()
        while self.peek() == ("name", "and"):
            self.next()
            e = Bin("and", e, self._cmp())
        return e

    def _cmp(self):
        e = self._sum()
        if self.peek()[1] in (">", "<", ">=", "<=", "==", "!="):
            op = self.next()[1]
            e = Bin(op, e, self._sum())
        return e

    def _sum(self):
        e = self._term()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            e = Bin(op, e, self._term())
        return e

    def _term(self):
        e = self._unary()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            e = Bin(op, e, self._unary())
        return e

    def _unary(self):
        if self.peek()[1] == "-":
            self.next()
            return Neg(self._unary())
        return self._atom()

    def _by_clause(self) -> tuple[str, ...]:
        self.expect("(")
        labels: list[str] = []
        while True:
            kind, val = self.next()
            if kind != "name":
                raise QueryError(f"bad by() label {val!r}")
            labels.append(val)
            kind, val = self.next()
            if val == ")":
                return tuple(labels)
            if val != ",":
                raise QueryError(f"expected , or ) in by(), got {val!r}")

    def _args(self) -> list:
        self.expect("(")
        args = [self.expr()]
        while self.peek()[1] == ",":
            self.next()
            args.append(self.expr())
        self.expect(")")
        return args

    def _atom(self):
        kind, val = self.peek()
        if kind == "num":
            self.next()
            return Num(float(val))
        if val == "(":
            self.next()
            e = self.expr()
            self.expect(")")
            return e
        if kind != "name":
            raise QueryError(f"unexpected {val or 'end of input'!r}")
        if val in _KEYWORDS:
            raise QueryError(f"unexpected keyword {val!r}")
        if val in AGG_OPS:
            self.next()
            by: tuple[str, ...] = ()
            if self.peek() == ("name", "by"):
                self.next()
                by = self._by_clause()
            args = self._args()
            if self.peek() == ("name", "by"):
                if by:
                    raise QueryError("duplicate by() clause")
                self.next()
                by = self._by_clause()
            return Agg(val, by, args)
        if val in RANGE_FUNCTIONS:
            self.next()
            return Call(val, self._args())
        return self._selector()

    def _selector(self) -> Selector:
        kind, family = self.next()
        matchers: list[tuple[str, str, str]] = []
        if self.peek()[1] == "{":
            self.next()
            while True:
                k, label = self.next()
                if k != "name":
                    raise QueryError(f"bad matcher label {label!r}")
                op = self.next()[1]
                if op not in ("=", "!=", "=~"):
                    raise QueryError(f"bad matcher operator {op!r}")
                k, raw = self.next()
                if k != "str":
                    raise QueryError("matcher value wants a \"string\"")
                matchers.append((label, op, json.loads(raw)))
                k, sep = self.next()
                if sep == "}":
                    break
                if sep != ",":
                    raise QueryError(f"expected , or }} in matchers, got {sep!r}")
        range_s = None
        if self.peek()[1] == "[":
            self.next()
            parts: list[str] = []
            while self.peek()[1] not in ("]", ""):
                parts.append(self.next()[1])
            self.expect("]")
            range_s = parse_range("".join(parts))
        return Selector(family, tuple(matchers), range_s)


def parse(src: str):
    """Parse an expression; raises QueryError on malformed input."""
    if not src or not src.strip():
        raise QueryError("empty expression")
    return _Parser(src).parse()


# ------------------------ series name → labels -------------------------


def parse_series_name(name: str) -> tuple[str, dict[str, str]]:
    """Map a flat ring series name onto (family, labels) — the topology
    labels are *derived from the naming contract*, not stored:

      chip.<id>.<metric>        -> ("chip.<metric>", {chip, host})
      slice.<node>.<id>.<stat>  -> ("slice.<stat>",  {node, slice})
      serving.<tenant>.<metric> -> ("serving.<metric>", {tenant})
      slo.<name>.<metric>       -> ("slo.<metric>",  {slo})
      anything else             -> (name, {})

    ``host`` is the chip id's host component (``host-0/chip-3``).
    Tenant names and SLO names are dot-free by contract (the traffic
    simulator and the SLO engine both validate), so the serving/slo forms
    split unambiguously. Limitation: a federation node name containing
    dots mis-splits the slice form (the hub's series contract puts
    node first)."""
    if name.startswith("serving."):
        rest = name[8:]
        tenant, _, metric = rest.partition(".")
        if tenant and metric and "." not in metric:
            return f"serving.{metric}", {"tenant": tenant}
        # Multi-dot metric tails (none exist today) fall through to
        # the verbatim form rather than guessing a split.
        if tenant and metric:
            return name, {}
    elif name.startswith("slo."):
        rest = name[4:]
        slo, _, metric = rest.partition(".")
        if slo and metric and "." not in metric:
            return f"slo.{metric}", {"slo": slo}
        if slo and metric:
            return name, {}
    if name.startswith("chip."):
        rest = name[5:]
        cid, _, metric = rest.rpartition(".")
        if cid and metric:
            labels = {"chip": cid}
            if "/" in cid:
                labels["host"] = cid.split("/", 1)[0]
            return f"chip.{metric}", labels
    elif name.startswith("slice."):
        rest = name[6:]
        mid, _, stat = rest.rpartition(".")
        if mid and stat:
            node, _, sid = mid.partition(".")
            return f"slice.{stat}", {"node": node, "slice": sid or node}
    return name, {}


def _has_glob(s: str) -> bool:
    return any(ch in s for ch in "*?[")


def _match_one(value: str | None, op: str, want: str) -> bool:
    if value is None:
        return op == "!=" and want != ""
    if op == "=":
        return value == want
    if op == "!=":
        return value != want
    import fnmatch

    return fnmatch.fnmatchcase(value, want)


# --------------------------- quantile sketch ---------------------------

# Fixed log-spaced bucket bounds (4 per decade, 1e-3 .. 1e12) shared by
# every sketch — what makes two sketches built anywhere in the tree
# mergeable by plain per-bucket addition. Bucket 0 holds <= lower-bound
# values (zeros, negatives).
QSKETCH_BOUNDS: tuple[float, ...] = tuple(
    10.0 ** (k / 4.0) for k in range(-12, 49)
)


class QSketch:
    """Bounded mergeable value sketch for distributed quantiles.

    Exact (a value list) up to ``cap`` values; beyond that it collapses
    to fixed log-bucket counts + exact min/max. Merging two sketches
    anywhere in the federation tree yields the same state as building
    one sketch from the concatenated values — which is what lets an
    aggregator fold its leaves' states without raw points. Quantiles
    are exact in list mode and bucket-interpolated (clamped to
    [min, max]) in bucket mode; docs/query.md documents the error
    bound (one bucket ≈ ±33%)."""

    __slots__ = ("cap", "n", "mn", "mx", "values", "buckets")

    def __init__(self, cap: int = 1024):
        self.cap = cap
        self.n = 0
        self.mn: float | None = None
        self.mx: float | None = None
        self.values: list[float] | None = []
        self.buckets: list[int] | None = None

    def add(self, v: float) -> None:
        self.n += 1
        if self.mn is None or v < self.mn:
            self.mn = v
        if self.mx is None or v > self.mx:
            self.mx = v
        if self.values is not None:
            self.values.append(v)
            if len(self.values) > self.cap:
                self._collapse()
        else:
            self.buckets[self._bucket(v)] += 1

    @staticmethod
    def _bucket(v: float) -> int:
        return bisect_left(QSKETCH_BOUNDS, v) if v > 0 else 0

    def _collapse(self) -> None:
        counts = [0] * (len(QSKETCH_BOUNDS) + 1)
        for v in self.values:
            counts[self._bucket(v)] += 1
        self.values = None
        self.buckets = counts

    def merge(self, other: "QSketch") -> None:
        self.n += other.n
        for attr, pick in (("mn", min), ("mx", max)):
            ov = getattr(other, attr)
            if ov is not None:
                sv = getattr(self, attr)
                setattr(self, attr, ov if sv is None else pick(sv, ov))
        if self.values is not None and other.values is not None:
            self.values.extend(other.values)
            if len(self.values) > self.cap:
                self._collapse()
            return
        if self.values is not None:
            self._collapse()
        if other.values is not None:
            for v in other.values:
                self.buckets[self._bucket(v)] += 1
        else:
            for i, c in enumerate(other.buckets):
                self.buckets[i] += c

    def quantile(self, q: float) -> float | None:
        if not self.n:
            return None
        if self.values is not None:
            return _quantile(sorted(self.values), q)
        rank = q * (self.n - 1)
        seen = 0.0
        for i, c in enumerate(self.buckets):
            if not c:
                continue
            if seen + c > rank:
                lo = QSKETCH_BOUNDS[i - 1] if i > 0 else (self.mn or 0.0)
                hi = QSKETCH_BOUNDS[i] if i < len(QSKETCH_BOUNDS) else self.mx
                v = (lo + hi) / 2.0
                return max(self.mn, min(self.mx, v))
            seen += c
        return self.mx

    def to_json(self) -> dict:
        out: dict = {"n": self.n, "mn": self.mn, "mx": self.mx}
        if self.values is not None:
            out["v"] = self.values
        else:
            out["b"] = {
                str(i): c for i, c in enumerate(self.buckets) if c
            }
        return out

    @classmethod
    def from_json(cls, d: dict, cap: int = 1024) -> "QSketch":
        sk = cls(cap)
        sk.n = int(d.get("n") or 0)
        sk.mn = d.get("mn")
        sk.mx = d.get("mx")
        if "v" in d:
            sk.values = [float(x) for x in d["v"]]
            if len(sk.values) > cap:
                sk._collapse()
        else:
            sk.values = None
            sk.buckets = [0] * (len(QSKETCH_BOUNDS) + 1)
            for k, c in (d.get("b") or {}).items():
                i = int(k)
                if 0 <= i < len(sk.buckets):
                    sk.buckets[i] = int(c)
        return sk


def _quantile(sorted_vals: list[float], q: float) -> float | None:
    """Linear interpolation at rank q*(n-1) — Prometheus's
    quantile_over_time method, and the single definition every path
    (direct, recording rule, distributed sketch in exact mode) shares."""
    n = len(sorted_vals)
    if not n:
        return None
    if n == 1:
        return sorted_vals[0]
    rank = max(0.0, min(1.0, q)) * (n - 1)
    lo = int(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * frac


# --------------------------- recording rules ---------------------------
#
# Append-time aggregate state lives in CONTIGUOUS COLUMNS, not per-point
# Python objects — the tsdb ``accum_many`` trick applied to query
# aggregates. Each rule owns a RuleStore: per matched series ("rule
# slot") one dense OPEN row plus a ring of RULE_SUB_BUCKETS closed rows,
# (bucket index, count, sum, min, max, first/last point, reset-aware
# increase) spread across ten array('d') columns. The per-tick batch
# ingest path (tpumon_torch.history.RingHistory.record_batch) updates every
# matched series' open row in ONE call per rule — the native kernel
# (tsdbkern.cpp tpumon_tsdb_rule_accum) when built, a bit-exact Python
# loop otherwise — so unmatched series pay nothing and matched series
# pay ~one C iteration. Instant reads merge <= 17 rows (O(1)).
# quantile_over_time deliberately has no rule backing (a per-point
# sketch would put Python work back in the hot path); it always takes
# the direct window read.

RULE_SUB_BUCKETS = 16  # window/16 closed sub-buckets (+ the open row)

# Row-major summary layout: one row = 10 consecutive doubles (80 bytes,
# ~2 cache lines) — [bucket index (NaN = empty), n, sum, min, max,
# first_ts, first_v, last_ts, last_v, increase].
R_BIDX, R_N, R_SUM, R_MN, R_MX = 0, 1, 2, 3, 4
R_FTS, R_FV, R_LTS, R_LV, R_INC = 5, 6, 7, 8, 9
RULE_ROW_STRIDE = 10

_NAN = float("nan")
_EMPTY_ROW = [_NAN] + [0.0] * (RULE_ROW_STRIDE - 1)


class RuleStore:
    """One recording rule's state (see the block comment above), split
    hot/cold for the per-tick update's sake: ``open`` holds ONE row per
    matched series — the sub-bucket currently accumulating, densely
    packed (80 B/series, so a 256-series rule's whole per-tick working
    set is ~20 KB and stays cache-resident) — and ``hist`` holds the
    RULE_SUB_BUCKETS closed rows per series as a ring (touched only on
    a bucket rollover, once per sub_s). ``slot_map`` maps the RING's
    global series slot -> this store's slot (-1 = not matched), which
    is what lets the batched update take the ring's existing (slots,
    values) arrays verbatim with no per-tick collection pass."""

    __slots__ = ("sub_s", "hh", "slot_map", "open", "hist", "_kptrs")

    def __init__(self, sub_s: float):
        self.sub_s = sub_s
        self.hh = array("i")  # per slot: next hist-ring write position
        self.slot_map = array("i")
        self.open = array("d")  # one open row per slot (hot)
        self.hist = array("d")  # RULE_SUB_BUCKETS closed rows per slot
        # Kernel-call cache (tpumon_torch.native.TsdbKernel.rule_accum): the
        # arrays only ever move on add_slot, so the struct of pointers
        # is rebuilt per topology change, not per tick.
        self._kptrs = None

    def add_slot(self, ring_slot: int | None) -> int:
        r = len(self.hh)
        self.hh.append(0)
        self.open.extend(_EMPTY_ROW)
        self.hist.extend(_EMPTY_ROW * RULE_SUB_BUCKETS)
        if ring_slot is not None:
            while len(self.slot_map) <= ring_slot:
                self.slot_map.append(-1)
            self.slot_map[ring_slot] = r
        self._kptrs = None  # arrays may have reallocated
        return r

    def observe_one(self, r: int, ts: float, v: float) -> None:
        """Per-point update (the non-batched ingest paths: add(),
        add_batch replays, slotless series). Bit-identical to one
        iteration of the batched kernel."""
        self._observe_prebucketed(r, ts // self.sub_s, ts, v)

    def accum_batch(self, ts: float, val_q: array, slots: array, k=None) -> None:
        """One shared-timestamp update for every matched series in the
        tick's batch: the ring hands its existing slots/values arrays;
        non-members skip via slot_map. One native call when the kernel
        is loaded; the Python loop is its bit-exact mirror."""
        if k is not None:
            k.rule_accum(ts, val_q, slots, self)
            return
        b = ts // self.sub_s
        smap = self.slot_map
        mlen = len(smap)
        for i, g in enumerate(slots):
            if g < 0 or g >= mlen:
                continue
            r = smap[g]
            if r < 0:
                continue
            self._observe_prebucketed(r, b, ts, val_q[i])

    def _observe_prebucketed(self, r: int, b: float, ts: float, v: float) -> None:
        op = self.open
        base = r * RULE_ROW_STRIDE
        if op[base] == b:
            op[base + R_N] += 1.0
            op[base + R_SUM] += v
            if v < op[base + R_MN]:
                op[base + R_MN] = v
            elif v > op[base + R_MX]:
                op[base + R_MX] = v
            delta = v - op[base + R_LV]
            op[base + R_INC] += delta if delta >= 0 else v
            op[base + R_LTS] = ts
            op[base + R_LV] = v
            return
        if op[base] == op[base]:  # open row holds a closed bucket: bank it
            h = self.hh[r]
            dst = (r * RULE_SUB_BUCKETS + h) * RULE_ROW_STRIDE
            self.hist[dst : dst + RULE_ROW_STRIDE] = op[
                base : base + RULE_ROW_STRIDE
            ]
            self.hh[r] = (h + 1) % RULE_SUB_BUCKETS
        op[base] = b
        op[base + R_N] = 1.0
        op[base + R_SUM] = v
        op[base + R_MN] = op[base + R_MX] = v
        op[base + R_FTS] = op[base + R_LTS] = ts
        op[base + R_FV] = op[base + R_LV] = v
        op[base + R_INC] = 0.0

    def rows(self, r: int) -> list[tuple[array, int]]:
        """Populated (array, row base) pairs for slot ``r`` — the hist
        ring's closed buckets plus the open row — oldest bucket first."""
        out: list[tuple[array, int]] = []
        hist = self.hist
        lo = r * RULE_SUB_BUCKETS * RULE_ROW_STRIDE
        for base in range(
            lo, lo + RULE_SUB_BUCKETS * RULE_ROW_STRIDE, RULE_ROW_STRIDE
        ):
            if hist[base] == hist[base]:
                out.append((hist, base))
        ob = r * RULE_ROW_STRIDE
        if self.open[ob] == self.open[ob]:
            out.append((self.open, ob))
        out.sort(key=lambda p: p[0][p[1]])
        return out


def _rule_kernel():
    """The native rule-accumulation entry point, or None. Rides the
    same loaded TsdbKernel as the ingest spine (tpumon_torch.tsdb.kernel) —
    one .so, one ABI gate, one enable switch."""
    from tpumon_torch import tsdb

    k = tsdb.kernel()
    return k if k is not None and hasattr(k, "rule_accum") else None


class RuleAccum:
    """One series' view onto one rule's store slot — what
    RingSeries.rec holds. ``observe`` is the per-point path; ``merged``
    the O(sub-buckets) instant read."""

    __slots__ = ("rule", "store", "slot")

    def __init__(self, rule: "RecordingRule", slot: int):
        self.rule = rule
        self.store = rule.store
        self.slot = slot

    def observe(self, ts: float, v: float) -> None:
        self.store.observe_one(self.slot, ts, v)

    def covers(self, at: float) -> bool:
        """A rule read is only honest for "now"-ish instants: the state
        holds the trailing window, so ``at`` must not predate the
        newest sub-bucket."""
        st = self.store
        b = st.open[self.slot * RULE_ROW_STRIDE]
        return b == b and at >= b * st.sub_s

    def merged(self, at: float):
        """Merge the sub-bucket rows covering [at - window, at];
        returns (n, sum, mn, mx, first_ts, first_v, last_ts, last_v,
        inc) or None when empty. The window is bucket-quantized: the
        oldest overlapping sub-bucket is included whole, so the
        effective span is [w, w + w/16) — documented in docs/query.md.

        Single allocation-free pass in hist-ring order (hh points at
        the oldest banked bucket, so ring order IS time order for
        in-order appends — the only order the store ever banks; a
        violated monotonicity check falls back to the sorted walk,
        preserving identical fold order). This is the per-tick rule
        read every trend condition pays — bench.py's ``actuate`` phase
        pins the ≤1% tick bound it serves."""
        st = self.store
        b_lo = (at - self.rule.window_s) // st.sub_s
        r = self.slot
        hist = st.hist
        lo = r * RULE_SUB_BUCKETS * RULE_ROW_STRIDE
        h0 = st.hh[r]
        n = 0
        total = 0.0
        mn = mx = None
        inc = 0.0
        prev_last = None
        prev_b = None
        first_arr = first_base = last_arr = last_base = None
        for k in range(RULE_SUB_BUCKETS + 1):
            if k < RULE_SUB_BUCKETS:
                arr = hist
                base = lo + ((h0 + k) % RULE_SUB_BUCKETS) * RULE_ROW_STRIDE
            else:
                arr = st.open
                base = r * RULE_ROW_STRIDE
            b = arr[base]
            if b != b or b < b_lo:
                continue
            if prev_b is not None and b < prev_b:
                return self._merged_sorted(at, b_lo)
            prev_b = b
            n += int(arr[base + R_N])
            total += arr[base + R_SUM]
            row_mn = arr[base + R_MN]
            row_mx = arr[base + R_MX]
            mn = row_mn if mn is None else (mn if mn < row_mn else row_mn)
            mx = row_mx if mx is None else (mx if mx > row_mx else row_mx)
            inc += arr[base + R_INC]
            if prev_last is not None:
                step = arr[base + R_FV] - prev_last
                inc += step if step >= 0 else arr[base + R_FV]
            prev_last = arr[base + R_LV]
            if first_base is None:
                first_arr, first_base = arr, base
            last_arr, last_base = arr, base
        if first_base is None:
            return None
        return (
            n, total, mn, mx,
            first_arr[first_base + R_FTS], first_arr[first_base + R_FV],
            last_arr[last_base + R_LTS], last_arr[last_base + R_LV], inc,
        )

    def _merged_sorted(self, at: float, b_lo: float):
        """The pre-optimization sorted walk — identical fold order for
        any bucket layout; ``merged`` delegates here if ring order ever
        disagrees with time order."""
        st = self.store
        sel = [
            (arr, base)
            for arr, base in st.rows(self.slot)
            if arr[base] >= b_lo
        ]
        if not sel:
            return None
        n = 0
        total = 0.0
        mn = mx = None
        inc = 0.0
        prev_last = None
        for arr, base in sel:
            n += int(arr[base + R_N])
            total += arr[base + R_SUM]
            row_mn = arr[base + R_MN]
            row_mx = arr[base + R_MX]
            mn = row_mn if mn is None else min(mn, row_mn)
            mx = row_mx if mx is None else max(mx, row_mx)
            inc += arr[base + R_INC]
            if prev_last is not None:
                step = arr[base + R_FV] - prev_last
                inc += step if step >= 0 else arr[base + R_FV]
            prev_last = arr[base + R_LV]
        farr, first = sel[0]
        larr, last = sel[-1]
        return (
            n, total, mn, mx,
            farr[first + R_FTS], farr[first + R_FV],
            larr[last + R_LTS], larr[last + R_LV], inc,
        )


class RecordingRule:
    """One registered ``family[window]`` selector (e.g. ``chip.mxu[5m]``)
    and its column store."""

    __slots__ = ("text", "family", "window_s", "sub_s", "store")

    def __init__(self, text: str):
        node = parse(text)
        if (
            not isinstance(node, Selector)
            or node.range_s is None
            or node.matchers
        ):
            raise QueryError(
                f"recording rule {text!r} must be a plain range selector "
                f"like chip.mxu[5m]"
            )
        self.text = text
        self.family = node.family
        self.window_s = node.range_s
        self.sub_s = node.range_s / RULE_SUB_BUCKETS
        self.store = RuleStore(self.sub_s)


class RuleSet:
    """The registered recording rules + the per-series attach logic the
    ring calls at series creation (tpumon_torch.history)."""

    def __init__(self, rules: list[RecordingRule]):
        self.rules = rules
        self._by_key = {(r.family, r.window_s): r for r in rules}
        # Kernel multi-call cache (TsdbKernel.rule_accum_multi): the
        # struct-pointer vector covering every rule's store, rebuilt
        # when any store's arrays move.
        self._kmulti = None

    def attach(self, name: str, ring_slot: int | None = None) -> list[RuleAccum] | None:
        family, _labels = parse_series_name(name)
        accums = [
            RuleAccum(r, r.store.add_slot(ring_slot))
            for r in self.rules
            if r.family == family
        ]
        return accums or None

    def accum_batch(self, ts: float, val_q: array, slots: array) -> None:
        """The per-tick batched update over the ring's existing
        (slots, f32 values) arrays: ONE native round trip covering
        every rule (FFI + pointer casts dominate a per-rule spelling);
        the Python fallback loops per rule, bit-exactly."""
        k = _rule_kernel()
        if k is not None:
            k.rule_accum_multi(ts, val_q, slots, self)
            return
        for r in self.rules:
            r.store.accum_batch(ts, val_q, slots, None)

    def lookup(self, family: str, window_s: float) -> RecordingRule | None:
        return self._by_key.get((family, window_s))

    def to_json(self) -> list[str]:
        return [r.text for r in self.rules]


# ----------------------------- evaluation ------------------------------


_UNRESOLVED = object()


class _Ctx:
    __slots__ = (
        "engine", "at", "win_cache", "exclude", "lookback_s", "_augment")

    def __init__(self, engine: "QueryEngine", at: float, exclude=None):
        self.engine = engine
        self.at = at
        self.win_cache: dict = {}
        self.exclude = exclude
        # Instant-selector staleness override for THIS evaluation
        # (None = the engine's lookback_s). The SLO engine tightens it
        # for fraction-mode bad-event samples: a per-tick sample read
        # from data older than the objective's shortest burn window is
        # not a current observation — it must read as absent, or a
        # vanished source would keep "reporting" its last value for the
        # whole 5-minute default lookback and a firing burn alert could
        # never drain to resolution (tests/test_slo.py).
        self.lookback_s: float | None = None
        # The label augmenter (pod attribution — O(chips) to build)
        # resolves lazily on first selector match and at most once per
        # evaluation: expressions that never touch an augmentable
        # family (the SLO engine's per-tick slo.bad/serving.* reads)
        # never pay for the attribution walk.
        self._augment = _UNRESOLVED

    @property
    def augment(self):
        if self._augment is _UNRESOLVED:
            self._augment = (
                self.engine.augment()
                if self.engine.augment is not None
                else None
            )
        return self._augment


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class QueryEngine:
    """Expression evaluation over one RingHistory.

    Stateless apart from two bounded caches: the compiled-expression
    cache (parse once per distinct query text) and the per-series
    name→labels parse cache. Owned by the Sampler (one per process);
    the server routes, the alert engine's env compiler, the CLI and
    the federation planner all go through it."""

    _COMPILE_CAP = 256

    # Labels an augmenter may ADD to derived labels (the sampler's pod
    # attribution, and the accelerator family — chip id → accel_kind,
    # slice → accel_kind). Matchers referencing any of these
    # must resolve per evaluation (the attribution changes tick to
    # tick); matchers over naming-derived labels only are resolvable
    # once per series set and ride the selector cache below.
    AUGMENT_LABELS = frozenset({"pod", "accel"})

    def __init__(
        self,
        ring,
        default_range_s: float = DEFAULT_RANGE_S,
        lookback_s: float = DEFAULT_LOOKBACK_S,
        augment=None,
    ):
        self.ring = ring
        self.default_range_s = default_range_s
        self.lookback_s = lookback_s
        # Optional label augmenter: a zero-arg callable returning a
        # ``fn(family, labels) -> None`` that mutates labels in place —
        # the server wires pod attribution (chip id -> owning pod)
        # through this so ``by (pod)`` works without the engine knowing
        # about k8s.
        self.augment = augment
        self._compiled: dict[str, object] = {}
        self._names: dict[str, tuple[str, dict]] = {}
        # Family -> candidate series names (the _matching pre-filter):
        # a selector eval walks only its family's series instead of the
        # whole ring. Invalidated whenever the ring's series set can
        # have changed (new series appeared / snapshot restore replaced
        # the objects). Matchers/augment/exclude still run per eval —
        # only the family scan is cached.
        self._family_cache: dict[str, list[str]] = {}
        self._family_gen: tuple | None = None
        # (family, matchers) -> [(name, family, base labels)] for
        # selectors whose matchers touch only naming-derived labels:
        # those can be resolved once per series set instead of per
        # eval (the SLO engine's per-tick hot path). Augment/exclude
        # still run per eval on the cached rows' label copies.
        self._sel_cache: dict[tuple, list] = {}
        self.compiles = 0
        self.evals = 0

    # --------------------------- compile cache --------------------------

    def compile(self, src: str):
        node = self._compiled.get(src)
        if node is None:
            node = parse(src)
            if len(self._compiled) >= self._COMPILE_CAP:
                self._compiled.clear()
            self._compiled[src] = node
            self.compiles += 1
        return node

    # ----------------------------- matching -----------------------------

    def _series_labels(self, name: str) -> tuple[str, dict]:
        hit = self._names.get(name)
        if hit is None:
            hit = self._names[name] = parse_series_name(name)
        return hit

    def _family_names(self, fam: str) -> list[str]:
        """Series names whose derived family matches ``fam`` (exact or
        glob) — the O(all series) scan, cached per family until the
        ring's series set moves. Sorted, so _matching's output order
        (the parity-pinned fold order) is already deterministic."""
        gen = (len(self.ring.series), getattr(self.ring, "generation", None))
        if gen != self._family_gen:
            self._family_cache.clear()
            self._sel_cache.clear()
            self._family_gen = gen
        names = self._family_cache.get(fam)
        if names is None:
            import fnmatch

            glob = _has_glob(fam)
            names = [
                name
                for name in self.ring.series
                if (
                    fnmatch.fnmatchcase(self._series_labels(name)[0], fam)
                    if glob
                    else self._series_labels(name)[0] == fam
                )
            ]
            names.sort()
            if len(self._family_cache) >= self._COMPILE_CAP:
                self._family_cache.clear()
            self._family_cache[fam] = names
        return names

    def _matching(self, sel: Selector, ctx: _Ctx) -> list[tuple[str, dict]]:
        """(series name, labels) pairs matching the selector, sorted by
        name — the deterministic fold order the parity tests pin.

        Matchers over naming-derived labels resolve against the cached
        pre-filtered rows (_sel_cache); a matcher that references an
        augmenter-added label (AUGMENT_LABELS — pod attribution moves
        tick to tick) forces the per-eval path."""
        out: list[tuple[str, dict]] = []
        cacheable = not any(
            label in self.AUGMENT_LABELS for label, _, _ in sel.matchers
        )
        if cacheable:
            key = (sel.family, sel.matchers)
            self._family_names(sel.family)  # validates the gen / caches
            rows = self._sel_cache.get(key)
            if rows is None:
                rows = []
                for name in self._family_names(sel.family):
                    family, base = self._series_labels(name)
                    if all(
                        _match_one(base.get(label), op, want)
                        for label, op, want in sel.matchers
                    ):
                        rows.append((name, family, base))
                if len(self._sel_cache) >= self._COMPILE_CAP:
                    self._sel_cache.clear()
                self._sel_cache[key] = rows
            if ctx.augment is None and ctx.exclude is None:
                # Hottest path (no per-eval label derivation at all):
                # hand out fresh label dicts, keep the cached bases
                # immutable.
                return [(name, dict(base)) for name, _, base in rows]
            for name, family, base in rows:
                labels = dict(base)
                if ctx.augment is not None:
                    ctx.augment(family, labels)
                if ctx.exclude is not None and ctx.exclude(family, labels):
                    continue
                out.append((name, labels))
            return out
        for name in self._family_names(sel.family):
            family, base = self._series_labels(name)
            labels = dict(base)
            if ctx.augment is not None:
                ctx.augment(family, labels)
            if ctx.exclude is not None and ctx.exclude(family, labels):
                continue
            ok = True
            for label, op, want in sel.matchers:
                if not _match_one(labels.get(label), op, want):
                    ok = False
                    break
            if ok:
                out.append((name, labels))
        out.sort(key=lambda p: p[0])
        return out

    def _matching_names(self, sel: Selector, ctx: _Ctx):
        """Matching series names only, no label materialization — the
        eval_condition hot path, which discards labels. Identical
        match set to _matching: when an exclude filter or a matcher
        over an augmenter-added label is in play (both can change the
        match set per evaluation), it defers to _matching."""
        if ctx.exclude is None and not any(
            label in self.AUGMENT_LABELS for label, _, _ in sel.matchers
        ):
            key = (sel.family, sel.matchers)
            self._family_names(sel.family)  # validates the series gen
            rows = self._sel_cache.get(key)
            if rows is None:
                self._matching(sel, ctx)  # builds + caches the rows
                rows = self._sel_cache[key]
            return [name for name, _, _ in rows]
        return [name for name, _ in self._matching(sel, ctx)]

    # --------------------------- point access ---------------------------

    def _window_points(
        self, ctx: _Ctx, name: str, w: float
    ) -> tuple[list[float], list[float]]:
        """(ts, vals) covering at least [at - w, at] for one series,
        cached per (name, w) within the evaluation (range queries reuse
        one fetch across every grid step). The underlying seek is
        Tier.since's bisect over sealed-chunk bounds."""
        key = (name, w)
        hit = ctx.win_cache.get(key)
        if hit is not None:
            return hit
        rs = self.ring.series[name]
        start = ctx.at - w
        if w <= rs.window_s:
            pts = rs.fine.since(start)
            if not pts and rs.fine.last_ts() is None:
                pts = rs.merged_points(w, ctx.at)
        else:
            pts = rs.merged_points(ctx.at - start, ctx.at)
        ts = [p[0] for p in pts]
        vals = [p[1] for p in pts]
        ctx.win_cache[key] = (ts, vals)
        return ts, vals

    # The store quantizes timestamps to 1 ms (round-half-up), so a
    # point recorded at ``at`` can land up to 0.5 ms in at's future;
    # instant reads tolerate exactly that round-up, or a query at the
    # record instant would miss its own point on a coin-flip of the
    # microsecond fraction.
    _TS_QUANT_EPS = 1e-3

    def _instant_value(self, ctx: _Ctx, name: str) -> float | None:
        rs = self.ring.series[name]
        at = ctx.at + self._TS_QUANT_EPS
        lookback = (
            self.lookback_s if ctx.lookback_s is None else ctx.lookback_s)
        last_ts = rs.fine.last_ts()
        if last_ts is not None and last_ts <= at:
            # ``at`` is at/after the newest fine point: the answer is
            # the tail point, read O(1) off the head columns — no
            # lookback-window fetch (the per-tick instant-selector hot
            # path; historical ``at`` takes the window walk below).
            if last_ts < ctx.at - lookback:
                return None
            return rs.fine.last()[1]
        ts, vals = self._window_points(ctx, name, lookback)
        hi = bisect_right(ts, at)
        if not hi:
            return None
        if ts[hi - 1] < ctx.at - lookback:
            return None
        return vals[hi - 1]

    # ------------------------------ eval --------------------------------

    def _eval(self, node, ctx: _Ctx):
        if isinstance(node, Num):
            return node.v
        if isinstance(node, Neg):
            v = self._eval(node.arg, ctx)
            if isinstance(v, list):
                return [(lb, -x) for lb, x in v]
            return -v
        if isinstance(node, Selector):
            if node.range_s is not None:
                raise QueryError(
                    f"range selector {node.family}[...] needs a function "
                    f"(rate, avg_over_time, ...)"
                )
            out = []
            for name, labels in self._matching(node, ctx):
                v = self._instant_value(ctx, name)
                if v is not None:
                    out.append((labels, v))
            return out
        if isinstance(node, Call):
            return self._eval_call(node, ctx)
        if isinstance(node, Agg):
            return self._eval_agg(node, ctx)
        if isinstance(node, Bin):
            return self._eval_bin(node, ctx)
        raise QueryError(f"unevaluable node {type(node).__name__}")

    # range functions ----------------------------------------------------

    def _range_args(self, node: Call) -> tuple[float | None, Selector]:
        args = node.args
        q = None
        if node.fn == "quantile_over_time":
            if len(args) != 2 or not isinstance(args[0], Num):
                raise QueryError("quantile_over_time wants (q, selector[w])")
            q = args[0].v
            sel = args[1]
        else:
            if len(args) != 1:
                raise QueryError(f"{node.fn} wants exactly one selector")
            sel = args[0]
        if not isinstance(sel, Selector):
            raise QueryError(f"{node.fn} wants a series selector argument")
        return q, sel

    def _eval_call(self, node: Call, ctx: _Ctx) -> list:
        q, sel = self._range_args(node)
        w = sel.range_s if sel.range_s is not None else self.default_range_s
        out = []
        rules = getattr(self.ring, "rules", None)
        rule = rules.lookup(sel.family, w) if rules is not None else None
        cache = ctx.win_cache
        for name, labels in self._matching(sel, ctx):
            # The computed (fn, series, window) value is memoized on
            # the evaluation context alongside the point fetches it
            # rides: several expressions reading the same trend at the
            # same instant (actuation policies + SLO conditions in one
            # tick) pay the rule merge / window walk once (bench.py's
            # ``actuate`` phase pins the ≤1% tick bound this serves).
            key = ("rangefn", node.fn, q, name, w)
            if key in cache:
                v = cache[key]
            elif rule is not None:
                v = self._rule_read(node.fn, q, rule, name, ctx)
                if v is _NO_RULE:
                    # series without a covering accumulator (created
                    # before registration / historical ``at``): direct.
                    v = self._direct_range(node.fn, q, name, w, ctx)
                cache[key] = v
            else:
                v = self._direct_range(node.fn, q, name, w, ctx)
                cache[key] = v
            if v is not None:
                out.append((labels, v))
        return out

    def _direct_range(
        self, fn: str, q: float | None, name: str, w: float, ctx: _Ctx
    ) -> float | None:
        ts, vals = self._window_points(ctx, name, w)
        lo = bisect_left(ts, ctx.at - w)
        hi = bisect_right(ts, ctx.at)
        if hi <= lo:
            return None
        window = vals[lo:hi]
        if fn == "avg_over_time":
            return sum(window) / len(window)
        if fn == "sum_over_time":
            return sum(window)
        if fn == "min_over_time":
            return min(window)
        if fn == "max_over_time":
            return max(window)
        if fn == "count_over_time":
            return float(len(window))
        if fn == "quantile_over_time":
            return _quantile(sorted(window), q)
        # rate / increase: need two points; counter resets contribute
        # the post-reset value (the Prometheus reset rule).
        if hi - lo < 2:
            return None
        inc = 0.0
        for i in range(lo + 1, hi):
            d = vals[i] - vals[i - 1]
            inc += d if d >= 0 else vals[i]
        if fn == "increase":
            return inc
        span = ts[hi - 1] - ts[lo]
        return inc / span if span > 0 else None

    def _rule_read(
        self, fn: str, q: float | None, rule: RecordingRule, name: str, ctx: _Ctx
    ):
        """O(sub-buckets) read of append-time rule state; returns
        _NO_RULE when this series carries no (covering) accumulator so
        the caller can fall back to the direct path."""
        if fn == "quantile_over_time":
            # Deliberately unbacked: a per-point sketch would put
            # Python work back in the append hot path. Direct read.
            return _NO_RULE
        rs = self.ring.series[name]
        accums = getattr(rs, "rec", None)
        if not accums:
            return _NO_RULE
        for a in accums:
            if a.rule is rule:
                if not a.covers(ctx.at):
                    return _NO_RULE
                m = a.merged(ctx.at)
                if m is None:
                    return None
                n, total, mn, mx, fts, fv, lts, lv, inc = m
                if fn == "avg_over_time":
                    return total / n
                if fn == "sum_over_time":
                    return total
                if fn == "min_over_time":
                    return mn
                if fn == "max_over_time":
                    return mx
                if fn == "count_over_time":
                    return float(n)
                if n < 2:
                    return None
                if fn == "increase":
                    return inc
                span = lts - fts
                return inc / span if span > 0 else None
        return _NO_RULE

    # aggregations -------------------------------------------------------

    def _eval_agg(self, node: Agg, ctx: _Ctx):
        args = node.args
        k = q = None
        if node.op in ("topk", "bottomk"):
            if len(args) != 2 or not isinstance(args[0], Num):
                raise QueryError(f"{node.op} wants (k, expr)")
            k = int(args[0].v)
            vec = self._eval(args[1], ctx)
        elif node.op == "quantile":
            if len(args) != 2 or not isinstance(args[0], Num):
                raise QueryError("quantile wants (q, expr)")
            q = args[0].v
            vec = self._eval(args[1], ctx)
        else:
            if len(args) != 1:
                raise QueryError(f"{node.op} wants exactly one argument")
            vec = self._eval(args[0], ctx)
        if not isinstance(vec, list):
            raise QueryError(f"{node.op} wants a vector, got a scalar")
        if node.op in ("topk", "bottomk"):
            rows = sorted(
                vec,
                key=lambda p: (p[1], _labels_key(p[0])),
                reverse=(node.op == "topk"),
            )
            if not node.by:
                return rows[: max(0, k)]
            # Per-group top-k (Prometheus semantics:
            # ``topk(5, rate(chip.hbm)) by (accel)``): k rows per
            # by-group, each row keeping its FULL label set so the
            # answer says which chip won, not just which family.
            taken: dict[tuple, int] = {}
            out = []
            for labels, v in rows:
                gk = _labels_key({
                    l: labels[l] for l in node.by if labels.get(l) is not None
                })
                n = taken.get(gk, 0)
                if n < max(0, k):
                    taken[gk] = n + 1
                    out.append((labels, v))
            return out
        groups: dict[tuple, tuple[dict, list[float]]] = {}
        for labels, v in vec:
            out_labels = {
                l: labels[l] for l in node.by if labels.get(l) is not None
            }
            gk = _labels_key(out_labels)
            ent = groups.get(gk)
            if ent is None:
                groups[gk] = (out_labels, [v])
            else:
                ent[1].append(v)
        out = []
        for gk in sorted(groups):
            labels, vs = groups[gk]
            if node.op == "sum":
                out.append((labels, sum(vs)))
            elif node.op == "avg":
                out.append((labels, sum(vs) / len(vs)))
            elif node.op == "min":
                out.append((labels, min(vs)))
            elif node.op == "max":
                out.append((labels, max(vs)))
            elif node.op == "count":
                out.append((labels, float(len(vs))))
            else:  # quantile
                out.append((labels, _quantile(sorted(vs), q)))
        return out

    # binary operators ---------------------------------------------------

    _ARITH = {
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        "*": lambda a, b: a * b,
        "/": lambda a, b: (a / b) if b else None,
    }
    _CMP = {
        ">": lambda a, b: a > b,
        "<": lambda a, b: a < b,
        ">=": lambda a, b: a >= b,
        "<=": lambda a, b: a <= b,
        "==": lambda a, b: a == b,
        "!=": lambda a, b: a != b,
    }

    def _eval_bin(self, node: Bin, ctx: _Ctx):
        if node.op in ("and", "or"):
            lhs = self._eval(node.lhs, ctx)
            rhs = self._eval(node.rhs, ctx)
            if isinstance(lhs, list) and isinstance(rhs, list):
                rkeys = {_labels_key(lb) for lb, _ in rhs}
                if node.op == "and":
                    return [p for p in lhs if _labels_key(p[0]) in rkeys]
                lkeys = {_labels_key(lb) for lb, _ in lhs}
                return lhs + [p for p in rhs if _labels_key(p[0]) not in lkeys]
            # Mixed scalar/vector: a vector operand collapses to its
            # non-emptiness (has-any-sample), scalars to truthiness.
            lv = bool(lhs)
            rv = bool(rhs)
            return 1.0 if (lv and rv if node.op == "and" else lv or rv) else 0.0
        lhs = self._eval(node.lhs, ctx)
        rhs = self._eval(node.rhs, ctx)
        arith = self._ARITH.get(node.op)
        if arith is not None:
            return self._combine(lhs, rhs, arith, filter_mode=False)
        cmp = self._CMP[node.op]
        return self._combine(lhs, rhs, cmp, filter_mode=True)

    @staticmethod
    def _combine(lhs, rhs, fn, filter_mode: bool):
        lv = isinstance(lhs, list)
        rv = isinstance(rhs, list)
        if not lv and not rv:
            r = fn(lhs, rhs)
            if isinstance(r, bool):
                return 1.0 if r else 0.0
            return r if r is not None else float("nan")
        if lv and not rv:
            out = []
            for lb, v in lhs:
                r = fn(v, rhs)
                if filter_mode:
                    if r:
                        out.append((lb, v))
                elif r is not None:
                    out.append((lb, r))
            return out
        if rv and not lv:
            out = []
            for lb, v in rhs:
                r = fn(lhs, v)
                if filter_mode:
                    if r:
                        out.append((lb, v))
                elif r is not None:
                    out.append((lb, r))
            return out
        right = {_labels_key(lb): v for lb, v in rhs}
        out = []
        for lb, v in lhs:
            ov = right.get(_labels_key(lb))
            if ov is None:
                continue
            r = fn(v, ov)
            if filter_mode:
                if r:
                    out.append((lb, v))
            elif r is not None:
                out.append((lb, r))
        return out

    # ----------------------------- public API ---------------------------

    def context(self, at: float | None = None, exclude=None) -> _Ctx:
        """An evaluation context reusable across several eval_compiled
        calls at the same instant: the label augmenter (pod
        attribution — O(chips) to build) and the per-(series, window)
        point fetches are shared instead of redone per expression."""
        return _Ctx(self, time.time() if at is None else at,
                    exclude=exclude)

    def eval_compiled(self, node, at: float | None = None, exclude=None,
                      ctx: _Ctx | None = None):
        """Evaluate an already-compiled AST node at one instant and
        return the raw value (scalar, or [(labels, value), ...] vector)
        — the per-tick hot path for callers that compile once per
        config (the SLO engine's burn-rate expressions, docs/slo.md)
        and must not depend on the bounded compile cache."""
        if ctx is None:
            ctx = self.context(at, exclude)
        self.evals += 1
        return self._eval(node, ctx)

    def eval_condition(self, node, at: float | None = None,
                       ctx: _Ctx | None = None) -> bool:
        """Boolean evaluation of a compiled condition: True when any
        sample satisfies it (absent data never fires — the alert
        engine's None contract). Semantically identical to
        ``bool(eval_compiled(node))`` with vector-non-emptiness /
        scalar-truthiness collapse, but the common per-tick shape — a
        single comparison between an instant selector and a constant —
        short-circuits on the first satisfying sample without
        materializing label vectors (the SLO engine's bad-condition
        hot path; bench.py's ``slo`` phase pins the ≤2% tick bound
        this serves). Every other shape — and/or (whose vector
        operands intersect/union BY LABELS in _eval_bin, not by
        truthiness), arithmetic, vector-vector comparisons — falls
        through to the generic evaluator, so the fast path can never
        disagree with it (tests/test_query.py pins the parity)."""
        if ctx is None:
            ctx = self.context(at)
        if isinstance(node, Bin):
            cmp = self._CMP.get(node.op)
            if cmp is not None:
                sel = const = None
                flip = False
                if (isinstance(node.lhs, Selector)
                        and node.lhs.range_s is None):
                    sel, const = node.lhs, _const_value(node.rhs)
                elif (isinstance(node.rhs, Selector)
                        and node.rhs.range_s is None):
                    sel, const = node.rhs, _const_value(node.lhs)
                    flip = True
                if sel is not None and const is not None:
                    self.evals += 1
                    for name in self._matching_names(sel, ctx):
                        v = self._instant_value(ctx, name)
                        if v is None:
                            continue
                        if cmp(const, v) if flip else cmp(v, const):
                            return True
                    return False
        v = self.eval_compiled(node, ctx=ctx)
        if isinstance(v, list):
            return bool(v)
        if v is None or v != v:  # None / NaN: absent never fires
            return False
        return bool(v)

    def instant(self, src: str, at: float | None = None, exclude=None) -> dict:
        """Evaluate ``src`` at one instant; returns the /api/query
        payload shape: {"result_type": "vector"|"scalar", "result":
        [{"labels", "value"}, ...]}."""
        at = time.time() if at is None else at
        self.evals += 1
        node = self.compile(src)
        ctx = _Ctx(self, at, exclude=exclude)
        v = self._eval(node, ctx)
        if isinstance(v, list):
            return {
                "result_type": "vector",
                "at": round(at, 3),
                "result": [
                    {"labels": lb, "value": _round(x)} for lb, x in v
                ],
            }
        return {
            "result_type": "scalar",
            "at": round(at, 3),
            "result": [{"labels": {}, "value": _round(v)}],
        }

    def range_query(
        self,
        src: str,
        window_s: float,
        step_s: float,
        end: float | None = None,
    ) -> dict:
        """Evaluate ``src`` on a step grid over the trailing window;
        returns {"series": [{"labels", "points": [[ts, v], ...]}]}.
        The per-(series, window) point fetch is shared across grid
        steps (one chunk decode per sealed chunk, not per step)."""
        end = time.time() if end is None else end
        self.evals += 1
        node = self.compile(src)
        if step_s <= 0 or window_s <= 0:
            raise QueryError("window and step must be positive")
        steps = int(window_s // step_s)
        if steps > 100_000:
            raise QueryError("window/step grid too fine")
        out: dict[tuple, dict] = {}
        ctx = _Ctx(self, end)
        t = end - (window_s // step_s) * step_s
        while t <= end + 1e-9:
            ctx.at = t
            v = self._eval(node, ctx)
            if not isinstance(v, list):
                v = [({}, v)]
            for lb, x in v:
                gk = _labels_key(lb)
                ent = out.get(gk)
                if ent is None:
                    ent = out[gk] = {"labels": lb, "points": []}
                ent["points"].append([round(t, 3), _round(x)])
            t += step_s
        return {
            "end": round(end, 3),
            "window_s": window_s,
            "step_s": step_s,
            "series": [out[k] for k in sorted(out)],
        }

    # ----------------------- distributed (fleet) ------------------------

    def partial_eval(
        self, src: str, at: float | None = None, exclude=None
    ) -> dict:
        """Phase 1 of a fleet query, run at every node: evaluate the
        aggregation's *inner* expression over local data only and
        reduce it to a mergeable per-group state — counts and sums,
        min/max, topk row sets, quantile sketches — never raw points.
        Raises QueryError unless the expression is a top-level
        aggregation (the distributable contract, docs/query.md)."""
        at = time.time() if at is None else at
        node = self.compile(src)
        if not isinstance(node, Agg):
            raise QueryError(
                "fleet queries must be a top-level aggregation "
                "(sum/avg/min/max/count/quantile/topk/bottomk over an "
                "inner expression)"
            )
        k = q = None
        if node.op in ("topk", "bottomk"):
            k = int(node.args[0].v)
            inner = node.args[1]
        elif node.op == "quantile":
            q = node.args[0].v
            inner = node.args[1]
        else:
            if len(node.args) != 1:
                raise QueryError(f"{node.op} wants exactly one argument")
            inner = node.args[0]
        ctx = _Ctx(self, at, exclude=exclude)
        vec = self._eval(inner, ctx)
        if not isinstance(vec, list):
            raise QueryError("fleet aggregation needs a vector inner expression")
        groups: dict[tuple, dict] = {}
        if node.op in ("topk", "bottomk"):
            rows = sorted(
                vec,
                key=lambda p: (p[1], _labels_key(p[0])),
                reverse=(node.op == "topk"),
            )
            if not node.by:
                return {
                    "op": node.op,
                    "arg": k,
                    "by": [],
                    "groups": [
                        {
                            "labels": {},
                            "state": {
                                "rows": [
                                    [lb, v] for lb, v in rows[: max(0, k)]
                                ]
                            },
                        }
                    ],
                }
            # Grouped top-k partial: k candidate rows PER by-group —
            # still never raw points (at most k × groups rows upstream),
            # and any tier merging fewer groups than exist below it
            # stays correct because each group's k-set is locally
            # complete.
            for labels, v in rows:
                out_labels = {
                    l: labels[l] for l in node.by if labels.get(l) is not None
                }
                gk = _labels_key(out_labels)
                ent = groups.get(gk)
                if ent is None:
                    ent = groups[gk] = {
                        "labels": out_labels,
                        "state": {"rows": []},
                    }
                if len(ent["state"]["rows"]) < max(0, k):
                    ent["state"]["rows"].append([labels, v])
            return {
                "op": node.op,
                "arg": k,
                "by": list(node.by),
                "groups": [groups[gk] for gk in sorted(groups)],
            }
        for labels, v in vec:
            out_labels = {
                l: labels[l] for l in node.by if labels.get(l) is not None
            }
            gk = _labels_key(out_labels)
            ent = groups.get(gk)
            if ent is None:
                ent = groups[gk] = {"labels": out_labels, "_vals": []}
            ent["_vals"].append(v)
        out_groups = []
        for gk in sorted(groups):
            ent = groups[gk]
            vs = ent.pop("_vals")
            if node.op == "quantile":
                sk = QSketch()
                for v in vs:
                    sk.add(v)
                ent["state"] = {"sk": sk.to_json()}
            else:
                ent["state"] = {
                    "n": len(vs),
                    "sum": sum(vs),
                    "min": min(vs),
                    "max": max(vs),
                }
            out_groups.append(ent)
        return {
            "op": node.op,
            "arg": q if node.op == "quantile" else None,
            "by": list(node.by),
            "groups": out_groups,
        }

    @staticmethod
    def merge_partials(parts: list[dict]) -> dict:
        """Phase 2: fold any number of partial states (an aggregator's
        children + its own local partial) into one. Associative and
        commutative by construction, so the tree shape doesn't matter."""
        parts = [p for p in parts if p is not None]
        if not parts:
            raise QueryError("no partial results to merge")
        base = parts[0]
        op = base["op"]
        if op in ("topk", "bottomk"):
            # Group-aware merge: partials from every tier carry one
            # entry per by-group (the ungrouped case is the single
            # group with empty labels, so pre-by peers merge
            # unchanged); rows re-rank within their group and each
            # group keeps its own k.
            k = int(base["arg"])
            by_groups: dict[tuple, dict] = {}
            for p in parts:
                for g in p["groups"]:
                    gk = _labels_key(g["labels"])
                    ent = by_groups.get(gk)
                    if ent is None:
                        ent = by_groups[gk] = {
                            "labels": dict(g["labels"]),
                            "rows": [],
                        }
                    ent["rows"].extend(
                        (dict(lb), v) for lb, v in g["state"]["rows"]
                    )
            out_groups = []
            for gk in sorted(by_groups):
                ent = by_groups[gk]
                ent["rows"].sort(
                    key=lambda r: (r[1], _labels_key(r[0])),
                    reverse=(op == "topk"),
                )
                out_groups.append(
                    {
                        "labels": ent["labels"],
                        "state": {
                            "rows": [[lb, v] for lb, v in ent["rows"][:k]]
                        },
                    }
                )
            return {
                "op": op,
                "arg": k,
                "by": base.get("by") or [],
                "groups": out_groups,
            }
        merged: dict[tuple, dict] = {}
        for p in parts:
            if p["op"] != op:
                raise QueryError("partial results disagree on the aggregation")
            for g in p["groups"]:
                gk = _labels_key(g["labels"])
                ent = merged.get(gk)
                if ent is None:
                    st = g["state"]
                    merged[gk] = {
                        "labels": dict(g["labels"]),
                        "state": (
                            {"sk": QSketch.from_json(st["sk"]).to_json()}
                            if "sk" in st
                            else dict(st)
                        ),
                    }
                    continue
                st = ent["state"]
                gs = g["state"]
                if "sk" in st:
                    sk = QSketch.from_json(st["sk"])
                    sk.merge(QSketch.from_json(gs["sk"]))
                    ent["state"] = {"sk": sk.to_json()}
                else:
                    st["n"] += gs["n"]
                    st["sum"] += gs["sum"]
                    st["min"] = min(st["min"], gs["min"])
                    st["max"] = max(st["max"], gs["max"])
        return {
            "op": op,
            "arg": base.get("arg"),
            "by": base.get("by") or [],
            "groups": [merged[k] for k in sorted(merged)],
        }

    @staticmethod
    def finalize(partial: dict) -> list[dict]:
        """Phase 3, root only: partial state → the instant-vector
        result rows /api/query serves."""
        op = partial["op"]
        out = []
        if op in ("topk", "bottomk"):
            for g in partial["groups"]:
                for lb, v in g["state"]["rows"]:
                    out.append({"labels": dict(lb), "value": _round(v)})
            return out
        for g in partial["groups"]:
            st = g["state"]
            if "sk" in st:
                v = QSketch.from_json(st["sk"]).quantile(partial["arg"])
            elif op == "sum":
                v = st["sum"]
            elif op == "avg":
                v = st["sum"] / st["n"] if st["n"] else None
            elif op == "min":
                v = st["min"]
            elif op == "max":
                v = st["max"]
            else:  # count
                v = float(st["n"])
            if v is not None:
                out.append({"labels": dict(g["labels"]), "value": _round(v)})
        return out

    def to_json(self) -> dict:
        rules = getattr(self.ring, "rules", None)
        return {
            "functions": list(FUNCTIONS),
            "series": len(self.ring.series),
            "compiled": len(self._compiled),
            "compiles": self.compiles,
            "evals": self.evals,
            "default_range_s": self.default_range_s,
            "lookback_s": self.lookback_s,
            "rules": rules.to_json() if rules is not None else [],
        }


_NO_RULE = object()  # sentinel: no covering accumulator, use direct path


def _round(v: float) -> float:
    """Payload rounding: floats serialize at a stable precision (the
    render layer's contract); NaN/inf degrade to None-safe values."""
    if v != v or v in (float("inf"), float("-inf")):
        return None
    return v


# ------------------------- env-predicate compiler -----------------------


def compile_env(src: str):
    """Compile an expression into an evaluator over a flat environment
    (``{"chip.hbm": 91.0, "chip.mxu": 3.0, ...}``) — the alert engine's
    rule compiler (tpumon_torch.alerts): threshold rules are expression
    strings formatted once per config, parsed by THIS parser, and the
    per-tick loop evaluates the compiled closures.

    Missing data (None) follows alerting semantics: arithmetic over
    None is None, a comparison against None is False (no data never
    fires a page), and/or treat None as False."""
    node = parse(src)
    _env_check(node)

    def run(env: dict):
        return _eval_env(node, env)

    return run


def _env_check(node) -> None:
    if isinstance(node, Selector):
        if node.range_s is not None or node.matchers:
            raise QueryError(
                "env expressions use plain names (no ranges/matchers)"
            )
        return
    if isinstance(node, Num):
        return
    if isinstance(node, Neg):
        _env_check(node.arg)
        return
    if isinstance(node, Bin):
        _env_check(node.lhs)
        _env_check(node.rhs)
        return
    raise QueryError(
        f"env expressions are scalar (no {type(node).__name__} nodes)"
    )


def _eval_env(node, env: dict):
    if isinstance(node, Num):
        return node.v
    if isinstance(node, Selector):
        return env.get(node.family)
    if isinstance(node, Neg):
        v = _eval_env(node.arg, env)
        return None if v is None else -v
    op = node.op
    a = _eval_env(node.lhs, env)
    b = _eval_env(node.rhs, env)
    if op in ("and", "or"):
        ta = bool(a) if a is not None else False
        tb = bool(b) if b is not None else False
        return (ta and tb) if op == "and" else (ta or tb)
    if op in QueryEngine._CMP:
        if a is None or b is None:
            return False
        return bool(QueryEngine._CMP[op](a, b))
    if a is None or b is None:
        return None
    return QueryEngine._ARITH[op](a, b)


# -------------------------------- CLI ----------------------------------


def _labels_str(labels: dict) -> str:
    if not labels:
        return "·"
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def query_cli(argv: list[str]) -> int:
    """``tpumon query 'expr'`` — run an instant or range query against a
    running server over the same /api/query routes the dashboard uses."""
    import urllib.parse
    import urllib.request

    url = "http://127.0.0.1:8888"
    expr = None
    rng = None
    step = "30s"
    as_json = False
    fleet = False
    at = None
    it = iter(argv)
    for a in it:
        if a == "--url":
            url = next(it, url)
        elif a == "--range":
            rng = next(it, None)
        elif a == "--step":
            step = next(it, step)
        elif a == "--json":
            as_json = True
        elif a == "--fleet":
            fleet = True
        elif a == "--time":
            at = next(it, None)
        elif a in ("-h", "--help"):
            print(
                "usage: python -m tpumon query 'expr' [--url HOST:8888]\n"
                "         [--range 30m [--step 30s]] [--fleet] [--time TS]\n"
                "         [--json]\n"
                "Instant by default; --range evaluates on a step grid;\n"
                "--fleet plans a distributed query over the federation\n"
                "tree (aggregator or root only). Grammar: docs/query.md."
            )
            return 0
        elif expr is None and not a.startswith("-"):
            expr = a
        else:
            print(f"unknown argument {a!r}", file=sys.stderr)
            return 2
    if not expr:
        print("query: an expression argument is required", file=sys.stderr)
        return 2
    if not url.startswith(("http://", "https://")):
        url = f"http://{url}"
    params = {"query": expr}
    if rng is not None:
        path = "/api/query_range"
        params["window"] = rng
        params["step"] = step
    else:
        path = "/api/query"
        if fleet:
            params["fleet"] = "1"
        if at is not None:
            params["time"] = at
    full = f"{url.rstrip('/')}{path}?{urllib.parse.urlencode(params)}"
    try:
        with urllib.request.urlopen(full, timeout=30) as r:
            payload = json.load(r)
    except Exception as e:
        body = getattr(e, "read", lambda: b"")()
        try:
            msg = json.loads(body).get("error", "")
        except Exception:
            msg = ""
        print(f"query failed: {msg or e}", file=sys.stderr)
        return 1
    if as_json:
        print(json.dumps(payload, indent=1))
        return 0
    if rng is not None:
        for s in payload.get("series", []):
            pts = s.get("points") or []
            vals = [p[1] for p in pts if p[1] is not None]
            if not vals:
                continue
            print(
                f"{_labels_str(s.get('labels') or {}):<40} "
                f"n={len(pts)} min={min(vals):.3f} "
                f"mean={sum(vals) / len(vals):.3f} max={max(vals):.3f} "
                f"last={vals[-1]:.3f}"
            )
        return 0
    if payload.get("partial"):
        missing = ", ".join(payload.get("missing") or [])
        print(f"[partial: missing {missing}]", file=sys.stderr)
    for row in payload.get("result", []):
        v = row.get("value")
        vs = "null" if v is None else f"{v:.6g}"
        print(f"{_labels_str(row.get('labels') or {}):<40} {vs}")
    return 0
