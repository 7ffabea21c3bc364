"""The port's query engine against the reference's.

``tpumon_torch/query.py`` is a copy of ``tpumon/query.py``. The same
seeded history lands in both packages' rings (the fuzz corpus of
tests/test_query.py, and a recording-rule ring of 8 chips), and every
instant query, range query and recording-rule read of tests/test_query.py
must give the reference's result exactly (== on floats). Rule stores are
compared byte for byte across both packages' kernel paths.
"""

import json
import math
from pathlib import Path

import pytest

from tpumon import query as ref_query
from tpumon import tsdb as ref_tsdb
from tpumon.history import RingHistory as RefRing
from tpumon_torch import query, tsdb
from tpumon_torch.history import RingHistory

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "tsdb_fuzz.json"
PACKAGES = ((RingHistory, query), (RefRing, ref_query))


def corpus_rings():
    """The fuzz corpus as chip.<case>/c<i>.mxu series in a ring of each
    package (non-finite values dropped, as tests/test_query.py does)."""
    corpus = json.loads(FIXTURE.read_text())
    out = []
    for ring_cls, _ in PACKAGES:
        ring = ring_cls(window_s=10**9, long_window_s=10**9)
        for i, case in enumerate(corpus):
            name = f"chip.{case['name']}/c{i}.mxu"
            for t_ms, v in zip(case["ts_ms"], case["values"]):
                if v != v or v in (math.inf, -math.inf):
                    continue
                ring.record(name, v, ts=t_ms / 1000.0)
        out.append(ring)
    at = max(s.fine.since(None)[-1][0] for s in out[0].series.values()
             if s.fine.since(None))
    return out, at


@pytest.fixture(scope="module")
def corpus_engines():
    (a, b), at = corpus_rings()
    return query.QueryEngine(a), ref_query.QueryEngine(b), at


INSTANT = [
    "chip.mxu",
    *[f"{fn}(chip.mxu[{w}s])"
      for fn in ("rate", "increase", "avg_over_time", "min_over_time",
                 "max_over_time", "sum_over_time", "count_over_time")
      for w in (30, 120, 3600)],
    *[f"quantile_over_time({q}, chip.mxu[300s])" for q in (0.0, 0.5, 0.9, 1.0)],
    "sum(chip.mxu)", "avg(chip.mxu)", "min(chip.mxu)", "max(chip.mxu)",
    "count(chip.mxu)", "quantile(0.5, chip.mxu)",
    "avg by (host) (chip.mxu)", "topk(3, chip.mxu)", "bottomk(2, chip.mxu)",
    "avg(chip.mxu) * 2 - 1", "chip.mxu > 50", "-(avg(chip.mxu)) / 2",
    "topk(5, avg_over_time(chip.mxu[5m]))",
    'chip.mxu{host=~"*fuzz*"}',
]


@pytest.mark.parametrize("expr", INSTANT)
def test_instant_query_equals_reference(corpus_engines, expr):
    port, ref, at = corpus_engines
    assert port.instant(expr, at=at) == ref.instant(expr, at=at)


@pytest.mark.parametrize("expr,window,step", [
    ("avg_over_time(chip.mxu[60s])", 300, 60),
    ("avg(chip.mxu)", 1800, 30),
    ("max by (host) (chip.mxu)", 600, 15),
])
def test_range_query_equals_reference(corpus_engines, expr, window, step):
    port, ref, at = corpus_engines
    assert (port.range_query(expr, window, step, end=at)
            == ref.range_query(expr, window, step, end=at))


def error_text(ring_cls, mod, src: str) -> str:
    """The QueryError a package raises parsing and evaluating ``src``."""
    with pytest.raises(mod.QueryError) as e:
        mod.QueryEngine(ring_cls(1800)).instant(src, at=1_700_000_000.0)
    return str(e.value)


@pytest.mark.parametrize("src", [
    "", "rate(", "topk(chip.mxu)", "chip.hbm[banana]", 'chip.hbm{chip=h0}',
    "avg by host (chip.mxu)", "quantile(chip.mxu)", "avg(chip.mxu)) ",
])
def test_query_errors_equal_reference(src):
    assert error_text(*PACKAGES[0], src) == error_text(*PACKAGES[1], src)


def rules_rings(port_path: str, ref_path: str):
    """tests/test_query.py's recording-rule ring (8 chips x 3 metrics,
    400 ticks, rules chip.mxu[5m] and chip.hbm[5m]) in both packages."""
    tsdb.set_kernel_enabled(port_path == "kernel")
    ref_tsdb.set_kernel_enabled(ref_path == "kernel")
    rings = []
    for ring_cls, mod in PACKAGES:
        ring = ring_cls()
        ring.set_recording_rules(mod.RuleSet(
            [mod.RecordingRule("chip.mxu[5m]"),
             mod.RecordingRule("chip.hbm[5m]")]))
        hs = [ring.handle(f"chip.h{c % 2}/c{c}.{m}")
              for c in range(8) for m in ("mxu", "hbm", "temp")]
        now = 1_700_000_000.0
        for i in range(400):
            ring.record_batch(
                [(h, 30.0 + (j * 3 + i) % 60) for j, h in enumerate(hs)],
                ts=now + i)
        rings.append(ring)
    return rings, now + 399


@pytest.fixture
def restore_policy():
    yield
    tsdb.set_kernel_enabled(True)
    ref_tsdb.set_kernel_enabled(True)


@pytest.mark.parametrize("port_path,ref_path", [
    ("kernel", "kernel"), ("python", "python"), ("kernel", "python")])
def test_recording_rules_equal_reference(restore_policy, port_path,
                                         ref_path):
    """Rule store columns byte for byte, and every rule-backed read (and
    one that falls back to the direct path) equal to the reference's."""
    (a, b), at = rules_rings(port_path, ref_path)
    if port_path == "kernel":
        assert tsdb.kernel() is not None
    assert a.rules.to_json() == b.rules.to_json()
    for rp, rr in zip(a.rules.rules, b.rules.rules):
        for col in ("hh", "open", "hist", "slot_map"):
            assert (getattr(rp.store, col).tobytes()
                    == getattr(rr.store, col).tobytes()), col
    pe, re_ = query.QueryEngine(a), ref_query.QueryEngine(b)
    for src in ("avg_over_time(chip.mxu[5m])", "max_over_time(chip.hbm[5m])",
                "min_over_time(chip.mxu[5m])", "sum_over_time(chip.hbm[5m])",
                "count_over_time(chip.mxu[5m])", "rate(chip.mxu[5m])",
                "increase(chip.hbm[5m])",
                "topk(3, avg_over_time(chip.mxu[5m]))",
                "avg(chip.temp)"):
        assert pe.instant(src, at=at) == re_.instant(src, at=at), src
    old = "avg_over_time(chip.mxu[5m])"
    assert pe.instant(old, at=at - 350) == re_.instant(old, at=at - 350)
    assert (pe.range_query("avg(chip.mxu)", 1800, 30, end=at)
            == re_.range_query("avg(chip.mxu)", 1800, 30, end=at))


@pytest.mark.parametrize("src,env", [
    ("chip.hbm > 50 and chip.mxu < 5", {"chip.hbm": 80.0, "chip.mxu": 3.0}),
    ("chip.hbm > 50 and chip.mxu < 5", {"chip.hbm": None, "chip.mxu": 3.0}),
    ("chip.link_up == 0 or chip.ici_health == 10",
     {"chip.link_up": None, "chip.ici_health": 10.0}),
    ("(host.cpu + 10) / 2", {"host.cpu": 90.0}),
    ("(host.cpu + 10) / 2", {}),
])
def test_compile_env_equals_reference(src, env):
    assert query.compile_env(src)(env) == ref_query.compile_env(src)(env)
