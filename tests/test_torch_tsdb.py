"""The port's columnar TSDB and its native ingest kernel against the
reference's.

``tpumon_torch/tsdb.py`` and ``tpumon_torch/native/`` are copies of the
reference's; the port builds its kernel from its own sources into
``build/tpumon_torch/native/``. The fuzz corpus of tests/test_ingest.py
goes through the port's pure-Python path and through its native kernel
(g++ builds it here), and through the reference's pure-Python path and
its kernel: head columns, sealed chunk bytes, downsampled tiers and
their accumulators, and the quantized values must be equal bit for bit.
Each package keeps its own process-wide kernel policy, so every test
sets both.
"""

import asyncio
import json
import shutil
import struct
from pathlib import Path

import pytest

from tpumon import native as ref_native
from tpumon import tsdb as ref_tsdb
from tpumon.history import RingHistory as RefRing
from tpumon.history import RingSeries as RefSeries
from tpumon_torch import native, tsdb
from tpumon_torch.history import RingHistory, RingSeries

ROOT = Path(__file__).resolve().parents[1]
FUZZ = ROOT / "tests" / "fixtures" / "tsdb_fuzz.json"
PATHS = ("python", "kernel")
BATCH_SIZES = (1, 7, 64, 200)


def _need_kernel(mod):
    if mod.kernel() is None:
        if shutil.which("g++") is None:
            pytest.skip("no g++ to build the ingest kernel")
        raise AssertionError(f"{mod.__name__}: kernel did not load")


@pytest.fixture
def policy():
    """set(port_path, ref_path): each package's kernel policy for the
    test; both restored to the default (kernel on) afterwards."""

    def set_paths(port_path: str, ref_path: str) -> None:
        tsdb.set_kernel_enabled(port_path == "kernel")
        ref_tsdb.set_kernel_enabled(ref_path == "kernel")
        if port_path == "kernel":
            _need_kernel(tsdb)
        if ref_path == "kernel":
            _need_kernel(ref_tsdb)

    yield set_paths
    tsdb.set_kernel_enabled(True)
    ref_tsdb.set_kernel_enabled(True)


def corpus():
    for entry in json.loads(FUZZ.read_text()):
        ts = [t / 1000.0 for t in entry["ts_ms"]]
        yield entry["name"], ts, [float(v) for v in entry["values"]]


def series_state(s) -> tuple:
    """Everything observable about a series' storage, as raw bytes (as
    tests/test_ingest.py reads it)."""

    def tier_state(t) -> tuple:
        return (t.head_ts.tobytes(), t.head_val.tobytes(),
                tuple((c.start_ms, c.end_ms, c.count, c.data)
                      for c in t.chunks))

    return (tier_state(s.fine),
            tuple((tier_state(d.tier), d.bucket, struct.pack("<d", d.bsum),
                   d.bn) for d in s.down))


def make_series(cls):
    s = cls(window_s=3600, long_window_s=24 * 3600, coarse_step_s=60.0,
            mid_step_s=30.0, mid_window_s=6 * 3600)
    s.fine.seal_points = 64  # many chunk boundaries over the corpus
    return s


def feed(s, ts, vals) -> None:
    i = k = 0
    while i < len(ts):
        n = BATCH_SIZES[k % len(BATCH_SIZES)]
        k += 1
        s.add_batch(ts[i:i + n], vals[i:i + n])
        i += n


@pytest.mark.parametrize("ref_path", PATHS)
@pytest.mark.parametrize("port_path", PATHS)
def test_fuzz_corpus_state_equals_reference(policy, port_path, ref_path):
    """Every corpus case in mixed batch sizes: the port's series state
    (head, sealed chunks, both downsampled tiers and accumulators)
    equals the reference's, byte for byte, on either path of each."""
    policy(port_path, ref_path)
    for name, ts, vals in corpus():
        a, b = make_series(RingSeries), make_series(RefSeries)
        feed(a, ts, vals)
        feed(b, ts, vals)
        assert series_state(a) == series_state(b), name
        assert a.fine.out_of_order == b.fine.out_of_order, name


@pytest.mark.parametrize("port_path", PATHS)
def test_quantized_values_and_chunks_equal_reference(policy, port_path):
    """quantize_batch (ms timestamps, f32 values, order flag) and one
    sealed chunk of each corpus case, through the port's path against
    the reference's pure-Python functions."""
    policy(port_path, "python")
    k = tsdb.kernel()
    for name, ts, vals in corpus():
        want = ref_tsdb.quantize_batch(ts, vals, None)
        got = tsdb.quantize_batch(ts, vals, None)
        assert [x.tobytes() if hasattr(x, "tobytes") else x for x in got] \
            == [x.tobytes() if hasattr(x, "tobytes") else x for x in want], name
        ts_q, val_q = want[0], want[1]
        if not want[2]:
            continue  # seal_encode takes ordered heads only
        ts_ms = [int(round(t * 1000)) for t in ts_q]
        bits = [ref_tsdb.f32bits(v) for v in val_q]
        chunk = ref_tsdb.encode_chunk(ts_ms, bits)
        assert tsdb.encode_chunk(ts_ms, bits) == chunk, name
        if k is not None:
            assert k.seal_encode(ts_q, val_q)[2] == chunk, name


@pytest.mark.parametrize("port_path", PATHS)
def test_record_batch_many_series_equals_reference(policy, port_path):
    """The sampler's tick shape: 48 series at one timestamp a tick, a
    fifth of them skipping each tick, through record_batch (the
    accum_many path once the batch clears ACCUM_KERNEL_MIN); then the
    binary snapshot of both rings is the same bytes."""
    policy(port_path, "python")
    assert tsdb.ACCUM_KERNEL_MIN == ref_tsdb.ACCUM_KERNEL_MIN <= 38
    rings = (RingHistory(), RefRing())
    names = [f"chip.h{i % 3}/c{i}.mxu" for i in range(48)]
    for tick in range(150):
        ts = 1_700_000_000.0 + tick
        pairs = [(n, None if (tick + i) % 5 == 0 else float(i) + tick * 0.01)
                 for i, n in enumerate(names)]
        for ring in rings:
            ring.record_batch(pairs, ts=ts)
    a, b = rings
    assert sorted(a.series) == sorted(b.series)
    for n in a.series:
        assert series_state(a.series[n]) == series_state(b.series[n]), n
    assert a.mutations == b.mutations
    assert (tsdb.dump_snapshot(a.series, 1_700_000_200.0)
            == ref_tsdb.dump_snapshot(b.series, 1_700_000_200.0))


def test_native_builds_into_the_build_tree():
    """python -m tpumon_torch.native build compiles both libraries from
    the port's sources into build/tpumon_torch/native/, named by a digest
    of the source; the kernel passes its ABI gate. The reference's
    in-package libraries are never the ones the port loads."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native layer")
    assert native.build()
    for lib in native.SOURCES:
        path = native.so_path(lib)
        assert path.exists()
        assert path.parent == ROOT / "build" / "tpumon_torch" / "native"
        assert path.name.startswith(f"libtpumon_{lib}-")
        assert Path(ref_native._DIR) not in path.parents
    assert native.load_tsdb(auto_build=False) is not None
    assert native.load(auto_build=False) is not None


def test_native_flags_key_the_library_name(monkeypatch, tmp_path):
    """$CXXFLAGS overrides the default flags and changes the library's
    digest, so a library built with other flags is never loaded in its
    place; the build writes under BUILD_DIR and nothing beside the
    sources."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native layer")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.delenv("CXXFLAGS", raising=False)
    default = native.so_path("tsdb")
    monkeypatch.setenv("CXXFLAGS", native.DEFAULT_CXXFLAGS + " -O1")
    other = native.so_path("tsdb")
    assert default != other and other.parent == tmp_path
    before = sorted(p.name for p in native._DIR.iterdir())
    assert native.build_library("tsdb") == other and other.exists()
    assert not default.exists()
    assert native.load_tsdb(auto_build=False) is not None
    assert sorted(p.name for p in native._DIR.iterdir()) == before


def test_native_host_reader_equals_reference():
    """The port's native /proc reader and the reference's, on the same
    /proc, report the same static fields."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native layer")
    port = native.make_reader()
    ref = ref_native.make_reader()
    if ref is None:
        pytest.skip("the reference's host sampler did not build")
    a, b = port.sample(), ref.sample()
    for key in ("ok_cpu", "ok_mem", "ok_disk", "cores", "mem_total",
                "disk_total"):
        assert a[key] == b[key], key


@pytest.fixture
def fresh_kernel_state():
    """The port's once-per-process kernel load, reset around the test."""
    saved = (tsdb._KERNEL, tsdb._KERNEL_TRIED, tsdb._KERNEL_ERROR)
    tsdb._KERNEL, tsdb._KERNEL_TRIED, tsdb._KERNEL_ERROR = None, False, None
    yield
    tsdb._KERNEL, tsdb._KERNEL_TRIED, tsdb._KERNEL_ERROR = saved


def test_failed_kernel_build_is_reported(fresh_kernel_state, monkeypatch,
                                         tmp_path):
    """A kernel that does not build leaves the store on its bit-exact
    Python path, and says why: tsdb.kernel_status() and the sampler's
    health report carry the compiler's error."""
    from tpumon_torch.config import load_config
    from tpumon_torch.sampler import Sampler

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    assert tsdb.kernel() is None
    status = tsdb.kernel_status()
    assert status["active"] is False
    assert "RuntimeError" in status["error"] and "false" in status["error"]
    sampler = Sampler(load_config(env={"TPUMON_COLLECTORS": "host"}))
    asyncio.run(sampler.tick_fast())
    h = sampler.health_json()["history"]
    assert h["ingest_kernel"] is False
    assert h["ingest_kernel_error"] == status["error"]
    ring = RingHistory()
    ring.record_batch([("x", 1.5)], ts=1_700_000_000.0)
    assert ring.series["x"].fine.since(None) == [(1_700_000_000.0, 1.5)]


def test_load_tsdb_says_why_when_not_built(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="not built"):
        native.load_tsdb(auto_build=False)
    assert native.load(auto_build=False) is None
