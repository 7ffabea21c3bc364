"""ctypes bindings for the native layer (hostmon.cpp, tsdbkern.cpp).

Optional fast paths: the host collector samples through
libtpumon_host.so and the columnar TSDB's ingest spine
(tpumon_torch.tsdb batch append / downsample / seal) runs through
libtpumon_tsdb.so; otherwise bit-exact pure-Python implementations are
used — every native piece degrades independently (docs/resilience.md).
Bindings are ctypes over a C ABI — no pybind11.

The libraries are built from the sources beside this file with
``$CXX $CXXFLAGS`` (default ``g++`` and ``DEFAULT_CXXFLAGS``), at first
use (or ``python -m tpumon_torch.native build``), into
``build/tpumon_torch/native/`` at the
repository root, each named with a digest of its source and the flags,
so an edited source rebuilds and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from array import array
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "tpumon_torch" / "native"
SOURCES = {"host": "hostmon.cpp", "tsdb": "tsdbkern.cpp"}
ABI_VERSION = 1
TSDB_ABI_VERSION = 2

OK_CPU, OK_MEM, OK_DISK = 1, 2, 4

_build_lock = threading.Lock()


DEFAULT_CXXFLAGS = "-O2 -fPIC -Wall -Wextra -std=c++17"


def _make_vars() -> tuple[str, list[str]]:
    """(compiler, flags): ``$CXX``/``$CXXFLAGS`` where set, else g++ and
    DEFAULT_CXXFLAGS."""
    cxx = os.environ.get("CXX") or "g++"
    flags = (os.environ.get("CXXFLAGS") or DEFAULT_CXXFLAGS).split()
    return cxx, flags


def so_path(lib: str) -> Path:
    """Where ``lib`` ("host" or "tsdb") is built: ``libtpumon_<lib>-<digest>.so``
    under BUILD_DIR, the digest over its source and the compiler flags."""
    cxx, flags = _make_vars()
    h = hashlib.sha256(" ".join([cxx, *flags]).encode())
    h.update((_DIR / SOURCES[lib]).read_bytes())
    return BUILD_DIR / f"libtpumon_{lib}-{h.hexdigest()[:16]}.so"


def build_library(lib: str) -> Path:
    """Compile ``lib`` unless its library is already built; returns its
    path. Raises RuntimeError with the compiler's output when the
    compiler is missing or fails."""
    out = so_path(lib)
    with _build_lock:
        if out.exists():
            return out
        cxx, flags = _make_vars()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *flags, "-shared", "-o", str(tmp), str(_DIR / SOURCES[lib])]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{cxx} not runnable: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build(quiet: bool = True) -> bool:
    """Compile both shared libraries; returns success (both)."""
    ok = True
    for lib in SOURCES:
        try:
            path = build_library(lib)
        except RuntimeError as e:
            ok = False
            if not quiet:
                print(e)
        else:
            if not quiet:
                print(f"built {path}")
    return ok


class RuleStoreStruct(ctypes.Structure):
    """Mirror of tsdbkern.cpp's TpumonRuleStore: one recording-rule
    store's geometry + column pointers, passed as a single argument so
    the per-tick call marshals one pointer instead of nineteen values
    (tpumon_torch.query.RuleStore caches an instance per store)."""

    _fields_ = [
        ("sub", ctypes.c_double),
        ("nsub", ctypes.c_int32),
        ("map_len", ctypes.c_int32),
        ("slot_map", ctypes.POINTER(ctypes.c_int32)),
        ("hh", ctypes.POINTER(ctypes.c_int32)),
        ("open", ctypes.POINTER(ctypes.c_double)),
        ("hist", ctypes.POINTER(ctypes.c_double)),
    ]


class HostSampleStruct(ctypes.Structure):
    _fields_ = [
        ("load1", ctypes.c_double),
        ("mem_total", ctypes.c_uint64),
        ("mem_available", ctypes.c_uint64),
        ("cpu_busy_jiffies", ctypes.c_uint64),
        ("cpu_total_jiffies", ctypes.c_uint64),
        ("disk_total", ctypes.c_uint64),
        ("disk_used", ctypes.c_uint64),
        ("cores", ctypes.c_int32),
        ("ok", ctypes.c_int32),
    ]


def load(auto_build: bool = False):
    """Load the native host sampler; returns the ctypes lib or None."""
    path = so_path("host")
    if not path.exists():
        if not auto_build:
            return None
        try:
            build_library("host")
        except RuntimeError:
            return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.tpumon_host_sample.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.POINTER(HostSampleStruct),
        ]
        lib.tpumon_host_sample.restype = ctypes.c_int
        lib.tpumon_native_abi_version.restype = ctypes.c_int
        if lib.tpumon_native_abi_version() != ABI_VERSION:
            return None
        return lib
    except OSError:
        return None


class NativeHostReader:
    """Samples host metrics through the C++ shim."""

    def __init__(self, lib, proc_root: str = "/proc", mount: str = "/"):
        self._lib = lib
        self._proc_root = proc_root.encode()
        self._mount = mount.encode()

    def sample(self) -> dict:
        s = HostSampleStruct()
        self._lib.tpumon_host_sample(
            self._proc_root, self._mount, ctypes.byref(s)
        )
        return {
            "ok_cpu": bool(s.ok & OK_CPU),
            "ok_mem": bool(s.ok & OK_MEM),
            "ok_disk": bool(s.ok & OK_DISK),
            "load1": s.load1,
            "cores": s.cores,
            "cpu_busy_jiffies": s.cpu_busy_jiffies,
            "cpu_total_jiffies": s.cpu_total_jiffies,
            "mem_total": s.mem_total,
            "mem_available": s.mem_available,
            "disk_total": s.disk_total,
            "disk_used": s.disk_used,
        }


def make_reader(
    proc_root: str = "/proc", mount: str = "/", auto_build: bool = True
) -> NativeHostReader | None:
    lib = load(auto_build=auto_build)
    return NativeHostReader(lib, proc_root, mount) if lib else None


# ------------------------- TSDB ingest kernel --------------------------

_PD = ctypes.POINTER(ctypes.c_double)
_PF = ctypes.POINTER(ctypes.c_float)
_PI32 = ctypes.POINTER(ctypes.c_int32)


def _pd(a: array) -> _PD:
    """array('d') -> double* (the array outlives every call here)."""
    return ctypes.cast(a.buffer_info()[0], _PD)


def _pf(a: array) -> _PF:
    return ctypes.cast(a.buffer_info()[0], _PF)


class TsdbKernel:
    """The native append/downsample kernel (tsdbkern.cpp) behind the
    columnar store's batch ingest path (tpumon_torch.tsdb). Stateless: every
    call transforms caller-owned buffers; the Python store keeps all
    state, which is what lets the pure-Python fallback stay bit-exact
    (tests/test_ingest.py drives both over the same fuzz corpus)."""

    __slots__ = ("_lib",)

    def __init__(self, lib):
        lib.tpumon_tsdb_quantize.argtypes = [
            ctypes.c_int64, _PD, _PD, ctypes.c_double, _PD, _PF,
        ]
        lib.tpumon_tsdb_quantize.restype = ctypes.c_int32
        lib.tpumon_tsdb_accum.argtypes = [
            ctypes.c_int64, _PD, _PF, ctypes.c_double, _PD, _PD, _PD,
        ]
        lib.tpumon_tsdb_accum.restype = ctypes.c_int64
        lib.tpumon_tsdb_accum_many.argtypes = [
            ctypes.c_int64, ctypes.c_double, _PF, _PI32, ctypes.c_double,
            _PD, _PD, _PD, _PI32, _PD, _PD,
        ]
        lib.tpumon_tsdb_accum_many.restype = ctypes.c_int64
        lib.tpumon_tsdb_seal_encode.argtypes = [
            ctypes.c_int64, _PD, _PF, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tpumon_tsdb_seal_encode.restype = ctypes.c_int64
        lib.tpumon_tsdb_rule_accum.argtypes = [
            ctypes.c_int64, ctypes.c_double, _PF, _PI32,
            ctypes.POINTER(RuleStoreStruct),
        ]
        lib.tpumon_tsdb_rule_accum.restype = ctypes.c_int64
        lib.tpumon_tsdb_rule_accum_multi.argtypes = [
            ctypes.c_int64, ctypes.c_double, _PF, _PI32,
            ctypes.POINTER(ctypes.POINTER(RuleStoreStruct)),
            ctypes.c_int32,
        ]
        lib.tpumon_tsdb_rule_accum_multi.restype = ctypes.c_int64
        self._lib = lib

    def quantize(
        self, ts: array, vals: array, last_ts: float | None
    ) -> tuple[array, array, bool]:
        """(raw f64 ts, raw f64 vals) -> (ms-quantized f64 ts, f32 vals,
        in-order?) — tsdb.quantize_batch's kernel half."""
        n = len(ts)
        ts_q = array("d", bytes(8 * n))
        val_q = array("f", bytes(4 * n))
        ordered = self._lib.tpumon_tsdb_quantize(
            n, _pd(ts), _pd(vals),
            float("nan") if last_ts is None else last_ts,
            _pd(ts_q), _pf(val_q),
        )
        return ts_q, val_q, bool(ordered)

    def accum(
        self, ts_q: array, val_q: array, step: float, down
    ) -> list[tuple[float, float]]:
        """Run a Downsample's bucket accumulation over a batch; updates
        down.bucket/bsum/bn in place, returns closed buckets as
        (mid_ts, raw mean) pairs."""
        n = len(ts_q)
        state = (ctypes.c_double * 3)(
            float("nan") if down.bucket is None else float(down.bucket),
            down.bsum,
            float(down.bn),
        )
        flush_ts = array("d", bytes(8 * n))
        flush_mean = array("d", bytes(8 * n))
        nf = self._lib.tpumon_tsdb_accum(
            n, _pd(ts_q), _pf(val_q), step, state, _pd(flush_ts), _pd(flush_mean)
        )
        b = state[0]
        down.bucket = None if b != b else int(b)
        down.bsum = state[1]
        down.bn = int(state[2])
        return [(flush_ts[i], flush_mean[i]) for i in range(nf)]

    def accum_many(
        self, ts_q: float, val_q: array, slots: array, store
    ) -> list[tuple[int, float, float]]:
        """One point per series at a shared timestamp, accumulated into
        an AccumStore's (bucket, bsum, bn) columns; returns closed
        buckets as (slot, mid_ts, raw mean)."""
        n = len(slots)
        flush_slot = array("i", bytes(4 * n))
        flush_ts = array("d", bytes(8 * n))
        flush_mean = array("d", bytes(8 * n))
        nf = self._lib.tpumon_tsdb_accum_many(
            n, ts_q, _pf(val_q),
            ctypes.cast(slots.buffer_info()[0], _PI32), store.step_s,
            _pd(store.bucket), _pd(store.bsum), _pd(store.bn),
            ctypes.cast(flush_slot.buffer_info()[0], _PI32),
            _pd(flush_ts), _pd(flush_mean),
        )
        return [(flush_slot[i], flush_ts[i], flush_mean[i]) for i in range(nf)]

    def rule_accum(self, ts: float, val_q: array, slots: array, store) -> int:
        """Recording-rule accumulation (tpumon_torch.query.RuleStore): update
        every matched series' open sub-bucket summary row for one
        shared-timestamp batch — the ring's existing (slots, f32
        values) arrays go straight in; store columns update in place.
        Returns the matched-series count. The store-side pointers are
        cached on the store (its arrays only move on add_slot) so the
        steady-state per-tick cost is the FFI call plus two casts."""
        ref = self._store_struct(store)
        return self._lib.tpumon_tsdb_rule_accum(
            len(slots), ts, _pf(val_q),
            ctypes.cast(slots.buffer_info()[0], _PI32),
            ref[0],
        )

    @staticmethod
    def _store_struct(store):
        """(byref, struct) for a RuleStore, cached on the store — its
        arrays only move on add_slot, which clears the cache."""
        ref = store._kptrs
        if ref is None:
            from tpumon_torch.query import RULE_SUB_BUCKETS

            st = RuleStoreStruct(
                sub=store.sub_s,
                nsub=RULE_SUB_BUCKETS,
                map_len=len(store.slot_map),
                slot_map=ctypes.cast(store.slot_map.buffer_info()[0], _PI32),
                hh=ctypes.cast(store.hh.buffer_info()[0], _PI32),
                open=_pd(store.open),
                hist=_pd(store.hist),
            )
            ref = store._kptrs = ctypes.byref(st), st  # keep st alive
        return ref

    def rule_accum_multi(self, ts: float, val_q: array, slots: array, ruleset) -> int:
        """EVERY registered rule's accumulation in one FFI round trip —
        the per-tick entry point (tpumon_torch.query.RuleSet.accum_batch).
        The struct-pointer vector is cached on the ruleset and rebuilt
        whenever any store's arrays moved."""
        vec = ruleset._kmulti
        if vec is None or any(r.store._kptrs is None for r in ruleset.rules):
            ptrs = [
                ctypes.pointer(self._store_struct(r.store)[1])
                for r in ruleset.rules
            ]
            vec = ruleset._kmulti = (
                (ctypes.POINTER(RuleStoreStruct) * len(ptrs))(*ptrs)
            )
        return self._lib.tpumon_tsdb_rule_accum_multi(
            len(slots), ts, _pf(val_q),
            ctypes.cast(slots.buffer_info()[0], _PI32),
            vec, len(vec),
        )

    def seal_encode(
        self, head_ts: array, head_val: array
    ) -> tuple[int, int, bytes]:
        """Encode the head columns into one sealed chunk; returns
        (first_ms, last_ms, chunk bytes) — byte-identical to
        tsdb.encode_chunk over the same head."""
        n = len(head_ts)
        cap = 16 + 15 * n
        buf = ctypes.create_string_buffer(cap)
        first = ctypes.c_int64()
        last = ctypes.c_int64()
        ln = self._lib.tpumon_tsdb_seal_encode(
            n, _pd(head_ts), _pf(head_val), buf, cap,
            ctypes.byref(first), ctypes.byref(last),
        )
        if ln < 0:  # pragma: no cover - cap is sized to make this impossible
            raise ValueError("seal encode overflow")
        return first.value, last.value, buf.raw[:ln]


def load_tsdb(auto_build: bool = True) -> TsdbKernel:
    """Load the TSDB ingest kernel. Raises RuntimeError saying why when
    it is unavailable (not built, the compiler failed, an ABI mismatch);
    the store then runs its bit-exact pure-Python path (tsdb.kernel
    keeps the reason for the sampler's health report)."""
    path = so_path("tsdb")
    if not path.exists():
        if not auto_build:
            raise RuntimeError(f"tsdb kernel not built ({path})")
        build_library("tsdb")
    try:
        lib = ctypes.CDLL(str(path))
        lib.tpumon_tsdbkern_abi_version.restype = ctypes.c_int
        abi = lib.tpumon_tsdbkern_abi_version()
        if abi != TSDB_ABI_VERSION:
            raise RuntimeError(
                f"tsdb kernel ABI {abi} != {TSDB_ABI_VERSION} ({path})")
        return TsdbKernel(lib)
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"tsdb kernel failed to load ({path}): {e}") from e
