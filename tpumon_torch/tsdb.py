"""Columnar time-series core: typed-array rings + compressed chunks.

The history layer used to keep every series as a deque of ``(ts, value)``
tuples — ~120 resident bytes per point (tuple header + two boxed floats
+ deque slot) and O(ring) Python-object churn on every window query. At
the 256-chip federation scale with per-chip series that is thousands of
series × thousands of points, and history became the slowest,
hungriest piece of the data plane once rendering was fast.

This module is the storage engine production TSDBs use, in pure stdlib
Python (no new deps):

- **Columnar head**: each tier appends into an ``array('d')`` timestamp
  column and an ``array('f')`` value column — 12 bytes/point, no boxed
  objects, C-speed appends.
- **Sealed chunks** (Gorilla, VLDB'15): once the head reaches
  ``seal_points`` it is sealed into one immutable ``bytes`` blob —
  timestamps as delta-of-delta zigzag varints (a steady cadence costs
  1 byte/point), values as float32-bit XOR-with-previous varints (a
  constant series costs 1 byte/point) — typically 2-6 bytes/point, an
  8-16x reduction over the tuple deque.
- **Tiered retention**: a series holds a fine tier (raw tick points)
  plus optional downsampled tiers (bucket means — mid ≈ 30 s, coarse ≈
  1-5 min), each its own ring. Downsampling is incremental at append
  time (running bucket sums, flushed on boundary crossing) — never at
  query time.
- **O(log n) window queries**: chunk time bounds are kept ordered, so a
  window query bisects to the first overlapping chunk and decodes only
  what it returns.

Timestamps are quantized to the millisecond on append — the same
precision the JSON snapshot format always rounded to — so a point reads
back identically whether it sits in the head or a sealed chunk. Values
are float32 (the column dtype); the render layer rounds to 2 decimals,
so the ~1e-7 relative quantization is invisible there.

The binary snapshot codec at the bottom writes sealed chunks verbatim
(no decode/encode, no JSON escaping) under a magic + version header —
the crash-safe history file (tpumon_torch.history.HistorySnapshotter) rides
it for ~10x cheaper writes and restores than the v1 full-JSON format.
"""

from __future__ import annotations

import json
import struct
from array import array
from bisect import bisect_left, bisect_right
from dataclasses import dataclass

# --------------------------- ingest kernel ----------------------------
#
# The write side has a native fast path (tpumon_torch/native/tsdbkern.cpp,
# bound in tpumon_torch.native.load_tsdb): batch quantization, downsample
# bucket accumulation and sealed-chunk encoding run as one C call per
# batch instead of interpreted per-point work. The kernel is stateless
# (all state stays in these Python objects) and the pure-Python code
# below is its bit-exact fallback — tests/test_ingest.py drives both
# over the same fuzz corpus and compares raw bytes. The switch is
# module-global (one process, one policy): config ``ingest_kernel``
# lands in set_kernel_enabled(). A kernel that does not build or load
# leaves kernel() returning None, and kernel_status() keeps the reason
# for the sampler's health report: it changes speed, never data, but
# it is not silent.

_KERNEL = None
_KERNEL_TRIED = False
_KERNEL_ENABLED = True
_KERNEL_ERROR: str | None = None


def set_kernel_enabled(on: bool) -> None:
    """Process-wide kernel policy (config ``ingest_kernel``); the pure
    Python path is always available and bit-exact, so flipping this is
    a pure performance decision."""
    global _KERNEL_ENABLED
    _KERNEL_ENABLED = bool(on)


def kernel():
    """The loaded native ingest kernel, or None (disabled / not built).
    Loading is lazy and attempted once per process."""
    global _KERNEL, _KERNEL_TRIED, _KERNEL_ERROR
    if not _KERNEL_ENABLED:
        return None
    if not _KERNEL_TRIED:
        _KERNEL_TRIED = True
        try:
            from tpumon_torch import native

            _KERNEL = native.load_tsdb(auto_build=True)
        except Exception as e:
            _KERNEL = None
            _KERNEL_ERROR = f"{type(e).__name__}: {e}"
    return _KERNEL


def kernel_status() -> dict:
    """Whether the ingest kernel is active, and why not when it failed
    to build or load (None when it loaded or was never tried)."""
    return {"active": kernel() is not None, "error": _KERNEL_ERROR}


# ----------------------------- varints --------------------------------


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if n < 0 else (n << 1)


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _put_uvarint(buf: bytearray, u: int) -> None:
    while u >= 0x80:
        buf.append((u & 0x7F) | 0x80)
        u >>= 7
    buf.append(u)


def _get_uvarint(data: bytes, i: int) -> tuple[int, int]:
    u = 0
    shift = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        b = data[i]
        i += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            return u, i
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow")


# --------------------------- chunk codec ------------------------------

_F32 = struct.Struct("<f")


def f32bits(v: float) -> int:
    """The value column's dtype: a float's 32-bit pattern (NaN-safe —
    the encoder is bit-exact, so NaN round-trips as NaN)."""
    return struct.unpack("<I", _F32.pack(v))[0]


def bits_to_f32(b: int) -> float:
    return _F32.unpack(struct.pack("<I", b))[0]


def encode_chunk(ts_ms: list[int], bits: list[int]) -> bytes:
    """Compress parallel (ms-timestamp, f32-bit-pattern) columns.

    Timestamps: first absolute (zigzag varint), then delta, then
    delta-of-delta — all zigzag varints, so irregular and even
    time-reversed inputs encode (just less tightly). Values: XOR with
    the previous bit pattern, as a plain uvarint — similar floats share
    sign/exponent/high-mantissa bits, so the XOR's high bits are zero
    and the varint drops them; a repeated value is one zero byte.
    """
    buf = bytearray()
    _put_uvarint(buf, len(ts_ms))
    prev_ts = 0
    prev_delta = 0
    prev_bits = 0
    for i, t in enumerate(ts_ms):
        if i == 0:
            _put_uvarint(buf, _zigzag(t))
            prev_ts = t
        else:
            delta = t - prev_ts
            _put_uvarint(buf, _zigzag(delta - prev_delta))
            prev_delta, prev_ts = delta, t
        b = bits[i]
        _put_uvarint(buf, b ^ prev_bits)
        prev_bits = b
    return bytes(buf)


def decode_chunk(data: bytes) -> tuple[list[int], list[int]]:
    """Inverse of encode_chunk; raises ValueError on truncation."""
    n, i = _get_uvarint(data, 0)
    ts_ms: list[int] = []
    bits: list[int] = []
    prev_ts = 0
    prev_delta = 0
    prev_bits = 0
    for k in range(n):
        u, i = _get_uvarint(data, i)
        if k == 0:
            prev_ts = _unzigzag(u)
        else:
            prev_delta += _unzigzag(u)
            prev_ts += prev_delta
        ts_ms.append(prev_ts)
        u, i = _get_uvarint(data, i)
        prev_bits ^= u
        bits.append(prev_bits)
    return ts_ms, bits


@dataclass
class Chunk:
    """One sealed, immutable, compressed run of points."""

    start_ms: int
    end_ms: int
    count: int
    data: bytes


# ------------------------------ tiers ---------------------------------

SEAL_POINTS = 256  # head size that triggers a seal (amortizes encode)


class Tier:
    """One bounded ring of (ts, value) points: sealed chunks + an open
    columnar head. Knows nothing about downsampling — a downsampled
    tier is just a Tier fed bucket means.
    """

    __slots__ = (
        "window_s", "seal_points", "chunks", "head_ts", "head_val",
        "_cutoff_ms", "_decoded", "_last_ts", "out_of_order", "_evict_due",
    )

    def __init__(self, window_s: float, seal_points: int = SEAL_POINTS):
        self.window_s = window_s
        self.seal_points = seal_points
        self.chunks: list[Chunk] = []
        self.head_ts = array("d")
        self.head_val = array("f")
        # High-water timestamp: append's ordering check must not cost a
        # chunk decode (the head is empty right after every seal).
        self._last_ts: float | None = None
        # Times the out-of-order sorted-rebuild slow path ran — a
        # misbehaving clock degrades append from O(1) to O(tier), which
        # must be visible (/api/health history stats), not silent.
        self.out_of_order = 0
        # Batch-path eviction pacing: the per-tick batch ingest loop
        # (tpumon_torch.history.RingHistory.record_batch) evicts a tier only
        # when ``now`` crosses this instead of per point — readers pass
        # explicit window starts, so the overhang is invisible to them
        # and bounded to window_s/16 of extra resident points.
        self._evict_due: float | None = None
        self._cutoff_ms = None  # logical eviction bound (ms) or None
        # Decode cache: {id(chunk): (ts_s list, val list)}. Sized to
        # hold a full window's worth of sealed chunks (a 30 min fine
        # tier at 1 Hz is ~8) so the steady-state query path — every
        # tick invalidates the render memo, every render re-reads the
        # window — pays decode once per SEAL, not once per query. Only
        # tiers actually being queried populate it, so the 1024
        # per-chip series cost nothing until someone drills in.
        self._decoded: dict[int, tuple[list[float], list[float]]] = {}

    # ------------------------------ write ------------------------------

    def append(self, ts: float, value: float) -> None:
        """Append a (quantized) point and maintain retention. Caller
        guarantees ms quantization (see quantize_ts). Appends are
        expected time-ordered (the sampler's are); an out-of-order
        point — restore paths seeding old data into a live tier —
        takes a slow sorted-rebuild path so queries keep their bisect
        invariant."""
        if self._last_ts is not None and ts < self._last_ts:
            self._insert_sorted(ts, value)
            return
        self._last_ts = ts
        self.head_ts.append(ts)
        self.head_val.append(value)
        if len(self.head_ts) >= self.seal_points:
            self.seal()
        self.evict(ts)

    def append_batch(self, ts_q: array, val_q: array) -> None:
        """Bulk append of pre-quantized, time-ordered columns (see
        quantize_batch — the caller checked ordering against last_ts).
        Bit-identical end state to appending the points one by one:
        seals trigger at exactly the same chunk boundaries, and the one
        trailing evict subsumes the per-point evicts it replaces (the
        final cutoff is the largest). The per-point cost collapses to
        an array-slice memcpy plus one encode per sealed chunk."""
        n = len(ts_q)
        if not n:
            return
        i = 0
        while i < n:
            room = self.seal_points - len(self.head_ts)
            if room <= 0:
                self.seal()
                continue
            take = room if room < n - i else n - i
            self.head_ts.extend(ts_q[i : i + take])
            self.head_val.extend(val_q[i : i + take])
            i += take
            if len(self.head_ts) >= self.seal_points:
                self.seal()
        self._last_ts = ts_q[n - 1]
        self.evict(self._last_ts)

    def _insert_sorted(self, ts: float, value: float) -> None:
        """Out-of-order insert: decode everything, insert at the sorted
        position, rebuild as one open head (future appends re-seal).
        O(tier) — fine for the restore paths that hit it, never the
        sampler's append path."""
        self.out_of_order += 1
        pts = self.since(None)
        i = bisect_right([t for t, _ in pts], ts)
        pts.insert(i, (ts, value))
        self.chunks.clear()
        self._decoded.clear()
        self._cutoff_ms = None
        self.head_ts = array("d", (t for t, _ in pts))
        self.head_val = array("f", (v for _, v in pts))
        self._last_ts = pts[-1][0]
        if len(self.head_ts) >= self.seal_points:
            self.seal()
        self.evict(pts[-1][0])

    def seal(self) -> None:
        if not self.head_ts:
            return
        k = kernel()
        if k is not None:
            first_ms, last_ms, data = k.seal_encode(self.head_ts, self.head_val)
            self.chunks.append(Chunk(first_ms, last_ms, len(self.head_ts), data))
        else:
            ts_ms = [int(round(t * 1000.0)) for t in self.head_ts]
            bits = [f32bits(v) for v in self.head_val]
            self.chunks.append(
                Chunk(ts_ms[0], ts_ms[-1], len(ts_ms), encode_chunk(ts_ms, bits))
            )
        del self.head_ts[:], self.head_val[:]

    def evict(self, now: float) -> None:
        """Retention: drop whole chunks that fell out of the window;
        trim the head exactly. A partially-expired oldest chunk stays
        resident but its expired points are masked by ``_cutoff_ms`` —
        readers never see them, and the memory overhang is bounded by
        one chunk."""
        cutoff = now - self.window_s
        cutoff_ms = int(round(cutoff * 1000.0))
        while self.chunks and self.chunks[0].end_ms < cutoff_ms:
            self._decoded.pop(id(self.chunks[0]), None)
            self.chunks.pop(0)
        if self.chunks:
            self._cutoff_ms = cutoff_ms if self.chunks[0].start_ms < cutoff_ms else None
        else:
            self._cutoff_ms = None
            k = bisect_left(self.head_ts, cutoff)
            if k:
                del self.head_ts[:k], self.head_val[:k]

    # ------------------------------ read -------------------------------

    def _chunk_points(self, c: Chunk) -> tuple[list[float], list[float]]:
        hit = self._decoded.get(id(c))
        if hit is not None:
            return hit
        ts_ms, bits = decode_chunk(c.data)
        out = ([t / 1000.0 for t in ts_ms], [bits_to_f32(b) for b in bits])
        if len(self._decoded) >= 12:
            self._decoded.pop(next(iter(self._decoded)))
        self._decoded[id(c)] = out
        return out

    def _start_bound(self, start: float | None) -> float:
        lo = self._cutoff_ms / 1000.0 if self._cutoff_ms is not None else None
        if start is None:
            return lo if lo is not None else float("-inf")
        return start if lo is None or start >= lo else lo

    def since(self, start: float | None) -> list[tuple[float, float]]:
        """Points with ts >= start, oldest first — O(log chunks +
        matched): bisect to the first overlapping chunk, decode from
        there, bisect within it."""
        start = self._start_bound(start)
        out: list[tuple[float, float]] = []
        if self.chunks:
            start_ms = int(round(start * 1000.0)) if start > float("-inf") else None
            first = 0
            if start_ms is not None:
                ends = [c.end_ms for c in self.chunks]
                first = bisect_left(ends, start_ms)
            for ci in range(first, len(self.chunks)):
                ts, vals = self._chunk_points(self.chunks[ci])
                k = bisect_left(ts, start) if ci == first else 0
                out.extend(zip(ts[k:], vals[k:]))
        k = bisect_left(self.head_ts, start) if start > float("-inf") else 0
        out.extend(zip(self.head_ts[k:], self.head_val[k:]))
        return out

    def dump(self) -> list[tuple[float, float]]:
        """All live points, decoded WITHOUT populating the decode cache
        — the bulk-dump path (tpumon_torch.state's JSON checkpoint walks every
        series every save) must not pin boxed-float lists for chunks no
        query is reading, or it would resurrect the deque-era resident
        memory this store exists to eliminate."""
        lo = self._start_bound(None)
        out: list[tuple[float, float]] = []
        for i, c in enumerate(self.chunks):
            cached = self._decoded.get(id(c))
            if cached is not None:
                ts, vals = cached
            else:
                ts_ms, bits = decode_chunk(c.data)
                ts = [t / 1000.0 for t in ts_ms]
                vals = [bits_to_f32(b) for b in bits]
            k = bisect_left(ts, lo) if i == 0 and lo > float("-inf") else 0
            out.extend(zip(ts[k:], vals[k:]))
        out.extend(zip(self.head_ts, self.head_val))
        return out

    def last(self) -> tuple[float, float] | None:
        if self.head_ts:
            return self.head_ts[-1], self.head_val[-1]
        if self.chunks:
            ts, vals = self._chunk_points(self.chunks[-1])
            return ts[-1], vals[-1]
        return None

    def last_ts(self) -> float | None:
        """Newest timestamp without any decode (timestamp-only callers
        — resample's end derivation — must stay cache-neutral)."""
        return self._last_ts

    def sync_last(self) -> None:
        """Recompute the high-water timestamp from resident data (the
        snapshot-adopt path fills chunks/head directly)."""
        if self.head_ts:
            self._last_ts = self.head_ts[-1]
        elif self.chunks:
            self._last_ts = self.chunks[-1].end_ms / 1000.0
        else:
            self._last_ts = None

    def first(self) -> tuple[float, float] | None:
        lo = self._start_bound(None)
        if self.chunks:
            ts, vals = self._chunk_points(self.chunks[0])
            k = bisect_left(ts, lo)
            if k < len(ts):
                return ts[k], vals[k]
            # fully-masked first chunk: fall through to the next data
            rest = self.since(lo)
            return rest[0] if rest else None
        if self.head_ts:
            return self.head_ts[0], self.head_val[0]
        return None

    def __len__(self) -> int:
        n = len(self.head_ts) + sum(c.count for c in self.chunks)
        if self._cutoff_ms is not None and self.chunks:
            ts, _ = self._chunk_points(self.chunks[0])
            n -= bisect_left(ts, self._cutoff_ms / 1000.0)
        return n

    def approx_len(self) -> int:
        """Resident point count ignoring the partial-first-chunk mask —
        O(chunks), no decode; the health/stats path at 1000+ series."""
        return len(self.head_ts) + sum(c.count for c in self.chunks)

    def resident_bytes(self) -> int:
        return (
            sum(len(c.data) + 64 for c in self.chunks)
            + self.head_ts.itemsize * len(self.head_ts)
            + self.head_val.itemsize * len(self.head_val)
        )


def quantize_ts(ts: float) -> float:
    """Millisecond quantization applied on every write — identical to
    the precision the v1 JSON snapshots rounded to, and what makes a
    point bit-stable across head/sealed representations."""
    return round(ts * 1000.0) / 1000.0


def quantize_val(v: float) -> float:
    """The value column is float32; quantize through it so a value
    compares equal before and after a seal."""
    return _F32.unpack(_F32.pack(v))[0]


def quantize_batch(
    ts_list, values, last_ts: float | None
) -> tuple[array, array, bool]:
    """Quantize a batch of raw (ts, value) columns in one step:
    timestamps onto the ms grid, values through float32 — plus the
    in-order check against ``last_ts`` (the tier's high water). Returns
    (ts_q, val_q, ordered); an unordered batch is handed back for the
    caller's per-point slow path. One C call when the kernel is loaded;
    the Python fallback leans on array('f')'s C-speed float32 casts."""
    k = kernel()
    if k is not None:
        tsa = ts_list if isinstance(ts_list, array) else array("d", ts_list)
        va = values if isinstance(values, array) else array("d", values)
        return k.quantize(tsa, va, last_ts)
    ts_q = array("d", [round(t * 1000.0) / 1000.0 for t in ts_list])
    val_q = array("f", values)
    ordered = True
    prev = last_ts
    for t in ts_q:
        if prev is not None and t < prev:
            ordered = False
            break
        prev = t
    return ts_q, val_q, ordered


# ----------------------------- views ----------------------------------


class PointsView:
    """Deque-compatible view over a Tier: the ``points`` / ``coarse``
    attributes history consumers (and tests) index, iterate and extend
    keep working unchanged over the columnar storage. Reads are
    decoded on demand (``[0]``/``[-1]`` without a full decode); writes
    go straight into the tier (the restore paths) and report through
    ``on_write`` so version counters stay honest."""

    __slots__ = ("_tier", "_on_write")

    def __init__(self, tier: "Tier", on_write=None):
        self._tier = tier
        self._on_write = on_write

    def _all(self) -> list[tuple[float, float]]:
        return self._tier.since(None)

    def __len__(self) -> int:
        return len(self._tier)

    def __bool__(self) -> bool:
        return bool(self._tier.head_ts) or len(self._tier) > 0

    def __iter__(self):
        return iter(self._all())

    def __reversed__(self):
        return reversed(self._all())

    def __getitem__(self, i):
        if isinstance(i, int):
            p = None
            if i == 0:
                p = self._tier.first()
            elif i == -1:
                p = self._tier.last()
            if p is not None:
                return p
            pts = self._all()
            return pts[i]
        return self._all()[i]

    def append(self, point) -> None:
        ts, v = point
        self._tier.append(quantize_ts(float(ts)), quantize_val(float(v)))
        if self._on_write is not None:
            self._on_write()

    def extend(self, points) -> None:
        for p in points:
            self.append(p)


# --------------------------- series core ------------------------------


class Downsample:
    """One downsampled tier: a Tier of bucket means plus the running
    accumulator for the open bucket (incremental — never query-time)."""

    __slots__ = ("step_s", "tier", "bucket", "bsum", "bn")

    def __init__(self, step_s: float, window_s: float):
        self.step_s = step_s
        self.tier = Tier(window_s)
        self.bucket: int | None = None
        self.bsum = 0.0
        self.bn = 0

    def observe(self, ts: float, value: float) -> None:
        b = int(ts // self.step_s)
        if self.bucket is not None and b != self.bucket:
            self.flush()
        self.bucket = b
        self.bsum += value
        self.bn += 1
        self.tier.evict(ts)

    def observe_batch(self, ts_q: array, val_q: array) -> None:
        """Accumulate an ordered, quantized batch: bucket sums advance
        per point (same add order as observe — bit-exact), but closed
        buckets are collected and appended in one pass and the tier is
        evicted once at the end instead of per point. One C call when
        the kernel is loaded."""
        n = len(ts_q)
        if not n:
            return
        k = kernel()
        if k is not None:
            flushes = k.accum(ts_q, val_q, self.step_s, self)
        else:
            flushes = []
            step = self.step_s
            bucket, bsum, bn = self.bucket, self.bsum, self.bn
            for i in range(n):
                b = int(ts_q[i] // step)
                if bucket is not None and b != bucket:
                    if bn:
                        flushes.append(
                            (quantize_ts((bucket + 0.5) * step), bsum / bn)
                        )
                    bsum, bn = 0.0, 0
                bucket = b
                bsum += val_q[i]
                bn += 1
            self.bucket, self.bsum, self.bn = bucket, bsum, bn
        for fts, fmean in flushes:
            self.tier.append(fts, quantize_val(fmean))
        self.tier.evict(ts_q[-1])

    def flush(self) -> None:
        if self.bucket is not None and self.bn:
            mid = quantize_ts((self.bucket + 0.5) * self.step_s)
            self.tier.append(mid, quantize_val(self.bsum / self.bn))
        self.bsum, self.bn = 0.0, 0

    def live_point(self) -> tuple[float, float] | None:
        """The open bucket's mean-so-far (not yet flushed)."""
        if self.bucket is None or not self.bn:
            return None
        return quantize_ts((self.bucket + 0.5) * self.step_s), self.bsum / self.bn


class AccumStore:
    """Contiguous (bucket, bsum, bn) columns for a family of same-step
    downsample accumulators — the layout the native ``accum_many``
    kernel updates in ONE call per tick for every per-chip series at
    once (tpumon_torch.history.RingHistory.record_batch). ``bucket`` uses NaN
    for "no open bucket"; ``bn`` rides as float64 (counts are tiny, and
    Python's ``bsum / int(bn)`` and C's ``bsum / (double)bn`` divide the
    same doubles either way)."""

    __slots__ = ("step_s", "bucket", "bsum", "bn")

    def __init__(self, step_s: float):
        self.step_s = step_s
        self.bucket = array("d")
        self.bsum = array("d")
        self.bn = array("d")

    def add_slot(self) -> int:
        self.bucket.append(float("nan"))
        self.bsum.append(0.0)
        self.bn.append(0.0)
        return len(self.bucket) - 1

    def __len__(self) -> int:
        return len(self.bucket)


class SlotDownsample(Downsample):
    """A Downsample whose accumulator state lives in an AccumStore slot:
    ``bucket``/``bsum``/``bn`` become views over the store's columns so
    the batch kernel can update thousands of accumulators in one call,
    while every existing consumer (observe, flush, live_point, the
    snapshot codec, tests poking attributes) keeps working unchanged —
    only the storage moved."""

    __slots__ = ("_store", "_slot")

    def __init__(self, store: AccumStore, slot: int, window_s: float):
        # Deliberately NOT calling Downsample.__init__: the accumulator
        # writes it does would route through the properties below before
        # _store is bound.
        self._store = store
        self._slot = slot
        self.step_s = store.step_s
        self.tier = Tier(window_s)

    @property
    def bucket(self) -> int | None:
        b = self._store.bucket[self._slot]
        return None if b != b else int(b)

    @bucket.setter
    def bucket(self, v) -> None:
        self._store.bucket[self._slot] = float("nan") if v is None else float(v)

    @property
    def bsum(self) -> float:
        return self._store.bsum[self._slot]

    @bsum.setter
    def bsum(self, v: float) -> None:
        self._store.bsum[self._slot] = v

    @property
    def bn(self) -> int:
        return int(self._store.bn[self._slot])

    @bn.setter
    def bn(self, v: int) -> None:
        self._store.bn[self._slot] = float(v)


# Minimum batch size for the native accum_many path: the kernel call's
# fixed cost (three flush-buffer allocations + six pointer casts + the
# FFI round trip, ~13 µs measured) crosses the pure-Python loop
# (~0.4 µs/series) near 32 series. Below it — e.g. the SLO engine's
# per-tick slo.<name>.bad append, a handful of series — the fallback is
# strictly faster; both paths are bit-exact (tests/test_ingest.py), so
# the switch is invisible to state.
ACCUM_KERNEL_MIN = 32


def accum_many(
    ts_q: float, val_q: array, slots: array, store: AccumStore
) -> list[tuple[int, float, float]]:
    """One point per series at a shared quantized timestamp, accumulated
    into ``store``'s columns; returns closed buckets as (slot, mid_ts,
    raw mean) — the multi-series mirror of Downsample.observe_batch.
    One C call when the kernel is loaded and the batch is large enough
    to amortize the call (ACCUM_KERNEL_MIN)."""
    k = kernel()
    if k is not None and len(slots) >= ACCUM_KERNEL_MIN:
        return k.accum_many(ts_q, val_q, slots, store)
    step = store.step_s
    bnew = int(ts_q // step)
    bnew_f = float(bnew)
    bucket_col, bsum_col, bn_col = store.bucket, store.bsum, store.bn
    flushes: list[tuple[int, float, float]] = []
    for i, s in enumerate(slots):
        b = bucket_col[s]
        if b == b and b != bnew_f:
            if bn_col[s]:
                flushes.append(
                    (s, quantize_ts((b + 0.5) * step), bsum_col[s] / bn_col[s])
                )
            bsum_col[s] = 0.0
            bn_col[s] = 0.0
        bucket_col[s] = bnew_f
        bsum_col[s] += val_q[i]
        bn_col[s] += 1.0
    return flushes


def merged(
    fine: Tier, down: list[Downsample], window_s: float, end: float
) -> list[tuple[float, float]]:
    """Points covering [end - window_s, end] across tiers: each coarser
    tier fills only the span older than all finer data (finer data
    wins), output time-ordered coarsest→finest. Unflushed live buckets
    are included exactly when they predate the finer tier's data — the
    newest downsampled value must not vanish just because its bucket
    hasn't closed."""
    start = end - window_s
    fine_pts = fine.since(start)
    bound = fine_pts[0][0] if fine_pts else float("inf")
    parts: list[list[tuple[float, float]]] = []
    for d in down:  # finest downsample first
        pts = [p for p in d.tier.since(start) if p[0] < bound]
        live = d.live_point()
        if live is not None and start <= live[0] < bound:
            pts.append(live)
        if pts:
            bound = pts[0][0]
            parts.append(pts)
    out: list[tuple[float, float]] = []
    for pts in reversed(parts):  # coarsest first in the output
        out.extend(pts)
    out.extend(fine_pts)
    return out


# ----------------------- binary snapshot codec ------------------------

MAGIC = b"TPUHIST\x02"
SNAPSHOT_VERSION = 2


def dump_snapshot(series: dict[str, object], saved_at: float) -> bytes:
    """Serialize a series map: magic + u32 index length + JSON index +
    raw payload. Sealed chunk bytes are written **verbatim** (already
    compressed); heads ride as raw array bytes — no per-point work at
    all, which is where the ~10x over json.dumps comes from."""
    index: dict = {"version": SNAPSHOT_VERSION, "saved_at": saved_at, "series": []}
    payload = bytearray()

    def emit_tier(t: Tier) -> dict:
        chunks = []
        for c in t.chunks:
            chunks.append([c.start_ms, c.end_ms, c.count, len(c.data)])
            payload.extend(c.data)
        head_n = len(t.head_ts)
        payload.extend(t.head_ts.tobytes())
        payload.extend(t.head_val.tobytes())
        return {"window_s": t.window_s, "chunks": chunks, "head_n": head_n}

    for name, s in series.items():
        entry: dict = {"name": name, "fine": emit_tier(s.fine), "down": []}
        for d in s.down:
            entry["down"].append(
                {
                    "step_s": d.step_s,
                    "tier": emit_tier(d.tier),
                    "bucket": d.bucket,
                    "bsum": d.bsum,
                    "bn": d.bn,
                }
            )
        index["series"].append(entry)
    index_json = json.dumps(index, separators=(",", ":")).encode()
    return MAGIC + struct.pack("<I", len(index_json)) + index_json + bytes(payload)


def load_snapshot(data: bytes) -> tuple[float, list[dict]]:
    """Parse a dump_snapshot blob back into plain structures WITHOUT
    touching any live ring — callers adopt the result only after the
    whole parse succeeded. Returns (saved_at, series dumps), where each
    dump is {"name", "fine": tier_dump, "down": [...]} and a tier dump
    is {"window_s", "chunks": [Chunk...], "head_ts": array('d'),
    "head_val": array('f')}.

    Raises ValueError on any truncation/corruption — every length is
    bounds-checked before use, and chunk payloads are verified to
    decode to their declared count (a torn tail can't smuggle garbage
    into a ring)."""
    if data[: len(MAGIC)] != MAGIC:
        raise ValueError("bad magic (not a tpumon binary history snapshot)")
    off = len(MAGIC)
    if len(data) < off + 4:
        raise ValueError("truncated index length")
    (index_len,) = struct.unpack_from("<I", data, off)
    off += 4
    if len(data) < off + index_len:
        raise ValueError("truncated index")
    try:
        index = json.loads(data[off : off + index_len])
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupt index: {e}")
    off += index_len
    if not isinstance(index, dict) or index.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot version {index.get('version')!r}")
    saved_at = index.get("saved_at")
    if not isinstance(saved_at, (int, float)):
        raise ValueError("missing saved_at")

    def read_tier(meta: dict) -> tuple[dict, int]:
        nonlocal off
        chunks: list[Chunk] = []
        for start_ms, end_ms, count, blen in meta["chunks"]:
            if len(data) < off + blen:
                raise ValueError("truncated chunk payload")
            blob = data[off : off + blen]
            off += blen
            ts_ms, _bits = decode_chunk(blob)  # validates
            if len(ts_ms) != count:
                raise ValueError("chunk count mismatch")
            chunks.append(Chunk(int(start_ms), int(end_ms), int(count), blob))
        head_n = int(meta["head_n"])
        need = head_n * (8 + 4)
        if len(data) < off + need:
            raise ValueError("truncated head columns")
        head_ts = array("d")
        head_ts.frombytes(data[off : off + head_n * 8])
        off += head_n * 8
        head_val = array("f")
        head_val.frombytes(data[off : off + head_n * 4])
        off += head_n * 4
        return (
            {
                "window_s": float(meta["window_s"]),
                "chunks": chunks,
                "head_ts": head_ts,
                "head_val": head_val,
            },
            head_n,
        )

    out: list[dict] = []
    try:
        for entry in index["series"]:
            fine, _ = read_tier(entry["fine"])
            down = []
            for dmeta in entry.get("down") or []:
                tier, _ = read_tier(dmeta["tier"])
                down.append(
                    {
                        "step_s": float(dmeta["step_s"]),
                        "tier": tier,
                        "bucket": dmeta.get("bucket"),
                        "bsum": float(dmeta.get("bsum") or 0.0),
                        "bn": int(dmeta.get("bn") or 0),
                    }
                )
            out.append({"name": str(entry["name"]), "fine": fine, "down": down})
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError(f"malformed snapshot index: {e}")
    return float(saved_at), out


def tier_points(dump: dict) -> list[tuple[float, float]]:
    """Decode a load_snapshot tier dump to plain points (the fallback
    path when the live ring's tier geometry doesn't match the file's —
    points are replayed through record() instead of adopted)."""
    out: list[tuple[float, float]] = []
    for c in dump["chunks"]:
        ts_ms, bits = decode_chunk(c.data)
        out.extend((t / 1000.0, bits_to_f32(b)) for t, b in zip(ts_ms, bits))
    out.extend(zip(dump["head_ts"], dump["head_val"]))
    return out
