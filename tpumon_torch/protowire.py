"""Minimal protobuf wire-format codec (no generated stubs, no deps), and
the monitor's columnar wire frames (a copy of ``tpumon/protowire.py``).

The generic codec backs the JAX package's libtpu runtime-metrics client;
the port has no libtpu, but keeps the codec because the frames below are
built from it. The frames carry the chip table between monitors:
``/api/accel/wire`` (``Accept: application/x-tpumon-wire``), the peer
collector (``tpumon_torch.collectors.accel_peers``), and the federation
tree's delta stream, query and trace messages
(``tpumon_torch.federation``). Every encoder gives the reference's bytes.

Wire format (https://protobuf.dev/programming-guides/encoding/):
  tag = (field_number << 3) | wire_type
  wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32
"""

from __future__ import annotations

import struct
from typing import Any

WT_VARINT = 0
WT_FIXED64 = 1
WT_LEN = 2
WT_FIXED32 = 5


def encode_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # two's-complement for negative int64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def encode_tag(field: int, wire_type: int) -> bytes:
    return encode_varint((field << 3) | wire_type)


def encode_string(field: int, value: str) -> bytes:
    raw = value.encode("utf-8")
    return encode_tag(field, WT_LEN) + encode_varint(len(raw)) + raw


def encode_message(field: int, payload: bytes) -> bytes:
    return encode_tag(field, WT_LEN) + encode_varint(len(payload)) + payload


def encode_int(field: int, value: int) -> bytes:
    return encode_tag(field, WT_VARINT) + encode_varint(value)


def encode_double(field: int, value: float) -> bytes:
    return encode_tag(field, WT_FIXED64) + struct.pack("<d", value)


class Field:
    """One decoded field occurrence."""

    __slots__ = ("number", "wire_type", "value")

    def __init__(self, number: int, wire_type: int, value: Any):
        self.number = number
        self.wire_type = wire_type
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Field({self.number}, wt={self.wire_type}, {self.value!r})"


class Message:
    """A decoded message: ordered list of Fields, with helpers."""

    __slots__ = ("fields",)

    def __init__(self, fields: list[Field]):
        self.fields = fields

    def all(self, number: int) -> list[Any]:
        return [f.value for f in self.fields if f.number == number]

    def first(self, number: int, default: Any = None) -> Any:
        for f in self.fields:
            if f.number == number:
                return f.value
        return default

    def walk(self):
        """Yield every Field in the tree, depth-first."""
        for f in self.fields:
            yield f
            if isinstance(f.value, Message):
                yield from f.value.walk()


def _try_decode_submessage(raw: bytes) -> Message | None:
    if not raw:
        return None
    try:
        return decode_message(raw)
    except ValueError:
        return None


# ---------------------- columnar wire frames ---------------------------
#
# Binary representation of the federation chip snapshot
# (tpumon_torch.topology.chips_to_wire's {"v", "fields", "rows"}), negotiated
# by Accept header on /api/accel/wire (tpumon_torch.server) — JSON stays the
# default so pre-binary peers keep federating. Layout is COLUMNAR and
# built for DECODE speed: homogeneous numeric columns ride as packed
# little-endian f64/i64 blocks and string/int-list columns as
# dictionary/fixed-stride blocks, so the decoder reads whole columns
# through array.frombytes (C speed) instead of a value-at-a-time parse
# — that is what lets the peer path beat json.loads while also shipping
# ~40% fewer bytes (strings dict-coded, ints 8B instead of digit runs).
#
#   TPWF <u8 frame-version>
#   varint wire-version (topology.WIRE_VERSION — the schema contract)
#   varint ncols; per col: varint len + utf-8 name
#   varint nrows
#   per col: u8 ctype + payload
#
# Nullable numeric columns carry a presence bitmap (bit i set = row i
# non-null) followed by the packed non-null values.

WIRE_FRAME_MAGIC = b"TPWF"
WIRE_FRAME_VERSION = 1
WIRE_FRAME_CTYPE = "application/x-tpumon-wire"

_CT_NONE = 0  # every value None; no payload
_CT_F64 = 1  # bitmap + packed <f64 (mixed int/float rides here too)
_CT_I64 = 2  # bitmap + packed <i64 (exact for every int64)
_CT_VARINT = 3  # bitmap + zigzag varints (ints beyond int64)
_CT_STR = 4  # dict: nuniq + strings, then <u16 indices (0=None)
_CT_BOOL = 5  # per-row byte: 0=None 1=False 2=True
_CT_INTLIST_FIXED = 6  # varint m + bitmap + packed <i32 (m per non-null row)
_CT_INTLIST = 7  # per-row varint (0=None else m+1) + m zigzag varints
# Half-width floats for exactly-f32-representable columns (bitmap +
# packed <f32 — lossless by construction). OPT-IN (allow_f32): only the
# delta stream emits it — /api/accel/wire keeps the original ctype set
# so pre-F32 peers never see an unknown column type. Decoders always
# accept it.
_CT_F32 = 8
# Delta-frame-only flag on the per-column ctype byte: an i64 sub-column
# coded as zigzag-varint DIFFS against the decoder's previous values at
# those rows (cumulative ICI counters move ~2e9/tick — 5 varint bytes
# instead of 8 fixed). Never valid in a full frame.
_CTF_I64_DELTA = 0x80

_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1
_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _zigzag64(n: int) -> int:
    # Arbitrary-precision zigzag. For int64-range values this is
    # bit-identical to the classic (n << 1) ^ (n >> 63); the int64
    # shift, however, silently corrupts negatives BEYOND int64 — the
    # very values _CT_VARINT exists to carry (caught by the tpulint
    # wire pass's exhaustive ctype truncation test).
    return (n << 1) if n >= 0 else ((-n) << 1) - 1


def _unzigzag64(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _null_bitmap(col: list) -> bytes:
    bm = bytearray((len(col) + 7) // 8)
    for i, v in enumerate(col):
        if v is not None:
            bm[i >> 3] |= 1 << (i & 7)
    return bytes(bm)


def _f32_exact(v: float) -> bool:
    return struct.unpack("<f", struct.pack("<f", v))[0] == v


def _classify(col: list, allow_f32: bool = False) -> int:
    saw_float = saw_int = saw_big = False
    f32_ok = True
    intlist_m = None
    intlist_ok = saw_list = False
    for v in col:
        if v is None:
            continue
        if isinstance(v, bool):
            return _CT_BOOL
        if isinstance(v, int):
            saw_int = True
            if not _I64_MIN <= v <= _I64_MAX:
                saw_big = True
        elif isinstance(v, float):
            saw_float = True
            if f32_ok and not _f32_exact(v):
                f32_ok = False
        elif isinstance(v, str):
            return _CT_STR
        elif isinstance(v, (list, tuple)):
            saw_list = True
            if intlist_m is None:
                intlist_m = len(v)
                intlist_ok = True
            if intlist_ok and (
                len(v) != intlist_m
                or not all(
                    isinstance(n, int) and _I32_MIN <= n <= _I32_MAX for n in v
                )
            ):
                intlist_ok = False
        else:
            raise ValueError(f"unencodable wire value {v!r}")
    if saw_list:
        return _CT_INTLIST_FIXED if intlist_ok and intlist_m else _CT_INTLIST
    if saw_float:
        # Pure-float f32-exact columns halve to <f32 when the caller
        # opted in (losslessly — exactness was just proven per value).
        if allow_f32 and not saw_int and f32_ok:
            return _CT_F32
        # Mixed int/float columns ride as f64 (the ints come back
        # float-typed — numerically equal, which is what the federation
        # merge compares); only a mix of floats and >2**53 ints would
        # lose precision, and no wire field produces one.
        return _CT_F64
    if saw_int:
        return _CT_VARINT if saw_big else _CT_I64
    return _CT_NONE


def _encode_col(out: bytearray, col: list, ctype: int) -> None:
    """Append one column's payload under an already-chosen ``ctype``.
    Shared by full frames and delta sub-columns — the delta path
    encodes a changed-rows subset under the FULL column's ctype, so a
    replayed cell is byte-identical to the same cell in a full frame."""
    if ctype == _CT_NONE:
        return
    if ctype == _CT_F64:
        present = [float(x) for x in col if x is not None]
        out += _null_bitmap(col)
        out += struct.pack(f"<{len(present)}d", *present)
    elif ctype == _CT_F32:
        present = [float(x) for x in col if x is not None]
        out += _null_bitmap(col)
        out += struct.pack(f"<{len(present)}f", *present)
    elif ctype == _CT_I64:
        present = [x for x in col if x is not None]
        out += _null_bitmap(col)
        out += struct.pack(f"<{len(present)}q", *present)
    elif ctype == _CT_VARINT:
        out += _null_bitmap(col)
        for x in col:
            if x is not None:
                out += encode_varint(_zigzag64(x))
    elif ctype == _CT_STR:
        uniq: dict[str, int] = {}
        for x in col:
            if x is not None and x not in uniq:
                uniq[x] = len(uniq)
        if len(uniq) > 0xFFFE:
            raise ValueError("string dictionary overflow")
        out += encode_varint(len(uniq))
        for s in uniq:
            raw = s.encode("utf-8")
            out += encode_varint(len(raw)) + raw
        out += struct.pack(
            f"<{len(col)}H",
            *(0 if x is None else uniq[x] + 1 for x in col),
        )
    elif ctype == _CT_BOOL:
        out += bytes(0 if x is None else (2 if x else 1) for x in col)
    elif ctype == _CT_INTLIST_FIXED:
        flat: list[int] = []
        m = 0
        for x in col:
            if x is not None:
                m = len(x)
                flat.extend(x)
        out += encode_varint(m)
        out += _null_bitmap(col)
        out += struct.pack(f"<{len(flat)}i", *flat)
    elif ctype == _CT_INTLIST:
        for x in col:
            if x is None:
                out += encode_varint(0)
            else:
                out += encode_varint(len(x) + 1)
                for n in x:
                    out += encode_varint(_zigzag64(int(n)))
    else:
        raise ValueError(f"unknown wire column type {ctype}")


def encode_wire_frame(
    v: int, fields: list[str], rows: list[list], allow_f32: bool = False
) -> bytes:
    """Serialize a chips_to_wire payload as a columnar binary frame.

    ``allow_f32`` opts in to the half-width float column type — the
    delta stream uses it; /api/accel/wire keeps the default so frames
    served to pre-F32 peers never contain a ctype they can't decode."""
    out = bytearray(WIRE_FRAME_MAGIC)
    out.append(WIRE_FRAME_VERSION)
    out += encode_varint(v)
    out += encode_varint(len(fields))
    for name in fields:
        raw = name.encode("utf-8")
        out += encode_varint(len(raw)) + raw
    out += encode_varint(len(rows))
    for ci in range(len(fields)):
        col = [row[ci] for row in rows]
        ctype = _classify(col, allow_f32=allow_f32)
        out.append(ctype)
        _encode_col(out, col, ctype)
    return bytes(out)


def _weave(vals, bm: bytes, nrows: int) -> list:
    """Spread packed non-null values back over a presence bitmap."""
    it = iter(vals)
    return [
        next(it) if bm[i >> 3] & (1 << (i & 7)) else None for i in range(nrows)
    ]


def _packed(blob: bytes, pos: int, nrows: int, fmt: str, size: int):
    """Read a bitmap'd packed numeric column; returns (values, pos).
    The no-nulls common case is one struct.unpack (C speed)."""
    nbm = (nrows + 7) // 8
    bm = blob[pos : pos + nbm]
    if len(bm) < nbm:
        raise ValueError("truncated null bitmap")
    pos += nbm
    k = sum(_POPCOUNT[b] for b in bm)
    if pos + size * k > len(blob):
        raise ValueError("truncated packed column")
    vals = struct.unpack_from(f"<{k}{fmt}", blob, pos)
    pos += size * k
    if k == nrows:
        return list(vals), pos
    return _weave(vals, bm, nrows), pos


_POPCOUNT = [bin(i).count("1") for i in range(256)]


def _decode_col(blob: bytes, pos: int, nrows: int, ctype: int) -> tuple[list, int]:
    """Decode one column payload of ``nrows`` values under ``ctype``;
    returns (values, new pos). Shared by full frames and delta
    sub-columns. Raises ValueError on anything malformed/truncated."""
    if ctype == _CT_NONE:
        return [None] * nrows, pos
    if ctype == _CT_F64:
        return _packed(blob, pos, nrows, "d", 8)
    if ctype == _CT_F32:
        return _packed(blob, pos, nrows, "f", 4)
    if ctype == _CT_I64:
        return _packed(blob, pos, nrows, "q", 8)
    if ctype == _CT_VARINT:
        nbm = (nrows + 7) // 8
        bm = blob[pos : pos + nbm]
        if len(bm) < nbm:
            raise ValueError("truncated null bitmap")
        pos += nbm
        col: list = []
        for i in range(nrows):
            if bm[i >> 3] & (1 << (i & 7)):
                u, pos = decode_varint(blob, pos)
                col.append(_unzigzag64(u))
            else:
                col.append(None)
        return col, pos
    if ctype == _CT_STR:
        nuniq, pos = decode_varint(blob, pos)
        if nuniq > 0xFFFE:
            raise ValueError("implausible string dictionary")
        # Index 0 = None, i+1 = uniq[i]: prepending None makes the
        # per-row step one list index over the C-decoded u16 block.
        uniq: list = [None]
        for _ in range(nuniq):
            ln, pos = decode_varint(blob, pos)
            if pos + ln > len(blob):
                raise ValueError("truncated string")
            uniq.append(blob[pos : pos + ln].decode("utf-8"))
            pos += ln
        if pos + 2 * nrows > len(blob):
            raise ValueError("truncated string indices")
        idx = struct.unpack_from(f"<{nrows}H", blob, pos)
        pos += 2 * nrows
        try:
            return [uniq[i] for i in idx], pos
        except IndexError:
            raise ValueError("string index out of range")
    if ctype == _CT_BOOL:
        if pos + nrows > len(blob):
            raise ValueError("truncated bool column")
        seg = blob[pos : pos + nrows]
        pos += nrows
        return [None if b == 0 else b == 2 for b in seg], pos
    if ctype == _CT_INTLIST_FIXED:
        m, pos = decode_varint(blob, pos)
        if not 0 < m <= 64:
            raise ValueError("implausible int-list stride")
        nbm = (nrows + 7) // 8
        bm = blob[pos : pos + nbm]
        if len(bm) < nbm:
            raise ValueError("truncated null bitmap")
        pos += nbm
        k = sum(_POPCOUNT[b] for b in bm)
        if pos + 4 * m * k > len(blob):
            raise ValueError("truncated int-list column")
        flat = struct.unpack_from(f"<{m * k}i", blob, pos)
        pos += 4 * m * k
        lists = [list(flat[i : i + m]) for i in range(0, m * k, m)]
        if k == nrows:
            return lists, pos
        return _weave(lists, bm, nrows), pos
    if ctype == _CT_INTLIST:
        # Ragged/oversized int lists — the rare fallback when
        # _CT_INTLIST_FIXED's uniform stride doesn't hold, so plain
        # varint calls are fine here.
        col = []
        for _ in range(nrows):
            m, pos = decode_varint(blob, pos)
            if m == 0:
                col.append(None)
            else:
                xs: list = []
                for _ in range(m - 1):
                    u, pos = decode_varint(blob, pos)
                    xs.append(_unzigzag64(u))
                col.append(xs)
        return col, pos
    raise ValueError(f"unknown wire column type {ctype}")


def decode_wire_frame(blob: bytes) -> tuple[int, list[str], list[list]]:
    """Inverse of encode_wire_frame: (wire version, fields, per-field
    value columns). Raises ValueError on anything malformed/truncated —
    the peer collector treats that like an incompatible wire version and
    falls back to JSON."""
    if blob[: len(WIRE_FRAME_MAGIC)] != WIRE_FRAME_MAGIC:
        raise ValueError("bad wire frame magic")
    if len(blob) < 5:
        raise ValueError("truncated wire frame header")
    if blob[4] != WIRE_FRAME_VERSION:
        raise ValueError(f"unsupported wire frame version {blob[4]}")
    pos = 5
    v, pos = decode_varint(blob, pos)
    ncols, pos = decode_varint(blob, pos)
    if ncols > 4096:
        raise ValueError("implausible column count")
    fields: list[str] = []
    for _ in range(ncols):
        ln, pos = decode_varint(blob, pos)
        if pos + ln > len(blob):
            raise ValueError("truncated field name")
        fields.append(blob[pos : pos + ln].decode("utf-8"))
        pos += ln
    nrows, pos = decode_varint(blob, pos)
    if nrows > 1_000_000:
        raise ValueError("implausible row count")
    cols: list[list] = []
    for _ in range(ncols):
        if pos >= len(blob):
            raise ValueError("truncated column")
        ctype = blob[pos]
        pos += 1
        col, pos = _decode_col(blob, pos, nrows, ctype)
        cols.append(col)
    return v, fields, cols


# ---------------------- delta stream frames ----------------------------
#
# Push-based federation wire (the federation tree, docs/federation.md):
# a leaf monitor streams its columnar table (chip rows, or slice-rollup
# rows at the aggregator tier) upstream as a BASELINE KEYFRAME followed
# by per-tick changed-columns diffs, so steady state ships only the
# cells that moved (duty/HBM/temp/ICI counters) instead of the whole
# 256-chip table every tick. Layout:
#
#   keyframe:  TPWK <u8 ver> <f64 ts> varint seq
#              varint len + embedded TPWF full frame
#   delta:     TPWD <u8 ver> <f64 ts> varint seq varint prev_seq
#              varint nrows + row mask (ceil(nrows/8) bytes,
#              bit i = row i changed)
#              varint ncols; per col: varint (index<<1 | full_flag),
#              u8 ctype, column payload over the masked rows (or ALL
#              rows when full_flag — see below)
#
# Replay is BIT-EXACT versus decoding a full frame of the same table
# (values and types): a changed cell is re-encoded under the ctype of
# the FULL current column, and a column whose ctype changed since the
# last frame (e.g. an all-int column gaining floats) is re-sent whole
# under the new ctype, so no cell is ever interpreted under a stale
# ctype. A delta whose prev_seq doesn't match the decoder's state
# raises ValueError — the transport treats that as a gap and resyncs
# by reconnecting, which always starts with a keyframe (the same
# resync contract as the SSE delta stream, tpumon_torch.deltas).
#
# Leadership generation (HA roots): every frame MAY carry a
# trailing varint generation token — the fencing epoch negotiated by
# the root-HA leadership lease. The trailer is APPEND-ONLY and OPTIONAL: it is only
# emitted when the sender's generation is > 0, so a non-HA deployment's
# frames stay byte-identical to the pre-generation layout (pinned by
# tests/fixtures/wire_pre_generation.json), and a frame without the
# trailer decodes as generation 0 — pre-upgrade peers federate
# unchanged in both directions. The same trailer rides TPWQ/TPWR below.
#
# Trace context (fleet tracing): a SECOND optional trailer
# MAY follow the generation — varint trace id, varint parent span id,
# varint len + utf-8 origin node name — linking the frame to the
# sender's open span (tpumon_torch.tracing). Ordering makes both layers
# independently append-only: absent entirely → (generation 0, no
# trace); generation alone → the generation-only layout, bit-exact (pinned by
# tests/fixtures/wire_gen_pre_trace.json); both → the generation varint
# is emitted even when 0 so the trace fields are unambiguous. Tracing
# is off by default, so a tracing-off sender adds ZERO wire bytes (the
# tracer's off-by-default contract), and a traced deployment only stamps frames after the
# receiving tier is upgraded — a pre-trace decoder refuses the extra
# bytes exactly like any other trailing garbage.

DELTA_KEY_MAGIC = b"TPWK"
DELTA_DIFF_MAGIC = b"TPWD"
DELTA_FRAME_VERSION = 1
DELTA_STREAM_CTYPE = "application/x-tpumon-deltastream"

# Longest origin node name the trace trailer accepts — matches the
# federation tier's node-name sanity bound, and keeps a hostile trailer
# from smuggling a megabyte into every frame.
TRACE_ORIGIN_MAX = 128


def encode_trailers(
    generation: int, trace: tuple[int, int, str] | None
) -> bytes:
    """The optional frame trailers: [varint generation][trace ctx].

    No generation, no trace → b"" (pre-generation layout, bit-exact).
    Generation only → single varint (generation-only layout, bit-exact).
    With a trace ctx the generation varint is ALWAYS emitted (0 is
    fine) so the decoder can tell the two trailers apart positionally.
    """
    if trace is None:
        return encode_varint(generation) if generation > 0 else b""
    tid, psid, origin = trace
    raw = origin.encode("utf-8")
    if len(raw) > TRACE_ORIGIN_MAX:
        raise ValueError("trace origin name too long")
    out = bytearray(encode_varint(generation))
    out += encode_varint(tid)
    out += encode_varint(psid)
    out += encode_varint(len(raw)) + raw
    return bytes(out)


def decode_trailers(
    blob: bytes, pos: int, what: str
) -> tuple[int, tuple[int, int, str] | None]:
    """Parse the optional trailers starting at ``pos``; returns
    (generation, trace ctx | None). The only VALID early ends are the
    append-only boundaries: end-of-payload (pre-generation peer) and
    end-of-generation-varint (pre-trace peer) — anything else, and any
    bytes past a complete trace ctx, raises ValueError."""
    if pos == len(blob):
        return 0, None
    gen, pos = decode_varint(blob, pos)
    if pos == len(blob):
        return gen, None
    tid, pos = decode_varint(blob, pos)
    psid, pos = decode_varint(blob, pos)
    ln, pos = decode_varint(blob, pos)
    if ln > TRACE_ORIGIN_MAX:
        raise ValueError(f"implausible trace origin after {what}")
    if pos + ln > len(blob):
        raise ValueError(f"truncated trace context after {what}")
    origin = blob[pos : pos + ln].decode("utf-8")
    pos += ln
    if pos != len(blob):
        raise ValueError(f"trailing bytes after {what}")
    return gen, (tid, psid, origin)


def _read_f64(blob: bytes, pos: int) -> tuple[float, int]:
    if pos + 8 > len(blob):
        raise ValueError("truncated f64")
    return struct.unpack_from("<d", blob, pos)[0], pos + 8


class DeltaStreamEncoder:
    """Stateful keyframe+diff encoder over (v, fields, rows) tables.

    ``encode`` returns ``(frame bytes, was_keyframe)``. Keyframes are
    emitted on the first frame, on any shape change (field list, row
    count, wire version), every ``keyframe_every`` frames (the
    ``sse_keyframe_every`` cadence idea: a silently-desynced consumer
    is bounded), and on ``force_key``/``reset()`` (transport
    reconnect). ``stats`` feeds bench.py's federation_tree phase.
    """

    def __init__(self, keyframe_every: int = 30):
        self.keyframe_every = max(1, int(keyframe_every))
        self.seq = 0
        # Leadership generation stamped on every frame while > 0
        # (the leadership lease's fencing epoch). 0 = unfenced: the trailer is
        # omitted entirely and the frame is byte-identical to the
        # pre-generation layout.
        self.generation = 0
        # Trace context (trace id, parent span id, origin node) stamped
        # while not None — set per tick by the federation uplink when
        # tracing is enabled. None (the default, and always when tracing
        # is off) adds zero wire bytes.
        self.trace: tuple[int, int, str] | None = None
        self._since_key = 0
        self._v: int | None = None
        self._fields: list[str] | None = None
        self._cols: list[list] | None = None
        self._ctypes: list[int] | None = None
        self.stats = {
            "frames": 0, "keyframes": 0, "bytes": 0,
            "delta_frames": 0, "delta_bytes": 0, "keyframe_bytes": 0,
        }

    def reset(self) -> None:
        """Drop baseline state: the next encode() emits a keyframe
        (reconnect resync — mirrors the SSE client protocol)."""
        self._cols = None

    def _header(self, magic: bytes, ts: float) -> bytearray:
        out = bytearray(magic)
        out.append(DELTA_FRAME_VERSION)
        out += struct.pack("<d", ts)
        out += encode_varint(self.seq)
        return out

    def encode(
        self, v: int, fields: list[str], rows: list[list], ts: float,
        force_key: bool = False,
    ) -> tuple[bytes, bool]:
        fields = list(fields)
        cols = [[row[ci] for row in rows] for ci in range(len(fields))]
        # allow_f32: stream frames are only read by DeltaStreamDecoder,
        # so the compact float type is safe here (unlike the negotiated
        # /api/accel/wire representation).
        ctypes = [_classify(c, allow_f32=True) for c in cols]
        nrows = len(rows)
        prev = self._cols
        need_key = (
            force_key
            or prev is None
            or v != self._v
            or fields != self._fields
            or (prev and len(prev[0]) != nrows)
            or (not prev and nrows)
            or self._since_key >= self.keyframe_every
        )
        self.seq += 1
        if need_key:
            inner = encode_wire_frame(v, fields, rows, allow_f32=True)
            out = self._header(DELTA_KEY_MAGIC, ts)
            out += encode_varint(len(inner))
            out += inner
            out += encode_trailers(self.generation, self.trace)
            self._since_key = 1
            self.stats["keyframes"] += 1
            self.stats["keyframe_bytes"] = len(out)
            was_key = True
        else:
            prev_ctypes = self._ctypes
            changed_rows = [False] * nrows
            partial: list[int] = []
            full: list[int] = []
            for ci, (col, pc) in enumerate(zip(cols, prev)):
                if ctypes[ci] != prev_ctypes[ci]:
                    # ctype moved (int column gained floats, ...): the
                    # whole column re-ships so no unchanged cell stays
                    # decoded under the stale ctype.
                    full.append(ci)
                    continue
                hit = False
                for ri in range(nrows):
                    a = col[ri]
                    b = pc[ri]
                    if a is b or a == b:
                        continue
                    changed_rows[ri] = True
                    hit = True
                if hit:
                    partial.append(ci)
            idx = [i for i, c in enumerate(changed_rows) if c]
            out = self._header(DELTA_DIFF_MAGIC, ts)
            out += encode_varint(self.seq - 1)
            out += encode_varint(nrows)
            mask = bytearray((nrows + 7) // 8)
            for i in idx:
                mask[i >> 3] |= 1 << (i & 7)
            out += mask
            out += encode_varint(len(partial) + len(full))
            for ci in sorted(partial + full):
                is_full = ci in full
                out += encode_varint((ci << 1) | (1 if is_full else 0))
                sub = cols[ci] if is_full else [cols[ci][ri] for ri in idx]
                if all(x is None for x in sub):
                    # An all-None subset under the full column's ctype
                    # can be unencodable (_CT_INTLIST_FIXED needs a
                    # stride from a non-null list) — and _CT_NONE is
                    # both always valid and smaller.
                    out.append(_CT_NONE)
                    continue
                if ctypes[ci] == _CT_I64 and not is_full:
                    # Cumulative-counter sub-columns (ICI tx/rx, HBM
                    # bytes) diff-code against the decoder's previous
                    # values when every touched cell has an int on both
                    # sides and the diff fits int64 — ~2e9/tick counter
                    # steps cost 5 varint bytes instead of 8 fixed.
                    olds = [prev[ci][ri] for ri in idx]
                    if all(
                        isinstance(o, int)
                        and x is not None
                        and _I64_MIN <= x - o <= _I64_MAX
                        for o, x in zip(olds, sub)
                    ):
                        out.append(_CTF_I64_DELTA | _CT_I64)
                        for o, x in zip(olds, sub):
                            out += encode_varint(_zigzag64(x - o))
                        continue
                out.append(ctypes[ci])
                _encode_col(out, sub, ctypes[ci])
            out += encode_trailers(self.generation, self.trace)
            self._since_key += 1
            self.stats["delta_frames"] += 1
            self.stats["delta_bytes"] += len(out)
            was_key = False
        self._v = v
        self._fields = fields
        self._cols = cols
        self._ctypes = ctypes
        self.stats["frames"] += 1
        self.stats["bytes"] += len(out)
        return bytes(out), was_key


class DeltaStreamDecoder:
    """Inverse of DeltaStreamEncoder: feed frames in stream order via
    ``apply``; the decoder's ``cols`` converge bit-exactly on what a
    full-frame decode of the sender's current table would produce.

    Raises ValueError on malformed/truncated frames, a delta before
    any keyframe, a row-count mismatch, or a ``prev_seq`` gap — the
    caller drops the connection and the sender resyncs with a
    keyframe. Delta application is two-phase (fully parsed, then
    applied) so a raise never leaves half-applied state.
    """

    def __init__(self):
        self.v: int | None = None
        self.fields: list[str] = []
        self.cols: list[list] = []
        self.seq = 0
        self.frames = 0
        self.keyframes = 0
        # Sender's leadership generation from the last applied frame
        # (0 when the frame carried no trailer — pre-upgrade peers).
        self.generation = 0
        # Sender's trace context from the last applied frame (None when
        # absent — untraced or pre-trace peers).
        self.trace: tuple[int, int, str] | None = None
        self._synced = False

    def apply(self, blob: bytes) -> dict:
        """Apply one frame; returns {"v", "fields", "cols", "ts",
        "seq", "key"}. ``cols`` is the decoder's live state — read it
        before feeding the next frame, don't mutate it."""
        magic = blob[:4]
        if magic == DELTA_KEY_MAGIC:
            return self._apply_key(blob)
        if magic == DELTA_DIFF_MAGIC:
            return self._apply_diff(blob)
        raise ValueError("bad delta stream frame magic")

    def _head(self, blob: bytes) -> tuple[float, int, int]:
        if len(blob) < 5:
            raise ValueError("truncated delta frame header")
        if blob[4] != DELTA_FRAME_VERSION:
            raise ValueError(f"unsupported delta frame version {blob[4]}")
        ts, pos = _read_f64(blob, 5)
        seq, pos = decode_varint(blob, pos)
        return ts, seq, pos

    def _done(self, ts: float, seq: int, key: bool) -> dict:
        self.seq = seq
        self.frames += 1
        self._synced = True
        return {
            "v": self.v, "fields": self.fields, "cols": self.cols,
            "ts": ts, "seq": seq, "key": key,
            "generation": self.generation, "trace": self.trace,
        }

    def _apply_key(self, blob: bytes) -> dict:
        ts, seq, pos = self._head(blob)
        ln, pos = decode_varint(blob, pos)
        if pos + ln > len(blob):
            raise ValueError("truncated keyframe payload")
        # Parse the trailers BEFORE decoding the embedded frame: a
        # truncated trailer must not leave replaced state.
        gen, trace = decode_trailers(blob, pos + ln, "keyframe")
        self.v, self.fields, self.cols = decode_wire_frame(blob[pos : pos + ln])
        self.generation = gen
        self.trace = trace
        self.keyframes += 1
        return self._done(ts, seq, True)

    def _apply_diff(self, blob: bytes) -> dict:
        if not self._synced:
            raise ValueError("delta frame before any keyframe")
        ts, seq, pos = self._head(blob)
        prev_seq, pos = decode_varint(blob, pos)
        if prev_seq != self.seq:
            raise ValueError(
                f"delta sequence gap (frame follows {prev_seq}, "
                f"state at {self.seq})"
            )
        nrows, pos = decode_varint(blob, pos)
        if self.cols and nrows != len(self.cols[0]):
            raise ValueError("delta row count mismatch")
        nbm = (nrows + 7) // 8
        mask = blob[pos : pos + nbm]
        if len(mask) < nbm:
            raise ValueError("truncated delta row mask")
        pos += nbm
        idx = [i for i in range(nrows) if mask[i >> 3] & (1 << (i & 7))]
        ncols, pos = decode_varint(blob, pos)
        if ncols > len(self.cols):
            raise ValueError("implausible delta column count")
        # Phase 1: parse everything (any truncation raises BEFORE any
        # state is touched).
        pending: list[tuple[int, bool, list]] = []
        for _ in range(ncols):
            tag, pos = decode_varint(blob, pos)
            ci, is_full = tag >> 1, bool(tag & 1)
            if ci >= len(self.cols):
                raise ValueError("delta column index out of range")
            if pos >= len(blob):
                raise ValueError("truncated delta column")
            ctype = blob[pos]
            pos += 1
            if ctype & _CTF_I64_DELTA:
                # Diff-coded i64 sub-column: previous state + varint
                # zigzag diffs (reading state here is fine — phase 2
                # is the only writer).
                if (ctype & ~_CTF_I64_DELTA) != _CT_I64 or is_full:
                    raise ValueError("bad diff-coded column header")
                col = self.cols[ci]
                vals = []
                for ri in idx:
                    u, pos = decode_varint(blob, pos)
                    old = col[ri]
                    if not isinstance(old, int):
                        raise ValueError("diff against a non-int cell")
                    vals.append(old + _unzigzag64(u))
            else:
                vals, pos = _decode_col(
                    blob, pos, nrows if is_full else len(idx), ctype
                )
            pending.append((ci, is_full, vals))
        gen, trace = decode_trailers(blob, pos, "delta frame")
        # Phase 2: apply.
        self.generation = gen
        self.trace = trace
        for ci, is_full, vals in pending:
            if is_full:
                self.cols[ci] = vals
            else:
                col = self.cols[ci]
                for k, ri in enumerate(idx):
                    col[ri] = vals[k]
        return self._done(ts, seq, False)


# ---------------------- distributed query frames -----------------------
#
# Fleet-query push-down over the federation tree
# (docs/query.md "Distributed evaluation"): the upstream hub writes a
# TPWQ request down an OPEN ingest stream (the same long-lived chunked
# POST the downstream pushes delta frames on — same auth, same resync
# contract: a dropped stream drops its in-flight queries and the hub
# answers partial), and the downstream interleaves a TPWR partial-result
# record into its upload. Both ride the varint-length-prefixed record
# framing of the ingest stream. Layout:
#
#   request:  TPWQ <u8 ver> varint qid <f64 at> <f64 timeout_s>
#             varint len + utf-8 expression [varint generation]
#   result:   TPWR <u8 ver> varint qid <u8 flags: 1=partial 2=error>
#             varint len + utf-8 JSON payload [varint generation]
#
# The trailing generation follows the delta-stream contract above:
# emitted only when > 0, absent decodes as 0 — pre-upgrade peers see
# byte-identical unfenced frames. A downstream answering a TPWQ whose
# generation is older than the newest it has seen refuses with an
# error TPWR ("stale generation"): a deposed root cannot gather the
# fleet state an actuation decision would need (the leadership lease).
#
# The result payload is the mergeable partial-aggregate state
# (tpumon_torch.query.partial_eval: group sums/counts/min/max, topk row sets,
# quantile sketches) — never raw points; an error result carries
# {"error": msg}. Truncation anywhere raises ValueError (the stream is
# dropped and resyncs, exactly like a refused delta frame).

QUERY_REQ_MAGIC = b"TPWQ"
QUERY_RES_MAGIC = b"TPWR"
QUERY_FRAME_VERSION = 1

_QRES_PARTIAL = 1
_QRES_ERROR = 2


def encode_query_request(
    qid: int,
    expr: str,
    at: float,
    timeout_s: float,
    generation: int = 0,
    trace: tuple[int, int, str] | None = None,
) -> bytes:
    out = bytearray(QUERY_REQ_MAGIC)
    out.append(QUERY_FRAME_VERSION)
    out += encode_varint(qid)
    out += struct.pack("<d", at)
    out += struct.pack("<d", timeout_s)
    raw = expr.encode("utf-8")
    out += encode_varint(len(raw)) + raw
    out += encode_trailers(generation, trace)
    return bytes(out)


def decode_query_request(
    blob: bytes,
) -> tuple[int, str, float, float, int, tuple[int, int, str] | None]:
    """(qid, expr, at, timeout_s, generation, trace); ValueError on
    anything malformed. generation is 0 and trace None when the frame
    carries no trailers."""
    if blob[: len(QUERY_REQ_MAGIC)] != QUERY_REQ_MAGIC:
        raise ValueError("bad query request magic")
    if len(blob) < 5:
        raise ValueError("truncated query request header")
    if blob[4] != QUERY_FRAME_VERSION:
        raise ValueError(f"unsupported query frame version {blob[4]}")
    qid, pos = decode_varint(blob, 5)
    if pos + 16 > len(blob):
        raise ValueError("truncated query request timestamps")
    at, timeout_s = struct.unpack_from("<dd", blob, pos)
    pos += 16
    ln, pos = decode_varint(blob, pos)
    if pos + ln > len(blob):
        raise ValueError("truncated query request expression")
    expr = blob[pos : pos + ln].decode("utf-8")
    gen, trace = decode_trailers(blob, pos + ln, "query request")
    return qid, expr, at, timeout_s, gen, trace


def encode_query_result(
    qid: int,
    payload: dict | None,
    partial: bool = False,
    error: str | None = None,
    generation: int = 0,
    trace: tuple[int, int, str] | None = None,
) -> bytes:
    import json as _json

    flags = (_QRES_PARTIAL if partial else 0) | (_QRES_ERROR if error else 0)
    body = _json.dumps(
        {"error": error} if error is not None else (payload or {}),
        separators=(",", ":"),
    ).encode("utf-8")
    out = bytearray(QUERY_RES_MAGIC)
    out.append(QUERY_FRAME_VERSION)
    out += encode_varint(qid)
    out.append(flags)
    out += encode_varint(len(body)) + body
    out += encode_trailers(generation, trace)
    return bytes(out)


def decode_query_result(
    blob: bytes,
) -> tuple[int, bool, str | None, dict, int, tuple[int, int, str] | None]:
    """(qid, partial, error, payload, generation, trace); ValueError on
    anything malformed. generation is 0 and trace None without
    trailers."""
    import json as _json

    if blob[: len(QUERY_RES_MAGIC)] != QUERY_RES_MAGIC:
        raise ValueError("bad query result magic")
    if len(blob) < 5:
        raise ValueError("truncated query result header")
    if blob[4] != QUERY_FRAME_VERSION:
        raise ValueError(f"unsupported query frame version {blob[4]}")
    qid, pos = decode_varint(blob, 5)
    if pos >= len(blob):
        raise ValueError("truncated query result flags")
    flags = blob[pos]
    pos += 1
    ln, pos = decode_varint(blob, pos)
    if pos + ln > len(blob):
        raise ValueError("truncated query result payload")
    try:
        payload = _json.loads(blob[pos : pos + ln])
    except ValueError as e:
        raise ValueError(f"corrupt query result payload: {e}")
    if not isinstance(payload, dict):
        raise ValueError("query result payload must be an object")
    error = payload.get("error") if flags & _QRES_ERROR else None
    gen, trace = decode_trailers(blob, pos + ln, "query result")
    return qid, bool(flags & _QRES_PARTIAL), error, payload, gen, trace


# ---------------------- trace span relay frames ------------------------
#
# Fleet tracing upload (tpumon_torch.tracing / docs/observability.md
# "Distributed tracing"): when tracing is enabled, each federation tier
# interleaves a TPWS record into its ingest upload after the data frame
# — its own completed remote-correlated spans for the tick (bounded by
# the tracer outbox, never raw rings) plus its current clock-offset
# table, which the root composes hop by hop to place every node's spans
# on its own clock. TPWS only exists on upgraded, tracing-on links:
# tracing off ⇒ the record is never written (zero wire bytes), and a
# pre-trace hub that somehow receives one refuses the unknown magic and
# drops the stream like any other corrupt record. Layout:
#
#   spans:  TPWS <u8 ver> varint len + utf-8 JSON
#           {"node": sender, "spans": [...], "offsets": {node: ms}}
#
# JSON is fine here: span relay is low-rate (bounded per tick) and off
# the hot decode path, unlike the columnar data frames above.

TRACE_SPANS_MAGIC = b"TPWS"
TRACE_SPANS_VERSION = 1
TRACE_SPANS_MAX = 256 * 1024  # refuse implausible relay payloads


def encode_trace_spans(payload: dict) -> bytes:
    import json as _json

    body = _json.dumps(payload, separators=(",", ":")).encode("utf-8")
    if len(body) > TRACE_SPANS_MAX:
        raise ValueError("trace span relay payload too large")
    out = bytearray(TRACE_SPANS_MAGIC)
    out.append(TRACE_SPANS_VERSION)
    out += encode_varint(len(body)) + body
    return bytes(out)


def decode_trace_spans(blob: bytes) -> dict:
    import json as _json

    if blob[: len(TRACE_SPANS_MAGIC)] != TRACE_SPANS_MAGIC:
        raise ValueError("bad trace span frame magic")
    if len(blob) < 5:
        raise ValueError("truncated trace span header")
    if blob[4] != TRACE_SPANS_VERSION:
        raise ValueError(f"unsupported trace span frame version {blob[4]}")
    ln, pos = decode_varint(blob, 5)
    if ln > TRACE_SPANS_MAX:
        raise ValueError("implausible trace span payload")
    if pos + ln != len(blob):
        raise ValueError("truncated trace span payload")
    try:
        payload = _json.loads(blob[pos : pos + ln])
    except ValueError as e:
        raise ValueError(f"corrupt trace span payload: {e}")
    if not isinstance(payload, dict):
        raise ValueError("trace span payload must be an object")
    return payload


def decode_message(buf: bytes, max_depth: int = 16) -> Message:
    """Decode protobuf bytes into a Message tree.

    Length-delimited fields are speculatively decoded as sub-messages; if
    that fails they are kept as utf-8 text (when decodable) or raw bytes.
    This is lossy w.r.t. schema (a string that happens to be valid proto
    decodes as a Message) which is fine for structural extraction — callers
    must match on shape, not on type alone.
    """
    if max_depth < 0:
        raise ValueError("max depth exceeded")
    fields: list[Field] = []
    pos = 0
    while pos < len(buf):
        tag, pos = decode_varint(buf, pos)
        number, wt = tag >> 3, tag & 7
        if number == 0:
            raise ValueError("field number 0")
        if wt == WT_VARINT:
            val, pos = decode_varint(buf, pos)
            fields.append(Field(number, wt, val))
        elif wt == WT_FIXED64:
            if pos + 8 > len(buf):
                raise ValueError("truncated fixed64")
            (val,) = struct.unpack_from("<d", buf, pos)
            fields.append(Field(number, wt, val))
            pos += 8
        elif wt == WT_FIXED32:
            if pos + 4 > len(buf):
                raise ValueError("truncated fixed32")
            (val,) = struct.unpack_from("<f", buf, pos)
            fields.append(Field(number, wt, val))
            pos += 4
        elif wt == WT_LEN:
            ln, pos = decode_varint(buf, pos)
            if pos + ln > len(buf):
                raise ValueError("truncated length-delimited field")
            raw = buf[pos : pos + ln]
            pos += ln
            sub = None
            if max_depth > 0:
                try:
                    sub = decode_message(raw, max_depth - 1) if raw else None
                except ValueError:
                    sub = None
            if sub is not None:
                fields.append(Field(number, wt, sub))
            else:
                try:
                    fields.append(Field(number, wt, raw.decode("utf-8")))
                except UnicodeDecodeError:
                    fields.append(Field(number, wt, raw))
        else:
            raise ValueError(f"unsupported wire type {wt}")
    return Message(fields)
