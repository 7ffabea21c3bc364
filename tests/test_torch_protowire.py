"""The port's wire codec (``tpumon_torch/protowire.py``) against the
reference's: every encoder gives the reference's bytes on the same input,
and each package's decoder reads the other's bytes back to equal values.

Inputs: the protobuf field codec, columnar frames of a ``fake:v5p-256``
fleet (256 chips at several clocks, through each package's own fake
collector and ``chips_to_wire``), a 20-tick delta stream with keyframes
over a churning table and over the fleet, with the generation and trace
trailers switched on part way, query requests and results, the trailers
alone, trace-span relay records, and the checked-in frames of older
senders (``tests/fixtures/wire_*.json``).
"""

import base64
import json
from pathlib import Path

import pytest

from tests.test_protowire import _DELTA_FIELDS, _evolving_table
from tpumon import protowire as ref_pw
from tpumon.collectors.accel_fake import FakeTpuCollector as RefFake
from tpumon.topology import chips_to_wire as ref_chips_to_wire
from tpumon_torch import protowire as pw
from tpumon_torch.collectors.accel_fake import FakeTpuCollector
from tpumon_torch.topology import chips_to_wire

FIXTURES = Path(__file__).resolve().parent / "fixtures"
T = 1_700_000_450.0
TRACE = (0xABCDEF0123, 42, "leaf0")
PKGS = (pw, ref_pw)


def fleet(ts: float, topology: str = "v5p-256", faults: bool = False):
    """(port wire table, reference wire table) of one fake fleet."""
    kw = dict(topology=topology, fault_episodes=faults, clock=lambda: ts)
    a = chips_to_wire(FakeTpuCollector(**kw).chips())
    b = ref_chips_to_wire(RefFake(**kw).chips())
    return (a["v"], a["fields"], a["rows"]), (b["v"], b["fields"], b["rows"])


def same_values(a, b):
    """Equal, and equal in type cell by cell (an int is not a float)."""
    assert a == b
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_field_codec_gives_the_reference_bytes():
    values = [0, 1, 127, 128, 300, 2**31, 2**63 - 1, 2**64 - 1]
    for v in values:
        assert pw.encode_varint(v) == ref_pw.encode_varint(v)
        assert pw.decode_varint(ref_pw.encode_varint(v), 0) == (
            v, len(ref_pw.encode_varint(v)))
    msg = (pw.encode_string(1, "tpu-host-0/chip-3") + pw.encode_int(2, -5)
           + pw.encode_double(3, 2.5)
           + pw.encode_message(4, pw.encode_int(1, 7) + pw.encode_string(2, "µ")))
    ref = (ref_pw.encode_string(1, "tpu-host-0/chip-3") + ref_pw.encode_int(2, -5)
           + ref_pw.encode_double(3, 2.5)
           + ref_pw.encode_message(4, ref_pw.encode_int(1, 7)
                                   + ref_pw.encode_string(2, "µ")))
    assert msg == ref
    a, b = pw.decode_message(ref), ref_pw.decode_message(msg)
    assert ([(f.number, f.wire_type) for f in a.walk()]
            == [(f.number, f.wire_type) for f in b.walk()])
    assert a.first(1) == b.first(1) and a.first(2) == b.first(2)
    for cut in range(1, len(msg)):  # truncations fail alike
        outs = []
        for pkg in PKGS:
            try:
                outs.append([(f.number, f.value) for f in
                             pkg.decode_message(msg[:cut]).walk()])
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], cut


@pytest.mark.parametrize("ts,faults", [(T, False), (T + 37.0, True),
                                       (T + 3600.5, False)])
def test_fleet_frame_equals_reference(ts, faults):
    port, ref = fleet(ts, faults=faults)
    assert len(port[2]) == 256
    same_values(port, ref)
    blob = pw.encode_wire_frame(*port)
    assert blob == ref_pw.encode_wire_frame(*ref)
    assert blob[:4] == pw.WIRE_FRAME_MAGIC
    assert pw.WIRE_FRAME_CTYPE == ref_pw.WIRE_FRAME_CTYPE
    same_values(list(pw.decode_wire_frame(blob)),
                list(ref_pw.decode_wire_frame(blob)))


@pytest.mark.parametrize("source", ["churn", "fleet"])
def test_delta_stream_equals_reference(source):
    """20 ticks, a keyframe every 6, the generation from tick 8 and a
    trace context on ticks 12–15: the same frames byte for byte, and
    each decoder replays the other encoder's stream to the same
    tables."""
    encs = [pkg.DeltaStreamEncoder(keyframe_every=6) for pkg in PKGS]
    # decs[i][j]: package i's decoder reading package j's stream
    decs = [[pkg.DeltaStreamDecoder() for _ in PKGS] for pkg in PKGS]
    keys = 0
    for t in range(20):
        if source == "churn":
            tables = [(1, _DELTA_FIELDS, _evolving_table(t))] * 2
        else:
            tables = fleet(T + t, topology="v5p-64", faults=True)
        for enc in encs:
            enc.generation = 0 if t < 8 else 3 + t // 10
            enc.trace = TRACE if 12 <= t < 16 else None
        frames = [enc.encode(*tab, ts=T + t) for enc, tab in zip(encs, tables)]
        assert frames[0] == frames[1], t
        keys += frames[0][1]
        for i in range(2):
            outs = [decs[i][j].apply(frames[j][0]) for j in range(2)]
            same_values(outs[0], outs[1])
            assert outs[0]["key"] == frames[0][1]
        want = list(ref_pw.decode_wire_frame(ref_pw.encode_wire_frame(*tables[1])))
        same_values(outs[0]["cols"], want[2])
    assert keys == 4
    assert encs[0].stats == encs[1].stats
    encs[1].encode(*tables[1], ts=T + 20)  # lost in transit
    gap, was_key = encs[1].encode(*tables[1], ts=T + 21)
    assert not was_key
    errors = []
    for i in range(2):  # a gap is refused alike
        with pytest.raises(ValueError) as e:
            decs[i][1].apply(gap)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("gen,trace", [(0, None), (5, None), (0, TRACE),
                                       (300, TRACE)])
def test_query_frames_and_trailers_equal_reference(gen, trace):
    assert pw.encode_trailers(gen, trace) == ref_pw.encode_trailers(gen, trace)
    req = pw.encode_query_request(9, "topk(3, chip.mxu)", T, 2.5,
                                  generation=gen, trace=trace)
    assert req == ref_pw.encode_query_request(9, "topk(3, chip.mxu)", T, 2.5,
                                              generation=gen, trace=trace)
    assert pw.decode_query_request(req) == ref_pw.decode_query_request(req)
    for kw in ({"payload": {"kind": "vector", "groups": [[["a"], 1.5]]}},
               {"payload": {"kind": "scalar"}, "partial": True},
               {"payload": None, "error": "stale generation"}):
        res = pw.encode_query_result(9, generation=gen, trace=trace, **kw)
        assert res == ref_pw.encode_query_result(9, generation=gen,
                                                 trace=trace, **kw)
        assert pw.decode_query_result(res) == ref_pw.decode_query_result(res)


def test_trace_span_relay_equals_reference():
    payload = {"node": "agg0",
               "spans": [{"sid": 3, "parent": None, "name": "fed.push",
                          "dur_ms": 1.5},
                         {"sid": 4, "parent": 3, "name": "http", "dur_ms": 0.25}],
               "offsets": {"leaf0": 12.25, "leaf1": -3.0}}
    blob = pw.encode_trace_spans(payload)
    assert blob == ref_pw.encode_trace_spans(payload)
    assert pw.decode_trace_spans(blob) == ref_pw.decode_trace_spans(blob) == payload
    for cut in range(0, len(blob), 7):
        with pytest.raises(ValueError):
            pw.decode_trace_spans(blob[:cut])


@pytest.mark.parametrize("name", ["wire_pre_generation.json",
                                  "wire_gen_pre_trace.json"])
def test_older_senders_fixtures_decode_as_the_reference(name):
    fix = json.loads((FIXTURES / name).read_text())
    blobs = {k.removesuffix("_b64"): base64.b64decode(v)
             for k, v in fix.items() if k.endswith("_b64")}
    assert {"keyframe", "delta"} <= set(blobs)
    decs = [pkg.DeltaStreamDecoder() for pkg in PKGS]
    for kind in ("keyframe", "delta"):
        a, b = (d.apply(blobs[kind]) for d in decs)
        same_values(a, b)
    for kind, fn in (("query_req", "decode_query_request"),
                     ("query_res", "decode_query_result")):
        if kind in blobs:
            assert (getattr(pw, fn)(blobs[kind])
                    == getattr(ref_pw, fn)(blobs[kind]))
