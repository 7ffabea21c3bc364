"""The port's federation wire helpers and hub (``tpumon_torch/federation.py``)
in lockstep with the reference's (``tpumon/federation.py``).

- Seeded numpy chip tables (``topology.WIRE_FIELDS`` rows, a share of
  missing readings) give equal ``slice_rollup_rows``, ``_rows_to_wire`` and
  ``_quantize_rows`` in both packages, and varint-prefixed record streams
  cut at seeded points split into the same records under
  ``split_records``, which refuses the same malformed prefixes.
- Two aggregators, one a port app and one a reference app (``build`` of
  each package), ingest the same recorded chunked streams through
  ``FederationHub.handle_ingest``: a leaf's chip frames with generation
  trailers, a lower aggregator's slice rows (one row dark), clock
  offsets relayed in a TPWS record, an unclaimed TPWR answer, a lagging
  frame, silence past ``dark_after_s``, a reconnect with its keyframe, a
  refused frame, and a node forgotten after its long outage. The wall
  clock is the test's (``time.time``); each package's federation and
  exporter modules read a monotonic and a perf clock of the test's
  through a ``time`` of their own, so the event loop keeps its real
  clock. After every step ``fleet()``, ``slices()``, ``health_json()``,
  ``to_json()``, the journal, the landed rollup and freshness series and
  the exporter's ``tpumon_federation_*`` text are equal, as are the bytes
  each hub wrote back to its sender.
"""

import asyncio
import time
import types

import numpy as np
import pytest

from tpumon import app as ref_app
from tpumon import exporter as ref_exporter
from tpumon import federation as ref_fed
from tpumon import protowire as ref_pw
from tpumon import topology as ref_topo
from tpumon.config import load_config as ref_load_config
from tpumon_torch import app, exporter, federation, protowire, topology
from tpumon_torch.config import load_config

T0 = 1_760_000_000.0

PORT = types.SimpleNamespace(fed=federation, topo=topology, pw=protowire,
                             app=app, exporter=exporter, load=load_config)
REF = types.SimpleNamespace(fed=ref_fed, topo=ref_topo, pw=ref_pw,
                            app=ref_app, exporter=ref_exporter,
                            load=ref_load_config)
SIDES = (PORT, REF)


def chip_rows(seed: int, prefix: str, n: int = 16, hosts: int = 4,
              slices: int = 2, accel: str = "tpu") -> list[list]:
    """One seeded chip table in ``WIRE_FIELDS`` order: identities from the
    prefix, readings from numpy, about one reading in ten missing."""
    rng = np.random.default_rng(seed)
    kind = "v5e" if accel == "tpu" else "h100"

    def maybe(v):
        return None if rng.random() < 0.1 else v

    rows = []
    for i in range(n):
        h = i * hosts // n
        total = int(rng.choice([16, 80])) << 30
        rows.append([
            f"{prefix}/chip-{i}", f"{prefix}-h{h}", f"slice-{i % slices}", i,
            kind, [i % 4, i // 4, 0],
            maybe(float(rng.uniform(0, 100))),
            maybe(int(rng.integers(0, total))), total,
            maybe(float(rng.uniform(30, 90))),
            int(rng.integers(0, 1 << 40)), int(rng.integers(0, 1 << 40)),
            int(rng.integers(0, 5)), maybe(float(rng.uniform(0, 1))),
            float(rng.uniform(0, 1)), "fake", accel,
        ])
    return rows


def columns(rows: list[list]) -> list[list]:
    return [list(c) for c in zip(*rows)]


def chips(side, rows):
    return side.topo.chips_from_columns(list(side.topo.WIRE_FIELDS),
                                        columns(rows))


@pytest.mark.parametrize("seed", range(6))
def test_rollups_wire_rows_and_quantize_agree(seed):
    assert list(federation.SLICE_FIELDS) == list(ref_fed.SLICE_FIELDS)
    assert federation.ROLLUP_SERIES == ref_fed.ROLLUP_SERIES
    for name in ("SLICE_WIRE_VERSION", "OFFSET_WINDOW", "RELAY_CAP",
                 "RELAY_PER_TICK", "FRESH_NODES_MAX", "INGEST_PATH",
                 "_F32_CHIP_FIELDS", "_F32_SLICE_FIELDS"):
        assert getattr(federation, name) == getattr(ref_fed, name), name
    accel = "gpu" if seed % 2 else "tpu"
    rows = chip_rows(seed, f"leaf{seed}", n=8 + 4 * seed, hosts=2 + seed,
                     slices=1 + seed % 3, accel=accel)
    ts = T0 + seed * 0.37
    for health in ("ok", "dark"):
        got = [federation.slice_rollup_rows(chips(PORT, rows), "leaf",
                                            ts, health)]
        want = [ref_fed.slice_rollup_rows(chips(REF, rows), "leaf", ts,
                                          health)]
        assert got == want
        assert {r["accel_kind"] for r in got[0]} == {accel}
        wire = federation._rows_to_wire(got[0])
        assert wire == ref_fed._rows_to_wire(want[0])
        for fields, which in ((list(federation.SLICE_FIELDS),
                               "_F32_SLICE_FIELDS"),):
            a = [list(r) for r in wire]
            b = [list(r) for r in wire]
            federation._quantize_rows(fields, a, getattr(federation, which))
            ref_fed._quantize_rows(fields, b, getattr(ref_fed, which))
            assert a == b
            assert [x.hex() if isinstance(x, float) else x
                    for r in a for x in r] == [
                x.hex() if isinstance(x, float) else x for r in b for x in r]
    a = [list(r) for r in rows]
    b = [list(r) for r in rows]
    fields = list(topology.WIRE_FIELDS)
    federation._quantize_rows(fields, a, federation._F32_CHIP_FIELDS)
    ref_fed._quantize_rows(fields, b, ref_fed._F32_CHIP_FIELDS)
    assert a == b and a != rows or all(
        r[6] is None and r[9] is None for r in rows)


@pytest.mark.parametrize("seed", range(4))
def test_split_records_agrees_on_any_cut(seed):
    rng = np.random.default_rng(100 + seed)
    records = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
               for n in rng.integers(0, 400, 40)]
    stream = b"".join(protowire.encode_varint(len(r)) + r for r in records)
    assert stream == b"".join(ref_pw.encode_varint(len(r)) + r
                              for r in records)
    cuts = sorted(int(c) for c in rng.integers(0, len(stream), 25))
    bounds = [0] + cuts + [len(stream)]
    outs = []
    for split in (federation.split_records, ref_fed.split_records):
        buf, got, trail = bytearray(), [], []
        for lo, hi in zip(bounds, bounds[1:]):
            buf += stream[lo:hi]
            got += split(buf)
            trail.append(bytes(buf))
        outs.append((got, trail))
    assert outs[0] == outs[1]
    assert outs[0][0] == records and outs[0][1][-1] == b""
    for bad in (b"\xff" * 10 + b"x",
                protowire.encode_varint(federation._MAX_RECORD + 1)):
        for split in (federation.split_records, ref_fed.split_records):
            with pytest.raises(ValueError):
                split(bytearray(bad))
    for split in (federation.split_records, ref_fed.split_records):
        part = bytearray(b"\xff" * 9)  # an incomplete varint waits
        assert split(part) == [] and part == bytearray(b"\xff" * 9)


class ManualClock:
    """The test's clocks: ``wall`` for ``time.time`` (patched process-wide:
    both packages' journals stamp it), and ``mono``/``perf`` for a ``time``
    namespace each package's federation and exporter modules read."""

    def __init__(self):
        self.wall = T0
        self.mono = 5_000.0
        self.perf = 100.0

    def namespace(self):
        return types.SimpleNamespace(time=lambda: self.wall,
                                     monotonic=lambda: self.mono,
                                     perf_counter=lambda: self.perf)

    def advance(self, s: float) -> None:
        self.wall += s
        self.mono += s
        self.perf += s


@pytest.fixture
def clock(monkeypatch):
    c = ManualClock()
    monkeypatch.setattr(time, "time", lambda: c.wall)
    for side in SIDES:
        monkeypatch.setattr(side.fed, "time", c.namespace())
        monkeypatch.setattr(side.exporter, "time", c.namespace())
    return c


class FakeWriter:
    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def get_extra_info(self, key):
        return ("127.0.0.1", 40000) if key == "peername" else None

    def close(self):
        pass


def aggregator(side):
    env = {"TPUMON_ACCEL_BACKEND": "none", "TPUMON_K8S_MODE": "none",
           "TPUMON_COLLECTORS": "accel", "TPUMON_PORT": "0",
           "TPUMON_FEDERATION_ROLE": "aggregator",
           "TPUMON_FEDERATION_NODE": "agg0",
           "TPUMON_FEDERATION_DARK_AFTER_S": "3"}
    sampler, _server = side.app.build(side.load(env=env))
    return sampler


def chunk(rec: bytes) -> bytes:
    return b"%x\r\n" % len(rec) + rec + b"\r\n"


def record(frame: bytes) -> bytes:
    return protowire.encode_varint(len(frame)) + frame


def view(sampler, side) -> dict:
    hub = sampler.federation
    series = {n: [tuple(p) for p in s.points]
              for n, s in sorted(sampler.history.series.items())
              if n.startswith(("slice.", "fed."))}
    return {
        "fleet": hub.fleet(), "slices": hub.slices(),
        "health": hub.health_json(), "json": hub.to_json(),
        "trace": {k: v for k, v in hub.fleet_trace_json().items()
                  if k != "spans"},
        "events": [{k: v for k, v in e.items()}
                   for e in sampler.journal.events()],
        "series": series,
        "exporter": side.exporter._render_federation(sampler),
        "frames": hub.frames,
        "nodes": {n: (ns.query_results, ns.generation, ns.lagging, ns.bytes)
                  for n, ns in hub.nodes.items()},
    }


class Stream:
    """One downstream connection into one hub: a StreamReader fed by the
    test and the task serving it."""

    def __init__(self, sampler, node, tier):
        self.reader = asyncio.StreamReader()
        self.writer = FakeWriter()
        self.task = asyncio.ensure_future(sampler.federation.handle_ingest(
            self.reader, self.writer, node, tier, chunked=True))

    def feed(self, data: bytes) -> None:
        self.reader.feed_data(data)

    def end(self) -> None:
        self.reader.feed_data(b"0\r\n\r\n")
        self.reader.feed_eof()


async def settle():
    for _ in range(20):
        await asyncio.sleep(0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hub_lockstep_over_recorded_streams(clock, seed):
    rng = np.random.default_rng(seed)
    leaf_rows = chip_rows(seed, "leaf0", n=8, hosts=2, slices=2)
    deep_rows = chip_rows(seed + 50, "deep", n=8, hosts=2, slices=2,
                          accel="gpu")
    enc = (protowire.DeltaStreamEncoder(keyframe_every=6),
           ref_pw.DeltaStreamEncoder(keyframe_every=6))
    slice_enc = (protowire.DeltaStreamEncoder(keyframe_every=6),
                 ref_pw.DeltaStreamEncoder(keyframe_every=6))

    def leaf_frame(gen=0, lag=0.05):
        """The leaf's next frame: a few readings moved, encoded by both
        packages' encoders, which must agree byte for byte."""
        for r in leaf_rows:
            if rng.random() < 0.4:
                r[6] = float(rng.uniform(0, 100))
            if rng.random() < 0.3:
                r[9] = float(rng.uniform(30, 90))
        rows = [list(r) for r in leaf_rows]
        federation._quantize_rows(list(topology.WIRE_FIELDS), rows,
                                  federation._F32_CHIP_FIELDS)
        frames = []
        for e in enc:
            e.generation = gen
            frames.append(e.encode(1, list(topology.WIRE_FIELDS),
                                   [list(r) for r in rows],
                                   clock.wall - lag)[0])
        assert frames[0] == frames[1]
        return frames[0]

    def slice_frame(dark=False):
        srows = ref_fed.slice_rollup_rows(chips(REF, deep_rows), "deep",
                                          clock.wall - 0.2)
        if dark:
            srows[0]["health"] = "dark"
        wire = ref_fed._rows_to_wire(srows)
        ref_fed._quantize_rows(list(ref_fed.SLICE_FIELDS), wire,
                               ref_fed._F32_SLICE_FIELDS)
        frames = [e.encode(1, list(ref_fed.SLICE_FIELDS),
                           [list(r) for r in wire], clock.wall - 0.1)[0]
                  for e in slice_enc]
        assert frames[0] == frames[1]
        return frames[0]

    async def scenario():
        samplers = [aggregator(side) for side in SIDES]
        leaf = [Stream(s, "leaf0", "leaf") for s in samplers]
        mid = [Stream(s, "agg1", "aggregator") for s in samplers]
        views = []

        def check(what):
            got = [view(s, side) for s, side in zip(samplers, SIDES)]
            assert got[0] == got[1], what
            views.append(got[0])
            return got[0]

        async def feed(streams, data):
            for st in streams:
                st.feed(data)
            await settle()

        await settle()
        check("connected")
        for i in range(8):
            clock.advance(1.0)
            await feed(leaf, chunk(record(leaf_frame(gen=1 if i > 3 else 0))))
            await feed(mid, chunk(record(slice_frame(dark=i >= 5))))
            check(f"tick {i}")
        spans = protowire.encode_trace_spans(
            {"node": "agg1", "spans": [],
             "offsets_s": {"deep": 0.25, "bad": "x"}})
        await feed(mid, chunk(record(spans)))
        reply = protowire.encode_query_result(
            99, {"partial": {}, "missing": []}, generation=2)
        await feed(leaf, chunk(record(reply)))
        clock.advance(1.0)
        await feed(leaf, chunk(record(leaf_frame(gen=2, lag=9.0))))
        v = check("lagging frame and relayed offsets")
        assert v["json"]["nodes"]["leaf0"]["generation"] == 2
        assert any("rollup lag" in e["msg"] for e in v["events"])
        assert "fed.deep.freshness_ms" in v["series"]
        # Silence: the leaf goes dark, the lower aggregator keeps talking.
        for _ in range(4):
            clock.advance(1.0)
            await feed(mid, chunk(record(slice_frame())))
        for s in samplers:
            s.federation.check_staleness()
        v = check("leaf dark")
        assert v["json"]["nodes"]["leaf0"]["status"] == "down"
        assert {r["health"] for r in v["slices"]
                if r["node"] == "leaf0"} == {"dark"}
        assert "tpumon_federation_downstream_up{node=\"leaf0\"" in (
            v["exporter"])
        # The old stream ends; a new one opens with a keyframe.
        for st in leaf:
            st.end()
        await settle()
        check("leaf stream ended")
        for e in enc:
            e.reset()
        leaf = [Stream(s, "leaf0", "leaf") for s in samplers]
        await settle()
        clock.advance(1.0)
        await feed(leaf, chunk(record(leaf_frame(gen=2))))
        v = check("leaf recovered")
        assert v["json"]["nodes"]["leaf0"]["resyncs"] == 1
        assert any("recovered" in e["msg"] for e in v["events"])
        # A frame the decoder refuses: 400 back down the stream.
        await feed(leaf, chunk(record(b"TPWD" + b"\x00" * 7)))
        await settle()
        v = check("refused frame")
        assert leaf[0].writer.data == leaf[1].writer.data
        assert leaf[0].writer.data.startswith(b"HTTP/1.1 400 ")
        assert any("refused frame" in e["msg"] for e in v["events"])
        # The lower aggregator vanishes long enough to be forgotten.
        for st in mid:
            st.end()
        await settle()
        clock.advance(5.0)
        for s in samplers:
            s.federation.check_staleness()
        check("aggregator unreachable")
        clock.advance(600.0)
        for s in samplers:
            s.federation.check_staleness()
        v = check("forgotten")
        assert "agg1" not in v["json"]["nodes"]
        assert any("forgotten" in e["msg"] for e in v["events"])
        for st in leaf + mid:
            st.task.cancel()
        await asyncio.gather(*(st.task for st in leaf + mid),
                             return_exceptions=True)
        return views

    views = asyncio.run(scenario())
    assert len(views) >= 15
