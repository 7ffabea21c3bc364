"""Mixed-package federation trees: the port's wire and the reference's are one
wire.

In one event loop, two trees run side by side, each node an app of one
package (``build``) with a live sampler loop and a real server:

- tree P: a port leaf → a reference aggregator → a port root;
- tree R: a reference leaf → a port aggregator → a reference root.

Both leaves read the same seeded chip table (a static collector per
package), so their own histories, and the fleet queries the roots push
down to them, hold the same data. Both uplinks encode the same seeded,
evolving chip tables at the same timestamps (their encoders are wrapped
to take frame ``i``'s table and time), so the two packages must put the
same bytes on the wire frame for frame, and each aggregator must land the
other package's frames without a refused frame. The two roots must show
the same slices and give the same fleet answers (an aggregate, a ``topk``
and a quantile), and after the leaves are stopped both answers must carry
the same explicit ``partial`` marker naming the missing leaf. Finally the
query frames each package encodes are refused by the other package's
decoder at every truncated prefix (with the optional generation and trace
trailers, a prefix that ends where a trailer starts is an older sender's
whole frame, and both packages read every prefix alike).
"""

import asyncio
import json
import time
import types
import urllib.parse
import urllib.request

import numpy as np
import pytest

from tests.test_torch_federation import chip_rows, columns
from tpumon import app as ref_app
from tpumon import collectors as ref_collectors
from tpumon import federation as ref_fed
from tpumon import protowire as ref_pw
from tpumon import topology as ref_topo
from tpumon.config import load_config as ref_load_config
from tpumon_torch import app, collectors, federation, protowire, topology
from tpumon_torch.config import load_config

PORT = types.SimpleNamespace(app=app, load=load_config, topo=topology,
                             Sample=collectors.Sample, fed=federation)
REF = types.SimpleNamespace(app=ref_app, load=ref_load_config, topo=ref_topo,
                            Sample=ref_collectors.Sample, fed=ref_fed)
INTERVAL_S = 0.1
DARK_AFTER_S = 0.6
FRAMES = 12


class StaticCollector:
    """One seeded chip table, the same every tick."""

    name = "accel"

    def __init__(self, side, rows):
        self.side = side
        self.rows = rows

    async def collect(self):
        chips = self.side.topo.chips_from_columns(
            list(self.side.topo.WIRE_FIELDS), columns(self.rows))
        return self.side.Sample(source="accel", ok=True, data=chips)


def mk(side, **env):
    base = {
        "TPUMON_PORT": "0",
        "TPUMON_HOST": "127.0.0.1",
        "TPUMON_K8S_MODE": "none",
        "TPUMON_COLLECTORS": "accel",
        "TPUMON_SAMPLE_INTERVAL_S": str(INTERVAL_S),
        "TPUMON_FEDERATION_DARK_AFTER_S": str(DARK_AFTER_S),
    }
    base.update(env)
    return side.app.build(side.load(env=base))


def get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


async def wait_until(fn, what, timeout_s=20.0):
    t0 = time.monotonic()
    while True:
        v = await asyncio.to_thread(fn)
        if v:
            return v
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"mixed trees: timed out waiting for {what}")
        await asyncio.sleep(0.05)


def frame_table(i: int) -> list[list]:
    """Frame ``i``'s chip table: the leaf's rows with a seeded share of
    readings moved, quantized as the uplink quantizes them."""
    rows = [list(r) for r in chip_rows(3, "leafx", n=8, hosts=2, slices=2)]
    rng = np.random.default_rng(1000 + i)
    for r in rows:
        if rng.random() < 0.5:
            r[6] = float(rng.uniform(0, 100))
        if rng.random() < 0.25:
            r[9] = float(rng.uniform(30, 90))
    federation._quantize_rows(list(topology.WIRE_FIELDS), rows,
                              federation._F32_CHIP_FIELDS)
    return rows


def tap(uplink, base_ts: float) -> list[bytes]:
    """Make the uplink's encoder take frame ``i``'s table and timestamp,
    and keep every frame it encodes."""
    frames: list[bytes] = []
    encode = uplink.enc.encode

    def wrapped(v, fields, rows, ts):
        i = len(frames)
        out = encode(v, list(topology.WIRE_FIELDS), frame_table(i),
                     base_ts + 0.25 * i)
        frames.append(out[0])
        return out

    uplink.enc.encode = wrapped
    return frames


def test_mixed_package_trees_share_one_wire():
    leaf_rows = chip_rows(3, "leafx", n=8, hosts=2, slices=2)

    async def scenario():
        nodes = []
        trees = {}
        base_ts = time.time()
        try:
            for name, (leaf_side, agg_side, root_side) in (
                    ("P", (PORT, REF, PORT)), ("R", (REF, PORT, REF))):
                root_s, root_srv = mk(
                    root_side, TPUMON_ACCEL_BACKEND="none",
                    TPUMON_FEDERATION_ROLE="root",
                    TPUMON_FEDERATION_NODE="root")
                await root_srv.start()
                await root_s.start()
                nodes.append((root_s, root_srv))
                agg_s, agg_srv = mk(
                    agg_side, TPUMON_ACCEL_BACKEND="none",
                    TPUMON_FEDERATION_ROLE="aggregator",
                    TPUMON_FEDERATION_NODE="agg0",
                    TPUMON_FEDERATE_UP=f"http://127.0.0.1:{root_srv.port}")
                await agg_srv.start()
                await agg_s.start()
                await agg_s.uplink.start()
                nodes.append((agg_s, agg_srv))
                leaf_s, leaf_srv = mk(
                    leaf_side, TPUMON_ACCEL_BACKEND="none",
                    TPUMON_FEDERATION_NODE="leafx",
                    TPUMON_FEDERATE_UP=f"http://127.0.0.1:{agg_srv.port}",
                    # No trace trailer: its trace ids are random draws.
                    TPUMON_TRACE_RING="0")
                leaf_s.accel = StaticCollector(leaf_side, leaf_rows)
                leaf_s.uplink.backoff_max_s = 0.4
                frames = tap(leaf_s.uplink, base_ts)
                await leaf_s.start()
                await leaf_s.uplink.start()
                nodes.append((leaf_s, leaf_srv))
                trees[name] = types.SimpleNamespace(
                    root=root_s, root_port=root_srv.port, agg=agg_s,
                    leaf=leaf_s, frames=frames)

            for t in trees.values():
                await wait_until(
                    lambda t=t: len(t.frames) >= FRAMES
                    and t.agg.federation.nodes.get("leafx") is not None
                    and t.agg.federation.nodes["leafx"].frames >= FRAMES,
                    "frames landing across packages")
            p, r = trees["P"].frames, trees["R"].frames
            n = min(len(p), len(r))
            assert n >= FRAMES and p[:n] == r[:n]
            for t in trees.values():
                ns = t.agg.federation.nodes["leafx"]
                assert ns.keyframes == 1 and ns.resyncs == 0 and not ns.error
                assert len(ns.chips) == 8

            def slices(t):
                rows = get_json(t.root_port, "/api/federation")["slices"]
                return sorted((s["slice_id"], s["node"], s["chips"],
                               s["hosts"], s["health"], s["accel_kind"])
                              for s in rows)

            want = [("slice-0", "leafx", 4, 2, "ok", "tpu"),
                    ("slice-1", "leafx", 4, 2, "ok", "tpu")]
            for t in trees.values():
                await wait_until(lambda t=t: slices(t) == want,
                                 "both roots see the leaf's slices")
            await asyncio.sleep(5 * INTERVAL_S)

            def fleet(t, expr, at):
                q = urllib.parse.quote(expr)
                return get_json(t.root_port,
                                f"/api/query?query={q}&fleet=1&time={at!r}")

            at = time.time()
            for expr in ("sum(chip.hbm)", "topk(3, chip.mxu)",
                         "quantile(0.9, chip.temp)",
                         "avg by (slice) (chip.mxu)"):
                got = [await asyncio.to_thread(fleet, t, expr, at)
                       for t in trees.values()]
                assert got[0] == got[1], expr
                assert got[0]["result"] and not got[0].get("partial"), got[0]
            for t in trees.values():
                assert t.leaf.uplink.queries_answered >= 4

            for t in trees.values():
                await t.leaf.stop()
            for t in trees.values():
                await wait_until(
                    lambda t=t: fleet(t, "sum(chip.hbm)", time.time()).get(
                        "partial"), "partial answers at both roots")
            got = [await asyncio.to_thread(fleet, t, "sum(chip.hbm)",
                                           time.time())
                   for t in trees.values()]
            assert [g["missing"] for g in got] == [["agg0/leafx"]] * 2
            assert [g["result"] for g in got] == [[], []]
        finally:
            for s, srv in nodes:
                for stop in (s.stop, srv.stop):
                    try:
                        await stop()
                    except Exception:
                        pass

    asyncio.run(scenario())


def outcome(decode, blob):
    try:
        return decode(blob)
    except ValueError:
        return "refused"


@pytest.mark.parametrize("enc,dec", [(protowire, ref_pw), (ref_pw, protowire)],
                         ids=["port_to_ref", "ref_to_port"])
def test_query_frames_refuse_truncation_across_packages(enc, dec):
    req = enc.encode_query_request(7, "topk(5, rate(chip.hbm[1m]))", 123.5, 2.0)
    res = enc.encode_query_result(
        7, {"partial": {"op": "sum", "groups": []}, "missing": ["x"]},
        partial=True)
    err = enc.encode_query_result(9, None, error="boom")
    assert dec.decode_query_request(req) == (
        7, "topk(5, rate(chip.hbm[1m]))", 123.5, 2.0, 0, None)
    qid, partial, error, payload, _gen, _trace = dec.decode_query_result(res)
    assert (qid, partial, error) == (7, True, None)
    assert payload["missing"] == ["x"]
    assert dec.decode_query_result(err)[2] == "boom"
    for blob in (req, res, err):
        for i in range(len(blob)):
            with pytest.raises(ValueError):
                dec.decode_query_request(blob[:i])
            with pytest.raises(ValueError):
                dec.decode_query_result(blob[:i])
    with pytest.raises(ValueError):
        dec.decode_query_request(req + b"\x80")
    with pytest.raises(ValueError):
        dec.decode_query_result(res + b"\x80")
    # With the optional generation and trace trailers, a prefix cut where
    # a trailer starts is an older sender's whole frame; every other
    # prefix is refused, and both packages read every prefix alike.
    req = enc.encode_query_request(
        7, "topk(5, rate(chip.hbm[1m]))", 123.5, 2.0, generation=3,
        trace=(12345, 67, "root"))
    res = enc.encode_query_result(
        7, {"partial": {"op": "sum", "groups": []}, "missing": ["x"]},
        partial=True, generation=3, trace=(12345, 68, "agg0"))
    assert dec.decode_query_request(req) == (
        7, "topk(5, rate(chip.hbm[1m]))", 123.5, 2.0, 3, (12345, 67, "root"))
    assert dec.decode_query_result(res)[4:] == (3, (12345, 68, "agg0"))
    for blob, name in ((req, "decode_query_request"),
                       (res, "decode_query_result")):
        got = [outcome(getattr(dec, name), blob[:i]) for i in range(len(blob))]
        assert got == [outcome(getattr(enc, name), blob[:i])
                       for i in range(len(blob))]
        whole = [g for g in got if g != "refused"]
        assert len(whole) == 2 and whole[0][4:] == (0, None)
        assert whole[1][4:] == (3, None)
