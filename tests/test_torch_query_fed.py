"""The port's distributed queries as a port-only counterpart of
``tests/test_query_fed.py``: a leaf, an aggregator and a root, each a port
app with a live sampler loop (as in ``tests/test_torch_federation_tree.py``)
— the root plans a fleet query, pushes TPWQ sub-queries down the open
federation ingest streams, and merges TPWR partial aggregates:

- fleet ``topk`` and ``quantile`` answers EQUAL a root-side brute force
  over all leaf points (same evaluation instant);
- the uplink bytes spent answering stay a small fraction of the raw
  points they summarize (partial aggregates, never raw points);
- a dark leaf degrades the answer to an explicit ``partial`` marker
  with the missing subtree named — plus ``query`` journal events —
  instead of an error;
- one fleet query against the tree is one trace across every node;
- the TPWQ/TPWR codecs refuse truncation at every prefix.
"""

import asyncio
import json
import time
import urllib.request

import pytest

from tpumon_torch.app import build
from tpumon_torch.config import load_config
from tpumon_torch.query import _quantile

INTERVAL_S = 0.1
DARK_AFTER_S = 0.6


def _mk(**env):
    base = {
        "TPUMON_PORT": "0",
        "TPUMON_HOST": "127.0.0.1",
        "TPUMON_K8S_MODE": "none",
        "TPUMON_COLLECTORS": "accel",
        "TPUMON_SAMPLE_INTERVAL_S": str(INTERVAL_S),
        "TPUMON_FEDERATION_DARK_AFTER_S": str(DARK_AFTER_S),
    }
    base.update(env)
    return build(load_config(env=base))


async def wait_until(fn, what: str, timeout_s: float = 20.0):
    t0 = time.monotonic()
    while True:
        v = fn()
        if asyncio.iscoroutine(v):
            v = await v
        if v:
            return v
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"query-fed soak: timed out waiting for {what}")
        await asyncio.sleep(0.05)


def _get_sync(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10
    ) as r:
        return json.loads(r.read())


def test_fleet_query_soak():
    async def scenario():
        nodes = []
        try:
            root_s, root_srv = _mk(
                TPUMON_ACCEL_BACKEND="none",
                TPUMON_FEDERATION_ROLE="root",
                TPUMON_FEDERATION_NODE="root",
            )
            await root_srv.start()
            await root_s.start()
            nodes.append((root_s, root_srv))
            agg_s, agg_srv = _mk(
                TPUMON_ACCEL_BACKEND="none",
                TPUMON_FEDERATION_ROLE="aggregator",
                TPUMON_FEDERATION_NODE="agg0",
                TPUMON_FEDERATE_UP=f"http://127.0.0.1:{root_srv.port}",
            )
            await agg_srv.start()
            await agg_s.start()
            await agg_s.uplink.start()
            nodes.append((agg_s, agg_srv))
            leaves = []
            for n in ("leaf0", "leaf1"):
                s, srv = _mk(
                    TPUMON_ACCEL_BACKEND=f"fake:v5e-8@{n}",
                    TPUMON_FEDERATION_NODE=n,
                    TPUMON_FEDERATE_UP=f"http://127.0.0.1:{agg_srv.port}",
                )
                s.uplink.backoff_max_s = 0.4
                await s.start()
                await s.uplink.start()
                leaves.append(s)
                nodes.append((s, srv))
            await wait_until(
                lambda: sum(
                    1
                    for ns in agg_s.federation.nodes.values()
                    if ns.connected
                ) == 2,
                "both leaves connected",
            )
            # A few ticks of per-chip history everywhere (rate needs >= 2
            # points per series).
            await asyncio.sleep(12 * INTERVAL_S)

            # --- topk: EQUAL to a root-side brute force over all leaf
            #     points, at the SAME evaluation instant -----------------
            at = time.time()
            expr = "topk(5,avg_over_time(chip.mxu[5s]))"
            out = await asyncio.to_thread(
                _get_sync, root_srv.port,
                f"/api/query?query={expr}&fleet=1&time={at!r}",
            )
            assert out["fleet"] is True and not out.get("partial"), out
            brute = []
            for s in leaves:
                r = s.query.instant("avg_over_time(chip.mxu[5s])", at=at)
                brute += [
                    (x["value"], tuple(sorted(x["labels"].items())))
                    for x in r["result"]
                ]
            brute.sort(reverse=True)
            got = [
                (r["value"], tuple(sorted(r["labels"].items())))
                for r in out["result"]
            ]
            assert got == brute[:5]
            assert len({lb for _, lb in got}) == 5  # 5 distinct chips

            # --- quantile: exact via the under-cap sketch ---------------
            qexpr = "quantile(0.9,chip.hbm)"
            out = await asyncio.to_thread(
                _get_sync, root_srv.port,
                f"/api/query?query={qexpr}&fleet=1&time={at!r}",
            )
            vals = []
            for s in leaves:
                vals += [
                    x["value"]
                    for x in s.query.instant("chip.hbm", at=at)["result"]
                ]
            assert out["result"][0]["value"] == pytest.approx(
                _quantile(sorted(vals), 0.9), abs=1e-12
            )

            # --- wire cost: TPWR partials are CONSTANT-size — bounded
            #     per answer, and independent of how many raw points
            #     they summarize (the "never ships raw points upstream"
            #     contract; at bench scale the ratio is ~1e-4) ----------
            q_bytes = sum(s.uplink.query_bytes for s in leaves)
            answered = sum(s.uplink.queries_answered for s in leaves)
            assert answered >= 4  # both leaves, both queries
            per_answer = q_bytes / answered
            assert per_answer < 1500, per_answer
            # Grow the rings substantially, re-ask: the marginal answer
            # must not grow with the point count.
            pts0 = sum(s.history.count_points() for s in leaves)
            await asyncio.sleep(25 * INTERVAL_S)
            await wait_until(
                lambda: sum(s.history.count_points() for s in leaves)
                > 2 * pts0,
                "leaf rings grew",
            )
            b0 = sum(s.uplink.query_bytes for s in leaves)
            a0 = sum(s.uplink.queries_answered for s in leaves)
            await asyncio.to_thread(
                _get_sync, root_srv.port,
                f"/api/query?query={qexpr}&fleet=1",
            )
            marginal = (
                sum(s.uplink.query_bytes for s in leaves) - b0
            ) / max(1, sum(s.uplink.queries_answered for s in leaves) - a0)
            assert marginal < 1500, (
                f"TPWR answer grew to {marginal}B after the ring doubled "
                f"— that is not a partial-aggregate push-down"
            )

            # --- non-aggregate fleet queries are a 400, not a hang ------
            import urllib.error

            def bad():
                try:
                    _get_sync(
                        root_srv.port, "/api/query?query=chip.mxu&fleet=1"
                    )
                except urllib.error.HTTPError as e:
                    return e.code

            assert await asyncio.to_thread(bad) == 400

            # --- dark leaf: explicit partial + query journal event ------
            dead = leaves[1]
            await dead.stop()
            await wait_until(
                lambda: any(
                    ns.status != "ok" or not ns.connected
                    for ns in agg_s.federation.nodes.values()
                ),
                "aggregator notices the dark leaf",
            )
            out = await asyncio.to_thread(
                _get_sync, root_srv.port,
                f"/api/query?query={qexpr}&fleet=1",
            )
            assert out.get("partial") is True
            assert any("leaf1" in m for m in out["missing"]), out["missing"]
            assert out["result"], "surviving subtree still answers"
            ev = await asyncio.to_thread(
                _get_sync, root_srv.port, "/api/events?kind=query"
            )
            assert any(
                "partial" in e["msg"] for e in ev["events"]
            ), ev["events"]
            # Transition-only journaling: re-asking while the SAME leaf
            # stays dark must not add events (a polling dashboard can't
            # flood the ring with one identical event per poll).
            n_events = len(ev["events"])
            for _ in range(3):
                await asyncio.to_thread(
                    _get_sync, root_srv.port,
                    f"/api/query?query={qexpr}&fleet=1",
                )
            ev2 = await asyncio.to_thread(
                _get_sync, root_srv.port, "/api/events?kind=query"
            )
            assert len(ev2["events"]) == n_events, ev2["events"][n_events:]
        finally:
            for s, srv in nodes:
                try:
                    await s.stop()
                except Exception:
                    pass
                try:
                    await srv.stop()
                except Exception:
                    pass

    asyncio.run(scenario())


def test_fleet_query_trace_assembles_across_tree():
    """A fleet query against a live 2-level tree
    produces ONE trace — the root's HTTP span, the aggregator's
    ``fed.query``, and each leaf's ``fed.query`` all share a trace id,
    with parent linkage pointing the right way (leaf → agg → root).
    Downstream spans reach the root over the uplink ``TPWS`` records
    (leaves ship to agg, agg relays), never as raw rings."""

    async def scenario():
        nodes = []
        try:
            root_s, root_srv = _mk(
                TPUMON_ACCEL_BACKEND="none",
                TPUMON_FEDERATION_ROLE="root",
                TPUMON_FEDERATION_NODE="root",
            )
            await root_srv.start()
            await root_s.start()
            nodes.append((root_s, root_srv))
            agg_s, agg_srv = _mk(
                TPUMON_ACCEL_BACKEND="none",
                TPUMON_FEDERATION_ROLE="aggregator",
                TPUMON_FEDERATION_NODE="agg0",
                TPUMON_FEDERATE_UP=f"http://127.0.0.1:{root_srv.port}",
            )
            await agg_srv.start()
            await agg_s.start()
            await agg_s.uplink.start()
            nodes.append((agg_s, agg_srv))
            for n in ("leaf0", "leaf1"):
                s, srv = _mk(
                    TPUMON_ACCEL_BACKEND=f"fake:v5e-8@{n}",
                    TPUMON_FEDERATION_NODE=n,
                    TPUMON_FEDERATE_UP=f"http://127.0.0.1:{agg_srv.port}",
                )
                s.uplink.backoff_max_s = 0.4
                await s.start()
                await s.uplink.start()
                nodes.append((s, srv))
            await wait_until(
                lambda: sum(
                    1
                    for ns in agg_s.federation.nodes.values()
                    if ns.connected
                ) == 2,
                "both leaves connected",
            )
            await asyncio.sleep(12 * INTERVAL_S)

            out = await asyncio.to_thread(
                _get_sync, root_srv.port,
                "/api/query?query=sum(chip.mxu)&fleet=1",
            )
            assert out["fleet"] is True and not out.get("partial"), out

            def assembled():
                """tid -> {node: [span, ...]} over the root's fleet
                view; truthy when one trace covers every live node."""
                t = _get_sync(root_srv.port, "/api/trace?fleet=1")
                by_tid: dict[str, dict[str, list]] = {}
                for sp in t["fleet"]["spans"]:
                    tid = sp.get("trace")
                    if tid:
                        by_tid.setdefault(tid, {}).setdefault(
                            sp["node"], []).append(sp)
                for tid, per_node in by_tid.items():
                    if {"root", "agg0", "leaf0", "leaf1"} <= set(per_node):
                        return per_node
                return None

            # Blocking HTTP must poll OFF the loop thread (the servers
            # share this loop): to_thread returns a coroutine, which
            # wait_until awaits.
            per_node = await wait_until(
                lambda: asyncio.to_thread(assembled),
                "one trace spanning every live node", timeout_s=20.0,
            )
            # Linkage points DOWN the tree: each leaf's fed.query is
            # remote-parented on agg0's, agg0's on the root's context.
            for leaf in ("leaf0", "leaf1"):
                q = [s for s in per_node[leaf] if s["name"] == "fed.query"]
                assert q, per_node[leaf]
                assert all(s["rp"][0] == "agg0" for s in q), q
            agg_q = [s for s in per_node["agg0"]
                     if s["name"] == "fed.query"]
            assert agg_q and all(s["rp"][0] == "root" for s in agg_q), agg_q
            # The agg's remote parent sid is a real root-side span of
            # the same trace (the query's serving context), so the
            # assembled tree is connected, not four orphan fragments.
            root_sids = {s["sid"] for s in per_node["root"]}
            assert any(s["rp"][1] in root_sids for s in agg_q), (
                agg_q, root_sids)
            # A leaf ships only completed own spans — bounded, never
            # the raw ring.
            leaf_uplinks = [s.uplink for s, _ in nodes if s.uplink]
            assert all(u.spans_shipped <= 4096 for u in leaf_uplinks)
            assert any(u.trace_bytes > 0 for u in leaf_uplinks)
            # Regression: the federation ingest
            # route must appear in /api/trace's per-route p95 table —
            # per-frame CLOSED fed.ingest spans feed it; the
            # never-ending chunked POST itself can't.
            t = await asyncio.to_thread(
                _get_sync, root_srv.port, "/api/trace")
            ingest = t["http"].get("/api/federation/ingest")
            assert ingest and ingest["count"] >= 1, t["http"].keys()
            assert ingest["p95_ms"] < 10_000.0, ingest
        finally:
            for s, srv in nodes:
                try:
                    await s.stop()
                except Exception:
                    pass
                try:
                    await srv.stop()
                except Exception:
                    pass

    asyncio.run(scenario())


def test_query_frames_refuse_truncation_everywhere():
    from tpumon_torch.protowire import (
        decode_query_request,
        decode_query_result,
        encode_query_request,
        encode_query_result,
    )

    req = encode_query_request(7, "topk(5, rate(chip.hbm[1m]))", 123.5, 2.0)
    assert decode_query_request(req) == (
        7, "topk(5, rate(chip.hbm[1m]))", 123.5, 2.0, 0, None
    )
    res = encode_query_result(
        7, {"partial": {"op": "sum", "groups": []}, "missing": ["x"]},
        partial=True,
    )
    qid, partial, error, payload, _gen, _trace = decode_query_result(res)
    assert (qid, partial, error) == (7, True, None)
    assert payload["missing"] == ["x"]
    err = encode_query_result(9, None, error="boom")
    assert decode_query_result(err)[2] == "boom"
    for blob in (req, res):
        for i in range(len(blob)):
            with pytest.raises(ValueError):
                decode_query_request(blob[:i])
            with pytest.raises(ValueError):
                decode_query_result(blob[:i])
    # Trailing garbage refused too. (A lone valid varint is
    # indistinguishable from the optional generation trailer by design
    # — append-only compat — so the garbage here is an incomplete
    # varint, which nothing legitimate emits.)
    with pytest.raises(ValueError):
        decode_query_request(req + b"\x80")
    with pytest.raises(ValueError):
        decode_query_result(res + b"\x80")
