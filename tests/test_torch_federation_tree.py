"""The port's federation tree as a port-only counterpart of
``tests/test_federation_tree.py``: a leaf, an aggregator and a root, each a
port app (``tpumon_torch.app.build``) with a live sampler loop and a real
server in one event loop. The leaf pushes one delta frame a tick up a
long-lived chunked POST (``tpumon_torch.federation``), the aggregator
lands chips and slice rollups and pushes slice rows to the root, and the
root serves the fleet view:

- the root's fleet view is fresh within 2 ticks of a leaf sample;
- killing the leaf flips its slice to health="dark" at the aggregator
  AND the root, and fires a serious ``federation`` event;
- a leaf restart resyncs via keyframe with no duplicated TSDB points;
- an aggregator restart severs both sides, and the leaf's reconnecting
  uplink re-establishes the whole chain (keyframe resync) — the root
  distinguishes the partitioned aggregator ("unreachable") from a
  reported-dark slice;
- steady-state upstream bytes per tick stay <= 25% of a keyframe;
- with an auth token set, the ingest route refuses an unauthenticated
  push and takes the uplink that carries the token.
"""

import asyncio
import json
import time
import urllib.request

from tpumon_torch.app import build
from tpumon_torch.config import load_config

INTERVAL_S = 0.1
DARK_AFTER_S = 0.6


def get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def _mk(**env):
    base = {
        "TPUMON_PORT": "0",
        "TPUMON_HOST": "127.0.0.1",
        "TPUMON_K8S_MODE": "none",
        "TPUMON_COLLECTORS": "accel",
        "TPUMON_SAMPLE_INTERVAL_S": str(INTERVAL_S),
        "TPUMON_FEDERATION_DARK_AFTER_S": str(DARK_AFTER_S),
        "TPUMON_HISTORY_PER_CHIP": "0",
    }
    base.update(env)
    return build(load_config(env=base))


async def wait_until(fn, what: str, timeout_s: float = 20.0):
    """Poll ``fn`` — sync or async — until truthy while the sampler
    loops run. Blocking I/O belongs in async fns (via to_thread): the
    servers under test share this event loop."""
    t0 = time.monotonic()
    while True:
        v = fn()
        if asyncio.iscoroutine(v):
            v = await v
        if v:
            return v
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"federation soak: timed out waiting for {what}")
        await asyncio.sleep(0.05)


def _slices_sync(port):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/federation", timeout=5
        ) as r:
            return {
                s["slice_id"]: s for s in json.loads(r.read()).get("slices", [])
            }
    except OSError:
        return {}


async def _slices(port):
    return await asyncio.to_thread(_slices_sync, port)


async def _slice_health(port, sid="slice-0"):
    return ((await _slices(port)).get(sid) or {}).get("health")


def _health_is(port, want):
    async def check():
        return (await _slice_health(port)) == want

    return check


def test_federation_tree_soak():
    async def scenario():
        # --- bring up the tree root-first (uplinks retry anyway) ----
        root_s, root_srv = _mk(
            TPUMON_ACCEL_BACKEND="none",
            TPUMON_FEDERATION_ROLE="root",
            TPUMON_FEDERATION_NODE="root",
        )
        await root_srv.start()
        await root_s.start()
        agg_s, agg_srv = _mk(
            TPUMON_ACCEL_BACKEND="none",
            TPUMON_FEDERATION_ROLE="aggregator",
            TPUMON_FEDERATION_NODE="agg0",
            TPUMON_FEDERATE_UP=f"http://127.0.0.1:{root_srv.port}",
        )
        await agg_srv.start()
        agg_port = agg_srv.port
        await agg_s.start()
        await agg_s.uplink.start()

        def leaf(n="leaf0"):
            s, srv = _mk(
                TPUMON_ACCEL_BACKEND=f"fake:v5e-8@{n}",
                TPUMON_FEDERATION_NODE=n,
                TPUMON_FEDERATE_UP=f"http://127.0.0.1:{agg_port}",
            )
            s.uplink.backoff_max_s = 0.4
            return s, srv

        leaf_s, leaf_srv = leaf()
        await leaf_srv.start()
        await leaf_s.start()
        await leaf_s.uplink.start()

        # --- fleet view converges, and is FRESH (<= 2 leaf ticks) ----
        async def root_ok():
            rows = await _slices(root_srv.port)
            r = rows.get("slice-0")
            return r if r and r["chips"] == 8 and r["health"] == "ok" else None

        row = await wait_until(root_ok, "root fleet view")
        # Freshness: the slice row's ts is the LEAF's own sample time;
        # push latency root-side must be within 2 leaf ticks (+ sched
        # slack for three busy event-driven servers in one loop).
        age = time.time() - row["ts"]
        assert age <= 2 * INTERVAL_S + 0.35, f"fleet view {age:.2f}s stale"
        assert row["node"] == "leaf0"
        assert row["duty_mean"] is not None and row["duty_p95"] is not None
        # Rollups landed in BOTH upper tiers' TSDBs as slice.* series...
        for s in (agg_s, root_s):
            assert "slice.leaf0.slice-0.duty" in s.history.series
            assert "slice.leaf0.slice-0.duty_p95" in s.history.series
        # ...and /api/history serves them (per_slice, glob-filtered).
        h = await asyncio.to_thread(
            get_json, agg_port, "/api/history?series=slice.*"
        )
        assert "leaf0.slice-0.duty" in h["per_slice"]
        assert h["per_slice"]["leaf0.slice-0.duty"]["data"]
        # The aggregator's merged accel view carries the leaf's chips.
        d = await asyncio.to_thread(get_json, agg_port, "/api/accel/metrics")
        assert len(d["chips"]) == 8
        assert d["health"]["ok"] is True  # dark-free tree, healthy accel

        # --- steady-state wire cost: deltas <= 25% of a keyframe -----
        await wait_until(
            lambda: leaf_s.uplink.enc.stats["delta_frames"] >= 8,
            "steady-state delta frames",
        )
        st = leaf_s.uplink.enc.stats
        assert (
            st["delta_bytes"] / st["delta_frames"]
            <= 0.25 * st["keyframe_bytes"]
        ), st

        # --- kill the leaf: slice dark + serious federation event ----
        await leaf_s.stop()
        await leaf_srv.stop()
        await wait_until(
            _health_is(agg_port, "dark"), "aggregator marks slice dark"
        )
        await wait_until(
            _health_is(root_srv.port, "dark"), "dark propagates to root"
        )
        ev = await asyncio.to_thread(
            get_json, agg_port, "/api/events?kind=federation"
        )
        assert any(
            e["severity"] == "serious" and "dark" in e["msg"]
            for e in ev["events"]
        ), ev["events"]
        # The dark slice DEGRADES the accel sample's error note but must
        # not fail it (a remote leaf can't lock out local collection).
        d = await asyncio.to_thread(get_json, agg_port, "/api/accel/metrics")
        assert d["health"]["ok"] is True
        assert "dark" in (d["health"].get("error") or "")

        # --- leaf restart: keyframe resync, no duplicated points -----
        leaf_s2, leaf_srv2 = leaf()
        await leaf_srv2.start()
        await leaf_s2.start()
        await leaf_s2.uplink.start()
        await wait_until(
            _health_is(root_srv.port, "ok"), "root recovers after leaf restart"
        )
        ns = agg_s.federation.nodes["leaf0"]
        assert ns.keyframes >= 2 and ns.resyncs >= 1
        pts = list(agg_s.history.series["slice.leaf0.slice-0.duty"].points)
        ts_list = [p[0] for p in pts]
        assert len(ts_list) >= 3
        assert all(a < b for a, b in zip(ts_list, ts_list[1:])), (
            "duplicated/reordered rollup points after resync"
        )

        # --- aggregator restart: root sees "unreachable", then the
        #     reconnecting uplinks re-establish the chain -------------
        await agg_s.stop()
        await agg_srv.stop()
        await wait_until(
            _health_is(root_srv.port, "unreachable"),
            "root marks partitioned aggregator subtree unreachable",
        )
        agg_s2, agg_srv2 = _mk(
            TPUMON_PORT=str(agg_port),  # same address the leaf pushes to
            TPUMON_ACCEL_BACKEND="none",
            TPUMON_FEDERATION_ROLE="aggregator",
            TPUMON_FEDERATION_NODE="agg0",
            TPUMON_FEDERATE_UP=f"http://127.0.0.1:{root_srv.port}",
        )
        for _ in range(40):  # the freed port can linger briefly
            try:
                await agg_srv2.start()
                break
            except OSError:
                await asyncio.sleep(0.1)
        else:
            raise AssertionError("aggregator port never came free")
        await agg_s2.start()
        await agg_s2.uplink.start()
        await wait_until(
            _health_is(root_srv.port, "ok"),
            "tree recovers after aggregator restart",
        )
        # The leaf's uplink observed the outage and resynced.
        assert leaf_s2.uplink.resyncs >= 1
        assert leaf_s2.uplink.enc.stats["keyframes"] >= 2

        for s, srv in (
            (leaf_s2, leaf_srv2), (agg_s2, agg_srv2), (root_s, root_srv),
        ):
            await s.stop()
            await srv.stop()

    asyncio.run(scenario())


def test_ingest_route_honors_auth_token():
    """/api/federation/ingest is a POST like any other: with auth_token
    configured, an unauthenticated push is refused (401) and an uplink
    carrying the Bearer token streams fine — forged frames must not
    land in the fleet view."""
    import urllib.error

    async def scenario():
        agg_s, agg_srv = _mk(
            TPUMON_ACCEL_BACKEND="none",
            TPUMON_FEDERATION_ROLE="aggregator",
            TPUMON_FEDERATION_NODE="agg0",
            TPUMON_AUTH_TOKEN="s3cret",
        )
        await agg_srv.start()
        await agg_s.start()

        def push_unauth():
            req = urllib.request.Request(
                f"http://127.0.0.1:{agg_srv.port}/api/federation/ingest",
                data=b"junk", method="POST",
            )
            try:
                with urllib.request.urlopen(req, timeout=5) as r:
                    return r.status
            except urllib.error.HTTPError as e:
                return e.code

        assert await asyncio.to_thread(push_unauth) == 401
        assert not agg_s.federation.nodes  # nothing registered

        leaf_s, leaf_srv = _mk(
            TPUMON_ACCEL_BACKEND="fake:v5e-4@leafT",
            TPUMON_FEDERATION_NODE="leafT",
            TPUMON_FEDERATE_UP=f"http://127.0.0.1:{agg_srv.port}",
            TPUMON_AUTH_TOKEN="s3cret",  # fleet-wide token
        )
        await leaf_s.start()
        await leaf_s.uplink.start()
        await wait_until(
            lambda: "leafT" in agg_s.federation.nodes
            and agg_s.federation.nodes["leafT"].frames > 0,
            "authenticated uplink streams",
        )
        for s, srv in ((leaf_s, leaf_srv), (agg_s, agg_srv)):
            await s.stop()
            await srv.stop()

    asyncio.run(scenario())
