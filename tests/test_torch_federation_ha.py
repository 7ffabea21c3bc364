"""The port's root HA as a port-only counterpart of
``tests/test_federation_ha.py``: the federation tree survives the death of
its own root. A real leaf → aggregator → active+standby root pair, every
node a port app, the aggregator dual-homed (``federate_up``
primary,standby), both roots scraping the port's traffic-sim serving
engine (``tpumon_torch.loadgen``, its tiny default model on the CPU) so
the SLO burn page and the shed remedy live on BOTH roots — then the
active root is killed mid-burn:

- while the active root leads, the standby's identical policy set is
  FENCED (``actuate``/``fenced`` journal events, zero engine actions:
  two roots can never both shed);
- the kill promotes the standby with a bumped generation (fencing
  token), the aggregator's uplink rotates and keyframe-resyncs, and the
  standby serves fleet view + firing SLO page + a real shed — within
  one keyframe cadence of the kill;
- the old root restarts and rejoins as STANDBY despite its bootstrap
  initial-leader flag (an observed leader always wins), fenced;
- wedging the new leader (lease never renewed again — the
  wedged-but-alive regression) self-fences it within one lease and the
  standby takes over with the next generation; the wedged root's
  actuation stays refused throughout.

The data, seed and assertions are the reference soak's. One wait is
added: before reading the wedged root's ``/api/actuate``, the soak lets
that root's sampler run one whole tick. The route's ``leader`` field is
published on the sampler's tick (``ActuationEngine.observe`` re-renders
the payload when leadership changed), not when the lease expires, and
under a loaded host the waits before the read can complete inside one
tick, so the reference's read can see the tick-old ``true``.

Satellites pinned alongside: decorrelated-jitter reconnect spread over
64 simulated uplinks, the chaos ``partition`` verb blackholing a live
uplink (frames dropped, socket open, keyframe resync on heal), the
``--chaos`` grammar split, and SSE slow-consumer drop-and-resync.
"""

import asyncio
import json
import random
import time
import urllib.request

from tpumon_torch.app import build
from tpumon_torch.collectors.chaos import Fault, split_link_faults
from tpumon_torch.config import load_config
from tpumon_torch.loadgen.serving import ServingEngine, start_metrics_server
from tpumon_torch.loadgen.traffic import TenantSpec, TrafficSim
from tpumon_torch.resilience import decorrelated_jitter

SAMPLE_INTERVAL_S = 0.25
SERVING_INTERVAL_S = 0.25
LEASE_S = 0.5
TTFT_THRESHOLD_MS = 700.0
DEGRADE_STALL_S = 1.0
# Failover budget: the uplink resync is bounded by one keyframe cadence
# (30 frames x the tick) and promotion by 2x the lease; measured
# end-to-end failover is ~1-2 s (bench.py federation_ha), so this holds
# an order of magnitude of full-suite-load headroom.
FAILOVER_BUDGET_S = 30 * SAMPLE_INTERVAL_S + 4.0

SLOS = [{
    "name": "chat_ttft",
    "tenant": "chat",
    "expr": f'serving.ttft_p95_ms{{tenant="chat"}} > {TTFT_THRESHOLD_MS:g}',
    "target": 0.99,
    "window": "1h",
    "fast": ["1s", "3s"],
    "slow": ["2s", "6s"],
}]

# One remedy, deliberately NOT curative: the scheduler stall dominates
# TTFT whatever the load, so the page keeps firing under the shed and
# the soak can kill the leader MID-BURN with the page + fired policy
# still live. clear_hold is parked high for the same reason — no revert
# races the failover assertions.
ACTUATIONS = [{
    "name": "shed_load", "when": 'slo.paging{slo="chat_ttft"} > 0',
    "action": "shed", "tenant": "*", "fraction": 0.5,
    "cooldown_s": 0, "fire_hold": 1, "clear_hold": 500,
}]


def get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return json.loads(r.read())


def serve(env=None):
    """A port app over the fake v5e-8 backend (not started)."""
    base = {
        "TPUMON_PORT": "0",
        "TPUMON_HOST": "127.0.0.1",
        "TPUMON_ACCEL_BACKEND": "fake:v5e-8",
        "TPUMON_K8S_MODE": "none",
    }
    base.update(env or {})
    return build(load_config(env=base))


def _mk(**env):
    base = {
        "TPUMON_PORT": "0",
        "TPUMON_HOST": "127.0.0.1",
        "TPUMON_K8S_MODE": "none",
        "TPUMON_COLLECTORS": "accel",
        "TPUMON_SAMPLE_INTERVAL_S": str(SAMPLE_INTERVAL_S),
        "TPUMON_HISTORY_PER_CHIP": "0",
        "TPUMON_ANOMALY_DETECT": "0",
    }
    base.update(env)
    return build(load_config(env=base))


async def wait_until(fn, what: str, timeout_s: float = 30.0):
    """Poll a sync ``fn`` until truthy, always off the event-loop
    thread: the fns here do blocking HTTP against in-process servers
    sharing this loop, and a blocking call ON the loop would deadlock
    against the very server it polls."""
    t0 = time.monotonic()
    while True:
        v = await asyncio.to_thread(fn)
        if v:
            return v
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"ha soak: timed out waiting for {what}")
        await asyncio.sleep(0.05)


def _root_env(node: str, metrics_port: int, **extra):
    env = {
        "TPUMON_ACCEL_BACKEND": "none",
        "TPUMON_COLLECTORS": "accel,serving",
        "TPUMON_FEDERATION_ROLE": "root",
        "TPUMON_FEDERATION_NODE": node,
        "TPUMON_FEDERATION_PEER": "http://127.0.0.1:9",  # patched later
        "TPUMON_FEDERATION_LEASE_S": str(LEASE_S),
        "TPUMON_SERVING_TARGETS": f"http://127.0.0.1:{metrics_port}/metrics",
        "TPUMON_SERVING_INTERVAL_S": str(SERVING_INTERVAL_S),
        "TPUMON_SLOS": json.dumps(SLOS),
        "TPUMON_ACTUATIONS": json.dumps(ACTUATIONS),
    }
    env.update(extra)
    return env


def test_federation_ha_kill_the_root_soak():
    engine = ServingEngine(device="cpu")
    engine.tenant_window_s = 2.0
    metrics_server, mport = start_metrics_server(engine)
    sim = TrafficSim(engine, [
        TenantSpec(name="chat", scenario="chat", rps=6.0, max_new=4),
        TenantSpec(name="rag", scenario="rag", rps=1.0,
                   prompt_chunks=3, max_new=4),
    ], seed=42)

    async def scenario():
        # --- warm the engine outside the judged window -----------------
        sim.start()
        await wait_until(
            lambda: engine.tenants.get("chat")
            and engine.tenants["chat"].completed >= 3,
            "chat traffic flowing", timeout_s=60.0)
        await wait_until(
            lambda: len(engine._queue) == 0,
            "compile-era queue backlog to drain", timeout_s=60.0)
        await asyncio.sleep(engine.tenant_window_s + 0.5)

        # --- active + standby roots, leases cross-wired --------------
        root_a, srv_a = _mk(**_root_env(
            "rootA", mport, TPUMON_FEDERATION_INITIAL_LEADER="1"))
        root_b, srv_b = _mk(**_root_env("rootB", mport))
        for s in (root_a, root_b):
            assert s.leader is not None and s.actuate is not None
            s.actuate.bind_engine(engine)
        await srv_a.start()
        await srv_b.start()
        a_port, b_port = srv_a.port, srv_b.port
        root_a.leader.peer_url = f"http://127.0.0.1:{b_port}"
        root_b.leader.peer_url = f"http://127.0.0.1:{a_port}"
        await root_a.start()
        await root_b.start()
        await root_a.leader.start()
        await root_b.leader.start()
        # HA steady state: A leads generation 1, B observed it and
        # joined as standby — both via the health heartbeat channel.
        await wait_until(root_a.leader.is_leader, "bootstrap leader")
        await wait_until(
            lambda: root_b.leader.generation == 1
            and not root_b.leader.is_leader(),
            "standby adopts the leader's generation")
        ev_b = await asyncio.to_thread(
            get_json, b_port, "/api/events?kind=leader")
        assert any("joined as standby" in e["msg"] for e in ev_b["events"])

        # --- the tree below: dual-homed aggregator, one leaf ---------
        agg_s, agg_srv = _mk(
            TPUMON_ACCEL_BACKEND="none",
            TPUMON_FEDERATION_ROLE="aggregator",
            TPUMON_FEDERATION_NODE="agg0",
            TPUMON_FEDERATE_UP=(
                f"http://127.0.0.1:{a_port},http://127.0.0.1:{b_port}"),
        )
        agg_s.uplink.backoff_max_s = 0.4
        await agg_srv.start()
        await agg_s.start()
        await agg_s.uplink.start()
        leaf_s, leaf_srv = _mk(
            TPUMON_ACCEL_BACKEND="fake:v5e-8@leaf0",
            TPUMON_FEDERATION_NODE="leaf0",
            TPUMON_FEDERATE_UP=f"http://127.0.0.1:{agg_srv.port}",
        )
        await leaf_s.start()
        await leaf_s.uplink.start()

        def slices(port):
            try:
                return {
                    s["slice_id"]: s
                    for s in get_json(port, "/api/federation")["slices"]
                }
            except OSError:
                return {}

        def fleet_ok(port):
            def check():
                r = slices(port).get("slice-0")
                return bool(r and r["chips"] == 8 and r["health"] == "ok")
            return check

        await wait_until(fleet_ok(a_port), "fleet view on the active root")
        # The standby takes NO stream while following: its fan-in state
        # will be rebuilt entirely from the failover keyframe.
        assert not await asyncio.to_thread(slices, b_port)

        # End-to-end freshness: the active root ages leaf0's
        # samples through agg0's relay, offset-corrected per link.
        def freshness(port):
            try:
                return get_json(port, "/api/federation").get(
                    "freshness") or {}
            except OSError:
                return {}
        await wait_until(
            lambda: "leaf0" in freshness(a_port),
            "leaf freshness accounted on the active root")
        fr_a = (await asyncio.to_thread(freshness, a_port))["leaf0"]
        assert 0 <= fr_a["ms"] < 30_000.0, fr_a

        # --- mid-burn: page fires on BOTH; only the leader sheds -----
        def fast_firing(port):
            return lambda: (
                get_json(port, "/api/slo")["slos"][0]
                ["burn"]["fast"]["firing"])

        def policy_row(port):
            return get_json(port, "/api/actuate")["policies"][0]

        for port in (a_port, b_port):
            await wait_until(
                lambda p=port: (get_json(p, "/api/slo")["slos"][0]
                                ["burn"]["fast"]["long"] == 0.0),
                f"clean baseline on :{port}", timeout_s=60.0)
        sim.degrade(DEGRADE_STALL_S)
        await wait_until(fast_firing(a_port), "page on the active root")
        await wait_until(fast_firing(b_port), "page on the standby")
        await wait_until(
            lambda: policy_row(a_port)["fired"] >= 1,
            "leader's shed fires")
        assert engine.shed_total >= 0 and engine.shed_fractions()
        # The standby's identical policy is armed by the same page but
        # FENCED — before cooldowns, before even dry-run accounting.
        await wait_until(
            lambda: policy_row(b_port)["fenced"] >= 1, "standby fenced")
        row_b = await asyncio.to_thread(policy_row, b_port)
        assert row_b["fired"] == 0
        act_b = await asyncio.to_thread(
            get_json, b_port, "/api/actuate")
        assert act_b["leader"] is False
        ev = await asyncio.to_thread(
            get_json, b_port, "/api/events?kind=actuate")
        assert any(e.get("state") == "fenced" for e in ev["events"])
        # Journal reconciliation: the leader's fired event is mirrored
        # onto the standby by (origin node, origin seq), exactly once.
        await wait_until(
            lambda: any(
                e.get("origin") == "rootA" and e.get("state") == "fired"
                for e in get_json(
                    b_port, "/api/events?kind=actuate")["events"]),
            "leader's actuation mirrored onto the standby")
        ev = await asyncio.to_thread(
            get_json, b_port, "/api/events?kind=actuate")
        mirrored = [(e["origin"], e["origin_seq"]) for e in ev["events"]
                    if e.get("origin")]
        assert len(mirrored) == len(set(mirrored)), "duplicated mirrors"

        # --- kill the active root mid-burn ---------------------------
        t_kill = time.monotonic()
        await srv_a.stop()
        await root_a.stop()
        await wait_until(
            lambda: root_b.leader.is_leader()
            and root_b.leader.generation == 2,
            "standby promotes with a bumped generation")
        await wait_until(fleet_ok(b_port),
                         "fleet view rebuilt on the new leader")
        failover_s = time.monotonic() - t_kill
        assert failover_s <= FAILOVER_BUDGET_S, (
            f"failover took {failover_s:.1f}s "
            f"(budget {FAILOVER_BUDGET_S:.1f}s)")
        # The rotation really was a dual-homed failover + keyframe
        # resync, not a reconnect to the corpse.
        assert agg_s.uplink.url.endswith(str(b_port))
        assert agg_s.uplink.failovers >= 1
        assert agg_s.uplink.enc.stats["keyframes"] >= 2
        # Page still firing; the armed policy the standby inherited
        # fires FOR REAL now — no operator, no re-arm.
        assert await asyncio.to_thread(
            lambda: fast_firing(b_port)())
        await wait_until(
            lambda: policy_row(b_port)["fired"] >= 1,
            "promoted standby sheds for real")
        act_b = await asyncio.to_thread(get_json, b_port, "/api/actuate")
        assert act_b["leader"] is True
        # Leadership is first-class observable: /api/federation block,
        # exporter families, health.
        fed = await asyncio.to_thread(get_json, b_port, "/api/federation")
        assert fed["leader"]["leader"] and fed["leader"]["generation"] == 2
        def metrics_text():
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{b_port}/metrics", timeout=5) as r:
                return r.read().decode()
        text = await asyncio.to_thread(metrics_text)
        assert "tpumon_federation_leader 1" in text
        assert "tpumon_federation_generation 2" in text
        assert "tpumon_federation_failovers_total 1" in text
        # Freshness survives the failover: the promoted root re-derives
        # leaf0's age from ITS OWN per-link clock offsets (keyframe
        # resync rebuilt the fan-in) — no negative ages, no multi-hour
        # spikes from trusting the dead root's clock arithmetic.
        await wait_until(
            lambda: "leaf0" in freshness(b_port),
            "leaf freshness re-accounted on the promoted root")
        fr_b = (await asyncio.to_thread(freshness, b_port))["leaf0"]
        assert 0 <= fr_b["ms"] < 30_000.0, fr_b
        text = await asyncio.to_thread(metrics_text)
        assert 'tpumon_federation_freshness_ms{node="leaf0"' in text

        # --- the old root restarts: standby, whatever its flag -------
        root_a2, srv_a2 = _mk(**_root_env(
            "rootA", mport,
            TPUMON_PORT=str(a_port),  # same address B's lease polls
            TPUMON_FEDERATION_INITIAL_LEADER="1",
        ))
        root_a2.actuate.bind_engine(engine)
        root_a2.leader.peer_url = f"http://127.0.0.1:{b_port}"
        for _ in range(40):  # the freed port can linger briefly
            try:
                await srv_a2.start()
                break
            except OSError:
                await asyncio.sleep(0.1)
        else:
            raise AssertionError("old root's port never came free")
        await root_a2.start()
        await root_a2.leader.start()
        await wait_until(
            lambda: root_a2.leader.generation == 2
            and not root_a2.leader.is_leader(),
            "restarted root adopts generation 2 as standby")
        ev = await asyncio.to_thread(
            get_json, a_port, "/api/events?kind=leader")
        assert any("joined as standby" in e["msg"] for e in ev["events"])
        # No fencing violation on rejoin: B keeps the lease untouched,
        # and the rejoined root's still-armed policy is fenced.
        assert root_b.leader.is_leader()
        assert root_b.leader.demotions == 0
        await wait_until(
            lambda: policy_row(a_port)["fenced"] >= 1,
            "rejoined root fenced")
        assert (await asyncio.to_thread(policy_row, a_port))["fired"] == 0

        # --- wedge the leader: the wedged-but-alive regression -------
        root_b.leader.wedge()
        await wait_until(
            lambda: not root_b.leader.is_leader(),
            "wedged leader self-fences within its lease", timeout_s=10.0)
        # B is still ALIVE — health answering, streams flowing — but
        # fenced; the standby observes a reachable non-leader and takes
        # over with the next generation.
        await wait_until(
            lambda: root_a2.leader.is_leader()
            and root_a2.leader.generation == 3,
            "standby takes over from the wedged leader")
        assert not root_b.leader.is_leader()  # never two leaders
        await wait_until(
            lambda: root_b.leader.generation == 3,
            "wedged root adopts the new generation")
        ev = await asyncio.to_thread(
            get_json, b_port, "/api/events?kind=leader")
        assert any("lease expired without renewal" in e["msg"]
                   for e in ev["events"])
        # The wedged root's actuation stays refused; the new leader's
        # engine fires. Two roots never both shed. /api/actuate publishes
        # leadership on the sampler's tick: let one whole tick of the
        # wedged root run after its lease went.
        for _ in range(2):
            assert await root_b.wait_tick(timeout_s=10.0)
        assert (await asyncio.to_thread(
            get_json, b_port, "/api/actuate"))["leader"] is False
        await wait_until(
            lambda: policy_row(a_port)["fired"] >= 1,
            "new leader's shed fires")

        for s, srv in ((leaf_s, leaf_srv), (agg_s, agg_srv),
                       (root_a2, srv_a2), (root_b, srv_b)):
            await s.stop()
            try:
                await srv.stop()
            except Exception:
                pass  # the leaf's server was never started

    try:
        asyncio.run(scenario())
    finally:
        sim.stop()
        metrics_server.shutdown()
        metrics_server.server_close()


# ---------------- satellite: reconnect-stampede jitter ------------------


def test_reconnect_backoff_jitter_spread_over_64_uplinks():
    """64 uplinks losing the same root at the same instant must NOT
    retry in lockstep: after a few decorrelated rounds their delays
    spread across most of the [base, cap] window, every delay respects
    the fleet-safe cap, and no quarter-second bucket holds more than a
    quarter of the fleet."""
    fleet = []
    for i in range(64):
        rng = random.Random(1000 + i)
        d = 0.25  # every uplink's clock starts at the same instant
        for _ in range(4):
            d = decorrelated_jitter(d, base_s=0.25, cap_s=5.0, rng=rng)
        fleet.append(d)
    assert all(0.25 <= d <= 5.0 for d in fleet)
    assert max(fleet) - min(fleet) > 2.0  # spread, not a stampede
    buckets = {}
    for d in fleet:
        buckets[int(d / 0.25)] = buckets.get(int(d / 0.25), 0) + 1
    assert max(buckets.values()) <= 16, buckets
    assert len(buckets) >= 8
    # The cap holds forever, whatever the walk does.
    rng = random.Random(7)
    d = 0.25
    for _ in range(50):
        d = decorrelated_jitter(d, base_s=0.25, cap_s=5.0, rng=rng)
        assert 0.25 <= d <= 5.0


# ---------------- satellite: chaos `partition` verb ---------------------


def test_split_link_faults_grammar():
    """partition targets links only, links take only partition — either
    mismatch fails loudly at startup, and mixed specs split cleanly."""
    import pytest

    coll, link = split_link_faults("partition:uplink:1.0")
    assert not coll and [f.mode for f in link["uplink"]] == ["partition"]
    coll, link = split_link_faults(
        "err:accel:0.2,partition:leader:0.5,slow:serving:10")
    assert set(coll) == {"accel", "serving"} and set(link) == {"leader"}
    assert link["leader"][0].param == 0.5
    with pytest.raises(ValueError):
        split_link_faults("slow:uplink:10")  # links take only partition
    with pytest.raises(ValueError):
        split_link_faults("partition:accel:1.0")  # not a collector mode


def test_chaos_partition_blackholes_live_uplink():
    """partition on a live leaf→aggregator uplink drops frames WITHOUT
    closing the socket: the upstream sees silence (slice dark), not a
    disconnect; healing the link forces a keyframe resync through the
    seq-gap contract."""

    async def scenario():
        agg_s, agg_srv = _mk(
            TPUMON_ACCEL_BACKEND="none",
            TPUMON_FEDERATION_ROLE="aggregator",
            TPUMON_FEDERATION_NODE="agg0",
            TPUMON_FEDERATION_DARK_AFTER_S="0.6",
        )
        await agg_srv.start()
        await agg_s.start()
        leaf_s, _leaf_srv = _mk(
            TPUMON_ACCEL_BACKEND="fake:v5e-8@leaf0",
            TPUMON_FEDERATION_NODE="leaf0",
            TPUMON_FEDERATE_UP=f"http://127.0.0.1:{agg_srv.port}",
            TPUMON_FEDERATION_DARK_AFTER_S="0.6",
        )
        leaf_s.uplink.backoff_max_s = 0.4
        await leaf_s.start()
        await leaf_s.uplink.start()

        def health():
            rows = get_json(agg_srv.port, "/api/federation")["slices"]
            return {r["slice_id"]: r["health"] for r in rows}

        await wait_until(
            lambda: health().get("slice-0") == "ok", "tree converges")

        # Blackhole: every frame encoded then dropped, socket open.
        leaf_s.uplink.faults = [Fault(mode="partition", param=1.0)]
        await wait_until(
            lambda: leaf_s.uplink.frames_dropped >= 3, "frames dropped")
        assert leaf_s.uplink.connected  # silence, not a disconnect
        await wait_until(
            lambda: health().get("slice-0") == "dark",
            "upstream sees silence as dark")
        resyncs0 = agg_s.federation.nodes["leaf0"].resyncs

        # Heal: the seq gap forces a keyframe resync, view recovers.
        leaf_s.uplink.faults = []
        await wait_until(
            lambda: health().get("slice-0") == "ok", "view recovers")
        await wait_until(
            lambda: agg_s.federation.nodes["leaf0"].resyncs > resyncs0,
            "keyframe resync after heal")

        await leaf_s.stop()
        await agg_s.stop()
        await agg_srv.stop()

    asyncio.run(scenario())


# ---------------- satellite: SSE slow-consumer fan-out ------------------


def test_sse_slow_consumer_dropped_and_resynced():
    """One stalled SSE consumer must not stall the broadcast tick: its
    bounded queue overruns, is cleared, and its next delivered frame is
    a forced keyframe — while a healthy client on the same broadcaster
    keeps receiving every tick."""
    sampler, server = serve()

    async def scenario():
        await sampler.tick_all()
        await server.start()
        port = server.port

        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /api/stream HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        while (await asyncio.wait_for(reader.readline(), 5)) not in (
                b"\r\n", b""):
            pass

        async def next_event():
            while True:
                line = await asyncio.wait_for(reader.readline(), 10)
                if line.startswith(b"data: "):
                    return json.loads(line[6:])

        first = await next_event()
        assert "key" in first  # immediate keyframe, no tick waited out

        # A synthetic stalled consumer: registered like _stream does,
        # but nothing ever drains its (tiny) queue.
        slow = {"queue": asyncio.Queue(maxsize=2), "ver": -1,
                "since_key": 1, "needs_key": False}
        server._sse_clients[10_000] = slow

        last_epoch = first["epoch"]
        for _ in range(4):
            await sampler.tick_fast()
            ev = await next_event()  # healthy client: never stalled
            assert ev["epoch"] >= last_epoch
            last_epoch = ev["epoch"]
        # maxsize-2 queue over 4 frames: overrun happened, queue was
        # cleared (drop-and-resync), and the post-overrun frame the
        # broadcaster re-enqueued is a forced keyframe.
        assert server.sse_overruns >= 1
        frame = json.loads(await asyncio.wait_for(slow["queue"].get(), 10))
        assert frame["key"]
        assert not slow["needs_key"]
        h = await asyncio.to_thread(get_json, port, "/api/health")
        assert h["http"]["sse_overruns"] >= 1
        assert h["http"]["sse_clients"] == 2

        del server._sse_clients[10_000]
        writer.close()
        await server.stop()
        await sampler.stop()

    asyncio.run(scenario())
