"""The port's mixed fleet as a port-only counterpart of
``tests/test_federation_mixed.py``: fake TPU leaves and fake GPU nodes,
each a port app, federate into ONE aggregator and root tree — real
servers, live sampler loops, the same harness as the port's tree soak:

- the root's fleet view labels every slice with its accelerator kind
  and partitions chip counts per family (`fleet.by_accel`);
- a distributed `topk(...) by (accel)` fleet query returns BOTH
  partitions, evaluated leaf-side (partial aggregates only — never raw
  points upstream);
- killing a GPU node marks its slice dark at the root exactly like a
  TPU leaf;
- a pre-upgrade leaf (streaming the old 16-field wire layout without
  `accel_kind`) still federates, its slices defaulting to "tpu";
- the aggregator's merged accel view, exporter and /api/gpu/metrics all
  thread the family through.
"""

import asyncio
import json
import time
import urllib.parse
import urllib.request

from tests.test_torch_federation_tree import _mk, get_json, wait_until


def _get_text(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as r:
        return r.read().decode()


def _slice_rows_sync(port):
    """Raw slice-row LIST (slice ids are only unique within a leaf —
    the TPU leaf and the GPU node both report a 'slice-0', so the
    tree soak's id-keyed dict would collapse them)."""
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/federation", timeout=5
        ) as r:
            return json.loads(r.read()).get("slices", [])
    except OSError:
        return []


async def _node_row(port, node):
    rows = await asyncio.to_thread(_slice_rows_sync, port)
    return next((r for r in rows if r.get("node") == node), None)


def test_mixed_fleet_soak():
    async def scenario():
        # --- tree: root <- agg <- {TPU leaf, GPU node, old peer} -----
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
        await agg_s.start()
        await agg_s.uplink.start()

        def leaf(name, backend, **env):
            s, srv = _mk(
                TPUMON_ACCEL_BACKEND=backend,
                TPUMON_FEDERATION_NODE=name,
                TPUMON_FEDERATE_UP=f"http://127.0.0.1:{agg_srv.port}",
                # Per-chip history ON (the tree soak disables it): the
                # by-(accel) fleet query reads chip.* at the leaves.
                TPUMON_HISTORY_PER_CHIP="64",
                **env,
            )
            s.uplink.backoff_max_s = 0.4
            return s, srv

        tpu_s, tpu_srv = leaf("tpuleaf", "fake:v5e-8@tpuleaf")
        gpu_s, gpu_srv = leaf("gpunode", "gpufake:dgx-a100-8@gpunode")
        for s, srv in ((tpu_s, tpu_srv), (gpu_s, gpu_srv)):
            await srv.start()
            await s.start()
            await s.uplink.start()

        # --- both kinds land, labeled, at the root -------------------
        async def both_kinds():
            t = await _node_row(root_srv.port, "tpuleaf")
            g = await _node_row(root_srv.port, "gpunode")
            return (
                t and g
                and t["health"] == "ok" and g["health"] == "ok"
                and t.get("accel_kind") == "tpu"
                and g.get("accel_kind") == "gpu"
            )

        await wait_until(both_kinds, "root labels both accelerator kinds")
        fed = await asyncio.to_thread(get_json, root_srv.port, "/api/federation")
        by_accel = fed["fleet"]["by_accel"]
        assert by_accel["tpu"]["chips"] == 8, by_accel
        assert by_accel["gpu"]["chips"] == 8, by_accel
        # The aggregator's merged accel view carries both families...
        d = await asyncio.to_thread(get_json, agg_srv.port, "/api/accel/metrics")
        kinds = {c["accel_kind"] for c in d["chips"]}
        assert kinds == {"tpu", "gpu"} and len(d["chips"]) == 16
        # ...the slice rollup JSON says which is which...
        slice_kinds = {s["slice"]: s["accel_kind"] for s in d["slices"]}
        assert set(slice_kinds.values()) == {"tpu", "gpu"}
        # ...the exporter's chip gauges carry the accel label...
        metrics = await asyncio.to_thread(_get_text, agg_srv.port, "/metrics")
        assert 'accel="gpu"' in metrics and 'accel="tpu"' in metrics
        # ...and the reference-compat view names GPU rows as GPUs.
        gpu_compat = await asyncio.to_thread(
            get_json, gpu_srv.port, "/api/gpu/metrics"
        )
        assert all(row["name"].startswith("GPU a100") for row in gpu_compat)

        # --- fleet query partitions per family, leaf-evaluated -------
        expr = "topk(5, rate(chip.hbm[5s])) by (accel)"
        # rate() needs >= 2 points per series: let a few ticks land.
        await asyncio.sleep(0.5)

        async def fleet_answer():
            out = await root_s.federation.fleet_query(expr, timeout_s=5.0)
            fams = {r["labels"].get("accel") for r in out["result"]}
            return out if fams == {"tpu", "gpu"} else None

        out = await wait_until(fleet_answer, "by (accel) fleet partitions")
        assert out["fleet"] is True and not out.get("partial"), out
        per_fam: dict = {}
        for r in out["result"]:
            per_fam.setdefault(r["labels"]["accel"], []).append(r)
        # k rows per family (8 chips each, k=5), full labels kept.
        assert all(len(rows) == 5 for rows in per_fam.values()), per_fam
        assert all(r["labels"].get("chip") for r in out["result"])
        # Leaves answered sub-queries with partial aggregates (TPWR
        # frames over the open uplink), never raw points: bytes per
        # answer stay far under one chip keyframe.
        for s in (tpu_s, gpu_s):
            assert s.uplink.queries_answered >= 1
            per_answer = s.uplink.query_bytes / s.uplink.queries_answered
            assert per_answer < s.uplink.enc.stats["keyframe_bytes"], (
                per_answer, s.uplink.enc.stats["keyframe_bytes"])
        # The HTTP route serves the same thing (fleet=1 at the root).
        q = urllib.parse.quote(expr)
        http_out = await asyncio.to_thread(
            get_json, root_srv.port, f"/api/query?query={q}&fleet=1"
        )
        assert {
            r["labels"].get("accel") for r in http_out["result"]
        } == {"tpu", "gpu"}

        # --- a pre-upgrade peer (no accel_kind column) federates -----
        old_s, old_srv = leaf("oldleaf", "fake:v5e-4@oldleaf")
        orig_payload = old_s.uplink._payload

        def pre_accel_payload(ts):
            v, fields, rows = orig_payload(ts)
            assert fields[-1] == "accel_kind"
            return v, fields[:-1], [r[:-1] for r in rows]

        old_s.uplink._payload = pre_accel_payload
        await old_srv.start()
        await old_s.start()
        await old_s.uplink.start()

        async def old_peer_lands():
            r = await _node_row(root_srv.port, "oldleaf")
            return r and r["health"] == "ok" and r.get("accel_kind") == "tpu"

        await wait_until(
            old_peer_lands, "pre-accel_kind peer federates as tpu"
        )

        # --- kill the GPU node: dark at the root, like any leaf ------
        await gpu_s.stop()
        await gpu_srv.stop()

        async def gpu_dark():
            r = await _node_row(root_srv.port, "gpunode")
            return r and r["health"] == "dark" and r["accel_kind"] == "gpu"

        await wait_until(gpu_dark, "dark GPU node propagates to root")
        ev = await asyncio.to_thread(
            get_json, agg_srv.port, "/api/events?kind=federation"
        )
        assert any(
            e["severity"] == "serious" and "gpunode" in e["msg"]
            and "dark" in e["msg"]
            for e in ev["events"]
        ), ev["events"]
        # The dark partition stays visible in the per-family fleet view.
        fed = await asyncio.to_thread(get_json, root_srv.port, "/api/federation")
        assert fed["fleet"]["by_accel"]["gpu"]["slices"] >= 1
        assert fed["fleet"]["dark_slices"] >= 1

        for s, srv in (
            (tpu_s, tpu_srv), (old_s, old_srv),
            (agg_s, agg_srv), (root_s, root_srv),
        ):
            await s.stop()
            await srv.stop()

    asyncio.run(scenario())


def test_mixed_chips_one_sampler_rollup_and_augmenter():
    """Below the tree: one sampler whose accel view carries both
    families (a TPU fake merged with GPU chips) derives per-family
    slice views, exporter labels and query `accel` labels from the
    same ChipSample schema — no federation required."""
    from tpumon_torch.collectors import Sample
    from tpumon_torch.collectors.accel_fake import FakeTpuCollector
    from tpumon_torch.collectors.gpu_fake import FakeGpuCollector
    from tpumon_torch.config import load_config
    from tpumon_torch.exporter import render_exporter
    from tpumon_torch.sampler import Sampler

    class MixedCollector:
        name = "accel"

        def __init__(self):
            self.tpu = FakeTpuCollector(topology="v5e-4", clock=lambda: 800.0)
            self.gpu = FakeGpuCollector(
                topology="dgx-a100-8", clock=lambda: 800.0)

        async def collect(self):
            return Sample(
                source="accel", ok=True,
                data=self.tpu.chips() + self.gpu.chips(),
            )

    cfg = load_config(env={
        "TPUMON_COLLECTORS": "accel", "TPUMON_K8S_MODE": "none",
    })
    sampler = Sampler(cfg, accel=MixedCollector())
    asyncio.run(sampler.tick_fast())
    views = {v.slice_id: v for v in sampler.slices()}
    assert views["slice-0"].accel_kind == "tpu"
    assert views["gpu-0"].accel_kind == "gpu"
    text = render_exporter(sampler)
    assert 'accel="gpu"' in text and 'accel="tpu"' in text
    # Query label derivation through the sampler's augmenter.
    out = sampler.query.instant(
        "count(chip.mxu) by (accel)", at=time.time())["result"]
    got = {r["labels"]["accel"]: r["value"] for r in out}
    assert got == {"tpu": 4.0, "gpu": 8.0}
    res = sampler.query.instant(
        'avg(chip.mxu{accel="gpu"})', at=time.time())["result"]
    assert len(res) == 1 and res[0]["value"] is not None
