"""Application wiring and entrypoint (``python -m tpumon_torch``), a copy of
``tpumon/app.py``: every flag of the reference, ``--serve-loadgen`` binding
the port's serving engine (``tpumon_torch.loadgen.serving``) in process,
plus ``--loadgen-device``. The federation roles (``--federation-role
aggregator|root``, ``--federate-up``, ``--federation-peer``) build the
port's hub, uplink and root-HA lease (``tpumon_torch.federation``,
``tpumon_torch.leader``) as the reference builds its own.

Reference startup (SURVEY §3.1): read HTML, create server, listen — no
config, no health check, no graceful shutdown (monitor_server.js:241-298).
tpumon adds all three: config via file/env (tpumon_torch.config), /api/health,
and SIGINT/SIGTERM-driven orderly shutdown of the sampler and server.
"""

from __future__ import annotations

import asyncio
import contextlib
import signal
import sys

from tpumon_torch.alerts import AlertEngine
from tpumon_torch.collectors.accel import make_accel_collector
from tpumon_torch.collectors.host import HostCollector
from tpumon_torch.collectors.k8s import K8sCollector
from tpumon_torch.collectors.serving import ServingCollector
from tpumon_torch.config import Config, load_config
from tpumon_torch.history import HistoryService, RingHistory
from tpumon_torch.sampler import Sampler
from tpumon_torch.server import MonitorServer


def build(cfg: Config) -> tuple[Sampler, MonitorServer]:
    """Construct the collector/sampler/server graph for a config."""
    from tpumon_torch import tsdb

    # Ingest-spine kernel policy is process-wide (the store's batch
    # paths consult tpumon_torch.tsdb.kernel()); the pure-Python fallback is
    # bit-exact, so this is purely a performance switch.
    tsdb.set_kernel_enabled(cfg.ingest_kernel)
    enabled = set(cfg.collectors)
    host = (
        HostCollector(cpu_count=cfg.cpu_count, disk_mounts=cfg.disk_mounts)
        if "host" in enabled
        else None
    )
    accel = make_accel_collector(cfg) if "accel" in enabled else None
    k8s = (
        K8sCollector(mode=cfg.k8s_mode, api_url=cfg.k8s_api_url)
        if "k8s" in enabled and cfg.k8s_mode != "none"
        else None
    )
    serving = (
        ServingCollector(targets=cfg.serving_targets)
        if "serving" in enabled and cfg.serving_targets
        else None
    )
    link_faults: dict = {}
    if cfg.chaos:
        from tpumon_torch.collectors.chaos import split_link_faults, wrap_collectors

        # Link faults (`partition:uplink:…`, `partition:leader:…`)
        # target the federation uplink / leadership heartbeat, not a
        # collector — split them off and attach them after the links
        # are built below.
        coll_faults, link_faults = split_link_faults(cfg.chaos)
        wrapped = wrap_collectors(
            {"host": host, "accel": accel, "k8s": k8s, "serving": serving},
            coll_faults,
            seed=cfg.chaos_seed,
        )
        host, accel = wrapped["host"], wrapped["accel"]
        k8s, serving = wrapped["k8s"], wrapped["serving"]
    ring = RingHistory(
        window_s=cfg.history_window_s,
        long_window_s=cfg.history_long_window_s,
        coarse_step_s=cfg.history_coarse_step_s,
        mid_step_s=cfg.history_mid_step_s,
        mid_window_s=cfg.history_mid_window_s,
    )
    notifier = None
    if cfg.alert_webhooks:
        from tpumon_torch.notify import WebhookNotifier

        notifier = WebhookNotifier(
            urls=tuple(cfg.alert_webhooks),
            min_severity=cfg.webhook_min_severity,
            timeout_s=cfg.webhook_timeout_s,
        )
    sampler = Sampler(
        cfg,
        host=host,
        accel=accel,
        k8s=k8s,
        serving=serving,
        history=ring,
        engine=AlertEngine(cfg.thresholds),
        notifier=notifier,
    )
    # Hierarchical federation (tpumon_torch.federation, docs/federation.md):
    # aggregator and root roles grow a hub (downstream delta streams fan in
    # through /api/federation/ingest, hub chips merge into the accel
    # view); --federate-up grows an uplink that pushes THIS node's
    # frames upstream (chip rows from a leaf, slice rows from an
    # aggregator). Standalone monitors skip all of it.
    role = cfg.federation_role or ("leaf" if cfg.federate_up else "")
    if role not in ("", "leaf", "aggregator", "root"):
        raise ValueError(
            f"unknown federation_role {cfg.federation_role!r} "
            f"(want leaf | aggregator | root)"
        )
    if role or cfg.federate_up:
        import socket

        from tpumon_torch.federation import (
            FederationHub,
            FederationUplink,
            HubMergedCollector,
        )

        node = cfg.federation_node or socket.gethostname()
        # Fleet tracing: spans shipped upstream (and wire/header trace
        # contexts) carry this node's federation name, not the "local"
        # placeholder — a multi-node Perfetto export needs one process
        # track per NAMED node.
        sampler.tracer.node = node
        if role in ("aggregator", "root"):
            hub = FederationHub(
                node=node, role=role, dark_after_s=cfg.federation_dark_after_s
            )
            hub.bind(sampler)
            sampler.federation = hub
            sampler.accel = HubMergedCollector(local=sampler.accel, hub=hub)
        if cfg.federate_up and role != "root":
            sampler.uplink = FederationUplink(
                sampler,
                url=cfg.federate_up,
                node=node,
                tier="aggregator" if sampler.federation is not None else "leaf",
                hub=sampler.federation,
                keyframe_every=cfg.federation_keyframe_every,
                auth_token=cfg.auth_token,
            )
            if sampler.federation is not None:
                # An aggregator is not a leader but relays the fleet
                # leader's fencing token: its own TPWQ fan-out stamps
                # the highest generation its uplink has seen.
                up = sampler.uplink
                sampler.federation.gen_source = lambda: up.gen_seen
        if role == "root" and (
            cfg.federation_peer or cfg.federation_initial_leader
        ):
            # Root HA (tpumon_torch.leader, docs/federation.md "Root HA"):
            # the lease self-fences actuation, the heartbeat poll
            # promotes the standby, and the hub stamps the generation
            # on every fleet query.
            from tpumon_torch.leader import LeaderLease

            sampler.leader = LeaderLease(
                node=node,
                journal=sampler.journal,
                peer_url=cfg.federation_peer,
                lease_s=cfg.federation_lease_s,
                initial_leader=cfg.federation_initial_leader,
                auth_token=cfg.auth_token,
                clock=sampler.clock,
            )
            sampler.leader.on_events = sampler.mark_events_dirty
            sampler.federation.lease = sampler.leader
    # Chaos link faults attach to the links they target; a fault aimed
    # at a link this config never builds must fail loudly, like an
    # unknown collector source does.
    for src, faults in link_faults.items():
        target = sampler.uplink if src == "uplink" else sampler.leader
        if target is None:
            raise ValueError(
                f"chaos spec targets {src!r} but no federation "
                f"{'uplink' if src == 'uplink' else 'leadership lease'} "
                f"is configured"
            )
        target.faults = list(faults)
    history = HistoryService(
        ring,
        prometheus_url=cfg.prometheus_url,
        window_s=cfg.history_window_s,
        step_s=cfg.history_step_s,
    )
    server = MonitorServer(cfg, sampler, history)
    return sampler, server


async def run(cfg: Config, loadgen_engine=None) -> None:
    sampler, server = build(cfg)
    journal = sampler.journal
    # Event-journal persistence restores FIRST: the state snapshot's
    # alert timeline then merges by seq into the already-replayed
    # journal (dedup), so a deployment with both files never
    # double-records an incident.
    eventlog = None
    events_restored = False
    if cfg.events_path:
        from tpumon_torch.events import EventLog

        eventlog = EventLog(journal, cfg.events_path, interval_s=cfg.events_interval_s)
        events_restored = eventlog.restore()
        if events_restored:
            print(f"tpumon resumed events from {cfg.events_path}", flush=True)
    store = None
    state_restored = False
    if cfg.state_path:
        from tpumon_torch.state import StateStore

        store = StateStore(cfg.state_path, interval_s=cfg.state_interval_s)
        state_restored = store.restore_into(sampler)
        if state_restored:
            print(f"tpumon resumed state from {cfg.state_path}", flush=True)
    # Restore bookkeeping only AFTER both restores: a fresh record
    # between them would consume a seq the (fresher) state snapshot may
    # have assigned to a real alert event, which ingest's dedup-by-seq
    # would then silently drop. And events replayed from the JSONL were
    # delivered (or deliberately not) in a previous life — without this,
    # a journal-only restore would re-page the whole alert history
    # (restore_state already marks for the state-snapshot path).
    if events_restored:
        journal.record(
            "history", "info", "events",
            f"restored event journal from {cfg.events_path}",
            path=cfg.events_path,
        )
        sampler.mark_events_notified()
    if state_restored:
        journal.record(
            "history", "info", "state",
            f"restored monitor state from {cfg.state_path}",
            path=cfg.state_path,
        )
    # Close the loop (tpumon_torch.actuate, docs/actuation.md): when this
    # process runs the serving loadgen AND actuation policies are
    # configured, bind the in-process engine behind the narrow actuator
    # interface — shed/capacity/drain actions drive it directly. With
    # no engine in-process the policies still evaluate and journal
    # intent (dry-run semantics), so a misdeclared deployment is
    # visible, not silent. AFTER the restores: bind_engine journals,
    # and a fresh record before them would consume a seq a restored
    # event may carry, which ingest's dedup-by-seq would silently drop.
    if loadgen_engine is not None and sampler.actuate is not None:
        sampler.actuate.bind_engine(loadgen_engine)
    snapshotter = None
    if cfg.history_snapshot_path:
        from tpumon_torch.history import HistorySnapshotter

        snapshotter = HistorySnapshotter(
            sampler.history,
            cfg.history_snapshot_path,
            interval_s=cfg.history_snapshot_interval_s,
            journal=journal,
            fmt=cfg.history_snapshot_format,
        )
        server.snapshotter = snapshotter  # /api/health save/skip counters
        # A full state restore already replayed history; restoring the
        # history-only snapshot on top would double every point.
        if not state_restored and snapshotter.restore():
            print(
                f"tpumon resumed history from {cfg.history_snapshot_path}",
                flush=True,
            )
    if cfg.chaos:
        journal.record(
            "chaos", "info", "config", f"chaos injection active: {cfg.chaos}",
            spec=cfg.chaos,
        )
        print(f"tpumon CHAOS ACTIVE: {cfg.chaos}", flush=True)
    journal.record(
        "config", "info", "sampler",
        f"monitor configured: collectors={','.join(cfg.collectors)} "
        f"accel={cfg.accel_backend} interval={cfg.sample_interval_s:g}s",
    )
    await sampler.start()
    if sampler.uplink is not None:
        # Push task starts with the tick loops: one delta frame per
        # tick flows upstream from here on (keyframe first).
        await sampler.uplink.start()
    if sampler.leader is not None:
        # Lease renewal + peer heartbeat poll; on a fresh HA pair the
        # initial_leader root promotes on its first probe.
        await sampler.leader.start()
    if store is not None:
        await store.start(sampler)
    if snapshotter is not None:
        await snapshotter.start()
    if eventlog is not None:
        await eventlog.start()
    await server.start()
    journal.record(
        "server", "info", "server",
        f"listening on http://{cfg.host}:{server.port}", port=server.port,
    )
    print(
        f"tpumon listening on http://{cfg.host}:{server.port} "
        f"(collectors: {', '.join(cfg.collectors)}; "
        f"accel backend: {cfg.accel_backend}; "
        f"prometheus: {cfg.prometheus_url or 'ring-buffer only'})",
        flush=True,
    )
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(NotImplementedError):
            loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    print("tpumon shutting down...", flush=True)
    journal.record("server", "info", "server", "shutting down")
    await server.stop()
    await sampler.stop()
    if store is not None:
        await store.stop(sampler)
    if snapshotter is not None:
        await snapshotter.stop()
    if eventlog is not None:
        await eventlog.stop()  # final save carries the shutdown event


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "trace":
        # ``tpumon trace`` — dump/summarize a running server's span ring
        # (tpumon_torch.tracing; docs/observability.md).
        from tpumon_torch.tracing import trace_cli

        return trace_cli(argv[1:])
    if argv and argv[0] == "events":
        # ``tpumon events`` — tail a running server's event journal
        # (tpumon_torch.events; docs/events.md); --follow rides the SSE stream.
        from tpumon_torch.events import events_cli

        return events_cli(argv[1:])
    if argv and argv[0] == "query":
        # ``tpumon query 'expr'`` — instant/range queries against a
        # running server's in-tree engine (tpumon_torch.query; docs/query.md);
        # --fleet plans a distributed query over the federation tree.
        from tpumon_torch.query import query_cli

        return query_cli(argv[1:])
    if argv and argv[0] == "slo":
        # ``tpumon slo`` — objectives, budget remaining and burn rates
        # from a running server's /api/slo (tpumon_torch.slo; docs/slo.md).
        from tpumon_torch.slo import slo_cli

        return slo_cli(argv[1:])
    path = None
    overrides = {}
    serve_loadgen = False
    loadgen_ckpt = None
    loadgen_quant = None
    loadgen_spec = 0
    loadgen_prefix = 0
    loadgen_kv = "dense"
    loadgen_pool = 0
    loadgen_block = 1
    loadgen_kv_dtype = "compute"
    loadgen_paged_attn = "gather"
    loadgen_spec_source = "draft"
    loadgen_scheduler = "interleaved"
    loadgen_prefill_budget = 1
    loadgen_admit_lookahead = 0
    loadgen_mesh_dp = 1
    loadgen_mesh_tp = 1
    loadgen_ring_attn = 0
    loadgen_device = None
    it = iter(argv)

    def take(flag: str) -> str:
        v = next(it, None)
        if v is None:
            print(f"{flag} requires a value", file=sys.stderr)
            raise SystemExit(2)
        return v

    def take_int(flag: str) -> int:
        v = take(flag)
        if not v.isdigit():
            print(f"{flag} wants an integer, got {v!r}", file=sys.stderr)
            raise SystemExit(2)
        return int(v)

    for arg in it:
        if arg in ("-c", "--config"):
            path = take(arg)
        elif arg == "--port":
            v = take(arg)
            if not v.isdigit():
                print(f"--port wants an integer, got {v!r}", file=sys.stderr)
                return 2
            overrides["port"] = v
        elif arg == "--accel-backend":
            overrides["accel_backend"] = take(arg)
        elif arg == "--demo":
            # Fully synthetic deployment: fake v5e-8 chips, fake pods,
            # fake JetStream target — every dashboard panel populates
            # with zero external dependencies.
            overrides.update(
                {
                    "accel_backend": "fake:v5e-8+faults",
                    "k8s_mode": "fake",
                    "serving_targets": ["fake:jetstream", "fake:trainer"],
                    "expected_slice_chips": {"slice-0": 8},
                }
            )
        elif arg == "--serve-loadgen":
            # In-process JetStream-style serving loadgen (KV-cached
            # prefill/decode on the local accelerator) scraped as a real
            # serving target — the north-star loop in one command.
            serve_loadgen = True
        elif arg == "--loadgen-ckpt":
            # Serve weights resumed from a tpumon_torch.loadgen.train
            # checkpoint directory (implies --serve-loadgen).
            loadgen_ckpt = take(arg)
            serve_loadgen = True
        elif arg == "--loadgen-quant":
            # Weight-only quantization for the loadgen engine ("int8");
            # implies --serve-loadgen.
            loadgen_quant = take(arg)
            serve_loadgen = True
        elif arg == "--loadgen-spec-len":
            # Speculative decoding for the loadgen engine (implies
            # --serve-loadgen; self-speculating draft).
            loadgen_spec = take_int(arg)
            serve_loadgen = True
        elif arg == "--loadgen-prefix-cache":
            loadgen_prefix = take_int(arg)
            serve_loadgen = True
        elif arg == "--loadgen-kv-layout":
            # "dense" | "paged" KV layout for the loadgen engine.
            loadgen_kv = take(arg)
            serve_loadgen = True
        elif arg == "--loadgen-pool-pages":
            loadgen_pool = take_int(arg)
            serve_loadgen = True
        elif arg == "--loadgen-decode-block":
            # Fuse N plain-decode steps per dispatch.
            loadgen_block = take_int(arg)
            serve_loadgen = True
        elif arg == "--loadgen-kv-dtype":
            # "compute" | "int8" KV cache element type.
            loadgen_kv_dtype = take(arg)
            serve_loadgen = True
        elif arg == "--loadgen-paged-attn":
            # "gather" | "kernel" paged decode read path (kernel =
            # the CUDA paged-attention kernel; needs --loadgen-kv-layout
            # paged).
            loadgen_paged_attn = take(arg)
            serve_loadgen = True
        elif arg == "--loadgen-spec-source":
            # "draft" | "prompt": speculative proposal source (prompt =
            # n-gram prompt lookup, no draft model; needs
            # --loadgen-spec-len).
            loadgen_spec_source = take(arg)
            serve_loadgen = True
        elif arg == "--loadgen-scheduler":
            # "interleaved" (chunked-prefill continuous batching,
            # default) | "sequential" (stop-the-world admission — the
            # bench baseline).
            loadgen_scheduler = take(arg)
            serve_loadgen = True
        elif arg == "--loadgen-prefill-budget":
            # Prefill chunk dispatches per engine step under the
            # interleaved scheduler (ServeConfig.prefill_chunk_budget).
            loadgen_prefill_budget = take_int(arg)
            serve_loadgen = True
        elif arg == "--loadgen-admit-lookahead":
            # Paged admission lookahead window past a page-blocked
            # queue head (0 = strict FIFO; aging-bounded).
            loadgen_admit_lookahead = take_int(arg)
            serve_loadgen = True
        elif arg == "--loadgen-mesh":
            # "DP,TP": serve over a dp×tp device mesh — DP replicas
            # behind the prefix-affinity router, each tensor-parallel
            # over TP chips (docs/perf.md "Mesh serving").
            raw = take(arg)
            try:
                loadgen_mesh_dp, loadgen_mesh_tp = (
                    int(x) for x in raw.split(","))
            except ValueError:
                print(f"--loadgen-mesh wants DP,TP (two integers), "
                      f"got {raw!r}", file=sys.stderr)
                return 2
            serve_loadgen = True
        elif arg == "--loadgen-ring-attn":
            # Ring-attention engine mode: admit prompts up to
            # N × max_seq by paging KV block-wise around the tp ring
            # (needs --loadgen-kv-layout paged; 0 = off).
            loadgen_ring_attn = take_int(arg)
            serve_loadgen = True
        elif arg == "--loadgen-device":
            # Device the loadgen engine runs on ("cuda" by default;
            # "cpu" runs the plain versions, at a small model).
            loadgen_device = take(arg)
            serve_loadgen = True
        elif arg == "--peers":
            # Comma-separated peer tpumon instances to federate
            # (docs/perf.md; also TPUMON_PEERS / config "peers").
            overrides["peers"] = take(arg)
        elif arg == "--peer-fanout":
            overrides["peer_fanout"] = take_int(arg)
        elif arg == "--federate-up":
            # Upstream aggregator this instance pushes delta frames to
            # (tpumon_torch.federation, docs/federation.md).
            overrides["federate_up"] = take(arg)
        elif arg == "--federation-role":
            # leaf | aggregator | root; --federate-up alone implies leaf.
            overrides["federation_role"] = take(arg)
        elif arg == "--federation-peer":
            # This root's peer root (root HA; set on both roots).
            overrides["federation_peer"] = take(arg)
        elif arg == "--federation-lease":
            # Leadership lease length in seconds (root HA).
            overrides["federation_lease_s"] = take(arg)
        elif arg == "--federation-initial-leader":
            # Bootstrap: this root claims leadership on its first peer
            # probe (set on exactly one root of an HA pair).
            overrides["federation_initial_leader"] = "1"
        elif arg == "--sse-keyframe-every":
            # Delta-SSE keyframe cadence (1 = full frame per tick).
            overrides["sse_keyframe_every"] = take_int(arg)
        elif arg == "--state":
            overrides["state_path"] = take(arg)
        elif arg == "--trace-ring":
            # Span-ring capacity for the always-on data-plane tracer
            # (/api/trace, docs/observability.md); 0 disables.
            overrides["trace_ring"] = take_int(arg)
        elif arg == "--events-ring":
            # Event-journal ring capacity (/api/events, docs/events.md).
            overrides["events_ring"] = take_int(arg)
        elif arg == "--events-log":
            # Crash-safe JSONL persistence for the event journal.
            overrides["events_path"] = take(arg)
        elif arg == "--chaos":
            # Fault injection (tpumon_torch.collectors.chaos): e.g.
            # --chaos hang:accel:0.1,err:k8s:0.3,slow:host:200
            overrides["chaos"] = take(arg)
        elif arg == "--history-snapshot":
            overrides["history_snapshot_path"] = take(arg)
        elif arg == "--history-snapshot-format":
            # "binary" (v2 chunk-verbatim, default) | "json" (v1).
            overrides["history_snapshot_format"] = take(arg)
        elif arg == "--history-per-chip":
            # Max chips with per-chip drill-down ring series; 0 disables.
            overrides["history_per_chip"] = take_int(arg)
        elif arg == "--wire-binary":
            # Binary federation wire frames on /api/accel/wire
            # (Accept-negotiated; "off" = JSON-only both ways).
            overrides["wire_binary"] = take(arg)
        elif arg == "--ingest-kernel":
            # Native TSDB append/downsample kernel ("off" forces the
            # bit-exact pure-Python ingest path).
            overrides["ingest_kernel"] = take(arg)
        elif arg == "--recording-rules":
            # Comma-separated query recording rules ("chip.mxu[5m]"):
            # append-time aggregates for O(1) instant reads
            # (tpumon_torch.query, docs/query.md).
            overrides["recording_rules"] = take(arg)
        elif arg == "--slos":
            # SLO objectives as a JSON list (tpumon_torch.slo, docs/slo.md):
            # '[{"name":"chat_ttft","expr":"...","target":0.99,
            # "window":"30d"}]' — config files take the same objects
            # under the `slos` key.
            overrides["slos"] = take(arg)
        elif arg == "--actuations":
            # Actuation policies as a JSON list (tpumon_torch.actuate,
            # docs/actuation.md): '[{"name":"shed-chat","when":"...",
            # "action":"shed","tenant":"chat","fraction":0.25}]' —
            # config files take the same objects under `actuations`.
            overrides["actuations"] = take(arg)
        elif arg == "--actuate-dry-run":
            # Every policy journals intent without driving the engine.
            overrides["actuate_dry_run"] = "1"
        elif arg == "--tls-cert":
            # Server-side TLS: PEM cert chain terminating HTTPS on the
            # listener (tls_key defaults to the same file).
            overrides["tls_cert"] = take(arg)
        elif arg == "--tls-key":
            overrides["tls_key"] = take(arg)
        elif arg in ("-h", "--help"):
            print(
                "usage: python -m tpumon_torch [-c CONFIG.{json,toml}] [--port N] "
                "[--accel-backend auto|cuda|fake:v5e-8|none] [--demo] "
                "[--serve-loadgen] [--loadgen-ckpt DIR] "
                "[--loadgen-quant int8] [--loadgen-spec-len N] "
                "[--loadgen-prefix-cache N] [--loadgen-kv-layout dense|paged] "
                "[--loadgen-pool-pages N] [--loadgen-decode-block N] "
                "[--loadgen-kv-dtype compute|int8] "
                "[--loadgen-paged-attn gather|kernel] "
                "[--loadgen-spec-source draft|prompt] "
                "[--loadgen-scheduler interleaved|sequential] "
                "[--loadgen-prefill-budget N] "
                "[--loadgen-admit-lookahead N] "
                "[--loadgen-mesh DP,TP] [--loadgen-ring-attn N] "
                "[--loadgen-device cuda|cpu] "
                "[--peers host:port,...] [--peer-fanout N] "
                "[--federate-up http://root-a:8888,http://root-b:8888] "
                "[--federation-role leaf|aggregator|root] "
                "[--federation-peer http://root-b:8888] "
                "[--federation-lease SECONDS] [--federation-initial-leader] "
                "[--sse-keyframe-every N] "
                "[--state FILE] [--history-snapshot FILE] "
                "[--history-snapshot-format binary|json] "
                "[--history-per-chip N] "
                "[--wire-binary on|off] [--ingest-kernel on|off] "
                "[--recording-rules chip.mxu[5m],...] "
                "[--slos JSON] "
                "[--actuations JSON] [--actuate-dry-run] "
                "[--tls-cert CERT.pem] [--tls-key KEY.pem] "
                "[--trace-ring N] "
                "[--events-ring N] [--events-log FILE] "
                "[--chaos mode:source:param,...]\n"
                "       python -m tpumon_torch trace [--url HOST:8888] "
                "[--export trace.json] [--spans N] [--fleet]   "
                "(self-trace of a running server; --fleet adds the "
                "federation freshness/span view)\n"
                "       python -m tpumon_torch events [--url HOST:8888] [-n N] "
                "[--kind K] [--severity S] [--follow] [--json]   (event "
                "journal tail)\n"
                "       python -m tpumon_torch query 'expr' [--url HOST:8888] "
                "[--range 30m --step 30s] [--fleet] [--json]   (in-tree "
                "PromQL-subset queries, docs/query.md)\n"
                "       python -m tpumon_torch slo [--url HOST:8888] [--json]   "
                "(SLO budgets + burn rates, docs/slo.md)\n"
                "Env: TPUMON_PORT, TPUMON_PROMETHEUS_URL, TPUMON_ACCEL_BACKEND, ..."
            )
            return 0
        else:
            print(f"unknown argument {arg!r}", file=sys.stderr)
            return 2
    cfg = load_config(path=path, overrides=overrides)
    loadgen_stop = None
    loadgen_engine = None
    if serve_loadgen:
        # Start only once the config is known-good, and *append* to the
        # resolved target list so file/env-configured serving targets
        # keep being scraped alongside the loadgen.
        import dataclasses

        try:
            from tpumon_torch.loadgen.model import resolve_device
            from tpumon_torch.loadgen.serving import start_background
        except ImportError:
            print(
                "--serve-loadgen requires torch (pip install 'tpumon[cuda]')",
                file=sys.stderr,
            )
            return 2
        try:
            device = resolve_device(loadgen_device)
        except RuntimeError as e:  # no card, and the CPU not asked for
            print(f"--serve-loadgen: {e}", file=sys.stderr)
            return 2
        try:
            loadgen_engine, url, loadgen_stop = start_background(
                ckpt_dir=loadgen_ckpt, quantize=loadgen_quant,
                spec_len=loadgen_spec, prefix_cache=loadgen_prefix,
                kv_layout=loadgen_kv, pool_pages=loadgen_pool,
                decode_block=loadgen_block, kv_dtype=loadgen_kv_dtype,
                paged_attn=loadgen_paged_attn,
                spec_source=loadgen_spec_source,
                scheduler=loadgen_scheduler,
                prefill_budget=loadgen_prefill_budget,
                admit_lookahead=loadgen_admit_lookahead,
                mesh_dp=loadgen_mesh_dp, mesh_tp=loadgen_mesh_tp,
                ring_stripes=loadgen_ring_attn, device=device,
            )
        except ValueError as e:
            # uncomposable/unknown engine options, or a mesh shape the
            # visible devices cannot hold
            print(f"--serve-loadgen: {e}", file=sys.stderr)
            return 2
        collectors = tuple(cfg.collectors)
        if "serving" not in collectors:
            collectors = collectors + ("serving",)
        cfg = dataclasses.replace(
            cfg,
            serving_targets=tuple(cfg.serving_targets) + (url,),
            collectors=collectors,
        )
    try:
        asyncio.run(run(cfg, loadgen_engine=loadgen_engine))
    finally:
        if loadgen_stop is not None:
            loadgen_stop.set()  # drains the arrival loop, closes /metrics
            # Exit only once the engine thread is out of its last step.
            loadgen_stop.join(timeout=30)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
