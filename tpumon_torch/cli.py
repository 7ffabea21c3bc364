"""``python -m tpumon_torch.info`` — terminal chip/host status, tpu-info style.

The reference ecosystem's quick-look tool is ``nvidia-smi`` (shelled out at
monitor_server.js:85); the TPU ecosystem's is ``tpu-info``. tpumon ships
its own: a one-shot (or --watch) terminal table of per-chip MXU duty, HBM,
temperature and ICI rates, plus host metrics — reading through the same
collector stack as the server, so what the CLI shows is exactly what the
dashboard and exporter show.
"""

from __future__ import annotations

import asyncio
import os
import sys
import time

from tpumon_torch.collectors.accel import make_accel_collector
from tpumon_torch.collectors.host import HostCollector
from tpumon_torch.config import load_config
from tpumon_torch.topology import ChipSample, accel_terms, slice_views


def _bar(pct: float | None, width: int = 20) -> str:
    if pct is None:
        return "·" * width
    filled = int(round(max(0.0, min(100.0, pct)) / 100 * width))
    return "█" * filled + "░" * (width - filled)


def _fmt_bytes(b: int | None) -> str:
    if b is None:
        return "–"
    return f"{b / 2**30:.1f}G"


def render(chips: list[ChipSample], host: dict, ici_rates: dict | None = None) -> str:
    lines: list[str] = []
    cpu = host.get("cpu") or {}
    mem = host.get("memory") or {}
    lines.append(
        f"host: cpu {cpu.get('percent', '–')}% (load {cpu.get('load_1min', '–')}, "
        f"{cpu.get('cores', '?')} cores) · mem {mem.get('percent', '–')}% "
        f"({_fmt_bytes(mem.get('used'))}/{_fmt_bytes(mem.get('total'))})"
    )
    if not chips:
        lines.append("no TPU chips visible")
        return "\n".join(lines)
    for v in slice_views(chips):
        lines.append(
            f"slice {v.slice_id}: {v.reporting_chips} chip(s) on "
            f"{len(v.hosts)} host(s)"
            + (f" · {v.accel_kind}" if v.accel_kind == "gpu" else "")
        )
    # Column headers speak the fleet's own family terms (MXU/HBM/ICI vs
    # SM/VRAM/NVLink); a mixed table falls back to the neutral words.
    families = {c.accel_kind for c in chips}
    if len(families) == 1:
        terms = accel_terms(next(iter(families)))
        duty_h, mem_h, link_h = terms["duty"], terms["mem"], terms["link"]
    else:
        duty_h, mem_h, link_h = "duty", "mem", "link"
    header = (
        f"{'chip':<24} {'kind':<5} {duty_h + '%':>6}  {'':20} "
        f"{mem_h:>12} {mem_h + '%':>6}  {'temp':>5}  {link_h + ' tx':>10}  {'link':>5}"
    )
    lines.append(header)
    for c in chips:
        duty = f"{c.mxu_duty_pct:.1f}" if c.mxu_duty_pct is not None else "–"
        hbm_pct = f"{c.hbm_pct:.1f}" if c.hbm_pct is not None else "–"
        temp = f"{c.temp_c:.0f}°C" if c.temp_c is not None else "–"
        rate = (ici_rates or {}).get(c.chip_id, {}).get("tx_bps")
        rate_s = f"{rate / 1e9:.2f}GB/s" if rate is not None else "–"
        # ICI link state: SDK health score when present (0 healthy ..
        # 10 unusable, PROBE_libtpu.md), else up/DOWN, else unknown.
        if c.ici_link_health is not None:
            link = f"{c.ici_link_health}/10"
        elif c.ici_link_up is not None:
            link = "up" if c.ici_link_up else "DOWN"
        else:
            link = "–"
        throttled = (
            f"  throttled ~{c.throttle_score * 10}%"
            if c.throttle_score else ""
        )
        lines.append(
            f"{c.chip_id:<24} {c.kind:<5} {duty:>6}  {_bar(c.mxu_duty_pct)} "
            f"{_fmt_bytes(c.hbm_used):>5}/{_fmt_bytes(c.hbm_total):<6} {hbm_pct:>6}  "
            f"{temp:>5}  {rate_s:>10}  {link:>5}{throttled}"
        )
    return "\n".join(lines)


def render_runtime_lines(runtime: dict | None) -> list[str]:
    """Slice-level runtime extras (/api/accel/metrics "runtime"; the JAX
    package's libtpu SDK fills them, the port's collectors leave them out):
    HLO queue depth and collective/DCN latency p50s, one line each."""
    lines: list[str] = []
    if not runtime:
        return lines
    queue = runtime.get("hlo_queue_size") or {}
    if queue:
        cells = " ".join(f"{k}:{v:.0f}" for k, v in sorted(queue.items()))
        lines.append(f"hlo queue: {cells}")
    for family, label in (
        ("collective_e2e_latency", "collective e2e"),
        ("buffer_transfer_latency", "DCN transfer"),
    ):
        table = runtime.get(family) or {}
        for bucket, pcts in sorted(table.items()):
            p50 = pcts.get("p50")
            p999 = pcts.get("p999")
            if p50 is not None:
                lines.append(
                    f"{label} {bucket}: p50 {p50:.0f}µs"
                    + (f" · p99.9 {p999:.0f}µs" if p999 is not None else "")
                )
    return lines


def render_health_lines(health: dict | None) -> list[str]:
    """Degraded-source lines for the remote view: failing sources and
    breakers that left closed (tpumon_torch.resilience) — healthy sources stay
    silent, a quick look only needs the problems."""
    lines: list[str] = []
    for name, s in sorted(((health or {}).get("sources") or {}).items()):
        br = s.get("breaker") or {}
        state = br.get("state", "closed")
        if s.get("ok") and state == "closed":
            continue
        bits = [f"source {name}: DOWN" if not s.get("ok") else f"source {name}:"]
        if s.get("error"):
            bits.append(str(s["error"])[:80])
        if state != "closed":
            retry = br.get("retry_in_s")
            bits.append(
                f"breaker {state}"
                + (f" (retry {retry:.0f}s)" if retry is not None else "")
            )
        lines.append(" · ".join(bits))
    chaos = (health or {}).get("chaos")
    if chaos:
        lines.append(f"CHAOS ACTIVE: {chaos}")
    return lines


def render_status_lines(alerts: dict | None, serving: dict | None) -> list[str]:
    """Alert/serving/training summary lines for the remote view."""
    lines: list[str] = []
    if alerts:
        n = {s: len(alerts.get(s) or []) for s in ("critical", "serious", "minor")}
        silenced = len(alerts.get("silenced") or [])
        line = f"alerts: {n['critical']}🔴 {n['serious']}🟠 {n['minor']}🟡"
        if silenced:
            line += f" ({silenced} silenced)"
        lines.append(line)
        for sev in ("critical", "serious"):
            for a in alerts.get(sev) or []:
                lines.append(f"  [{sev}] {a.get('title')}: {a.get('desc')}")
    for t in (serving or {}).get("targets") or []:
        if t.get("train_step") is not None:
            loss = t.get("train_loss")
            gp = t.get("train_goodput_pct")
            lines.append(
                f"train {t.get('target')}: step {t['train_step']:.0f}"
                + (f" · loss {loss:.3f}" if loss is not None else "")
                + (f" · goodput {gp:.0f}%" if gp is not None else "")
            )
        elif t.get("ok"):
            tps = t.get("tokens_per_sec")
            ttft = t.get("ttft_p50_ms")
            spec = t.get("spec_accept_pct")
            kv = t.get("kv_pages_used_pct")
            lines.append(
                f"serve {t.get('target')}:"
                + (f" {tps:.0f} tok/s" if tps is not None else "")
                + (f" · TTFT p50 {ttft:.0f}ms" if ttft is not None else "")
                + (f" · spec {spec:.0f}%" if spec is not None else "")
                + (f" · KV pool {kv:.0f}%" if kv is not None else "")
            )
        else:
            # a down target carries no train_* fields, so we can't tell
            # trainer from server here — keep the label neutral
            lines.append(f"target {t.get('target')}: DOWN ({t.get('error')})")
    return lines


async def _run_remote(url: str, watch: float | None) -> int:
    """Render a running tpumon server's view (no local collectors or devices)."""
    import json
    import urllib.request

    from tpumon_torch.collectors.accel_peers import chip_from_json, normalize_base_url

    base = normalize_base_url(url)
    failed: list[str] = []

    def get(path: str) -> dict | None:
        try:
            with urllib.request.urlopen(f"{base}{path}", timeout=5) as r:
                return json.load(r)
        except Exception as e:
            failed.append(f"{path}: {type(e).__name__}")
            return None

    first = True
    while True:
        failed.clear()
        accel, host, alerts, serving, health = await asyncio.gather(
            *(asyncio.to_thread(get, p) for p in (
                "/api/accel/metrics", "/api/host/metrics",
                "/api/alerts", "/api/serving", "/api/health",
            ))
        )
        if accel is None and host is None:
            print(f"tpumon at {base} unreachable", file=sys.stderr)
            if first or not watch:
                return 1
            # transient failure mid-watch: keep polling, the server may
            # be restarting (matches the local loop's degraded behavior)
            await asyncio.sleep(watch)
            continue
        first = False
        chips = [chip_from_json(c) for c in (accel or {}).get("chips") or []]
        rates = {
            c.get("chip"): {"tx_bps": c["tx_bps"]}
            for c in (accel or {}).get("chips") or []
            if c.get("tx_bps") is not None
        }
        if watch:
            print("\x1b[2J\x1b[H", end="")
            print(time.strftime("%H:%M:%S"), f"· tpumon info · {base}")
        print(render(chips, host or {}, rates))
        for line in render_runtime_lines((accel or {}).get("runtime")):
            print(line)
        for line in render_health_lines(health):
            print(line)
        for line in render_status_lines(alerts, serving):
            print(line)
        if failed:
            print(f"[degraded: {', '.join(sorted(failed))}]", file=sys.stderr)
        sys.stdout.flush()
        if not watch:
            return 0
        await asyncio.sleep(watch)


async def _run(watch: float | None, backend: str | None) -> int:
    env = {"TPUMON_COLLECTORS": "host,accel"}
    if backend:
        env["TPUMON_ACCEL_BACKEND"] = backend
    cfg = load_config(env={**os.environ, **env})
    accel = make_accel_collector(cfg)
    host = HostCollector(cpu_count=cfg.cpu_count, disk_mounts=cfg.disk_mounts)

    from tpumon_torch.sampler import Sampler

    sampler = Sampler(cfg, host=host, accel=accel)
    while True:
        await sampler.tick_fast()
        out = render(sampler.chips(), sampler.host_data(), sampler.ici_rates)
        if watch:
            print("\x1b[2J\x1b[H", end="")  # clear screen
            print(time.strftime("%H:%M:%S"), "· tpumon info")
        print(out, flush=True)
        accel_sample = sampler.sample_of("accel")
        if accel_sample and accel_sample.error:
            print(f"[degraded: {accel_sample.error}]", file=sys.stderr)
        if not watch:
            return 0
        await asyncio.sleep(watch)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    watch = None
    backend = None
    remote = None
    it = iter(argv)
    for a in it:
        if a in ("-w", "--watch"):
            watch = float(next(it, "1") or 1)
        elif a == "--backend":
            backend = next(it, None)
        elif a == "--remote":
            remote = next(it, None)
            if not remote or remote.startswith("-"):
                print("--remote requires a tpumon URL", file=sys.stderr)
                return 2
        elif a in ("-h", "--help"):
            print(
                "usage: python -m tpumon_torch.info [-w SECONDS] "
                "[--backend cuda|fake:v5e-8] [--remote HOST:8888]\n"
                "--remote renders a running tpumon server's view (chips, "
                "alerts, serving/training) without local collectors"
            )
            return 0
        else:
            print(f"unknown argument {a!r}", file=sys.stderr)
            return 2
    if remote and backend:
        print("--remote and --backend are mutually exclusive", file=sys.stderr)
        return 2
    try:
        if remote:
            return asyncio.run(_run_remote(remote, watch))
        return asyncio.run(_run(watch, backend))
    except KeyboardInterrupt:
        return 0
