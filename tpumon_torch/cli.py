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
                "alerts, serving/training) without local collectors; it is "
                "not yet ported (ROADMAP item 7c)"
            )
            return 0
        else:
            print(f"unknown argument {a!r}", file=sys.stderr)
            return 2
    if remote and backend:
        print("--remote and --backend are mutually exclusive", file=sys.stderr)
        return 2
    if remote:
        print("--remote is not yet ported (ROADMAP item 7c): it reads a "
              "running server through the peer collector", file=sys.stderr)
        return 2
    try:
        return asyncio.run(_run(watch, backend))
    except KeyboardInterrupt:
        return 0
