"""``python -m tpumon_torch`` (``tpumon_torch/app.py``) against ``python -m
tpumon`` (``tpumon/app.py``).

- Every flag of the reference's usage, with ``run`` and
  ``start_background`` patched out in both packages, gives the same exit
  code, the same ``Config`` and the same engine arguments (the port adds
  ``device``).
- The federation flags (an upstream, an aggregator, an HA root, a peer
  alone) give the same ``Config`` through ``main`` and build the same hub
  role, uplink URLs and tier, and lease peer and bootstrap flag.
- ``--serve-loadgen`` with no card and no ``--loadgen-device cpu`` exits
  non-zero with ``resolve_device``'s message; on the CPU a 2 x 1 mesh
  exits 2 with the reference's "divide the device count" (one CPU device
  is visible), and the ring engine serves a prompt past max_seq.
- A subprocess ``python -m tpumon_torch --port 0 --serve-loadgen
  --loadgen-device cpu --accel-backend fake:v5e-8`` prints the banner,
  scrapes its own engine in ``/api/serving`` and exits 0 on SIGTERM.
"""

import asyncio
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from tpumon import app as ref_app
from tpumon.loadgen import serving as ref_serving
from tpumon_torch import app
from tpumon_torch.loadgen import serving

ROOT = Path(__file__).resolve().parents[1]
SLOS = json.dumps([{"name": "ttft", "expr": "serving.ttft_p50_ms > 500",
                    "target": 0.99, "window": "1h"}])
ACTS = json.dumps([{"name": "shed", "when": "queue_depth > 4",
                    "action": "shed", "tenant": "*", "fraction": 0.25}])

CASES = [
    [], ["--port", "9000"], ["--port", "x"], ["--port"],
    ["--accel-backend", "fake:v5e-8"], ["--accel-backend", "jax"],
    ["--demo"], ["--serve-loadgen"], ["--loadgen-ckpt", "ckpt"],
    ["--loadgen-quant", "int8"], ["--loadgen-spec-len", "4"],
    ["--loadgen-spec-len", "x"], ["--loadgen-prefix-cache", "8"],
    ["--loadgen-kv-layout", "paged", "--loadgen-paged-attn", "kernel"],
    ["--loadgen-pool-pages", "64"], ["--loadgen-decode-block", "8"],
    ["--loadgen-kv-dtype", "int8"], ["--loadgen-spec-source", "prompt"],
    ["--loadgen-scheduler", "sequential"], ["--loadgen-prefill-budget", "2"],
    ["--loadgen-admit-lookahead", "4"], ["--loadgen-mesh", "2,1"],
    ["--loadgen-mesh", "2"], ["--loadgen-ring-attn", "2"],
    ["--peers", "a:8888,b:8888", "--peer-fanout", "4"],
    ["--federation-lease", "12"], ["--federation-initial-leader"],
    ["--sse-keyframe-every", "5"], ["--state", "s.json"],
    ["--trace-ring", "0"], ["--events-ring", "64"],
    ["--events-log", "e.jsonl"], ["--chaos", "err:accel:0.1,slow:host:5"],
    ["--history-snapshot", "h.bin", "--history-snapshot-format", "json"],
    ["--history-per-chip", "16"], ["--wire-binary", "off"],
    ["--ingest-kernel", "off"], ["--recording-rules", "chip.mxu[5m]"],
    ["--slos", SLOS], ["--actuations", ACTS, "--actuate-dry-run"],
    ["--tls-cert", "c.pem", "--tls-key", "k.pem"], ["--bogus"],
    ["-c", "CONFIG"], ["-h"],
]
FEDERATION = [
    ["--federate-up", "http://root:8888"],
    ["--federation-role", "aggregator"],
    ["--federation-role", "root", "--federation-peer", "http://root-b:8888",
     "--federation-initial-leader"],
    ["--federation-peer", "http://root-b:8888"],
]


class Calls:
    """What main handed to run and to start_background."""

    def __init__(self):
        self.cfg = None
        self.engine_kw = None

    async def run(self, cfg, loadgen_engine=None):
        self.cfg = cfg

    def start_background(self, **kw):
        self.engine_kw = kw
        return "engine", "http://127.0.0.1:1/metrics", serving.BackgroundStop()


def drive(monkeypatch, mod, serving_mod, argv, capsys):
    calls = Calls()
    monkeypatch.setattr(mod, "run", calls.run)
    monkeypatch.setattr(serving_mod, "start_background", calls.start_background)
    try:
        code = mod.main(argv)
    except SystemExit as e:  # a flag's missing or malformed value
        code = e.code
    out = capsys.readouterr()
    cfg = None if calls.cfg is None else dataclasses.asdict(calls.cfg)
    return code, cfg, calls.engine_kw, out


@pytest.mark.parametrize("argv", CASES, ids=lambda a: " ".join(a)[:40] or "bare")
def test_flags_parse_as_the_reference(monkeypatch, capsys, tmp_path, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for key in [k for k in os.environ if k.startswith("TPUMON_")]:
        monkeypatch.delenv(key)
    config = tmp_path / "tpumon.json"
    config.write_text(json.dumps({"port": 7777, "sample_interval_s": 2.0}))
    argv = [str(config) if a == "CONFIG" else a for a in argv]
    port = drive(monkeypatch, app, serving, argv, capsys)
    ref = drive(monkeypatch, ref_app, ref_serving, argv, capsys)
    assert port[0] == ref[0], (port[3].err, ref[3].err)
    assert port[1] == ref[1]
    if ref[2] is not None:
        assert port[2].pop("device") == torch.device("cuda")
        assert port[2] == ref[2]
    else:
        assert port[2] is None
    if argv == ["-h"]:
        assert "python -m tpumon_torch" in port[3].out
        assert "--loadgen-device cuda|cpu" in port[3].out
    else:
        assert port[3].err == ref[3].err


def federation_wiring(sampler) -> dict:
    """What ``build`` wired for federation, in terms both packages share."""
    hub, up, lease = sampler.federation, sampler.uplink, sampler.leader
    return {
        "hub": None if hub is None else (hub.role, hub.dark_after_s,
                                         hub.lease is lease),
        "merged": type(sampler.accel).__name__,
        "uplink": None if up is None else (
            up.urls, up.tier, up.hub is hub, up.enc.keyframe_every,
            None if hub is None or hub.gen_source is None
            else hub.gen_source()),
        "lease": None if lease is None else (
            lease.peer_url, lease.initial_leader, lease.lease_s,
            lease.clock is sampler.clock, lease.on_events is not None),
        "node": sampler.tracer.node,
    }


@pytest.mark.parametrize("argv", FEDERATION)
def test_federation_builds_as_the_reference(monkeypatch, capsys, argv):
    for key in [k for k in os.environ if k.startswith("TPUMON_")]:
        monkeypatch.delenv(key)
    argv = argv + ["--accel-backend", "none", "--federation-lease", "3"]
    cfgs = []
    for mod in (app, ref_app):
        calls = Calls()
        monkeypatch.setattr(mod, "run", calls.run)
        assert mod.main(argv) == 0, capsys.readouterr().err
        cfgs.append(calls.cfg)
    assert dataclasses.asdict(cfgs[0]) == dataclasses.asdict(cfgs[1])
    got = federation_wiring(app.build(cfgs[0])[0])
    want = federation_wiring(ref_app.build(cfgs[1])[0])
    assert got == want
    role = dict(zip(argv, argv[1:])).get("--federation-role")
    assert (got["hub"] is not None) == (role in ("aggregator", "root"))
    assert (got["lease"] is not None) == (role == "root")


def test_serve_loadgen_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert app.main(["--serve-loadgen"]) == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "device='cpu'" in err


@pytest.mark.parametrize("flags", [["--loadgen-mesh", "2,1"],
                                   ["--loadgen-ring-attn", "2",
                                    "--loadgen-kv-layout", "paged"]])
def test_mesh_and_ring_exit_2_not_yet_ported(monkeypatch, capsys, tmp_path,
                                             flags):
    """Both are ported now (the name is the earlier slices'): the mesh
    asks for two devices where the CPU has one and exits 2 with the
    reference's text; the ring engine serves a prompt longer than the
    flat engine admits while the app runs."""
    for key in [k for k in os.environ if k.startswith("TPUMON_")]:
        monkeypatch.delenv(key)
    served = []

    async def run(cfg, loadgen_engine=None):
        eng = loadgen_engine
        prompt = list(range(eng.cfg.model.max_seq + 20))
        req = eng.submit(prompt, max_new=3)
        await asyncio.to_thread(req.done.wait, 60)
        served.append((eng.cfg.ring_stripes, req.status, len(req.output)))

    monkeypatch.setattr(app, "run", run)
    code = app.main(flags + ["--loadgen-device", "cpu",
                             "--accel-backend", "none"])
    if flags[0] == "--loadgen-mesh":
        assert code == 2
        assert ("dp*tp must divide the device count"
                in capsys.readouterr().err)
        return
    assert code == 0, capsys.readouterr().err
    assert served == [(2, "completed", 4)]


def get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return json.loads(r.read())


def test_serve_loadgen_subprocess_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), TPUMON_SERVING_INTERVAL_S="1",
               TPUMON_K8S_MODE="none", TMPDIR=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpumon_torch", "--port", "0",
         "--serve-loadgen", "--loadgen-device", "cpu",
         "--accel-backend", "fake:v5e-8"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        banner = proc.stdout.readline()
        m = re.match(r"tpumon listening on http://0\.0\.0\.0:(\d+) ", banner)
        assert m, (banner, proc.stderr.read() if proc.poll() is not None else "")
        port = int(m.group(1))
        deadline = time.monotonic() + 30
        target = None
        while time.monotonic() < deadline:
            targets = get_json(port, "/api/serving")["targets"]
            if targets and targets[0]["ok"] and targets[0].get("tokens_total"):
                target = targets[0]
                break
            time.sleep(0.5)
        assert target is not None, targets
        assert target["target"].startswith("http://127.0.0.1:")
        assert len(get_json(port, "/api/accel/metrics")["chips"]) == 8
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=15) == 0, proc.stderr.read()
        assert "tpumon shutting down" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
