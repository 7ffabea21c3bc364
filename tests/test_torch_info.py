"""``python -m tpumon_torch.info`` against ``python -m tpumon.info``.

The port's ``cli.render`` prints the reference's table on the same
chips (each package's fake collector at the same clock), and a whole
local run (host, accelerator, sampler tick, table) prints
what the reference prints. ``--remote`` against a live port server
prints, line for line, what the reference's ``--remote`` prints against
the reference's server ticked in lockstep (``tests/test_torch_server.py``'s
harness), and its render helpers equal the reference's. With no NVML the
default backend reports the collector's error and shows no chips; it
falls back to no other backend.
"""

import asyncio
import itertools
import time

import pytest

from tests.test_host_collector import make_proc
from tests.test_torch_server import Pair
from tests.test_torch_server import clock  # noqa: F401 — the fixture
from tpumon import cli as ref_cli
from tpumon.collectors import accel_fake as ref_accel_fake
from tpumon.collectors import gpu_fake as ref_gpu_fake
from tpumon.collectors import host as ref_host
from tpumon_torch import cli
from tpumon_torch.collectors import accel_cuda, accel_fake, gpu_fake, host

T = 1_700_000_450.0
BACKENDS = ["fake:v5e-8", "fake:v5e-8+faults", "gpufake:dgx-h100-8",
            "fake:v5p-64@pod"]
HOST = {"cpu": {"percent": 12.5, "load_1min": 0.7, "cores": 8},
        "memory": {"percent": 40.0, "used": 25 << 30, "total": 64 << 30}}


def chips(backend: str):
    """(port chips, reference chips) from each package's fake collector."""
    kind, spec = backend.split(":", 1)
    faults = spec.endswith("+faults")
    topology, _, prefix = spec.removesuffix("+faults").partition("@")
    kw = dict(topology=topology, fault_episodes=faults, clock=lambda: T)
    if prefix:
        kw["host_prefix"] = prefix
    mods = ((gpu_fake.FakeGpuCollector, ref_gpu_fake.FakeGpuCollector)
            if kind == "gpufake" else
            (accel_fake.FakeTpuCollector, ref_accel_fake.FakeTpuCollector))
    return [cls(**kw).chips() for cls in mods]


@pytest.mark.parametrize("backend", BACKENDS)
def test_render_equals_reference(backend):
    port, ref = chips(backend)
    rates = {c.chip_id: {"tx_bps": 1.5e9 + i} for i, c in enumerate(port)}
    assert cli.render(port, HOST, rates) == ref_cli.render(ref, HOST, rates)
    assert cli.render(port, {}) == ref_cli.render(ref, {})
    assert cli.render([], HOST) == ref_cli.render([], HOST)


@pytest.mark.parametrize("backend", ["fake:v5e-8", "gpufake:dgx-h100-8"])
def test_local_run_prints_the_reference_table(monkeypatch, tmp_path, capsys,
                                              backend):
    """main(["--backend", ...]) in both packages, at one wall clock and
    over one /proc fixture: the same table, exit 0, nothing on stderr."""
    proc = make_proc(tmp_path)
    monkeypatch.setattr(time, "time", lambda: T)
    for mod, host_mod in ((cli, host), (ref_cli, ref_host)):
        cls = host_mod.HostCollector
        monkeypatch.setattr(
            mod, "HostCollector",
            lambda cpu_count, disk_mounts, cls=cls: cls(
                cpu_count=8, proc_root=proc, disk_mounts=(str(tmp_path),),
                use_native=False))
    for mod in (cli, ref_cli):
        # The fake collectors' default clock is bound when their class is
        # made; set it on the collector the real factory builds.
        def make(cfg, factory=mod.make_accel_collector):
            c = factory(cfg)
            c.clock = time.time
            return c

        monkeypatch.setattr(mod, "make_accel_collector", make)
    out = []
    for mod in (cli, ref_cli):
        assert mod.main(["--backend", backend]) == 0
        got = capsys.readouterr()
        assert got.err == ""
        out.append(got.out)
    assert out[0] == out[1]
    assert "chip" in out[0] and "slice" in out[0]


@pytest.mark.parametrize("argv,code,msg", [
    (["--remote", "127.0.0.1:1"], 1, "unreachable"),
    (["--remote"], 2, "--remote requires a tpumon URL"),
    (["--remote", "x:1", "--backend", "fake:v5e-8"], 2, "mutually exclusive"),
    (["--bogus"], 2, "unknown argument"),
])
def test_refusals(capsys, argv, code, msg):
    assert cli.main(argv) == code
    assert msg in capsys.readouterr().err


def test_help_names_the_port(capsys):
    assert cli.main(["--help"]) == 0
    out = capsys.readouterr().out
    assert "python -m tpumon_torch.info" in out and "--remote" in out
    assert "not yet ported" not in out


def test_default_backend_without_nvml_reports_and_does_not_fall_back(
        monkeypatch, tmp_path, capsys):
    """The default backend is the NVML collector. With no NVML library
    the table shows no chips and stderr carries the collector's error."""
    monkeypatch.setattr(accel_cuda, "NVML_LIB",
                        str(tmp_path / "libnvidia-ml.so.1"))
    monkeypatch.delenv("TPUMON_ACCEL_BACKEND", raising=False)
    assert cli.main([]) == 0
    got = capsys.readouterr()
    assert "no TPU chips visible" in got.out
    assert "[degraded:" in got.err and "libnvidia-ml.so.1" in got.err


def test_sampler_tick_feeds_the_table(monkeypatch):
    """The local mode's path: one Sampler tick over the fake collector,
    whose chips and ICI rates the table renders."""
    from tpumon_torch.config import load_config
    from tpumon_torch.sampler import Sampler

    clock = itertools.count(T)  # one second a read
    monkeypatch.setattr(time, "time", lambda: next(clock))
    s = Sampler(load_config(env={"TPUMON_COLLECTORS": "accel"}),
                accel=accel_fake.FakeTpuCollector(topology="v5e-8",
                                                  clock=lambda: time.time()))
    asyncio.run(s.tick_fast())
    asyncio.run(s.tick_fast())
    table = cli.render(s.chips(), s.host_data(), s.ici_rates)
    assert len(s.chips()) == 8 and len(s.ici_rates) == 8
    assert table.count("GB/s") == 8


RUNTIME = {"hlo_queue_size": {"tensorcore_0": 2, "tensorcore_1": 0},
           "collective_e2e_latency": {
               "2MB+-ALL_REDUCE": {"p50": 210.0, "p999": 800.0}},
           "buffer_transfer_latency": {"8MB+": {"p50": 120.0}}}
HEALTH = {"sources": {
    "host": {"ok": True, "breaker": {"state": "closed"}},
    "k8s": {"ok": False, "error": "deadline exceeded: k8s.collect() "
            "exceeded 10s", "breaker": {"state": "open", "retry_in_s": 42.0}},
    "accel": {"ok": True, "breaker": {"state": "half_open"}}},
    "chaos": "hang:k8s:0.5"}
ALERTS = {"critical": [{"title": "HBM full", "desc": "chip-0 at 97%"}],
          "serious": [{"title": "hot", "desc": "chip-3 at 88C"}],
          "minor": [{"title": "warm", "desc": ""}],
          "silenced": [{"title": "muted"}]}
SERVING = {"targets": [
    {"target": "js:9100", "ok": True, "tokens_per_sec": 1234.5,
     "ttft_p50_ms": 42.0, "spec_accept_pct": 94.2, "kv_pages_used_pct": 62.5},
    {"target": "engine:9105", "ok": True, "tokens_per_sec": None},
    {"target": "trainer:9200", "ok": True, "train_step": 310.0,
     "train_loss": 2.345, "train_goodput_pct": 91.0},
    {"target": "dead:9300", "ok": False, "error": "connection refused"}]}


@pytest.mark.parametrize("name,args", [
    ("render_runtime_lines", (RUNTIME,)), ("render_runtime_lines", (None,)),
    ("render_health_lines", (HEALTH,)), ("render_health_lines", (None,)),
    ("render_status_lines", (ALERTS, SERVING)),
    ("render_status_lines", (None, None)),
])
def test_render_helpers_equal_reference(name, args):
    got = getattr(cli, name)(*args)
    assert got == getattr(ref_cli, name)(*args)
    assert got or args[0] is None


@pytest.mark.parametrize("backend", ["fake:v5e-8+faults", "gpufake:dgx-h100-8"])
def test_remote_lines_equal_reference(clock, capsys, backend):  # noqa: F811
    """``info --remote`` of each package against its own server, the two
    servers over samplers ticked in lockstep into the serving storm: the
    same lines, exit 0, the same degraded note on stderr."""
    pair = Pair(clock, backend=backend)

    async def run():
        await pair.start()
        try:
            for tick in range(25):
                await pair.tick(tick)
            out = []
            for side, mod, (_, srv) in (("port", cli, pair.port),
                                        ("ref", ref_cli, pair.ref)):
                clock.side = side
                rc = await mod._run_remote(f"127.0.0.1:{srv.port}", None)
                out.append((rc, capsys.readouterr()))
            return out
        finally:
            await pair.stop()

    (rc_a, a), (rc_b, b) = asyncio.run(run())
    assert rc_a == rc_b == 0
    assert a.out.splitlines() == b.out.splitlines()
    assert a.err == b.err
    assert "alerts:" in a.out and "serve http://stub/metrics" in a.out
    assert sum("chip-" in line or "gpu-" in line
               for line in a.out.splitlines()) >= 8
