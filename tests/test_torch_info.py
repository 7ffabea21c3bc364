"""``python -m tpumon_torch.info`` against ``python -m tpumon.info``.

The port's ``cli.render`` prints the reference's table on the same
chips (each package's fake collector at the same clock), and a whole
local run (host, accelerator, sampler tick, table) prints
what the reference prints. ``--remote`` needs the peer collector and
the server, not yet ported: it exits 2 and says so. With no NVML the
default backend reports the collector's error and shows no chips; it
falls back to no other backend.
"""

import asyncio
import itertools
import time

import pytest

from tests.test_host_collector import make_proc
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
    (["--remote", "127.0.0.1:8888"], 2, "not yet ported (ROADMAP item 7c)"),
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
    assert "python -m tpumon_torch.info" in out and "7c" in out


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
