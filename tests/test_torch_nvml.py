"""The port's in-process NVML collector against a fake ``libnvidia-ml``.

``tests/fake_nvml.cpp`` exports the NVML entry points the collector binds
with canned values and nvml.h's struct layouts; it is built here with the
host's g++ (the test skips where there is none). The fake has two cards
in PCI bus order (0x18, 0x9a), one field NOT_SUPPORTED (card 1's
utilisation), no NVLink unless asked, and throttle bits set. The cases
hold the collector's ChipSamples, ``probe_sources()``, the merge with the
workload self-report (by PCI bus id, where CUDA's order is the other
one), the torch allocator source (matched by UUID or PCI bus id), and the
three ways NVML can fail to start: no library, a failing init and a
hanging one, each a degraded sample with its reason and no chips.
"""

from __future__ import annotations

import asyncio
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from tpumon.collectors.workload import read_reports  # noqa: E402
from tpumon_torch.collectors import accel_cuda  # noqa: E402
from tpumon_torch.collectors.accel_cuda import (  # noqa: E402
    CudaGpuCollector,
    Memory,
    MemoryV2,
    PciInfo,
    Utilization,
    throttle_score,
)
from tpumon_torch.collectors.workload import write_report  # noqa: E402
from tpumon_torch.loadgen import report  # noqa: E402

GiB = 1 << 30
TOTAL = 85520809984  # the fake's framebuffer: 81559 MiB
SOURCE = Path(__file__).with_name("fake_nvml.cpp")
UUIDS = ("GPU-11111111-2222-3333-4444-555555555555",
         "GPU-aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee")
FAKE_ENV = ("FAKE_NVML_INIT", "FAKE_NVML_NO_MEMORY", "FAKE_NVML_LINKS")


@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory) -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++ or c++) to build the fake "
                    "libnvidia-ml")
    lib = tmp_path_factory.mktemp("nvml") / "libnvidia-ml-fake.so.1"
    proc = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                           "-o", str(lib), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return str(lib)


@pytest.fixture
def env(monkeypatch):
    for key in FAKE_ENV:
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


def collect(collector, probe: bool = False):
    async def go():
        try:
            s = await collector.collect()
            p = await collector.probe_sources() if probe else None
            return s, p
        finally:
            await collector.close()
    return asyncio.run(go())


def chip_fields(chip) -> dict:
    d = chip.to_json()
    for key in ("chip", "host", "slice", "coords", "hbm_pct"):
        d.pop(key)
    return d


def test_struct_layouts_are_nvml_h():
    """Sizes and offsets of nvml.h's structs (x86-64): a ctypes field out
    of place reads garbage, not an error."""
    assert ctypes.sizeof(PciInfo) == 68
    assert (PciInfo.domain.offset, PciInfo.bus.offset, PciInfo.device.offset,
            PciInfo.busId.offset) == (16, 20, 24, 36)
    assert ctypes.sizeof(Memory) == 24 and Memory.used.offset == 16
    assert ctypes.sizeof(MemoryV2) == 40
    assert (MemoryV2.total.offset, MemoryV2.reserved.offset,
            MemoryV2.used.offset) == (8, 16, 32)
    # NVML_STRUCT_VERSION(Memory, 2)
    assert accel_cuda.MEMORY_V2_VERSION == 0x02000028
    assert ctypes.sizeof(Utilization) == 8


def test_chip_samples_from_canned_values(fake_lib, env):
    s, _ = collect(CudaGpuCollector(nvml_lib=fake_lib, hostname="h0"))
    assert s.ok and s.error is None and s.notes == []
    assert [c.chip_id for c in s.data] == ["h0/gpu-0", "h0/gpu-1"]
    assert {c.slice_id for c in s.data} == {"gpu-0"}
    base = dict(kind="h100", hbm_total=TOTAL, ici_tx_bytes=None,
                ici_rx_bytes=None, ici_link_up=None, ici_link_health=None,
                counter_source="nvml", accel_kind="gpu")
    assert [chip_fields(c) for c in s.data] == [
        # v2's used (no driver reserve); software power cap + hardware
        # thermal slowdown -> 10.
        dict(base, index=0, mxu_duty_pct=87.0, hbm_used=3 * GiB,
             temp_c=41.0, throttle_score=10),
        # utilisation NOT_SUPPORTED -> None, the sample still ok;
        # software thermal slowdown (idle bit ignored) -> 6.
        dict(base, index=1, mxu_duty_pct=None, hbm_used=1 * GiB,
             temp_c=55.0, throttle_score=6),
    ]


def test_probe_sources(fake_lib, env, tmp_path):
    _, p = collect(CudaGpuCollector(nvml_lib=fake_lib,
                                    workload_dir=str(tmp_path / "w")),
                   probe=True)
    assert sorted(p) == ["nvml", "torch", "workload"]
    assert p["nvml"]["live"]
    assert "2 device(s) (NVIDIA H100 80GB HBM3)" in p["nvml"]["detail"]
    assert p["torch"] == {"live": False, "detail":
                          "torch.cuda not initialised in this process"}
    assert not p["workload"]["live"]
    assert p["workload"]["detail"].endswith("no fresh reports")


class FakeCuda:
    """``torch.cuda`` of a process holding both cards, in CUDA's order:
    device 0 is the card on PCI bus 0x9a, device 1 the one on 0x18."""

    def __init__(self, uuids=True, pci=True):
        self.devices = [(0x9a, UUIDS[1], 6 * GiB), (0x18, UUIDS[0], 2 * GiB)]
        self.uuids, self.pci = uuids, pci

    def is_available(self):
        return True

    def is_initialized(self):
        return True

    def device_count(self):
        return 2

    def get_device_properties(self, i):
        bus, uuid, _ = self.devices[i]
        return SimpleNamespace(
            pci_domain_id=0, pci_bus_id=bus if self.pci else 0,
            pci_device_id=0, total_memory=80 * GiB,
            uuid=uuid[4:] if self.uuids else "")

    def memory_allocated(self, i):
        return self.devices[i][2]


def test_workload_reports_merge_by_pci_bus_id(fake_lib, env, tmp_path):
    """The port's reporter keys its devices by PCI rank; CUDA's device 0
    is card 1 here. Card 1's utilisation is NOT_SUPPORTED, so its duty
    comes from the report of the device on its bus (busy 0.75), not from
    CUDA's device 1 (busy 0.25); NVML's memory still ranks first."""
    env.setattr(report.torch, "cuda", FakeCuda())
    env.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    devices = [{"index": idx, **ent, "busy_frac": ent["hbm_used"] / (8 * GiB)}
               for idx, ent in sorted(report.footprint_by_device().items())]
    d = tmp_path / "w"
    write_report(str(d), "serve", devices)
    # The unchanged monitor reads the same file the same way.
    assert read_reports(str(d))[0]["devices"] == devices
    s, p = collect(CudaGpuCollector(nvml_lib=fake_lib,
                                    workload_dir=str(d)), probe=True)
    c0, c1 = s.data
    assert (c0.mxu_duty_pct, c0.counter_source) == (87.0, "nvml")
    assert (c1.mxu_duty_pct, c1.hbm_used, c1.counter_source) == (
        75.0, 1 * GiB, "nvml+workload")
    assert s.ok and any("source: workload — serve" in n for n in s.notes)
    assert p["workload"] == {"live": True,
                             "detail": f"{d}: 2 device entries"}


@pytest.mark.parametrize("by", ["uuid", "pci"])
def test_torch_source_fills_memory_nvml_does_not_give(fake_lib, env, by):
    """Card 1's memory NOT_SUPPORTED: in a process where torch.cuda is
    initialised, its allocator's reading of the same card (CUDA's device
    0, matched by UUID or by PCI bus id) fills it."""
    env.setenv("FAKE_NVML_NO_MEMORY", "1")
    env.setattr(torch, "cuda", FakeCuda(uuids=by == "uuid",
                                        pci=by == "pci"))
    s, p = collect(CudaGpuCollector(nvml_lib=fake_lib), probe=True)
    c0, c1 = s.data
    assert (c0.hbm_used, c0.hbm_total, c0.counter_source) == (
        3 * GiB, TOTAL, "nvml")
    assert (c1.hbm_used, c1.hbm_total, c1.mxu_duty_pct,
            c1.counter_source) == (6 * GiB, 80 * GiB, None, "torch")
    assert s.ok
    assert p["torch"]["live"]


def test_no_counter_source_degrades_the_sample(fake_lib, env):
    env.setenv("FAKE_NVML_NO_MEMORY", "1")
    s, _ = collect(CudaGpuCollector(nvml_lib=fake_lib))
    assert not s.ok and s.error == "chip 1: no counter source"
    assert (s.data[1].hbm_used, s.data[1].counter_source) == (None, None)
    assert s.data[1].temp_c == 55.0  # the fields NVML gives stay


@pytest.mark.parametrize("links,want", [
    (None, [(None, None), (None, None)]),
    ("up", [(True, 0), (None, None)]),  # card 1: links, none active
    ("degraded", [(False, 7), (None, None)]),
])
def test_nvlink_state(fake_lib, env, links, want):
    if links:
        env.setenv("FAKE_NVML_LINKS", links)
    s, _ = collect(CudaGpuCollector(nvml_lib=fake_lib))
    assert s.ok
    assert [(c.ici_link_up, c.ici_link_health) for c in s.data] == want


@pytest.mark.parametrize("reasons,score", [
    (0x0, 0), (0x1, 0), (0x2 | 0x10 | 0x100, 0), (0x4, 3), (0x20, 6),
    (0x4 | 0x20, 6), (0x8, 10), (0x40, 10), (0x80, 10), (0x1 | 0x80, 10)])
def test_throttle_score(reasons, score):
    assert throttle_score(reasons) == score


def test_missing_library_degrades(env, tmp_path):
    missing = str(tmp_path / "libnvidia-ml.so.1")
    s, p = collect(CudaGpuCollector(nvml_lib=missing), probe=True)
    assert (s.ok, s.data) == (False, [])
    assert s.error.startswith(f"RuntimeError: {missing} not loadable")
    assert p["nvml"] == {"live": False, "detail": s.error}


def test_failing_init_degrades(fake_lib, env):
    env.setenv("FAKE_NVML_INIT", "fail")
    s, _ = collect(CudaGpuCollector(nvml_lib=fake_lib))
    assert (s.ok, s.data) == (False, [])
    assert s.error == ("NvmlError: nvmlInit_v2: Driver Not Loaded "
                       "(NVML error 9)")


def test_hanging_init_degrades_at_its_timeout(fake_lib, env):
    """The fake's init sleeps 20 s: the collector gives up at its
    timeout, keeps the reason for later samples, and does not wait for
    the init thread at exit."""
    env.setenv("FAKE_NVML_INIT", "hang")
    c = CudaGpuCollector(nvml_lib=fake_lib, init_timeout_s=0.3)

    async def go():
        first = await c.collect()
        env.delenv("FAKE_NVML_INIT")
        return first, await c.collect()

    t0 = time.monotonic()
    first, second = asyncio.run(go())
    assert time.monotonic() - t0 < 5.0
    for s in (first, second):
        assert (s.ok, s.data) == (False, [])
        assert s.error == "NVML init hung >0.3s (wedged driver?)"


def test_the_collector_never_imports_torch(fake_lib, env):
    """Sampling the card from a monitor process that has not imported
    torch leaves it so: the collector creates no CUDA context."""
    code = (
        "import asyncio, sys\n"
        "from tpumon_torch.collectors.accel_cuda import CudaGpuCollector\n"
        f"s = asyncio.run(CudaGpuCollector(nvml_lib={fake_lib!r}).collect())\n"
        "print(s.ok, len(s.data), 'torch' in sys.modules)\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "2", "False"]
