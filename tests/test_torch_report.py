"""The port's workload self-report against the reference's.

``tpumon_torch.loadgen.report.WorkloadReporter`` writes through the
port's copy of the channel's writer (``tpumon_torch.collectors.
workload``); the unchanged monitor reads its files
(``tpumon.collectors.workload.read_reports`` and ``WorkloadFileSource``)
with the reference reporter's fields and busy-fraction arithmetic, under
one injected clock. ``footprint_by_device`` runs against a fake
``torch.cuda`` of two devices (this machine has no GPU). The engine's
step and the trainer's step count as declared device work, and
``--no-report`` turns the reporter off in both CLIs.
"""

import json
import os
import threading
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from tpumon.collectors import workload as jax_workload  # noqa: E402
from tpumon.collectors.workload import (  # noqa: E402
    WorkloadFileSource,
    read_reports,
)
from tpumon.loadgen import report as jax_report  # noqa: E402
from tpumon_torch.collectors import workload  # noqa: E402
from tpumon_torch.loadgen import report, serving, train  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig  # noqa: E402

GiB = 1 << 30


class FakeCuda:
    """``torch.cuda`` as far as footprint_by_device reads it: devices with
    PCI bus ids, total memory and allocated bytes (None: unreadable)."""

    def __init__(self, devices):
        self.devices = devices

    def is_available(self):
        return True

    def device_count(self):
        return len(self.devices)

    def get_device_properties(self, i):
        bus, total, _ = self.devices[i]
        return SimpleNamespace(pci_domain_id=0, pci_bus_id=bus,
                               pci_device_id=0, total_memory=total)

    def memory_allocated(self, i):
        used = self.devices[i][2]
        if used is None:
            raise RuntimeError("device unreadable")
        return used


@pytest.fixture
def two_gpus(monkeypatch):
    """Torch device 0 on PCI bus 0x41, device 1 on bus 0x18 (so nvidia-smi
    numbers them 1 and 0); device 1 holds nothing."""
    fake = FakeCuda([(0x41, 80 * GiB, 3 * GiB), (0x18, 80 * GiB, 0)])
    monkeypatch.setattr(report.torch, "cuda", fake)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    return fake


def test_footprint_reports_every_device_in_nvidia_smi_order(two_gpus):
    assert report.footprint_by_device() == {
        0: {"hbm_used": 0, "hbm_total": 80 * GiB},
        1: {"hbm_used": 3 * GiB, "hbm_total": 80 * GiB}}


@pytest.mark.parametrize("visible,want", [
    ("2,3", {2: 0, 3: 3 * GiB}), ("3,2", {2: 0, 3: 3 * GiB}),
    ("GPU-1234,GPU-5678", {0: 0, 1: 3 * GiB})])
def test_footprint_indices_through_cuda_visible_devices(two_gpus,
                                                        monkeypatch,
                                                        visible, want):
    """Integer entries name nvidia-smi's cards (under PCI_BUS_ID order):
    the visible devices take them in PCI order; UUIDs leave the ranks."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    got = report.footprint_by_device()
    assert {i: e["hbm_used"] for i, e in got.items()} == want


def test_unreadable_device_keeps_its_baseline(monkeypatch):
    fake = FakeCuda([(0x18, 80 * GiB, 5), (0x41, 80 * GiB, None)])
    monkeypatch.setattr(report.torch, "cuda", fake)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert report.footprint_by_device() == {
        0: {"hbm_used": 5, "hbm_total": 80 * GiB},
        1: {"hbm_used": 0, "hbm_total": None}}


def test_no_gpu_reports_no_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    assert report.footprint_by_device() == {}


def test_reports_read_back_like_the_references(two_gpus, monkeypatch,
                                               tmp_path):
    """Both reporters, one injected clock and one footprint: the unchanged
    read_reports gets the same devices from each (index, hbm_used,
    hbm_total, busy_frac = 3 busy seconds over a 4 s interval)."""
    clock = {"t": 0.0}
    monkeypatch.setattr(report.time, "monotonic", lambda: clock["t"])
    monkeypatch.setattr(jax_report, "footprint_by_device",
                        report.footprint_by_device)
    files = {}
    for label, mod in (("port", report), ("ref", jax_report)):
        clock["t"] = 0.0
        d = tmp_path / label
        rep = mod.WorkloadReporter(name="serve", directory=str(d))
        with rep.device_work():
            clock["t"] = 3.0
        clock["t"] = 4.0
        rep.write_once(interval_s=4.0)
        (files[label],) = read_reports(str(d))
    assert files["port"]["devices"] == files["ref"]["devices"]
    assert files["port"]["devices"][1] == {
        "index": 1, "hbm_used": 3 * GiB, "hbm_total": 80 * GiB,
        "busy_frac": 0.75}
    assert {k: v for k, v in files["port"].items() if k != "ts"} == {
        k: v for k, v in files["ref"].items() if k != "ts"}


def test_writer_copy_is_the_references(tmp_path):
    assert workload.DEFAULT_DIR == jax_workload.DEFAULT_DIR
    assert workload.REPORT_VERSION == jax_workload.REPORT_VERSION
    devices = [{"index": 0, "hbm_used": 7, "hbm_total": 9,
                "busy_frac": 0.5}]
    for mod in (workload, jax_workload):
        d = tmp_path / mod.__name__
        path = mod.write_report(str(d), "train", devices, pid=1, now=100.0)
        with open(path) as f:
            assert json.load(f) == {"v": 1, "name": "train", "pid": 1,
                                    "ts": 100.0, "devices": devices}
        assert read_reports(str(d), now=101.0)[0]["devices"] == devices
        mod.remove_report(str(d), "train", pid=1)
        assert read_reports(str(d), now=101.0) == []


def test_writer_refuses_a_symlinked_dir(tmp_path):
    real = tmp_path / "victim"
    real.mkdir()
    link = tmp_path / "planted"
    link.symlink_to(real)
    assert workload._owned_by_us(str(real), want_dir=True)
    assert not workload._owned_by_us(str(link), want_dir=True)
    with pytest.raises(PermissionError):
        workload.write_report(str(link), "x", [], pid=1)


def test_drain_does_not_double_count(monkeypatch):
    """The reference's regression: a drain mid-block counts the open slice
    and advances its start, so block exit charges only the rest."""
    clock = {"t": 0.0}
    monkeypatch.setattr(report.time, "monotonic", lambda: clock["t"])
    rep = report.WorkloadReporter(name="t", directory="/nonexistent")
    with rep.device_work():
        clock["t"] = 5.0
        assert abs(rep._drain_busy(clock["t"]) - 5.0) < 1e-9
        clock["t"] = 7.0
    assert abs(rep._drain_busy(clock["t"]) - 2.0) < 1e-9


def test_concurrent_device_work_blocks(monkeypatch):
    """Two threads sharing one reporter each get their own interval."""
    clock = {"t": 0.0}
    monkeypatch.setattr(report.time, "monotonic", lambda: clock["t"])
    rep = report.WorkloadReporter(name="t", directory="/nonexistent")
    enter_b, exit_b = threading.Event(), threading.Event()

    def worker_b():
        with rep.device_work():
            enter_b.set()
            exit_b.wait(5.0)

    t = threading.Thread(target=worker_b, daemon=True)
    with rep.device_work():
        t.start()
        assert enter_b.wait(5.0)
        clock["t"] = 3.0
        exit_b.set()
        t.join(5.0)
        assert not t.is_alive()
        clock["t"] = 5.0
    assert abs(rep._drain_busy(clock["t"]) - 8.0) < 1e-9


def test_reporter_thread_writes_and_stop_removes(two_gpus, tmp_path):
    """The background loop writes a report the unchanged monitor's source
    reads; stop() removes it."""
    d = str(tmp_path)
    rep = report.WorkloadReporter(name="t", directory=d, interval_s=0.02)
    with rep:
        for _ in range(200):
            snap = WorkloadFileSource(directory=d).snapshot()
            if snap:
                break
            threading.Event().wait(0.02)
        assert snap[1]["hbm_used"] == 3 * GiB
        assert "t" in snap[1]["workloads"]
    assert read_reports(d) == []


class Recorder:
    """A reporter that records its busy blocks instead of writing."""

    def __init__(self):
        self.blocks = 0

    def device_work(self):
        import contextlib

        self.blocks += 1
        return contextlib.nullcontext()


def test_engine_step_and_train_step_are_device_work():
    rec = Recorder()
    cfg = serving.default_engine_config()
    eng = serving.ServingEngine(cfg=cfg, device="cpu")
    eng.reporter = rec
    eng.submit([1, 2, 3], max_new=3)
    steps = 0
    while eng.step():
        steps += 1
    assert rec.blocks == steps + 1
    rec = Recorder()
    tcfg = train.TrainConfig(model=ModelConfig(
        vocab=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=64,
        max_seq=32, compute_dtype="float32"), steps=3, batch=1, seq=8)
    out = train.run_train(tcfg, "cpu", reporter=rec)
    assert rec.blocks == 3 and out["loss"] is not None


class StartStop:
    """Stands in for WorkloadReporter in the CLIs: records start/stop."""

    made: list = []

    def __init__(self, name="loadgen", **_):
        self.name = name
        self.events = []
        StartStop.made.append(self)

    def start(self):
        self.events.append("start")
        return self

    def stop(self):
        self.events.append("stop")

    def device_work(self):
        import contextlib

        return contextlib.nullcontext()


@pytest.mark.parametrize("no_report", [False, True])
def test_clis_run_the_reporter_unless_no_report(monkeypatch, no_report):
    monkeypatch.setattr(report, "WorkloadReporter", StartStop)
    StartStop.made = []
    flag = ["--no-report"] if no_report else []
    assert serving.main(["--device", "cpu", "--port", "0", "--duration",
                         "0.1", "--rps", "20", "--max-new", "2"] + flag) == 0
    assert train.main(["--device", "cpu", "--steps", "1", "--batch", "1",
                       "--seq", "16"] + flag) == 0
    if no_report:
        assert StartStop.made == []
    else:
        assert [(r.name, r.events) for r in StartStop.made] == [
            ("serve", ["start", "stop"]), ("train", ["start", "stop"])]


def test_default_dir_is_the_monitors(monkeypatch, tmp_path):
    """A reporter with no directory writes where the monitor reads by
    default (DEFAULT_DIR; moved to tmp_path here)."""
    monkeypatch.setattr(report, "DEFAULT_DIR", str(tmp_path))
    rep = report.WorkloadReporter(name="x")
    path = rep.write_once()
    assert os.path.dirname(path) == str(tmp_path)
    rep.stop()
    assert not os.path.exists(path)
