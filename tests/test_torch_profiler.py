"""The port's device-trace capture (``tpumon_torch/profiler.py``, on
``torch.profiler``) and ``/api/profile``.

On the CPU the captures ask for the CPU activity alone: a capture
writes a Chrome trace (CPU op events come from the capturing thread
only, so the trace holds the profiler's own window; the CUDA kernels
another thread launches are read on the card, by chip_smoke);
``status()``, ``history`` and the summary carry the reference's keys; a
second capture while one runs raises ``ProfileBusy`` and the route
answers 409; a capture that asks for CUDA without a card refuses before
it starts (503 through the route) and records nothing.
"""

import asyncio
import json
import threading

import pytest
import torch

from tests.test_torch_server import request
from tpumon import profiler as ref_profiler
from tpumon_torch import profiler
from tpumon_torch.app import build
from tpumon_torch.config import load_config
from tpumon_torch.profiler import ProfileBusy, ProfilerService

SUMMARY_KEYS = {"dir", "seconds", "files", "total_bytes", "captured_at", "hint"}


def work(stop: threading.Event):
    x = torch.ones(64, 64)
    while not stop.is_set():
        torch.mm(x, x)


def test_cpu_capture_writes_a_trace_with_the_reference_keys(tmp_path):
    svc = ProfilerService(base_dir=str(tmp_path), activities=("cpu",))
    ref = ref_profiler.ProfilerService(base_dir=str(tmp_path))
    assert svc.status().keys() == ref.status().keys()
    stop = threading.Event()
    t = threading.Thread(target=work, args=(stop,), daemon=True)
    t.start()
    try:
        result = asyncio.run(svc.capture(seconds=0.3))
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()
    assert set(result) == SUMMARY_KEYS
    assert [f["file"] for f in result["files"]] == [profiler.TRACE_FILE]
    assert result["total_bytes"] > 0 and result["seconds"] >= 0.3
    trace = json.loads((tmp_path / result["dir"] / profiler.TRACE_FILE)
                       .read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "PyTorch Profiler (0)" in names, sorted(map(str, names))
    st = svc.status()
    assert st["last"] == result and st["history"] == [result]
    assert st["captures"] == 1 and st["busy"] is False


def test_second_capture_while_busy_raises(tmp_path):
    svc = ProfilerService(base_dir=str(tmp_path), activities=("cpu",))

    async def two():
        first = asyncio.create_task(svc.capture(seconds=0.4))
        await asyncio.sleep(0.1)
        assert svc.busy
        with pytest.raises(ProfileBusy):
            await svc.capture(seconds=0.1)
        return await first

    assert asyncio.run(two())["seconds"] >= 0.4
    assert svc.captures == 1 and not svc.busy


def test_capture_clamps_and_keeps_a_bounded_history(tmp_path):
    svc = ProfilerService(base_dir=str(tmp_path), max_seconds=0.1,
                          activities=("cpu",))

    async def many():
        for _ in range(ProfilerService.HISTORY + 1):
            await svc.capture(seconds=999)

    asyncio.run(many())
    assert svc.captures == ProfilerService.HISTORY + 1
    assert len(svc.history) == ProfilerService.HISTORY
    assert svc.history[0]["seconds"] < 10.0


@pytest.mark.parametrize("activities", [("cuda",), ("cpu", "cuda")])
def test_cuda_without_a_card_refuses(tmp_path, monkeypatch, activities):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = ProfilerService(base_dir=str(tmp_path), activities=activities)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        asyncio.run(svc.capture(seconds=0.1))
    assert svc.captures == 0 and not svc.busy and svc.last is None
    assert not list(tmp_path.iterdir())
    with pytest.raises(ValueError, match="non-empty subset"):
        profiler.torch_activities(("tpu",))


def test_profile_route_answers_409_while_busy_and_503_without_cuda(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(env={"TPUMON_PORT": "0", "TPUMON_HOST": "127.0.0.1",
                           "TPUMON_ACCEL_BACKEND": "fake:v5e-4",
                           "TPUMON_K8S_MODE": "none"})
    sampler, server = build(cfg)

    async def get(query=""):
        status, _, body = await request(server.port, "/api/profile" + query)
        return status, body

    async def scenario():
        await sampler.tick_all()
        await server.start()
        try:
            st, body = await get()
            assert st == 200 and json.loads(body)["busy"] is False
            # The default activities ask for CUDA: refused, loudly.
            st, body = await get("?seconds=0.1")
            assert st == 503 and b"needs a CUDA device" in body
            server._profiler.activities = ("cpu",)
            first = asyncio.create_task(get("?seconds=0.4"))
            await asyncio.sleep(0.1)
            st, body = await get("?seconds=0.1")
            assert st == 409 and b"already in progress" in body
            st, body = await first
            assert st == 200 and json.loads(body)["total_bytes"] > 0
            st, body = await get("?seconds=nope")
            assert st == 400
            st, _, body = await request(server.port, "/metrics")
            text = body.decode()
            assert "tpumon_profile_captures_total 1" in text
            assert "torch.profiler device-trace captures" in text
        finally:
            await server.stop()

    asyncio.run(scenario())
