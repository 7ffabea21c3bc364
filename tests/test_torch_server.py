"""The port's HTTP server and exporter against the reference's.

Two MonitorServers, the port's and the reference's, each over its own
package's Sampler, tick in lockstep over the same fake collectors
(``tests/test_torch_sampler.py``'s harness: stub host and serving
sources, each package's fake accelerator collector) under a patched
clock: ``time.time`` is the tick's wall clock, and ``time.perf_counter``
and ``time.monotonic`` step a fixed amount a call on a counter of each
side's own, so both sides read the same clock values. Requests go over
real sockets from the test's event loop. After ticks 1, 12 and 24
(during the serving storm, when alerts, the SLO and the actuation
policies have fired) every GET route of the route map answers the same
status and the same JSON, the ``/metrics`` text is equal line for line
(apart from the profiler's help line), each server serves its own
package's dashboard assets, which differ only in eight reworded comments,
and the first SSE frame is equal. POSTs to silence and
unsilence have the same effects, and Bearer auth refuses the same
requests.
"""

import asyncio
import itertools
import json
import threading
import time
from pathlib import Path

import pytest

from tests.test_torch_sampler import ACTUATIONS, SLOS, T0, StubHost, StubServing
from tpumon import collectors as ref_collectors
from tpumon import server as ref_server
from tpumon.collectors import accel_fake as ref_accel_fake
from tpumon.collectors import gpu_fake as ref_gpu_fake
from tpumon.config import load_config as ref_load_config
from tpumon.history import HistoryService as RefHistoryService
from tpumon.sampler import Sampler as RefSampler
from tpumon_torch import collectors, server
from tpumon_torch.collectors import accel_fake, gpu_fake
from tpumon_torch.config import load_config
from tpumon_torch.history import HistoryService
from tpumon_torch.sampler import Sampler

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINTS = (1, 12, 24)

PORT = dict(load_config=load_config, Sampler=Sampler, Sample=collectors.Sample,
            fake=accel_fake.FakeTpuCollector, gpufake=gpu_fake.FakeGpuCollector,
            MonitorServer=server.MonitorServer, HistoryService=HistoryService)
REF = dict(load_config=ref_load_config, Sampler=RefSampler,
           Sample=ref_collectors.Sample, fake=ref_accel_fake.FakeTpuCollector,
           gpufake=ref_gpu_fake.FakeGpuCollector,
           MonitorServer=ref_server.MonitorServer,
           HistoryService=RefHistoryService)

# Routes with parameters, each asked as a user would ask it.
QUERIES = [
    ("/api/history", ""), ("/api/history", "window=3h"),
    ("/api/history", "series=chip.*"), ("/api/history", "window=bogus"),
    ("/api/query", ""), ("/api/query", "query=avg(chip.mxu)"),
    ("/api/query", "query=topk(3,avg_over_time(chip.mxu%5B5m%5D))"),
    ("/api/query", "query=avg%20by%20(slice)%20(chip.hbm)"),
    ("/api/query", "query=bad(("),
    ("/api/query_range", "query=avg(chip.mxu)&window=5m&step=30s"),
    ("/api/events", ""), ("/api/events", "kind=alert&limit=5"),
    ("/api/events", "after=3&severity=serious"),
    ("/api/trace", "fleet=1"), ("/api/trace/export", ""),
    ("/api/profile", ""), ("/api/profile", "seconds=x"),
    ("/api/nope", ""), ("/danyichun/../etc/passwd", ""),
]
# Fields masked before the comparison, each with why: the accelerator
# sample's ``ts`` is stamped by ``Sample``'s default factory, the real
# wall clock bound when the class was made (the fake collectors pass no
# ts); ``ingest_kernel_error`` is the port's own health field (why the
# native ingest kernel failed to build, None when it did not).
VOLATILE = {
    "/api/accel/metrics": ("health.ts",),
    "/api/health": ("sources.accel.ts", "history.ingest_kernel_error"),
    "/api/stream": ("key.accel.health.ts",),
}
# Responses that carry a masked field (or the profiler's help line): the
# byte counts their http spans record differ with it.
SIZED = {"/api/accel/metrics", "/api/health", "/metrics"}
PROFILER_HELP = "# HELP tpumon_profile_captures_total "


class SidedClock:
    """The tick's wall clock, and a step-a-call perf/monotonic clock per
    side (port, reference) for the test's thread; other threads read the
    real clock."""

    def __init__(self):
        self.now = T0
        self.side = "port"
        self._calls = {"port": itertools.count(), "ref": itertools.count()}
        self._owner = threading.get_ident()
        self._real = time.perf_counter
        self.real_monotonic = time.monotonic

    def wall(self) -> float:
        return self.now

    def step(self) -> float:
        if threading.get_ident() != self._owner:
            return self._real()
        return next(self._calls[self.side]) * 0.0005


@pytest.fixture
def clock(monkeypatch):
    c = SidedClock()
    monkeypatch.setattr(time, "time", c.wall)
    monkeypatch.setattr(time, "perf_counter", c.step)
    monkeypatch.setattr(time, "monotonic", c.step)
    # The event loop's own clock stays real: its reads would land on
    # whichever side is active and shift that side's counter.
    monkeypatch.setattr(asyncio.BaseEventLoop, "time",
                        lambda loop: c.real_monotonic())
    return c


def make(pkg, clock, backend="fake:v5e-8+faults", env=None):
    """(sampler, server) of one package over the shared fakes."""
    cfg = pkg["load_config"](env={
        "TPUMON_PORT": "0", "TPUMON_HOST": "127.0.0.1",
        "TPUMON_COLLECTORS": "host,accel,serving",
        "TPUMON_ACCEL_BACKEND": backend,
        "TPUMON_RECORDING_RULES": "chip.mxu[5m],chip.hbm[5m]",
        "TPUMON_HISTORY_PER_CHIP": "6",
        "TPUMON_SLOS": json.dumps(SLOS),
        "TPUMON_ACTUATIONS": json.dumps(ACTUATIONS),
        "TPUMON_ANOMALY_WARMUP": "10",
        "TPUMON_COLLECT_DEADLINE_S": "0",
        **(env or {}),
    })
    kind, spec = backend.split(":", 1)
    accel = pkg[kind](topology=spec.removesuffix("+faults"),
                      fault_episodes=spec.endswith("+faults"),
                      clock=clock.wall)
    s = pkg["Sampler"](cfg, host=StubHost(pkg, clock), accel=accel,
                       serving=StubServing(pkg, clock))
    history = pkg["HistoryService"](s.history, window_s=cfg.history_window_s,
                                    step_s=cfg.history_step_s)
    return s, pkg["MonitorServer"](cfg, s, history)


async def request(port, path, method="GET", body=b"", headers=None,
                  first_event=False):
    """(status, headers, body) over a socket; with ``first_event`` the
    body is the stream's first SSE event."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    head = [f"{method} {path} HTTP/1.1", "Host: t", "Connection: close",
            f"Content-Length: {len(body)}"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await reader.readuntil(b"\r\n\r\n")
    status = int(raw.split()[1])
    hdrs = dict(line.split(": ", 1) for line in
                raw.decode("latin-1").split("\r\n")[1:] if ": " in line)
    if first_event:
        data = await reader.readuntil(b"\n\n")
    else:
        data = await reader.read()
    writer.close()
    return status, hdrs, data


class Pair:
    """The two servers, driven one side at a time on the patched clock."""

    def __init__(self, clock, **kw):
        self.clock = clock
        clock.side = "port"
        self.port = make(PORT, clock, **kw)
        clock.side = "ref"
        self.ref = make(REF, clock, **kw)

    async def both(self, fn):
        out = []
        for side, (s, srv) in (("port", self.port), ("ref", self.ref)):
            self.clock.side = side
            out.append(await fn(s, srv))
        return out

    async def start(self):
        await self.both(lambda s, srv: srv.start())

    async def stop(self):
        await self.both(lambda s, srv: srv.stop())

    async def tick(self, tick):
        self.clock.now = T0 + tick
        await self.both(lambda s, srv: s.tick_all())

    async def get(self, path, **kw):
        return await self.both(lambda s, srv: request(srv.port, path, **kw))


def masked(path, payload):
    for dotted in VOLATILE.get(path, ()):
        *parents, leaf = dotted.split(".")
        node = payload
        for key in parents:
            node = node[key]
        node.pop(leaf, None)
    spans = {"/api/trace": ("spans", "tags"),
             "/api/trace/export": ("traceEvents", "args")}.get(path)
    if spans:
        for span in payload[spans[0]]:
            tags = span.get(spans[1]) or {}
            if tags.get("route") in SIZED:
                tags.pop("bytes", None)
    return payload


def json_routes(srv) -> list[str]:
    static = {"/", "/monitor.html", "/index.html", "/dashboard", "/logo.svg",
              "/chartcore.js", "/dashboard.js", "/metrics", "/api/stream",
              "/api/silence", "/api/unsilence", "/api/federation/ingest"}
    return [r for r in srv.routes() if r not in static]


@pytest.mark.parametrize("backend", ["fake:v5e-8+faults", "gpufake:dgx-h100-8"])
def test_lockstep_routes_equal_reference(clock, backend):
    pair = Pair(clock, backend=backend)
    assert pair.port[1].routes() == pair.ref[1].routes()

    async def run():
        await pair.start()
        try:
            for tick in range(max(CHECKPOINTS) + 1):
                await pair.tick(tick)
                if tick not in CHECKPOINTS:
                    continue
                asked = [(r, "") for r in json_routes(pair.port[1])] + QUERIES
                for path, query in asked:
                    url = path + (f"?{query}" if query else "")
                    (sa, _, a), (sb, _, b) = await pair.get(url)
                    assert sa == sb, (tick, url)
                    if sa == 200:
                        a, b = (masked(path, json.loads(x)) for x in (a, b))
                    assert a == b, (tick, url)
                (sa, _, a), (sb, _, b) = await pair.get("/metrics")
                assert sa == sb == 200
                la, lb = a.decode().splitlines(), b.decode().splitlines()
                assert len(la) == len(lb)
                diff = [(x, y) for x, y in zip(la, lb) if x != y]
                assert [x for x, _ in diff] == [
                    x for x in la if x.startswith(PROFILER_HELP)], tick
                assert "torch.profiler" in diff[0][0]
                assert "jax.profiler" in diff[0][1]
                (sa, ha, a), (sb, hb, b) = await pair.get(
                    "/api/accel/wire",
                    headers={"Accept": "application/x-tpumon-wire"})
                assert (sa, a) == (sb, b) and sa == 200
                assert ha["Content-Type"] == hb["Content-Type"]
        finally:
            await pair.stop()

    asyncio.run(run())
    kinds = {e["kind"] for e in pair.port[0].journal.events()}
    assert {"alert", "slo", "actuate"} <= kinds, kinds


def asset_diff(name: str) -> list[tuple[int, str]]:
    """(line number, the port's line) where the port's copy of a
    dashboard asset differs from the reference's."""
    a = (ROOT / "tpumon_torch" / "web" / name).read_text().splitlines()
    b = (ROOT / "tpumon" / "web" / name).read_text().splitlines()
    assert len(a) == len(b), name
    return [(i + 1, x) for i, (x, y) in enumerate(zip(a, b)) if x != y]


# The port's copies reword eight comments of the reference's assets (a
# machine path and issue numbers); code, markup and text shown are the
# reference's.
REWORDED = {"dashboard.html": [5, 185, 297],
            "dashboard.js": [80, 313, 780, 810, 946],
            "chartcore.js": [], "logo.svg": []}
ASSET_ROUTES = {"/": "dashboard.html", "/monitor.html": "dashboard.html",
                "/logo.svg": "logo.svg", "/chartcore.js": "chartcore.js",
                "/dashboard.js": "dashboard.js"}


def test_static_assets_and_first_sse_frame_equal_reference(clock):
    for name, lines in REWORDED.items():
        diff = asset_diff(name)
        assert [n for n, _ in diff] == lines, name
        assert all(x.strip().startswith(("/*", "*", "//", "<!--"))
                   or "dashboard (its monitor.html)" in x
                   for _, x in diff), diff
    assert server.WEB_DIR == str(ROOT / "tpumon_torch" / "web")
    pair = Pair(clock)

    async def run():
        await pair.start()
        try:
            for tick in range(3):
                await pair.tick(tick)
            for path, name in ASSET_ROUTES.items():
                (sa, ha, a), (sb, hb, b) = await pair.get(path)
                assert sa == sb == 200, path
                assert a == (ROOT / "tpumon_torch" / "web" / name).read_bytes()
                assert b == (ROOT / "tpumon" / "web" / name).read_bytes()
                assert ha["Content-Type"] == hb["Content-Type"], path
            (sa, _, a), (sb, _, b) = await pair.get("/api/stream",
                                                    first_event=True)
            assert sa == sb == 200
            assert a.startswith(b"data: ") and a.endswith(b"\n\n")
            a, b = (masked("/api/stream", json.loads(x.removeprefix(b"data: ")))
                    for x in (a, b))
            assert a == b
            assert a["key"]["host"] and a["key"]["accel"]["chips"]
        finally:
            await pair.stop()

    asyncio.run(run())


def test_silence_posts_have_the_reference_effects(clock):
    pair = Pair(clock)

    async def run():
        await pair.start()
        try:
            for tick in range(24):
                await pair.tick(tick)
            posts = [("/api/silence", {"key": "chip", "duration": "30m"}),
                     ("/api/silence", {"key": "slo", "duration": "0s"}),
                     ("/api/silence", {"duration": "1h"}),
                     ("/api/unsilence", {"key": "chip"}),
                     ("/api/unsilence", {"key": "never-set"}),
                     ("/api/silence", {"key": "serving"}),
                     ("/api/history", {})]
            for path, body in posts:
                (sa, _, a), (sb, _, b) = await pair.get(
                    path, method="POST", body=json.dumps(body).encode())
                assert (sa, a) == (sb, b), path
                (_, _, a), (_, _, b) = await pair.get("/api/alerts")
                assert json.loads(a) == json.loads(b), path
            (sa, _, a), (sb, _, b) = await pair.get(
                "/api/silence", method="POST", body=b"{not json")
            assert sa == sb == 400
            await pair.tick(24)
            (_, _, a), (_, _, b) = await pair.get("/api/events?kind=silence")
            assert json.loads(a) == json.loads(b)
            assert json.loads(a)["events"]
        finally:
            await pair.stop()

    asyncio.run(run())


def test_bearer_auth_refuses_as_the_reference(clock):
    pair = Pair(clock, env={"TPUMON_AUTH_TOKEN": "s3cret"})
    cases = [("/api/silence", "POST", None), ("/api/silence", "POST", "Bearer x"),
             ("/api/silence", "POST", "Bearer s3cret"),
             ("/api/unsilence", "POST", "Basic s3cret"),
             ("/api/profile", "GET", None), ("/api/profile", "GET", "Bearer s3cret"),
             ("/api/trace/export", "GET", None), ("/api/health", "GET", None),
             ("/metrics", "GET", "Bearer nope"), ("/nope", "GET", None)]

    async def run():
        statuses = []
        await pair.start()
        try:
            await pair.tick(0)
            for path, method, auth in cases:
                headers = {"Authorization": auth} if auth else {}
                body = b'{"key": "chip"}' if method == "POST" else b""
                (sa, _, a), (sb, _, b) = await pair.get(
                    path, method=method, headers=headers, body=body)
                assert sa == sb, (path, auth)
                if sa == 401:
                    assert a == b
                statuses.append(sa)
        finally:
            await pair.stop()
        return statuses

    statuses = asyncio.run(run())
    assert statuses.count(401) == 4 and 200 in statuses, statuses
