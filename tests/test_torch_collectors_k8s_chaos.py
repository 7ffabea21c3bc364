"""The port's k8s, chaos and peer collectors against the reference's.

- ``collectors/k8s.py``: the reference tests' pod documents (crash loops,
  OOM kills, pending pods without status, TPU node selectors) parse to
  the same rows; the fake, api and watch modes give the same samples,
  the api and watch modes each against a fake API server of their own
  (``tests/fakes.py``, ``tests/test_k8s_watch.py``).
- ``collectors/chaos.py``: the spec grammar, its refusals and the link
  split are the reference's; a wrapper at the same seed over the same
  inner samples injects the same faults, corrupts the same keys and
  journals the same notes, collect by collect.
- ``collectors/accel_peers.py``: both packages' peer collectors against
  a live port server, over the binary wire and over JSON, federate the
  same chips; the factory builds the port's one from ``cfg.peers``.
"""

import asyncio
import dataclasses
import datetime
import time
import types

import pytest

from tests.fakes import fake_k8s_api
from tests.test_k8s import NOW, pod_doc
from tests.test_k8s_watch import FakeWatchApi, pod_item, wait_for
from tpumon.collectors import accel_fake as ref_accel_fake
from tpumon.collectors import accel_peers as ref_peers
from tpumon.collectors import chaos as ref_chaos
from tpumon.collectors import k8s as ref_k8s
from tpumon.events import EventJournal as RefJournal
from tpumon_torch.app import build
from tpumon_torch.collectors import accel as port_accel
from tpumon_torch.collectors import accel_fake, accel_peers, chaos, k8s
from tpumon_torch.config import load_config
from tpumon_torch.events import EventJournal

DOCS = [
    pod_doc(restarts=(2, 3)),
    pod_doc(name="pend", phase="Pending"),
    pod_doc(name="crash", restarts=(4,), status__containerStatuses=[
        {"restartCount": 4, "state": {"waiting": {"reason": "CrashLoopBackOff"}}}]),
    pod_doc(name="oom", status__containerStatuses=[
        {"restartCount": 1, "state": {"running": {}},
         "lastState": {"terminated": {"reason": "OOMKilled"}}}]),
    pod_doc(name="done", phase="Succeeded", status__containerStatuses=[
        {"restartCount": 0, "state": {"terminated": {"reason": "Completed"}}}]),
    pod_doc(name="tpu", ns="jobs", start_offset_s=3 * 86400,
            spec__nodeSelector={
                "cloud.google.com/gke-tpu-topology": "2x4",
                "cloud.google.com/gke-tpu-accelerator": "tpu-v5-lite-podslice"},
            spec__containers=[{"resources": {"limits": {"google.com/tpu": "4"}}}],
            metadata__labels={"jobset.sigs.k8s.io/jobset-name": "train"}),
]


def plain(x):
    """Dataclasses (each package has its own ChipSample) as dicts."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def sample_view(s):
    return (s.source, s.ok, plain(s.data), s.error, s.notes)


def test_pod_parser_equals_reference():
    bare = pod_doc(name="bare", phase="Pending")
    del bare["status"]["containerStatuses"], bare["status"]["startTime"]
    doc = {"items": DOCS + [bare]}
    assert k8s.parse_pod_list(doc, now=NOW) == ref_k8s.parse_pod_list(doc, now=NOW)
    for s in (0, 10, 150, 3 * 3600 + 100, 2 * 86400 + 5):
        assert k8s.humanize_age(s) == ref_k8s.humanize_age(s)


class FrozenDatetime(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime.fromtimestamp(NOW, tz)


@pytest.fixture
def frozen(monkeypatch):
    """Both parsers' "now" (pod ages) and the fake source's clock at NOW."""
    shim = types.SimpleNamespace(datetime=FrozenDatetime,
                                 timezone=datetime.timezone)
    for mod in (k8s, ref_k8s):
        monkeypatch.setattr(mod, "dt", shim)
    monkeypatch.setattr(time, "time", lambda: NOW)


def test_fake_and_api_modes_equal_reference(frozen):
    api = fake_k8s_api(DOCS)
    try:
        for kw in ({"mode": "fake"}, {"mode": "api", "api_url": api.url},
                   {"mode": "none"},
                   {"mode": "api", "api_url": "http://127.0.0.1:9"}):
            a = asyncio.run(k8s.K8sCollector(**kw).collect())
            b = asyncio.run(ref_k8s.K8sCollector(**kw).collect())
            assert sample_view(a) == sample_view(b), kw
    finally:
        api.close()


def test_watch_mode_equals_reference(frozen):
    """One fake watch API for each package, fed the same events: the
    collectors' samples (interim phases, a deleted pod's excursion) are
    equal after each step."""
    apis = [FakeWatchApi([pod_item("web"), pod_item("db")]) for _ in range(2)]
    colls = [mod.K8sCollector(mode="watch", api_url=api.url)
             for mod, api in zip((k8s, ref_k8s), apis)]
    try:
        samples = [asyncio.run(c.collect()) for c in colls]
        assert [s.ok for s in samples] == [False, False]  # not synced yet
        assert wait_for(lambda: all(c._watcher.synced for c in colls))
        steps = [  # (events, the phase excursions they record)
            ([("MODIFIED", pod_item("web", phase="Failed"))], 1),
            ([("ADDED", pod_item("job", rv="12")),
              ("MODIFIED", pod_item("job", phase="Failed", rv="13")),
              ("DELETED", pod_item("job", phase="Failed", rv="14"))], 3),
            ([], 0),
        ]
        for events, excursions in steps:
            for api in apis:
                for kind, item in events:
                    api.send_event(kind, item)
            assert wait_for(lambda: all(
                sum(map(len, c._watcher._interim.values())) == excursions
                for c in colls))
            a, b = (asyncio.run(c.collect()) for c in colls)
            assert sample_view(a) == sample_view(b)
            assert a.ok and len(a.data) == 2 + (excursions == 3)
    finally:
        for api in apis:  # end the streams first: the watchers then stop
            api.shutdown()
        for c in colls:
            c.stop()


@pytest.mark.parametrize("spec", [
    "hang:accel:0.1,err:k8s:0.3,slow:host:200",
    "corrupt:accel:0.5, flap:serving:0.2",
    "partition:uplink:1.0,err:accel:0.1,partition:leader:0.5",
    "bogus:accel:0.1", "err:accel", "err:accel:x", "err:accel:1.5",
    "slow:host:-1",
])
def test_chaos_spec_equals_reference(spec):
    out = []
    for mod in (chaos, ref_chaos):
        try:
            out.append(("ok", repr(mod.parse_chaos_spec(spec)),
                        repr(mod.split_link_faults(spec))))
        except ValueError as e:
            out.append(("error", str(e)))
    assert out[0] == out[1]


class Inner:
    """Each package's fake accelerator at a stepping clock, as a
    collector (the same samples on both sides)."""

    name = "accel"

    def __init__(self, mod):
        self.t = 1_700_000_000.0
        self.fake = mod.FakeTpuCollector(topology="v5e-4",
                                         clock=lambda: self.t)

    async def collect(self):
        self.t += 1.0
        return await self.fake.collect()


@pytest.mark.parametrize("spec", ["err:accel:0.3,corrupt:accel:0.4",
                                  "flap:accel:0.35,slow:accel:1",
                                  "corrupt:accel:1.0"])
def test_chaos_wrapper_at_one_seed_equals_reference(spec):
    wrapped, journals = [], []
    for mod, fake, journal in ((chaos, accel_fake, EventJournal),
                               (ref_chaos, ref_accel_fake, RefJournal)):
        w = mod.wrap_collectors({"accel": Inner(fake), "host": None}, spec,
                                seed=7)
        j = journal()
        w["accel"].set_journal(j)
        assert w["host"] is None and w["accel"].name == "accel"
        wrapped.append(w["accel"])
        journals.append(j)

    async def run(c):
        out = []
        for _ in range(30):
            try:
                s = await c.collect()
                out.append(("ok", s.ok, plain(s.data), s.notes))
            except Exception as e:
                out.append(("raised", type(e).__name__, str(e)))
        return out

    a, b = asyncio.run(run(wrapped[0])), asyncio.run(run(wrapped[1]))
    assert a == b
    assert any(x[0] == "raised" for x in a) or "corrupt" in spec
    strip = lambda j: [(e["kind"], e["severity"], e["source"], e["msg"])  # noqa: E731
                       for e in j.events()]
    assert strip(journals[0]) == strip(journals[1]) and strip(journals[0])
    with pytest.raises(ValueError, match="unknown source"):
        chaos.wrap_collectors({"accel": None}, "err:gpu:0.1")
    with pytest.raises(ValueError, match="disabled source"):
        chaos.wrap_collectors({"accel": None}, "err:accel:0.1")


def test_peer_collectors_against_a_port_server_equal_reference():
    """A port server over 4 fake chips (hosts ha-*); both packages' peer
    collectors fetch it, over the binary wire and with JSON only, and
    federate the same chips; a dead peer is reported alike."""
    cfg = load_config(env={"TPUMON_PORT": "0", "TPUMON_HOST": "127.0.0.1",
                           "TPUMON_ACCEL_BACKEND": "fake:v5e-4@ha",
                           "TPUMON_K8S_MODE": "none"})
    sampler, server = build(cfg)

    async def scenario():
        await sampler.tick_all()
        await server.start()
        try:
            peer = f"127.0.0.1:{server.port}"
            for wire in (True, False):
                got = []
                for mod in (accel_peers, ref_peers):
                    fed = mod.PeerFederatedCollector(
                        local=None, peers=(peer, "127.0.0.1:9"),
                        timeout_s=1.0, wire_binary=wire)
                    s = await fed.collect()
                    got.append((s.ok, [c.to_json() for c in s.data],
                                dict(fed.last_peer_status)))
                assert got[0] == got[1], wire
                assert len(got[0][1]) == 4
                assert all(c["chip"].startswith("ha-") for c in got[0][1])
        finally:
            await server.stop()

    asyncio.run(scenario())
    for url in ("h:8888", "http://h:8888/", "https://h"):
        assert (accel_peers.normalize_base_url(url)
                == ref_peers.normalize_base_url(url))
    cfg = load_config(env={"TPUMON_ACCEL_BACKEND": "fake:v5e-4",
                           "TPUMON_PEERS": "http://a:8899,b:8898"})
    fed = port_accel.make_accel_collector(cfg)
    assert isinstance(fed, accel_peers.PeerFederatedCollector)
    assert isinstance(fed.local, accel_fake.FakeTpuCollector)
    assert fed.peers == ("http://a:8899", "b:8898")
