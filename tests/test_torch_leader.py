"""The port's root-HA lease (``tpumon_torch/leader.py``) in lockstep with the
reference's (``tpumon/leader.py``).

Each scenario drives one ``LeaderLease`` of each package through the same
script: a monotonic clock of the test's (read through a ``time`` of each
leader module's own, so ``asyncio`` keeps its real clock), the same peer
answers in place of the blocking heartbeat fetch (``/api/health``'s
leader block, ``/api/events`` pages, or a transport error), the same
seeded ``random.Random`` for the chaos partition draws, and the same
calls (``wedge``, ``observe``). Every step is one cycle of the lease's
own loop: renew, then poll the peer and reconcile its journal. After
each step ``is_leader()``, the generation, ``to_json()`` and the journal
must be equal: bootstrap with the peer unreachable and reachable,
joining as standby, peer silence past two leases, a wedged leader
fencing itself, partitions, a same-generation tie, a higher generation
observed from the tree, a sole root, and journal reconciliation that
mirrors each peer event once and never a mirror.
"""

import asyncio
import random
import time
import types
import urllib.parse

import pytest

from tpumon import leader as ref_leader
from tpumon.collectors.chaos import Fault as RefFault
from tpumon.events import EventJournal as RefJournal
from tpumon.snapshot import EpochClock as RefEpochClock
from tpumon_torch import leader
from tpumon_torch.collectors.chaos import Fault
from tpumon_torch.events import EventJournal
from tpumon_torch.snapshot import EpochClock

T0 = 1_760_000_000.0
LEASE_S = 0.5
SIDES = ((leader, Fault, EventJournal, EpochClock),
         (ref_leader, RefFault, RefJournal, RefEpochClock))


class Peer:
    """The scripted peer root: what its health route says, its journal,
    or the error its heartbeat fails with."""

    def __init__(self):
        self.node = "rootB"
        self.leader = False
        self.generation = 0
        self.error: Exception | None = None
        self.events: list[dict] = []

    def fetch(self, path: str) -> dict:
        if self.error is not None:
            raise self.error
        if path.startswith("/api/health"):
            return {"federation": {"leader": {
                "node": self.node, "leader": self.leader,
                "generation": self.generation}}}
        q = urllib.parse.parse_qs(urllib.parse.urlsplit(path).query)
        after, limit = int(q["after"][0]), int(q["limit"][0])
        return {"events": [e for e in self.events if e["seq"] > after][:limit]}

    def event(self, kind, msg, **extra):
        ev = {"seq": len(self.events) + 1, "ts": T0 + len(self.events),
              "kind": kind, "severity": "info", "source": "peer", "msg": msg}
        ev.update(extra)
        self.events.append(ev)


class Pair:
    """One lease per package over one peer script and one clock."""

    def __init__(self, monkeypatch, node="rootA", peer_url="http://peer:1",
                 initial_leader=False, seed=0):
        self.mono = 1_000.0
        self.wall = T0
        self.peer = Peer()
        monkeypatch.setattr(time, "time", lambda: self.wall)
        clock = types.SimpleNamespace(monotonic=lambda: self.mono,
                                      time=lambda: self.wall)
        self.leases = []
        for mod, _fault, journal_cls, epoch_cls in SIDES:
            monkeypatch.setattr(mod, "time", clock)
            lease = mod.LeaderLease(
                node=node, journal=journal_cls(), peer_url=peer_url,
                lease_s=LEASE_S, initial_leader=initial_leader,
                clock=epoch_cls(), rng=random.Random(seed))
            lease._fetch = self.peer.fetch
            self.leases.append(lease)
        self.history = []

    def advance(self, s: float) -> None:
        self.mono += s
        self.wall += s

    def faults(self, p: float | None) -> None:
        for lease, (_mod, fault, _j, _e) in zip(self.leases, SIDES):
            lease.faults = ([] if p is None
                            else [fault(mode="partition", param=p)])

    def state(self, lease) -> tuple:
        return (lease.is_leader(), lease.generation, lease.to_json(),
                lease.journal.events(), lease.clock.to_json())

    async def cycle(self, dt: float = LEASE_S / 3) -> tuple:
        """One turn of ``LeaderLease._run``'s loop on each side."""
        self.advance(dt)
        for lease in self.leases:
            try:
                lease._renew()
                await lease._poll_cycle()
            except Exception as e:
                lease.last_peer_error = f"{type(e).__name__}: {e}"
        got = [self.state(lease) for lease in self.leases]
        assert got[0] == got[1], len(self.history)
        self.history.append(got[0])
        return got[0]

    def call(self, name, *args) -> tuple:
        for lease in self.leases:
            getattr(lease, name)(*args)
        got = [self.state(lease) for lease in self.leases]
        assert got[0] == got[1], name
        return got[0]


def msgs(state) -> list[str]:
    return [e["msg"] for e in state[3]]


async def bootstrap_unreachable(p: Pair):
    p.peer.error = OSError("connection refused")
    st = await p.cycle()
    assert st[:2] == (True, 1)
    assert "bootstrap: peer unreachable" in msgs(st)[-1]
    for _ in range(6):
        st = await p.cycle()
    assert st[0] and st[2]["last_peer_error"].startswith("OSError")


async def bootstrap_follower(p: Pair):
    p.peer.event("alert", "chip hot", alert="hbm")
    st = await p.cycle()
    assert st[:2] == (True, 1) and st[2]["mirrored_events"] == 1
    p.peer.leader, p.peer.generation = True, 1
    st = await p.cycle()  # same generation, "rootB" > "rootA": A keeps it
    assert st[0] and st[2]["demotions"] == 0


async def standby_joins_then_promotes_on_silence(p: Pair):
    p.peer.leader, p.peer.generation = True, 4
    st = await p.cycle()
    assert st[:2] == (False, 4) and "joined as standby" in msgs(st)[-1]
    p.peer.error = TimeoutError("timed out")
    promoted = None
    for i in range(12):
        st = await p.cycle()
        if st[0] and promoted is None:
            promoted = i
    assert st[:2] == (True, 5) and promoted is not None and promoted >= 4
    assert st[2]["failovers"] == 1 and "peer silent" in msgs(st)[-1]


async def wedged_leader_fences_itself(p: Pair):
    p.peer.error = OSError("down")
    await p.cycle()
    p.peer.error = None
    for _ in range(3):
        st = await p.cycle()
    assert st[:2] == (True, 1)
    p.call("wedge")
    p.peer.error = OSError("down")  # silent for less than two leases
    st = await p.cycle(LEASE_S / 4)
    assert st[0]
    st = await p.cycle(LEASE_S)
    assert not st[0]
    assert "lease expired without renewal" in msgs(st)[-1]
    p.peer.error = None
    p.peer.leader, p.peer.generation = True, 2
    st = await p.cycle()
    assert st[:2] == (False, 2) and st[2]["demotions"] == 1


async def partitions_draw_alike(p: Pair):
    p.faults(0.5)
    for _ in range(20):
        st = await p.cycle()
    assert st[2]["promotions"] >= 1
    p.faults(1.0)
    p.peer.leader, p.peer.generation = True, 9
    for _ in range(4):
        st = await p.cycle()
    assert st[2]["last_peer_error"] == "partitioned (chaos)"
    p.faults(None)
    st = await p.cycle()
    assert st[:2] == (False, 9) and st[2]["demotions"] >= 1


async def same_generation_tie(p: Pair):
    p.peer.error = OSError("down")
    await p.cycle()
    p.peer.error = None
    p.peer.node, p.peer.leader, p.peer.generation = "root0", True, 1
    st = await p.cycle()
    assert st[:2] == (False, 1) and "lexical tie-break" in msgs(st)[-1]


async def observed_generation_demotes(p: Pair):
    p.peer.error = OSError("down")
    st = await p.cycle()
    assert st[0]
    st = p.call("observe", 1, "agg0")
    assert st[0]  # not above its own lease: nothing happens
    st = p.call("observe", 3, "agg0")
    assert st[:2] == (False, 3) and "demoted (fenced)" in msgs(st)[-1]
    p.peer.error = None
    st = await p.cycle()  # peer reachable, not leading, name above: promote
    assert st[:2] == (True, 4)


async def sole_root(p: Pair):
    st = await p.cycle()
    assert st[:2] == (True, 1) and "no peer configured" in msgs(st)[-1]
    st = await p.cycle()
    assert st[2]["promotions"] == 1


async def reconcile_mirrors_once(p: Pair):
    p.peer.leader, p.peer.generation = True, 2
    p.peer.event("alert", "fired", alert="x", state="firing")
    p.peer.event("actuate", "shed", state="fired")
    p.peer.event("alert", "mirror", origin="rootA", origin_seq=1)
    p.peer.event("no-such-kind", "from a newer peer")
    st = await p.cycle()
    assert st[2]["mirrored_events"] == 2
    for _ in range(3):
        st = await p.cycle()
    assert st[2]["mirrored_events"] == 2
    p.peer.event("alert", "resolved", alert="x", state="resolved")
    st = await p.cycle()
    mirrored = [(e["origin"], e["origin_seq"]) for e in st[3]
                if e.get("origin")]
    assert mirrored == [("rootB", 1), ("rootB", 2), ("rootB", 5)]


SCENARIOS = {
    "bootstrap_unreachable": (bootstrap_unreachable, True, "http://peer:1"),
    "bootstrap_follower": (bootstrap_follower, True, "peer:1"),
    "standby_joins": (standby_joins_then_promotes_on_silence, False,
                      "http://peer:1/"),
    "wedge": (wedged_leader_fences_itself, True, "http://peer:1"),
    "partition": (partitions_draw_alike, False, "http://peer:1"),
    "tie_break": (same_generation_tie, True, "http://peer:1"),
    "observe": (observed_generation_demotes, True, "http://peer:1"),
    "sole_root": (sole_root, False, ""),
    "reconcile": (reconcile_mirrors_once, False, "http://peer:1"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("seed", [0, 7])
def test_lease_lockstep(monkeypatch, name, seed):
    fn, initial, peer_url = SCENARIOS[name]
    p = Pair(monkeypatch, peer_url=peer_url, initial_leader=initial,
             seed=seed)
    assert p.leases[0].peer_url == p.leases[1].peer_url
    asyncio.run(fn(p))
    assert p.history


def test_module_constants_and_defaults():
    assert leader.PROMOTE_AFTER_LEASES == ref_leader.PROMOTE_AFTER_LEASES
    assert leader.RECONCILE_PAGE == ref_leader.RECONCILE_PAGE
    a = leader.LeaderLease("n", EventJournal(), lease_s=0.01)
    b = ref_leader.LeaderLease("n", RefJournal(), lease_s=0.01)
    assert a.to_json() == b.to_json() and a.lease_s == 0.2
