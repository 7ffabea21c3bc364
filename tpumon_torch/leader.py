"""Root HA leadership: a lease, a monotonic generation token, fencing (a
copy of ``tpumon/leader.py`` with the imports rewritten).

The federation tree (tpumon_torch.federation) funnels into one root — the
paper's single L3 server scaled up but never made redundant — so the
root *is* the outage, and nothing structural stops a zombie root and
its replacement from both driving the actuation loop (tpumon_torch.actuate)
at once. This module is the smallest mechanism that fixes both:

- **Lease**: the active root holds a time-bounded leadership lease it
  must keep renewing from its own event loop. ``is_leader()`` is
  therefore *self-fencing*: a wedged-but-alive root (stalled loop,
  stuck GIL, paused VM) stops renewing, its lease expires, and its own
  actuation engine refuses to fire — no cooperation from anyone else
  required.
- **Generation**: a monotonic fencing token, bumped on every
  promotion. The leader stamps it on every TPWQ fleet query and every
  delta frame (tpumon_torch.protowire trailing varint); downstreams remember
  the highest generation they have seen and answer an older one with an
  explicit "stale generation" error — a deposed root cannot even gather
  the fleet state an actuation decision would need.
- **Heartbeat**: the standby polls the peer root's ``/api/health``
  leadership block. Peer silence past ``2 × lease_s`` (or a reachable
  peer that reports it no longer leads) promotes the standby with
  ``generation + 1``. The same channel reconciles the event journal:
  peer-native events are mirrored by ``(origin node, origin seq)``
  cursor so fired/resolved alert pairs survive promotion without
  duplication (tpumon_torch.events dedup contract).

Two roots and a lease is deliberately NOT a quorum: if the heartbeat
channel partitions while both roots live, both can lead until the
partition heals — at which point the generations fence the loser (it
observes the higher token and demotes). The chaos ``partition`` verb
(docs/resilience.md) exists to exercise exactly that window. For the
deployment this repo models — two roots in one control plane — the
lease failure mode is "operator sees two leaders in the dashboard",
not silent double-shedding: every actuation verb checks the lease
first.

Bootstrap is asymmetric by config: the root with
``federation_initial_leader`` promotes after its *first* peer probe
(reachable-and-follower, or unreachable — a cold cluster must not wait
out a silence window); a restarting root defers to any observed leader
and joins as standby, whatever its bootstrap flag says.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import random
import time
import urllib.request

# Standby promotes after this many lease lengths of peer silence. Two
# leases means one whole missed renewal cycle plus slack for a slow
# poll — tight enough that bench's federation_failover_ms stays within
# a keyframe cadence, loose enough that one dropped poll can't flap
# leadership.
PROMOTE_AFTER_LEASES = 2.0

# Journal-reconciliation page size per poll cycle (the /api/events
# route caps limit at 1000 anyway).
RECONCILE_PAGE = 500


class LeaderLease:
    """One root's side of the two-root lease. Owns a background task
    (``start``/``stop``) that renews its own lease, polls the peer, and
    mirrors the peer's journal; everything else is synchronous state
    the sampler/hub/engine read on their own ticks."""

    def __init__(
        self,
        node: str,
        journal,
        peer_url: str = "",
        lease_s: float = 2.0,
        initial_leader: bool = False,
        auth_token: str | None = None,
        clock=None,
        rng: random.Random | None = None,
    ):
        self.node = node
        self.journal = journal
        peer = peer_url.strip()
        if peer and not peer.startswith(("http://", "https://")):
            peer = f"http://{peer}"
        self.peer_url = peer.rstrip("/")
        self.lease_s = max(0.2, float(lease_s))
        self.initial_leader = bool(initial_leader)
        self.auth_token = auth_token
        self.clock = clock  # snapshot.EpochClock ("federation" section)
        self._rng = rng or random.Random()

        # generation = the highest fencing token this node knows of;
        # _owner = whether this node minted (and still holds) it.
        self.generation = 0
        self._owner = False
        self._expires = 0.0
        self._wedged = False  # test hook: stop self-renewal (see wedge)
        self._bootstrapped = False  # first peer probe has resolved

        self.promotions = 0
        self.demotions = 0
        self.failovers = 0  # promotions that replaced a previous leader
        self.mirrored_events = 0
        self.peer_node: str | None = None
        self.peer_leader: bool | None = None
        self.peer_generation = 0
        self.last_peer_error: str | None = None
        self._last_peer_ok = time.monotonic()
        self._peer_cursor = 0  # peer journal seq already mirrored
        # Chaos partition faults (tpumon_torch.collectors.chaos `partition`
        # mode targeting source "leader"): an active partition makes
        # every peer poll fail without touching the network — lease
        # expiry distinct from clean disconnect.
        self.faults: list = []
        self.on_events = None  # callback after mirroring (cache dirty)
        self._task: asyncio.Task | None = None

    # ----------------------------- state -----------------------------

    def is_leader(self) -> bool:
        """Self-fencing leadership check: ownership AND an unexpired
        lease. Every actuation verb gates on this."""
        return self._owner and time.monotonic() < self._expires

    def wedge(self) -> None:
        """Test hook: simulate a wedged-but-alive root. The event loop
        keeps running (health answers, streams flow) but the lease is
        never renewed again — within ``lease_s`` this root fences
        itself."""
        self._wedged = True

    def _bump(self) -> None:
        if self.clock is not None:
            self.clock.bump("federation")

    def observe(self, generation: int, source: str = "") -> None:
        """A higher generation seen anywhere (ingested frame, TPWR,
        peer health) means a newer leader exists: adopt the token and,
        if this node thought it led, demote — the fencing heal path."""
        if generation <= self.generation:
            return
        was_leader = self._owner
        self.generation = generation
        self._owner = False
        if was_leader:
            self.demotions += 1
            self.journal.record(
                "leader", "serious", self.node,
                f"demoted (fenced): observed generation {generation} "
                f"from {source or 'peer'} above own lease",
                generation=generation,
            )
            self._bump()

    def promote(self, reason: str) -> None:
        self.generation += 1
        self._owner = True
        self._expires = time.monotonic() + self.lease_s
        self._bootstrapped = True
        self.promotions += 1
        first = self.generation == 1
        if not first:
            self.failovers += 1
        self.journal.record(
            "leader", "info" if first else "serious", self.node,
            f"promoted to leader (generation {self.generation}): {reason}",
            generation=self.generation,
        )
        self._bump()

    # ------------------------- renewal + poll -------------------------

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await self._task
            self._task = None

    async def _run(self) -> None:
        tick = max(0.05, self.lease_s / 3.0)
        while True:
            try:
                self._renew()
                await self._poll_cycle()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # survive anything; leases must not die
                self.last_peer_error = f"{type(e).__name__}: {e}"
            await asyncio.sleep(tick)

    def _renew(self) -> None:
        if not self._owner:
            return
        now = time.monotonic()
        if self._wedged:
            if now >= self._expires:
                # The lease ran out without renewal. On a truly wedged
                # root this journal line lands when the loop unwedges;
                # is_leader() went False the moment the lease expired.
                self._owner = False
                self.demotions += 1
                self.journal.record(
                    "leader", "serious", self.node,
                    f"lease expired without renewal (generation "
                    f"{self.generation}); fenced — refusing to actuate",
                    generation=self.generation,
                )
                self._bump()
            return
        self._expires = now + self.lease_s

    def _partitioned(self) -> bool:
        for f in self.faults:
            if f.mode == "partition" and self._rng.random() < f.param:
                return True
        return False

    def _fetch(self, path: str) -> dict:
        """Blocking GET (runs under asyncio.to_thread): the heartbeat
        is deliberately tiny and independent of the ingest streams."""
        req = urllib.request.Request(self.peer_url + path)
        if self.auth_token:
            req.add_header("Authorization", f"Bearer {self.auth_token}")
        timeout = max(0.2, min(1.0, self.lease_s / 2.0))
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())

    async def _poll_cycle(self) -> None:
        if not self.peer_url:
            # Sole configured root: HA is off, but a lease was still
            # asked for — hold leadership so actuation keeps working.
            if not self._owner and self.generation == 0:
                self.promote("no peer configured")
            return
        if self._partitioned():
            self._peer_failed("partitioned (chaos)")
            return
        try:
            health = await asyncio.to_thread(self._fetch, "/api/health")
            info = (health.get("federation") or {}).get("leader") or {}
        except Exception as e:
            self._peer_failed(f"{type(e).__name__}: {e}")
            return
        self.last_peer_error = None
        self._last_peer_ok = time.monotonic()
        self.peer_node = info.get("node")
        self.peer_leader = bool(info.get("leader"))
        self.peer_generation = int(info.get("generation") or 0)
        if self.peer_generation > self.generation:
            if self.peer_leader:
                self.observe(self.peer_generation, self.peer_node or "peer")
            else:
                self.generation = self.peer_generation  # adopt silently
        if (
            self.is_leader()
            and self.peer_leader
            and self.peer_generation == self.generation
            and self.peer_node
            and self.peer_node < self.node
        ):
            # Same-generation split (bootstrap race): deterministic
            # lexical tie-break — the greater node name yields.
            self._owner = False
            self.demotions += 1
            self.journal.record(
                "leader", "serious", self.node,
                f"demoted: generation {self.generation} tie with "
                f"{self.peer_node} (lexical tie-break)",
                generation=self.generation,
            )
            self._bump()
        if not self.is_leader():
            if self.peer_leader:
                if not self._bootstrapped:
                    self._bootstrapped = True
                    self.journal.record(
                        "leader", "info", self.node,
                        f"joined as standby under {self.peer_node} "
                        f"(generation {self.peer_generation})",
                        generation=self.peer_generation,
                    )
            elif self.initial_leader and not self._bootstrapped:
                self.promote("bootstrap: peer reachable and not leading")
            elif self.peer_generation <= self.generation and (
                self.peer_node is None or self.node < self.peer_node
            ):
                self.promote(
                    f"peer {self.peer_node or self.peer_url} reachable "
                    f"but not leading"
                )
        await self._reconcile()

    def _peer_failed(self, err: str) -> None:
        self.last_peer_error = err
        self.peer_leader = None
        if self.is_leader():
            return
        silent = time.monotonic() - self._last_peer_ok
        if self.initial_leader and not self._bootstrapped:
            self.promote(f"bootstrap: peer unreachable ({err})")
        elif silent > PROMOTE_AFTER_LEASES * self.lease_s:
            self.promote(
                f"peer silent {silent:.1f}s (> "
                f"{PROMOTE_AFTER_LEASES:g}x lease {self.lease_s:g}s): {err}"
            )

    # --------------------- journal reconciliation ---------------------

    async def _reconcile(self) -> None:
        """Mirror peer-native journal events by (origin node, origin
        seq): the cursor IS the dedup — each peer seq is fetched once,
        recorded locally with ``origin``/``origin_seq`` attrs, and a
        mirrored copy is never re-mirrored back (no ping-pong). Fired/
        resolved alert pairs therefore survive promotion exactly once."""
        page = await asyncio.to_thread(
            self._fetch,
            f"/api/events?after={self._peer_cursor}&limit={RECONCILE_PAGE}",
        )
        events = page.get("events") or []
        landed = 0
        for ev in events:
            seq = ev.get("seq")
            if not isinstance(seq, int) or seq <= self._peer_cursor:
                continue
            self._peer_cursor = seq
            if ev.get("origin"):
                continue  # already a mirror (possibly of our own events)
            try:
                attrs = {
                    k: v for k, v in ev.items()
                    if k not in ("seq", "ts", "kind", "severity",
                                 "source", "msg")
                }
                self.journal.record(
                    ev["kind"], ev["severity"], ev.get("source", "peer"),
                    ev.get("msg", ""), ts=ev.get("ts"),
                    origin=self.peer_node or "peer", origin_seq=seq,
                    **attrs,
                )
                landed += 1
            except (KeyError, ValueError):
                continue  # unknown kind/severity from a newer peer: skip
        if landed:
            self.mirrored_events += landed
            if self.on_events is not None:
                self.on_events()

    # ------------------------------ views ------------------------------

    def to_json(self) -> dict:
        leader = self.is_leader()
        return {
            "node": self.node,
            "leader": leader,
            "generation": self.generation,
            "lease_s": self.lease_s,
            "expires_in_s": (
                round(max(0.0, self._expires - time.monotonic()), 3)
                if leader else 0.0
            ),
            "peer": self.peer_url or None,
            "peer_node": self.peer_node,
            "peer_leader": self.peer_leader,
            "peer_generation": self.peer_generation,
            "promotions": self.promotions,
            "demotions": self.demotions,
            "failovers": self.failovers,
            "mirrored_events": self.mirrored_events,
            **(
                {"last_peer_error": self.last_peer_error}
                if self.last_peer_error else {}
            ),
        }
