"""Three-tier alert engine, re-keyed for TPU.

Reference parity (monitor_server.js:156-238 ``checkAlerts``): severity
buckets ``{minor, serious, critical}`` of ``{title, desc, fix}`` alerts
(``fix`` is human remediation advice), with threshold rules (SURVEY §2.2)
and stateful pod-transition detection (recovered / restarted).

Deliberate fixes over the reference:
- **Per-chip** accelerator rules — the reference inspected only device 0
  (monitor_server.js:178); a v5e-8 has 8 chips.
- **Server-side sampling** — the reference updated its transition cache
  inside the request handler (monitor_server.js:235), so detection
  depended on client polling and concurrent clients raced on shared
  state (SURVEY §5.2). Here the engine is owned by the background
  sampler; requests only read the last evaluation.
- TPU-only rules: stalled-chip (HBM committed but MXU idle), ICI link
  down, and slice-failure (expected chips missing) per SURVEY §2.2's
  north-star re-keying.
- **Expression rules**: the host/chip/slice/serving
  threshold rules are no longer hand-rolled comparison closures — each
  is an expression in the in-tree query language (tpumon_torch.query),
  formatted with this config's threshold values and **compiled once
  per engine** (``compile_env``); the per-tick loop evaluates the
  generated closures over a flat ``chip.hbm``-style environment. The
  pre-refactor behavior is pinned bit-for-bit by the golden scenario
  fixture (tests/fixtures/alerts_scenario.json). Presentation
  (title/desc/fix text) stays data in the rule specs; only the firing
  *conditions* are expressions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable

from tpumon_torch.config import Thresholds, TriLevel
from tpumon_torch.events import EventJournal
from tpumon_torch.query import compile_env
from tpumon_torch.topology import ChipSample, SliceView, accel_terms, attribute_pods

SEVERITIES = ("minor", "serious", "critical")


@dataclass(frozen=True)
class Alert:
    severity: str
    title: str
    desc: str
    fix: str
    key: str  # stable identity for dedup/testing

    def to_json(self) -> dict:
        return {
            "severity": self.severity,
            "title": self.title,
            "desc": self.desc,
            "fix": self.fix,
            "key": self.key,
        }


def _bucketize(alerts: Iterable[Alert]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {s: [] for s in SEVERITIES}
    for a in alerts:
        out[a.severity].append(a.to_json())
    return out


_SEV_LABEL = {"minor": "notice", "serious": "high", "critical": "critical"}


# ------------------- expression-rule generation -------------------------
#
# Threshold rules are built from expression strings in the in-tree
# query language (tpumon_torch.query.compile_env): the gate/condition text is
# formatted with the config's threshold values ONCE per engine and
# compiled to a closure; evaluation is then closure(env) over a flat
# environment ({"chip.hbm": 91.0, ...}). Missing data follows alerting
# semantics — a comparison against None is False, so absent metrics
# never fire. The generated evaluators slot into the same rules × items
# loops the hand-rolled closures used, pinned by the golden scenario
# fixture.


def _tri_rule(value_expr: str, tri: TriLevel, gate_expr: str | None, emit):
    """Generated evaluator for a TriLevel threshold: optional compiled
    gate, compiled value expression, tri.severity() classification,
    ``emit(item, value, sev, note) -> Alert``."""
    value_fn = compile_env(value_expr)
    gate_fn = compile_env(gate_expr) if gate_expr else None

    def rule(item, env: dict, note: str) -> Alert | None:
        if gate_fn is not None and not gate_fn(env):
            return None
        v = value_fn(env)
        if v is None:
            return None
        sev = tri.severity(float(v))
        if not sev:
            return None
        return emit(item, float(v), sev, note)

    return rule


def _cond_rule(cond_expr: str, emit):
    """Generated evaluator for a fixed-severity condition expression:
    ``emit(item, env, note) -> Alert`` runs iff the compiled condition
    holds."""
    cond_fn = compile_env(cond_expr)

    def rule(item, env: dict, note: str) -> Alert | None:
        if not cond_fn(env):
            return None
        return emit(item, env, note)

    return rule


def _chip_env(c: ChipSample, hbm: float | None) -> dict:
    """The expression vocabulary for per-chip rules — deliberately the
    same ``chip.<metric>`` spelling the query engine derives from the
    ring's series naming, so an alert condition reads like a query."""
    return {
        "chip.hbm": hbm,
        "chip.mxu": c.mxu_duty_pct,
        "chip.temp": c.temp_c,
        "chip.ici_health": (
            None if c.ici_link_health is None else float(c.ici_link_health)
        ),
        "chip.throttle": (
            None if c.throttle_score is None else float(c.throttle_score)
        ),
        "chip.link_up": (
            None if c.ici_link_up is None else (1.0 if c.ici_link_up else 0.0)
        ),
    }


class AlertEngine:
    def __init__(
        self,
        thresholds: Thresholds | None = None,
        journal: EventJournal | None = None,
    ):
        self.t = thresholds or Thresholds()
        # Threshold rules as compiled expressions, built once per
        # config (the expression text embeds this config's threshold
        # values): the per-tick loops evaluate generated closures, not
        # hand-rolled comparisons (_build_*_rules; docs/query.md).
        self._chip_rules = self._build_chip_rules()
        self._host_rules = self._build_host_rules()
        self._slice_rule = self._build_slice_rule()
        self._kv_rule = self._build_kv_rule()
        # Pod transition state (reference: module-global lastPodStates,
        # monitor_server.js:157 — here private to the engine, which is
        # only driven by the sampler).
        self._last_pods: dict[str, dict] | None = None
        self._last_eval: dict[str, list[dict]] = _bucketize([])
        self._last_eval_ts: float | None = None
        self._active_keys: dict[str, dict] = {}
        # Fired/resolved timeline (the reference keeps no alert history
        # at all). The engine's old private deque is gone: timeline
        # events now live in the shared structured journal
        # (tpumon_torch.events, kind="alert") — /api/alerts, the webhook
        # notifier and /api/events all read the SAME record. A
        # standalone engine (tests, tools) gets a private journal.
        self.journal = journal if journal is not None else EventJournal(512)
        # Seq of the last ALERT event this engine recorded — the alerts
        # section fingerprint, insulated from other kinds' traffic.
        self._timeline_seq = 0
        # Anti-flap hold bookkeeping (Thresholds.fire_hold_s /
        # resolve_hold_s): key -> ts the condition was first seen pending
        # fire / first seen clear pending resolve.
        self._pending_fire: dict[str, float] = {}
        self._pending_resolve: dict[str, float] = {}
        # Training-stall tracking: target -> (last seen step, ts it was
        # first seen at that step).
        self._train_progress: dict[str, tuple[float, float]] = {}
        # Silences: key-prefix -> expiry ts. A silenced alert keeps its
        # full lifecycle (state tracking, timeline) but is excluded from
        # the served severity buckets and from webhook delivery —
        # Alertmanager semantics: mute the noise, don't blind the record.
        self.silences: dict[str, float] = {}
        self._last_silenced: list[dict] = []
        # Fired events suppressed by a silence: if the alert is still
        # active when its silence ends, a fresh "fired" event re-notifies
        # (Alertmanager re-notifies on silence expiry).
        self._suppressed_fires: set[str] = set()

    # ---------------- timeline (journal-backed) --------------------------

    def bind_journal(self, journal: EventJournal) -> None:
        """Re-point the timeline at a shared journal (the sampler's),
        migrating any events recorded against the private one — so an
        engine built standalone then handed to a Sampler keeps one
        consistent record. An empty target adopts the private seqs
        verbatim; a non-empty one re-records (fresh seqs) so private
        seq numbers can't collide-and-drop against events the shared
        journal already holds."""
        if journal is self.journal:
            return
        private = self.journal.events()
        if journal.seq == 0:
            journal.ingest(private)
        else:
            for e in private:
                attrs = {
                    k: v
                    for k, v in e.items()
                    if k not in ("seq", "ts", "kind", "severity", "source", "msg")
                }
                journal.record(
                    e["kind"], e["severity"], e["source"], e["msg"],
                    ts=e["ts"], **attrs,
                )
        self.journal = journal
        self._timeline_seq = max(
            (e["seq"] for e in self.events), default=self._timeline_seq
        )

    def _emit(self, state: str, alert: dict, now: float, **extra) -> dict:
        """One timeline event (kind="alert") into the journal. Keeps the
        legacy event shape (state/title/desc/fix/key ride flat) so the
        notifier, dashboard timeline and state snapshots are unchanged."""
        ev = self.journal.record(
            "alert",
            alert["severity"],
            "alerts",
            f"{alert['title']} {state}",
            ts=now,
            state=state,
            title=alert["title"],
            desc=alert["desc"],
            fix=alert["fix"],
            key=alert["key"],
            **extra,
        )
        self._timeline_seq = ev["seq"]
        return ev

    @property
    def events(self) -> list[dict]:
        """The alert timeline: journal events of kind "alert", oldest
        first — a filtered view, not separate storage."""
        return [e for e in self.journal.events() if e.get("kind") == "alert"]

    @property
    def timeline_seq(self) -> int:
        """Journal seq of the newest alert event (fingerprint input)."""
        return self._timeline_seq

    # ---------------- host rules (monitor_server.js:162-175) -------------

    def _build_host_rules(self) -> list:
        specs = (
            (
                "cpu", self.t.cpu_pct, "CPU usage",
                "Identify hot processes (top/pidstat); rebalance or scale out "
                "CPU-bound preprocessing and data-loading work.",
            ),
            (
                "memory", self.t.memory_pct, "Memory usage",
                "Find the largest consumers (ps --sort=-rss); lower host-side "
                "cache sizes or move work off this host before the OOM killer "
                "does it for you.",
            ),
            (
                "disk", self.t.disk_pct, "Disk usage",
                "Clear old checkpoints/logs or expand the volume; full disks "
                "break checkpoint writes and pod scheduling.",
            ),
        )
        rules = []
        for key, tri, label, fix in specs:

            def emit(_item, v, sev, _note, key=key, tri=tri, label=label, fix=fix):
                return Alert(
                    severity=sev,
                    title=f"{label} {_SEV_LABEL[sev]}",
                    desc=f"{label} at {v:.1f}% "
                    f"(threshold {getattr(tri, sev)}%)",
                    fix=fix,
                    key=f"host.{key}.{sev}",
                )

            rules.append(_tri_rule(f"host.{key}", tri, None, emit))
        return rules

    def _host_alerts(self, host: dict | None) -> list[Alert]:
        alerts: list[Alert] = []
        if not host:
            return alerts
        env = {
            "host.cpu": (host.get("cpu") or {}).get("percent"),
            "host.memory": (host.get("memory") or {}).get("percent"),
            "host.disk": (host.get("disk") or {}).get("percent"),
        }
        for rule in self._host_rules:
            a = rule(None, env, "")
            if a is not None:
                alerts.append(a)
        return alerts

    # ------------- per-chip rules (re-keyed monitor_server.js:178-184) ----

    def _build_chip_rules(self) -> list:
        """Per-chip threshold rules as compiled expressions, built ONCE
        per engine: each rule's firing condition is an expression in
        the query language — formatted with this config's threshold
        values, parsed by tpumon_torch.query, compiled to a closure — and the
        per-tick loop is a flat rules × chips evaluation of generated
        evaluators over a per-chip environment (_chip_env). At 256
        chips this keeps alert evaluation linear with a small constant,
        and a deployment reading the rule table sees the *conditions*
        in the same language it queries with."""
        t = self.t

        # Alert KEYS keep the TPU-native namespace (chip.<id>.hbm.* —
        # silences and the timeline depend on stable keys); the
        # human-facing title/desc speak the chip's own family terms
        # (HBM vs VRAM, MXU vs SM, ICI vs NVLink — accel_terms).
        def hbm_emit(c: ChipSample, v: float, sev: str, pod_note: str) -> Alert:
            mem = accel_terms(c.accel_kind)["mem"]
            return Alert(
                severity=sev,
                title=f"{mem} pressure on {c.chip_id}",
                desc=f"{mem} at {v:.1f}% "
                f"({(c.hbm_used or 0) / 2**30:.1f} / "
                f"{(c.hbm_total or 0) / 2**30:.1f} GiB){pod_note}",
                fix="Reduce batch size or sequence length, shard the "
                "model over more chips, or enable rematerialization "
                f"(jax.checkpoint) to trade FLOPs for {mem}.",
                key=f"chip.{c.chip_id}.hbm.{sev}",
            )

        def temp_emit(c: ChipSample, v: float, sev: str, pod_note: str) -> Alert:
            return Alert(
                severity=sev,
                title=f"Temperature {_SEV_LABEL[sev]} on {c.chip_id}",
                desc=f"Chip at {v:.0f}°C "
                f"(threshold {getattr(t.temp_c, sev)}°C)",
                fix="Check node cooling/airflow and ambient temp; "
                "sustained thermal throttling degrades step time "
                "before it damages hardware.",
                key=f"chip.{c.chip_id}.temp.{sev}",
            )

        # HBM heavily committed but MXU ~idle ⇒ the job holds memory
        # without computing (wedged collective, host input stall,
        # deadlock).
        def stalled_emit(c: ChipSample, env: dict, pod_note: str) -> Alert:
            terms = accel_terms(c.accel_kind)
            return Alert(
                severity="serious",
                title=f"Chip {c.chip_id} stalled",
                desc=f"{terms['mem']} {env['chip.hbm']:.0f}% committed "
                f"but {terms['duty']} duty "
                f"cycle only {c.mxu_duty_pct:.1f}%{pod_note}",
                fix="The job holds memory but isn't computing: look for "
                "a host-side input bottleneck, a hung collective "
                "(one host of the slice down?), or a deadlocked step.",
                key=f"chip.{c.chip_id}.stalled",
            )

        # Link down: the producer says so directly (link_up False), or
        # the SDK health score hits 10 ("link is not usable") — the
        # engine owns this derivation so a producer that sets only the
        # score still raises the critical alert.
        def link_down_emit(c: ChipSample, env: dict, pod_note: str) -> Alert:
            link = accel_terms(c.accel_kind)["link"]
            return Alert(
                severity="critical",
                title=f"{link} link down on {c.chip_id}",
                desc="Inter-chip interconnect link reports down; "
                f"collectives crossing it will hang or fail.{pod_note}",
                fix="Drain the slice and file a hardware case; a single "
                f"bad {link} link poisons every collective in the slice.",
                key=f"chip.{c.chip_id}.ici_down",
            )

        # libtpu SDK 0-10 score (PROBE_libtpu.md): 1-5 transient ->
        # minor, 6-9 persistent -> serious; 10 is the critical
        # link-down rule above.
        def ici_health_emit(c: ChipSample, v: float, sev: str, pod_note: str) -> Alert:
            link = accel_terms(c.accel_kind)["link"]
            return Alert(
                severity=sev,
                title=f"{link} link degraded on {c.chip_id}",
                desc=f"Worst {link} link health score "
                f"{c.ici_link_health}/10 "
                f"({'persistent' if c.ici_link_health > 5 else 'transient'} "
                f"problem){pod_note}",
                fix="Watch collective latency on this slice; if the "
                "score persists above 5, drain the slice and file "
                "a hardware case before the link fails outright.",
                key=f"chip.{c.chip_id}.ici_health.{sev}",
            )

        # Throttle score 0-10 = throttled by 0-100% — the platform's
        # thermal/power proxy (PROBE_libtpu.md finding #4).
        def throttle_emit(c: ChipSample, v: float, sev: str, pod_note: str) -> Alert:
            return Alert(
                severity=sev,
                title=f"TPU throttled on {c.chip_id}",
                desc=f"Throttle score {c.throttle_score}/10 "
                f"(~{c.throttle_score * 10}% throttled){pod_note}",
                fix="Check node cooling/power; sustained throttling "
                "stretches step time. If cluster-wide, suspect "
                "datacenter thermals rather than one node.",
                key=f"chip.{c.chip_id}.throttle.{sev}",
            )

        return [
            _tri_rule("chip.hbm", t.hbm_pct, None, hbm_emit),
            _tri_rule("chip.temp", t.temp_c, None, temp_emit),
            _cond_rule(
                f"chip.hbm > {t.mxu_idle_hbm_gate_pct!r} "
                f"and chip.mxu < {t.mxu_idle_pct!r}",
                stalled_emit,
            ),
            _cond_rule(
                "chip.link_up == 0 or chip.ici_health == 10",
                link_down_emit,
            ),
            _tri_rule(
                "chip.ici_health",
                t.ici_health_score,
                "chip.ici_health > 0 and chip.ici_health < 10",
                ici_health_emit,
            ),
            _tri_rule(
                "chip.throttle",
                t.throttle_score,
                "chip.throttle > 0",
                throttle_emit,
            ),
        ]

    def _chip_alerts(
        self, chips: list[ChipSample], owners: dict[str, str] | None = None
    ) -> list[Alert]:
        alerts: list[Alert] = []
        owners = owners or {}
        for c in chips:
            # Owning pod (pod->chip attribution): names the workload in the
            # alert text so remediation starts at the right pod.
            pod = owners.get(c.chip_id)
            pod_note = f" — pod {pod}" if pod else ""
            env = _chip_env(c, c.hbm_pct)
            for rule in self._chip_rules:
                a = rule(c, env, pod_note)
                if a is not None:
                    alerts.append(a)
        return alerts

    # ------------- slice rules (SURVEY §2.2 TPU re-keying) ----------------

    def _build_slice_rule(self):
        def emit(s: SliceView, env: dict, _note: str) -> Alert:
            return Alert(
                severity="critical",
                title=f"Slice {s.slice_id} unhealthy",
                desc=f"{s.reporting_chips}/{s.expected_chips} chips "
                f"reporting ({s.missing_chips} missing) across hosts "
                f"{', '.join(s.hosts) or 'none'}",
                fix="A multi-host slice is all-or-nothing: check the "
                "non-reporting hosts' pods/VMs and restart the slice "
                "job from the last checkpoint once all hosts are back.",
                key=f"slice.{s.slice_id}.missing",
            )

        return _cond_rule("slice.missing > 0 and slice.expected > 0", emit)

    def _slice_alerts(self, slices: list[SliceView]) -> list[Alert]:
        alerts: list[Alert] = []
        for s in slices:
            env = {
                "slice.missing": float(s.missing_chips),
                "slice.expected": (
                    None if s.expected_chips is None else float(s.expected_chips)
                ),
            }
            a = self._slice_rule(s, env, "")
            if a is not None:
                alerts.append(a)
        return alerts

    # ------------- pod rules (monitor_server.js:188-232) ------------------

    def _pod_alerts(self, pods: list[dict] | None) -> list[Alert]:
        alerts: list[Alert] = []
        if pods is None:
            return alerts
        current: dict[str, dict] = {
            f"{p.get('namespace')}/{p.get('name')}": p for p in pods
        }
        prev = self._last_pods
        for full_name, p in current.items():
            status = p.get("status")
            reason = p.get("reason")
            if status in ("Failed", "Error") or reason in ("Error", "OOMKilled"):
                alerts.append(
                    Alert(
                        severity="critical",
                        title=f"Pod {full_name} failed",
                        desc=f"Pod in {status}"
                        + (f" ({reason})" if reason else ""),
                        fix="kubectl describe / logs the pod; fix the image, "
                        "config or OOM cause, then delete the pod so its "
                        "controller recreates it.",
                        key=f"pod.{full_name}.failed",
                    )
                )
            elif reason == "CrashLoopBackOff":
                alerts.append(
                    Alert(
                        severity="critical",
                        title=f"Pod {full_name} crash-looping",
                        desc="Container repeatedly crashing (CrashLoopBackOff)",
                        fix="kubectl logs --previous to see the crash; fix the "
                        "startup error before restart backoff masks it.",
                        key=f"pod.{full_name}.crashloop",
                    )
                )
            elif status == "Pending":
                alerts.append(
                    Alert(
                        severity="serious",
                        title=f"Pod {full_name} pending",
                        desc="Pod unscheduled or pulling images"
                        + (f" ({reason})" if reason else ""),
                        fix="kubectl describe pod for scheduling events — for "
                        "TPU pods, usually no free chips of the requested "
                        "topology or a missing node selector/toleration.",
                        key=f"pod.{full_name}.pending",
                    )
                )
            # Sub-sample flap (watch-mode collector only): the pod
            # passed through a failed phase between samples but looks
            # healthy now — a poll-based diff would never see it
            # (SURVEY §2.2's missed-transition gap).
            bad_interim = [
                ph for ph in p.get("interim_phases") or []
                if ph in ("Failed", "Error", "Unknown")
            ]
            if bad_interim and status not in ("Failed", "Error"):
                alerts.append(
                    Alert(
                        severity="serious",
                        title=f"Pod {full_name} flapped",
                        desc=f"Passed through {'/'.join(bad_interim)} "
                        "between samples (now "
                        f"{status})",
                        fix="Transient failure healed by the controller — "
                        "check logs --previous for the cause before it "
                        "recurs under load.",
                        key=f"pod.{full_name}.flapped",
                    )
                )
            if prev is not None:
                was = prev.get(full_name)
                if was is not None:
                    if was.get("status") != "Running" and status == "Running":
                        alerts.append(
                            Alert(
                                severity="serious",
                                title=f"Pod {full_name} recovered",
                                desc=f"Transitioned {was.get('status')} → Running",
                                fix="Confirm the workload resumed cleanly (for "
                                "training jobs: restored from the latest "
                                "checkpoint, step counter advancing).",
                                key=f"pod.{full_name}.recovered",
                            )
                        )
                    if (p.get("restarts") or 0) > (was.get("restarts") or 0):
                        alerts.append(
                            Alert(
                                severity="serious",
                                title=f"Pod {full_name} restarted",
                                desc=f"Restart count {was.get('restarts')} → "
                                f"{p.get('restarts')}",
                                fix="kubectl logs --previous for the terminated "
                                "container; repeated restarts on TPU pods "
                                "often mean device OOM or preemption.",
                                key=f"pod.{full_name}.restarted",
                            )
                        )
        self._last_pods = current
        return alerts

    # ------------- source-down rule (tpumon_torch.resilience breakers) ----------

    def _source_alerts(self, sources: list[dict] | None) -> list[Alert]:
        """A monitoring *pipeline* rule: a source whose circuit breaker
        left CLOSED has failed repeatedly and is being polled on a
        backoff cadence — its panels are stale, which is itself a
        page-worthy condition (SURVEY §7: the monitor must be loudest
        about what it can no longer see)."""
        alerts: list[Alert] = []
        for s in sources or []:
            if s.get("breaker", "closed") == "closed":
                continue
            name = s.get("source")
            err = s.get("error") or "repeated collection failures"
            alerts.append(
                Alert(
                    severity="serious",
                    title=f"Source {name} down",
                    desc=f"{s.get('consecutive_failures', 0)} consecutive "
                    f"failures; polling on backoff "
                    f"(breaker {s.get('breaker')}): {str(err)[:160]}",
                    fix="The monitor is flying blind on this source — its "
                    "panels show the last good data. Check the upstream "
                    "(kubectl/apiserver reachability, libtpu runtime, "
                    "serving targets) and the error text; the breaker "
                    "re-probes and clears this automatically on recovery.",
                    key=f"source.{name}.down",
                )
            )
        return alerts

    # ------------- serving rules (BASELINE config 4) ----------------------

    def _serving_alerts(
        self, serving: list[dict] | None, now: float
    ) -> list[Alert]:
        alerts: list[Alert] = []
        # Prune stall clocks for targets that vanished from the config —
        # a target re-added later must start a fresh observation window.
        current = {s.get("target") for s in serving or []}
        for gone in [t for t in self._train_progress if t not in current]:
            del self._train_progress[gone]
        for s in serving or []:
            # Training-stall rule: the step counter is the job's
            # heartbeat — a reachable trainer whose step stops advancing
            # is wedged (hung collective, input starvation, stuck
            # checkpoint write) even though its process scrapes fine.
            target = s.get("target")
            step = s.get("train_step")
            if not s.get("ok"):
                # Unreachable: the scrape-failure rule owns it. Drop the
                # stall clock — a trainer that recovers at the same step
                # (restart from checkpoint) must not page instantly.
                self._train_progress.pop(target, None)
            if s.get("ok") and step is not None and self.t.train_stall_s > 0:
                prev = self._train_progress.get(target)
                if prev is None or step != prev[0]:
                    self._train_progress[target] = (step, now)
                elif now - prev[1] >= self.t.train_stall_s:
                    alerts.append(
                        Alert(
                            severity="serious",
                            title=f"Training stalled on {target}",
                            desc=f"Step counter stuck at {step:.0f} for "
                            f"{now - prev[1]:.0f}s "
                            f"(threshold {self.t.train_stall_s:.0f}s)",
                            fix="Check the job's logs for a hung collective "
                            "(a peer host down?), host-side input "
                            "starvation, or a checkpoint write that never "
                            "returned; restart from the last checkpoint "
                            "if wedged.",
                            key=f"train.{target}.stalled",
                        )
                    )
            if not s.get("ok"):
                alerts.append(
                    Alert(
                        severity="serious",
                        title=f"Serving target {s.get('target')} unreachable",
                        desc=str(s.get("error", "scrape failed")),
                        fix="Check the JetStream/MaxText server process and its "
                        "metrics port; an unreachable target usually means "
                        "the server crashed or the port mapping changed.",
                        key=f"serving.{s.get('target')}.down",
                    )
                )
            if s.get("ok"):
                a = self._kv_rule(
                    target, {"serving.kv": s.get("kv_pages_used_pct")}, ""
                )
                if a is not None:
                    alerts.append(a)
        return alerts

    def _build_kv_rule(self):
        t = self.t

        def emit(target, v: float, sev: str, _note: str) -> Alert:
            return Alert(
                severity=sev,
                title=f"KV pool pressure on {target}",
                desc=f"Paged KV pool {v:.0f}% reserved "
                f"(threshold "
                f"{getattr(t.kv_pool_pct, sev):.0f}%)",
                fix="Admissions are about to queue on KV "
                "memory: grow --pool-pages, lower max_new, "
                "or add serving replicas.",
                key=f"serving.{target}.kv_pool",
            )

        return _tri_rule("serving.kv", t.kv_pool_pct, None, emit)

    # ------------- SLO burn-rate rule (tpumon_torch.slo, docs/slo.md) -----------

    def _slo_alerts(self, slos: list[dict] | None) -> list[Alert]:
        """One alert per firing burn window, pre-evaluated by the SLO
        engine (both-windows-must-fire with recovery hysteresis lives
        THERE — this rule only presents the result): the fast pair is
        the page (critical), the slow pair the ticket (minor)."""
        alerts: list[Alert] = []
        for row in slos or []:
            name = row.get("name", "?")
            speed = row.get("window", "fast")
            tenant = row.get("tenant") or ""
            tenant_note = f" (tenant {tenant})" if tenant else ""
            fast = speed == "fast"
            alerts.append(
                Alert(
                    severity="critical" if fast else "minor",
                    title=f"SLO {name} burning "
                    f"{'fast' if fast else 'slow'}{tenant_note}",
                    desc=f"Error budget burning ≥"
                    f"{row.get('threshold', 0):g}x over both the "
                    f"{row.get('short_s', 0):g}s and "
                    f"{row.get('long_s', 0):g}s windows",
                    fix="The objective is consuming budget far faster "
                    "than it earns it: check /api/slo for the burn "
                    "curves and the tenant's serving.<tenant>.* series "
                    "for the regressing signal (TTFT/TPOT/errors); "
                    "docs/slo.md has the window math."
                    if fast else
                    "Sustained slow burn: not page-worthy yet, but the "
                    "budget will exhaust within the SLO window at this "
                    "rate — file a ticket and watch /api/slo.",
                    key=f"slo.{name}.burn.{speed}",
                )
            )
        return alerts

    # ------------- anomaly rule (tpumon_torch.anomaly EWMA detectors) -----------

    def _anomaly_alerts(self, anomalies: list[dict] | None) -> list[Alert]:
        """Early-warning drift rule: each currently-anomalous series
        (EWMA z-score gate, tpumon_torch.anomaly) is a minor alert — the
        point is to page a human while the drift is still hours from a
        hard threshold."""
        alerts: list[Alert] = []
        for a in anomalies or []:
            series = a.get("series", "?")
            alerts.append(
                Alert(
                    severity="minor",
                    title=f"Anomalous drift in {series}",
                    desc=f"{series} at {a.get('value', 0):.2f}, EWMA baseline "
                    f"{a.get('mean', 0):.2f} (z={a.get('z', 0):.1f})",
                    fix="A slow drift, not yet a threshold breach: check "
                    "for HBM creep (leaking cache?), duty-cycle sag "
                    "(input starvation?) or a degrading source before "
                    "the hard threshold pages. Tuning: docs/events.md.",
                    key=f"anomaly.{series}",
                )
            )
        return alerts

    # ----------------------------------------------------------------------

    def evaluate(
        self,
        host: dict | None = None,
        chips: list[ChipSample] | None = None,
        slices: list[SliceView] | None = None,
        pods: list[dict] | None = None,
        serving: list[dict] | None = None,
        sources: list[dict] | None = None,
        anomalies: list[dict] | None = None,
        slos: list[dict] | None = None,
        update_pod_state: bool = True,
        now: float | None = None,
    ) -> dict[str, list[dict]]:
        now = time.time() if now is None else now
        alerts: list[Alert] = []
        alerts += self._host_alerts(host)
        alerts += self._source_alerts(sources)
        alerts += self._anomaly_alerts(anomalies)
        alerts += self._slo_alerts(slos)
        # Attribution uses the freshest pod view available: this
        # evaluation's pods, else the last healthy scrape's baseline.
        owner_pods = (
            pods if pods is not None else list((self._last_pods or {}).values())
        )
        alerts += self._chip_alerts(
            chips or [], attribute_pods(chips or [], owner_pods)
        )
        alerts += self._slice_alerts(slices or [])
        if update_pod_state:
            alerts += self._pod_alerts(pods)
        alerts += self._serving_alerts(serving, now)
        raw = {a.key: a.to_json() for a in alerts}

        # Fire side: a new condition becomes active once it has held for
        # fire_hold_s (Prometheus "for"); 0 = instantly, the reference's
        # behavior. A condition that clears while pending never fires.
        for key, a in raw.items():
            if key in self._active_keys:
                self._active_keys[key] = a  # refresh desc with latest values
                continue
            first_seen = self._pending_fire.setdefault(key, now)
            if now - first_seen >= self.t.fire_hold_s:
                self._active_keys[key] = a
                self._emit("fired", a, now)
                if self.is_silenced(key, now):
                    self._suppressed_fires.add(key)
        for key in [
            k for k in self._pending_fire if k not in raw or k in self._active_keys
        ]:
            del self._pending_fire[key]

        # Resolve side: an active alert resolves once its condition has
        # stayed clear for resolve_hold_s ("keep_firing_for") — brief dips
        # below a threshold no longer spam fired/resolved event pairs.
        for key in list(self._active_keys):
            if key in raw:
                self._pending_resolve.pop(key, None)
                continue
            first_clear = self._pending_resolve.setdefault(key, now)
            if now - first_clear >= self.t.resolve_hold_s:
                a = self._active_keys.pop(key)
                del self._pending_resolve[key]
                # An incident whose fire was suppressed by a silence never
                # paged — mark its resolution so delivery skips it too
                # (a "resolved" for an unknown incident is pager noise).
                suppressed = key in self._suppressed_fires
                self._suppressed_fires.discard(key)
                self._emit(
                    "resolved",
                    {**a, "desc": ""},
                    now,
                    **({"suppressed": True} if suppressed else {}),
                )

        # Served buckets are the *held* view: pending-fire alerts aren't
        # shown yet, held-resolving ones still are. Silenced alerts move
        # to their own list instead of a severity bucket.
        for prefix in [p for p, until in self.silences.items() if until <= now]:
            del self.silences[prefix]
        # Re-fire: an alert whose "fired" event was suppressed and that is
        # still active once no silence covers it gets a fresh timeline
        # event — so it pages after the silence expires or is removed.
        for key in sorted(self._suppressed_fires):
            if key not in self._active_keys:
                self._suppressed_fires.discard(key)
            elif not self.is_silenced(key, now):
                self._suppressed_fires.discard(key)
                self._emit("fired", self._active_keys[key], now)
        self._last_eval = {s: [] for s in SEVERITIES}
        silenced: list[dict] = []
        for a in self._active_keys.values():
            if self.is_silenced(a["key"], now):
                silenced.append(a)
            else:
                self._last_eval[a["severity"]].append(a)
        self._last_silenced = silenced
        self._last_eval_ts = now
        return self._last_eval

    # ------------- silences (Alertmanager-style mutes) --------------------

    def silence(self, key_prefix: str, duration_s: float, now: float | None = None) -> float:
        """Mute alerts whose key starts with ``key_prefix`` for
        ``duration_s``; returns the expiry timestamp."""
        now = time.time() if now is None else now
        until = now + max(0.0, duration_s)
        self.silences[key_prefix] = until
        # A silence mutes the pager — which is exactly why the record
        # must say who went quiet and until when (kind="silence", so the
        # alert timeline view stays fired/resolved-only).
        self.journal.record(
            "silence", "info", "alerts",
            f"silenced {key_prefix!r} for {max(0.0, duration_s):.0f}s",
            ts=now, key=key_prefix, until=round(until, 3),
        )
        return until

    def unsilence(self, key_prefix: str, now: float | None = None) -> bool:
        existed = self.silences.pop(key_prefix, None) is not None
        if existed:
            self.journal.record(
                "silence", "info", "alerts",
                f"unsilenced {key_prefix!r}",
                ts=now, key=key_prefix,
            )
        return existed

    def is_silenced(self, key: str, now: float | None = None) -> bool:
        now = time.time() if now is None else now
        return any(
            key.startswith(p) for p, until in self.silences.items() if until > now
        )

    @property
    def last_silenced(self) -> list[dict]:
        return self._last_silenced

    def recent_events(self, n: int = 50) -> list[dict]:
        return self.journal.recent(n, kind="alert")  # newest first

    # ------------- checkpoint/resume (tpumon_torch.state, SURVEY §5.4) ----------

    def to_state(self) -> dict:
        """Stateful parts worth surviving a restart: the pod-transition
        baseline (so restarts/recoveries during monitor downtime still
        alert), active alert keys (so unchanged alerts don't re-fire
        into the timeline) and the event timeline itself."""
        return {
            "last_pods": self._last_pods,
            "active_keys": self._active_keys,
            "events": self.events,
            "pending_fire": self._pending_fire,
            "pending_resolve": self._pending_resolve,
            "silences": self.silences,
            "suppressed_fires": sorted(self._suppressed_fires),
        }

    def load_state(self, state: dict) -> None:
        last_pods = state.get("last_pods")
        self._last_pods = dict(last_pods) if last_pods is not None else None
        self._active_keys = dict(state.get("active_keys") or {})
        # Timeline events merge into the journal (dedup by seq): when
        # the journal's own JSONL restore already replayed them — it
        # runs first in tpumon_torch.app — this is a no-op, so a deployment
        # with both state_path and events_path never double-records.
        self.journal.ingest(state.get("events") or [])
        self._timeline_seq = max(
            (e.get("seq", 0) for e in self.events), default=self._timeline_seq
        )
        self._pending_fire = dict(state.get("pending_fire") or {})
        self._pending_resolve = dict(state.get("pending_resolve") or {})
        self.silences = {
            str(k): float(v) for k, v in (state.get("silences") or {}).items()
        }
        self._suppressed_fires = set(state.get("suppressed_fires") or [])

    @property
    def last(self) -> dict[str, list[dict]]:
        return self._last_eval

    @property
    def last_ts(self) -> float | None:
        return self._last_eval_ts
