"""The port's ``state.py`` and ``notify.py`` against the reference's.

State: the two samplers of ``tests/test_torch_server.py``'s lockstep
harness tick through the serving storm; each package's ``StateStore``
writes the same file byte for byte, each restores the other's file into
a fresh sampler of its own package to the same history, alert timeline
and pod baseline, and both refuse the same broken or stale files.

Notify: both packages' ``WebhookNotifier`` post the same payloads to a
generic and a Slack receiver (the reference test's ``WebhookReceiver``),
filter by severity alike, and count a dead sink alike; ``--alert-webhooks``
config reaches the sampler through the port's ``app.build``.
"""

import asyncio
import json
import time

import pytest

from tests.test_notify import WebhookReceiver, fired
from tests.test_torch_server import Pair
from tests.test_torch_server import clock  # noqa: F401 — the fixture
from tpumon import notify as ref_notify
from tpumon import state as ref_state
from tpumon_torch import notify, state
from tpumon_torch.app import build
from tpumon_torch.config import load_config

MODS = {"port": state, "ref": ref_state}


def restorable(s) -> dict:
    return {"points": s.history.dump_points(),
            "coarse": s.history.dump_coarse(),
            "alerts": s.engine.to_state()}


def test_state_files_equal_and_restore_across_packages(clock, tmp_path):
    pair = Pair(clock)

    async def run():
        for tick in range(30):
            await pair.tick(tick)

    asyncio.run(run())
    samplers = {"port": pair.port[0], "ref": pair.ref[0]}
    assert samplers["port"].engine.to_state()["events"]
    paths = {}
    for side, mod in MODS.items():
        paths[side] = tmp_path / f"{side}.json"
        store = mod.StateStore(str(paths[side]))
        assert store.save(samplers[side])
        assert store.last_save_ts == clock.now
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    # Each package resumes from the other's file.
    fresh = Pair(clock)
    for side, other in (("port", "ref"), ("ref", "port")):
        target = fresh.port[0] if side == "port" else fresh.ref[0]
        assert MODS[side].StateStore(str(paths[other])).restore_into(target)
        assert restorable(target) == restorable(samplers[other])
    assert (json.dumps(restorable(fresh.port[0]))
            == json.dumps(restorable(fresh.ref[0])))


@pytest.mark.parametrize("broken", [
    "not json", "{}", '{"version": 99}',
    '{"version": 1, "saved_at": 0, "history": {}, "alerts": {}}',
    '{"version": 1, "saved_at": "%(now)s", "history": {"x": [[1, "a"]]}, '
    '"alerts": {}}',
    '{"version": 1, "saved_at": %(now)s, "history": {"cpu": [[%(now)s, 1.5]]},'
    ' "alerts": {"events": [], "active_keys": {}, "last_pods": null}}',
])
def test_state_refusals_equal_reference(clock, tmp_path, broken):
    pair = Pair(clock)
    f = tmp_path / "state.json"
    f.write_text(broken % {"now": clock.now})
    got = [MODS[side].StateStore(str(f)).restore_into(s)
           for side, s in (("port", pair.port[0]), ("ref", pair.ref[0]))]
    assert got[0] == got[1]
    assert restorable(pair.port[0]) == restorable(pair.ref[0])
    assert got[0] is broken.endswith("null}}")


def test_webhook_payloads_equal_reference(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    batches = [[fired()],
               [fired(severity="minor", key="host.cpu.minor", seq=2)],
               [{**fired(seq=3), "state": "resolved"},
                fired(severity="serious", key="chip.hbm", seq=4)]]
    bodies, stats = [], []
    for mod in (notify, ref_notify):
        rx, slack = WebhookReceiver(), WebhookReceiver()
        try:
            async def go():
                n = mod.WebhookNotifier(
                    urls=(rx.url, "slack+" + slack.url,
                          "http://127.0.0.1:9/dead"),
                    min_severity="serious", timeout_s=0.5, hostname="h0")
                for batch in batches:
                    n.notify(batch)
                    await n.close()
                return n

            n = asyncio.run(go())
            bodies.append((rx.bodies, slack.bodies))
            stats.append(n.to_json())
            for sink in stats[-1]["sinks"]:  # each side's receivers' ports
                sink.pop("url")
        finally:
            rx.close()
            slack.close()
    assert bodies[0] == bodies[1]
    assert stats[0] == stats[1]
    generic, slack_bodies = bodies[0]
    assert [len(b["events"]) for b in generic] == [1, 2]
    assert "✅ resolved" in slack_bodies[1]["text"]
    assert stats[0]["sinks"][2]["failures"] == 2
    for mod in (notify, ref_notify):
        with pytest.raises(ValueError, match="webhook_min_severity"):
            mod.WebhookNotifier(urls=(), min_severity="page")
    assert notify.slack_text(batches[2], "h") == ref_notify.slack_text(
        batches[2], "h")


def test_app_wires_the_port_notifier():
    cfg = load_config(env={
        "TPUMON_ACCEL_BACKEND": "fake:v5e-4", "TPUMON_K8S_MODE": "none",
        "TPUMON_ALERT_WEBHOOKS": "http://127.0.0.1:9/hook",
        "TPUMON_WEBHOOK_MIN_SEVERITY": "critical"})
    sampler, _ = build(cfg)
    assert isinstance(sampler.notifier, notify.WebhookNotifier)
    assert sampler.notifier.min_severity == "critical"
