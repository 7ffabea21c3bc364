"""Alert webhook notification sinks.

The reference has no alert delivery at all — alerts exist only as long as
a browser polls ``/api/alerts`` (monitor_server.js:282-288); nobody is
told when a pod crash-loops at 3am. tpumon pushes alert *transitions*
(fired / resolved, as recorded on the AlertEngine event timeline) to
configured webhook URLs so alerts reach paging/chat systems without a
browser open.

Design:
- The sampler owns dispatch (single writer, same stance as SURVEY §5.2):
  after each alert evaluation it hands newly-appended timeline events to
  the notifier. Delivery is fire-and-forget on background asyncio tasks —
  a slow or dead sink never blocks the sample loop.
- Generic sinks get a JSON POST ``{"source": "tpumon", "host": ...,
  "events": [{ts, state, severity, title, desc, fix, key}]}``.
- Slack-compatible sinks (URL host ``hooks.slack.com`` or a ``slack+``
  scheme prefix) get ``{"text": "..."}`` with one line per event.
- Failures are counted per-sink and surfaced in ``/api/health`` — a
  misconfigured webhook is itself an observable condition, never an
  exception in the sample path.
"""

from __future__ import annotations

import asyncio
import json
import socket
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field

_SEV_RANK = {"minor": 0, "serious": 1, "critical": 2}

_EMOJI = {"minor": "🟡", "serious": "🟠", "critical": "🔴"}


def slack_text(events: list[dict], hostname: str) -> str:
    lines = [f"tpumon on {hostname}:"]
    for e in events:
        if e.get("state") == "resolved":
            lines.append(f"✅ resolved: {e.get('title')}")
        else:
            emoji = _EMOJI.get(e.get("severity", ""), "⚪")
            line = f"{emoji} {e.get('title')}: {e.get('desc')}"
            if e.get("fix"):
                line += f"\n    fix: {e['fix']}"
            lines.append(line)
    return "\n".join(lines)


@dataclass
class SinkStats:
    url: str
    kind: str  # "generic" | "slack"
    sent: int = 0
    failures: int = 0
    last_error: str | None = None
    last_sent_ts: float | None = None

    def to_json(self) -> dict:
        # Redact path+query: webhook URLs carry capability tokens (Slack
        # webhook paths ARE the secret) and /api/health is unauthenticated.
        parts = urllib.parse.urlsplit(self.url)
        return {
            "url": f"{parts.scheme}://{parts.netloc}/…",
            "kind": self.kind,
            "sent": self.sent,
            "failures": self.failures,
            "last_error": self.last_error,
            "last_sent_ts": self.last_sent_ts,
        }


@dataclass
class WebhookNotifier:
    """Pushes alert fired/resolved events to HTTP sinks."""

    urls: tuple[str, ...]
    min_severity: str = "minor"
    timeout_s: float = 5.0
    hostname: str = field(default_factory=socket.gethostname)

    def __post_init__(self) -> None:
        if self.min_severity not in _SEV_RANK:
            raise ValueError(
                f"webhook_min_severity: want one of {sorted(_SEV_RANK)}, "
                f"got {self.min_severity!r}"
            )
        self.sinks: list[SinkStats] = []
        for url in self.urls:
            kind = "generic"
            if url.startswith("slack+"):
                url, kind = url[len("slack+"):], "slack"
            elif urllib.parse.urlsplit(url).hostname == "hooks.slack.com":
                kind = "slack"
            self.sinks.append(SinkStats(url=url, kind=kind))
        # Per-sink delivery locks: batches must reach each sink in the
        # order notify() was called (a fast "resolved" POST overtaking its
        # slow "fired" would leave a pager stuck active). asyncio.Lock is
        # FIFO-fair, and notify() runs on the event loop in order.
        self._locks = [asyncio.Lock() for _ in self.sinks]
        self._inflight: set[asyncio.Task] = set()

    # ------------------------------------------------------------------

    def _wants(self, event: dict) -> bool:
        if event.get("state") == "resolved":
            return True  # resolutions always close the loop
        rank = _SEV_RANK.get(event.get("severity", ""), 0)
        return rank >= _SEV_RANK.get(self.min_severity, 0)

    def _post(self, sink: SinkStats, events: list[dict]) -> None:
        if sink.kind == "slack":
            payload = {"text": slack_text(events, self.hostname)}
        else:
            payload = {
                "source": "tpumon",
                "host": self.hostname,
                "ts": time.time(),
                "events": events,
            }
        req = urllib.request.Request(
            sink.url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                r.read()
            sink.sent += 1
            sink.last_error = None
            sink.last_sent_ts = time.time()
        except Exception as e:
            sink.failures += 1
            sink.last_error = f"{type(e).__name__}: {e}"

    async def _post_ordered(
        self, sink: SinkStats, lock: asyncio.Lock, events: list[dict]
    ) -> None:
        async with lock:
            await asyncio.to_thread(self._post, sink, events)

    async def _dispatch(self, events: list[dict]) -> None:
        await asyncio.gather(
            *(
                self._post_ordered(s, lock, events)
                for s, lock in zip(self.sinks, self._locks)
            )
        )

    def notify(self, events: list[dict]) -> None:
        """Schedule delivery of timeline events. Non-blocking; safe to
        call from the sample loop."""
        batch = [e for e in events if self._wants(e)]
        if not batch or not self.sinks:
            return
        task = asyncio.ensure_future(self._dispatch(batch))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def close(self) -> None:
        """Let in-flight deliveries finish (bounded by timeout_s)."""
        if self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)

    def to_json(self) -> dict:
        return {
            "min_severity": self.min_severity,
            "sinks": [s.to_json() for s in self.sinks],
        }
