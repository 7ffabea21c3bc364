"""The traced slice: ``torch.profiler`` over a few seconds of the window.

The profiler keeps its events in memory and writes nothing; the slice is
reduced here from the raw events, without building the profiler's event
tree. Host spans are the benchmark's own ``record_function`` ranges
(names from ``span``), so they share the device events' clock.

The reduction gives: the slice's length; the union of device intervals
(busy); per device operation its count and summed time (of the launches
wholly inside the slice); the idle gaps
summed by the innermost host span they fall in; and the host spans'
own durations.
"""

from __future__ import annotations

import bisect
import contextlib

import torch

from portbench.stats import gaps, union_length

SLICE = "bench.slice"
# Seconds profiled, in the middle of a traced window.
SLICE_S = 5.0
SPAN_PREFIXES = ("bench.", "serve.", "train.")
NAME_CHARS = 160  # of a device operation's name in the breakdown


def span(name: str):
    """A host span in the trace (a no-op while no profiler runs); its
    name starts with one of ``SPAN_PREFIXES``."""
    return torch.profiler.record_function(name)


class Slice:
    """Start and stop the profiler around part of a window."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self._span = None
        self.events = None

    def warm(self) -> None:
        """Start and stop the profiler once, outside the window: its
        first start initializes the tracing libraries (seconds)."""
        self.start()
        self.stop()
        self.events = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._span = span(SLICE)
        self._span.__enter__()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.stop()
        self.events = self.prof.profiler.kineto_results.events()

    def reduce(self, top: int = 10) -> dict:
        return reduce_events(self.events, top)


def _is_device(ev) -> bool:
    return "CPU" not in str(ev.device_type())


def _is_span(ev) -> bool:
    """A host span, or the profiler's device-side copy of one."""
    kind = getattr(ev, "activity_type", lambda: "")()
    return ev.name().startswith(SPAN_PREFIXES) or "annotation" in str(kind)


def reduce_events(events, top: int = 10) -> dict:
    """The slice's numbers from raw profiler events (seconds)."""
    slice_ev = [e for e in events if e.name() == SLICE and not _is_device(e)]
    if not slice_ev:
        return {}
    s0 = slice_ev[0].start_ns()
    s1 = s0 + slice_ev[0].duration_ns()
    dev, spans = [], []
    ops: dict = {}
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if _is_device(e) and _is_span(e):
            continue
        if _is_device(e):
            lo, hi = max(a, s0), min(a + d, s1)
            if hi <= lo:
                continue
            dev.append((lo, hi))
            if lo == a and hi == a + d:  # counted only when wholly inside
                cnt, tot = ops.get(e.name(), (0, 0))
                ops[e.name()] = (cnt + 1, tot + d)
        elif e.name().startswith(SPAN_PREFIXES) and e.name() != SLICE:
            spans.append((a, a + d, e.name()))
    busy = union_length(dev)
    idle = gaps(dev, s0, s1)
    # Innermost host span around each gap's midpoint.
    spans.sort()
    starts = [s[0] for s in spans]
    by_label: dict = {}
    for g0, g1 in idle:
        mid = (g0 + g1) / 2
        label, best = "bench", None
        i = bisect.bisect_right(starts, mid)
        for a, b, name in reversed(spans[max(0, i - 64):i]):
            if b >= mid and (best is None or b - a < best):
                label, best = name, b - a
        by_label[label] = by_label.get(label, 0) + (g1 - g0)
    span_s: dict = {}
    for a, b, name in spans:
        span_s.setdefault(name, []).append((b - a) * 1e-9)
    ns = 1e-9
    return {
        "window_s": (s1 - s0) * ns,
        "busy_s": busy * ns,
        "ops": {k: (c, t * ns) for k, (c, t) in ops.items()},
        "device_ops": [[k[:NAME_CHARS], t * ns] for k, (_, t) in sorted(
            ops.items(), key=lambda kv: -kv[1][1])[:top]],
        "idle_gaps": [[k, v * ns] for k, v in sorted(
            by_label.items(), key=lambda kv: -kv[1])[:top]],
        "spans": span_s,
    }


@contextlib.contextmanager
def wrapped(module, name: str, label: str, record=None):
    """Replace ``module.name`` by a wrapper that runs it inside the host
    span ``label`` and passes its arguments to ``record(args, kwargs)``;
    restored on exit. A missing attribute wraps nothing."""
    fn = getattr(module, name, None)
    if fn is None:
        yield False
        return

    def wrapper(*args, **kwargs):
        if record is not None:
            record(args, kwargs)
        with span(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield True
    finally:
        setattr(module, name, fn)
