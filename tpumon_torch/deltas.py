"""Structural delta codec for the SSE realtime stream.

The SSE stream used to push the full realtime payload (every chip,
every field) once per tick per client — O(chips) bytes per frame even
though most per-chip fields are stable between ticks (identity, HBM
capacity, link state). This codec diffs successive snapshots into
minimal patch nodes so steady-state frames carry only what moved, with
periodic keyframes bounding client resync time (tpumon_torch/server.py emits
them; web/dashboard.js applies them — the JS apply mirrors
``apply_delta`` in the jsmini dialect).

Patch-node grammar (every node is a dict with exactly one of):
  {"s": value}                    replace the target with ``value``
  {"o": {key: node}, "d": [key]}  object merge: patch/insert keys via
                                  nested nodes, then drop keys in "d"
                                  (either part may be absent)
  {"l": [[index, node], ...]}     same-length list: patch elements

``diff(old, new)`` returns ``None`` when nothing changed (the frame
then degrades to a heartbeat). Lists that changed length replace
wholesale — chip arrival/departure is rare and a positional patch
across a reindex would be wrong.
"""

from __future__ import annotations

from typing import Any


def diff(old: Any, new: Any) -> dict | None:
    """Minimal patch node transforming ``old`` into ``new``; None if
    equal. Values must be JSON-shaped (dict/list/scalar)."""
    if old is new:
        return None
    if isinstance(old, dict) and isinstance(new, dict):
        patched: dict[str, Any] = {}
        for k, v in new.items():
            if k not in old:
                patched[k] = {"s": v}
            else:
                sub = diff(old[k], v)
                if sub is not None:
                    patched[k] = sub
        dropped = [k for k in old if k not in new]
        if not patched and not dropped:
            return None
        node: dict[str, Any] = {}
        if patched:
            node["o"] = patched
        if dropped:
            node["d"] = dropped
        return node
    if isinstance(old, list) and isinstance(new, list) and len(old) == len(new):
        patches = [
            [i, sub]
            for i, (a, b) in enumerate(zip(old, new))
            if (sub := diff(a, b)) is not None
        ]
        return {"l": patches} if patches else None
    if old == new and type(old) is type(new):
        return None
    return {"s": new}


def apply_delta(target: Any, node: dict | None) -> Any:
    """Apply a patch node produced by :func:`diff`. Mutates dicts/lists
    in place where possible and returns the patched value (replacement
    nodes return the new value). ``node=None`` is a no-op."""
    if node is None:
        return target
    if "s" in node:
        return node["s"]
    if "l" in node:
        for i, sub in node["l"]:
            target[i] = apply_delta(target[i], sub)
        return target
    for k, sub in node.get("o", {}).items():
        target[k] = apply_delta(target.get(k), sub)
    for k in node.get("d", ()):
        target.pop(k, None)
    return target
