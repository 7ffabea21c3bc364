"""Checkpoint/resume for the port's trainer and serving engine.

Counterpart of ``tpumon/loadgen/checkpoint.py`` with the same on-disk
layout: one directory per step, ``<dir>/step_<n:08d>/``, plus a small
``meta.json`` naming the latest step and the ModelConfig it was saved
with, written last so a crash mid-save never points it at a partial
step. The params are one torch file per step (``params.pt``: the param
tree of CPU tensors) where the reference writes orbax's format; the port
reads its own files, not orbax's. Restore is best-effort, as in the
reference: it returns None on anything it cannot use (no checkpoint,
another architecture, a damaged file), and the caller cold-starts.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch

from tpumon_torch.loadgen.model import ModelConfig, map_params, param_leaves

_META = "meta.json"
_PARAMS = "params.pt"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(directory: str, params: Any, step: int,
                    cfg: ModelConfig | None = None) -> str:
    """Save a param tree at ``<directory>/step_<step>``; updates meta.json
    last. Returns the step directory path."""
    path = _step_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    host = map_params(params, lambda t: t.detach().to("cpu", copy=True))
    _write_atomic(os.path.join(path, _PARAMS), lambda p: torch.save(host, p))
    meta = {
        "latest_step": step,
        "model_config": dataclasses.asdict(cfg) if cfg is not None else None,
    }

    def write_meta(p):
        with open(p, "w") as f:
            json.dump(meta, f)

    _write_atomic(os.path.join(directory, _META), write_meta)
    return path


def latest_step(directory: str) -> int | None:
    """The step named by meta.json, or None if no usable checkpoint."""
    try:
        with open(os.path.join(directory, _META)) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    step = meta.get("latest_step")
    if not isinstance(step, int) or not os.path.isdir(
            _step_dir(directory, step)):
        return None
    return step


# Execution-schedule fields: they change memory/scheduling, never the
# param tree, so differing values must not invalidate a resume (e.g.
# extending a run with --remat or --attention flash).
_SCHEDULE_FIELDS = ("remat", "attention", "attn_block_k")


def _arch_key(cfg: ModelConfig) -> dict:
    d = dataclasses.asdict(cfg)
    for f in _SCHEDULE_FIELDS:
        d.pop(f, None)
    return d


def saved_model_config(directory: str) -> ModelConfig | None:
    """The ModelConfig meta.json was saved with, or None."""
    try:
        with open(os.path.join(directory, _META)) as f:
            raw = json.load(f).get("model_config")
        return ModelConfig(**raw) if raw else None
    except (OSError, json.JSONDecodeError, TypeError, ValueError,
            NotImplementedError):
        # A config this build cannot construct (other fields, an
        # unported family): no usable config, the caller cold-starts.
        return None


def restore_checkpoint(directory: str, like: Any, step: int | None = None,
                       cfg: ModelConfig | None = None
                       ) -> tuple[Any, int] | None:
    """Restore ``(params, step)`` from the latest (or given) step.

    ``like`` is a param tree of tensors: the restored tree must have its
    structure and shapes, and lands on its leaves' devices and dtypes.
    Returns None when there is nothing (or nothing compatible) to resume
    from.
    """
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None
    if cfg is not None:
        saved = saved_model_config(directory)
        if saved is not None and _arch_key(saved) != _arch_key(cfg):
            return None  # architecture changed under the checkpoint dir
    try:
        loaded = torch.load(os.path.join(_step_dir(directory, step), _PARAMS),
                            map_location="cpu", weights_only=True)
        def shape(t):
            return tuple(t.shape)

        if map_params(loaded, shape) != map_params(like, shape):
            return None  # another tree: same keys and shapes or nothing
        want = iter(param_leaves(like))

        def place(t):
            w = next(want)
            return t.to(device=w.device, dtype=w.dtype)

        params = map_params(loaded, place)
    except Exception:
        return None
    return params, step
