"""Sequence-parallel (sp) training: the full train step over a "seq" mesh.

Counterpart of ``tpumon/loadgen/sp_train.py``. Activations are split on the
sequence axis end to end: the embedding, norms and MLPs are per token (each
device runs its own block), attention runs through the ring or zigzag inner
bodies of ``loadgen.ring_attention`` (the narrow nkv-head K/V rotates, GQA
widening happens after each receive), and the loss is the sum of every
block's NLL over the token count. Positions travel as data: each row's
global position is passed in, so RoPE and the loss are layout-agnostic and
the contiguous and zigzag layouts differ only in the gather of (inputs,
labels, positions) that ``sp_batch`` makes before the step. Labels are
shifted before the split, so no block needs its neighbour's first token.

Composition, as in the reference: ``dp_axis`` also splits the batch, and
``tp_axis`` (the axis named "model") Megatron-splits the weights under
``model.PARAM_SPECS``, with their row-parallel partials summed over it
(``model.mesh_loss`` runs all three). The reference runs one ``shard_map``
over the loss with XLA's collectives; here one controller holds every
device's blocks (``model.shard_params``) and one backward pass covers
them, the gradient of each block summed over the devices that hold it.
"""

from __future__ import annotations

from functools import partial

import torch

from tpumon_torch.loadgen.model import (
    Mesh,
    ModelConfig,
    mesh_loss,
    mesh_sgd_step,
    param_shardings,
    replicated_specs,
    shard_params,
    shard_views,
)
from tpumon_torch.loadgen.ring_attention import (
    ring_attend_inner,
    zigzag_attend_inner,
    zigzag_indices,
)

SCHEDULES = ("ring", "zigzag")


def _check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(
            f"unknown sp schedule {schedule!r} (expected {SCHEDULES})")


def sp_batch(tokens: torch.Tensor, n: int, schedule: str):
    """Host-side prep: (inputs, labels, positions), layout-applied.

    tokens: [B, T+1]; n (ring) resp. 2n (zigzag) must divide T. Returns
    the three tensors the step splits over the sequence axis (positions
    int32 [T]). The layout must match the step's schedule: prefer the
    ``prep`` bound to the step by ``make_sp_train_step``.
    """
    _check_schedule(schedule)
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    t = inputs.shape[1]
    pos = torch.arange(t, dtype=torch.int32)
    if schedule == "zigzag":
        zi = zigzag_indices(t, n)
        inputs, labels, pos = inputs[:, zi.to(inputs.device)], labels[
            :, zi.to(labels.device)], pos[zi]
    return inputs, labels, pos


def _sp_specs(params, tp_axis: str | None):
    return (param_shardings(None, params) if tp_axis
            else replicated_specs(params))


def _check_axes(mesh: Mesh, axis: str, dp_axis: str | None,
                tp_axis: str | None) -> None:
    if tp_axis and tp_axis in {axis, dp_axis}:
        raise ValueError(f"tp_axis {tp_axis!r} must be distinct")
    if tp_axis and tp_axis != "model":
        raise ValueError(
            "tp_axis must be the mesh axis named 'model' — "
            "model.PARAM_SPECS (the Megatron split table) is keyed on "
            f"that name; got {tp_axis!r}")
    if "model" in mesh.shape and not tp_axis:
        raise ValueError("the mesh has a 'model' axis: pass tp_axis='model'")


def sp_loss_fn(cfg: ModelConfig, params, inputs: torch.Tensor,
               labels: torch.Tensor, positions: torch.Tensor, mesh: Mesh,
               axis: str = "seq", schedule: str = "zigzag",
               dp_axis: str | None = None,
               tp_axis: str | None = None) -> torch.Tensor:
    """Mean next-token NLL with activations split over ``axis``.

    ``params`` is one full param tree (each device reads its block as a
    differentiable view, ``model.shard_views``, so a gradient lands on the
    tree) or the per-device blocks of ``make_sp_train_step``. ``dp_axis``
    also splits the batch; ``tp_axis`` (named "model") splits the weights
    under ``model.PARAM_SPECS``.
    """
    _check_schedule(schedule)
    _check_axes(mesh, axis, dp_axis, tp_axis)
    if cfg.n_experts:
        raise ValueError("the sp step runs the dense family only")
    kv_rep = cfg.n_heads // cfg.n_kv_heads
    views = params if isinstance(params, list) else shard_views(
        mesh, params, _sp_specs(params, tp_axis))

    def ring(qs, ks, vs):
        if schedule == "zigzag":
            return zigzag_attend_inner(qs, ks, vs, kv_rep=kv_rep)
        return ring_attend_inner(qs, ks, vs, causal=True, kv_rep=kv_rep)

    return mesh_loss(cfg, views, mesh, inputs, labels, positions,
                     data_axis=dp_axis, seq_axis=axis, ring=ring)


def make_sp_train_step(cfg: ModelConfig, mesh: Mesh, params: dict,
                       axis: str = "seq", schedule: str = "zigzag",
                       lr: float = 1e-3, dp_axis: str | None = None,
                       tp_axis: str | None = None):
    """An SGD step over the seq mesh; returns (step_fn, placed).

    ``step_fn(placed, inputs, labels, positions) -> (placed, loss)``, with
    (inputs, labels, positions) from ``step_fn.prep(tokens)``, which is
    bound to this step's mesh size and schedule so the batch layout
    cannot mismatch. ``placed`` holds each device's blocks (replicated, or
    split over "model" with ``tp_axis``), each its own allocation; every
    copy of a block is updated by its gradient summed over the devices
    that hold it. ``step_fn.specs`` is the spec tree of ``placed`` (for
    ``model.mesh_value_and_grad`` and ``model.unshard_params``).
    """
    _check_axes(mesh, axis, dp_axis, tp_axis)
    n = mesh.shape[axis]
    specs = _sp_specs(params, tp_axis)
    placed = shard_params(mesh, params, specs=specs)

    def loss(views, inputs, labels, positions):
        return sp_loss_fn(cfg, views, inputs, labels, positions, mesh, axis,
                          schedule, dp_axis=dp_axis, tp_axis=tp_axis)

    def step(p, inputs, labels, positions):
        return mesh_sgd_step(
            mesh, p, specs, lambda v: loss(v, inputs, labels, positions), lr)

    step.prep = partial(sp_batch, n=n, schedule=schedule)
    step.specs = specs
    return step, placed
