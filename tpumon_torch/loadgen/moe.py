"""Mixture-of-Experts FFN: top-1 routing with a fixed expert capacity.

Counterpart of ``tpumon/loadgen/moe.py`` on one device: ``MoEConfig``,
``init_moe_params`` (the reference's tree, shapes and scales, drawn from a
``torch.Generator``), ``_route`` and ``moe_ffn``. Routing is the
reference's GShard/Switch scheme, static-shaped: each token goes to its
argmax expert (the first on a tie), its place in that expert's queue is
the cumsum of the one-hot assignments (arrival order), and tokens past
``capacity`` are dropped (their output is zero; the caller's residual
carries them).

Dtypes are the reference's. There the router product ``x @ router``
promotes a bf16 ``x`` to f32 against the f32 router, the dispatch and
combine tensors are f32, so both expert products run in f32 over the
compute-dtype weights, and the caller casts back at the end. Torch
refuses mixed-dtype products, so here every upcast is explicit.

The reference contracts tokens with one-hot ``dispatch``/``combine``
tensors ``[G, E, C]`` (einsums that XLA lowers to all-to-alls over a
mesh). Each (expert, slot) holds at most one token, so those contractions
are a copy of each kept token into its slot and a gate-weighted copy
back: ``moe_ffn`` makes them by index, the same f32 values without the
O(G·E·C·d) products (one of them is 3.4e14 FLOP at the trainer's G 8192,
E 8, C 1280, d 2048). ``_route`` still builds the tensors, for the tests
that hold them to the reference's.

Over a mesh each shard holds a contiguous block of the experts and runs
them with its ``expert_offset``: routing is over every expert (the router
replicates), and a shard returns only its experts' tokens, zeros
elsewhere, so the sum over shards is each token's one expert output,
exactly. Serving and the dp x tp trainer split the experts over "model"
(``model.PARAM_SPECS``); ``make_sharded_moe_step`` is the reference's
expert-parallel FFN step over a ("data", "expert") mesh
(``MOE_PARAM_SPECS``): the whole batch is routed at once, as the
reference's global computation is (``route``: capacity from the global
token count), and device (d, e) runs expert block e over data row d's
tokens (``expert_block_outputs``).

The routed FFN of DeepSeekMoE (``TopKConfig``, ``init_topk_params``,
``topk_ffn``) has no counterpart in the reference package: a softmax over
the experts, each token's top k at their probabilities (not
renormalised), SwiGLU experts, and shared experts that every token takes
at gate 1. It drops nothing and computes each (token, expert) pair once:
the pairs are sorted by expert and run as grouped products
(``torch._grouped_mm``, one group per expert, the group ends on the
device), so no device→host read is made and no expert computes rows for
tokens it was not given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 128
    n_experts: int = 8
    capacity_factor: float = 1.25

    def capacity(self, n_tokens: int) -> int:
        cap = int(self.capacity_factor * n_tokens / self.n_experts)
        return max(cap, 1)


def init_moe_params(cfg: MoEConfig, generator: torch.Generator) -> dict:
    """The router ``[d, E]`` and the expert banks ``w_in [E, d, ff]`` and
    ``w_out [E, ff, d]``, f32, at the reference's scales, on
    ``generator.device``."""
    dev = generator.device
    scale_in = (1.0 / cfg.d_model) ** 0.5
    scale_out = (1.0 / cfg.d_ff) ** 0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * scale

    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": normal((d, e), scale_in),
        "w_in": normal((e, d, ff), scale_in),
        "w_out": normal((e, ff, d), scale_out),
    }


MOE_PARAM_SPECS = {
    "router": (None, None),
    "w_in": ("expert", None, None),
    "w_out": ("expert", None, None),
}


def moe_param_shardings(mesh, params: dict) -> dict:
    """The spec of each leaf of an expert FFN's params (the mesh only
    fixes the axis names)."""
    del mesh
    return {name: MOE_PARAM_SPECS[name] for name in params}


class Assignment(NamedTuple):
    """Top-1 routing of a batch of G tokens: each token's expert [G], its
    place in that expert's queue [G], whether it is kept [G] (place below
    ``capacity``) and its gate [G] f32."""

    expert: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    gate: torch.Tensor
    capacity: int


def route(router_w: torch.Tensor, x: torch.Tensor,
          capacity: int) -> Assignment:
    """Top-1 routing of x [G, d] at ``capacity`` (``_assign``)."""
    return Assignment(*_assign(router_w, x, capacity), capacity)


def _assign(router_w: torch.Tensor, x: torch.Tensor, capacity: int):
    """Top-1 routing of x [G, d]: (expert [G], position in its queue [G],
    kept [G] bool, gate [G] f32)."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)  # [G, E]
    expert = torch.argmax(probs, dim=-1)  # the first maximum on a tie
    gate = probs.gather(-1, expert[:, None])[:, 0]
    onehot = _one_hot(expert, router_w.shape[-1]).long()
    position = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(-1)
    return expert, position, position < capacity, gate


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """f32 [..., n]: 1 where ``index`` names the column, all zeros for an
    index out of range, as ``jax.nn.one_hot`` gives it (``F.one_hot``
    raises there, and on the card it checks the range by a host sync)."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


def _route(cfg: MoEConfig, router_w: torch.Tensor, x: torch.Tensor,
           capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's (dispatch [G, E, C] one-hot, combine [G, E, C]),
    f32; a position past the capacity has an all-zero one-hot row."""
    expert, position, kept, gate = _assign(router_w, x, capacity)
    onehot = _one_hot(expert, cfg.n_experts)  # [G, E]
    pos_onehot = _one_hot(position, capacity)  # [G, C]
    dispatch = onehot[:, :, None] * pos_onehot[:, None, :]
    dispatch = dispatch * kept[:, None, None]
    return dispatch, dispatch * gate[:, None, None]


def moe_ffn(cfg: MoEConfig, params: dict, x: torch.Tensor,
            capacity: int | None = None,
            expert_offset: int = 0) -> torch.Tensor:
    """x: [G, d_model] -> [G, d_model] f32; dropped tokens return zeros
    (callers add the residual). ``capacity`` overrides the capacity-factor
    default: the serving engine passes G (no drops), so routing does not
    depend on the batch's shape and every decode mode emits the same
    tokens. ``params`` may hold a block of the experts, the first being
    expert ``expert_offset`` (a tensor-parallel shard): tokens routed
    elsewhere return zeros."""
    capacity = cfg.capacity(x.shape[0]) if capacity is None else capacity
    assign = route(params["router"], x, capacity)
    return expert_block_outputs(params, x, assign, slice(None),
                                expert_offset)


def expert_block_outputs(params: dict, x: torch.Tensor, assign: Assignment,
                         rows: slice, expert_offset: int) -> torch.Tensor:
    """f32 [n, d]: the outputs of the block of experts ``params`` holds
    (``w_in``/``w_out``, the first being expert ``expert_offset``) for the
    tokens ``rows`` of a routed batch, given as x [n, d] on the block's
    device; zeros for a token routed to another block or dropped."""
    d = x.shape[1]
    e = params["w_in"].shape[0]
    cap = assign.capacity
    dev = x.device
    expert = assign.expert[rows].to(dev) - expert_offset
    kept = assign.kept[rows].to(dev) & (expert >= 0) & (expert < e)
    slot = torch.where(kept, expert * cap + assign.position[rows].to(dev),
                       e * cap)
    expert_in = _dispatch(x, slot, e * cap).view(e, cap, d)
    h = torch.relu(torch.bmm(expert_in, params["w_in"].float()))
    expert_out = torch.bmm(h, params["w_out"].float()).view(-1, d)
    return _combine(expert_out, slot, kept, assign.gate[rows].to(dev))


def make_sharded_moe_step(cfg: MoEConfig, mesh, params: dict):
    """The expert-parallel FFN step over a ("data", "expert") mesh;
    returns (step_fn, placed).

    ``placed`` holds each device's blocks under ``MOE_PARAM_SPECS``
    (``model.shard_params``). ``step_fn(placed, x)`` splits x [G, d] over
    "data", routes the whole batch by the first device's router, runs
    each (data row, expert block) on its device and sums the blocks
    (``model.all_reduce_sum``), and takes one SGD step at lr 1e-2 on the
    reference's autoencoding objective mean((y - x)^2), every copy of a
    block updated by its gradient summed over "data"; it returns (placed,
    loss)."""
    from tpumon_torch.loadgen.model import (
        all_reduce_sum,
        mesh_sgd_step,
        shard_params,
    )

    specs = moe_param_shardings(mesh, params)
    placed = shard_params(mesh, params, specs=specs)
    dp, ep = mesh.shape.get("data", 1), mesh.shape["expert"]
    if cfg.n_experts % ep:
        raise ValueError(f"n_experts={cfg.n_experts} must be divisible by "
                         f"the mesh's 'expert' axis ({ep})")
    devs = mesh.device_list

    def loss(views, x):
        g = x.shape[0]
        if g % dp:
            raise ValueError(f"{g} tokens do not split over data={dp}")
        gb = g // dp
        home = devs[0]
        assign = route(views[0]["router"], x.to(home), cfg.capacity(g))
        total = None
        for d in range(dp):
            rows = slice(d * gb, (d + 1) * gb)
            parts = []
            for e in range(ep):
                i = mesh.index(data=d, expert=e)
                parts.append(expert_block_outputs(
                    views[i], x[rows].to(devs[i]), assign, rows,
                    e * (cfg.n_experts // ep)))
            y = all_reduce_sum(parts)[0]
            sq = torch.square(y - x[rows].to(y.device)).sum().to(home)
            total = sq if total is None else total + sq
        return total / x.numel()

    def step(p, x):
        return mesh_sgd_step(mesh, p, specs, lambda v: loss(v, x), lr=1e-2)

    return step, placed


def _dispatch(x: torch.Tensor, slot: torch.Tensor,
              rows: int) -> torch.Tensor:
    """f32 [rows, d]: each kept token of x [G, d] in its (expert, slot)
    row, zeros elsewhere; a dropped token's ``slot`` is ``rows``, a spare
    row cut off after."""
    xf = x.float()
    return xf.new_zeros(rows + 1, x.shape[1]).index_copy(0, slot, xf)[:rows]


def _combine(expert_out: torch.Tensor, slot: torch.Tensor,
             kept: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """[G, d]: each kept token's row of expert_out [rows, d] back, weighted
    by its gate; zeros for a dropped token."""
    back = expert_out.index_select(0, torch.where(kept, slot, 0))
    return back * torch.where(kept, gate, 0.0)[:, None]


@dataclass(frozen=True)
class TopKConfig:
    """The routed FFN: ``n_experts`` routed SwiGLU experts of width
    ``d_ff``, ``top_k`` a token, and ``n_shared`` shared experts of the
    same width that every token takes."""

    d_model: int = 64
    d_ff: int = 32
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0


def init_topk_params(cfg: TopKConfig, generator: torch.Generator) -> dict:
    """f32 ``router`` [d, E] and the expert groups: ``w_gate_up`` [G, d,
    2·ff] (gate columns, then up) and ``w_down`` [G, ff, d], G = E +
    n_shared, the shared experts last; fan-in scaled, on
    ``generator.device``."""
    dev = generator.device
    g, d, ff = cfg.n_experts + cfg.n_shared, cfg.d_model, cfg.d_ff

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * fan_in ** -0.5

    return {"router": normal((d, cfg.n_experts), d),
            "w_gate_up": normal((g, d, 2 * ff), d),
            "w_down": normal((g, ff, d), ff)}


def topk_gates(cfg: TopKConfig, router_w: torch.Tensor,
               x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(gates [N, k] f32, experts [N, k]): each token's top k of the
    softmax over every expert, computed in f32, the gates not
    renormalised."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    return torch.topk(probs, cfg.top_k, dim=-1)


def topk_ffn(cfg: TopKConfig, params: dict, x: torch.Tensor,
             n_shared: int | None = None, expert_offset: int = 0,
             counts: torch.Tensor | None = None) -> torch.Tensor:
    """x [N, d] -> [N, d] in x's dtype: the sum over each token's top-k
    experts of gate · SwiGLU_e(x), plus its shared experts' outputs.

    ``params`` holds the router over all ``cfg.n_experts`` and a block of
    expert groups (``init_topk_params``'s layout): routed experts
    ``expert_offset``.. first, then ``n_shared`` shared ones
    (``cfg.n_shared`` unless given; a shard but one passes 0, so the sum
    over shards counts them once). A pair routed outside the block gives
    nothing. The pairs are sorted by group (stably: the order of a
    group's rows is the tokens') and run as two grouped products in x's
    dtype, gate and up in one; the gates weigh them in f32. ``counts``
    [2, routed experts of the block], when given, gains each expert's
    rows and, where it had any, one call."""
    n_shared = cfg.n_shared if n_shared is None else n_shared
    n, d = x.shape
    w_gu, w_down = params["w_gate_up"], params["w_down"]
    groups = w_gu.shape[0]
    routed = groups - n_shared
    ff = w_down.shape[1]
    wts, ids = topk_gates(cfg, params["router"], x)
    partial = bool(expert_offset) or routed != cfg.n_experts
    if partial:  # a pair past every group is dropped
        local = ids - expert_offset
        inside = (local >= 0) & (local < routed)
        ids = torch.where(inside, local, groups)
        wts = torch.where(inside, wts, 0.0)
    width = cfg.top_k + n_shared
    if n_shared:
        shared = torch.arange(routed, groups, device=x.device)
        ids = torch.cat([ids, shared.expand(n, n_shared)], dim=1)
        wts = torch.cat([wts, wts.new_ones(n, n_shared)], dim=1)
    sorted_ids, order = torch.sort(ids.flatten(), stable=True)
    ends = torch.searchsorted(
        sorted_ids, torch.arange(1, groups + 1, device=x.device),
        out_int32=True)
    if counts is not None:
        rows = torch.diff(ends[:routed], prepend=ends.new_zeros(1))
        counts[0] += rows
        counts[1] += rows.clamp(max=1)
    xs = x.index_select(0, order // width)
    h = torch._grouped_mm(xs, w_gu.to(x.dtype), offs=ends)
    act = F.silu(h[:, :ff]) * h[:, ff:]
    out = torch._grouped_mm(act, w_down.to(x.dtype), offs=ends)
    out = out.float() * wts.flatten()[order][:, None]
    if partial:  # rows past the last group are not computed
        out = torch.where((sorted_ids < groups)[:, None], out, 0.0)
    pairs = torch.empty_like(out).index_copy_(0, order, out)
    return pairs.view(n, width, d).sum(dim=1).to(x.dtype)
