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

Over a serving mesh each tensor-parallel shard holds a contiguous block
of the experts (``model.PARAM_SPECS``) and runs ``moe_ffn`` with its
``expert_offset``: routing is over every expert (the router replicates),
and a shard returns only its experts' tokens, zeros elsewhere, so the sum
over shards is each token's one expert output, exactly.
``make_sharded_moe_step`` and ``MOE_PARAM_SPECS`` (the training mesh) are
multi-GPU work, not yet ported (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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
    g, d = x.shape
    e = params["w_in"].shape[0]
    capacity = cfg.capacity(g) if capacity is None else capacity
    expert, position, kept, gate = _assign(params["router"], x, capacity)
    if e != cfg.n_experts:
        expert = expert - expert_offset
        kept = kept & (expert >= 0) & (expert < e)
    slot = torch.where(kept, expert * capacity + position, e * capacity)
    expert_in = _dispatch(x, slot, e * capacity).view(e, capacity, d)
    h = torch.relu(torch.bmm(expert_in, params["w_in"].float()))
    expert_out = torch.bmm(h, params["w_out"].float()).view(-1, d)
    return _combine(expert_out, slot, kept, gate)


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
