"""Pipeline parallelism: GPipe-style microbatched stages over the mesh.

Counterpart of ``tpumon/loadgen/pipeline.py``. The transformer stack is
split into S stages over a mesh "pipe" axis and a batch goes through as M
microbatches: at tick i stage s runs microbatch i - s on its device and
hands the activation to stage s + 1 (a ``.to()`` copy, the reference's
``ppermute``). The schedule is GPipe's, M + S - 1 ticks, with the bubble's
(S-1)/(M+S-1) share idle; the reference computes its bubble ticks on
zeros and masks them, here they are skipped. The backward pass needs no
hand-written schedule: autograd runs the hand-offs in reverse.

Composes with data parallelism: the mesh is ("data", "pipe"), each
microbatch's rows split over "data". The embedding, final norm and head
run on the first device, outside the pipeline, as the reference runs them
outside its ``shard_map``. Each stage's layers go through
``model._layer_block``, so a flash config runs the flash kernels per stage.
The stacked tree keeps the reference's layout: each per-layer leaf becomes
``stages[key]`` of shape [S, layers per stage, ...], split over "pipe" on
its leading axis (``pipeline_param_shardings``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from tpumon_torch.loadgen.model import (
    Mesh,
    ModelConfig,
    _layer_block,
    _rms_norm,
    init_params,
    mesh_sgd_step,
    next_token_nll,
    shard_params,
    shard_views,
)


@dataclass(frozen=True)
class PipelineConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    n_stages: int = 2
    n_microbatches: int = 4

    def check(self) -> "PipelineConfig":
        """Raises AssertionError, as the reference does, for a stage count
        that does not divide the layers or no microbatch."""
        assert self.model.n_layers % self.n_stages == 0, (
            f"n_layers={self.model.n_layers} must divide into "
            f"n_stages={self.n_stages}")
        assert self.n_microbatches >= 1
        return self


def stack_pipeline_params(cfg: PipelineConfig, params: dict) -> dict:
    """Regroup a ``model.init_params`` tree for the pipeline: the per-layer
    dicts become stacked leaves [n_stages, layers_per_stage, ...], so
    stage s owns layers [s*Lps, (s+1)*Lps) in order. Embed, head and final
    norm stay top-level."""
    cfg.check()
    layers = params["layers"]
    if "moe" in layers[0]:
        raise ValueError("the pipeline runs the dense family only")
    lps = cfg.model.n_layers // cfg.n_stages
    stacked = {
        key: torch.stack([
            torch.stack([layers[s * lps + j][key] for j in range(lps)])
            for s in range(cfg.n_stages)])
        for key in layers[0]
    }
    return {"embed": params["embed"], "stages": stacked,
            "final_norm": params["final_norm"], "lm_head": params["lm_head"]}


def init_pipeline_params(cfg: PipelineConfig,
                         generator: torch.Generator) -> dict:
    return stack_pipeline_params(cfg, init_params(cfg.model, generator))


def pipeline_param_shardings(mesh, params: dict) -> dict:
    """Stage leaves split over "pipe" on their leading axis; the embedding
    and head ends replicated (the mesh only fixes the axis names)."""
    del mesh
    return {k: ({s: ("pipe",) + (None,) * (v.dim() - 1)
                 for s, v in params[k].items()} if k == "stages"
                else (None,) * params[k].dim())
            for k in params}


def _stage_apply(cfg: ModelConfig, stage: dict, x: torch.Tensor
                 ) -> torch.Tensor:
    """Run one stage's stacked layers (leaves [Lps, ...]) over x."""
    for j in range(next(iter(stage.values())).shape[0]):
        x = _layer_block(cfg, x, {k: v[j] for k, v in stage.items()})
    return x


def _check_mesh(cfg: PipelineConfig, mesh: Mesh) -> None:
    if mesh.shape.get("pipe") != cfg.n_stages:
        raise ValueError(f"the mesh's 'pipe' axis ({mesh.shape.get('pipe')}) "
                         f"must equal n_stages={cfg.n_stages}")


def pipeline_forward(cfg: PipelineConfig, params, tokens: torch.Tensor,
                     mesh: Mesh) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] f32, on the first device.

    B must equal n_microbatches x microbatch size, and the microbatch size
    must divide by the mesh's "data" axis. ``params`` is a stacked tree
    (its blocks read as differentiable views, ``model.shard_views``) or
    the per-device blocks of ``make_pipeline_train_step``.
    """
    cfg.check()
    _check_mesh(cfg, mesh)
    mcfg = cfg.model
    s_count, m_count = cfg.n_stages, cfg.n_microbatches
    b, t = tokens.shape
    if b % m_count:
        raise ValueError(f"batch {b} not divisible by M={m_count}")
    mb = b // m_count
    dp = mesh.shape.get("data", 1)
    if mb % dp:
        raise ValueError(f"microbatch size {mb} not divisible by dp={dp}")
    mbd = mb // dp
    views = params if isinstance(params, list) else shard_views(
        mesh, params, pipeline_param_shardings(mesh, params))
    devs = mesh.device_list
    home = devs[0]
    dt = mcfg.torch_dtype
    top = views[0]
    x = top["embed"].to(dt)[tokens.to(home).long()]  # [B, T, D]

    def stage(d, s):
        i = mesh.index(data=d, pipe=s)
        return devs[i], {k: v[0] for k, v in views[i]["stages"].items()}

    # acts[d, m]: microbatch m's activation as the last stage to run it
    # left it; at tick i stage s takes microbatch i - s from stage s - 1.
    acts = {(d, m): x[m * mb + d * mbd:m * mb + (d + 1) * mbd]
            for d in range(dp) for m in range(m_count)}
    for i in range(m_count + s_count - 1):
        for s in range(s_count):
            m = i - s
            if 0 <= m < m_count:
                for d in range(dp):
                    dev, layers = stage(d, s)
                    acts[d, m] = _stage_apply(mcfg, layers,
                                              acts[d, m].to(dev))
    out = torch.cat([acts[d, m].to(home) for m in range(m_count)
                     for d in range(dp)])
    out = _rms_norm(out, top["final_norm"])
    return (out @ top["lm_head"].to(dt)).float()


def pipeline_loss(cfg: PipelineConfig, params, tokens: torch.Tensor,
                  mesh: Mesh) -> torch.Tensor:
    logits = pipeline_forward(cfg, params, tokens[:, :-1], mesh)
    return next_token_nll(logits, tokens[:, 1:].to(logits.device))


def make_pipeline_train_step(cfg: PipelineConfig, mesh: Mesh, params: dict):
    """One SGD step (lr 1e-3) over a ("data", "pipe") mesh; returns (step,
    placed). ``params`` is a stacked tree; ``placed`` holds each device's
    blocks (its stage's layers, the replicated ends), each its own
    allocation, and ``step(placed, tokens)`` returns (placed, loss),
    every copy of a block updated by its gradient summed over the devices
    that hold it."""
    _check_mesh(cfg, mesh)
    specs = pipeline_param_shardings(mesh, params)
    placed = shard_params(mesh, params, specs=specs)

    def step(p, tokens):
        return mesh_sgd_step(
            mesh, p, specs, lambda v: pipeline_loss(cfg, v, tokens, mesh),
            1e-3)

    step.specs = specs
    return step, placed
