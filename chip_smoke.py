#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card: needs torch.cuda; prints nvidia-smi's name and power limit.
2. build: compiles every CUDA source of tpumon_torch/ops/csrc with nvcc
   (one process per source, started together) and prints the time.
3. kernel vs plain: the paged-attention kernel against its plain PyTorch
   version at the production decode shape (B=16, 32/8 heads, hd 128,
   page 128, 32-page tables drawn from a random permutation of a 513-page
   pool, lengths 0/1/127/128/129/2000/4096 and random; and at batch 4,
   lengths 2000/4096/129/0, over 4 and 8 splits), in bf16 and f32,
   plus group-1 hd-64, the serving CLI's hd-32 and an odd page size; each
   held to its worst relative error over (sequence, head) rows and run
   twice to the same bits, with planted faults of a paged kernel and of
   its split design (at the wrapper's pages_per_split) read beside under
   the same limit. The kernel's ptxas lines and shared memory are printed
   after the build.
4. engine: the serving engine at production width (bench.py's paged
   decode shape: vocab 4096, d_model 4096, 2 layers, 32/8 heads, d_ff
   8192, max_seq 4096, 16 slots, page 128, random weights from a seed),
   kv_layout="paged" with the kernel read path named explicitly (the
   defaults are the reference's dense/gather), serves 16 greedy requests
   of 64-3000 prompt tokens to completion; the
   kernel's launch count must equal n_layers x decode steps, and the
   fused draws' (phase 17) the sampler's: one categorical and two key
   launches per sampled token (each decode step and each first token,
   greedy rows drawn too, as the reference draws them); one decode
   step of the kernel path is held to the gather path in bf16 and f32;
   a small f32 engine's streams on the card equal the CPU's.
5. times: kernel, plain version, torch's SDPA on the gathered context
   with and without the gather (library yardsticks, never called by the
   port) and the bytes bound, with every table full and at phase 3's
   production lengths, each beside a table of the kernel at other pages
   per split and ring depths (each held to the plain version); engine
   decode step (kernel and gather), tokens/s, TTFT p50, and where a
   decode step's time goes.
6. server: the engine behind its HTTP server, stepped by the arrival
   pump, answers a /generate call with the greedy tokens a direct
   submission gives, and serves the /metrics families the monitor
   scrapes.
7. flash kernels vs plain: the causal flash forward (out, lse), dQ and
   dK/dV kernels against their plain PyTorch versions in bf16 and f32 at
   the production training shape (BH 128 = batch 8 x 16 heads, T 1024,
   hd 128), the seq-8k shape (BH 16, T 8192) and small shapes (hd 32 and
   64, T 128 and 384; hd 64 and 128, T 192 and 320, where the bf16
   forward's 128-row tiles reach past T), each output held to its worst
   relative error over 64-row tiles; beside each case, planted faults of
   a tiled kernel, modelled in plain torch at the kernel's tiles (the
   forward's 128 rows; each backward kernel's 128 owned rows in two
   warpgroups of 64, and its 64-row streamed tiles), must read over the
   same limit where they apply. The bf16 forward's and backward's ptxas
   lines, shared memory and registers after setmaxnreg are printed after
   the build. Then the bf16 gradients on more draws at the production
   shape (numpy's from seeds 0-7, as tests/flash_spread.py gives them to
   the JAX reference's kernel on the CPU, and flash_variants' draw) under
   the same limit, each draw's worst slice saved to build/flash_spread/
   for tests/flash_spread.py --slices.
8. trainer: the trainer at production width (bench.py's d2048/L6 flash
   schedule: vocab 4096, d_model 2048, 6 layers, 16/16 heads, d_ff 8192,
   attn_block_k 512, batch 8, seq 1024, bf16 over f32 master weights,
   random weights from a seed) runs a few steps through run_train with
   TrainMetrics and a checkpoint at its last step; each flash kernel's
   launch count must equal n_layers x steps; one step's loss and grads on
   the flash path are held to the naive path's (bf16 at 6 layers, f32 at
   2); a small f32 trainer's losses on the card equal the CPU's; the
   port's serving engine serves the checkpoint.
9. times: each flash kernel, its plain version, SDPA's causal forward or
   backward (autograd.grad of one recorded forward; library yardstick,
   never called by the port) under each pinned backend that runs (flash,
   cuDNN; the faster is the library time) and its bound; the triangle
   forward and both backward kernels at the seq-8k shape beside SDPA and
   their bounds;
   the train step (flash and naive) in ms, tokens/s and MFU, its tokens
   drawn as the reference's scan draws them (threefry); the batch draw's
   own host time; seq 8192 with flash beside remat + chunked; where a
   step's device time goes and the device's idle share (seq 1024 and
   8192).
10. trainer /metrics: the tpumon_train_* families the monitor scrapes.
11. GEMM kernels vs plain: matmul and the int8 weight-only product at the
    burn's 4096^3 (bf16), at tests/test_ops.py's shapes and at the shapes
    the persistent wgmma kernel adds (more tiles than SMs with a partial
    last wave, N not a multiple of 256, K not of 64) (bf16, f32), each
    held to its worst relative error over 128 x 128 output tiles, with
    planted faults beside (the K and scale faults of a 64-deep K step and
    two of a persistent tile scheduler); the scale applied once; the
    reference's fallback for a shape that does not tile, with no launch.
12. burn path: the chained burn programs at size 4096, on the reference's
    inputs (threefry normals and randint drawn on the card from
    PRNGKey(0) by the fused draws of phase 17, one draw launch per input),
    through the kernels and the library (the 3-link chains agree; 64
    launches per 64-link call), then mxu_burn and int8_burn for
    2 s each way with nvidia-smi's
    power draw and SM clock read during each; beside them, as a reference
    point, the same chain kept live (renormalised by sqrt(size)).
13. kernels phase: bench.py's slope-timed measurements through the port
    (matmul and int8 matmul, kernel and library; paged attention, kernel
    and gather; the production engine decode step, gather and kernel), on
    one line under bench.py's key names (pallas read as kernel).
14. burn load: validate's verdicts on nvidia-smi's memory.used around
    hbm_fill(0.3) and utilization.gpu under mxu_burn in a thread.
15. rectangular flash forward vs plain: causal and not, bf16 and f32, at
    the training shape and small shapes (T 192 and 320 among them), with
    the forward faults that apply (the tail of keys past T left unmasked
    among them); then the times of the GEMM kernels (their f32 variants
    beside full-f32 library calls) and of the rectangular forward beside
    their plain versions, library calls (SDPA pinned as in 9) and
    bounds.
16. dense and fused serving: phase 4's model and traffic, half the
    requests greedy and half sampled (temperature 0.8, top-k 0 and 50),
    through the dense engine at decode_block 1 and 8 (and 8 under the
    sequential scheduler) and the paged kernel engine at block 1 and 8
    and the paged gather engine at block 8 (the kernel's launches must
    equal n_layers x decode steps, in-block steps included; the fused
    draws' the sampler's); each request's stream identical across blocks
    and schedulers, the paged kernel's included; dense and paged-gather
    greedy streams equal up to the first near-tie, which is printed;
    small f32 engines (dense and paged, greedy and sampled) emit the
    CPU's streams on the card; sample_tokens on [16, 4096] logits agrees
    with its CPU run outside a 1e-4 margin. Times: the dense decode step
    at block 1 and 8, one sample_tokens call against the greedy argmax
    (with its launches and device time), where a dense step's device
    time goes and the idle share, tokens/s and TTFT p50 of each run.
17. fused threefry draws: the key, draw and categorical kernels
    (csrc/threefry.cu) against their plain PyTorch versions
    (tpumon_torch/prng.py) at the shapes the paths give them (the
    sampler's keys and [16, 4096] categorical, the burns' 4096^2 bf16
    normals and int8 randint, the paged burn's pool, queries and table),
    every element equal; then each kernel's time beside its plain
    version's and its bound, the normal also at [8, 4096, 4096], where
    back-to-back launches keep the card busy (its summary row), bounded
    at the card's issue rate (SMs x 128 lanes x the maximum SM clock).
18. serving features: phase 4's model. Prefix caching (16 requests behind
    a 2048-token system prompt, tails of 64-512 tokens, half sampled;
    dense with 4 entries and paged kernel at block 8 with the admission
    lookahead): every stream equal to the same engine's with the cache
    off, 15 hits, TTFT p50 cold against hit. Speculative decoding (dense
    self at spec_len 3, a 1-of-2-layer draft, prompt lookup at spec_len 15
    on periodic prompts, paged kernel self at 3; sequential scheduler):
    acceptance, target dispatches and tokens/s against plain decode,
    bf16 greedy streams equal plain decode's up to the first near-tie.
    int8 KV (dense block 8, paged gather), int8 weights (dense block 8)
    and both: every run completes, agreement with bf16 printed, resident
    weight and KV bytes and the dense decode step against bf16, with where
    each dense step's device time goes. Small f32
    engines of each kind emit the CPU's streams on the card (self
    speculation accepting every proposal). The actuator verbs: set_shed
    sheds half a tenant's submissions, a slice drained mid-flight
    requeues with streams equal to the undrained run's, evict_all then
    adopt on a second engine gives the same streams, nudge_capacity acts
    on the next step. A two-tenant TrafficSim behind /metrics serves the
    tenant families. The paged kernel's launches equal n_layers x plain
    decode steps in every run (in-block steps included, speculative
    rounds excluded: their verify block reads by gather).
19. the MoE family, the induction trainer and the workload self-report.
    MoE serving: phase 4's model with 8 experts a layer (top-1, full
    capacity) and phase 4's traffic, half sampled, through the dense
    engine at block 1 and the paged kernel at block 1 and 8 (the kernel's
    launches equal n_layers x decode steps; the paged streams identical
    across blocks); the decode step in ms and where its device time goes
    (attention, the expert banks' f32 casts, the f32 expert products,
    routing, dispatch and combine), resident weight bytes, tokens/s and
    TTFT p50; a WorkloadReporter on the paged block-1 engine writes a
    report whose hbm_used is memory_allocated (1%) and whose busy_frac
    lies in (0, 1]; small f32 MoE engines emit the CPU's streams on the
    card in every mode. MoE training: phase 8's model with 8 experts
    through run_train (finite loss, each flash kernel launched n_layers x
    steps times), its step ms and MFU over the active parameters, and a
    small f32 MoE trainer's losses equal to the CPU's within STEP_TOL.
    train_induction at bench.py's settings (final loss under 1.0), then
    prompt lookup against plain block-8 decode of the trained model on
    bench.py's periodic prompts: identical streams, acceptance and both
    tokens/s.
20. the monitor's GPU collectors and validate: the in-process NVML
    collector (tpumon_torch/collectors/accel_cuda.py) sees the card as
    nvidia-smi does (kind h100, name, memory.total, memory.used within
    256 MiB, the card idle); its hbm_used rises by at least 0.9 x the
    bytes of hbm_fill(0.3); its mxu_duty_pct reaches 80% in one of five
    samples a second apart under mxu_burn(use_kernel=True) (the GEMM
    kernel's launches counted from 0), and is read under the default
    (cuBLAS) burn too; python -m tpumon_torch.validate runs in its own
    process with its defaults (backend cuda, device cuda) and exits 0
    with every check PASS but dark source-* SKIPs and source-nvml PASS;
    the median cost of 50 collects of the NVML collector and of the
    nvidia-smi one.
21. the monitor core: the native layer (tpumon_torch/native, g++) builds
    into build/tpumon_torch/native/ and the TSDB's ingest kernel loads;
    python -m tpumon_torch.info runs with its defaults in its own process
    (exit 0, no degraded source, a row for the card with NVML's HBM
    total); phase 4's engine (paged kernel) serves 2 x phase 4's 16
    prompts, 32 new tokens each, from start_background (no synthetic
    arrivals) behind its /metrics, while a port Sampler (NVML, host and
    serving collectors; rules chip.mxu[5m] and chip.hbm[5m], the default
    thresholds, a TTFT SLO, a capacity policy bound to the engine) ticks
    every second (serving_interval_s cut 5 -> 1 s): the card's duty series
    rises over its idle ticks, the TSDB's tokens/s integrates to the
    engine's token count (5%), its last TTFT p50 is the engine's own, the
    ingest kernel is active, the policy fires and moves the prefill
    budget, no collector fails, the paged kernel's and the draws' launches
    are the path's (counted from 0); the tick's p50/p95 and each stage's
    p50; the engine's tokens/s and decode-step ms without and with a
    sampler ticking, in turns; a Sampler on fake:v5p-256 with 256 chips'
    series (1,034 series), 8 + 40 ticks through the ingest kernel and
    with ingest_kernel off, equal series, the history stage's p50 and the
    instant and 30 m range queries' p50s. Row 1's and the sampler draws'
    launches in the summary add this path's to phase 4's.

The last three lines are the kernels summary (JSON), nvidia-smi's name
and power limit, and the contract line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

PROD_LENGTHS = (0, 1, 127, 128, 129, 2000, 4096)
# Paged-attention kernel vs plain version: rows_rel_err, the worst
# ||got - want|| / ||want|| over the (sequence, head) rows of length > 0;
# a length-0 row must be exactly zero. A decode row over n keys has an
# output spread near sqrt(e / n) at random inputs, so an absolute limit
# fitted to the short rows would pass a fault on the long ones. bf16: the
# plain version rounds the scores and P to bf16 where the kernel keeps
# f32. Each limit lies between the kernel's reading and the weakest
# planted fault's (paged_faulty_plain; PERF.md).
PAGED_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# The faults of the split design (paged_split_plain) after those of a
# kernel that walks a sequence's pages in order.
SPLIT_FAULTS = ("split_partial_dropped", "merge_no_rescale",
                "split_boundary_row_twice", "stale_stage")
PAGED_FAULTS = ("last_page_dropped", "first_page_dropped", "no_rescale",
                "last_page_unmasked", "wrong_kv_head", *SPLIT_FAULTS)
# Engine logits, kernel path vs gather path on the same pool. bf16: the
# plain path rounds scores and probabilities to bf16 where the kernel
# keeps f32, and logits near 4 have a bf16 spacing of 1/32, so 0.25 is
# eight such steps. f32: both paths in full f32 (no TF32); 1e-3.
ENGINE_TOL = {"bfloat16": 0.25, "float32": 1e-3}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str) -> tuple[str, float, dict]:
    """(variant, memory bytes/s, peak op/s by dtype) from the port's table
    of NVIDIA's data sheets (tpumon_torch.loadgen.train.NVIDIA_PEAKS),
    dense rates: bf16 on tensor cores, f32 on CUDA cores."""
    from tpumon_torch.loadgen.train import card_peaks as port_card_peaks

    peaks = port_card_peaks(name)
    if peaks is None:
        fail(f"unknown card {name!r}: no peak rates on record")
    return peaks.variant, peaks.hbm, {"bfloat16": peaks.bf16,
                                      "float32": peaks.f32}


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paged_inputs(gen, b, nh, nkv, hd, ps, max_pages, lengths, dtype):
    """q and a (1 + b*max_pages)-page pool with random values; each
    sequence's table is its own slice of a random page permutation."""
    import torch

    dev = gen.device
    num_pages = b * max_pages + 1
    q = torch.randn(b, nh, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(nkv, num_pages, ps, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(nkv, num_pages, ps, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    table = perm[:b * max_pages].reshape(b, max_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, table.contiguous(), lens


def rows_rel_err(got, want, lengths) -> float:
    """The worst relative error over the (sequence, head) rows of
    [B, n_heads, hd] outputs whose sequence has length > 0."""
    live = lengths > 0
    if not bool(live.any()):
        return 0.0
    a, b = got[live].float(), want[live].float()
    return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max(
        ).item()


def paged_split_plain(q, k_pages, v_pages, table, lengths, pages: int,
                      fault: str | None = None, tile: int = 0):
    """The kernel's split and merge in plain torch, in f32: each split of
    ``pages`` table entries keeps its own softmax state (m_i, l_i, acc_i)
    over its live keys, and the live splits merge in split order, out =
    sum_i acc_i e^(m_i - m) / sum_i l_i e^(m_i - m) with m = max_i m_i.
    Carries one fault of the split design (None: no fault):

    - split_partial_dropped: the middle live split (n_live // 2, of at
      least 3) is missing from the merge;
    - merge_no_rescale: the partials are summed without their
      e^(m_i - m) weights;
    - split_boundary_row_twice: the first row of each split after the
      first is counted twice;
    - stale_stage: the first ``tile`` rows (one ring stage) of each split
      after the first read the K and V of the tile before them.
    """
    import torch

    b, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    max_pages = table.shape[1]
    span, n_split = pages * ps, -(-max_pages // pages)
    s_max = n_split * span
    pos = torch.arange(s_max, device=q.device)
    idx = table.long()
    # [B, S, nkv, hd], padded with zeros to whole splits
    k, v = (torch.nn.functional.pad(
        x[:, idx].reshape(nkv, b, max_pages * ps, hd).permute(1, 2, 0, 3),
        (0, 0, 0, 0, 0, s_max - max_pages * ps)).float()
        for x in (k_pages, v_pages))
    if fault == "stale_stage":
        src = torch.where((pos >= span) & (pos % span < tile), pos - tile, pos)
        k, v = k[:, src], v[:, src]
    n = lengths.long().clamp(0, max_pages * ps)
    live = pos[None] < n[:, None]  # [B, S]
    qg = q.float().reshape(b, nkv, nh // nkv, hd)
    s = torch.einsum("bngd,bknd->bngk", qg, k) / hd**0.5
    s = torch.where(live[:, None, None], s, -1e30).unflatten(-1, (n_split, span))
    m = s.amax(-1)  # [B, nkv, group, splits]
    p = torch.exp(s - m[..., None]) * live.unflatten(-1, (n_split, span))[
        :, None, None]
    if fault == "split_boundary_row_twice":
        p = p * (1 + ((pos % span == 0) & (pos > 0))).unflatten(
            -1, (n_split, span))
    el = p.sum(-1)
    acc = torch.einsum("bngik,biknd->bngid", p, v.unflatten(1, (n_split, span)))
    n_live = torch.tensor(paged_split_n_live(lengths.tolist(), ps, pages,
                                             max_pages), device=q.device)
    split_live = torch.arange(n_split, device=q.device)[None] < n_live[:, None]
    weight = torch.exp(m - torch.where(split_live[:, None, None], m, -1e30
                                       ).amax(-1, keepdim=True))
    weight = weight * split_live[:, None, None]
    if fault == "split_partial_dropped":
        mid = torch.arange(n_split, device=q.device)[None] == (n_live // 2)[:, None]
        weight = weight * ~(mid & (n_live[:, None] >= 3))[:, None, None]
    elif fault == "merge_no_rescale":
        weight = split_live[:, None, None].float().expand_as(weight)
    total = (weight * el).sum(-1)[..., None]
    out = (weight[..., None] * acc).sum(-2) / total.clamp_min(1e-30)
    return torch.where(total > 0, out, 0.0).reshape(b, nh, hd).to(q.dtype)


def paged_split_n_live(lengths, ps: int, pages: int, max_pages: int) -> list:
    """The live splits of each sequence: splits of ``pages`` table entries
    that start below its (clamped) length."""
    pages_live = [-(-min(max(n, 0), max_pages * ps) // ps) for n in lengths]
    return [-(-n // pages) for n in pages_live]


def paged_faulty_plain(q, k_pages, v_pages, table, lengths,
                       fault: str | None):
    """The plain version (paged_attention_reference's numerics) carrying
    one fault of a kernel that walks each sequence's pages in table order
    (None: no fault):

    - last_page_dropped / first_page_dropped: the sequence's last live
      page, or its first, is skipped;
    - no_rescale: the accumulator is not rescaled when the running max
      rises from one page to the next;
    - last_page_unmasked: the last live page is read whole, past lengths;
    - wrong_kv_head: each query group reads the next kv head's pages;

    or one fault of the split design (SPLIT_FAULTS), modelled by
    paged_split_plain at the wrapper's own pages_per_split and ring stage.
    """
    import torch

    from tpumon_torch.ops.paged_attention import STAGE_ROWS, pages_per_split

    b, nh, hd = q.shape
    if fault in SPLIT_FAULTS:
        nkv, _, ps, _ = k_pages.shape
        return paged_split_plain(
            q, k_pages, v_pages, table, lengths,
            pages_per_split(b, nkv, table.shape[1], ps), fault,
            min(STAGE_ROWS[q.dtype], ps))
    nkv, _, ps, _ = k_pages.shape
    s_max = table.shape[1] * ps
    heads = torch.arange(nkv, device=q.device)
    if fault == "wrong_kv_head":
        heads = (heads + 1) % nkv
    idx = table.long()
    k, v = (x[heads][:, idx].reshape(nkv, b, s_max, hd).permute(1, 2, 0, 3)
            for x in (k_pages, v_pages))
    k = torch.repeat_interleave(k, nh // nkv, dim=2)
    v = torch.repeat_interleave(v, nh // nkv, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q, k).float() / hd**0.5
    kpos = torch.arange(s_max, device=q.device)[None, None]
    n = lengths[:, None, None].long()
    mask = kpos < n
    if fault == "last_page_dropped":
        mask &= kpos < (n - 1) // ps * ps
    elif fault == "first_page_dropped":
        mask &= kpos >= ps
    elif fault == "last_page_unmasked":
        mask = kpos < (n + ps - 1) // ps * ps
    s = torch.where(mask, s, -1e30)
    m = s.amax(-1, keepdim=True)
    el = torch.exp(s - m).sum(-1, keepdim=True)
    if fault == "no_rescale":  # each page weighed at its running max
        run = s.unflatten(-1, (-1, ps)).amax(-1).cummax(-1)[0]
        p = torch.exp(s - run.repeat_interleave(ps, -1))
    else:
        p = torch.exp(s - m)
    probs = torch.where(mask, (p / el).to(q.dtype), 0.0)
    return torch.einsum("bhk,bkhd->bhd", probs, v)


def paged_fault_applies(fault: str, nkv: int, lengths, ps: int,
                        n_live=()) -> bool:
    """Whether a planted fault changes any live row of this case;
    ``n_live``: each sequence's live splits at the wrapper's rule (the
    split faults need two, a dropped middle split three)."""
    live = [n for n in lengths if n > 0]
    if fault == "wrong_kv_head":
        return nkv > 1
    if fault == "last_page_unmasked":
        return any(n % ps for n in live)
    if fault in SPLIT_FAULTS:
        return max(n_live, default=0) >= (
            3 if fault == "split_partial_dropped" else 2)
    return bool(live)


def paged_fault_readings(args, want) -> dict:
    """{fault: rows_rel_err against the plain version} for every planted
    fault that applies to the case (``args`` as paged_attention takes)."""
    from tpumon_torch.ops.paged_attention import pages_per_split

    q, k_pages, _, table, lengths = args
    lens = lengths.tolist()
    nkv, _, ps, _ = k_pages.shape
    n_live = paged_split_n_live(
        lens, ps, pages_per_split(q.shape[0], nkv, table.shape[1], ps),
        table.shape[1])
    return {f: rows_rel_err(paged_faulty_plain(*args, f), want, lengths)
            for f in PAGED_FAULTS
            if paged_fault_applies(f, nkv, lens, ps, n_live)}


def prod_lengths() -> list:
    """The production case's 16 lengths: PROD_LENGTHS, then random ones
    from a seed."""
    rng = random.Random(1)
    return list(PROD_LENGTHS) + [
        rng.randint(1, 4096) for _ in range(16 - len(PROD_LENGTHS))]


def print_paged_config() -> None:
    """ptxas's lines for the paged kernel's instances (registers, spills)
    beside its dynamic shared memory, default ring depth and stage rows
    at page 128 per type."""
    import torch

    from tpumon_torch.ops import _build
    from tpumon_torch.ops.paged_attention import kernel_config

    configs = {f"{str(dt)[6:]}_hd{hd}": kernel_config(hd, dt, 128)
               for dt in (torch.bfloat16, torch.float32) for hd in (32, 64, 128)}
    print(f"paged_ptxas config={configs} "
          + " | ".join(_build.ptxas_report("paged_attention")), flush=True)


def check_kernel(gen) -> dict:
    import torch

    from tpumon_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    cases = [
        ("production", dict(b=16, nh=32, nkv=8, hd=128, ps=128, max_pages=32,
                            lengths=prod_lengths())),
        # production widths at batch 4, where the rule splits a table in 8
        ("production_b4", dict(b=4, nh=32, nkv=8, hd=128, ps=128,
                               max_pages=32, lengths=[2000, 4096, 129, 0])),
        ("group1_hd64", dict(b=8, nh=8, nkv=8, hd=64, ps=128, max_pages=8,
                             lengths=[0, 1, 127, 128, 129, 500, 1024, 777])),
        ("cli_hd32", dict(b=4, nh=8, nkv=4, hd=32, ps=32, max_pages=8,
                          lengths=[0, 1, 33, 256])),
        ("odd_page40", dict(b=4, nh=8, nkv=2, hd=128, ps=40, max_pages=5,
                            lengths=[0, 39, 41, 200])),
    ]
    worst = {}
    for name, case in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            tol = PAGED_TOL[dname]
            args = paged_inputs(gen, dtype=dtype, **case)
            out = paged_attention(*args)
            again = paged_attention(*args)
            torch.cuda.synchronize()
            ref = paged_attention_reference(*args)
            err = (out.float() - ref.float()).abs().max().item()
            rel = rows_rel_err(out, ref, args[4])
            zero = [i for i, n in enumerate(case["lengths"]) if n == 0]
            zeros_ok = bool((out[zero] == 0).all().item()) if zero else True
            finite = bool(torch.isfinite(out.float()).all().item())
            same = torch.equal(out, again)  # the merge is in split order
            ok = rel <= tol and zeros_ok and finite and same
            faults = paged_fault_readings(args, ref)
            missed = [f for f, r in faults.items() if not r > tol]
            # The same faults on the longest sequence's rows alone.
            long = args[4] == args[4].max()
            long_faults = {f: rows_rel_err(
                paged_faulty_plain(*args, f)[long], ref[long], args[4][long])
                for f in faults}
            print(f"kernel_vs_plain {name} {dname} lengths={case['lengths']} "
                  f"rows_rel_err={rel!r} tol={tol} max_abs_err={err!r} "
                  f"zero_rows_zero={zeros_ok} repeat_identical={same} "
                  f"{'ok' if ok else 'MISS'}",
                  flush=True)
            print(f"paged_planted_faults {name} {dname} rows_rel_err="
                  f"{faults} longest_rows={long_faults} tol={tol} "
                  f"missed={missed}", flush=True)
            if not ok:
                fail(f"paged_attention kernel disagrees with its plain "
                     f"version ({name}, {dname})")
            if missed:
                fail(f"the paged limit {tol} passes planted faults {missed} "
                     f"({name}, {dname})")
            if name == "production":
                worst[dname] = err
    return worst


def engine_config(paged_attn="kernel", dtype="bfloat16", kv_layout="paged",
                  decode_block=1, scheduler="interleaved"):
    """bench.py's production serving shape; the paged layout with the
    kernel read path unless asked otherwise."""
    from tpumon_torch.loadgen.model import ModelConfig
    from tpumon_torch.loadgen.serving import ServeConfig

    return ServeConfig(
        model=ModelConfig(vocab=4096, d_model=4096, n_layers=2, n_heads=32,
                          n_kv_heads=8, d_ff=8192, max_seq=4096,
                          compute_dtype=dtype),
        slots=16, prefill_len=128, kv_layout=kv_layout,
        paged_attn=paged_attn, decode_block=decode_block,
        scheduler=scheduler)


def engine_traffic() -> tuple:
    """Phase 4's traffic: 16 prompts of 64-3000 tokens (lengths, prompts),
    and phase 16's sampling settings for them (temperature, top_k): even
    requests greedy, odd ones at temperature 0.8, half of those over the
    whole vocab and half over the top 50."""
    rng = random.Random(2)
    lens = [64, 3000] + [rng.randint(64, 3000) for _ in range(14)]
    prompts = [[rng.randrange(4096) for _ in range(n)] for n in lens]
    sampling = [(0.0, 0) if i % 2 == 0 else (0.8, 0 if i % 4 == 1 else 50)
                for i in range(len(lens))]
    return lens, prompts, sampling


def run_engine() -> tuple:
    """The main path: 16 mixed-length greedy requests at production width
    through the paged engine, kernel read path. Returns (engine, stats,
    snapshot of the state before the decode step with the most decoding
    slots)."""
    import torch

    from tpumon_torch.loadgen.serving import ServingEngine, sample_tokens
    from tpumon_torch.ops import threefry
    from tpumon_torch.ops.paged_attention import paged_attention

    eng = ServingEngine(cfg=engine_config(), seed=0, device="cuda")
    lens, prompts, _ = engine_traffic()
    max_new = 32
    # The sampler's first calls on the card, timed apart from the traffic:
    # the fused draws' first launches, then the first sample_tokens (the
    # first sort among them).
    zeros = torch.zeros(eng.cfg.slots, eng.cfg.model.vocab, device="cuda")
    first = {}
    for what, fn in (
            ("fused_draws", lambda: threefry.categorical(
                threefry.fold_in(eng._sample_key, eng.rids), zeros)),
            ("sample_tokens", lambda: sample_tokens(
                zeros, eng._sample_key, eng.rids, eng.tok_ctrs, eng.temps,
                eng.topks))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first[what] = time.perf_counter() - t0
    print(f"engine first_call_s={first}", flush=True)
    paged_attention.launches = 0  # count only the main path from here
    threefry.set_launch_counts(0)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    snap, best = None, 0
    while True:
        decoding = [s for s in range(eng.cfg.slots)
                    if eng._slots[s] is not None
                    and eng._prefill_work[s] is None]
        if len(decoding) > best:
            eng._sync_tables()
            best = len(decoding)
            snap = {"pool": {k: t.clone() for k, t in eng.pool.items()},
                    "last": eng.last_tokens.clone(),
                    "pos": eng.positions.clone(),
                    "tables": eng._tables_dev.clone(),
                    "decoding": decoding,
                    "lengths": [eng._host_positions[s] + 1
                                for s in decoding]}
        if not eng.step():
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    draws = threefry.launch_counts()
    steps = eng.decode_steps_total
    print(f"engine prompts={lens} max_new={max_new} decode_steps={steps} "
          f"kernel_launches={launches} threefry_launches={draws} "
          f"wall_s={wall!r}", flush=True)
    bad = [r.rid for r in reqs
           if r.status != "completed" or len(r.output) != max_new + 1]
    if bad:
        fail(f"requests {bad} did not complete with {max_new + 1} tokens")
    if launches != eng.cfg.model.n_layers * steps or steps == 0:
        fail(f"kernel launches {launches} != n_layers x decode steps "
             f"({eng.cfg.model.n_layers} x {steps})")
    check_sampler_draws(draws, steps + len(reqs), "engine")
    stats = {"wall_s": wall, "tokens": eng.tokens_total, "steps": steps,
             "launches": launches, "threefry": draws}
    return eng, stats, snap


def check_sampler_draws(draws: dict, samples: int, label: str) -> None:
    """The fused draws of ``samples`` sample_tokens calls: one categorical
    and two key launches each, no other draw."""
    want = {"threefry_keys": 2 * samples, "threefry_draw": 0,
            "threefry_categorical": samples}
    if draws != want or samples == 0:
        fail(f"{label}: threefry launches {draws} != {want} for {samples} "
             f"sampled tokens")


def compare_paths(eng, snap) -> None:
    """One decode step from the snapshot through the kernel path and the
    gather path, in bf16 and in f32."""
    import torch

    from tpumon_torch.loadgen.model import map_params
    from tpumon_torch.loadgen.paged_kv import paged_decode_step

    rows = snap["decoding"]
    print(f"compare_state decoding_slots={len(rows)} "
          f"lengths={snap['lengths']}", flush=True)
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        params = map_params(eng.params, lambda t: t.to(tdt))
        logits = {}
        for path in ("kernel", "gather"):
            pool = {k: t.to(tdt, copy=True) for k, t in snap["pool"].items()}
            logits[path] = paged_decode_step(
                engine_config(path, dtype), params, pool, snap["last"],
                snap["pos"], snap["tables"])[rows]
            del pool
        torch.cuda.synchronize()
        lk, lg = logits["kernel"], logits["gather"]
        finite = bool(torch.isfinite(lk).all().item())
        err = (lk - lg).abs().max().item()
        agree = int((lk.argmax(-1) == lg.argmax(-1)).sum().item())
        ok = finite and err <= ENGINE_TOL[dtype]
        print(f"engine_kernel_vs_gather {dtype} logits_max_abs_err={err!r} "
              f"tol_abs={ENGINE_TOL[dtype]} greedy_agree={agree}/{len(rows)} "
              f"finite={finite} {'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"engine decode logits, kernel vs gather ({dtype})")


def check_small_engine_against_cpu() -> None:
    """A small f32 engine's greedy streams on the card (kernel path) equal
    the same engine's on the CPU (plain versions), same weights."""
    import torch

    from tpumon_torch.loadgen.model import ModelConfig, init_params
    from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine

    cfg = ServeConfig(model=ModelConfig(vocab=256, d_model=128, n_layers=2,
                                        n_heads=4, n_kv_heads=2, d_ff=256,
                                        max_seq=128, compute_dtype="float32"),
                      slots=3, prefill_len=16, kv_layout="paged",
                      paged_attn="kernel")
    gen = torch.Generator().manual_seed(3)
    params = init_params(cfg.model, gen)
    rng = random.Random(4)
    prompts = [[rng.randrange(256) for _ in range(n)] for n in (5, 40, 17, 64)]
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(cfg=cfg, params=params, device=dev)
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.drain()
        streams[dev] = [r.output for r in reqs]
    same = streams["cpu"] == streams["cuda"]
    print(f"small_engine_cuda_vs_cpu f32 streams_identical={same}", flush=True)
    if not same:
        fail("small engine: card streams differ from the CPU's")


def gather_dense(k_pages, v_pages, table, lengths):
    """The gathered context of a paged call, as SDPA takes it: K and V
    [B, n_kv_heads, S, hd] and the key mask [B, 1, 1, S]."""
    import torch

    nkv, _, ps, hd = k_pages.shape
    b, max_pages = table.shape
    s = max_pages * ps
    idx = table.long()
    k = k_pages[:, idx].reshape(nkv, b, s, hd).transpose(0, 1)
    v = v_pages[:, idx].reshape(nkv, b, s, hd).transpose(0, 1)
    kpos = torch.arange(s, device=k_pages.device)
    return k, v, (kpos[None] < lengths[:, None])[:, None, None, :]


def sdpa_dense(q, k, v, mask):
    """torch's SDPA of one query token per sequence over a gathered
    context (gather_dense)."""
    import torch.nn.functional as F

    out = F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                         enable_gqa=True)
    return out[:, :, 0]


def library_attention(q, k_pages, v_pages, table, lengths):
    """torch's SDPA over the gathered context, gather included: the
    library yardstick for paged_attention (timed here only)."""
    return sdpa_dense(q, *gather_dense(k_pages, v_pages, table, lengths))


PAGED_VARIANT_PAGES = (1, 2, 4, 8, 16, 32)  # 32: one split (the table's length)
PAGED_VARIANT_STAGES = (2, 3, 4)


def time_paged_case(args, label: str, bw: float, peaks: dict) -> dict:
    """Kernel (and the host's time to enqueue it), plain version, gather +
    SDPA and SDPA on the gathered context alone (the cost of a dense
    layout; both library calls are yardsticks, never called by the port)
    at one bf16 case, beside the bound of the bytes these lengths need;
    then the kernel at each (pages per split, ring stages) of
    PAGED_VARIANT_*, as a table."""
    import torch

    from tpumon_torch.ops import paged_attention as pa

    q, k_pages, _, table, lens = args
    b, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    elem = q.element_size()
    rows = int(lens.clamp(0, table.shape[1] * ps).sum().item())
    kv_bytes = 2 * rows * nkv * hd * elem
    io_bytes = 2 * b * nh * hd * elem + table.numel() * 4 + b * 4
    ops = 4 * rows * nh * hd
    bound_ms, bound_by = max(((kv_bytes + io_bytes) / bw * 1e3, "bytes"),
                             (ops / peaks["bfloat16"] * 1e3, "operations"))
    ms = cuda_ms(lambda: pa.paged_attention(*args), reps=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the host's time to enqueue a call
    for _ in range(200):
        pa.paged_attention(*args)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: pa.paged_attention_reference(*args), reps=10)
    lib_ms = cuda_ms(lambda: library_attention(*args), reps=10)
    dense = gather_dense(*args[1:])
    sdpa_ms = cuda_ms(lambda: sdpa_dense(q, *dense), reps=20)
    ref = pa.paged_attention_reference(*args).float()
    lib_err = (library_attention(*args).float() - ref).abs().max().item()
    ker_err = (pa.paged_attention(*args).float() - ref).abs().max().item()
    del dense
    pages = pa.pages_per_split(b, nkv, table.shape[1], ps)
    print(f"time_paged_attention {label} bf16 pages_per_split={pages} "
          f"kernel_ms={ms!r} host_enqueue_us={host_us!r} plain_ms={plain_ms!r} "
          f"library_gather_sdpa_ms={lib_ms!r} library_sdpa_gathered_ms="
          f"{sdpa_ms!r} bound_ms={bound_ms!r} ({bound_by}: "
          f"{kv_bytes + io_bytes} B, {ops} op) kernel_over_bound="
          f"{ms / bound_ms!r} achieved_GBps={(kv_bytes + io_bytes) / ms / 1e6!r} "
          f"kernel_err={ker_err!r} library_err={lib_err!r}", flush=True)
    stages = pa.kernel_config(hd, q.dtype, ps)["default_stages"]
    table_ms, worst = {}, 0.0
    for st in PAGED_VARIANT_STAGES:
        for pg in PAGED_VARIANT_PAGES:
            if pg <= table.shape[1]:
                table_ms[(pg, st)] = cuda_ms(
                    lambda: pa._launch(*args, pages=pg, stages=st), reps=50)
                worst = max(worst, rows_rel_err(
                    pa._launch(*args, pages=pg, stages=st), ref, lens))
    print(f"paged_variants {label} (pages per split x ring stages, µs; the "
          f"rule: {pages} x {stages}) worst rows_rel_err={worst!r} "
          f"tol={PAGED_TOL['bfloat16']}", flush=True)
    if not worst <= PAGED_TOL["bfloat16"]:
        fail(f"a paged kernel variant disagrees with the plain version ({label})")
    for pg in sorted({p for p, _ in table_ms}):
        cells = " ".join(f"{table_ms[(pg, st)] * 1e3:9.2f}"
                         for st in PAGED_VARIANT_STAGES)
        print(f"paged_variants {label} pages={pg:3d} splits="
              f"{-(-table.shape[1] // pg):3d} stages {PAGED_VARIANT_STAGES}: "
              f"{cells}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_kernel(gen, bw: float, peaks: dict) -> dict:
    """The paged kernel's times (time_paged_case) at the production decode
    shape with every table full (4096 rows per sequence), then at
    check_kernel's production lengths; returns the full-table ones."""
    import torch

    from tpumon_torch.ops.paged_attention import paged_attention

    before = paged_attention.launches
    shape = dict(b=16, nh=32, nkv=8, hd=128, ps=128, max_pages=32)
    full = time_paged_case(
        paged_inputs(gen, **shape, lengths=[32 * 128] * 16,
                     dtype=torch.bfloat16),
        "shape=B16/h32/kv8/hd128/page128/len4096", bw, peaks)
    time_paged_case(
        paged_inputs(gen, **shape, lengths=prod_lengths(),
                     dtype=torch.bfloat16),
        "shape=B16/h32/kv8/hd128/page128/prod_lengths", bw, peaks)
    paged_attention.launches = before  # timing launches are not the path's
    return full


def device_busy(fn, reps: int = 5):
    """(device busy ms, wall ms, device kernels) per call of ``fn`` from a
    torch.profiler trace of ``reps`` back-to-back calls; None when the
    trace holds no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return busy_us / 1e3 / reps, wall_ms / reps, len(kernels) / reps


def time_engine(eng, snap, stats: dict) -> None:
    """Decode-step times on the snapshot state, kernel and gather paths,
    and where the kernel path's step time goes."""
    import torch

    from tpumon_torch.loadgen.paged_kv import paged_decode_step
    from tpumon_torch.ops.paged_attention import _launch, paged_attention
    from tpumon_torch.tracing import quantiles

    before = paged_attention.launches
    step_ms = {}
    for path in ("kernel", "gather"):
        cfg = engine_config(path)
        pool = {k: t.clone() for k, t in snap["pool"].items()}
        step_ms[path] = cuda_ms(lambda: paged_decode_step(
            cfg, eng.params, pool, snap["last"], snap["pos"],
            snap["tables"]), reps=10)
        del pool
    # Host time to enqueue one kernel-path step (no sync inside).
    cfg = engine_config("kernel")
    pool = {k: t.clone() for k, t in snap["pool"].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        paged_decode_step(cfg, eng.params, pool, snap["last"], snap["pos"],
                          snap["tables"])
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    busy = device_busy(lambda: paged_decode_step(
        cfg, eng.params, pool, snap["last"], snap["pos"], snap["tables"]))
    # The step's two attention calls alone, on the snapshot's tables.
    m = cfg.model
    q = torch.randn(16, m.n_heads, m.head_dim, device="cuda",
                    dtype=torch.bfloat16)
    lengths = snap["pos"] + 1
    attn_ms = m.n_layers * cuda_ms(lambda: paged_attention(
        q, pool["k"][0], pool["v"][0], snap["tables"], lengths), reps=20)
    # The same two calls at other pages per split (32: one split), in two
    # turns, the second in reverse order.
    attn_pages = {pg: [] for pg in PAGED_VARIANT_PAGES}
    for turn in (PAGED_VARIANT_PAGES, PAGED_VARIANT_PAGES[::-1]):
        for pg in turn:
            attn_pages[pg].append(m.n_layers * cuda_ms(lambda: _launch(
                q, pool["k"][0], pool["v"][0], snap["tables"], lengths,
                pages=pg), reps=50))
    print(f"engine_attention_variants pages_per_split -> ms of the step's "
          f"{m.n_layers} calls, two turns: {attn_pages}", flush=True)
    # The step's projections alone: 7 per layer plus the LM head.
    x = torch.randn(16, m.d_model, device="cuda", dtype=torch.bfloat16)
    xf = torch.randn(16, m.d_ff, device="cuda", dtype=torch.bfloat16)

    def projections():
        for layer in eng.params["layers"]:
            for w in ("wq", "wk", "wv", "wo", "w_gate", "w_up"):
                x @ layer[w]
            xf @ layer["w_down"]
        x @ eng.params["lm_head"]

    mm_ms = cuda_ms(projections, reps=20)
    paged_attention.launches = before
    ttft = quantiles([t * 1e3 for t in eng._ttft_recent])
    print(f"engine_step decoding_slots={len(snap['decoding'])} "
          f"kernel_step_ms={step_ms['kernel']!r} "
          f"gather_step_ms={step_ms['gather']!r} "
          f"host_enqueue_ms={host_ms!r} attention_kernel_ms={attn_ms!r} "
          f"projections_ms={mm_ms!r} "
          f"other_ms={step_ms['kernel'] - attn_ms - mm_ms!r}", flush=True)
    if busy is None:
        print("engine_step_trace device_busy=not measured (the profiler "
              "recorded no device activity)", flush=True)
    else:
        busy_ms, wall_ms, kernels = busy
        print(f"engine_step_trace wall_ms={wall_ms!r} device_busy_ms="
              f"{busy_ms!r} device_idle_share={1 - busy_ms / wall_ms!r} "
              f"device_kernels_per_step={kernels!r}", flush=True)
    print(f"engine_run tokens={stats['tokens']} wall_s={stats['wall_s']!r} "
          f"tokens_per_s={stats['tokens'] / stats['wall_s']!r} "
          f"ttft_p50_ms={ttft[0]!r} ttft_p95_ms={ttft[1]!r}", flush=True)


def check_server(eng) -> None:
    """The engine behind its HTTP server, stepped by the arrival pump: a
    /generate call answers with the greedy tokens a direct submission
    gives, and /metrics serves the families the monitor scrapes."""
    import threading

    from tpumon_torch.loadgen.serving import ArrivalPump, start_metrics_server

    prompt = [random.Random(5).randrange(4096) for _ in range(200)]
    stop = threading.Event()
    pump = threading.Thread(target=ArrivalPump(eng, []).run, args=(stop,))
    server, port = start_metrics_server(eng, port=0)
    pump.start()
    try:
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(
                f"{url}/generate?prompt={','.join(map(str, prompt))}"
                f"&max_new=4", timeout=120) as resp:
            served = json.loads(resp.read())["tokens"]
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as resp:
            text = resp.read().decode()
    finally:
        stop.set()
        pump.join(timeout=60)
        server.shutdown()
        server.server_close()
    direct = eng.submit(prompt, max_new=4)
    eng.drain()
    print(f"server generate_tokens={served} direct_tokens={direct.output}",
          flush=True)
    if pump.is_alive() or served != direct.output or len(served) != 5:
        fail("/generate did not answer with the engine's greedy tokens")
    want = ("jetstream_generate_tokens", "jetstream_request_count",
            "tpumon_serving_requests_completed",
            "tpumon_serving_decode_steps", "tpumon_serving_ttft_p50_ms",
            "tpumon_serving_tpot_p95_ms", "tpumon_serving_kv_pages_total",
            "tpumon_serving_weight_bytes",
            "jetstream_time_to_first_token_bucket")
    missing = [f for f in want if f not in text]
    print(f"metrics families={len([ln for ln in text.splitlines() if ln.startswith('# TYPE')])} "
          f"missing={missing}", flush=True)
    if missing:
        fail(f"/metrics lacks {missing}")


# --- the training path: causal flash attention and the trainer -----------

FLASH_KERNELS = ("flash_attention_tri_fwd", "flash_attention_tri_bwd_dq",
                 "flash_attention_tri_bwd_dkv")
# Kernel vs plain version. out, dq, dk and dv are held to tile_rel_err,
# the worst ||got - want|| / ||want|| over 64-row tiles: causal outputs
# shrink along the sequence (row i of out has a spread near sqrt(e / i)
# at random inputs), so an absolute limit fitted to the early rows would
# pass a fault on the late ones. lse is f32 either way and of order
# log T: max abs, 10x the kernels' 1.9e-6. Each other limit lies between
# the kernels' worst reading over the checked shapes and the weakest
# planted fault's, at least 1.6x from each (PERF.md, PR 2). f32 sums in
# another order: kernels 1.5e-6, faults 7.2e-2. bf16 out: P rounds to
# bf16 at other running maxima than the plain version's one block per
# row: 2.7e-3 against 7.3e-2. bf16 gradients: the kernels round dS and P
# where the plain versions do, against 2.8e-3 for P and dS left
# unrounded; where a dominant entry's f32 value lies a hair from a bf16
# rounding point, any other exact computation rounds it the other way, so
# the reading depends on the draw: 1.93e-3 on flash_variants' draw (an
# NVIDIA H100 80GB HBM3 at 700 W), where the JAX reference's own Pallas
# backward reads 1.90e-3 against the same plain version (tests/
# flash_spread.py on the slice check_flash_grad_spread saves). 2.3e-3 lies
# between, 1.2x from each.
FLASH_TOL = {"float32": {"out": 1e-4, "grad": 1e-4, "lse": 2e-5},
             "bfloat16": {"out": 1.5e-2, "grad": 2.3e-3, "lse": 2e-5}}
FLASH_TILE = 64  # rows of the tiles tile_rel_err runs over (T % 64 == 0)
# The tiles a kernel's planted faults are modelled at: the bf16 forward's
# 128-row q and k tiles (csrc/flash_fwd.cuh); the backward kernels' (csrc/
# flash_attention_tri_bwd.cu) owned tile (128 rows, two warpgroups of 64)
# and streamed tile (64 rows: dQ's k tiles, dK/dV's q tiles).
FWD_TILE = 128
BWD_TILES = {"flash_attention_tri_bwd_dq": (128, 64),
             "flash_attention_tri_bwd_dkv": (128, 64)}
# Faults a tiled flash kernel can plausibly carry, modelled in plain
# torch (faulty_plain, faulty_grads) and read against the plain version
# under the limits above; a fault is caught when one output of its kernel
# reads over its limit. A fault is required only where it applies
# (fault_applies). "unrounded" (P and dS kept in f32 before their bf16
# products) is required of the backward kernels only: in the forward it
# reads at the kernel's own level (one bf16 rounding of P), so no limit
# separates it there; it is printed all the same.
FWD_FAULTS = ("diag_unmasked", "last_diag_dropped", "no_rescale",
              "unrounded", "stale_stage", "wg1_mask_offset")
BWD_FAULTS = ("diag_unmasked", "last_diag_dropped", "no_d", "unrounded",
              "stale_stage", "wg1_mask_offset", "row_stats_offset")
# T = 64 x odd: the forward's last 128-row q and k tiles reach past T.
ODD_T_CASES = [(f"hd{hd}_t{t}", 6, t, hd) for hd in (64, 128)
               for t in (192, 320)]
FLASH_OUTPUTS = {"flash_attention_tri_fwd": ("out",),
                 "flash_attention_tri_bwd_dq": ("dq",),
                 "flash_attention_tri_bwd_dkv": ("dk", "dv")}


def flash_limit(kernel: str, dtype: str) -> float:
    """The tile_rel_err limit of a flash kernel's outputs."""
    return FLASH_TOL[dtype]["out" if kernel.endswith("fwd") else "grad"]


def fault_required(kernel: str, fault: str) -> bool:
    """Whether the limit must catch this planted fault (see above)."""
    return not (fault == "unrounded" and kernel.endswith("fwd"))


def fault_applies(fault: str, t: int, causal: bool = True,
                  kernel: str = "flash_attention_tri_fwd") -> bool:
    """Whether a fault of ``kernel`` changes anything at sequence length
    t: the mask faults need the causal mask, the tile-to-tile faults a
    second streamed tile, the second warpgroup's a second half of an
    owned tile, the tail fault a last k tile that reaches past T."""
    if kernel.endswith("fwd"):
        own = stream = FWD_TILE
    else:
        own, stream = BWD_TILES[kernel]
    if fault in ("diag_unmasked", "wg1_mask_offset"):
        return causal and (fault == "diag_unmasked" or t > own // 2)
    if fault in ("no_rescale", "stale_stage", "row_stats_offset"):
        return t > stream
    if fault == "tail_keys_unmasked":
        return not causal and t % FWD_TILE != 0
    return True


# One train step, flash path vs naive path on the same params and tokens:
# loss max abs, grads relative L2 per param. At random init the loss is
# near ln(vocab) whatever attention computes, so the gradients carry the
# check and the loss limit only bounds drift. bf16 at 6 layers: the naive
# path rounds normalised probabilities to bf16 and the flash path
# unnormalised ones per key tile, and six layers of bf16 activations
# carry the difference: loss 2e-3 (measured 1.6e-4) and grads 5e-2
# (measured 2.9e-2). f32 at 2 layers: summation order only, 1e-4 each.
STEP_TOL = {"bfloat16": (2e-3, 5e-2), "float32": (1e-4, 1e-4)}
TRAIN_STEPS = 4
MOE_TRAIN_STEPS = 3
INDUCTION_STEPS = 2000  # bench.py's train_induction steps on the chip
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"


def flash_counts() -> dict:
    from tpumon_torch.ops import flash_attention as fa

    return {n: getattr(fa, n).launches for n in FLASH_KERNELS}


def set_flash_counts(counts: dict) -> None:
    from tpumon_torch.ops import flash_attention as fa

    for n in FLASH_KERNELS:
        getattr(fa, n).launches = counts[n]


def flash_inputs(gen, bh, t, hd, dtype):
    """q, k, v, dout at random; lse and D from the plain forward."""
    import torch

    from tpumon_torch.ops.flash_attention import (
        flash_attention_tri_fwd_reference,
    )

    q, k, v, g = (torch.randn(bh, t, hd, generator=gen,
                              device=gen.device).to(dtype) for _ in range(4))
    out, lse = flash_attention_tri_fwd_reference(q, k, v)
    dvec = (g.float() * out.float()).sum(-1)
    return q, k, v, g, out, lse, dvec


def tile_rel_err(got, want) -> float:
    """The worst relative error over 64-row tiles of [BH, T, D] tensors:
    max over (bh, tile) of ||got - want|| / ||want||."""
    bh, t, _ = want.shape
    a, b = (x.float().reshape(bh, t // FLASH_TILE, -1) for x in (got, want))
    return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max(
        ).item()


def faulty_plain(q, k, v, fault: str | None, causal: bool = True,
                 tile: int = FWD_TILE):
    """The plain forward's out, with the plain version's numerics,
    carrying one fault of a forward kernel that tiles T by ``tile`` rows
    (None: no fault); ``causal=False`` drops the causal mask (the
    rectangular forward). The keys are padded with zeros to whole tiles,
    as TMA fills a last tile that reaches past T; no fault but
    tail_keys_unmasked lets a row see them.

    - diag_unmasked: the diagonal tile is not masked, so a row also sees
      the later keys of its own tile;
    - last_diag_dropped: the last q tile skips its diagonal k tile;
    - no_rescale: the accumulator is not rescaled when the running max
      rises from one k tile to the next;
    - stale_stage: each k tile's P V reads the previous tile's V (a ring
      stage used before its load landed);
    - tail_keys_unmasked: without the causal mask, the zero keys past T
      in a last tile that reaches past T are left in the softmax;
    - wg1_mask_offset: the diagonal tile's mask for the second 64-row
      half of each q tile (the second warpgroup) uses the first half's
      row offset, so those rows lose 64 keys;
    - unrounded: P enters P V unrounded.
    """
    import torch

    bh, t, d = q.shape
    scale = 1.0 / d**0.5
    n = -(-t // tile) * tile  # keys padded to whole tiles
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(n, device=q.device)[None, :]
    real = j < t
    mask = ((i >= j) | (not causal)) & real
    diag = (i // tile) == (j // tile)
    if fault == "diag_unmasked":
        mask = mask | (diag & real)
    elif fault == "last_diag_dropped":
        mask = mask & ~(diag & (i // tile == (t - 1) // tile))
    elif fault == "tail_keys_unmasked":
        mask = mask | ~real
    elif fault == "wg1_mask_offset":
        half = tile // 2
        wg1 = (i % tile >= half) & (j % tile > i % tile - half)
        mask = mask & ~(diag & wg1)
    out = torch.empty_like(q)
    step = max(1, (1 << 26) // (t * n))
    pad = torch.nn.functional.pad
    for lo in range(0, bh, step):
        c = slice(lo, lo + step)
        qc, kc, vc = (x[c].float() for x in (q, k, v))
        kp, vp = (pad(x, (0, 0, 0, n - t)) for x in (kc, vc))
        s = torch.where(mask, torch.matmul(qc, kp.transpose(1, 2)) * scale,
                        -1e30)
        m = s.amax(-1, keepdim=True)
        el = torch.exp(s - m).sum(-1, keepdim=True)
        if fault == "no_rescale":  # each k tile weighed at its running max
            run = s.unflatten(-1, (-1, tile)).amax(-1).cummax(-1)[0]
            p = torch.exp(s - run.repeat_interleave(tile, -1))
        else:
            p = torch.exp(s - m)
        if fault == "stale_stage":
            vp = torch.cat((vp[:, :tile], vp[:, :-tile]), 1)
        if fault != "unrounded":
            p = p.to(q.dtype).float()
        out[c] = (torch.matmul(p, vp) / el).to(q.dtype)
        del s, p
    return out


def faulty_grads(q, k, v, g, lse, dvec, fault: str | None,
                 kernel: str) -> dict:
    """The plain backward's outputs of ``kernel`` (dq, or dk and dv), with
    the plain versions' numerics and the true lse and D, carrying one
    fault of that kernel at its tiles (BWD_TILES: a CTA owns ``own`` rows,
    two warpgroups of own / 2, and streams ``stream``-row tiles of the
    other side; dQ owns queries and streams keys, dK/dV the reverse).
    None: no fault. A warpgroup masks its diagonal block, the own / 2
    rows of its own side against the same rows of the other.

    - diag_unmasked: the diagonal blocks are not masked;
    - last_diag_dropped: the last q rows skip their diagonal block (for
      dK/dV: the last keys get nothing from it);
    - no_d: dS = P * dP * scale, without subtracting D;
    - unrounded: P and dS enter their products unrounded;
    - stale_stage: each streamed tile's products read the previous
      tile's stage (dQ: K and V; dK/dV: Q, dO, lse and D), the mask
      taken at the true positions;
    - wg1_mask_offset: the second warpgroup masks its diagonal block with
      the first's row offset: dQ's later q rows lose the whole block,
      dK/dV's later keys see the queries before them in it;
    - row_stats_offset: each q tile's lse and D are read one streamed
      tile later (the last tile reads its own).
    """
    import torch

    bh, t, d = q.shape
    scale = 1.0 / d**0.5
    own, stream = BWD_TILES[kernel]
    half = own // 2
    dq_kernel = kernel.endswith("dq")

    def shifted(x):  # each streamed tile takes the previous one's rows
        return torch.cat((x[:, :stream], x[:, :-stream]), 1)

    i = torch.arange(t, device=q.device)[:, None]  # queries
    j = torch.arange(t, device=q.device)[None, :]  # keys
    mask = i >= j
    diag = (i // half) == (j // half)
    if fault == "diag_unmasked":
        mask = mask | diag
    elif fault == "last_diag_dropped":
        mask = mask & ~(diag & (i // half == (t - 1) // half))
    elif fault == "wg1_mask_offset" and dq_kernel:
        mask = mask & ~(diag & (i % own >= half))
    elif fault == "wg1_mask_offset":
        mask = mask | (diag & (j % own >= half))
    if fault == "stale_stage" and dq_kernel:
        k, v = shifted(k), shifted(v)
    elif fault == "stale_stage":
        q, g, lse, dvec = (shifted(x) for x in (q, g, lse, dvec))
    elif fault == "row_stats_offset":
        lse, dvec = (torch.cat((x[:, stream:], x[:, -stream:]), 1)
                     for x in (lse, dvec))

    def rnd(x):
        return x if fault == "unrounded" else x.to(q.dtype).float()

    outs = ("dq",) if dq_kernel else ("dk", "dv")
    got = {name: torch.empty_like(q) for name in outs}
    step = max(1, (1 << 26) // (t * t))
    for lo in range(0, bh, step):
        c = slice(lo, lo + step)
        qc, kc, vc, gc = (x[c].float() for x in (q, k, v, g))
        s = torch.matmul(qc, kc.transpose(1, 2)) * scale
        p = torch.where(mask, torch.exp(s - lse[c][..., None]), 0.0)
        dp = torch.matmul(gc, vc.transpose(1, 2))
        ds = p * (dp - (0.0 if fault == "no_d" else dvec[c][..., None])
                  ) * scale
        if dq_kernel:
            got["dq"][c] = torch.matmul(rnd(ds), kc).to(q.dtype)
        else:
            got["dk"][c] = torch.matmul(rnd(ds).transpose(1, 2), qc).to(
                q.dtype)
            got["dv"][c] = torch.matmul(rnd(p).transpose(1, 2), gc).to(
                q.dtype)
        del s, p, dp, ds
    return got


def fault_readings(q, k, v, g, lse, dvec, want: dict) -> dict:
    """{kernel: {fault: the largest tile_rel_err over the kernel's
    outputs}} for every planted fault that applies at this T, each
    modelled at its kernel's tiles; "unrounded" only where the dtype
    rounds (in f32 it is no fault)."""
    import torch

    t = q.shape[1]
    rounds = q.dtype != torch.float32
    got = {}
    for kernel, outs in FLASH_OUTPUTS.items():
        fwd = kernel.endswith("fwd")
        got[kernel] = {}
        for f in FWD_FAULTS if fwd else BWD_FAULTS:
            if (f == "unrounded" and not rounds) or not fault_applies(
                    f, t, kernel=kernel):
                continue
            faulty = ({"out": faulty_plain(q, k, v, f)} if fwd else
                      faulty_grads(q, k, v, g, lse, dvec, f, kernel))
            got[kernel][f] = max(tile_rel_err(faulty[o], want[o])
                                 for o in outs)
    return got


def check_flash_kernels(gen) -> dict:
    """Each flash kernel against its plain version, with the planted
    faults' readings beside; returns the worst max abs error per kernel at
    the production shape in bf16."""
    import torch

    from tpumon_torch.ops import flash_attention as fa

    cases = [("production", 128, 1024, 128), ("seq8k", 16, 8192, 128),
             ("hd64_t384", 6, 384, 64), ("hd32_t128", 6, 128, 32),
             ("hd64_t128", 6, 128, 64), ("hd32_t384", 6, 384, 32),
             *ODD_T_CASES]
    worst = {}
    for name, bh, t, hd in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            tol = FLASH_TOL[dname]
            q, k, v, g, want_out, want_lse, dvec = flash_inputs(
                gen, bh, t, hd, dtype)
            got = {}
            # block 64: the padding contract T % 64 == 0 (T 192, 320)
            got["out"], got["lse"] = fa.flash_attention_tri_fwd(
                q, k, v, block=64)
            got["dq"] = fa.flash_attention_tri_bwd_dq(q, k, v, g, want_lse,
                                                      dvec, block=64)
            got["dk"], got["dv"] = fa.flash_attention_tri_bwd_dkv(
                q, k, v, g, want_lse, dvec, block=64)
            torch.cuda.synchronize()
            want = {"out": want_out, "lse": want_lse}
            want["dq"] = fa.flash_attention_tri_bwd_dq_reference(
                q, k, v, g, want_lse, dvec)
            want["dk"], want["dv"] = fa.flash_attention_tri_bwd_dkv_reference(
                q, k, v, g, want_lse, dvec)
            finite = all(bool(torch.isfinite(x).all().item())
                         for x in got.values())
            abs_err = {key: (got[key].float() - want[key].float()).abs().max(
                ).item() for key in got}
            rel = {o: tile_rel_err(got[o], want[o])
                   for outs in FLASH_OUTPUTS.values() for o in outs}
            ok = finite and abs_err["lse"] <= tol["lse"] and all(
                rel[o] <= flash_limit(kern, dname)
                for kern, outs in FLASH_OUTPUTS.items() for o in outs)
            faults = fault_readings(q, k, v, g, want_lse, dvec, want)
            missed = [f"{kern}:{f}" for kern, fs in faults.items()
                      for f, r in fs.items() if fault_required(kern, f)
                      and not r > flash_limit(kern, dname)]
            print(f"flash_kernel_vs_plain {name} BH{bh}/T{t}/hd{hd} {dname} "
                  f"tile_rel_err={rel} lse_max_abs_err={abs_err['lse']!r} "
                  f"max_abs_err={abs_err} tol={tol} finite={finite} "
                  f"{'ok' if ok else 'MISS'}", flush=True)
            print(f"flash_planted_faults {name} {dname} tile_rel_err="
                  f"{faults} tol={tol} missed={missed}", flush=True)
            if not ok:
                fail(f"flash kernels disagree with their plain versions "
                     f"({name}, {dname})")
            if missed:
                fail(f"the limits {tol} pass planted faults {missed} "
                     f"({name}, {dname})")
            if name == "production" and dtype == torch.bfloat16:
                worst = {
                    "flash_attention_tri_fwd": max(abs_err["out"],
                                                   abs_err["lse"]),
                    "flash_attention_tri_bwd_dq": abs_err["dq"],
                    "flash_attention_tri_bwd_dkv": max(abs_err["dk"],
                                                       abs_err["dv"])}
            del q, k, v, g, want_out, want_lse, dvec, got, want
            torch.cuda.empty_cache()
    return worst


# The bf16 gradients' spread on more draws, at phase 7's production shape:
# the draws tests/flash_spread.py gives the JAX reference's own Pallas
# backward on the CPU (numpy's standard normals from each seed), so each
# card reading has the reference kernel's on the same inputs, and the
# draw of tpumon_torch/ops/flash_variants.py --backward, which read dQ at
# 1.93e-3. Each case's worst (output, bh) slice goes to SPREAD_DIR with
# the kernel's gradients there, for tests/flash_spread.py --slices.
FLASH_SPREAD_SEEDS = range(8)
SPREAD_DIR = Path(__file__).resolve().parent / "build" / "flash_spread"


def spread_cases():
    """(label, q, k, v, dO) on the card, one case at a time."""
    import numpy as np
    import torch

    bh, t, hd = 128, 1024, 128
    for seed in FLASH_SPREAD_SEEDS:
        rng = np.random.default_rng(seed)
        yield (f"seed{seed}", *(torch.from_numpy(rng.standard_normal(
            (bh, t, hd), np.float32)).to("cuda", torch.bfloat16)
            for _ in range(4)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    yield ("variants_draw", *(torch.randn(bh, t, hd, generator=gen,
                                          device="cuda").bfloat16()
                              for _ in range(4)))


def check_flash_grad_spread() -> None:
    """Each bf16 gradient kernel against its plain version on
    spread_cases(), under phase 7's limit; saves each case's worst slice."""
    import numpy as np
    import torch

    from tpumon_torch.ops import flash_attention as fa

    def bits(x):
        return x.contiguous().view(torch.int16).cpu().numpy()

    launches = flash_counts()
    SPREAD_DIR.mkdir(parents=True, exist_ok=True)
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    t0 = time.perf_counter()
    for label, q, k, v, g in spread_cases():
        out, lse = fa.flash_attention_tri_fwd_reference(q, k, v)
        dvec = (g.float() * out.float()).sum(-1)
        got = dict(zip(("dk", "dv"), fa.flash_attention_tri_bwd_dkv(
            q, k, v, g, lse, dvec, block=64)))
        got["dq"] = fa.flash_attention_tri_bwd_dq(q, k, v, g, lse, dvec,
                                                  block=64)
        want = dict(zip(("dk", "dv"), fa.flash_attention_tri_bwd_dkv_reference(
            q, k, v, g, lse, dvec)))
        want["dq"] = fa.flash_attention_tri_bwd_dq_reference(q, k, v, g, lse,
                                                             dvec)
        per_bh = {}
        for o in ("dq", "dk", "dv"):
            a, b = (x.float().reshape(q.shape[0], -1, FLASH_TILE * q.shape[2])
                    for x in (got[o], want[o]))
            per_bh[o] = ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(
                1e-30)).amax(dim=-1)
        rel = {o: float(r.max()) for o, r in per_bh.items()}
        o_max = max(rel, key=rel.get)
        b = int(per_bh[o_max].argmax())
        np.savez(SPREAD_DIR / f"{label}.npz", output=o_max, bh=b,
                 reading=rel[o_max],
                 **{n: bits(x[b:b + 1]) for n, x in (
                     ("q", q), ("k", k), ("v", v), ("dout", g), ("out", out),
                     ("dq", got["dq"]), ("dk", got["dk"]),
                     ("dv", got["dv"]))},
                 lse=lse[b:b + 1].cpu().numpy(),
                 dvec=dvec[b:b + 1].cpu().numpy())
        print(f"flash_grad_spread BH{q.shape[0]}/T{q.shape[1]}/hd{q.shape[2]} "
              f"bfloat16 {label} tile_rel_err={rel} worst_slice=({o_max}, bh "
              f"{b}) limit={FLASH_TOL['bfloat16']['grad']}", flush=True)
        for o, r in rel.items():
            worst[o] = max(worst[o], r)
        del q, k, v, g, out, lse, dvec, got, want
    set_flash_counts(launches)  # a check's launches are not the paths'
    print(f"flash_grad_spread worst={worst} slices={SPREAD_DIR} wall_s="
          f"{time.perf_counter() - t0!r}", flush=True)
    over = {o: r for o, r in worst.items()
            if not r <= FLASH_TOL["bfloat16"]["grad"]}
    if over:
        fail(f"bf16 flash gradients over their limit on more draws: {over}")


def train_model(dtype="bfloat16", **over):
    """bench.py's production training width (d2048/L6, flash, block 512)."""
    from tpumon_torch.loadgen.model import ModelConfig

    cfg = dict(vocab=4096, d_model=2048, n_layers=6, n_heads=16,
               n_kv_heads=16, d_ff=8192, max_seq=1024, attention="flash",
               attn_block_k=512, compute_dtype=dtype)
    cfg.update(over)
    return ModelConfig(**cfg)


def run_trainer() -> dict:
    """The main path: run_train at production width on the card, with
    TrainMetrics and a checkpoint at the last step. Each flash kernel must
    launch n_layers x steps times."""
    import shutil

    import torch

    from tpumon_torch.loadgen.train import (
        TrainConfig,
        TrainMetrics,
        detect_peak_flops,
        flops_per_token,
        run_train,
    )

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    cfg = TrainConfig(model=train_model(), steps=TRAIN_STEPS, batch=8,
                      seq=1024, ckpt_dir=str(CKPT_DIR),
                      ckpt_every=TRAIN_STEPS)
    metrics = TrainMetrics(flops_per_token=flops_per_token(cfg.model, cfg.seq),
                           peak_flops=detect_peak_flops())
    torch.cuda.synchronize()
    set_flash_counts(dict.fromkeys(FLASH_KERNELS, 0))  # the main path only
    t0 = time.perf_counter()
    out = run_train(cfg, "cuda", metrics=metrics)
    wall = time.perf_counter() - t0
    launches = flash_counts()
    want = cfg.model.n_layers * cfg.steps
    print(f"trainer steps={cfg.steps} loss={out['loss']!r} "
          f"metrics_loss={metrics.loss!r} launches={launches} "
          f"want={want} wall_s={wall!r} (checkpoint save included) "
          f"tokens_per_s={out['tokens_per_sec']!r} "
          f"mfu_pct={metrics.mfu_pct!r}", flush=True)
    if not (out["loss"] is not None and torch.isfinite(
            torch.tensor(out["loss"])) and metrics.loss == out["loss"]):
        fail("the trainer's loss is not finite")
    if any(n != want for n in launches.values()):
        fail(f"flash launches {launches} != n_layers x steps ({want})")
    return {"launches": launches, "metrics": metrics, "params": out["params"],
            "cfg": cfg}


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30)).item()


def compare_flash_naive() -> None:
    """One step's loss and grads, flash path vs naive path, on the same
    params and tokens: bf16 at production width, f32 at 2 layers."""
    import dataclasses

    import torch

    from tpumon_torch.loadgen.model import init_params, value_and_grad

    before = flash_counts()
    for dtype, layers in (("bfloat16", 6), ("float32", 2)):
        cfg = train_model(dtype, n_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(11)
        params = init_params(cfg, gen)
        tokens = torch.randint(0, cfg.vocab, (8, 1024), generator=gen,
                               device="cuda", dtype=torch.int32)
        loss, grads = {}, {}
        for att in ("flash", "naive"):
            loss[att], grads[att] = value_and_grad(
                dataclasses.replace(cfg, attention=att), params, tokens)
            torch.cuda.synchronize()
        dl = abs(float(loss["flash"]) - float(loss["naive"]))
        dg = max(rel_l2(a, b) for a, b in zip(grads["flash"], grads["naive"]))
        finite = all(bool(torch.isfinite(g).all().item())
                     for g in grads["flash"])
        tl, tg = STEP_TOL[dtype]
        ok = finite and dl <= tl and dg <= tg
        print(f"train_step_flash_vs_naive {dtype} layers={layers} "
              f"loss_flash={float(loss['flash'])!r} "
              f"loss_naive={float(loss['naive'])!r} loss_abs_err={dl!r} "
              f"grad_max_rel_l2={dg!r} tol=({tl}, {tg}) finite={finite} "
              f"{'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            fail(f"one train step, flash vs naive ({dtype})")
        del params, grads
        torch.cuda.empty_cache()
    set_flash_counts(before)


def check_small_trainer_against_cpu() -> None:
    """A small f32 trainer (flash, hd 32, T 100 padded to 128): three SGD
    steps on the card (kernels) give the CPU's losses (plain versions),
    same weights and tokens."""
    import torch

    from tpumon_torch.loadgen.model import (
        ModelConfig,
        init_params,
        map_params,
        sgd_train_step,
    )
    from tpumon_torch.loadgen.train import TrainConfig, synthetic_batch

    before = flash_counts()
    cfg = TrainConfig(model=ModelConfig(
        vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq=128, compute_dtype="float32", attention="flash",
        attn_block_k=128), batch=2, seq=101, lr=0.05)
    init = init_params(cfg.model, torch.Generator().manual_seed(3))
    losses = {}
    for dev in ("cpu", "cuda"):
        params = map_params(init, lambda t: t.to(dev, copy=True))
        losses[dev] = [float(sgd_train_step(
            cfg.model, params, synthetic_batch(cfg, step, dev),
            lr=cfg.lr)[1]) for step in range(3)]
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    launched = flash_counts()["flash_attention_tri_fwd"] - before[
        "flash_attention_tri_fwd"]
    ok = err <= 1e-5 and launched == 3 * cfg.model.n_layers
    print(f"small_trainer_cuda_vs_cpu f32 losses_cpu={losses['cpu']} "
          f"losses_cuda={losses['cuda']} max_abs_err={err!r} tol=1e-05 "
          f"fwd_launches={launched} {'ok' if ok else 'MISS'}", flush=True)
    set_flash_counts(before)
    if not ok:
        fail("small trainer: card losses differ from the CPU's")


def check_served_checkpoint(trained: dict) -> None:
    """The port's serving engine serves the trainer's last checkpoint."""
    import shutil

    import torch

    from tpumon_torch.loadgen.model import param_leaves
    from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine

    cfg = trained["cfg"]
    eng = ServingEngine(cfg=ServeConfig(model=cfg.model, slots=2,
                                        prefill_len=128, kv_layout="paged",
                                        paged_attn="kernel"),
                        ckpt_dir=str(CKPT_DIR), device="cuda")
    same = all(torch.equal(a.to(b.dtype), b) for a, b in zip(
        param_leaves(trained["params"]), param_leaves(eng.params)))
    prompt = [random.Random(6).randrange(cfg.model.vocab) for _ in range(40)]
    req = eng.submit(prompt, max_new=4)
    eng.drain()
    print(f"serve_checkpoint ckpt_step={eng.ckpt_step} "
          f"weights_equal_trained={same} tokens={req.output}", flush=True)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if (eng.ckpt_step != cfg.steps - 1 or not same
            or req.status != "completed" or len(req.output) != 5):
        fail("the serving engine did not serve the trainer's checkpoint")


# The library yardstick's backends, pinned one at a time (torch.nn.
# attention.SDPBackend names), so that each time names the kernels it
# ran; the faster is the library time.
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION")


def library_flash(q, k, v, dout, backend: str, causal: bool = True,
                  batch: int = 8):
    """torch's SDPA under one pinned backend on the folded [BH, T, D]
    inputs viewed as [batch, BH / batch, T, D] (batch 8 of the training
    shape): the library yardstick (timed here only). Returns (forward
    call, backward call or None without dout): the backward reruns
    autograd.grad of one forward recorded under the backend, so its time
    holds that backend's backward kernels and nothing of autograd's
    set-up. Raises RuntimeError where the backend does not take these
    inputs on this card."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    pinned = getattr(SDPBackend, backend)
    bh, t, d = q.shape
    shape = (batch, bh // batch, t, d)
    qs, ks, vs = (x.view(shape) for x in (q, k, v))

    def fwd():
        with sdpa_kernel(pinned):
            return F.scaled_dot_product_attention(qs, ks, vs,
                                                  is_causal=causal)

    fwd()
    if dout is None:
        return fwd, None
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (qs, ks, vs))
    with sdpa_kernel(pinned):
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    g = dout.view(shape)
    return fwd, lambda: torch.autograd.grad(out, (qg, kg, vg), g,
                                            retain_graph=True)


def time_sdpa(q, k, v, dout, label: str, causal: bool = True,
              batch: int = 8, reps: int = 50) -> dict:
    """{"fwd": {backend: ms}, "bwd": {backend: ms}} of SDPA under each
    pinned backend that runs these inputs (bwd only with dout), CUDA
    events over ``reps`` calls after 10 unrecorded ones, printed with the
    backend each ran and, for the backward, the device time of its
    kernels per call from a profiler trace (the events read the call as a
    caller sees it, host included; PERF.md §7); a backend that refuses
    these inputs is printed as such and left out."""
    import torch

    times = {"fwd": {}, "bwd": {}}
    for backend in SDPA_BACKENDS:
        try:
            fwd, bwd = library_flash(q, k, v, dout, backend, causal, batch)
            fwd_ms = cuda_ms(fwd, reps=reps, warmup=10)
            bwd_ms = None if bwd is None else cuda_ms(bwd, reps=reps,
                                                      warmup=10)
            trace = None if bwd is None else trace_step(bwd, reps=5)
        except RuntimeError as e:
            print(f"time_sdpa {label} backend={backend} not run: "
                  f"{str(e).splitlines()[0][:160]}", flush=True)
            continue
        finally:
            fwd = bwd = None
            torch.cuda.empty_cache()
        times["fwd"][backend] = fwd_ms
        if bwd_ms is not None:
            times["bwd"][backend] = bwd_ms
        device = trace and trace["busy_ms"]
        print(f"time_sdpa {label} backend={backend} causal={causal} "
              f"fwd_ms={fwd_ms!r} bwd_ms={bwd_ms!r} "
              f"bwd_device_ms={device!r} ({reps} reps; the backward is "
              f"autograd.grad of one recorded forward, dq, dk and dv in "
              f"one call)", flush=True)
    if not times["fwd"]:
        fail(f"no pinned SDPA backend ran ({label})")
    return times


def fastest(times: dict) -> tuple[float | None, str | None]:
    """(ms, backend) of the fastest backend in {backend: ms}."""
    if not times:
        return None, None
    backend = min(times, key=times.get)
    return times[backend], backend


# Per flash kernel: (products over the causal pairs, [BH, T, D] tensors
# and [BH, T] f32 rows read or written).
FLASH_WORK = {"flash_attention_tri_fwd": (2, 4, 1),
              "flash_attention_tri_bwd_dq": (3, 5, 2),
              "flash_attention_tri_bwd_dkv": (4, 6, 2)}


def flash_ops(bh, t, hd) -> dict:
    """FLOPs per kernel: its causal products, T(T+1)/2 pairs per bh and
    2 * hd FLOPs per pair per product."""
    pairs = bh * t * (t + 1) // 2
    return {name: products * 2 * hd * pairs
            for name, (products, _, _) in FLASH_WORK.items()}


def flash_bounds(bh, t, hd, elem, bw, peak) -> dict:
    """Least time per kernel: the larger of its bytes (each input read
    once, each output written once) over the memory rate and its FLOPs
    (flash_ops) over the peak rate."""
    tensor, row = bh * t * hd * elem, bh * t * 4
    ops = flash_ops(bh, t, hd)
    out = {}
    for name, (_, tensors, rows) in FLASH_WORK.items():
        t_bytes = (tensors * tensor + rows * row) / bw * 1e3
        out[name] = max((t_bytes, "bytes"), (ops[name] / peak * 1e3,
                                             "operations"))
    return out


def print_flash_config() -> None:
    """ptxas's lines for the bf16 forward and backward kernels (registers
    at launch, spills) beside their shared memory and registers after
    setmaxnreg per head dim."""
    from tpumon_torch.ops import _build
    from tpumon_torch.ops.flash_attention import (
        bwd_kernel_config,
        fwd_kernel_config,
    )

    for tag, source, config in (
            ("flash_fwd_ptxas", "flash_attention_tri_fwd", fwd_kernel_config),
            ("flash_bwd_ptxas", "flash_attention_tri_bwd", bwd_kernel_config)):
        keep, lines = False, []
        for ln in _build.ptxas_report(source):
            if "Compiling entry function" in ln:
                keep = "wgmma" in ln
            if keep:
                lines.append(ln)
        configs = {hd: config(hd) for hd in (32, 64, 128)}
        print(f"{tag} config={configs} " + " | ".join(lines), flush=True)


def time_flash_kernels(gen, bw: float, peaks: dict) -> dict:
    """Kernel, plain and library times at the production training shape,
    bf16, with their bounds; the triangle forward and both backward
    kernels at the seq-8k shape beside SDPA and their bounds."""
    import torch

    from tpumon_torch.ops import flash_attention as fa

    bh, t, hd = 128, 1024, 128
    before = flash_counts()
    q, k, v, g, out, lse, dvec = flash_inputs(gen, bh, t, hd, torch.bfloat16)
    bounds = flash_bounds(bh, t, hd, 2, bw, peaks["bfloat16"])
    ops = flash_ops(bh, t, hd)
    calls = {
        "flash_attention_tri_fwd": (
            lambda: fa.flash_attention_tri_fwd(q, k, v),
            lambda: fa.flash_attention_tri_fwd_reference(q, k, v)),
        "flash_attention_tri_bwd_dq": (
            lambda: fa.flash_attention_tri_bwd_dq(q, k, v, g, lse, dvec),
            lambda: fa.flash_attention_tri_bwd_dq_reference(
                q, k, v, g, lse, dvec)),
        "flash_attention_tri_bwd_dkv": (
            lambda: fa.flash_attention_tri_bwd_dkv(q, k, v, g, lse, dvec),
            lambda: fa.flash_attention_tri_bwd_dkv_reference(
                q, k, v, g, lse, dvec)),
    }
    sdpa = time_sdpa(q, k, v, g, "BH128/T1024/hd128")
    lib_fwd, fwd_backend = fastest(sdpa["fwd"])
    lib_bwd, bwd_backend = fastest(sdpa["bwd"])
    times = {}
    for name, (kernel, plain) in calls.items():
        ms = cuda_ms(kernel, reps=10)
        plain_ms = cuda_ms(plain, reps=3)
        bound_ms, bound_by = bounds[name]
        fwd = name == "flash_attention_tri_fwd"
        lib = lib_fwd if fwd else lib_bwd
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib}
        print(f"time_{name} shape=BH128/T1024/hd128 bf16 kernel_ms={ms!r} "
              f"plain_ms={plain_ms!r} library_sdpa_ms={lib!r} "
              f"(backend {fwd_backend if fwd else bwd_backend}) "
              f"bound_ms={bound_ms!r} ({bound_by}) "
              f"kernel_over_bound={ms / bound_ms!r} "
              f"kernel_tflops={ops[name] / ms / 1e9!r}", flush=True)
    dq_ms = times["flash_attention_tri_bwd_dq"]["ms"]
    dkv_ms = times["flash_attention_tri_bwd_dkv"]["ms"]
    print(f"time_flash_bwd shape=BH128/T1024/hd128 bf16 dq_plus_dkv_ms="
          f"{dq_ms + dkv_ms!r} sdpa_bwd_ms={lib_bwd!r} (backend "
          f"{bwd_backend}) ratio={(dq_ms + dkv_ms) / lib_bwd!r}", flush=True)
    q, k, v, g = (x.float() for x in (q, k, v, g))
    for name, f32_call in (
            ("flash_attention_tri_fwd",
             lambda: fa.flash_attention_tri_fwd(q, k, v)),
            ("flash_attention_tri_bwd_dq",
             lambda: fa.flash_attention_tri_bwd_dq(q, k, v, g, lse, dvec)),
            ("flash_attention_tri_bwd_dkv",
             lambda: fa.flash_attention_tri_bwd_dkv(q, k, v, g, lse, dvec))):
        print(f"time_{name} shape=BH128/T1024/hd128 f32 (CUDA cores) "
              f"kernel_ms={cuda_ms(f32_call, reps=5)!r}", flush=True)
    del q, k, v, g, out, lse, dvec
    torch.cuda.empty_cache()
    # The seq-8k training shape (batch 1 x 16 heads): the triangle forward
    # and both backward kernels beside SDPA and their bounds.
    bh, t = 16, 8192
    q, k, v, g = (torch.randn(bh, t, hd, generator=gen, device=gen.device).to(
        torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention_tri_fwd(q, k, v)
    dvec = (g.float() * out.float()).sum(-1)
    bounds = flash_bounds(bh, t, hd, 2, bw, peaks["bfloat16"])
    ops = flash_ops(bh, t, hd)
    sdpa = time_sdpa(q, k, v, g, "BH16/T8192/hd128", batch=1, reps=10)
    for name, call in (
            ("flash_attention_tri_fwd",
             lambda: fa.flash_attention_tri_fwd(q, k, v)),
            ("flash_attention_tri_bwd_dq",
             lambda: fa.flash_attention_tri_bwd_dq(q, k, v, g, lse, dvec)),
            ("flash_attention_tri_bwd_dkv",
             lambda: fa.flash_attention_tri_bwd_dkv(q, k, v, g, lse, dvec))):
        ms = cuda_ms(call, reps=10)
        bound_ms, bound_by = bounds[name]
        lib, backend = fastest(sdpa["fwd" if name.endswith("fwd") else "bwd"])
        print(f"time_{name} shape=BH16/T8192/hd128 bf16 kernel_ms={ms!r} "
              f"library_sdpa_ms={lib!r} (backend {backend}) "
              f"bound_ms={bound_ms!r} ({bound_by}) "
              f"kernel_over_bound={ms / bound_ms!r} "
              f"kernel_tflops={ops[name] / ms / 1e9!r}", flush=True)
    set_flash_counts(before)
    del q, k, v, g, out, lse, dvec
    torch.cuda.empty_cache()
    return times


def trace_step(fn, reps: int = 3):
    """device_busy plus where the device time of one call goes: the port's
    flash kernels (the forward's ``flash_fwd*`` and the backward's
    ``flash_tri_bwd*``; ``flash_fwd_ms`` and ``flash_bwd_ms`` are their
    parts), matrix products, and the rest, from one torch.profiler trace;
    None without device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    parts = {"flash_kernels": 0.0, "matmul": 0.0, "other": 0.0}
    flash_fwd_ms = flash_bwd_ms = 0.0
    by_name: dict[str, float] = {}
    for e in kernels:
        name = e.name.lower()
        ms = e.time_range.elapsed_us() / 1e3 / reps
        part = ("flash_kernels" if "flash_fwd" in name or "flash_tri" in name
                else "matmul" if any(w in name for w in (
                    "gemm", "cutlass", "xmma", "nvjet", "matmul")) else "other")
        parts[part] += ms
        flash_fwd_ms += ms if "flash_fwd" in name else 0.0
        flash_bwd_ms += ms if "flash_tri_bwd" in name else 0.0
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + ms
    busy = sum(parts.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share":
            1 - busy / wall_ms, "kernels_per_step": len(kernels) / reps,
            **parts, "flash_fwd_ms": flash_fwd_ms,
            "flash_bwd_ms": flash_bwd_ms,
            "top_ms": [(n, round(ms, 3)) for n, ms in top]}


def time_trainer(trained: dict) -> None:
    """Train-step times: flash beside naive at the production width, seq
    8192 flash beside remat + chunked, and one step's trace."""
    import dataclasses

    import torch

    from tpumon_torch.loadgen.model import init_params, sgd_train_step
    from tpumon_torch.loadgen.train import (
        TrainConfig,
        fused_train_bench,
        synthetic_batch,
    )

    before = flash_counts()
    model = train_model()
    runs = [
        ("seq1024_flash", TrainConfig(model=model, batch=8, seq=1024), 5),
        ("seq1024_naive", TrainConfig(
            model=dataclasses.replace(model, attention="naive"), batch=8,
            seq=1024), 5),
        ("seq8192_flash", TrainConfig(model=train_model(
            max_seq=8192, attn_block_k=1024), batch=1, seq=8192), 3),
        ("seq8192_remat_chunked", TrainConfig(model=train_model(
            max_seq=8192, attention="chunked", attn_block_k=512, remat=True),
            batch=1, seq=8192), 3),
    ]
    for name, cfg, steps in runs:
        torch.cuda.reset_peak_memory_stats()
        r = fused_train_bench(cfg, steps=steps, device="cuda")
        step_ms = r["seconds"] / steps * 1e3
        print(f"train_step {name} steps={steps} step_ms={step_ms!r} "
              f"tokens_per_s={r['tokens_per_sec']!r} mfu_pct={r['mfu_pct']!r} "
              f"loss={r['loss']!r} peak_mem_GB="
              f"{torch.cuda.max_memory_allocated() / 1e9!r}", flush=True)
        if not torch.isfinite(torch.tensor(r["loss"])):
            fail(f"train step {name}: loss not finite")
        torch.cuda.empty_cache()
    # The batch draw (threefry on the host, then a pinned copy) alone: the
    # host time the production step's loop spends on it.
    cfg = runs[0][1]
    synthetic_batch(cfg, 0, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(20):
        synthetic_batch(cfg, step, "cuda")
    torch.cuda.synchronize()
    print(f"train_batch_draw batch=8 seq=1024 vocab={model.vocab} host_ms="
          f"{(time.perf_counter() - t0) / 20 * 1e3!r}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for name, cfg, reps in (("seq1024_flash", runs[0][1], 3),
                            ("seq1024_naive", runs[1][1], 3),
                            ("seq8192_flash", runs[2][1], 3),
                            ("seq8192_remat_chunked", runs[3][1], 1)):
        params = (trained["params"] if name == "seq1024_flash" else
                  init_params(cfg.model, gen))
        tokens = torch.randint(0, model.vocab, (cfg.batch, cfg.seq),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
        tr = trace_step(lambda: sgd_train_step(cfg.model, params, tokens),
                        reps=reps)
        if tr is None:
            print(f"train_step_trace {name} device_busy=not measured (the "
                  f"profiler recorded no device activity)", flush=True)
        else:
            print(f"train_step_trace {name} " + " ".join(
                f"{k}={v!r}" for k, v in tr.items()), flush=True)
        del params
        torch.cuda.empty_cache()
    set_flash_counts(before)


def check_train_metrics(trained: dict) -> None:
    """The trainer's /metrics serves the families the monitor scrapes."""
    from tpumon_torch.loadgen.train import start_metrics_server

    httpd, url = start_metrics_server(trained["metrics"], port=0)
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            text = resp.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
    want = ("tpumon_train_step", "tpumon_train_loss",
            "tpumon_train_tokens_total", "tpumon_train_step_time_seconds",
            "tpumon_train_goodput_pct", "tpumon_train_mfu_pct")
    missing = [f for f in want if f"\n{f} " not in "\n" + text]
    print("train_metrics " + " ".join(
        ln for ln in text.splitlines() if not ln.startswith("#"))
        + f" missing={missing}", flush=True)
    if missing:
        fail(f"trainer /metrics lacks {missing}")


# --- the burn path: GEMM kernels, burns, measurements, validate ----------

GEMM_KERNELS = ("matmul", "quantized_matmul_kernel")
GEMM_TILE = 128  # output tiles the agreement metric runs over
GEMM_K_STEP = 64  # the wgmma kernel's K stage (the f32 kernel's step is 8)
GEMM_KERNEL_TILE = (128, 256)  # the wgmma kernel's output tile (M, N)
# Kernel vs plain version: gemm_tile_rel_err, the worst ||got - want|| /
# ||want|| over 128 x 128 output tiles. Both versions form each product
# exactly and sum in f32 (in another order), then round once to the
# output type: bf16 rounds at 2^-9 relative, and only where the two f32
# sums fall on either side of a rounding point; f32 differs in summation
# order only. Each limit lies between the kernels' reading and the
# weakest planted fault's (gemm_faulty_plain; PERF.md).
GEMM_TOL = {"bfloat16": 4e-3, "float32": 1e-5}
GEMM_FAULTS = ("k_block_dropped", "scale_per_k_step", "scale_left_out",
               "b_transposed", "tile_from_neighbour", "last_tile_unwritten")
# The 3-link burn chains, GEMM kernel vs library (normwise relative): each
# link rounds to bf16, so a 1-ulp difference in one link carries into the
# next; 2e-2 is five bf16 half-ulps.
CHAIN_TOL = 2e-2


def gemm_counts() -> dict:
    from tpumon_torch.ops import matmul as mm
    from tpumon_torch.ops import quant_matmul as qm

    return {"matmul": mm.matmul.launches,
            "quantized_matmul_kernel": qm.quantized_matmul_kernel.launches}


def set_gemm_counts(counts: dict) -> None:
    from tpumon_torch.ops import matmul as mm
    from tpumon_torch.ops import quant_matmul as qm

    mm.matmul.launches = counts["matmul"]
    qm.quantized_matmul_kernel.launches = counts["quantized_matmul_kernel"]


def gemm_tile_rel_err(got, want) -> float:
    """The worst relative error over 128 x 128 output tiles of [M, N]
    tensors (the whole tensor where a side is shorter)."""
    m, n = want.shape
    tm, tn = min(GEMM_TILE, m), min(GEMM_TILE, n)
    a, b = (x.float().reshape(m // tm, tm, n // tn, tn) for x in (got, want))
    num = (a - b).square().sum((1, 3)).sqrt()
    return (num / b.square().sum((1, 3)).sqrt().clamp_min(1e-30)).max().item()


def gemm_faulty_plain(a, b, scale, fault: str | None):
    """The plain product (f32, rounded once to a's dtype; scaled per
    column once when ``scale`` is given) carrying one fault of a kernel
    that steps K by GEMM_K_STEP (a zero-filled tail past K) and walks
    GEMM_KERNEL_TILE output tiles from a persistent scheduler (None: no
    fault):

    - k_block_dropped: the last K step is skipped;
    - scale_per_k_step: the scale multiplies the accumulator after every
      K step, not once at store;
    - scale_left_out: the scale is never applied;
    - b_transposed: B is read as B^T (square B only);
    - tile_from_neighbour: the last output tile (bottom right, the last of
      the scheduler's order) holds the tile above it, or the one to its
      left in a single row of tiles;
    - last_tile_unwritten: the last output tile is left as zeros.
    """
    af, bf = a.float(), b.float()
    if fault == "b_transposed":
        bf = bf.t()
    k = a.shape[1]
    last = (k - 1) // GEMM_K_STEP * GEMM_K_STEP  # the last K step's start
    if fault == "k_block_dropped":
        c = af[:, :last] @ bf[:last]
    elif fault == "scale_per_k_step":
        c = 0.0
        for k0 in range(0, k, GEMM_K_STEP):
            c = (c + af[:, k0:k0 + GEMM_K_STEP] @ bf[k0:k0 + GEMM_K_STEP]
                 ) * scale.float()
    else:
        c = af @ bf
    if scale is not None and fault not in ("scale_per_k_step",
                                           "scale_left_out"):
        c = c * scale.float()
    if fault in ("tile_from_neighbour", "last_tile_unwritten"):
        (tm, tn), (m, n) = GEMM_KERNEL_TILE, c.shape
        m0, n0 = m - tm, (n - 1) // tn * tn
        if fault == "last_tile_unwritten":
            c[m0:, n0:] = 0
        elif m0 > 0:
            c[m0:, n0:] = c[m0 - tm:m0, n0:].clone()
        else:
            c[m0:, n0:] = c[m0:, n0 - tn:n0 - tn + (n - n0)].clone()
    return c.to(a.dtype)


def gemm_fault_applies(fault: str, a, b, scale) -> bool:
    if fault == "scale_per_k_step":  # needs a second K step
        return scale is not None and a.shape[1] > GEMM_K_STEP
    if fault == "scale_left_out":
        return scale is not None
    if fault == "b_transposed":
        return b.shape[0] == b.shape[1]
    if fault == "tile_from_neighbour":  # needs a second output tile
        (tm, tn), m, n = GEMM_KERNEL_TILE, a.shape[0], b.shape[1]
        return m > tm or n > tn
    return True


def gemm_fault_readings(a, b, scale, want) -> dict:
    return {f: gemm_tile_rel_err(gemm_faulty_plain(a, b, scale, f), want)
            for f in GEMM_FAULTS if gemm_fault_applies(f, a, b, scale)}


def gemm_case(gen, m, k, n, dtype, quant: bool, scale=None):
    """a [m, k] and b [k, n] (int8 q and a per-column scale when
    ``quant``: N(0, 1) / 127 around 1, unless given) from the card's
    generator."""
    import torch

    dev = gen.device
    a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    if not quant:
        return a, torch.randn(k, n, generator=gen, device=dev).to(dtype), None
    q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    if scale is None:
        scale = (1.0 + 0.25 * torch.randn(n, generator=gen, device=dev)) / 127
    return a, q, scale


def check_gemm_kernels(gen) -> dict:
    """Phase 11: both GEMM kernels against their plain versions at the
    burn's 4096^3 and at tests/test_ops.py's shapes, with the planted
    faults' readings beside each case; the reference's quantized fallback
    on a shape that does not tile. Returns the worst max abs error per
    kernel at 4096^3."""
    import torch

    from tpumon_torch.ops import matmul as mm
    from tpumon_torch.ops import quant_matmul as qm

    before = gemm_counts()
    bf16, f32 = torch.bfloat16, torch.float32
    burn_scale = torch.full((4096,), 1 / 127, device=gen.device)
    # (name, kernel, m, k, n, blocks (m, n, k), dtypes, scale)
    cases = [
        ("burn_4096", "matmul", 4096, 4096, 4096, None, (bf16,), None),
        ("burn_4096", "quantized_matmul_kernel", 4096, 4096, 4096, None,
         (bf16,), burn_scale),
        ("single_tile", "matmul", 128, 64, 128, (128, 128, 64), (bf16, f32),
         None),
        ("multi_tile", "matmul", 256, 128, 256, (128, 128, 64), (bf16, f32),
         None),
        ("k_major", "matmul", 256, 256, 128, (128, 128, 128), (bf16, f32),
         None),
        ("dequant_ref", "quantized_matmul_kernel", 256, 512, 512,
         (128, 128, 128), (bf16, f32), None),
        ("two_k_steps", "quantized_matmul_kernel", 128, 256, 128,
         (128, 128, 128), (bf16, f32), None),
    ]
    # What the persistent wgmma kernel adds: more 128 x 256 tiles than SMs
    # with a partial last wave (17 x 8 = 136 tiles), N a multiple of 128
    # but not of 256 (a tile half past N), K a multiple of 32 but not of
    # 64 (a zero-filled K tail).
    for kern in GEMM_KERNELS:
        cases += [
            ("partial_wave", kern, 2176, 192, 2048, (128, 128, 64),
             (bf16, f32), None),
            ("n_not_256", kern, 256, 128, 384, (128, 128, 128), (bf16, f32),
             None),
            ("k_not_64", kern, 128, 96, 256, (128, 128, 32), (bf16, f32),
             None),
        ]
    sms = torch.cuda.get_device_properties(gen.device).multi_processor_count
    tiles = (2176 // GEMM_KERNEL_TILE[0]) * (2048 // GEMM_KERNEL_TILE[1])
    print(f"gemm_partial_wave tiles={tiles} sms={sms} last_wave="
          f"{tiles % sms}", flush=True)
    if not (tiles > sms and tiles % sms):
        fail(f"the partial_wave case has {tiles} tiles on {sms} SMs: no "
             f"partial last wave")
    worst = {}
    for name, kern, m, k, n, blocks, dtypes, scale in cases:
        kw = {} if blocks is None else dict(zip(
            ("block_m", "block_n", "block_k"), blocks))
        for dtype in dtypes:
            dname = str(dtype).split(".")[1]
            tol = GEMM_TOL[dname]
            quant = kern != "matmul"
            a, b, sc = gemm_case(gen, m, k, n, dtype, quant, scale)
            if quant:
                got = qm.quantized_matmul_kernel(a, b, sc, **kw)
                want = qm.quantized_matmul_reference(a, b, sc)
            else:
                got = mm.matmul(a, b, **kw)
                want = mm.matmul_reference(a, b)
            torch.cuda.synchronize()
            rel = gemm_tile_rel_err(got, want)
            err = (got.float() - want.float()).abs().max().item()
            finite = bool(torch.isfinite(got.float()).all().item())
            clean = gemm_tile_rel_err(gemm_faulty_plain(a, b, sc, None), want)
            faults = gemm_fault_readings(a, b, sc, want)
            missed = [f for f, r in faults.items() if not r > tol]
            ok = finite and got.dtype == dtype and rel <= tol
            print(f"gemm_kernel_vs_plain {kern} {name} {m}x{k}x{n} {dname} "
                  f"tile_rel_err={rel!r} tol={tol} max_abs_err={err!r} "
                  f"fault_model_clean={clean!r} {'ok' if ok else 'MISS'}",
                  flush=True)
            print(f"gemm_planted_faults {kern} {name} {dname} tile_rel_err="
                  f"{faults} tol={tol} missed={missed}", flush=True)
            if not ok:
                fail(f"{kern} kernel disagrees with its plain version "
                     f"({name}, {dname})")
            if missed or clean > 1e-6:
                fail(f"the GEMM limit {tol} passes planted faults {missed} "
                     f"or the fault model is off ({name}, {dname})")
            if name == "burn_4096":
                worst[kern] = err
    # The reference's own exact case: ones @ ones over two K steps with a
    # scale of 0.5 gives 256 * 0.5 everywhere, the scale applied once.
    for dtype in (bf16, f32):
        ones = torch.ones(128, 256, device=gen.device, dtype=dtype)
        out = qm.quantized_matmul_kernel(
            ones, torch.ones(256, 128, device=gen.device, dtype=torch.int8),
            torch.full((128,), 0.5, device=gen.device), block_m=128,
            block_n=128, block_k=128)
        exact = bool((out.float() == 128.0).all().item())
        print(f"gemm_scale_once {dtype} all_128={exact}", flush=True)
        if not exact:
            fail("the int8 kernel does not apply its scale exactly once")
    # A decode shape does not tile: the reference's fallback, no launch.
    a = torch.randn(4, 64, generator=gen, device=gen.device)
    q = torch.randint(-127, 128, (64, 48), generator=gen, device=gen.device,
                      dtype=torch.int8)
    sc = torch.rand(48, generator=gen, device=gen.device) / 127
    n0 = qm.quantized_matmul_kernel.launches
    out = qm.quantized_matmul(a, q, sc)
    same = torch.equal(out, a @ (q.to(a.dtype) * sc.to(a.dtype)))
    print(f"gemm_fallback 4x64x48 f32 equal_plain={same} launches="
          f"{qm.quantized_matmul_kernel.launches - n0}", flush=True)
    if not same or qm.quantized_matmul_kernel.launches != n0:
        fail("quantized_matmul's fallback launched a kernel or differs")
    set_gemm_counts(before)
    return worst


def smi(fields: str) -> list[str]:
    """One nvidia-smi reading of the first card: the fields' values."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return [x.strip() for x in out.stdout.strip().splitlines()[0].split(",")]


def while_running(fn, sample, period: float = 0.4):
    """Run ``fn`` in a thread and call ``sample()`` every ``period`` s
    until it ends; returns (fn's result, the samples). fn's exception is
    raised here."""
    import threading

    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # handed to the caller below
            box["err"] = e

    t = threading.Thread(target=target)
    t.start()
    samples = []
    while t.is_alive():
        samples.append(sample())
        t.join(timeout=period)
    if "err" in box:
        raise box["err"]
    return box["out"], samples


def power_clock():
    """(power draw W, SM clock MHz) now."""
    p, c = smi("power.draw,clocks.sm")
    return float(p), float(c)


def run_burn_path() -> dict:
    """Phase 12, the burn slice's main path: the chained programs at size
    4096 through the GEMM kernels and the library (the 3-link chains held
    together; 64 kernel launches per 64-link call), then mxu_burn and
    int8_burn for their default 2 s each way, with power and SM clock read
    during each. Returns the kernels' launches over the whole phase."""
    import torch

    from tpumon_torch import prng
    from tpumon_torch.loadgen import burn
    from tpumon_torch.ops import threefry
    from tpumon_torch.ops.matmul import matmul
    from tpumon_torch.ops.quant_matmul import quantized_matmul_kernel

    key = prng.torch_key(0, torch.device("cuda"))
    a, b = burn._mxu_inputs(key, 4096)
    chains = {"mxu": (burn._mxu_chain(a, b, 3, matmul),
                      burn._mxu_chain(a, b, 3, torch.matmul))}
    a, q, sc = burn._int8_inputs(key, 4096)
    chains["int8"] = (burn._int8_chain(a, q, sc, 3, quantized_matmul_kernel),
                      burn._int8_chain(a, q, sc, 3, burn._dequant_matmul))
    for name, (kern, lib) in chains.items():
        rel = gemm_tile_rel_err(kern, lib)
        scale = lib.float().abs().mean().item()
        print(f"burn_chain {name} links=3 size=4096 kernel_vs_library "
              f"tile_rel_err={rel!r} tol={CHAIN_TOL} mean_abs={scale!r}",
              flush=True)
        if not rel <= CHAIN_TOL or scale == 0:
            fail(f"the 3-link {name} chain: kernel and library disagree")
    del a, b, q, sc, chains

    set_gemm_counts(dict.fromkeys(GEMM_KERNELS, 0))  # the path only
    threefry.set_launch_counts(0)
    t0 = time.perf_counter()
    # Inputs: two normals (a; b under fold_in(key, 1)), or a normal and an
    # int8 randint (under fold_in(key, 1), after its split).
    for prog, kern, want_draws in (
            (burn._mxu_burn_program, "matmul",
             {"threefry_keys": 1, "threefry_draw": 2}),
            (burn._int8_burn_program, "quantized_matmul_kernel",
             {"threefry_keys": 2, "threefry_draw": 2})):
        n0, d0 = gemm_counts()[kern], threefry.launch_counts()
        total = burn._sync(prog(key, 4096, 64, use_kernel=True))
        n = gemm_counts()[kern] - n0
        drawn = {k: v - d0[k] for k, v in threefry.launch_counts().items()
                 if k != "threefry_categorical"}
        print(f"burn_program {prog.__name__} size=4096 links=64 "
              f"launches={n} threefry_launches={drawn} sum={total!r}",
              flush=True)
        if n != 64:
            fail(f"{prog.__name__}: {n} kernel launches for 64 links")
        if drawn != want_draws:
            fail(f"{prog.__name__}: threefry launches {drawn}, want "
                 f"{want_draws}")
    for fn, use_kernel in ((burn.mxu_burn, None), (burn.mxu_burn, True),
                           (burn.int8_burn, None), (burn.int8_burn, False)):
        n0 = gemm_counts()
        out, samples = while_running(
            lambda: fn(use_kernel=use_kernel), power_clock)
        launched = {k: v - n0[k] for k, v in gemm_counts().items()}
        want = 64 * (out["calls"] + 1) if out["kernel"] else 0
        print(f"burn {fn.__name__} use_kernel={use_kernel} result={out} "
              f"launches={launched} power_W_sm_MHz={samples}", flush=True)
        kern = "matmul" if fn is burn.mxu_burn else "quantized_matmul_kernel"
        if launched[kern] != want or not out["tflops"] > 0:
            fail(f"{fn.__name__}: {launched[kern]} launches, want {want}")
    launches = gemm_counts()
    draws = threefry.launch_counts()
    print(f"burn_path launches={launches} threefry_launches={draws} "
          f"wall_s={time.perf_counter() - t0!r}", flush=True)
    if not all(launches.values()):
        fail(f"a GEMM kernel was not launched on the burn path: {launches}")
    if not draws["threefry_draw"] or not draws["threefry_keys"]:
        fail(f"the fused draws were not launched on the burn path: {draws}")
    for use_kernel in (False, True):
        out, samples = while_running(lambda: live_chain(use_kernel),
                                     power_clock)
        print(f"live_chain use_kernel={use_kernel} result={out} "
              f"power_W_sm_MHz={samples}", flush=True)
    set_gemm_counts(launches)
    return {**launches, **draws}


def live_chain(use_kernel: bool, seconds: float = 2.0, size: int = 4096,
               links: int = 64) -> dict:
    """A power reference point for the burn, not the burn: its chain at
    size 4096, renormalised by sqrt(size) in place of the reference's
    size, so the values stay N(0, 1) through every link where the burn's
    underflow to zeros after about 22. Run for ``seconds``; returns calls
    and TFLOP/s."""
    import torch

    from tpumon_torch import prng
    from tpumon_torch.loadgen import burn
    from tpumon_torch.ops.matmul import matmul

    a, b = burn._mxu_inputs(prng.torch_key(0, torch.device("cuda")), size)
    mm = matmul if use_kernel else torch.matmul
    calls, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        x = a
        for _ in range(links):
            x = (mm(x, b) / size**0.5).to(torch.bfloat16)
        burn._sync(x.float().abs().mean())
        calls += 1
    dt = time.perf_counter() - t0
    return {"calls": calls, "tflops": 2 * size**3 * links * calls / dt / 1e12,
            "end_mean_abs": float(x.float().abs().mean())}


def measure_kernels() -> dict:
    """Phase 13, bench.py's kernels phase through the port: slope-timed
    kernel and library rates and the production engine decode step, on
    one line under bench.py's key names (pallas read as kernel)."""
    import dataclasses

    from tpumon_torch.loadgen import burn
    from tpumon_torch.loadgen.model import ModelConfig
    from tpumon_torch.loadgen.serving import ServeConfig

    t0 = time.perf_counter()
    before = gemm_counts()
    mm_k = burn.measure_mxu_tflops(use_kernel=True)
    mm_x = burn.measure_mxu_tflops(use_kernel=False)
    i8_k = burn.measure_int8_tflops(use_kernel=True)
    i8_x = burn.measure_int8_tflops(use_kernel=False)
    pa_k = burn.measure_paged_gbps(use_kernel=True)
    pa_x = burn.measure_paged_gbps(use_kernel=False)
    prod = ServeConfig(
        model=ModelConfig(vocab=4096, d_model=4096, n_layers=2, n_heads=32,
                          n_kv_heads=8, d_ff=8192, max_seq=4096),
        slots=16, prefill_len=128, kv_layout="paged")
    es_g = burn.measure_paged_engine_step_ms(
        dataclasses.replace(prod, paged_attn="gather"), inner_steps=16)
    es_k = burn.measure_paged_engine_step_ms(
        dataclasses.replace(prod, paged_attn="kernel"), inner_steps=16)
    set_gemm_counts(before)
    out = {
        "mxu_matmul_kernel_tflops": mm_k["tflops"],
        "mxu_matmul_xla_tflops": mm_x["tflops"],
        "mxu_matmul_vs_xla": mm_k["tflops"] / mm_x["tflops"],
        "int8_matmul_kernel_tflops": i8_k["tflops"],
        "int8_matmul_xla_tflops": i8_x["tflops"],
        "int8_matmul_vs_xla": i8_k["tflops"] / i8_x["tflops"],
        "paged_attention_kernel_kv_gbps": pa_k["kv_gbps"],
        "paged_attention_xla_kv_gbps": pa_x["kv_gbps"],
        "paged_attention_vs_xla": pa_k["kv_gbps"] / pa_x["kv_gbps"],
        "paged_engine_step_gather_ms": es_g["ms_per_step"],
        "paged_engine_step_kernel_ms": es_k["ms_per_step"],
        "paged_engine_step_kernel_vs_gather":
            es_g["ms_per_step"] / es_k["ms_per_step"],
        "kernel_marginal_s": {
            "mxu_kernel": mm_k["marginal_s"], "mxu_xla": mm_x["marginal_s"],
            "int8_kernel": i8_k["marginal_s"], "int8_xla": i8_x["marginal_s"],
            "paged_kernel": pa_k["marginal_s"],
            "paged_xla": pa_x["marginal_s"],
            "engine_gather": es_g["marginal_s"],
            "engine_kernel": es_k["marginal_s"]},
        "device_rooflines": burn.device_rooflines(),
    }
    print("kernels_phase " + json.dumps(out), flush=True)
    print(f"kernels_phase wall_s={time.perf_counter() - t0!r}", flush=True)
    return out


def check_burn_load() -> None:
    """Phase 14: the burns load the card, judged by the port's copy of
    validate's verdicts on nvidia-smi's readings: memory.used before,
    during and after hbm_fill(0.3), and utilization.gpu under
    mxu_burn(seconds=0.5, size=2048, iters=16) run in a loop in a thread,
    as the reference's validate runs it."""
    import threading

    import torch

    from tpumon_torch.loadgen import burn
    from tpumon_torch.validate import (
        classify_hbm_response,
        classify_mxu_response,
        summarize,
    )

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the caching allocator's reserve is not the fill

    def used() -> float:
        return float(smi("memory.used")[0]) * 2**20  # MiB

    time.sleep(1.0)
    hbm0 = used()
    arrays = burn.hbm_fill(0.3)
    time.sleep(1.0)
    hbm_during = used()
    del arrays
    torch.cuda.empty_cache()
    time.sleep(1.0)
    hbm_after = used()
    hbm = classify_hbm_response(hbm0, hbm_during, hbm_after, False,
                                source="nvidia-smi memory.used")

    duty0 = float(smi("utilization.gpu")[0])
    stop = threading.Event()
    errors = []

    def loop():
        try:
            while not stop.is_set():
                burn.mxu_burn(seconds=0.5, size=2048, iters=16)
        except BaseException as e:  # handed to the main thread below
            errors.append(e)

    t = threading.Thread(target=loop)
    t.start()
    duty = []
    try:
        time.sleep(2.0)
        for _ in range(5):
            duty.append(float(smi("utilization.gpu")[0]))
            time.sleep(1.0)
    finally:
        stop.set()
        t.join(timeout=60)
    if errors or t.is_alive():
        fail(f"the mxu burn thread failed: {errors}")
    mxu = classify_mxu_response(duty0, duty, False,
                                source="nvidia-smi utilization.gpu")
    table, code = summarize([hbm, mxu])
    print(f"burn_load memory_used_bytes={[hbm0, hbm_during, hbm_after]} "
          f"utilization_pct={duty0} -> {duty} wall_s="
          f"{time.perf_counter() - t0!r}", flush=True)
    for line in table.splitlines():
        print(f"burn_load {line}", flush=True)
    if code:
        fail("a burn did not register on the card's counters")


FLASH_RECT_FAULTS = ("diag_unmasked", "last_diag_dropped", "no_rescale",
                     "stale_stage", "tail_keys_unmasked", "wg1_mask_offset")


def check_flash_rect(gen) -> dict:
    """Phase 15: the rectangular flash forward against its plain version,
    causal and not, bf16 and f32, at the training shape and small shapes,
    under FLASH_TOL's out limits, with the planted forward faults that
    apply. Returns {"launches", "max_abs_err"} (the launches of this
    check, the error at the training shape, bf16, causal)."""
    import torch

    from tpumon_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fa.flash_attention.launches = 0  # the kernel's own phase only
    cases = [("production", 128, 1024, 128), ("hd64_t384", 6, 384, 64),
             ("hd32_t128", 6, 128, 32), *ODD_T_CASES]
    worst = None
    for name, bh, t, hd in cases:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            tol = FLASH_TOL[dname]["out"]
            q, k, v = (torch.randn(bh, t, hd, generator=gen,
                                   device=gen.device).to(dtype)
                       for _ in range(3))
            for causal in (True, False):
                got = fa.flash_attention(q, k, v, causal=causal,
                                         block_q=64, block_k=64)
                torch.cuda.synchronize()
                want = fa.flash_attention_reference(q, k, v, causal)
                rel = tile_rel_err(got, want)
                err = (got.float() - want.float()).abs().max().item()
                finite = bool(torch.isfinite(got.float()).all().item())
                faults = {f: tile_rel_err(faulty_plain(q, k, v, f, causal),
                                          want)
                          for f in FLASH_RECT_FAULTS
                          if fault_applies(f, t, causal)}
                missed = [f for f, r in faults.items() if not r > tol]
                ok = finite and rel <= tol
                print(f"flash_rect_vs_plain {name} BH{bh}/T{t}/hd{hd} {dname} "
                      f"causal={causal} tile_rel_err={rel!r} tol={tol} "
                      f"max_abs_err={err!r} {'ok' if ok else 'MISS'}",
                      flush=True)
                print(f"flash_rect_planted_faults {name} {dname} causal="
                      f"{causal} tile_rel_err={faults} missed={missed}",
                      flush=True)
                if not ok:
                    fail(f"flash_attention kernel disagrees with its plain "
                         f"version ({name}, {dname}, causal={causal})")
                if missed:
                    fail(f"the flash limit {tol} passes planted faults "
                         f"{missed} ({name}, {dname}, causal={causal})")
                if name == "production" and dname == "bfloat16" and causal:
                    worst = err
            del q, k, v
    launches = fa.flash_attention.launches
    print(f"flash_rect launches={launches} wall_s="
          f"{time.perf_counter() - t0!r}", flush=True)
    if launches != 2 * 2 * len(cases):
        fail(f"flash_attention launched {launches} times")
    return {"launches": launches, "max_abs_err": worst}


def time_gemm_kernels(gen, bw: float, peaks: dict) -> dict:
    """Kernel, plain and library times of both GEMM kernels at the burn's
    4096^3 with a bf16 a, with their bounds; the f32 kernels' times
    beside."""
    import torch

    from tpumon_torch.loadgen.burn import _dequant_matmul
    from tpumon_torch.ops import matmul as mm
    from tpumon_torch.ops import quant_matmul as qm

    before = gemm_counts()
    n = 4096
    ops = 2 * n**3
    a, b, _ = gemm_case(gen, n, n, n, torch.bfloat16, False)
    _, q, sc = gemm_case(gen, n, n, n, torch.bfloat16, True)
    calls = {
        "matmul": (lambda: mm.matmul(a, b), lambda: mm.matmul_reference(a, b),
                   lambda: torch.matmul(a, b), 3 * n * n * 2),
        "quantized_matmul_kernel": (
            lambda: qm.quantized_matmul_kernel(a, q, sc),
            lambda: qm.quantized_matmul_reference(a, q, sc),
            lambda: _dequant_matmul(a, q, sc), 2 * n * n * 2 + n * n + 4 * n),
    }
    times = {}
    for name, (kernel, plain, library, nbytes) in calls.items():
        bound_ms, bound_by = max((nbytes / bw * 1e3, "bytes"),
                                 (ops / peaks["bfloat16"] * 1e3, "operations"))
        ms = cuda_ms(kernel, reps=20)
        plain_ms = cuda_ms(plain, reps=5)
        lib_ms = cuda_ms(library, reps=20)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms}
        print(f"time_{name} shape=4096^3 bf16 kernel_ms={ms!r} "
              f"plain_ms={plain_ms!r} library_ms={lib_ms!r} "
              f"bound_ms={bound_ms!r} ({bound_by}: {nbytes} B, {ops} FLOP) "
              f"kernel_tflops={ops / ms / 1e9!r} "
              f"library_tflops={ops / lib_ms / 1e9!r}", flush=True)
    # The f32 variants (CUDA cores), beside full-f32 library calls (TF32 is
    # off: main() clears allow_tf32) and the f32 operations bound.
    af, bf = a.float(), b.float()
    f32_bound = ops / peaks["float32"] * 1e3
    print(f"time_gemm_f32 shape=4096^3 f32 (CUDA cores) matmul_kernel_ms="
          f"{cuda_ms(lambda: mm.matmul(af, bf), reps=3)!r} "
          f"library_ms={cuda_ms(lambda: torch.matmul(af, bf), reps=5)!r} "
          f"quantized_kernel_ms="
          f"{cuda_ms(lambda: qm.quantized_matmul_kernel(af, q, sc), reps=3)!r} "
          f"dequant_library_ms="
          f"{cuda_ms(lambda: _dequant_matmul(af, q, sc), reps=5)!r} "
          f"bound_ms={f32_bound!r} (operations: {ops} FLOP) "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}", flush=True)
    set_gemm_counts(before)
    return times


def time_flash_rect(gen, bw: float, peaks: dict) -> dict:
    """The rectangular forward's kernel, plain and SDPA (pinned backends)
    times at the training shape, bf16, causal and not, with their bounds;
    returns the causal ones, with the faster backend's time."""
    import torch

    from tpumon_torch.ops import flash_attention as fa

    before = fa.flash_attention.launches
    bh, t, hd = 128, 1024, 128
    q, k, v = (torch.randn(bh, t, hd, generator=gen, device=gen.device).to(
        torch.bfloat16) for _ in range(3))
    nbytes = 4 * bh * t * hd * 2
    out = {}
    for causal in (True, False):
        pairs = bh * (t * (t + 1) // 2 if causal else t * t)
        bound_ms, bound_by = max((nbytes / bw * 1e3, "bytes"),
                                 (2 * 2 * hd * pairs / peaks["bfloat16"] * 1e3,
                                  "operations"))
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                     reps=20)
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v,
                                                                causal), reps=3)
        lib_ms, backend = fastest(time_sdpa(
            q, k, v, None, "rect BH128/T1024/hd128", causal=causal)["fwd"])
        print(f"time_flash_attention shape=BH128/T1024/hd128 bf16 "
              f"causal={causal} kernel_ms={ms!r} plain_ms={plain_ms!r} "
              f"library_sdpa_ms={lib_ms!r} (backend {backend}) "
              f"bound_ms={bound_ms!r} ({bound_by}) "
              f"kernel_over_bound={ms / bound_ms!r}", flush=True)
        out[causal] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": lib_ms}
    fa.flash_attention.launches = before
    return out[True]


# Phase 16: the dense layout, fused block decode and keyed sampling at
# production width. Sampler agreement between two runs of one draw (card
# and CPU): tokens equal wherever the winning perturbed logit leads the
# runner-up by more than SAMPLE_MARGIN; the rows inside it (near-ties)
# must stay under 1% of the draws (tests/test_torch_sampling.py's rule).
SAMPLE_MARGIN = 1e-4


def sample_margin(logits, key, rids, ctrs, temps, topk):
    """Per row of one ``sample_tokens`` call, how far the winning
    perturbed logit (Gumbel + the top-k-masked, temperature-scaled logit)
    leads the runner-up; inf on greedy rows. The near-tie measure of the
    sampler checks, on the tensors' device."""
    import torch

    from tpumon_torch import prng

    v = logits.shape[-1]
    keys = prng.torch_fold_in(prng.torch_fold_in(key, rids), ctrs)
    srt = torch.sort(logits, dim=-1, descending=True).values
    k_idx = (torch.where(topk > 0, topk, v) - 1).clamp(0, v - 1).long()
    thresh = srt.gather(-1, k_idx[:, None])
    scaled = torch.where(logits >= thresh, logits, -1e30) / temps.clamp_min(
        1e-6)[:, None]
    top2 = torch.topk(prng.gumbel(keys, (v,)) + scaled, 2).values
    return torch.where(temps > 0, top2[:, 0] - top2[:, 1], float("inf"))


def serve_traffic(cfg, label: str, max_new: int = 32) -> tuple:
    """Phase 4's traffic with phase 16's sampling settings through a fresh
    engine (random weights from seed 0, as phase 4's) on the card, the
    paged kernel's and the fused draws' counts set to 0 just before and
    read just after. Returns (engine, streams, stats)."""
    import torch

    from tpumon_torch.loadgen.serving import ServingEngine
    from tpumon_torch.ops import threefry
    from tpumon_torch.ops.paged_attention import paged_attention
    from tpumon_torch.tracing import quantiles

    _, prompts, sampling = engine_traffic()
    eng = ServingEngine(cfg=cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    paged_attention.launches = 0
    threefry.set_launch_counts(0)
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new=max_new, temperature=t, top_k=k)
            for p, (t, k) in zip(prompts, sampling)]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    draws = threefry.launch_counts()
    steps = eng.decode_steps_total
    ttft = quantiles([t * 1e3 for t in eng._ttft_recent])
    stats = {"wall_s": wall, "tokens": eng.tokens_total, "steps": steps,
             "launches": launches, "tokens_per_s": eng.tokens_total / wall,
             "ttft_p50_ms": ttft[0], "ttft_p95_ms": ttft[1],
             "threefry": draws}
    print(f"dense_fused_run {label} " + " ".join(
        f"{k}={v!r}" for k, v in stats.items()), flush=True)
    bad = [r.rid for r in reqs
           if r.status != "completed" or len(r.output) != max_new + 1]
    if bad:
        fail(f"{label}: requests {bad} did not complete with "
             f"{max_new + 1} tokens")
    want = cfg.model.n_layers * steps if cfg.paged_attn == "kernel" else 0
    if cfg.kv_layout == "paged" and launches != want:
        fail(f"{label}: kernel launches {launches} != n_layers x decode "
             f"steps ({cfg.model.n_layers} x {steps})")
    check_sampler_draws(draws, steps + len(reqs), label)
    return eng, [r.output for r in reqs], stats


def greedy_divergence(eng, prompt, a, b) -> str | None:
    """Where two bf16 greedy streams of one request part: None when equal;
    else the index and the top-2 margin of the full forward's logits at
    that prefix (the port's plain training forward, bf16), which must be a
    near-tie (within the engine paths' logit tolerance, ENGINE_TOL)."""
    import torch

    from tpumon_torch.loadgen.model import forward

    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None:
        return None
    seq = torch.tensor([prompt + a[:i]], dtype=torch.int32, device="cuda")
    logits = forward(eng.cfg.model, eng.params, seq)[0, -1]
    top2 = torch.topk(logits, 2).values
    margin = float(top2[0] - top2[1])
    if margin > ENGINE_TOL["bfloat16"]:
        fail(f"greedy streams part at token {i} where the forward's margin "
             f"is {margin!r}, not a near-tie")
    return f"token {i} (forward top-2 margin {margin!r})"


def check_dense_and_fused() -> dict:
    """Phase 16's engine runs and checks: the dense engine at decode_block
    1 and 8 (and 8 under the sequential scheduler), the paged engine with
    the kernel read path at block 1 and 8 and with the gather read path at
    block 8, all on phase 4's traffic with greedy and sampled requests;
    each request's stream identical across blocks and schedulers (the
    paged kernel's too: it is deterministic); dense and paged-gather
    greedy streams equal up to the first near-tie. Returns the stats by
    run and the state the timings start from."""
    import torch

    runs = {"dense_b1": engine_config("gather", kv_layout="dense"),
            "dense_b8": engine_config("gather", kv_layout="dense",
                                      decode_block=8),
            "dense_b8_sequential": engine_config(
                "gather", kv_layout="dense", decode_block=8,
                scheduler="sequential"),
            "paged_kernel_b1": engine_config("kernel"),
            "paged_kernel_b8": engine_config("kernel", decode_block=8),
            "paged_gather_b8": engine_config("gather", decode_block=8)}
    streams, stats, keep = {}, {}, None
    for label, cfg in runs.items():
        eng, streams[label], stats[label] = serve_traffic(cfg, label)
        if label == "dense_b8":
            keep = eng
        else:
            del eng
        torch.cuda.empty_cache()
    _, prompts, sampling = engine_traffic()
    for label, base in (("dense_b8", "dense_b1"),
                        ("dense_b8_sequential", "dense_b1"),
                        ("paged_kernel_b8", "paged_kernel_b1")):
        same = streams[label] == streams[base]
        print(f"dense_fused_streams {label}_vs_{base} identical={same}",
              flush=True)
        if not same:
            fail(f"streams differ between {base} and {label}")
    same = streams["paged_kernel_b8"] == streams["paged_gather_b8"]
    print(f"dense_fused_streams paged_kernel_b8_vs_paged_gather_b8 "
          f"identical={same} (bf16: not required)", flush=True)
    for i, (t, _) in enumerate(sampling):
        if t > 0:
            continue
        where = greedy_divergence(keep, prompts[i],
                                  streams["dense_b8"][i],
                                  streams["paged_gather_b8"][i])
        print(f"dense_fused_greedy request={i} dense_vs_paged_gather "
              f"{'identical' if where is None else 'near-tie at ' + where}",
              flush=True)
    return {"stats": stats, "engine": keep}


def check_small_engines_sampled_against_cpu() -> None:
    """A small f32 engine's greedy and sampled streams on the card equal
    the CPU's, dense (decode_block 1 and 4) and paged (kernel, block 4),
    same weights."""
    import torch

    from tpumon_torch.loadgen.model import ModelConfig, init_params
    from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine

    model = ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=256, max_seq=128,
                        compute_dtype="float32")
    params = init_params(model, torch.Generator().manual_seed(3))
    rng = random.Random(4)
    prompts = [[rng.randrange(256) for _ in range(n)]
               for n in (5, 40, 17, 64, 9)]
    sampling = [(0.0, 0), (0.8, 0), (0.8, 50), (1.3, 5), (0.0, 0)]
    for layout, attn, block in (("dense", "gather", 1),
                                ("dense", "gather", 4),
                                ("paged", "kernel", 4)):
        cfg = ServeConfig(model=model, slots=3, prefill_len=16,
                          kv_layout=layout, paged_attn=attn,
                          decode_block=block)
        streams = {}
        for dev in ("cpu", "cuda"):
            eng = ServingEngine(cfg=cfg, params=params, seed=7, device=dev)
            reqs = [eng.submit(p, max_new=12, temperature=t, top_k=k)
                    for p, (t, k) in zip(prompts, sampling)]
            eng.drain()
            streams[dev] = [r.output for r in reqs]
        same = streams["cpu"] == streams["cuda"]
        print(f"small_engine_cuda_vs_cpu f32 {layout}/{attn} "
              f"decode_block={block} greedy+sampled "
              f"streams_identical={same}", flush=True)
        if not same:
            fail(f"small {layout} engine: card streams differ from the CPU's")


def check_sampler(eng) -> dict:
    """sample_tokens on the card against its CPU run on the same [16,
    4096] logits (a dense decode step's), over 8 token counters; then its
    time against the greedy argmax. Returns the logits and the sampler's
    inputs for the timings."""
    import torch

    from tpumon_torch import prng
    from tpumon_torch.loadgen.serving import decode_step, sample_tokens

    _, prompts, _ = engine_traffic()
    i32 = dict(dtype=torch.int32, device="cuda")
    last = torch.tensor([p[-1] for p in prompts], **i32)
    pos = torch.tensor([len(p) for p in prompts], **i32)
    logits = decode_step(eng.cfg, eng.params, eng.cache, last, pos)
    temps = torch.tensor([0.0, 0.8, 1.3, 0.8] * 4, device="cuda")
    topk = torch.tensor([0, 0, 50, 1] * 4, **i32)
    rids = torch.arange(16, **i32) * 7
    key = prng.torch_key(0x7A11, "cuda")
    near = mismatched = 0
    for ctr in range(8):
        ctrs = torch.full((16,), ctr, **i32)
        card = sample_tokens(logits, key, rids, ctrs, temps, topk).cpu()
        args = [t.cpu() for t in (logits, key, rids, ctrs, temps, topk)]
        cpu = sample_tokens(*args)
        tie = sample_margin(*args) <= SAMPLE_MARGIN
        near += int(tie.sum())
        mismatched += int(((card != cpu) & ~tie).sum())
    print(f"sampler_card_vs_cpu shape=[16, 4096] draws=128 "
          f"mismatched_outside_margin={mismatched} near_ties={near} "
          f"margin={SAMPLE_MARGIN}", flush=True)
    if mismatched or near >= 0.01 * 128:
        fail("sample_tokens on the card disagrees with its CPU run")
    return {"logits": logits, "args": (key, rids, torch.zeros_like(rids),
                                       temps, topk)}


def time_dense_and_fused(eng, runs: dict, sampler: dict) -> None:
    """Phase 16's times: the dense decode step at decode_block 1 and 8
    (CUDA events; the host's enqueue time), one sample_tokens call against
    the greedy argmax, with its fused draws' launches and device time,
    where a dense step's device time goes and the idle share, and the
    runs' tokens/s and TTFT p50 at block 8."""
    import torch

    from tpumon_torch.loadgen.serving import (
        decode_rounds,
        decode_step,
        sample_tokens,
    )
    from tpumon_torch.ops import threefry

    _, prompts, _ = engine_traffic()
    i32 = dict(dtype=torch.int32, device="cuda")
    last = torch.tensor([p[-1] for p in prompts], **i32)
    pos = torch.tensor([len(p) for p in prompts], **i32)
    key, rids, ctrs, temps, topk = sampler["args"]
    cfg, params, cache = eng.cfg, eng.params, eng.cache

    def step():
        decode_step(cfg, params, cache, last, pos)

    def block():
        decode_rounds(cfg, params, cache, last, pos, key, rids, ctrs,
                      temps, topk, 8)

    ms = {"step_b1": cuda_ms(step, reps=20),
          "step_b8": cuda_ms(block, reps=5) / 8}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    logits = sampler["logits"]
    def sample():
        sample_tokens(logits, key, rids, ctrs, temps, topk)

    sample_ms = cuda_ms(sample, reps=20)
    greedy_ms = cuda_ms(lambda: torch.argmax(logits, dim=-1), reps=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        sample()
    sample_host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    before = threefry.launch_counts()
    sample()
    draws = {k: v - before[k] for k, v in threefry.launch_counts().items()}
    sample_busy = device_busy(sample)
    print(f"dense_step decoding_slots=16 step_ms_b1={ms['step_b1']!r} "
          f"step_ms_b8={ms['step_b8']!r} host_enqueue_ms_b1={host_ms!r}",
          flush=True)
    print(f"sampler shape=[16, 4096] sample_tokens_ms={sample_ms!r} "
          f"host_enqueue_ms={sample_host_ms!r} "
          f"greedy_argmax_ms={greedy_ms!r} threefry_launches={draws} "
          f"device_kernels_per_call="
          f"{None if sample_busy is None else sample_busy[2]!r} "
          f"device_busy_ms={None if sample_busy is None else sample_busy[0]!r}",
          flush=True)
    for label, fn in (("b1", step), ("b8", block)):
        tr = trace_step(fn)
        if tr is None:
            print(f"dense_step_trace {label} device_busy=not measured (the "
                  f"profiler recorded no device activity)", flush=True)
        else:
            print(f"dense_step_trace {label} wall_ms={tr['wall_ms']!r} "
                  f"device_busy_ms={tr['busy_ms']!r} device_idle_share="
                  f"{tr['idle_share']!r} kernels_per_call="
                  f"{tr['kernels_per_step']!r} matmul_ms={tr['matmul']!r} "
                  f"other_ms={tr['other']!r} top={tr['top_ms']}",
                  flush=True)
    for label in ("dense_b8", "paged_kernel_b8", "paged_gather_b8",
                  "dense_b1", "paged_kernel_b1"):
        st = runs[label]
        print(f"dense_fused_times {label} tokens_per_s="
              f"{st['tokens_per_s']!r} ttft_p50_ms={st['ttft_p50_ms']!r} "
              f"ttft_p95_ms={st['ttft_p95_ms']!r} decode_steps={st['steps']} "
              f"paged_kernel_launches={st['launches']}", flush=True)


# Phase 17: the fused Threefry draws (csrc/threefry.cu) against their plain
# versions (tpumon_torch/prng.py's torch functions). A kernel computes
# what its plain version computes, step for step and rounded alike, so
# the limit is equality of every element.
THREEFRY_KERNELS = ("threefry_keys", "threefry_draw", "threefry_categorical")
# Instructions an element, for the bounds, at the fewest a compiler can
# issue: Threefry-2x32's 20 rounds are 60 (add, rotate, xor); of its 12
# key adds, the 5 into x0 that a round's add follows fold into that add
# (IADD3), leaving 7: 67 in all. A bf16 normal adds one: the XOR of the
# two words and the mask of the 7 mantissa bits that index its table (the
# kernel looks the normal up among the 128 values a CTA computes once)
# fold into one LOP3: 68. The categorical adds the XOR, a Gumbel's uniform
# 6, two logs about 64, its sum and comparison 3: 141. Each is counted at the
# card's issue rate, one 32-bit instruction a lane a clock (SMs x 128
# lanes x the maximum SM clock, read from the card), which no instruction
# stream exceeds, so each bound is a least time. (The float32 FLOP rate,
# used before, counts an FMA as two and so halved the bounds.)
THREEFRY_OPS = {"keys": 67, "normal_bf16": 68, "categorical": 141}
# The normal draw is also timed at [8, 4096, 4096], where one call's
# device time is 8x the 4096^2 draw's and dwarfs the wrapper's host time,
# so back-to-back launches keep the card busy: device-bound.
THREEFRY_DEVICE_BOUND_SHAPE = (8, 4096, 4096)


def issue_rate() -> tuple[float, int, float]:
    """(32-bit instructions a second, SMs, maximum SM clock Hz) of card 0:
    SMs x 128 lanes x the clock nvidia-smi gives as clocks.max.sm."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = float(smi("clocks.max.sm")[0]) * 1e6
    return sms * 128 * clock, sms, clock


def threefry_cases(gen) -> dict:
    """By kernel, (label, fused call, plain call) at the shapes the paths
    give it: the sampler's keys and categorical, the burns' inputs."""
    import torch

    from tpumon_torch import prng
    from tpumon_torch.ops import threefry

    dev = torch.device("cuda")
    key = prng.torch_key(0, dev)
    base = prng.torch_key(0x7A11, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    rids = torch.arange(16, **i32) * 7
    ctrs = torch.arange(16, **i32) + 3
    rows = prng.torch_fold_in(base, rids)
    logits = torch.randn(16, 4096, device=dev, generator=gen) * 3
    logits[::4, 50:] = -1e30  # top-k 50 rows, as the sampler masks them
    logits = logits / 0.8
    bf16 = torch.bfloat16
    n4096 = (4096, 4096)
    return {
        "threefry_keys": [
            ("fold_in [16] rids", lambda f: f(base, rids), "fold_in"),
            ("fold_in [16, 2] ctrs", lambda f: f(rows, ctrs), "fold_in"),
            ("fold_in calls", lambda f: f(key, 12345), "fold_in"),
            ("split 96", lambda f: f(key, 96), "split")],
        "threefry_draw": [
            ("normal 4096^2 bf16", lambda f: f(key, n4096, bf16), "normal"),
            ("randint 4096^2 int8", lambda f: f(key, n4096, -127, 128,
                                                torch.int8), "randint"),
            ("normal pool [8, 512, 128, 128] bf16",
             lambda f: f(key, (8, 512, 128, 128), bf16), "normal"),
            ("normal queries [96] x [16, 32, 128] bf16",
             lambda f: f(prng.torch_split(key, 96), (16, 32, 128), bf16),
             "normal"),
            ("permutation 512", lambda f: f(key, 512), "permutation")],
        "threefry_categorical": [
            ("categorical [16, 4096]",
             lambda f: f(prng.torch_fold_in(rows, ctrs), logits),
             "categorical")],
    }, {"fold_in": (threefry.fold_in, prng.torch_fold_in),
        "split": (threefry.split, prng.torch_split),
        "normal": (threefry.normal, prng.normal),
        "randint": (threefry.randint, prng.torch_randint),
        "permutation": (threefry.permutation, prng.permutation),
        "categorical": (threefry.categorical, prng.categorical)}


def check_threefry(gen, bw: float, peaks: dict) -> dict:
    """Phase 17: every case of each fused draw equal to its plain version
    on the card; then, at the shape each path gives it (the sampler's
    first fold_in, the burn's 4096^2 bf16 normal, the sampler's
    categorical), the kernel's time beside the plain version's and the
    bound. Returns the kernels summary's fields by kernel."""
    import torch

    from tpumon_torch import prng
    from tpumon_torch.ops import threefry

    before = threefry.launch_counts()
    cases, fns = threefry_cases(gen)
    out = {}
    for kernel, rows in cases.items():
        worst = 0.0
        for label, call, name in rows:
            fused, plain = fns[name]
            got, want = call(fused), call(plain)
            err = float((got.double() - want.double()).abs().max())
            same = got.dtype == want.dtype and torch.equal(got, want)
            print(f"threefry_check kernel={kernel} case={label!r} "
                  f"shape={list(got.shape)} dtype={got.dtype} equal={same} "
                  f"max_abs_err={err!r}", flush=True)
            if not same:
                fail(f"{kernel}: {label} differs from the plain version")
            worst = max(worst, err)
        out[kernel] = {"max_abs_err": worst}
    dev = torch.device("cuda")
    key = prng.torch_key(0, dev)
    rids = torch.arange(16, dtype=torch.int32, device=dev) * 7
    logits = torch.randn(16, 4096, device=dev, generator=gen)
    keys16 = prng.torch_fold_in(key, rids)
    rate, sms, clock = issue_rate()
    print(f"threefry_issue_rate ops_per_s={rate!r} (SMs {sms} x 128 lanes x "
          f"clocks.max.sm {clock / 1e6!r} MHz)", flush=True)
    big = THREEFRY_DEVICE_BOUND_SHAPE
    n_big = big[0] * big[1] * big[2]
    timed = {
        "threefry_keys": (
            lambda: threefry.fold_in(key, rids),
            lambda: prng.torch_fold_in(key, rids),
            16 + 16 * 4 + 16 * 16, 16 * THREEFRY_OPS["keys"],
            "fold_in [16] int32 rids"),
        "threefry_draw": (
            lambda: threefry.normal(key, (4096, 4096), torch.bfloat16),
            lambda: prng.normal(key, (4096, 4096), torch.bfloat16),
            16 + 4096 * 4096 * 2, 4096 * 4096 * THREEFRY_OPS["normal_bf16"],
            "normal 4096^2 bf16"),
        "threefry_draw_device_bound": (
            lambda: threefry.normal(key, big, torch.bfloat16),
            lambda: prng.normal(key, big, torch.bfloat16),
            16 + n_big * 2, n_big * THREEFRY_OPS["normal_bf16"],
            f"normal {list(big)} bf16"),
        "threefry_categorical": (
            lambda: threefry.categorical(keys16, logits),
            lambda: prng.categorical(keys16, logits),
            16 * 16 + 16 * 4096 * 4 + 16 * 8,
            16 * 4096 * THREEFRY_OPS["categorical"],
            "categorical [16, 4096] f32")}
    for kernel, (fused, plain, nbytes, ops, shape) in timed.items():
        big_case = kernel.endswith("_device_bound")
        ms = cuda_ms(fused, reps=20 if big_case else 50, warmup=3)
        plain_ms = cuda_ms(plain, reps=2 if big_case else 5, warmup=1)
        busy = device_busy(fused, reps=5 if big_case else 20)
        bytes_ms, ops_ms = nbytes / bw * 1e3, ops / rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        print(f"time_threefry kernel={kernel} shape={shape!r} ms={ms!r} "
              f"plain_ms={plain_ms!r} bound_ms={bound_ms!r} ({bound_by}; "
              f"bytes {nbytes}, operations {ops}) library_ms=None (no "
              f"library call draws jax's threefry) kernel_over_bound="
              f"{ms / bound_ms!r} device_ms="
              f"{None if busy is None else busy[0]!r} (profiler, all "
              f"device kernels of a call)", flush=True)
        if big_case:
            if ms < bound_ms:
                fail(f"threefry normal {shape}: {ms!r} ms under its bound "
                     f"{bound_ms!r} ms: the count, the rate or the timing is "
                     "off")
            # The summary's draw row: the device-bound reading.
            kernel = "threefry_draw"
        out[kernel].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)
    for name, n in before.items():  # the check's launches are not the paths'
        getattr(threefry, name).launches = n
    return out


# Phase 18: the rest of the serving engine at production width (phase 4's
# model): prefix caching, speculative decoding, int8 KV and weights, the
# actuator verbs and the traffic simulator. Each run is a fresh engine
# (random weights from seed 0, as phase 4's) with the paged kernel's and
# the fused draws' counts set to 0 just before it and read just after.


def short_traffic() -> tuple:
    """16 prompts of 64-512 tokens, each asking 32 new tokens, with phase
    16's sampling settings (even requests greedy)."""
    rng = random.Random(18)
    prompts = [[rng.randrange(4096) for _ in range(rng.randint(64, 512))]
               for _ in range(16)]
    return prompts, engine_traffic()[2]


def prefix_traffic() -> tuple:
    """16 prompts behind one 2048-token system prompt (16 pages), each
    with its own tail of 64-512 tokens; phase 16's sampling settings. A
    prefix cache keys each prompt's longest chunk-aligned strict prefix,
    so the first request's tail is 64 tokens: its key is the system
    prompt itself, which the other 15 then share."""
    rng = random.Random(19)
    system = [rng.randrange(4096) for _ in range(2048)]
    tails = [64] + [rng.randint(64, 512) for _ in range(15)]
    prompts = [system + [rng.randrange(4096) for _ in range(n)]
               for n in tails]
    return prompts, engine_traffic()[2]


def periodic_traffic() -> tuple:
    """Prompt lookup's case: 16 prompts of 256-512 tokens that repeat a
    random period of 8-64 tokens; all greedy."""
    rng = random.Random(20)
    prompts = []
    for _ in range(16):
        period = [rng.randrange(4096) for _ in range(rng.randint(8, 64))]
        n = rng.randint(256, 512)
        prompts.append([period[i % len(period)] for i in range(n)])
    return prompts, [(0.0, 0)] * 16


def feature_config(**kw):
    """Phase 4's model and shape with the dense cache (the defaults) and
    ``kw`` over it."""
    import dataclasses

    return dataclasses.replace(
        engine_config("gather", kv_layout="dense"), **kw)


def serve_features(cfg, label: str, traffic: tuple, staged: bool = False,
                   max_new: int = 32, engine=None, **engine_kw) -> tuple:
    """``traffic`` through a fresh engine on the card (or ``engine``), the
    paged kernel's and the draws' counts set to 0 just before and read
    just after. ``staged``: the first request alone until its first token,
    then the rest (so a prefix cache holds the shared prefix by then).
    Checks every request completed with max_new + 1 tokens, the kernel's
    launches (n_layers per plain decode step on the kernel path, none
    elsewhere) and the draws (two key folds per categorical). Returns
    (engine, streams, stats)."""
    import torch

    from tpumon_torch.loadgen.serving import ServingEngine
    from tpumon_torch.ops import threefry
    from tpumon_torch.ops.paged_attention import paged_attention
    from tpumon_torch.tracing import quantiles

    prompts, sampling = traffic
    eng = engine or ServingEngine(cfg=cfg, seed=0, device="cuda",
                                  **engine_kw)
    torch.cuda.synchronize()
    paged_attention.launches = 0
    threefry.set_launch_counts(0)
    t0 = time.perf_counter()

    def submit(i):
        t, k = sampling[i]
        return eng.submit(prompts[i], max_new=max_new, temperature=t,
                          top_k=k)

    if staged:
        reqs = [submit(0)]
        while not reqs[0].output:
            eng.step()
        reqs += [submit(i) for i in range(1, len(prompts))]
    else:
        reqs = [submit(i) for i in range(len(prompts))]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_attention.launches
    draws = threefry.launch_counts()
    m = eng.cfg.model
    plain_steps = eng.decode_steps_total - eng.spec_rounds_total
    ttfts = [r.ttft_s * 1e3 for r in reqs]
    stats = {"wall_s": wall, "tokens": eng.tokens_total,
             "tokens_per_s": eng.tokens_total / wall,
             "target_dispatches": eng.decode_steps_total,
             "spec_rounds": eng.spec_rounds_total,
             "spec_proposed": eng.spec_proposed_total,
             "spec_accepted": eng.spec_accepted_total,
             "acceptance_pct": (100.0 * eng.spec_accepted_total
                                / eng.spec_proposed_total
                                if eng.spec_proposed_total else None),
             "ttft_p50_ms": quantiles(ttfts)[0],
             "ttft_p50_ms_after_first": quantiles(ttfts[1:])[0],
             "launches": launches, "threefry": draws,
             "prefix": eng._stats_snapshot()["prefix"]}
    print(f"features_run {label} " + " ".join(
        f"{k}={v!r}" for k, v in stats.items()), flush=True)
    bad = [r.rid for r in reqs
           if r.status != "completed" or len(r.output) != max_new + 1]
    if bad:
        fail(f"{label}: requests {bad} did not complete with "
             f"{max_new + 1} tokens")
    kernel = eng.cfg.kv_layout == "paged" and eng.cfg.paged_attn == "kernel"
    want = m.n_layers * plain_steps if kernel else 0
    if launches != want or (kernel and plain_steps == 0):
        fail(f"{label}: kernel launches {launches} != n_layers x plain "
             f"decode steps ({m.n_layers} x {plain_steps})")
    if (draws["threefry_keys"] != 2 * draws["threefry_categorical"]
            or draws["threefry_draw"]
            or draws["threefry_categorical"] < len(reqs)):
        fail(f"{label}: threefry launches {draws}")
    return eng, [r.output for r in reqs], stats


def first_divergences(eng, label: str, prompts, sampling, got, want,
                      what: str) -> None:
    """Greedy requests: ``got`` equal to ``want`` up to the first near-tie
    (greedy_divergence fails on any other), printed."""
    for i, (t, _) in enumerate(sampling):
        if t > 0:
            continue
        where = greedy_divergence(eng, prompts[i], got[i], want[i])
        print(f"features_greedy {label} request={i} {what} "
              f"{'identical' if where is None else 'near-tie at ' + where}",
              flush=True)


def agreement(got, want) -> str:
    """How far two runs' streams agree: identical requests, and tokens
    before each request's first difference."""
    same = sum(a == b for a, b in zip(got, want))
    lead = sum(next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    len(a)) for a, b in zip(got, want))
    total = sum(len(a) for a in want)
    return f"identical_requests={same}/{len(want)} leading_tokens={lead}/{total}"


def check_prefix() -> dict:
    """Prefix caching, dense (4 entries) and paged kernel at block 8 with
    the admission lookahead: each stream equal to the same engine's with
    the cache off, hits counted, TTFT p50 cold against hit."""
    import dataclasses

    import torch

    traffic = prefix_traffic()
    out = {}
    for label, base in (
            ("dense", feature_config()),
            ("paged_kernel_b8_la2", dataclasses.replace(
                engine_config("kernel", decode_block=8),
                admit_lookahead=2))):
        _, cold, cold_st = serve_features(base, f"prefix_{label}_off",
                                          traffic, staged=True)
        torch.cuda.empty_cache()
        _, hot, hot_st = serve_features(
            dataclasses.replace(base, prefix_cache_entries=4),
            f"prefix_{label}_on", traffic, staged=True)
        pc = hot_st["prefix"]
        same = hot == cold
        print(f"prefix {label} streams_identical_to_cache_off={same} "
              f"hits={pc['hits']} misses={pc['misses']} saved_tokens="
              f"{pc['saved_tokens']} resident_bytes={pc['bytes']} "
              f"ttft_p50_ms cold={cold_st['ttft_p50_ms_after_first']!r} "
              f"hit={hot_st['ttft_p50_ms_after_first']!r} tokens_per_s "
              f"cold={cold_st['tokens_per_s']!r} "
              f"hit={hot_st['tokens_per_s']!r}", flush=True)
        if not same:
            fail(f"prefix {label}: cache-on streams differ from cache-off")
        if pc["hits"] < len(traffic[0]) - 1:
            fail(f"prefix {label}: {pc['hits']} hits, want "
                 f"{len(traffic[0]) - 1}")
        out[label] = {"cold": cold_st, "hit": hot_st}
        torch.cuda.empty_cache()
    return out


def check_spec() -> dict:
    """Speculative decoding at production width (sequential scheduler:
    each prompt prefills inline at admission, so the dense rounds never
    wait on a slot mid-prefill): acceptance, target dispatches and
    tokens/s beside plain decode of the same layout and traffic; bf16
    greedy streams equal plain decode's up to the first near-tie."""
    import dataclasses

    import torch

    half = dataclasses.replace(feature_config().model, n_layers=1)
    paged = {"kv_layout": "paged", "paged_attn": "kernel"}
    runs = {  # label: (layout, speculation, traffic)
        "dense_self_g3": ({}, {"spec_len": 3}, "short"),
        "dense_draft_1of2_g3": ({}, {"spec_len": 3, "draft_model": half},
                                "short"),
        "dense_prompt_g15": ({}, {"spec_len": 15, "spec_source": "prompt"},
                             "periodic"),
        "paged_kernel_self_g3": (paged, {"spec_len": 3}, "short"),
    }
    traffics = {"short": short_traffic(), "periodic": periodic_traffic()}
    plain, out = {}, {}
    for label, (layout, spec, tname) in runs.items():
        traffic = traffics[tname]
        base = feature_config(scheduler="sequential", **layout)
        key = (tuple(layout), tname)
        if key not in plain:
            _, streams, st = serve_features(base, f"spec_plain_{label}",
                                            traffic)
            plain[key] = (streams, st)
            torch.cuda.empty_cache()
        pstreams, pst = plain[key]
        eng, streams, st = serve_features(
            dataclasses.replace(base, **spec), f"spec_{label}", traffic)
        print(f"spec {label} acceptance_pct={st['acceptance_pct']!r} "
              f"target_dispatches={st['target_dispatches']} (plain "
              f"{pst['target_dispatches']}) tokens_per_s="
              f"{st['tokens_per_s']!r} (plain {pst['tokens_per_s']!r}) "
              f"vs_plain {agreement(streams, pstreams)}", flush=True)
        first_divergences(eng, f"spec_{label}", traffic[0], traffic[1],
                          streams, pstreams, "spec_vs_plain")
        if st["spec_rounds"] == 0:
            fail(f"spec {label}: no speculative round ran")
        out[label] = st
        del eng
        torch.cuda.empty_cache()
    return out


def small_engines_against_cpu(label: str, runs: dict,
                              n_experts: int = 0) -> None:
    """A small f32 engine (of ``n_experts`` experts a layer, 0: dense) of
    each kind in ``runs`` ({name: ServeConfig fields}) emits the CPU's
    streams on the card, greedy and sampled, on the same weights;
    self-speculation accepts every proposal."""
    import dataclasses

    import torch

    from tpumon_torch.loadgen.model import ModelConfig, init_params
    from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine

    model = ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=256, max_seq=128,
                        compute_dtype="float32", n_experts=n_experts)
    params = init_params(model, torch.Generator().manual_seed(3))
    rng = random.Random(4)
    prompts = [[rng.randrange(256) for _ in range(n)]
               for n in (5, 40, 17, 64, 9)]
    prompts[4] = [7, 1, 9] * 8  # periodic: prompt lookup finds it
    sampling = [(0.0, 0), (0.8, 0), (0.8, 50), (0.0, 0), (0.0, 0)]
    for name, over in runs.items():
        if over.get("draft_model") == "half":
            over = {**over, "draft_model": dataclasses.replace(
                model, n_layers=1)}
        cfg = ServeConfig(model=model, slots=3, prefill_len=16, **over)
        streams, engines = {}, {}
        for dev in ("cpu", "cuda"):
            eng = ServingEngine(cfg=cfg, params=params, seed=7, device=dev)
            reqs = [eng.submit(p, max_new=12, temperature=t, top_k=k)
                    for p, (t, k) in zip(prompts, sampling)]
            eng.drain()
            streams[dev], engines[dev] = [r.output for r in reqs], eng
        card = engines["cuda"]
        same = streams["cpu"] == streams["cuda"]
        print(f"small_engine_cuda_vs_cpu f32 {label} {name} "
              f"streams_identical={same} spec_accepted="
              f"{card.spec_accepted_total}/{card.spec_proposed_total}",
              flush=True)
        if not same:
            fail(f"small {label} {name} engine: card streams differ from "
                 f"the CPU's")
        if (name.endswith("self") and card.spec_accepted_total
                != card.spec_proposed_total):
            fail(f"small {name} engine: self-speculation rejected a "
                 f"proposal on the card")


def resident_bytes(eng) -> tuple:
    from tpumon_torch.loadgen.model import leaf_bytes, param_bytes

    store = eng.pool if eng.paged else eng.cache
    return param_bytes(eng.params), sum(leaf_bytes(t)
                                        for t in store.values())


def check_int8() -> dict:
    """int8 KV (dense block 8, paged gather), int8 weights (dense block
    8) and both: every run completes; agreement with the bf16 streams;
    resident weight and KV bytes and memory_allocated against bf16; the
    dense decode step in ms against bf16 (and its device time by kernel
    from the profiler), and the per-step dequantize of the int8 weights
    alone."""
    import dataclasses

    import torch

    from tpumon_torch.loadgen.model import param_leaves
    from tpumon_torch.loadgen.quant import QTensor
    from tpumon_torch.loadgen.serving import ServingEngine, decode_step

    traffic = short_traffic()
    runs = {
        "bf16_dense_b8": feature_config(decode_block=8),
        "kv8_dense_b8": feature_config(decode_block=8, kv_dtype="int8"),
        "bf16_paged_gather": engine_config("gather"),
        "kv8_paged_gather": dataclasses.replace(engine_config("gather"),
                                                kv_dtype="int8"),
        "w8_dense_b8": feature_config(decode_block=8, quantize="int8"),
        "w8_kv8_dense_b8": feature_config(decode_block=8, kv_dtype="int8",
                                          quantize="int8"),
    }
    prompts, _ = traffic
    i32 = dict(dtype=torch.int32, device="cuda")
    vocab = feature_config().model.vocab
    last = torch.tensor([p[-1] % vocab for p in prompts], **i32)
    pos = torch.tensor([len(p) for p in prompts], **i32)
    streams, out = {}, {}
    for label, cfg in runs.items():
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        eng = ServingEngine(cfg=cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated() - base_mem
        wbytes, kvbytes = resident_bytes(eng)
        _, streams[label], st = serve_features(cfg, f"int8_{label}",
                                               traffic, engine=eng)
        step_ms = None
        if not eng.paged:
            def step():
                decode_step(eng.cfg, eng.params, eng.cache, last, pos)

            step_ms = cuda_ms(step, reps=10)
            tr = trace_step(step)
            print(f"int8_trace {label} " + ("device_busy=not measured (the "
                  "profiler recorded no device activity)" if tr is None else
                  f"wall_ms={tr['wall_ms']!r} device_busy_ms="
                  f"{tr['busy_ms']!r} device_idle_share={tr['idle_share']!r} "
                  f"kernels_per_step={tr['kernels_per_step']!r} matmul_ms="
                  f"{tr['matmul']!r} other_ms={tr['other']!r} "
                  f"top={tr['top_ms']}"), flush=True)
        st.update(weight_bytes=wbytes, kv_bytes=kvbytes,
                  memory_allocated=alloc, decode_step_ms=step_ms)
        if cfg.quantize:
            qs = [x for x in param_leaves(eng.params)
                  if isinstance(x, QTensor)]
            st["dequantize_ms"] = cuda_ms(
                lambda: [x.to(torch.bfloat16) for x in qs], reps=10)
        base = "bf16_paged_gather" if eng.paged else "bf16_dense_b8"
        print(f"int8 {label} weight_bytes={wbytes} kv_bytes={kvbytes} "
              f"memory_allocated={alloc} decode_step_ms={step_ms!r} "
              f"dequantize_ms={st.get('dequantize_ms')!r} tokens_per_s="
              f"{st['tokens_per_s']!r} vs_{base} "
              f"{agreement(streams[label], streams[base])}", flush=True)
        out[label] = st
        del eng
    return out


def check_actuator() -> dict:
    """The actuator verbs at production width (paged kernel engine,
    block 1, the short traffic): shedding half a tenant's submissions; a
    slice drained mid-flight requeues its requests, and every stream
    equals the undrained run's; evict_all on one engine and adopt on a
    second give the same streams; nudge_capacity takes effect on the
    next step."""
    import torch

    from tpumon_torch.loadgen.serving import ServingEngine

    cfg = engine_config("kernel")
    traffic = short_traffic()
    prompts, sampling = traffic
    _, want, st = serve_features(cfg, "actuate_undrained", traffic)
    # Shed: fraction 0.5 sheds exactly every second submission.
    eng = ServingEngine(cfg=cfg, seed=0, device="cuda")
    eng.set_shed("t", 0.5)
    reqs = [eng.submit(p, max_new=2, tenant="t") for p in prompts]
    eng.drain()
    shed = sum(r.status == "shed" for r in reqs)
    served = sum(r.status == "completed" for r in reqs)
    text = eng.metrics_text()
    print(f"actuate shed fraction=0.5 submitted={len(reqs)} shed={shed} "
          f"completed={served}", flush=True)
    if shed != round(len(reqs) / 2) or served != len(reqs) - shed or (
            f'tpumon_serving_tenant_shed{{tenant="t"}} {shed}' not in text):
        fail("set_shed(t, 0.5) did not shed half the submissions")
    # Drain a slice mid-flight.
    eng = ServingEngine(cfg=cfg, seed=0, device="cuda")
    eng.set_slices(["a", "b"])
    from tpumon_torch.ops.paged_attention import paged_attention

    paged_attention.launches = 0
    reqs = [eng.submit(p, max_new=32, temperature=t, top_k=k)
            for p, (t, k) in zip(prompts, sampling)]
    for i in range(10_000):
        if i == 24:
            eng.drain_slice("a")
        if i == 40:
            eng.undrain_slice("a")
        if not eng.step():
            break
    got = [r.output for r in reqs]
    launches = paged_attention.launches
    print(f"actuate drain requeued={eng.requeued_total} requeues="
          f"{[r.requeues for r in reqs]} streams_identical_to_undrained="
          f"{got == want} kernel_launches={launches} decode_steps="
          f"{eng.decode_steps_total}", flush=True)
    if eng.requeued_total == 0 or got != want:
        fail("slice drain: no requeue, or streams differ from undrained")
    if launches != cfg.model.n_layers * eng.decode_steps_total:
        fail("slice drain: kernel launches != n_layers x decode steps")
    del eng
    # Evict from one engine, adopt into a second.
    first = ServingEngine(cfg=cfg, seed=0, device="cuda")
    reqs = [first.submit(p, max_new=32, temperature=t, top_k=k)
            for p, (t, k) in zip(prompts, sampling)]
    for _ in range(30):
        first.step()
    evicted = first.evict_all()
    second = ServingEngine(cfg=cfg, seed=0, device="cuda")
    for r in reversed(evicted):
        second.adopt(r)
    second.drain()
    got = [r.output for r in reqs]
    print(f"actuate evict_adopt evicted={len(evicted)} requeued="
          f"{first.requeued_total} streams_identical={got == want}",
          flush=True)
    if first.load() or got != want or not evicted:
        fail("evict_all + adopt: streams differ from the undrained run")
    del first, second
    torch.cuda.empty_cache()
    # nudge_capacity: the prefill budget of the very next step.
    eng = ServingEngine(cfg=feature_config(), seed=0, device="cuda")
    p = eng.cfg.prefill_len
    eng.submit(prompts[0][:p // 2], max_new=32)  # one chunk, then decodes
    longs = [eng.submit((prompts[i] * 16)[:8 * p], max_new=4)
             for i in range(1, 5)]
    eng.step()  # nothing decodes yet: a chunk for every slot

    def chunks():
        return sum(w.next_c0 for w in eng._prefill_work
                   if w is not None) // eng.cfg.prefill_len

    moved = []
    for budget in (1, 4, 1):
        eng.nudge_capacity(prefill_budget=budget)
        before = chunks()
        eng.step()
        moved.append(chunks() - before)
    print(f"actuate nudge prefill_budget 1 -> 4 -> 1: chunks in the next "
          f"step {moved}", flush=True)
    eng.drain()
    if moved != [1, 4, 1] or not all(r.status == "completed" for r in longs):
        fail(f"nudge_capacity: chunks per step {moved}, want [1, 4, 1]")
    return st


def check_traffic() -> None:
    """A two-tenant TrafficSim behind the /metrics server for a few
    seconds (paged kernel engine with the prefix cache): the tenant
    families appear, tpumon_serving_tenant_shed among them."""
    import dataclasses

    from tpumon_torch.loadgen.traffic import (
        TenantSpec,
        start_traffic_background,
    )
    from tpumon_torch.ops.paged_attention import paged_attention

    tenants = [TenantSpec(name="chat", scenario="chat", rps=6.0),
               TenantSpec(name="rag", scenario="rag", rps=2.0,
                          prompt_chunks=8)]
    cfg = dataclasses.replace(engine_config("kernel"),
                              prefix_cache_entries=4)
    paged_attention.launches = 0
    engine, sim, url, stop = start_traffic_background(
        tenants, cfg=cfg, seed=0, device="cuda")
    try:
        engine.set_shed("chat", 0.5)
        time.sleep(4.0)
        with urllib.request.urlopen(url, timeout=30) as resp:
            text = resp.read().decode()
    finally:
        stop.set()
        sim._thread.join(timeout=60)
    launches = paged_attention.launches
    want = [f'{fam}{{tenant="{t}"}}' for t in ("chat", "rag")
            for fam in ("tpumon_serving_tenant_requests",
                        "tpumon_serving_tenant_shed",
                        "tpumon_serving_tenant_completed")]
    missing = [w for w in want if w not in text]
    print(f"traffic sim={json.dumps(sim.to_json())} completed="
          f"{engine.completed_total} shed={engine.shed_total} prefix_hits="
          f"{engine.prefix_cache.hits} kernel_launches={launches} "
          f"decode_steps={engine.decode_steps_total} missing={missing}",
          flush=True)
    if sim._thread.is_alive() or missing or engine.completed_total == 0:
        fail("traffic: the sim did not serve both tenants' families")
    if launches != cfg.model.n_layers * engine.decode_steps_total:
        fail("traffic: kernel launches != n_layers x decode steps")


def phase18() -> dict:
    t0 = time.perf_counter()
    out = {"prefix": check_prefix()}
    out["spec"] = check_spec()
    kinds = {"dense_self": {"spec_len": 3},
             "dense_draft_half": {"spec_len": 3, "draft_model": "half"},
             "dense_prompt": {"spec_len": 6, "spec_source": "prompt"},
             "paged_kernel_self": {"spec_len": 3, "kv_layout": "paged",
                                   "paged_attn": "kernel"}}
    small_engines_against_cpu("spec", kinds)
    out["int8"] = check_int8()
    small_engines_against_cpu("int8", {
        "kv8_dense_b4": {"kv_dtype": "int8", "decode_block": 4},
        "kv8_paged_gather": {"kv_dtype": "int8", "kv_layout": "paged"},
        "w8_dense_b4": {"quantize": "int8", "decode_block": 4},
        "w8_kv8_dense": {"quantize": "int8", "kv_dtype": "int8"}})
    out["actuate"] = check_actuator()
    check_traffic()
    print(f"phase18 wall_s={time.perf_counter() - t0!r}", flush=True)
    return out


# Phase 19: the MoE model family (serving and training), the induction
# trainer and the workload self-report, at the widths below. Each path is
# driven with the paged kernel's, the flash kernels' and the fused draws'
# counts set to 0 just before it and read just after.

MOE_EXPERTS = 8  # Mixtral-8x7B's expert count; top-1 routing (moe.py)


def moe_engine_config(paged_attn="kernel", kv_layout="paged",
                      decode_block=1):
    """Phase 4's production serving model with MOE_EXPERTS experts a layer
    (bf16, 16 slots, prefill_len 128 under the 256-token MoE cap)."""
    import dataclasses

    cfg = engine_config(paged_attn, kv_layout=kv_layout,
                        decode_block=decode_block)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, n_experts=MOE_EXPERTS))


def moe_step_parts(eng, lens) -> dict:
    """One paged-kernel decode step of the MoE engine at 16 decoding slots
    (tables over the pool's pages, each slot at one of phase 4's prompt
    lengths) in ms by CUDA events, the device busy and idle share from a
    trace, and its parts timed alone at the step's shapes: the two paged
    attention calls, the two MoE FFNs, and within them the bf16 -> f32
    casts of the expert banks, the f32 expert products, and the routing
    with the dispatch and combine copies."""
    import torch

    from tpumon_torch.loadgen.model import _moe_mlp
    from tpumon_torch.loadgen.moe import _assign, _combine, _dispatch
    from tpumon_torch.loadgen.paged_kv import paged_decode_step
    from tpumon_torch.ops.paged_attention import paged_attention

    cfg, m = eng.cfg, eng.cfg.model
    b, per = cfg.slots, eng._max_pages
    gen = torch.Generator(device="cuda").manual_seed(19)
    pages = torch.randperm(eng.pool["k"].shape[2] - 1, generator=gen,
                           device="cuda")[:b * per] + 1
    tables = pages.view(b, per).int()
    pos = torch.tensor([n - 1 for n in lens[:b]], dtype=torch.int32,
                       device="cuda")
    last = torch.randint(0, m.vocab, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    pool = {k: t.clone() for k, t in eng.pool.items()}
    before = paged_attention.launches

    def step():
        paged_decode_step(cfg, eng.params, pool, last, pos, tables)

    out = {"step_ms": cuda_ms(step, reps=10)}
    busy = device_busy(step)
    if busy is not None:
        out.update(device_busy_ms=busy[0], device_idle_share=1 - busy[0]
                   / busy[1], device_kernels_per_step=busy[2])
    q = torch.randn(b, m.n_heads, m.head_dim, device="cuda",
                    dtype=torch.bfloat16, generator=gen)
    out["attention_ms"] = m.n_layers * cuda_ms(lambda: paged_attention(
        q, pool["k"][0], pool["v"][0], tables, pos + 1), reps=20)
    hm = torch.randn(b, 1, m.d_model, device="cuda", dtype=torch.bfloat16,
                     generator=gen)
    layers = [layer["moe"] for layer in eng.params["layers"]]
    out["moe_ffn_ms"] = cuda_ms(lambda: [_moe_mlp(
        m, p, hm, full_capacity=True) for p in layers], reps=10)
    out["moe_bank_casts_ms"] = cuda_ms(lambda: [
        (p["w_in"].float(), p["w_out"].float()) for p in layers], reps=10)
    banks = [(p["w_in"].float(), p["w_out"].float()) for p in layers]
    xin = torch.randn(MOE_EXPERTS, b, m.d_model, device="cuda",
                      generator=gen)
    out["moe_products_ms"] = cuda_ms(lambda: [torch.bmm(torch.relu(
        torch.bmm(xin, w_in)), w_out) for w_in, w_out in banks], reps=10)
    del banks
    x = hm.view(b, m.d_model)
    out["moe_route_ms"] = cuda_ms(lambda: [_assign(p["router"], x, b)
                                           for p in layers], reps=20)
    rows = MOE_EXPERTS * b
    expert, position, kept, gate = _assign(layers[0]["router"], x, b)
    slot = torch.where(kept, expert * b + position, rows)
    yout = torch.randn(rows, m.d_model, device="cuda", generator=gen)
    out["moe_dispatch_combine_ms"] = m.n_layers * cuda_ms(lambda: (
        _dispatch(x, slot, rows), _combine(yout, slot, kept, gate)),
        reps=20)
    paged_attention.launches = before  # timing launches are not the path's
    del pool
    torch.cuda.empty_cache()
    return out


def check_moe_serving() -> dict:
    """MoE serving at production width with phase 4's traffic (half the
    requests sampled): dense block 1 and the paged kernel at block 1 and
    8, the kernel's launches equal n_layers x decode steps (serve_features
    checks them); the paged kernel's streams identical across blocks. A
    WorkloadReporter on the paged block-1 engine writes a report whose
    device hbm_used is memory_allocated at the write (1%) and whose
    busy_frac lies in (0, 1]. Returns the stats by run."""
    import shutil
    import tempfile

    import torch

    from tpumon_torch.loadgen.model import param_bytes
    from tpumon_torch.loadgen.report import WorkloadReporter
    from tpumon_torch.loadgen.serving import ServingEngine

    lens, prompts, sampling = engine_traffic()
    traffic = (prompts, sampling)
    runs = {"moe_dense_b1": moe_engine_config("gather", kv_layout="dense"),
            "moe_paged_kernel_b1": moe_engine_config(),
            "moe_paged_kernel_b8": moe_engine_config(decode_block=8)}
    streams, stats = {}, {}
    for label, cfg in runs.items():
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(cfg=cfg, seed=0, device="cuda")
        build_peak = torch.cuda.max_memory_allocated()
        rep = None
        if label == "moe_paged_kernel_b1":
            rdir = tempfile.mkdtemp(prefix="chip_smoke_report_")
            rep = WorkloadReporter(name="chip_smoke_moe", directory=rdir)
            eng.reporter = rep
        _, streams[label], stats[label] = serve_features(cfg, label, traffic,
                                                         engine=eng)
        banks = sum(p.numel() * p.element_size()
                    for layer in eng.params["layers"]
                    for k, p in layer["moe"].items() if k != "router")
        print(f"moe_serving {label} resident_weight_bytes="
              f"{param_bytes(eng.params)} expert_bank_bytes={banks} "
              f"build_peak_bytes={build_peak}", flush=True)
        if rep is not None:
            path = rep.write_once(interval_s=stats[label]["wall_s"])
            allocated = torch.cuda.memory_allocated(0)
            with open(path) as f:
                dev = json.load(f)["devices"][0]
            rep.stop()
            shutil.rmtree(rdir, ignore_errors=True)
            ok = (abs(dev["hbm_used"] - allocated) <= 0.01 * allocated
                  and 0 < dev["busy_frac"] <= 1)
            print(f"moe_report device={dev} memory_allocated={allocated} "
                  f"{'ok' if ok else 'MISS'}", flush=True)
            if not ok:
                fail("workload report: hbm_used or busy_frac out of range")
        if label == "moe_paged_kernel_b1":
            parts = moe_step_parts(eng, lens)
            print("moe_decode_step " + " ".join(
                f"{k}={v!r}" for k, v in parts.items()), flush=True)
            stats[label]["step"] = parts
        del eng
        torch.cuda.empty_cache()
    same = streams["moe_paged_kernel_b1"] == streams["moe_paged_kernel_b8"]
    dense = agreement(streams["moe_dense_b1"], streams["moe_paged_kernel_b1"])
    print(f"moe_serving paged_kernel_b8_vs_b1 streams_identical={same} "
          f"dense_vs_paged_kernel (bf16: not required) {dense}", flush=True)
    if not same:
        fail("MoE paged kernel: block 8 streams differ from block 1's")
    return stats


def check_small_moe_trainer_against_cpu() -> None:
    """A small f32 MoE trainer (4 experts, flash, hd 32, T 100): three SGD
    steps on the card give the CPU's losses within phase 8's STEP_TOL."""
    import torch

    from tpumon_torch.loadgen.model import (
        ModelConfig,
        init_params,
        map_params,
        sgd_train_step,
    )
    from tpumon_torch.loadgen.train import TrainConfig, synthetic_batch

    before = flash_counts()
    cfg = TrainConfig(model=ModelConfig(
        vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq=128, compute_dtype="float32", attention="flash",
        attn_block_k=128, n_experts=4), batch=2, seq=101, lr=0.05)
    init = init_params(cfg.model, torch.Generator().manual_seed(3))
    losses = {}
    for dev in ("cpu", "cuda"):
        params = map_params(init, lambda t: t.to(dev, copy=True))
        losses[dev] = [float(sgd_train_step(
            cfg.model, params, synthetic_batch(cfg, step, dev),
            lr=cfg.lr)[1]) for step in range(3)]
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    tol = STEP_TOL["float32"][0]
    ok = err <= tol
    print(f"small_moe_trainer_cuda_vs_cpu f32 losses_cpu={losses['cpu']} "
          f"losses_cuda={losses['cuda']} max_abs_err={err!r} tol={tol} "
          f"{'ok' if ok else 'MISS'}", flush=True)
    set_flash_counts(before)
    if not ok:
        fail("small MoE trainer: card losses differ from the CPU's")


def check_moe_training() -> dict:
    """MoE training at the bench trainer's width (phase 8's model with
    MOE_EXPERTS experts, flash at block 512, batch 8 x seq 1024) through
    run_train: finite losses, each flash kernel launched n_layers x steps
    times; then the step time and MFU over the active parameters
    (fused_train_bench)."""
    import torch

    from tpumon_torch.loadgen.train import (
        TrainConfig,
        TrainMetrics,
        detect_peak_flops,
        flops_per_token,
        fused_train_bench,
        run_train,
    )

    model = train_model(n_experts=MOE_EXPERTS)
    cfg = TrainConfig(model=model, steps=MOE_TRAIN_STEPS, batch=8, seq=1024)
    metrics = TrainMetrics(flops_per_token=flops_per_token(model, cfg.seq),
                           peak_flops=detect_peak_flops())
    before = flash_counts()
    torch.cuda.synchronize()
    set_flash_counts(dict.fromkeys(FLASH_KERNELS, 0))
    t0 = time.perf_counter()
    out = run_train(cfg, "cuda", metrics=metrics)
    wall = time.perf_counter() - t0
    launches = flash_counts()
    want = model.n_layers * cfg.steps
    print(f"moe_trainer steps={cfg.steps} loss={out['loss']!r} "
          f"launches={launches} want={want} wall_s={wall!r}", flush=True)
    del out
    torch.cuda.empty_cache()
    if not torch.isfinite(torch.tensor(metrics.loss or float("nan"))):
        fail("the MoE trainer's loss is not finite")
    if any(n != want for n in launches.values()):
        fail(f"MoE flash launches {launches} != n_layers x steps ({want})")
    torch.cuda.reset_peak_memory_stats()
    r = fused_train_bench(cfg, steps=MOE_TRAIN_STEPS, device="cuda")
    print(f"moe_train_step step_ms={r['seconds'] / MOE_TRAIN_STEPS * 1e3!r} "
          f"tokens_per_s={r['tokens_per_sec']!r} mfu_pct_active="
          f"{r['mfu_pct']!r} flops_per_token={metrics.flops_per_token!r} "
          f"loss={r['loss']!r} peak_mem_GB="
          f"{torch.cuda.max_memory_allocated() / 1e9!r}", flush=True)
    if not torch.isfinite(torch.tensor(r["loss"])):
        fail("the MoE train step's loss is not finite")
    set_flash_counts(before)
    torch.cuda.empty_cache()
    return {"launches": launches, **r}


def check_induction() -> dict:
    """train_induction at bench.py's settings (its TPU serving model,
    2000 Adam steps, period 16, seq 256, batch 16): final loss under 1.0;
    then bench.py's periodic prompts (3 periods of context, 160 new
    tokens) through prompt lookup at spec_len 15 and through plain block-8
    decode of the trained model: identical streams."""
    import dataclasses

    import torch

    from tpumon_torch.loadgen.model import ModelConfig
    from tpumon_torch.loadgen.serving import ServeConfig
    from tpumon_torch.loadgen.train import train_induction
    from tpumon_torch.ops import threefry

    m = ModelConfig(vocab=4096, d_model=512, n_layers=4, n_heads=8,
                    n_kv_heads=8, d_ff=2048, max_seq=512)
    period, seq, steps = 16, 256, INDUCTION_STEPS
    threefry.set_launch_counts(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trained, losses = train_induction(m, steps=steps, period=period,
                                      seq=seq)
    first, last = float(losses[0]), float(losses[-1])
    wall = time.perf_counter() - t0
    draws = threefry.launch_counts()
    print(f"induction steps={steps} loss_first={first!r} loss_last={last!r} "
          f"wall_s={wall!r} step_ms={wall / steps * 1e3!r} "
          f"threefry_launches={draws}", flush=True)
    if not last < 1.0:
        fail(f"train_induction did not learn to copy: last loss {last!r}")

    def mk_prompt(i: int) -> list:
        rng = [1 + (i * 997 + j * 131) % (m.vocab - 1)
               for j in range(period)]
        return (rng * -(-48 // period))[:48]

    traffic = ([mk_prompt(i) for i in range(24)], [(0.0, 0)] * 24)
    new = min(160, m.max_seq - 64)
    base = ServeConfig(model=m, slots=8, prefill_len=32)
    runs = {"block8": dataclasses.replace(base, decode_block=8),
            "prompt_g15": dataclasses.replace(base, spec_len=15,
                                              spec_source="prompt")}
    streams, stats = {}, {}
    for label, cfg in runs.items():
        _, streams[label], stats[label] = serve_features(
            cfg, f"induction_{label}", traffic, max_new=new, params=trained)
        torch.cuda.empty_cache()
    same = streams["block8"] == streams["prompt_g15"]
    print(f"induction_spec acceptance_pct="
          f"{stats['prompt_g15']['acceptance_pct']!r} tokens_per_s "
          f"prompt_g15={stats['prompt_g15']['tokens_per_s']!r} "
          f"block8={stats['block8']['tokens_per_s']!r} "
          f"streams_identical={same}", flush=True)
    if not same:
        fail("prompt lookup on the trained model: streams differ from "
             "plain block-8 decode's")
    return {"loss_last": last, **stats}


def phase19() -> dict:
    t0 = time.perf_counter()
    out = {"serving": check_moe_serving()}
    small_engines_against_cpu("moe", {
        "dense_b1": {}, "dense_b4": {"decode_block": 4},
        "paged_gather": {"kv_layout": "paged"},
        "paged_kernel": {"kv_layout": "paged", "paged_attn": "kernel"},
        "dense_self": {"spec_len": 3},
        "paged_prompt": {"spec_len": 3, "spec_source": "prompt",
                         "kv_layout": "paged"}}, n_experts=4)
    out["training"] = check_moe_training()
    check_small_moe_trainer_against_cpu()
    out["induction"] = check_induction()
    print(f"phase19 wall_s={time.perf_counter() - t0!r}", flush=True)
    return out


# Phase 20: the monitor's GPU-facing half. The in-process NVML collector
# (tpumon_torch/collectors/accel_cuda.py) is held to nvidia-smi on this
# card and must see the burns; then python -m tpumon_torch.validate runs
# on the card as a user runs it, in its own process, with its defaults.
# With the card idle, the collector's memory.used and nvidia-smi's, read
# right after, may differ by what allocations land between the two.
NVML_USED_SLACK = 256 * 2**20
NVML_FILL_SHARE = 0.9  # of hbm_fill's bytes the reading must rise by
DUTY_MIN_PCT = 80.0  # SM utilisation under the GEMM kernel's burn


def monitor_chip(collector):
    """Card 0's ChipSample from one collect; fails unless the sample is
    whole. Card 0 is torch's device 0, found among NVML's cards by UUID."""
    import asyncio

    import torch

    from tpumon_torch.collectors.accel_cuda import uuid_key

    s = asyncio.run(collector.collect())
    if not s.ok or not s.data:
        fail(f"the NVML collector: ok={s.ok} error={s.error!r}")
    want = uuid_key(str(torch.cuda.get_device_properties(0).uuid))
    index = next((c.index for c in collector.cards
                  if uuid_key(c.uuid) == want), None)
    if index is None:
        fail(f"no NVML card has torch device 0's UUID ({collector.cards})")
    return next(c for c in s.data if c.index == index)


def duty_under(burn, collector) -> list:
    """The collector's mxu_duty_pct of card 0 in five samples a second
    apart, after a second's start, while ``burn`` runs in a loop in a
    thread."""
    import threading

    stop = threading.Event()
    errors = []

    def loop():
        try:
            while not stop.is_set():
                burn()
        except BaseException as e:  # handed to the main thread below
            errors.append(e)

    t = threading.Thread(target=loop)
    t.start()
    duty = []
    try:
        time.sleep(1.0)
        for _ in range(5):
            duty.append(monitor_chip(collector).mxu_duty_pct)
            time.sleep(1.0)
    finally:
        stop.set()
        t.join(timeout=60)
    if errors or t.is_alive():
        fail(f"the burn thread failed: {errors}")
    return duty


def collect_ms(collector, n: int = 50) -> float:
    """Median wall ms of ``n`` collects, each whole."""
    import asyncio
    import statistics

    async def run():
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            s = await collector.collect()
            times.append((time.perf_counter() - t0) * 1e3)
            if not s.ok:
                fail(f"{type(collector).__name__}: {s.error}")
        return statistics.median(times)

    return asyncio.run(run())


def check_monitor() -> None:
    """Phase 20: identity, memory and duty of the NVML collector against
    nvidia-smi and the burns; validate on the card; each collector's cost."""
    import asyncio
    import tempfile

    import torch

    from tpumon_torch.collectors.accel_cuda import CudaGpuCollector, Nvml
    from tpumon_torch.collectors.gpu import NvidiaSmiCollector
    from tpumon_torch.loadgen import burn
    from tpumon_torch.ops import threefry

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the caching allocator's reserve is not a fill
    collector = CudaGpuCollector(workload_dir=None)
    monitor_chip(collector)
    time.sleep(1.0)

    # Identity, against nvidia-smi read right after.
    chip = monitor_chip(collector)
    card = next(c for c in collector.cards if c.index == chip.index)
    name, total, used, reserved = smi(
        "name,memory.total,memory.used,memory.reserved")
    nvml = Nvml()
    nvml.init()
    h = nvml.handle(card.index)
    v1, v2 = nvml.memory_v1(h), nvml.memory_v2(h)
    nvml.shutdown()
    print(f"monitor_identity chip={chip.to_json()} name={card.name!r} "
          f"smi_name={name!r} smi_total_mib={total} smi_used_mib={used} "
          f"smi_reserved_mib={reserved} nvml_v1(total,used)="
          f"{(v1.total, v1.used)} nvml_v2(total,reserved,used)="
          f"{(v2.total, v2.reserved, v2.used)} links={card.links}",
          flush=True)
    if chip.kind != "h100" or card.name != name:
        fail(f"identity: kind {chip.kind!r}, name {card.name!r} against "
             f"nvidia-smi's {name!r}")
    if chip.hbm_total // 2**20 != int(total):
        fail(f"hbm_total {chip.hbm_total} B against nvidia-smi's {total} MiB")
    if abs(chip.hbm_used - float(used) * 2**20) > NVML_USED_SLACK:
        fail(f"hbm_used {chip.hbm_used} B against nvidia-smi's {used} MiB")

    # Memory response.
    hbm0 = monitor_chip(collector).hbm_used
    arrays = burn.hbm_fill(0.3)
    filled = sum(a.numel() * a.element_size() for a in arrays)
    hbm1 = monitor_chip(collector).hbm_used
    del arrays
    torch.cuda.empty_cache()
    hbm2 = monitor_chip(collector).hbm_used
    print(f"monitor_memory hbm_used={[hbm0, hbm1, hbm2]} filled={filled} "
          f"rise_over_filled={(hbm1 - hbm0) / filled!r}", flush=True)
    if hbm1 - hbm0 < NVML_FILL_SHARE * filled:
        fail(f"hbm_used rose {hbm1 - hbm0} B under a {filled} B fill")

    # Duty response: the GEMM kernel's burn (its launches counted from 0),
    # then the reference's default burn (cuBLAS).
    gemm_before, draws_before = gemm_counts(), threefry.launch_counts()
    set_gemm_counts({k: 0 for k in gemm_before})
    threefry.set_launch_counts(0)
    duty_kernel = duty_under(lambda: burn.mxu_burn(
        seconds=0.5, use_kernel=True), collector)
    launches = {**gemm_counts(), **threefry.launch_counts()}
    duty_library = duty_under(lambda: burn.mxu_burn(seconds=0.5), collector)
    set_gemm_counts(gemm_before)
    for kname, n in draws_before.items():
        getattr(threefry, kname).launches = n
    print(f"monitor_duty kernel_burn={duty_kernel} library_burn="
          f"{duty_library} launches={launches} throttle_score="
          f"{monitor_chip(collector).throttle_score}", flush=True)
    if not launches["matmul"]:
        fail("the duty burn launched no GEMM kernel")
    if max(d for d in duty_kernel if d is not None) < DUTY_MIN_PCT:
        fail(f"mxu_duty_pct {duty_kernel} under the GEMM kernel's burn")

    # validate, as a user runs it: backend cuda, device cuda.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "validate.json"
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpumon_torch.validate", "--json",
             str(path)], cwd=Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t1
        for line in proc.stdout.splitlines():
            print(f"validate | {line}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], flush=True)
            fail(f"python -m tpumon_torch.validate exit {proc.returncode}")
        art = json.loads(path.read_text())
    bad = [c for c in art["checks"] if c["verdict"] != "PASS" and not (
        c["check"].startswith("source-") and c["verdict"] == "SKIP")]
    nvml_check = [c["verdict"] for c in art["checks"]
                  if c["check"] == "source-nvml"]
    print(f"validate seconds={art['seconds']!r} exit={art['exit']} "
          f"wall_s={wall!r}", flush=True)
    if bad or nvml_check != ["PASS"]:
        fail(f"validate on the card: {bad or art['checks']}")

    # Each collector's cost a sample.
    nvml_ms = collect_ms(collector)
    smi_ms = collect_ms(NvidiaSmiCollector())
    asyncio.run(collector.close())
    print(f"collector_cost nvml_median_ms={nvml_ms!r} nvidia_smi_median_ms="
          f"{smi_ms!r} (50 collects each) card={card_line()!r}", flush=True)
    print(f"phase20 wall_s={time.perf_counter() - t0!r}", flush=True)


# Phase 21: the monitor core. python -m tpumon_torch.info runs on the
# card; a port Sampler (NVML, host and serving collectors; recording
# rules, the default thresholds, a TTFT SLO and a capacity policy bound
# to the engine in process) ticks at the reference's 1 s while phase 4's
# engine serves behind its /metrics; the engine's tokens/s and step ms
# with and without the sampler ticking; the reference's fleet scale
# (fake:v5p-256, 256 chips' series) through both ingest paths.
# Traffic keeps two waves of phase 4's 16 prompts outstanding (a new
# wave whenever no more than one is left) for a fixed window, so the
# number of sampler ticks under load is set by the window, not by how
# fast the engine serves.
MONITOR_BUSY_S = 12.0  # the window the checks read: >= 12 ticks serving
MONITOR_BUSY_TICKS = 10  # fewer ticks under load fail the phase
MONITOR_SLO = {"name": "ttft", "expr": "ttft_p50_ms > 10000",
               "target": 0.99, "window": "1h"}
# Holds while more requests wait than a quarter of a wave; capacity is
# the one verb that changes what the engine does next without dropping
# work (the prefill budget 1 -> 2 chunks a step).
MONITOR_POLICY = {"name": "grow_prefill", "when": "queue_depth > 4",
                  "action": "capacity", "prefill_budget": 2,
                  "cooldown_s": 0, "fire_hold": 2, "clear_hold": 2}
DUTY_RISE_PCT = 5.0  # the card's duty series over its idle maximum
# The tokens/s series integrated over the sampler's tick times against
# the engine's token counter: the rate divides by the scrape times, a
# few ms from the tick times over 1 s ticks.
TOKENS_TOL = 0.05
TTFT_WINDOW = 512  # the engine's /metrics TTFT p50 is over its last 512
# The monitor's cost to the job: one warmed sampler, turns of a fixed
# window in the order without, with, with, without twice over, under the
# same continuous traffic; 8 ticks a "with" turn, 32 in all.
COST_TURNS = ("without", "with", "with", "without") * 2
COST_TURN_S = 7.5
COST_WARM_S = 4.0  # the queue filled from empty serves prefill-heavy at first
COST_MIN_TICKS = 30
FLEET_WARMUP, FLEET_TICKS = 8, 40  # bench.py:1282-1304
HOST_SERIES = ("cpu", "memory", "disk", "dcn")


def monitor_sampler(url: str, accel, actuations: list):
    """A port Sampler as tpumon's app builds one: the host collector, the
    given accelerator collector and a serving collector on ``url``."""
    from tpumon_torch.collectors.host import HostCollector
    from tpumon_torch.collectors.serving import ServingCollector
    from tpumon_torch.config import load_config
    from tpumon_torch.sampler import Sampler

    cfg = load_config(env={
        "TPUMON_COLLECTORS": "host,accel,serving",
        "TPUMON_SERVING_TARGETS": url,
        "TPUMON_SERVING_INTERVAL_S": "1",
        "TPUMON_RECORDING_RULES": "chip.mxu[5m],chip.hbm[5m]",
        "TPUMON_SLOS": json.dumps([MONITOR_SLO]),
        "TPUMON_ACTUATIONS": json.dumps(actuations),
    })
    host = HostCollector(cpu_count=cfg.cpu_count, disk_mounts=cfg.disk_mounts)
    serving = ServingCollector(targets=cfg.serving_targets)
    return Sampler(cfg, host=host, accel=accel, serving=serving)


async def keep_serving(eng, prompts, max_new: int, reqs: list,
                       seconds: float, sampler=None, on_tick=None,
                       interval_s: float = 1.0) -> int:
    """For ``seconds``, keep two waves of ``prompts`` outstanding at the
    engine its pump thread steps (appending each request to ``reqs``);
    with a sampler, tick_all every ``interval_s`` from the start (calling
    ``on_tick()`` after each tick). Returns the number of ticks."""
    import asyncio

    t0 = time.perf_counter()
    next_tick, ticks = t0, 0
    pending: list = []
    while (now := time.perf_counter()) < t0 + seconds:
        pending = [r for r in pending if not r.status]
        if len(pending) <= len(prompts):
            wave = [eng.submit(p, max_new=max_new) for p in prompts]
            pending += wave
            reqs += wave
        if sampler is not None and now >= next_tick:
            next_tick += interval_s
            await sampler.tick_all()
            ticks += 1
            if on_tick is not None:
                on_tick()
        await asyncio.sleep(0.01)
    return ticks


async def drain(reqs: list, sampler=None, on_tick=None,
                interval_s: float = 1.0) -> None:
    """Wait until every request in ``reqs`` ended, ticking as above."""
    import asyncio

    next_tick = time.perf_counter()
    while not all(r.status for r in reqs):
        if sampler is not None and time.perf_counter() >= next_tick:
            next_tick += interval_s
            await sampler.tick_all()
            if on_tick is not None:
                on_tick()
        await asyncio.sleep(0.01)


async def idle_ticks(sampler, n: int) -> None:
    """``n`` ticks a second apart with no traffic."""
    import asyncio

    for _ in range(n):
        t0 = time.perf_counter()
        await sampler.tick_all()
        await asyncio.sleep(max(0.0, 1.0 - (time.perf_counter() - t0)))


def series_points(sampler, name: str) -> list:
    s = sampler.history.series.get(name)
    return s.fine.since(None) if s is not None else []


def check_info(collector) -> None:
    """python -m tpumon_torch.info with its defaults, in its own process:
    exit 0, no degraded source, and a row for the card with NVML's HBM
    total."""
    from tpumon_torch.cli import _fmt_bytes

    chip = monitor_chip(collector)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpumon_torch.info"],
                          cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"info | {line}", flush=True)
    row = [ln for ln in proc.stdout.splitlines()
           if ln.startswith(chip.chip_id + " ")]
    print(f"phase21 info exit={proc.returncode} wall_s={wall!r} "
          f"stderr={proc.stderr.strip()[-400:]!r} nvml_hbm_total="
          f"{chip.hbm_total}", flush=True)
    if proc.returncode != 0 or "[degraded" in proc.stderr:
        fail(f"python -m tpumon_torch.info: exit {proc.returncode}, "
             f"stderr {proc.stderr[-2000:]!r}")
    if (len(row) != 1 or f" {chip.kind} " not in row[0]
            or f"/{_fmt_bytes(chip.hbm_total)}" not in row[0]):
        fail(f"info's table has no row for {chip.chip_id} ({chip.kind}, "
             f"{_fmt_bytes(chip.hbm_total)} HBM): {row}")


def check_monitor_serving(eng, url: str, accel) -> dict:
    """The sampler over the serving job: duty rises, the TSDB's tokens/s
    and TTFT agree with the engine's own, the ingest kernel is active,
    the capacity policy fires and moves the engine, no collector fails.
    Returns the launches of the paged kernel and the fused draws."""
    import asyncio

    from tpumon_torch import tsdb
    from tpumon_torch.ops import threefry
    from tpumon_torch.ops.paged_attention import paged_attention
    from tpumon_torch.tracing import quantiles

    _, prompts, _ = engine_traffic()
    sampler = monitor_sampler(url, accel, [MONITOR_POLICY])
    sampler.actuate.bind_engine(eng)  # as tpumon/app.py:240-241 does
    budgets = []

    def on_tick():
        budgets.append(eng.cfg.prefill_chunk_budget)

    async def run():
        await idle_ticks(sampler, 3)
        t_submit = time.time()
        tok0, steps0 = eng.tokens_total, eng.decode_steps_total
        paged_attention.launches = 0  # count only this path from here
        threefry.set_launch_counts(0)
        t0 = time.perf_counter()
        reqs: list = []
        busy_ticks = await keep_serving(eng, prompts, 32, reqs,
                                        MONITOR_BUSY_S, sampler, on_tick)
        await drain(reqs, sampler, on_tick)
        out = {"wall_s": time.perf_counter() - t0, "t_submit": t_submit,
               "tokens": eng.tokens_total - tok0,
               "steps": eng.decode_steps_total - steps0, "reqs": reqs,
               "busy_ticks": busy_ticks,
               "launches": paged_attention.launches,
               "draws": threefry.launch_counts()}
        await idle_ticks(sampler, 3)  # the last scrapes see the finished work
        return out

    run = asyncio.run(run())
    t_submit, launches, draws = run["t_submit"], run["launches"], run["draws"]

    duty = series_points(sampler, "mxu")
    idle = [v for t, v in duty if t < t_submit]
    busy = [v for t, v in duty if t >= t_submit]
    rate = series_points(sampler, "tokens_per_sec")
    ticks = [t for t, _ in rate]
    served = sum(v * (t - ticks[i - 1]) for i, (t, v) in enumerate(rate)
                 if i and t >= t_submit)
    ttft = series_points(sampler, "ttft_p50_ms")
    # The engine's own p50 as its /metrics gauge exports it (ms, rounded
    # to 3 places), as the TSDB stores it (f32).
    want_ttft = tsdb.quantize_val(round(
        quantiles([r.ttft_s for r in run["reqs"]])[0] * 1e3, 3))
    fired = [e for e in sampler.journal.events()
             if e["kind"] == "actuate" and e.get("state") == "fired"]
    health = sampler.health_json()
    failures = {n: st.failures for n, st in sampler.stats.items()}
    bad_targets = [r for r in sampler.serving_data() if not r.get("ok")]
    stages = sampler.tracer.to_json()["stages"]
    print(f"phase21 serving window_s={MONITOR_BUSY_S} busy_ticks="
          f"{run['busy_ticks']} requests="
          f"{len(run['reqs'])} wall_s={run['wall_s']!r} tokens="
          f"{run['tokens']} decode_steps={run['steps']} "
          f"paged_launches={launches} threefry_launches={draws} "
          f"duty_idle={idle} duty_busy={busy} "
          f"tokens_series_integral={served!r} ttft_series={ttft[-1:]} "
          f"engine_ttft_p50_ms_f32={want_ttft!r} prefill_budget_by_tick="
          f"{budgets} fired={[e['msg'] for e in fired]} "
          f"ingest_kernel={health['history']['ingest_kernel']} "
          f"failures={failures} series={len(sampler.history.series)}",
          flush=True)
    bad = [r.rid for r in run["reqs"] if r.status != "completed"]
    if bad:
        fail(f"phase 21: requests {bad} did not complete")
    if run["busy_ticks"] < MONITOR_BUSY_TICKS:
        fail(f"phase 21: {run['busy_ticks']} sampler ticks while serving, "
             f"fewer than {MONITOR_BUSY_TICKS}")
    if len(run["reqs"]) > TTFT_WINDOW:
        fail(f"phase 21: {len(run['reqs'])} requests overrun the engine's "
             f"TTFT window of {TTFT_WINDOW}")
    if launches != eng.cfg.model.n_layers * run["steps"] or not launches:
        fail(f"phase 21: paged kernel launches {launches} != n_layers x "
             f"decode steps ({run['steps']})")
    check_sampler_draws(draws, run["steps"] + len(run["reqs"]), "phase 21")
    if not idle or not busy or max(busy) < max(idle) + DUTY_RISE_PCT:
        fail(f"the card's duty series did not rise while serving: idle "
             f"{idle}, serving {busy}")
    if abs(served - run["tokens"]) > TOKENS_TOL * run["tokens"]:
        fail(f"the TSDB's tokens/s integrates to {served} tokens against "
             f"the engine's {run['tokens']}")
    if not ttft or ttft[-1][1] != want_ttft:
        fail(f"the TSDB's TTFT p50 {ttft[-1:]} against the engine's "
             f"{want_ttft}")
    if not health["history"]["ingest_kernel"] or tsdb.kernel() is None:
        fail(f"the native ingest kernel is not active: "
             f"{tsdb.kernel_status()}")
    if not fired or MONITOR_POLICY["prefill_budget"] not in budgets:
        fail(f"the capacity policy: fired {fired}, prefill budget by tick "
             f"{budgets}")
    if (set(failures) != {"host", "accel", "serving"}
            or any(failures.values()) or bad_targets):
        fail(f"a collector reported ok=False: {failures} {bad_targets}")
    tick = stages["tick_fast"]
    print("phase21 tick " + " ".join(
        f"{name}_p50_ms={row['p50_ms']!r}" for name, row in stages.items())
        + f" tick_fast_p95_ms={tick['p95_ms']!r} card={card_line()!r}",
        flush=True)
    return {"paged": launches, "threefry": draws, "capacity_after": (
        eng.cfg.prefill_chunk_budget, eng.cfg.admit_lookahead)}


def monitor_cost(eng, url: str, accel) -> None:
    """The engine's tokens/s and decode-step ms with the sampler ticking
    at 1 s and without, under the same continuous traffic: one sampler
    (no policy: the engine is the same in both arms), warmed by idle
    ticks, ticks in the "with" turns of COST_TURNS and rests in the
    others; each turn is a fixed window of COST_TURN_S. Prints every
    turn, each arm's mean and spread, and the difference."""
    import asyncio
    import statistics

    _, prompts, _ = engine_traffic()
    sampler = monitor_sampler(url, accel, [])
    capacity = (eng.cfg.prefill_chunk_budget, eng.cfg.admit_lookahead)

    async def run():
        await idle_ticks(sampler, 3)
        reqs: list = []
        await keep_serving(eng, prompts, 32, reqs, COST_WARM_S)
        rows = []
        for arm in COST_TURNS:
            tok0, steps0 = eng.tokens_total, eng.decode_steps_total
            t0 = time.perf_counter()
            ticks = await keep_serving(
                eng, prompts, 32, reqs, COST_TURN_S,
                sampler if arm == "with" else None)
            wall = time.perf_counter() - t0
            tokens = eng.tokens_total - tok0
            steps = eng.decode_steps_total - steps0
            rows.append((arm, tokens / wall, wall * 1e3 / max(1, steps),
                         ticks))
        await drain(reqs)
        return rows, reqs

    rows, reqs = asyncio.run(run())
    if any(r.status != "completed" for r in reqs):
        fail("phase 21 cost run: a request did not complete")
    arms = {arm: [r for r in rows if r[0] == arm]
            for arm in ("without", "with")}
    ticks = sum(r[3] for r in arms["with"])
    stat = {}
    for arm, rs in arms.items():
        tps = [r[1] for r in rs]
        ms = [r[2] for r in rs]
        mean = statistics.mean(tps)
        stat[arm] = mean
        print(f"phase21 cost arm={arm} turns={len(rs)} tokens_per_s={tps} "
              f"mean={mean!r} spread_pct={(max(tps) - min(tps)) / mean * 100!r}"
              f" ms_per_decode_step={ms} mean_ms={statistics.mean(ms)!r}",
              flush=True)
    tick = sampler.tracer.to_json()["stages"]["tick_fast"]
    print(f"phase21 cost turns={[r[0] for r in rows]} turn_s={COST_TURN_S} "
          f"with_ticks={ticks} requests={len(reqs)} capacity={capacity} "
          f"tick_fast_p50_ms={tick['p50_ms']!r} tokens_per_s_change_pct="
          f"{(stat['with'] - stat['without']) / stat['without'] * 100!r} "
          f"card={card_line()!r}", flush=True)
    if ticks < COST_MIN_TICKS or any(r[1] <= 0 for r in rows):
        fail(f"phase 21 cost: {ticks} ticks in the with arm (want >= "
             f"{COST_MIN_TICKS}), turns {rows}")


def fleet_scale() -> None:
    """bench.py's ingest tick at the reference's fleet scale: a Sampler on
    fake:v5p-256 with 256 chips' series, 8 warm-up and 40 timed ticks a
    second apart on a shared clock, through the native ingest kernel and
    through the reference's ``ingest_kernel off`` path (timed beside it,
    never in its place); both must leave equal accelerator series. Then
    bench.py's instant and range queries over each ring."""
    import asyncio
    import statistics
    from unittest import mock

    from tpumon_torch import tsdb
    from tpumon_torch.collectors.accel_fake import FakeTpuCollector
    from tpumon_torch.collectors.host import HostCollector
    from tpumon_torch.config import load_config
    from tpumon_torch.sampler import Sampler

    t_base = time.time()
    out = {}
    for path in ("kernel", "off"):
        cfg = load_config(env={
            "TPUMON_COLLECTORS": "host,accel",
            "TPUMON_HISTORY_PER_CHIP": "256",
            "TPUMON_INGEST_KERNEL": "1" if path == "kernel" else "0",
        })
        tsdb.set_kernel_enabled(cfg.ingest_kernel)  # as tpumon/app.py:34
        if (tsdb.kernel() is not None) != (path == "kernel"):
            fail(f"ingest path {path}: kernel {tsdb.kernel_status()}")
        now = [t_base]
        accel = FakeTpuCollector(topology="v5p-256", clock=lambda: now[0])
        sampler = Sampler(cfg, accel=accel, host=HostCollector(
            cpu_count=cfg.cpu_count, disk_mounts=cfg.disk_mounts))

        async def ticks():
            for i in range(FLEET_WARMUP + FLEET_TICKS):
                now[0] = t_base + i
                await sampler.tick_fast()

        with mock.patch("time.time", lambda: now[0]):
            asyncio.run(ticks())
            at = now[0]
            inst, rng = [], []
            for _ in range(40):
                t0 = time.perf_counter()
                got = sampler.query.instant(
                    "topk(5, avg_over_time(chip.mxu[5m]))", at=at)
                inst.append((time.perf_counter() - t0) * 1e3)
            for _ in range(10):
                t0 = time.perf_counter()
                rq = sampler.query.range_query("avg(chip.mxu)", 1800, 30,
                                               end=at)
                rng.append((time.perf_counter() - t0) * 1e3)
        if len(got["result"]) != 5 or not rq["series"][0]["points"]:
            fail(f"fleet queries ({path}): {got} {rq['series'][:1]}")
        stages = sampler.tracer.to_json()["stages"]
        series = {n: s.fine.since(None)
                  for n, s in sampler.history.series.items()
                  if n not in HOST_SERIES}
        coarse = {n: v for n, v in sampler.history.dump_coarse().items()
                  if n not in HOST_SERIES}
        out[path] = (series, coarse)
        print(f"phase21 fleet path={path} series="
              f"{len(sampler.history.series)} history_p50_ms="
              f"{stages['history']['p50_ms']!r} tick_fast_p50_ms="
              f"{stages['tick_fast']['p50_ms']!r} query_instant_p50_ms="
              f"{statistics.median(inst)!r} query_range_30m_p50_ms="
              f"{statistics.median(rng)!r} card={card_line()!r}", flush=True)
    tsdb.set_kernel_enabled(True)
    if out["kernel"] != out["off"] or len(out["kernel"][0]) < 1024:
        fail("the two ingest paths left different series at v5p-256")


def phase21() -> int:
    """Phase 21: build the native layer, then the entry point, the
    sampler on the serving job, its cost to the job, the fleet scale.
    Returns the launches of the paged kernel and the fused draws on the
    serving path."""
    import asyncio

    from tpumon_torch import native, tsdb
    from tpumon_torch.collectors.accel_cuda import CudaGpuCollector
    from tpumon_torch.loadgen.serving import start_background

    t0 = time.perf_counter()
    if not native.build(quiet=False):
        fail("the native layer did not build")
    print(f"phase21 native_build_s={time.perf_counter() - t0!r} "
          f"tsdb={native.so_path('tsdb')}", flush=True)
    if tsdb.kernel() is None:
        fail(f"the native ingest kernel did not load: {tsdb.kernel_status()}")
    accel = CudaGpuCollector(workload_dir=None)
    check_info(accel)
    eng, url, stop = start_background(rps=0.0, cfg=engine_config(),
                                      device="cuda")
    try:
        served = check_monitor_serving(eng, url, accel)
        monitor_cost(eng, url, accel)
    finally:
        stop.set()
        asyncio.run(accel.close())
    fleet_scale()
    del eng
    print(f"phase21 wall_s={time.perf_counter() - t0!r} capacity_after="
          f"{served['capacity_after']}", flush=True)
    return served


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from tpumon_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    variant, bw, peaks = card_peaks(name)
    print(f"card: {card} ({variant}, {bw / 1e12} TB/s) torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: nvcc {built} in {time.perf_counter() - t0!r} s "
          f"-> {_build.BUILD_DIR}", flush=True)

    print("ptxas: " + " | ".join(
        ln for n in _build.sources() for ln in _build.ptxas_report(n)
        if n != "paged_attention"), flush=True)
    print_paged_config()
    print_flash_config()

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = check_kernel(gen)
    eng, stats, snap = run_engine()
    compare_paths(eng, snap)
    check_small_engine_against_cpu()
    times = time_kernel(gen, bw, peaks)
    time_engine(eng, snap, stats)
    check_server(eng)
    del eng, snap
    torch.cuda.empty_cache()

    flash_worst = check_flash_kernels(gen)
    check_flash_grad_spread()
    trained = run_trainer()
    compare_flash_naive()
    check_small_trainer_against_cpu()
    check_served_checkpoint(trained)
    flash_times = time_flash_kernels(gen, bw, peaks)
    time_trainer(trained)
    check_train_metrics(trained)
    flash_launches = trained["launches"]
    del trained
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gemm_worst = check_gemm_kernels(gen)
    print(f"phase11 gemm_checks wall_s={time.perf_counter() - t0!r}",
          flush=True)
    burn_launches = run_burn_path()
    measure_kernels()
    check_burn_load()
    rect = check_flash_rect(gen)
    gemm_times = time_gemm_kernels(gen, bw, peaks)
    rect_times = time_flash_rect(gen, bw, peaks)

    t0 = time.perf_counter()
    dense = check_dense_and_fused()
    check_small_engines_sampled_against_cpu()
    sampler = check_sampler(dense["engine"])
    time_dense_and_fused(dense["engine"], dense["stats"], sampler)
    del dense, sampler
    torch.cuda.empty_cache()
    print(f"phase16 wall_s={time.perf_counter() - t0!r}", flush=True)

    t0 = time.perf_counter()
    draws = check_threefry(gen, bw, peaks)
    print(f"phase17 wall_s={time.perf_counter() - t0!r}", flush=True)

    phase18()
    phase19()
    check_monitor()
    monitor = phase21()

    rows = [{"name": "paged_attention", "route": "cuda",
             "source": "tpumon_torch/ops/csrc/paged_attention.cu",
             "replaces": "tpumon/ops/paged_attention.py:65",
             "launches": stats["launches"] + monitor["paged"],
             "max_abs_err": worst["bfloat16"],
             **times}]
    sources = {"flash_attention_tri_fwd": (
        "tpumon_torch/ops/csrc/flash_attention_tri_fwd.cu",
        "tpumon/ops/flash_attention.py:170"),
        "flash_attention_tri_bwd_dq": (
            "tpumon_torch/ops/csrc/flash_attention_tri_bwd.cu",
            "tpumon/ops/flash_attention.py:308"),
        "flash_attention_tri_bwd_dkv": (
            "tpumon_torch/ops/csrc/flash_attention_tri_bwd.cu",
            "tpumon/ops/flash_attention.py:341")}
    for kernel in FLASH_KERNELS:
        source, replaces = sources[kernel]
        rows.append({"name": kernel, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": flash_launches[kernel],
                     "max_abs_err": flash_worst[kernel],
                     **flash_times[kernel]})
    rows.append({"name": "flash_attention", "route": "cuda",
                 "source": "tpumon_torch/ops/csrc/flash_attention.cu",
                 "replaces": "tpumon/ops/flash_attention.py:62",
                 "launches": rect["launches"],
                 "max_abs_err": rect["max_abs_err"], **rect_times})
    for kernel, source, replaces in (
            ("matmul", "tpumon_torch/ops/csrc/matmul.cu",
             "tpumon/ops/matmul.py:30"),
            ("quantized_matmul_kernel", "tpumon_torch/ops/csrc/matmul.cu",
             "tpumon/ops/quant_matmul.py:37")):
        rows.append({"name": kernel, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": burn_launches[kernel],
                     "max_abs_err": gemm_worst[kernel],
                     **gemm_times[kernel]})
    # The draws replace no Pallas kernel: each row names the jax.random
    # call it computes on the path whose launches it counts (phase 4's
    # and phase 21's sampler, phase 12's burn inputs).
    for kernel, replaces, launches in (
            ("threefry_keys", "tpumon/loadgen/serving.py:687",
             stats["threefry"]["threefry_keys"]
             + monitor["threefry"]["threefry_keys"]),
            ("threefry_draw", "tpumon/loadgen/burn.py:38",
             burn_launches["threefry_draw"]),
            ("threefry_categorical", "tpumon/loadgen/serving.py:694",
             stats["threefry"]["threefry_categorical"]
             + monitor["threefry"]["threefry_categorical"])):
        rows.append({"name": kernel, "route": "cuda",
                     "source": "tpumon_torch/ops/csrc/threefry.cu",
                     "replaces": replaces, "launches": launches,
                     **draws[kernel]})
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
