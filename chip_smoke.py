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
   pool, lengths 0/1/127/128/129/2000/4096 and random), in bf16 and f32,
   plus group-1 hd-64, the serving CLI's hd-32 and an odd page size.
4. engine: the serving engine at production width (bench.py's paged
   decode shape: vocab 4096, d_model 4096, 2 layers, 32/8 heads, d_ff
   8192, max_seq 4096, 16 slots, page 128, random weights from a seed)
   serves 16 greedy requests of 64-3000 prompt tokens to completion; the
   kernel's launch count must equal n_layers x decode steps; one decode
   step of the kernel path is held to the gather path in bf16 and f32;
   a small f32 engine's streams on the card equal the CPU's.
5. times: kernel, plain version, torch's SDPA on the gathered context
   (library yardstick, never called by the port) and the bytes bound;
   engine decode step (kernel and gather), tokens/s, TTFT p50, and where
   a decode step's time goes.
6. server: the engine behind its HTTP server, stepped by the arrival
   pump, answers a /generate call with the greedy tokens a direct
   submission gives, and serves the /metrics families the monitor
   scrapes.

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
TOL = {"bfloat16": 3e-2, "float32": 1e-4}  # kernel vs plain, max abs
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
    """(variant, memory bytes/s, peak op/s by dtype) from NVIDIA's data
    sheets, dense rates: bf16 on tensor cores, f32 on CUDA cores."""
    n = name.upper()
    if "H200" in n:
        return "H200 SXM", 4.8e12, {"bfloat16": 989e12, "float32": 67e12}
    if "H100" in n and "PCIE" in n:
        return "H100 PCIe", 2.0e12, {"bfloat16": 756e12, "float32": 51e12}
    if "H100" in n and "NVL" in n:
        return "H100 NVL", 3.9e12, {"bfloat16": 835e12, "float32": 60e12}
    if "H100" in n:
        return "H100 SXM", 3.35e12, {"bfloat16": 989e12, "float32": 67e12}
    fail(f"unknown card {name!r}: no peak rates on record")


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


def check_kernel(gen) -> dict:
    import torch

    from tpumon_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    rng = random.Random(1)
    prod_lengths = list(PROD_LENGTHS) + [
        rng.randint(1, 4096) for _ in range(16 - len(PROD_LENGTHS))]
    cases = [
        ("production", dict(b=16, nh=32, nkv=8, hd=128, ps=128, max_pages=32,
                            lengths=prod_lengths)),
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
            args = paged_inputs(gen, dtype=dtype, **case)
            out = paged_attention(*args)
            torch.cuda.synchronize()
            ref = paged_attention_reference(*args)
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            zero = [i for i, n in enumerate(case["lengths"]) if n == 0]
            zeros_ok = bool((out[zero] == 0).all().item()) if zero else True
            finite = bool(torch.isfinite(out.float()).all().item())
            ok = err <= TOL[dname] and zeros_ok and finite
            print(f"kernel_vs_plain {name} {dname} lengths={case['lengths']} "
                  f"max_abs_err={err!r} max_rel_err={err / scale!r} "
                  f"tol_abs={TOL[dname]} zero_rows_zero={zeros_ok} "
                  f"{'ok' if ok else 'MISS'}", flush=True)
            if not ok:
                fail(f"paged_attention kernel disagrees with its plain "
                     f"version ({name}, {dname})")
            if name == "production":
                worst[dname] = err
    return worst


def engine_config(paged_attn="kernel", dtype="bfloat16"):
    from tpumon_torch.loadgen.model import ModelConfig
    from tpumon_torch.loadgen.serving import ServeConfig

    return ServeConfig(
        model=ModelConfig(vocab=4096, d_model=4096, n_layers=2, n_heads=32,
                          n_kv_heads=8, d_ff=8192, max_seq=4096,
                          compute_dtype=dtype),
        slots=16, prefill_len=128, paged_attn=paged_attn)


def run_engine() -> tuple:
    """The main path: 16 mixed-length greedy requests at production width
    through the paged engine, kernel read path. Returns (engine, stats,
    snapshot of the state before the decode step with the most decoding
    slots)."""
    import torch

    from tpumon_torch.loadgen.serving import ServingEngine
    from tpumon_torch.ops.paged_attention import paged_attention

    eng = ServingEngine(cfg=engine_config(), seed=0, device="cuda")
    rng = random.Random(2)
    lens = [64, 3000] + [rng.randint(64, 3000) for _ in range(14)]
    prompts = [[rng.randrange(4096) for _ in range(n)] for n in lens]
    max_new = 32
    torch.cuda.synchronize()
    paged_attention.launches = 0  # count only the main path from here
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
    steps = eng.decode_steps_total
    print(f"engine prompts={lens} max_new={max_new} decode_steps={steps} "
          f"kernel_launches={launches} wall_s={wall!r}", flush=True)
    bad = [r.rid for r in reqs
           if r.status != "completed" or len(r.output) != max_new + 1]
    if bad:
        fail(f"requests {bad} did not complete with {max_new + 1} tokens")
    if launches != eng.cfg.model.n_layers * steps or steps == 0:
        fail(f"kernel launches {launches} != n_layers x decode steps "
             f"({eng.cfg.model.n_layers} x {steps})")
    stats = {"wall_s": wall, "tokens": eng.tokens_total, "steps": steps,
             "launches": launches}
    return eng, stats, snap


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
                      slots=3, prefill_len=16)
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


def library_attention(q, k_pages, v_pages, table, lengths):
    """torch's SDPA over the gathered context, gather included: the
    library yardstick for paged_attention (timed here only)."""
    import torch
    import torch.nn.functional as F

    b, nh, hd = q.shape
    nkv, _, ps, _ = k_pages.shape
    s = table.shape[1] * ps
    idx = table.long()
    k = k_pages[:, idx].reshape(nkv, b, s, hd).transpose(0, 1)
    v = v_pages[:, idx].reshape(nkv, b, s, hd).transpose(0, 1)
    kpos = torch.arange(s, device=q.device)
    mask = (kpos[None] < lengths[:, None])[:, None, None, :]
    out = F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                         enable_gqa=True)
    return out[:, :, 0]


def time_kernel(gen, bw: float, peaks: dict) -> dict:
    """Kernel, plain and library times at the production decode shape
    with every table full (4096 rows per sequence), bf16."""
    import torch

    from tpumon_torch.ops.paged_attention import (
        paged_attention,
        paged_attention_reference,
    )

    b, nh, nkv, hd, ps, mp = 16, 32, 8, 128, 128, 32
    args = paged_inputs(gen, b, nh, nkv, hd, ps, mp, [mp * ps] * b,
                        torch.bfloat16)
    lens = args[4]
    elem = 2
    kv_bytes = 2 * int(lens.sum().item()) * nkv * hd * elem
    io_bytes = (2 * b * nh * hd * elem + args[3].numel() * 4 + b * 4)
    ops = 4 * int(lens.sum().item()) * nh * hd
    t_bytes = (kv_bytes + io_bytes) / bw * 1e3
    t_ops = ops / peaks["bfloat16"] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    before = paged_attention.launches
    ms = cuda_ms(lambda: paged_attention(*args), reps=50)
    plain_ms = cuda_ms(lambda: paged_attention_reference(*args), reps=10)
    lib_ms = cuda_ms(lambda: library_attention(*args), reps=10)
    paged_attention.launches = before  # timing launches are not the path's
    ref = paged_attention_reference(*args).float()
    lib_err = (library_attention(*args).float() - ref).abs().max().item()
    ker_err = (paged_attention(*args).float() - ref).abs().max().item()
    paged_attention.launches = before
    print(f"time_paged_attention shape=B16/h32/kv8/hd128/page128/len4096 "
          f"bf16 kernel_ms={ms!r} plain_ms={plain_ms!r} "
          f"library_sdpa_ms={lib_ms!r} bound_ms={bound_ms!r} ({bound_by}: "
          f"{kv_bytes + io_bytes} B, {ops} op) "
          f"achieved_GBps={(kv_bytes + io_bytes) / ms / 1e6!r} "
          f"kernel_err={ker_err!r} library_err={lib_err!r}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    from tpumon_torch.ops.paged_attention import paged_attention
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

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = check_kernel(gen)
    eng, stats, snap = run_engine()
    compare_paths(eng, snap)
    check_small_engine_against_cpu()
    times = time_kernel(gen, bw, peaks)
    time_engine(eng, snap, stats)
    check_server(eng)

    row = {"name": "paged_attention", "route": "cuda",
           "source": "tpumon_torch/ops/csrc/paged_attention.cu",
           "replaces": "tpumon/ops/paged_attention.py:65",
           "launches": stats["launches"], "max_abs_err": worst["bfloat16"],
           **times}
    print(json.dumps({"kernels": [row]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
