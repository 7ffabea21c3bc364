"""Time source variants of the bf16 flash kernels in one process: the
forward (``csrc/flash_fwd.cuh``) or, with ``--backward``, the backward's
dQ and dK/dV kernels (``csrc/flash_attention_tri_bwd.cu``).

Run from the repository root on a machine with a CUDA card and nvcc:

    python -m tpumon_torch.ops.flash_variants [--backward] [--json PATH]
        [--only NAME ...]

Each variant is the source with textual substitutions (``VARIANTS``,
``BWD_VARIANTS``), built with the package's nvcc flags into
``build/tpumon_torch/flash_variants/<name>/`` (or ``flash_bwd_variants``;
``gemm_variants.build_variants``: one nvcc per variant, all started
together); a forward variant beside a copy of ``csrc/flash_attention.cu``,
which includes it. Forward: each runs the rectangular forward, causal and
not, at the training shape (BH 128, T 1024, hd 128) and causal at the
seq-8k shape (BH 16, T 8192), bf16, held to the plain version by the worst
relative error over 64-row tiles under chip_smoke.py's bf16 out limit
(1.5e-2). Backward: each runs dQ and dK/dV at both shapes on the plain
forward's lse and D, each output held to its plain version under the bf16
gradient limit (2.3e-3), or to the as-built kernel's own reading where
that is over it, but for the diagnostic variants (``BWD_DIAGNOSTIC``),
whose readings are printed only. Times are CUDA events: per shape, every
variant twice in palindromic order (a, b, ..., b, a) between two timings
of torch's SDPA on the same inputs under each pinned backend that runs
(the backward: autograd.grad of one recorded forward). Prints the card's
name and power limit, each variant's ptxas lines for its bf16 kernels,
and one JSON line per variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from tpumon_torch.ops import _build, gemm_variants
from tpumon_torch.ops.flash_attention import flash_attention_reference
from tpumon_torch.ops.gemm_variants import cuda_ms

TOL = 1.5e-2  # chip_smoke.FLASH_TOL["bfloat16"]["out"]
# (name, BH, T, causal): the training shape both ways, the seq-8k shape.
SHAPES = (("train_causal", 128, 1024, True), ("train_full", 128, 1024, False),
          ("seq8k_causal", 16, 8192, True))
# name -> substitutions in flash_fwd.cuh; every variant computes the same
# function and must agree with the plain version.
VARIANTS = {
    "as_built": (),
    # A third K and V stage (224 KB of shared memory at hd 128).
    "stages_3": (("constexpr int kStages = 2;",
                  "constexpr int kStages = 3;"),),
    # No overlap inside a warpgroup: wait for S_j and P V together before
    # the softmax.
    "no_overlap": (("wgmma_wait<1>();  // S_j is done",
                    "wgmma_wait<0>();  // S_j is done"),),
    # The two arithmetic warpgroups issue their products as they come,
    # not in turns.
    "no_pingpong": (
        ("auto my_turn = [&] { named_sync(1 + wg, 256); };",
         "auto my_turn = [&] {};"),
        ("auto their_turn = [&] { named_arrive(2 - wg, 256); };",
         "auto their_turn = [&] {};")),
    # exp2f (denormals kept) in place of ex2.approx.ftz in the softmax.
    "exp2f": (("x = ex2(fmaf(x, scale_log2, -mb));",
               "x = exp2f(fmaf(x, scale_log2, -mb));"),),
    # The causal grid in sequence order, not longest rows first.
    "grid_in_order": (("const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;",
                       "const int q0 = blockIdx.x * kBM;"),),
    # The grid bh-major: every bh's last q tile first, then the one before
    # (the CTAs in flight read as many bhs' K and V as there are SMs).
    "grid_bh_major": (
        ("  const int bh = blockIdx.y;\n"
         "  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;",
         "  const int bh = blockIdx.x;\n"
         "  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;"),
        ("  const dim3 grid((t + wg::kBM - 1) / wg::kBM, bh);",
         "  const dim3 grid(bh, (t + wg::kBM - 1) / wg::kBM);")),
}


GRAD_TOL = 2.3e-3  # chip_smoke.FLASH_TOL["bfloat16"]["grad"]
# (name, BH, T) of the backward's timings: the training shape, seq 8k.
BWD_SHAPES = (("train", 128, 1024), ("seq8k", 16, 8192))
# The dK/dV loop's schedule within a warpgroup, as built: tile j-1's
# gradient products, then tile j's score products, then P_j and dS_j.
DKV_SERIAL = """\
      if (j > first) {  // tile j-1's dK/dV products, then its stage back
        issue_dkv(j - 1);
        wgmma_wait<0>();
        fence_operands(acc_dk);
        fence_operands(acc_dv);
        release(j - 1);
      }
      issue_sdp(j);
      turn.theirs();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);
      grads(j);
      pack();"""
# name -> substitutions in flash_attention_tri_bwd.cu; every variant
# computes the same function.
BWD_VARIANTS = {
    "as_built": (),
    # dQ's arithmetic warpgroups issue as they come, not in turns.
    "dq_no_pingpong": (("constexpr bool kDqPingPong = true,",
                        "constexpr bool kDqPingPong = false,"),),
    # dK/dV's arithmetic warpgroups take turns issuing their products.
    "dkv_pingpong": (("kDkvPingPong = false;", "kDkvPingPong = true;"),),
    # Two streamed stages in both kernels, not three.
    "stages_2": (("constexpr int kDqStages = kSplit ? 2 : 3;",
                  "constexpr int kDqStages = 2;"),
                 ("constexpr int kDkvStages = kSplit ? 2 : 3;",
                  "constexpr int kDkvStages = 2;")),
    # dQ without overlap inside a warpgroup: wait for the score products
    # and the previous tile's gradient product together.
    "dq_no_overlap": (("wgmma_wait<1>();  // S_j and dP_j are done",
                       "wgmma_wait<0>();  // S_j and dP_j are done"),),
    # dK/dV issues tile j's score products and tile j-1's gradient
    # products together, then waits for both.
    "dkv_together": ((DKV_SERIAL, """\
      issue_sdp(j);
      if (j > first) issue_dkv(j - 1);
      turn.theirs();
      wgmma_wait<0>();
      if (j > first) {
        fence_operands(acc_dk);
        fence_operands(acc_dv);
        release(j - 1);
      }
      fence_operands(s);
      fence_operands(dp);
      grads(j);
      pack();"""),),
    # dK/dV as dQ: P_j and dS_j computed while tile j-1's gradient
    # products run.
    "dkv_overlap": ((DKV_SERIAL, """\
      issue_sdp(j);
      if (j > first) issue_dkv(j - 1);
      turn.theirs();
      if (j > first) {
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_operands(s);
      fence_operands(dp);
      grads(j);
      if (j > first) {
        wgmma_wait<0>();
        fence_operands(acc_dk);
        fence_operands(acc_dv);
        fence_operands(pf);
        fence_operands(dsf);
        release(j - 1);
      }
      pack();"""),),
    # dQ streams 128-row k tiles (S and dP by m64n128k16; 2 stages fit).
    "dq_k_tile_128": (("constexpr int kDqK = 64;", "constexpr int kDqK = 128;"),
                      ("constexpr int kDqStages = kSplit ? 2 : 3;",
                       "constexpr int kDqStages = 2;")),
    # dK/dV streams 32-row q tiles (S^T and dP^T by m64n32k16).
    "dkv_q_tile_32": (("constexpr int kDkvQ = 64;", "constexpr int kDkvQ = 32;"),),
    # Both grids shortest tiles first.
    "grid_shortest_first": (
        ("const int q0 = (gridDim.x - 1 - blockIdx.x) * kOwn;  // the longest rows first",
         "const int q0 = blockIdx.x * kOwn;"),
        ("const int k0 = blockIdx.x * kOwn;  // the first k tile, the longest, first",
         "const int k0 = (gridDim.x - 1 - blockIdx.x) * kOwn;")),
    # Both grids bh-major: every bh's longest tile first, then the next.
    "grid_bh_major": (
        ("  const int bh = blockIdx.y;\n"
         "  const int q0 = (gridDim.x - 1 - blockIdx.x) * kOwn;  // the longest rows first",
         "  const int bh = blockIdx.x;\n"
         "  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;"),
        ("  const int bh = blockIdx.y;\n"
         "  const int k0 = blockIdx.x * kOwn;  // the first k tile, the longest, first",
         "  const int bh = blockIdx.x;\n"
         "  const int k0 = blockIdx.y * kOwn;"),
        ("const dim3 grid((t + kOwn - 1) / kOwn, bh);  // a bh's tiles together",
         "const dim3 grid(bh, (t + kOwn - 1) / kOwn);")),
    # P by expf of the plain version's own steps (the product rounded,
    # then the difference), not ex2.approx of a pre-scaled FFMA.
    "plain_expf": (("  return ex2(fmaf(s, scale * kLog2e, -lse * kLog2e));",
                    "  return expf(__fsub_rn(__fmul_rn(s, scale), lse));"),),
}
# Backward variants whose agreement is printed, not required: they round
# P and dS to bf16 at other places than the plain version.
BWD_DIAGNOSTIC = ("plain_expf",)
# kernel family -> (source with the substitutions, file that includes it
# or None, its variants)
SOURCES = {"fwd": ("flash_fwd.cuh", "flash_attention.cu", VARIANTS),
           "bwd": ("flash_attention_tri_bwd.cu", None, BWD_VARIANTS)}


def variant_source(subs, kernel: str = "fwd") -> str:
    return gemm_variants.variant_source(subs, SOURCES[kernel][0])


def bind(lib: ctypes.CDLL) -> None:
    lib.tpumon_flash_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def bind_bwd(lib: ctypes.CDLL) -> None:
    tail = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    lib.tpumon_flash_tri_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
    lib.tpumon_flash_tri_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + tail


def ptxas_lines(nvcc_output: str) -> list[str]:
    """ptxas's lines for the bf16 (wgmma) kernels."""
    lines, keep = [], False
    for ln in nvcc_output.splitlines():
        if "Compiling entry function" in ln:
            keep = "wgmma" in ln
        if keep and any(k in ln for k in ("Compiling", "spill", "Used ")):
            lines.append(ln.strip())
    return lines


def tile_rel_err(got, want, tile: int = 64) -> float:
    bh, t, _ = want.shape
    a, b = (x.float().reshape(bh, t // tile, -1) for x in (got, want))
    err = (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)
    return err.max().item()


SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION")  # SDPBackend names


def sdpa_calls(q, k, v, dout, view, causal: bool = True) -> dict:
    """{backend: call} of torch's SDPA under each pinned backend that runs
    these [BH, T, D] inputs viewed as ``view``: the forward, or with dout
    autograd.grad of one forward recorded under the backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    calls = {}
    for backend in SDPA_BACKENDS:
        pinned = getattr(SDPBackend, backend)
        qs, ks, vs = (x.view(view) for x in (q, k, v))
        try:
            if dout is None:
                def call(qs=qs, ks=ks, vs=vs, pinned=pinned):
                    with sdpa_kernel(pinned):
                        return F.scaled_dot_product_attention(
                            qs, ks, vs, is_causal=causal)
                call()
            else:
                qg, kg, vg = (x.detach().requires_grad_(True)
                              for x in (qs, ks, vs))
                with sdpa_kernel(pinned):
                    o = F.scaled_dot_product_attention(qg, kg, vg,
                                                       is_causal=causal)

                def call(o=o, qg=qg, kg=kg, vg=vg, g=dout.view(view)):
                    return torch.autograd.grad(o, (qg, kg, vg), g,
                                               retain_graph=True)
        except RuntimeError as e:
            print(f"sdpa backend {backend} not run: "
                  f"{str(e).splitlines()[0][:160]}", flush=True)
            continue
        calls[backend] = call
    return calls


def time_in_turns(runs: dict, sdpa: dict, row_of: dict, key: str) -> None:
    """Each run twice, in palindromic order between two timings of each
    SDPA call, so that a drift of the card's clock over the run weighs on
    every variant alike; appends to row_of[name][key + "_ms"] and sets
    key + "_sdpa_ms" in every row."""
    sdpa_ms = {b: [cuda_ms(call)] for b, call in sdpa.items()}
    for name in [*runs, *reversed(runs)]:
        row_of[name].setdefault(f"{key}_ms", []).append(cuda_ms(runs[name]))
    for b, call in sdpa.items():
        sdpa_ms[b].append(cuda_ms(call))
    for row in row_of.values():
        row[f"{key}_sdpa_ms"] = sdpa_ms


def time_forward(names, stream) -> list[dict]:
    built = gemm_variants.build_variants(
        _build.BUILD_DIR / "flash_variants",
        {name: VARIANTS[name] for name in names}, bind,
        source="flash_fwd.cuh", entry="flash_attention.cu")
    libs = {name: (lib, ptxas_lines(log)) for name, (lib, log) in built.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for shape, bh, t, causal in SHAPES:
        qkv = [torch.randn(bh, t, 128, generator=gen, device="cuda").bfloat16()
               for _ in range(3)]
        inputs[shape] = (qkv, flash_attention_reference(*qkv, causal))
    for name, (_, ptxas) in libs.items():
        for ln in ptxas:
            print(f"ptxas {name}: {ln}", flush=True)
    rows = {name: {"variant": name} for name in libs}
    for shape, bh, t, causal in SHAPES:
        (q, k, v), want = inputs[shape]
        out = torch.empty_like(q)

        def launcher(name, lib, q=q, k=k, v=v, out=out, bh=bh, t=t,
                     causal=causal):
            def run():
                err = lib.tpumon_flash_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    bh, t, 128, 1, int(causal), 128 ** -0.5, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            return run

        runs = {name: launcher(name, lib) for name, (lib, _) in libs.items()}
        for name, run in runs.items():
            run()
            torch.cuda.synchronize()
            rows[name][f"{shape}_tile_rel_err"] = tile_rel_err(out, want)
        time_in_turns(runs, sdpa_calls(q, k, v, None, (bh // 16, 16, t, 128),
                                       causal), rows, shape)
    for row in rows.values():
        row["agrees"] = all(row[f"{s[0]}_tile_rel_err"] <= TOL for s in SHAPES)
    return list(rows.values())


def time_backward(names, stream) -> list[dict]:
    from tpumon_torch.ops import flash_attention as fa

    built = gemm_variants.build_variants(
        _build.BUILD_DIR / "flash_bwd_variants",
        {name: BWD_VARIANTS[name] for name in names}, bind_bwd,
        source="flash_attention_tri_bwd.cu")
    libs = {name: (lib, ptxas_lines(log)) for name, (lib, log) in built.items()}
    for name, (_, ptxas) in libs.items():
        for ln in ptxas:
            print(f"ptxas {name}: {ln}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {name: {"variant": name} for name in libs}
    for shape, bh, t in BWD_SHAPES:
        q, k, v, g = (torch.randn(bh, t, 128, generator=gen,
                                  device="cuda").bfloat16() for _ in range(4))
        out, lse = fa.flash_attention_tri_fwd_reference(q, k, v)
        dvec = (g.float() * out.float()).sum(-1)
        want = {"dq": fa.flash_attention_tri_bwd_dq_reference(
            q, k, v, g, lse, dvec)}
        want["dk"], want["dv"] = fa.flash_attention_tri_bwd_dkv_reference(
            q, k, v, g, lse, dvec)
        got = {x: torch.empty_like(q) for x in want}
        ptrs = [x.data_ptr() for x in (q, k, v, g, lse, dvec)]

        def launcher(name, lib, kernel, outs, bh=bh, t=t):
            fn = getattr(lib, f"tpumon_flash_tri_bwd_{kernel}")

            def run():
                err = fn(*ptrs, *(got[x].data_ptr() for x in outs), bh, t,
                         128, 1, 128 ** -0.5, stream)
                if err:
                    raise RuntimeError(f"{name} {kernel}: CUDA error {err}")
            return run

        # SDPA's whole backward (dq, dk and dv in one call) around each
        # kernel's turns.
        sdpa = sdpa_calls(q, k, v, g, (bh // 16, 16, t, 128))
        for kernel, outs in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            runs = {name: launcher(name, lib, kernel, outs)
                    for name, (lib, _) in libs.items()}
            for name, run in runs.items():
                run()
                torch.cuda.synchronize()
                rows[name][f"{shape}_{kernel}_tile_rel_err"] = max(
                    tile_rel_err(got[x], want[x]) for x in outs)
            time_in_turns(runs, sdpa, rows, f"{shape}_{kernel}")
        del q, k, v, g, out, lse, dvec, want, got, sdpa
        torch.cuda.empty_cache()
    # Held to the plain version under the gradient limit; where the
    # as-built kernel reads over it on the same draw (bf16 roundings of
    # dS that land otherwise than the plain version's: the first draw at
    # the training shape reads 1.93e-3 in dQ, with the earlier mma.sync
    # kernels too; PERF.md), no worse than the as-built kernel.
    keys = [f"{s[0]}_{k}_tile_rel_err" for s in BWD_SHAPES
            for k in ("dq", "dkv")]
    base = rows.get("as_built", {})
    for name, row in rows.items():
        row["diagnostic"] = name in BWD_DIAGNOSTIC
        row["agrees"] = all(row[k] <= max(GRAD_TOL, base.get(k, 0.0))
                            for k in keys)
    return list(rows.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backward", action="store_true",
                    help="time the backward's variants, not the forward's")
    ap.add_argument("--json", help="also write the lines to this file")
    ap.add_argument("--only", nargs="+",
                    choices=sorted({*VARIANTS, *BWD_VARIANTS}),
                    help="build and time these variants only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    variants = BWD_VARIANTS if args.backward else VARIANTS
    names = [n for n in args.only or variants if n in variants]
    stream = torch.cuda.current_stream().cuda_stream
    lines = (time_backward if args.backward else time_forward)(names, stream)
    for row in lines:
        print(json.dumps(row), flush=True)
    if args.json:
        Path(args.json).write_text(
            "".join(json.dumps(r) + "\n" for r in lines))
    wrong = [row["variant"] for row in lines
             if not row["agrees"] and not row.get("diagnostic")]
    if wrong:
        raise SystemExit(f"variants {wrong} disagree with the plain version")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
