"""Time variants of the bf16 flash forward (``csrc/flash_fwd.cuh``) in one
process.

Run from the repository root on a machine with a CUDA card and nvcc:

    python -m tpumon_torch.ops.flash_variants [--json PATH] [--only NAME ...]

Each variant is ``csrc/flash_fwd.cuh`` with textual substitutions
(``VARIANTS``), built beside a copy of ``csrc/flash_attention.cu`` with the
package's nvcc flags into ``build/tpumon_torch/flash_variants/<name>/``
(``gemm_variants.build_variants``: one nvcc per variant, all started
together). Each runs the rectangular
forward, causal and not, at the training shape (BH 128, T 1024, hd 128)
and causal at the seq-8k shape (BH 16, T 8192), bf16; each output is held
to the plain version by the worst relative error over 64-row tiles under
chip_smoke.py's bf16 limit (1.5e-2) and timed with CUDA events: per
shape, every variant twice in palindromic order (a, b, ..., b, a) between
two timings of torch's SDPA on the same inputs. Prints the card's name
and power limit, each variant's ptxas lines for its bf16 kernels, and one
JSON line per variant.
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


def variant_source(subs) -> str:
    return gemm_variants.variant_source(subs, "flash_fwd.cuh")


def bind(lib: ctypes.CDLL) -> None:
    lib.tpumon_flash_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


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


def main(argv=None) -> int:
    import torch.nn.functional as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the lines to this file")
    ap.add_argument("--only", nargs="+", choices=sorted(VARIANTS),
                    help="build and time these variants only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    built = gemm_variants.build_variants(
        _build.BUILD_DIR / "flash_variants",
        {name: VARIANTS[name] for name in args.only or VARIANTS}, bind,
        source="flash_fwd.cuh", entry="flash_attention.cu")
    libs = {name: (lib, ptxas_lines(log)) for name, (lib, log) in built.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
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

        view = (bh // 16, 16, t, 128)

        def sdpa(q=q, k=k, v=v, view=view, causal=causal):
            return F.scaled_dot_product_attention(
                q.view(view), k.view(view), v.view(view), is_causal=causal)

        runs = {name: launcher(name, lib) for name, (lib, _) in libs.items()}
        for name, run in runs.items():
            run()
            torch.cuda.synchronize()
            rows[name][f"{shape}_tile_rel_err"] = tile_rel_err(out, want)
        # Each variant twice, in palindromic order between two SDPA
        # timings, so that a drift of the card's clock over the run
        # weighs on every variant alike.
        sdpa_ms = [cuda_ms(sdpa)]
        for name in [*runs, *reversed(runs)]:
            rows[name].setdefault(f"{shape}_ms", []).append(
                cuda_ms(runs[name]))
        sdpa_ms.append(cuda_ms(sdpa))
        for row in rows.values():
            row[f"{shape}_sdpa_ms"] = sdpa_ms
    lines = list(rows.values())
    for row in lines:
        row["agrees"] = all(row[f"{s[0]}_tile_rel_err"] <= TOL for s in SHAPES)
        print(json.dumps(row), flush=True)
    wrong = [row["variant"] for row in lines if not row["agrees"]]
    if args.json:
        Path(args.json).write_text(
            "".join(json.dumps(r) + "\n" for r in lines))
    if wrong:
        raise SystemExit(f"variants {wrong} disagree with the plain version")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
