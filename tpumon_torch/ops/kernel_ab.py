"""Time the port's kernels at their production shapes in several checkouts
of the repository, in turns, on one card.

    python -m tpumon_torch.ops.kernel_ab DIR [DIR ...] [--turns 2] [--reps 200]

The checkouts run in order and then in reverse, ``--turns`` times (A, B,
B, A, ... for two), so drift on the card spreads over all of them. Each
reading is a fresh process started in one checkout's root (two
checkouts' ``tpumon_torch`` cannot share a process) that builds that
checkout's kernels and prints one line: the checkout and a JSON object of
microseconds per call, each the mean over ``--reps`` calls after a warm-up
(chip_smoke.cuda_ms), three readings a kernel: the paged kernel (B 16,
32/8 heads, hd 128, page 128, 4096 rows each), the causal flash forward
as the triangle and as the rectangle, dQ and dK/dV (BH 128, T 1024, hd
128), and the bf16 and int8 GEMMs at 4096^3, all bf16. Compare two
versions only within one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path


def _one(reps: int) -> None:
    """Time the kernels of the checkout in the working directory (it takes
    the place of this file's directory on the import path)."""
    sys.path[0] = os.getcwd()
    import torch

    import chip_smoke as c
    from tpumon_torch.ops import _build
    from tpumon_torch.ops import flash_attention as fa
    from tpumon_torch.ops import matmul as mm
    from tpumon_torch.ops import paged_attention as pa
    from tpumon_torch.ops import quant_matmul as qm

    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g, _, lse, dvec = c.flash_inputs(gen, 128, 1024, 128,
                                              torch.bfloat16)
    args = c.paged_inputs(gen, 16, 32, 8, 128, 128, 32, [4096] * 16,
                          torch.bfloat16)
    a, b = (torch.randn(4096, 4096, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    qi = torch.randint(-127, 128, (4096, 4096), generator=gen, device="cuda",
                       dtype=torch.int8)
    sc = torch.full((4096,), 1 / 127, device="cuda")
    calls = {
        "paged": lambda: pa.paged_attention(*args),
        "tri_fwd": lambda: fa.flash_attention_tri_fwd(q, k, v),
        "rect_causal": lambda: fa.flash_attention(q, k, v, causal=True),
        "dq": lambda: fa.flash_attention_tri_bwd_dq(q, k, v, g, lse, dvec),
        "dkv": lambda: fa.flash_attention_tri_bwd_dkv(q, k, v, g, lse, dvec),
        "matmul": lambda: mm.matmul(a, b),
        "int8": lambda: qm.quantized_matmul_kernel(a, qi, sc),
    }
    us = {name: [round(c.cuda_ms(fn, reps=reps, warmup=20) * 1e3, 2)
                 for _ in range(3)] for name, fn in calls.items()}
    print(f"{os.getcwd()} {json.dumps(us)}", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", help="checkout roots")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        _one(args.reps)
        return 0
    dirs = [str(Path(d).resolve()) for d in args.dirs]
    if not dirs:
        ap.error("name at least one checkout")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    order = [d for _ in range(args.turns) for d in (*dirs, *dirs[::-1])]
    for d in order:
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one",
             "--reps", str(args.reps)], cwd=d)
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
