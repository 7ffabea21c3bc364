"""Where the bf16 flash gradients' spread against their plain versions
comes from, measured on the CPU.

For each seed, bf16 q, k, v, dO are drawn with numpy; lse and O come
from the port's plain forward. Three things are held to the port's plain
backward (``flash_attention_tri_bwd_dq_reference`` / ``_dkv_reference``)
by ``tile_rel_err``, the worst ||got - want|| / ||want|| over 64-row
tiles (chip_smoke's metric and limit):

- ``ref_kernel``: the JAX reference's Pallas backward
  (``tpumon/ops/flash_attention.py::flash_attention_tri_bwd``) in
  interpret mode, on the same lse and O;
- ``exp2``: the plain version with P taken as exp2 of a pre-scaled
  argument, as the card's kernels take it (another f32 path, each step
  rounded to nearest): only the f32 values of P and dS differ, so only
  where they round to bf16;
- ``tiles``: the plain version with P and dS rounded exactly as it
  rounds them, and the gradient products summed over 64-key tiles in
  turn: the accumulation order alone.

Run from the repository root (minutes at the production shape):

    JAX_PLATFORMS=cpu python -m tests.flash_spread --shape 128x1024x128 \
        --seeds 0-7

``--slices DIR`` instead reads the slices ``chip_smoke.py`` phase 7 saves
(``build/flash_spread/*.npz``: each case's worst (output, bh) slice, with
the card kernel's gradients, lse and D there) and holds the card's
kernel, the reference's kernel and the plain version to each other on
the same inputs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

LOG2E = 1.4426950408889634


def tile_rel_err(got, want, tile: int = 64) -> float:
    bh, t, _ = want.shape
    a, b = (x.float().reshape(bh, t // tile, -1) for x in (got, want))
    return ((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max(
        ).item()


def plain_model(q, k, v, g, lse, dvec, mode: str):
    """(dq, dk, dv) of the plain backward with P by ``exp`` or ``exp2``,
    or (``tiles``) its products summed over 64-key tiles in turn."""
    t, d = q.shape[1:]
    scale = 1.0 / d**0.5
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for c in range(0, q.shape[0], 8):
        qc, kc, vc, gc = (x[c:c + 8].float() for x in (q, k, v, g))
        s = torch.matmul(qc, kc.transpose(1, 2))
        if mode == "exp2":
            arg = s * (scale * LOG2E) - (lse[c:c + 8] * LOG2E)[..., None]
            p = torch.where(causal, torch.exp2(arg), 0.0)
        else:
            p = torch.where(causal, torch.exp(s * scale
                                              - lse[c:c + 8][..., None]),
                            0.0)
        dp = torch.matmul(gc, vc.transpose(1, 2))
        ds = p * (dp - dvec[c:c + 8][..., None]) * scale
        pb, dsb = p.to(q.dtype).float(), ds.to(q.dtype).float()
        if mode == "tiles":
            steps = range(0, t, 64)
            dq[c:c + 8] = sum(dsb[:, :, j:j + 64] @ kc[:, j:j + 64]
                              for j in steps).to(q.dtype)
            dk[c:c + 8] = sum(dsb[:, j:j + 64].transpose(1, 2)
                              @ qc[:, j:j + 64] for j in steps).to(q.dtype)
            dv[c:c + 8] = sum(pb[:, j:j + 64].transpose(1, 2)
                              @ gc[:, j:j + 64] for j in steps).to(q.dtype)
        else:
            dq[c:c + 8] = (dsb @ kc).to(q.dtype)
            dk[c:c + 8] = (dsb.transpose(1, 2) @ qc).to(q.dtype)
            dv[c:c + 8] = (pb.transpose(1, 2) @ gc).to(q.dtype)
    return dq, dk, dv


def spread(bh: int, t: int, d: int, seed: int) -> dict:
    """tile_rel_err of (dq, dk, dv) by source, on one seed's draw."""
    import jax.numpy as jnp

    from tests.torch_parity import jax_f32, to_jax, to_torch
    from tpumon.ops import flash_attention as jax_fa
    from tpumon_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((bh, t, d), np.float32) for _ in range(4)]
    q, k, v, g = to_torch(arrs, torch.bfloat16)
    out, lse = fa.flash_attention_tri_fwd_reference(q, k, v)
    dvec = (g.float() * out.float()).sum(-1)
    want = (fa.flash_attention_tri_bwd_dq_reference(q, k, v, g, lse, dvec),
            *fa.flash_attention_tri_bwd_dkv_reference(q, k, v, g, lse,
                                                      dvec))
    jq, jk, jv, jg = to_jax(arrs, jnp.bfloat16)
    ref = jax_fa.flash_attention_tri_bwd(
        jq, jk, jv, jnp.asarray(out.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(lse.numpy()), jg, block=128, interpret=True)
    got = {"ref_kernel": [torch.tensor(jax_f32(x)).to(torch.bfloat16)
                          for x in ref]}
    for mode in ("exp2", "tiles"):
        got[mode] = plain_model(q, k, v, g, lse, dvec, mode)
    return {src: [tile_rel_err(a, b) for a, b in zip(outs, want)]
            for src, outs in got.items()}


def slice_readings(path) -> dict:
    """tile_rel_err of (dq, dk, dv), the card's kernel and the reference's
    kernel against the plain version and against each other, on one slice
    saved by chip_smoke.py."""
    import jax.numpy as jnp

    from tests.torch_parity import jax_f32
    from tpumon.ops import flash_attention as jax_fa
    from tpumon_torch.ops import flash_attention as fa

    z = np.load(path)

    def bf16(name):
        return torch.from_numpy(z[name]).view(torch.bfloat16)

    q, k, v, g, out = (bf16(n) for n in ("q", "k", "v", "dout", "out"))
    card = [bf16(n) for n in ("dq", "dk", "dv")]
    lse, dvec = (torch.from_numpy(z[n]) for n in ("lse", "dvec"))
    plain = (fa.flash_attention_tri_bwd_dq_reference(q, k, v, g, lse, dvec),
             *fa.flash_attention_tri_bwd_dkv_reference(q, k, v, g, lse,
                                                       dvec))
    jq, jk, jv, jg, jout = (jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16) for x in (q, k, v, g, out))
    ref = [torch.tensor(jax_f32(x)).to(torch.bfloat16)
           for x in jax_fa.flash_attention_tri_bwd(
               jq, jk, jv, jout, jnp.asarray(lse.numpy()), jg, block=128,
               interpret=True)]
    return {"card_vs_plain": [tile_rel_err(a, b)
                              for a, b in zip(card, plain)],
            "ref_vs_plain": [tile_rel_err(a, b) for a, b in zip(ref, plain)],
            "card_vs_ref": [tile_rel_err(a, b) for a, b in zip(card, ref)],
            "saved": (str(z["output"]), int(z["bh"]), float(z["reading"]))}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="6x384x64",
                    help="BHxTxD, T a multiple of 128 (default 6x384x64)")
    ap.add_argument("--seeds", default="0-3", help="first-last (default 0-3)")
    ap.add_argument("--slices", help="a directory of chip_smoke.py's slices")
    args = ap.parse_args(argv)
    if args.slices:
        from pathlib import Path

        for path in sorted(Path(args.slices).glob("*.npz")):
            row = slice_readings(path)
            print(f"flash_spread_slice {path.stem} " + " ".join(
                f"{key}={val!r}" for key, val in row.items()), flush=True)
        return
    bh, t, d = (int(x) for x in args.shape.split("x"))
    lo, _, hi = args.seeds.partition("-")
    worst: dict[str, float] = {}
    for seed in range(int(lo), int(hi or lo) + 1):
        t0 = time.perf_counter()
        row = spread(bh, t, d, seed)
        for src, errs in row.items():
            worst[src] = max(worst.get(src, 0.0), *errs)
        print(f"flash_spread BH{bh}/T{t}/hd{d} seed={seed} "
              + " ".join(f"{src}(dq,dk,dv)={errs!r}"
                         for src, errs in row.items())
              + f" wall_s={time.perf_counter() - t0!r}", flush=True)
    print(f"flash_spread BH{bh}/T{t}/hd{d} worst={worst!r}", flush=True)


if __name__ == "__main__":
    main()
