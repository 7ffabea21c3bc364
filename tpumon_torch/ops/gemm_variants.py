"""Time variants of the GEMM kernels (``csrc/matmul.cu``) in one process.

Run from the repository root on a machine with a CUDA card and nvcc:

    python -m tpumon_torch.ops.gemm_variants [--json PATH]

Each variant is ``csrc/matmul.cu`` with textual substitutions
(``VARIANTS``), built with the package's nvcc flags into
``build/tpumon_torch/variants/<name>/`` (``build_variants``, which
``flash_variants`` shares). Each is run at the burn's 4096^3 with a
bf16 A, bf16 B and int8 Q, held to the plain product by
``tile_rel_err`` (worst relative error over 128 x 128 output tiles), and
timed with CUDA events in turns with cuBLAS (``torch.matmul``) and the
dequantized product. Diagnostic variants break the arithmetic on purpose
to show what a part of the kernel costs; their error is printed, not
checked. Prints one JSON line per variant, and the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import torch

from tpumon_torch.ops import _build

N = 4096
# name -> (substitutions, exact): exact variants must agree with the plain
# product; the others are diagnostics.
VARIANTS = {
    "as_built": ((), True),
    # 8 M tiles per N column in the tile order, not 16.
    "group_m_8": (
        (("constexpr int kGroupM = 16;", "constexpr int kGroupM = 8;"),), True),
    # int8: bf16 pairs packed by cvt.rn.bf16x2.f32, not a byte permute.
    "int8_cvt_pack": ((
        ("  return make_uint2(__byte_perm(f[0], f[1], 0x7632), "
         "__byte_perm(f[2], f[3], 0x7632));",
         "  return make_uint2(\n"
         "      pack_bf16(__uint_as_float(f[0]), __uint_as_float(f[1])),\n"
         "      pack_bf16(__uint_as_float(f[2]), __uint_as_float(f[3])));"),), True),
    # Diagnostic, int8: no fence.proxy.async after the widening.
    "int8_no_proxy_fence": ((
        ("  asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n}",
         "}"),), False),
    # Diagnostic, int8: no widening at all (wgmma reads stale bf16 stages).
    "int8_no_widening": ((
        ("void widen_half(const uint8_t* q, uint8_t* b, int half, int t) {\n",
         "void widen_half(const uint8_t* q, uint8_t* b, int half, int t) {\n"
         "  return;\n"),), False),
}


def variant_source(subs, source: str = "matmul.cu") -> str:
    """``csrc/<source>`` with the substitutions (old, new) made; each old
    text must be there."""
    src = (_build.CSRC / source).read_text()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"substitution target not in {source}: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(out_dir: Path, variants, bind, source: str = "matmul.cu",
                   entry: str | None = None) -> dict[str, tuple[ctypes.CDLL, str]]:
    """{name: (library, nvcc's output)} for ``variants`` {name:
    substitutions in ``source``}: one nvcc per variant, all started
    together, each in ``out_dir/<name>/``. The variant of ``source`` is
    compiled itself or, given ``entry``, beside a copy of that file, which
    includes it. ``bind(lib)`` sets the library's argtypes."""
    procs = {}
    for name, subs in variants.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(variant_source(subs, source))
        if entry:
            shutil.copy(_build.CSRC / entry, d)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(d / "lib.so"), str(d / (entry or source))]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err}{out}")
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        bind(lib)
        libs[name] = (lib, err + out)
    return libs


def bind_matmul(lib: ctypes.CDLL) -> None:
    lib.tpumon_matmul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.tpumon_quantized_matmul.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]


def tile_rel_err(got, want, tile: int = 128) -> float:
    m, n = want.shape
    a, b = (x.float().reshape(m // tile, tile, n // tile, tile) for x in (got, want))
    num = (a - b).square().sum((1, 3)).sqrt()
    return (num / b.square().sum((1, 3)).sqrt().clamp_min(1e-30)).max().item()


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_variants needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build_variants(
        _build.BUILD_DIR / "variants",
        {name: subs for name, (subs, _) in VARIANTS.items()}, bind_matmul)
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(N, N, generator=gen, device="cuda").bfloat16()
    b = torch.randn(N, N, generator=gen, device="cuda").bfloat16()
    q = torch.randint(-127, 128, (N, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    scale = (1 + 0.25 * torch.randn(N, generator=gen, device="cuda")) / 127
    want_mm = (a.float() @ b.float()).bfloat16()
    want_q = ((a.float() @ q.float()) * scale).bfloat16()
    c = torch.empty(N, N, device="cuda", dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for name, (lib, _) in libs.items():
        def mm(lib=lib):
            err = lib.tpumon_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                    N, N, N, 1, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        def qmm(lib=lib):
            err = lib.tpumon_quantized_matmul(
                a.data_ptr(), q.data_ptr(), scale.data_ptr(), c.data_ptr(),
                N, N, N, 1, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        mm()
        torch.cuda.synchronize()
        mm_err = tile_rel_err(c, want_mm)
        qmm()
        torch.cuda.synchronize()
        q_err = tile_rel_err(c, want_q)
        exact = VARIANTS[name][1]
        row = {"variant": name, "exact": exact,
               "library_ms": cuda_ms(lambda: torch.matmul(a, b)),
               "matmul_ms": cuda_ms(mm), "quantized_ms": cuda_ms(qmm),
               "dequant_library_ms": cuda_ms(
                   lambda: a @ (q.to(a.dtype) * scale.to(a.dtype))),
               "matmul_tile_rel_err": mm_err, "quantized_tile_rel_err": q_err}
        row["agrees"] = mm_err <= 4e-3 and q_err <= 4e-3
        print(json.dumps(row), flush=True)
        lines.append(row)
        if exact and not row["agrees"]:
            raise SystemExit(f"variant {name} disagrees with the plain product")
    if args.json:
        Path(args.json).write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
