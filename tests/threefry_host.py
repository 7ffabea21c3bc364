"""csrc/threefry.cu's arithmetic compiled for the host, so the CPU tests can
hold it to the plain versions (tpumon_torch/prng.py) bit for bit.

The kernel's device functions (Threefry, XLA's log, log1p and erf_inv,
the per-element draws and the argmax order) are cut out of the source
unchanged and compiled with the host's C++ compiler under shims of the
CUDA intrinsics they use (each an IEEE float or double operation rounded
to nearest, no contraction). Loops over the elements stand in for the
grids; ``patch`` routes ``tpumon_torch.ops.threefry``'s launches to them,
so the wrappers' own argument handling is exercised too.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

SOURCE = (Path(__file__).resolve().parents[1] / "tpumon_torch" / "ops"
          / "csrc" / "threefry.cu")

_SHIM = r"""
#include <math.h>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>
using std::isnan;
#define __device__
#define __forceinline__ inline
#define F32(x) static_cast<float>(x)
struct __nv_bfloat16 { uint16_t x; };
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return std::sqrt(a); }
static inline double __dmul_rn(double a, double b) { return a * b; }
static inline double __dadd_rn(double a, double b) { return a + b; }
static inline float __double2float_rn(double d) { return (float)d; }
static inline int32_t __float_as_int(float f) {
  int32_t i; memcpy(&i, &f, 4); return i; }
static inline float __int_as_float(int32_t i) {
  float f; memcpy(&f, &i, 4); return f; }
static inline float __uint_as_float(uint32_t i) {
  float f; memcpy(&f, &i, 4); return f; }
static inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; memcpy(&u, &f, 4); __nv_bfloat16 r;
  if (std::isnan(f)) { r.x = 0x7FC0; return r; }
  u += 0x7FFF + ((u >> 16) & 1); r.x = (uint16_t)(u >> 16); return r; }
static inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.x << 16; float f; memcpy(&f, &u, 4); return f; }
"""

_LOOPS = r"""
extern "C" {
void host_draw(const long long* keys, long long rows, long long n, int kind,
               int dtype, float lo, float scale, float mul, unsigned mask,
               unsigned span, unsigned mult, unsigned ilo, void* out) {
  const DrawArgs a{keys, rows, n, lo, scale, mul, mask, span, mult, ilo};
  const int words = kind == kRandint ? 4 : 2;
  for (long long r = 0; r < rows; ++r)
    for (long long i = 0; i < n; ++i) {
      const long long* key = keys + r * words;
      const long long t = r * n + i;
      switch (kind * 8 + dtype) {
        case kBits * 8 + 5: ((long long*)out)[t] =
            draw_one<kBits, long long>(a, key, i); break;
        case kUniform * 8 + 0: ((float*)out)[t] =
            draw_one<kUniform, float>(a, key, i); break;
        case kUniform * 8 + 1: ((__nv_bfloat16*)out)[t] =
            draw_one<kUniform, __nv_bfloat16>(a, key, i); break;
        case kNormal * 8 + 0: ((float*)out)[t] =
            draw_one<kNormal, float>(a, key, i); break;
        case kNormal * 8 + 1: ((__nv_bfloat16*)out)[t] =
            draw_one<kNormal, __nv_bfloat16>(a, key, i); break;
        case kGumbel * 8 + 0: ((float*)out)[t] =
            draw_one<kGumbel, float>(a, key, i); break;
        case kRandint * 8 + 2: ((int8_t*)out)[t] =
            draw_one<kRandint, int8_t>(a, key, i); break;
        case kRandint * 8 + 3: ((int16_t*)out)[t] =
            draw_one<kRandint, int16_t>(a, key, i); break;
        case kRandint * 8 + 4: ((int32_t*)out)[t] =
            draw_one<kRandint, int32_t>(a, key, i); break;
        case kRandint * 8 + 5: ((long long*)out)[t] =
            draw_one<kRandint, long long>(a, key, i); break;
      }
    }
}

void host_keys(const long long* keys, long long key_stride, const void* data,
               int data_kind, long long scalar, long long rows, long long n,
               long long* out) {
  for (long long t = 0; t < rows * n; ++t) {
    const long long r = t / n, i = t - r * n;
    const long long* key = keys + r * key_stride;
    uint32_t x0, x1;
    if (data_kind == 0) {
      x0 = (uint32_t)((uint64_t)i >> 32); x1 = (uint32_t)i;
    } else {
      const long long d = data_kind == 1 ? ((const int32_t*)data)[t]
          : data_kind == 2 ? ((const long long*)data)[t] : scalar;
      x0 = 0; x1 = (uint32_t)d;
    }
    threefry((uint32_t)key[0], (uint32_t)key[1], x0, x1);
    out[2 * t] = x0; out[2 * t + 1] = x1;
  }
}

void host_categorical(const long long* keys, const float* logits,
                      long long rows, long long v, float lo, float scale,
                      long long* out) {
  for (long long r = 0; r < rows; ++r) {
    float best = -INFINITY; long long idx = LLONG_MAX;
    for (long long i = 0; i < v; ++i) {
      const float val = __fadd_rn(gumbel_at((uint32_t)keys[2 * r],
          (uint32_t)keys[2 * r + 1], i, lo, scale), logits[r * v + i]);
      if (better(val, i, best, idx)) { best = val; idx = i; }
    }
    out[r] = idx;
  }
}
}
"""


def _device_functions(src: str) -> str:
    """The source's device functions: everything in its anonymous
    namespace before the draw kernel, and the argmax order."""
    start = src.index("namespace {") + len("namespace {")
    body = src[start:src.index("// grid (element blocks, rows)")]
    order = src[src.index("// torch.argmax's order"):
                src.index("constexpr int kCatThreads")]
    return "namespace {" + body + order + "}  // namespace\n"


def build(out_dir: Path) -> ctypes.CDLL:
    """Compile the host copy into ``out_dir``; raises RuntimeError when no
    C++ compiler is found or the build fails."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")
    cpp = out_dir / "threefry_host.cpp"
    lib = out_dir / "threefry_host.so"
    cpp.write_text(_SHIM + _device_functions(SOURCE.read_text()) + _LOOPS)
    proc = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(lib), str(cpp)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"host build failed:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def patch(monkeypatch, lib: ctypes.CDLL) -> None:
    """Route ``ops.threefry``'s launches to the host copy, and let CPU
    keys take the kernel route."""
    from tpumon_torch.ops import threefry

    def call(symbol, argtypes, args, dev):
        fn = getattr(lib, symbol.replace("tpumon_threefry_", "host_"))
        fn.argtypes, fn.restype = argtypes, None
        fn(*args)

    check = threefry._on_cuda

    def on_kernel_route(k):
        check(k)  # the wrapper's own key checks
        return True

    monkeypatch.setattr(threefry, "_call", call)
    monkeypatch.setattr(threefry, "_on_cuda", on_kernel_route)
