"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/tpumon_torch/<name>-<hash>.so`` at the repository
root, loaded with ``ctypes``, beside ptxas's resource report
(``<name>-<hash>.log``). The hash covers every source and header in
``csrc/`` and the compiler flags, so a rebuild happens only when one of
them changed. Nothing is built at import time: ``load`` builds on first
use, and ``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpumon_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build only on a machine with the "
            "CUDA toolkit")
    return found


def sources() -> list[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for ``name`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
            f"{stderr}{stdout}")
    # ptxas's report (registers, shared memory, spills per kernel).
    out.with_suffix(".log").write_text(stderr + stdout)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all() -> list[str]:
    """Build every kernel whose library is missing, one nvcc per source,
    all started together. Returns the names that were compiled."""
    with _lock:
        started = {n: s for n in sources() if (s := _start(n)) is not None}
        try:
            for name, s in started.items():
                _finish(name, s)
        finally:
            for proc, tmp, _ in started.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
    return sorted(started)


def ptxas_report(name: str) -> list[str]:
    """ptxas's resource lines for ``csrc/<name>.cu`` from its last build
    (``-Xptxas -v``): one "Used N registers" line per kernel instance,
    each after the line naming the kernel and its spill stores/loads."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    keep = ("Compiling entry function", "spill stores", "Used ")
    return [ln.strip() for ln in log.read_text().splitlines()
            if any(k in ln for k in keep)]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(library_path(name)))
            lib.tpumon_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tpumon_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaGetLastError()``."""
    if err:
        msg = lib.tpumon_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
