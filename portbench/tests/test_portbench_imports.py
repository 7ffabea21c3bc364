"""The import rule: nothing the benchmark loads is JAX or the JAX
package (by whole top-level names), and the reference imports nothing of
the program."""

import ast
import subprocess
import sys

from portbench import run

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
import portbench.run as run, portbench.control
from portbench.tests.conftest import make_tiny
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    bench, root, pkg = make_tiny(Path(tmp))
    for cell in ("tiny.serve", "tiny.train"):
        run.execute(bench, cell, 1, 0.3, True, "cpu", root=root, pkg=pkg,
                    log=lambda m: None)
    for m in bench["end_to_end"] + bench["per_layer"]:
        run.reader(m["name"])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(run.loaded_forbidden())
"""


def test_no_forbidden_module_after_a_run():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(run.ROOT))],
        capture_output=True, text=True, timeout=600, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top, bad = out.stdout.strip().splitlines()[-2:]
    assert bad == "[]"
    names = set(eval(top))
    assert "tpumon_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "tpumon"}


def test_forbidden_names_compare_whole():
    assert run.forbidden(["tpumon_torch", "tpumon_torch.ops", "jaxtyping",
                          "flaxen", "portbench.run"]) == []
    assert run.forbidden(["jax.numpy", "tpumon.app", "flax", "jaxlib.xla",
                          "torch"]) == ["flax", "jax", "jaxlib", "tpumon"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_torch_only():
    for path in (run.PKG / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("torch", "numpy", "__future__", "math"), (path, name)


def test_yardstick_imports_nothing_of_the_program():
    paths = [run.PKG / f"{name}.py" for name in (
        "counts", "stats", "models", "compare", "loadmix", "kernels",
        "trace")] + sorted((run.PKG / "families").glob("*.py"))
    for path in paths:
        for imp in _imports(path):
            assert imp.split(".")[0] not in ("tpumon_torch", "tpumon",
                                             "jax"), (path, imp)


READERS_PROBE = r"""
import sys
sys.path.insert(0, {root!r})
import portbench.metrics.serve_mfu, portbench.metrics.train_mfu
from portbench import families
families.of({{}})
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("portbench", "tpumon_torch")))
"""


def test_mfu_readers_load_no_program_code_nor_the_comparison():
    """The MFU readers reach the FLOP counts through the family, which
    loads neither the comparison nor anything of the program."""
    out = subprocess.run(
        [sys.executable, "-c", READERS_PROBE.format(root=str(run.ROOT))],
        capture_output=True, text=True, timeout=300, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "portbench.families.llama" in loaded
    assert "portbench.compare" not in loaded
    assert not {m for m in loaded if m.split(".")[0] == "tpumon_torch"}
