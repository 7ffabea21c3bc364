"""The port stands alone: no file of ``tpumon_torch/`` (nor chip_smoke.py)
imports ``jax`` or the ``tpumon`` package, and importing the serving and
training entry points loads neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "tpumon_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "tpumon")


def imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_tpumon(path):
    bad = [m for m in imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import jax.numpy as jnp\n"
                   "from tpumon.loadgen import serving\n"
                   "import tpumon_torch.ops\n"
                   "def f():\n    from jax import lax\n")
    bad = [m for m in imported_modules(src) if _forbidden(m)]
    assert bad == ["jax.numpy", "tpumon.loadgen", "jax"]


def test_importing_the_port_loads_neither_jax_nor_tpumon():
    code = (
        "import sys\n"
        "import tpumon_torch.loadgen.serving\n"
        "import tpumon_torch.loadgen.train\n"
        "import tpumon_torch.ops.paged_attention\n"
        "import tpumon_torch.ops.flash_attention\n"
        "import tpumon_torch.loadgen.burn\n"
        "import tpumon_torch.validate\n"
        "import tpumon_torch.sampler\n"
        "import tpumon_torch.cli\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'tpumon'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
