"""On the card: each cell runs through the command and comes out
correct, and its control comes out not correct. Skips without a GPU
(decided inside each test)."""

import json
import subprocess
import sys

import pytest

from portbench import run

CELLS = [w["name"] for w in run.load_json(run.ROOT / "BENCHMARK.json")[
    "workloads"]]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (none visible)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    _need_card()
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "4242424242", "--seconds", "10", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    _need_card()
    from portbench.control import readings

    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    limits = run.load_json(run.PKG / "limits" / f"{cell}.json")
    got = readings(bench, cell, 777, 10.0, "cuda")
    ok, _ = run.judge(got["control"], limits)
    assert not ok, got
