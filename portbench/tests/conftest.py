"""Fixtures of the benchmark's tests: a tiny copy of a cell of each kind
in a temporary folder, run on the CPU through the plain versions."""

import json
import shutil

import pytest
import torch

from portbench import run, trace


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips with a reason where there is none")


TINY_WIDTHS = dict(hidden_size=64, intermediate_size=128,
                   num_attention_heads=4, num_hidden_layers=2,
                   vocab_size=256)


def make_tiny(tmp_path, serve_cell="mistral7b.serve.chat",
              train_cell="deepseek7b.train.seq4k"):
    """(bench, root, pkg): tiny configurations of both models, a tiny
    serving and training mix, the real metric readers, and the real
    cells' limits under the tiny cells' names."""
    root, pkg = tmp_path, tmp_path / "pkg"
    (pkg / "traffic").mkdir(parents=True)
    (pkg / "limits").mkdir()
    shutil.copytree(run.PKG / "metrics", pkg / "metrics")
    serve = run.load_json(run.PKG / "configs" / "mistral-7b-v0.3.json")
    serve.update(TINY_WIDTHS, num_key_value_heads=2)
    serve["serving"]["model"]["max_seq"] = 256
    serve["serving"]["engine"]["prefill_len"] = 32
    train = run.load_json(run.PKG / "configs" / "deepseek-llm-7b-base.json")
    # float32 products at this width: bf16 rounding at width 64 reads
    # near the full-width cells' limits, which the faults must clear.
    train.update(TINY_WIDTHS, num_key_value_heads=4, torch_dtype="float32")
    (root / "serve.json").write_text(json.dumps(serve))
    (root / "train.json").write_text(json.dumps(train))
    (pkg / "traffic" / "chat.json").write_text(json.dumps({
        "driver": "serve_closed_loop", "clients": 4,
        "prompt": {"dist": "log_uniform", "min": 20, "max": 90},
        "output": {"dist": "uniform", "min": 4, "max": 12},
        "engine": {"slots": 4}, "check_requests": 4}))
    (pkg / "traffic" / "steps.json").write_text(json.dumps({
        "driver": "train_steps", "batch": 2, "seq": 32}))
    for tiny, real in (("tiny.serve", serve_cell), ("tiny.train", train_cell)):
        src = run.PKG / "limits" / f"{real}.json"
        if src.exists():
            shutil.copy(src, pkg / "limits" / f"{tiny}.json")
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    bench["configs"] = [{"name": "s", "file": "serve.json"},
                        {"name": "t", "file": "train.json"}]
    bench["workloads"] = [
        {"name": "tiny.serve", "config": "s", "traffic": "chat", "chips": 1},
        {"name": "tiny.train", "config": "t", "traffic": "steps",
         "chips": 1}]
    return bench, root, pkg


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "SLICE_S", 0.3)
    # One thread for the tiny products: on shared cores a pool of threads
    # slows a tiny step enough that a short window completes no request.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield make_tiny(tmp_path)
    finally:
        torch.set_num_threads(threads)
