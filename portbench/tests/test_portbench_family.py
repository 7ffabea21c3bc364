"""A model family is new files. In a copy of the package, a stand-in
family that draws its weights its own way, with a tiny serving cell and
a tiny training cell that name it, runs correct through ``run.execute``,
and a served token altered through it is caught; no file the copy
already had changes. The Llama family names the harness's own
functions."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import compare, counts, families, models, program, run
from portbench.reference import llama
from portbench.tests.conftest import TINY_WIDTHS

STANDIN = '''"""A stand-in family: the Llama model with its weights drawn its own
way, uniform from one generator a run, where the Llama family draws a
normal block a kind."""

import torch

from portbench import models
from portbench.families.llama import (  # noqa: F401
    flops_per_token, model_config, ref_cfg, reference, serve_flops, sizes)

DRAWN = []  # the seed of every draw, so a test sees both sides draw here


def make_params(s, seed, device, dtype):
    DRAWN.append(seed)
    gen = torch.Generator(device=device).manual_seed(
        (seed ^ 0x5DEECE66D) % (1 << 63))

    def uniform(shape, scale):
        u = torch.rand(shape, generator=gen, device=device)
        return u.mul_(2).sub_(1).mul_(scale * 3 ** 0.5).to(dtype)

    def ones():
        return torch.ones((s.d_model,), device=device, dtype=dtype)

    embed = uniform((s.vocab, s.d_model), 0.02)
    layers = []
    for _ in range(s.n_layers):
        layer = {"attn_norm": ones(), "mlp_norm": ones()}
        for kind, rows, cols in models.LAYER_KINDS:
            layer[kind] = uniform((rows(s), cols(s)), rows(s) ** -0.5)
        layers.append(layer)
    return {"embed": embed, "layers": layers, "final_norm": ones(),
            "lm_head": uniform((s.d_model, s.vocab), s.d_model ** -0.5)}


def initial_leaves(s, seed, device, dtype):
    yield from reference.leaves(make_params(s, seed, device, dtype))
'''

PROBE = r"""
import json, sys
sys.path.insert(0, {copy!r})
sys.path.append({repo!r})
import torch
torch.set_num_threads(1)
from portbench import run
assert str(run.PKG) == {pkg!r}, run.PKG
from tpumon_torch.loadgen import serving

bench = run.load_json(run.ROOT / "BENCHMARK.json")
out = {{}}
for cell in ("standin.serve", "standin.train"):
    res = run.execute(bench, cell, 2**31 + 77, 1.0, False, "cpu",
                      log=lambda m: None)
    out[cell] = {{"correct": res["correct"], "check": res["check"],
                 "family": res["record"]["family"]}}
from portbench.families import standin
out["drawn"] = len(standin.DRAWN)
sample, calls = serving.sample_tokens, [0]

def altered(*a, **k):
    got = sample(*a, **k)
    calls[0] += 1
    return (got + 1) % 256 if calls[0] % 3 == 0 else got

serving.sample_tokens = altered
res = run.execute(bench, "standin.serve", 2**31 + 78, 1.0, False, "cpu",
                  log=lambda m: None)
out["altered"] = {{"correct": res["correct"], "check": res["check"]}}
print(json.dumps(out))
"""


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts and ".cache" not in p.parts}


def _new_files(copy: Path) -> dict:
    """The stand-in family, its two tiny configurations, two tiny mixes,
    the real cells' limits under the tiny cells' names, and the entries
    added to BENCHMARK.json: all of them new files or new entries."""
    pkg = copy / "portbench"
    serve = run.load_json(run.PKG / "configs" / "mistral-7b-v0.3.json")
    serve.update(TINY_WIDTHS, num_key_value_heads=2, family="standin",
                 source="https://example.org/standin")
    serve["serving"]["model"]["max_seq"] = 256
    serve["serving"]["engine"]["prefill_len"] = 32
    train = run.load_json(run.PKG / "configs" / "deepseek-llm-7b-base.json")
    train.update(TINY_WIDTHS, num_key_value_heads=4, torch_dtype="float32",
                 family="standin", source="https://example.org/standin")
    new = {
        "families/standin.py": STANDIN,
        "configs/standin-serve.json": json.dumps(serve),
        "configs/standin-train.json": json.dumps(train),
        "traffic/standin_chat.json": json.dumps({
            "driver": "serve_closed_loop", "clients": 4,
            "prompt": {"dist": "log_uniform", "min": 20, "max": 90},
            "output": {"dist": "uniform", "min": 4, "max": 12},
            "engine": {"slots": 4}, "check_requests": 4}),
        "traffic/standin_steps.json": json.dumps({
            "driver": "train_steps", "batch": 2, "seq": 32}),
        "limits/standin.serve.json": (
            run.PKG / "limits" / "mistral7b.serve.chat.json").read_text(),
        "limits/standin.train.json": (
            run.PKG / "limits" / "deepseek7b.train.seq4k.json").read_text(),
    }
    for rel, text in new.items():
        (pkg / rel).write_text(text)
    bench = run.load_json(copy / "BENCHMARK.json")
    for name, what in (("serve", "serving"), ("train", "training")):
        bench["configs"].append({
            "name": f"standin-{name}", "source": "https://example.org/standin",
            "file": f"portbench/configs/standin-{name}.json",
            "reduced": list(run.load_json(
                pkg / "configs" / f"standin-{name}.json")["published"]),
            "why": f"a stand-in family's tiny {what} configuration"})
    bench["workloads"] += [
        {"name": "standin.serve", "config": "standin-serve",
         "traffic": "standin_chat", "chips": 1, "why": "tiny serving"},
        {"name": "standin.train", "config": "standin-train",
         "traffic": "standin_steps", "chips": 1, "why": "tiny training"}]
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    return {"portbench/" + rel for rel in new}


def test_a_new_family_is_new_files(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(run.PKG, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(run.ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    had = _files(copy)
    real = _files(run.PKG)
    added = _new_files(copy)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(
            copy=str(copy), repo=str(run.ROOT),
            pkg=str(copy / "portbench"))],
        capture_output=True, text=True, timeout=600, cwd=copy, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for cell in ("standin.serve", "standin.train"):
        assert got[cell]["correct"], got[cell]["check"]
        assert got[cell]["family"] == "standin"
    # Both sides drew through the family: the program's set-up and the
    # reference in each cell.
    assert got["drawn"] >= 4
    assert not got["altered"]["correct"], got["altered"]["check"]
    # Only new files: the copy's files and entries as they were, and the
    # package itself untouched.
    now = _files(copy)
    assert set(now) - set(had) == added
    assert all(now[rel] == data for rel, data in had.items()
               if rel != "BENCHMARK.json")
    old, new = (json.loads(had["BENCHMARK.json"]),
                json.loads(now["BENCHMARK.json"]))
    for key, entries in old.items():
        if isinstance(entries, list) and key != "paths":
            assert new[key][:len(entries)] == entries, key
        else:
            assert new[key] == entries, key
    assert _files(run.PKG) == real


def test_the_llama_family_names_the_harness_functions():
    fam = families.of({})
    assert families.name({}) == "llama"
    assert families.of({"family": "llama"}) is fam
    assert fam.sizes is models.sizes
    assert fam.model_config is program.model_config
    assert fam.make_params is models.make_params
    assert fam.initial_leaves is models.initial_leaves
    assert fam.reference is llama
    assert fam.ref_cfg.__module__ == fam.__name__
    assert not hasattr(compare, "ref_cfg")  # the comparison is the family's
    assert fam.serve_flops is counts.serve_flops
    assert fam.flops_per_token is counts.flops_per_token


@pytest.mark.parametrize("name", ["no.such", "../llama", "", 7])
def test_a_family_name_is_a_module_name(name):
    with pytest.raises(ValueError):
        families.of({"family": name})


def test_every_configuration_names_a_family_there_is():
    for entry in run.load_json(run.ROOT / "BENCHMARK.json")["configs"]:
        cfg = run.load_json(run.ROOT / entry["file"])
        fam = families.of(cfg)
        for name in ("sizes", "model_config", "make_params",
                     "initial_leaves", "reference", "ref_cfg",
                     "serve_flops", "flops_per_token"):
            assert hasattr(fam, name), (entry["name"], name)
