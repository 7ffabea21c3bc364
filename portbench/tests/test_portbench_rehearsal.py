"""A tiny rehearsal of both drivers on the CPU, through the program's
plain versions, and the faults the check has to catch: each run is the
harness's own ``execute`` with the look for a chip skipped, the timed
path broken underneath where a test plants a fault."""

import pytest
import torch

from portbench import families, run
from portbench.drivers import serve_closed_loop, train_steps
from portbench.models import make_params, sizes


def _run(tiny, cell, seconds=1.0, traced=False):
    bench, root, pkg = tiny
    return run.execute(bench, cell, 20251018, seconds, traced, "cpu",
                       root=root, pkg=pkg, log=lambda m: None)


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.train"])
def test_rehearsal_is_correct_and_reports_no_device_metric(tiny, cell):
    res = _run(tiny, cell, traced=True)
    rec = res["record"]
    assert res["correct"], res["check"]
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert "breakdown" not in res and "busy_s" not in res["device"]
    assert rec["tokens"] > 0 and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-2:] == ["check", "record"]


def test_serving_record_counts_the_slice_work(tiny):
    rec = _run(tiny, "tiny.serve", traced=True)["record"]
    work = rec["slice_work"]
    assert work["prefill_seen"] and work["steps"]
    assert all(0 <= start and 0 < n <= 32 for start, n in work["chunks"])
    assert rec["ttft_ms"] and rec["tpot_ms"] and rec["steps_ms"]
    assert "serve.step" in rec["slice"]["spans"]


def _fault(monkeypatch, module, name, make):
    monkeypatch.setattr(module, name, make(getattr(module, name)))


def test_served_token_altered_is_caught(tiny, monkeypatch):
    from tpumon_torch.loadgen import serving

    calls = [0]

    def make(fn):
        def altered(*a, **k):
            out = fn(*a, **k)
            calls[0] += 1
            return (out + 1) % 256 if calls[0] % 3 == 0 else out
        return altered

    _fault(monkeypatch, serving, "sample_tokens", make)
    res = _run(tiny, "tiny.serve")
    assert not res["correct"], res["check"]


def test_decode_state_left_unchanged_is_caught(tiny, monkeypatch):
    from tpumon_torch.loadgen import serving

    def make(fn):
        def unchanged(cfg, params, pool, *a, **k):
            saved = {name: t.clone() for name, t in pool.items()}
            out = fn(cfg, params, pool, *a, **k)
            for name, t in pool.items():
                t.copy_(saved[name])
            return out
        return unchanged

    _fault(monkeypatch, serving, "paged_decode_step", make)
    res = _run(tiny, "tiny.serve")
    assert not res["correct"], res["check"]


def test_train_state_left_unchanged_is_caught(tiny, monkeypatch):
    from tpumon_torch.loadgen import model

    def make(fn):
        def unchanged(cfg, params, tokens, lr=1e-3):
            return params, model.value_and_grad(cfg, params, tokens)[0]
        return unchanged

    _fault(monkeypatch, model, "sgd_train_step", make)
    res = _run(tiny, "tiny.train")
    assert not res["correct"], res["check"]
    assert res["check"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_is_caught(tiny, monkeypatch):
    from tpumon_torch.loadgen import model

    def make(fn):
        def half(cfg, params, tokens, lr=1e-3):
            return fn(cfg, params, tokens[: tokens.shape[0] // 2], lr=lr)
        return half

    _fault(monkeypatch, model, "sgd_train_step", make)
    res = _run(tiny, "tiny.train")
    assert not res["correct"], res["check"]


def test_control_reads_worse_than_the_program_serving(tiny):
    bench, root, pkg = tiny
    from portbench.control import readings

    got = readings(bench, "tiny.serve", 5, 1.0, "cpu", root=root, pkg=pkg)
    assert got["control"]["logit_gap"] >= 3 * got["program"]["logit_gap"]


def test_control_reads_worse_than_the_program_training(tiny):
    bench, root, pkg = tiny
    from portbench.control import readings

    got = readings(bench, "tiny.train", 5, 0.2, "cpu", root=root, pkg=pkg)
    worst = lambda d: max(d["loss_gap"], d["grad_gap"], d["change_gap"])
    assert worst(got["control"]) >= 3 * worst(got["program"])
    assert worst(got["half_batch"]) >= 3 * worst(got["program"])


def test_reference_agrees_with_itself_and_sees_one_token(tiny):
    """The reference's logits at a served position do not depend on the
    tokens after it, and change when a token before it changes."""
    bench, root, _ = tiny
    cfg = run.load_json(root / "serve.json")
    s = sizes(cfg)
    params = make_params(s, 3, "cpu", torch.bfloat16)
    rc = families.of(cfg).ref_cfg(s, cfg)
    from portbench.reference import llama

    toks = torch.arange(1, 41)[None]
    full = llama.hidden(params, toks, rc, q_block=16)
    head = llama.hidden(params, toks[:, :30], rc, q_block=16)
    assert torch.allclose(full[:, :30], head, atol=1e-5)
    toks2 = toks.clone()
    toks2[0, 5] += 1
    moved = llama.hidden(params, toks2, rc, q_block=16)
    assert not torch.allclose(moved[:, 6:], full[:, 6:], atol=1e-3)
    assert serve_closed_loop.Bench.kind == "serve"
    assert train_steps.Bench.kind == "train"
