"""The port's ServingEngine against the JAX reference engine.

On bridged f32 weights, token streams must be IDENTICAL to the
reference's (prompts of 1-4 chunks): greedy over the paged engine with
both of the port's decode read paths, and greedy and sampled requests
mixed over every layout (dense, paged gather, paged kernel) x
decode_block {1, 4} x both schedulers; the /metrics text must render the
same families and labels, so the unchanged monitor distills it the same;
``ServeConfig()`` and the CLI's defaults are the reference's.
"""

import argparse
import asyncio
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_parity import bridged_params  # noqa: E402
from tpumon.collectors.serving import (  # noqa: E402
    ServingCollector,
    distill_serving_metrics,
)
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch.loadgen import serving  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig, params_from_jax  # noqa: E402
from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine  # noqa: E402
from tpumon_torch.ops.paged_attention import paged_attention  # noqa: E402

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=64, compute_dtype="float32")
PS = 8
_rng = np.random.default_rng(11)
# 1, 2, 3 and 4 prefill chunks of 8, plus a one-token prompt.
PROMPTS = [[int(t) for t in _rng.integers(0, 128, n)]
           for n in (5, 12, 27, 8, 17, 1, 30)]
MAX_NEW = [6, 9, 4, 10, 7, 5, 8]


@pytest.fixture(scope="module")
def weights():
    return bridged_params(JaxModelConfig(**SMALL), seed=5)


def port_engine(tree, **kw):
    """The port's paged engine (kernel read path unless ``kw`` says
    otherwise) on the bridged weights."""
    kw = {"kv_layout": "paged", "paged_attn": "kernel", **kw}
    cfg = ServeConfig(model=ModelConfig(**SMALL), slots=2, prefill_len=PS,
                      **kw)
    return ServingEngine(cfg=cfg, params=params_from_jax(tree), device="cpu")


def jax_engine(jparams, **kw):
    cfg = jax_serving.ServeConfig(model=JaxModelConfig(**SMALL), slots=2,
                                  prefill_len=PS, kv_layout="paged", **kw)
    return jax_serving.ServingEngine(cfg=cfg, params=jparams)


def run(engine, prompts=PROMPTS, tenant=""):
    reqs = [engine.submit(p, max_new=n, tenant=tenant)
            for p, n in zip(prompts, MAX_NEW)]
    engine.drain()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("scheduler", ["interleaved", "sequential"])
def test_greedy_streams_identical_to_reference(weights, scheduler):
    jparams, tree = weights
    ref = jax_engine(jparams, scheduler=scheduler)
    want = run(ref)
    assert [len(o) for o in want] == [n + 1 for n in MAX_NEW]
    for paged_attn in ("gather", "kernel"):
        eng = port_engine(tree, scheduler=scheduler, paged_attn=paged_attn)
        assert run(eng) == want, paged_attn
        # Same schedule, step for step.
        assert eng.decode_steps_total == ref.decode_steps_total
        assert eng.tokens_total == ref.tokens_total
        assert eng.allocator.free_pages == ref.allocator.free_pages


def test_kernel_path_on_cpu_runs_plain_version_and_counts_nothing(weights):
    _, tree = weights
    before = paged_attention.launches
    run(port_engine(tree, paged_attn="kernel"), prompts=PROMPTS[:2])
    assert paged_attention.launches == before


def _snapshot():
    now = time.monotonic()
    return {
        "tokens": 123, "requests": 9, "completed": 7, "steps": 55,
        "queue": 2, "rejected": 1, "cancelled": 1, "shed": 0,
        "requeued": 0, "ttft_counts": [0, 1, 2, 0, 3, 0, 0, 1, 0, 0, 0],
        "ttft_inf": 1, "ttft_sum": 4.25, "free": 1, "in_prefill": 1,
        "ttft_recent": [0.01, 0.2, 0.031, 0.5],
        "tpot_recent": [0.002, 0.0031],
        "spec_rounds": 0, "spec_proposed": 0, "spec_accepted": 0,
        "tenant_window_s": 60.0,
        "tenants": {
            "chat": {"submitted": 5, "completed": 4, "rejected": 1,
                     "cancelled": 0, "shed": 0, "tokens": 40,
                     "ttft": [(now, 0.01), (now - 120.0, 9.0)],
                     "tpot": [(now, 0.002)]},
            "batch": {"submitted": 4, "completed": 3, "rejected": 0,
                      "cancelled": 1, "shed": 0, "tokens": 83,
                      "ttft": [], "tpot": []},
        },
        "weight_bytes": 1 << 20, "kv_pages_total": 24, "kv_pages_free": 11,
        "prefix": None,
    }


def test_render_is_identical_for_one_snapshot():
    snap = _snapshot()
    assert serving._render_serving_metrics(snap) == (
        jax_serving._render_serving_metrics(snap))


def test_live_metrics_distill_to_the_same_keys(weights):
    jparams, tree = weights
    ref, eng = jax_engine(jparams), port_engine(tree)
    run(ref, prompts=PROMPTS[:3], tenant="chat")
    run(eng, prompts=PROMPTS[:3], tenant="chat")
    want = distill_serving_metrics(ref.metrics_text(), now=1.0)
    got = distill_serving_metrics(eng.metrics_text(), now=1.0)
    assert set(got) == set(want)
    for key in ("tokens_total", "requests_total"):
        assert got[key] == want[key]
    text = eng.metrics_text()
    assert 'tpumon_serving_tenant_tokens{tenant="chat"}' in text
    assert "tpumon_serving_kv_pages_free" in text


def test_weight_bytes_reports_the_resident_dtype(weights):
    _, tree = weights
    eng = port_engine(tree)
    n = sum(p.numel() for p in jax_leaves(eng.params))
    assert eng._stats_snapshot()["weight_bytes"] == 4 * n


def jax_leaves(params):
    if isinstance(params, dict):
        return [x for v in params.values() for x in jax_leaves(v)]
    if isinstance(params, list):
        return [x for v in params for x in jax_leaves(v)]
    return [params]


def test_engine_without_device_raises_when_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the engine would rightly serve on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg=ServeConfig(model=ModelConfig(**SMALL), slots=2,
                                      prefill_len=PS, kv_layout="paged",
                                      paged_attn="kernel"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg=ServeConfig(model=ModelConfig(**SMALL), slots=2,
                                      prefill_len=PS))
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.main(["--duration", "0.01", "--port", "0"])


# Every field is served now (speculation, prefix caching, int8 KV and
# weights, each to completion); the mesh and ring fields do what the
# reference does with the same options: serve its streams, or raise its
# error where the options do not compose. The case order is the earlier
# list's.
SLICE_CASES = [
    {"spec_source": "prompt", "spec_len": 3}, {"mesh_dp": 2},
    {"spec_len": 2}, {"prefix_cache_entries": 4},
    {"kv_dtype": "int8", "paged_attn": "gather"}, {"quantize": "int8"},
    {"mesh_tp": 2}, {"ring_stripes": 2}, {"paged_attn": "ring"},
]


@pytest.mark.parametrize("over", SLICE_CASES)
def test_outside_the_slice_raises_not_yet_ported(weights, over):
    over = {"kv_layout": "paged", "paged_attn": "kernel", **over}
    cfg = ServeConfig(model=ModelConfig(**SMALL), slots=2, prefill_len=PS,
                      **over)
    if set(over) & {"mesh_dp", "mesh_tp", "ring_stripes"} or (
            over["paged_attn"] == "ring"):
        jparams, tree = weights
        try:
            ref = jax_serving.make_serving_engine(
                jax_serving.ServeConfig(model=JaxModelConfig(**SMALL),
                                        slots=2, prefill_len=PS, **over),
                params=jparams)
        except ValueError as e:
            # The reference's text up to its parenthesis (which names its
            # Pallas kernel).
            with pytest.raises(ValueError,
                               match=re.escape(str(e).split(" (")[0])):
                serving.make_serving_engine(
                    cfg, devices=[torch.device("cpu")] * 8, device="cpu")
            return
        eng = serving.make_serving_engine(
            cfg, params=params_from_jax(tree),
            devices=[torch.device("cpu")] * 8, device="cpu")
        assert run(eng, prompts=PROMPTS[:4]) == run(ref, prompts=PROMPTS[:4])
        return
    eng = ServingEngine(cfg=cfg, params=params_from_jax(weights[1]),
                        device="cpu")
    outs = run(eng, prompts=PROMPTS[:4])
    assert [len(o) for o in outs] == [n + 1 for n in MAX_NEW[:4]]
    snap = eng._stats_snapshot()
    if "spec_len" in over:
        assert snap["spec_rounds"] > 0
    if "prefix_cache_entries" in over:
        assert snap["prefix"] is not None


def test_moe_family_and_sampling_raise_not_yet_ported(weights):
    """Both are ported now (the name is the earlier slices'): an MoE
    config builds and its engine serves a sampled request to completion,
    and so does the dense engine."""
    moe = ModelConfig(**dict(SMALL, n_experts=4))
    eng = ServingEngine(cfg=ServeConfig(model=moe, slots=2, prefill_len=PS,
                                        kv_layout="paged",
                                        paged_attn="kernel"),
                        device="cpu")
    assert "moe" in eng.params["layers"][0]
    for eng in (eng, port_engine(weights[1])):
        req = eng.submit([1, 2, 3], max_new=4, temperature=0.7, top_k=5)
        eng.drain()
        assert req.status == "completed" and len(req.output) == 5


# Every flag parses and builds an engine, which serves a moment, or exits
# 2 with the reference's text where the reference's would: the ring read
# and the ring mode on the default dense layout, and a 1 x 2 mesh over the
# one CPU device (``--device cpu``: no other device of its kind). The case
# order is the earlier list's; the last two serve the ring mode.
CLI_CASES = [
    ["--kv-dtype", "int8"], ["--paged-attn", "ring"], ["--spec-len", "2"],
    ["--spec-source", "prompt", "--spec-len", "2"], ["--quant", "int8"],
    ["--mesh", "1,2"], ["--ring-attn", "2"], ["--prefix-cache", "8"],
    ["--experts", "4"], ["--kv-layout", "paged", "--ring-attn", "2"],
    ["--kv-layout", "paged", "--paged-attn", "ring"],
]
CLI_NOT_PORTED = {
    "--paged-attn": "paged_attn='ring' requires kv_layout='paged'",
    "--mesh": "dp*tp must divide the device count",
    "--ring-attn": "--ring-attn requires --kv-layout paged",
}


@pytest.mark.parametrize("flags", CLI_CASES)
def test_cli_flags_outside_the_slice_exit(flags, capsys, monkeypatch,
                                          tmp_path):
    # The workload self-report runs by default: into tmp_path here.
    from tpumon_torch.loadgen import report

    monkeypatch.setattr(report, "DEFAULT_DIR", str(tmp_path))
    if flags[0] in CLI_NOT_PORTED:
        with pytest.raises(SystemExit) as exc:
            serving.main(flags + ["--device", "cpu"])
        assert exc.value.code == 2
        assert CLI_NOT_PORTED[flags[0]] in capsys.readouterr().err
        return
    built = []
    real = serving.start_metrics_server

    def capture(engine, *a, **kw):
        built.append(engine)
        return real(engine, *a, **kw)

    monkeypatch.setattr(serving, "start_metrics_server", capture)
    assert serving.main(flags + ["--device", "cpu", "--port", "0",
                                 "--duration", "0.2", "--rps", "20",
                                 "--max-new", "2"]) == 0
    (eng,) = built
    cfg = eng.cfg
    took = {"--kv-dtype": cfg.kv_dtype == "int8",
            "--spec-len": cfg.spec_len == 2,
            "--spec-source": cfg.spec_source == "prompt",
            "--quant": cfg.quantize == "int8",
            "--prefix-cache": cfg.prefix_cache_entries == 8,
            "--experts": cfg.model.n_experts == 4,
            "--kv-layout": cfg.kv_layout == "paged",
            "--ring-attn": cfg.ring_stripes == 2,
            "--paged-attn": cfg.paged_attn == "ring"}
    assert all(took[f] for f in flags if f.startswith("--"))
    assert eng.requests_total >= 1


def test_backpressure_cancel_and_metrics_endpoint(weights):
    """Pool pressure blocks admission instead of failing; a cancelled
    request frees its pages; /metrics serves the scrapeable families."""
    _, tree = weights
    eng = port_engine(tree, pool_pages=6)  # 5 usable pages
    big = eng.submit(PROMPTS[6], max_new=8)  # 38 rows -> 5 pages
    small = eng.submit(PROMPTS[0], max_new=2)  # must wait for pages
    gone = eng.submit(PROMPTS[1], max_new=2)
    gone.cancel()
    eng.step()
    assert small.status == "" and eng.allocator.free_pages == 0
    eng.drain()
    assert big.status == small.status == "completed"
    assert gone.status == "cancelled" and eng.cancelled_total == 1
    assert eng.allocator.free_pages == 5
    server, port = serving.start_metrics_server(eng, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            text = resp.read().decode()
    finally:
        server.shutdown()
        server.server_close()
    for fam in ("jetstream_generate_tokens", "tpumon_serving_ttft_p50_ms",
                "tpumon_serving_decode_steps",
                "jetstream_time_to_first_token_bucket"):
        assert fam in text


def test_generate_endpoint_streams_greedy_tokens(weights):
    _, tree = weights
    eng = port_engine(tree)
    stop = threading.Event()
    loop = threading.Thread(
        target=lambda: serving.ArrivalPump(eng, []).run(stop), daemon=True)
    loop.start()
    server, port = serving.start_metrics_server(eng, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/generate?prompt=1,2,3&max_new=4",
                timeout=30) as resp:
            body = json.loads(resp.read())
    finally:
        stop.set()
        loop.join(timeout=10)
        server.shutdown()
        server.server_close()
    assert not loop.is_alive()
    assert len(body["tokens"]) == 5
    ref = port_engine(tree)
    r = ref.submit([1, 2, 3], max_new=4)
    ref.drain()
    assert body["tokens"] == r.output


def test_unchanged_monitor_scrapes_the_port_cli_over_http():
    """The port's CLI runs as its own process (on the CPU here, as the
    tests ask); the reference's unchanged ServingCollector scrapes its
    /metrics over HTTP, as it scrapes the JAX loadgen, and sees tokens."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpumon_torch.loadgen.serving", "--device",
         "cpu", "--port", "0", "--rps", "20", "--max-new", "4",
         "--duration", "60", "--no-report"],
        cwd=root, env=dict(os.environ, PYTHONPATH=str(root),
                           OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner = proc.stdout.readline()
        assert "/metrics on :" in banner, proc.stderr.read()
        port = int(banner.split("/metrics on :")[1].split()[0])
        coll = ServingCollector(targets=(f"127.0.0.1:{port}",))
        deadline = time.monotonic() + 60
        while True:
            row = asyncio.run(coll.collect()).data[0]
            assert row["ok"], row
            if row["tokens_total"] > 0 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert row["tokens_total"] > 0
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
    assert proc.returncode is not None


# ---------------------------------------------------------------------------
# The dense layout, fused block decode and keyed sampling: engine parity
# over layouts x decode_block x schedulers, greedy and sampled requests
# mixed, on bridged weights and one sampling seed.
# ---------------------------------------------------------------------------

LAYOUTS = {"dense": {"kv_layout": "dense"},
           "paged-gather": {"kv_layout": "paged", "paged_attn": "gather"},
           "paged-kernel": {"kv_layout": "paged", "paged_attn": "kernel"}}
# (temperature, top_k) per prompt: greedy, sampled over the whole vocab,
# sampled over the top 5.
SAMPLING = [(0.0, 0), (0.8, 0), (0.8, 5), (0.0, 0), (0.8, 5), (0.8, 0),
            (0.0, 0)]
SEED = 3


def run_mixed(engine):
    reqs = [engine.submit(p, max_new=n, temperature=t, top_k=k)
            for p, n, (t, k) in zip(PROMPTS, MAX_NEW, SAMPLING)]
    engine.drain()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def reference_streams(weights):
    """The reference engine's streams per (layout, decode_block,
    scheduler), computed once."""
    cache = {}

    def get(layout, block, scheduler):
        k = (layout, block, scheduler)
        if k not in cache:
            cfg = jax_serving.ServeConfig(
                model=JaxModelConfig(**SMALL), slots=2, prefill_len=PS,
                decode_block=block, scheduler=scheduler, **LAYOUTS[layout])
            eng = jax_serving.ServingEngine(cfg=cfg, params=weights[0],
                                            seed=SEED)
            cache[k] = (run_mixed(eng), eng.decode_steps_total,
                        eng.tokens_total)
        return cache[k]
    return get


@pytest.mark.parametrize("scheduler", ["interleaved", "sequential"])
@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_streams_identical_to_reference_greedy_and_sampled(
        weights, reference_streams, layout, block, scheduler):
    want, steps, tokens = reference_streams(layout, block, scheduler)
    cfg = ServeConfig(model=ModelConfig(**SMALL), slots=2, prefill_len=PS,
                      decode_block=block, scheduler=scheduler,
                      **LAYOUTS[layout])
    eng = ServingEngine(cfg=cfg, params=params_from_jax(weights[1]),
                        seed=SEED, device="cpu")
    assert run_mixed(eng) == want
    assert eng.decode_steps_total == steps and eng.tokens_total == tokens


def test_streams_do_not_depend_on_layout_block_or_schedule(weights):
    """A request's stream is a pure function of (seed, prompt, params):
    every configuration of the port emits the same streams (the
    reference's invariant, tests/test_scheduler.py)."""
    streams = []
    for layout in LAYOUTS.values():
        for block in (1, 4):
            for scheduler in ("interleaved", "sequential"):
                cfg = ServeConfig(model=ModelConfig(**SMALL), slots=2,
                                  prefill_len=PS, decode_block=block,
                                  scheduler=scheduler, **layout)
                streams.append(run_mixed(ServingEngine(
                    cfg=cfg, params=params_from_jax(weights[1]), seed=SEED,
                    device="cpu")))
    assert all(s == streams[0] for s in streams)
    assert any(t > 0 for t, _ in SAMPLING)


@pytest.mark.parametrize("block", [1, 4])
def test_kernel_route_runs_once_per_layer_and_decode_step(weights, block):
    """With paged_attn="kernel", every decode step, in-block steps
    included, calls the paged-attention wrapper once per layer (counted
    through a wrapper here: on the CPU the kernel's own launch count stays
    0, its plain version runs)."""
    from tpumon_torch.loadgen import paged_kv

    calls = []
    real = paged_kv.paged_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    eng = port_engine(weights[1], decode_block=block)
    orig, paged_kv.paged_attention = paged_kv.paged_attention, counting
    try:
        run_mixed(eng)
    finally:
        paged_kv.paged_attention = orig
    assert eng.decode_steps_total > 0
    assert len(calls) == SMALL["n_layers"] * eng.decode_steps_total


def test_serve_config_defaults_equal_reference():
    got = dataclasses.asdict(ServeConfig())
    want = dataclasses.asdict(jax_serving.ServeConfig())
    assert got == want
    assert got["kv_layout"] == "dense" and got["paged_attn"] == "gather"


def test_default_engine_config_equals_reference():
    """``ServingEngine()`` with no config builds the reference's demo
    engine (dense, gather), not a paged one."""
    got = dataclasses.asdict(serving.default_engine_config())
    assert got == dataclasses.asdict(jax_serving.default_engine_config())
    assert got["kv_layout"] == "dense"


def _parsed_defaults(main) -> dict:
    """The namespace ``main([])`` parses, captured before it builds an
    engine."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen.update(vars(real(self, args, namespace)))
        raise Parsed

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(Parsed):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen


def test_main_parsed_defaults_equal_reference():
    got = _parsed_defaults(serving.main)
    want = _parsed_defaults(jax_serving.main)
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
    assert got["kv_layout"] == "dense" and got["paged_attn"] == "gather"


@pytest.mark.parametrize("flags", [
    ["--pool-pages", "8"], ["--admit-lookahead", "2"],
    ["--paged-attn", "kernel"],
])
def test_cli_paged_only_flags_need_the_paged_layout(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        serving.main(flags + ["--device", "cpu"])
    assert exc.value.code == 2
    assert "--kv-layout paged" in capsys.readouterr().err


def test_dense_engine_rejects_paged_options():
    model = ModelConfig(**SMALL)
    for over in ({"pool_pages": 8}, {"admit_lookahead": 1},
                 {"paged_attn": "kernel"}, {"decode_block": 0},
                 {"kv_layout": "striped"}):
        with pytest.raises(ValueError):
            ServingEngine(cfg=ServeConfig(model=model, slots=2,
                                          prefill_len=PS, **over),
                          device="cpu")


def test_dense_metrics_distill_to_the_same_keys(weights):
    """A dense engine's /metrics (sampled requests and blocks included):
    the reference's families, no KV-pool gauges."""
    jparams, tree = weights
    jcfg = jax_serving.ServeConfig(model=JaxModelConfig(**SMALL), slots=2,
                                   prefill_len=PS, decode_block=4)
    ref = jax_serving.ServingEngine(cfg=jcfg, params=jparams, seed=SEED)
    eng = ServingEngine(cfg=ServeConfig(model=ModelConfig(**SMALL), slots=2,
                                        prefill_len=PS, decode_block=4),
                        params=params_from_jax(tree), seed=SEED,
                        device="cpu")
    for e in (ref, eng):
        for p, n, (t, k) in zip(PROMPTS[:3], MAX_NEW, SAMPLING):
            e.submit(p, max_new=n, temperature=t, top_k=k, tenant="chat")
        e.drain()
    want = distill_serving_metrics(ref.metrics_text(), now=1.0)
    got = distill_serving_metrics(eng.metrics_text(), now=1.0)
    assert set(got) == set(want)
    for key in ("tokens_total", "requests_total"):
        assert got[key] == want[key]
    snap, jsnap = eng._stats_snapshot(), ref._stats_snapshot()
    for key in ("tokens", "requests", "completed", "steps", "free",
                "kv_pages_total", "kv_pages_free", "prefix"):
        assert snap[key] == jsnap[key], key
    assert "tpumon_serving_kv_pages" not in eng.metrics_text()


def test_generate_endpoint_samples_with_temperature(weights):
    """/generate takes temperature and top_k: its tokens are a direct
    submission's (the draw is keyed by request id and index)."""
    _, tree = weights
    eng = port_engine(tree)
    stop = threading.Event()
    loop = threading.Thread(
        target=lambda: serving.ArrivalPump(eng, []).run(stop), daemon=True)
    loop.start()
    server, port = serving.start_metrics_server(eng, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/generate?prompt=1,2,3&max_new=4"
                f"&temperature=0.9&top_k=5", timeout=30) as resp:
            body = json.loads(resp.read())
    finally:
        stop.set()
        loop.join(timeout=10)
        server.shutdown()
        server.server_close()
    assert not loop.is_alive()
    ref = port_engine(tree)
    r = ref.submit([1, 2, 3], max_new=4, temperature=0.9, top_k=5,
                   rid=body["rid"])
    ref.drain()
    assert body["tokens"] == r.output
