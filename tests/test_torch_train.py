"""The port's training path against the JAX reference.

On bridged f32 weights and the same tokens (made with numpy), the port's
``forward``, ``loss_fn`` and gradients match the reference's for the
naive, chunked and flash attention schedules, unaligned T included; remat
changes nothing; three SGD steps land on the reference's params; the
copied numbers (``flops_per_token``, the ``tpumon_train_*`` text) are the
reference's, and the unchanged monitor reads the port's trainer.

Tolerances: logits 2e-5 and loss 1e-5, the reference's own bound between
its schedules (tests/test_loadgen.py); gradients rtol 2e-4 / atol 1e-5,
the same test's. Both packages run f32 on the CPU, so what is left is
summation order.
"""

import asyncio
import dataclasses
import time
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (  # noqa: E402
    assert_trees_close,
    bridged_params,
    grads_tree,
)
from tpumon.collectors.serving import (  # noqa: E402
    ServingCollector,
    distill_serving_metrics,
)
from tpumon.loadgen import model as jax_model  # noqa: E402
from tpumon.loadgen import train as jax_train  # noqa: E402
from tpumon_torch.loadgen import model, train  # noqa: E402
from tpumon_torch.ops import flash_attention as fa  # noqa: E402

# tests/test_loadgen.py's CFG, in f32.
SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
             d_ff=128, max_seq=256, compute_dtype="float32")
SCHEDULES = {"naive": 512, "chunked": 32, "flash": 32}  # attn_block_k


@pytest.fixture(scope="module")
def weights():
    return bridged_params(jax_model.ModelConfig(**SMALL), seed=0)


def tokens_np(t, seed, b=2):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab"], (b, t + 1)).astype(np.int32)


def port_cfg(**kw):
    return model.ModelConfig(**dict(SMALL, **kw))


@pytest.mark.parametrize("attention,t", [
    ("naive", 100), ("chunked", 100), ("flash", 100), ("flash", 129)])
def test_schedule_matches_reference(weights, attention, t):
    """Logits, loss and every gradient. T = 100 is unaligned to the
    chunk and to the flash grid's 128 rows; 129 is one past the grid, so
    flash pads to two 128-row blocks."""
    jparams, tree = weights
    kw = dict(attention=attention, attn_block_k=SCHEDULES[attention])
    jcfg = dataclasses.replace(jax_model.ModelConfig(**SMALL), **kw)
    tcfg = port_cfg(**kw)

    @jax.jit
    def jax_run(p, toks):
        logits = jax_model.forward(jcfg, p, toks[:, :-1])
        loss, grads = jax.value_and_grad(
            partial(jax_model.loss_fn, jcfg))(p, toks)
        return logits, loss, grads

    toks = tokens_np(t, seed=t)
    logits, loss, grads = jax_run(jparams, jnp.asarray(toks))
    params = model.params_from_jax(tree)
    got = model.forward(tcfg, params, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               rtol=2e-5, atol=2e-5)
    tloss, tgrads = model.value_and_grad(tcfg, params, torch.from_numpy(toks))
    assert abs(float(tloss) - float(loss)) < 1e-5
    assert_trees_close(grads, grads_tree(params, tgrads), rtol=2e-4, atol=1e-5)


def test_flash_schedule_on_cpu_launches_no_kernel(weights):
    _, tree = weights
    before = (fa.flash_attention_tri_fwd.launches,
              fa.flash_attention_tri_bwd_dq.launches,
              fa.flash_attention_tri_bwd_dkv.launches)
    model.value_and_grad(port_cfg(attention="flash", attn_block_k=32),
                         model.params_from_jax(tree),
                         torch.from_numpy(tokens_np(40, seed=1)))
    assert (fa.flash_attention_tri_fwd.launches,
            fa.flash_attention_tri_bwd_dq.launches,
            fa.flash_attention_tri_bwd_dkv.launches) == before


@pytest.mark.parametrize("attention", ["naive", "flash"])
def test_remat_changes_nothing(weights, attention):
    """remat recomputes each layer in the backward pass: logits, loss and
    gradients equal the plain pass's exactly (same ops, same order)."""
    _, tree = weights
    toks = torch.from_numpy(tokens_np(60, seed=2))
    out = {}
    for remat in (False, True):
        cfg = port_cfg(attention=attention, attn_block_k=32, remat=remat)
        params = model.params_from_jax(tree)
        logits = model.forward(cfg, params, toks[:, :-1])
        loss, grads = model.value_and_grad(cfg, params, toks)
        out[remat] = (logits.detach(), loss, grads)
    assert torch.equal(out[False][0], out[True][0])
    assert float(out[False][1]) == float(out[True][1])
    for a, b in zip(out[False][2], out[True][2]):
        assert torch.equal(a, b)


def test_three_sgd_steps_match_reference(weights):
    """The port updates in place, the reference returns new arrays: after
    three steps on the same tokens the params and losses agree."""
    jparams, tree = weights
    jcfg = jax_model.ModelConfig(**SMALL)
    step = jax.jit(partial(jax_model.sgd_train_step, jcfg, lr=0.05))
    params = model.params_from_jax(tree)
    for i in range(3):
        toks = tokens_np(24, seed=10 + i)
        jparams, jloss = step(jparams, jnp.asarray(toks))
        same, loss = model.sgd_train_step(port_cfg(), params,
                                          torch.from_numpy(toks), lr=0.05)
        assert same is params
        assert abs(float(loss) - float(jloss)) < 1e-5
    assert_trees_close(jparams, params, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cfg", [
    dict(SMALL),
    dict(vocab=4096, d_model=2048, n_layers=6, n_heads=16, n_kv_heads=16,
         d_ff=8192, max_seq=1024),
    dict(vocab=2048, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
         d_ff=1024),
], ids=["small", "production", "cli"])
def test_flops_per_token_is_the_reference_formula(cfg):
    for seq in (64, 1024, 8192):
        assert train.flops_per_token(model.ModelConfig(**cfg), seq) == (
            jax_train.flops_per_token(jax_model.ModelConfig(**cfg), seq))


def _observe(metrics):
    metrics.observe_step(0, 0.25, 512)
    metrics.observe_step(1, 0.125, 512)
    metrics.ckpt_step = 1
    metrics.loss = 4.8512345


def test_metrics_text_is_the_references_byte_for_byte(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    texts = []
    for mod in (jax_train, train):
        empty = mod.TrainMetrics(flops_per_token=1e6, peak_flops=1e12)
        texts.append([empty.metrics_text()])
        _observe(empty)
        texts[-1].append(empty.metrics_text())
    assert texts[0] == texts[1]
    assert "tpumon_train_mfu_pct" in texts[1][1]


def test_unchanged_monitor_reads_the_trainers_metrics():
    """The reference's ServingCollector scrapes the port's trainer
    /metrics over HTTP and distills the tpumon_train_* families exactly
    as it distills the reference trainer's text."""
    metrics = train.TrainMetrics(flops_per_token=1e6, peak_flops=1e12)
    _observe(metrics)
    ref = jax_train.TrainMetrics(flops_per_token=1e6, peak_flops=1e12)
    _observe(ref)
    ref.started = metrics.started
    httpd, url = train.start_metrics_server(metrics, port=0)
    try:
        row = asyncio.run(ServingCollector(targets=(url,)).collect()).data[0]
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert row["ok"], row
    assert row["train_step"] == 1 and row["train_ckpt_step"] == 1
    assert row["train_tokens_total"] == 1024
    assert row["train_loss"] == pytest.approx(4.851235)
    for key in ("train_goodput_pct", "train_mfu_pct", "train_step_time_ms"):
        assert key in row
    want = distill_serving_metrics(ref.metrics_text(), now=1.0)
    got = distill_serving_metrics(metrics.metrics_text(), now=1.0)
    assert set(got) == set(want)
    for key in ("train_step", "train_loss", "train_tokens_total",
                "train_step_time_ms", "train_mfu_pct"):
        assert got[key] == want[key]


def test_synthetic_batch_is_deterministic_per_seed_and_step():
    """The port draws the reference's tokens (tpumon_torch.prng, a copy of
    jax.random's threefry): equal to jax.random's batch for the same
    (seed, step), and so deterministic per (seed, step), which resume
    needs."""
    cfg = train.TrainConfig(model=port_cfg(), batch=3, seq=16, seed=4)
    a = train.synthetic_batch(cfg, 5)
    assert a.dtype == torch.int32 and a.shape == (3, 16)
    assert int(a.min()) >= 0 and int(a.max()) < SMALL["vocab"]
    assert torch.equal(a, train.synthetic_batch(cfg, 5))
    assert not torch.equal(a, train.synthetic_batch(cfg, 6))
    assert not torch.equal(
        a, train.synthetic_batch(dataclasses.replace(cfg, seed=5), 5))
    ref = jax_train.synthetic_batch(jax_train.TrainConfig(
        model=jax_model.ModelConfig(**SMALL), batch=3, seq=16, seed=4), 5)
    assert np.array_equal(np.asarray(ref), a.numpy())


def test_run_train_on_cpu_reports_metrics():
    cfg = train.TrainConfig(model=port_cfg(n_layers=1, attention="flash",
                                           attn_block_k=128),
                            steps=3, batch=2, seq=20)
    metrics = train.TrainMetrics(flops_per_token=train.flops_per_token(
        cfg.model, cfg.seq), peak_flops=1e12)
    out = train.run_train(cfg, "cpu", metrics=metrics)
    assert out["step"] == 2 and out["resumed_from"] is None
    assert np.isfinite(out["loss"]) and metrics.loss == out["loss"]
    assert metrics.step == 2 and metrics.tokens_total == 3 * 2 * 20
    bench = train.fused_train_bench(cfg, steps=2, device="cpu")
    assert np.isfinite(bench["loss"]) and bench["mfu_pct"] is None


def test_peaks_and_devices():
    assert train.card_peaks("NVIDIA H100 80GB HBM3")[:2] == ("H100 SXM",
                                                            989e12)
    assert train.card_peaks("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    assert train.card_peaks("NVIDIA H100 NVL")[0] == "H100 NVL"
    assert train.card_peaks("NVIDIA H200")[0] == "H200 SXM"
    assert train.card_peaks("NVIDIA A10") is None
    if not torch.cuda.is_available():
        assert train.detect_peak_flops() is None
        with pytest.raises(RuntimeError, match="CUDA"):
            train.run_train(train.TrainConfig(model=port_cfg(), steps=1))
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--steps", "1"])


def test_cli_trains_on_cpu(capsys):
    assert train.main(["--device", "cpu", "--steps", "2", "--batch", "1",
                       "--seq", "16", "--attention", "flash",
                       "--attn-block", "128", "--no-report"]) == 0
    assert "'step': 1" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--experts", "4"], ["--parallel", "sp"],
                                   ["--parallel", "sp-ring"]])
def test_cli_flags_outside_the_slice_exit(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(flags + ["--device", "cpu"])
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def test_configs_validate_like_the_reference():
    with pytest.raises(ValueError, match="attention"):
        port_cfg(attention="ring")
    with pytest.raises(ValueError, match="attn_block_k"):
        port_cfg(attn_block_k=0)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train.TrainConfig(model=port_cfg(), parallel="sp")
    with pytest.raises(ValueError, match="parallel"):
        train.TrainConfig(model=port_cfg(), parallel="pp")
    # The config fields are the reference's, in its order.
    assert [f.name for f in dataclasses.fields(model.ModelConfig)] == [
        f.name for f in dataclasses.fields(jax_model.ModelConfig)]


@pytest.mark.parametrize("b,t", [(1, 100), (2, 128)])
def test_flash_residuals_are_what_the_kernels_take(b, t):
    """The kernels take contiguous [BH, Tp, D] tensors: the fold must copy
    even where a reshape could be a view (batch 1), and pad T to the
    block grid."""
    x = torch.randn(b, t, 4, 32)
    out, res = model._flash_fwd(x, x, x, 512)
    assert out.shape == x.shape and out.is_contiguous()
    for r in res[:3]:
        assert r.shape == (b * 4, 128, 32) and r.is_contiguous()
    assert res[4].shape == (b * 4, 128)
