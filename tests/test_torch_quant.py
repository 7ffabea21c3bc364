"""The port's int8 weight quantization against the JAX reference's.

``quantize`` gives the reference's int8 codes and f32 scales bit for bit
on the same f32 weights (seeded numpy, all-zero columns and exact .5
ties included); ``quantize_params`` quantizes the same leaves and skips
the same ones; ``params_from_jax`` carries the reference's quantized tree
over code for code; ``param_bytes`` counts what the reference counts. An
engine serving int8 weights (``quantize="int8"``, dense and paged, greedy
and sampled, with the int8 KV cache too) emits the reference engine's
streams exactly on bridged f32 weights, and its weight gauge reports the
int8 bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import bridged_params  # noqa: E402
from tpumon.loadgen import quant as jax_quant  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch.loadgen import quant, serving  # noqa: E402
from tpumon_torch.loadgen.model import (  # noqa: E402
    ModelConfig,
    map_params,
    param_bytes,
    param_leaves,
    params_from_jax,
)

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=64, compute_dtype="float32")
PS = 8
SEED = 3
_rng = np.random.default_rng(51)
PROMPTS = [[int(t) for t in _rng.integers(0, 128, n)]
           for n in (5, 12, 20, 1, 9)]
MAX_NEW = [9, 6, 12, 4, 7]
SAMPLING = [(0.0, 0), (0.8, 0), (0.0, 0), (0.8, 5), (0.0, 0)]


@pytest.fixture(scope="module")
def weights():
    return bridged_params(JaxModelConfig(**SMALL), seed=5)


def weight_cases():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero column: the 1e-8 scale floor
    # Exact ties: column 9's max is 127, so w / scale hits k + 0.5.
    w[:, 9] = np.arange(64, dtype=np.float32) - 31.5
    w[0, 9] = 127.0
    three = rng.standard_normal((3, 16, 24)).astype(np.float32) * 40
    return [w, three, rng.standard_normal((1, 7)).astype(np.float32)]


@pytest.mark.parametrize("case", range(3))
def test_quantize_codes_and_scales_equal_reference(case):
    w = weight_cases()[case]
    want = jax_quant.quantize(jnp.asarray(w))
    got = quant.quantize(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    # Dequantize: the reference's astype, bit for bit.
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            got.to(dt).float().numpy(),
            np.asarray(want.astype(jdt).astype(jnp.float32)))
    assert got.nbytes == want.nbytes


def test_quantize_params_tree_equals_reference(weights):
    jparams, tree = weights
    jq = jax_quant.quantize_params(jparams)
    tq = quant.quantize_params(params_from_jax(tree))
    quantized = []

    def walk(j, t, path):
        if isinstance(j, dict):
            assert set(j) == set(t)
            for k in j:
                walk(j[k], t[k], f"{path}/{k}")
        elif isinstance(j, list):
            for i, (a, b) in enumerate(zip(j, t)):
                walk(a, b, f"{path}/{i}")
        elif isinstance(j, jax_quant.QTensor):
            assert isinstance(t, quant.QTensor), path
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(t.scale.numpy(),
                                          np.asarray(j.scale))
            quantized.append(path.rsplit("/", 1)[-1])
        else:
            assert isinstance(t, torch.Tensor), path
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    walk(jq, tq, "")
    assert set(quantized) == {"wq", "wk", "wv", "wo", "w_gate", "w_up",
                              "w_down", "lm_head"}
    assert param_bytes(tq) == jax_quant.param_bytes(jq)
    assert len(param_leaves(tq)) == len(jax.tree.leaves(
        jq, is_leaf=lambda x: isinstance(x, jax_quant.QTensor)))


def test_params_from_jax_carries_the_quantized_tree(weights):
    jq = jax_quant.quantize_params(weights[0])
    tq = params_from_jax(jax.tree.map(np.asarray, jq))
    wq = tq["layers"][1]["wq"]
    assert isinstance(wq, quant.QTensor) and wq.q.dtype == torch.int8
    np.testing.assert_array_equal(wq.q.numpy(),
                                  np.asarray(jq["layers"][1]["wq"].q))
    assert param_bytes(tq) == jax_quant.param_bytes(jq)
    # map_params keeps a QTensor whole.
    assert map_params(tq, lambda x: type(x).__name__)["lm_head"] == "QTensor"


def serve(engine):
    reqs = [engine.submit(p, max_new=n, temperature=t, top_k=k)
            for p, n, (t, k) in zip(PROMPTS, MAX_NEW, SAMPLING)]
    engine.drain()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("over", [
    {"decode_block": 4},
    {"kv_layout": "paged", "paged_attn": "kernel"},
    {"kv_dtype": "int8"},
    {"kv_layout": "paged", "kv_dtype": "int8", "spec_len": 2},
])
def test_int8_weight_streams_identical_to_reference(weights, over):
    jcfg = jax_serving.ServeConfig(model=JaxModelConfig(**SMALL), slots=2,
                                   prefill_len=PS, quantize="int8", **over)
    tcfg = serving.ServeConfig(model=ModelConfig(**SMALL), slots=2,
                               prefill_len=PS, quantize="int8", **over)
    ref = jax_serving.ServingEngine(cfg=jcfg, params=weights[0], seed=SEED)
    eng = serving.ServingEngine(cfg=tcfg, params=params_from_jax(weights[1]),
                                seed=SEED, device="cpu")
    assert serve(eng) == serve(ref)
    jsnap, snap = ref._stats_snapshot(), eng._stats_snapshot()
    for key in ("tokens", "steps", "weight_bytes", "spec_accepted"):
        assert snap[key] == jsnap[key], key


def test_quantize_argument_and_weight_gauge(weights):
    """``ServingEngine(quantize="int8")`` overrides the config as the
    reference's does; the resident weights are int8 codes, f32 scales and
    the unquantized embedding and norms."""
    cfg = serving.ServeConfig(model=ModelConfig(**SMALL), slots=2,
                              prefill_len=PS)
    eng = serving.ServingEngine(cfg=cfg, params=params_from_jax(weights[1]),
                                quantize="int8", device="cpu")
    plain = serving.ServingEngine(cfg=cfg,
                                  params=params_from_jax(weights[1]),
                                  device="cpu")
    assert eng.cfg.quantize == "int8"
    got = eng._stats_snapshot()["weight_bytes"]
    assert got == jax_quant.param_bytes(
        jax_quant.quantize_params(weights[0]))
    assert got < plain._stats_snapshot()["weight_bytes"] / 2
    assert f"tpumon_serving_weight_bytes {got}" in eng.metrics_text()
    with pytest.raises(ValueError, match="unknown quantize mode"):
        serving.ServingEngine(cfg=cfg, quantize="int4", device="cpu")
