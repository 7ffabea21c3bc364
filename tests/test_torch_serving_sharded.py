"""The port's tensor-parallel serving against the JAX reference.

The counterparts of ``tests/test_serving_sharded.py:36-265`` and
``tests/test_quant.py:112-140``, on the reference's weights
(``params_from_jax``): the port's mesh is ``[cpu] * 8`` (one controller,
the same code as dp×tp on one card), the reference's its conftest's 8 CPU
devices. Sharded prefill and decode logits within 1e-5 relative (L2) of
the reference's single-device logits (f32: the row-parallel sums
reassociate, as XLA's psum does); each shard holding n_kv/tp heads of the
cache or pool on its device; the engine's streams equal to the
reference's single-device engine's in dense tp, block decode, paged tp and
paged tp speculation; the data-axis and kernel rejections; MoE over tp;
int8 weights over a 2×2 mesh.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import bridged_params  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon.loadgen.quant import quantize_params as jax_quantize  # noqa: E402
from tpumon_torch.loadgen.model import (  # noqa: E402
    Mesh,
    ModelConfig,
    all_reduce_sum,
    gather_vocab,
    param_shardings,
    params_from_jax,
    shard_params,
)
from tpumon_torch.loadgen.quant import QTensor  # noqa: E402
from tpumon_torch.loadgen.serving import (  # noqa: E402
    ServeConfig,
    ServingEngine,
    make_sharded_serving,
)

CPU = torch.device("cpu")
# tests/test_serving_sharded.py's CFG.
SMALL = dict(vocab=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=32, compute_dtype="float32")
PROMPTS = [[9, 4, 77], [5, 2, 8, 1], [3, 3], [60, 11, 42]]
PAGED_PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7], [2, 7]]
MOE_PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5], [2, 7]]
REL = 1e-5


def mesh(shape, axes):
    n = int(np.prod(shape))
    return Mesh(np.array([CPU] * n, dtype=object).reshape(shape), axes)


DATA_MODEL = mesh((4, 2), ("data", "model"))
TP2 = mesh((2,), ("model",))


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def scfg(**over):
    return ServeConfig(model=ModelConfig(**SMALL), slots=4, prefill_len=8,
                       **over)


def jcfg(**over):
    return jax_serving.ServeConfig(model=JaxModelConfig(**SMALL), slots=4,
                                   prefill_len=8, **over)


@pytest.fixture(scope="module")
def weights():
    return bridged_params(JaxModelConfig(**SMALL), seed=3)


def jax_streams(cfg, prompts, max_new, seed):
    eng = jax_serving.ServingEngine(cfg=cfg, seed=seed)
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.drain()
    return [r.output for r in reqs]


def port_streams(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.drain()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs]


def test_sharded_logits_match_reference_single_device(weights):
    jparams, tree = weights
    pre, dec, placed, cache, _ = make_sharded_serving(
        scfg(), DATA_MODEL, params_from_jax(tree))
    assert len(placed) == len(cache) == 8
    prompt = [9, 4, 77]
    n = len(prompt)
    toks = prompt + [0] * (8 - n)
    jcache = jax_serving.init_cache(jcfg())
    jcache, want = jax_serving.prefill(
        jcfg(), jparams, jcache, jnp.asarray(toks, jnp.int32),
        jnp.int32(n), jnp.int32(1))
    got = pre(cache, torch.tensor(toks, dtype=torch.int32), n, 1)
    assert rel(got.numpy(), want) < REL
    positions = np.zeros(4, np.int32)
    positions[1] = n
    last = np.zeros(4, np.int32)
    last[1] = int(jnp.argmax(want))
    for _ in range(4):
        jcache, jstep = jax_serving.decode_step(
            jcfg(), jparams, jcache, jnp.asarray(last),
            jnp.asarray(positions))
        step = dec(cache, torch.from_numpy(last), torch.from_numpy(positions))
        assert rel(step[1].numpy(), jstep[1]) < REL
        nxt = int(jnp.argmax(jstep[1]))
        assert int(torch.argmax(step[1])) == nxt
        positions[1] += 1
        last[1] = nxt


def test_sharded_cache_layout(weights):
    """The cache splits on its kv-head axis over "model" and on slots over
    "data": each shard's appends stay on its device, each its own
    allocation."""
    _, _, placed, cache, _ = make_sharded_serving(
        scfg(), DATA_MODEL, params_from_jax(weights[1]))
    for shard in cache:
        shape = tuple(shard["k"].shape)
        # slots 4 over dp=4 -> 1; n_kv 2 over tp=2 -> 1
        assert shape == (2, 1, 32, 1, 16)
        assert shard["k"].device == CPU
    assert len({s["k"].data_ptr() for s in cache}) == 8
    # wq's columns (4 heads x 16) split over "model": 2 heads a shard.
    assert tuple(placed[0]["layers"][0]["wq"].shape) == (64, 32)
    assert tuple(placed[1]["layers"][0]["wo"].shape) == (32, 64)
    assert tuple(placed[0]["lm_head"].shape) == (64, 48)
    assert tuple(placed[0]["embed"].shape) == (96, 64)


def test_shard_params_and_collectives(weights):
    params = params_from_jax(weights[1])
    shards = shard_params(TP2, params)
    wq = params["layers"][0]["wq"]
    assert torch.equal(torch.cat([s["layers"][0]["wq"] for s in shards], 1),
                       wq)
    assert torch.equal(torch.cat([s["layers"][0]["w_down"]
                                  for s in shards], 0),
                       params["layers"][0]["w_down"])
    # Replicated leaves are copies, not aliases, even on one device.
    assert shards[0]["embed"].data_ptr() != shards[1]["embed"].data_ptr()
    assert shards[0]["embed"].data_ptr() != params["embed"].data_ptr()
    a, b = torch.ones(2, 3), torch.full((2, 3), 2.0)
    summed = all_reduce_sum([a, b])
    assert all(torch.equal(s, torch.full((2, 3), 3.0)) for s in summed)
    assert torch.equal(gather_vocab([a, b]), torch.cat([a, b], -1))


def test_engine_runs_tensor_parallel(weights):
    want = jax_streams(jcfg(), PROMPTS, 8, seed=3)
    eng = ServingEngine(cfg=scfg(), params=params_from_jax(weights[1]),
                        seed=3, mesh=DATA_MODEL)
    assert port_streams(eng, PROMPTS, 8) == want
    assert isinstance(eng.cache, list) and len(eng.cache) == 8


def test_engine_mesh_block_decode_matches_reference(weights):
    want = jax_streams(jcfg(), PROMPTS, 8, seed=3)
    eng = ServingEngine(cfg=scfg(decode_block=4),
                        params=params_from_jax(weights[1]), seed=3,
                        mesh=DATA_MODEL)
    assert port_streams(eng, PROMPTS, 8) == want
    assert eng.decode_steps_total % 4 == 0


@pytest.mark.parametrize("over", [{"spec_len": 2},
                                  {"prefix_cache_entries": 4},
                                  {"kv_layout": "paged"}])
def test_engine_mesh_rejects_uncomposable_modes(over):
    with pytest.raises(ValueError, match="mesh"):
        ServingEngine(cfg=scfg(**over), mesh=DATA_MODEL)


class TestShardedPagedEngine:
    """Paged KV (and the speculative verify) over a tp-only mesh: the
    pool splits on its kv-head axis, and the streams equal the
    reference's single-device paged engine's."""

    @pytest.fixture(scope="class")
    def tree(self):
        return bridged_params(JaxModelConfig(**SMALL), seed=0)[1]

    def _run(self, tree, **kw):
        eng = ServingEngine(cfg=scfg(kv_layout="paged", **kw),
                            params=params_from_jax(tree), mesh=TP2)
        return eng, port_streams(eng, PAGED_PROMPTS, 8)

    def _want(self, **kw):
        return jax_streams(jcfg(kv_layout="paged", **kw), PAGED_PROMPTS, 8,
                           seed=0)

    def test_paged_tp_matches_reference(self, tree):
        eng, got = self._run(tree)
        assert got == self._want()
        assert len(eng.pool) == 2
        for shard in eng.pool:  # n_kv 2 over tp 2: one head a shard
            assert shard["k"].shape[1] == 1 and shard["k"].device == CPU
        assert eng.pool[0]["k"].data_ptr() != eng.pool[1]["k"].data_ptr()

    def test_paged_tp_block_decode_matches(self, tree):
        assert self._run(tree, decode_block=4)[1] == self._want(
            decode_block=4)

    def test_paged_tp_speculative_matches(self, tree):
        draft = ModelConfig(**dict(SMALL, n_layers=1))
        eng, got = self._run(tree, spec_len=3, draft_model=draft)
        assert got == self._want(
            spec_len=3, draft_model=JaxModelConfig(**dict(SMALL,
                                                          n_layers=1)))
        assert eng.spec_proposed_total > 0
        # The truncated draft aliases the placed target's shards.
        assert (eng.draft_params[0]["layers"][0]
                is eng.params[0]["layers"][0])
        assert [c["k"].shape[3] for c in eng.draft_cache] == [1, 1]

    def test_paged_mesh_rejects_data_axis_and_kernel(self):
        with pytest.raises(ValueError, match="tensor-parallel only"):
            ServingEngine(cfg=scfg(kv_layout="paged"),
                          mesh=mesh((2, 2), ("data", "model")))
        with pytest.raises(ValueError, match="kernel"):
            ServingEngine(cfg=scfg(kv_layout="paged", paged_attn="kernel"),
                          mesh=TP2)


def moe_config(n_experts=4, **kw):
    return ServeConfig(model=ModelConfig(**dict(SMALL, n_experts=n_experts)),
                       slots=4, prefill_len=8, **kw)


@pytest.fixture(scope="module")
def moe_weights():
    return bridged_params(JaxModelConfig(**dict(SMALL, n_experts=4)), seed=0)


def moe_reference(**kw):
    cfg = jax_serving.ServeConfig(
        model=JaxModelConfig(**dict(SMALL, n_experts=4)), slots=4,
        prefill_len=8, **kw)
    return jax_streams(cfg, MOE_PROMPTS, 6, seed=0)


def test_moe_model_serves_over_tp_mesh(moe_weights):
    """Experts split over "model" beside the Megatron attention split."""
    eng = ServingEngine(cfg=moe_config(),
                        params=params_from_jax(moe_weights[1]),
                        mesh=mesh((1, 2), ("data", "model")))
    assert port_streams(eng, MOE_PROMPTS, 6) == moe_reference()
    banks = [sh["layers"][0]["moe"]["w_in"].shape[0] for sh in eng.params]
    assert banks == [2, 2]
    with pytest.raises(ValueError, match="n_experts"):
        ServingEngine(cfg=moe_config(n_experts=3),
                      mesh=mesh((1, 2), ("data", "model")))


def test_moe_paged_spec_prompt_over_tp_mesh(moe_weights):
    spec = dict(kv_layout="paged", spec_len=2, spec_source="prompt")
    want = moe_reference(**spec)
    assert want == moe_reference(kv_layout="paged")  # lossless
    eng = ServingEngine(cfg=moe_config(**spec),
                        params=params_from_jax(moe_weights[1]), mesh=TP2)
    assert port_streams(eng, MOE_PROMPTS, 6) == want
    assert eng.spec_rounds_total > 0


def test_quantized_tensor_parallel_serving():
    """int8 weights over a 2×2 mesh: q keeps the weight's spec, the scale
    takes its last axis's (split for column-parallel weights, replicated
    for row-parallel ones); the sharded logits equal the reference's
    sharded run on the same codes."""
    from jax.sharding import Mesh as JaxMesh

    jparams, _ = bridged_params(JaxModelConfig(**SMALL), seed=0)
    jq = jax_quantize(jparams)
    tree = jax.tree.map(np.asarray, jq)
    params = params_from_jax(tree)
    mesh22 = mesh((2, 2), ("data", "model"))
    sh = param_shardings(mesh22, params)
    assert isinstance(sh["layers"][0]["wq"], QTensor)
    assert sh["layers"][0]["wq"].q == (None, "model")
    assert sh["layers"][0]["wq"].scale == ("model",)
    assert sh["layers"][0]["w_down"].scale == (None,)
    cfg = ServeConfig(model=ModelConfig(**SMALL), slots=2, prefill_len=8,
                      quantize="int8")
    pre, dec, placed, cache, _ = make_sharded_serving(cfg, mesh22, params)
    wq = placed[1]["layers"][0]["wq"]
    assert wq.q.dtype == torch.int8 and tuple(wq.q.shape) == (64, 32)
    assert tuple(wq.scale.shape) == (32,)
    assert tuple(placed[1]["layers"][0]["w_down"].scale.shape) == (64,)

    jmesh = JaxMesh(np.array(jax.devices()[:4]).reshape(2, 2),
                    ("data", "model"))
    jcfg_q = jax_serving.ServeConfig(model=JaxModelConfig(**SMALL), slots=2,
                                     prefill_len=8, quantize="int8")
    jpre, jdec, _, jcache, _ = jax_serving.make_sharded_serving(
        jcfg_q, jmesh, jq)
    toks = [1, 2, 3, 0, 0, 0, 0, 0]
    jcache, jplog = jpre(jcache, jnp.asarray(toks, jnp.int32), jnp.int32(3),
                         jnp.int32(0))
    plog = pre(cache, torch.tensor(toks, dtype=torch.int32), 3, 0)
    assert rel(plog.numpy(), jplog) < REL
    jcache, jdlog = jdec(jcache, jnp.zeros((2,), jnp.int32),
                         jnp.array([3, 0], jnp.int32))
    dlog = dec(cache, torch.zeros(2, dtype=torch.int32),
               torch.tensor([3, 0], dtype=torch.int32))
    assert bool(torch.isfinite(dlog).all())
    assert rel(dlog[0].numpy(), jdlog[0]) < REL


def test_quantized_mesh_engine_streams_equal_unsharded():
    """The int8 engine over a tp mesh emits the single-device int8
    engine's streams (the codes are the same, the products split)."""
    tree = bridged_params(JaxModelConfig(**SMALL), seed=0)[1]
    want = port_streams(ServingEngine(
        cfg=scfg(quantize="int8", kv_layout="paged"),
        params=params_from_jax(tree), device="cpu"), PAGED_PROMPTS, 6)
    eng = ServingEngine(cfg=scfg(quantize="int8", kv_layout="paged"),
                        params=params_from_jax(tree), mesh=TP2)
    assert port_streams(eng, PAGED_PROMPTS, 6) == want
    assert isinstance(eng.params[0]["layers"][0]["wq"], QTensor)


def test_mesh_shape_reads_as_the_reference():
    assert DATA_MODEL.shape == {"data": 4, "model": 2}
    assert TP2.shape.get("data", 1) == 1 and TP2.shape["model"] == 2
    assert [DATA_MODEL.model_index(i) for i in range(4)] == [0, 1, 0, 1]
    with pytest.raises(ValueError):
        Mesh([CPU, CPU], ("data", "model"))
