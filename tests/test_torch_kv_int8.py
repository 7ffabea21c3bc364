"""The port's int8 KV cache and pool against the JAX reference's.

``_kv_quant`` gives the reference's int8 codes and f32 scales bit for bit
on the same inputs (round half to even at exact ties, the 1e-8 scale
floor on zero rows), and ``_kv_dequant`` its values. ``init_cache`` and
``init_pool`` lay out the int8 rows and their scales as the reference
does. Through ``prefill``, ``decode_step``, ``speculative.decode_block``
and the paged functions on bridged f32 weights, the logits agree within
atol = rtol = 1e-4 and the stored scales within rtol 1e-5; the stored
codes are the reference's except where the two frameworks' K/V differ
across a rounding point, by one code at most, in under 0.1% of entries.
Engines with ``kv_dtype="int8"`` (dense with block decode, paged gather,
with prefix caching and speculation) emit the reference's streams
exactly, greedy and sampled; the composition rules and the kernel's
refusal of the int8 pool carry the reference's messages.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import bridged_params, jax_f32, torch_f32  # noqa: E402
from tpumon.loadgen import paged_kv as jax_kv  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen import speculative as jax_spec  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch.loadgen import paged_kv, serving, speculative  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig, params_from_jax  # noqa: E402

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=64, compute_dtype="float32")
PS = 8
SLOTS = 3
SEED = 3
TOL = dict(atol=1e-4, rtol=1e-4)
_rng = np.random.default_rng(61)
PROMPTS = [[int(t) for t in _rng.integers(0, 128, n)]
           for n in (5, 12, 20, 1, 9, 17)]
MAX_NEW = [9, 6, 12, 4, 7, 5]
SAMPLING = [(0.0, 0), (0.8, 0), (0.0, 0), (0.8, 5), (0.0, 0), (0.0, 0)]


def test_kv_quant_codes_and_scales_equal_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # a zero row: the 1e-8 floor
    # Exact ties: max 127 gives scale 1, so halves land on k + 0.5.
    x[1, 2, 1] = np.concatenate([[127.0], np.arange(15) - 6.5])
    for arr in (x, x.astype(np.float32) * 1e-6):
        qj, sj = jax_serving._kv_quant(jnp.asarray(arr))
        qt, st = serving._kv_quant(torch.from_numpy(arr))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            np.testing.assert_array_equal(
                torch_f32(serving._kv_dequant(qt, st, dt)),
                jax_f32(jax_serving._kv_dequant(qj, sj, jdt)))
    # bf16 input: quantized from its f32 value, as the reference does.
    xb = torch.from_numpy(x).to(torch.bfloat16)
    qj, sj = jax_serving._kv_quant(jnp.asarray(x).astype(jnp.bfloat16))
    qt, st = serving._kv_quant(xb)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def configs(**kw):
    return (jax_serving.ServeConfig(model=JaxModelConfig(**SMALL),
                                    slots=SLOTS, prefill_len=PS,
                                    kv_dtype="int8", **kw),
            serving.ServeConfig(model=ModelConfig(**SMALL), slots=SLOTS,
                                prefill_len=PS, kv_dtype="int8", **kw))


def test_int8_cache_and_pool_layouts_equal_reference():
    jcfg, tcfg = configs()
    jcache, tcache = jax_serving.init_cache(jcfg), serving.init_cache(
        tcfg, "cpu")
    jpool, tpool = jax_kv.init_pool(jcfg, 10), paged_kv.init_pool(
        tcfg, 10, "cpu")
    for j, t in ((jcache, tcache), (jpool, tpool)):
        assert set(t) == set(j) == {"k", "v", "ks", "vs"}
        for name in j:
            assert tuple(t[name].shape) == j[name].shape
            assert str(t[name].dtype).split(".")[-1] == str(j[name].dtype)
            assert not t[name].any()


def assert_codes_match(tq, jq, ts, js):
    """Scales within rtol 1e-5; codes equal but where the two K/V fell
    either side of a rounding point: one code apart, under 0.1%."""
    np.testing.assert_allclose(torch_f32(ts), jax_f32(js), rtol=1e-5,
                               atol=1e-12)
    d = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.fixture(scope="module")
def weights():
    return bridged_params(JaxModelConfig(**SMALL), seed=7)


def test_dense_int8_prefill_decode_and_block_match_reference(weights):
    jcfg, tcfg = configs()
    jparams, tparams = weights[0], params_from_jax(weights[1])
    jc, tc = jax_serving.init_cache(jcfg), serving.init_cache(tcfg, "cpu")
    for slot, prompt in ((0, PROMPTS[2]), (2, PROMPTS[0])):
        for c0 in range(0, len(prompt), PS):
            chunk = prompt[c0:c0 + PS]
            toks = np.zeros(PS, np.int32)
            toks[:len(chunk)] = chunk
            jc, jl = jax_serving.prefill(
                jcfg, jparams, jc, jnp.asarray(toks), jnp.int32(len(chunk)),
                jnp.int32(slot), jnp.int32(c0))
            tl = serving.prefill(tcfg, tparams, tc, torch.from_numpy(toks),
                                 len(chunk), slot, c0)
            np.testing.assert_allclose(torch_f32(tl), jax_f32(jl), **TOL)
    pos = [len(PROMPTS[2]), SMALL["max_seq"] - 1, len(PROMPTS[0])]
    last = [3, 0, 77]
    for _ in range(3):
        jc, jl = jax_serving.decode_step(jcfg, jparams, jc,
                                         jnp.asarray(last, jnp.int32),
                                         jnp.asarray(pos, jnp.int32))
        tl = serving.decode_step(tcfg, tparams, tc,
                                 torch.tensor(last, dtype=torch.int32),
                                 torch.tensor(pos, dtype=torch.int32))
        np.testing.assert_allclose(torch_f32(tl), jax_f32(jl), **TOL)
        last = [int(t) for t in np.asarray(jl).argmax(-1)]
        pos = [min(p + 1, SMALL["max_seq"] - 1) for p in pos]
    block = [[5, 6, 7], [1, 2, 3], [9, 8, 7]]
    jc, jl = jax_spec.decode_block(jcfg, jparams, jc,
                                   jnp.asarray(block, jnp.int32),
                                   jnp.asarray(pos, jnp.int32))
    tl = speculative.decode_block(tcfg, tparams, tc,
                                  torch.tensor(block, dtype=torch.int32),
                                  torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(torch_f32(tl), jax_f32(jl), **TOL)
    for name, sname in (("k", "ks"), ("v", "vs")):
        assert_codes_match(tc[name], jc[name], tc[sname], jc[sname])


def test_paged_int8_prefill_decode_and_block_match_reference(weights):
    jcfg, tcfg = configs(kv_layout="paged")
    jparams, tparams = weights[0], params_from_jax(weights[1])
    jp, tp = jax_kv.init_pool(jcfg, 12), paged_kv.init_pool(tcfg, 12, "cpu")
    tables = np.zeros((SLOTS, 8), np.int32)
    tables[0, :3] = [5, 9, 2]
    tables[2, :2] = [7, 3]
    for slot, prompt in ((0, PROMPTS[2]), (2, PROMPTS[1])):
        for c0 in range(0, len(prompt), PS):
            chunk = prompt[c0:c0 + PS]
            toks = np.zeros(PS, np.int32)
            toks[:len(chunk)] = chunk
            page = int(tables[slot, c0 // PS])
            jp, jl = jax_kv.paged_prefill(
                jcfg, jparams, jp, jnp.asarray(toks), jnp.int32(len(chunk)),
                jnp.int32(page), jnp.asarray(tables[slot]), jnp.int32(c0))
            tl = paged_kv.paged_prefill(
                tcfg, tparams, tp, torch.from_numpy(toks), len(chunk), page,
                torch.from_numpy(tables[slot]), c0)
            np.testing.assert_allclose(torch_f32(tl), jax_f32(jl), **TOL)
    pos = np.array([len(PROMPTS[2]), 0, len(PROMPTS[1])], np.int32)
    last = np.array([4, 0, 8], np.int32)
    jp, jl = jax_kv.paged_decode_step(jcfg, jparams, jp, jnp.asarray(last),
                                      jnp.asarray(pos), jnp.asarray(tables))
    tl = paged_kv.paged_decode_step(tcfg, tparams, tp,
                                    torch.from_numpy(last),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(tables))
    np.testing.assert_allclose(torch_f32(tl), jax_f32(jl), **TOL)
    block = np.array([[5, 6, 7], [0, 0, 0], [9, 8, 7]], np.int32)
    jp, jl = jax_kv.paged_decode_block(jcfg, jparams, jp,
                                       jnp.asarray(block),
                                       jnp.asarray(pos + 1),
                                       jnp.asarray(tables))
    tl = paged_kv.paged_decode_block(tcfg, tparams, tp,
                                     torch.from_numpy(block),
                                     torch.from_numpy(pos + 1),
                                     torch.from_numpy(tables))
    np.testing.assert_allclose(torch_f32(tl), jax_f32(jl), **TOL)
    for name, sname in (("k", "ks"), ("v", "vs")):
        # Page 0 (the trash page the idle slot writes) aside: its rows are
        # garbage by design.
        assert_codes_match(tp[name][:, :, 1:], jp[name][:, :, 1:],
                           tp[sname][:, :, 1:], jp[sname][:, :, 1:])
    with pytest.raises(ValueError, match="cannot read a quantized"):
        paged_kv.paged_decode_step(
            dataclasses.replace(tcfg, paged_attn="kernel"), tparams, tp,
            torch.from_numpy(last), torch.from_numpy(pos),
            torch.from_numpy(tables))


ENGINES = {
    "dense-block4": {"decode_block": 4},
    "paged-gather": {"kv_layout": "paged"},
    "paged-prefix-spec": {"kv_layout": "paged", "prefix_cache_entries": 2,
                          "spec_len": 2},
    "paged-block4": {"kv_layout": "paged", "decode_block": 4},
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_int8_kv_engine_streams_identical_to_reference(weights, name):
    kw = ENGINES[name]
    jcfg = jax_serving.ServeConfig(model=JaxModelConfig(**SMALL), slots=2,
                                   prefill_len=PS, kv_dtype="int8", **kw)
    tcfg = serving.ServeConfig(model=ModelConfig(**SMALL), slots=2,
                               prefill_len=PS, kv_dtype="int8", **kw)
    ref = jax_serving.ServingEngine(cfg=jcfg, params=weights[0], seed=SEED)
    eng = serving.ServingEngine(cfg=tcfg, params=params_from_jax(weights[1]),
                                seed=SEED, device="cpu")
    streams = []
    for e in (ref, eng):
        reqs = [e.submit(p, max_new=n, temperature=t, top_k=k)
                for p, n, (t, k) in zip(PROMPTS, MAX_NEW, SAMPLING)]
        e.drain()
        assert all(r.status == "completed" for r in reqs)
        streams.append([r.output for r in reqs])
    assert streams[1] == streams[0]
    jsnap, snap = ref._stats_snapshot(), eng._stats_snapshot()
    for key in ("tokens", "steps", "spec_accepted", "prefix",
                "kv_pages_free"):
        assert snap[key] == jsnap[key], key


@pytest.mark.parametrize("over", [
    {"kv_layout": "paged", "paged_attn": "kernel"},
    {"prefix_cache_entries": 2},
    {"spec_len": 2, "spec_source": "prompt"},
    {"kv_dtype": "int4"},
])
def test_int8_composition_rules_match_reference(over):
    kw = {"kv_dtype": "int8", **over}
    with pytest.raises(ValueError) as want:
        jax_serving.ServingEngine(cfg=jax_serving.ServeConfig(
            model=JaxModelConfig(**SMALL), slots=2, prefill_len=PS, **kw))
    with pytest.raises(ValueError) as got:
        serving.ServingEngine(cfg=serving.ServeConfig(
            model=ModelConfig(**SMALL), slots=2, prefill_len=PS, **kw),
            device="cpu")
    # The port's kernel is CUDA, not Pallas: its message names no Pallas.
    assert str(got.value) == str(want.value).replace("the Pallas kernel",
                                                     "the kernel")


def test_int8_cache_halves_the_resident_kv():
    """bf16 model: the int8 cache holds 1 byte a K/V element plus 4 bytes
    of scale a (row, kv head), against 2 bytes a bf16 element."""
    model = ModelConfig(**dict(SMALL, compute_dtype="bfloat16"))
    sizes = {}
    for kv in ("compute", "int8"):
        cache = serving.init_cache(serving.ServeConfig(
            model=model, slots=2, prefill_len=PS, kv_dtype=kv), "cpu")
        sizes[kv] = sum(t.numel() * t.element_size() for t in cache.values())
    hd = model.head_dim
    assert sizes["int8"] / sizes["compute"] == (hd + 4) / (2 * hd)
