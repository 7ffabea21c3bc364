"""The port's speculative engine against the JAX reference's.

Self-speculation, a layer-truncated draft (sharing the target's bottom
layer) and prompt lookup, over the dense cache and the paged pool (the
kernel read path for plain steps, the gather verify block), with greedy
and sampled requests mixed: on f32 weights bridged with
``params_from_jax`` the streams are IDENTICAL to the reference engine's,
and so are the speculative counters (rounds, proposals, acceptances) and
the decode steps. Greedy speculation is lossless: every stream equals the
same engine's plain decode. ``ngram_propose`` equals the reference's on
seeded contexts, and the composition rules reject what the reference
rejects, with its messages.
"""

import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_parity import bridged_params  # noqa: E402
from tpumon.loadgen import prompt_lookup as jax_pl  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch.loadgen import prompt_lookup, serving  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig, params_from_jax  # noqa: E402

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=64, compute_dtype="float32")
PS = 8
SEED = 3
_rng = np.random.default_rng(41)
# Random prompts of 1-3 chunks and two periodic ones (prompt lookup's
# case: the context repeats).
PROMPTS = ([[int(t) for t in _rng.integers(0, 128, n)] for n in (5, 12, 20)]
           + [[3, 14, 15, 92, 65] * 4, [7, 7, 1] * 3])
MAX_NEW = [9, 6, 12, 10, 7]
SAMPLING = [(0.0, 0), (0.8, 0), (0.0, 0), (0.0, 0), (0.8, 5)]

KINDS = {
    "self": {"spec_len": 3},
    "truncated": {"spec_len": 2, "draft_model": 1},
    "prompt": {"spec_len": 4, "spec_source": "prompt"},
}
LAYOUTS = {"dense": {},
           "paged-kernel": {"kv_layout": "paged", "paged_attn": "kernel"}}


@pytest.fixture(scope="module")
def weights():
    return bridged_params(JaxModelConfig(**SMALL), seed=5)


def configs(kind, layout):
    kw = {**KINDS[kind], **LAYOUTS[layout]}
    jkw, tkw = dict(kw), dict(kw)
    if "draft_model" in kw:
        jkw["draft_model"] = JaxModelConfig(**dict(SMALL, n_layers=1))
        tkw["draft_model"] = ModelConfig(**dict(SMALL, n_layers=1))
    return (jax_serving.ServeConfig(model=JaxModelConfig(**SMALL), slots=2,
                                    prefill_len=PS, **jkw),
            serving.ServeConfig(model=ModelConfig(**SMALL), slots=2,
                                prefill_len=PS, **tkw))


def port_engine(weights, cfg):
    return serving.ServingEngine(cfg=cfg, params=params_from_jax(weights[1]),
                                 seed=SEED, device="cpu")


def serve(engine, sampling=SAMPLING):
    reqs = [engine.submit(p, max_new=n, temperature=t, top_k=k)
            for p, n, (t, k) in zip(PROMPTS, MAX_NEW, sampling)]
    engine.drain()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs]


SPEC_KEYS = ("tokens", "steps", "spec_rounds", "spec_proposed",
             "spec_accepted", "weight_bytes")


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_spec_streams_identical_to_reference(weights, kind, layout):
    jcfg, tcfg = configs(kind, layout)
    ref = jax_serving.ServingEngine(cfg=jcfg, params=weights[0], seed=SEED)
    eng = port_engine(weights, tcfg)
    assert serve(eng) == serve(ref)
    jsnap, snap = ref._stats_snapshot(), eng._stats_snapshot()
    for key in SPEC_KEYS:
        assert snap[key] == jsnap[key], key
    assert snap["spec_rounds"] > 0


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_speculation_is_lossless(weights, kind, layout):
    """Greedy streams equal plain decode's whatever the proposals (f32);
    self-speculation accepts every proposal."""
    greedy = [(0.0, 0)] * len(PROMPTS)
    _, tcfg = configs(kind, layout)
    plain = serve(port_engine(weights, dataclasses.replace(
        tcfg, spec_len=0, draft_model=None, spec_source="draft")), greedy)
    eng = port_engine(weights, tcfg)
    assert serve(eng, greedy) == plain
    if kind == "self":
        assert eng.spec_accepted_total == eng.spec_proposed_total > 0


def test_truncated_draft_shares_the_target_tensors(weights):
    _, tcfg = configs("truncated", "dense")
    eng = port_engine(weights, tcfg)
    assert eng.draft_params["layers"][0] is eng.params["layers"][0]
    assert len(eng.draft_params["layers"]) == 1
    assert eng.draft_params["embed"] is eng.params["embed"]
    # weight_bytes counts shared tensors once: the target's bytes only.
    plain = port_engine(weights, dataclasses.replace(
        tcfg, spec_len=0, draft_model=None))
    assert (eng._stats_snapshot()["weight_bytes"]
            == plain._stats_snapshot()["weight_bytes"])


def test_spec_metrics_count_for_real(weights):
    _, tcfg = configs("prompt", "paged-kernel")
    eng = port_engine(weights, tcfg)
    serve(eng)
    text = eng.metrics_text()
    for fam, value in (("tpumon_serving_spec_rounds", eng.spec_rounds_total),
                       ("tpumon_serving_spec_accepted",
                        eng.spec_accepted_total)):
        assert f"{fam} {value}" in text
    assert eng.spec_rounds_total > 0 and eng.spec_accepted_total > 0


def test_ngram_propose_equals_reference():
    rng = random.Random(5)
    contexts = [[], [4], [1, 2, 3, 1, 2], [5] * 7]
    for _ in range(200):
        n = rng.randint(1, 40)
        period = rng.randint(1, 6)
        base = [rng.randrange(8) for _ in range(period)]
        contexts.append([base[i % period] if rng.random() < 0.8
                         else rng.randrange(8) for i in range(n)])
    for ctx in contexts:
        for g, window in ((1, 1024), (4, 1024), (7, 0), (5, 6)):
            assert prompt_lookup.ngram_propose(ctx, g, window=window) == (
                jax_pl.ngram_propose(ctx, g, window=window)), (ctx, g)


@pytest.mark.parametrize("over", [
    {"spec_len": -1},
    {"spec_source": "ngram"},
    {"spec_len": 2, "spec_source": "prompt", "draft_model": "1 layer"},
    {"spec_len": 2, "draft_model": "vocab 64"},
    {"spec_len": 2, "draft_model": "2 layers"},
    {"spec_len": 2, "kv_dtype": "int8"},
])
def test_composition_rules_match_reference(weights, over):
    drafts = {"1 layer": dict(SMALL, n_layers=1),
              "vocab 64": dict(SMALL, n_layers=1, vocab=64),
              "2 layers": SMALL}
    jover, tover = dict(over), dict(over)
    if "draft_model" in over:
        jover["draft_model"] = JaxModelConfig(**drafts[over["draft_model"]])
        tover["draft_model"] = ModelConfig(**drafts[over["draft_model"]])
    with pytest.raises(ValueError) as want:
        jax_serving.ServingEngine(cfg=jax_serving.ServeConfig(
            model=JaxModelConfig(**SMALL), slots=2, prefill_len=PS,
            **jover), params=weights[0])
    with pytest.raises(ValueError) as got:
        serving.ServingEngine(cfg=serving.ServeConfig(
            model=ModelConfig(**SMALL), slots=2, prefill_len=PS, **tover),
            params=params_from_jax(weights[1]), device="cpu")
    assert str(got.value) == str(want.value)
