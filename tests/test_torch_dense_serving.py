"""The port's dense KV cache against the JAX reference.

``init_cache``, ``prefill``, ``decode_step``, ``speculative.decode_block``
and ``decode_rounds`` of ``tpumon_torch.loadgen`` against
``tpumon.loadgen``'s, on the same weights (``params_from_jax``), tokens
and slots: logits and every cache row agree within atol = rtol = 1e-4
(f32; the two frameworks sum in different orders), as the paged tests
hold them. The reference's ``lax.dynamic_update_slice`` clamps its
start so the update fits; a last prefill chunk when max_seq is not a
multiple of prefill_len, and a T > 1 block at a parked slot's row
max_seq - 1, show that the port writes the rows the reference writes.
Then the reference's own oracle: cached decode equals the full forward.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import bridged_params, jax_f32, torch_f32  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen import speculative as jax_spec  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch import prng  # noqa: E402
from tpumon_torch.loadgen import serving, speculative  # noqa: E402
from tpumon_torch.loadgen.model import (  # noqa: E402
    ModelConfig,
    forward,
    params_from_jax,
)

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=64, compute_dtype="float32")
PS = 8
SLOTS = 3
TOL = dict(atol=1e-4, rtol=1e-4)
_rng = np.random.default_rng(21)
PROMPT_A = [int(t) for t in _rng.integers(0, 128, 19)]
PROMPT_B = [int(t) for t in _rng.integers(0, 128, 5)]


class Pair:
    """One reference cache and one port cache driven in lockstep."""

    def __init__(self, max_seq=SMALL["max_seq"], seed=7):
        small = dict(SMALL, max_seq=max_seq)
        self.jcfg = jax_serving.ServeConfig(
            model=JaxModelConfig(**small), slots=SLOTS, prefill_len=PS)
        self.tcfg = serving.ServeConfig(model=ModelConfig(**small),
                                        slots=SLOTS, prefill_len=PS)
        self.jparams, tree = bridged_params(self.jcfg.model, seed=seed)
        self.tparams = params_from_jax(tree)
        self.jcache = jax_serving.init_cache(self.jcfg)
        self.tcache = serving.init_cache(self.tcfg, "cpu")

    def assert_caches_match(self):
        for name in ("k", "v"):
            np.testing.assert_allclose(torch_f32(self.tcache[name]),
                                       jax_f32(self.jcache[name]), **TOL)

    def prefill(self, prompt, slot):
        """Chunked prefill on both sides; each chunk's logits must agree.
        Returns the last chunk's (reference, port) logits."""
        for c0 in range(0, len(prompt), PS):
            chunk = prompt[c0:c0 + PS]
            toks = np.zeros(PS, np.int32)
            toks[:len(chunk)] = chunk
            self.jcache, jl = jax_serving.prefill(
                self.jcfg, self.jparams, self.jcache, jnp.asarray(toks),
                jnp.int32(len(chunk)), jnp.int32(slot), jnp.int32(c0))
            tl = serving.prefill(self.tcfg, self.tparams, self.tcache,
                                 torch.from_numpy(toks), len(chunk), slot,
                                 c0)
            np.testing.assert_allclose(torch_f32(tl), jax_f32(jl), **TOL)
        return jax_f32(jl), torch_f32(tl)

    def decode(self, last, positions):
        self.jcache, jl = jax_serving.decode_step(
            self.jcfg, self.jparams, self.jcache,
            jnp.asarray(last, jnp.int32), jnp.asarray(positions, jnp.int32))
        tl = serving.decode_step(
            self.tcfg, self.tparams, self.tcache,
            torch.tensor(last, dtype=torch.int32),
            torch.tensor(positions, dtype=torch.int32))
        return jax_f32(jl), torch_f32(tl)

    def block(self, tokens, positions):
        self.jcache, jl = jax_spec.decode_block(
            self.jcfg, self.jparams, self.jcache,
            jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32))
        tl = speculative.decode_block(
            self.tcfg, self.tparams, self.tcache,
            torch.tensor(tokens, dtype=torch.int32),
            torch.tensor(positions, dtype=torch.int32))
        return jax_f32(jl), torch_f32(tl)


def test_init_cache_layout():
    pair = Pair()
    for name in ("k", "v"):
        assert tuple(pair.tcache[name].shape) == pair.jcache[name].shape
        assert pair.tcache[name].dtype == torch.float32
        assert not pair.tcache[name].any()
    # The int8 layout: int8 rows and f32 scales, the reference's shapes.
    jcache = jax_serving.init_cache(dataclasses.replace(pair.jcfg,
                                                        kv_dtype="int8"))
    tcache = serving.init_cache(dataclasses.replace(pair.tcfg,
                                                    kv_dtype="int8"), "cpu")
    assert set(tcache) == set(jcache) == {"k", "v", "ks", "vs"}
    for name, dtype in (("k", torch.int8), ("v", torch.int8),
                        ("ks", torch.float32), ("vs", torch.float32)):
        assert tuple(tcache[name].shape) == jcache[name].shape
        assert tcache[name].dtype == dtype and not tcache[name].any()


@pytest.mark.parametrize("slot", [0, 2])
def test_prefill_logits_and_cache_match(slot):
    pair = Pair()
    pair.prefill(PROMPT_A, slot)
    pair.prefill(PROMPT_B, (slot + 1) % SLOTS)
    pair.assert_caches_match()


@pytest.mark.parametrize("max_seq,n", [(60, 57), (60, 59), (44, 41)])
def test_prefill_last_chunk_clamps_like_dynamic_update_slice(max_seq, n):
    """max_seq % prefill_len != 0: the last chunk's write starts past
    max_seq - prefill_len and is clamped back, over rows an earlier chunk
    wrote; the port writes exactly the reference's rows."""
    assert max_seq % PS
    pair = Pair(max_seq=max_seq)
    prompt = [int(t) for t in np.random.default_rng(n).integers(0, 128, n)]
    pair.prefill(prompt, 1)
    pair.assert_caches_match()
    s0 = (n - 1) // PS * PS
    assert s0 > max_seq - PS  # the case under test: a clamped start


def test_decode_steps_match_with_a_parked_slot():
    """Two live slots at unequal lengths plus one parked at max_seq - 1
    (as the engine parks free and mid-prefill slots)."""
    pair = Pair()
    pair.prefill(PROMPT_A, 0)
    pair.prefill(PROMPT_B, 2)
    positions = [len(PROMPT_A), SMALL["max_seq"] - 1, len(PROMPT_B)]
    last = [11, 0, 42]
    for _ in range(4):
        jl, tl = pair.decode(last, positions)
        np.testing.assert_allclose(tl, jl, **TOL)
        pair.assert_caches_match()
        last = [int(t) for t in jl.argmax(-1)]
        positions = [positions[0] + 1, positions[1], positions[2] + 1]


@pytest.mark.parametrize("t", [1, 3])
def test_decode_block_matches(t):
    pair = Pair()
    pair.prefill(PROMPT_A, 0)
    pair.prefill(PROMPT_B, 1)
    tokens = np.random.default_rng(t).integers(0, 128, (SLOTS, t))
    positions = [len(PROMPT_A), len(PROMPT_B), 40]
    jl, tl = pair.block(tokens, positions)
    assert tl.shape == (SLOTS, t, SMALL["vocab"])
    np.testing.assert_allclose(tl, jl, **TOL)
    pair.assert_caches_match()


def test_decode_block_at_a_parked_position_clamps():
    """A T = 3 block at row max_seq - 1: the write lands on the last three
    rows, the reference's clamp, not past the cache."""
    pair = Pair()
    pair.prefill(PROMPT_A, 0)
    tokens = [[3, 4, 5], [6, 7, 8], [9, 10, 11]]
    park = SMALL["max_seq"] - 1
    jl, tl = pair.block(tokens, [len(PROMPT_A), park, park])
    np.testing.assert_allclose(tl, jl, **TOL)
    pair.assert_caches_match()
    rows = pair.tcache["k"][0, 1].abs().sum(-1).sum(-1).nonzero()[:, 0]
    assert rows.tolist() == [park - 2, park - 1, park]


def test_decode_step_is_block_of_one():
    pair = Pair()
    pair.prefill(PROMPT_A, 0)
    args = (torch.tensor([7, 1, 2], dtype=torch.int32),
            torch.tensor([len(PROMPT_A), 63, 63], dtype=torch.int32))
    cache = {k: v.clone() for k, v in pair.tcache.items()}
    step = serving.decode_step(pair.tcfg, pair.tparams, pair.tcache, *args)
    blk = speculative.decode_block(pair.tcfg, pair.tparams, cache,
                                   args[0][:, None], args[1])
    assert torch.equal(step, blk[:, 0])


@pytest.mark.parametrize("sampled", [False, True])
def test_decode_rounds_matches(sampled):
    """Four fused steps, greedy or with mixed temperature/top-k rows:
    the same tokens, positions and cache as the reference's scan."""
    pair = Pair()
    pair.prefill(PROMPT_A, 0)
    pair.prefill(PROMPT_B, 1)
    last = np.array([11, 42, 0], np.int32)
    positions = np.array([len(PROMPT_A), len(PROMPT_B), 63], np.int32)
    rids = np.array([4, 9, 0], np.int32)
    ctr0 = np.array([1, 3, 0], np.int32)
    temps = np.array([0.8, 1.3, 0.0] if sampled else [0.0] * 3, np.float32)
    topks = np.array([0, 5, 0], np.int32)
    seed = 0x7A11
    jcache, jlast, jpos, jtoks = jax_serving.decode_rounds(
        pair.jcfg, pair.jparams, pair.jcache, jnp.asarray(last),
        jnp.asarray(positions), jax.random.PRNGKey(seed), jnp.asarray(rids),
        jnp.asarray(ctr0), jnp.asarray(temps), jnp.asarray(topks), steps=4)
    pair.jcache = jcache
    tlast, tpos, ttoks = serving.decode_rounds(
        pair.tcfg, pair.tparams, pair.tcache, torch.from_numpy(last),
        torch.from_numpy(positions), prng.torch_key(seed, "cpu"),
        torch.from_numpy(rids), torch.from_numpy(ctr0),
        torch.from_numpy(temps),
        torch.from_numpy(topks), steps=4)
    assert ttoks.shape == (SLOTS, 4)
    live = [0, 1]
    assert np.array_equal(ttoks.numpy()[live], np.asarray(jtoks)[live])
    assert np.array_equal(tlast.numpy()[live], np.asarray(jlast)[live])
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    for name in ("k", "v"):  # the live slots' rows (slot 2 is parked)
        np.testing.assert_allclose(torch_f32(pair.tcache[name][:, :2]),
                                   jax_f32(pair.jcache[name][:, :2]), **TOL)


def test_cached_decode_equals_full_forward():
    """The reference's oracle (tests/test_serving_engine.py): greedy
    generation through the dense cache reproduces the recompute-
    everything forward token for token, at a non-zero slot."""
    pair = Pair()
    prompt = PROMPT_B
    _, tl = pair.prefill(prompt, 1)
    seq = list(prompt) + [int(tl.argmax())]
    last = [0, seq[-1], 0]
    for _ in range(6):
        positions = [63, len(seq) - 1, 63]
        _, logits = pair.decode(last, positions)
        full = forward(pair.tcfg.model, pair.tparams,
                       torch.tensor([seq], dtype=torch.int32))
        np.testing.assert_allclose(logits[1], torch_f32(full[0, -1]),
                                   atol=2e-4)
        seq.append(int(logits[1].argmax()))
        last = [0, seq[-1], 0]
