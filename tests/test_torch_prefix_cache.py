"""The port's prefix caching against the JAX reference's.

``PrefixCache`` (dense snapshot and restore) and ``PagePrefixCache``
(shared refcounted pages) hold the reference's LRU, hit/miss and page
accounting operation for operation; the engines' streams with the cache
on equal the reference engine's exactly (f32 weights bridged with
``params_from_jax``, greedy and sampled requests, dense and paged, the
paged kernel read path with the admission lookahead), equal the same
engine's streams with the cache off, and count the same hits, misses and
saved tokens. The reference's admission scenarios (tests/
test_scheduler.py: the lookahead past a page-blocked head, the aging
bound, the protection of the head's own prefix from eviction) run in
lockstep through both engines and must observe the same state at every
step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_parity import bridged_params, jax_f32, torch_f32  # noqa: E402
from tpumon.loadgen import paged_kv as jax_kv  # noqa: E402
from tpumon.loadgen import prefix_cache as jax_pc  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch.loadgen import paged_kv, prefix_cache, serving  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig, params_from_jax  # noqa: E402

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=64, compute_dtype="float32")
PS = 8
SEED = 3
_rng = np.random.default_rng(31)
SYSTEM = [int(t) for t in _rng.integers(0, 128, 2 * PS)]  # two chunks
# Four prompts behind one shared two-chunk prefix (one of them exactly
# the prefix plus one token), a one-chunk-prefix sharer and two strangers.
PROMPTS = ([SYSTEM + [int(t) for t in _rng.integers(0, 128, n)]
            for n in (3, 11, 1, 7)]
           + [SYSTEM[:PS] + [5, 6, 7]]
           + [[int(t) for t in _rng.integers(0, 128, n)] for n in (9, 20)])
MAX_NEW = [6, 4, 9, 5, 7, 3, 8]
SAMPLING = [(0.0, 0), (0.8, 0), (0.0, 0), (0.8, 5), (0.0, 0), (0.8, 0),
            (0.0, 0)]

CONFIGS = {
    "dense": {},
    "paged-gather": {"kv_layout": "paged"},
    "paged-kernel-lookahead": {"kv_layout": "paged", "paged_attn": "kernel",
                               "admit_lookahead": 2, "decode_block": 4},
}


@pytest.fixture(scope="module")
def weights():
    return bridged_params(JaxModelConfig(**SMALL), seed=5)


def engines(weights, **kw):
    jcfg = jax_serving.ServeConfig(model=JaxModelConfig(**SMALL), slots=2,
                                   prefill_len=PS, **kw)
    tcfg = serving.ServeConfig(model=ModelConfig(**SMALL), slots=2,
                               prefill_len=PS, **kw)
    return (jax_serving.ServingEngine(cfg=jcfg, params=weights[0],
                                      seed=SEED),
            serving.ServingEngine(cfg=tcfg, params=params_from_jax(
                weights[1]), seed=SEED, device="cpu"))


def serve(engine, prompts=PROMPTS):
    reqs = [engine.submit(p, max_new=n, temperature=t, top_k=k)
            for p, n, (t, k) in zip(prompts, MAX_NEW, SAMPLING)]
    engine.drain()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("layout", list(CONFIGS))
def test_prefix_hit_streams_identical_to_reference(weights, layout):
    ref, eng = engines(weights, prefix_cache_entries=4, **CONFIGS[layout])
    want = serve(ref)
    assert serve(eng) == want
    jsnap, snap = ref._stats_snapshot(), eng._stats_snapshot()
    assert snap["prefix"] == jsnap["prefix"]
    assert snap["prefix"]["hits"] >= 2
    for key in ("steps", "tokens", "kv_pages_free"):
        assert snap[key] == jsnap[key], key


@pytest.mark.parametrize("layout", list(CONFIGS))
def test_prefix_hits_do_not_change_streams(weights, layout):
    """A hit restores (dense) or shares (paged) the rows a prefill wrote,
    so every stream equals the same engine's with the cache off."""
    _, cold = engines(weights, **CONFIGS[layout])
    _, hot = engines(weights, prefix_cache_entries=4, **CONFIGS[layout])
    assert serve(hot) == serve(cold)
    assert hot.prefix_cache.hits >= 2
    assert "tpumon_serving_prefix_hits" in hot.metrics_text()


def test_dense_restore_and_extract_match_reference(weights):
    """Store a slot's prefix, restore it into another slot: the port's
    cache rows equal the reference's, and the LRU bookkeeping (entries,
    resident bytes, hits, saved tokens) too."""
    import jax.numpy as jnp

    jcfg = jax_serving.ServeConfig(model=JaxModelConfig(**SMALL), slots=3,
                                   prefill_len=PS)
    tcfg = serving.ServeConfig(model=ModelConfig(**SMALL), slots=3,
                               prefill_len=PS)
    jparams, tparams = weights[0], params_from_jax(weights[1])
    jcache, tcache = jax_serving.init_cache(jcfg), serving.init_cache(
        tcfg, "cpu")
    prompt = PROMPTS[0]  # stores its 2-chunk strict prefix
    for c0 in range(0, len(prompt), PS):
        chunk = prompt[c0:c0 + PS]
        toks = np.zeros(PS, np.int32)
        toks[:len(chunk)] = chunk
        jcache, _ = jax_serving.prefill(
            jcfg, jparams, jcache, jnp.asarray(toks), jnp.int32(len(chunk)),
            jnp.int32(0), jnp.int32(c0))
        serving.prefill(tcfg, tparams, tcache, torch.from_numpy(toks),
                        len(chunk), 0, c0)
    jpc = jax_pc.PrefixCache(chunk=PS, max_entries=2)
    tpc = prefix_cache.PrefixCache(chunk=PS, max_entries=2)
    jpc.store(jcache, prompt, jnp.int32(0))
    tpc.store(tcache, prompt, 0)
    assert tpc.entries == jpc.entries == 1
    assert tpc.resident_bytes() == jpc.resident_bytes()
    for p in (PROMPTS[1], PROMPTS[4], PROMPTS[5]):
        assert tpc.peek(p) == jpc.peek(p)
        assert tpc.restore(tcache, p, 2) == jpc.restore(jcache, p,
                                                        jnp.int32(2))
    assert (tpc.hits, tpc.misses, tpc.saved_tokens) == (
        jpc.hits, jpc.misses, jpc.saved_tokens) == (1, 2, 2 * PS)
    for name in ("k", "v"):
        np.testing.assert_allclose(torch_f32(tcache[name]),
                                   jax_f32(jcache[name]), atol=1e-4,
                                   rtol=1e-4)
    # Rows 0..2*PS-1 of slot 2 are now slot 0's, bit for bit.
    assert torch.equal(tcache["k"][:, 2, :2 * PS], tcache["k"][:, 0, :2 * PS])
    # LRU eviction past max_entries frees the oldest entry's bytes.
    for p in (PROMPTS[5], PROMPTS[6]):
        jpc.store(jcache, p, jnp.int32(0))
        tpc.store(tcache, p, 0)
    assert tpc.entries == jpc.entries == 2
    assert tpc.resident_bytes() == jpc.resident_bytes()
    assert tpc.peek(prompt) == jpc.peek(prompt) == 0


def test_page_prefix_cache_accounting_matches_reference():
    """One script of stores, peeks, lookups, evictions and releases over
    both packages' allocator and page cache: every answer, refcount and
    free count equal."""
    ja, ta = jax_kv.PageAllocator(20), paged_kv.PageAllocator(20)
    jc = jax_kv.PagePrefixCache(chunk=4, allocator=ja, max_entries=2)
    tc = paged_kv.PagePrefixCache(chunk=4, allocator=ta, max_entries=2)
    jc.page_bytes = tc.page_bytes = 100
    prompts = [list(range(10)), list(range(10)) + [3], list(range(5)),
               [9] * 13, [1, 2, 3, 4, 5, 6, 7, 8, 9]]

    def both(fn):
        got = [fn(c, a) for c, a in ((jc, ja), (tc, ta))]
        assert got[0] == got[1]
        assert ja.free_pages == ta.free_pages and ja._refs == ta._refs
        assert (jc.hits, jc.misses, jc.saved_tokens, jc.entries) == (
            tc.hits, tc.misses, tc.saved_tokens, tc.entries)
        assert jc.resident_bytes() == tc.resident_bytes()
        return got[0]

    held = []
    for p in prompts:
        pages = both(lambda c, a, p=p: a.alloc(-(-len(p) // 4)))
        both(lambda c, a, p=p, pages=pages: c.store(p, pages))
        held.append(pages)
    for p in prompts:
        both(lambda c, a, p=p: c.peek(p))
        held.append(both(lambda c, a, p=p: c.lookup(p))[1])  # retained
    both(lambda c, a: c.evict_one(protect=tuple(range(8))))
    for pages in held:
        both(lambda c, a, pages=pages: a.release(pages))
    while both(lambda c, a: c.evict_one()):
        pass
    assert ta.free_pages == 20


class Lockstep:
    """The reference's admission scenarios (tests/test_scheduler.py
    TestLookaheadAdmission) driven through both engines at once: every
    call goes to both, and ``check`` compares what each observes."""

    PREFIX = [7, 1, 8, 2, 8, 1, 8, 2]  # one chunk at prefill_len=8
    MODEL = dict(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=128, max_seq=64, compute_dtype="float32")

    def __init__(self, lookahead=0, max_skips=8, pool_pages=12, slots=2):
        kw = dict(slots=slots, prefill_len=8, kv_layout="paged",
                  pool_pages=pool_pages, prefix_cache_entries=4,
                  scheduler="sequential", admit_lookahead=lookahead,
                  admit_max_skips=max_skips)
        jparams, tree = bridged_params(JaxModelConfig(**self.MODEL), seed=2)
        self.ref = jax_serving.ServingEngine(
            cfg=jax_serving.ServeConfig(model=JaxModelConfig(**self.MODEL),
                                        **kw), params=jparams)
        self.eng = serving.ServingEngine(
            cfg=serving.ServeConfig(model=ModelConfig(**self.MODEL), **kw),
            params=params_from_jax(tree), device="cpu")
        self.reqs = []  # (reference request, port request)

    def submit(self, prompt, max_new):
        self.reqs.append((self.ref.submit(prompt, max_new=max_new),
                          self.eng.submit(prompt, max_new=max_new)))
        return len(self.reqs) - 1

    def step(self, n=1):
        for _ in range(n):
            assert self.ref.step() == self.eng.step()
            self.check()

    def cancel(self, i):
        for r in self.reqs[i]:
            r.cancel()

    def drain(self):
        self.ref.drain()
        self.eng.drain()
        self.check()

    def check(self):
        for jr, tr in self.reqs:
            assert (jr.status, jr.output, jr.ttft_s is None) == (
                tr.status, tr.output, tr.ttft_s is None)
        ref, eng = self.ref, self.eng
        assert ref._head_skips == eng._head_skips
        assert ref.allocator.free_pages == eng.allocator.free_pages
        assert ref.allocator._refs == eng.allocator._refs
        jpc, tpc = ref.prefix_cache, eng.prefix_cache
        assert list(jpc._store.items()) == list(tpc._store.items())
        assert (jpc.hits, jpc.misses, jpc.saved_tokens) == (
            tpc.hits, tpc.misses, tpc.saved_tokens)

    def seed_prefix(self):
        self.submit(self.PREFIX + [3, 3], max_new=2)
        self.drain()

    def hog_and_head(self):
        hog = self.submit([(3 * i) % 97 for i in range(30)], max_new=40)
        self.step()
        head = self.submit([(11 * i + 1) % 97 for i in range(30)],
                           max_new=40)
        self.step()
        return hog, head


@pytest.mark.parametrize("lookahead,max_skips,n_cands", [
    (0, 8, 1),   # strict FIFO: the cached candidate waits behind the head
    (2, 8, 1),   # the candidate jumps the page-blocked head
    (4, 2, 5),   # the aging bound: two jumps, then the head is next
])
def test_lookahead_admission_in_lockstep(lookahead, max_skips, n_cands):
    ls = Lockstep(lookahead=lookahead, max_skips=max_skips)
    ls.seed_prefix()
    hog, head = ls.hog_and_head()
    cands = [ls.submit(Lockstep.PREFIX + [9, i], max_new=1)
             for i in range(n_cands)]
    ls.step(8)
    served = sum(ls.reqs[c][1].done.is_set() for c in cands)
    assert served == {0: 0, 2: 1, 4: 2}[lookahead]
    ls.cancel(hog)
    ls.drain()
    assert ls.reqs[head][1].done.is_set()


def test_head_eviction_spares_its_own_prefix_in_lockstep():
    ls = Lockstep(pool_pages=10, slots=2)
    ls.seed_prefix()  # the PREFIX entry, LRU-first
    ls.submit([9] * 8 + [1, 1], max_new=2)  # a second entry
    ls.drain()
    filler = ls.submit([(3 * i) % 97 for i in range(20)], max_new=36)
    ls.step()
    assert ls.eng.allocator.free_pages == 0
    hits0 = ls.eng.prefix_cache.hits
    head = ls.submit(Lockstep.PREFIX + [5] * 4, max_new=2)
    ls.step()
    assert ls.reqs[head][1].ttft_s is not None
    assert ls.eng.prefix_cache.hits == hits0 + 1
    assert tuple(Lockstep.PREFIX) in ls.eng.prefix_cache._store
    ls.cancel(filler)
    ls.drain()


def test_prefix_hit_len_and_peek_have_no_side_effects(weights):
    def trace(pc):
        return (pc.hits, pc.misses, pc.saved_tokens, list(pc._store))

    for kw in ({}, {"kv_layout": "paged"}):
        ref, eng = engines(weights, prefix_cache_entries=4, **kw)
        serve(ref, PROMPTS[:1])
        serve(eng, PROMPTS[:1])
        before = trace(eng.prefix_cache)
        for p in PROMPTS:
            assert eng.prefix_hit_len(p) == ref.prefix_hit_len(p)
        assert trace(eng.prefix_cache) == before
        assert eng.prefix_hit_len(PROMPTS[2]) == 2 * PS
    _, plain = engines(weights)
    assert plain.prefix_hit_len(PROMPTS[0]) == 0
