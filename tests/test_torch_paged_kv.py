"""The port's paged prefill/decode against the JAX reference.

Same weights (``params_from_jax``), same tokens, same page ids: each
prefill chunk's logits and each decode step's logits must agree within
1e-4 (f32; the two frameworks sum in different orders), and so must
every page of the resulting pools. Both decode read paths are covered:
``gather`` and ``kernel`` (on the CPU the port's kernel wrapper runs its
plain version; the reference runs its Pallas kernel in interpret mode),
for the single step, the multi-token block and the fused rounds.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import bridged_params, jax_f32, torch_f32  # noqa: E402
from tpumon.loadgen import paged_kv as jax_kv  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon.loadgen.serving import ServeConfig as JaxServeConfig  # noqa: E402
from tpumon_torch import prng  # noqa: E402
from tpumon_torch.loadgen import paged_kv  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig, params_from_jax  # noqa: E402
from tpumon_torch.loadgen.serving import ServeConfig  # noqa: E402

SMALL = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=64, compute_dtype="float32")
PS = 8
SLOTS = 3
MAX_PAGES = SMALL["max_seq"] // PS
NUM_PAGES = SLOTS * MAX_PAGES + 1
TOL = dict(atol=1e-4, rtol=1e-4)


def configs(paged_attn):
    jcfg = JaxServeConfig(model=JaxModelConfig(**SMALL), slots=SLOTS,
                          prefill_len=PS, kv_layout="paged",
                          paged_attn=paged_attn)
    tcfg = ServeConfig(model=ModelConfig(**SMALL), slots=SLOTS,
                       prefill_len=PS, kv_layout="paged",
                       paged_attn=paged_attn)
    return jcfg, tcfg


def assert_pools_match(jpool, tpool):
    for name in ("k", "v"):
        np.testing.assert_allclose(torch_f32(tpool[name]),
                                   jax_f32(jpool[name]), **TOL)


class Pair:
    """One reference pool and one port pool driven in lockstep."""

    def __init__(self, paged_attn):
        self.jcfg, self.tcfg = configs(paged_attn)
        self.jparams, tree = bridged_params(self.jcfg.model, seed=7)
        self.tparams = params_from_jax(tree)
        self.jpool = jax_kv.init_pool(self.jcfg, NUM_PAGES)
        self.tpool = paged_kv.init_pool(self.tcfg, NUM_PAGES, "cpu")

    def prefill(self, prompt, pages):
        """Chunked prefill of ``prompt`` into ``pages`` on both sides;
        returns each chunk's (reference, port) logits."""
        row = np.zeros(MAX_PAGES, np.int32)
        row[:len(pages)] = pages
        out = []
        for ci, c0 in enumerate(range(0, len(prompt), PS)):
            chunk = prompt[c0:c0 + PS]
            toks = np.zeros(PS, np.int32)
            toks[:len(chunk)] = chunk
            self.jpool, jl = jax_kv.paged_prefill(
                self.jcfg, self.jparams, self.jpool, jnp.asarray(toks),
                jnp.int32(len(chunk)), jnp.int32(pages[ci]),
                jnp.asarray(row), jnp.int32(c0))
            tl = paged_kv.paged_prefill(
                self.tcfg, self.tparams, self.tpool, torch.from_numpy(toks),
                len(chunk), pages[ci], torch.from_numpy(row), c0)
            out.append((jax_f32(jl), torch_f32(tl)))
        return out

    def decode(self, last, positions, tables):
        self.jpool, jl = jax_kv.paged_decode_step(
            self.jcfg, self.jparams, self.jpool,
            jnp.asarray(last, jnp.int32), jnp.asarray(positions, jnp.int32),
            jnp.asarray(tables, jnp.int32))
        tl = paged_kv.paged_decode_step(
            self.tcfg, self.tparams, self.tpool,
            torch.tensor(last, dtype=torch.int32),
            torch.tensor(positions, dtype=torch.int32),
            torch.tensor(tables, dtype=torch.int32))
        return jax_f32(jl), torch_f32(tl)


PROMPT_A = [int(t) for t in np.random.default_rng(1).integers(0, 128, 19)]
PROMPT_B = [5, 9, 2, 6, 5]
PAGES_A = [5, 9, 2]  # shuffled page ids: the table, not the order, rules
PAGES_B = [7]


def test_prefill_logits_and_pages_match():
    pair = Pair("gather")
    for jl, tl in pair.prefill(PROMPT_A, PAGES_A):
        np.testing.assert_allclose(tl, jl, **TOL)
    assert_pools_match(pair.jpool, pair.tpool)


@pytest.mark.parametrize("paged_attn", ["gather", "kernel"])
def test_decode_steps_match(paged_attn):
    """Two live slots at unequal lengths plus one parked slot (position
    max_seq-1, table all trash page 0, as the engine parks free and
    mid-prefill slots): logits and every pool page agree step by step."""
    pair = Pair(paged_attn)
    pair.prefill(PROMPT_A, PAGES_A)
    pair.prefill(PROMPT_B, PAGES_B)
    tables = np.zeros((SLOTS, MAX_PAGES), np.int32)
    tables[0, :3] = PAGES_A
    tables[2, :1] = PAGES_B
    positions = [len(PROMPT_A), SMALL["max_seq"] - 1, len(PROMPT_B)]
    last = [11, 0, 42]
    for _ in range(4):
        jl, tl = pair.decode(last, positions, tables)
        live = [0, 2]
        np.testing.assert_allclose(tl[live], jl[live], **TOL)
        assert_pools_match(pair.jpool, pair.tpool)
        last = [int(t) for t in jl.argmax(-1)]
        positions = [positions[0] + 1, positions[1], positions[2] + 1]


def test_decode_scatter_keeps_batch_first_when_slots_equal_kv_heads():
    """slots == n_kv_heads: a transposed scatter value would broadcast
    silently (the reference's paged_kv comment); the pools must still
    match page for page."""
    small = dict(SMALL, n_kv_heads=2)
    jcfg = JaxServeConfig(model=JaxModelConfig(**small), slots=2,
                          prefill_len=PS, kv_layout="paged")
    tcfg = ServeConfig(model=ModelConfig(**small), slots=2, prefill_len=PS,
                       kv_layout="paged", paged_attn="gather")
    jparams, tree = bridged_params(jcfg.model, seed=3)
    tparams = params_from_jax(tree)
    jpool = jax_kv.init_pool(jcfg, 9)
    tpool = paged_kv.init_pool(tcfg, 9, "cpu")
    tables = np.array([[3, 0, 0, 0, 0, 0, 0, 0],
                       [6, 1, 0, 0, 0, 0, 0, 0]], np.int32)
    positions = np.array([2, 11], np.int32)
    last = np.array([4, 8], np.int32)
    jpool, jl = jax_kv.paged_decode_step(
        jcfg, jparams, jpool, jnp.asarray(last), jnp.asarray(positions),
        jnp.asarray(tables))
    tl = paged_kv.paged_decode_step(
        tcfg, tparams, tpool, torch.from_numpy(last),
        torch.from_numpy(positions), torch.from_numpy(tables))
    np.testing.assert_allclose(torch_f32(tl), jax_f32(jl), **TOL)
    assert_pools_match(jpool, tpool)
    # The new rows landed at (page, offset) = (3, 2) and (1, 3) only.
    written = torch.nonzero(tpool["k"][0].abs().sum(-1))
    assert sorted({(int(p), int(o)) for _, p, o in written}) == [(1, 3), (3, 2)]


def test_not_ported_read_paths_raise():
    _, tcfg = configs("gather")
    pool = paged_kv.init_pool(tcfg, NUM_PAGES, "cpu")
    with pytest.raises(NotImplementedError):
        paged_kv.paged_decode_step(
            dataclasses.replace(tcfg, paged_attn="ring"), {}, pool,
            torch.zeros(SLOTS, dtype=torch.int32),
            torch.zeros(SLOTS, dtype=torch.int32),
            torch.zeros((SLOTS, MAX_PAGES), dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        paged_kv.init_pool(dataclasses.replace(tcfg, kv_dtype="int8"),
                           NUM_PAGES, "cpu")


def test_page_allocator_order_matches_reference():
    """Page ids decide which pool pages both engines touch: the port's
    allocator hands out, retains and frees exactly as the reference's."""
    ja, ta = jax_kv.PageAllocator(10), paged_kv.PageAllocator(10)
    script = [("alloc", 3), ("alloc", 2), ("release", 0), ("alloc", 4),
              ("retain", 1), ("release", 1), ("release", 1), ("alloc", 5),
              ("alloc", 9)]
    held = {"j": [], "t": []}
    for op, arg in script:
        for key, a in (("j", ja), ("t", ta)):
            if op == "alloc":
                held[key].append(a.alloc(arg))
            elif op == "retain":
                a.retain(held[key][arg])
            else:
                a.release(held[key][arg])
        assert held["j"] == held["t"]
        assert ja.free_pages == ta.free_pages


def setup_two_live_slots(pair):
    """PROMPT_A in pages 5, 9, 2 (slot 0), PROMPT_B in page 7 (slot 2),
    slot 1 parked on the trash page; returns the tables."""
    pair.prefill(PROMPT_A, PAGES_A)
    pair.prefill(PROMPT_B, PAGES_B)
    tables = np.zeros((SLOTS, MAX_PAGES), np.int32)
    tables[0, :3] = PAGES_A
    tables[0, 3] = 11  # slot 0's next page: its block crosses into it
    tables[2, :1] = PAGES_B
    tables[2, 1] = 4
    return tables


def assert_live_pages_match(jpool, tpool, pages):
    for name in ("k", "v"):
        np.testing.assert_allclose(torch_f32(tpool[name][:, :, pages]),
                                   jax_f32(jpool[name][:, :, pages]), **TOL)


@pytest.mark.parametrize("t_blk", [1, 3, 6])
def test_paged_decode_block_matches(t_blk):
    """T tokens a slot, each scattered to its own (page, offset): slot 0
    at row 19 crosses from page 2 into page 11 at T = 6, slot 2 from page
    7 into page 4. Logits and every written page agree."""
    pair = Pair("gather")
    tables = setup_two_live_slots(pair)
    tokens = np.random.default_rng(t_blk).integers(0, 128, (SLOTS, t_blk))
    positions = np.array([len(PROMPT_A) + 2, SMALL["max_seq"] - 1,
                          len(PROMPT_B) + 1], np.int32)
    pair.jpool, jl = jax_kv.paged_decode_block(
        pair.jcfg, pair.jparams, pair.jpool, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(positions), jnp.asarray(tables))
    tl = paged_kv.paged_decode_block(
        pair.tcfg, pair.tparams, pair.tpool,
        torch.tensor(tokens, dtype=torch.int32), torch.from_numpy(positions),
        torch.from_numpy(tables))
    assert tl.shape == (SLOTS, t_blk, SMALL["vocab"])
    np.testing.assert_allclose(torch_f32(tl)[[0, 2]], jax_f32(jl)[[0, 2]],
                               **TOL)
    assert_live_pages_match(pair.jpool, pair.tpool, PAGES_A + [11, 7, 4])


def test_paged_decode_block_of_one_is_the_step():
    pair = Pair("gather")
    tables = torch.from_numpy(setup_two_live_slots(pair))
    last = torch.tensor([3, 0, 8], dtype=torch.int32)
    pos = torch.tensor([19, 63, 5], dtype=torch.int32)
    pool = {k: v.clone() for k, v in pair.tpool.items()}
    step = paged_kv.paged_decode_step(pair.tcfg, pair.tparams, pair.tpool,
                                      last, pos, tables)
    blk = paged_kv.paged_decode_block(pair.tcfg, pair.tparams, pool,
                                      last[:, None], pos, tables)
    torch.testing.assert_close(step, blk[:, 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("paged_attn", ["gather", "kernel"])
@pytest.mark.parametrize("sampled", [False, True])
def test_paged_decode_rounds_matches(paged_attn, sampled):
    """Six fused steps over loop-invariant tables (slot 0 crosses into
    page 11 on the way): the same tokens, positions and written pages as
    the reference's scan, greedy or with temperature/top-k rows."""
    pair = Pair(paged_attn)
    tables = setup_two_live_slots(pair)
    last = np.array([11, 0, 42], np.int32)
    positions = np.array([len(PROMPT_A) + 3, SMALL["max_seq"] - 1,
                          len(PROMPT_B)], np.int32)
    rids = np.array([3, 0, 8], np.int32)
    ctr0 = np.array([2, 0, 1], np.int32)
    temps = np.array([0.8, 0.0, 1.3] if sampled else [0.0] * 3, np.float32)
    topks = np.array([5, 0, 0], np.int32)
    pair.jpool, jlast, jpos, jtoks = jax_kv.paged_decode_rounds(
        pair.jcfg, pair.jparams, pair.jpool, jnp.asarray(last),
        jnp.asarray(positions), jnp.asarray(tables),
        jax.random.PRNGKey(0x7A11), jnp.asarray(rids), jnp.asarray(ctr0),
        jnp.asarray(temps), jnp.asarray(topks), steps=6)
    tlast, tpos, ttoks = paged_kv.paged_decode_rounds(
        pair.tcfg, pair.tparams, pair.tpool, torch.from_numpy(last),
        torch.from_numpy(positions), torch.from_numpy(tables),
        prng.torch_key(0x7A11, "cpu"), torch.from_numpy(rids),
        torch.from_numpy(ctr0),
        torch.from_numpy(temps),
        torch.from_numpy(topks), steps=6)
    live = [0, 2]
    assert np.array_equal(ttoks.numpy()[live], np.asarray(jtoks)[live])
    assert np.array_equal(tlast.numpy()[live], np.asarray(jlast)[live])
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    assert_live_pages_match(pair.jpool, pair.tpool, PAGES_A + [11, 7])


def test_paged_decode_rounds_kernel_route_counts_nothing_on_the_cpu():
    from tpumon_torch.ops.paged_attention import paged_attention

    pair = Pair("kernel")
    tables = torch.from_numpy(setup_two_live_slots(pair))
    before = paged_attention.launches
    paged_kv.paged_decode_rounds(
        pair.tcfg, pair.tparams, pair.tpool,
        torch.tensor([1, 2, 3], dtype=torch.int32),
        torch.tensor([19, 63, 5], dtype=torch.int32), tables,
        prng.torch_key(0, "cpu"), torch.zeros(3, dtype=torch.int32),
        torch.zeros(3, dtype=torch.int32), torch.zeros(3),
        torch.zeros(3, dtype=torch.int32), steps=2)
    assert paged_attention.launches == before
