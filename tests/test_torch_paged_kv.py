"""The port's paged prefill/decode against the JAX reference.

Same weights (``params_from_jax``), same tokens, same page ids: each
prefill chunk's logits and each decode step's logits must agree within
1e-4 (f32; the two frameworks sum in different orders), and so must
every page of the resulting pools. Both decode read paths are covered:
``gather`` and ``kernel`` (on the CPU the port's kernel wrapper runs its
plain version; the reference runs its Pallas kernel in interpret mode).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import bridged_params, jax_f32, torch_f32  # noqa: E402
from tpumon.loadgen import paged_kv as jax_kv  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon.loadgen.serving import ServeConfig as JaxServeConfig  # noqa: E402
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
                       prefill_len=PS, paged_attn=paged_attn)
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
                       paged_attn="gather")
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
