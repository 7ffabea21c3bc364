"""The port's ring engine mode against the JAX reference.

``paged_ring_decode_attend`` (the page-at-a-time online-softmax read of
``paged_attn="ring"``) against the reference's on one pool, f32 within
1e-5 relative, with the per-row ``[B]`` ``q_off`` form of
``_block_attend`` it stands on; the int8-pool rejection; and the three
cases of ``tests/test_scheduler.py::TestRingAdmission`` on the
reference's weights: a prompt past max_seq is refused flat and admitted
with ``ring_stripes=2``, and its stream (greedy and seeded, gather and
ring reads) equals the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import bridged_params, paged_case  # noqa: E402
from tpumon.loadgen import ring_attention as jax_ring  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch.loadgen import paged_kv, ring_attention  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig, params_from_jax  # noqa: E402
from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine  # noqa: E402

# tests/test_scheduler.py's MODEL and TestRingAdmission's prompt.
MODEL = dict(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=96, compute_dtype="float32")
LONG = [(7 * i + 3) % 97 for i in range(MODEL["max_seq"] + 20)]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("nh,nkv,positions", [
    (4, 2, (4, 16, 31)),   # GQA 2, a frontier on a page's first row
    (4, 4, (0, 7, 8)),     # no GQA, the first row alone
    (8, 1, (31, 20, 9)),   # one kv head
])
def test_paged_ring_decode_attend_matches_reference(nh, nkv, positions):
    q, kp, vp, table, _ = paged_case(b=3, nh=nh, nkv=nkv, hd=16,
                                     lengths=tuple(p + 1 for p in positions),
                                     seed=nh + nkv)
    q = q[:, None]  # [B, 1, nh, hd]
    pos = np.asarray(positions, np.int32)
    want = jax_ring.paged_ring_decode_attend(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(q), jnp.asarray(table),
        jnp.asarray(pos))
    got = ring_attention.paged_ring_decode_attend(
        torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(q),
        torch.from_numpy(table), torch.from_numpy(pos))
    assert tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) < 1e-5


def test_block_attend_per_row_offsets_match_reference():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 1, 2, 8), np.float32)
    k = rng.standard_normal((3, 8, 2, 8), np.float32)
    v = rng.standard_normal((3, 8, 2, 8), np.float32)
    q_off = np.array([3, 8, 20], np.int32)  # row 2 sees every key
    m0 = np.full((3, 2, 1), -np.inf, np.float32)
    l0 = np.zeros((3, 2, 1), np.float32)
    o0 = np.zeros((3, 1, 2, 8), np.float32)
    want = jax_ring._block_attend(*(jnp.asarray(a) for a in (
        q, k, v, q_off)), 8, 0.25, True, *(jnp.asarray(a)
                                         for a in (m0, l0, o0)))
    got = ring_attention._block_attend(*(torch.from_numpy(a) for a in (
        q, k, v, q_off)), 8, 0.25, True, *(torch.from_numpy(a)
                                           for a in (m0, l0, o0)))
    # Row 0 (frontier 3 < key offset 8) is fully masked: m stays -inf.
    assert bool(torch.isneginf(got[0][0]).all())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_ring_read_rejects_an_int8_pool():
    cfg = ServeConfig(model=ModelConfig(**MODEL), slots=2, prefill_len=8,
                      kv_layout="paged", kv_dtype="int8", paged_attn="ring")
    pool = paged_kv.init_pool(cfg, 8, "cpu")
    zeros = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="quantized"):
        paged_kv.paged_decode_step(cfg, {}, pool, zeros, zeros,
                                   torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="ring"):
        ServingEngine(cfg, device="cpu")


class TestRingAdmission:
    """The admission boundary moves from max_seq to stripes × max_seq, and
    the admitted stream equals the reference's: its ring engine's, and
    its flat engine of max_seq 2 × 96, which holds the context flat."""

    @pytest.fixture(scope="class")
    def tree(self):
        return bridged_params(JaxModelConfig(**MODEL), seed=5)[1]

    @staticmethod
    def base(**over):
        return ServeConfig(model=ModelConfig(**MODEL), slots=2,
                           prefill_len=8, kv_layout="paged", **over)

    @staticmethod
    def reference(temperature=0.0, top_k=0, **over):
        """The reference's ring engine and its wide flat engine."""
        base = jax_serving.ServeConfig(model=JaxModelConfig(**MODEL),
                                       slots=2, prefill_len=8,
                                       kv_layout="paged")
        out = []
        for cfg in (dataclasses.replace(base, ring_stripes=2, **over),
                    dataclasses.replace(base, model=JaxModelConfig(
                        **dict(MODEL, max_seq=2 * MODEL["max_seq"])))):
            eng = jax_serving.ServingEngine(cfg, seed=5)
            r = eng.submit(LONG, max_new=4, temperature=temperature,
                           top_k=top_k)
            eng.drain()
            out.append(r.output)
        assert out[0] == out[1]
        return out[0]

    def ring(self, tree, temperature=0.0, top_k=0, **over):
        eng = ServingEngine(self.base(ring_stripes=2, **over),
                            params=params_from_jax(tree), seed=5,
                            device="cpu")
        assert eng._seq_cap == 2 * MODEL["max_seq"]
        assert eng._tables_dev.shape[1] == 2 * MODEL["max_seq"] // 8
        r = eng.submit(LONG, max_new=4, temperature=temperature,
                       top_k=top_k)
        eng.drain()
        assert r.status == "completed"
        return r.output

    def test_flat_refuses_ring_admits_same_stream(self, tree):
        flat = ServingEngine(self.base(), params=params_from_jax(tree),
                             seed=5, device="cpu")
        r = flat.submit(LONG, max_new=4)
        assert r.status == "rejected" and r.output == []
        assert self.ring(tree) == self.reference()

    def test_ring_seeded_stream_matches_reference(self, tree):
        assert self.ring(tree, temperature=1.0, top_k=8) == self.reference(
            temperature=1.0, top_k=8)

    def test_blockwise_ring_attend_matches_reference(self, tree):
        """paged_attn="ring" reads the pages through the online-softmax
        accumulator; greedy picks the reference's tokens (the
        accumulation reassociates: argmax agreement, not bitwise
        logits)."""
        assert self.ring(tree, paged_attn="ring") == self.reference(
            paged_attn="ring")
