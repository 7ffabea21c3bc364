"""The port's threefry (tpumon_torch/prng.py) against jax.random.

Every draw is compared bit for bit on the CPU, under the repo's JAX
configuration (threefry2x32, partitionable): keys, fold_in, split,
32-bit random bits, randint, and the trainer's synthetic batch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpumon.loadgen import model as jax_model  # noqa: E402
from tpumon.loadgen import train as jax_train  # noqa: E402
from tpumon_torch import prng  # noqa: E402
from tpumon_torch.loadgen import model, train  # noqa: E402

SEEDS = (0, 1, 42, 0x5EED, 2**31 - 1, 2**31 + 5, 2**32 + 7, -3)


def test_the_repo_runs_partitionable_threefry():
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_prngkey(seed):
    assert np.array_equal(prng.key(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 2**31 + 3, 2**32 - 1])
def test_fold_in(seed, data):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    assert np.array_equal(prng.fold_in(prng.key(seed), data), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", [1, 2, 5, 64])
def test_split(seed, n):
    want = jax.random.split(jax.random.PRNGKey(seed), n)
    got = prng.split(prng.key(seed), n)
    assert got.dtype == np.uint32 and np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (8, 1024)])
def test_random_bits(shape):
    k = jax.random.fold_in(jax.random.PRNGKey(9), 3)
    want = jax.random.bits(k, shape, jnp.uint32)
    got = prng.random_bits(prng.fold_in(prng.key(9), 3), shape)
    assert got.shape == shape and np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 5, 2**32 + 7])
@pytest.mark.parametrize("shape,lo,hi", [
    ((3, 16), 0, 97),
    ((8, 1024), 0, 4096),
    ((5, 33), 0, 32000),
    ((4, 4), 0, 2**20),
    ((6,), -50, 50),
    ((9,), 0, 1),
])
def test_randint(seed, shape, lo, hi):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    want = jax.random.randint(k, shape, lo, hi, dtype=jnp.int32)
    got = prng.randint(prng.fold_in(prng.key(seed), 2), shape, lo, hi)
    assert got.dtype == np.int32 and np.array_equal(got, np.asarray(want))


def test_randint_rejects_empty_or_wide_bounds():
    for lo, hi in ((5, 5), (6, 5), (0, 2**31)):
        with pytest.raises(ValueError):
            prng.randint(prng.key(0), (2,), lo, hi)


@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (0, 0, 2, 8, 97),
    (4, 5, 3, 16, 128),
    (7, 123, 1, 33, 32000),
    (2**31 + 5, 2, 2, 5, 4096),
    (0, 3, 8, 1024, 4096),  # the production batch
])
def test_synthetic_batch_is_the_references(seed, step, batch, seq, vocab):
    small = dict(d_model=64, n_layers=1, n_heads=4, n_kv_heads=4, d_ff=128,
                 max_seq=1024, compute_dtype="float32")
    want = jax_train.synthetic_batch(jax_train.TrainConfig(
        model=jax_model.ModelConfig(vocab=vocab, **small), batch=batch,
        seq=seq, seed=seed), step)
    got = train.synthetic_batch(train.TrainConfig(
        model=model.ModelConfig(vocab=vocab, **small), batch=batch, seq=seq,
        seed=seed), step)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_fused_bench_draws_the_references_scan_keys():
    """fused_train_bench's step keys are the reference scan's:
    split(PRNGKey(2), steps), and partitionable split keys are fold_in's."""
    want = jax.random.split(jax.random.PRNGKey(2), 4)
    assert np.array_equal(prng.split(prng.key(2), 4), np.asarray(want))
    for i in range(4):
        assert np.array_equal(prng.fold_in(prng.key(2), i), np.asarray(want[i]))


# ---------------------------------------------------------------------------
# The torch twins (tpumon_torch/prng.py's device-tensor draws), held to
# jax.random on the CPU: bits, keys, uniforms, randint and permutation bit
# for bit; gumbel and normal against XLA's own float32 log, log1p and
# erf_inv, which the port copies (its FMAs as one float64 product and
# sum): every gumbel draw is equal, and every normal draw outside erf_inv's
# w >= 5 branch (|u| > 0.9966, about 0.4% of draws), whose sqrt XLA's CPU
# computes approximately (0.65% of its results 1 ulp off the rounded
# sqrt), and there within 2 ulp: about 99.998% of float32 draws are equal.
# ---------------------------------------------------------------------------


def _tkey(seed):
    return prng.torch_key(seed, "cpu")


def _ulps(got: torch.Tensor, want) -> np.ndarray:
    """|got - want| in units in the last place of got's dtype."""
    itype = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    w = torch.from_numpy(np.array(want, np.float32)).to(got.dtype)
    return (got.view(itype).long() - w.view(itype).long()).abs().numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_key_fold_in_split_match(seed):
    jk = jax.random.PRNGKey(seed)
    tk = _tkey(seed)
    assert tk.dtype == torch.int64
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    for data in (0, 1, 7, 2**31 + 3, 2**32 - 1):
        assert np.array_equal(prng.torch_fold_in(tk, data).numpy(),
                              np.asarray(jax.random.fold_in(jk, data)))
    for n in (1, 2, 5, 64):
        assert np.array_equal(prng.torch_split(tk, n).numpy(),
                              np.asarray(jax.random.split(jk, n)))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_torch_fold_in_over_int32_tensors(seed):
    """Request ids and token counters arrive as int32 tensors (negative
    ones too): each element folds in as jax folds it, mod 2**32; a batch
    of keys folds a batch of data, row by row, as vmap does."""
    ids = np.array([0, 1, 5, 2**31 - 1, -1, -7], np.int32)
    ctrs = np.array([0, 3, 1, 9, 2**20, 4], np.int32)
    base = jax.random.PRNGKey(seed)
    want = jax.vmap(lambda r, c: jax.random.fold_in(
        jax.random.fold_in(base, r), c))(jnp.asarray(ids), jnp.asarray(ctrs))
    got = prng.torch_fold_in(
        prng.torch_fold_in(_tkey(seed), torch.from_numpy(ids)),
        torch.from_numpy(ctrs))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4), (8, 1024)])
def test_torch_random_bits(shape):
    k = jax.random.fold_in(jax.random.PRNGKey(9), 3)
    want = jax.random.bits(k, shape, jnp.uint32)
    got = prng.torch_random_bits(prng.torch_fold_in(_tkey(9), 3), shape)
    assert got.shape == shape and np.array_equal(got.numpy(), np.asarray(want))
    # And the numpy version's, from which the trainer draws.
    assert np.array_equal(got.numpy(), prng.random_bits(
        prng.fold_in(prng.key(9), 3), shape))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 6.0), (0.5, 0.75)])
def test_torch_uniform(seed, dtype, lo, hi):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.random.uniform(jax.random.PRNGKey(seed), (4, 257), jdt, lo, hi)
    got = prng.uniform(_tkey(seed), (4, 257), dtype, lo, hi)
    assert got.dtype == dtype
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 5, 2**32 + 7])
@pytest.mark.parametrize("shape,lo,hi,dtype", [
    ((3, 16), 0, 97, torch.int32),
    ((8, 1024), 0, 4096, torch.int32),
    ((5, 33), 0, 100_000, torch.int32),  # a span over 2**16
    ((4, 4), 0, 2**20, torch.int32),
    ((6,), -50, 50, torch.int32),
    ((9,), 0, 1, torch.int32),
    ((64, 64), -127, 128, torch.int8),  # the int8 burn's weights
    ((40,), -300, 300, torch.int8),  # bounds clipped to the type
    ((40,), -5, 2000, torch.int16),
])
def test_torch_randint(seed, shape, lo, hi, dtype):
    jdt = {torch.int32: jnp.int32, torch.int16: jnp.int16,
           torch.int8: jnp.int8}[dtype]
    k = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    want = jax.random.randint(k, shape, lo, hi, dtype=jdt)
    got = prng.torch_randint(prng.torch_fold_in(_tkey(seed), 2), shape, lo,
                             hi, dtype)
    assert got.dtype == dtype
    assert np.array_equal(got.numpy(), np.asarray(want))
    if dtype == torch.int32:
        assert np.array_equal(got.numpy(), prng.randint(
            prng.fold_in(prng.key(seed), 2), shape, lo, hi))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", [1, 7, 513, 2000])  # 2000: two rounds
def test_torch_permutation(seed, n):
    want = jax.random.permutation(jax.random.PRNGKey(seed), n)
    got = prng.permutation(_tkey(seed), n)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_permutation_round_counts_are_jaxs():
    rounds = [int(np.ceil(3 * np.log(n) / np.log(2**32 - 1)))
              for n in (7, 513, 2000)]
    assert rounds == [1, 1, 2]


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_torch_gumbel(seed):
    """Gumbel is -log(-log(u)) under XLA's own log, which the port copies:
    every draw equal (4 ulp allowed: the share equal is asserted too)."""
    want = jax.random.gumbel(jax.random.PRNGKey(seed), (64, 1024))
    got = prng.gumbel(_tkey(seed), (64, 1024))
    d = _ulps(got, want)
    assert d.max() <= 4 and (d == 0).mean() == 1.0


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_torch_normal_bf16(seed):
    """bfloat16 normals (the burns' inputs): every draw equal."""
    want = jax.random.normal(jax.random.PRNGKey(seed), (256, 1024),
                             jnp.bfloat16)
    got = prng.normal(_tkey(seed), (256, 1024), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert (_ulps(got, want.astype(jnp.float32)) == 0).all()


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_torch_normal_f32(seed):
    """float32 normals: every draw equal, the tail (erf_inv's w >= 5,
    through its sqrt) included."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (256, 1024)))
    got = prng.normal(_tkey(seed), (256, 1024))
    assert (np.abs(want) >= 2.1).any()  # the tail is drawn
    assert (_ulps(got, want) == 0).all()


def test_xla_log_copy_matches_xla_over_every_exponent():
    rng = np.random.default_rng(0)
    x = np.exp(rng.uniform(-87.0, 88.0, 200_000)).astype(np.float32)
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    assert np.array_equal(prng._xla_log(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_torch_categorical(seed):
    """Per-row keys over [B, V] logits, as sample_tokens draws them."""
    logits = np.random.default_rng(seed & 0xFFFF).standard_normal(
        (6, 300)).astype(np.float32) * 3
    keys = jax.random.split(jax.random.PRNGKey(seed), 6)
    want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits))
    got = prng.categorical(prng.torch_split(_tkey(seed), 6),
                           torch.from_numpy(logits))
    assert np.array_equal(got.numpy(), np.asarray(want))
