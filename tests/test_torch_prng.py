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
