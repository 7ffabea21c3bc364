"""The port's induction trainer against the reference's.

``train.Adam`` makes ``optax.adam``'s update on the same gradients
(within 1e-6 relative, f32); ``induction_batches`` are the reference's
batches bit for bit (``randint`` under ``split(PRNGKey(seed ^ 0xC0FFEE),
steps)``, tiled); ``train_induction`` on bridged f32 weights follows the
reference's first 20 losses within 1e-4 relative, and at the reference
test's size it learns to copy (last loss < 1.0 after 700 steps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import bridged_params  # noqa: E402
from tpumon.loadgen import model as jax_model  # noqa: E402
from tpumon.loadgen import train as jax_train  # noqa: E402
from tpumon_torch.loadgen import model, train  # noqa: E402

# tests/test_train.py::test_train_induction_learns_copying's model.
SMALL = dict(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=128, compute_dtype="float32")


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("lr", [1e-3, 3e-2])
def test_adam_updates_are_optax_adams(lr):
    """Three updates on the same gradients (each step's own draw, with
    zeros and tiny values among them), from optax's init."""
    rng = np.random.default_rng(0)
    shapes = [(16, 8), (8,), (3, 4, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = optax.adam(lr)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    adam = train.Adam(tp, lr)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        grads[0][0] = 0.0
        grads[1][:4] *= 1e-9
        updates, state = opt.update([jnp.asarray(g) for g in grads], state)
        jp = optax.apply_updates(jp, updates)
        adam.step(tp, [torch.from_numpy(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)
    assert adam.count == 3 and int(state[0].count) == 3


@pytest.mark.parametrize("steps,period,seq,batch,seed", [
    (4, 16, 256, 16, 0), (3, 8, 20, 3, 5), (2, 5, 5, 2, 7)])
def test_batches_are_the_references(steps, period, seq, batch, seed):
    cfg = jax_model.ModelConfig(**SMALL)
    reps = -(-seq // period)
    want = [np.asarray(jnp.tile(jax.random.randint(
        k, (batch, period), 1, cfg.vocab, jnp.int32), (1, reps))[:, :seq])
        for k in jax.random.split(jax.random.PRNGKey(seed ^ 0xC0FFEE),
                                  steps)]
    got = train.induction_batches(model.ModelConfig(**SMALL), steps, period,
                                  seq, batch, seed, "cpu")
    assert got.dtype == torch.int32 and got.shape == (steps, batch, seq)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_first_losses_follow_the_reference():
    """20 Adam steps from the same (bridged) init on the same batches."""
    cfg = jax_model.ModelConfig(**SMALL)
    _, tree = bridged_params(cfg, seed=3)
    _, want = jax_train.train_induction(cfg, steps=20, period=8, seq=64,
                                        batch=4, seed=3)
    params, got = train.train_induction(
        model.ModelConfig(**SMALL), steps=20, period=8, seq=64, batch=4,
        seed=3, device="cpu", params=model.params_from_jax(tree))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert params["lm_head"].dtype == torch.float32


def test_train_induction_learns_copying():
    """The reference's test at its size: 700 Adam steps land near the
    irreducible first-period entropy (8/64 x ln 63 ~ 0.52)."""
    params, losses = train.train_induction(
        model.ModelConfig(**SMALL), steps=700, period=8, seq=64, batch=8,
        device="cpu")
    first, last = float(losses[0]), float(losses[-1])
    assert last < 1.0, (first, last)
    assert all(bool(torch.isfinite(p).all())
               for p in model.param_leaves(params))


def test_train_induction_needs_a_device_when_there_is_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_induction(model.ModelConfig(**SMALL), steps=1)
