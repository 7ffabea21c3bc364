"""The port's ring and zigzag attention against the JAX reference.

``tests/test_ring_attention.py``'s cases through both packages on the same
numpy-made q/k/v: the reference on its conftest's CPU devices, the port on
``[cpu] * n`` (one controller passing each K/V block to the next device
by ``.to()``). Forward outputs and the q/k/v gradients of sum(out^2) must
be the reference's, and so must the zigzag permutation.

Tolerances: f32 outputs and gradients rtol/atol 1e-5 (both accumulate
the same online-softmax blocks in f32; only the einsums' summation order
differs); bf16 5e-2, the reference's own bound against its oracle.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from tpumon.loadgen import ring_attention as jra  # noqa: E402
from tpumon_torch.loadgen import ring_attention as ra  # noqa: E402
from tpumon_torch.loadgen.model import Mesh  # noqa: E402

TOL = 1e-5


def qkv_np(t, b=2, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d), np.float32) for _ in range(3)]


def meshes(n):
    return (JaxMesh(np.array(jax.devices()[:n]), ("seq",)),
            Mesh([torch.device("cpu")] * n, ("seq",)))


def grads_of(fn, arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    (out.float() ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_reference(n, causal):
    """Against the reference's full-attention oracle, and against the
    reference's ring itself at n 2 and 4 (causal) and 4 (not causal): its
    shard_map compiles slowly at n 8, and the reference's own tests hold
    it to the oracle there."""
    jmesh, mesh = meshes(n)
    q, k, v = qkv_np(32)
    got = ra.ring_attention(*map(torch.from_numpy, (q, k, v)), mesh,
                            causal=causal)
    wants = [jra.reference_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal)]
    if (causal and n < 8) or n == 4:
        wants.append(jra.ring_attention(*map(jnp.asarray, (q, k, v)), jmesh,
                                        causal=causal))
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zigzag_matches_reference(n):
    """Against the reference's oracle, and its zigzag ring at n 2 and 4."""
    jmesh, mesh = meshes(n)
    q, k, v = qkv_np(32)
    t = q.shape[1]
    zi, inv = np.asarray(jra.zigzag_indices(t, n)), np.asarray(
        jra.zigzag_inverse(t, n))
    got = ra.zigzag_ring_attention(
        *(torch.from_numpy(x[:, zi]) for x in (q, k, v)), mesh)
    if n < 8:
        want = jra.zigzag_ring_attention(
            *(jnp.asarray(x[:, zi]) for x in (q, k, v)), jmesh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    ref = jra.reference_attention(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy()[:, inv], np.asarray(ref),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,n", [(32, 4), (16, 2), (64, 8)])
def test_zigzag_permutation_roundtrip(t, n):
    zi, inv = ra.zigzag_indices(t, n), ra.zigzag_inverse(t, n)
    assert zi.tolist() == np.asarray(jra.zigzag_indices(t, n)).tolist()
    assert inv.tolist() == np.asarray(jra.zigzag_inverse(t, n)).tolist()
    x = torch.arange(t)
    assert torch.equal(x[zi][inv], x)
    hb = t // (2 * n)  # device 0's block holds half-blocks 0 and 2n-1
    assert zi[:2 * hb].tolist() == (list(range(hb))
                                    + list(range(t - hb, t)))
    with pytest.raises(ValueError, match="divide"):
        ra.zigzag_indices(t + 1, n)


def test_bf16_and_first_row():
    """tests/test_ring_attention.py's bf16 bound, and a finite output for
    the causal first row (it attends only itself)."""
    jmesh, mesh = meshes(4)
    q, k, v = qkv_np(32)
    want = jra.ring_attention(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)), jmesh)
    got = ra.ring_attention(*(torch.from_numpy(x).bfloat16()
                              for x in (q, k, v)), mesh)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)
    q, k, v = qkv_np(16)
    out = ra.ring_attention(*map(torch.from_numpy, (q, k, v)), mesh)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("schedule", ["ring", "zigzag"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_grads_match_reference(schedule, n):
    """The q/k/v gradients of sum(out^2) through the ring (the K/V copies
    between devices run backwards) are those of the reference's full
    attention, as tests/test_ring_attention.py holds the reference's
    rings to them; for the ring at n 2 also those of the reference's ring
    itself (a gradient through its shard_map compiles slowly)."""
    jmesh, mesh = meshes(n)
    arrays = qkv_np(16 if n < 8 else 32)
    t = arrays[0].shape[1]
    if schedule == "ring":
        def jfn(q, k, v):
            return jra.ring_attention(q, k, v, jmesh)

        def tfn(q, k, v):
            return ra.ring_attention(q, k, v, mesh)
    else:
        zi, inv = jra.zigzag_indices(t, n), jra.zigzag_inverse(t, n)
        tzi, tinv = ra.zigzag_indices(t, n), ra.zigzag_inverse(t, n)

        def jfn(q, k, v):
            return jra.zigzag_ring_attention(q[:, zi], k[:, zi], v[:, zi],
                                             jmesh)[:, inv]

        def tfn(q, k, v):
            return ra.zigzag_ring_attention(q[:, tzi], k[:, tzi], v[:, tzi],
                                            mesh)[:, tinv]

    _, got = grads_of(tfn, arrays)
    wants = [jra.reference_attention] + (
        [jfn] if n == 2 and schedule == "ring" else [])
    for fn in wants:
        want = jax.grad(lambda q, k, v: jnp.sum(
            fn(q, k, v).astype(jnp.float32) ** 2),
            argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                       atol=1e-4)


def test_inner_bodies_widen_kv_heads_locally():
    """sp_train's use: unwidened nkv-head K/V rotate and each device widens
    its own copy (kv_rep), the same output as widening first."""
    q, k, v = (torch.from_numpy(x) for x in qkv_np(32))
    k2, v2 = k[:, :, :2], v[:, :, :2]
    wide = [torch.repeat_interleave(x, 2, dim=2) for x in (k2, v2)]

    def blocks(x, n=4):
        return list(x.split(x.shape[1] // n, dim=1))

    for inner in (ra.ring_attend_inner, ra.zigzag_attend_inner):
        narrow = inner(blocks(q), blocks(k2), blocks(v2), kv_rep=2)
        full = inner(blocks(q), *(blocks(x) for x in wide))
        for a, b in zip(narrow, full):
            assert torch.equal(a, b)
