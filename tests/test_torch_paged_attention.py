"""The port's paged_attention against the JAX reference.

On the CPU the port's wrapper runs its plain version, which is held to
both the Pallas kernel (interpret mode) and the reference's dense-gather
oracle on the same numpy inputs, over every case of
tests/test_paged_attention.py. Tolerances: f32 atol=rtol=1e-5 (summation
order only); bf16 atol=3e-2, the reference test's own.

The CUDA kernel itself runs only on a GPU: see tests/test_torch_cuda.py
and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (  # noqa: E402
    PAGED_CARD_CASE,
    PAGED_CARD_SHAPES,
    jax_f32,
    paged_case,
    to_jax,
    to_torch,
    torch_f32,
)
from tpumon.ops import paged_attention as jax_pa  # noqa: E402
from tpumon_torch.ops.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_reference,
)

CASES = {
    "mixed_lengths": {},
    "gqa_group_of_four": {"nh": 8, "nkv": 2, "lengths": (8, 24, 31)},
    "single_token_and_full_pages": {"lengths": (1, 32, 16)},
    "zero_length": {"lengths": (0, 9, 12)},
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_kernel_and_oracle(name):
    case = paged_case(**CASES[name])
    out = torch_f32(paged_attention(*to_torch(case)))
    kern = jax_f32(jax_pa.paged_attention(*to_jax(case), interpret=True))
    ref = jax_f32(jax_pa.paged_attention_reference(*to_jax(case)))
    np.testing.assert_allclose(out, kern, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_zero_length_sequence_is_zeros():
    case = paged_case(lengths=(0, 9, 12))
    out = paged_attention(*to_torch(case))
    assert torch.equal(out[0], torch.zeros_like(out[0]))


def test_page_order_is_table_order():
    """Permuting the pool and rewriting the table through the same
    permutation leaves the result unchanged: the table is the source of
    truth."""
    q, k, v, table, lengths = paged_case(lengths=(32, 32, 32))
    out1 = paged_attention(*to_torch((q, k, v, table, lengths)))
    perm = np.random.default_rng(1).permutation(k.shape[1])
    inv = np.argsort(perm)
    moved = (q, k[:, inv], v[:, inv], perm[table].astype(np.int32), lengths)
    out2 = paged_attention(*to_torch(moved))
    torch.testing.assert_close(out1, out2, atol=1e-5, rtol=1e-5)
    ref2 = jax_f32(jax_pa.paged_attention(*to_jax(moved), interpret=True))
    np.testing.assert_allclose(torch_f32(out2), ref2, atol=1e-5, rtol=1e-5)


def test_bfloat16_path():
    case = paged_case(lengths=(7, 30, 21))
    out = paged_attention(*to_torch(case, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    kern = jax_pa.paged_attention(*to_jax(case, jnp.bfloat16), interpret=True)
    ref = jax_pa.paged_attention_reference(*to_jax(case, jnp.bfloat16))
    np.testing.assert_allclose(torch_f32(out), jax_f32(kern), atol=3e-2)
    np.testing.assert_allclose(torch_f32(out), jax_f32(ref), atol=3e-2)


def test_cpu_calls_do_not_count_as_launches():
    before = paged_attention.launches
    paged_attention(*to_torch(paged_case()))
    assert paged_attention.launches == before


def _bad(case, **over):
    t = dict(zip(("q", "k", "v", "table", "lengths"), to_torch(case)))
    t.update(over)
    return t["q"], t["k"], t["v"], t["table"], t["lengths"]


@pytest.mark.parametrize("what", [
    "heads_not_multiple_of_kv_heads", "kv_shape_mismatch", "float16",
    "int64_table", "short_lengths", "non_contiguous_q",
])
def test_rejects_bad_inputs(what):
    """The reference asserts nh % nkv == 0 and equal K/V shapes
    (tests/test_paged_attention.py::test_rejects_bad_shapes); the port
    raises ValueError on those and on every type/layout it cannot take."""
    case = paged_case()
    q, k, v, table, lengths = to_torch(case)
    over = {
        "heads_not_multiple_of_kv_heads": {"q": q[:, :3].contiguous()},
        "kv_shape_mismatch": {"v": v[:, :, :4].contiguous()},
        "float16": {"q": q.half(), "k": k.half(), "v": v.half()},
        "int64_table": {"table": table.long()},
        "short_lengths": {"lengths": lengths[:2]},
        "non_contiguous_q": {"q": q.transpose(0, 1).contiguous()
                             .transpose(0, 1)},
    }[what]
    with pytest.raises(ValueError):
        paged_attention(*_bad(case, **over))


def test_plain_version_matches_jax_oracle_larger_gqa():
    """The plain version mirrors the reference's oracle op for op, so in
    f32 the two agree to rounding on a larger GQA case too."""
    case = paged_case(b=4, nh=8, nkv=2, hd=32, num_pages=20, page_size=8,
                      max_pages=5, lengths=(40, 1, 0, 23), seed=3)
    out = torch_f32(paged_attention_reference(*to_torch(case)))
    ref = jax_f32(jax_pa.paged_attention_reference(*to_jax(case)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", range(len(PAGED_CARD_SHAPES)))
def test_planted_faults_read_over_the_card_limits(dtype, shape):
    """The limits the CUDA kernel is held to (chip_smoke.PAGED_TOL, also
    tests/test_torch_cuda.py's) catch every planted fault of a paged
    kernel that applies at the card tests' shapes: each reads over its
    limit here, where the plain version computes them. Without a fault
    the model is the plain version."""
    import chip_smoke

    spec = PAGED_CARD_SHAPES[shape]
    args = to_torch(paged_case(**PAGED_CARD_CASE, **spec),
                    getattr(torch, dtype))
    want = paged_attention_reference(*args)
    clean = chip_smoke.paged_faulty_plain(*args, None)
    assert chip_smoke.rows_rel_err(clean, want, args[4]) <= 1e-6
    # the dropped last page is the plain version over shortened lengths
    n, ps = args[4], spec["page_size"]
    short = torch.clamp((n - 1) // ps * ps, min=0).to(torch.int32)
    assert chip_smoke.rows_rel_err(
        chip_smoke.paged_faulty_plain(*args, "last_page_dropped"),
        paged_attention_reference(*args[:4], short), args[4]) <= 1e-6
    readings = chip_smoke.paged_fault_readings(args, want)
    assert len(readings) == (5 if spec["nkv"] > 1 else 4)
    tol = chip_smoke.PAGED_TOL[dtype]
    assert min(readings.values()) > tol, readings
