"""The port's GEMM wrappers against the JAX reference kernels.

Inputs are made once with numpy from a seed; JAX runs its Pallas kernels
in interpret mode on the CPU (as tests/test_ops.py does), the port runs
its plain versions (every CPU tensor does).

Tolerances: both sides form each product of bf16 (or f32) inputs exactly
and sum in f32, then round once to the output type, so they differ in
summation order only. f32: 1e-5 relative (tests/test_ops.py's fallback
bound), bf16: 2^-8 relative, one bf16 rounding step, where a sum lies
near a rounding point. The quantized kernel's f32 case is held at 2e-2,
tests/test_ops.py's own bound for it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (  # noqa: E402
    GEMM_CARD_CASES,
    jax_f32,
    to_jax,
    to_torch,
    torch_f32,
)
from tpumon.ops import matmul as jax_mm  # noqa: E402
from tpumon.ops import quant_matmul as jax_qm  # noqa: E402
from tpumon_torch.ops import matmul as mm  # noqa: E402
from tpumon_torch.ops import quant_matmul as qm  # noqa: E402

BF16_RTOL = 2.0**-8


def normal(rng, *shape):
    return rng.standard_normal(shape, np.float32)


def assert_close(got, want, rtol):
    """Within ``rtol`` of want's largest magnitude, elementwise."""
    g, w = torch_f32(got), jax_f32(want)
    np.testing.assert_allclose(g, w, rtol=0, atol=rtol * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (128, 64, 128, 128, 64, 128),   # single tile
    (256, 128, 256, 128, 64, 128),  # multi-tile all axes
    (256, 256, 128, 128, 128, 128),  # k-major accumulation
])
def test_matmul_matches_reference(dtype, m, k, n, bm, bk, bn):
    rng = np.random.default_rng(m + k + n)
    a, b = normal(rng, m, k), normal(rng, k, n)
    want = jax_mm.matmul(*to_jax((a, b), jnp.dtype(dtype)), block_m=bm,
                         block_n=bn, block_k=bk, interpret=True)
    got = mm.matmul(*to_torch((a, b), getattr(torch, dtype)), block_m=bm,
                    block_n=bn, block_k=bk)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, BF16_RTOL if dtype == "bfloat16" else 1e-5)


def test_matmul_rejects_nondivisible():
    a, b = torch.zeros(100, 64), torch.zeros(64, 128)
    with pytest.raises(ValueError, match="must divide blocks"):
        mm.matmul(a, b, block_m=128, block_n=128, block_k=64)
    with pytest.raises(AssertionError):  # the reference asserts here
        jax_mm.matmul(jnp.zeros((100, 64)), jnp.zeros((64, 128)),
                      block_m=128, block_n=128, block_k=64, interpret=True)
    with pytest.raises(ValueError, match="a \\[M, K\\] and b \\[K, N\\]"):
        mm.matmul(torch.zeros(128, 64), torch.zeros(32, 128))
    with pytest.raises(ValueError, match="b must be"):
        mm.matmul(torch.zeros(128, 64), torch.zeros(64, 128).bfloat16(),
                  block_m=128, block_n=128, block_k=64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mm.matmul(torch.zeros(128, 64).half(), torch.zeros(64, 128).half(),
                  block_m=128, block_n=128, block_k=64)


def quant_case(m, k, n, seed=0):
    """(a, q, scale) as numpy, the reference's quantize() of a normal w."""
    from tpumon.loadgen.quant import quantize

    rng = np.random.default_rng(seed)
    qt = quantize(jnp.asarray(normal(rng, k, n)))
    return normal(rng, m, k), np.array(qt.q), np.array(qt.scale)


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-2),
                                        ("bfloat16", BF16_RTOL)])
def test_quantized_kernel_matches_reference(dtype, rtol):
    a, q, scale = quant_case(256, 512, 512)
    want = jax_qm.quantized_matmul_pallas(
        *to_jax((a,), jnp.dtype(dtype)), jnp.asarray(q), jnp.asarray(scale),
        block_m=128, block_n=128, block_k=128, interpret=True)
    got = qm.quantized_matmul_kernel(
        *to_torch((a,), getattr(torch, dtype)), torch.from_numpy(q),
        torch.from_numpy(scale), block_m=128, block_n=128, block_k=128)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, rtol)
    # and the plain version is the dequantized product in f32
    deq = a.astype(np.float32) @ (q.astype(np.float32) * scale)
    if dtype == "float32":
        np.testing.assert_allclose(torch_f32(got), deq, rtol=1e-5,
                                   atol=1e-5 * np.abs(deq).max())


def test_quantized_kernel_applies_scale_once_across_k_steps():
    """Two K steps with a non-unit scale, the reference test's case: a
    scale inside the K loop would apply it twice."""
    a = torch.ones(128, 256)
    q = torch.ones(256, 128, dtype=torch.int8)
    scale = torch.full((128,), 0.5)
    out = qm.quantized_matmul_kernel(a, q, scale, block_m=128, block_n=128,
                                     block_k=128)
    want = jax_qm.quantized_matmul_pallas(
        jnp.ones((128, 256)), jnp.ones((256, 128), jnp.int8),
        jnp.full((128,), 0.5), block_m=128, block_n=128, block_k=128,
        interpret=True)
    assert torch.equal(out, torch.full((128, 128), 128.0))
    np.testing.assert_array_equal(torch_f32(out), jax_f32(want))


def test_quantized_matmul_fallback_for_decode_shapes():
    """A decode-sized M does not tile: both packages take the plain
    dequantized product, and the port launches no kernel."""
    a, q, scale = quant_case(4, 64, 48, seed=1)
    want = jax_qm.quantized_matmul(jnp.asarray(a), jnp.asarray(q),
                                   jnp.asarray(scale), interpret=True)
    before = qm.quantized_matmul_kernel.launches
    got = qm.quantized_matmul(torch.from_numpy(a), torch.from_numpy(q),
                              torch.from_numpy(scale))
    assert qm.quantized_matmul_kernel.launches == before
    np.testing.assert_allclose(torch_f32(got), jax_f32(want), rtol=1e-5,
                               atol=1e-5)


def test_quantized_kernel_rejects_bad_operands():
    a, q, scale = (torch.from_numpy(x) for x in quant_case(128, 128, 128))
    with pytest.raises(ValueError, match="must divide blocks"):
        qm.quantized_matmul_kernel(a, q, scale)
    with pytest.raises(ValueError, match="b must be torch.int8"):
        qm.quantized_matmul_kernel(a, q.float(), scale, 128, 128, 128)
    with pytest.raises(ValueError, match="scale must be a float"):
        qm.quantized_matmul_kernel(a, q, scale[:64], 128, 128, 128)
    with pytest.raises(ValueError, match="cpu or cuda"):
        qm.quantized_matmul_kernel(a.to("meta"), q.to("meta"),
                                   scale.to("meta"), 128, 128, 128)


def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(2)
    a, b = to_torch((normal(rng, 128, 64), normal(rng, 64, 128)))
    q = torch.randint(-127, 128, (64, 128), dtype=torch.int8)
    scale = torch.rand(128)
    before = (mm.matmul.launches, qm.quantized_matmul_kernel.launches)
    assert torch.equal(mm.matmul(a, b, 128, 128, 64),
                       mm.matmul_reference(a, b))
    assert torch.equal(qm.quantized_matmul_kernel(a, q, scale, 128, 128, 64),
                       qm.quantized_matmul_reference(a, q, scale))
    assert (mm.matmul.launches, qm.quantized_matmul_kernel.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
def test_planted_faults_read_over_the_card_limits(quant, dtype):
    """The limit the GEMM kernels are held to on the card
    (chip_smoke.GEMM_TOL, also tests/test_torch_cuda.py's) catches every
    planted fault that applies at the card tests' shapes: each reads over
    it here, where the plain versions compute them."""
    import chip_smoke

    tol = chip_smoke.GEMM_TOL[dtype]
    gen = torch.Generator().manual_seed(4)
    for m, k, n in GEMM_CARD_CASES:
        a, b, scale = chip_smoke.gemm_case(gen, m, k, n,
                                           getattr(torch, dtype), quant)
        want = (qm.quantized_matmul_reference(a, b, scale) if quant
                else mm.matmul_reference(a, b))
        clean = chip_smoke.gemm_faulty_plain(a, b, scale, None)
        assert chip_smoke.gemm_tile_rel_err(clean, want) == 0.0
        readings = chip_smoke.gemm_fault_readings(a, b, scale, want)
        tiles = (m // 128) * -(-n // 256)  # the wgmma kernel's tiles
        assert len(readings) == (1 + (k == n) + quant * (1 + (k > 64))
                                 + 1 + (tiles > 1))
        assert min(readings.values()) > tol, (m, k, n, readings)


def test_gemm_variants_apply_to_the_kernel_source():
    """Every source variant that tpumon_torch.ops.gemm_variants times on
    the card still finds its substitution targets in csrc/matmul.cu."""
    from tpumon_torch.ops import gemm_variants

    base = gemm_variants.variant_source(())
    for name, (subs, _) in gemm_variants.VARIANTS.items():
        src = gemm_variants.variant_source(subs)
        assert (src == base) == (not subs), name
