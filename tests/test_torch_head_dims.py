"""The kernels' plain twins against the JAX reference at every shape the
reference's kernels take and the CUDA kernels now take too.

The reference's contracts are narrow: ``paged_attention`` asserts matching
shapes and ``n_heads % n_kv_heads == 0``, the flash functions that T
divides the caller's block, the GEMMs that the shapes divide the blocks.
Here, on the CPU, each wrapper runs its plain version on numpy inputs
from a seed, and the reference runs its Pallas kernel in interpret mode on
the same bits (as its own tests run it):

- paged decode at head dims 8, 24, 72, 96, 192 and 256, GQA groups 1, 8
  and 16, pages of 8 and 16 rows, mixed lengths (a zero-length sequence
  among them);
- the causal flash forward (out, lse) and backward (dq, dk, dv) and the
  rectangular forward at head dims 192 and 256, and at T 96 with block 32
  and T 40 with block 8;
- matmul and the int8 product at (M, K, N) = (16, 40, 48) and the other
  edge shapes of ``GEMM_EDGE_CASES``, at blocks equal to the shape.

and above 256, where the kernels take the sliced route (chip_smoke.py
phase 27):

- paged decode at head dims 300, 384, 512 and 1024, GQA groups 1 and 8,
  pages of 8 rows, mixed lengths with a zero-length sequence;
- the causal forward (out, lse) and backward (dq, dk, dv) and the
  rectangular forward at head dims 320, 512 and 1024, T 64, block 32.

The CUDA kernels are held to these plain twins on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 26 and 27).

Tolerances. f32: 1e-5 of the reference's largest magnitude (summation
order only). bf16, the port's existing parity bounds: paged 3e-2 max abs
(tests/test_torch_paged_attention.py, the reference test's own), flash
6e-2 max abs (tests/test_torch_flash_attention.py: the reference rounds P
and dS per block, the plain versions per row), GEMM 2^-8 of the largest
magnitude (tests/test_torch_matmul.py: one bf16 rounding step).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import (  # noqa: E402
    FLASH_SHAPE_CASES,
    FLASH_WIDE_HEAD_DIMS,
    GEMM_EDGE_CASES,
    PAGED_GROUPS,
    PAGED_HEAD_DIMS,
    PAGED_PAGE_SIZES,
    PAGED_WIDE_GROUPS,
    PAGED_WIDE_HEAD_DIMS,
    jax_f32,
    paged_head_dim_case,
    to_jax,
    to_torch,
    torch_f32,
)
from tpumon.ops import flash_attention as jax_fa  # noqa: E402
from tpumon.ops import matmul as jax_mm  # noqa: E402
from tpumon.ops import paged_attention as jax_pa  # noqa: E402
from tpumon.ops import quant_matmul as jax_qm  # noqa: E402
from tpumon_torch.ops import flash_attention as fa  # noqa: E402
from tpumon_torch.ops import matmul as mm  # noqa: E402
from tpumon_torch.ops import paged_attention as pa  # noqa: E402
from tpumon_torch.ops import quant_matmul as qm  # noqa: E402

F32_REL = 1e-5
BF16_ABS = {"paged": 3e-2, "flash": 6e-2}
BF16_GEMM_REL = 2.0**-8


def assert_close(got, want, dtype: str, kind: str) -> None:
    g, w = torch_f32(got), jax_f32(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=F32_REL * np.abs(w).max())
    elif kind == "gemm":
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=BF16_GEMM_REL * np.abs(w).max())
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=BF16_ABS[kind])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page_size", PAGED_PAGE_SIZES)
@pytest.mark.parametrize("nh,nkv", PAGED_GROUPS)
@pytest.mark.parametrize("hd", PAGED_HEAD_DIMS)
def test_paged_matches_reference_kernel(hd, nh, nkv, page_size, dtype):
    case = paged_head_dim_case(hd, nh, nkv, page_size)
    want = jax_pa.paged_attention(*to_jax(case, jnp.dtype(dtype)),
                                  interpret=True)
    got = pa.paged_attention(*to_torch(case, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype, "paged")
    assert torch.equal(got[2].float(), torch.zeros_like(got[2].float()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,nkv", PAGED_WIDE_GROUPS)
@pytest.mark.parametrize("hd", PAGED_WIDE_HEAD_DIMS)
def test_paged_wide_matches_reference_kernel(hd, nh, nkv, dtype):
    """Head dims above 256 (the kernel's sliced route on the card), pages
    of 8 rows, a zero-length sequence among the mixed lengths."""
    case = paged_head_dim_case(hd, nh, nkv, 8)
    want = jax_pa.paged_attention(*to_jax(case, jnp.dtype(dtype)),
                                  interpret=True)
    got = pa.paged_attention(*to_torch(case, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype, "paged")
    assert torch.equal(got[2].float(), torch.zeros_like(got[2].float()))


@pytest.mark.parametrize("hd", PAGED_HEAD_DIMS)
def test_paged_instance_of_each_head_dim(hd):
    """Each head dim runs in the least instance not below it, and the
    group tile is 8 query heads but for f32 at the 256 instance."""
    inst = pa.kernel_head_dim(hd)
    assert inst in pa.KERNEL_HEAD_DIMS and inst >= hd
    assert all(i < hd for i in pa.KERNEL_HEAD_DIMS if i < inst)
    assert pa.group_tile(torch.bfloat16, hd) == 8
    assert pa.group_tile(torch.float32, hd) == (4 if inst == 256 else 8)


def flash_case(hd, t, seed=3):
    rng = np.random.default_rng(seed + hd + t)
    return [rng.standard_normal((2, t, hd), np.float32) for _ in range(4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,t,block", FLASH_SHAPE_CASES)
def test_flash_tri_matches_reference_kernels(hd, t, block, dtype):
    """Forward (out, lse) and backward (dq, dk, dv) on the reference
    forward's own out and lse, as tests/test_torch_flash_attention.py."""
    q, k, v, g = flash_case(hd, t)
    jq, jk, jv, jg = to_jax((q, k, v, g), jnp.dtype(dtype))
    jout, jlse = jax_fa.flash_attention_tri_fwd(jq, jk, jv, block=block,
                                                interpret=True)
    jgrads = jax_fa.flash_attention_tri_bwd(jq, jk, jv, jout, jlse, jg,
                                            block=block, interpret=True)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = to_torch((q, k, v, g), tdt)
    out, lse = fa.flash_attention_tri_fwd(tq, tk, tv, block=block)
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert_close(out, jout, dtype, "flash")
    np.testing.assert_allclose(torch_f32(lse), jax_f32(jlse), rtol=0,
                               atol=1e-5)
    grads = fa.flash_attention_tri_bwd(
        tq, tk, tv, torch.tensor(jax_f32(jout)).to(tdt),
        torch.tensor(jax_f32(jlse)), tg, block=block)
    for got, want in zip(grads, jgrads):
        assert got.dtype == tdt
        assert_close(got, want, dtype, "flash")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", FLASH_WIDE_HEAD_DIMS)
def test_flash_tri_wide_matches_reference_kernels(hd, dtype):
    """Head dims above 256 (the kernels' sliced route on the card), T 64,
    block 32."""
    test_flash_tri_matches_reference_kernels(hd, 64, 32, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", FLASH_WIDE_HEAD_DIMS)
def test_flash_rect_wide_matches_reference_kernel(hd, dtype, causal):
    test_flash_rect_matches_reference_kernel(hd, 64, 32, dtype, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,t,block", FLASH_SHAPE_CASES)
def test_flash_rect_matches_reference_kernel(hd, t, block, dtype, causal):
    q, k, v, _ = flash_case(hd, t)
    want = jax_fa.flash_attention(*to_jax((q, k, v), jnp.dtype(dtype)),
                                  causal=causal, block_q=block,
                                  block_k=block, interpret=True)
    got = fa.flash_attention(*to_torch((q, k, v), getattr(torch, dtype)),
                             causal=causal, block_q=block, block_k=block)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype, "flash")


@pytest.mark.parametrize("hd,t,block", FLASH_SHAPE_CASES)
def test_flash_kernel_head_dim_and_block_contract(hd, t, block):
    """The instance each head dim runs at (192 pads to 256), and T is held
    to the caller's block only: one that does not divide T raises, as the
    reference asserts."""
    assert fa.kernel_head_dim(hd) == (256 if hd > 128 else hd)
    q = torch.zeros(1, t, hd)
    with pytest.raises(ValueError, match="must be a multiple of block"):
        fa.flash_attention_tri_fwd(q, q, q, block=t + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", GEMM_EDGE_CASES)
def test_matmul_edges_match_reference_kernel(m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k), np.float32)
    b = rng.standard_normal((k, n), np.float32)
    want = jax_mm.matmul(*to_jax((a, b), jnp.dtype(dtype)), block_m=m,
                         block_n=n, block_k=k, interpret=True)
    got = mm.matmul(*to_torch((a, b), getattr(torch, dtype)), block_m=m,
                    block_n=n, block_k=k)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype, "gemm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", GEMM_EDGE_CASES)
def test_quantized_edges_match_reference_kernel(m, k, n, dtype):
    from tpumon.loadgen.quant import quantize

    rng = np.random.default_rng(m + k + n + 1)
    qt = quantize(jnp.asarray(rng.standard_normal((k, n), np.float32)))
    a = rng.standard_normal((m, k), np.float32)
    q, scale = np.array(qt.q), np.array(qt.scale)
    want = jax_qm.quantized_matmul_pallas(
        *to_jax((a,), jnp.dtype(dtype)), jnp.asarray(q), jnp.asarray(scale),
        block_m=m, block_n=n, block_k=k, interpret=True)
    got = qm.quantized_matmul_kernel(
        *to_torch((a,), getattr(torch, dtype)), torch.from_numpy(q),
        torch.from_numpy(scale), block_m=m, block_n=n, block_k=k)
    assert got.dtype == getattr(torch, dtype)
    # the reference's own f32 bound for its int8 kernel is 2e-2
    # (tests/test_torch_matmul.py); both sides here sum exact products
    assert_close(got, want, dtype, "gemm")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", GEMM_EDGE_CASES)
def test_gemm_pad_route_is_the_product(m, k, n, dtype):
    """The zero-pad route the bf16 kernel takes where TMA's 16-byte
    strides do not fit K or N: the padded operands' product, sliced back
    to N columns, is the product (the zero rows and columns add exact
    zeros); f32 operands, which the f32 kernel takes at any shape, are
    left as they are. Counted in ``matmul.padded``. The sums are compared
    at torch's default bounds for the dtype: the padded K may be blocked
    otherwise."""
    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randn(m, k, generator=gen).to(dtype)
    b = torch.randn(k, n, generator=gen).to(dtype)
    q = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    scale = torch.rand(n, generator=gen) / 127
    before = mm.matmul.padded
    pa_, pb, _ = mm.padded_operands(a, b)
    qa, pq, ps = mm.padded_operands(a, q, scale)
    bf16 = dtype == torch.bfloat16
    need = bf16 and bool(k % 8 or n % 8)
    need_q = bf16 and bool(k % 8 or n % 16)
    assert mm.matmul.padded - before == int(need) + int(need_q)
    if bf16:
        assert pa_.shape[1] % 8 == 0 and pb.shape == (pa_.shape[1],
                                                      pb.shape[1])
        assert pb.shape[1] % 8 == 0 and pq.shape[1] % 16 == 0
        assert ps.shape == (pq.shape[1],)
    else:
        assert pa_ is a and pb is b and pq is q and ps is scale
    torch.testing.assert_close(mm.matmul_reference(pa_, pb)[:, :n],
                               mm.matmul_reference(a, b))
    torch.testing.assert_close(
        qm.quantized_matmul_reference(qa, pq, ps)[:, :n],
        qm.quantized_matmul_reference(a, q, scale))
