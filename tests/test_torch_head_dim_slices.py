"""The column-sliced design of the port's attention kernels above head dim
256, on the CPU.

Above 256 the paged decode kernel and the flash kernels cut each output's
columns into slices, one CTA a slice, and compute every slice's scores
over the whole head dim in 256-column chunks (tpumon_torch/ops/csrc/
paged_attention.cu, flash_fwd.cuh, flash_attention_tri_bwd.cu).
chip_smoke.py models that schedule in plain torch (``paged_sliced_plain``,
``flash_sliced_plain``, ``flash_sliced_grads``) and plants the design's
faults in the model (``SLICE_FAULTS``: a slice's scores over its own
columns, a slice written at the next slice's offset, the lse taken from
the last slice's own columns). Here the model without a fault is held to
the JAX Pallas kernels (interpret mode) on the same numpy inputs, with
tests/test_torch_head_dims.py's tolerances (f32 1e-5 of the largest
magnitude; bf16 paged 3e-2 and flash 6e-2 max abs); each planted fault
reads over the limits the kernels are held to on the card (PAGED_TOL,
FLASH_TOL) at phase 27's shapes; and each fault vanishes where there is
one slice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    FLASH_WIDE_HEAD_DIMS,
    PAGED_WIDE_GROUPS,
    jax_f32,
    paged_head_dim_case,
    to_jax,
    to_torch,
    torch_f32,
)
from tpumon.ops import flash_attention as jax_fa  # noqa: E402
from tpumon.ops import paged_attention as jax_pa  # noqa: E402
from tpumon_torch.ops import flash_attention as fa  # noqa: E402
from tpumon_torch.ops import paged_attention as pa  # noqa: E402

F32_REL = 1e-5
BF16_ABS = {"paged": 3e-2, "flash": 6e-2}


def assert_close(got, want, dtype: str, kind: str) -> None:
    g, w = torch_f32(got), jax_f32(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    atol = (F32_REL * np.abs(w).max() if dtype == "float32"
            else BF16_ABS[kind])
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nh,nkv", PAGED_WIDE_GROUPS)
@pytest.mark.parametrize("hd", [300, 512, 1024])
def test_paged_sliced_model_matches_jax_kernel(hd, nh, nkv, dtype):
    case = paged_head_dim_case(hd, nh, nkv, 8)
    want = jax_pa.paged_attention(*to_jax(case, jnp.dtype(dtype)),
                                  interpret=True)
    got = chip_smoke.paged_sliced_plain(*to_torch(case, getattr(torch, dtype)))
    assert pa.head_dim_slices(hd) > 1
    assert_close(got, want, dtype, "paged")
    assert torch.equal(got[2].float(), torch.zeros_like(got[2].float()))


def flash_case(hd, t=64, seed=3):
    rng = np.random.default_rng(seed + hd + t)
    return [rng.standard_normal((2, t, hd), np.float32) for _ in range(4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", FLASH_WIDE_HEAD_DIMS)
def test_flash_sliced_model_matches_jax_kernels(hd, dtype):
    """The forward's out and lse, the backward's dq, dk and dv (on the
    reference forward's own out and lse) and the rectangular forward
    without the mask, T 64, block 32."""
    q, k, v, g = flash_case(hd)
    jq, jk, jv, jg = to_jax((q, k, v, g), jnp.dtype(dtype))
    jout, jlse = jax_fa.flash_attention_tri_fwd(jq, jk, jv, block=32,
                                                interpret=True)
    jgrads = jax_fa.flash_attention_tri_bwd(jq, jk, jv, jout, jlse, jg,
                                            block=32, interpret=True)
    jrect = jax_fa.flash_attention(jq, jk, jv, causal=False, block_q=32,
                                   block_k=32, interpret=True)
    tq, tk, tv, tg = to_torch((q, k, v, g), getattr(torch, dtype))
    out, lse = chip_smoke.flash_sliced_plain(tq, tk, tv)
    assert_close(out, jout, dtype, "flash")
    np.testing.assert_allclose(torch_f32(lse), jax_f32(jlse), rtol=0,
                               atol=1e-5)
    rect, _ = chip_smoke.flash_sliced_plain(tq, tk, tv, causal=False)
    assert_close(rect, jrect, dtype, "flash")
    tout = torch.tensor(jax_f32(jout)).to(tq.dtype)
    tlse = torch.tensor(jax_f32(jlse))
    dvec = (tg.float() * tout.float()).sum(-1)
    got = {}
    for kernel in ("flash_attention_tri_bwd_dq",
                   "flash_attention_tri_bwd_dkv"):
        got.update(chip_smoke.flash_sliced_grads(tq, tk, tv, tg, tlse, dvec,
                                                 None, kernel))
    for name, want in zip(("dq", "dk", "dv"), jgrads):
        assert_close(got[name], want, dtype, "flash")


def paged_card_cases():
    """Phase 27's paged shapes above 256 at every group."""
    return [(hd, nh, nkv) for hd in chip_smoke.P27_HEAD_DIMS
            for nh, nkv in chip_smoke.PAGED_GROUPS]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_slice_faults_read_over_the_card_limit(dtype):
    """At phase 27's paged shapes every fault of the sliced design that
    applies (all but lse_from_last_slice) reads over PAGED_TOL, and the
    model without a fault is within half of it (bf16: the plain version
    rounds the scores to bf16, the model keeps them in f32)."""
    tol = chip_smoke.PAGED_TOL[dtype]
    for hd, nh, nkv in paged_card_cases():
        shape = chip_smoke.paged_head_dim_shape(hd, nh, nkv,
                                                chip_smoke.P27_PAGE_SIZE)
        args = chip_smoke.paged_inputs(torch.Generator().manual_seed(hd),
                                       **shape, dtype=getattr(torch, dtype))
        want = pa.paged_attention_reference(*args)
        clean = chip_smoke.paged_sliced_plain(*args)
        assert chip_smoke.rows_rel_err(clean, want, args[4]) <= tol / 2
        readings = chip_smoke.paged_slice_readings(args, want)
        assert sorted(readings) == ["slice_local_scores", "slice_offset"]
        assert min(readings.values()) > tol, (hd, nh, readings)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", chip_smoke.P27_HEAD_DIMS)
def test_flash_slice_faults_read_over_the_card_limits(hd, dtype):
    """At phase 27's flash shape (T 128) every fault of the sliced design
    reads over the limit of each kernel it applies to (lse_from_last_slice
    on the forward's lse), and the models without a fault read well under
    those limits."""
    tdt = getattr(torch, dtype)
    q, k, v, g, out, lse, dvec = chip_smoke.flash_inputs(
        torch.Generator().manual_seed(hd), 2, 128, hd, tdt)
    want = {"out": out, "lse": lse,
            "rect": fa.flash_attention_reference(q, k, v, False)}
    want["dq"] = fa.flash_attention_tri_bwd_dq_reference(q, k, v, g, lse,
                                                         dvec)
    want["dk"], want["dv"] = fa.flash_attention_tri_bwd_dkv_reference(
        q, k, v, g, lse, dvec)
    clean, clean_lse = chip_smoke.flash_sliced_plain(q, k, v)
    limits = chip_smoke.FLASH_TOL[dtype]
    assert chip_smoke.tile_rel_err(clean, out) <= limits["out"] / 10
    assert (clean_lse - lse).abs().max().item() <= limits["lse"] / 10
    readings = chip_smoke.flash_slice_readings(q, k, v, g, lse, dvec, want)
    assert sorted(readings["flash_attention_tri_fwd"]) == sorted(
        chip_smoke.SLICE_FAULTS)
    for kernel in ("flash_attention_tri_bwd_dq",
                   "flash_attention_tri_bwd_dkv", "flash_attention"):
        assert sorted(readings[kernel]) == ["slice_local_scores",
                                            "slice_offset"]
    low = {(kern, f): r / lim for kern, fs in readings.items()
           for f, (r, lim) in fs.items()}
    assert min(low.values()) > 1, low


@pytest.mark.parametrize("fault", chip_smoke.SLICE_FAULTS)
@pytest.mark.parametrize("hd", [96, 256])
def test_slice_faults_vanish_with_one_slice(hd, fault):
    """Up to head dim 256 there is one slice: no fault of the sliced
    design applies, and each faulty model is the clean one bit for bit."""
    q, k, v, g, _, lse, dvec = chip_smoke.flash_inputs(
        torch.Generator().manual_seed(hd), 2, 64, hd, torch.float32)
    for kernel in ("paged_attention", "flash_attention",
                   *chip_smoke.FLASH_OUTPUTS):
        assert not chip_smoke.slice_fault_applies(fault, kernel, hd,
                                                  torch.float32)
    for causal in (True, False):
        faulty = chip_smoke.flash_sliced_plain(q, k, v, fault, causal)
        clean = chip_smoke.flash_sliced_plain(q, k, v, None, causal)
        for a, b in zip(faulty, clean):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    for kernel in ("flash_attention_tri_bwd_dq",
                   "flash_attention_tri_bwd_dkv"):
        faulty = chip_smoke.flash_sliced_grads(q, k, v, g, lse, dvec, fault,
                                               kernel)
        clean = chip_smoke.flash_sliced_grads(q, k, v, g, lse, dvec, None,
                                              kernel)
        for name in faulty:
            torch.testing.assert_close(faulty[name], clean[name], atol=0,
                                       rtol=0)
    args = chip_smoke.paged_inputs(torch.Generator().manual_seed(hd),
                                   **chip_smoke.paged_head_dim_shape(
                                       hd, 8, 1, 16), dtype=torch.float32)
    torch.testing.assert_close(chip_smoke.paged_sliced_plain(*args, fault),
                               chip_smoke.paged_sliced_plain(*args),
                               atol=0, rtol=0)


def test_slices_of_each_route():
    """The column slices each route cuts a head dim into: the paged
    kernel's 256-column slices, the bf16 forward's 256, the backward's and
    the f32 kernels' 128 (over the head dim padded to a multiple of 256)."""
    assert [pa.head_dim_slices(d) for d in (256, 257, 512, 513, 1024)] == [
        1, 2, 2, 3, 4]
    bf16, f32 = torch.bfloat16, torch.float32
    assert [fa.column_slices(d, bf16, True) for d in (256, 300, 512, 1024)] == [
        1, 2, 2, 4]
    assert [fa.column_slices(d, bf16, False) for d in (256, 300, 512)] == [
        1, 4, 4]
    assert [fa.column_slices(d, f32, True) for d in (256, 513, 1024)] == [
        1, 6, 8]
