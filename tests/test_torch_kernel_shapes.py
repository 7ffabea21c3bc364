"""The kernels' shape routing, checked on the CPU.

The flash kernels have instances at head_dim 32, 64, 128 and 256; a head
dim between them runs through the next one, zero-padded along D with the
true scale ``1/sqrt(D)`` (``flash_attention.pad_head_dim``). Here that
route runs the plain twins, which take the scale as the kernels do: at
head_dim 8, 16 and 48 the padded forward, lse and the three gradients must
equal the plain twins at the true shape, and the padded columns of the
gradients must be zero. Also: which instance a head dim runs at (the paged
kernel's 16 ... 256 read the pool at its true head dim; the flash
kernels' 32 ... 256 through the pad), and, above 256, the sliced route's
padded head dim and column slices: no head dim is refused.

Tolerances: f32 1e-6 (the zero columns add exact zeros; only the products'
blocking may reorder the sums); bf16 1e-3 of the tile norm (a bf16
rounding of P or dS may fall the other way on a reordered f32 sum).
"""

import pytest

torch = pytest.importorskip("torch")

from tpumon_torch.ops import flash_attention as fa  # noqa: E402
from tpumon_torch.ops import paged_attention as pa  # noqa: E402


def inputs(hd, dtype, bh=3, t=64, seed=0):
    gen = torch.Generator().manual_seed(seed + hd)
    q, k, v, g = (torch.randn(bh, t, hd, generator=gen).to(dtype)
                  for _ in range(4))
    out, lse = fa.flash_attention_tri_fwd_reference(q, k, v)
    dvec = (g.float() * out.float()).sum(-1)
    return q, k, v, g, lse, dvec


def close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    else:
        err = (got.float() - want.float()).norm() / want.float().norm()
        assert err <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [8, 16, 48])
def test_padded_route_equals_the_true_shape(hd, dtype):
    q, k, v, g, lse, dvec = inputs(hd, dtype)
    assert fa.kernel_head_dim(hd) == (32 if hd <= 32 else 64)
    out, lse_p = fa.pad_head_dim(fa.flash_attention_tri_fwd_reference,
                                 (q, k, v))
    want_out, want_lse = fa.flash_attention_tri_fwd_reference(q, k, v)
    assert out.shape == q.shape and out.is_contiguous()
    close(out, want_out, dtype)
    torch.testing.assert_close(lse_p, want_lse, atol=1e-5, rtol=1e-6)
    (dq,) = fa.pad_head_dim(
        lambda *a, scale: (fa.flash_attention_tri_bwd_dq_reference(
            *a, scale=scale),), (q, k, v, g), (lse, dvec))
    close(dq, fa.flash_attention_tri_bwd_dq_reference(q, k, v, g, lse,
                                                      dvec), dtype)
    dk, dv = fa.pad_head_dim(fa.flash_attention_tri_bwd_dkv_reference,
                             (q, k, v, g), (lse, dvec))
    want_dk, want_dv = fa.flash_attention_tri_bwd_dkv_reference(
        q, k, v, g, lse, dvec)
    close(dk, want_dk, dtype)
    close(dv, want_dv, dtype)


def test_padded_columns_come_back_zero():
    """Zero columns of q, k, v and dO give zero columns of every output:
    the slice drops nothing."""
    q, k, v, g, lse, dvec = inputs(16, torch.float32)
    wide = [torch.nn.functional.pad(x, (0, 16)) for x in (q, k, v, g)]
    scale = 16**-0.5
    out, _ = fa.flash_attention_tri_fwd_reference(*wide[:3], scale=scale)
    dq = fa.flash_attention_tri_bwd_dq_reference(*wide, lse, dvec,
                                                 scale=scale)
    dk, dv = fa.flash_attention_tri_bwd_dkv_reference(*wide, lse, dvec,
                                                      scale=scale)
    for x in (out, dq, dk, dv):
        assert torch.equal(x[..., 16:], torch.zeros_like(x[..., 16:]))


def test_instances_and_limits():
    """No head dim is refused. The flash kernels: the instances up to 256;
    above, the sliced route at the head dim padded to a multiple of 256,
    in column slices of 256 (the bf16 forward) or 128 (the backward, and
    f32). The paged kernel: the instances up to 256; above, the 256
    instance's tiles in 256-column slices over the pool's true head dim
    (f32: group tiles of 4 query heads, as at 256)."""
    assert [fa.kernel_head_dim(d) for d in (
        1, 8, 32, 40, 64, 72, 128, 129, 192, 255, 256)] == [
        32, 32, 32, 64, 64, 128, 128, 256, 256, 256, 256]
    assert fa.KERNEL_HEAD_DIMS == (32, 64, 128, 256)
    wide = (257, 300, 512, 513, 1024)
    assert [fa.kernel_head_dim(d) for d in wide] == [512, 512, 512, 768,
                                                     1024]
    bf16, f32 = torch.bfloat16, torch.float32
    assert [fa.column_slices(d, bf16, True) for d in wide] == [2, 2, 2, 3, 4]
    assert [fa.column_slices(d, bf16, False) for d in wide] == [
        4, 4, 4, 6, 8]
    assert [fa.column_slices(d, f32, True) for d in wide] == [4, 4, 4, 6, 8]
    assert fa.column_slices(256, bf16, True) == 1
    for bad in (0, -3):
        with pytest.raises(ValueError, match="at least 1"):
            fa.kernel_head_dim(bad)
    # the paged kernel
    assert [pa.kernel_head_dim(d) for d in (
        1, 8, 16, 24, 72, 96, 129, 192, 256)] == [
        16, 16, 16, 32, 128, 128, 256, 256, 256]
    assert [pa.kernel_head_dim(d) for d in wide] == [256] * 5
    assert [pa.head_dim_slices(d) for d in wide] == [2, 2, 2, 3, 4]
    assert [pa.group_tile(f32, d) for d in wide] == [4] * 5
    assert [pa.group_tile(bf16, d) for d in wide] == [8] * 5
    assert pa.KERNEL_HEAD_DIMS == (16, 32, 64, 128, 256)


def test_cpu_tensors_run_the_plain_twins_at_any_head_dim():
    """On the CPU the wrappers run the plain versions (no pad), at the
    reference's small head dims too."""
    q, k, v, g, lse, dvec = inputs(8, torch.float32)
    before = fa.flash_attention_tri_fwd.launches
    out, _ = fa.flash_attention_tri_fwd(q, k, v, block=32)
    assert fa.flash_attention_tri_fwd.launches == before
    assert torch.equal(out, fa.flash_attention_tri_fwd_reference(q, k, v)[0])


def test_planted_faults_read_over_the_paged_limits_at_the_new_shapes():
    """At the card tests' new paged shapes (tests/test_torch_cuda.py's
    PAGED_WIDE_SHAPES and PAGED_WIDE_SPLIT_CASE), every planted fault that
    applies, the group tiles' among them, reads over the limit the kernel
    is held to; the split model without a fault stays within half of it."""
    import chip_smoke
    from tests.test_torch_cuda import PAGED_WIDE_SHAPES, PAGED_WIDE_SPLIT_CASE
    from tests.torch_parity import PAGED_CARD_CASE, paged_case, to_torch

    specs = [dict(PAGED_CARD_CASE, **s) for s in PAGED_WIDE_SHAPES]
    specs.append(PAGED_WIDE_SPLIT_CASE)
    for spec in specs:
        for dtype in ("float32", "bfloat16"):
            args = to_torch(paged_case(**spec), getattr(torch, dtype))
            want = pa.paged_attention_reference(*args)
            tol = chip_smoke.PAGED_TOL[dtype]
            pages = pa.pages_per_split(spec["b"], spec["nkv"],
                                       spec["max_pages"], spec["page_size"])
            clean = chip_smoke.paged_split_plain(*args, pages)
            assert chip_smoke.rows_rel_err(clean, want, args[4]) <= tol / 2
            readings = chip_smoke.paged_fault_readings(args, want)
            assert ("group_tile_repeated" in readings) == (
                spec["nh"] // spec["nkv"] > 8)
            assert min(readings.values()) > tol, (spec, readings)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [8, 96, 256, 12])
def test_planted_faults_read_over_the_paged_limits_at_every_head_dim(
        hd, dtype):
    """At chip_smoke phase 26's paged shapes (groups 1, 8 and 16, pages of
    8 and 16), every planted fault that applies reads over the limit the
    kernel is held to, the group tile's among them (f32 at the 256
    instance: tiles of 4 query heads)."""
    import chip_smoke

    tol = chip_smoke.PAGED_TOL[dtype]
    tdt = getattr(torch, dtype)
    for nh, nkv in chip_smoke.PAGED_GROUPS:
        for ps in chip_smoke.PAGED_PAGE_SIZES:
            shape = chip_smoke.paged_head_dim_shape(hd, nh, nkv, ps)
            args = chip_smoke.paged_inputs(torch.Generator().manual_seed(hd),
                                           **shape, dtype=tdt)
            want = pa.paged_attention_reference(*args)
            readings = chip_smoke.paged_fault_readings(args, want)
            tile = pa.group_tile(tdt, hd)
            assert ("group_tile_repeated" in readings) == (nh // nkv > tile)
            assert readings and min(readings.values()) > tol, (
                shape, readings)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,t,block", [(192, 128, 64), (64, 96, 32),
                                        (256, 40, 8)])
def test_planted_faults_read_over_the_flash_limits_at_ragged_t(
        hd, t, block, dtype):
    """At phase 26's flash shapes (head dims past 128, T no multiple of
    the kernels' tiles) the forward, backward and rectangular faults that
    apply read over their limits, and each fault model without its fault
    is the plain version."""
    import chip_smoke

    tdt = getattr(torch, dtype)
    q, k, v, g, out, lse, dvec = chip_smoke.flash_inputs(
        torch.Generator().manual_seed(t), 2, t, hd, tdt)
    want = {"out": out}
    want["dq"] = fa.flash_attention_tri_bwd_dq_reference(q, k, v, g, lse,
                                                         dvec)
    want["dk"], want["dv"] = fa.flash_attention_tri_bwd_dkv_reference(
        q, k, v, g, lse, dvec)
    assert chip_smoke.tile_rel_err(chip_smoke.faulty_plain(q, k, v, None),
                                   out) <= 1e-6
    readings = chip_smoke.fault_readings(q, k, v, g, lse, dvec, want)
    caught = [r / chip_smoke.flash_limit(kern, dtype)
              for kern, faults in readings.items()
              for f, r in faults.items()
              if chip_smoke.fault_required(kern, f)]
    for causal in (True, False):
        want_r = fa.flash_attention_reference(q, k, v, causal)
        caught += [chip_smoke.tile_rel_err(chip_smoke.faulty_plain(
            q, k, v, f, causal), want_r) / chip_smoke.FLASH_TOL[dtype]["out"]
            for f in chip_smoke.FLASH_RECT_FAULTS
            if chip_smoke.fault_applies(f, t, causal)]
    assert caught and min(caught) > 1


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(16, 40, 48), (24, 20, 36),
                                   (200, 136, 264)])
def test_planted_faults_read_over_the_gemm_limits_at_edge_shapes(
        m, k, n, dtype, quant):
    """At phase 26's GEMM edge shapes every planted fault that applies
    reads over GEMM_TOL, the last-tile faults at the kernel's ragged last
    tile, and the fault model without a fault is the plain version."""
    import chip_smoke

    from tpumon_torch.ops import matmul as mm
    from tpumon_torch.ops import quant_matmul as qm

    a, b, sc = chip_smoke.gemm_case(torch.Generator().manual_seed(m), m, k,
                                    n, getattr(torch, dtype), quant)
    want = (qm.quantized_matmul_reference(a, b, sc) if quant
            else mm.matmul_reference(a, b))
    assert chip_smoke.gemm_tile_rel_err(
        chip_smoke.gemm_faulty_plain(a, b, sc, None), want) <= 1e-6
    readings = chip_smoke.gemm_fault_readings(a, b, sc, want)
    assert "last_tile_unwritten" in readings
    assert min(readings.values()) > chip_smoke.GEMM_TOL[dtype], readings
