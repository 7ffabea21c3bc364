"""The port's flash attention against the JAX reference kernels.

Inputs are made once with numpy from a seed; JAX runs its Pallas kernels
in interpret mode on the CPU (as tests/test_flash_attention.py does),
the port runs its plain versions (every CPU tensor does).

Tolerances, max abs: f32 out and lse 1e-5, gradients 2e-4, the
reference test's own bounds (summation order only). bf16: 6e-2, the
reference test's bf16 bound: the reference rounds P and dS to bf16 per
128-row block, the plain versions per whole row, so those roundings
differ by an ulp here and there, and outputs carry bf16's 2^-8.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import jax_f32, to_jax, to_torch, torch_f32  # noqa: E402
from tpumon.loadgen import ring_attention as jax_ring  # noqa: E402
from tpumon.ops import flash_attention as jax_fa  # noqa: E402
from tpumon_torch.loadgen import ring_attention  # noqa: E402
from tpumon_torch.ops import flash_attention as fa  # noqa: E402
from tpumon_torch.ops import flash_variants  # noqa: E402

TOL = {"float32": {"out": 1e-5, "lse": 1e-5, "grad": 2e-4},
       "bfloat16": {"out": 6e-2, "lse": 1e-5, "grad": 6e-2}}


def case(bh=3, t=384, d=64, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, t, d), np.float32) for _ in range(4)]


def assert_close(got, want, atol):
    np.testing.assert_allclose(torch_f32(got), jax_f32(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(384, 64), (128, 32)])
def test_forward_and_lse_match_reference(dtype, t, d):
    q, k, v, _ = case(t=t, d=d)
    jout, jlse = jax_fa.flash_attention_tri_fwd(
        *to_jax((q, k, v), jnp.dtype(dtype)), interpret=True)
    out, lse = fa.flash_attention_tri_fwd(
        *to_torch((q, k, v), getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    assert_close(out, jout, TOL[dtype]["out"])
    assert_close(lse, jlse, TOL[dtype]["lse"])
    assert torch.equal(out, fa.flash_attention_tri(
        *to_torch((q, k, v), getattr(torch, dtype))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d,block", [(384, 64, 128), (320, 64, 64)])
def test_backward_matches_reference(dtype, t, d, block):
    """Both packages' backward on the same q/k/v/out/lse/dout: the
    reference forward's out and lse, fed to both. T = 320 = 5 x 64 at
    64-row blocks: the bf16 kernels' 128-row owned tiles reach past T
    there (the CUDA tests hold the kernels to these plain versions)."""
    q, k, v, g = case(t=t, d=d)
    jq, jk, jv, jg = to_jax((q, k, v, g), jnp.dtype(dtype))
    jout, jlse = jax_fa.flash_attention_tri_fwd(jq, jk, jv, block=block,
                                                interpret=True)
    want = jax_fa.flash_attention_tri_bwd(jq, jk, jv, jout, jlse, jg,
                                          block=block, interpret=True)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = to_torch((q, k, v, g), tdt)
    out = torch.tensor(jax_f32(jout)).to(tdt)
    got = fa.flash_attention_tri_bwd(tq, tk, tv, out,
                                     torch.tensor(jax_f32(jlse)), tg,
                                     block=block)
    for a, b in zip(got, want):
        assert a.dtype == tdt
        assert_close(a, b, TOL[dtype]["grad"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,t", [(d, t) for d in (32, 64, 128)
                                 for t in (128, 384)]
                         + [(d, t) for d in (64, 128) for t in (192, 320)])
def test_planted_faults_read_over_the_card_limits(dtype, d, t):
    """The limits the CUDA kernels are held to (chip_smoke.FLASH_TOL, also
    tests/test_torch_cuda.py's, at its shapes) catch every planted fault
    of a tiled kernel that applies at this T: each reads over its limit
    here, where the plain versions compute them. Without a fault each
    model is the plain versions: the forward's at its 128-row tiles, each
    backward kernel's at its own (chip_smoke.BWD_TILES)."""
    import chip_smoke

    q, k, v, g = to_torch(case(t=t, d=d), getattr(torch, dtype))
    want = {}
    want["out"], lse = fa.flash_attention_tri_fwd_reference(q, k, v)
    dvec = (g.float() * want["out"].float()).sum(-1)
    want["dq"] = fa.flash_attention_tri_bwd_dq_reference(q, k, v, g, lse,
                                                         dvec)
    want["dk"], want["dv"] = fa.flash_attention_tri_bwd_dkv_reference(
        q, k, v, g, lse, dvec)
    clean = chip_smoke.faulty_plain(q, k, v, None)
    assert chip_smoke.tile_rel_err(clean, want["out"]) <= 1e-6
    for kernel in chip_smoke.BWD_TILES:
        clean = chip_smoke.faulty_grads(q, k, v, g, lse, dvec, None, kernel)
        assert set(clean) == set(chip_smoke.FLASH_OUTPUTS[kernel])
        for name, x in clean.items():
            assert chip_smoke.tile_rel_err(x, want[name]) <= 1e-6
    readings = chip_smoke.fault_readings(q, k, v, g, lse, dvec, want)
    caught = {f"{kernel}:{fault}": r / chip_smoke.flash_limit(kernel, dtype)
              for kernel, faults in readings.items()
              for fault, r in faults.items()
              if chip_smoke.fault_required(kernel, fault)}
    # Forward: diag_unmasked, last_diag_dropped, wg1_mask_offset, and
    # past one 128-row k tile no_rescale and stale_stage; each backward
    # kernel (T > 64 here, so a second streamed tile and a second
    # warpgroup's rows): diag_unmasked, last_diag_dropped, no_d,
    # stale_stage, wg1_mask_offset, row_stats_offset, and in bf16
    # unrounded.
    fwd = 3 + (2 if t > chip_smoke.FWD_TILE else 0)
    assert len(caught) == fwd + 2 * (6 if dtype == "float32" else 7)
    assert min(caught.values()) > 1, caught


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_rect_forward_matches_reference(causal, dtype):
    """The rectangular forward against the reference's rectangular
    kernel, 2 x 2 blocks of 128; the reference test's own bounds (f32
    2e-5, bf16 6e-2)."""
    q, k, v, _ = case(t=256, d=64)
    want = jax_fa.flash_attention(*to_jax((q, k, v), jnp.dtype(dtype)),
                                  causal=causal, interpret=True)
    got = fa.flash_attention(*to_torch((q, k, v), getattr(torch, dtype)),
                             causal=causal)
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, 2e-5 if dtype == "float32" else 6e-2)
    if causal:  # the triangle forward computes the same function
        assert torch.equal(got, fa.flash_attention_tri(
            *to_torch((q, k, v), getattr(torch, dtype))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_rect_planted_faults_read_over_the_card_limit(causal, dtype):
    """The forward faults that apply to the rectangular kernel read over
    the out limit (chip_smoke.FLASH_TOL) at the card tests' shapes."""
    import chip_smoke

    tol = chip_smoke.FLASH_TOL[dtype]["out"]
    for d, t in ((32, 128), (64, 384), (128, 128), (64, 192), (128, 320)):
        q, k, v, _ = to_torch(case(t=t, d=d), getattr(torch, dtype))
        want = fa.flash_attention_reference(q, k, v, causal)
        clean = chip_smoke.faulty_plain(q, k, v, None, causal)
        assert chip_smoke.tile_rel_err(clean, want) <= 1e-6
        for fault in chip_smoke.FLASH_RECT_FAULTS:
            if not chip_smoke.fault_applies(fault, t, causal):
                continue
            got = chip_smoke.faulty_plain(q, k, v, fault, causal)
            assert chip_smoke.tile_rel_err(got, want) > tol, (fault, d, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_at_t_320_matches_reference(causal, dtype):
    """T = 320 = 5 x 64, where the bf16 kernel's last 128-row q and k
    tiles reach past T: the plain forward against the reference kernels
    at 64-row blocks (the triangle forward's out and lse, the rectangular
    forward's out), at this file's bounds."""
    q, k, v, _ = case(t=320, d=64)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    jq, jk, jv = to_jax((q, k, v), jdt)
    tq, tk, tv = to_torch((q, k, v), tdt)
    want = jax_fa.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                  block_k=64, interpret=True)
    got = fa.flash_attention(tq, tk, tv, causal=causal, block_q=64,
                             block_k=64)
    assert_close(got, want, TOL[dtype]["out"])
    if causal:
        jout, jlse = jax_fa.flash_attention_tri_fwd(jq, jk, jv, block=64,
                                                    interpret=True)
        out, lse = fa.flash_attention_tri_fwd(tq, tk, tv, block=64)
        assert_close(out, jout, TOL[dtype]["out"])
        assert_close(lse, jlse, TOL[dtype]["lse"])


def test_kernels_reject_bad_shapes_and_types():
    q, k, v, _ = to_torch(case(bh=2, t=200, d=64))
    with pytest.raises(ValueError, match="multiple of block"):
        fa.flash_attention_tri_fwd(q, k, v)  # the reference asserts here
    with pytest.raises(AssertionError):
        jax_fa.flash_attention_tri_fwd(*to_jax(case(bh=2, t=200, d=64)[:3]),
                                       interpret=True)
    q, k, v, _ = to_torch(case(bh=2, t=128, d=32))
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_tri_fwd(q, k[:1], v)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_tri_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_tri_bwd_dq(q, k, v, q, torch.zeros(2, 64),
                                      torch.zeros(2, 128))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention_tri_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="multiple of block=256"):
        fa.flash_attention(q, k, v, block_q=128, block_k=256)
    with pytest.raises(AssertionError):  # the reference asserts here
        jax_fa.flash_attention(*to_jax(case(bh=2, t=128, d=32)[:3]),
                               block_k=256, interpret=True)


def test_cpu_tensors_run_the_plain_versions_and_count_nothing():
    q, k, v, g = to_torch(case(bh=1, t=128, d=32))
    counters = (fa.flash_attention_tri_fwd, fa.flash_attention_tri_bwd_dq,
                fa.flash_attention_tri_bwd_dkv, fa.flash_attention)
    before = [f.launches for f in counters]
    out, lse = fa.flash_attention_tri_fwd(q, k, v)
    fa.flash_attention_tri_bwd(q, k, v, out, lse, g)
    fa.flash_attention(q, k, v, causal=False)
    assert [f.launches for f in counters] == before
    assert torch.equal(out, fa.flash_attention_tri_fwd_reference(q, k, v)[0])


@pytest.mark.parametrize(
    "kernel,name",
    [("fwd", n) for n in sorted(flash_variants.VARIANTS)]
    + [("bwd", n) for n in sorted(flash_variants.BWD_VARIANTS)],
    ids=[*sorted(flash_variants.VARIANTS),
         *(f"bwd-{n}" for n in sorted(flash_variants.BWD_VARIANTS))])
def test_flash_variants_apply_to_the_kernel_source(kernel, name):
    """Every source variant that tpumon_torch.ops.flash_variants times on
    the card finds its substitution targets in its source (the forward's
    csrc/flash_fwd.cuh, the backward's csrc/flash_attention_tri_bwd.cu),
    and only the built kernel is the unchanged source."""
    subs = flash_variants.SOURCES[kernel][2][name]
    src = flash_variants.variant_source(subs, kernel)
    assert (src == flash_variants.variant_source((), kernel)) == (not subs)


def test_ring_attention_pieces_match_reference():
    """The chunked schedule's copied pieces: the plain oracle, and the
    block update over two blocks equals the oracle."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 48, 4, 16), np.float32)
               for _ in range(3))
    want = jax_ring.reference_attention(*to_jax((q, k, v)))
    got = ring_attention.reference_attention(*to_torch((q, k, v)))
    assert_close(got, want, 1e-5)
    tq, tk, tv = to_torch((q, k, v))
    m = torch.full((2, 4, 48), float("-inf"))
    el = torch.zeros(2, 4, 48)
    o = torch.zeros(2, 48, 4, 16)
    jm, jl, jo = jnp.asarray(m.numpy()), jnp.asarray(el.numpy()), jnp.asarray(
        o.numpy())
    for j in (0, 24):
        m, el, o = ring_attention._block_attend(
            tq, tk[:, j:j + 24], tv[:, j:j + 24], 0, j, 0.25, True, m, el, o)
        jm, jl, jo = jax_ring._block_attend(
            *to_jax((q, k[:, j:j + 24], v[:, j:j + 24])), 0, j, 0.25, True,
            jm, jl, jo)
    for a, b in ((m, jm), (el, jl), (o, jo)):
        assert_close(a, b, 1e-5)
    assert_close(o / el.transpose(1, 2)[..., None], want, 1e-5)
