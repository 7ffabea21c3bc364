"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip elsewhere (the kernels have no
CPU mode). They import no JAX, so they run on a GPU host as they are:

    python -m pytest tests/test_torch_cuda.py -q

Every kernel is held to its plain version by chip_smoke.py's metrics
and limits: the paged kernel by rows_rel_err (worst relative error over
the (sequence, head) rows of length > 0) under PAGED_TOL, the flash
kernels by tile_rel_err under FLASH_TOL, the GEMM kernels by
gemm_tile_rel_err under GEMM_TOL. The reasons, the kernels' readings on
the card and what planted faults read are in chip_smoke.py and PERF.md;
the CPU tests check that the faults read over these limits at this
file's shapes.
"""

import pytest

torch = pytest.importorskip("torch")

# By bare name, not as ``tests.torch_parity``: a GPU host's site-packages
# may hold a ``tests`` package of its own, which shadows this directory.
from chip_smoke import (  # noqa: E402
    FLASH_TOL,
    GEMM_TOL,
    PAGED_TOL,
    gemm_tile_rel_err,
    rows_rel_err,
    tile_rel_err,
)
from torch_parity import (  # noqa: E402
    GEMM_CARD_CASES,
    PAGED_CARD_CASE,
    PAGED_CARD_SHAPES,
    PAGED_SPLIT_CARD_CASES,
    paged_case,
    to_torch,
)
from tpumon_torch.ops.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PAGED_CARD_SHAPES)
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    case = paged_case(**PAGED_CARD_CASE, **shape)
    args = [t.to(cuda_device) for t in to_torch(case, dtype)]
    before = paged_attention.launches
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(*args)
    assert torch.isfinite(out.float()).all()
    assert rows_rel_err(out, ref, args[4]) <= PAGED_TOL[str(dtype)[6:]]
    zero = [i for i, n in enumerate(shape["lengths"]) if n == 0]
    assert torch.equal(out[zero].float(), torch.zeros_like(out[zero].float()))


def test_kernel_rejects_unsupported_sizes_on_card(cuda_device):
    case = paged_case(nh=4, nkv=2, hd=16)
    args = [t.to(cuda_device) for t in to_torch(case)]
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(*args)


def test_kernel_reads_a_parked_slots_repeated_trash_page(cuda_device):
    """The engine parks free and mid-prefill slots at the last row with a
    table of trash page 0: the kernel walks every page, all of them page
    0, without fault, and still agrees with the plain version."""
    case = list(paged_case(b=3, nh=16, nkv=2, hd=128, num_pages=9,
                           page_size=16, max_pages=4, lengths=(64, 5, 33),
                           seed=9))
    case[3][0] = 0  # slot 0: parked — all-trash table at full length
    args = [t.to(cuda_device) for t in to_torch(case, torch.bfloat16)]
    out = paged_attention(*args)  # group 8, the kernel's largest
    torch.cuda.synchronize()
    ref = paged_attention_reference(*args)
    assert torch.isfinite(out.float()).all()
    assert rows_rel_err(out, ref, args[4]) <= PAGED_TOL["bfloat16"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(PAGED_SPLIT_CARD_CASES)))
def test_split_kernel_matches_plain_on_card(cuda_device, case, dtype):
    """The page axis split across CTAs at the wrapper's pages_per_split:
    a sequence over 4 splits ending in a partial page, mixed lengths whose
    splits end at different points, all rows but one of length 0. One
    launch; the same bits on a second call (the partials merge in split
    order, whichever CTA arrives last)."""
    from tpumon_torch.ops.paged_attention import pages_per_split

    spec = PAGED_SPLIT_CARD_CASES[case]
    args = [t.to(cuda_device) for t in to_torch(paged_case(**spec), dtype)]
    assert pages_per_split(spec["b"], spec["nkv"], spec["max_pages"],
                           spec["page_size"]) < spec["max_pages"]
    before = paged_attention.launches
    out = paged_attention(*args)
    again = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 2
    ref = paged_attention_reference(*args)
    assert torch.isfinite(out.float()).all()
    assert rows_rel_err(out, ref, args[4]) <= PAGED_TOL[str(dtype)[6:]]
    assert torch.equal(out, again)
    zero = [i for i, n in enumerate(spec["lengths"]) if n == 0]
    assert torch.equal(out[zero].float(), torch.zeros_like(out[zero].float()))


@pytest.mark.parametrize("pages,stages", [(1, 2), (3, 4), (64, 0), (5, 6)])
def test_split_kernel_at_other_splits_and_rings_on_card(cuda_device, pages,
                                                        stages):
    """The kernel at pages per split and ring depths other than the rule's
    (3 does not divide the 64-entry table; 64 is one split) agrees with
    the plain version too."""
    from tpumon_torch.ops.paged_attention import _launch

    args = [t.to(cuda_device) for t in to_torch(
        paged_case(**PAGED_SPLIT_CARD_CASES[0]), torch.bfloat16)]
    out = _launch(*args, pages=pages, stages=stages)
    torch.cuda.synchronize()
    ref = paged_attention_reference(*args)
    assert rows_rel_err(out, ref, args[4]) <= PAGED_TOL["bfloat16"]


# --- the causal flash-attention kernels (training path) -------------------

# Kernel vs plain version: chip_smoke.py's limits and metric. out and the
# gradients are held to their worst relative error over 64-row tiles
# (causal outputs shrink along the sequence, so one absolute limit would
# not see the late rows), lse to max abs. The reasons, the kernels'
# readings and what planted faults read are in chip_smoke.py and PERF.md;
# tests/test_torch_flash_attention.py checks on the CPU that the faults
# read over these limits at this file's shapes.
FLASH_CASES = [(hd, t) for hd in (32, 64, 128) for t in (128, 384)] + [
    (hd, t) for hd in (64, 128) for t in (192, 320)]  # T = 64 x odd


def flash_inputs(device, dtype, hd, t, bh=3, seed=7):
    """q, k, v, dout from a seed; out, lse and D from the plain forward."""
    from tpumon_torch.ops.flash_attention import (
        flash_attention_tri_fwd_reference,
    )

    gen = torch.Generator().manual_seed(seed + hd + t)
    q, k, v, g = (torch.randn(bh, t, hd, generator=gen).to(device, dtype)
                  for _ in range(4))
    out, lse = flash_attention_tri_fwd_reference(q, k, v)
    dvec = (g.float() * out.float()).sum(-1)
    return q, k, v, g, out, lse, dvec


def _close(got, want, key):
    """got within chip_smoke's limit ``key`` ("out", "grad" or "lse") of
    want: tile-wise relative for [BH, T, D] outputs, max abs for lse."""
    tol = FLASH_TOL[str(want.dtype).split(".")[1]][key]
    assert torch.isfinite(got.float()).all()
    if key == "lse":
        torch.testing.assert_close(got, want, atol=tol, rtol=0)
    else:
        assert tile_rel_err(got, want) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,t", FLASH_CASES)
def test_flash_fwd_kernel_matches_plain_on_card(cuda_device, dtype, hd, t):
    from tpumon_torch.ops import flash_attention as fa

    q, k, v, _, want, want_lse, _ = flash_inputs(cuda_device, dtype, hd, t)
    before = fa.flash_attention_tri_fwd.launches
    out, lse = fa.flash_attention_tri_fwd(q, k, v, block=64)
    torch.cuda.synchronize()
    assert fa.flash_attention_tri_fwd.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, want, "out")
    _close(lse, want_lse, "lse")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,t", FLASH_CASES)
def test_flash_dq_kernel_matches_plain_on_card(cuda_device, dtype, hd, t):
    from tpumon_torch.ops import flash_attention as fa

    q, k, v, g, _, lse, dvec = flash_inputs(cuda_device, dtype, hd, t)
    before = fa.flash_attention_tri_bwd_dq.launches
    dq = fa.flash_attention_tri_bwd_dq(q, k, v, g, lse, dvec, block=64)
    torch.cuda.synchronize()
    assert fa.flash_attention_tri_bwd_dq.launches == before + 1
    want = fa.flash_attention_tri_bwd_dq_reference(q, k, v, g, lse, dvec)
    assert dq.dtype == dtype
    _close(dq, want, "grad")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,t", FLASH_CASES)
def test_flash_dkv_kernel_matches_plain_on_card(cuda_device, dtype, hd, t):
    from tpumon_torch.ops import flash_attention as fa

    q, k, v, g, _, lse, dvec = flash_inputs(cuda_device, dtype, hd, t)
    before = fa.flash_attention_tri_bwd_dkv.launches
    dk, dv = fa.flash_attention_tri_bwd_dkv(q, k, v, g, lse, dvec, block=64)
    torch.cuda.synchronize()
    assert fa.flash_attention_tri_bwd_dkv.launches == before + 1
    want_dk, want_dv = fa.flash_attention_tri_bwd_dkv_reference(
        q, k, v, g, lse, dvec)
    _close(dk, want_dk, "grad")
    _close(dv, want_dv, "grad")


def test_flash_kernels_reject_unsupported_sizes_on_card(cuda_device):
    from tpumon_torch.ops.flash_attention import flash_attention_tri_fwd

    q = torch.randn(2, 128, 16, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_tri_fwd(q, q, q)
    q = torch.randn(2, 96, 64, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash_attention_tri_fwd(q, q, q, block=32)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launch_counts_on_card(cuda_device, remat):
    """One flash train step launches each backward kernel once per layer
    and the forward kernel once per layer, twice under remat (the
    checkpointed layer recomputes its forward in the backward pass)."""
    from tpumon_torch.loadgen.model import ModelConfig, init_params
    from tpumon_torch.loadgen.model import sgd_train_step
    from tpumon_torch.ops import flash_attention as fa

    cfg = ModelConfig(vocab=128, d_model=128, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=256, max_seq=128,
                      compute_dtype="bfloat16", attention="flash",
                      attn_block_k=128, remat=remat)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_params(cfg, gen)
    tokens = torch.randint(0, 128, (2, 65), generator=gen,
                           device=cuda_device)
    kernels = (fa.flash_attention_tri_fwd, fa.flash_attention_tri_bwd_dq,
               fa.flash_attention_tri_bwd_dkv)
    before = [k.launches for k in kernels]
    _, loss = sgd_train_step(cfg, params, tokens)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    got = [k.launches - b for k, b in zip(kernels, before)]
    assert got == [cfg.n_layers * (2 if remat else 1), cfg.n_layers,
                   cfg.n_layers]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,t", FLASH_CASES)
def test_flash_rect_kernel_matches_plain_on_card(cuda_device, dtype, hd, t,
                                                 causal):
    from tpumon_torch.ops import flash_attention as fa

    q, k, v = flash_inputs(cuda_device, dtype, hd, t)[:3]
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert out.dtype == dtype
    _close(out, fa.flash_attention_reference(q, k, v, causal), "out")


# --- the GEMM kernels (burn path) -----------------------------------------

def gemm_inputs(device, dtype, m, k, n, seed=3):
    gen = torch.Generator().manual_seed(seed + m + k + n)
    a = torch.randn(m, k, generator=gen).to(device, dtype)
    b = torch.randn(k, n, generator=gen).to(device, dtype)
    q = torch.randint(-127, 128, (k, n), generator=gen,
                      dtype=torch.int8).to(device)
    scale = ((1 + 0.25 * torch.randn(n, generator=gen)) / 127).to(device)
    return a, b, q, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", GEMM_CARD_CASES)
def test_matmul_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    from tpumon_torch.ops.matmul import matmul, matmul_reference

    a, b, _, _ = gemm_inputs(cuda_device, dtype, m, k, n)
    before = matmul.launches
    c = matmul(a, b, block_m=128, block_n=128, block_k=k)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1 and c.dtype == dtype
    assert torch.isfinite(c.float()).all()
    assert gemm_tile_rel_err(c, matmul_reference(a, b)) <= GEMM_TOL[
        str(dtype)[6:]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", GEMM_CARD_CASES)
def test_quantized_kernel_matches_plain_on_card(cuda_device, dtype, m, k, n):
    from tpumon_torch.ops.quant_matmul import (
        quantized_matmul_kernel,
        quantized_matmul_reference,
    )

    a, _, q, scale = gemm_inputs(cuda_device, dtype, m, k, n)
    before = quantized_matmul_kernel.launches
    c = quantized_matmul_kernel(a, q, scale, block_m=128, block_n=128,
                                block_k=k)
    torch.cuda.synchronize()
    assert quantized_matmul_kernel.launches == before + 1 and c.dtype == dtype
    assert torch.isfinite(c.float()).all()
    assert gemm_tile_rel_err(c, quantized_matmul_reference(a, q, scale)) <= (
        GEMM_TOL[str(dtype)[6:]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_kernel_applies_scale_once_on_card(cuda_device, dtype):
    from tpumon_torch.ops.quant_matmul import quantized_matmul_kernel

    out = quantized_matmul_kernel(
        torch.ones(128, 256, device=cuda_device, dtype=dtype),
        torch.ones(256, 128, device=cuda_device, dtype=torch.int8),
        torch.full((128,), 0.5, device=cuda_device), block_m=128,
        block_n=128, block_k=128)
    assert torch.equal(out.float(), torch.full_like(out.float(), 128.0))


def test_gemm_fallback_and_rejects_on_card(cuda_device):
    from tpumon_torch.ops.matmul import matmul
    from tpumon_torch.ops.quant_matmul import (
        quantized_matmul,
        quantized_matmul_kernel,
    )

    a, _, q, scale = gemm_inputs(cuda_device, torch.float32, 128, 64, 128)
    before = quantized_matmul_kernel.launches
    out = quantized_matmul(a[:4], q[:, :48].contiguous(), scale[:48])
    assert quantized_matmul_kernel.launches == before
    assert torch.equal(out, a[:4] @ (q[:, :48].float() * scale[:48]))
    x = torch.randn(64, 64, device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 128"):
        matmul(x, x, block_m=64, block_n=64, block_k=64)


def test_burn_programs_launch_once_per_link_on_card(cuda_device):
    from tpumon_torch.loadgen import burn
    from tpumon_torch.ops.matmul import matmul
    from tpumon_torch.ops.quant_matmul import quantized_matmul_kernel

    for prog, kernel in ((burn._mxu_burn_program, matmul),
                         (burn._int8_burn_program, quantized_matmul_kernel)):
        before = kernel.launches
        total = burn._sync(prog(0, 1024, 3, use_kernel=True,
                                device=cuda_device))
        assert kernel.launches == before + 3
        lib = burn._sync(prog(0, 1024, 3, use_kernel=False,
                              device=cuda_device))
        assert kernel.launches == before + 3
        assert abs(total - lib) <= 2e-2 * abs(lib) + 1e-6
