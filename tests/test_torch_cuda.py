"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip elsewhere (the kernels have no
CPU mode). They import no JAX, so they run on a GPU host as they are:

    python -m pytest tests/test_torch_cuda.py -q

Every kernel is held to its plain version by chip_smoke.py's metrics
and limits: the paged kernel by rows_rel_err (worst relative error over
the (sequence, head) rows of length > 0) under PAGED_TOL, the chunk
attention of the paged prefill by chunk_rows_rel_err (over the chunk's
(row, head) rows) under PREFILL_TOL, the flash
kernels by tile_rel_err under FLASH_TOL, the GEMM kernels by
gemm_tile_rel_err under GEMM_TOL, the fused threefry draws element for
element (they compute what their plain versions compute, rounded alike).
The reasons, the kernels' readings on
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
from chip_smoke import (  # noqa: E402
    PREFILL_CARD_SHAPES,
    PREFILL_LENGTHS,
    PREFILL_STARTS,
    PREFILL_TOL,
    chunk_rows_rel_err,
    prefill_fault_readings,
    prefill_inputs,
)
from chip_smoke import (  # noqa: E402
    FLASH_SHAPE_CASES,
    GEMM_EDGE_CASES,
    PAGED_COPY_HEAD_DIMS,
    PAGED_GROUPS,
    PAGED_HEAD_DIMS,
    PAGED_PAGE_SIZES,
)
from torch_parity import (  # noqa: E402
    GEMM_CARD_CASES,
    PAGED_CARD_CASE,
    PAGED_CARD_SHAPES,
    PAGED_SPLIT_CARD_CASES,
    paged_case,
    paged_head_dim_case,
    to_torch,
)
from tpumon_torch.ops.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_reference,
)

pytestmark = pytest.mark.cuda

# The shapes the paged kernel took in PR 16, at PAGED_CARD_CASE's batch:
# head_dim 16 at tests/test_paged_attention.py's heads and page, and a GQA
# group of 16 (two group tiles of 8 query heads); and a split case with a
# group of 12 (tiles of 8 and 4: the workspace's tile stride past the
# last tile's heads).
PAGED_WIDE_SHAPES = [
    {"nh": 4, "nkv": 2, "hd": 16, "page_size": 8,
     "lengths": (5, 17, 32, 0, 1, 31)},
    {"nh": 32, "nkv": 2, "hd": 128, "page_size": 16,
     "lengths": (0, 1, 15, 16, 17, 64)},
]
PAGED_WIDE_SPLIT_CASE = dict(b=3, nh=24, nkv=2, hd=64, page_size=8,
                             max_pages=96, num_pages=200,
                             lengths=(700, 0, 333), seed=14)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PAGED_CARD_SHAPES + PAGED_WIDE_SHAPES)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [264, 512, 1024])
def test_kernel_rejects_unsupported_sizes_on_card(cuda_device, hd, dtype):
    """No head dim is refused now: above 256 the kernel takes its sliced
    route (264 among them, refused until then), one launch a call,
    against the plain version, at one split and at several (a group of
    12), the pool read in place."""
    for spec in (dict(PAGED_CARD_CASE, **PAGED_WIDE_SHAPES[0]) | {
            "hd": hd}, dict(PAGED_WIDE_SPLIT_CASE, hd=hd)):
        args = [t.to(cuda_device) for t in to_torch(paged_case(**spec),
                                                     dtype)]
        pool = args[1].clone()
        before = paged_attention.launches
        out = paged_attention(*args)
        torch.cuda.synchronize()
        assert paged_attention.launches == before + 1
        assert out.shape == args[0].shape and torch.equal(args[1], pool)
        ref = paged_attention_reference(*args)
        assert torch.isfinite(out.float()).all()
        assert rows_rel_err(out, ref, args[4]) <= PAGED_TOL[str(dtype)[6:]]
        zero = [i for i, n in enumerate(spec["lengths"]) if n == 0]
        assert torch.equal(out[zero].float(),
                           torch.zeros_like(out[zero].float()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_size", PAGED_PAGE_SIZES)
@pytest.mark.parametrize("nh,nkv", PAGED_GROUPS)
@pytest.mark.parametrize("hd", PAGED_HEAD_DIMS + PAGED_COPY_HEAD_DIMS)
def test_kernel_takes_every_head_dim_on_card(cuda_device, hd, nh, nkv,
                                             page_size, dtype):
    """Every head dim up to 256 runs in the next instance's tile (the
    columns past it zeros, the pool read in place), at GQA groups 1, 8 and
    16 (f32 at the 256 instance: group tiles of 4), against the plain
    version; one launch, no copy of the pool."""
    args = [t.to(cuda_device) for t in to_torch(
        paged_head_dim_case(hd, nh, nkv, page_size), dtype)]
    pool = args[1].clone()
    before = paged_attention.launches
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    assert out.shape == args[0].shape and torch.equal(args[1], pool)
    ref = paged_attention_reference(*args)
    assert torch.isfinite(out.float()).all()
    assert rows_rel_err(out, ref, args[4]) <= PAGED_TOL[str(dtype)[6:]]
    assert torch.equal(out[2].float(), torch.zeros_like(out[2].float()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [96, 192, 256, 12])
def test_split_kernel_at_wide_head_dims_on_card(cuda_device, hd, dtype):
    """The split design at head dims past 128 and between instances: a
    table the rule splits several ways, a group of 12 (f32 at 256: tiles
    of 4, 4 and 4), the partials merged in one launch, the same bits on a
    second call."""
    from tpumon_torch.ops.paged_attention import pages_per_split

    spec = dict(PAGED_WIDE_SPLIT_CASE, hd=hd)
    args = [t.to(cuda_device) for t in to_torch(paged_case(**spec), dtype)]
    assert pages_per_split(spec["b"], spec["nkv"], spec["max_pages"],
                           spec["page_size"]) < spec["max_pages"]
    out = paged_attention(*args)
    again = paged_attention(*args)
    torch.cuda.synchronize()
    ref = paged_attention_reference(*args)
    assert rows_rel_err(out, ref, args[4]) <= PAGED_TOL[str(dtype)[6:]]
    assert torch.equal(out, again)


def test_kernel_reads_a_parked_slots_repeated_trash_page(cuda_device):
    """The engine parks free and mid-prefill slots at the last row with a
    table of trash page 0: the kernel walks every page, all of them page
    0, without fault, and still agrees with the plain version."""
    case = list(paged_case(b=3, nh=16, nkv=2, hd=128, num_pages=9,
                           page_size=16, max_pages=4, lengths=(64, 5, 33),
                           seed=9))
    case[3][0] = 0  # slot 0: parked — all-trash table at full length
    args = [t.to(cuda_device) for t in to_torch(case, torch.bfloat16)]
    out = paged_attention(*args)  # group 8, one group tile
    torch.cuda.synchronize()
    ref = paged_attention_reference(*args)
    assert torch.isfinite(out.float()).all()
    assert rows_rel_err(out, ref, args[4]) <= PAGED_TOL["bfloat16"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_prefix_shared_pages_on_card(cuda_device, dtype):
    """Prefix caching points several tables at the same pages (the
    paged prefix cache's sharing): sequences 0, 2 and 3 share sequence
    1's first two pages, at lengths that end inside and past them, and
    the kernel agrees with the plain version on every row."""
    case = list(paged_case(b=4, nh=16, nkv=2, hd=128, num_pages=40,
                           page_size=16, max_pages=8,
                           lengths=(40, 100, 33, 128), seed=21))
    table = case[3]
    for row in (0, 2, 3):
        table[row, :2] = table[1, :2]
    args = [t.to(cuda_device) for t in to_torch(case, dtype)]
    out = paged_attention(*args)
    torch.cuda.synchronize()
    ref = paged_attention_reference(*args)
    assert torch.isfinite(out.float()).all()
    assert rows_rel_err(out, ref, args[4]) <= PAGED_TOL[str(dtype)[6:]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(PAGED_SPLIT_CARD_CASES) + 1))
def test_split_kernel_matches_plain_on_card(cuda_device, case, dtype):
    """The page axis split across CTAs at the wrapper's pages_per_split:
    a sequence over 4 splits ending in a partial page, mixed lengths whose
    splits end at different points, all rows but one of length 0. One
    launch; the same bits on a second call (the partials merge in split
    order, whichever CTA arrives last)."""
    from tpumon_torch.ops.paged_attention import pages_per_split

    spec = (PAGED_SPLIT_CARD_CASES + [PAGED_WIDE_SPLIT_CASE])[case]
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
    (hd, t) for hd in (64, 128) for t in (192, 320)] + [  # T = 64 x odd
    (8, 128), (16, 128), (16, 384), (48, 192)]  # D zero-padded to 32 / 64


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [264, 512, 1024])
def test_flash_kernels_reject_unsupported_sizes_on_card(cuda_device, hd,
                                                        dtype):
    """No head dim is refused now: above 256 the forward (out, lse), dQ,
    dK/dV and the rectangular forward take the sliced route (264 among
    them, refused until then), each one launch, against the plain
    versions; T is held to the caller's block alone (T 96 at block 32)."""
    from tpumon_torch.ops import flash_attention as fa

    q, k, v, g, want, want_lse, dvec = flash_inputs(cuda_device, dtype, hd,
                                                    96)
    kernels = (fa.flash_attention_tri_fwd, fa.flash_attention_tri_bwd_dq,
               fa.flash_attention_tri_bwd_dkv, fa.flash_attention)
    before = [x.launches for x in kernels]
    out, lse = fa.flash_attention_tri_fwd(q, k, v, block=32)
    dq = fa.flash_attention_tri_bwd_dq(q, k, v, g, want_lse, dvec, block=32)
    dk, dv = fa.flash_attention_tri_bwd_dkv(q, k, v, g, want_lse, dvec,
                                            block=32)
    rect = fa.flash_attention(q, k, v, causal=False, block_q=32, block_k=32)
    torch.cuda.synchronize()
    assert [x.launches for x in kernels] == [n + 1 for n in before]
    _close(out, want, "out")
    _close(lse, want_lse, "lse")
    _close(dq, fa.flash_attention_tri_bwd_dq_reference(
        q, k, v, g, want_lse, dvec), "grad")
    want_dk, want_dv = fa.flash_attention_tri_bwd_dkv_reference(
        q, k, v, g, want_lse, dvec)
    _close(dk, want_dk, "grad")
    _close(dv, want_dv, "grad")
    _close(rect, fa.flash_attention_reference(q, k, v, False), "out")


# (head_dim, T, block) beside the shared list: T past several 128-row
# tiles with ragged last ones, T % 4 != 0 (dK/dV's lse and D written by
# the loading thread on every stage), T below a tile.
FLASH_WIDE_CASES = FLASH_SHAPE_CASES + [
    (256, 320, 64), (128, 200, 8), (256, 1000, 8), (64, 50, 5), (256, 7, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,t,block", FLASH_WIDE_CASES)
def test_flash_kernels_at_wide_head_dims_and_ragged_t_on_card(
        cuda_device, dtype, hd, t, block):
    """The forward (out, lse), dQ and dK/dV kernels at head dims past 128
    and at T no multiple of their tiles, each one launch, against the
    plain versions."""
    from tpumon_torch.ops import flash_attention as fa

    q, k, v, g, want, want_lse, dvec = flash_inputs(cuda_device, dtype, hd,
                                                    t)
    kernels = (fa.flash_attention_tri_fwd, fa.flash_attention_tri_bwd_dq,
               fa.flash_attention_tri_bwd_dkv)
    before = [x.launches for x in kernels]
    out, lse = fa.flash_attention_tri_fwd(q, k, v, block=block)
    dq = fa.flash_attention_tri_bwd_dq(q, k, v, g, want_lse, dvec,
                                       block=block)
    dk, dv = fa.flash_attention_tri_bwd_dkv(q, k, v, g, want_lse, dvec,
                                            block=block)
    torch.cuda.synchronize()
    assert [x.launches - b for x, b in zip(kernels, before)] == [1, 1, 1]
    _close(out, want, "out")
    _close(lse, want_lse, "lse")
    _close(dq, fa.flash_attention_tri_bwd_dq_reference(q, k, v, g, want_lse,
                                                       dvec), "grad")
    want_dk, want_dv = fa.flash_attention_tri_bwd_dkv_reference(
        q, k, v, g, want_lse, dvec)
    _close(dk, want_dk, "grad")
    _close(dv, want_dv, "grad")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,t,block", FLASH_WIDE_CASES)
def test_flash_rect_at_wide_head_dims_and_ragged_t_on_card(
        cuda_device, dtype, hd, t, block, causal):
    from tpumon_torch.ops import flash_attention as fa

    q, k, v = flash_inputs(cuda_device, dtype, hd, t)[:3]
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, block_q=block,
                             block_k=block)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    _close(out, fa.flash_attention_reference(q, k, v, causal), "out")


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
    # 64 x 64 at blocks of 64, which the reference takes, runs the kernel
    x = torch.randn(64, 64, device=cuda_device)
    before = matmul.launches
    out = matmul(x, x, block_m=64, block_n=64, block_k=64)
    torch.cuda.synchronize()
    assert matmul.launches == before + 1
    assert gemm_tile_rel_err(out, x @ x) <= GEMM_TOL["float32"]


# (M, K, N) beside the shared edge list: a single row, and tiles past
# every edge at once with the pad route in bf16 and int8.
GEMM_WIDE_CASES = GEMM_EDGE_CASES + [(1, 8, 16), (130, 264, 136),
                                     (300, 37, 77)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", GEMM_WIDE_CASES)
def test_gemm_kernels_at_edge_shapes_on_card(cuda_device, dtype, m, k, n,
                                             quant):
    """Any M, N, K the blocks admit (here blocks equal to the shape):
    edge tiles zero-filled and clipped, the bf16 pad route where TMA's
    16-byte strides do not fit; one launch, against the plain version."""
    from tpumon_torch.ops.matmul import matmul, matmul_reference
    from tpumon_torch.ops.quant_matmul import (
        quantized_matmul_kernel,
        quantized_matmul_reference,
    )

    a, b, q, scale = gemm_inputs(cuda_device, dtype, m, k, n)
    kernel = quantized_matmul_kernel if quant else matmul
    before = kernel.launches
    if quant:
        c = kernel(a, q, scale, block_m=m, block_n=n, block_k=k)
        want = quantized_matmul_reference(a, q, scale)
    else:
        c = kernel(a, b, block_m=m, block_n=n, block_k=k)
        want = matmul_reference(a, b)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert c.shape == (m, n) and c.dtype == dtype
    assert torch.isfinite(c.float()).all()
    assert gemm_tile_rel_err(c, want) <= GEMM_TOL[str(dtype)[6:]]


def test_burn_programs_launch_once_per_link_on_card(cuda_device):
    """One kernel launch per link of a burn program, none on the library
    path; the two chains (from the program's inputs, the reference's
    draws) held together by chip_smoke's burn-chain limit, tile by tile
    (the programs' sums cancel to near zero, a noisy measure of either)."""
    from chip_smoke import CHAIN_TOL

    from tpumon_torch import prng
    from tpumon_torch.loadgen import burn
    from tpumon_torch.ops.matmul import matmul
    from tpumon_torch.ops.quant_matmul import quantized_matmul_kernel

    key = prng.torch_key(0, cuda_device)
    a, b = burn._mxu_inputs(key, 1024)
    a8, q, scale = burn._int8_inputs(key, 1024)
    for prog, kernel, chains in (
            (burn._mxu_burn_program, matmul, (
                lambda: burn._mxu_chain(a, b, 3, matmul),
                lambda: burn._mxu_chain(a, b, 3, torch.matmul))),
            (burn._int8_burn_program, quantized_matmul_kernel, (
                lambda: burn._int8_chain(a8, q, scale, 3,
                                         quantized_matmul_kernel),
                lambda: burn._int8_chain(a8, q, scale, 3,
                                         burn._dequant_matmul)))):
        before = kernel.launches
        assert torch.isfinite(torch.tensor(burn._sync(
            prog(key, 1024, 3, use_kernel=True))))
        assert kernel.launches == before + 3
        burn._sync(prog(key, 1024, 3, use_kernel=False))
        assert kernel.launches == before + 3
        got, want = (f() for f in chains)
        assert gemm_tile_rel_err(got, want) <= CHAIN_TOL


# ---------------------------------------------------------------------------
# Keyed sampling, the torch threefry and the fused decode blocks on the
# card, against the same functions' runs on the CPU (which the CPU tests
# hold to jax.random and the JAX package).
# ---------------------------------------------------------------------------


def test_torch_threefry_on_card_matches_cpu(cuda_device):
    from tpumon_torch import prng

    for seed in (0, 1, 0x7A11, 2**31 + 5):
        kc, kg = prng.torch_key(seed, "cpu"), prng.torch_key(seed, cuda_device)
        ids = torch.tensor([0, 5, -1, 2**31 - 1], dtype=torch.int32)
        assert torch.equal(prng.torch_fold_in(kg, ids.to(cuda_device)).cpu(),
                           prng.torch_fold_in(kc, ids))
        assert torch.equal(prng.torch_random_bits(kg, (3, 1000)).cpu(),
                           prng.torch_random_bits(kc, (3, 1000)))
        assert torch.equal(prng.torch_randint(kg, (64, 64), -127, 128,
                                              torch.int8).cpu(),
                           prng.torch_randint(kc, (64, 64), -127, 128,
                                              torch.int8))
        assert torch.equal(prng.permutation(kg, 2000).cpu(),
                           prng.permutation(kc, 2000))
        for dtype in (torch.float32, torch.bfloat16):
            assert torch.equal(prng.uniform(kg, (4, 999), dtype).cpu(),
                               prng.uniform(kc, (4, 999), dtype))
            assert torch.equal(prng.normal(kg, (64, 1024), dtype).cpu(),
                               prng.normal(kc, (64, 1024), dtype))
        assert torch.equal(prng.gumbel(kg, (16, 4096)).cpu(),
                           prng.gumbel(kc, (16, 4096)))


def _threefry_case_names():
    from test_torch_threefry import CASES

    return sorted(CASES)


@pytest.mark.parametrize("case", _threefry_case_names())
def test_threefry_kernel_matches_plain_on_card(cuda_device, case):
    """Each fused draw (csrc/threefry.cu) equal, element for element, to
    its plain version on the card and on the CPU, with one launch per
    launcher as the wrapper counts them."""
    from test_torch_threefry import CASES, PLAIN

    from tpumon_torch import prng
    from tpumon_torch.ops import threefry

    call, name, launches = CASES[case]
    for seed in (0, 1, 0x7A11, 2**31 + 5):
        k = prng.torch_key(seed, cuda_device)
        before = threefry.launch_counts()
        got = call(getattr(threefry, name), k)
        after = threefry.launch_counts()
        assert got.device.type == "cuda"
        assert torch.equal(got, call(PLAIN[name], k))
        assert torch.equal(got.cpu(), call(PLAIN[name],
                                           prng.torch_key(seed, "cpu")))
        assert {n: after[n] - before[n] for n in after} == {
            n: launches.get(n.removeprefix("threefry_"), 0) for n in after}


def test_sample_tokens_launches_the_fused_draws_on_card(cuda_device):
    """One sampler call: two key launches (rid, then counter) and one
    categorical launch, whatever the rows' temperatures."""
    from tpumon_torch import prng
    from tpumon_torch.loadgen.serving import sample_tokens
    from tpumon_torch.ops import threefry

    i32 = dict(dtype=torch.int32, device=cuda_device)
    logits = torch.randn(16, 4096, device=cuda_device)
    for temps in (torch.zeros(16), torch.full((16,), 0.8)):
        before = threefry.launch_counts()
        sample_tokens(logits, prng.torch_key(0x7A11, cuda_device),
                      torch.arange(16, **i32), torch.zeros(16, **i32),
                      temps.to(cuda_device), torch.zeros(16, **i32))
        after = threefry.launch_counts()
        assert {n: after[n] - before[n] for n in after} == {
            "threefry_keys": 2, "threefry_draw": 0,
            "threefry_categorical": 1}


def test_sample_tokens_on_card_matches_cpu(cuda_device):
    """[16, 4096] logits, greedy and sampled rows with top-k 0, 1 and 50:
    the card's tokens equal the CPU's wherever the winning perturbed
    logit leads by more than 1e-4 (tests/test_torch_sampling.py's rule);
    near-ties stay under 1% of the draws."""
    from tpumon_torch import prng
    from tpumon_torch.loadgen.serving import sample_tokens

    from chip_smoke import SAMPLE_MARGIN, sample_margin

    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(16, 4096, generator=gen) * 3
    temps = torch.tensor([0.0, 0.8, 1.3, 0.8] * 4)
    topk = torch.tensor([0, 0, 50, 1] * 4, dtype=torch.int32)
    rids = torch.arange(16, dtype=torch.int32) * 7
    mismatched, near = 0, 0
    for ctr in range(8):
        ctrs = torch.full((16,), ctr, dtype=torch.int32)
        args = (prng.torch_key(0x7A11, "cpu"), rids, ctrs, temps, topk)
        cpu = sample_tokens(logits, *args)
        card = sample_tokens(logits.to(cuda_device),
                             *(a.to(cuda_device) for a in args)).cpu()
        tie = sample_margin(logits, *args) <= SAMPLE_MARGIN
        near += int(tie.sum())
        mismatched += int(((card != cpu) & ~tie).sum())
    assert mismatched == 0 and near < 0.01 * 16 * 8


def _small_serve(kv_layout, paged_attn="gather"):
    from tpumon_torch.loadgen.model import ModelConfig, init_params
    from tpumon_torch.loadgen.serving import ServeConfig

    cfg = ServeConfig(model=ModelConfig(
        vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq=128, compute_dtype="float32"), slots=3,
        prefill_len=16, kv_layout=kv_layout, paged_attn=paged_attn)
    return cfg, init_params(cfg.model, torch.Generator().manual_seed(3))


def _rounds_case(device, kv_layout, paged_attn, params):
    """Prefill two prompts, then 8 fused sampled/greedy steps; returns
    the tokens [3, 8]."""
    from tpumon_torch import prng
    from tpumon_torch.loadgen import paged_kv, serving

    cfg, _ = _small_serve(kv_layout, paged_attn)
    params = {"embed": params["embed"].to(device),
              "final_norm": params["final_norm"].to(device),
              "lm_head": params["lm_head"].to(device),
              "layers": [{k: v.to(device) for k, v in layer.items()}
                         for layer in params["layers"]]}
    i32 = dict(dtype=torch.int32, device=device)
    prompts = [list(range(5, 40)), list(range(90, 97))]
    last = torch.tensor([0, 0, 0], **i32)
    pos = torch.tensor([127, 127, 127], **i32)
    if kv_layout == "dense":
        store = serving.init_cache(cfg, device)
    else:
        store = paged_kv.init_pool(cfg, 3 * 8 + 1, device)
        tables = torch.zeros((3, 8), **i32)
        tables[0, :4] = torch.tensor([3, 9, 1, 20], **i32)
        tables[1, :2] = torch.tensor([7, 2], **i32)
    for slot, prompt in enumerate(prompts):
        for c0 in range(0, len(prompt), 16):
            chunk = prompt[c0:c0 + 16]
            toks = torch.tensor(chunk + [0] * (16 - len(chunk)), **i32)
            if kv_layout == "dense":
                logits = serving.prefill(cfg, params, store, toks,
                                         len(chunk), slot, c0)
            else:
                logits = paged_kv.paged_prefill(
                    cfg, params, store, toks, len(chunk),
                    int(tables[slot, c0 // 16]), tables[slot], c0)
        last[slot] = int(logits.argmax())
        pos[slot] = len(prompt)
    key = prng.torch_key(0x7A11, device)
    rids = torch.tensor([4, 9, 0], **i32)
    ctr0 = torch.ones(3, **i32)
    temps = torch.tensor([0.8, 0.0, 0.0], device=device)
    topks = torch.tensor([5, 0, 0], **i32)
    if kv_layout == "dense":
        _, _, toks = serving.decode_rounds(cfg, params, store, last, pos,
                                           key, rids, ctr0, temps, topks, 8)
    else:
        _, _, toks = paged_kv.paged_decode_rounds(
            cfg, params, store, last, pos, tables, key, rids, ctr0, temps,
            topks, 8)
    return toks.cpu()[:2]


@pytest.mark.parametrize("kv_layout,paged_attn", [
    ("dense", "gather"), ("paged", "gather"), ("paged", "kernel")])
def test_decode_rounds_on_card_match_cpu(cuda_device, kv_layout,
                                         paged_attn):
    """decode_rounds and paged_decode_rounds (both read paths) in f32:
    the card's tokens equal the CPU's; the kernel route launches the
    paged kernel once per layer and step."""
    _, params = _small_serve(kv_layout)
    before = paged_attention.launches
    card = _rounds_case(cuda_device, kv_layout, paged_attn, params)
    launched = paged_attention.launches - before
    cpu = _rounds_case("cpu", kv_layout, paged_attn, params)
    assert torch.equal(card, cpu)
    assert launched == (2 * 8 if paged_attn == "kernel" else 0)


@pytest.mark.parametrize("kv_layout,paged_attn", [
    ("dense", "gather"), ("paged", "kernel")])
def test_moe_engine_on_card_matches_cpu(cuda_device, kv_layout, paged_attn):
    """A small f32 MoE engine (4 experts, full-capacity routing) emits the
    CPU's greedy and sampled streams on the card; the kernel route
    launches the paged kernel once per layer and decode step."""
    from tpumon_torch.loadgen.model import ModelConfig, init_params
    from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine

    cfg = ServeConfig(model=ModelConfig(
        vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq=128, compute_dtype="float32", n_experts=4),
        slots=3, prefill_len=16, kv_layout=kv_layout, paged_attn=paged_attn)
    params = init_params(cfg.model, torch.Generator().manual_seed(3))
    prompts = [list(range(5, 40)), [7, 1, 9] * 6, [100]]
    streams = []
    for dev in ("cpu", cuda_device):
        eng = ServingEngine(cfg=cfg, params=params, seed=7, device=dev)
        before = paged_attention.launches
        reqs = [eng.submit(p, max_new=10, temperature=t)
                for p, t in zip(prompts, (0.0, 0.8, 0.0))]
        eng.drain()
        launched = paged_attention.launches - before
        streams.append([r.output for r in reqs])
    assert streams[0] == streams[1]
    want = cfg.model.n_layers * eng.decode_steps_total
    assert launched == (want if paged_attn == "kernel" else 0)


def test_workload_footprint_on_card(cuda_device):
    """footprint_by_device reports every visible card; the one holding a
    tensor counts its bytes, and hbm_total is the card's memory."""
    from tpumon_torch.loadgen.report import footprint_by_device

    held = torch.empty(1 << 20, device=cuda_device)
    fp = footprint_by_device()
    assert len(fp) == torch.cuda.device_count()
    total = torch.cuda.get_device_properties(0).total_memory
    assert any(e["hbm_used"] >= held.numel() * 4 and e["hbm_total"] == total
               for e in fp.values())


@pytest.mark.parametrize("p", PREFILL_LENGTHS)
@pytest.mark.parametrize("start", PREFILL_STARTS)
@pytest.mark.parametrize("shape", PREFILL_CARD_SHAPES,
                         ids=lambda sh: f"hd{sh['hd']}")
def test_prefill_kernel_matches_plain_on_card(cuda_device, shape, start, p):
    """The chunk attention kernel at the serving cells' shape (32 query
    heads on 8 kv heads, hd 128, page 1,024) and at hd 64, one launch a
    call, the pool read in place, within PREFILL_TOL of the plain version;
    every planted fault of its design reads over the limit there."""
    from tpumon_torch.ops.prefill_attention import (
        prefill_attention,
        prefill_attention_reference,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(start + p)
    args = prefill_inputs(gen, **shape, start=start, p=p,
                          dtype=torch.bfloat16)
    pool = args[1].clone()
    before = prefill_attention.launches
    out = prefill_attention(*args)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 1
    assert out.shape == args[0].shape and torch.equal(args[1], pool)
    assert torch.isfinite(out.float()).all()
    ref = prefill_attention_reference(*args)
    assert chunk_rows_rel_err(out, ref) <= PREFILL_TOL
    faults = prefill_fault_readings(args, ref)
    assert faults and min(faults.values()) > PREFILL_TOL, faults


def test_prefill_kernel_launches_once_a_layer_and_chunk_on_card(cuda_device):
    """The paged engine on the card: one chunk kernel launch a layer and
    chunk on the kernel route (a bf16 pool at hd 64, page 128), none on
    the gather route."""
    from tpumon_torch.loadgen.model import ModelConfig, init_params
    from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine
    from tpumon_torch.ops.prefill_attention import prefill_attention

    model = ModelConfig(vocab=256, d_model=512, n_layers=2, n_heads=8,
                        n_kv_heads=2, d_ff=512, max_seq=512,
                        compute_dtype="bfloat16")
    params = init_params(model, torch.Generator().manual_seed(4))
    prompts = [list(range(1, 301)), [7, 1, 9] * 50, [100]]
    chunks = sum(-(-len(p) // 128) for p in prompts)
    for read in ("gather", "kernel"):
        eng = ServingEngine(cfg=ServeConfig(
            model=model, slots=2, prefill_len=128, kv_layout="paged",
            paged_attn=read), params=params, seed=7, device=cuda_device)
        before = prefill_attention.launches
        reqs = [eng.submit(p, max_new=3) for p in prompts]
        eng.drain()
        torch.cuda.synchronize()
        assert all(r.status == "completed" for r in reqs)
        launched = prefill_attention.launches - before
        assert launched == (model.n_layers * chunks if read == "kernel"
                            else 0)


def test_kernel_f32_sliced_route_reads_no_stale_columns_on_card(cuda_device):
    """The f32 sliced route loads no box of a K chunk wholly past the head
    dim (hd 300: columns 320-511 of the second chunk), so those shared
    memory columns hold what an earlier launch left. A launch over NaN
    pools at hd 512 leaves NaN in every ring slot on every SM (256 CTAs);
    the hd-300 call after it at the same grid must stay finite and within
    the limit."""
    spec = dict(b=64, nh=4, nkv=2, num_pages=260, page_size=8, max_pages=4,
                lengths=(32,) * 64, seed=15)
    poison = [t.to(cuda_device) for t in to_torch(
        paged_case(**spec, hd=512), torch.float32)]
    poison[1].fill_(float("nan"))
    poison[2].fill_(float("nan"))
    for _ in range(3):
        paged_attention(*poison)
    args = [t.to(cuda_device) for t in to_torch(
        paged_case(**spec, hd=300), torch.float32)]
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    ref = paged_attention_reference(*args)
    assert rows_rel_err(out, ref, args[4]) <= PAGED_TOL["float32"]


def test_kernel_at_the_latent_decode_shape_on_card(cuda_device):
    """DeepSeek-V2-Lite's absorbed decode (dsv2lite.serve.sharegpt): 256
    slots, 16 query heads on the one 576-wide latent row (a group of 16
    on the sliced route), page 1,024, two pages a table over the cell's
    513-page pool, mixed lengths, one tensor passed as K and as V."""
    gen = torch.Generator(device=cuda_device).manual_seed(25)
    pool = torch.randn((1, 513, 1024, 576), generator=gen,
                       device=cuda_device, dtype=torch.bfloat16)
    q = torch.randn((256, 16, 576), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    cpu = torch.Generator().manual_seed(26)
    lengths = torch.randint(1, 2049, (256,), generator=cpu)
    lengths[:5] = torch.tensor([1, 1023, 1024, 1025, 2048])
    table = (torch.randperm(512, generator=cpu) + 1).view(256, 2)
    lengths = lengths.to(cuda_device, torch.int32)
    table = table.to(cuda_device, torch.int32)
    before = paged_attention.launches
    out = paged_attention(q, pool, pool, table, lengths)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(q, pool, pool, table, lengths)
    assert rows_rel_err(out, ref, lengths) <= PAGED_TOL["bfloat16"]


# The grouped expert products of bf16 against f32 products over the same
# bf16 weights, worst token row by norm: bf16 operands and outputs with
# f32 accumulation read ~4e-3 a group on the card (PERF.md §6).
GROUPED_TOL = 2e-2


def test_grouped_expert_ffn_makes_no_sync_on_card(cuda_device):
    """DeepSeek-V2-Lite's routed layer at its widths (top 6 of 64 experts
    of 1,408, 2 shared) over a decode step's 256 tokens: no device→host
    read (torch's sync debug mode raises on one), every expert counted,
    and each token's output as a loop over its experts in f32 gives it."""
    import torch.nn.functional as F

    from tpumon_torch.loadgen.moe import (
        TopKConfig,
        init_topk_params,
        topk_ffn,
    )

    cfg = TopKConfig(d_model=2048, d_ff=1408, n_experts=64, top_k=6,
                     n_shared=2)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    params = {k: v if k == "router" else v.bfloat16()
              for k, v in init_topk_params(cfg, gen).items()}
    x = torch.randn((256, 2048), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    counts = torch.zeros((2, 64), dtype=torch.int64, device=cuda_device)
    topk_ffn(cfg, params, x)  # warm: first calls may set up libraries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = topk_ffn(cfg, params, x, counts=counts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(counts[0].sum()) == 256 * 6 and int(counts[1].min()) == 1
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    gates, experts = torch.topk(probs, 6, dim=-1)
    want = torch.zeros((256, 2048), device=cuda_device)
    picks = [(experts[:, j], gates[:, j]) for j in range(6)] + [
        (torch.full((256,), 64 + i, device=cuda_device),
         torch.ones(256, device=cuda_device)) for i in range(2)]
    for e in range(66):
        for ids, g in picks:
            tok = (ids == e).nonzero()[:, 0]
            if tok.numel():
                h = x[tok].float() @ params["w_gate_up"][e].float()
                a = F.silu(h[:, :1408]) * h[:, 1408:]
                want.index_add_(0, tok, (a @ params["w_down"][e].float())
                                * g[tok, None])
    err = (y.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(err.max()) <= GROUPED_TOL


def test_latent_engine_decodes_through_the_kernel_on_card(cuda_device):
    """A small latent model served by the paged engine in bf16: every
    decode step launches the paged kernel once a layer."""
    from tpumon_torch.loadgen.model import LatentModelConfig, init_params
    from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine

    model = LatentModelConfig(
        vocab=256, d_model=128, n_layers=3, n_heads=4, n_kv_heads=4,
        d_ff=192, max_seq=256, kv_lora_rank=64, qk_nope_head_dim=32,
        qk_rope_head_dim=16, v_head_dim=32, yarn_factor=40,
        yarn_original_max_pos=4096, yarn_mscale=0.707,
        yarn_mscale_all_dim=0.707, routed_experts=8, experts_per_token=2,
        expert_d_ff=64, shared_experts=2, first_dense_layers=1)
    params = init_params(model, torch.Generator().manual_seed(4))
    eng = ServingEngine(cfg=ServeConfig(
        model=model, slots=3, prefill_len=128, kv_layout="paged",
        paged_attn="kernel"), params=params, seed=7, device=cuda_device)
    before = paged_attention.launches
    reqs = [eng.submit(p, max_new=9) for p in
            ([5] * 200, list(range(1, 40)), [9])]
    eng.drain()
    torch.cuda.synchronize()
    assert all(r.status == "completed" for r in reqs)
    assert paged_attention.launches - before == (
        model.n_layers * eng.decode_steps_total)
