"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip elsewhere (the kernels have no
CPU mode). They import no JAX, so they run on a GPU host as they are:

    python -m pytest tests/test_torch_cuda.py -q

Every kernel is held to its plain version by chip_smoke.py's metrics
and limits: the paged kernel by rows_rel_err (worst relative error over
the (sequence, head) rows of length > 0) under PAGED_TOL, the flash
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
