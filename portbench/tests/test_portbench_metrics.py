"""The metric arithmetic on hand-made inputs."""

import pytest

from portbench import counts, kernels, run, stats
from portbench.counts import CardPeaks, Sizes

H100 = counts.card_peaks("NVIDIA H100 80GB HBM3")
MISTRAL8 = Sizes(vocab=32768, d_model=4096, n_layers=8, n_heads=32,
                 n_kv_heads=8, head_dim=128, d_ff=14336)


def test_union_of_intervals_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.8), (9, 12)]
    assert stats.union_length(iv) == 3 + 1 + 3
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.gaps([], 0, 4) == [(0, 4)]


def test_percentile_over_all_values():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([], 95) is None
    # a tail of all requests: 1000 values, the slowest 50 beyond p95
    tail = [1.0] * 950 + [10.0] * 50
    assert stats.percentile(tail, 95) == pytest.approx(1.0 + 9.0 * 0.05)


def test_peaks_by_device_name():
    assert H100.bf16 == 989e12 and H100.hbm == 3.35e12
    assert counts.card_peaks("NVIDIA H100 PCIe").variant == "H100 PCIe"
    assert counts.card_peaks("Tesla T4") is None


def test_flash_bounds_at_a_known_shape():
    # BH 128 / T 1024 / hd 128 bf16: the forward reads q, k, v and writes
    # out (4 x 33.6 MB) and lse; its two products are 34.4 GFLOP.
    b = counts.flash_bounds(128, 1024, 128, 2, H100.hbm, H100.bf16)
    ms, by = b["flash_attention_tri_fwd"]
    assert by == "bytes"
    assert ms == pytest.approx((4 * 128 * 1024 * 128 * 2 + 128 * 1024 * 4)
                               / 3.35e12 * 1e3)
    ops = counts.flash_ops(128, 1024, 128)
    assert ops["flash_attention_tri_fwd"] == 2 * 2 * 128 * 128 * 1024 * 1025 // 2
    assert b["flash_attention_tri_bwd_dkv"][1] == "operations"


def test_train_flops_per_token_deepseek8():
    s = Sizes(vocab=102400, d_model=4096, n_layers=8, n_heads=32,
              n_kv_heads=32, head_dim=128, d_ff=11008)
    n = 2 * 102400 * 4096 + 8 * (4 * 4096 * 4096 + 3 * 4096 * 11008
                                 + 2 * 4096) + 4096
    assert counts.flops_per_token(s, 4096) == 6 * n + 12 * 8 * 4096 * 4096
    assert 16.3e9 < counts.flops_per_token(s, 4096) < 16.5e9


def test_serve_flops_by_hand():
    s = Sizes(vocab=10, d_model=4, n_layers=1, n_heads=2, n_kv_heads=1,
              head_dim=2, d_ff=8)
    lp = counts.layer_params(s)
    assert lp == 4 * (2 + 2) * 2 + 2 * 2 * 4 + 3 * 4 * 8 + 2 * 4
    # one chunk of 3 tokens at rows 5..7 (contexts 6, 7, 8), one decode
    # token over 9 rows, 2 heads computed
    got = counts.serve_flops(s, [(5, 3)], [9], emitted=2)
    want = (3 * 2 * lp + 4 * 2 * 2 * (6 + 7 + 8)
            + 2 * lp + 4 * 2 * 2 * 9 + 2 * 2 * 4 * 10)
    assert got == want


def test_paged_bound_is_bytes_at_decode():
    ctx = [4000] * 128
    t = counts.paged_call_bound_s(MISTRAL8, ctx, 8, 2, H100.hbm, H100.bf16)
    kv = 2 * 4000 * 128 * 8 * 128 * 2
    io = 2 * 128 * 32 * 128 * 2 + 128 * 8 * 4 + 128 * 4
    assert t == pytest.approx((kv + io) / 3.35e12)


def test_decode_rounds():
    # (prompt, output tokens before, after): a request finishing prefill
    # this step (token 0 from prefill, token 1 decoded over n + 1 rows),
    # and one decoding its 5th token.
    assert kernels.decode_rounds([(100, 0, 2), (50, 4, 5)]) == [[101, 54]]
    assert kernels.decode_rounds([(10, 1, 4), (20, 2, 3)]) == [
        [11, 22], [12], [13]]


def test_kernel_names():
    assert kernels.flash_kind("flash_tri_bwd_dkv_wgmma_kernel<128>") == (
        "flash_attention_tri_bwd_dkv")
    assert kernels.flash_kind("void flash_tri_bwd_dq_wgmma_kernel") == (
        "flash_attention_tri_bwd_dq")
    assert kernels.flash_kind("flash_fwd_wgmma_kernel") == (
        "flash_attention_tri_fwd")
    assert kernels.is_gemm("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n")
    assert kernels.is_gemm("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN")
    assert not kernels.is_gemm("flash_fwd_wgmma_kernel")
    assert not kernels.is_gemm("void at::native::vectorized_elementwise_k")
    assert kernels.is_paged("paged_attention_kernel<__nv_bfloat16, 128>")


def _slice(ops, busy=1.0, window=2.0):
    return {"ops": ops, "busy_s": busy, "window_s": window}


def test_readers_on_a_made_train_record():
    s = Sizes(vocab=102400, d_model=4096, n_layers=8, n_heads=32,
              n_kv_heads=32, head_dim=128, d_ff=11008)
    bounds = counts.flash_bounds(64, 4096, 128, 2, H100.hbm, H100.bf16)
    least = sum(b[0] for b in bounds.values()) * 1e-3
    rec = {"kind": "train", "on_card": True, "peaks": H100, "sizes": s,
           "seq": 4096, "batch": 2, "elem": 2, "tokens": 8192 * 10,
           "window_s": 4.0,
           "slice": _slice({"flash_fwd_wgmma_kernel": (1, least),
                            "flash_tri_bwd_dq_wgmma_kernel": (1, least),
                            "flash_tri_bwd_dkv_wgmma_kernel": (1, least),
                            "sm90_xmma_gemm_bf16": (10, 6 * least),
                            "elementwise_kernel": (5, 3 * least)},
                           busy=1.5, window=2.0)}
    assert run.reader("flash_roofline.train")(rec) == pytest.approx(
        100.0 / 3)
    assert run.reader("elementwise_share.train")(rec) == pytest.approx(25.0)
    assert run.reader("device_idle.train")(rec) == pytest.approx(25.0)
    mfu = run.reader("train_mfu")(rec)
    assert mfu == pytest.approx(100 * counts.flops_per_token(s, 4096)
                                * 81920 / (4.0 * 989e12))
    assert run.reader("train_tokens_per_s")(rec) == 20480.0
    assert run.reader("serve_mfu")(rec) is None
    rec["on_card"] = False  # a CPU run reports no device metric
    assert run.reader("flash_roofline.train")(rec) is None


def test_readers_on_a_made_serve_record():
    steps = [[(1000, 5, 6), (2000, 9, 10)], [(1000, 6, 7), (3000, 0, 2)]]
    bound = sum(8 * counts.paged_call_bound_s(
        MISTRAL8, ctx, 8, 2, H100.hbm, H100.bf16)
        for ctx in ([1005, 2009], [1006, 3001]))
    rec = {"kind": "serve", "on_card": True, "peaks": H100,
           "sizes": MISTRAL8, "elem": 2, "max_pages": 8, "tokens": 500,
           "window_s": 2.0, "ttft_ms": list(range(1, 101)),
           "tpot_ms": [20.0] * 10, "steps_ms": [1.0, 2.0, 3.0],
           "slice": _slice({"paged_attention_kernel": (16, 2 * bound)}),
           "slice_work": {"chunks": [(2048, 952)], "steps": steps,
                          "prefill_seen": True}}
    assert run.reader("paged_attn_roofline.serve")(rec) == pytest.approx(50)
    assert run.reader("serve_tokens_per_s")(rec) == 250.0
    assert run.reader("ttft_p95_ms")(rec) == pytest.approx(95.05)
    assert run.reader("tpot_p95_ms")(rec) == 20.0
    assert run.reader("engine_step_p50_ms.serve")(rec) == 2.0
    flops = counts.serve_flops(MISTRAL8, [(2048, 952)],
                               [1005, 2009, 1006, 3001], emitted=5)
    assert run.reader("serve_mfu")(rec) == pytest.approx(
        100 * flops / (2.0 * 989e12))
    # launches that do not match the calls counted: no reading
    rec["slice"]["ops"]["paged_attention_kernel"] = (15, 2 * bound)
    assert run.reader("paged_attn_roofline.serve")(rec) is None
    # prefill ran (a first token) but no chunk was counted: no reading
    rec["slice_work"]["chunks"] = []
    assert run.reader("serve_mfu")(rec) is None
    assert CardPeaks  # the peaks type is what the record carries


@pytest.mark.parametrize("family", [None, "llama"])
def test_mfu_readers_read_todays_values(family):
    """serve_mfu and train_mfu take their FLOPs from the record's family;
    on the made records they read exactly what the Llama counts give,
    with the record's ``family`` or without it."""
    s = Sizes(vocab=102400, d_model=4096, n_layers=8, n_heads=32,
              n_kv_heads=32, head_dim=128, d_ff=11008)
    train = {"kind": "train", "on_card": True, "peaks": H100, "sizes": s,
             "seq": 4096, "tokens": 8192 * 10, "window_s": 4.0}
    steps = [[(1000, 5, 6), (2000, 9, 10)], [(1000, 6, 7), (3000, 0, 2)]]
    serve = {"kind": "serve", "on_card": True, "peaks": H100,
             "sizes": MISTRAL8, "slice": _slice({}),
             "slice_work": {"chunks": [(2048, 952)], "steps": steps,
                            "prefill_seen": True}}
    if family:
        train["family"] = serve["family"] = family
    flops = counts.flops_per_token(s, 4096) * 81920
    assert run.reader("train_mfu")(train) == 100.0 * flops / (4.0 * H100.bf16)
    assert run.reader("serve_mfu")(serve) == 100.0 * counts.serve_flops(
        MISTRAL8, [(2048, 952)], [1005, 2009, 1006, 3001], 5) / (
        2.0 * H100.bf16)
