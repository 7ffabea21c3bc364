"""The chunk attention of the paged prefill, on the CPU.

``ops.prefill_attention`` reads one prompt chunk's context straight from
the paged pool on the card (csrc/prefill_attention.cu); on the CPU it
runs its plain version, dense attention over the pages through the
chunk's own. Here the plain version is held to dense f32 attention over
the whole gathered table (the rows past the chunk's own pages add exact
zeros there), the engine's route is pinned to the pools the kernel takes,
its launch counter stays untouched on the CPU, and each planted fault of
the kernel's design (chip_smoke.prefill_faulty_plain) reads over the card
limit (chip_smoke.PREFILL_TOL) at small shapes of the card tests' kind.
"""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from tpumon_torch.loadgen import paged_kv  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig  # noqa: E402
from tpumon_torch.loadgen.serving import ServeConfig  # noqa: E402
from tpumon_torch.ops import prefill_attention as pa  # noqa: E402

PAGE = 128
MAX_PAGES = 4
# Tolerances against the f32 oracle: f32 differs by summation order only;
# bf16 rounds q, K, V, the scores, P and the output to bf16, a relative
# step of 2^-8 each.
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def case(start, p, nh, nkv, hd, dtype, seed=0, page=PAGE,
         max_pages=MAX_PAGES):
    """q [1, p, nh, hd], a pool of 2 x max_pages pages and a table that
    is a shuffled slice of them, from a seed."""
    g = torch.Generator().manual_seed(seed)
    num_pages = 2 * max_pages
    q = torch.randn(1, p, nh, hd, generator=g).to(dtype)
    k = torch.randn(nkv, num_pages, page, hd, generator=g).to(dtype)
    v = torch.randn(nkv, num_pages, page, hd, generator=g).to(dtype)
    table = torch.randperm(num_pages, generator=g)[:max_pages].to(torch.int32)
    return q, k, v, table, start


def dense_f32(q, k_pool, v_pool, table, start):
    """Causal attention of the chunk's rows over the whole gathered table,
    every step in f32."""
    _, p, nh, hd = q.shape
    nkv, _, page, _ = k_pool.shape
    s = table.shape[0] * page
    k = k_pool.float()[:, table.long()].reshape(nkv, s, hd)
    v = v_pool.float()[:, table.long()].reshape(nkv, s, hd)
    k = k.repeat_interleave(nh // nkv, dim=0)  # [nh, S, hd]
    v = v.repeat_interleave(nh // nkv, dim=0)
    scores = torch.einsum("qhd,hkd->hqk", q[0].float(), k) / hd**0.5
    mask = torch.arange(s)[None] <= start + torch.arange(p)[:, None]
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hqk,hkd->qhd", probs, v)[None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("nh,nkv", [(2, 2), (8, 2)], ids=["group1", "group4"])
@pytest.mark.parametrize("p", [1, PAGE - 1, PAGE])
@pytest.mark.parametrize("start", [0, PAGE, (MAX_PAGES - 1) * PAGE],
                         ids=["first_page", "second_page", "last_page"])
def test_plain_matches_dense_f32_over_the_table(start, p, nh, nkv, hd, dtype):
    args = case(start, p, nh, nkv, hd, dtype, seed=start + p + nh + hd)
    got = pa.prefill_attention(*args)
    assert got.shape == (1, p, nh, hd) and got.dtype == dtype
    err = chip_smoke.chunk_rows_rel_err(got, dense_f32(*args))
    assert err <= REL_TOL[dtype]


def test_plain_reads_only_the_pages_through_the_chunks_own():
    """Pages of the table past the chunk's own, and pool pages off the
    table, never reach the output: filling them with NaN changes
    nothing."""
    q, k, v, table, start = case(PAGE, PAGE, 8, 2, 64, torch.bfloat16)
    want = pa.prefill_attention(q, k, v, table, start)
    off = [pg for pg in range(k.shape[1]) if pg not in table[:2].tolist()]
    k[:, off] = float("nan")
    v[:, off] = float("nan")
    assert torch.equal(pa.prefill_attention(q, k, v, table, start), want)


def pool_for(dtype="bfloat16", hd=64, page=PAGE, kv_dtype="compute",
             paged_attn="kernel"):
    model = ModelConfig(vocab=64, d_model=4 * hd, n_layers=1, n_heads=4,
                        n_kv_heads=2, d_ff=64, max_seq=4 * page,
                        compute_dtype=dtype)
    cfg = ServeConfig(model=model, slots=1, prefill_len=page,
                      kv_layout="paged", paged_attn=paged_attn,
                      kv_dtype=kv_dtype)
    return cfg, paged_kv.init_pool(cfg, 5, "cpu")


@pytest.mark.parametrize("kw,taken", [
    ({}, True),
    ({"hd": 128}, True),
    ({"page": 256}, True),
    ({"kv_dtype": "int8"}, False),
    ({"dtype": "float32"}, False),
    ({"hd": 256}, False),
    ({"hd": 32}, False),
    ({"page": 64}, False),
    ({"paged_attn": "gather"}, False),
    ({"paged_attn": "ring"}, False),
], ids=["bf16_hd64", "bf16_hd128", "page256", "int8_pool", "f32_pool",
        "hd256", "hd32", "page64", "gather", "ring"])
def test_route_follows_the_pool(kw, taken):
    cfg, pool = pool_for(**kw)
    assert paged_kv.prefill_reads_kernel(cfg, pool) is taken
    table = torch.zeros(4, dtype=torch.int32)
    page = cfg.prefill_len
    want = 2 * page if taken else 4 * page
    assert paged_kv.prefill_rows(cfg, pool, table, page) == want


def test_route_not_taken_over_a_mesh():
    cfg, pool = pool_for()
    assert not paged_kv.prefill_reads_kernel(cfg, [pool, pool])


def test_kernel_route_counts_no_launch_on_the_cpu():
    cfg, pool = pool_for()
    params = _tiny_params(cfg)
    before = pa.prefill_attention.launches
    toks = torch.zeros(PAGE, dtype=torch.int32)
    table = torch.tensor([3, 1, 0, 0], dtype=torch.int32)
    for c0, pg in ((0, 3), (PAGE, 1)):
        out = paged_kv.paged_prefill(cfg, params, pool, toks, 5, pg, table, c0)
        assert out.shape == (cfg.model.vocab,) and torch.isfinite(out).all()
    assert pa.prefill_attention.launches == before


def _tiny_params(cfg):
    from tpumon_torch.loadgen.model import init_params
    from tpumon_torch.loadgen.serving import _place

    return _place(init_params(cfg.model, torch.Generator().manual_seed(0)),
                  "cpu", cfg.model.torch_dtype)


@pytest.mark.parametrize("change,match", [
    (lambda a: dict(a, start=PAGE // 2), "multiple of the page"),
    (lambda a: dict(a, start=MAX_PAGES * PAGE), "inside the table"),
    (lambda a: dict(a, q=torch.zeros(1, PAGE + 1, 8, 64, dtype=torch.bfloat16)),
     "rows must be"),
    (lambda a: dict(a, q=a["q"].float()), "float32 or bfloat16"),
    (lambda a: dict(a, table_row=a["table_row"].long()), "int32"),
    (lambda a: dict(a, q=a["q"][:, :, :3]), "multiple of n_kv_heads"),
    (lambda a: dict(a, q=a["q"][..., :32]), "head_dim"),
    (lambda a: dict(a, q=a["q"][0]), r"\[1, P, n_heads, hd\]"),
], ids=["start_mid_page", "start_past_table", "p_over_page", "mixed_dtypes",
        "table_int64", "group", "head_dim", "no_batch"])
def test_wrapper_rejects_what_it_does_not_take(change, match):
    q, k, v, table, start = case(PAGE, 16, 8, 2, 64, torch.bfloat16)
    args = change(dict(q=q, k_pool=k, v_pool=v, table_row=table, start=start))
    with pytest.raises(ValueError, match=match):
        pa.prefill_attention(**args)


def test_no_fault_model_is_the_plain_version():
    args = case(2 * PAGE, 100, 8, 2, 64, torch.bfloat16)
    assert torch.equal(chip_smoke.prefill_faulty_plain(*args),
                       pa.prefill_attention_reference(*args))


# Small shapes of the card tests' kind: 8 query heads on 2 kv heads, page
# 128, eight pages a table; starts at the first, second, fourth and last
# page; one row, a ragged chunk and a full one.
FAULT_STARTS = (0, PAGE, 3 * PAGE, 7 * PAGE)
FAULT_LENGTHS = (1, 65, PAGE)


@pytest.mark.parametrize("fault", chip_smoke.PREFILL_FAULTS)
def test_planted_faults_read_over_the_card_limit(fault):
    readings = {}
    for start in FAULT_STARTS:
        for p in FAULT_LENGTHS:
            args = case(start, p, 8, 2, 64, torch.bfloat16, seed=start + p,
                        max_pages=8)
            if not chip_smoke.prefill_fault_applies(fault, args):
                continue
            want = pa.prefill_attention_reference(*args)
            readings[(start, p)] = chip_smoke.chunk_rows_rel_err(
                chip_smoke.prefill_faulty_plain(*args, fault), want)
    assert readings, f"{fault} applies to no case"
    assert min(readings.values()) > chip_smoke.PREFILL_TOL, readings


def test_faults_apply_where_they_change_the_output():
    args = case(0, PAGE, 8, 2, 64, torch.bfloat16)
    assert not chip_smoke.prefill_fault_applies("offset_ignored", args)
    q, k, v, _, _ = args
    ordered = (q, k, v, torch.arange(MAX_PAGES, dtype=torch.int32), PAGE)
    assert not chip_smoke.prefill_fault_applies("table_ignored", ordered)
    one_kv = case(PAGE, 8, 4, 1, 64, torch.bfloat16)
    assert not chip_smoke.prefill_fault_applies("kv_head_wrong", one_kv)
    assert chip_smoke.prefill_fault_applies("diagonal_unmasked", args)


def test_card_shapes_are_the_cells():
    """The card tests' first shape is the serving cells' chunk: the
    benchmark's Mistral-7B heads, head dim, page and table."""
    import json
    from pathlib import Path

    cfg = json.loads((Path(chip_smoke.__file__).parent / "portbench" /
                      "configs" / "mistral-7b-v0.3.json").read_text())
    shape = chip_smoke.PREFILL_CARD_SHAPES[0]
    nh = cfg["num_attention_heads"]
    page = cfg["serving"]["engine"]["prefill_len"]
    assert (shape["nh"], shape["nkv"], shape["hd"], shape["page"]) == (
        nh, cfg["num_key_value_heads"], cfg["hidden_size"] // nh, page)
    assert shape["max_pages"] == cfg["serving"]["model"]["max_seq"] // page
    assert max(chip_smoke.PREFILL_STARTS) == (shape["max_pages"] - 1) * page
