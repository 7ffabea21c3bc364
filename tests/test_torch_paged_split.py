"""The split design of the port's paged-attention kernel, on the CPU.

The CUDA kernel splits each sequence's page table into CTAs of
``pages_per_split`` entries and merges their partial softmax states in
split order (tpumon_torch/ops/csrc/paged_attention.cu). chip_smoke.py
models that split and merge in plain torch (``paged_split_plain``) and
plants the design's faults in the model. Here the model without a fault
is held to the JAX Pallas kernel (interpret mode) and the reference's
oracle on the same numpy inputs, f32 atol=rtol=1e-5 (summation order
only); the wrapper's split rule is pinned; and each planted fault of the
split design reads over the card limits (chip_smoke.PAGED_TOL) at the
split card cases of tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    PAGED_CARD_CASE,
    PAGED_CARD_SHAPES,
    PAGED_SPLIT_CARD_CASES,
    jax_f32,
    paged_case,
    to_jax,
    to_torch,
    torch_f32,
)
from tpumon.ops import paged_attention as jax_pa  # noqa: E402
from tpumon_torch.ops.paged_attention import (  # noqa: E402
    STAGE_ROWS,
    paged_attention_reference,
    pages_per_split,
)

SMALL = dict(b=4, nh=8, nkv=2, hd=32, num_pages=40, page_size=8, max_pages=8,
             seed=3)
MODEL_CASES = {
    # (case, pages per split)
    "one_page_per_split": (dict(SMALL, lengths=(0, 1, 33, 64)), 1),
    "split_not_dividing_max_pages": (dict(SMALL, lengths=(64, 17, 40, 9)), 3),
    # splits 1-3 lie wholly past the first three lengths
    "splits_past_a_length": (dict(SMALL, lengths=(0, 5, 16, 64)), 2),
    "one_split": (dict(SMALL, lengths=(64, 1, 23, 0)), 8),
}


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_split_model_matches_jax_kernel(name):
    spec, pages = MODEL_CASES[name]
    case = paged_case(**spec)
    out = torch_f32(chip_smoke.paged_split_plain(*to_torch(case), pages))
    kern = jax_f32(jax_pa.paged_attention(*to_jax(case), interpret=True))
    ref = jax_f32(jax_pa.paged_attention_reference(*to_jax(case)))
    np.testing.assert_allclose(out, kern, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", range(len(PAGED_SPLIT_CARD_CASES)))
def test_split_model_at_the_rule_matches_jax_oracle(case):
    """At the split card cases and the wrapper's own pages_per_split."""
    spec = PAGED_SPLIT_CARD_CASES[case]
    arrays = paged_case(**spec)
    pages = pages_per_split(spec["b"], spec["nkv"], spec["max_pages"],
                            spec["page_size"])
    out = torch_f32(chip_smoke.paged_split_plain(*to_torch(arrays), pages))
    ref = jax_f32(jax_pa.paged_attention_reference(*to_jax(arrays)))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_pages_per_split_rule():
    """About 256 CTAs a call of at least 256 rows each, from static shapes
    alone; a table of at most 256 rows keeps one split."""
    assert pages_per_split(16, 8, 32, 128) == 16  # production: 256 CTAs
    assert pages_per_split(4, 8, 32, 128) == 4  # batch 4: 256 CTAs
    assert pages_per_split(2, 1, 32, 128) == 2  # the 256-row floor
    assert pages_per_split(32, 8, 32, 128) == 32  # 256 pairs: one split
    assert pages_per_split(1, 1, 2, 128) == 2  # short: one split
    for shape in PAGED_CARD_SHAPES:  # the one-split card cases
        assert pages_per_split(PAGED_CARD_CASE["b"], shape["nkv"],
                               PAGED_CARD_CASE["max_pages"],
                               shape["page_size"]) == 4


def test_split_card_cases_are_what_they_claim():
    """At the wrapper's rule: the longest sequence of case 0 spans at least
    3 splits and ends in a partial page; case 1's rows end in different
    splits; case 2 has one row of length > 0, over at least 3 splits."""
    live = []
    for spec in PAGED_SPLIT_CARD_CASES:
        pages = pages_per_split(spec["b"], spec["nkv"], spec["max_pages"],
                                spec["page_size"])
        live.append(chip_smoke.paged_split_n_live(
            spec["lengths"], spec["page_size"], pages, spec["max_pages"]))
    longest = max(PAGED_SPLIT_CARD_CASES[0]["lengths"])
    assert max(live[0]) >= 3
    assert longest % PAGED_SPLIT_CARD_CASES[0]["page_size"] != 0
    assert len(set(live[1])) == len(live[1])
    assert sorted(live[2]) == [0, 0, 0, max(live[2])] and max(live[2]) >= 3


@pytest.mark.parametrize("fault", chip_smoke.SPLIT_FAULTS)
def test_split_faults_vanish_with_one_split(fault):
    """Each fault of the split design is a fault of the merge or of a
    split's first tile: with one split the model is the clean one."""
    spec, _ = MODEL_CASES["one_split"]
    args = to_torch(paged_case(**spec))
    clean = chip_smoke.paged_split_plain(*args, spec["max_pages"])
    faulty = chip_smoke.paged_split_plain(*args, spec["max_pages"], fault,
                                          STAGE_ROWS[torch.float32])
    torch.testing.assert_close(faulty, clean, atol=0, rtol=0)


def test_stale_stage_reads_the_tile_before():
    """stale_stage with one-page splits and a page-sized tile: each page
    after the first reads the page before it, so it equals the clean model
    over a table whose entries are shifted by one page."""
    spec, _ = MODEL_CASES["one_page_per_split"]
    q, k, v, table, lengths = to_torch(paged_case(**spec))
    faulty = chip_smoke.paged_split_plain(q, k, v, table, lengths, 1,
                                          "stale_stage", spec["page_size"])
    shifted = torch.cat((table[:, :1], table[:, :-1]), 1)
    want = chip_smoke.paged_split_plain(q, k, v, shifted, lengths, 1)
    torch.testing.assert_close(faulty, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("fault", chip_smoke.SPLIT_FAULTS)
def test_split_faults_do_not_apply_with_one_split(fault):
    """At the one-split card cases (tests/test_torch_paged_attention.py
    counts their faults) no fault of the split design applies."""
    for shape in PAGED_CARD_SHAPES:
        pages = pages_per_split(PAGED_CARD_CASE["b"], shape["nkv"],
                                PAGED_CARD_CASE["max_pages"],
                                shape["page_size"])
        n_live = chip_smoke.paged_split_n_live(
            shape["lengths"], shape["page_size"], pages,
            PAGED_CARD_CASE["max_pages"])
        assert not chip_smoke.paged_fault_applies(
            fault, shape["nkv"], shape["lengths"], shape["page_size"], n_live)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(PAGED_SPLIT_CARD_CASES)))
def test_split_faults_read_over_the_card_limits(dtype, case):
    """Every planted fault, those of the split design among them, reads
    over the limit the CUDA kernel is held to at the split card cases;
    without a fault the split model is within a tenth of the limit."""
    spec = PAGED_SPLIT_CARD_CASES[case]
    args = to_torch(paged_case(**spec), getattr(torch, dtype))
    want = paged_attention_reference(*args)
    tol = chip_smoke.PAGED_TOL[dtype]
    pages = pages_per_split(spec["b"], spec["nkv"], spec["max_pages"],
                            spec["page_size"])
    clean = chip_smoke.paged_split_plain(*args, pages)
    assert chip_smoke.rows_rel_err(clean, want, args[4]) <= (
        tol / 10 if dtype == "float32" else tol / 2)
    readings = chip_smoke.paged_fault_readings(args, want)
    assert set(chip_smoke.SPLIT_FAULTS) <= set(readings)
    assert min(readings.values()) > tol, readings
