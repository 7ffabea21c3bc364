"""The port's keyed temperature/top-k sampler against the reference's.

``tpumon_torch.loadgen.serving.sample_tokens`` and
``tpumon.loadgen.serving.sample_tokens`` on the same f32 logits [B, V]
(numpy, from a seed), base key, request ids, token counters,
temperatures and top-k: each row's key is fold_in(fold_in(base, rid),
ctr), its draw jax's Gumbel-max over threefry bits, both of which the
port reproduces bit for bit on the CPU (tests/test_torch_prng.py). The
rule: tokens are equal wherever the winning perturbed logit leads the
runner-up by more than 1e-4; rows inside that margin are near-ties, which
are counted and must stay under 1% of the draws. Then the reference's
own sampler properties (tests/test_sampling.py), on the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from chip_smoke import SAMPLE_MARGIN as MARGIN  # noqa: E402
from chip_smoke import sample_margin  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon_torch import prng  # noqa: E402
from tpumon_torch.loadgen.serving import sample_tokens  # noqa: E402

B, V = 8, 512


def logits_batch(seed=7, b=B, v=V):
    return (np.random.default_rng(seed).standard_normal((b, v))
            * 3.0).astype(np.float32)


def both(logits, seed, rids, ctrs, temps, topk):
    """(reference tokens, port tokens, the port's perturbed-logit margin
    per row) for one call."""
    rids, ctrs = np.asarray(rids, np.int32), np.asarray(ctrs, np.int32)
    temps, topk = np.asarray(temps, np.float32), np.asarray(topk, np.int32)
    want = np.asarray(jax_serving.sample_tokens(
        jnp.asarray(logits), jax.random.PRNGKey(seed), jnp.asarray(rids),
        jnp.asarray(ctrs), jnp.asarray(temps), jnp.asarray(topk)))
    tl = torch.from_numpy(logits)
    key = prng.torch_key(seed, "cpu")
    got = sample_tokens(tl, key, torch.from_numpy(rids),
                        torch.from_numpy(ctrs), torch.from_numpy(temps),
                        torch.from_numpy(topk))
    assert got.dtype == torch.int32 and got.shape == (len(rids),)
    margin = sample_margin(tl, key, torch.from_numpy(rids),
                           torch.from_numpy(ctrs), torch.from_numpy(temps),
                           torch.from_numpy(topk))
    return want, got.numpy(), margin.numpy()


TEMPS, TOPKS = (0.0, 0.7, 1.3), (0, 1, 5)
SAMPLE_SEEDS = (0, 0x7A11, 2**31 + 5)
RIDS_B = np.array([0, 1, 2, 3, 17, 2**20, 2**31 - 1, 5])


def case_draws(temp, topk, seed):
    """(reference, port, margin) over four token counters of one case."""
    logits = logits_batch(seed & 0xFFFF)
    out = [both(logits, seed, RIDS_B, np.full(B, ctr) + np.arange(B),
                np.full(B, temp), np.full(B, topk)) for ctr in (0, 1, 9, 31)]
    return [np.concatenate(a) for a in zip(*out)]


@pytest.mark.parametrize("temp", TEMPS)
@pytest.mark.parametrize("topk", TOPKS)
@pytest.mark.parametrize("seed", SAMPLE_SEEDS)
def test_sample_tokens_matches_reference(temp, topk, seed):
    want, got, margin = case_draws(temp, topk, seed)
    clear = margin > MARGIN
    assert np.array_equal(got[clear], want[clear]), (got, want)


def test_near_ties_are_rare():
    """Over every case above: the draws inside the 1e-4 margin, which the
    rule exempts, are under 1% of all draws."""
    margins = np.concatenate([case_draws(t, k, s)[2] for t in TEMPS
                              for k in TOPKS for s in SAMPLE_SEEDS])
    assert (margins <= MARGIN).mean() < 0.01


def test_mixed_rows_match_reference():
    """Greedy and sampled rows, mixed top-k, in one batch."""
    logits = logits_batch(3)
    temps = [0.0, 0.8, 0.8, 1.3, 0.0, 0.7, 2.0, 0.8]
    topk = [0, 0, 5, 1, 7, 50, 0, 512]
    want, got, margin = both(logits, 0x7A11, np.arange(B) * 3, np.arange(B),
                             temps, topk)
    assert np.array_equal(got[margin > MARGIN], want[margin > MARGIN])


# The reference's sampler properties (tests/test_sampling.py), on the
# port: temperature 0 and top-k 1 are argmax; top-k restricts the
# support; a request's draw depends on its (rid, index), not its row.

KEY = prng.torch_key(0, "cpu")
RIDS = torch.arange(4, dtype=torch.int32)


def small_logits():
    return torch.from_numpy(logits_batch(7, 4, 64))


def test_temperature_zero_is_argmax():
    logits = small_logits()
    out = sample_tokens(logits, KEY, RIDS, torch.zeros(4, dtype=torch.int32),
                        torch.zeros(4), torch.zeros(4, dtype=torch.int32))
    assert torch.equal(out.long(), logits.argmax(-1))


def test_top_k_one_is_argmax_even_when_hot():
    logits = small_logits()
    out = sample_tokens(logits, KEY, RIDS, torch.zeros(4, dtype=torch.int32),
                        torch.full((4,), 5.0),
                        torch.ones(4, dtype=torch.int32))
    assert torch.equal(out.long(), logits.argmax(-1))


def test_top_k_restricts_support():
    logits = small_logits()
    top3 = torch.argsort(-logits, dim=-1)[:, :3]
    for ctr in range(30):
        out = sample_tokens(logits, KEY, RIDS,
                            torch.full((4,), ctr, dtype=torch.int32),
                            torch.full((4,), 2.0),
                            torch.full((4,), 3, dtype=torch.int32))
        for row in range(4):
            assert int(out[row]) in top3[row].tolist()


def test_batch_permutation_invariance():
    """Rows permuted with their (rid, ctr, temp, topk) give the same
    tokens permuted: a draw belongs to its request, not its slot."""
    logits = torch.from_numpy(logits_batch(11))
    rids = torch.tensor([4, 9, 1, 33, 2, 8, 5, 70], dtype=torch.int32)
    ctrs = torch.tensor([0, 5, 2, 7, 1, 1, 3, 9], dtype=torch.int32)
    temps = torch.tensor([0.8, 1.3, 0.0, 0.7, 0.8, 2.0, 1.0, 0.9])
    topk = torch.tensor([0, 5, 0, 1, 50, 0, 3, 0], dtype=torch.int32)
    out = sample_tokens(logits, KEY, rids, ctrs, temps, topk)
    perm = torch.tensor([5, 2, 7, 0, 3, 1, 6, 4])
    out_p = sample_tokens(logits[perm], KEY, rids[perm], ctrs[perm],
                          temps[perm], topk[perm])
    assert torch.equal(out_p, out[perm])


def test_sampling_varies_with_counter_and_request():
    logits = small_logits()
    temps = torch.full((4,), 1.5)
    topk = torch.zeros(4, dtype=torch.int32)
    outs = {tuple(sample_tokens(logits, KEY, RIDS,
                                torch.full((4,), c, dtype=torch.int32),
                                temps, topk).tolist()) for c in range(20)}
    assert len(outs) > 1
    same = logits[:1].repeat(4, 1)
    cols = [tuple(sample_tokens(same, KEY, RIDS,
                                torch.full((4,), c, dtype=torch.int32),
                                temps, topk)[r].item() for c in range(16))
            for r in range(4)]
    assert len(set(cols)) > 1
