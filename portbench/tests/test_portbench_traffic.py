"""The serving traffic generator: deterministic per seed, inside its
stated ranges, the same work for every seed in another order."""

from collections import Counter

import pytest

from portbench import run
from portbench.loadmix import Mix, table

MIXES = ["chat", "code"]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_in_range_and_each_round_is_the_table(name):
    mix = run.load_json(run.PKG / "traffic" / f"{name}.json")
    m = Mix(mix, 2**31 + 11, 32768)
    lo_p, hi_p = mix["prompt"]["min"], mix["prompt"]["max"]
    lo_o, hi_o = mix["output"]["min"], mix["output"]["max"]
    for c in range(m.clients):
        for k in range(3):
            n, out = m.lengths(c, k)
            assert lo_p <= n <= hi_p and lo_o <= out <= hi_o
    for k in range(3):  # a round is the whole table
        got = Counter(m.lengths(c, k)[0] for c in range(m.clients))
        assert got == Counter(m.prompts)


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_per_seed_same_work_for_every_seed(name):
    mix = run.load_json(run.PKG / "traffic" / f"{name}.json")
    a, b = Mix(mix, 7, 32768), Mix(mix, 7, 32768)
    c = Mix(mix, 8, 32768)
    assert a.request(3, 2) == b.request(3, 2)
    assert a.request(3, 2)[0] != c.request(3, 2)[0]
    # the seed draws token ids, never the work
    assert all(a.lengths(i, k) == c.lengths(i, k)
               for i in range(a.clients) for k in range(4))
    toks, _ = a.request(0, 0)
    assert min(toks) >= 1 and max(toks) < 32768


def test_table_follows_its_distribution():
    t = table({"dist": "log_uniform", "min": 1024, "max": 6144}, 128)
    assert t[0] >= 1024 and t[-1] <= 6144 and t == sorted(t)
    # log-uniform: the median is the geometric mean of the ends
    assert abs(t[64] / (1024 * 6144) ** 0.5 - 1) < 0.02
    u = table({"dist": "uniform", "min": 16, "max": 64}, 64)
    assert abs(sum(u) / len(u) - 40) < 0.5
