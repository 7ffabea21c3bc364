"""The one generator of serving traffic, driven by a mix's data file.

A mix states its clients and the distributions of prompt and output
lengths (``{"dist": "log_uniform" | "uniform", "min": a, "max": b}``).
The lengths are the distribution's values at ``M`` evenly spaced points,
``M`` the number of clients, and client ``c``'s ``k``-th request takes
the table's entry ``P[(c + 37 k) % M]`` for its prompt and
``Q[(c + 23 k) % M]`` for its output, ``P`` and ``Q`` fixed
permutations, so each round of requests is the whole table. The seed
draws the token ids (uniform over ``[1, vocab)``, per seed, client and
request) and not the lengths: in a closed loop the order in which long
and short requests meet sets the tails, so every seed gets the same
work, and seeds differ in what the requests say.
"""

from __future__ import annotations

import numpy as np


def table(spec: dict, m: int) -> list[int]:
    """The distribution's values at the m points (i + 0.5) / m."""
    a, b = spec["min"], spec["max"]
    out = []
    for i in range(m):
        u = (i + 0.5) / m
        if spec["dist"] == "log_uniform":
            x = a * (b / a) ** u
        elif spec["dist"] == "uniform":
            x = a + (b - a) * u
        else:
            raise ValueError(f"unknown length distribution {spec['dist']!r}")
        out.append(int(round(x)))
    return out


class Mix:
    """Requests of a mix for one seed; ``request(c, k)`` is a pure
    function of (mix, seed, vocab, c, k), and ``lengths(c, k)`` of (mix,
    c, k)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.clients = int(mix["clients"])
        m = self.clients
        self.prompts = table(mix["prompt"], m)
        self.outputs = table(mix["output"], m)
        rng = np.random.default_rng(0x5EED)  # the same order for every seed
        self.p_order = rng.permutation(m)
        self.q_order = rng.permutation(m)
        self.m = m
        self.seed = seed
        self.vocab = vocab

    def lengths(self, c: int, k: int) -> tuple[int, int]:
        """(prompt tokens, output tokens) of client c's k-th request."""
        return (self.prompts[self.p_order[(c + 37 * k) % self.m]],
                self.outputs[self.q_order[(c + 23 * k) % self.m]])

    def request(self, c: int, k: int) -> tuple[list[int], int]:
        """(prompt token ids, output tokens) of client c's k-th request."""
        n, out = self.lengths(c, k)
        rng = np.random.default_rng([self.seed, c, k])
        return rng.integers(1, self.vocab, size=n).tolist(), out
