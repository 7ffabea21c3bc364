"""Device operations by name, and the decode work of a step.

The port's kernels are told apart by their CUDA function names
(``csrc/``): ``paged_attention_kernel``, ``flash_fwd_*`` (the causal
forward), ``flash_tri_bwd_dq_*`` and ``flash_tri_bwd_dkv_*``. Matrix
products of the libraries carry their families' names.
"""

from __future__ import annotations

import re

GEMM = re.compile(r"gemm|xmma|nvjet|cutlass|cublas|splitk", re.IGNORECASE)
FLASH = (("flash_tri_bwd_dkv", "flash_attention_tri_bwd_dkv"),
         ("flash_tri_bwd_dq", "flash_attention_tri_bwd_dq"),
         ("flash_fwd", "flash_attention_tri_fwd"))


def flash_kind(name: str) -> str | None:
    """The ``counts.FLASH_WORK`` key of a flash kernel's name, else
    None."""
    for needle, kind in FLASH:
        if needle in name:
            return kind
    return None


def is_flash(name: str) -> bool:
    return flash_kind(name) is not None


def is_gemm(name: str) -> bool:
    return not is_flash(name) and bool(GEMM.search(name))


def is_paged(name: str) -> bool:
    return "paged_attention" in name


def decode_rounds(step) -> list[list[int]]:
    """The step's decode calls, each as the context rows of its tokens.
    ``step`` lists, per request that emitted, (prompt tokens n, output
    tokens before, after); output token j >= 1 comes from a decode call
    fed at row n + j - 1, which reads rows 0..n + j - 1 (token 0 comes
    from the prefill). Round r holds each request's r-th decode token of
    the step."""
    rounds: list[list[int]] = []
    for n, o, o2 in step:
        for r, j in enumerate(range(max(1, o), o2)):
            if r == len(rounds):
                rounds.append([])
            rounds[r].append(n + j)
    return rounds
