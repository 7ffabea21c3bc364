"""Prompt-lookup speculative drafting (n-gram proposal from context).

Counterpart of ``tpumon/loadgen/prompt_lookup.py``, line for line: the
proposal is a host-side list search over the request's own context, so
the port keeps its own copy. Engine integration:
``ServeConfig(spec_source="prompt")``; the verify step is the draft
model's, so greedy output stays lossless whatever the guesses.
"""

from __future__ import annotations


def ngram_propose(
    context: list[int], g: int, max_n: int = 3, window: int = 1024
) -> list[int]:
    """Propose ``g`` next tokens for ``context`` by n-gram lookup.

    Finds the most recent PRIOR occurrence of the longest trailing n-gram
    (n = max_n down to 1) within the last ``window`` tokens (0 = no
    bound) and copies the tokens that followed it, cycling the post-match
    span when it is shorter than ``g``; with no match, ``g`` repeats of
    the last token.
    """
    if g <= 0:
        return []
    if not context:
        return [0] * g
    last = context[-1]
    lo = max(0, len(context) - window) if window and window > 0 else 0
    for n in range(min(max_n, len(context)), 0, -1):
        tail = context[-n:]
        hi = len(context) - n - 1  # last candidate start index
        for i in range(hi, lo - 1, -1):
            if context[i:i + n] == tail:
                prop = context[i + n:i + n + g]
                if not prop:
                    continue  # match flush against the tail: no info
                span = len(context) - i - n  # tokens after the match
                while len(prop) < g:
                    prop.append(context[i + n + (len(prop) % span)])
                return prop[:g]
    return [last] * g
