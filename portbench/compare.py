"""The comparisons that decide ``correct``, against the plain reference.

Serving: each sampled request's prompt and served tokens run once
through the reference; a served token's gap is how far its reference
logit lies below the reference's best at that position, and the number
compared is the widest gap over the sample (valid for greedy tokens).
The lower-precision control reads, at the same positions, the gap of the
token that its own logits put first.

Training: per step the loss, the norm of each leaf's first gradient and
of each leaf's change after three steps, each against the reference's as
a gap of norms over the reference's norm of that leaf or of the median
leaf, whichever is larger; the worst leaf counts. Leaves whose reference
gradient is under a thousandth of the median leaf's are left out (they
move by round-off alone).

Both sides' weights, the reference and its settings come from the
configuration's family (``families.of(cfg)``).
"""

from __future__ import annotations

import statistics

import torch

from portbench import families
from portbench.counts import Sizes

TINY_LEAF = 1e-3  # of the median leaf's gradient norm


@torch.no_grad()
def served_gaps(s: Sizes, cfg: dict, seed: int, dtype, device,
                requests: list, control: bool = False) -> dict:
    """Widest gap of the served tokens of ``requests`` (dicts with
    ``prompt`` and ``output`` token lists) under the float32 reference,
    whose weights it draws again from the seed; with ``control``, also
    the widest gap of the tokens the fp8 reference puts first."""
    fam = families.of(cfg)
    ref_model = fam.reference
    ref_model.strict_f32()
    params = fam.make_params(s, seed, device, dtype)
    rc = fam.ref_cfg(s, cfg)
    worst, worst_ctl = 0.0, 0.0
    for req in requests:
        prompt, out = list(req["prompt"]), list(req["output"])
        seq = torch.tensor(prompt + out[:-1], device=device)[None]
        rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out),
                            device=device)
        ref = ref_model.logits(params,
                               ref_model.hidden(params, seq, rc)[0, rows])
        served = torch.tensor(out, device=device)
        best = ref.max(dim=-1).values
        gap = best - ref.gather(1, served[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        if control:
            lp = ref_model.Precision("fp8")
            low = ref_model.logits(
                params, ref_model.hidden(params, seq, rc, lp)[0, rows], lp)
            pick = low.argmax(dim=-1)
            gap = best - ref.gather(1, pick[:, None])[:, 0]
            worst_ctl = max(worst_ctl, float(gap.max()))
        del ref
    out = {"logit_gap": worst}
    if control:
        out["control_logit_gap"] = worst_ctl
    return out


def norm_gaps(prog: dict, ref: dict, keep: set) -> float:
    """Worst leaf's |program norm - reference norm| over the larger of the
    reference's norm of that leaf and the median leaf's."""
    med = statistics.median(ref[n] for n in keep)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep)


def kept_leaves(grad_norms: dict) -> set:
    """Leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad_norms.values())
    return {n for n, g in grad_norms.items() if g >= TINY_LEAF * med}


def reference_steps(s: Sizes, cfg: dict, seed: int, batches: list,
                    lr: float, device, prec: str = "f32",
                    half_batch: bool = False, q_block: int = 512) -> dict:
    """The reference's own three SGD steps from the seed's weights over
    ``batches`` (token tensors [B, T + 1]): each step's loss, each leaf's
    first-gradient norm and each leaf's change norm after the steps.
    ``prec`` and ``half_batch`` put a lower-precision or planted-fault
    version of it in the program's place."""
    fam = families.of(cfg)
    ref_model = fam.reference
    ref_model.strict_f32()
    params = fam.make_params(s, seed, device, torch.float32)
    rc = fam.ref_cfg(s, cfg)
    p = ref_model.Precision(prec)
    losses, grad_norms = [], {}
    for i, tokens in enumerate(batches):
        if half_batch:
            tokens = tokens[: max(1, tokens.shape[0] // 2)]
        value, grads = ref_model.value_and_grad(params, tokens, rc, p,
                                                q_block)
        losses.append(float(value))
        if i == 0:
            grad_norms = {n: float(g.norm()) for n, g in grads.items()}
        with torch.no_grad():
            for name, leaf in ref_model.leaves(params):
                leaf.sub_(lr * grads[name])
        del grads
    named = dict(ref_model.leaves(params))
    change = {n: float((named[n] - p0).norm()) for n, p0 in
              fam.initial_leaves(s, seed, device, torch.float32)}
    return {"loss": losses, "grad_norms": grad_norms, "change_norms": change}


def train_numbers(prog: dict, ref: dict) -> dict:
    """The three numbers compared for a training cell, from the
    program's and the reference's readings (``reference_steps``'s
    keys)."""
    keep = kept_leaves(ref["grad_norms"])
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": norm_gaps(prog["grad_norms"], ref["grad_norms"], keep),
        "change_gap": norm_gaps(prog["change_norms"], ref["change_norms"],
                                keep),
    }
