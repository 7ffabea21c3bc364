"""train_mfu: training FLOPs (the record's family's flops_per_token: for
Llama 6·N plus attention) of the tokens trained in the traced run's
window over the synchronized window times the card's bf16 peak (%)."""

from portbench import families


def read(rec):
    peaks = rec.get("peaks")
    if rec.get("kind") != "train" or not rec.get("on_card") or not peaks:
        return None
    fam = families.of(rec)
    flops = fam.flops_per_token(rec["sizes"], rec["seq"]) * rec["tokens"]
    return 100.0 * flops / (rec["window_s"] * peaks.bf16)
