"""train_tokens_per_s: tokens trained in the window's steps over the
window, which ends in a synchronize (host clock)."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("window_s"):
        return None
    return rec["tokens"] / rec["window_s"]
