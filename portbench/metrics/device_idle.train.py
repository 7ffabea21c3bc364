"""device_idle.train: share of the traced slice that the union of device
operations does not cover (%)."""


def read(rec):
    sl = rec.get("slice")
    if rec.get("kind") != "train" or not rec.get("on_card") or not sl:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
