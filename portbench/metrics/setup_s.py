"""setup_s: process start to the start of the window, less the set-up
time spent only on the correctness readings (host clock)."""


def read(rec):
    return rec.get("setup_s")
