"""serve_tokens_per_s: output tokens emitted in the window over the
window (host clock)."""


def read(rec):
    if rec.get("kind") != "serve" or not rec.get("window_s"):
        return None
    return rec["tokens"] / rec["window_s"]
