"""A configuration, a traffic mix, a metric and a cell added as new
files and entries are found by name, with no edit to any file there."""

import hashlib
import json

from portbench import run


def _digest():
    h = hashlib.sha256()
    for p in sorted(run.PKG.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_new_files_are_found(tiny):
    before = _digest()
    bench, root, pkg = tiny
    cfg = run.load_json(root / "serve.json")
    cfg.update(num_hidden_layers=1, vocab_size=128)
    (root / "other.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "burst.json").write_text(json.dumps({
        "driver": "serve_closed_loop", "clients": 2,
        "prompt": {"dist": "uniform", "min": 40, "max": 60},
        "output": {"dist": "uniform", "min": 3, "max": 5},
        "engine": {"slots": 2}, "check_requests": 2}))
    (pkg / "metrics" / "requests_done.serve.py").write_text(
        "def read(rec):\n    return float(rec['attempted'])\n")
    (pkg / "limits" / "other.burst.json").write_text(json.dumps(
        {"logit_gap": {"limit": 0.2}}))
    bench["configs"].append({"name": "other", "file": "other.json"})
    bench["workloads"].append({"name": "other.burst", "config": "other",
                               "traffic": "burst", "chips": 1})
    bench["per_layer"].append({
        "name": "requests_done.serve", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "serving engine",
        "moves": "serve_tokens_per_s", "workloads": ["other.burst"]})
    res = run.execute(bench, "other.burst", 9, 0.5, False, "cpu", root=root,
                      pkg=pkg, log=lambda m: None)
    rec = res["record"]
    assert rec["sizes"].n_layers == 1 and rec["sizes"].vocab == 128
    assert res["correct"], res["check"]
    names = [m["name"] for m in run.cell_metrics(bench, "other.burst", True)]
    assert names == ["requests_done.serve"]
    assert run.reader("requests_done.serve", pkg)(rec) == rec["attempted"]
    assert _digest() == before
