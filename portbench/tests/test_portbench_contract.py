"""BENCHMARK.json and the data files beside it: published widths, the
contract's shapes and names, and every file the harness finds by name."""

import json
import re

import pytest

from portbench import families, run

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# Published config.json values (Hugging Face) of the configurations
# there now, the widths never cut, and the head width the harness reads.
PUBLISHED = {
    "mistral-7b-v0.3": (dict(hidden_size=4096, intermediate_size=14336,
                             num_attention_heads=32, num_key_value_heads=8,
                             vocab_size=32768, rope_theta=1e6,
                             num_hidden_layers=32, rms_norm_eps=1e-5,
                             tie_word_embeddings=False,
                             torch_dtype="bfloat16"), 128),
    "deepseek-llm-7b-base": (dict(hidden_size=4096, intermediate_size=11008,
                                  num_attention_heads=32,
                                  num_key_value_heads=32, vocab_size=102400,
                                  rope_theta=1e4, num_hidden_layers=30,
                                  rms_norm_eps=1e-6,
                                  tie_word_embeddings=False,
                                  torch_dtype="bfloat16"), 128),
}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_widths_are_published(entry):
    """Every configuration, of any family, against its own file: the
    keys it reduced are those it records as published, each changed;
    its source is named; its widths build through its family. The
    configurations above also against their published values."""
    cfg = json.loads((run.ROOT / entry["file"]).read_text())
    published = cfg.get("published", {})
    assert set(entry["reduced"]) == set(published)
    for key, value in published.items():
        assert cfg[key] != value, key
    assert entry["source"] and cfg["source"] == entry["source"]
    s = families.of(cfg).sizes(cfg)
    known, head_dim = PUBLISHED.get(entry["name"], ({}, s.head_dim))
    for key, value in known.items():
        assert published.get(key, cfg[key]) == value, key
        if key not in entry["reduced"]:
            assert cfg[key] == value, key
    assert s.head_dim == head_dim


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its allowance.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + (
        1200) <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_names_units_and_cells():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in run.cell_metrics(BENCH, w["name"], False)]
        layer = run.cell_metrics(BENCH, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:  # each per-layer metric's e2e metric is there too
            assert m["moves"] in e2e


def test_every_named_file_exists():
    for w in BENCH["workloads"]:
        mix = run.load_json(run.PKG / "traffic" / f"{w['traffic']}.json")
        assert (run.PKG / "drivers" / f"{mix['driver']}.py").exists()
        assert (run.PKG / "limits" / f"{w['name']}.json").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.reader(m["name"]))
