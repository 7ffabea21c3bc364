"""DeepSeek-V2 on the port: latent attention (MLA) through the paged pool,
the dropless routed top-k FFN with shared experts, and YaRN, against the
plain float32 reference (``portbench/reference/deepseek_v2.py``), on the
CPU at a small size in float32, with seeded random weights drawn by the
benchmark's family (``portbench/families/deepseek_v2.py``).

The served logits (each prompt prefilled chunk by chunk on the gather
route, then decoded through ``paged_attention``'s plain version) are held
to the reference's full forward within ``LOGIT_TOL`` of the largest
reference logit: float32 on both sides, the absorbed decode and the
grouped expert products reassociate the sums, which moves logits by
~1e-6 of their scale. Each planted fault (in the reference, put in the
program's place) moves them by more than a hundred times that.
"""

import copy
import json

import pytest
import torch
import torch.nn.functional as F

from portbench import families, run
from portbench.reference import deepseek_v2 as ref
from tpumon_torch.loadgen import model as model_mod
from tpumon_torch.loadgen.model import (
    init_params,
    latent_softmax_scale,
    rope_cos_sin_scale,
    rope_inv_freq,
    yarn_correction_range,
)
from tpumon_torch.loadgen.moe import TopKConfig, init_topk_params, topk_ffn
from tpumon_torch.loadgen.paged_kv import (
    init_pool,
    paged_decode_step,
    paged_prefill,
)
from tpumon_torch.loadgen.serving import ServeConfig, ServingEngine

CONFIG = run.PKG / "configs" / "deepseek-v2-lite.json"
# The published widths cut for the CPU; every mechanism kept (a dense
# first layer, routed layers with shared experts, YaRN at the published
# factor).
TINY = dict(hidden_size=64, intermediate_size=96, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            moe_intermediate_size=24, n_routed_experts=8,
            num_experts_per_tok=3, num_attention_heads=4,
            num_key_value_heads=4, num_hidden_layers=3, vocab_size=128,
            torch_dtype="float32")
LOGIT_TOL = 1e-4  # of the largest reference logit
PROMPTS = ([3 + i % 97 for i in range(37)], [11, 5, 7, 2, 9], [40] * 16)
STEPS = 6


def tiny_cfg() -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg.update(TINY)
    cfg["serving"]["engine"].update(prefill_len=16, slots=3)
    cfg["serving"]["model"]["max_seq"] = 64
    return cfg


def build(cfg, seed=5):
    fam = families.of(cfg)
    s = fam.sizes(cfg)
    m = fam.model_config(cfg, cfg["serving"]["model"])
    scfg = ServeConfig(model=m, **cfg["serving"]["engine"])
    return fam, s, scfg, fam.make_params(s, seed, "cpu", torch.float32)


def serve(scfg, params, prompts, steps, moe_rows=None):
    """Each prompt prefilled chunk by chunk into its own pages, then
    ``steps`` greedy decode steps of all of them at once; (token lists,
    logits [tokens, vocab] a sequence: the prefill's last row, then each
    decode step's)."""
    m = scfg.model
    page = scfg.prefill_len
    max_pages = m.max_seq // page
    pool = init_pool(scfg, 1 + len(prompts) * max_pages, "cpu")
    tables = torch.tensor([[1 + b * max_pages + j for j in range(max_pages)]
                           for b in range(len(prompts))], dtype=torch.int32)
    seqs = [list(p) for p in prompts]
    logits = [[] for _ in prompts]
    for b, p in enumerate(prompts):
        for c0 in range(0, len(p), page):
            chunk = p[c0:c0 + page]
            toks = torch.tensor(chunk + [0] * (page - len(chunk)),
                                dtype=torch.int32)
            lg = paged_prefill(scfg, params, pool, toks, len(chunk),
                               int(tables[b, c0 // page]), tables[b], c0,
                               moe_rows=moe_rows)
        logits[b].append(lg)
        seqs[b].append(int(lg.argmax()))
    for _ in range(steps):
        last = torch.tensor([s[-1] for s in seqs], dtype=torch.int32)
        pos = torch.tensor([len(s) - 1 for s in seqs], dtype=torch.int32)
        lg = paged_decode_step(scfg, params, pool, last, pos, tables,
                               moe_rows=moe_rows)
        for b in range(len(seqs)):
            logits[b].append(lg[b])
            seqs[b].append(int(lg[b].argmax()))
    return seqs, [torch.stack(rows) for rows in logits]


def reference_gap(fam, s, cfg, params, prompts, seqs, logits) -> float:
    """Widest |served - reference| logit over every served row, over the
    largest reference logit."""
    rc = fam.ref_cfg(s, cfg)
    worst = 0.0
    for p, seq, lg in zip(prompts, seqs, logits):
        h = ref.hidden(params, torch.tensor(seq[:-1])[None], rc)[0]
        want = ref.logits(params, h[len(p) - 1:])
        worst = max(worst, float((lg - want).abs().max()
                                 / want.abs().max()))
    return worst


@pytest.fixture(scope="module")
def served():
    cfg = tiny_cfg()
    fam, s, scfg, params = build(cfg)
    seqs, logits = serve(scfg, params, PROMPTS, STEPS)
    return cfg, fam, s, scfg, params, seqs, logits


def test_served_logits_match_the_reference(served):
    cfg, fam, s, _, params, seqs, logits = served
    assert reference_gap(fam, s, cfg, params, PROMPTS, seqs,
                         logits) <= LOGIT_TOL


def _no_mscale(cfg):
    return (cfg["nope"] + cfg["rope_dim"]) ** -0.5


def _renormalised(x, router, cfg, prec):
    g, e = torch.topk(torch.softmax(prec.mm(x, router), -1), cfg["top_k"],
                      dim=-1)
    return g / g.sum(-1, keepdim=True), e


def _one_dim_unrotated(cfg, inv_freq=ref.inv_freq):
    freqs = inv_freq(cfg).clone()
    freqs[0] = 0.0
    return freqs


FAULTS = {
    "mscale_dropped": ("softmax_scale", _no_mscale),
    "topk_renormalised": ("gates", _renormalised),
    "shared_expert_left_out": (
        "shared_ffn", lambda x, e, cfg, prec: torch.zeros_like(x)),
    "kv_a_norm_skipped": ("kv_norm", lambda c, w, eps: c),
    "one_rope_dim_unrotated": ("inv_freq", _one_dim_unrotated),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_the_comparison(served, fault,
                                                 monkeypatch):
    cfg, fam, s, _, params, seqs, logits = served
    name, planted = FAULTS[fault]
    monkeypatch.setattr(ref, name, planted)
    assert reference_gap(fam, s, cfg, params, PROMPTS, seqs,
                         logits) > 100 * LOGIT_TOL


def test_engine_serves_the_reference_tokens(served):
    """The engine (paged, kernel read: its plain version here) emits the
    greedy tokens of the direct prefill and decode calls, and counts its
    routed pairs on the host and its rows per expert on the device: a
    chunk's tokens alone, every slot of a decode step."""
    cfg, _, s, scfg, params, seqs, _ = served
    eng = ServingEngine(scfg, params=params, seed=1, device="cpu")
    reqs = [eng.submit(p, max_new=STEPS) for p in PROMPTS]
    eng.drain()
    for p, seq, r in zip(PROMPTS, seqs, reqs):
        assert r.status == "completed"
        assert r.output == seq[len(p):]
    rows = eng.moe_rows
    assert rows.shape == (s.routed_layers, 2, s.n_experts)
    chunks = sum(-(-len(p) // scfg.prefill_len) for p in PROMPTS)
    calls = chunks + eng.decode_steps_total
    pairs = (sum(map(len, PROMPTS)) + eng.decode_steps_total
             * scfg.slots) * s.top_k
    assert eng.moe_pairs_routed == pairs * s.routed_layers
    assert (rows[:, 0].sum(dim=1) == pairs).all()
    assert (rows[:, 1] <= calls).all() and (rows[:, 1] > 0).any()


def _swiglu_loop(cfg: TopKConfig, params, x, n_shared):
    """Each token through its experts one at a time."""
    ff = cfg.d_ff
    probs = torch.softmax(x @ params["router"], dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    y = torch.zeros_like(x)
    for t in range(x.shape[0]):
        picks = [(int(e), float(g)) for e, g in zip(experts[t], gates[t])]
        picks += [(cfg.n_experts + i, 1.0) for i in range(n_shared)]
        for e, g in picks:
            h = x[t] @ params["w_gate_up"][e]
            y[t] += g * (F.silu(h[:ff]) * h[ff:]) @ params["w_down"][e]
    return y


@pytest.mark.parametrize("crowded", [False, True])
def test_grouped_ffn_matches_a_per_expert_loop(crowded):
    """Dropless: every (token, expert) pair computed, also when the router
    sends every token to the same top-k experts; the sum over blocks of
    experts (the shared ones in one block) is the whole layer."""
    cfg = TopKConfig(d_model=32, d_ff=16, n_experts=12, top_k=6,
                     n_shared=2)
    params = init_topk_params(cfg, torch.Generator().manual_seed(3))
    x = torch.randn(40, 32, generator=torch.Generator().manual_seed(4))
    chosen = [1, 3, 4, 6, 9, 11]
    if crowded:
        x[:, 0] = 8.0
        params["router"][0, chosen] = 4.0
    counts = torch.zeros((2, cfg.n_experts), dtype=torch.int64)
    got = topk_ffn(cfg, params, x, counts=counts)
    want = _swiglu_loop(cfg, params, x, cfg.n_shared)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert int(counts[0].sum()) == 40 * cfg.top_k
    assert int(counts[1].max()) == 1
    if crowded:
        assert counts[0, chosen].tolist() == [40] * 6
    half = cfg.n_experts // 2
    lo = {"router": params["router"],
          "w_gate_up": torch.cat([params["w_gate_up"][:half],
                                  params["w_gate_up"][cfg.n_experts:]]),
          "w_down": torch.cat([params["w_down"][:half],
                               params["w_down"][cfg.n_experts:]])}
    hi = {"router": params["router"],
          "w_gate_up": params["w_gate_up"][half:cfg.n_experts],
          "w_down": params["w_down"][half:cfg.n_experts]}
    parts = topk_ffn(cfg, lo, x) + topk_ffn(cfg, hi, x, n_shared=0,
                                            expert_offset=half)
    assert float((parts - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_yarn_at_the_published_numbers():
    cfg = json.loads(CONFIG.read_text())
    m = families.of(cfg).model_config(cfg, cfg["serving"]["model"])
    assert yarn_correction_range(m) == (10, 23)
    assert latent_softmax_scale(m) == pytest.approx(0.114721, abs=5e-7)
    assert rope_cos_sin_scale(m) == 1.0
    inv = rope_inv_freq(m, "cpu")
    extra = 1e4 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    assert torch.allclose(inv[:11].double(), extra[:11], rtol=1e-6)
    assert torch.allclose(inv[23:].double(), extra[23:] / 40, rtol=1e-6)
    mid = inv[11:23].double()
    assert ((mid < extra[11:23]) & (mid > extra[11:23] / 40)).all()
    rc = families.of(cfg).ref_cfg(families.of(cfg).sizes(cfg), cfg)
    assert ref.ramp_range(rc) == (10, 23)
    assert ref.softmax_scale(rc) == pytest.approx(latent_softmax_scale(m))
    assert torch.allclose(ref.inv_freq(rc), inv, rtol=1e-6)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_family_sizes_and_params_follow_the_config():
    cfg = json.loads(CONFIG.read_text())
    fam = families.of(cfg)
    s = fam.sizes(cfg)
    assert (s.d_model, s.n_layers, s.n_heads, s.kv_lora_rank,
            s.qk_nope_head_dim, s.qk_rope_head_dim, s.v_head_dim, s.d_ff,
            s.expert_d_ff, s.n_experts, s.top_k, s.n_shared,
            s.first_dense, s.vocab) == (
        2048, 8, 16, 512, 128, 64, 128, 10944, 1408, 64, 6, 2, 1, 102400)
    assert (s.slots, s.head_dim, s.latent_width) == (256, 192, 576)
    assert fam.n_params(s) == 4_594_374_656
    assert fam.n_params(s._replace(n_layers=27)) == 15_706_484_224
    tiny = tiny_cfg()
    _, ts, scfg, params = build(tiny)
    want = init_params(scfg.model, torch.Generator().manual_seed(0))
    assert _shapes(params) == _shapes(want)
    assert sum(t.numel() for _, t in fam.initial_leaves(
        ts, 5, "cpu", torch.float32)) == fam.n_params(ts)
    again = fam.make_params(ts, 5, "cpu", torch.float32)
    assert torch.equal(again["layers"][2]["experts"]["w_gate_up"],
                       params["layers"][2]["experts"]["w_gate_up"])


def test_family_refuses_what_the_port_does_not_compute():
    base = tiny_cfg()
    fam = families.of(base)
    for key, value in (("norm_topk_prob", True), ("q_lora_rank", 1536),
                       ("scoring_func", "sigmoid"),
                       ("routed_scaling_factor", 16.0),
                       ("topk_method", "noaux_tc"),
                       ("rms_norm_eps", 1e-5)):
        cfg = copy.deepcopy(base)
        cfg[key] = value
        with pytest.raises(ValueError, match=key):
            fam.model_config(cfg, {})
    cfg = copy.deepcopy(base)
    cfg["rope_scaling"]["type"] = "linear"
    with pytest.raises(ValueError, match="YaRN"):
        fam.model_config(cfg, {})


def test_training_and_other_serving_paths_refuse_the_config():
    cfg = tiny_cfg()
    _, _, scfg, params = build(cfg)
    m = scfg.model
    tokens = torch.zeros((1, 9), dtype=torch.long)
    for fn in (lambda: model_mod.forward(m, params, tokens[:, :-1]),
               lambda: model_mod.sgd_train_step(m, params, tokens)):
        with pytest.raises(ValueError, match="latent attention"):
            fn()
    for bad in (dict(kv_layout="dense", paged_attn="gather"),
                dict(paged_attn="gather"), dict(paged_attn="ring"),
                dict(spec_len=2), dict(decode_block=2),
                dict(prefix_cache_entries=2), dict(kv_dtype="int8"),
                dict(quantize="int8")):
        with pytest.raises(ValueError, match="latent attention"):
            ServingEngine(ServeConfig(**{**scfg.__dict__, **bad}),
                          params=params, device="cpu")
    mesh = model_mod.Mesh(["cpu", "cpu"], ("model",))
    with pytest.raises(ValueError, match="a mesh"):
        ServingEngine(scfg, params=params, device="cpu", mesh=mesh)


def _tiny_cell(tmp_path):
    """(bench, root, pkg): the cell ``tiny.dsv2`` over the tiny
    configuration, a small ShareGPT-like mix, the real metric readers and
    the real cell's limits."""
    import shutil

    root, pkg = tmp_path, tmp_path / "pkg"
    (pkg / "traffic").mkdir(parents=True)
    (pkg / "limits").mkdir()
    shutil.copytree(run.PKG / "metrics", pkg / "metrics")
    shutil.copy(run.PKG / "limits" / "dsv2lite.serve.sharegpt.json",
                pkg / "limits" / "tiny.dsv2.json")
    (root / "dsv2.json").write_text(json.dumps(tiny_cfg()))
    mix = json.loads((run.PKG / "traffic" / "sharegpt.json").read_text())
    mix.update(clients=3, prompt={"dist": "log_uniform", "min": 4,
                                  "max": 40},
               output={"dist": "log_uniform", "min": 3, "max": 12})
    (pkg / "traffic" / "sharegpt.json").write_text(json.dumps(mix))
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    bench["configs"] = [{"name": "d", "file": "dsv2.json"}]
    bench["workloads"] = [{"name": "tiny.dsv2", "config": "d",
                           "traffic": "sharegpt", "chips": 1}]
    return bench, root, pkg


@pytest.mark.parametrize("altered", [False, True])
def test_the_cell_runs_on_the_cpu_and_catches_an_altered_token(
        tmp_path, monkeypatch, altered):
    from tpumon_torch.loadgen import serving

    if altered:
        sample, calls = serving.sample_tokens, [0]

        def wrong(*a, **k):
            out = sample(*a, **k)
            calls[0] += 1
            return (out + 1) % 128 if calls[0] % 3 == 0 else out
        monkeypatch.setattr(serving, "sample_tokens", wrong)
    bench, root, pkg = _tiny_cell(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = run.execute(bench, "tiny.dsv2", 2**31 + 7, 1.0, False, "cpu",
                          root=root, pkg=pkg, log=lambda m: None)
    finally:
        torch.set_num_threads(threads)
    assert res["attempted"] > 0 and res["record"]["family"] == "deepseek_v2"
    assert res["correct"] is not altered, res["check"]


class _Peaks:
    hbm, bf16 = 3.35e12, 989e12


def _record(ops):
    s = families.of({"family": "deepseek_v2"}).sizes(json.loads(
        CONFIG.read_text()))
    steps = [[(100, 5, 6), (40, 0, 1)], [(100, 6, 7), (40, 1, 2)]]
    return {"kind": "serve", "on_card": True, "family": "deepseek_v2",
            "sizes": s, "elem": 2, "max_pages": 2, "peaks": _Peaks,
            "slice": {"ops": ops, "spans": {"serve.moe": [1e-3, 3e-3,
                                                          2e-3]}},
            "slice_work": {"chunks": [(0, 40)], "steps": steps,
                           "prefill_seen": True}}


def test_the_new_readers_read_their_launches_or_nothing():
    """Decode rounds here: [105] and [106, 41] (the second request's first
    token came from its chunk of 40): two paged calls a layer, three
    calls of the routed layers."""
    s = families.of({"family": "deepseek_v2"}).sizes(json.loads(
        CONFIG.read_text()))
    fam = families.of({"family": "deepseek_v2"})
    paged = "void paged_attention_kernel<bf16>"
    gemm = "cutlass::GroupProblemShape<...>"
    prep = "at::cuda::detail::prepare_grouped_gemm_data<...>"
    ops = {paged: (2 * s.n_layers, 1e-3), gemm: (6 * s.routed_layers, 4e-3),
           prep: (6 * s.routed_layers, 1e-4), "nvjet_other": (9, 1.0)}
    rec = _record(ops)
    latent = run.reader("latent_attn_roofline.serve")
    least = s.n_layers * sum(fam.latent_call_bound_s(
        s, ctx, 2, 2, 3.35e12, 989e12) for ctx in ([105], [106, 41]))
    assert latent(rec) == pytest.approx(100 * least / 1e-3)
    experts = run.reader("moe_expert_roofline.serve")
    least = s.routed_layers * sum(fam.expert_call_bound_s(
        s, n, rows, 2, 3.35e12, 989e12)
        for n, rows in ((40, 40), (1, 256), (2, 256)))
    assert experts(rec) == pytest.approx(100 * least / 4.1e-3)
    few = fam.expert_call_bound_s(s, 5, 5, 2, 3.35e12, 989e12)
    assert few < fam.expert_call_bound_s(s, 5, 256, 2, 3.35e12, 989e12)
    assert run.reader("moe_host_ms.serve")(rec) == pytest.approx(2.0)
    for broken in ({paged: (2 * s.n_layers - 1, 1e-3)},
                   {gemm: (6 * s.routed_layers + 1, 4e-3)}):
        rec = _record({**ops, **broken})
        assert (latent(rec) is None) is (paged in broken)
        assert (experts(rec) is None) is (gemm in broken)
    rec = _record(ops)
    rec["family"] = "llama"
    assert latent(rec) is None and experts(rec) is None
