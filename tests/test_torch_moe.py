"""The port's Mixture-of-Experts family against the JAX reference.

``moe._route`` and ``moe_ffn`` on the same f32 inputs (numpy, from a
seed): dispatch equal exactly, with a case where the capacity drops
tokens and a tie; combine and the FFN within 1e-6 and 1e-5 relative (the
router product and the softmax sum in another order than XLA's, a few
ulps). The MoE model's logits, loss and gradients on bridged f32 weights
within 1e-5 relative; in bf16 the same greedy argmax. Then the port of
``tests/test_moe.py::TestMoEModelFamily`` (its config and prompts): the
model trains, and the port's engine gives the reference engine's token
streams in every mode, int8 weights included.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import bridged_params, grads_tree  # noqa: E402
from tpumon.loadgen import model as jax_model  # noqa: E402
from tpumon.loadgen import moe as jax_moe  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen import train as jax_train  # noqa: E402
from tpumon_torch.loadgen import model, moe, serving, train  # noqa: E402

CFG = dict(d_model=32, d_ff=64, n_experts=8, capacity_factor=1.25)
# tests/test_moe.py::TestMoEModelFamily's model and prompts.
MOE = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=64, compute_dtype="float32", n_experts=4)
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7], [2, 7]]


def moe_inputs(seed=0, g=64, tie=False):
    """numpy router, banks and tokens; ``tie``: a zero router, so every
    token's probabilities tie and argmax takes the first expert."""
    rng = np.random.default_rng(seed)
    d, ff, e = CFG["d_model"], CFG["d_ff"], CFG["n_experts"]
    p = {"router": rng.standard_normal((d, e), np.float32) * d**-0.5,
         "w_in": rng.standard_normal((e, d, ff), np.float32) * d**-0.5,
         "w_out": rng.standard_normal((e, ff, d), np.float32) * ff**-0.5}
    if tie:
        p["router"] = np.zeros_like(p["router"])
    return p, rng.standard_normal((g, d), np.float32)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (case, capacity): the capacity-factor default (1.25 x 64 / 8 = 10, which
# routing at these seeds overflows), a small one that drops most tokens,
# full capacity (no drops), and the tie: every token to expert 0, so 10
# kept and 54 dropped.
ROUTE_CASES = [("default", None), ("drops", 3), ("full", 64), ("tie", None)]


@pytest.mark.parametrize("case,capacity", ROUTE_CASES)
def test_route_matches_reference(case, capacity):
    p, x = moe_inputs(seed=1, tie=case == "tie")
    cap = capacity or jax_moe.MoEConfig(**CFG).capacity(len(x))
    jd, jc = jax_moe._route(jax_moe.MoEConfig(**CFG),
                            jnp.asarray(p["router"]), jnp.asarray(x), cap)
    td, tc = moe._route(moe.MoEConfig(**CFG), torch.from_numpy(p["router"]),
                        torch.from_numpy(x), cap)
    jd, jc = np.asarray(jd), np.asarray(jc)
    assert td.dtype == tc.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-6, atol=0)
    kept = int(jd.sum())
    if case == "tie":
        assert kept == cap == 10 and jd[:, 0].sum() == 10
        np.testing.assert_array_equal(tc.numpy(), jc)  # gates 1/8 exactly
    elif case == "full":
        assert kept == len(x)
    else:
        assert kept < len(x)  # overflow dropped


@pytest.mark.parametrize("case,capacity", ROUTE_CASES)
def test_moe_ffn_matches_reference(case, capacity):
    p, x = moe_inputs(seed=2, tie=case == "tie")
    want = np.asarray(jax_moe.moe_ffn(
        jax_moe.MoEConfig(**CFG), {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x), capacity=capacity))
    got = moe.moe_ffn(moe.MoEConfig(**CFG),
                      {k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), capacity=capacity)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert rel(got.numpy(), want) <= 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # Dropped tokens come back as zeros, exactly where the reference's do.
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)


def test_moe_ffn_gradients_match_reference():
    """The gate carries the router's gradient (the one-hot none), and x
    gets its own back from the slot it was copied to."""
    p, x = moe_inputs(seed=3)
    cfg = jax_moe.MoEConfig(**CFG)

    def jloss(p, x):
        return jnp.sum(jnp.sin(jax_moe.moe_ffn(cfg, p, x)))

    jg = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    torch.sin(moe.moe_ffn(moe.MoEConfig(**CFG), tp, tx)).sum().backward()
    for k in p:
        assert rel(tp[k].grad.numpy(), jg[0][k]) <= 1e-5, k
    assert rel(tx.grad.numpy(), jg[1]) <= 1e-5


def test_init_params_tree_and_scales_are_the_references():
    jcfg, tcfg = jax_model.ModelConfig(**MOE), model.ModelConfig(**MOE)
    want = jax.tree.map(np.asarray, jax_model.init_params(
        jcfg, jax.random.PRNGKey(0)))
    got = model.init_params(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.structure(want) == jax.tree.structure(
        model.map_params(got, lambda t: t.numpy()))
    scales = {"router": MOE["d_model"] ** -0.5,
              "w_in": MOE["d_model"] ** -0.5, "w_out": MOE["d_ff"] ** -0.5}
    for li in range(MOE["n_layers"]):
        for k, w in want["layers"][li]["moe"].items():
            t = got["layers"][li]["moe"][k]
            assert t.shape == w.shape and t.dtype == torch.float32
            # Both draws' spread is the reference's scale (the router's
            # 256 draws read within 15% of it in both packages).
            for std in (float(t.std()), float(w.std())):
                np.testing.assert_allclose(std, scales[k], rtol=0.15)


@pytest.fixture(scope="module")
def weights():
    return bridged_params(jax_model.ModelConfig(**MOE), seed=0)


def test_moe_model_logits_loss_and_grads_match_reference(weights):
    jparams, tree = weights
    jcfg, tcfg = jax_model.ModelConfig(**MOE), model.ModelConfig(**MOE)
    toks = np.random.default_rng(0).integers(0, 128, (2, 33)).astype(np.int32)
    logits = jax_model.forward(jcfg, jparams, jnp.asarray(toks[:, :-1]))
    loss, grads = jax.value_and_grad(partial(jax_model.loss_fn, jcfg))(
        jparams, jnp.asarray(toks))
    params = model.params_from_jax(tree)
    got = model.forward(tcfg, params, torch.from_numpy(toks[:, :-1]))
    assert rel(got.detach().numpy(), logits) <= 1e-5
    tloss, tgrads = model.value_and_grad(tcfg, params, torch.from_numpy(toks))
    assert abs(float(tloss) - float(loss)) <= 1e-5 * abs(float(loss))
    got_tree = model.map_params(grads_tree(params, tgrads),
                                lambda t: t.numpy())
    pairs = zip(jax.tree.leaves_with_path(grads), jax.tree.leaves(got_tree))
    for (path, want), g in pairs:
        assert rel(g, want) <= 1e-5, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, np.asarray(want), rtol=2e-4, atol=1e-5)


def test_moe_model_bf16_greedy_argmax_matches_reference(weights):
    jparams, tree = weights
    over = dict(MOE, compute_dtype="bfloat16")
    toks = np.random.default_rng(1).integers(0, 128, (2, 40)).astype(np.int32)
    want = np.asarray(jax_model.forward(jax_model.ModelConfig(**over),
                                        jparams, jnp.asarray(toks)))
    got = model.forward(model.ModelConfig(**over), model.params_from_jax(tree),
                        torch.from_numpy(toks)).detach().numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("n_experts,seq", [(4, 32), (8, 32), (8, 1024)])
def test_flops_per_token_is_the_references(n_experts, seq):
    over = dict(MOE, n_experts=n_experts)
    assert train.flops_per_token(model.ModelConfig(**over), seq) == (
        jax_train.flops_per_token(jax_model.ModelConfig(**over), seq))


class TestMoEModelFamily:
    """tests/test_moe.py::TestMoEModelFamily on the port: the same model
    and prompts, the reference's engine as the oracle."""

    def test_moe_model_trains(self, weights):
        """30 SGD steps at lr 0.1 drop the loss by 0.5, the reference's
        bound, from the reference's init and tokens."""
        cfg = model.ModelConfig(**MOE)
        params = model.params_from_jax(weights[1])
        toks = torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(1), (2, 33), 0, MOE["vocab"], jnp.int32)))
        l0 = float(model.loss_fn(cfg, params, toks))
        for _ in range(30):
            params, loss = model.sgd_train_step(cfg, params, toks, lr=0.1)
        assert float(loss) < l0 - 0.5, (l0, float(loss))

    @staticmethod
    def _serve(package, params, **kw):
        mod = serving if package == "port" else jax_serving
        mcfg = (model.ModelConfig if package == "port"
                else jax_model.ModelConfig)(**MOE)
        extra = {"device": "cpu"} if package == "port" else {}
        eng = mod.ServingEngine(cfg=mod.ServeConfig(
            model=mcfg, slots=2, prefill_len=8, **kw), params=params, **extra)
        reqs = [eng.submit(p, max_new=8) for p in PROMPTS]
        eng.drain()
        assert all(r.done.is_set() for r in reqs)
        return [r.output for r in reqs]

    # Each port mode against the reference engine in the same mode (the
    # reference has no CPU kernel path: its paged gather stands in).
    MODES = {
        "step": ({}, {}),
        "block4": ({"decode_block": 4}, None),
        "paged_gather": ({"kv_layout": "paged"}, None),
        "paged_kernel": ({"kv_layout": "paged", "paged_attn": "kernel"},
                         {"kv_layout": "paged"}),
        "spec3": ({"spec_len": 3}, None),
        "prompt_lookup_paged": ({"spec_len": 3, "spec_source": "prompt",
                                 "kv_layout": "paged"}, None),
    }

    @pytest.mark.parametrize("mode", list(MODES))
    def test_serving_modes_give_the_references_streams(self, weights, mode):
        jparams, tree = weights
        port_kw, ref_kw = self.MODES[mode]
        want = self._serve("jax", jparams,
                           **(port_kw if ref_kw is None else ref_kw))
        got = self._serve("port", model.params_from_jax(tree), **port_kw)
        assert got == want
        # Every mode equals the step mode's streams (full capacity).
        assert got == self._serve("port", model.params_from_jax(tree))

    def test_int8_kv_completes_with_valid_tokens(self, weights):
        outs = self._serve("port", model.params_from_jax(weights[1]),
                           kv_dtype="int8", decode_block=4)
        assert all(len(o) == 9 for o in outs)
        assert all(0 <= t < MOE["vocab"] for o in outs for t in o)

    def test_int8_weights_give_the_references_int8_streams(self, weights):
        jparams, tree = weights
        want = self._serve("jax", jparams, quantize="int8")
        got = self._serve("port", model.params_from_jax(tree),
                          quantize="int8")
        assert got == want


def test_prefill_chunk_cap_message_is_the_references():
    msgs = []
    for mod, mcfg in ((serving, model.ModelConfig),
                      (jax_serving, jax_model.ModelConfig)):
        cfg = mod.ServeConfig(model=mcfg(**dict(MOE, max_seq=1024)),
                              prefill_len=512)
        kw = {"device": "cpu"} if mod is serving else {}
        with pytest.raises(ValueError) as exc:
            mod.ServingEngine(cfg=cfg, **kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "moe_prefill_max_chunk" in msgs[0]


def test_engine_keeps_the_router_f32(weights):
    """The one-time cast to the compute dtype skips the router (the
    reference routes in f32); int8 weights quantize the expert banks per
    output channel over the leading axes, and leave the router alone."""
    cfg = serving.ServeConfig(
        model=model.ModelConfig(**dict(MOE, compute_dtype="bfloat16")),
        slots=2, prefill_len=8)
    eng = serving.ServingEngine(cfg=cfg, params=model.params_from_jax(
        weights[1]), device="cpu")
    layer = eng.params["layers"][0]["moe"]
    assert layer["router"].dtype == torch.float32
    assert layer["w_in"].dtype == layer["w_out"].dtype == torch.bfloat16
    q = serving.ServingEngine(cfg=dataclasses.replace(cfg, quantize="int8"),
                              params=model.params_from_jax(weights[1]),
                              device="cpu").params["layers"][0]["moe"]
    assert q["router"].dtype == torch.float32
    assert q["w_in"].q.shape == (4, 64, 128) and q["w_in"].scale.shape == (
        128,)
    assert q["w_out"].scale.shape == (64,)


def test_moe_with_sequence_parallelism_refused_like_the_reference():
    with pytest.raises(ValueError, match="MoE family does not compose"):
        train.TrainConfig(model=model.ModelConfig(**MOE), parallel="sp")


def test_moe_checkpoint_is_served(tmp_path):
    """The MoE trainer's checkpoint (the ``moe`` subtree) restores into
    the engine, which serves it."""
    cfg = train.TrainConfig(model=model.ModelConfig(**MOE), steps=2,
                            batch=2, seq=16, ckpt_dir=str(tmp_path),
                            ckpt_every=2)
    out = train.run_train(cfg, "cpu")
    eng = serving.ServingEngine(ckpt_dir=str(tmp_path), device="cpu")
    assert eng.ckpt_step == 1
    want = out["params"]["layers"][1]["moe"]["w_out"]
    assert torch.equal(eng.params["layers"][1]["moe"]["w_out"], want)
    req = eng.submit([1, 2, 3], max_new=3)
    eng.drain()
    assert req.status == "completed" and len(req.output) == 4


@pytest.mark.parametrize("dp,ep", [(2, 4), (1, 8), (4, 2)])
def test_sharded_moe_step_matches_reference(dp, ep):
    """tests/test_moe.py::test_sharded_moe_train_step through both
    packages: the experts over an "expert" axis, tokens over "data" (the
    reference on its CPU devices, the port on [cpu] * dp * ep). The loss
    is the reference's within 1e-5 relative, one step lands on its params
    (rtol 2e-4 / atol 2e-6), the second step's loss falls, and each
    device's w_in is its block of the experts."""
    from jax.sharding import Mesh as JaxMesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    p_np, x = moe_inputs(seed=3)
    jcfg, cfg = jax_moe.MoEConfig(**CFG), moe.MoEConfig(**CFG)
    jmesh = JaxMesh(np.array(jax.devices()[:dp * ep]).reshape(dp, ep),
                    ("data", "expert"))
    jstep, jplaced = jax_moe.make_sharded_moe_step(
        jcfg, jmesh, {k: jnp.asarray(v) for k, v in p_np.items()})
    jx = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("data", None)))
    jp1, jl1 = jstep(jplaced, jx)
    mesh = model.Mesh([[torch.device("cpu")] * ep] * dp, ("data", "expert"))
    step, placed = moe.make_sharded_moe_step(
        cfg, mesh, {k: torch.from_numpy(v) for k, v in p_np.items()})
    p1, l1 = step(placed, torch.from_numpy(x))
    assert abs(float(l1) - float(jl1)) <= 1e-5 * float(jl1)
    new = model.unshard_params(mesh, p1,
                               moe.moe_param_shardings(mesh, p1[0]))
    for k in p_np:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jp1[k]),
                                   rtol=2e-4, atol=2e-6, err_msg=k)
    assert moe.MOE_PARAM_SPECS["w_in"] == ("expert", None, None)
    for i, shard in enumerate(p1):
        e = mesh.coords(i)["expert"]
        n = CFG["n_experts"] // ep
        assert torch.equal(shard["w_in"], new["w_in"][e * n:(e + 1) * n])
    _, l2 = step(p1, torch.from_numpy(x))  # updates p1 in place
    assert float(l2) < float(l1)
