"""The port's sequence-parallel training against the JAX reference.

``tests/test_sp_train.py``'s cases through both packages on bridged
weights and numpy-made tokens: the reference on its conftest's CPU
devices, the port on ``[cpu] * n`` (one controller; each device's
sequence block stays on it and the K/V blocks pass round the ring by
``.to()``). The sp loss must be the reference's sp loss and the
single-device loss; one sp step's updated params must be a single-device
SGD step's; and the composed dp x sp and dp x tp x sp meshes, remat (which
must also keep fewer bytes for the backward) and the refusals behave as
the reference's do.

Tolerances: f32 loss 1e-5 relative and gradients 1e-4 of the largest
gradient (summation order only); updated params rtol 2e-4 / atol 2e-6, the
reference's own bound in tests/test_sp_train.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from tests.torch_parity import (  # noqa: E402
    assert_trees_close,
    bridged_params,
    grads_tree,
)
from tpumon.loadgen import model as jax_model  # noqa: E402
from tpumon.loadgen import sp_train as jsp  # noqa: E402
from tpumon_torch.loadgen import model, sp_train, train  # noqa: E402

CPU = torch.device("cpu")
# tests/test_sp_train.py's CFG.
CFG = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=64, compute_dtype="float32")
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def weights():
    return bridged_params(jax_model.ModelConfig(**CFG), seed=0)


def tokens_np(b=2, t=32, seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab"], (b, t + 1)).astype(np.int32)


def port_cfg(**kw):
    return model.ModelConfig(**dict(CFG, **kw))


def seq_mesh(n):
    return model.Mesh([CPU] * n, ("seq",))


def single_device(tree, toks):
    """The reference's single-device (loss, gradient tree)."""
    loss, grads = jax.value_and_grad(lambda p: jax_model.loss_fn(
        jax_model.ModelConfig(**CFG), p, jnp.asarray(toks)))(tree)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("schedule", ["ring", "zigzag"])
def test_sp_loss_matches_reference(weights, n, schedule):
    jp, tree = weights
    toks = tokens_np()
    want = single_device(jp, toks)[0]
    ji, jl, jpos = jsp.sp_batch(jnp.asarray(toks), n, schedule)
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
    ref = float(jax.jit(lambda *a: jsp.sp_loss_fn(
        jax_model.ModelConfig(**CFG), *a, jmesh, schedule=schedule))(
        jp, ji, jl, jpos))
    inputs, labels, pos = sp_train.sp_batch(torch.from_numpy(toks), n,
                                            schedule)
    for a, b in ((inputs, ji), (labels, jl), (pos, jpos)):
        assert a.tolist() == np.asarray(b).tolist()
    got = float(sp_train.sp_loss_fn(port_cfg(), model.params_from_jax(tree),
                                    inputs, labels, pos, seq_mesh(n),
                                    schedule=schedule))
    for w in (want, ref):
        assert abs(got - w) <= LOSS_RTOL * abs(w)


@pytest.mark.parametrize("schedule", ["ring", "zigzag"])
def test_sp_train_step_descends_and_matches_reference_grads(weights,
                                                            schedule):
    """Over 4 devices: the sp gradients are the single-device ones, one
    step lands on a single-device SGD step's params, and a second step on
    the same batch descends."""
    jp, tree = weights
    toks = tokens_np()
    want_loss, want_grads = single_device(jp, toks)
    mesh = seq_mesh(4)
    step, placed = sp_train.make_sp_train_step(
        port_cfg(), mesh, model.params_from_jax(tree), schedule=schedule)
    batch = step.prep(torch.from_numpy(toks))
    loss, grads = model.mesh_value_and_grad(
        mesh, placed, step.specs, lambda v: sp_train.sp_loss_fn(
            port_cfg(), v, *batch, mesh, schedule=schedule))
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(want_grads))
    assert_trees_close(want_grads, grads_tree(placed[0], grads[0]),
                       rtol=0, atol=GRAD_TOL * scale)
    p1, loss1 = step(placed, *batch)
    assert abs(float(loss1) - want_loss) <= LOSS_RTOL * want_loss
    sgd = jax.tree.map(lambda p, g: np.asarray(p) - 1e-3 * g, jp,
                       want_grads)
    assert_trees_close(sgd, model.unshard_params(mesh, p1, step.specs),
                       rtol=2e-4, atol=2e-6)
    _, loss2 = step(p1, *batch)
    assert float(loss2) < float(loss1)


def saved_bytes(fn):
    """(fn(), the bytes autograd kept for the backward pass while it ran,
    outside any region that recomputes them)."""
    n = [0]

    def pack(t):
        n[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, n[0]


def test_sp_remat_matches_no_remat(weights):
    """cfg.remat only changes what the backward recomputes, never the
    math: the remat loss and gradients are the reference's remat ones and
    the plain run's, and the forward keeps under a fifth of the plain
    run's bytes for the backward (each layer's activations are
    recomputed)."""
    jp, tree = weights
    toks = tokens_np()
    jcfg = jax_model.ModelConfig(**dict(CFG, remat=True))
    jmesh = JaxMesh(np.array(jax.devices()[:2]), ("seq",))
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, *a: jsp.sp_loss_fn(jcfg, p, *a, jmesh)))(
        jp, *jsp.sp_batch(jnp.asarray(toks), 2, "zigzag"))
    batch = sp_train.sp_batch(torch.from_numpy(toks), 2, "zigzag")
    runs = {}
    for remat in (False, True):
        params = model.params_from_jax(tree)
        leaves = model.param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, kept = saved_bytes(lambda: sp_train.sp_loss_fn(
            port_cfg(remat=remat), params, *batch, seq_mesh(2)))
        runs[remat] = (float(loss.detach()), kept, grads_tree(
            params, torch.autograd.grad(loss, leaves)))
    base, remat = runs[False], runs[True]
    assert abs(remat[0] - base[0]) <= 1e-6 * base[0]
    assert abs(remat[0] - float(want_loss)) <= LOSS_RTOL * float(want_loss)
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(want_grads))
    for got in (remat[2], base[2]):
        assert_trees_close(jax.tree.map(np.asarray, want_grads), got,
                           rtol=0, atol=GRAD_TOL * scale)
    assert remat[1] < base[1] / 5, (remat[1], base[1])


def test_sp_bad_schedule_rejected(weights):
    _, tree = weights
    toks = torch.from_numpy(tokens_np())
    with pytest.raises(ValueError, match="schedule"):
        sp_train.sp_batch(toks, 2, "Zigzag")
    inputs, labels, pos = sp_train.sp_batch(toks, 2, "ring")
    with pytest.raises(ValueError, match="schedule"):
        sp_train.sp_loss_fn(port_cfg(), model.params_from_jax(tree), inputs,
                            labels, pos, seq_mesh(2), schedule="striped")


def test_dp2_sp4_loss_matches_reference(weights):
    """tests/test_sp_train.py::test_dp2_sp4_loss_matches_single_device."""
    jp, tree = weights
    toks = tokens_np(b=4)
    want = single_device(jp, toks)[0]
    mesh = model.Mesh([[CPU] * 4] * 2, ("data", "seq"))
    for schedule in ("ring", "zigzag"):
        batch = sp_train.sp_batch(torch.from_numpy(toks), 4, schedule)
        got = float(sp_train.sp_loss_fn(port_cfg(),
                                        model.params_from_jax(tree), *batch,
                                        mesh, schedule=schedule,
                                        dp_axis="data"))
        assert abs(got - want) <= LOSS_RTOL * want


def test_dp2_tp2_sp2_train_step_matches_reference_grads(weights):
    """The 2x2x2 dp x tp x sp step: loss and updated params equal a
    single-device SGD step's, and the reference's own 2x2x2 step's."""
    jp, tree = weights
    toks = tokens_np(b=4, t=8)
    want_loss, want_grads = single_device(jp, toks)
    jmesh = JaxMesh(np.array(jax.devices()).reshape(2, 2, 2),
                    ("data", "model", "seq"))
    jstep, jplaced = jsp.make_sp_train_step(
        jax_model.ModelConfig(**CFG), jmesh, jp, dp_axis="data",
        tp_axis="model", schedule="zigzag")
    jnew, jloss = jstep(jplaced, *jstep.prep(jnp.asarray(toks)))
    mesh = model.Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 2, 2),
                      ("data", "model", "seq"))
    step, placed = sp_train.make_sp_train_step(
        port_cfg(), mesh, model.params_from_jax(tree), dp_axis="data",
        tp_axis="model", schedule="zigzag")
    p1, loss1 = step(placed, *step.prep(torch.from_numpy(toks)))
    for w in (want_loss, float(jloss)):
        assert abs(float(loss1) - w) <= LOSS_RTOL * w
    new = model.unshard_params(mesh, p1, step.specs)
    sgd = jax.tree.map(lambda p, g: np.asarray(p) - 1e-3 * g, jp,
                       want_grads)
    assert_trees_close(sgd, new, rtol=2e-4, atol=2e-6)
    assert_trees_close(jax.tree.map(np.asarray, jnew), new, rtol=2e-4,
                       atol=2e-6)
    assert p1[0]["layers"][0]["wq"].shape == (64, 32)  # split over "model"


def test_tp_axis_must_be_named_model(weights):
    _, tree = weights
    mesh = model.Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 2, 2),
                      ("data", "tensor", "seq"))
    with pytest.raises(ValueError, match="model"):
        sp_train.make_sp_train_step(port_cfg(), mesh,
                                    model.params_from_jax(tree),
                                    dp_axis="data", tp_axis="tensor")


@pytest.mark.parametrize("parallel", ["sp", "sp-ring"])
def test_run_train_sequence_parallel(parallel):
    """run_train's sp branch over devices=[cpu] * 2 lands on the
    single-device run's loss; the reference's refusals stand (one device,
    seq - 1 not divisible, a mesh= with parallel=, the MoE family)."""
    cfg = train.TrainConfig(model=port_cfg(), steps=2, batch=2, seq=17,
                            parallel=parallel)
    out = train.run_train(cfg, devices=[CPU] * 2)
    one = train.run_train(dataclasses.replace(cfg, parallel="auto"), "cpu")
    assert out["mesh"] == {"seq": 2}
    assert abs(out["loss"] - one["loss"]) <= LOSS_RTOL * one["loss"]
    with pytest.raises(ValueError, match=">1 device"):
        train.run_train(cfg, devices=[CPU])
    with pytest.raises(ValueError, match="divisible"):
        train.run_train(dataclasses.replace(cfg, seq=16), devices=[CPU] * 2)
    with pytest.raises(ValueError, match="either mesh"):
        train.run_train(cfg, mesh=seq_mesh(2), devices=[CPU] * 2)
    with pytest.raises(ValueError, match="MoE family does not compose"):
        train.TrainConfig(model=port_cfg(n_experts=4), parallel=parallel)
