"""The port's dp x tp training step against the JAX reference.

The reference's ``make_sharded_train_step`` runs on its conftest's 8 CPU
devices, the port's on ``[cpu] * n`` (one controller, the same code that
runs dp x tp on one card), on bridged weights and numpy-made tokens: the
loss and the gradients must be the reference's single-device ones (the
reference's own sharded tests hold its sharded step to those), and one
step's updated params must be the reference's sharded step's. Cases:
``tests/test_loadgen.py``'s CFG over dp 2 x tp 4 with the naive schedule
and with ``attention="flash"`` (the flash kernels' plain twins on the
CPU), other layouts, bf16, and the MoE family (``tests/test_moe.py``);
remat on the mesh must also keep fewer bytes for the backward.

Tolerances: f32 loss 1e-5 relative and gradients 1e-4 of the largest
gradient (summation order only: the shards' partials and the dp sum
reassociate); updated params rtol 2e-4 / atol 2e-6 (the reference's
tests/test_sp_train.py bound); bf16 loss 2e-2 relative (each package
rounds its bf16 products in its own order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from tests.torch_parity import (  # noqa: E402
    assert_trees_close,
    bridged_params,
    grads_tree,
)
from tpumon.loadgen import model as jax_model  # noqa: E402
from tpumon_torch.loadgen import model  # noqa: E402

CPU = torch.device("cpu")
# tests/test_loadgen.py's CFG (8 heads over 4 kv heads: tp 4 leaves one kv
# head a shard), f32 unless a case says otherwise.
CFG = dict(vocab=128, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
           d_ff=128, max_seq=256, compute_dtype="float32")
# tests/test_moe.py's TestMoEModelFamily.MOE.
MOE = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=128, max_seq=64, compute_dtype="float32", n_experts=4)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def tokens_np(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def jax_mesh(dp, tp):
    return JaxMesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                   ("data", "model"))


def port_mesh(dp, tp):
    return model.Mesh([[CPU] * tp] * dp, ("data", "model"))


def reference_step(cfg, tree, toks, dp, tp):
    """The reference's sharded step: (loss, updated params as numpy)."""
    mesh = jax_mesh(dp, tp)
    step, placed = jax_model.make_sharded_train_step(cfg, mesh, tree)
    new, loss = step(placed, jax.device_put(
        jnp.asarray(toks), NamedSharding(mesh, P("data", None))))
    return float(loss), jax.tree.map(np.asarray, new)


def reference_grads(cfg, tree, toks):
    """The reference's single-device (loss, gradient tree)."""
    loss, grads = jax.value_and_grad(
        lambda p: jax_model.loss_fn(cfg, p, jnp.asarray(toks)))(tree)
    return float(loss), jax.tree.map(np.asarray, grads)


def assert_grads_close(want, got):
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(want))
    assert_trees_close(want, got, rtol=0, atol=GRAD_TOL * scale)


def check_step(cfg_kw, dp, tp, shape, seed=0):
    jcfg = jax_model.ModelConfig(**cfg_kw)
    jp, tree = bridged_params(jcfg, seed=seed)
    toks = tokens_np(shape, cfg_kw["vocab"])
    want_loss, want_grads = reference_grads(jcfg, jp, toks)
    mesh = port_mesh(dp, tp)
    step, placed = model.make_sharded_train_step(
        model.ModelConfig(**cfg_kw), mesh, model.params_from_jax(tree))
    tokens = torch.from_numpy(toks)
    loss, grads = model.mesh_value_and_grad(
        mesh, placed, step.specs, lambda v: model.mesh_loss(
            model.ModelConfig(**cfg_kw), v, mesh, tokens[:, :-1],
            tokens[:, 1:]))
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert_grads_close(want_grads, model.unshard_params(
        mesh, [grads_tree(p, g) for p, g in zip(placed, grads)],
        step.specs))
    placed, loss1 = step(placed, tokens)
    assert float(loss1) == float(loss)
    ref_loss, ref_new = reference_step(jcfg, jp, toks, dp, tp)
    assert abs(ref_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert_trees_close(ref_new, model.unshard_params(mesh, placed),
                       rtol=2e-4, atol=2e-6)
    return mesh, placed


@pytest.mark.parametrize("dp,tp,attention", [
    (2, 4, "naive"), (2, 4, "flash"), (1, 2, "naive"), (4, 1, "naive"),
    (2, 2, "chunked")])
def test_sharded_step_matches_reference(dp, tp, attention):
    """tests/test_loadgen.py's dp 2 x tp 4 step (and other layouts): loss
    and gradients the reference's, updated params its sharded step's. The
    flash case is test_flash_schedule_under_dp_tp_mesh's (T 128: 129
    tokens, block 32)."""
    cfg = dict(CFG, attention=attention, attn_block_k=32)
    mesh, placed = check_step(cfg, dp, tp, (4, 129 if attention == "flash"
                                            else 33))
    # Every data row's copy of a block is the same after the update.
    for i in range(len(placed)):
        twin = mesh.index(model=mesh.coords(i)["model"])
        for a, b in zip(model.param_leaves(placed[i]),
                        model.param_leaves(placed[twin])):
            assert torch.equal(a, b)


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


@pytest.mark.parametrize("cfg_kw,dp,tp", [
    (CFG, 2, 2), (dict(CFG, attention="flash", attn_block_k=32), 2, 4),
    (MOE, 2, 2)], ids=["naive", "flash", "moe"])
def test_remat_on_the_mesh_matches_reference(cfg_kw, dp, tp):
    """cfg.remat over a dp x tp mesh: the loss and gradients are the
    reference's remat ones, and the forward keeps under a fifth of the
    plain run's bytes for the backward (each layer is recomputed)."""
    jcfg = jax_model.ModelConfig(**dict(cfg_kw, remat=True))
    jp, tree = bridged_params(jcfg)
    toks = tokens_np((4, 129 if cfg_kw.get("attention") == "flash"
                      else 17), cfg_kw["vocab"])
    want_loss, want_grads = reference_grads(jcfg, jp, toks)
    tokens = torch.from_numpy(toks)
    mesh = port_mesh(dp, tp)
    kept = {}
    for remat in (False, True):
        cfg = model.ModelConfig(**dict(cfg_kw, remat=remat))
        step, placed = model.make_sharded_train_step(
            cfg, mesh, model.params_from_jax(tree))
        (loss, grads), kept[remat] = saved_bytes(
            lambda: model.mesh_value_and_grad(
                mesh, placed, step.specs, lambda v: model.mesh_loss(
                    cfg, v, mesh, tokens[:, :-1], tokens[:, 1:])))
        assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
        assert_grads_close(want_grads, model.unshard_params(
            mesh, [grads_tree(p, g) for p, g in zip(placed, grads)],
            step.specs))
    assert kept[True] < kept[False] / 5, kept


def test_visible_devices_takes_an_indexed_device(monkeypatch):
    """No device, or "cuda", spreads over every card torch sees; an
    indexed one ("cuda:1") is that card alone; a CPU is itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    every = [torch.device("cuda", i) for i in range(3)]
    assert model.visible_devices() == every
    assert model.visible_devices("cuda") == every
    assert model.visible_devices("cuda:1") == [torch.device("cuda:1")]
    assert model.visible_devices("cpu") == [CPU]


def test_wq_keeps_its_model_split():
    """tests/test_loadgen.py::test_sharded_train_step_8dev: the loss is
    finite and wq stays split over "model" after the update."""
    jp, tree = bridged_params(jax_model.ModelConfig(**CFG))
    mesh = port_mesh(2, 4)
    step, placed = model.make_sharded_train_step(
        model.ModelConfig(**CFG), mesh, model.params_from_jax(tree))
    new, loss = step(placed, torch.from_numpy(tokens_np((4, 32), 128)))
    assert np.isfinite(float(loss))
    assert model.param_shardings(mesh, new[0])["layers"][0]["wq"] == (
        None, "model")
    for i, shard in enumerate(new):
        r = mesh.coords(i)["model"]
        assert shard["layers"][0]["wq"].shape == (64, 16)
        assert torch.equal(shard["layers"][0]["wq"],
                           model.unshard_params(mesh, new)["layers"][0][
                               "wq"][:, r * 16:(r + 1) * 16])


def test_bf16_sharded_loss_matches_reference():
    """tests/test_loadgen.py::test_sharded_matches_single_device in the
    reference's default bf16: the port's sharded loss against the
    reference's sharded loss."""
    cfg = dict(CFG, compute_dtype="bfloat16")
    jcfg = jax_model.ModelConfig(**cfg)
    jp, tree = bridged_params(jcfg)
    toks = tokens_np((4, 32), 128)
    want, _ = reference_step(jcfg, jp, toks, 2, 4)
    step, placed = model.make_sharded_train_step(
        model.ModelConfig(**cfg), port_mesh(2, 4),
        model.params_from_jax(tree))
    _, loss = step(placed, torch.from_numpy(toks))
    assert abs(float(loss) - want) <= 2e-2 * abs(want)


def test_moe_trains_through_the_sharded_step():
    """tests/test_moe.py::test_dp_tp_train_step_matches_single_device:
    the MoE family over dp 2 x tp 4 (one expert a shard; the whole batch
    routed at once, capacity from its token count, so tokens drop as they
    do on one device)."""
    check_step(MOE, 2, 4, (4, 33))


def test_moe_experts_must_divide_the_model_axis():
    jp, tree = bridged_params(jax_model.ModelConfig(**MOE))
    with pytest.raises(ValueError, match="divisible"):
        model.make_sharded_train_step(
            model.ModelConfig(**dict(MOE, n_experts=3)),
            port_mesh(1, 2), model.params_from_jax(tree))


def test_run_train_over_a_mesh_matches_one_device():
    """run_train's "auto" mode over a dp 2 x tp 2 mesh (the reference's
    mesh branch) lands on the same loss as one device, and its default
    mesh is the reference's (tp the first of 4, 8, 2 that divides)."""
    from tpumon_torch.loadgen import train

    cfg = train.TrainConfig(model=model.ModelConfig(**CFG), steps=2,
                            batch=4, seq=17)
    one = train.run_train(cfg, "cpu")
    out = train.run_train(cfg, mesh=port_mesh(2, 2))
    assert out["mesh"] == {"data": 2, "model": 2}
    assert abs(out["loss"] - one["loss"]) <= LOSS_RTOL * one["loss"]
    assert train._default_mesh([CPU]).__class__ is type(None)
    assert train._default_mesh([CPU] * 8).shape == {"data": 2, "model": 4}
    assert train._default_mesh([CPU] * 6).shape == {"data": 3, "model": 2}
    auto = train.run_train(cfg, devices=[CPU] * 4)
    assert auto["mesh"] == {"data": 1, "model": 4}
    assert abs(auto["loss"] - one["loss"]) <= LOSS_RTOL * one["loss"]


def test_shard_params_places_any_spec_and_keeps_quantized_types():
    """shard_params over any named axes: blocks by coordinate, each its own
    allocation, the router kept f32, a quantized weight's int8 codes and
    f32 scales kept in their types under a bf16 cast; unshard_params puts
    the blocks back."""
    from tpumon_torch.loadgen.quant import QTensor

    gen = torch.Generator().manual_seed(0)
    params = {"wq": QTensor(q=torch.randint(-8, 8, (4, 8), generator=gen,
                                            dtype=torch.int8),
                            scale=torch.rand(8, generator=gen)),
              "w_up": torch.randn(4, 8, generator=gen),
              "router": torch.randn(4, 2, generator=gen)}
    mesh = port_mesh(2, 2)
    placed = model.shard_params(mesh, params, torch.bfloat16)
    for i, shard in enumerate(placed):
        r = mesh.coords(i)["model"]
        assert shard["wq"].q.dtype == torch.int8
        assert shard["wq"].scale.dtype == torch.float32
        assert torch.equal(shard["wq"].scale, params["wq"].scale[r * 4:
                                                                (r + 1) * 4])
        assert shard["w_up"].dtype == torch.bfloat16
        assert shard["router"].dtype == torch.float32
    assert placed[0]["w_up"].data_ptr() != placed[2]["w_up"].data_ptr()
    stacked = {"s": torch.arange(24.0).reshape(2, 3, 4)}
    pipe = model.Mesh([[CPU] * 2] * 2, ("data", "pipe"))
    specs = {"s": ("pipe", None, None)}
    blocks = model.shard_params(pipe, stacked, specs=specs)
    assert blocks[3]["s"].shape == (1, 3, 4)
    assert torch.equal(model.unshard_params(pipe, blocks, specs)["s"],
                       stacked["s"])
