"""The port's pipeline parallelism against the JAX reference.

``tests/test_pipeline.py``'s cases through both packages on bridged
weights and numpy-made tokens: the reference's ``pipeline_forward`` and
``pipeline_loss`` on its conftest's CPU devices, the port's on
``[cpu] * n`` over a ("data", "pipe") mesh (one controller; each
microbatch's activation is handed to the next stage's device by
``.to()``). Logits, loss and the stacked gradients must be the
reference's and the sequential model's; the train step descends.

Tolerances: f32 logits 2e-5 and loss 1e-5 relative (microbatches change
execution order, not math); gradients 1e-4 of the largest gradient;
updated params rtol 2e-4 / atol 2e-6.
"""

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
from tpumon.loadgen import pipeline as jpl  # noqa: E402
from tpumon_torch.loadgen import model, pipeline  # noqa: E402

CPU = torch.device("cpu")
# tests/test_pipeline.py's MCFG.
MCFG = dict(vocab=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq=16, compute_dtype="float32")
GRAD_TOL = 1e-4


def tokens_np(b, t=12, seed=1):
    return np.random.default_rng(seed).integers(
        0, MCFG["vocab"], (b, t)).astype(np.int32)


def meshes(dp, pp):
    return (JaxMesh(np.array(jax.devices()[:dp * pp]).reshape(dp, pp),
                    ("data", "pipe")),
            model.Mesh([[CPU] * pp] * dp, ("data", "pipe")))


def configs(pp, m):
    return (jpl.PipelineConfig(model=jax_model.ModelConfig(**MCFG),
                               n_stages=pp, n_microbatches=m),
            pipeline.PipelineConfig(model=model.ModelConfig(**MCFG),
                                    n_stages=pp, n_microbatches=m))


@pytest.mark.parametrize("pp,m,dp", [(4, 4, 1), (2, 6, 1), (4, 8, 1),
                                     (2, 4, 2)])
def test_forward_matches_reference(pp, m, dp):
    jcfg, cfg = configs(pp, m)
    jmesh, mesh = meshes(dp, pp)
    jp, tree = bridged_params(jcfg.model, seed=0)
    toks = tokens_np(m * 2)
    seq = jax_model.forward(jcfg.model, jp, jnp.asarray(toks))
    ref = jpl.pipeline_forward(jcfg, jpl.stack_pipeline_params(jcfg, jp),
                               jnp.asarray(toks), jmesh)
    got = pipeline.pipeline_forward(
        cfg, pipeline.stack_pipeline_params(cfg, model.params_from_jax(tree)),
        torch.from_numpy(toks), mesh)
    for want in (seq, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_grads_match_reference():
    """tests/test_pipeline.py::test_grads_match_sequential_model: the
    pipeline's stacked gradients are the sequential model's, leaf for
    leaf, and the loss the reference pipeline's."""
    jcfg, cfg = configs(4, 4)
    jmesh, mesh = meshes(1, 4)
    jp, tree = bridged_params(jcfg.model, seed=6)
    toks = tokens_np(8, seed=7)
    want_loss, seq_grads = jax.value_and_grad(lambda p: jax_model.loss_fn(
        jcfg.model, p, jnp.asarray(toks)))(jp)
    ref_loss = jpl.pipeline_loss(jcfg, jpl.stack_pipeline_params(jcfg, jp),
                                 jnp.asarray(toks), jmesh)
    stacked = pipeline.stack_pipeline_params(cfg, model.params_from_jax(tree))
    leaves = model.param_leaves(stacked)
    for x in leaves:
        x.requires_grad_(True)
    loss = pipeline.pipeline_loss(cfg, stacked, torch.from_numpy(toks), mesh)
    grads = torch.autograd.grad(loss, leaves)
    for w in (float(want_loss), float(ref_loss)):
        assert abs(loss.item() - w) <= 1e-5 * w
    want = jax.tree.map(np.asarray, jpl.stack_pipeline_params(
        jcfg, seq_grads))
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(want))
    assert_trees_close(want, grads_tree(stacked, grads), rtol=0,
                       atol=GRAD_TOL * scale)


def test_train_step_matches_single_device_grads():
    """tests/test_pipeline.py::test_train_step_matches_single_device_grads
    over dp 2 x pp 2: the loss is the sequential one, one step lands on a
    sequential SGD step's params, and a second step descends."""
    jcfg, cfg = configs(2, 4)
    _, mesh = meshes(2, 2)
    jp, tree = bridged_params(jcfg.model, seed=4)
    toks = tokens_np(8, seed=5)
    want_loss, seq_grads = jax.value_and_grad(lambda p: jax_model.loss_fn(
        jcfg.model, p, jnp.asarray(toks)))(jp)
    step, placed = pipeline.make_pipeline_train_step(
        cfg, mesh, pipeline.stack_pipeline_params(
            cfg, model.params_from_jax(tree)))
    new, loss = step(placed, torch.from_numpy(toks))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    sgd = jax.tree.map(np.asarray, jpl.stack_pipeline_params(
        jcfg, jax.tree.map(lambda p, g: p - 1e-3 * g, jp, seq_grads)))
    assert_trees_close(sgd, model.unshard_params(mesh, new, step.specs),
                       rtol=2e-4, atol=2e-6)
    # stage 1's devices hold layers 2-3, each its own allocation
    assert new[1]["stages"]["wq"].shape == (1, 2, 32, 32)
    assert new[1]["stages"]["wq"].data_ptr() != new[3]["stages"][
        "wq"].data_ptr()
    _, loss2 = step(new, torch.from_numpy(toks))
    assert float(loss2) < float(loss)


def test_bad_stage_count_rejected():
    _, cfg = configs(3, 4)
    with pytest.raises(AssertionError):
        cfg.check()
    _, cfg = configs(2, 4)
    with pytest.raises(ValueError, match="pipe"):
        pipeline.pipeline_forward(cfg, {}, torch.zeros(8, 4, dtype=torch.int32),
                                  model.Mesh([CPU] * 4, ("pipe",)))


def test_init_pipeline_params_shapes():
    _, cfg = configs(2, 4)
    params = pipeline.init_pipeline_params(
        cfg, torch.Generator().manual_seed(0))
    assert params["stages"]["w_down"].shape == (2, 2, 64, 32)
    assert params["embed"].shape == (128, 32)
