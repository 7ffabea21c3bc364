"""The port's bf16 tensor-parallel serving against the JAX reference.

The mesh parity tests run f32 (tests/test_torch_mesh_serving.py); the
reference computes in bf16 by default, and on a tp 2 mesh each shard's
row-parallel partial is a bf16 product before the sum. Here the
reference's ``MeshServingEngine`` at ``mesh_tp=2`` in bf16 runs on two of
its CPU devices and the port's on ``[cpu, cpu]``, on the reference's own
weights (bridged), and the two are held as the north star holds bf16:
the same greedy argmax at every position of one prefix, teacher-forced
(one request per prefix length, one new token each). The same holds for
the dense and paged layouts and, as a control, for 1x1.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.torch_parity import bridged_params  # noqa: E402
from tpumon.loadgen import serving as jax_serving  # noqa: E402
from tpumon.loadgen.model import ModelConfig as JaxModelConfig  # noqa: E402
from tpumon_torch.loadgen.model import ModelConfig, params_from_jax  # noqa: E402
from tpumon_torch.loadgen.serving import ServeConfig, make_serving_engine  # noqa: E402

# tests/test_torch_mesh_serving.py's MESH_MODEL in the reference's bf16.
MODEL = dict(vocab=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq=96, compute_dtype="bfloat16")
PREFIX = [(7 * i + 3) % 96 for i in range(40)]
SEED = 5


@pytest.fixture(scope="module")
def tree():
    return bridged_params(JaxModelConfig(**MODEL), seed=SEED)[1]


def teacher_forced(eng) -> list:
    """The greedy next token after every prefix of PREFIX."""
    reqs = [eng.submit(PREFIX[:i], max_new=1)
            for i in range(1, len(PREFIX) + 1)]
    eng.drain()
    assert all(r.done.is_set() for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("tp,layout", [(2, "dense"), (2, "paged"),
                                       (1, "dense")])
def test_bf16_argmax_matches_reference_teacher_forced(tree, tp, layout):
    want = teacher_forced(jax_serving.make_serving_engine(
        jax_serving.ServeConfig(model=JaxModelConfig(**MODEL), slots=2,
                                prefill_len=8, mesh_tp=tp, kv_layout=layout),
        seed=SEED, devices=jax.devices()[:tp]))
    got = teacher_forced(make_serving_engine(
        ServeConfig(model=ModelConfig(**MODEL), slots=2, prefill_len=8,
                    mesh_tp=tp, kv_layout=layout),
        params=params_from_jax(tree), seed=SEED,
        devices=[torch.device("cpu")] * tp, device="cpu"))
    assert got == want
