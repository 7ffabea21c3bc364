"""The port's burns and slope-timed measurements against the reference.

The chained burn bodies run on the same numpy arrays through both
packages: the reference's body as burn.py writes it (its Pallas kernels
in interpret mode, or XLA's product), the port's through its plain
versions (every CPU tensor does). Two links at size 128, where the values
are still live (each link shrinks them by 128 / sqrt(128)). Tolerance:
normwise relative 1e-2; each link rounds to bf16 (2^-9 relative), and a
sum that lies near a rounding point may round the other way in one
package.

The burns' inputs are the reference's draws from PRNGKey(seed) and its
fold_ins, on seeds 0 and 1 at size 64: bf16 normals and int8 randint bit
for bit, the paged pool's permutation too, and the programs' sums as
close as their summation order allows.

``_guarded_slope`` runs in both packages under one fake clock, over the
four cases of tests/test_loadgen.py. The burns run at tiny sizes on the
CPU (``device="cpu"``), where only their control flow and result keys
mean anything.
"""

import dataclasses
from functools import partial
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.torch_parity import jax_f32, to_jax, to_torch, torch_f32  # noqa: E402
from tpumon.loadgen import burn as jax_burn  # noqa: E402
from tpumon_torch import prng  # noqa: E402
from tpumon_torch.loadgen import burn  # noqa: E402

SIZE = 128
BLOCKS = dict(block_m=128, block_n=128, block_k=128)


def rel_err(got, want) -> float:
    g, w = torch_f32(got), jax_f32(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def jax_chain(a, body, links: int):
    """burn.py's scan body, ``links`` times: c = body(a), renormalised by
    size in bf16."""
    for _ in range(links):
        c = body(a)
        a = (c / jnp.float32(SIZE).astype(jnp.bfloat16)).astype(jnp.bfloat16)
    return a


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mxu_chain_matches_reference_body(use_kernel):
    from tpumon.ops.matmul import matmul as jax_matmul
    from tpumon_torch.ops.matmul import matmul

    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((SIZE, SIZE), np.float32) for _ in range(2))
    ja, jb = to_jax((a, b), jnp.bfloat16)
    if use_kernel:
        want = jax_chain(ja, lambda x: jax_matmul(x, jb, interpret=True,
                                                  **BLOCKS), 2)
        mm = partial(matmul, **BLOCKS)
    else:
        want = jax_chain(ja, lambda x: x @ jb, 2)
        mm = torch.matmul
    got = burn._mxu_chain(*to_torch((a, b), torch.bfloat16), 2, mm)
    assert got.dtype == torch.bfloat16
    assert float(jnp.abs(want.astype(jnp.float32)).max()) > 1e-3  # live
    assert rel_err(got, want) <= 1e-2


@pytest.mark.parametrize("use_kernel", [True, False])
def test_int8_chain_matches_reference_body(use_kernel):
    from tpumon.ops.quant_matmul import quantized_matmul_pallas
    from tpumon_torch.ops.quant_matmul import quantized_matmul_kernel

    rng = np.random.default_rng(1)
    a = rng.standard_normal((SIZE, SIZE), np.float32)
    q = rng.integers(-127, 128, (SIZE, SIZE)).astype(np.int8)
    scale = np.full((SIZE,), 1.0 / 127.0, np.float32)
    (ja,) = to_jax((a,), jnp.bfloat16)
    jq, js = jnp.asarray(q), jnp.asarray(scale)
    if use_kernel:
        want = jax_chain(ja, lambda x: quantized_matmul_pallas(
            x, jq, js, interpret=True, **BLOCKS), 2)
        qmm = partial(quantized_matmul_kernel, **BLOCKS)
    else:
        want = jax_chain(ja, lambda x: x @ (
            jq.astype(jnp.bfloat16) * js.astype(jnp.bfloat16)), 2)
        qmm = burn._dequant_matmul
    got = burn._int8_chain(*to_torch((a,), torch.bfloat16),
                           torch.from_numpy(q), torch.from_numpy(scale), 2,
                           qmm)
    assert float(jnp.abs(want.astype(jnp.float32)).max()) > 1e-4  # live
    assert rel_err(got, want) <= 1e-2


class _FakeClock:
    """tests/test_loadgen.py's stand-in device: run(n) 'takes' overhead +
    n * per_iter seconds, with optional per-call noise, without
    sleeping."""

    def __init__(self, per_iter_s, overhead_s=0.05, noise=None):
        self.per_iter_s = per_iter_s
        self.overhead_s = overhead_s
        self.noise = list(noise or [])
        self.now = 0.0
        self.calls = []

    def run(self, n):
        self.calls.append(n)
        self.now += self.overhead_s + n * self.per_iter_s + (
            self.noise.pop(0) if self.noise else 0.0)


def guarded(module, clock_args, **kw):
    """(result or the exception's text, the iteration counts run) of one
    package's _guarded_slope under a fresh fake clock."""
    clock = _FakeClock(**clock_args)
    with mock.patch.object(module.time, "perf_counter", lambda: clock.now):
        try:
            out = module._guarded_slope(clock.run, **kw)
        except RuntimeError as e:
            out = str(e)
    return out, clock.calls


@pytest.mark.parametrize("clock_args,kw", [
    # clean: 10 ms/iter, marginal 96 iters = 0.96 s
    (dict(per_iter_s=0.01), dict(iters=32, units_per_iter=100.0,
                                 peak_per_sec=None)),
    # below the noise floor at n=16: must grow
    (dict(per_iter_s=0.001), dict(iters=16, units_per_iter=1.0,
                                  peak_per_sec=None)),
    # above the roofline every time: raises
    (dict(per_iter_s=0.01), dict(iters=32, units_per_iter=10.0,
                                 peak_per_sec=500.0)),
    # one noisy window above the roofline, then a clean retry
    (dict(per_iter_s=0.01, noise=[0.0, 0.0, -0.4, 0.0]),
     dict(iters=32, units_per_iter=100.0, peak_per_sec=12_000.0, reps=1)),
], ids=["clean", "grows_past_noise_floor", "rejects_above_roofline",
        "roofline_retry_recovers"])
def test_guarded_slope_matches_reference(clock_args, kw):
    kw = {"what": "t", "reps": 2, **kw}
    want = guarded(jax_burn, clock_args, **kw)
    got = guarded(burn, clock_args, **kw)
    assert got[1] == want[1]  # the same runs, in the same order
    if isinstance(want[0], str):
        assert "roofline" in want[0] and "roofline" in got[0]
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    assert burn.MIN_MARGINAL_S == jax_burn.MIN_MARGINAL_S


def test_device_rooflines_keys_on_the_cpu():
    peaks = burn.device_rooflines("cpu")
    assert set(peaks) == set(jax_burn.device_rooflines())
    assert all(v is None for v in peaks.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            burn.device_rooflines()


def test_peak_table_has_int8_column():
    from tpumon_torch.loadgen.train import card_peaks

    h100 = card_peaks("NVIDIA H100 80GB HBM3")
    assert (h100.bf16, h100.int8, h100.hbm) == (989e12, 1979e12, 3.35e12)


def test_burn_result_keys_at_tiny_sizes():
    """The reference's result keys, ``pallas`` read as ``kernel``."""
    out = burn.mxu_burn(seconds=0.02, size=128, iters=2, device="cpu")
    assert set(out) == {"calls", "seconds", "kernel", "tflops"}
    assert out["kernel"] is False and out["tflops"] > 0
    out = burn.int8_burn(seconds=0.02, size=128, iters=2, device="cpu")
    assert set(out) == {"calls", "seconds", "kernel", "tflops", "weight_gbps"}
    assert out["kernel"] is False and out["weight_gbps"] > 0
    out = burn.paged_burn(seconds=0.02, batch=2, n_heads=4, n_kv_heads=2,
                          head_dim=16, page_size=8, context=32, device="cpu")
    assert set(out) == {"calls", "seconds", "kernel", "decode_steps_per_sec",
                        "kv_gbps"}
    assert out["kernel"] is False and out["kv_gbps"] > 0
    with pytest.raises(ValueError, match="multiple of page_size"):
        burn.paged_burn(seconds=0.0, context=30, page_size=8, device="cpu")
    from tpumon_torch.loadgen.model import Mesh

    out = burn.ici_burn(Mesh([torch.device("cpu")] * 4, ("ring",)),
                        mb_per_shift=1, iters=4)
    assert set(out) == {"devices", "bytes_shifted", "seconds", "gbps"}
    assert out["devices"] == 4 and out["gbps"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            burn.mxu_burn(seconds=0.0, size=128, iters=1)


def test_burn_programs_launch_nothing_on_the_cpu():
    from tpumon_torch.ops.matmul import matmul
    from tpumon_torch.ops.quant_matmul import quantized_matmul_kernel

    before = (matmul.launches, quantized_matmul_kernel.launches)
    # The kernel paths at a size the default blocks admit, one link each.
    for prog in (burn._mxu_burn_program, burn._int8_burn_program):
        assert np.isfinite(burn._sync(prog(prng.torch_key(0, "cpu"), 1024,
                                           1, use_kernel=True)))
    assert (matmul.launches, quantized_matmul_kernel.launches) == before


def test_measure_paged_engine_step_both_paths():
    """tests/test_loadgen.py's shape on both read paths, with a short
    noise floor (the CPU step is not what is measured here)."""
    from tpumon_torch.loadgen.model import ModelConfig
    from tpumon_torch.loadgen.serving import ServeConfig

    cfg = ServeConfig(
        model=ModelConfig(vocab=128, d_model=64, n_layers=2, n_heads=8,
                          n_kv_heads=4, d_ff=128, max_seq=64,
                          compute_dtype="float32"),
        slots=2, prefill_len=8, kv_layout="paged")
    short = partial(burn._guarded_slope, min_marginal_s=0.01)
    with mock.patch.object(burn, "_guarded_slope", short):
        for pa in ("gather", "kernel"):
            out = burn.measure_paged_engine_step_ms(
                dataclasses.replace(cfg, paged_attn=pa), inner_steps=4,
                reps=1, device="cpu")
            assert set(out) == {"ms_per_step", "kv_gbps_floor", "paged_attn",
                                "marginal_s"}
            assert out["ms_per_step"] > 0 and out["kv_gbps_floor"] > 0
            assert out["paged_attn"] == pa


def test_hbm_fill_matches_reference_chunks():
    hbm = 2**27 + 2**21  # a 64 MB chunk and a short one at fraction 1/2
    want = jax_burn.hbm_fill(0.5, hbm_bytes=hbm)
    got = burn.hbm_fill(0.5, hbm_bytes=hbm, device="cpu")
    assert [t.shape[0] for t in got] == [a.shape[0] for a in want] == [
        2**24, 2**18]
    assert [float(t[0]) for t in got] == [float(a[0]) for a in want]
    assert all(t.dtype == torch.float32 for t in got)
    with pytest.raises(ValueError, match="hbm_bytes"):
        burn.hbm_fill(0.5, device="cpu")


def _bf16_equal(got: torch.Tensor, want) -> bool:
    return np.array_equal(torch_f32(got), jax_f32(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_mxu_and_int8_inputs_are_the_references_draws(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.torch_key(seed, "cpu")
    a, b = burn._mxu_inputs(tkey, 64)
    assert a.dtype == b.dtype == torch.bfloat16
    assert _bf16_equal(a, jax.random.normal(key, (64, 64), jnp.bfloat16))
    assert _bf16_equal(b, jax.random.normal(jax.random.fold_in(key, 1),
                                            (64, 64), jnp.bfloat16))
    a, q, scale = burn._int8_inputs(tkey, 64)
    assert _bf16_equal(a, jax.random.normal(key, (64, 64), jnp.bfloat16))
    want_q = jax.random.randint(jax.random.fold_in(key, 1), (64, 64), -127,
                                128, jnp.int8)
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(want_q))
    assert torch.equal(scale, torch.full((64,), 1.0 / 127.0))


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_pool_and_steps_are_the_references_draws(seed):
    """The pool (normals), its table (permutation) and the measured
    program's queries (split(fold_in(key, 3), steps)): the reference's
    program and the port's sum the same attention outputs."""
    key, tkey = jax.random.PRNGKey(seed), prng.torch_key(seed, "cpu")
    shape = dict(batch=2, n_kv_heads=2, head_dim=16, page_size=8, context=32)
    k_pages, v_pages, table, lengths = burn._paged_pool(tkey, **shape)
    assert _bf16_equal(k_pages, jax.random.normal(
        key, (2, 8, 8, 16), jnp.bfloat16))
    assert _bf16_equal(v_pages, jax.random.normal(
        jax.random.fold_in(key, 1), (2, 8, 8, 16), jnp.bfloat16))
    assert np.array_equal(table.numpy(), np.asarray(jax.random.permutation(
        jax.random.fold_in(key, 2), 8)).reshape(2, 4))
    assert lengths.tolist() == [32, 32]
    args = (2, 4, 2, 16, 8, 32, 3)
    want = float(jax_burn._paged_measure_program(key, *args, False))
    got = burn._sync(burn._paged_measure_program(tkey, *args, False))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_burn_key_chains_are_the_references(seed):
    """A burn's call i draws under fold_in(PRNGKey(seed), i) (paged:
    3 + i, its bursts' steps split into 8): the keys the calls see."""
    key, tkey = jax.random.PRNGKey(seed), prng.torch_key(seed, "cpu")
    for i in (0, 1, 5):
        assert np.array_equal(prng.torch_fold_in(tkey, i).numpy(),
                              np.asarray(jax.random.fold_in(key, i)))
    assert np.array_equal(
        prng.torch_split(prng.torch_fold_in(tkey, 3), 8).numpy(),
        np.asarray(jax.random.split(jax.random.fold_in(key, 3), 8)))
    seen = []
    real = burn._mxu_burn_program

    def spy(k, *a, **kw):
        seen.append(k.clone())
        return real(k, *a, **kw)

    with mock.patch.object(burn, "_mxu_burn_program", spy):
        burn.mxu_burn(seconds=0.01, size=64, iters=1, seed=seed,
                      device="cpu")
    assert len(seen) >= 2
    assert np.array_equal(seen[0].numpy(), np.asarray(key))  # warm-up
    for i, k in enumerate(seen[1:]):
        assert np.array_equal(k.numpy(),
                              np.asarray(jax.random.fold_in(key, i)))


def test_burn_module_draws_no_torch_generator():
    import inspect

    src = inspect.getsource(burn)
    assert "zlib" not in src and "randn(" not in src


@pytest.mark.parametrize("n,mb,iters", [(4, 1, 4), (2, 2, 3), (8, 1, 1)])
def test_ici_burn_counts_as_the_reference(n, mb, iters):
    """tests/test_loadgen.py::test_ici_burn_on_cpu_mesh through both
    packages: the same devices and bytes_shifted (n x block x iters), and
    after the rotation each device holds the block that started iters
    places before it on the ring."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from tpumon.loadgen import burn as jax_burn
    from tpumon_torch.loadgen.model import Mesh

    want = jax_burn.ici_burn(JaxMesh(np.array(jax.devices()[:n]), ("ring",)),
                             mb_per_shift=mb, iters=iters)
    got = burn.ici_burn(Mesh([torch.device("cpu")] * n, ("ring",)),
                        mb_per_shift=mb, iters=iters)
    assert got["devices"] == want["devices"] == n
    assert got["bytes_shifted"] == want["bytes_shifted"] == (
        n * mb * 2**20 * iters)
    assert got["gbps"] > 0 and got["seconds"] > 0
