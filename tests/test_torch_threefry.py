"""The fused Threefry draws (tpumon_torch/ops/threefry.py and
csrc/threefry.cu) against their plain versions (tpumon_torch/prng.py,
which tests/test_torch_prng.py holds to jax.random).

On the CPU the wrappers run the plain versions and launch nothing. The
kernel's own arithmetic is held to the plain versions bit for bit through
its device functions compiled for the host (tests/threefry_host.py), with
the wrappers' argument handling in front of them; on the card,
tests/test_torch_cuda.py holds the kernels themselves.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import threefry_host  # noqa: E402

from tpumon_torch import prng  # noqa: E402
from tpumon_torch.ops import threefry  # noqa: E402

SEEDS = (0, 1, 0x7A11, 2**31 + 5)


def _ids(k: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0, 5, -1, 2**31 - 1, 77], dtype=torch.int32,
                        device=k.device)


def _logits(k: torch.Tensor) -> torch.Tensor:
    """[5, 4096] logits from the key's second word, on its device."""
    rng = np.random.default_rng(int(k[1]) & 0xFFFF)
    x = rng.standard_normal((5, 4096))
    x[1, 100:200] = -1e30  # a top-k mask's rows
    return torch.from_numpy((x * 3).astype(np.float32)).to(k.device)


# name -> (call on a function and a key, the function's name, launches by
# launcher); every input on the key's device.
CASES = {
    "fold_in_int": (lambda m, k: m(k, 3), "fold_in", {"keys": 1}),
    "fold_in_wide_int": (lambda m, k: m(k, 2**40 + 7), "fold_in",
                         {"keys": 1}),
    "fold_in_int32_ids": (lambda m, k: m(k, _ids(k)), "fold_in", {"keys": 1}),
    "fold_in_int64_ids": (lambda m, k: m(k, _ids(k).long()), "fold_in",
                          {"keys": 1}),
    "fold_in_per_row": (lambda m, k: m(prng.torch_split(k, 5), _ids(k) * 3),
                        "fold_in", {"keys": 1}),
    "split": (lambda m, k: m(k, 7), "split", {"keys": 1}),
    "split_rows": (lambda m, k: m(prng.torch_split(k, 4), 3), "split",
                   {"keys": 1}),
    "bits_8": (lambda m, k: m(k, (3, 100), 8), "random_bits", {"draw": 1}),
    "bits_32_rows": (lambda m, k: m(prng.torch_split(k, 3), (2, 50)),
                     "random_bits", {"draw": 1}),
    "randint_int8": (lambda m, k: m(k, (64, 65), -127, 128, torch.int8),
                     "randint", {"keys": 1, "draw": 1}),
    "randint_wide_span": (lambda m, k: m(k, (64, 65), -5, 70000),
                          "randint", {"keys": 1, "draw": 1}),
    "randint_int32_bounds": (
        lambda m, k: m(k, (999,), -2**31, 2**31 - 1), "randint",
        {"keys": 1, "draw": 1}),
    "uniform_f32": (lambda m, k: m(k, (4, 999), torch.float32, -3.0, 5.5),
                    "uniform", {"draw": 1}),
    "uniform_bf16": (lambda m, k: m(k, (4, 999), torch.bfloat16),
                     "uniform", {"draw": 1}),
    "normal_f32": (lambda m, k: m(k, (256, 1024)), "normal", {"draw": 1}),
    "normal_bf16": (lambda m, k: m(k, (256, 1024), torch.bfloat16),
                    "normal", {"draw": 1}),
    "normal_bf16_rows": (
        lambda m, k: m(prng.torch_split(k, 4), (16, 32, 8), torch.bfloat16),
        "normal", {"draw": 1}),
    "gumbel": (lambda m, k: m(k, (1 << 16,)), "gumbel", {"draw": 1}),
    "categorical": (
        lambda m, k: m(prng.torch_split(k, 5), _logits(k)),
        "categorical", {"categorical": 1}),
    "categorical_one_key": (lambda m, k: m(k, _logits(k)),
                            "categorical", {"categorical": 1}),
    "permutation": (lambda m, k: m(k, 513), "permutation",
                    {"keys": 1, "draw": 1}),
}
PLAIN = {"fold_in": prng.torch_fold_in, "split": prng.torch_split,
          "random_bits": prng.torch_random_bits,
          "randint": prng.torch_randint, "uniform": prng.uniform,
          "normal": prng.normal, "gumbel": prng.gumbel,
          "categorical": prng.categorical,
          "permutation": prng.permutation}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    try:
        return threefry_host.build(tmp_path_factory.mktemp("threefry"))
    except RuntimeError as e:
        pytest.skip(f"the host copy of the kernel does not build: {e}")


def _counts() -> dict:
    return {name.removeprefix("threefry_"): n
            for name, n in threefry.launch_counts().items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_arithmetic_equals_plain_version(case, host_lib,
                                                monkeypatch):
    """The kernel's device functions, behind the wrappers: every element
    equal to the plain version's, each launcher counted once a launch."""
    threefry_host.patch(monkeypatch, host_lib)
    call, name, launches = CASES[case]
    for seed in SEEDS:
        k = prng.torch_key(seed, "cpu")
        before = _counts()
        got = call(getattr(threefry, name), k)
        after = _counts()
        want = call(PLAIN[name], k)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), f"{case} seed {seed}"
        assert {n: after[n] - before[n] for n in after} == {
            n: launches.get(n, 0) for n in after}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrappers_run_the_plain_versions_on_the_cpu(case):
    call, name, _ = CASES[case]
    k = prng.torch_key(7, "cpu")
    before = threefry.launch_counts()
    assert torch.equal(call(getattr(threefry, name), k),
                       call(PLAIN[name], k))
    assert threefry.launch_counts() == before


def _cu_floats(name: str) -> list[float]:
    """The F32(...) values of the constant named ``name`` in the kernel's
    source, rounded as the kernel rounds them (double, then float)."""
    src = threefry_host.SOURCE.read_text()
    m = (re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", src)
         or re.search(rf"{name} = (F32\([^)]*\))", src))
    vals = re.findall(r"F32\(([^)]*)\)", m.group(1))
    return [float(np.float32(float(v))) for v in vals]


def test_kernel_constants_are_the_plain_versions():
    """XLA's polynomial coefficients and cut-offs in the kernel are the
    plain version's, as are Threefry's rotations and parity word."""
    assert _cu_floats("kLogP") == prng._LOG_P
    assert _cu_floats("kLogQ1") == [prng._LOG_Q1]
    assert _cu_floats("kLogQ2") == [prng._LOG_Q2]
    assert _cu_floats("kSqrtHalf") == [prng._SQRT_HALF]
    assert _cu_floats("kLog1pNum") == prng._LOG1P_NUM
    assert _cu_floats("kLog1pDen") == prng._LOG1P_DEN
    assert _cu_floats("kLog1pSmall") == [prng._LOG1P_SMALL]
    assert _cu_floats("kErfInvLt5") == prng._ERFINV_LT5
    assert _cu_floats("kErfInvGe5") == prng._ERFINV_GE5
    src = threefry_host.SOURCE.read_text()
    rot = re.search(r"kRot\[2\]\[4\] = \{\{([^}]*)\}, \{([^}]*)\}\}", src)
    assert tuple(tuple(int(x) for x in g.split(",")) for g in rot.groups()
                 ) == prng._ROTATIONS
    assert int(re.search(r"kParity = (0x[0-9A-F]+)u", src).group(1),
               16) == int(prng._PARITY)


def test_wrappers_reject_malformed_keys_and_other_devices():
    with pytest.raises(ValueError, match="int64"):
        threefry.normal(torch.zeros(2, dtype=torch.int32), (4,))
    with pytest.raises(ValueError, match=r"\[\.\.\., 2\]"):
        threefry.split(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="cpu or cuda"):
        threefry.fold_in(torch.zeros(2, dtype=torch.int64, device="meta"),
                         1)
