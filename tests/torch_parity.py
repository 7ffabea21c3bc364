"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Every input is made once with numpy from a seed and handed to both
packages, so the JAX reference and ``tpumon_torch`` see identical bits.
JAX runs on the CPU (interpret mode for its Pallas kernels), torch on
the CPU, where every port kernel wrapper runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

# The suite runs in parallel worker processes: one intra-op thread keeps
# these tiny cases from crowding out other workers' timing-bound tests.
torch.set_num_threads(1)


def paged_case(b=3, nh=4, nkv=2, hd=16, num_pages=12, page_size=8,
               max_pages=4, lengths=(5, 17, 32), seed=0):
    """numpy inputs of one paged-attention call, the layout of
    tests/test_paged_attention.py::make_case: distinct pages per
    sequence from a seeded permutation; unused table entries hold page
    0. Returns (q, k_pages, v_pages, table, lengths) as f32/int32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nh, hd), np.float32)
    k_pages = rng.standard_normal((nkv, num_pages, page_size, hd), np.float32)
    v_pages = rng.standard_normal((nkv, num_pages, page_size, hd), np.float32)
    perm = iter(rng.permutation(num_pages))
    table = np.zeros((b, max_pages), np.int32)
    for i, n in enumerate(lengths):
        for j in range(-(-n // page_size)):
            table[i, j] = next(perm)
    return q, k_pages, v_pages, table, np.asarray(lengths, np.int32)


# The paged-attention card tests' cases (tests/test_torch_cuda.py): six
# sequences over a 40-page pool; the CPU tests check that the planted
# faults read over the card limits at these shapes.
PAGED_CARD_CASE = dict(b=6, num_pages=40, max_pages=4, seed=5)
PAGED_CARD_SHAPES = [
    {"nh": 8, "nkv": 2, "hd": 128, "page_size": 16,
     "lengths": (0, 1, 15, 16, 17, 64)},
    {"nh": 4, "nkv": 4, "hd": 64, "page_size": 40,
     "lengths": (160, 39, 41, 0, 1, 100)},
    {"nh": 8, "nkv": 1, "hd": 32, "page_size": 8,
     "lengths": (32, 31, 9, 8, 7, 2)},
]

# The split kernel's card cases (tests/test_torch_cuda.py), each a whole
# paged_case: tables long enough that the wrapper's pages_per_split gives
# several splits per sequence. The longest sequence spans 4 splits and
# ends in a partial page; a mixed batch whose live splits (5, 2, 3, 0, 1,
# 4) end at different points; a batch where all but one row have length
# 0. The CPU tests check that the split design's planted faults read over
# the card limits here.
PAGED_SPLIT_CARD_CASES = [
    dict(b=2, nh=8, nkv=2, hd=128, page_size=16, max_pages=64,
         num_pages=120, lengths=(1000, 700), seed=11),
    dict(b=6, nh=4, nkv=4, hd=64, page_size=40, max_pages=32, num_pages=90,
         lengths=(1280, 281, 561, 0, 1, 999), seed=12),
    dict(b=4, nh=8, nkv=1, hd=32, page_size=8, max_pages=128,
         num_pages=100, lengths=(0, 0, 777, 0), seed=13),
]


# The GEMM card tests' (M, K, N) (tests/test_torch_cuda.py), where the CPU
# tests check the planted GEMM faults against the card limits too.
GEMM_CARD_CASES = [(128, 64, 128), (256, 128, 256), (256, 256, 128),
                   (384, 512, 256),
                   # the persistent wgmma kernel's edges (128 x 256 tiles,
                   # 64-deep K stages): more tiles than an H100's 132 SMs
                   # with a partial last wave, N not a multiple of 256, K
                   # not of 64
                   (2176, 192, 2048), (256, 128, 384), (128, 96, 256)]


# The shapes the kernels take since they follow the reference's contracts
# (chip_smoke.py phase 26 defines them; tests/test_torch_head_dims.py holds
# the plain twins to the reference there, tests/test_torch_cuda.py the
# kernels to the plain twins on the card).
from chip_smoke import (  # noqa: E402
    FLASH_SHAPE_CASES,
    GEMM_EDGE_CASES,
    PAGED_GROUPS,
    PAGED_HEAD_DIMS,
    PAGED_PAGE_SIZES,
    paged_head_dim_shape,
)


# Above 256, where the kernels take the sliced route (chip_smoke.py phase
# 27): the paged kernel at groups 1 and 8, the flash kernels at T 64.
PAGED_WIDE_HEAD_DIMS = (300, 384, 512, 1024)
PAGED_WIDE_GROUPS = ((2, 2), (8, 1))
FLASH_WIDE_HEAD_DIMS = (320, 512, 1024)


def paged_head_dim_case(hd, nh, nkv, page_size, seed=17):
    """paged_case at one of phase 26's paged shapes (paged_head_dim_shape)
    over a 24-page pool."""
    shape = paged_head_dim_shape(hd, nh, nkv, page_size)
    return paged_case(b=shape["b"], nh=nh, nkv=nkv, hd=hd, num_pages=24,
                      page_size=page_size, max_pages=shape["max_pages"],
                      lengths=shape["lengths"], seed=seed + hd)


def to_jax(arrays, dtype=None):
    import jax.numpy as jnp

    out = [jnp.asarray(a) for a in arrays]
    if dtype is not None:
        out = [a.astype(dtype) if a.dtype == jnp.float32 else a for a in out]
    return out


def to_torch(arrays, dtype=None):
    out = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if dtype is not None:
        out = [t.to(dtype) if t.dtype == torch.float32 else t for t in out]
    return out


def jax_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def torch_f32(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def bridged_params(jax_cfg, seed=0):
    """(JAX params, the same weights as a numpy tree) for one JAX
    ModelConfig; ``tpumon_torch.loadgen.model.params_from_jax`` turns
    the numpy tree into the port's params."""
    import jax

    from tpumon.loadgen.model import init_params

    params = init_params(jax_cfg, jax.random.PRNGKey(seed))
    return params, jax.tree.map(np.asarray, params)


def assert_trees_close(jax_tree, torch_tree, rtol: float, atol: float,
                       path: str = "") -> None:
    """np.testing.assert_allclose over two param trees of one structure
    (dicts and lists): a JAX tree (arrays or numpy) against the port's
    tensors."""
    if isinstance(jax_tree, dict):
        assert set(jax_tree) == set(torch_tree), path
        for k in jax_tree:
            assert_trees_close(jax_tree[k], torch_tree[k], rtol, atol,
                               f"{path}/{k}")
    elif isinstance(jax_tree, (list, tuple)):
        assert len(jax_tree) == len(torch_tree), path
        for i, (a, b) in enumerate(zip(jax_tree, torch_tree)):
            assert_trees_close(a, b, rtol, atol, f"{path}/{i}")
    else:
        np.testing.assert_allclose(torch_f32(torch_tree), jax_f32(jax_tree),
                                   rtol=rtol, atol=atol, err_msg=path)


def grads_tree(params, grads):
    """The port's flat grads (``param_leaves`` order) as params' tree."""
    from tpumon_torch.loadgen.model import map_params

    it = iter(grads)
    return map_params(params, lambda _: next(it))
