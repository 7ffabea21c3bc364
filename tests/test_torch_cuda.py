"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip elsewhere (the kernels have no
CPU mode). They import no JAX, so they run on a GPU host as they are:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances (max abs vs the plain version on the same inputs): f32 1e-4
(summation order), bf16 3e-2 (the reference test's own; the plain
version rounds scores and probabilities to bf16, the kernel keeps f32).
"""

import pytest

torch = pytest.importorskip("torch")

# By bare name, not as ``tests.torch_parity``: a GPU host's site-packages
# may hold a ``tests`` package of its own, which shadows this directory.
from torch_parity import paged_case, to_torch  # noqa: E402
from tpumon_torch.ops.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape", [
    {"nh": 8, "nkv": 2, "hd": 128, "page_size": 16,
     "lengths": (0, 1, 15, 16, 17, 64)},
    {"nh": 4, "nkv": 4, "hd": 64, "page_size": 40,
     "lengths": (160, 39, 41, 0, 1, 100)},
    {"nh": 8, "nkv": 1, "hd": 32, "page_size": 8,
     "lengths": (32, 31, 9, 8, 7, 2)},
])
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype, atol):
    case = paged_case(b=6, num_pages=40, max_pages=4, seed=5, **shape)
    args = [t.to(cuda_device) for t in to_torch(case, dtype)]
    before = paged_attention.launches
    out = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    zero = [i for i, n in enumerate(shape["lengths"]) if n == 0]
    assert torch.equal(out[zero].float(), torch.zeros_like(out[zero].float()))


def test_kernel_rejects_unsupported_sizes_on_card(cuda_device):
    case = paged_case(nh=4, nkv=2, hd=16)
    args = [t.to(cuda_device) for t in to_torch(case)]
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(*args)


def test_kernel_reads_a_parked_slots_repeated_trash_page(cuda_device):
    """The engine parks free and mid-prefill slots at the last row with a
    table of trash page 0: the kernel walks every page, all of them page
    0, without fault, and still agrees with the plain version."""
    case = list(paged_case(b=3, nh=16, nkv=2, hd=128, num_pages=9,
                           page_size=16, max_pages=4, lengths=(64, 5, 33),
                           seed=9))
    case[3][0] = 0  # slot 0: parked — all-trash table at full length
    args = [t.to(cuda_device) for t in to_torch(case, torch.bfloat16)]
    out = paged_attention(*args)  # group 8, the kernel's largest
    torch.cuda.synchronize()
    ref = paged_attention_reference(*args)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=0)
