"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of ``tpumon/ops/flash_attention.py``: its triangle-grid pair,
the training schedule's attention (``loadgen.model`` ``attention=
"flash"``), and its rectangular forward. q/k/v are ``[BH, T, D]`` (batch
and heads folded), with the reference's scale ``1/sqrt(D)``:

- ``flash_attention`` is the rectangular forward, causal or not
  (``csrc/flash_attention.cu``): out in q's dtype. It lies on no path of
  the reference package but its own tests.

- ``flash_attention_tri_fwd`` returns ``(out, lse)``: out in q's dtype and
  the per-row logsumexp of the scaled scores in f32, the residual the
  backward rebuilds P from. ``flash_attention_tri`` is its forward-only
  view.
- ``flash_attention_tri_bwd`` returns ``(dq, dk, dv)``. It computes
  ``D = rowsum(dO * O)`` once in plain torch and runs two passes:
  ``flash_attention_tri_bwd_dq`` and ``flash_attention_tri_bwd_dkv``.

Each of the four kernel wrappers launches its CUDA kernel (``csrc/
flash_attention.cu``, ``csrc/flash_attention_tri_fwd.cu``, ``csrc/
flash_attention_tri_bwd.cu``) on CUDA tensors and counts the launch in its ``launches`` attribute; on CPU
tensors it runs its plain version (``*_reference``); any other device
raises. The plain versions mirror the reference kernels' numerics: f32
scores and softmax, masked scores at -1e30, and the rounding of P and dS
to the input dtype right before their products.
"""

from __future__ import annotations

import ctypes

import torch

from tpumon_torch.ops import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_TILE = 64  # the kernels need T % 64 == 0 (bf16 forward: 128-row tiles)
# The plain versions materialise [chunk, T, T] f32 tensors; chunking the
# folded batch keeps each near 1 GiB at long T.
_PLAIN_CHUNK_ELEMS = 1 << 28


def _check(q, k, v, block: int, *more, block_k: int | None = None) -> None:
    """Reject what neither version computes; raises ValueError."""
    if q.dim() != 3:
        raise ValueError(f"q must be [BH, T, D]; got {tuple(q.shape)}")
    bh, t, d = q.shape
    for x in (k, v, *more):
        if x.shape != q.shape:
            raise ValueError(
                f"q/k/v (and out/dout) must share one [BH, T, D] shape; got "
                f"{tuple(q.shape)} and {tuple(x.shape)}")
        if x.dtype != q.dtype:
            raise ValueError(f"mixed dtypes {q.dtype} and {x.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q/k/v must be float32 or bfloat16, not {q.dtype}")
    for b in (block, block if block_k is None else block_k):
        if b < 1 or t % b:
            raise ValueError(f"T={t} must be a multiple of block={b}")
    if len({x.device for x in (q, k, v, *more)}) != 1:
        raise ValueError("flash attention's tensors must share one device")


def _on_cuda(*tensors) -> bool:
    """False for CPU tensors (the plain versions run); True for CUDA
    tensors the kernels take; raises for anything else."""
    q = tensors[0]
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    _, t, d = q.shape
    if d not in KERNEL_HEAD_DIMS or t % KERNEL_TILE:
        raise ValueError(
            f"the CUDA kernels take head_dim in {KERNEL_HEAD_DIMS} and T a "
            f"multiple of {KERNEL_TILE}; got head_dim={d}, T={t}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the CUDA kernels take contiguous tensors only")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("the CUDA kernels need 16-byte aligned tensors")
    return True


def _kernel(source: str, symbol: str, n_ptr: int, n_int: int):
    """The built library and one launcher of it, with its C signature:
    ``n_ptr`` pointers, ``n_int`` ints (bh, t, head dim, dtype, then any
    flags), scale, stream."""
    lib = _build.load(source)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        i32 = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [i32] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = i32
    return lib, fn


def _launch(source: str, symbol: str, tensors, q, *flags: int) -> None:
    bh, t, d = q.shape
    lib, fn = _kernel(source, symbol, len(tensors), 4 + len(flags))
    with torch.cuda.device(q.device):
        err = fn(*(x.data_ptr() for x in tensors), bh, t, d, _DTYPES[q.dtype],
                 *flags, 1.0 / d**0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, f"{symbol} launch")


def _chunks(bh: int, t: int):
    step = max(1, _PLAIN_CHUNK_ELEMS // (t * t))
    return [slice(i, min(bh, i + step)) for i in range(0, bh, step)]


def _causal(t: int, device) -> torch.Tensor:
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


def _plain_fwd(q, k, v, causal: bool):
    """(out, lse) of softmax attention, as one online-softmax block per
    row: f32 scores, P = exp(s - rowmax) rounded to v's dtype before P V,
    divided by the unrounded row sum; lse = rowmax + log(row sum)."""
    bh, t, d = q.shape
    scale = 1.0 / d**0.5
    mask = _causal(t, q.device) if causal else None
    out = torch.empty_like(q)
    lse = torch.empty(bh, t, dtype=torch.float32, device=q.device)
    for c in _chunks(bh, t):
        s = torch.matmul(q[c].float(), k[c].float().transpose(1, 2)) * scale
        if mask is not None:
            s = torch.where(mask, s, _NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        el = p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), v[c].float()) / el
        out[c] = o.to(q.dtype)
        lse[c] = (m + torch.log(el))[..., 0]
    return out, lse


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              causal: bool = True) -> torch.Tensor:
    """Plain version of the rectangular forward kernel."""
    return _plain_fwd(q, k, v, causal)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Flash attention forward, causal or not: [BH, T, D] -> [BH, T, D]
    in q's dtype, T a multiple of block_q and of block_k (the reference's
    block grid). On a CUDA tensor the kernel tiles T itself (bf16: 128-row
    tiles, f32: 64), so the blocks only set the contract, as in the
    reference.
    """
    _check(q, k, v, block_q, block_k=block_k)
    if not _on_cuda(q, k, v):
        return flash_attention_reference(q, k, v, causal)
    out = torch.empty_like(q)
    _launch("flash_attention", "tpumon_flash_fwd", (q, k, v, out), q,
            int(bool(causal)))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_tri_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor):
    """Plain version of the triangle forward kernel: (out, lse) of causal
    softmax attention (``_plain_fwd``)."""
    return _plain_fwd(q, k, v, True)


def flash_attention_tri_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            block: int = 128):
    """Causal flash forward returning ``(out, lse)``.

    q/k/v: [BH, T, D] with T % block == 0 (callers pad T; the reference
    kernel's block grid). out: [BH, T, D] in q's dtype; lse: [BH, T] f32.
    On a CUDA tensor the kernel tiles T itself (bf16: 128-row tiles, f32:
    64), so ``block`` only sets the padding contract, as in the reference.
    """
    _check(q, k, v, block)
    if not _on_cuda(q, k, v):
        return flash_attention_tri_fwd_reference(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_attention_tri_fwd", "tpumon_flash_tri_fwd",
            (q, k, v, out, lse), q)
    flash_attention_tri_fwd.launches += 1
    return out, lse


flash_attention_tri_fwd.launches = 0


def fwd_kernel_config(head_dim: int) -> dict:
    """The bf16 forward kernel's dynamic shared-memory bytes, K/V ring
    stages and registers per thread after setmaxnreg (loading warpgroup,
    arithmetic warpgroups) at ``head_dim``, from the built library."""
    lib = _build.load("flash_attention_tri_fwd")
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.tpumon_flash_fwd_config(head_dim, out),
                 "tpumon_flash_fwd_config")
    return dict(zip(("smem_bytes", "stages", "load_regs", "math_regs"), out))


def bwd_kernel_config(head_dim: int) -> dict:
    """The bf16 backward kernels' dynamic shared-memory bytes, streamed
    stages and streamed tile rows (dQ: k tiles, dK/dV: q tiles), and the
    registers per thread after setmaxnreg at ``head_dim``, from the built
    library."""
    lib = _build.load("flash_attention_tri_bwd")
    out = (ctypes.c_int * 8)()
    _build.check(lib, lib.tpumon_flash_bwd_config(head_dim, out),
                 "tpumon_flash_bwd_config")
    return dict(zip(("dq_smem_bytes", "dkv_smem_bytes", "dq_stages",
                     "dkv_stages", "dq_k_tile", "dkv_q_tile", "load_regs",
                     "math_regs"), out))


def flash_attention_tri(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block: int = 128) -> torch.Tensor:
    """Forward-only view of ``flash_attention_tri_fwd``: [BH, T, D]."""
    return flash_attention_tri_fwd(q, k, v, block=block)[0]


def _probs_and_dscores(q, k, v, dout, lse, dvec):
    """P = exp(s - lse) (0 above the diagonal) and dS = P * (dO V^T - D)
    * scale for one chunk, in f32: what both backward passes rebuild."""
    t, d = q.shape[1:]
    scale = 1.0 / d**0.5
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.where(_causal(t, q.device), torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(dout.float(), v.float().transpose(1, 2))
    return p, p * (dp - dvec[..., None]) * scale


def flash_attention_tri_bwd_dq_reference(q, k, v, dout, lse, dvec):
    """Plain version of the dQ kernel: dQ = dS K, dS rounded to k's dtype
    first, accumulated in f32, returned in q's dtype."""
    dq = torch.empty_like(q)
    for c in _chunks(*q.shape[:2]):
        _, ds = _probs_and_dscores(q[c], k[c], v[c], dout[c], lse[c], dvec[c])
        dq[c] = torch.matmul(ds.to(k.dtype).float(), k[c].float()).to(q.dtype)
    return dq


def flash_attention_tri_bwd_dkv_reference(q, k, v, dout, lse, dvec):
    """Plain version of the dK/dV kernel: dV = P^T dO and dK = dS^T Q,
    P and dS rounded to the input dtype first, accumulated in f32,
    returned in the input dtype."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for c in _chunks(*q.shape[:2]):
        p, ds = _probs_and_dscores(q[c], k[c], v[c], dout[c], lse[c], dvec[c])
        dv[c] = torch.matmul(p.to(dout.dtype).float().transpose(1, 2),
                             dout[c].float()).to(v.dtype)
        dk[c] = torch.matmul(ds.to(q.dtype).float().transpose(1, 2),
                             q[c].float()).to(k.dtype)
    return dk, dv


def _check_residuals(q, lse, dvec) -> None:
    for name, x in (("lse", lse), ("D", dvec)):
        if x.shape != q.shape[:2] or x.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 [BH, T]={tuple(q.shape[:2])}; got "
                f"{x.dtype} {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} must lie on q's device")


def flash_attention_tri_bwd_dq(q, k, v, dout, lse, dvec, block: int = 128):
    """The dQ pass: [BH, T, D] in q's dtype. ``dvec`` is D = rowsum(dO *
    O), [BH, T] f32, like ``lse``."""
    _check(q, k, v, block, dout)
    _check_residuals(q, lse, dvec)
    if not _on_cuda(q, k, v, dout, lse, dvec):
        return flash_attention_tri_bwd_dq_reference(q, k, v, dout, lse, dvec)
    dq = torch.empty_like(q)
    _launch("flash_attention_tri_bwd", "tpumon_flash_tri_bwd_dq",
            (q, k, v, dout, lse, dvec, dq), q)
    flash_attention_tri_bwd_dq.launches += 1
    return dq


flash_attention_tri_bwd_dq.launches = 0


def flash_attention_tri_bwd_dkv(q, k, v, dout, lse, dvec, block: int = 128):
    """The dK/dV pass: (dk, dv), [BH, T, D] each in the input dtype."""
    _check(q, k, v, block, dout)
    _check_residuals(q, lse, dvec)
    if not _on_cuda(q, k, v, dout, lse, dvec):
        return flash_attention_tri_bwd_dkv_reference(q, k, v, dout, lse, dvec)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_tri_bwd", "tpumon_flash_tri_bwd_dkv",
            (q, k, v, dout, lse, dvec, dk, dv), q)
    flash_attention_tri_bwd_dkv.launches += 1
    return dk, dv


flash_attention_tri_bwd_dkv.launches = 0


def flash_attention_tri_bwd(q, k, v, out, lse, dout, block: int = 128):
    """Backward of the causal flash attention: ``(dq, dk, dv)``.

    Two passes over the same causal pairs, P rebuilt from the forward's
    ``lse``: dQ per q tile, dK/dV per k tile. D = rowsum(dO * O) is
    computed once here in plain torch (the reference does it outside its
    kernels too), so ``out`` itself never enters a kernel.
    """
    _check(q, k, v, block, out, dout)
    dvec = (dout.float() * out.float()).sum(-1)
    dq = flash_attention_tri_bwd_dq(q, k, v, dout, lse, dvec, block)
    dk, dv = flash_attention_tri_bwd_dkv(q, k, v, dout, lse, dvec, block)
    return dq, dk, dv
