"""Weight-only int8 quantization for serving.

Counterpart of ``tpumon/loadgen/quant.py``. A decode step streams every
weight once for one token a slot, so storing the weights as int8 with a
per-output-channel float scale halves the resident bytes against bf16
(4x against the f32 master weights).

``QTensor`` holds ``(q: int8, scale: f32[out])``; ``QTensor.to(dt)``
*dequantizes* (``q.to(dt) * scale.to(dt)``, the reference's ``astype``),
and the serving paths only ever touch a weight as ``x @ w.to(dt)``, so
quantized params drop in unchanged. As in the reference, the serving path
dequantizes in the compute dtype and then runs the product; it does not
route decode products through the int8 GEMM kernel (``ops/quant_matmul``),
which the burns use. Eager torch materializes the dequantized weight on
each call.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# Leaves never quantized: the 1-D norm gains and the embedding table
# (its consumer is a gather), and the MoE router.
SKIP_NAMES = ("embed", "attn_norm", "mlp_norm", "final_norm", "router")


@dataclass
class QTensor:
    """int8 weights + per-output-channel scale; dequantizes on ``to``."""

    q: torch.Tensor  # int8, [..., out]
    scale: torch.Tensor  # float32, [out]

    def to(self, dt: torch.dtype) -> torch.Tensor:
        return self.q.to(dt) * self.scale.to(dt)

    def to_device(self, device) -> "QTensor":
        return QTensor(q=self.q.to(device), scale=self.scale.to(device))

    @property
    def shape(self):
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.numel() + 4 * self.scale.numel()


def quantize(w: torch.Tensor) -> QTensor:
    """Symmetric per-output-channel (last axis) int8 quantization, the
    reference's op order (round half to even), so the codes and scales of
    an f32 weight equal the reference's bit for bit."""
    dims = tuple(range(w.ndim - 1))
    scale = torch.clamp_min(torch.amax(w.abs(), dim=dims) / 127.0, 1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale.float())


def quantize_params(params, skip_names: tuple[str, ...] = SKIP_NAMES,
                    _name: str = ""):
    """Quantize every >= 2-D weight leaf except ``skip_names`` (a leaf's
    name is its dict key)."""
    if isinstance(params, dict):
        return {k: quantize_params(v, skip_names, k)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [quantize_params(v, skip_names, f"[{i}]")
                for i, v in enumerate(params)]
    if _name in skip_names or params.ndim < 2:
        return params
    return quantize(params)
