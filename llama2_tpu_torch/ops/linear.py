"""Matmul dispatch for weight-applying projections.

Port of ``llama2_tpu/ops/linear.py``. An fp weight is a plain
``torch.matmul`` (the JAX package leaves the fp dot to XLA too). A
``QuantTensor`` weight dequantizes beside the matmul with ``backend="torch"``
(JAX's ``xla``), or goes through the hand-written fused dequant-matmul kernel
with ``backend="cuda"`` (fast mode; JAX's ``pallas``) and
``backend="cuda-accurate"`` (accurate mode; JAX's ``pallas-accurate``).
"""

from __future__ import annotations

import torch

from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_stacked
from llama2_tpu_torch.quant.q8 import QuantTensor, dequantize

BACKENDS = ("torch", "cuda", "cuda-accurate")


def quant_mode(backend: str) -> str:
    """``cuda`` -> the fast per-group-bf16 kernels; ``cuda-accurate`` -> the
    float32-dequant kernels, argmax token-exact against the dequant oracle."""
    return "accurate" if backend == "cuda-accurate" else "fast"


def linear(x: torch.Tensor, w, backend: str = "torch", layer=None) -> torch.Tensor:
    """``x (..., in) @ w (in, out)``; ``w`` an fp tensor or a QuantTensor.

    ``layer``: when ``w`` is a layer-STACKED (3-D) QuantTensor, selects the
    layer; the CUDA kernel then reads its tiles in place from the stack.
    """
    if isinstance(w, QuantTensor):
        if w.q.ndim == 3 and layer is not None:
            if backend.startswith("cuda"):
                return quant_matmul_stacked(x, w, layer, mode=quant_mode(backend))
            return torch.matmul(x, dequantize(w[layer], x.dtype))
        if backend.startswith("cuda"):
            return quant_matmul(x, w, mode=quant_mode(backend))
        return torch.matmul(x, dequantize(w, x.dtype))
    return torch.matmul(x, w)
