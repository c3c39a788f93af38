"""Matmul dispatch for weight-applying projections.

Port of ``llama2_tpu/ops/linear.py``, fp branch only: ``x @ w`` is a plain
``torch.matmul`` (the JAX package leaves the fp dot to XLA too). Quantized
weights, which take the fused dequant-matmul kernel there, are not ported yet.
"""

from __future__ import annotations

import torch


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x (..., in) @ w (in, out)`` for an fp weight tensor."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"weight of type {type(w).__name__}: quantized weights are not yet "
            "ported to the torch package (quantized-weight slice)"
        )
    return torch.matmul(x, w)
