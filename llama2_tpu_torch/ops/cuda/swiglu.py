"""Fused SwiGLU gate (kernel K20).

``swiglu`` launches the hand-written CUDA kernel ``csrc/swiglu.cu``, which
replaces ``llama2_tpu/ops/pallas/swiglu.py::swiglu``: ``silu(h1) * h3`` with
silu in float32 rounded to h1's dtype before the product, stored in h1's
dtype. ``swiglu_plain`` is the same function in plain PyTorch,
``ref.swiglu`` cast to h1's dtype. No model path calls it (the model runs
``ref.swiglu``, as the JAX model runs the XLA one); the kernel benchmarks
(``llama2_tpu_torch/benchmarks/kernels.py``) do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import build

_LIB = "swiglu"


def swiglu_plain(h1: torch.Tensor, h3: torch.Tensor) -> torch.Tensor:
    return ref.swiglu(h1, h3).to(h1.dtype)


def swiglu(h1: torch.Tensor, h3: torch.Tensor) -> torch.Tensor:
    """``silu(h1) * h3`` for h1, h3 of one shape; returns h1's shape and
    dtype.

    CPU tensors take the plain version; CUDA tensors (h1 and h3 of one
    dtype) launch the kernel (and count the launch in ``swiglu.launches``)
    or raise.
    """
    if h1.shape != h3.shape:
        raise ValueError(f"h1 {tuple(h1.shape)} and h3 {tuple(h3.shape)} differ")
    if h1.device.type == "cpu":
        return swiglu_plain(h1, h3)
    if h1.device.type != "cuda":
        raise ValueError(f"unsupported device {h1.device}")
    if h1.dtype not in build.DTYPE_CODES or h3.dtype != h1.dtype:
        raise ValueError(f"dtypes {h1.dtype}, {h3.dtype}: want one of f32, bf16 for both")
    if h3.device != h1.device:
        raise ValueError("all operands must be on one device")
    if not (h1.is_contiguous() and h3.is_contiguous()):
        raise ValueError("operands must be contiguous")
    out = torch.empty_like(h1)
    if h1.numel() == 0:
        return out
    err = _entry()(
        h1.data_ptr(), h3.data_ptr(), out.data_ptr(), build.DTYPE_CODES[h1.dtype], h1.numel(),
        torch.cuda.current_stream(h1.device).cuda_stream,
    )
    build.check(err, "swiglu")
    swiglu.launches += 1
    return out


swiglu.launches = 0


@functools.cache
def _entry():
    fn = build.load_library(_LIB).swiglu
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, ctypes.c_longlong, p]
    fn.restype = i
    return fn
