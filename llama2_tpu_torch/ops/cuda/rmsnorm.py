"""Fused RMS norm (kernel K19).

``rmsnorm`` launches the hand-written CUDA kernel ``csrc/rmsnorm.cu``, which
replaces ``llama2_tpu/ops/pallas/rmsnorm.py::rmsnorm``: ``x * rsqrt(mean(x²)
+ eps) * w`` over the last axis, eps after the mean, for any leading shape,
stored in x's dtype. ``rmsnorm_plain`` is the same function in plain
PyTorch: ``ref.rmsnorm`` cast to x's dtype (``ref.rmsnorm`` returns the
promoted dtype, float32 for bf16 rows under a float32 weight; the Pallas
kernel stores into x's dtype). The rounding order is the Pallas kernel's:
normalize in float32, round to x's dtype, multiply by the weight, round to
x's dtype. No model path calls it (the model runs ``ref.rmsnorm``, as the
JAX model runs the XLA one); the kernel benchmarks
(``llama2_tpu_torch/benchmarks/kernels.py``) do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import build

_LIB = "rmsnorm"


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ref.rmsnorm(x, weight, eps).to(x.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis of x (..., D) with weight (D,); returns
    x's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``rmsnorm.launches``) or raise.
    """
    D = x.shape[-1]
    if tuple(weight.shape) != (D,):
        raise ValueError(f"weight {tuple(weight.shape)}: want ({D},)")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in build.DTYPE_CODES or weight.dtype not in build.DTYPE_CODES:
        raise ValueError(f"dtypes {x.dtype}, {weight.dtype}: want f32 or bf16")
    if weight.device != x.device:
        raise ValueError("all operands must be on one device")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("operands must be contiguous")
    out = torch.empty_like(x)
    R = x.numel() // D if D else 0
    if R == 0:
        return out
    err = _entry()(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), build.DTYPE_CODES[x.dtype],
        build.DTYPE_CODES[weight.dtype], R, D, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


@functools.cache
def _entry():
    fn = build.load_library(_LIB).rmsnorm
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    return fn
