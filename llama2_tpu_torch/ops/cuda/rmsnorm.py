"""Fused RMS norm (kernel K19).

``rmsnorm`` launches the hand-written CUDA kernel ``csrc/rmsnorm.cu``, which
replaces ``llama2_tpu/ops/pallas/rmsnorm.py::rmsnorm``: ``x * rsqrt(mean(x²)
+ eps) * w`` over the last axis, eps after the mean, for any leading shape,
stored in x's dtype. ``rmsnorm_plain`` is the same function in plain
PyTorch: ``ref.rmsnorm`` cast to x's dtype (``ref.rmsnorm`` returns the
promoted dtype, float32 for bf16 rows under a float32 weight; the Pallas
kernel stores into x's dtype). The rounding order is the Pallas kernel's:
normalize in float32, round to x's dtype, multiply by the weight, round to
x's dtype.

The kernel has three forms (``csrc/rmsnorm.cu``), chosen by :func:`plan`:
``regs`` keeps a row and its slice of the weight in registers (a group of
32-256 threads a row, up to ``VECS`` 16-byte vectors a thread, several short
rows a block), ``loop`` is one block a row reading the row twice (rows too
long for the register form), ``scalar`` the loop one element at a time
(rows whose length or pointers do not allow 16-byte loads). Each launch
counts in ``rmsnorm.launches`` and in ``launches_<form>``. No model path
calls it (the model runs ``ref.rmsnorm``, as the JAX model runs the XLA
one); the kernel benchmarks (``llama2_tpu_torch/benchmarks/kernels.py``)
do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import build

_LIB = "rmsnorm"
FORMS = ("scalar", "loop", "regs")  # the kernel's form codes, in order
VECS = 8  # 16-byte vectors a thread of the register form holds (kVecs)
MAX_THREADS = 256  # the largest block of either form (kThreads)
ELEMS = {torch.float32: 4, torch.bfloat16: 8}  # elements of x in 16 bytes


def plan(R: int, D: int, dtype: torch.dtype, aligned: bool, sms: int) -> dict:
    """How one launch over ``R`` rows of ``D`` elements of ``dtype`` runs:
    its ``form``, and for the register form the threads a row ``tpr`` (the
    fewest, a power of two from 32 to 256, that hold the row at ``VECS``
    vectors a thread: 4 to 8 each above 32) and the rows a block ``rows``
    (as many as fit 256 threads while the launch still has a block for each
    of the ``sms`` SMs), and the ``grid``. ``aligned``: x, the weight and the
    output all sit on 16-byte boundaries."""
    n = ELEMS[dtype]
    if D % n or not aligned:
        return {"form": "scalar", "tpr": 0, "rows": 1, "grid": R}
    nvec = D // n
    tpr = 32
    while tpr * VECS < nvec and tpr < MAX_THREADS:
        tpr *= 2
    if tpr * VECS < nvec:
        return {"form": "loop", "tpr": 0, "rows": 1, "grid": R}
    rows = MAX_THREADS // tpr
    while rows > 1 and -(-R // rows) < sms:
        rows //= 2
    return {"form": "regs", "tpr": tpr, "rows": rows, "grid": -(-R // rows)}


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ref.rmsnorm(x, weight, eps).to(x.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last axis of x (..., D) with weight (D,); returns
    x's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``rmsnorm.launches``, and by form) or raise.
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, weight, out))
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    p = plan(R, D, x.dtype, aligned, _sms(index))
    err = _entry()(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), build.DTYPE_CODES[x.dtype],
        build.DTYPE_CODES[weight.dtype], R, D, float(eps), FORMS.index(p["form"]), p["tpr"],
        p["rows"], torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    name = f"launches_{p['form']}"
    setattr(rmsnorm, name, getattr(rmsnorm, name) + 1)
    return out


rmsnorm.launches = 0
for _form in FORMS:
    setattr(rmsnorm, f"launches_{_form}", 0)


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _entry():
    fn = build.load_library(_LIB).rmsnorm
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i, i, i, p]
    fn.restype = i
    return fn
