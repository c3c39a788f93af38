"""Fused INT8 dequant-matmul (kernels K5 and K6).

``y (M, N) = x (M, K) @ dequant(q (K, N) int8, scale (K/G, N) f32)``

``quant_matmul`` and ``quant_matmul_stacked`` launch the hand-written CUDA
kernels of ``csrc/quant_matmul.cu``, which replace
``llama2_tpu/ops/pallas/quant_matmul.py::quant_matmul`` and
``::quant_matmul_stacked``. The stacked form reads layer ``layer`` of
(L, K, N) weights in place and can fuse an rmsnorm prologue (``rms_w``) and a
residual epilogue (``residual``). Two modes, as the Pallas kernel has them:

* ``accurate``: ``w = float(q) * scale``, float32 products and sums;
* ``fast``: x rounded to bf16; products summed in float32 within a quant
  group, the group's partial times its f32 scale added to a float32
  accumulator.

``quant_matmul_plain`` and ``quant_matmul_stacked_plain`` are the same
functions in plain PyTorch: the wrappers take them for CPU tensors, and
``chip_smoke.py`` holds the kernels against them on the card. The kernel
source's header says what bounds the kernels and how they are laid out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama2_tpu_torch.ops.cuda import build
from llama2_tpu_torch.quant.q8 import QuantTensor

_LIB = "quant_matmul"
MODES = ("accurate", "fast")
_MAX_GROUP_GEMV = 128  # kMaxG of the decode-row kernel
_STRIP = 128  # columns a block of the decode-row kernel covers (TILE_N)
_BLOCKS = 3 * 132  # blocks the decode-row kernel wants in flight: three an SM


def norm_rows(x2: torch.Tensor, rms_w: torch.Tensor, eps: float) -> torch.Tensor:
    """rmsnorm as the kernels' prologue computes it: float32 throughout, eps
    after the mean, no rounding to x's dtype before the weight multiply."""
    xf = x2.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(ms + eps) * rms_w.float()


def fast_accum(xf: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, group_size: int) -> torch.Tensor:
    """Fast mode's product of float32 rows ``xf (M, K)`` with ``q (K, N)``,
    ``scale (K/G, N)``: x rounded to bf16, each quant group's products summed
    in float32 (a bf16 x times an int8 w is exact there), the group's partial
    times its scale, the partials summed. Returns float32 (M, N)."""
    K, N = q.shape
    xb = xf.to(torch.bfloat16).float()
    xg = xb.reshape(-1, K // group_size, group_size).transpose(0, 1)  # (KG, M, G)
    part = torch.bmm(xg, q.float().reshape(K // group_size, group_size, N))
    return (part * scale[:, None, :]).sum(0)


def _matmul_plain(x2, q, scale, group_size: int, mode: str, rms_w, eps, res2):
    """(M, K) x -> (M, N) in x's dtype; the kernels' arithmetic."""
    K, N = q.shape
    xf = x2.float() if rms_w is None else norm_rows(x2, rms_w, eps)
    if mode == "accurate":
        w = q.float().reshape(K // group_size, group_size, N) * scale[:, None, :]
        acc = torch.matmul(xf, w.reshape(K, N))
    else:
        acc = fast_accum(xf, q, scale, group_size)
    if res2 is not None:
        acc = acc + res2.float()
    return acc.to(x2.dtype)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: want one of {MODES}")


def _flatten(x: torch.Tensor, K: int):
    if x.shape[-1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not contract with K={K}")
    lead = x.shape[:-1]
    return x.reshape(-1, K).contiguous(), lead


def _check_weight(q, scale, group_size: int, ndim: int):
    if q.ndim != ndim or scale.ndim != ndim or q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(
            f"want int8 q and float32 scale of rank {ndim}; got {q.dtype} {tuple(q.shape)}, "
            f"{scale.dtype} {tuple(scale.shape)}"
        )
    K, N = q.shape[-2:]
    if group_size <= 0 or K % group_size != 0:
        raise ValueError(f"in-features {K} not divisible by group size {group_size}")
    if tuple(scale.shape) != (*q.shape[:-2], K // group_size, N):
        raise ValueError(f"scale {tuple(scale.shape)} does not match q {tuple(q.shape)}")
    return K, N


def quant_matmul_plain(x: torch.Tensor, w: QuantTensor, *, mode: str = "fast") -> torch.Tensor:
    """``x (..., K) @ dequant(w)`` for a 2-D QuantTensor, in plain PyTorch."""
    _check_mode(mode)
    K, N = _check_weight(w.q, w.scale, w.group_size, 2)
    x2, lead = _flatten(x, K)
    return _matmul_plain(x2, w.q, w.scale, w.group_size, mode, None, 0.0, None).reshape(*lead, N)


def quant_matmul_stacked_plain(
    x: torch.Tensor,
    w: QuantTensor,
    layer: int,
    *,
    mode: str = "fast",
    rms_w: torch.Tensor | None = None,
    eps: float = 1e-5,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """``[residual +] [rmsnorm](x) (..., K) @ dequant(w[layer])`` for a
    layer-stacked (3-D) QuantTensor, in plain PyTorch."""
    _check_mode(mode)
    K, N = _check_weight(w.q, w.scale, w.group_size, 3)
    layer = _check_layer(layer, w.q.shape[0])
    x2, lead = _flatten(x, K)
    res2 = None if residual is None else residual.reshape(-1, N)
    out = _matmul_plain(
        x2, w.q[layer], w.scale[layer], w.group_size, mode, rms_w, float(eps), res2
    )
    return out.reshape(*lead, N)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_layer(layer, L: int) -> int:
    layer = int(layer)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    return layer


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, G: int) -> dict:
    """How the kernels cut an (M, K) x (K, N) product with group size ``G``.

    ``M <= 8`` takes the decode-row kernel: ``mt`` rows a thread, ``strips``
    blocks of 128 columns, and the contraction split over ``ksplit`` blocks of
    whole groups (8 warps a block, one group a warp at a time) so that about
    three blocks an SM are in flight. Larger ``M`` takes the tiled kernel with
    ``kc`` rows of K a shared-memory tile (the largest divisor of G up to 32).
    """
    if N % 4 != 0:
        raise ValueError(f"the kernels take out-features divisible by 4 (got {N})")
    KG = K // G
    if M > 8:
        kc = max(d for d in range(1, min(G, 32) + 1) if G % d == 0)
        return {"mt": 0, "ksplit": 1, "kc": kc, "strips": 0}
    if G > _MAX_GROUP_GEMV:
        raise ValueError(f"the decode-row kernel takes group sizes up to {_MAX_GROUP_GEMV} (got {G})")
    mt = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    strips = _cdiv(N, _STRIP)
    if strips > build.MAX_TICKETS:
        raise ValueError(f"out-features {N}: more than {build.MAX_TICKETS} column strips")
    want = _cdiv(_BLOCKS, strips)
    per = max(8, _cdiv(_cdiv(KG, want), 8) * 8)  # groups a block: whole rounds of 8 warps
    return {"mt": mt, "ksplit": max(1, _cdiv(KG, per)), "kc": 0, "strips": strips}


def _launch(which, x2, q, scale, group_size, mode, layer, rms_w, eps, res2):
    """Check the operands of a CUDA launch, launch, count it."""
    L = q.shape[0] if q.ndim == 3 else None
    K, N = q.shape[-2:]
    M = x2.shape[0]
    if x2.dtype not in build.DTYPE_CODES:
        raise ValueError(f"x dtype {x2.dtype}: want one of f32, bf16")
    operands = [x2, q, scale]
    for name, t, shape in (("rms_w", rms_w, (K,)), ("residual", res2, (M, N))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != x2.dtype:
            raise ValueError(
                f"{name} {t.dtype} {tuple(t.shape)}: want {x2.dtype} {shape}"
            )
        operands.append(t)
    if any(t.device != x2.device for t in operands):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, scale)):
        raise ValueError("q and scale must be 16-byte aligned")
    if M == 0:
        return torch.empty((0, N), dtype=x2.dtype, device=x2.device)
    p = plan(M, K, N, group_size)
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    partial = tickets = None
    if p["ksplit"] > 1:
        partial, tickets = build.workspace(x2.device, p["ksplit"] * M * N)
    head = (
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), _ptr(rms_w), _ptr(res2),
        out.data_ptr(), _ptr(partial), _ptr(tickets),
        build.DTYPE_CODES[x2.dtype], MODES.index(mode),
    )
    tail = (
        M, K, N, group_size, p["mt"], p["ksplit"], p["kc"], float(eps),
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    entry2d, entry3d = _entries()
    if L is None:
        err = entry2d(*head, *tail)
    else:
        err = entry3d(*head, layer, L, *tail)
    build.check(err, which.__name__)
    which.launches += 1
    return out


def quant_matmul(x: torch.Tensor, w: QuantTensor, *, mode: str = "fast") -> torch.Tensor:
    """``x (..., K) @ w`` with fused dequantization, for a 2-D QuantTensor.
    Returns (..., N) in x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``quant_matmul.launches``) or raise.
    """
    _check_mode(mode)
    if w.q.ndim != 2:
        raise ValueError("quant_matmul expects a 2D QuantTensor (use quant_matmul_stacked)")
    K, N = _check_weight(w.q, w.scale, w.group_size, 2)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x2, lead = _flatten(x, K)
    out = _launch(quant_matmul, x2, w.q, w.scale, w.group_size, mode, 0, None, 0.0, None)
    return out.reshape(*lead, N)


quant_matmul.launches = 0


def quant_matmul_stacked(
    x: torch.Tensor,
    w: QuantTensor,
    layer: int,
    *,
    mode: str = "fast",
    rms_w: torch.Tensor | None = None,
    eps: float = 1e-5,
    residual: torch.Tensor | None = None,
) -> torch.Tensor:
    """``x (..., K) @ w[layer]`` for a layer-stacked (3-D) QuantTensor, read
    in place (no slice copy). Returns (..., N) in x's dtype.

    ``rms_w (K,)``: compute ``rmsnorm(x, rms_w, eps) @ w[layer]`` with the
    norm fused into the launch. ``residual (..., N)``: fused ``+ residual``.
    Both in x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``quant_matmul_stacked.launches``) or raise.
    """
    _check_mode(mode)
    if w.q.ndim != 3:
        raise ValueError("quant_matmul_stacked expects a layer-stacked (3D) QuantTensor")
    K, N = _check_weight(w.q, w.scale, w.group_size, 3)
    layer = _check_layer(layer, w.q.shape[0])
    if x.device.type == "cpu":
        return quant_matmul_stacked_plain(
            x, w, layer, mode=mode, rms_w=rms_w, eps=eps, residual=residual
        )
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x2, lead = _flatten(x, K)
    res2 = None if residual is None else residual.reshape(-1, N).contiguous()
    out = _launch(
        quant_matmul_stacked, x2, w.q, w.scale, w.group_size, mode, layer, rms_w, eps, res2
    )
    return out.reshape(*lead, N)


quant_matmul_stacked.launches = 0


@functools.cache
def _entries():
    lib = build.load_library(_LIB)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [p] * 8 + [i, i]
    tail = [i] * 7 + [f, p]
    lib.quant_matmul.argtypes = head + tail
    lib.quant_matmul.restype = i
    lib.quant_matmul_stacked.argtypes = head + [i, i] + tail
    lib.quant_matmul_stacked.restype = i
    return lib.quant_matmul, lib.quant_matmul_stacked
