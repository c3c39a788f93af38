"""Fused INT8 dequant-matmul (kernels K5 and K6).

``y (M, N) = x (M, K) @ dequant(q (K, N) int8, scale (K/G, N) f32)``

``quant_matmul`` and ``quant_matmul_stacked`` launch the hand-written CUDA
kernels of ``csrc/quant_matmul.cu``, which replace
``llama2_tpu/ops/pallas/quant_matmul.py::quant_matmul`` and
``::quant_matmul_stacked``. The stacked form reads layer ``layer`` of
(L, K, N) weights in place and can fuse an rmsnorm prologue (``rms_w``) and a
residual epilogue (``residual``). Two modes, as the Pallas kernel has them:

* ``accurate``: ``w = float(q) * scale``, float32 products and sums (the
  M > 8 tile reaches it with x cut into three bf16 planes, ``x_planes``);
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
_SMS = 132  # the H100's SMs
_BLOCKS = 3 * _SMS  # blocks the decode-row kernel wants in flight: three an SM
# the M > 8 tile (tiled_wgmma_kernel): rows and columns a block, K rows a tile
_WG_BM, _WG_BN, _WG_BK = 128, 128, 64


def _wg_smem(planes: int) -> int:
    """The tile's dynamic shared memory with ``planes`` x planes (Ring::kSmem:
    5 stages of one plane, 3 of three; a stage holds the x tiles, a bf16 and
    a raw int8 weight tile, scales, 2 barriers and a counter; 1 KB of slack)."""
    stages = 5 if planes == 1 else 3
    return stages * (planes * _WG_BM * _WG_BK * 2 + _WG_BN * _WG_BK * 2 + _WG_BK * _WG_BN + _WG_BN * 4 + 2 * 8 + 4) + 1024


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


def x_planes(mode: str, dtype: torch.dtype, rms_w) -> int:
    """The bf16 planes the M > 8 tile cuts x into: one in fast mode (x
    rounded to bf16); in accurate mode three (hi, mid, lo: together the 24
    bits of a float32), or one for bf16 rows with no rmsnorm prologue, which
    are exact in bf16 already."""
    if mode == "fast" or (dtype == torch.bfloat16 and rms_w is None):
        return 1
    return 3


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
def plan(M: int, K: int, N: int, G: int, mode: str = "fast", planes: int | None = None) -> dict:
    """How the kernels cut an (M, K) x (K, N) product with group size ``G``.

    ``M <= 8`` takes the decode-row kernel: ``mt`` rows a thread, ``strips``
    blocks of 128 columns, and the contraction split over ``ksplit`` blocks of
    whole groups (8 warps a block, one group a warp at a time) so that about
    three blocks an SM are in flight. Larger ``M`` takes the wgmma tile
    (``mt`` 0) in both modes: ``tiles`` of 128 x 128 (row tiles, column
    tiles), K split by whole groups over ``ksplit`` blocks until 132 blocks
    run, x cut into ``planes`` bf16 planes (``x_planes``; by default 3 in
    accurate mode, as for float32 rows, 1 in fast mode) and ``smem`` bytes of
    shared memory a block.
    """
    if N % 4 != 0:
        raise ValueError(f"the kernels take out-features divisible by 4 (got {N})")
    KG = K // G
    if M > 8:
        planes = planes or (3 if mode == "accurate" else 1)
        tiles = (_cdiv(M, _WG_BM), _cdiv(N, _WG_BN))
        ksplit = 1
        if tiles[0] * tiles[1] < _SMS:
            per = _cdiv(KG, min(KG, _cdiv(_SMS, tiles[0] * tiles[1])))
            ksplit = _cdiv(KG, per)  # no split left empty
        if ksplit > 1 and tiles[0] * tiles[1] > build.MAX_TICKETS:
            raise ValueError(f"{tiles} output tiles: more than {build.MAX_TICKETS}")
        return {"mt": 0, "ksplit": ksplit, "strips": 0, "tiles": tiles, "planes": planes,
                "smem": _wg_smem(planes)}
    if G > _MAX_GROUP_GEMV:
        raise ValueError(f"the decode-row kernel takes group sizes up to {_MAX_GROUP_GEMV} (got {G})")
    mt = 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8
    strips = _cdiv(N, _STRIP)
    if strips > build.MAX_TICKETS:
        raise ValueError(f"out-features {N}: more than {build.MAX_TICKETS} column strips")
    want = _cdiv(_BLOCKS, strips)
    per = max(8, _cdiv(_cdiv(KG, want), 8) * 8)  # groups a block: whole rounds of 8 warps
    return {"mt": mt, "ksplit": max(1, _cdiv(KG, per)), "strips": strips}


def needs_prologue(x2: torch.Tensor, G: int, rms_w) -> bool:
    """Whether the M > 8 tile, in either mode, first writes x's bf16 planes
    to the workspace (normed with ``rms_w``, rounded or cut from float32, or
    laid out by K tile where ``G % 64 != 0``) rather than reading x as it is
    (which only bf16 rows with no prologue allow: one exact plane)."""
    return rms_w is not None or x2.dtype != torch.bfloat16 or G % _WG_BK != 0 or x2.data_ptr() % 16 != 0


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
    planes = x_planes(mode, x2.dtype, rms_w)
    p = plan(M, K, N, group_size, mode, planes)
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    partial = tickets = xt = None
    n_part = p["ksplit"] * M * N if p["ksplit"] > 1 else 0
    n_xt = 0  # the bf16 planes of the tile's prologue, after the partials
    if p["mt"] == 0 and needs_prologue(x2, group_size, rms_w):
        n_part = _cdiv(n_part, 4) * 4  # 16-byte aligned rows
        n_xt = _cdiv(planes * M * (K // group_size) * _cdiv(group_size, _WG_BK) * _WG_BK, 2)
    if n_part + n_xt:
        ws, tickets = build.workspace(x2.device, n_part + n_xt)
        partial = ws if p["ksplit"] > 1 else None
        if n_xt:
            xt = ws[n_part:n_part + n_xt]
    head = (
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), _ptr(rms_w), _ptr(res2),
        out.data_ptr(), _ptr(partial), _ptr(tickets), _ptr(xt),
        build.DTYPE_CODES[x2.dtype], MODES.index(mode),
    )
    tail = (
        M, K, N, group_size, p["mt"], p["ksplit"], planes, float(eps),
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    entry2d, entry3d = _entries()
    if L is None:
        err = entry2d(*head, *tail)
    else:
        err = entry3d(*head, layer, L, *tail)
    build.check(err, which.__name__)
    which.launches += 1
    if p["mt"] == 0:
        if mode == "fast":
            which.launches_tile_fast += 1
        else:
            which.launches_tile_accurate += 1
    return out


def quant_matmul(x: torch.Tensor, w: QuantTensor, *, mode: str = "fast") -> torch.Tensor:
    """``x (..., K) @ w`` with fused dequantization, for a 2-D QuantTensor.
    Returns (..., N) in x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``quant_matmul.launches``, an M > 8 tile's also in
    ``launches_tile_fast`` or ``launches_tile_accurate`` by mode) or raise.
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
quant_matmul.launches_tile_fast = 0
quant_matmul.launches_tile_accurate = 0


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
    count the launch in ``quant_matmul_stacked.launches``, an M > 8 tile's
    also in ``launches_tile_fast`` or ``launches_tile_accurate``) or raise.
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
quant_matmul_stacked.launches_tile_fast = 0
quant_matmul_stacked.launches_tile_accurate = 0


@functools.cache
def _entries():
    lib = build.load_library(_LIB)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [p] * 9 + [i, i]
    tail = [i] * 7 + [f, p]
    lib.quant_matmul.argtypes = head + tail
    lib.quant_matmul.restype = i
    lib.quant_matmul_stacked.argtypes = head + [i, i] + tail
    lib.quant_matmul_stacked.restype = i
    return lib.quant_matmul, lib.quant_matmul_stacked
