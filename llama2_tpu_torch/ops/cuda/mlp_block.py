"""The FFN megakernels (kernels K10, K11, K12): the post-attention half of a
decode layer over layer-stacked INT8 weights, one launch each.

* ``mlp_block_stacked``: ``x + swiglu(rmsnorm(x) @ w1[l], rmsnorm(x) @ w3[l]) @ w2[l]``
  (``residual=False`` leaves ``x +`` out);
* ``attn_mlp_block_stacked``: the same on ``r = x + att @ wo[l]``;
* ``layer_tail_qkv_stacked``: that, plus the next layer's pre-RoPE QKV
  ``rmsnorm(out, rms_att[l+1]) @ wqkv[l+1]`` (the index clamps to the last
  layer). With the glue-fused decode attention a decode layer is two launches.

They launch the one hand-written cooperative CUDA kernel of
``csrc/mlp_block.cu``, which replaces
``llama2_tpu/ops/pallas/mlp_block.py::mlp_block_stacked``,
``::attn_mlp_block_stacked`` and ``::layer_tail_qkv_stacked``. Arithmetic is
the dequant-matmul's fast mode (``ops/cuda/quant_matmul.py``): every matmul
operand is rounded to bf16 where it is used, a quant group's products are
summed in float32, times the f32 scale, into a float32 accumulator. Between
the phases everything stays float32; only the outputs are rounded to the
activation dtype, so the second rmsnorm of ``layer_tail_qkv_stacked`` reads
the float32 ``out``, not the value it returns. There is no accurate variant.

``*_plain`` are the same functions in plain PyTorch: the wrappers take them
for CPU tensors, and ``chip_smoke.py`` holds the kernel against them on the
card. On a CUDA tensor a wrapper launches or raises; nothing falls back to
the composed dequant-matmul route. The predicates ``*_supported`` say what
the kernel takes. The kernel source's header says what bounds it and how it
is laid out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama2_tpu_torch.ops.cuda import build
from llama2_tpu_torch.ops.cuda.quant_matmul import (
    _MAX_GROUP_GEMV,
    _STRIP,
    _cdiv,
    _check_layer,
    _check_weight,
    _ptr,
    fast_accum,
    norm_rows,
)
from llama2_tpu_torch.quant.q8 import QuantTensor

_LIB = "mlp_block"
_BLOCKS_PER_SM = 3  # the most blocks the persistent grid takes on an SM (kMinBlocks of the kernel)


def _stacked_quant(*ws) -> bool:
    return all(isinstance(w, QuantTensor) and w.q.ndim == 3 for w in ws)


def _takes(K: int, N: int, G: int) -> bool:
    """What the kernel's decode-row code takes of one (K, N) matrix."""
    return 0 < G <= _MAX_GROUP_GEMV and K % G == 0 and N % 4 == 0


def mlp_block_supported(w1, w3, w2) -> bool:
    """Whether ``mlp_block_stacked`` takes these weights: layer-stacked
    QuantTensors whose shapes agree, one group size for w1 and w3, whole
    groups along both contractions (groups up to 128), widths divisible by 4."""
    if not _stacked_quant(w1, w3, w2):
        return False
    L, D, HD = w1.q.shape
    if tuple(w3.q.shape) != (L, D, HD) or tuple(w2.q.shape) != (L, HD, D):
        return False
    if w1.group_size != w3.group_size:
        return False
    return _takes(D, HD, w1.group_size) and _takes(HD, D, w2.group_size)


def attn_mlp_block_supported(wo, w1, w3, w2) -> bool:
    """:func:`mlp_block_supported`, and ``wo`` a stacked (L, D, D) QuantTensor."""
    if not mlp_block_supported(w1, w3, w2) or not _stacked_quant(wo):
        return False
    L, D, _ = w1.q.shape
    return tuple(wo.q.shape) == (L, D, D) and _takes(D, D, wo.group_size)


def layer_tail_qkv_supported(wo, w1, w3, w2, wqkv) -> bool:
    """:func:`attn_mlp_block_supported`, and ``wqkv`` a stacked (L, D, Dq)
    QuantTensor."""
    if not attn_mlp_block_supported(wo, w1, w3, w2) or not _stacked_quant(wqkv):
        return False
    L, D, _ = w1.q.shape
    return tuple(wqkv.q.shape[:2]) == (L, D) and _takes(D, wqkv.q.shape[2], wqkv.group_size)


def _rows(x: torch.Tensor, D: int):
    if x.shape[-1] != D:
        raise ValueError(f"rows {tuple(x.shape)} do not have the model width {D}")
    return x.reshape(-1, D)


def _check(name: str, ok: bool, ws) -> None:
    """Raise on unsupported weights, scales that do not match them included."""
    if not ok:
        raise ValueError(f"{name}: unsupported weights (see the *_supported predicates)")
    for w in ws:
        _check_weight(w.q, w.scale, w.group_size, 3)


def _ffn_plain(rf, rms_w, w1, w3, w2, layer: int, eps: float):
    """float32 rows (M, D) -> the float32 FFN output, without the residual."""
    xn = norm_rows(rf, rms_w, eps)
    h1 = fast_accum(xn, w1.q[layer], w1.scale[layer], w1.group_size)
    h3 = fast_accum(xn, w3.q[layer], w3.scale[layer], w3.group_size)
    return fast_accum(h1 * torch.sigmoid(h1) * h3, w2.q[layer], w2.scale[layer], w2.group_size)


def mlp_block_plain(x, rms_w, w1, w3, w2, layer, eps: float = 1e-5, *, residual: bool = True):
    """``[x +] swiglu(rmsnorm(x, rms_w) @ w1[layer], .. @ w3[layer]) @ w2[layer]``
    in plain PyTorch, float32 between the steps. ``x (..., D)``."""
    _check("mlp_block", mlp_block_supported(w1, w3, w2), (w1, w3, w2))
    layer = _check_layer(layer, w1.q.shape[0])
    rf = _rows(x, w1.q.shape[1]).float()
    out = _ffn_plain(rf, rms_w, w1, w3, w2, layer, float(eps))
    if residual:
        out = out + rf
    return out.to(x.dtype).reshape(x.shape)


def _attn_ffn_plain(att, x, wo, rms_w, w1, w3, w2, layer: int, eps: float):
    """float32 ``r + ffn(r)`` with ``r = x + att @ wo[layer]``, as (M, D)."""
    D = w1.q.shape[1]
    r = _rows(x, D).float() + fast_accum(
        _rows(att, D).float(), wo.q[layer], wo.scale[layer], wo.group_size
    )
    return r + _ffn_plain(r, rms_w, w1, w3, w2, layer, eps)


def attn_mlp_block_plain(att, x, wo, rms_w, w1, w3, w2, layer, eps: float = 1e-5):
    """``r + swiglu(rmsnorm(r, rms_w) @ w1[layer], ..) @ w2[layer]`` with
    ``r = x + att @ wo[layer]``, in plain PyTorch. ``att``, ``x`` (..., D)."""
    _check("attn_mlp_block", attn_mlp_block_supported(wo, w1, w3, w2), (wo, w1, w3, w2))
    layer = _check_layer(layer, w1.q.shape[0])
    out = _attn_ffn_plain(att, x, wo, rms_w, w1, w3, w2, layer, float(eps))
    return out.to(x.dtype).reshape(x.shape)


def layer_tail_qkv_plain(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer, eps: float = 1e-5):
    """:func:`attn_mlp_block_plain` with layer-stacked ``rms_ffn (L, D)``, and
    ``qkv' = rmsnorm(out, rms_att[l']) @ wqkv[l']`` from the float32 ``out``,
    ``l' = min(layer + 1, L - 1)``. Returns ``(out (..., D), qkv' (..., Dq))``."""
    _check(
        "layer_tail_qkv", layer_tail_qkv_supported(wo, w1, w3, w2, wqkv), (wo, w1, w3, w2, wqkv)
    )
    L = w1.q.shape[0]
    layer = _check_layer(layer, L)
    nxt = min(layer + 1, L - 1)
    out = _attn_ffn_plain(att, x, wo, rms_ffn[layer], w1, w3, w2, layer, float(eps))
    qkv = fast_accum(
        norm_rows(out, rms_att[nxt], float(eps)), wqkv.q[nxt], wqkv.scale[nxt], wqkv.group_size
    )
    lead = x.shape[:-1]
    return out.to(x.dtype).reshape(x.shape), qkv.to(x.dtype).reshape(*lead, wqkv.q.shape[2])


def row_tile(M: int) -> int:
    """Rows a thread of the kernel holds (its ``MT``); more rows take passes."""
    return 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8


def plan(M: int, D: int, HD: int, Dq: int, groups: tuple, blocks: int) -> dict:
    """How one launch of ``blocks`` resident blocks cuts its four phases
    (wo, w1/w3, w2, wqkv; group sizes ``groups``; ``Dq`` 0 without the last,
    ``groups[0]`` 0 without the first): ``mt`` rows a thread, and per phase the
    number of splits of the contraction, whole rounds of a block's 8 warps
    over whole quant groups, so that its items (matrices x 128-column strips
    x splits) about fill the grid once. ``ws_floats`` is the workspace the
    launch needs."""
    mt = row_tile(M)

    def ksplit(K: int, N: int, G: int, nmat: int = 1) -> int:
        if not G or not N:
            return 0
        KG = K // G
        want = max(1, blocks // (nmat * _cdiv(N, _STRIP)))
        per = max(8, _cdiv(_cdiv(KG, want), 8) * 8)
        return max(1, _cdiv(KG, per))

    G0, G1, G2, Gq = groups
    ks = (ksplit(D, D, G0), ksplit(D, HD, G1, 2), ksplit(HD, D, G2), ksplit(D, Dq, Gq))
    partial = max(ks[0] * D, 2 * ks[1] * HD, ks[2] * D, ks[3] * Dq)
    return {"mt": mt, "ksplit": ks, "ws_floats": mt * (3 * D + HD + partial)}


@functools.lru_cache(maxsize=None)
def _grid(mt: int, device_index: int, att: bool = False) -> int:
    """Blocks of one launch on this device: three an SM, or fewer where fewer
    are resident together (a cooperative launch takes no more). ``att``: the
    instance with the attention phase (``ops/cuda/layer_block.py``)."""
    per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _entries()[1](mt, int(att), ctypes.byref(per_sm), ctypes.byref(sms))
        build.check(err, "mlp_block_occupancy")
    if per_sm.value < 1:
        raise RuntimeError(f"mlp_block: no block of the mt={mt} kernel fits an SM")
    return min(per_sm.value, _BLOCKS_PER_SM) * sms.value


def _launch(which, att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer, eps, residual, rms_stacked):
    """Check the operands of a CUDA launch, launch, count it. Returns
    ``(out (M, D), qkv (M, Dq) or None)``."""
    L, D, HD = w1.q.shape
    x2 = _rows(x, D).contiguous()
    att2 = None if att is None else _rows(att, D).contiguous()
    M = x2.shape[0]
    Dq = 0 if wqkv is None else wqkv.q.shape[2]
    if x2.dtype not in build.DTYPE_CODES:
        raise ValueError(f"x dtype {x2.dtype}: want one of f32, bf16")
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    rms_shape = (L, D) if rms_stacked else (D,)
    acts = [("att", att2, (M, D)), ("rms_ffn", rms_ffn, rms_shape), ("rms_att", rms_att, rms_shape)]
    operands = [x2]
    for name, t, shape in acts:
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != x2.dtype:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: want {x2.dtype} {shape}")
        operands.append(t)
    weights = [w for w in (wo, w1, w3, w2, wqkv) if w is not None]
    for w in weights:
        operands += [w.q, w.scale]
        if w.q.data_ptr() % 16 or w.scale.data_ptr() % 16:
            raise ValueError("q and scale must be 16-byte aligned")
    if any(t.device != x2.device for t in operands):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("operands must be contiguous")
    out = torch.empty((M, D), dtype=x2.dtype, device=x2.device)
    qkv = None if wqkv is None else torch.empty((M, Dq), dtype=x2.dtype, device=x2.device)
    if M == 0:
        return out, qkv
    groups = (
        wo.group_size if wo is not None else 0, w1.group_size, w2.group_size,
        wqkv.group_size if wqkv is not None else 0,
    )
    device = torch.device("cuda", x2.device.index if x2.device.index is not None
                          else torch.cuda.current_device())
    grid = _grid(row_tile(M), device.index)
    p = plan(M, D, HD, Dq, groups, grid)
    ws, tickets = build.workspace(device, p["ws_floats"])

    def qs(w):
        return (None, None) if w is None else (w.q.data_ptr(), w.scale.data_ptr())

    err = _entries()[0](
        _ptr(att2), x2.data_ptr(), *qs(wo), rms_ffn.data_ptr(), *qs(w1), *qs(w3), *qs(w2),
        _ptr(rms_att), *qs(wqkv), out.data_ptr(), _ptr(qkv), ws.data_ptr(), tickets.data_ptr(),
        ws.numel(), tickets.numel(), build.DTYPE_CODES[x2.dtype], layer, L, M, D, HD, Dq,
        *groups, *p["ksplit"], p["mt"], grid, int(residual), int(rms_stacked), float(eps),
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    build.check(err, which.__name__)
    which.launches += 1
    return out, qkv


def mlp_block_stacked(x, rms_w, w1, w3, w2, layer, eps: float = 1e-5, *, residual: bool = True):
    """``x + swiglu(rmsnorm(x, rms_w) @ w1[layer], .. @ w3[layer]) @ w2[layer]``
    in one launch. ``x (..., D)``, ``rms_w (D,)``; weights layer-stacked 3-D
    QuantTensors. ``residual=False`` returns the bare FFN output, for a
    caller that reduces partial outputs before it adds the residual.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``mlp_block_stacked.launches``) or raise.
    """
    if x.device.type == "cpu":
        return mlp_block_plain(x, rms_w, w1, w3, w2, layer, eps, residual=residual)
    _check("mlp_block_stacked", mlp_block_supported(w1, w3, w2), (w1, w3, w2))
    layer = _check_layer(layer, w1.q.shape[0])
    out, _ = _launch(
        mlp_block_stacked, None, x, None, rms_w, w1, w3, w2, None, None, layer, eps, residual, False
    )
    return out.reshape(x.shape)


mlp_block_stacked.launches = 0


def attn_mlp_block_stacked(att, x, wo, rms_w, w1, w3, w2, layer, eps: float = 1e-5):
    """``r + swiglu(rmsnorm(r, rms_w) @ w1[layer], ..) @ w2[layer]`` with
    ``r = x + att @ wo[layer]``: the whole post-attention half of a decoder
    layer in one launch. ``att``, ``x`` (..., D), ``rms_w (D,)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``attn_mlp_block_stacked.launches``) or raise.
    """
    if x.device.type == "cpu":
        return attn_mlp_block_plain(att, x, wo, rms_w, w1, w3, w2, layer, eps)
    _check("attn_mlp_block_stacked", attn_mlp_block_supported(wo, w1, w3, w2), (wo, w1, w3, w2))
    layer = _check_layer(layer, w1.q.shape[0])
    out, _ = _launch(
        attn_mlp_block_stacked, att, x, wo, rms_w, w1, w3, w2, None, None, layer, eps, True, False
    )
    return out.reshape(x.shape)


attn_mlp_block_stacked.launches = 0


def layer_tail_qkv_stacked(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer, eps: float = 1e-5):
    """The post-attention half of decoder layer ``layer`` and the next
    layer's pre-RoPE QKV projection, in one launch::

        r    = x + att @ wo[l]
        out  = r + swiglu(rmsnorm(r, rms_ffn[l]) @ w1[l], ..) @ w2[l]
        qkv' = rmsnorm(out, rms_att[l']) @ wqkv[l'],   l' = min(l + 1, L - 1)

    ``rms_ffn`` and ``rms_att`` are layer-stacked (L, D): the kernel reads two
    different layers of them. Returns ``(out (..., D), qkv' (..., Dq))``; the
    last layer's qkv' is its own layer's again and of no use.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``layer_tail_qkv_stacked.launches``) or raise.
    """
    if x.device.type == "cpu":
        return layer_tail_qkv_plain(att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer, eps)
    _check(
        "layer_tail_qkv_stacked", layer_tail_qkv_supported(wo, w1, w3, w2, wqkv),
        (wo, w1, w3, w2, wqkv),
    )
    layer = _check_layer(layer, w1.q.shape[0])
    out, qkv = _launch(
        layer_tail_qkv_stacked, att, x, wo, rms_ffn, w1, w3, w2, rms_att, wqkv, layer, eps,
        True, True,
    )
    return out.reshape(x.shape), qkv.reshape(*x.shape[:-1], wqkv.q.shape[2])


layer_tail_qkv_stacked.launches = 0


@functools.cache
def _entries():
    lib = build.load_library(_LIB)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mlp_block.argtypes = [p] * 18 + [ctypes.c_longlong] + [i] * 20 + [f, p]
    lib.mlp_block.restype = i
    lib.mlp_block_occupancy.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.mlp_block_occupancy.restype = i
    lib.layer_block.argtypes = [p] * 25 + [ctypes.c_longlong] + [i] * 18 + [f] + [i] * 5 + [f, p]
    lib.layer_block.restype = i
    return lib.mlp_block, lib.mlp_block_occupancy, lib.layer_block
