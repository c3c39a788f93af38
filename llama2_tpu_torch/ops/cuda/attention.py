"""Flash decode attention over the layer-stacked KV cache (kernels K2, K4).

``flash_decode_attention_stacked`` launches the hand-written CUDA kernel
``csrc/decode_attention.cu``, which replaces
``llama2_tpu/ops/pallas/attention.py::flash_decode_attention_stacked``: it
appends this step's K/V rows at ``[layer, b, :, pos_b]`` in place and runs
single-query attention over keys ``0..pos_b``; the kernel source's header
says what bounds it and how it is laid out.
``flash_decode_attention_stacked_plain`` is the same function in plain
PyTorch: the wrapper takes it for CPU tensors, and ``backend="torch"`` runs it
on the card for comparison.

``flash_decode_attention_fused`` is the glue-fused form (K4), which replaces
``llama2_tpu/ops/pallas/attention.py::flash_decode_attention_fused``: it takes
the QKV projection's raw pre-RoPE rows, rotates the query and key rows by the
step's pair-duplicated cos/sin tables inside the kernel, appends the rotated
K row and the raw V row, and runs the same read.
``flash_decode_attention_fused_plain`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import build

_LIB = "decode_attention"


def flash_decode_attention_stacked_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    layer: int,
    pos: torch.Tensor,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: write the rows in place, then
    float32 attention with q scaled by 1/sqrt(hs) before the dot over keys
    0..max(pos)."""
    has_t = q.ndim == 4  # (B, 1, H, hs): keep the token axis in the output
    q3 = q[:, 0] if has_t else q
    scale = 1.0 / (q3.shape[-1] ** 0.5)
    for b, p in enumerate(pos.tolist()):
        k_cache[layer, b, :, p] = k_new[b, :, 0]
        v_cache[layer, b, :, p] = v_new[b, :, 0]
    n = int(pos.max()) + 1
    out = ref.attention(
        q3[:, None].float() * scale,
        k_cache[layer, :, :, :n].float(),
        v_cache[layer, :, :, :n].float(),
        pos,
        scale=1.0,
    ).to(q.dtype)
    return out if has_t else out[:, 0]


def _check(q3, k_cache, v_cache, k_new, v_new, layer, pos):
    if q3.ndim != 3 or k_cache.ndim != 5 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want q (B,[1,]H,hs) and caches (L,B,KVH,S,hs); got {tuple(q3.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    B, H, hs = q3.shape
    L, Bc, KVH, S, hs_c = k_cache.shape
    if Bc != B or hs_c != hs or H % KVH != 0:
        raise ValueError(f"q {tuple(q3.shape)} does not match cache {tuple(k_cache.shape)}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, KVH, 1, hs):
            raise ValueError(f"{name} {tuple(t.shape)}: want {(B, KVH, 1, hs)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    if tuple(pos.shape) != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be an int32 ({B},) tensor, got {pos.dtype} {tuple(pos.shape)}")


def flash_decode_attention_stacked(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    layer: int,
    pos: torch.Tensor,
) -> torch.Tensor:
    """Fused KV append + decode attention over the layer-stacked cache.

    q (B, H, hs) or (B, 1, H, hs); caches (L, B, KVH, S, hs), updated IN
    PLACE at ``[layer, b, :, pos[b]]`` with k_new/v_new (B, KVH, 1, hs);
    ``pos`` an int32 (B,) tensor on q's device, each row at its own position
    (0 <= pos[b] < S is the caller's contract: the kernel does not read it
    back to check). Returns the attention output shaped like q.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``flash_decode_attention_stacked.launches``) or raise.
    """
    layer = int(layer)
    q3 = q[:, 0] if q.ndim == 4 else q
    if q.ndim == 4 and q.shape[1] != 1:
        raise ValueError("flash_decode_attention_stacked is T=1 only")
    _check(q3, k_cache, v_cache, k_new, v_new, layer, pos)
    if q.device.type == "cpu":
        return flash_decode_attention_stacked_plain(q, k_cache, v_cache, k_new, v_new, layer, pos)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tensors = (q3, k_cache, v_cache, k_new, v_new)
    if q.dtype not in build.DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"dtypes {[t.dtype for t in tensors]}: want one of f32, bf16")
    if any(t.device != q.device for t in (*tensors, pos)):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in (*tensors, pos)):
        raise ValueError("operands must be contiguous")
    B, H, hs = q3.shape
    KVH, S = k_cache.shape[2], k_cache.shape[3]
    if hs > 256:
        raise ValueError(f"kernel takes hs <= 256 (got {hs})")
    out = torch.empty_like(q3)
    err = _entry()(
        q3.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[q.dtype], layer, B, H, KVH, S, hs, 1.0 / (hs**0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_decode_attention_stacked")
    flash_decode_attention_stacked.launches += 1
    return out.view(q.shape)


flash_decode_attention_stacked.launches = 0


def flash_decode_attention_fused_plain(
    qkv: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cos_il: torch.Tensor,
    sin_il: torch.Tensor,
    layer: int,
    pos: torch.Tensor,
    n_heads: int,
) -> torch.Tensor:
    """The fused kernel's arithmetic in plain PyTorch. RoPE in float32 on the
    raw rows (``x0*c - x1*s``, ``x0*s + x1*c``, as ``ref.apply_rope``); the
    query stays float32 and is scaled in float32; the rotated K row is rounded
    to the cache dtype and written, with the raw V row, before the read."""
    B, rows, hs = qkv.shape
    H, KVH = n_heads, k_cache.shape[2]
    cos, sin = cos_il[:, None, 0::2], sin_il[:, None, 0::2]  # (B, 1, hs/2)
    x = qkv.float()
    q = ref.apply_rope(x[:, None, :H], cos, sin)  # (B, 1, H, hs) float32
    k_new = ref.apply_rope(x[:, None, H : H + KVH], cos, sin)[:, 0].to(k_cache.dtype)
    v_new = qkv[:, H + KVH :].to(v_cache.dtype)
    for b, p in enumerate(pos.tolist()):
        k_cache[layer, b, :, p] = k_new[b]
        v_cache[layer, b, :, p] = v_new[b]
    n = int(pos.max()) + 1
    out = ref.attention(
        q * (1.0 / (hs**0.5)),
        k_cache[layer, :, :, :n].float(),
        v_cache[layer, :, :, :n].float(),
        pos,
        scale=1.0,
    )
    return out[:, 0].to(qkv.dtype)


def flash_decode_attention_fused(
    qkv: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cos_il: torch.Tensor,
    sin_il: torch.Tensor,
    layer: int,
    pos: torch.Tensor,
    *,
    n_heads: int,
) -> torch.Tensor:
    """Glue-fused decode attention: RoPE (q and k), the in-place KV append and
    the online-softmax read in one launch on the QKV projection's raw output.

    qkv (B, H + 2*KVH, hs), pre-RoPE; caches (L, B, KVH, S, hs) in qkv's
    dtype, updated IN PLACE at ``[layer, b, :, pos[b]]``; cos_il/sin_il
    (B, hs) float32, each pair's value DUPLICATED on both of its elements;
    ``pos`` an int32 (B,) tensor (0 <= pos[b] < S is the caller's contract).
    Returns att (B, H, hs) in qkv's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``flash_decode_attention_fused.launches``) or raise.
    """
    layer = int(layer)
    if qkv.ndim != 3 or k_cache.ndim != 5 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want qkv (B,H+2*KVH,hs) and caches (L,B,KVH,S,hs); got {tuple(qkv.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    B, rows, hs = qkv.shape
    L, Bc, KVH, S, hs_c = k_cache.shape
    H = int(n_heads)
    if rows != H + 2 * KVH:
        raise ValueError(f"qkv rows {rows} != n_heads {H} + 2*KVH {2 * KVH}")
    if Bc != B or hs_c != hs or H % KVH != 0 or hs % 2 != 0:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not match cache {tuple(k_cache.shape)}")
    for name, t in (("cos_il", cos_il), ("sin_il", sin_il)):
        if tuple(t.shape) != (B, hs) or t.dtype != torch.float32:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: want float32 {(B, hs)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    if tuple(pos.shape) != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be an int32 ({B},) tensor, got {pos.dtype} {tuple(pos.shape)}")
    if qkv.device.type == "cpu":
        return flash_decode_attention_fused_plain(
            qkv, k_cache, v_cache, cos_il, sin_il, layer, pos, H
        )
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    tensors = (qkv, k_cache, v_cache)
    if qkv.dtype not in build.DTYPE_CODES or any(t.dtype != qkv.dtype for t in tensors):
        raise ValueError(f"dtypes {[t.dtype for t in tensors]}: want one of f32, bf16")
    everything = (*tensors, cos_il, sin_il, pos)
    if any(t.device != qkv.device for t in everything):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in everything):
        raise ValueError("operands must be contiguous")
    if hs > 256:
        raise ValueError(f"kernel takes hs <= 256 (got {hs})")
    out = torch.empty((B, H, hs), dtype=qkv.dtype, device=qkv.device)
    err = _entry_fused()(
        qkv.data_ptr(), cos_il.data_ptr(), sin_il.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[qkv.dtype], layer, B, H, KVH, S, hs, 1.0 / (hs**0.5),
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    build.check(err, "flash_decode_attention_fused")
    flash_decode_attention_fused.launches += 1
    return out


flash_decode_attention_fused.launches = 0


@functools.cache
def _entry_fused():
    fn = build.load_library(_LIB).flash_decode_attention_fused
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    return fn


@functools.cache
def _entry():
    fn = build.load_library(_LIB).flash_decode_attention_stacked
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    return fn
