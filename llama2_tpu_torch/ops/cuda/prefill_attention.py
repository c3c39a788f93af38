"""Causal flash attention for prefill segments (kernel K1).

``flash_prefill_attention`` launches the hand-written CUDA kernel
``csrc/prefill_attention.cu``, which replaces
``llama2_tpu/ops/pallas/prefill_attention.py::flash_prefill_attention``; the
kernel source's header says what bounds it and how it is laid out.
``flash_prefill_attention_plain`` is the same function in plain PyTorch: the
wrapper takes it for CPU tensors, and ``backend="torch"`` runs it on the card
for comparison.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import build

_LIB = "prefill_attention"


def flash_prefill_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: float32 throughout, q scaled
    by 1/sqrt(hs) before the dot, keys 0..pos+T-1 only. Returns q's dtype."""
    T, hs = q.shape[1], q.shape[-1]
    scale = 1.0 / (hs**0.5)
    n = pos + T
    out = ref.attention(
        q.float() * scale, k_cache[:, :, :n].float(), v_cache[:, :, :n].float(),
        pos, scale=1.0,
    )
    return out.to(q.dtype)


def _check(q, k_cache, v_cache, pos):
    if q.ndim != 4 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want q (B,T,H,hs) and caches (B,KVH,S,hs); got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    B, T, H, hs = q.shape
    Bc, KVH, S, hs_c = k_cache.shape
    if Bc != B or hs_c != hs or H % KVH != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if pos < 0 or pos + T > S:
        raise ValueError(f"segment {pos}..{pos + T - 1} outside the cache (S={S})")


def flash_prefill_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
) -> torch.Tensor:
    """Causal attention of a (B, T, H, hs) segment starting at position
    ``pos`` (an int) against the (B, KVH, S, hs) caches, which already hold
    the segment's own K/V rows. Returns (B, T, H, hs) in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``flash_prefill_attention.launches``) or raise.
    """
    pos = int(pos)
    _check(q, k_cache, v_cache, pos)
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k_cache, v_cache, pos)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, T, H, hs = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in build.DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: want one of f32, bf16")
    if not (k_cache.device == q.device == v_cache.device):
        raise ValueError("q and caches must be on one device")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("q and caches must be contiguous")
    if hs > 256 or H // KVH > 64:
        raise ValueError(f"kernel takes hs <= 256 and H/KVH <= 64 (got {hs}, {H // KVH})")
    out = torch.empty_like(q)
    fn = _entry()
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[q.dtype], B, T, H, KVH, S, hs, pos, 1.0 / (hs**0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_prefill_attention")
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0


@functools.cache
def _entry():
    fn = build.load_library(_LIB).flash_prefill_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
    fn.restype = i
    return fn
