"""Causal flash attention for prefill segments (kernel K1).

``flash_prefill_attention`` launches the hand-written CUDA kernel
``csrc/prefill_attention.cu``, which replaces
``llama2_tpu/ops/pallas/prefill_attention.py::flash_prefill_attention``; the
kernel source's header says what bounds it and how it is laid out. It has
three variants, chosen by :func:`plan` from the dtype and head size before
the launch: ``mma`` (bf16 with ``hs % 16 == 0``: bf16 tensor-core products),
``tf32`` (float32 with ``hs % 8 == 0``: each product as three TF32 tensor-core
passes, float32 accuracy) and ``fma`` (any other head size: float32 FMA). The
wrapper counts every launch in ``flash_prefill_attention.launches`` and each
variant's in ``launches_mma`` / ``launches_tf32`` / ``launches_fma``.
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
_SMS = 132  # the H100's SMs: the tensor-core variants' row tile is sized to fill them
_ROWS = 64  # query rows a block of the fma variant
_MAX_SPLITS = 16  # blocks a row tile's keys are cut over, at most


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


def plan(B: int, T: int, H: int, KVH: int, hs: int, dtype: torch.dtype) -> dict:
    """How a (B, T, H, hs) segment is launched: the variant, the row groups
    of a block of a tensor-core variant (``warps``: 16 query rows each; 0 for
    fma) and the key slices each is cut into (``slices``: one warp each; the
    tf32 variant's blocks have 4 warps where a slice keeps 8 keys of a tile),
    the blocks each row tile's keys are cut over (``splits``), the grid
    (KVH * splits, row tiles, B), the dynamic shared memory in bytes and the
    float32 workspace the splits' runs take (``ws``, 0 for one split).

    bf16 with ``hs % 16 == 0`` takes the mma variant and float32 with ``hs %
    8 == 0`` the tf32 one, each with the largest row tile of 64, 32 or 16 rows
    that still launches ``_SMS`` blocks (16 if none does); anything else the
    fma variant's 64-row tiles of whole tokens. Where even 16-row tiles
    launch fewer than ``_SMS`` blocks (a verify window), the tf32 variant
    cuts each row tile's keys over up to ``_MAX_SPLITS`` blocks, for about
    two blocks an SM; the split count comes from the shapes, not from the
    position (a split whose run of keys is empty merges as nothing).
    """
    G = H // KVH
    bf16 = dtype == torch.bfloat16
    if (bf16 and hs % 16 == 0) or (dtype == torch.float32 and hs % 8 == 0):
        hs_pad = 64 if hs <= 64 else 128 if hs <= 128 else 256
        warps = 4
        while warps > 1 and B * KVH * _cdiv(T * G, 16 * warps) < _SMS:
            warps //= 2
        tiles = _cdiv(T * G, 16 * warps)
        if bf16:  # keys a K/V tile; a q tile and two K/V tiles, rows of 16 bytes of pad
            keys = 64 if hs_pad <= 128 else 32
            smem = 2 * (hs_pad + 8) * (16 * warps + 4 * keys)
            return {"variant": "mma", "warps": warps, "slices": 1, "splits": 1,
                    "grid": (KVH, tiles, B), "smem": smem, "ws": 0}
        # q's hi and lo tiles and two K/V tiles, rows of 4 floats of pad
        keys = 64 if hs_pad <= 64 else 32 if hs_pad <= 128 and warps < 4 else 16
        slices = min(4 // warps, keys // 8)
        smem = 4 * (hs_pad + 4) * (2 * 16 * warps + 4 * keys)
        blocks = B * KVH * tiles  # one ticket each where keys are split
        splits = 1 if blocks >= _SMS else min(_MAX_SPLITS, _cdiv(2 * _SMS, blocks))
        # each run's rows of (o, m, l) at the padded head size
        ws = blocks * splits * 16 * warps * (hs_pad + 2) if splits > 1 else 0
        return {"variant": "tf32", "warps": warps, "slices": slices, "splits": splits,
                "grid": (KVH * splits, tiles, B), "smem": smem, "ws": ws}
    block_q = _ROWS // G
    smem = 4 * (_ROWS * hs + 32 * (hs + 1) + 32 * hs + _ROWS * 32)
    return {"variant": "fma", "warps": 0, "slices": 1, "splits": 1,
            "grid": (KVH, _cdiv(T, block_q), B), "smem": smem, "ws": 0}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    count the launch in ``flash_prefill_attention.launches`` and in its
    variant's ``launches_mma``, ``launches_tf32`` or ``launches_fma``) or
    raise.
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
    p = plan(B, T, H, KVH, hs, q.dtype)
    if p["warps"] and any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError(f"the {p['variant']} variant reads 16-byte aligned q and caches")
    out = torch.empty_like(q)
    ws = tickets = None
    if p["ws"]:
        ws, tickets = (t.data_ptr() for t in build.workspace(q.device, p["ws"]))
    fn = _entry()
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        build.DTYPE_CODES[q.dtype], B, T, H, KVH, S, hs, pos, 1.0 / (hs**0.5), p["warps"],
        p["splits"], ws, tickets, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_prefill_attention")
    flash_prefill_attention.launches += 1
    counter = f"launches_{p['variant']}"
    setattr(flash_prefill_attention, counter, getattr(flash_prefill_attention, counter) + 1)
    return out


flash_prefill_attention.launches = 0
flash_prefill_attention.launches_mma = 0
flash_prefill_attention.launches_tf32 = 0
flash_prefill_attention.launches_fma = 0


@functools.cache
def _entry():
    fn = build.load_library(_LIB).flash_prefill_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, i, p, p, p]
    fn.restype = i
    return fn
