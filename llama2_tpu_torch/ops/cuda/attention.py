"""Flash decode attention over the KV cache (kernels K2, K3, K4).

``flash_decode_attention_stacked`` launches the hand-written CUDA kernel
``csrc/decode_attention.cu``, which replaces
``llama2_tpu/ops/pallas/attention.py::flash_decode_attention_stacked``: it
appends this step's K/V rows at ``[layer, b, :, pos_b]`` in place and runs
single-query attention over keys ``0..pos_b``; the kernel source's header
says what bounds it and how it is laid out. K2 and K4 cut the key range into
splits merged in one launch through ``build.workspace``; :func:`plan` picks
the split count and the lane layout from the shapes alone (the paged K15 and
K17 take the same form and plan, ``paged_attention.fp_plan``).
``flash_decode_attention_stacked_plain`` is the same function in plain
PyTorch: the wrapper takes it for CPU tensors, and ``backend="torch"`` runs it
on the card for comparison.

``flash_decode_attention_fused`` is the glue-fused form (K4), which replaces
``llama2_tpu/ops/pallas/attention.py::flash_decode_attention_fused``: it takes
the QKV projection's raw pre-RoPE rows, rotates the query and key rows by the
step's pair-duplicated cos/sin tables inside the kernel, appends the rotated
K row and the raw V row, and runs the same read.
``flash_decode_attention_fused_plain`` is its plain version.

``flash_decode_attention`` (K3) replaces
``llama2_tpu/ops/pallas/attention.py::flash_decode_attention``: single-query
attention over one layer's read-only ``(B, KVH, S, hs)`` cache, each row at
its own position, no append: K2's split form and plan at ``S``, with a
read-only block (``split_block_read``: nothing written back, every key from
the cache). Under grouped-query attention each query head is its own block,
so a kv head's rows are read once a query head of its group (the L2 serves
the rereads where they fit). ``flash_decode_attention_plain`` is its plain
version. No model path calls it (the JAX model sends every T = 1 step to the
stacked kernel); the kernel benchmarks
(``llama2_tpu_torch/benchmarks/kernels.py``) do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import build
from llama2_tpu_torch.ops.cuda.attention_q8 import _sms

_LIB = "decode_attention"

WARPS = 8  # warps a block (csrc/decode_attention.cuh: kWarps)
MAX_SPLITS = 32  # kMaxSplit
# the blocks a split launch aims at, per SM: on the H100, 8 splits at batch 1
# (256 blocks) read faster than 6, 9, 12 or 16, and one split at 8 rows
# faster than two (`chip_smoke.py --dense-timing`, its dense-split lines)
BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, KVH: int, S: int, hs: int, dtype, sms: int, aligned: bool = True,
         splits: int | None = None) -> dict:
    """The launch of K2/K4's split form, from the shapes alone (never from
    ``pos``, which lives on the device): the lane layout and the split count.
    Cached by its arguments: the decode step asks for the same plan 32 times.

    ``vec`` elements a vector load: a 16-byte vector where hs is a multiple
    of it and the cache and new-row operands are 16-byte aligned
    (``aligned``), else 1. ``lanes`` a row (a power of two, 4..32; with one
    element a vector always 32), ``nv`` vectors a lane a row, ``unroll``
    warp loads a chunk. ``chunk`` is the keys one pass of a block covers,
    ``splits`` the split count: as many as keep the grid within
    ``BLOCKS_PER_SM`` blocks a SM (so 1 where the B * H blocks of (b, query
    head) fill the SMs already), each split at least 4 chunks at full
    context, at most ``MAX_SPLITS``. ``ws_floats`` and ``tickets`` are what
    the launch takes of ``build.workspace``. The device cuts row b's keys
    ``0..pos[b]`` into at most ``splits`` runs of whole chunks
    (``split_range`` in ``csrc/decode_attention.cuh``). ``splits`` given
    (1..``MAX_SPLITS``) replaces the chosen count: ``chip_smoke.py
    --dense-timing`` times the kernels at other counts with it. Where the
    B * H pairs fill the card (more than ``BLOCKS_PER_SM * sms``), the count
    is 1, which takes no ticket (:func:`split_workspace`): any B * H.
    """
    v = 16 // dtype.itemsize
    if aligned and hs % v == 0:
        vec, n = v, hs // v
        lanes = min(32, max(4, 1 << (n - 1).bit_length()))
        nv = -(-n // lanes)
        unroll = 4 // nv
    else:
        vec, lanes = 1, 32
        nv = 1 << (-(-hs // 32) - 1).bit_length()
        unroll = 8 // nv
    chunk = WARPS * unroll * (32 // lanes)
    if splits is None:
        splits = max(1, min(MAX_SPLITS, -(-S // (4 * chunk)), BLOCKS_PER_SM * sms // (B * H)))
    elif not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits {splits} outside 1..{MAX_SPLITS}")
    return {
        "vec": vec, "lanes": lanes, "nv": nv, "unroll": unroll, "chunk": chunk,
        "splits": splits, "grid": (splits, H, B),
        "ws_floats": B * H * splits * (hs + 2), "tickets": B * H,
    }


def split_workspace(device, p: dict, pairs: int) -> tuple:
    """The workspace of a split-form launch of plan ``p`` over ``pairs``
    (b, query head) pairs on ``device``, as the C entries take it: (ws,
    tickets, ws floats, ticket count). One split writes out directly and
    takes no state and no ticket, so it takes any number of pairs; more
    splits take a ticket a pair, at most ``build.MAX_TICKETS``."""
    if p["splits"] > 1 and pairs > build.MAX_TICKETS:
        raise ValueError(f"{pairs} (b, query head) pairs over {p['splits']} splits: more than "
                         f"{build.MAX_TICKETS} tickets")
    ws, tickets = build.workspace(device, p["ws_floats"] if p["splits"] > 1 else 0)
    return ws.data_ptr(), tickets.data_ptr(), ws.numel(), tickets.numel()


def _launch_plan(device, B, H, KVH, S, hs, dtype, rows: tuple[int, ...], splits) -> tuple[dict, tuple]:
    """The plan of a CUDA launch on ``device`` whose cache (and new-row)
    operands start at the addresses ``rows``, and its workspace
    (:func:`split_workspace`)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    aligned = all(r % 16 == 0 for r in rows)
    p = plan(B, H, KVH, S, hs, dtype, _sms(index), aligned, splits)
    return p, split_workspace(device, p, B * H)


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
    if q3.shape[2] > 256:
        raise ValueError(f"kernel takes hs <= 256 (got {q3.shape[2]})")
    return launch_stacked(q3, k_cache, v_cache, k_new, v_new, layer, pos).view(q.shape)


def launch_stacked(q3, k_cache, v_cache, k_new, v_new, layer: int, pos, splits: int | None = None):
    """K2's launch on operands the wrapper has checked, q3 (B, H, hs): the
    split count of :func:`plan`, or ``splits``. Counts the launch."""
    B, H, hs = q3.shape
    KVH, S = k_cache.shape[2], k_cache.shape[3]
    rows = (k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(), v_new.data_ptr())
    p, work = _launch_plan(q3.device, B, H, KVH, S, hs, q3.dtype, rows, splits)
    out = torch.empty_like(q3)
    err = _entry()(
        q3.data_ptr(), *rows, pos.data_ptr(), out.data_ptr(), *work,
        build.DTYPE_CODES[q3.dtype], layer, B, H, KVH, S, hs, p["splits"], p["vec"], p["chunk"],
        1.0 / (hs**0.5), torch.cuda.current_stream(q3.device).cuda_stream,
    )
    build.check(err, "flash_decode_attention_stacked")
    flash_decode_attention_stacked.launches += 1
    return out


flash_decode_attention_stacked.launches = 0


def rope_rows_plain(qkv, cos_il, sin_il, n_heads: int, cache_dtype):
    """The glue-fused kernels' prologue (K4, K17): RoPE in float32 on the raw
    rows (as ``ref.apply_rope``): the query (B, H, hs) kept float32, the
    rotated K rows rounded to the cache dtype and the raw V rows, each
    (B, KVH, hs)."""
    H = n_heads
    KVH = (qkv.shape[1] - H) // 2
    cos, sin = cos_il[:, None, 0::2], sin_il[:, None, 0::2]  # (B, 1, hs/2)
    x = qkv.float()
    q = ref.apply_rope(x[:, None, :H], cos, sin)[:, 0]
    k = ref.apply_rope(x[:, None, H : H + KVH], cos, sin)[:, 0].to(cache_dtype)
    return q, k, qkv[:, H + KVH :].to(cache_dtype)


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
    hs = qkv.shape[-1]
    q, k_new, v_new = rope_rows_plain(qkv, cos_il, sin_il, n_heads, k_cache.dtype)
    for b, p in enumerate(pos.tolist()):
        k_cache[layer, b, :, p] = k_new[b]
        v_cache[layer, b, :, p] = v_new[b]
    n = int(pos.max()) + 1
    out = ref.attention(
        q[:, None] * (1.0 / (hs**0.5)),
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
    return launch_fused(qkv, k_cache, v_cache, cos_il, sin_il, layer, pos, H)


def launch_fused(qkv, k_cache, v_cache, cos_il, sin_il, layer: int, pos, H: int, splits: int | None = None):
    """K4's launch on operands the wrapper has checked: the split count of
    :func:`plan`, or ``splits``. Counts the launch."""
    B, _, hs = qkv.shape
    KVH, S = k_cache.shape[2], k_cache.shape[3]
    x, k, v = qkv.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()
    p, work = _launch_plan(qkv.device, B, H, KVH, S, hs, qkv.dtype, (k, v, x), splits)
    out = torch.empty((B, H, hs), dtype=qkv.dtype, device=qkv.device)
    err = _entry_fused()(
        x, cos_il.data_ptr(), sin_il.data_ptr(), k, v, pos.data_ptr(), out.data_ptr(), *work,
        build.DTYPE_CODES[qkv.dtype], layer, B, H, KVH, S, hs, p["splits"], p["vec"], p["chunk"],
        1.0 / (hs**0.5), torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    build.check(err, "flash_decode_attention_fused")
    flash_decode_attention_fused.launches += 1
    return out


flash_decode_attention_fused.launches = 0


def pos_rows(pos, B: int, device) -> torch.Tensor:
    """``pos`` (an int, or a tensor of 1 or B positions) as an int32 (B,)
    tensor on ``device``, as the JAX wrappers broadcast it; a tensor that is
    one already is returned as it is."""
    return torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1).expand(B).contiguous()


def flash_decode_attention_plain(q, k_cache, v_cache, pos, *, scale=None) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch: float32 attention with q scaled
    before the dot, over keys 0..pos[b] of each row. q (B, 1, H, hs) or
    (B, H, hs); caches (B, KVH, S, hs); ``pos`` an int or a (B,) tensor."""
    q3 = q[:, 0] if q.ndim == 4 else q
    if scale is None:
        scale = 1.0 / q3.shape[-1] ** 0.5
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
    n = pos + 1 if isinstance(pos, int) else int(pos.max()) + 1
    out = ref.attention(
        q3[:, None].float() * scale,
        k_cache[:, :, :n].float(),
        v_cache[:, :, :n].float(),
        pos if isinstance(pos, int) else pos_rows(pos, q3.shape[0], q.device),
        scale=1.0,
    ).to(q.dtype)
    return out.reshape(q.shape)


def flash_decode_attention(q, k_cache, v_cache, pos, *, scale=None) -> torch.Tensor:
    """Single-query decode attention over one layer's cache, no append.

    q (B, 1, H, hs) or (B, H, hs); k_cache/v_cache (B, KVH, S, hs) in q's
    dtype, read only; ``pos`` the query's position, an int or a per-row (B,)
    tensor (0 <= pos < S is the caller's contract; a tensor's values are not
    read back to check); ``scale`` defaults to 1/sqrt(hs) (a caller that
    zero-pads the head dim passes the real one). Returns q's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``flash_decode_attention.launches``) or raise.
    """
    if q.ndim == 4 and q.shape[1] != 1:
        raise ValueError("flash_decode_attention is single-query (T=1)")
    q3 = q[:, 0] if q.ndim == 4 else q
    if q3.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"want q (B,[1,]H,hs) and caches (B,KVH,S,hs); got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    B, H, hs = q3.shape
    Bc, KVH, S, hs_c = k_cache.shape
    if Bc != B or hs_c != hs or H % KVH != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
        if not 0 <= pos < S:
            raise ValueError(f"pos {pos} outside 0..{S - 1}")
    if scale is None:
        scale = 1.0 / hs**0.5
    if q.device.type == "cpu":
        return flash_decode_attention_plain(q, k_cache, v_cache, pos, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in build.DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}: want one of f32, bf16")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in (q3, k_cache, v_cache)):
        raise ValueError("operands must be contiguous")
    if hs > 256:
        raise ValueError(f"kernel takes hs <= 256 (got {hs})")
    return launch_read(q3, k_cache, v_cache, pos_rows(pos, B, q.device), float(scale)).view(q.shape)


def read_plan(q3, k_cache, v_cache, sms: int, splits: int | None = None) -> dict:
    """K3's launch: :func:`plan` at the cache's ``S`` for q3 (B, H, hs) over
    one layer's caches (B, KVH, S, hs), 16-byte vectors where both caches
    start aligned to them (q is read by element), or ``splits`` splits."""
    B, H, hs = q3.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    aligned = k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0
    return plan(B, H, KVH, S, hs, q3.dtype, sms, aligned, splits)


def launch_read(q3, k_cache, v_cache, pos, scale: float, splits: int | None = None):
    """K3's launch on operands the wrapper has checked, q3 (B, H, hs) and
    ``pos`` an int32 (B,) tensor, as :func:`read_plan` says. Counts the
    launch."""
    B, H, hs = q3.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    index = q3.device.index if q3.device.index is not None else torch.cuda.current_device()
    p = read_plan(q3, k_cache, v_cache, _sms(index), splits)
    out = torch.empty_like(q3)
    err = _entry_read()(
        q3.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(),
        *split_workspace(q3.device, p, B * H), build.DTYPE_CODES[q3.dtype],
        B, H, KVH, S, hs, p["splits"], p["vec"], p["chunk"], scale,
        torch.cuda.current_stream(q3.device).cuda_stream,
    )
    build.check(err, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


@functools.cache
def _entry_read():
    """K3's entry: 7 pointers, the workspace's size, 10 ints, the scale, the stream."""
    fn = build.load_library(_LIB).flash_decode_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [ctypes.c_longlong] + [i] * 10 + [ctypes.c_float, p]
    fn.restype = i
    return fn


# both split-form entries: 9 pointers, the workspace's size, 11 ints, the scale, the stream
_SPLIT_ARGS = (
    [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
)


@functools.cache
def _entry_fused():
    fn = build.load_library(_LIB).flash_decode_attention_fused
    fn.argtypes = _SPLIT_ARGS
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry():
    fn = build.load_library(_LIB).flash_decode_attention_stacked
    fn.argtypes = _SPLIT_ARGS
    fn.restype = ctypes.c_int
    return fn
