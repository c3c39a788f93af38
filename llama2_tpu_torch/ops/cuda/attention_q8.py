"""Attention over the INT8 KV cache (kernels K7, K8, K9).

The cache stores K/V as int8 rows with one float32 scale per (position, kv
head) row: half the bytes of a bf16 cache, which is what a decode step's
attention reads. ``quantize_kv_rows`` and ``dequantize_kv`` are the row
quantizer and its inverse (plain PyTorch; the JAX package computes them
outside any kernel too).

The wrappers launch the hand-written CUDA kernel of ``csrc/attention_q8.cu``,
which replaces, in ``llama2_tpu/ops/pallas/attention_q8.py``:

* ``flash_decode_attention_q8`` (K7): a window of T <= 16 query rows over one
  layer's cache, read only; a T > 1 call is a speculative verify window;
* ``flash_decode_attention_q8_stacked`` (K8): T = 1 over the layer-stacked
  cache, appending this step's already-quantized rows and scales in place;
* ``flash_decode_attention_q8_fused`` (K9): K8 on the QKV projection's raw
  pre-RoPE rows, with RoPE and the row quantization in the kernel.

Arithmetic (all three, and their plain versions): the query is rounded to
bf16; a score is the float32-accumulated dot with the int8 row times
``k_scale[t] * scale`` (the two scalars multiplied first); softmax in float32;
``p * v_scale[t]`` is rounded to bf16 before its product with the int8 row;
``out = acc / l`` in the query's dtype. The kernel source's header says what
bounds the kernel and how it is laid out.

``*_plain`` are the same functions in plain PyTorch: the wrappers take them
for CPU tensors, and ``chip_smoke.py`` holds the kernel against them on the
card. On a CUDA tensor a wrapper launches or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import build

_LIB = "attention_q8"
_MODES = {"window": 0, "append": 1, "fused": 2}
ROWS_PER_ITEM = 16  # query rows a work item of the kernel (kRB)
KEYS_PER_CHUNK = 32  # keys the kernel stages at a time (kCK)
MAX_WINDOW = 16  # K7's longest window
MAX_SPLITS = 32  # splits of the key range the kernel merges (kMaxSplit)


def quantize_kv_rows(rows: torch.Tensor):
    """Per-row symmetric int8: rows (..., hs) -> (int8 rows, float32 scales (...)).

    ``scale = amax / 127``, ``q = clip(round_half_even(rows / max(scale, 1e-20)),
    -127, 127)``, computed in the dtype of ``rows`` (bf16 rows: bf16 arithmetic,
    each step rounded), the scale returned as float32."""
    amax = rows.abs().amax(dim=-1)
    # a tensor divisor: on CUDA tensors PyTorch turns division by a Python
    # number into multiplication by its reciprocal, which rounds otherwise
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.clamp_min(scale, 1e-20)[..., None]
    q = torch.clamp(torch.round(rows / safe), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows`: float32 ``q * scale``."""
    return q.float() * scale[..., None]


def _attend_plain(q, k8, ks, v8, vs, horizon, scale: float) -> torch.Tensor:
    """The kernels' arithmetic over one layer's cache: q (B, T, H, hs); k8/v8
    (B, KVH, S, hs) int8, ks/vs (B, KVH, S) float32; horizon (B, T) int64, the
    last key each query token sees. Returns float32 (B, T, H, hs)."""
    B, T, H, hs = q.shape
    KVH = k8.shape[1]
    n = int(horizon.max()) + 1
    qb = q.to(torch.bfloat16).float().reshape(B, T, KVH, H // KVH, hs)
    s = torch.einsum("btkgd,bksd->bkgts", qb, k8[:, :, :n].float())
    s = s * (ks[:, :, None, None, :n] * scale)
    visible = torch.arange(n, device=q.device)[None, None, :] <= horizon[:, :, None]  # (B, T, n)
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)  # (B, KVH, G, T)
    pv = (p * vs[:, :, None, None, :n]).to(torch.bfloat16).float()
    acc = torch.einsum("bkgts,bksd->bkgtd", pv, v8[:, :, :n].float())
    out = acc / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hs)


def _pos_vector(pos, B: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(B).contiguous()
    return torch.full((B,), int(pos), dtype=torch.int32, device=device)


def _check_head(hs: int, H: int, KVH: int) -> None:
    if hs > 256 or hs % 2 != 0 or H % KVH != 0:
        raise ValueError(f"kernel takes an even hs <= 256 and H % KVH == 0 (got hs={hs}, H={H}, KVH={KVH})")


def _check_cache(k8, k_scale, v8, v_scale, ndim: int):
    if k8.ndim != ndim or k8.shape != v8.shape or k8.dtype != torch.int8 or v8.dtype != torch.int8:
        raise ValueError(f"want int8 caches of rank {ndim}; got {k8.dtype} {tuple(k8.shape)}, "
                         f"{v8.dtype} {tuple(v8.shape)}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(t.shape) != tuple(k8.shape[:-1]) or t.dtype != torch.float32:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: want float32 {tuple(k8.shape[:-1])}")


def flash_decode_attention_q8_plain(q, k8, k_scale, v8, v_scale, pos) -> torch.Tensor:
    """K7's arithmetic in plain PyTorch; arguments as the wrapper's."""
    squeeze = q.ndim == 3
    q4 = q[:, None] if squeeze else q
    B, T, _, hs = q4.shape
    last = _pos_vector(pos, B, q.device).long()
    horizon = last[:, None] - (T - 1) + torch.arange(T, device=q.device)[None, :]
    out = _attend_plain(q4, k8, k_scale, v8, v_scale, horizon, 1.0 / hs**0.5).to(q.dtype)
    return out[:, 0] if squeeze else out


def flash_decode_attention_q8(q, k8, k_scale, v8, v_scale, pos) -> torch.Tensor:
    """Attention of a window of T <= 16 query rows over one layer's int8 cache.

    q (B, T, H, hs) or (B, H, hs); k8/v8 (B, KVH, S, hs) int8; k_scale/v_scale
    (B, KVH, S) float32; ``pos`` (an int, or an int32 (B,) tensor) is the
    position of the LAST query row: row t sees keys 0..pos - (T - 1) + t, which
    the caller has already written. Returns q's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``flash_decode_attention_q8.launches``) or raise.
    """
    q4 = q[:, None] if q.ndim == 3 else q
    if q4.ndim != 4:
        raise ValueError(f"want q (B,[T,]H,hs); got {tuple(q.shape)}")
    _check_cache(k8, k_scale, v8, v_scale, 4)
    B, T, H, hs = q4.shape
    Bc, KVH, S, hs_c = k8.shape
    if Bc != B or hs_c != hs:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k8.shape)}")
    _check_head(hs, H, KVH)
    if not 1 <= T <= MAX_WINDOW:
        raise ValueError(f"window of {T} rows: the kernel takes 1..{MAX_WINDOW}")
    if q.device.type == "cpu":
        return flash_decode_attention_q8_plain(q, k8, k_scale, v8, v_scale, pos)
    out = torch.empty_like(q4)
    _launch(flash_decode_attention_q8, "window", q=q4, caches=(k8, k_scale, v8, v_scale),
            pos=_pos_vector(pos, B, q.device), out=out, L=1, layer=0, T=T, H=H)
    return out.view(q.shape)


flash_decode_attention_q8.launches = 0


def append_rows(k8, k_scale, v8, v_scale, rows, layer: int, pos) -> None:
    """Write (B, KVH, hs) int8 rows and (B, KVH) scales (``rows``: K rows, K
    scales, V rows, V scales) at ``[layer, b, :, pos[b]]`` of the stacked
    caches."""
    k_new, ks_new, v_new, vs_new = rows
    for b, p in enumerate(pos.tolist()):
        k8[layer, b, :, p] = k_new[b]
        k_scale[layer, b, :, p] = ks_new[b]
        v8[layer, b, :, p] = v_new[b]
        v_scale[layer, b, :, p] = vs_new[b]


def flash_decode_attention_q8_stacked_plain(
    q, k8, k_scale, v8, v_scale, k_new, ks_new, v_new, vs_new, layer, pos
) -> torch.Tensor:
    """K8's arithmetic in plain PyTorch: append, then attend keys 0..pos_b."""
    has_t = q.ndim == 4
    q3 = q[:, 0] if has_t else q
    layer = int(layer)
    rows = (k_new.reshape(k_new.shape[0], -1, k_new.shape[-1]), ks_new.reshape(ks_new.shape[0], -1),
            v_new.reshape(v_new.shape[0], -1, v_new.shape[-1]), vs_new.reshape(vs_new.shape[0], -1))
    append_rows(k8, k_scale, v8, v_scale, rows, layer, pos)
    out = _attend_plain(q3[:, None], k8[layer], k_scale[layer], v8[layer], v_scale[layer],
                        pos.long()[:, None], 1.0 / q3.shape[-1] ** 0.5).to(q.dtype)
    return out if has_t else out[:, 0]


def _check_stacked(B: int, H: int, hs: int, k8, k_scale, v8, v_scale, layer: int, pos):
    _check_cache(k8, k_scale, v8, v_scale, 5)
    L, Bc, KVH, S, hs_c = k8.shape
    if Bc != B or hs_c != hs:
        raise ValueError(f"rows ({B}, {H}, {hs}) do not match cache {tuple(k8.shape)}")
    _check_head(hs, H, KVH)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    if tuple(pos.shape) != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be an int32 ({B},) tensor, got {pos.dtype} {tuple(pos.shape)}")
    return KVH


def flash_decode_attention_q8_stacked(
    q, k8, k_scale, v8, v_scale, k_new, ks_new, v_new, vs_new, layer, pos
) -> torch.Tensor:
    """T = 1 attention over the layer-stacked int8 cache, appending this
    step's rows first.

    q (B, H, hs) or (B, 1, H, hs); k8/v8 (L, B, KVH, S, hs) int8 and
    k_scale/v_scale (L, B, KVH, S) float32, updated IN PLACE at
    ``[layer, b, :, pos[b]]`` with k_new/v_new (B, KVH, 1, hs) int8 and
    ks_new/vs_new (B, KVH, 1) float32 (:func:`quantize_kv_rows` of the step's
    rows); ``pos`` an int32 (B,) tensor (0 <= pos[b] < S is the caller's
    contract). Returns the attention output shaped like q.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``flash_decode_attention_q8_stacked.launches``) or raise.
    """
    layer = int(layer)
    if q.ndim == 4 and q.shape[1] != 1:
        raise ValueError("flash_decode_attention_q8_stacked is T=1 only")
    q3 = q[:, 0] if q.ndim == 4 else q
    if q3.ndim != 3:
        raise ValueError(f"want q (B,[1,]H,hs); got {tuple(q.shape)}")
    B, H, hs = q3.shape
    KVH = _check_stacked(B, H, hs, k8, k_scale, v8, v_scale, layer, pos)
    news = (k_new.reshape(B, -1, hs), ks_new.reshape(B, -1), v_new.reshape(B, -1, hs), vs_new.reshape(B, -1))
    for name, t, dt in zip(("k_new", "ks_new", "v_new", "vs_new"), news,
                           (torch.int8, torch.float32, torch.int8, torch.float32)):
        if t.shape[1] != KVH or t.dtype != dt:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: want {dt} with {KVH} kv heads")
    if q.device.type == "cpu":
        return flash_decode_attention_q8_stacked_plain(
            q, k8, k_scale, v8, v_scale, k_new, ks_new, v_new, vs_new, layer, pos
        )
    out = torch.empty_like(q3)
    _launch(flash_decode_attention_q8_stacked, "append", q=q3, caches=(k8, k_scale, v8, v_scale),
            pos=pos, out=out, L=k8.shape[0], layer=layer, T=1, H=H,
            news=tuple(t.contiguous() for t in news))
    return out.view(q.shape)


flash_decode_attention_q8_stacked.launches = 0


def rope_quantize_plain(qkv, cos_il, sin_il, n_heads: int):
    """What K9 and K13 compute from the raw QKV rows (B, H + 2*KVH, hs): the
    rotated query rows in float32 (B, H, hs), and the rotated K row and the
    raw V row quantized in float32: ``(q, (k8, ks, v8, vs))`` with int8
    (B, KVH, hs) rows and float32 (B, KVH) scales."""
    H = n_heads
    KVH = (qkv.shape[1] - H) // 2
    cos, sin = cos_il[:, None, 0::2], sin_il[:, None, 0::2]  # (B, 1, hs/2)
    x = qkv.float()
    q = ref.apply_rope(x[:, None, :H], cos, sin)[:, 0]
    k = ref.apply_rope(x[:, None, H : H + KVH], cos, sin)[:, 0]
    k8, ks = quantize_kv_rows(k)
    v8, vs = quantize_kv_rows(x[:, H + KVH :])
    return q, (k8, ks, v8, vs)


def flash_decode_attention_q8_fused_plain(
    qkv, k8, k_scale, v8, v_scale, cos_il, sin_il, layer, pos, n_heads: int
) -> torch.Tensor:
    """K9's arithmetic in plain PyTorch: RoPE and quantization in float32,
    append, attend keys 0..pos_b. Returns (B, H, hs) in qkv's dtype."""
    layer = int(layer)
    q, rows = rope_quantize_plain(qkv, cos_il, sin_il, n_heads)
    append_rows(k8, k_scale, v8, v_scale, rows, layer, pos)
    out = _attend_plain(q[:, None], k8[layer], k_scale[layer], v8[layer], v_scale[layer],
                        pos.long()[:, None], 1.0 / qkv.shape[-1] ** 0.5)
    return out[:, 0].to(qkv.dtype)


def flash_decode_attention_q8_fused(
    qkv, k8, k_scale, v8, v_scale, cos_il, sin_il, layer, pos, *, n_heads: int
) -> torch.Tensor:
    """Glue-fused T = 1 attention over the int8 cache: RoPE (q and k), the
    float32 quantization of the K and V rows, the in-place append and the read,
    in one launch on the QKV projection's raw output.

    qkv (B, H + 2*KVH, hs) pre-RoPE, float32 or bf16; caches as
    :func:`flash_decode_attention_q8_stacked`'s, updated IN PLACE;
    cos_il/sin_il (B, hs) float32, each pair's value on both of its elements;
    ``pos`` an int32 (B,) tensor. Returns att (B, H, hs) in qkv's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``flash_decode_attention_q8_fused.launches``) or raise.
    """
    layer = int(layer)
    if qkv.ndim != 3:
        raise ValueError(f"want qkv (B,H+2*KVH,hs); got {tuple(qkv.shape)}")
    B, rows, hs = qkv.shape
    H = int(n_heads)
    KVH = _check_stacked(B, H, hs, k8, k_scale, v8, v_scale, layer, pos)
    if rows != H + 2 * KVH:
        raise ValueError(f"qkv rows {rows} != n_heads {H} + 2*KVH {2 * KVH}")
    for name, t in (("cos_il", cos_il), ("sin_il", sin_il)):
        if tuple(t.shape) != (B, hs) or t.dtype != torch.float32:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: want float32 {(B, hs)}")
    if qkv.device.type == "cpu":
        return flash_decode_attention_q8_fused_plain(
            qkv, k8, k_scale, v8, v_scale, cos_il, sin_il, layer, pos, H
        )
    out = torch.empty((B, H, hs), dtype=qkv.dtype, device=qkv.device)
    _launch(flash_decode_attention_q8_fused, "fused", qkv=qkv, caches=(k8, k_scale, v8, v_scale),
            pos=pos, out=out, L=k8.shape[0], layer=layer, T=1, H=H, rope=(cos_il, sin_il))
    return out


flash_decode_attention_q8_fused.launches = 0


def splits(B: int, KVH: int, n_rg: int, S: int, blocks: int) -> int:
    """Splits of the key range: enough work items for ``blocks`` blocks, each
    split at least 4 chunks of keys at full context, at most MAX_SPLITS."""
    items = B * KVH * n_rg
    return max(1, min(-(-S // (4 * KEYS_PER_CHUNK)), -(-blocks // items), MAX_SPLITS))


def n_row_groups(rows: int) -> int:
    return -(-rows // ROWS_PER_ITEM)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(which, mode, *, caches, pos, out, L, layer, T, H, q=None, qkv=None, news=None, rope=None):
    """Check the operands of a CUDA launch, launch, count it."""
    k8, ks, v8, vs = caches
    act = q if q is not None else qkv
    if act.device.type != "cuda":
        raise ValueError(f"unsupported device {act.device}")
    if act.dtype not in build.DTYPE_CODES:
        raise ValueError(f"dtype {act.dtype}: want one of f32, bf16")
    operands = [act, k8, ks, v8, vs, pos, out, *(news or ()), *(rope or ())]
    if any(t.device != act.device for t in operands):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("operands must be contiguous")
    hs, KVH, S = k8.shape[-1], k8.shape[-3], k8.shape[-2]
    B = pos.shape[0]
    align = 16 if hs % 16 == 0 else 2
    if any(t.data_ptr() % align for t in (k8, v8, *(news[::2] if news else ()))):
        raise ValueError(f"int8 rows must be {align}-byte aligned")
    n_rg = n_row_groups(T * (H // KVH))
    if B * KVH * n_rg > build.MAX_TICKETS:
        raise ValueError(f"{B * KVH * n_rg} (b, kv head, row group) triples: more than {build.MAX_TICKETS}")
    device = act.device
    # four blocks an SM are resident (registers), and each hides the others'
    # load latency
    nsplit = splits(B, KVH, n_rg, S, 4 * _sms(device.index if device.index is not None
                                              else torch.cuda.current_device()))
    ws_floats = B * KVH * n_rg * nsplit * ROWS_PER_ITEM * (hs + 2)
    ws, tickets = build.workspace(device, ws_floats)

    def ptr(t):
        return None if t is None else t.data_ptr()

    k_new, ks_new, v_new, vs_new = news or (None,) * 4
    cos_il, sin_il = rope or (None, None)
    err = _entry()(
        _MODES[mode], ptr(q), ptr(qkv), ptr(cos_il), ptr(sin_il), k8.data_ptr(), ks.data_ptr(),
        v8.data_ptr(), vs.data_ptr(), ptr(k_new), ptr(ks_new), ptr(v_new), ptr(vs_new),
        pos.data_ptr(), out.data_ptr(), ws.data_ptr(), tickets.data_ptr(), ws.numel(),
        tickets.numel(), build.DTYPE_CODES[act.dtype], layer, L, B, T, H, KVH, S, hs, nsplit,
        1.0 / hs**0.5, torch.cuda.current_stream(device).cuda_stream,
    )
    build.check(err, which.__name__)
    which.launches += 1


@functools.cache
def _entry():
    fn = build.load_library(_LIB).attention_q8
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i] + [p] * 16 + [ctypes.c_longlong] + [i] * 11 + [ctypes.c_float, p]
    fn.restype = i
    return fn
