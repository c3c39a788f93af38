"""Paged decode attention over page pools (kernels K14-K18).

The KV cache of the paged serving engine is a pool of fixed-size pages,
``(L, P, KVH, page, hs)`` for K and V (and, for an int8 pool, float32 scale
pools ``(L, P, KVH, page)``); batch row ``b`` reaches its positions through an
int32 page table ``(B, max_pages)``: row ``t`` lives at
``[layer, table[b, t // page], :, t % page]``. Each wrapper appends this
step's K/V row at ``(write_page[b], write_row[b])`` of ``layer``, in place,
then runs single-query attention over keys ``0..pos[b]`` through the table.

The wrappers launch the hand-written CUDA kernels of ``csrc/paged_attention.cu``,
which replace, in ``llama2_tpu/ops/pallas/paged_attention.py``:

* ``paged_decode_attention`` (K14): the read alone, over ONE layer's fp pools
  ``(P, KVH, page, hs)``, no append; table entries past ``pos[b] // page``
  are never read. No model path calls it; the kernel benchmarks do;
* ``paged_decode_attention_stacked`` (K15): roped ``q (B, H, hs)`` and rows
  ``k_new/v_new (B, KVH, 1, hs)`` in the pool dtype;
* ``paged_decode_attention_q8_stacked`` (K16): int8 pools; the rows already
  quantized (``quantize_kv_rows``), with their float32 scales;
* ``paged_decode_attention_fused`` (K17): the QKV projection's raw pre-RoPE
  rows ``(B, H + 2*KVH, hs)`` and the step's pair-duplicated cos/sin rows;
  RoPE on q and k in the kernel, the rotated K row rounded to the pool dtype
  before it is dotted, as K4;
* ``paged_decode_attention_q8_fused`` (K18): K17 over an int8 pool, with the
  float32 row quantization of K9 in the kernel.

The arithmetic is the dense kernels' (K2/K4 for fp pools, K8/K9 for int8
pools; see ``attention.py`` and ``attention_q8.py``); only where a key row
lives differs. K15, K17 and K14 run K2, K4 and K3's split form
(``attend_split`` of ``csrc/decode_attention.cuh``: a block per (b, query
head, split), 16-byte loads, the splits merged in one launch through
``build.workspace``; K14's block reads only, like K3's), launched as
:func:`fp_plan` says. K16 and K18 run the int8 split decode loop (``att_split`` of
``csrc/attention_q8.cuh``: a block per (b, kv head, group of query rows,
split), each warp on its own keys), launched as :func:`q8_plan` says. Each
returns ``(att, *pools)`` with the pools updated in place, the argument
order of the JAX functions minus ``scale`` and ``interpret``.

``*_plain`` are the same functions in plain PyTorch: the wrappers take them
for CPU tensors, and ``chip_smoke.py`` holds the kernels against them on the
card. Their shared reference is :func:`paged_attention_oracle`, the JAX
package's gather-and-attend oracle. On a CUDA tensor a wrapper launches its
kernel or raises. The limits are the port's own: an even ``hs <= 256``
(K14: any ``hs <= 256``), ``H % KVH == 0``, one query token; no TPU tiling
rule (``hs % 128``, ``page % 128`` for int8 pools) applies.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda import build
from llama2_tpu_torch.ops.cuda import attention as fa
from llama2_tpu_torch.ops.cuda.attention import pos_rows, rope_rows_plain
from llama2_tpu_torch.ops.cuda.attention_q8 import (  # noqa: F401 (the plan's constants, re-exported)
    Q8_BLOCKS_PER_SM,
    Q8_WARPS,
    _sms,
    dequantize_kv,
    q8_plan,
    rope_quantize_plain,
)

_LIB = "paged_attention"
_MODES = {"append": 1, "fused": 2}


def gather_pages(pool: torch.Tensor, table: torch.Tensor, n_pages: int) -> torch.Tensor:
    """The first ``n_pages`` pages of each batch row, through the table, as a
    dense cache: one layer's pool ``(P, KVH, page, ...)`` -> ``(B, KVH,
    n_pages * page, ...)``."""
    g = pool[table[:, :n_pages].long()]  # (B, n, KVH, page, ...)
    B, n, KVH, page = g.shape[:4]
    return g.transpose(1, 2).reshape(B, KVH, n * page, *g.shape[4:])


def _pages_read(pos: torch.Tensor, page: int) -> int:
    """Pages of the table the longest row reads (a host read of ``pos``)."""
    return int(pos.max()) // page + 1


def paged_attention_oracle(q, k_pool, v_pool, table, pos, scale=None, ks_pool=None, vs_pool=None):
    """Gather each row's pages into a dense cache, then masked attention
    (``ref.attention``) over keys 0..pos[b]. q (B, H, hs) or (B, 1, H, hs);
    one layer's pools (P, KVH, page, hs); returns q's shape. With the scale
    pools (P, KVH, page) of an int8 pool, the gathered rows are dequantized
    and the attention runs in float32, its output cast to q's dtype (the
    JAX package dequantizes the layer's pool before this oracle: the same
    values)."""
    q4 = q[:, None] if q.ndim == 3 else q
    n = _pages_read(pos, k_pool.shape[2])
    k, v = gather_pages(k_pool, table, n), gather_pages(v_pool, table, n)
    if ks_pool is not None:
        k = dequantize_kv(k, gather_pages(ks_pool, table, n))
        v = dequantize_kv(v, gather_pages(vs_pool, table, n))
        out = ref.attention(q4.float(), k, v, pos, scale=scale).to(q.dtype)
    else:
        out = ref.attention(q4, k, v, pos, scale=scale)
    return out[:, 0] if q.ndim == 3 else out


def _attend_pages_plain(q3, k_pool, v_pool, table, pos, scale: float) -> torch.Tensor:
    """The fp kernels' read in plain PyTorch: float32 attention of q3
    (B, H, hs), scaled before the dot, over keys 0..pos[b] of one layer's
    pools (P, KVH, page, hs) gathered through the table. Returns float32
    (B, H, hs)."""
    n = _pages_read(pos, k_pool.shape[2])
    return ref.attention(
        q3[:, None].float() * scale,
        gather_pages(k_pool, table, n).float(),
        gather_pages(v_pool, table, n).float(),
        pos,
        scale=1.0,
    )[:, 0]


def write_rows(pools, rows, layer: int, write_page, write_row) -> None:
    """Write each batch row's ``rows[i][b]`` (KVH, ...) at ``[layer,
    write_page[b], :, write_row[b]]`` of ``pools[i]``, in batch order (a later
    row wins an address two rows share, as the slots run in order in the JAX
    kernels' grid)."""
    for b, (pg, r) in enumerate(zip(write_page.tolist(), write_row.tolist())):
        for pool, new in zip(pools, rows):
            pool[layer, pg, :, r] = new[b]


def _attend_pages_q8_plain(q, k8, ks, v8, vs, table, pos, scale: float) -> torch.Tensor:
    """The int8 kernels' arithmetic (``attention_q8``'s) through the table,
    page by page in table order with an online softmax, as the Pallas
    kernels run it, so that every bf16 rounding of ``p * v_scale`` is taken
    against the same running maximum as there: q (B, H, hs); one layer's
    pools k8/v8 (P, KVH, page, hs) int8, ks/vs (P, KVH, page) float32.
    Returns float32 (B, H, hs). A row's pages past pos[b] // page are masked
    whole and leave its state unchanged, bit for bit."""
    B, H, hs = q.shape
    KVH, page = k8.shape[1], k8.shape[2]
    qb = q.to(torch.bfloat16).float().reshape(B, KVH, H // KVH, hs)
    m = torch.full((B, KVH, H // KVH, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, H // KVH, hs), device=q.device)
    for i in range(_pages_read(pos, page)):
        pg = table[:, i].long()
        s = torch.einsum("bkgd,bktd->bkgt", qb, k8[pg].float()) * (ks[pg][:, :, None] * scale)
        t = i * page + torch.arange(page, device=q.device)
        s = s.masked_fill(t[None, :] > pos.long()[:, None, None, None], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = (p * vs[pg][:, :, None]).to(torch.bfloat16).float()
        acc = acc * alpha + torch.einsum("bkgt,bktd->bkgd", pv, v8[pg].float())
        m = m_new
    return (acc / l).reshape(B, H, hs)


def _q3(q: torch.Tensor) -> torch.Tensor:
    if q.ndim == 4 and q.shape[1] != 1:
        raise ValueError("paged decode attention is single-query (T=1)")
    return q[:, 0] if q.ndim == 4 else q


def paged_decode_attention_stacked_plain(
    q, k_pool, v_pool, table, k_new, v_new, write_page, write_row, layer, pos
):
    """K15's arithmetic in plain PyTorch: write the rows, then float32
    attention with q scaled by 1/sqrt(hs) before the dot, through the table."""
    layer = int(layer)
    q3 = _q3(q)
    write_rows((k_pool, v_pool), (k_new[:, :, 0], v_new[:, :, 0]), layer, write_page, write_row)
    out = _attend_pages_plain(q3, k_pool[layer], v_pool[layer], table, pos, 1.0 / q3.shape[-1] ** 0.5)
    return out.to(q.dtype).reshape(q.shape), k_pool, v_pool


def paged_decode_attention_q8_stacked_plain(
    q, k_pool, ks_pool, v_pool, vs_pool, table, k_new, ks_new, v_new, vs_new, write_page,
    write_row, layer, pos,
):
    """K16's arithmetic in plain PyTorch: write the int8 rows and scales,
    then attend keys 0..pos[b] through the table (:func:`_attend_pages_q8_plain`)."""
    layer = int(layer)
    q3 = _q3(q)
    B, hs = q3.shape[0], q3.shape[-1]
    pools = (k_pool, ks_pool, v_pool, vs_pool)
    rows = (k_new.reshape(B, -1, hs), ks_new.reshape(B, -1), v_new.reshape(B, -1, hs), vs_new.reshape(B, -1))
    write_rows(pools, rows, layer, write_page, write_row)
    out = _attend_pages_q8_plain(q3, *(p[layer] for p in pools), table, pos, 1.0 / hs**0.5)
    return (out.to(q.dtype).reshape(q.shape), *pools)


def paged_decode_attention_fused_plain(
    qkv, k_pool, v_pool, table, cos_il, sin_il, write_page, write_row, layer, pos, n_heads: int
):
    """K17's arithmetic in plain PyTorch: RoPE as K4's (``rope_rows_plain``),
    write the rows, attend in float32. Returns att (B, H, hs) in qkv's dtype
    and the pools."""
    layer = int(layer)
    q, k, v = rope_rows_plain(qkv, cos_il, sin_il, n_heads, k_pool.dtype)
    write_rows((k_pool, v_pool), (k, v), layer, write_page, write_row)
    out = _attend_pages_plain(q, k_pool[layer], v_pool[layer], table, pos, 1.0 / qkv.shape[-1] ** 0.5)
    return out.to(qkv.dtype), k_pool, v_pool


def paged_decode_attention_q8_fused_plain(
    qkv, k_pool, ks_pool, v_pool, vs_pool, table, cos_il, sin_il, write_page, write_row, layer,
    pos, n_heads: int,
):
    """K18's arithmetic in plain PyTorch: RoPE and quantization in float32
    (``rope_quantize_plain``), write, attend keys 0..pos[b] through the table."""
    layer = int(layer)
    q, rows = rope_quantize_plain(qkv, cos_il, sin_il, n_heads)
    pools = (k_pool, ks_pool, v_pool, vs_pool)
    write_rows(pools, rows, layer, write_page, write_row)
    out = _attend_pages_q8_plain(q, *(p[layer] for p in pools), table, pos, 1.0 / qkv.shape[-1] ** 0.5)
    return (out.to(qkv.dtype), *pools)


def paged_decode_attention_plain(q, k_pool, v_pool, table, pos, *, scale=None) -> torch.Tensor:
    """K14's arithmetic in plain PyTorch: :func:`paged_attention_oracle`'s
    gather and attend, in float32 with q scaled before the dot, as the fp
    kernels compute it. Returns q's shape and dtype."""
    q3 = _q3(q)
    if scale is None:
        scale = 1.0 / q3.shape[-1] ** 0.5
    pos = pos_rows(pos, q3.shape[0], q.device)
    return _attend_pages_plain(q3, k_pool, v_pool, table, pos, scale).to(q.dtype).reshape(q.shape)


def paged_decode_attention(q, k_pool, v_pool, table, pos, *, scale=None) -> torch.Tensor:
    """Paged decode attention over one layer's fp pools, no append.

    q (B, 1, H, hs) or (B, H, hs); k_pool/v_pool (P, KVH, page, hs) in q's
    dtype, read only; table (B, max_pages) int32, the physical page of each
    row's logical page (entries past ``pos[b] // page`` are never read, and
    may name any page); ``pos`` (B,) int32 (or an int), 0 <= pos[b] <
    max_pages * page by the caller's contract; ``scale`` defaults to
    1/sqrt(hs). Returns q's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``paged_decode_attention.launches``) or raise.
    """
    q3 = _q3(q)
    if q3.ndim != 3 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError(f"want q (B,[1,]H,hs) and one layer's pools (P,KVH,page,hs) of one dtype; got "
                         f"{tuple(q.shape)}, {k_pool.dtype} {tuple(k_pool.shape)}, "
                         f"{v_pool.dtype} {tuple(v_pool.shape)}")
    B, H, hs = q3.shape
    P, KVH, page, hs_c = k_pool.shape
    if hs_c != hs or H % KVH != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match pools {tuple(k_pool.shape)}")
    if table.ndim != 2 or table.shape[0] != B or table.dtype != torch.int32:
        raise ValueError(f"table must be an int32 ({B}, max_pages) tensor, got {table.dtype} {tuple(table.shape)}")
    if scale is None:
        scale = 1.0 / hs**0.5
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, table, pos, scale=scale)
    posv = pos_rows(pos, B, q.device)
    if hs > 256:
        raise ValueError(f"kernel takes hs <= 256 (got {hs})")
    if k_pool.dtype != q.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype} differs from the query's {q.dtype}")
    _check_device(q3, (q3, k_pool, v_pool, table, posv))
    return _read_launch(q3, k_pool, v_pool, table, posv, float(scale)).view(q.shape)


def _read_launch(q3, k_pool, v_pool, table, pos, scale: float, splits: int | None = None):
    """K14's launch on operands the wrapper has checked (q3 (B, H, hs), one
    layer's pools, ``pos`` an int32 (B,) tensor): :func:`fp_plan`'s read
    form, or ``splits`` splits. Counts the launch."""
    B, H, hs = q3.shape
    P, KVH, page, _ = k_pool.shape
    index = q3.device.index if q3.device.index is not None else torch.cuda.current_device()
    p = fp_plan(q3, k_pool, v_pool, None, None, table, H, _sms(index), False, splits)
    out = torch.empty_like(q3)
    err = _entry_read()(
        q3.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        *fa.split_workspace(q3.device, p, B * H), build.DTYPE_CODES[q3.dtype], B, H, KVH, P, page,
        table.shape[1], hs, p["splits"], p["vec"], p["chunk"], scale,
        torch.cuda.current_stream(q3.device).cuda_stream,
    )
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _check(B: int, H: int, hs: int, k_pool, v_pool, table, write_page, write_row, layer: int, pos,
           scale_pools=None) -> int:
    """The shapes every paged wrapper takes; returns KVH."""
    if k_pool.ndim != 5 or k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError(f"want pools (L,P,KVH,page,hs) of one dtype; got {k_pool.dtype} "
                         f"{tuple(k_pool.shape)}, {v_pool.dtype} {tuple(v_pool.shape)}")
    L, P, KVH, page, hs_c = k_pool.shape
    if hs_c != hs:
        raise ValueError(f"rows of head size {hs} do not match pools {tuple(k_pool.shape)}")
    if hs > 256 or hs % 2 != 0 or H % KVH != 0:
        raise ValueError(f"kernel takes an even hs <= 256 and H % KVH == 0 (got hs={hs}, H={H}, KVH={KVH})")
    if scale_pools is not None:
        if k_pool.dtype != torch.int8:
            raise ValueError(f"an int8 pool takes int8 rows, got {k_pool.dtype}")
        for name, t in zip(("ks_pool", "vs_pool"), scale_pools):
            if tuple(t.shape) != (L, P, KVH, page) or t.dtype != torch.float32:
                raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: want float32 {(L, P, KVH, page)}")
    if table.ndim != 2 or table.shape[0] != B or table.dtype != torch.int32:
        raise ValueError(f"table must be an int32 ({B}, max_pages) tensor, got {table.dtype} {tuple(table.shape)}")
    for name, t in (("write_page", write_page), ("write_row", write_row), ("pos", pos)):
        if tuple(t.shape) != (B,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be an int32 ({B},) tensor, got {t.dtype} {tuple(t.shape)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside 0..{L - 1}")
    return KVH


def _check_device(act, operands) -> None:
    if act.device.type != "cuda":
        raise ValueError(f"unsupported device {act.device}")
    if act.dtype not in build.DTYPE_CODES:
        raise ValueError(f"dtype {act.dtype}: want one of f32, bf16")
    if any(t.device != act.device for t in operands):
        raise ValueError("all operands must be on one device")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("operands must be contiguous")


def fp_plan(act, k_pool, v_pool, kn, vn, table, H: int, sms: int, fused: bool,
            splits: int | None = None) -> dict:
    """The launch of K15 (``act`` the query, kn/vn the new rows), K17
    (``act`` the raw qkv rows, which are also its new rows) or K14 (``act``
    the query over one layer's pools, kn = vn = None: read only): K2/K4's
    :func:`attention.plan` at the table's reach, ``max_pages * page`` rows,
    from the shapes alone (never from ``pos``); 16-byte vectors where the
    pools and the new-row operands start 16-byte aligned, else one element a
    lane; K14 (read only) the pools alone. ``splits`` as
    :func:`attention.plan` takes it."""
    KVH, page, hs = k_pool.shape[-3:]
    operands = (k_pool, v_pool, act) if fused else (k_pool, v_pool) if kn is None else (k_pool, v_pool, kn, vn)
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    return fa.plan(act.shape[0], H, KVH, table.shape[1] * page, hs, act.dtype, sms, aligned, splits)


def _fp_launch(which, act, k_pool, v_pool, kn, vn, table, write_page, write_row, layer, pos, H: int,
               splits: int | None = None):
    """Launch K15 (kn/vn: the new rows) or K17 (kn/vn: cos_il/sin_il) on
    :func:`fp_plan`'s split form, or at ``splits`` splits, and count it."""
    if k_pool.dtype != act.dtype:
        raise ValueError(f"pool dtype {k_pool.dtype} differs from the activations' {act.dtype}")
    _check_device(act, (act, k_pool, v_pool, kn, vn, table, write_page, write_row, pos))
    fused = which is paged_decode_attention_fused
    L, P, KVH, page, hs = k_pool.shape
    B = act.shape[0]
    index = act.device.index if act.device.index is not None else torch.cuda.current_device()
    p = fp_plan(act, k_pool, v_pool, kn, vn, table, H, _sms(index), fused, splits)
    out = torch.empty((B, H, hs), dtype=act.dtype, device=act.device)
    err = _entry(which.__name__)(
        act.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        table.data_ptr(), write_page.data_ptr(), write_row.data_ptr(), pos.data_ptr(), out.data_ptr(),
        *fa.split_workspace(act.device, p, B * H), build.DTYPE_CODES[act.dtype],
        layer, B, H, KVH, P, page, table.shape[1], hs, p["splits"], p["vec"], p["chunk"], 1.0 / hs**0.5,
        torch.cuda.current_stream(act.device).cuda_stream,
    )
    build.check(err, which.__name__)
    which.launches += 1
    return out


def paged_decode_attention_stacked(
    q, k_pool, v_pool, table, k_new, v_new, write_page, write_row, layer, pos
):
    """Fused append + paged decode attention over layer-stacked fp pools.

    q (B, H, hs) or (B, 1, H, hs); pools (L, P, KVH, page, hs) in q's dtype,
    updated IN PLACE at ``[layer, write_page[b], :, write_row[b]]`` with
    k_new/v_new (B, KVH, 1, hs); table (B, max_pages) int32; write_page,
    write_row, pos int32 (B,) tensors on q's device (the caller keeps them in
    range: the kernel does not read them back to check). Returns
    ``(att shaped like q, k_pool, v_pool)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``paged_decode_attention_stacked.launches``) or raise.
    """
    layer = int(layer)
    q3 = _q3(q)
    B, H, hs = q3.shape
    KVH = _check(B, H, hs, k_pool, v_pool, table, write_page, write_row, layer, pos)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, KVH, 1, hs):
            raise ValueError(f"{name} {tuple(t.shape)}: want {(B, KVH, 1, hs)}")
    if q.device.type == "cpu":
        return paged_decode_attention_stacked_plain(
            q, k_pool, v_pool, table, k_new, v_new, write_page, write_row, layer, pos
        )
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError(f"new rows {k_new.dtype}, {v_new.dtype}: want {q.dtype}")
    out = _fp_launch(paged_decode_attention_stacked, q3, k_pool, v_pool, k_new, v_new, table, write_page,
                     write_row, layer, pos, H)
    return out.view(q.shape), k_pool, v_pool


paged_decode_attention_stacked.launches = 0


def _check_rope(B: int, hs: int, cos_il, sin_il) -> None:
    for name, t in (("cos_il", cos_il), ("sin_il", sin_il)):
        if tuple(t.shape) != (B, hs) or t.dtype != torch.float32:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: want float32 {(B, hs)}")


def _qkv_heads(qkv, n_heads: int, KVH: int) -> None:
    if qkv.shape[1] != n_heads + 2 * KVH:
        raise ValueError(f"qkv rows {qkv.shape[1]} != n_heads {n_heads} + 2*KVH {2 * KVH}")


def paged_decode_attention_fused(
    qkv, k_pool, v_pool, table, cos_il, sin_il, write_page, write_row, layer, pos, *, n_heads: int
):
    """Glue-fused fp paged decode attention: RoPE (q and k), the in-place row
    append at ``(write_page, write_row)`` and the read through the table in
    one launch on the QKV projection's raw output.

    qkv (B, H + 2*KVH, hs) pre-RoPE, in the pools' dtype; cos_il/sin_il
    (B, hs) float32, each pair's value on both of its elements; the rest as
    :func:`paged_decode_attention_stacked`'s. Returns ``(att (B, H, hs),
    k_pool, v_pool)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``paged_decode_attention_fused.launches``) or raise.
    """
    layer = int(layer)
    if qkv.ndim != 3:
        raise ValueError(f"want qkv (B,H+2*KVH,hs); got {tuple(qkv.shape)}")
    B, _, hs = qkv.shape
    H = int(n_heads)
    KVH = _check(B, H, hs, k_pool, v_pool, table, write_page, write_row, layer, pos)
    _qkv_heads(qkv, H, KVH)
    _check_rope(B, hs, cos_il, sin_il)
    if qkv.device.type == "cpu":
        return paged_decode_attention_fused_plain(
            qkv, k_pool, v_pool, table, cos_il, sin_il, write_page, write_row, layer, pos, H
        )
    out = _fp_launch(paged_decode_attention_fused, qkv, k_pool, v_pool, cos_il, sin_il, table, write_page,
                     write_row, layer, pos, H)
    return out, k_pool, v_pool


paged_decode_attention_fused.launches = 0


def _q8_launch(which, mode, act, pools, table, write_page, write_row, layer, pos, H: int,
               q=None, qkv=None, news=None, rope=None, splits: int | None = None):
    """Launch K16 or K18 (``q8_plan``'s split loop) and count it."""
    k8, ks, v8, vs = pools
    _check_device(act, (act, *pools, table, write_page, write_row, pos, *(news or ()), *(rope or ())))
    L, P, KVH, page, hs = k8.shape
    B = act.shape[0]
    if any(t.data_ptr() % 2 for t in (k8, v8)):
        raise ValueError("int8 pools must be 2-byte aligned")
    device = act.device
    max_pages = table.shape[1]
    index = device.index if device.index is not None else torch.cuda.current_device()
    aligned = all(t.data_ptr() % 16 == 0 for t in (k8, v8))
    p = q8_plan(B, H, KVH, max_pages * page, hs, _sms(index), aligned, splits)
    if p["tickets"] > build.MAX_TICKETS:
        raise ValueError(f"{p['tickets']} (b, kv head, row group) triples: more than {build.MAX_TICKETS}")
    ws, tickets = build.workspace(device, p["ws_floats"])
    out = torch.empty((B, H, hs), dtype=act.dtype, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    k_new, ks_new, v_new, vs_new = news or (None,) * 4
    cos_il, sin_il = rope or (None, None)
    err = _entry_q8()(
        _MODES[mode], ptr(q), ptr(qkv), ptr(cos_il), ptr(sin_il), k8.data_ptr(), ks.data_ptr(),
        v8.data_ptr(), vs.data_ptr(), ptr(k_new), ptr(ks_new), ptr(v_new), ptr(vs_new),
        table.data_ptr(), write_page.data_ptr(), write_row.data_ptr(), pos.data_ptr(), out.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(), ws.numel(), tickets.numel(), build.DTYPE_CODES[act.dtype],
        layer, L, B, H, KVH, P, page, max_pages, hs, p["splits"], p["nq"], p["vb"], p["chunk"],
        1.0 / hs**0.5, torch.cuda.current_stream(device).cuda_stream,
    )
    build.check(err, which.__name__)
    which.launches += 1
    return out


def paged_decode_attention_q8_stacked(
    q, k_pool, ks_pool, v_pool, vs_pool, table, k_new, ks_new, v_new, vs_new, write_page,
    write_row, layer, pos,
):
    """Fused append + paged decode attention over layer-stacked int8 pools.

    q (B, H, hs) or (B, 1, H, hs), f32 or bf16; k_pool/v_pool (L, P, KVH,
    page, hs) int8 and ks_pool/vs_pool (L, P, KVH, page) float32, updated IN
    PLACE at ``[layer, write_page[b], :, write_row[b]]`` with k_new/v_new
    (B, KVH, 1, hs) int8 and ks_new/vs_new (B, KVH, 1) float32; the rest as
    :func:`paged_decode_attention_stacked`'s. Returns ``(att shaped like q,
    k_pool, ks_pool, v_pool, vs_pool)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``paged_decode_attention_q8_stacked.launches``) or raise.
    """
    layer = int(layer)
    q3 = _q3(q)
    B, H, hs = q3.shape
    KVH = _check(B, H, hs, k_pool, v_pool, table, write_page, write_row, layer, pos,
                 scale_pools=(ks_pool, vs_pool))
    news = (k_new.reshape(B, -1, hs), ks_new.reshape(B, -1), v_new.reshape(B, -1, hs), vs_new.reshape(B, -1))
    for name, t, dt in zip(("k_new", "ks_new", "v_new", "vs_new"), news,
                           (torch.int8, torch.float32, torch.int8, torch.float32)):
        if t.shape[1] != KVH or t.dtype != dt:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: want {dt} with {KVH} kv heads")
    if q.device.type == "cpu":
        return paged_decode_attention_q8_stacked_plain(
            q, k_pool, ks_pool, v_pool, vs_pool, table, k_new, ks_new, v_new, vs_new, write_page,
            write_row, layer, pos,
        )
    pools = (k_pool, ks_pool, v_pool, vs_pool)
    out = _q8_launch(paged_decode_attention_q8_stacked, "append", q3, pools, table, write_page,
                     write_row, layer, pos, H, q=q3, news=tuple(t.contiguous() for t in news))
    return (out.view(q.shape), *pools)


paged_decode_attention_q8_stacked.launches = 0


def paged_decode_attention_q8_fused(
    qkv, k_pool, ks_pool, v_pool, vs_pool, table, cos_il, sin_il, write_page, write_row, layer,
    pos, *, n_heads: int,
):
    """Glue-fused int8 paged decode attention: RoPE (q and k), the float32
    quantization of the K and V rows, the in-place append at ``(write_page,
    write_row)`` and the read through the table, in one launch on the QKV
    projection's raw output.

    qkv (B, H + 2*KVH, hs) pre-RoPE, float32 or bf16; pools as
    :func:`paged_decode_attention_q8_stacked`'s; cos_il/sin_il (B, hs)
    float32. Returns ``(att (B, H, hs), k_pool, ks_pool, v_pool, vs_pool)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``paged_decode_attention_q8_fused.launches``) or raise.
    """
    layer = int(layer)
    if qkv.ndim != 3:
        raise ValueError(f"want qkv (B,H+2*KVH,hs); got {tuple(qkv.shape)}")
    B, _, hs = qkv.shape
    H = int(n_heads)
    KVH = _check(B, H, hs, k_pool, v_pool, table, write_page, write_row, layer, pos,
                 scale_pools=(ks_pool, vs_pool))
    _qkv_heads(qkv, H, KVH)
    _check_rope(B, hs, cos_il, sin_il)
    if qkv.device.type == "cpu":
        return paged_decode_attention_q8_fused_plain(
            qkv, k_pool, ks_pool, v_pool, vs_pool, table, cos_il, sin_il, write_page, write_row,
            layer, pos, H,
        )
    pools = (k_pool, ks_pool, v_pool, vs_pool)
    out = _q8_launch(paged_decode_attention_q8_fused, "fused", qkv, pools, table, write_page,
                     write_row, layer, pos, H, qkv=qkv, rope=(cos_il, sin_il))
    return (out, *pools)


paged_decode_attention_q8_fused.launches = 0


@functools.cache
def _entry(name: str):
    """K15's or K17's entry: 12 pointers, the workspace's size, 13 ints, the scale, the stream."""
    fn = getattr(build.load_library(_LIB), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 12 + [ctypes.c_longlong] + [i] * 13 + [ctypes.c_float, p]
    fn.restype = i
    return fn


@functools.cache
def _entry_read():
    """K14's entry: 8 pointers, the workspace's size, 12 ints, the scale, the stream."""
    fn = build.load_library(_LIB).paged_decode_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 8 + [ctypes.c_longlong] + [i] * 12 + [ctypes.c_float, p]
    fn.restype = i
    return fn


@functools.cache
def _entry_q8():
    fn = build.load_library(_LIB).paged_attention_q8
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i] + [p] * 19 + [ctypes.c_longlong] + [i] * 15 + [ctypes.c_float, p]
    fn.restype = i
    return fn
