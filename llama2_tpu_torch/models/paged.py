"""Decode forward step, and speculative window, over a paged KV cache.

Port of ``llama2_tpu/models/paged.py::paged_forward_step`` and
``paged_forward_window``. The step is the paged
counterpart of :func:`llama2_tpu_torch.models.llama.forward` for a T=1
decode step. K/V live in layer-stacked page pools ``(L, P, KVH, page, hs)``
(``runtime/paged_cache.py``) and each batch row reaches its positions
through an int32 page table; this step's row of each batch row is written
at ``(page_ids[b], row_ids[b])``, coordinates the engine computes on the host
from the row's position. The layer loop is a Python loop; the pools are
updated in place.

Routes, by backend and weights (as the JAX function's):

* ``cuda`` with stacked quantized ``wqkv``/``wo``/``w1``/``w3``/``w2`` that
  the wo/FFN/next-QKV megakernel takes (``layer_tail_qkv_supported``): two
  launches a layer, the glue-fused paged attention (K17 over an fp pool, K18
  over an int8 pool) and the megakernel (``models/llama.py::
  decode_two_launch``), plus one dequant-matmul launch for layer 0's QKV;
* ``cuda`` with a stacked quantized ``wqkv`` otherwise: the rmsnorm-fused
  QKV launch, the glue-fused paged attention, then ``_post_attention``;
* anything else (``cuda-accurate``, fp weights, ``torch``): projections,
  RoPE outside, then the stacked paged attention (K15 over an fp pool;
  ``quantize_kv_rows`` and K16 over an int8 pool) on ``cuda*``, or on
  ``torch`` the rows written in PyTorch and the gather-and-attend oracle
  (the JAX ``xla`` route).

Under a model ``group`` (a rank of the paged mesh path,
``parallel/dp_paged.py``) ``params``, the pools and ``config`` are the
rank's shards and local view: the 2-launch route is off (its megakernel
spans both row-parallel reduces, as in the JAX function), and a layer is K6
(``wqkv`` with the rmsnorm prologue), K17 or K18 at the rank's heads, then
``_post_attention`` with the group: ``wo`` without its residual and K10
with ``residual=False``, each followed by the group's all-reduce, or with
``ring`` the ring collective matmul's forms.

:func:`paged_forward_window` runs a (B, T) teacher-forced window (the paged
engine's speculative verify window): its write coordinates come from the
table on the device, the QKV projection is K6 with its rmsnorm prologue on
``cuda`` with a stacked quantized ``wqkv``, attention the gather-and-attend
oracle over the whole table, then the segment's wo and FFN projections
(``models/llama.py::_wo_ffn``): at B * T rows, each one launch of K6.
"""

from __future__ import annotations

import torch

from llama2_tpu_torch.config import ModelConfig
from llama2_tpu_torch.models.llama import (
    _post_attention,
    _qkv,
    _wo_ffn,
    activation_dtype,
    decode_two_launch,
    layer_keys,
)
from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda.attention_q8 import quantize_kv_rows
from llama2_tpu_torch.ops.cuda.mlp_block import layer_tail_qkv_supported
from llama2_tpu_torch.ops.cuda.paged_attention import (
    paged_attention_oracle,
    paged_decode_attention_fused,
    paged_decode_attention_q8_fused,
    paged_decode_attention_q8_stacked,
    paged_decode_attention_stacked,
    write_rows,
)
from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul_stacked
from llama2_tpu_torch.ops.linear import BACKENDS
from llama2_tpu_torch.quant.q8 import QuantTensor

_TAIL = ("wo", "w1", "w3", "w2", "wqkv")


def paged_forward_step(
    params: dict,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    tokens: torch.Tensor,
    pos: torch.Tensor,
    page_ids: torch.Tensor,
    row_ids: torch.Tensor,
    config: ModelConfig,
    backend: str = "torch",
    ks_pool: torch.Tensor | None = None,
    vs_pool: torch.Tensor | None = None,
    group=None,
    ring: bool = False,
):
    """One batched decode step over the page pools.

    k_pool/v_pool (L, P, KVH, page, hs), int8 with float32 scale pools
    ks_pool/vs_pool (L, P, KVH, page) for an int8 pool; table (B, max_pages),
    tokens, pos (the position of ``tokens``), page_ids and row_ids (where
    this step's rows go) int32 (B,) tensors on the pools' device. Writes the
    step's K/V rows of every layer in place and returns ``(hidden (B, 1, D),
    k_pool, v_pool)``, or ``(hidden, k_pool, ks_pool, v_pool, vs_pool)``
    for an int8 pool; ``hidden`` is final-rmsnormed (project it with
    ``logits_from_hidden``). ``group``/``ring``: a rank's reduces (see the
    module's docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    B = tokens.shape[0]
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
    keys = layer_keys(params)
    # quantized weights stay layer-STACKED: the kernels index the layer
    stacked = {k for k in keys if isinstance(params[k], QuantTensor)}
    kv_quant = ks_pool is not None
    pools = (k_pool, ks_pool, v_pool, vs_pool) if kv_quant else (k_pool, v_pool)
    x = params["tok_emb"][tokens.long()].to(activation_dtype(params))[:, None, :]  # (B, 1, D)
    cos, sin = ref.rope_angles(pos[:, None], hs)  # (B, 1, hs/2)

    # pair-duplicated step RoPE rows for the glue-fused attention, built once
    # per step: every layer shares the step's positions
    cos_il = sin_il = None
    if backend == "cuda" and stacked:
        cos_il = cos.reshape(B, hs // 2).repeat_interleave(2, dim=-1).contiguous()
        sin_il = sin.reshape(B, hs // 2).repeat_interleave(2, dim=-1).contiguous()

    def fused_attention(qkv3, i: int):
        if kv_quant:
            return paged_decode_attention_q8_fused(
                qkv3, *pools, table, cos_il, sin_il, page_ids, row_ids, i, pos, n_heads=H
            )[0]
        return paged_decode_attention_fused(
            qkv3, *pools, table, cos_il, sin_il, page_ids, row_ids, i, pos, n_heads=H
        )[0]

    if (
        cos_il is not None
        and group is None  # the tail megakernel spans both row-parallel reduces
        and set(_TAIL) <= stacked
        and layer_tail_qkv_supported(*(params[k] for k in _TAIL))
    ):
        x = decode_two_launch(x, params, fused_attention, config)
    else:
        for i in range(config.n_layers):
            lp = {k: params[k] if k in stacked else params[k][i] for k in keys}
            quant_idx = i if stacked else None
            x = _layer(x, lp, pools, table, pos, page_ids, row_ids, i, quant_idx, cos, sin,
                       fused_attention if cos_il is not None else None, config, backend, group, ring)
    x = ref.rmsnorm(x, params["rms_final"], config.norm_eps)
    return (x, *pools)


def _layer(x, lp, pools, table, pos, page_ids, row_ids, i: int, quant_idx, cos, sin,
           fused_attention, config: ModelConfig, backend: str, group=None, ring: bool = False):
    """One decoder layer of the step: the glue-fused attention block where a
    stacked quantized ``wqkv`` runs on the fast CUDA backend, else the
    composed block; then ``_post_attention``."""
    B = x.shape[0]
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
    if (
        fused_attention is not None
        and quant_idx is not None
        and isinstance(lp.get("wqkv"), QuantTensor)
        and lp["wqkv"].q.ndim == 3
    ):
        qkv = quant_matmul_stacked(
            x, lp["wqkv"], quant_idx, rms_w=lp["rms_att"], eps=config.norm_eps
        )  # (B, 1, (H + 2*KVH) * hs), pre-RoPE
        att = fused_attention(qkv.reshape(B, H + 2 * KVH, hs), i)
        return _post_attention(x, att.reshape(B, 1, H * hs), lp, config, backend, quant_idx, group, ring)

    q, k, v = _qkv(x, lp, cos, sin, config, backend, quant_idx)  # (B, 1, H|KVH, hs)
    k_bh = k.transpose(1, 2).contiguous()  # (B, KVH, 1, hs)
    v_bh = v.transpose(1, 2).contiguous()
    scale = 1.0 / hs**0.5
    if len(pools) == 4:
        k8, ksc = quantize_kv_rows(k_bh)  # (B, KVH, 1, hs), (B, KVH, 1)
        v8, vsc = quantize_kv_rows(v_bh)
        if backend.startswith("cuda"):
            att = paged_decode_attention_q8_stacked(
                q, *pools, table, k8, ksc, v8, vsc, page_ids, row_ids, i, pos
            )[0]
        else:
            rows = (k8[:, :, 0], ksc[:, :, 0], v8[:, :, 0], vsc[:, :, 0])
            write_rows(pools, rows, i, page_ids, row_ids)
            k_pool, ks_pool, v_pool, vs_pool = (p[i] for p in pools)
            att = paged_attention_oracle(q, k_pool, v_pool, table, pos, scale, ks_pool, vs_pool)
    elif backend.startswith("cuda"):
        att = paged_decode_attention_stacked(
            q, *pools, table, k_bh, v_bh, page_ids, row_ids, i, pos
        )[0]
    else:
        write_rows(pools, (k_bh[:, :, 0], v_bh[:, :, 0]), i, page_ids, row_ids)
        att = paged_attention_oracle(q, pools[0][i], pools[1][i], table, pos, scale)
    return _post_attention(x, att.reshape(B, 1, H * hs), lp, config, backend, quant_idx, group, ring)


def _write_window(pool, rows, layer: int, page_ids, row_ids) -> None:
    """Write a window's rows (B, KVH, T, ...) at per-(row, token) ``(page,
    row)`` coordinates (each (B, T)) of ``layer`` of the pool (L, P, KVH,
    page, ...), in place: one indexed write for the whole window, its
    addresses on the device. Only scratch-page addresses repeat (rows past
    ``seq_len``, inactive rows), and nothing reads those."""
    B, KVH, T = rows.shape[:3]
    flat = rows.transpose(1, 2).reshape(B * T, KVH, *rows.shape[3:])
    pool[layer][page_ids.reshape(-1), :, row_ids.reshape(-1)] = flat.to(pool.dtype)


def paged_forward_window(
    params: dict,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    seg: torch.Tensor,
    pos: torch.Tensor,
    config: ModelConfig,
    backend: str = "torch",
    ks_pool: torch.Tensor | None = None,
    vs_pool: torch.Tensor | None = None,
    group=None,
    ring: bool = False,
):
    """A (B, T) teacher-forced window over the page pools: every batch row
    runs the T tokens of ``seg`` at positions ``pos[b]..pos[b] + T - 1``,
    writing each row's K/V through its page table. The paged twin of the
    dense verify window (``models/llama.py::forward`` with per-row ``pos``).

    Write coordinates are computed on the device from ``table`` (B,
    max_pages): a window's position advance depends on the data, so the
    host cannot compute them as it does for the step; positions at or past
    ``seq_len`` go to the scratch page 0, never onto a committed row.
    The QKV projection on ``cuda`` with a stacked quantized ``wqkv`` is K6
    with the rmsnorm prologue, as the JAX ``fuse_glue``; the wo and FFN
    projections take the segment's route (``_wo_ffn``: K6 at B * T rows,
    never the decode megakernels, which run 8 rows a pass). Attention runs
    :func:`paged_attention_oracle` over the window with the mask per row (an
    int8 pool dequantized) and gathers every entry of the table, as the JAX
    oracle does: no host read, and each row's result does not depend on the
    positions of the rows batched with it.

    Returns ``(hidden (B, T, D), *pools)`` with :func:`paged_forward_step`'s
    pool arity; ``hidden`` is final-rmsnormed. ``group``/``ring``: a rank's
    reduces, as the step's."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    B, T = seg.shape
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
    ps = k_pool.shape[3]
    keys = layer_keys(params)
    stacked = {k for k in keys if isinstance(params[k], QuantTensor)}
    kv_quant = ks_pool is not None
    pools = (k_pool, ks_pool, v_pool, vs_pool) if kv_quant else (k_pool, v_pool)
    x = params["tok_emb"][seg.long()].to(activation_dtype(params))  # (B, T, D)
    positions = pos.long()[:, None] + torch.arange(T, device=seg.device)  # (B, T)
    cos, sin = ref.rope_angles(positions, hs)
    valid = positions < config.seq_len
    pidx = (positions // ps).clamp(max=table.shape[1] - 1)
    page_ids = torch.where(valid, table.long().gather(1, pidx), 0)
    row_ids = torch.where(valid, positions % ps, 0)
    scale = 1.0 / hs**0.5
    qd, kd = H * hs, KVH * hs
    n_pages = table.shape[1]
    for i in range(config.n_layers):
        lp = {k: params[k] if k in stacked else params[k][i] for k in keys}
        quant_idx = i if stacked else None
        if (
            backend == "cuda"
            and quant_idx is not None
            and isinstance(lp.get("wqkv"), QuantTensor)
            and lp["wqkv"].q.ndim == 3
        ):
            qkv = quant_matmul_stacked(x, lp["wqkv"], i, rms_w=lp["rms_att"], eps=config.norm_eps)
            q = ref.apply_rope(qkv[..., :qd].reshape(B, T, H, hs), cos, sin)
            k = ref.apply_rope(qkv[..., qd : qd + kd].reshape(B, T, KVH, hs), cos, sin)
            v = qkv[..., qd + kd :].reshape(B, T, KVH, hs)
        else:
            q, k, v = _qkv(x, lp, cos, sin, config, backend, quant_idx)
        k_bh, v_bh = k.transpose(1, 2), v.transpose(1, 2)  # (B, KVH, T, hs)
        if kv_quant:
            (k8, ksc), (v8, vsc) = quantize_kv_rows(k_bh), quantize_kv_rows(v_bh)
            for pool, new in zip(pools, (k8, ksc, v8, vsc)):
                _write_window(pool, new, i, page_ids, row_ids)
            att = paged_attention_oracle(q, k_pool[i], v_pool[i], table, pos, scale, ks_pool[i],
                                         vs_pool[i], n_pages=n_pages)
        else:
            _write_window(k_pool, k_bh, i, page_ids, row_ids)
            _write_window(v_pool, v_bh, i, page_ids, row_ids)
            att = paged_attention_oracle(q, k_pool[i], v_pool[i], table, pos, scale, n_pages=n_pages)
        x = _wo_ffn(x, att.reshape(B, T, H * hs), lp, config, backend, quant_idx, group, ring)
    x = ref.rmsnorm(x, params["rms_final"], config.norm_eps)
    return (x, *pools)
