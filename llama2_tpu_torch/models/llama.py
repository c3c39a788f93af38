"""The Llama-2 decoder over a parameter dict, in PyTorch.

Port of ``llama2_tpu/models/llama.py`` for fp32/bf16 and INT8 (Q8) weights,
with an fp or an int8 KV cache (the reference's ``transformer()``,
main.zig:285-430). A whole segment of T
tokens runs per call: T > 1 is a prefill segment, T = 1 a decode step, and
causal masking makes segment processing the same math as the reference's
token-at-a-time loop up to reduction order. The layer loop is a Python loop
over the layer-stacked weights; quantized weights stay stacked and the
kernels index the layer themselves.

Cache layout: ``(n_layers, B, n_kv_heads, S, head_size)`` for K and V, with
no padding of the head dim. The cache is updated IN PLACE (a layer's plane
is a view): a prefill writes its rows before attention runs, and a decode
step's rows are appended inside the decode attention kernel. The int8 cache
(``init_cache(kv_quant=True)``) holds int8 rows and one float32 scale per
(position, kv head) row, ``k_scale``/``v_scale`` ``(n_layers, B, n_kv_heads,
S)``; rows are quantized as they are written (``quantize_kv_rows``).

Backends (``BACKENDS``):

* ``cuda``: the hand-written kernels (``ops/cuda``): flash prefill attention
  for T > 1, flash decode attention for T = 1, and for quantized weights the
  fast-mode dequant-matmul kernels. With quantized params fused for this
  backend (:func:`fuse_layer_params`: ``wqkv``, separate ``w1``/``w3``) a
  decode layer is TWO launches: the glue-fused attention (RoPE and append in
  the kernel) on the layer's pre-RoPE QKV, then one FFN megakernel
  (``ops/cuda/mlp_block.py``) for ``wo``, the FFN block and the NEXT layer's
  rmsnorm-fused QKV; layer 0's QKV is one dequant-matmul launch a step. With
  the ``w13`` layout a decode layer is the composed route: rmsnorm-fused
  ``wqkv`` -> glue-fused attention -> residual-fused ``wo`` -> rmsnorm ->
  ``w13`` -> swiglu -> ``w2``. The JAX ``pallas``. With the int8 cache, a
  segment of at most 16 tokens (a speculative verify window, a short prefill
  chunk) attends through the int8 window kernel and a longer one through the
  dequantized cache; a decode layer takes the int8 glue-fused attention in
  place of the fp one, and where ``layer_block_supported`` holds the whole
  layer is ONE launch (``ops/cuda/layer_block.py``), layer 0's QKV one
  dequant-matmul launch a step.
* ``cuda-accurate``: the same kernels with the accurate-mode dequant-matmul
  and no glue fusion (RoPE outside, the stacked decode kernel; with the int8
  cache the rows are quantized outside and the int8 stacked kernel appends
  them). The JAX ``pallas-accurate``.
* ``torch``: the plain versions, quantized weights dequantized beside
  ``torch.matmul``. The JAX ``xla``.

The kernel wrappers use their plain versions for CPU tensors.
"""

from __future__ import annotations

import torch

from llama2_tpu_torch.config import ModelConfig
from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda.attention import (
    flash_decode_attention_fused,
    flash_decode_attention_stacked,
    flash_decode_attention_stacked_plain,
)
from llama2_tpu_torch.ops.cuda.attention_q8 import (
    MAX_WINDOW,
    append_rows,
    dequantize_kv,
    flash_decode_attention_q8,
    flash_decode_attention_q8_fused,
    flash_decode_attention_q8_stacked,
    quantize_kv_rows,
)
from llama2_tpu_torch.ops.cuda.layer_block import layer_block_stacked, layer_block_supported
from llama2_tpu_torch.ops.cuda.mlp_block import (
    attn_mlp_block_stacked,
    attn_mlp_block_supported,
    layer_tail_qkv_stacked,
    layer_tail_qkv_supported,
    mlp_block_stacked,
    mlp_block_supported,
)
from llama2_tpu_torch.ops.cuda.prefill_attention import (
    flash_prefill_attention,
    flash_prefill_attention_plain,
)
from llama2_tpu_torch.ops.cuda.quant_matmul import quant_matmul_stacked
from llama2_tpu_torch.ops.linear import BACKENDS, linear
from llama2_tpu_torch.quant.q8 import QuantTensor


def init_cache(
    config: ModelConfig,
    batch: int = 1,
    dtype=torch.float32,
    device="cpu",
    kv_quant: bool = False,
    pad: int = 0,
) -> dict[str, torch.Tensor]:
    """Allocate the KV cache at full seq_len (main.zig:151-152), zeroed.

    ``kv_quant``: int8 K/V rows ``k``/``v`` plus float32 per-row scales
    ``k_scale``/``v_scale`` (n_layers, B, n_kv_heads, S), half the bytes of a
    bf16 cache. ``pad`` positions past seq_len give a speculative verify
    window that starts at the last position rows to write into."""
    shape = (config.n_layers, batch, config.n_kv_heads, config.seq_len + pad, config.head_size)
    if kv_quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def layer_keys(params: dict) -> tuple[str, ...]:
    """The per-layer param keys actually present (QKV and W1/W3 may each be
    fused or separate, see :func:`fuse_layer_params`)."""
    keys = ["rms_att"]
    keys += ["wqkv"] if "wqkv" in params else ["wq", "wk", "wv"]
    keys += ["wo", "rms_ffn"]
    keys += ["w13"] if "w13" in params else ["w1", "w3"]
    keys += ["w2"]
    return tuple(keys)


def use_mlp_block(params: dict, backend: str) -> bool:
    """Whether the decode FFN runs as one fused launch (``ops/cuda/mlp_block.py``)
    and not as w13 -> swiglu -> w2: the fast CUDA backend with separate
    layer-stacked quantized w1/w3 (the kernel streams each matrix by itself)."""
    return (
        backend == "cuda"
        and "w13" not in params
        and isinstance(params.get("w1"), QuantTensor)
        and mlp_block_supported(params["w1"], params["w3"], params["w2"])
    )


def fuse_layer_params(params: dict, backend: str = "cuda", shards: int = 1) -> dict:
    """Concatenate QKV (and, where the FFN megakernel will not take over,
    W1/W3) along out-features: wqkv (L, D, D+2*KV), w13 (L, D, 2*HD).

    The launch analog of the reference's ``matmul_fused`` (one read of x
    across co-located matvecs, main.zig:530-605): 7 weight-applying calls per
    layer become 4. Works for fp tensors and QuantTensors (values and scales
    concatenate; same K and group size by construction). Done once at engine
    init; checkpoints keep the 9-key layout. W1/W3 stay separate (the same
    tensors, no copy) when :func:`use_mlp_block` engages for ``backend``; any
    other backend, ``"torch"`` for one, gives the ``w13`` layout, on which
    ``backend="cuda"`` runs the composed route. Tensor-parallel shard-blocked
    layouts (``shards > 1``) are not ported.
    """
    if shards != 1:
        raise NotImplementedError("tensor-parallel layouts are not yet ported to the torch package")

    def cat(*ws):
        if isinstance(ws[0], QuantTensor):
            if len({w.group_size for w in ws}) != 1:
                raise ValueError("fused weights need one group size")
            return QuantTensor(
                q=torch.cat([w.q for w in ws], dim=-1),
                scale=torch.cat([w.scale for w in ws], dim=-1),
                group_size=ws[0].group_size,
            )
        return torch.cat(ws, dim=-1)

    out = {k: v for k, v in params.items() if k not in ("wq", "wk", "wv", "w1", "w3")}
    out["wqkv"] = cat(params["wq"], params["wk"], params["wv"])
    if use_mlp_block(params, backend):
        out["w1"], out["w3"] = params["w1"], params["w3"]
    else:
        out["w13"] = cat(params["w1"], params["w3"])
    return out


def _split_qkv(lp, xb, config: ModelConfig, backend: str, quant_idx):
    """Q/K/V projections of normed ``xb``: (B, T, H|KVH, hs) each, pre-RoPE."""
    B, T, _ = xb.shape
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
    if "wqkv" in lp:
        # fused QKV (the reference's matmul_fused(3, ...) analog): one launch
        qd, kv = H * hs, KVH * hs
        qkv = linear(xb, lp["wqkv"], backend, quant_idx)
        q, k, v = qkv[..., :qd], qkv[..., qd : qd + kv], qkv[..., qd + kv :]
    else:
        q = linear(xb, lp["wq"], backend, quant_idx)
        k = linear(xb, lp["wk"], backend, quant_idx)
        v = linear(xb, lp["wv"], backend, quant_idx)
    return q.reshape(B, T, H, hs), k.reshape(B, T, KVH, hs), v.reshape(B, T, KVH, hs)


def _qkv(x, lp, cos, sin, config: ModelConfig, backend: str, quant_idx):
    """rmsnorm + Q/K/V projections + RoPE: (B, T, H|KVH, hs) each."""
    xb = ref.rmsnorm(x, lp["rms_att"], config.norm_eps)
    q, k, v = _split_qkv(lp, xb, config, backend, quant_idx)
    return ref.apply_rope(q, cos, sin), ref.apply_rope(k, cos, sin), v


def _ffn(x, lp, config: ModelConfig, backend: str, quant_idx):
    """rmsnorm + gate/up + swiglu + down projection + residual."""
    xb = ref.rmsnorm(x, lp["rms_ffn"], config.norm_eps)
    if "w13" in lp:
        # fused gate+up (matmul_fused(2, {w1,w3}) analog, main.zig:405-408)
        h13 = linear(xb, lp["w13"], backend, quant_idx)
        HD = h13.shape[-1] // 2
        h1, h3 = h13[..., :HD], h13[..., HD:]
    else:
        h1 = linear(xb, lp["w1"], backend, quant_idx)
        h3 = linear(xb, lp["w3"], backend, quant_idx)
    return x + linear(ref.swiglu(h1, h3), lp["w2"], backend, quant_idx)


def _post_attention(x, att, lp, config: ModelConfig, backend: str, quant_idx):
    """The post-attention half of a decode layer: wo projection + residual,
    then the FFN block, by the fewest launches that take the weights: the
    wo + FFN megakernel (one); else wo, with its residual add in the launch's
    epilogue where ``wo`` is a stacked quantized weight on the fast CUDA
    backend, and the FFN megakernel (two); else wo and the composed rmsnorm /
    w13 / swiglu / w2."""
    wo = lp["wo"]
    mlp_block = quant_idx is not None and use_mlp_block(lp, backend)
    if mlp_block and attn_mlp_block_supported(wo, lp["w1"], lp["w3"], lp["w2"]):
        return attn_mlp_block_stacked(
            att, x, wo, lp["rms_ffn"], lp["w1"], lp["w3"], lp["w2"], quant_idx, config.norm_eps
        )
    if (
        backend == "cuda"
        and quant_idx is not None
        and isinstance(wo, QuantTensor)
        and wo.q.ndim == 3
    ):
        x = quant_matmul_stacked(att, wo, quant_idx, residual=x)
    else:
        x = x + linear(att, wo, backend, quant_idx)
    if mlp_block:
        return mlp_block_stacked(
            x, lp["rms_ffn"], lp["w1"], lp["w3"], lp["w2"], quant_idx, config.norm_eps
        )
    return _ffn(x, lp, config, backend, quant_idx)


def _dequant_attention(q, k8, ks, v8, vs, pos, n: int):
    """Attention over the dequantized int8 cache, keys 0..n-1 of the (B, KVH,
    S, hs) planes: the JAX package's route outside any kernel, in float32,
    the output cast to q's dtype. ``pos`` is the first query row's position."""
    hs = q.shape[-1]
    kd = dequantize_kv(k8[:, :, :n], ks[:, :, :n])
    vd = dequantize_kv(v8[:, :, :n], vs[:, :, :n])
    return ref.attention(q.float(), kd, vd, pos, scale=1.0 / hs**0.5).to(q.dtype)


def _layer(
    x, lp, k_cache, v_cache, pos: int, cos, sin, config: ModelConfig, backend: str,
    quant_idx=None, ks_cache=None, vs_cache=None,
):
    """One decoder layer over a (B, T, D) prefill segment starting at ``pos``.

    ``k_cache``/``v_cache`` are this layer's (B, KVH, S, hs) planes; the
    segment's rows are written into them before attention reads them.
    ``ks_cache``/``vs_cache``: the layer's (B, KVH, S) scales of an int8
    cache, whose rows are quantized as they are written.
    ``quant_idx``: the layer index when quantized weights arrive
    layer-STACKED, else None.
    """
    B, T, _ = x.shape
    H, hs = config.n_heads, config.head_size
    q, k, v = _qkv(x, lp, cos, sin, config, backend, quant_idx)
    if ks_cache is not None:
        k8, ksc = quantize_kv_rows(k.transpose(1, 2))  # (B, KVH, T, hs), (B, KVH, T)
        v8, vsc = quantize_kv_rows(v.transpose(1, 2))
        k_cache[:, :, pos : pos + T] = k8
        ks_cache[:, :, pos : pos + T] = ksc
        v_cache[:, :, pos : pos + T] = v8
        vs_cache[:, :, pos : pos + T] = vsc
        if backend.startswith("cuda") and T <= MAX_WINDOW:
            # the window kernel takes the LAST query row's position
            att = flash_decode_attention_q8(q, k_cache, ks_cache, v_cache, vs_cache, pos + T - 1)
        else:
            att = _dequant_attention(q, k_cache, ks_cache, v_cache, vs_cache, pos, pos + T)
        att = att.reshape(B, T, H * hs)
        x = x + linear(att, lp["wo"], backend, quant_idx)
        return _ffn(x, lp, config, backend, quant_idx)
    k_cache[:, :, pos : pos + T] = k.transpose(1, 2)
    v_cache[:, :, pos : pos + T] = v.transpose(1, 2)
    attend = flash_prefill_attention if backend.startswith("cuda") else flash_prefill_attention_plain
    att = attend(q, k_cache, v_cache, pos).reshape(B, T, H * hs)
    x = x + linear(att, lp["wo"], backend, quant_idx)
    return _ffn(x, lp, config, backend, quant_idx)


def _fused_attention(qkv3, cache: dict, cos_il, sin_il, layer_idx: int, pos, n_heads: int):
    """The glue-fused decode attention on raw QKV rows: int8 (K9) or fp (K4),
    by the cache."""
    if "k_scale" in cache:
        return flash_decode_attention_q8_fused(
            qkv3, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], cos_il, sin_il,
            layer_idx, pos, n_heads=n_heads,
        )
    return flash_decode_attention_fused(
        qkv3, cache["k"], cache["v"], cos_il, sin_il, layer_idx, pos, n_heads=n_heads
    )


def _layer_decode_stacked(
    x, lp, cache: dict, layer_idx: int, pos: torch.Tensor, cos, sin,
    config: ModelConfig, backend: str, quant_idx=None, cos_il=None, sin_il=None,
):
    """One decoder layer of the T=1 decode step over the LAYER-STACKED
    (L, B, KVH, S, hs) caches of ``cache``; ``pos`` is the int32 (B,) row
    positions. The step's K/V rows are appended by the attention kernel
    itself (with the int8 cache, quantized outside it by
    ``quantize_kv_rows``; on ``backend="torch"`` written here, then the
    layer's cache dequantized).

    ``cos_il``/``sin_il`` (B, hs), the step's pair-duplicated RoPE rows,
    enable the glue-fused block on the fast CUDA backend with a stacked
    quantized ``wqkv``: the rmsnorm rides the QKV launch and RoPE, the int8
    quantization, append and attention are one launch on its raw output.
    """
    B, T, _ = x.shape
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
    kv_quant = "k_scale" in cache
    fuse_glue = (
        backend == "cuda"
        and quant_idx is not None
        and isinstance(lp.get("wqkv"), QuantTensor)
        and lp["wqkv"].q.ndim == 3
    )
    if fuse_glue and cos_il is not None:
        qkv = quant_matmul_stacked(
            x, lp["wqkv"], quant_idx, rms_w=lp["rms_att"], eps=config.norm_eps
        )  # (B, 1, (H + 2*KVH) * hs), pre-RoPE
        att = _fused_attention(
            qkv.reshape(B, H + 2 * KVH, hs), cache, cos_il, sin_il, layer_idx, pos, H
        )
        return _post_attention(x, att.reshape(B, T, H * hs), lp, config, backend, quant_idx)

    q, k, v = _qkv(x, lp, cos, sin, config, backend, quant_idx)
    k_bh = k.transpose(1, 2).contiguous()  # (B, KVH, 1, hs)
    v_bh = v.transpose(1, 2).contiguous()
    if kv_quant:
        rows = (*quantize_kv_rows(k_bh), *quantize_kv_rows(v_bh))  # k8, ks, v8, vs
        caches = (cache["k"], cache["k_scale"], cache["v"], cache["v_scale"])
        if backend.startswith("cuda"):
            att = flash_decode_attention_q8_stacked(q, *caches, *rows, layer_idx, pos)
        else:
            append_rows(*caches, tuple(t[:, :, 0] for t in rows), layer_idx, pos)
            att = _dequant_attention(q, *(c[layer_idx] for c in caches), pos, int(pos.max()) + 1)
        return _post_attention(x, att.reshape(B, T, H * hs), lp, config, backend, quant_idx)
    attend = (
        flash_decode_attention_stacked
        if backend.startswith("cuda")
        else flash_decode_attention_stacked_plain
    )
    att = attend(q, cache["k"], cache["v"], k_bh, v_bh, layer_idx, pos)
    return _post_attention(x, att.reshape(B, T, H * hs), lp, config, backend, quant_idx)


def _decode_two_launch(x, params, cache, pos, cos_il, sin_il, config: ModelConfig):
    """All layers of a T=1 decode step at two launches a layer: the glue-fused
    attention (int8 or fp, by the cache) on the layer's pre-RoPE QKV, then the
    megakernel that runs wo, the FFN block and the NEXT layer's rmsnorm-fused
    QKV. Layer 0's QKV is one dequant-matmul launch; the last layer takes the
    megakernel without the QKV phase, whose output nobody would read. ``x``
    (B, 1, D); ``pos`` the int32 (B,) row positions."""
    B, T, D = x.shape
    L, H, KVH, hs = config.n_layers, config.n_heads, config.n_kv_heads, config.head_size
    eps = config.norm_eps
    tail = [params[k] for k in ("w1", "w3", "w2")]
    qkv = quant_matmul_stacked(x, params["wqkv"], 0, rms_w=params["rms_att"][0], eps=eps)
    for i in range(L):
        att = _fused_attention(
            qkv.reshape(B, H + 2 * KVH, hs), cache, cos_il, sin_il, i, pos, H
        ).reshape(B, T, D)
        if i < L - 1:
            x, qkv = layer_tail_qkv_stacked(
                att, x, params["wo"], params["rms_ffn"], *tail, params["rms_att"],
                params["wqkv"], i, eps,
            )
        else:
            x = attn_mlp_block_stacked(att, x, params["wo"], params["rms_ffn"][i], *tail, i, eps)
    return x


def _decode_layer_block(x, params, cache, pos, cos_il, sin_il, config: ModelConfig):
    """All layers of a T=1 decode step over the int8 cache at ONE launch a
    layer (``layer_block_stacked``: attention, wo, the FFN block and the next
    layer's QKV), plus one dequant-matmul launch for layer 0's QKV; the last
    layer runs without the QKV phase. ``x`` (B, 1, D); ``pos`` the int32
    (B,) row positions."""
    B, T, D = x.shape
    L, H, KVH, hs = config.n_layers, config.n_heads, config.n_kv_heads, config.head_size
    eps = config.norm_eps
    weights = [params[k] for k in ("wo", "rms_ffn", "w1", "w3", "w2", "rms_att", "wqkv")]
    caches = (cache["k"], cache["k_scale"], cache["v"], cache["v_scale"])
    qkv = quant_matmul_stacked(x, params["wqkv"], 0, rms_w=params["rms_att"][0], eps=eps)
    x2 = x.reshape(B, D)
    for i in range(L):
        x2, qkv = layer_block_stacked(
            qkv.reshape(B, H + 2 * KVH, hs), x2, *caches, cos_il, sin_il, *weights, i, pos,
            n_heads=H, eps=eps, with_qkv=i < L - 1,
        )
    return x2.reshape(B, T, D)


def activation_dtype(params: dict) -> torch.dtype:
    """The dtype activations run in: the fp weights', or with quantized
    weights (whose scales stay float32) the norm weights'."""
    w = params.get("wq", params.get("wqkv"))
    return params["rms_final"].dtype if isinstance(w, QuantTensor) else w.dtype


def forward(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,
    pos,
    config: ModelConfig,
    backend: str = "cuda",
) -> torch.Tensor:
    """Run T tokens at positions ``pos..pos+T-1`` through all layers.

    tokens: (B, T) integer tensor. ``pos`` is an int, or for a decode step
    (T = 1) also a per-row (B,) tensor. Writes the segment's K/V rows into
    ``cache`` (fp or int8, see :func:`init_cache`) in place and returns the
    hidden states (B, T, D), already final-rmsnormed; project with
    :func:`logits_from_hidden`.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    keys = layer_keys(params)
    # quantized weights stay layer-STACKED: the kernel indexes the layer
    stacked = {k for k in keys if isinstance(params[k], QuantTensor)}
    B, T = tokens.shape
    dev = tokens.device
    kv_quant = "k_scale" in cache
    x = params["tok_emb"][tokens].to(activation_dtype(params))  # (B, T, D)
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(device=dev, dtype=torch.int32)
        positions = pos_t.reshape(-1, 1) + torch.arange(T, device=dev, dtype=torch.int32)
    else:
        pos_t = None
        positions = torch.arange(pos, pos + T, device=dev, dtype=torch.int32)
    cos, sin = ref.rope_angles(positions, config.head_size)

    def layer_params(i: int) -> dict:
        return {k: params[k] if k in stacked else params[k][i] for k in keys}

    if T == 1:
        # decode: every row at its own position, caches stay layer-stacked
        if pos_t is None:
            pos_t = torch.full((B,), pos, dtype=torch.int32, device=dev)
        pvec = pos_t.reshape(-1).expand(B).contiguous()
        # pair-duplicated step RoPE rows for the glue-fused attention kernel,
        # built once per step: every layer shares the step's positions
        cos_il = sin_il = None
        if backend == "cuda" and stacked:
            hs = config.head_size
            cos_il = cos.reshape(-1, hs // 2).repeat_interleave(2, dim=-1).expand(B, hs).contiguous()
            sin_il = sin.reshape(-1, hs // 2).repeat_interleave(2, dim=-1).expand(B, hs).contiguous()
        tail = ("wo", "w1", "w3", "w2", "wqkv")
        if (
            cos_il is not None
            and set(tail) <= stacked
            and layer_tail_qkv_supported(*(params[k] for k in tail))
        ):
            # one launch a layer over the int8 cache where the whole-layer
            # kernel takes the weights; else two
            if kv_quant and layer_block_supported(*(params[k] for k in tail), config):
                x = _decode_layer_block(x, params, cache, pvec, cos_il, sin_il, config)
            else:
                x = _decode_two_launch(x, params, cache, pvec, cos_il, sin_il, config)
        else:
            for i in range(config.n_layers):
                x = _layer_decode_stacked(
                    x, layer_params(i), cache, i, pvec, cos, sin, config,
                    backend, i if stacked else None, cos_il, sin_il,
                )
    else:
        if pos_t is not None:
            raise ValueError("a prefill segment (T > 1) takes one int start position")
        for i in range(config.n_layers):
            scales = (cache["k_scale"][i], cache["v_scale"][i]) if kv_quant else (None, None)
            x = _layer(
                x, layer_params(i), cache["k"][i], cache["v"][i], pos, cos, sin, config,
                backend, i if stacked else None, *scales,
            )
    return ref.rmsnorm(x, params["rms_final"], config.norm_eps)


def logits_from_hidden(params: dict, hidden: torch.Tensor, backend: str = "torch") -> torch.Tensor:
    """Classifier head: ``hidden @ wcls`` -> (..., vocab) float32 logits. A
    quantized classifier goes through ``backend``'s dequant-matmul."""
    return linear(hidden, params["wcls"], backend).float()
