"""The Llama-2 decoder over a parameter dict, in PyTorch.

Port of ``llama2_tpu/models/llama.py`` for fp32/bf16 and INT8 (Q8) weights
(the reference's ``transformer()``, main.zig:285-430). A whole segment of T
tokens runs per call: T > 1 is a prefill segment, T = 1 a decode step, and
causal masking makes segment processing the same math as the reference's
token-at-a-time loop up to reduction order. The layer loop is a Python loop
over the layer-stacked weights; quantized weights stay stacked and the
kernels index the layer themselves.

Cache layout: ``(n_layers, B, n_kv_heads, S, head_size)`` for K and V, with
no padding of the head dim. The cache is updated IN PLACE (a layer's plane
is a view): a prefill writes its rows before attention runs, and a decode
step's rows are appended inside the decode attention kernel.

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
  ``w13`` -> swiglu -> ``w2``. The JAX ``pallas``.
* ``cuda-accurate``: the same kernels with the accurate-mode dequant-matmul
  and no glue fusion (RoPE outside, the stacked decode kernel). The JAX
  ``pallas-accurate``.
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
) -> dict[str, torch.Tensor]:
    """Allocate the KV cache at full seq_len (main.zig:151-152), zeroed."""
    if kv_quant:
        raise NotImplementedError(
            "the int8 KV cache is not yet ported to the torch package"
        )
    shape = (config.n_layers, batch, config.n_kv_heads, config.seq_len, config.head_size)
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


def _layer(
    x, lp, k_cache, v_cache, pos: int, cos, sin, config: ModelConfig, backend: str,
    quant_idx=None,
):
    """One decoder layer over a (B, T, D) prefill segment starting at ``pos``.

    ``k_cache``/``v_cache`` are this layer's (B, KVH, S, hs) planes; the
    segment's rows are written into them before attention reads them.
    ``quant_idx``: the layer index when quantized weights arrive
    layer-STACKED, else None.
    """
    B, T, _ = x.shape
    H, hs = config.n_heads, config.head_size
    q, k, v = _qkv(x, lp, cos, sin, config, backend, quant_idx)
    k_cache[:, :, pos : pos + T] = k.transpose(1, 2)
    v_cache[:, :, pos : pos + T] = v.transpose(1, 2)
    attend = flash_prefill_attention if backend.startswith("cuda") else flash_prefill_attention_plain
    att = attend(q, k_cache, v_cache, pos).reshape(B, T, H * hs)
    x = x + linear(att, lp["wo"], backend, quant_idx)
    return _ffn(x, lp, config, backend, quant_idx)


def _layer_decode_stacked(
    x, lp, k_cache, v_cache, layer_idx: int, pos: torch.Tensor, cos, sin,
    config: ModelConfig, backend: str, quant_idx=None, cos_il=None, sin_il=None,
):
    """One decoder layer of the T=1 decode step over the LAYER-STACKED
    (L, B, KVH, S, hs) caches; ``pos`` is the int32 (B,) row positions. The
    step's K/V rows are appended by the attention kernel itself.

    ``cos_il``/``sin_il`` (B, hs), the step's pair-duplicated RoPE rows,
    enable the glue-fused block on the fast CUDA backend with a stacked
    quantized ``wqkv``: the rmsnorm rides the QKV launch and RoPE, append and
    attention are one launch on its raw output.
    """
    B, T, _ = x.shape
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
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
        att = flash_decode_attention_fused(
            qkv.reshape(B, H + 2 * KVH, hs), k_cache, v_cache, cos_il, sin_il,
            layer_idx, pos, n_heads=H,
        )
        return _post_attention(x, att.reshape(B, T, H * hs), lp, config, backend, quant_idx)

    q, k, v = _qkv(x, lp, cos, sin, config, backend, quant_idx)
    k_bh = k.transpose(1, 2).contiguous()  # (B, KVH, 1, hs)
    v_bh = v.transpose(1, 2).contiguous()
    attend = (
        flash_decode_attention_stacked
        if backend.startswith("cuda")
        else flash_decode_attention_stacked_plain
    )
    att = attend(q, k_cache, v_cache, k_bh, v_bh, layer_idx, pos)
    return _post_attention(x, att.reshape(B, T, H * hs), lp, config, backend, quant_idx)


def _decode_two_launch(x, params, cache, pos, cos_il, sin_il, config: ModelConfig):
    """All layers of a T=1 decode step at two launches a layer: the glue-fused
    attention on the layer's pre-RoPE QKV, then the megakernel that runs wo,
    the FFN block and the NEXT layer's rmsnorm-fused QKV. Layer 0's QKV is one
    dequant-matmul launch; the last layer takes the megakernel without the
    QKV phase, whose output nobody would read. ``x`` (B, 1, D); ``pos`` the
    int32 (B,) row positions."""
    B, T, D = x.shape
    L, H, KVH, hs = config.n_layers, config.n_heads, config.n_kv_heads, config.head_size
    eps = config.norm_eps
    tail = [params[k] for k in ("w1", "w3", "w2")]
    qkv = quant_matmul_stacked(x, params["wqkv"], 0, rms_w=params["rms_att"][0], eps=eps)
    for i in range(L):
        att = flash_decode_attention_fused(
            qkv.reshape(B, H + 2 * KVH, hs), cache["k"], cache["v"], cos_il, sin_il, i, pos,
            n_heads=H,
        ).reshape(B, T, D)
        if i < L - 1:
            x, qkv = layer_tail_qkv_stacked(
                att, x, params["wo"], params["rms_ffn"], *tail, params["rms_att"],
                params["wqkv"], i, eps,
            )
        else:
            x = attn_mlp_block_stacked(att, x, params["wo"], params["rms_ffn"][i], *tail, i, eps)
    return x


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
    ``cache`` in place and returns the hidden states (B, T, D), already
    final-rmsnormed; project with :func:`logits_from_hidden`.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    keys = layer_keys(params)
    # quantized weights stay layer-STACKED: the kernel indexes the layer
    stacked = {k for k in keys if isinstance(params[k], QuantTensor)}
    B, T = tokens.shape
    dev = tokens.device
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
        if (
            cos_il is not None
            and {"wqkv", "wo", "w1", "w3", "w2"} <= stacked
            and layer_tail_qkv_supported(*(params[k] for k in ("wo", "w1", "w3", "w2", "wqkv")))
        ):
            x = _decode_two_launch(x, params, cache, pvec, cos_il, sin_il, config)
        else:
            for i in range(config.n_layers):
                x = _layer_decode_stacked(
                    x, layer_params(i), cache["k"], cache["v"], i, pvec, cos, sin, config,
                    backend, i if stacked else None, cos_il, sin_il,
                )
    else:
        if pos_t is not None:
            raise ValueError("a prefill segment (T > 1) takes one int start position")
        for i in range(config.n_layers):
            x = _layer(
                x, layer_params(i), cache["k"][i], cache["v"][i], pos, cos, sin, config,
                backend, i if stacked else None,
            )
    return ref.rmsnorm(x, params["rms_final"], config.norm_eps)


def logits_from_hidden(params: dict, hidden: torch.Tensor, backend: str = "torch") -> torch.Tensor:
    """Classifier head: ``hidden @ wcls`` -> (..., vocab) float32 logits. A
    quantized classifier goes through ``backend``'s dequant-matmul."""
    return linear(hidden, params["wcls"], backend).float()
