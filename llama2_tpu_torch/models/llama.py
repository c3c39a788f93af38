"""The Llama-2 decoder over a parameter dict, in PyTorch.

Port of ``llama2_tpu/models/llama.py`` for fp32/bf16 weights (the
reference's ``transformer()``, main.zig:285-430). A whole segment of T tokens
runs per call: T > 1 is a prefill segment, T = 1 a decode step, and causal
masking makes segment processing the same math as the reference's
token-at-a-time loop up to reduction order. The layer loop is a Python loop
over the layer-stacked weights.

Cache layout: ``(n_layers, B, n_kv_heads, S, head_size)`` for K and V, with
no padding of the head dim. The cache is updated IN PLACE (a layer's plane
is a view): a prefill writes its rows before attention runs, and a decode
step's rows are appended inside the decode attention kernel.

``backend="cuda"`` sends attention through the hand-written kernels
(``ops/cuda``): flash prefill attention for T > 1, the stacked flash decode
kernel for T = 1. Their wrappers use the plain versions for CPU tensors.
``backend="torch"`` calls the plain versions directly, so the same model can
run both ways on the card for comparison.
"""

from __future__ import annotations

import torch

from llama2_tpu_torch.config import ModelConfig
from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.ops.cuda.attention import (
    flash_decode_attention_stacked,
    flash_decode_attention_stacked_plain,
)
from llama2_tpu_torch.ops.cuda.prefill_attention import (
    flash_prefill_attention,
    flash_prefill_attention_plain,
)
from llama2_tpu_torch.ops.linear import linear

BACKENDS = ("torch", "cuda")

_LAYER_KEYS = ("rms_att", "wq", "wk", "wv", "wo", "rms_ffn", "w1", "w2", "w3")


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
    """The per-layer param keys. Fused QKV / W1-W3 layouts belong to the
    quantized path, which is not ported yet."""
    if "wqkv" in params or "w13" in params:
        raise NotImplementedError(
            "fused wqkv/w13 params are not yet ported to the torch package"
        )
    return _LAYER_KEYS


def _qkv(x, lp, cos, sin, config: ModelConfig):
    """rmsnorm + Q/K/V projections + RoPE: (B, T, H|KVH, hs) each."""
    B, T, _ = x.shape
    H, KVH, hs = config.n_heads, config.n_kv_heads, config.head_size
    xb = ref.rmsnorm(x, lp["rms_att"], config.norm_eps)
    q = linear(xb, lp["wq"]).reshape(B, T, H, hs)
    k = linear(xb, lp["wk"]).reshape(B, T, KVH, hs)
    v = linear(xb, lp["wv"]).reshape(B, T, KVH, hs)
    return ref.apply_rope(q, cos, sin), ref.apply_rope(k, cos, sin), v


def _post_attention(x, att, lp, config: ModelConfig):
    """wo projection + residual, then the FFN block + residual."""
    x = x + linear(att, lp["wo"])
    xb = ref.rmsnorm(x, lp["rms_ffn"], config.norm_eps)
    h = ref.swiglu(linear(xb, lp["w1"]), linear(xb, lp["w3"]))
    return x + linear(h, lp["w2"])


def _layer(x, lp, k_cache, v_cache, pos: int, cos, sin, config: ModelConfig, backend: str):
    """One decoder layer over a (B, T, D) prefill segment starting at ``pos``.

    ``k_cache``/``v_cache`` are this layer's (B, KVH, S, hs) planes; the
    segment's rows are written into them before attention reads them.
    """
    B, T, _ = x.shape
    H, hs = config.n_heads, config.head_size
    q, k, v = _qkv(x, lp, cos, sin, config)
    k_cache[:, :, pos : pos + T] = k.transpose(1, 2)
    v_cache[:, :, pos : pos + T] = v.transpose(1, 2)
    attend = flash_prefill_attention if backend == "cuda" else flash_prefill_attention_plain
    att = attend(q, k_cache, v_cache, pos)
    return _post_attention(x, att.reshape(B, T, H * hs), lp, config)


def _layer_decode_stacked(
    x, lp, k_cache, v_cache, layer_idx: int, pos: torch.Tensor, cos, sin,
    config: ModelConfig, backend: str,
):
    """One decoder layer of the T=1 decode step over the LAYER-STACKED
    (L, B, KVH, S, hs) caches; ``pos`` is the int32 (B,) row positions. The
    step's K/V rows are appended by the attention kernel itself."""
    B, T, _ = x.shape
    H, hs = config.n_heads, config.head_size
    q, k, v = _qkv(x, lp, cos, sin, config)
    k_bh = k.transpose(1, 2).contiguous()  # (B, KVH, 1, hs)
    v_bh = v.transpose(1, 2).contiguous()
    attend = (
        flash_decode_attention_stacked
        if backend == "cuda"
        else flash_decode_attention_stacked_plain
    )
    att = attend(q, k_cache, v_cache, k_bh, v_bh, layer_idx, pos)
    return _post_attention(x, att.reshape(B, T, H * hs), lp, config)


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
    B, T = tokens.shape
    dev = tokens.device
    x = params["tok_emb"][tokens].to(params["wq"].dtype)  # (B, T, D)
    if isinstance(pos, torch.Tensor):
        pos_t = pos.to(device=dev, dtype=torch.int32)
        positions = pos_t.reshape(-1, 1) + torch.arange(T, device=dev, dtype=torch.int32)
    else:
        pos_t = None
        positions = torch.arange(pos, pos + T, device=dev, dtype=torch.int32)
    cos, sin = ref.rope_angles(positions, config.head_size)

    if T == 1:
        # decode: every row at its own position, caches stay layer-stacked
        if pos_t is None:
            pos_t = torch.full((B,), pos, dtype=torch.int32, device=dev)
        pvec = pos_t.reshape(-1).expand(B).contiguous()
        for i in range(config.n_layers):
            lp = {k: params[k][i] for k in keys}
            x = _layer_decode_stacked(
                x, lp, cache["k"], cache["v"], i, pvec, cos, sin, config, backend
            )
    else:
        if pos_t is not None:
            raise ValueError("a prefill segment (T > 1) takes one int start position")
        for i in range(config.n_layers):
            lp = {k: params[k][i] for k in keys}
            x = _layer(x, lp, cache["k"][i], cache["v"][i], pos, cos, sin, config, backend)
    return ref.rmsnorm(x, params["rms_final"], config.norm_eps)


def logits_from_hidden(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Classifier head: ``hidden @ wcls`` -> (..., vocab) float32 logits."""
    return linear(hidden, params["wcls"]).float()
