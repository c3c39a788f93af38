"""Sequence-parallel prefill: the whole decoder over a segment cut over ``seq``.

Counterpart of ``llama2_tpu/parallel/sp.py``. A prompt too long for one
card's activations is cut over the ``seq`` axis of a mesh
(:func:`make_seq_mesh`): every position-local op (norms, the QKV and FFN
products, RoPE, SwiGLU) runs on the rank that owns the position with no
communication, and attention runs as ``parallel/ring.py``'s ring, S - 1
hops a layer.

The weights are replicated over ``seq``. With ``model_axis`` on a ``(seq,
model)`` mesh (:func:`make_sp_tp_mesh`) they are cut Megatron-style as well
(wq, wk, wv, w1, w3 on out-features, wo and w2 on in-features), and one
float32 all-reduce over the model group follows wo and one w2
(``parallel/tp.py::add_reduced``); the ring moves activations only, so the
two axes compose. A rank holds only its own slices (:func:`rank_params`).
After the prefill, :func:`cache_from_segments` gathers the KV segments into
a dense cache (``models/llama.py::init_cache``) for a decode loop.

These families are the fp path of the JAX package (``ops/xla.py`` and
``einsum``): plain PyTorch (``ops/ref.py``, ``torch.matmul``) on the mesh's
device, fp32, no kernel of ``ops/cuda``.
"""

from __future__ import annotations

import numpy as np
import torch

from llama2_tpu_torch.ops import ref
from llama2_tpu_torch.parallel.mesh import MODEL_AXIS, SEQ_AXIS, make_seq_mesh, make_sp_tp_mesh
from llama2_tpu_torch.parallel.ring import ring_attention_local
from llama2_tpu_torch.parallel.tp import add_reduced, gather
from llama2_tpu_torch.quant.q8 import QuantTensor

__all__ = ["SEQ_AXIS", "make_seq_mesh", "make_sp_tp_mesh", "sp_prefill", "cache_from_segments", "rank_params"]

LAYER_KEYS = ("rms_att", "wq", "wk", "wv", "wo", "rms_ffn", "w1", "w2", "w3")
COLUMN = ("wq", "wk", "wv", "w1", "w3")  # (L, in, out): cut on out-features
ROW = ("wo", "w2")  # (L, in, out): cut on in-features


def _slice(v, idx):
    """``v[idx]`` as an array of its own: only the slice's bytes are copied
    (a numpy slice stays on the host until the move to the device)."""
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v[idx]))
    return v[idx].clone()


def rank_params(params: dict, mesh, model_axis: bool = True, layers: slice | None = None) -> dict:
    """This rank's fp32 weights on ``mesh.device`` from the whole tree
    ``params`` (numpy arrays or tensors, the layout of ``io/checkpoint.py``):
    the layer stack's ``layers`` (None: all), each cut over the model group
    with ``model_axis`` (column-parallel wq/wk/wv/w1/w3 on out-features,
    row-parallel wo/w2 on in-features), the rest replicated. Only the
    rank's slices are copied to the device. fp weights only: these families
    have no quantized path."""
    from llama2_tpu_torch.runtime.generator import prepare_params

    if any(isinstance(v, QuantTensor) for v in params.values()):
        raise ValueError("the seq and stage families run fp weights; these params are quantized")
    tp = mesh.tp if model_axis else 1
    t = mesh.index(MODEL_AXIS)
    out = {}
    for k, v in params.items():
        idx = [slice(None)] * np.ndim(v)
        if k in LAYER_KEYS and layers is not None:
            idx[0] = layers
        if tp > 1 and k in COLUMN + ROW:
            d = -1 if k in COLUMN else 1
            n = v.shape[d] // tp
            idx[d] = slice(t * n, (t + 1) * n)
        cut = any(i != slice(None) for i in idx)
        out[k] = _slice(v, tuple(idx)) if cut else v
    return prepare_params(out, torch.float32, "torch", mesh.device)


def model_axis_size(config, mesh, model_axis: bool) -> int:
    """The model group's size the weights are cut over (1 without
    ``model_axis``); the JAX ``ValueError`` where it does not divide the
    head counts."""
    if not model_axis:
        return 1
    tp = mesh.tp
    if config.n_kv_heads % tp or config.n_heads % tp:
        raise ValueError(f"model axis {tp} must divide n_heads/n_kv_heads")
    return tp


def _sp_forward_local(params: dict, tokens: torch.Tensor, config, mesh, t_local: int, model_group):
    """A rank's body: the whole layer stack over its chunk ``tokens (B,
    T/S)`` at its global positions, attention through the KV ring. Returns
    the final-rmsnormed hidden ``(B, T/S, D)`` and the chunk's KV rows
    ``(L, B, KVH_local, T/S, hs)``."""
    B, Tl = tokens.shape
    hs = config.head_size
    my = mesh.index(SEQ_AXIS)
    positions = my * t_local + torch.arange(t_local, device=tokens.device, dtype=torch.int32)
    cos, sin = ref.rope_angles(positions, hs)
    x = params["tok_emb"][tokens]
    H_l = params["wq"].shape[-1] // hs  # the local head counts, from the (possibly cut) weights
    KVH_l = params["wk"].shape[-1] // hs
    ks, vs = [], []
    for i in range(config.n_layers):
        xb = ref.rmsnorm(x, params["rms_att"][i], config.norm_eps)
        q = ref.apply_rope((xb @ params["wq"][i]).reshape(B, Tl, H_l, hs), cos, sin)
        k = ref.apply_rope((xb @ params["wk"][i]).reshape(B, Tl, KVH_l, hs), cos, sin)
        v = (xb @ params["wv"][i]).reshape(B, Tl, KVH_l, hs)
        att = ring_attention_local(q, k, v, mesh.group(SEQ_AXIS), 1.0 / hs**0.5, t_local)
        x = add_reduced(x, att.reshape(B, Tl, H_l * hs) @ params["wo"][i], model_group)
        xb = ref.rmsnorm(x, params["rms_ffn"][i], config.norm_eps)
        ffn = ref.swiglu(xb @ params["w1"][i], xb @ params["w3"][i]) @ params["w2"][i]
        x = add_reduced(x, ffn, model_group)
        ks.append(k.transpose(1, 2))  # the cache planes (B, KVH_local, T/S, hs)
        vs.append(v.transpose(1, 2))
    x = ref.rmsnorm(x, params["rms_final"], config.norm_eps)
    return x, torch.stack(ks), torch.stack(vs)


def sp_prefill(params: dict, tokens, config, mesh, model_axis: bool = False):
    """Run a ``(B, T)`` segment sequence-parallel from position 0.

    ``params``: the whole tree (the rank cuts its slices, :func:`rank_params`);
    ``tokens``: the whole segment on every rank, S (the ``seq`` size) must
    divide T. Returns the rank's ``(hidden, k_seg, v_seg)``: hidden ``(B,
    T/S, D)`` final-rmsnormed, its rows of the segment; the KV segments
    ``(L, B, KVH_local, T/S, hs)`` (kv heads cut over ``model`` with
    ``model_axis``). Numerics equal ``models/llama.py::forward`` up to the
    order of the sums.

    ``model_axis``: tensor parallelism over the mesh's ``model`` axis
    (:func:`make_sp_tp_mesh`), whose size must divide the head counts;
    without it the weights are replicated over ``model`` too."""
    tokens = torch.as_tensor(tokens)
    B, T = tokens.shape
    S = mesh.shape[SEQ_AXIS]
    if T % S != 0:
        raise ValueError(f"T={T} not divisible by seq shards {S}")
    tp = model_axis_size(config, mesh, model_axis)
    t_local = T // S
    my = mesh.index(SEQ_AXIS)
    local = rank_params(params, mesh, model_axis)
    chunk = tokens[:, my * t_local : (my + 1) * t_local].to(mesh.device, torch.int64)
    return _sp_forward_local(local, chunk, config, mesh, t_local, mesh.model_group if tp > 1 else None)


def cache_from_segments(cache: dict, k_seg: torch.Tensor, v_seg: torch.Tensor, mesh) -> dict:
    """Write the ranks' prefill KV segments into a dense cache at position 0.

    ``cache``: ``{"k", "v"}`` of ``models/llama.py::init_cache``'s layout
    ``(L, B, KVH, S, hs)``, whole; ``k_seg, v_seg``: this rank's segments as
    :func:`sp_prefill` returns them. The segments are gathered over ``seq``
    (and over ``model`` where their kv heads are cut) and written in place,
    in the cache's dtype. Returns ``cache``."""
    group = mesh.group(SEQ_AXIS)
    for name, seg in (("k", k_seg), ("v", v_seg)):
        whole = gather(seg, group, 3)
        if whole.shape[2] != cache[name].shape[2]:  # kv heads cut over model
            whole = gather(whole, mesh.model_group, 2)
        cache[name][:, :, :, : whole.shape[3]] = whole.to(cache[name].device, cache[name].dtype)
    return cache
