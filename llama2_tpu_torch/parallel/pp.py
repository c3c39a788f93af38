"""Pipeline parallelism: the layer stack cut over a ``stage`` axis.

Counterpart of ``llama2_tpu/parallel/pp.py``. For a layer stack that does
not fit one card, stage ``s`` of a ``(stage,)`` mesh (:func:`make_stage_mesh`)
holds layers ``[s * L/S, (s + 1) * L/S)`` of it and nothing else of it
(``sp.rank_params``), and M microbatches flow through the stages
GPipe-style:

    step t (0 <= t < M + S - 1): stage s runs microbatch t - s (when valid)
    through its layers, then hands its activation to stage s + 1 by one
    point-to-point hop (``parallel/collective_matmul.py``'s ``Hop`` over
    the stage group; staged through the host on gloo with the activation on
    the card, printed once).

Every rank issues the same hops in the same order, bubble steps included, so
that the ranks stay in step; the last step's hop moves nothing that is read
and is not issued. A microbatch is an independent ``(B, T)`` prefill from
position 0, so attention is the segment's own dense causal attention
(``ring.dense_causal_attention``), and the KV segments stay cut over stages
like the weights, the layout the pipelined decode reads. With
``model_axis`` on a ``(stage, model)`` mesh (:func:`make_pp_tp_mesh`) each
stage's layers are also cut Megatron-style, one float32 all-reduce after wo
and one after w2.

Decode pipelines too (:func:`pp_decode`): M = S microbatch groups rotate
through the stages, the KV cache cut over stages with the weights, the last
stage's greedy token sent round the wrap hop as the next token's embedding.

The fp path, as in the JAX package (fp weights, plain PyTorch on the mesh's
device, no kernel of ``ops/cuda``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from llama2_tpu_torch.ops import ref, sampling
from llama2_tpu_torch.parallel.collective_matmul import Hop
from llama2_tpu_torch.parallel.mesh import STAGE_AXIS, make_pp_tp_mesh, make_stage_mesh
from llama2_tpu_torch.parallel.ring import dense_causal_attention
from llama2_tpu_torch.parallel.sp import model_axis_size, rank_params
from llama2_tpu_torch.parallel.tp import add_reduced

__all__ = ["STAGE_AXIS", "make_stage_mesh", "make_pp_tp_mesh", "pp_prefill", "pp_decode"]


def _stage_layers(config, mesh) -> slice:
    """This stage's layers; the JAX ``ValueError`` where the stages do not
    divide them."""
    S, L = mesh.shape[STAGE_AXIS], config.n_layers
    if L % S != 0:
        raise ValueError(f"n_layers={L} not divisible by {S} stages")
    my = mesh.index(STAGE_AXIS)
    return slice(my * L // S, (my + 1) * L // S)


def _replicate_from_last(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` as the last stage holds it, on every stage of the group."""
    group = mesh.group(STAGE_AXIS)
    if group is not None:
        dist.broadcast(t, src=dist.get_global_rank(group, mesh.shape[STAGE_AXIS] - 1), group=group)
    return t


def _local_layers(x, params: dict, cos, sin, config, model_group):
    """This stage's layers over a ``(B, T, D)`` segment from position 0;
    returns the hidden and the layers' KV ``(L/S, B, KVH_local, T, hs)``."""
    B, T, _ = x.shape
    hs = config.head_size
    H_l = params["wq"].shape[-1] // hs
    KVH_l = params["wk"].shape[-1] // hs
    ks, vs = [], []
    for i in range(params["wq"].shape[0]):
        xb = ref.rmsnorm(x, params["rms_att"][i], config.norm_eps)
        q = ref.apply_rope((xb @ params["wq"][i]).reshape(B, T, H_l, hs), cos, sin)
        k = ref.apply_rope((xb @ params["wk"][i]).reshape(B, T, KVH_l, hs), cos, sin)
        v = (xb @ params["wv"][i]).reshape(B, T, KVH_l, hs)
        att = dense_causal_attention(q, k, v, scale=1.0 / hs**0.5)
        x = add_reduced(x, att.reshape(B, T, H_l * hs) @ params["wo"][i], model_group)
        xb = ref.rmsnorm(x, params["rms_ffn"][i], config.norm_eps)
        x = add_reduced(x, ref.swiglu(xb @ params["w1"][i], xb @ params["w3"][i]) @ params["w2"][i], model_group)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    return x, torch.stack(ks), torch.stack(vs)


def pp_prefill(params: dict, tokens, config, mesh, model_axis: bool = False):
    """Pipelined prefill of M independent ``(B, T)`` segments from position 0.

    ``params``: the whole tree (the stage keeps its layers, cut over
    ``model`` with ``model_axis``); ``tokens``: ``(M, B, T)``, the whole on
    every rank. Returns ``(hidden, k_seg, v_seg)``: hidden ``(M, B, T, D)``
    final-rmsnormed, equal on every stage; the KV segments of this stage's
    layers, ``(L/S, M, B, KVH_local, T, hs)``. The stages must divide the
    layers; the model axis, with ``model_axis``, the head counts."""
    layers = _stage_layers(config, mesh)
    tp = model_axis_size(config, mesh, model_axis)
    S, my = mesh.shape[STAGE_AXIS], mesh.index(STAGE_AXIS)
    local = rank_params(params, mesh, model_axis, layers)
    model_group = mesh.model_group if tp > 1 else None
    dev = mesh.device
    tokens = torch.as_tensor(tokens).to(dev, torch.int64)
    M, B, T = tokens.shape
    hs = config.head_size
    cos, sin = ref.rope_angles(torch.arange(T, device=dev, dtype=torch.int32), hs)
    KVH_l = local["wk"].shape[-1] // hs
    L_l = layers.stop - layers.start
    hidden = torch.zeros((M, B, T, config.dim), dtype=torch.float32, device=dev)
    k_out = torch.zeros((L_l, M, B, KVH_l, T, hs), dtype=torch.float32, device=dev)
    v_out = torch.zeros_like(k_out)
    hop = Hop(mesh.group(STAGE_AXIS), dev)
    x_recv = torch.zeros((B, T, config.dim), dtype=torch.float32, device=dev)
    n = M + S - 1
    for t in range(n):
        mb = t - my  # the microbatch this stage runs at step t
        h = x_recv  # a bubble runs nothing: what it hands on is never read
        if 0 <= mb < M:
            x_in = local["tok_emb"][tokens[mb]] if my == 0 else x_recv
            h, k_out[:, mb], v_out[:, mb] = _local_layers(x_in, local, cos, sin, config, model_group)
            if my == S - 1:
                hidden[mb] = h
        if t < n - 1:
            x_recv = hop(h)
    hidden = _replicate_from_last(hidden, mesh)
    return ref.rmsnorm(hidden, local["rms_final"], config.norm_eps), k_out, v_out


def _decode_layers(x, params: dict, kc, vc, pos: torch.Tensor, config):
    """This stage's layers over one decode row a slot, ``x (B, 1, D)`` at
    the per-row positions ``pos (B,)``, appending into ``kc, vc (L/S, B,
    KVH, S_len, hs)`` in place."""
    B = x.shape[0]
    hs, H, KVH = config.head_size, config.n_heads, config.n_kv_heads
    cos, sin = ref.rope_angles(pos[:, None], hs)
    rows = torch.arange(B, device=x.device)
    for i in range(params["wq"].shape[0]):
        xb = ref.rmsnorm(x, params["rms_att"][i], config.norm_eps)
        q = ref.apply_rope((xb @ params["wq"][i]).reshape(B, 1, H, hs), cos, sin)
        k = ref.apply_rope((xb @ params["wk"][i]).reshape(B, 1, KVH, hs), cos, sin)
        v = (xb @ params["wv"][i]).reshape(B, 1, KVH, hs)
        kc[i][rows, :, pos] = k[:, 0]
        vc[i][rows, :, pos] = v[:, 0]
        att = ref.attention(q, kc[i], vc[i], pos, scale=1.0 / hs**0.5)
        x = x + att.reshape(B, 1, H * hs) @ params["wo"][i]
        xb = ref.rmsnorm(x, params["rms_ffn"][i], config.norm_eps)
        x = x + ref.swiglu(xb @ params["w1"][i], xb @ params["w3"][i]) @ params["w2"][i]
    return x


def pp_decode(params: dict, k_cache, v_cache, tokens0, pos0, n_steps: int, config, mesh):
    """Pipelined greedy decode of M = S microbatch groups.

    ``params``: the whole tree (the stage keeps its layers); ``k_cache,
    v_cache``: this stage's layers of the cache, ``(L/S, M, B, KVH, S_len,
    hs)`` (as :func:`pp_prefill` returns its segments, padded to the cache's
    length), written in place on the mesh's device; ``tokens0 (M, B)``: each
    slot's last token, not yet in the cache, at its position ``pos0 (M,
    B)``; the cache holds the positions before it.

    At step t stage s advances microbatch ``(t - s) mod S`` through its
    layers, S * n_steps + S - 1 steps in all; the last stage takes the
    float32 classifier's greedy token and sends its embedding round the wrap
    hop, and stage 0 primes the first S - 1 steps from ``tokens0``. Returns
    ``(tokens (M, B, n_steps), k_cache, v_cache)``, the tokens equal on
    every stage."""
    layers = _stage_layers(config, mesh)
    S, my = mesh.shape[STAGE_AXIS], mesh.index(STAGE_AXIS)
    tokens0 = torch.as_tensor(tokens0)
    M, B = tokens0.shape
    if M != S:
        raise ValueError(f"pp_decode rotates M == n_stages microbatches (got M={M}, S={S}); "
                         "group slots accordingly")
    L_l = layers.stop - layers.start
    if k_cache.shape[0] != L_l or v_cache.shape[0] != L_l:
        raise ValueError(f"the caches hold {k_cache.shape[0]} layers; stage {my} holds {L_l}")
    dev = mesh.device
    local = rank_params(params, mesh, False, layers)
    k_cache, v_cache = k_cache.to(dev), v_cache.to(dev)
    tokens0 = tokens0.to(dev, torch.int64)
    pos0 = np.asarray(pos0, dtype=np.int64)
    emb = local["tok_emb"]
    wcls = local.get("wcls", emb.T).float()
    out = torch.zeros((M, B, n_steps), dtype=torch.int32, device=dev)
    hop = Hop(mesh.group(STAGE_AXIS), dev)
    x_recv = emb[tokens0[0]]  # stage 0's first step: microbatch 0's seed token
    n = S * n_steps + S - 1
    for t in range(n):
        rel = t - my
        x_out = x_recv  # a bubble runs nothing: what it hands on is never read
        if 0 <= rel < S * n_steps:
            mb, rnd = rel % S, rel // S
            pos = torch.as_tensor(pos0[mb] + rnd, dtype=torch.int32, device=dev)
            h = _decode_layers(x_recv[:, None], local, k_cache[:, mb], v_cache[:, mb], pos, config)[:, 0]
            x_out = h
            if my == S - 1:  # the head, greedy, and the next token's embedding for the wrap hop
                logits = ref.rmsnorm(h, local["rms_final"], config.norm_eps).float() @ wcls
                tok = sampling.sample_argmax(logits)
                out[mb, :, rnd] = tok
                x_out = emb[tok.long()]
        if t < n - 1:
            x_recv = hop(x_out)
            if my == 0 and t + 1 < S:  # round 0's later microbatches: primed from their seed tokens
                x_recv = emb[tokens0[t + 1]]
    return _replicate_from_last(out, mesh), k_cache, v_cache
