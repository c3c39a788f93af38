"""Ring attention: exact causal attention over a sequence-sharded segment.

Counterpart of ``llama2_tpu/parallel/ring.py``. A prefill segment of T
tokens is cut over the ``seq`` axis of S ranks; each rank holds the query,
key and value rows of its own T/S positions, and attention runs S steps of
online-softmax accumulation: at step s a rank combines its queries with the
KV chunk that started on rank ``(i - s) mod S``, then passes that chunk on
to its ring successor by one point-to-point hop
(``parallel/collective_matmul.py``'s ``Hop``; on gloo with the chunk on the
card the hop is staged through the host, printed once).

* Causality by construction: chunks from later ranks mask to ``NEG_INF``
  and the merge keeps the running max and denominator finite; the diagonal
  chunk takes the causal mask within itself; earlier chunks are attended
  whole.
* The statistics (running max, denominator, numerator) are float32 whatever
  the activations' dtype.
* A layer is S - 1 hops: the JAX scan's last ``ppermute`` moves a chunk
  nothing reads, and is not issued. :data:`hops` counts a process's hops
  (``collective_matmul.hops`` counts them too: it counts every hop of the
  process). The key and value chunks travel as one tensor.

The result equals dense masked attention up to the order of the sums.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from llama2_tpu_torch.parallel.collective_matmul import Hop
from llama2_tpu_torch.parallel.mesh import SEQ_AXIS

NEG_INF = -1e30
hops = 0  # the ring attention's hops this process made


def _chunk_attention_step(q, k, v, acc, row_max, row_sum, q_pos, k_pos, scale: float):
    """One online-softmax accumulation of a (query chunk, KV chunk) pair.

    q: (B, Tq, H, hs); k, v: (B, Tk, KVH, hs); acc: (B, Tq, H, hs) the
    running numerator; row_max, row_sum: (B, Tq, H) the running max and
    denominator, all float32. q_pos: (Tq,) and k_pos: (Tk,) the global
    positions. Returns the new ``(acc, row_max, row_sum)``."""
    B, Tq, H, hs = q.shape
    KVH = k.shape[2]
    group = H // KVH  # GQA: query head h reads kv head h // group
    qg = q.reshape(B, Tq, KVH, group, hs)
    scores = torch.einsum("bqkgh,bskh->bqkgs", qg, k).float() * scale  # (B, Tq, KVH, g, Tk)
    mask = (k_pos[None, :] <= q_pos[:, None])[None, :, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    new_max = torch.maximum(row_max, scores.amax(dim=-1).reshape(B, Tq, H))
    correction = torch.exp(row_max - new_max)  # the previous accumulator rescaled to the new max
    p = torch.exp(scores - new_max.reshape(B, Tq, KVH, group)[..., None])
    new_sum = row_sum * correction + p.sum(dim=-1).reshape(B, Tq, H)
    pv = torch.einsum("bqkgs,bskh->bqkgh", p.to(v.dtype), v).reshape(B, Tq, H, hs).float()
    return acc * correction[..., None] + pv, new_max, new_sum


def ring_attention_local(q, k, v, group, scale: float, t_local: int) -> torch.Tensor:
    """A rank's causal attention over the whole segment: its chunk's
    queries ``q (B, T/S, H, hs)`` against every rank's KV, its own ``k, v
    (B, T/S, KVH, hs)`` first, passed round the ``group``'s ring (None: one
    rank). Returns ``(B, T/S, H, hs)`` in q's dtype."""
    global hops
    B, Tl, H, hs = q.shape
    S = 1 if group is None else dist.get_world_size(group)
    my = 0 if group is None else dist.get_rank(group)
    dev = q.device
    q_pos = my * t_local + torch.arange(t_local, device=dev)
    acc = torch.zeros((B, Tl, H, hs), dtype=torch.float32, device=dev)
    row_max = torch.full((B, Tl, H), NEG_INF, dtype=torch.float32, device=dev)
    row_sum = torch.zeros((B, Tl, H), dtype=torch.float32, device=dev)
    hop = Hop(group, dev)
    kv = torch.stack([k, v])
    for s in range(S):
        src = (my - s) % S  # the rank this chunk started on
        k_pos = src * t_local + torch.arange(t_local, device=dev)
        acc, row_max, row_sum = _chunk_attention_step(q, kv[0], kv[1], acc, row_max, row_sum, q_pos, k_pos,
                                                      scale)
        if s < S - 1:
            hops += 1
            kv = hop(kv)
    # row_sum is never 0: every query attends at least to itself
    return (acc / row_sum[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, scale: float | None = None) -> torch.Tensor:
    """Exact causal attention over a segment cut over ``mesh``'s ``seq``
    axis, through the KV ring.

    q: (B, T, H, hs), k, v: (B, T, KVH, hs), the whole segment on every rank
    (any other axis replicates it). The rank takes its T/S rows and returns
    its rows of the output, ``(B, T/S, H, hs)``, on the mesh's device. S
    must divide T."""
    B, T, H, hs = q.shape
    S = mesh.shape[SEQ_AXIS]
    if T % S != 0:
        raise ValueError(f"T={T} not divisible by seq shards {S}")
    scale = scale if scale is not None else 1.0 / (hs**0.5)
    t_local = T // S
    rows = slice(mesh.index(SEQ_AXIS) * t_local, (mesh.index(SEQ_AXIS) + 1) * t_local)

    def mine(t):
        return torch.as_tensor(t)[:, rows].to(mesh.device)

    return ring_attention_local(mine(q), mine(k), mine(v), mesh.group(SEQ_AXIS), scale, t_local)


def dense_causal_attention(q, k, v, scale: float | None = None) -> torch.Tensor:
    """The oracle: dense masked attention over a whole ``(B, T, H, hs)``
    segment from position 0 (the pipeline's attention, and the tests')."""
    B, T, H, hs = q.shape
    KVH = k.shape[2]
    group = H // KVH
    scale = scale if scale is not None else 1.0 / (hs**0.5)
    qg = q.reshape(B, T, KVH, group, hs)
    scores = torch.einsum("bqkgh,bskh->bqkgs", qg, k) * scale
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, :] <= pos[:, None])[None, :, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bqkgs,bskh->bqkgh", p, v).reshape(B, T, H, hs)
