"""The paged engine over a ``(data, model)`` mesh: page pools cut both ways.

Counterpart of ``llama2_tpu/parallel/dp_paged.py``. With a replicated pool
every rank holds all pages, so paged KV memory does not scale with the
mesh. Here the pools shard both ways instead:

* the page axis over ``data``, with an allocator per data group: slots go
  to data groups in contiguous blocks of ``B/dp`` and a slot's pages come
  from its group's share, so the per-slot side of a tick is data-parallel;
  page ids are LOCAL, each group's ids 0 .. P/dp - 1, its page 0 its
  scratch page (the one-card engine's inactive-slot contract, per group);
* the kv-head axis over ``model``, as the dense cache's: each rank appends
  and attends its own heads with the one-card paged kernels at its shapes
  (K17/K18 at ``H/tp`` heads over a ``KVH/tp`` pool shard), and the tick's
  collectives are the model group's reduces of ``wo``/``w2`` (or the ring
  collective matmul's hops) and one all-gather of the vocab-sharded logits.

So each rank's pool is 1/(dp*tp) of the one-card pool at the same page
count. Where the JAX package runs four ``shard_map`` programs over the
mesh, every rank here runs rank-local functions on its own shards, and the
host scheduler (the same on every rank, for every data group) decides what
they do:

* :func:`tick` and :func:`window`: the rank's slots of a decode step or a
  speculative window through ``models/paged.py`` with the local config and
  the model group; the classifier is ``logits_from_hidden(mesh=)`` (K5 on
  the rank's vocab slice, then the model group's all-gather, whose rule,
  the JAX ``_gather_logits``, is ``parallel/tp.py::vocab_split``), and the
  sampled tokens are all-gathered over ``data`` by the engine;
* :func:`stage_write`: an admission's prefill runs in every data group (the
  B = 1 staging plane replicates over ``data``); only the group that owns
  the slot writes the staged rows into its pages, a branch on the host
  where the JAX program redirects the other groups' writes to their
  scratch pages;
* :func:`gather_prefix`: the owner gathers a prefix hit's local pages into
  its staging plane, and the plane reaches the other data groups of the
  same model index by a broadcast over the data group (the JAX
  psum-broadcast); rows past the prefix keep the plane's values.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from llama2_tpu_torch.models.paged import paged_forward_step, paged_forward_window
from llama2_tpu_torch.ops.cuda.attention_q8 import dequantize_kv, quantize_kv_rows
from llama2_tpu_torch.parallel.sharding import mesh_shape
from llama2_tpu_torch.runtime.paged_cache import write_pages


def dp_pool_supported(mesh, batch_size: int, n_pages: int, config=None, params=None,
                      backend: str = "torch") -> tuple[bool, str]:
    """Whether the paged engine shards its pools over ``mesh``, with the JAX
    reasons: ``dp > 1`` needs the batch and the pages to divide over the data
    groups (an allocator each); ``tp > 1`` needs the model to shard, by
    ``tp_cuda_supported`` on the CUDA backends and ``tp_ring_supported``
    (divisibility alone) on ``torch``. ``params`` is the whole UNFUSED tree
    as loaded, ``backend`` the one the engine runs."""
    if mesh is None:
        return False, "no mesh"
    sizes = mesh_shape(mesh)
    dp, tp = sizes["data"], sizes["model"]
    if dp <= 1 and tp <= 1:
        return False, "mesh is 1x1 (nothing to shard)"
    if dp > 1:
        if batch_size % dp:
            return False, f"batch_size={batch_size} not divisible by dp={dp}"
        if n_pages % dp:
            return False, f"n_pages={n_pages} not divisible by dp={dp}"
    if tp > 1:
        if config is None or params is None:
            return False, f"tp={tp}: eligibility needs config+params"
        from llama2_tpu_torch.parallel.tp import tp_cuda_supported, tp_ring_supported

        supported = tp_cuda_supported if backend.startswith("cuda") else tp_ring_supported
        ok, why = supported(params, config, mesh)
        if not ok:
            return False, f"tp={tp}: {why}"
    return True, ""


def tick(params: dict, pool, table, tokens, pos, page_ids, row_ids, config, backend: str,
         rows: slice = slice(None), group=None, ring: bool = False) -> torch.Tensor:
    """One decode step of the rank's slots ``rows`` over its pool shard
    (``runtime/paged_cache.py::PagePool``, local page ids): ``table`` (B,
    max_pages), ``tokens``, ``pos``, ``page_ids``, ``row_ids`` the whole
    batch's (B,) tensors, ``config`` the rank's local view, ``group`` the
    model group of the reduces (``ring``: the ring collective matmul's).
    Returns the rank's (rows, 1, D) hidden states."""
    return paged_forward_step(
        params, pool.k, pool.v, table[rows], tokens[rows], pos[rows], page_ids[rows], row_ids[rows], config,
        backend, pool.ks, pool.vs, group=group, ring=ring,
    )[0]


def window(params: dict, pool, table, seg, pos, config, backend: str, rows: slice = slice(None), group=None,
           ring: bool = False) -> torch.Tensor:
    """A speculative window (``seg`` (B, d) at ``pos`` (B,)) of the rank's
    slots ``rows`` over its pool shard, as :func:`tick`: the rank's (rows,
    d, D) hidden states."""
    return paged_forward_window(
        params, pool.k, pool.v, table[rows], seg[rows], pos[rows], config, backend, pool.ks, pool.vs,
        group=group, ring=ring,
    )[0]


def stage_write(pool, staging: dict, row0: int, bucket: int, pids, rids, own: bool = True) -> None:
    """Move the staging plane's rows ``row0 .. row0 + bucket - 1`` to
    ``(pids[r], rids[r])`` of the rank's pools (into an int8 pool quantized
    per (row, kv head) on the way: prefill itself stays fp), each rank its
    own kv heads. Only the data group that owns the slot writes (``own``):
    the others computed the same prefill and keep nothing of it."""
    if not own:
        return

    def rows_of(name):
        # (L, 1, KVH, rows, hs) -> (bucket, L, KVH, hs)
        return staging[name][:, 0, :, row0 : row0 + bucket].permute(2, 0, 1, 3)

    if pool.kv_quant:
        for name, p, sp in (("k", pool.k, pool.ks), ("v", pool.v, pool.vs)):
            q, scale = quantize_kv_rows(rows_of(name))
            write_pages(p, q, pids, rids)
            write_pages(sp, scale, pids, rids)
    else:
        write_pages(pool.k, rows_of("k"), pids, rids)
        write_pages(pool.v, rows_of("v"), pids, rids)


def gather_prefix(staging: dict, pool, hits: list[int], owner: int = 0, mesh=None) -> None:
    """Copy a prefix hit's cached pages ``hits`` (local ids of data group
    ``owner``) into the staging plane's first ``len(hits) * page`` rows
    (an int8 pool's dequantized: the values decode attention reads). Under
    a mesh with ``dp > 1`` the owner gathers and broadcasts the plane over
    its data group (in float32, exact for the bf16 plane), so that every
    data group prefills the suffix on the same prefix."""
    device = staging["k"].device
    n = len(hits) * pool.page_size
    L, _, KVH, _, hs = pool.k.shape
    spread = mesh is not None and mesh.dp > 1
    own = not spread or mesh.coord[0] == owner
    idx = torch.as_tensor(hits, device=device)
    for name, p, sp in (("k", pool.k, pool.ks), ("v", pool.v, pool.vs)):
        if own:
            g = p[:, idx]  # (L, n_hits, KVH, page, hs)
            if sp is not None:
                g = dequantize_kv(g, sp[:, idx])
            plane = g.transpose(1, 2).reshape(L, KVH, n, hs)
        else:
            plane = None
        if spread:
            plane = (plane.float().contiguous() if own
                     else torch.empty((L, KVH, n, hs), dtype=torch.float32, device=device))
            src = dist.get_global_rank(mesh.data_group, owner)
            dist.broadcast(plane, src=src, group=mesh.data_group)
        staging[name][:, 0, :, :n] = plane.to(staging[name].dtype)
