"""The overlapped ring collective matmul: row-parallel linears whose reduce
is a ring of point-to-point hops.

Counterpart of ``llama2_tpu/parallel/collective_matmul.py``. The psum form
of a row-parallel ``wo``/``w2`` (``parallel/tp.py::add_reduced``) computes
the rank's whole partial product, then all-reduces it: the reduce waits for
the product. Here the reduce is a ring reduce-scatter fused with the
product, column chunk by column chunk, and every hop has a chunk product
issued beside it that does not depend on it:

    step t on rank i:   hop:  send acc to i + 1, receive from i - 1   (issued)
                        part = y @ w_local[:, chunk (i - 1 - t) % tp]  (independent)
                        wait for the hop; acc = received + part

The accumulator bound for rank ``d`` starts at rank ``(d + 1) % tp`` and
travels forward, each rank adding its partial of out-chunk ``d``; after
``tp - 1`` hops it lands on ``d`` with every rank's contribution. A ring
all-gather (``tp - 1`` more hops) then rebuilds the whole output on every
rank. The products are the psum form's, cut by columns; only the reduction
is restructured. On NCCL a hop is a ``batch_isend_irecv`` that runs while
the chunk product runs.

Accumulation: the partial chunks are summed in float32 across the hops, and
:func:`ring_linear_local` returns the float32 sum; the caller adds its
residual in float32 and rounds once to the activation dtype, as
``add_reduced``'s float32 reduce does. So the ring and the psum forms
differ only in the order of the sum.

Gloo (ranks sharing one card): gloo's point-to-point takes host memory only,
so where the model group's backend is gloo and the chunk lies on the card,
each hop is staged through a host copy of the chunk. The choice follows the
backend the rank's group was made with (``distributed.backend_rule``) and is
printed once; it is never found by catching an error.

``hops`` counts the hops a rank made (two rings of ``tp - 1`` a row-parallel
linear).
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from llama2_tpu_torch.quant.q8 import QuantTensor, dequantize

hops = 0  # the point-to-point hops this process made, summed over its rings
_said: set = set()  # the staging rules already printed


def _staged(group, device: torch.device) -> bool:
    """Whether a hop of a tensor on ``device`` over ``group`` goes through a
    host copy: a chunk on the card over a gloo group. Printed once."""
    staged = device.type == "cuda" and dist.get_backend(group) == "gloo"
    if staged and group not in _said:
        _said.add(group)
        print("[ring] gloo: hops staged through the host", file=sys.stderr, flush=True)
    return staged


class _Ring:
    """A rank's place in the model group's ring: its index and the global
    ranks of its neighbours."""

    def __init__(self, group):
        ranks = dist.get_process_group_ranks(group)
        self.group = group
        self.tp = len(ranks)
        self.i = dist.get_rank(group)
        self.next = ranks[(self.i + 1) % self.tp]
        self.prev = ranks[(self.i - 1) % self.tp]

    def issue(self, t: torch.Tensor, staged: bool):
        """Start one hop of ``t``: sent to the next rank, the previous rank's
        received into a new buffer. Returns ``(works, buffer)``."""
        global hops
        hops += 1
        src = t.cpu() if staged else t.contiguous()
        buf = torch.empty_like(src)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, self.next, self.group),
            dist.P2POp(dist.irecv, buf, self.prev, self.group),
        ])
        return works, buf

    def done(self, pending, device: torch.device) -> torch.Tensor:
        """Wait for a hop; its received tensor on ``device``."""
        works, buf = pending
        for w in works:
            w.wait()
        return buf.to(device, non_blocking=False)


def _hop(ring: _Ring, t: torch.Tensor, staged: bool, overlap=None):
    """One hop of ``t`` over ``ring`` with ``overlap()`` (the chunk product,
    or None) computed while it is in flight: ``(received, overlap's
    value)``."""
    pending = ring.issue(t, staged)
    value = overlap() if overlap is not None else None
    return ring.done(pending, t.device), value


class Hop:
    """A group's ring as one call: ``hop(t)`` sends ``t`` to the next rank
    and returns the previous rank's (``t`` itself without a group), staged
    through the host where ``_staged`` says so; the hops of the ring
    attention (``parallel/ring.py``) and of the pipeline's stages
    (``parallel/pp.py``)."""

    def __init__(self, group, device: torch.device):
        self.ring = None if group is None else _Ring(group)
        self.staged = group is not None and _staged(group, device)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.ring is None else _hop(self.ring, t, self.staged)[0]


def ring_rs_matmul(y: torch.Tensor, w_local: torch.Tensor, group) -> torch.Tensor:
    """Row-parallel partial products and a ring reduce-scatter, overlapped.

    ``y (..., in/tp)`` is this rank's activation shard and ``w_local (in/tp,
    out)`` its weight shard (dense, ``y``'s dtype). Returns this rank's
    out-chunk ``(..., out/tp)``, summed over the model group in float32."""
    ring = _Ring(group)
    tp, i = ring.tp, ring.i
    chunk = w_local.shape[-1] // tp
    staged = _staged(group, y.device)

    def chunk_dot(d: int) -> torch.Tensor:
        return torch.matmul(y, w_local[:, d * chunk : (d + 1) * chunk]).float()

    acc = chunk_dot((i - 1) % tp)
    for t in range(1, tp):
        # the hop and the chunk product are independent: the overlap
        received, part = _hop(ring, acc, staged, lambda t=t: chunk_dot((i - 1 - t) % tp))
        acc = received + part
    return acc


def _ring_all_gather(chunk_i: torch.Tensor, group) -> torch.Tensor:
    """The whole out dim from the ranks' chunks (rank ``i`` holds chunk
    ``i``): ``tp - 1`` hops, the piece received at hop ``t`` being chunk
    ``(i - t) % tp``, placed at its offset."""
    ring = _Ring(group)
    tp, i = ring.tp, ring.i
    n = chunk_i.shape[-1]
    staged = _staged(group, chunk_i.device)
    out = torch.empty((*chunk_i.shape[:-1], n * tp), dtype=chunk_i.dtype, device=chunk_i.device)
    moving = chunk_i
    out[..., i * n : (i + 1) * n] = moving
    for t in range(1, tp):
        moving, _ = _hop(ring, moving, staged)
        src = (i - t) % tp
        out[..., src * n : (src + 1) * n] = moving
    return out


def _dense(w, dtype, layer=None) -> torch.Tensor:
    """``w`` (a layer-stacked one indexed by ``layer``) as a dense tensor of
    ``dtype``: a QuantTensor dequantized."""
    if isinstance(w, QuantTensor):
        if w.q.ndim == 3 and layer is not None:
            w = w[layer]
        return dequantize(w, dtype)
    if w.ndim == 3 and layer is not None:
        w = w[layer]
    return w.to(dtype)


def ring_linear_local(y: torch.Tensor, w, group, layer=None) -> torch.Tensor:
    """The row-parallel linear of a rank: ``y (..., in/tp)`` its feature
    shard (its heads' attention outputs, its hidden columns), ``w (in/tp,
    out)`` its in-sharded weight shard (a QuantTensor dequantized to
    ``y.dtype``; layer-stacked ones indexed by ``layer``). Returns the whole
    ``(..., out)`` summed over the model group, in float32: the ring
    reduce-scatter fused with the chunk products, then the ring all-gather.
    Without a group, or where ``out`` does not split into ``tp`` chunks,
    the plain product and all-reduce."""
    w = _dense(w, y.dtype, layer)
    tp = 1 if group is None else dist.get_world_size(group)
    if tp == 1:
        return torch.matmul(y, w).float()
    if w.shape[-1] % tp:
        # no even out-chunking: the plain all-reduce
        total = torch.matmul(y, w).float()
        dist.all_reduce(total, group=group)
        return total
    return _ring_all_gather(ring_rs_matmul(y, w, group), group)


def row_parallel_linear(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``x @ w`` with the whole ``w (in, out)`` given on every rank: the rank
    takes its in-feature slice of ``x`` and its row block of ``w`` and runs
    :func:`ring_linear_local` over the mesh's model group. Returns the whole
    product in ``x``'s dtype. Needs ``in`` and ``out`` to divide ``tp``."""
    tp = mesh.tp
    n_in, out = w.shape[-2], w.shape[-1]
    if tp == 1:
        return torch.matmul(x, w)
    if n_in % tp or out % tp:
        raise ValueError(f"({n_in}, {out}) not divisible by tp={tp}")
    c = n_in // tp
    t = mesh.coord[1]
    return ring_linear_local(x[..., t * c : (t + 1) * c], w[t * c : (t + 1) * c], mesh.model_group).to(x.dtype)
