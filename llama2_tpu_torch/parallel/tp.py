"""Tensor-parallel execution: each rank runs the single-card kernels on its
own shards.

Port of ``llama2_tpu/parallel/tp.py``. The JAX package runs the layer stack
inside ``shard_map``; here every rank is a process holding its shards
(:mod:`.sharding`) and runs ``models/llama.py``'s layer code on them, with
the row-parallel outputs all-reduced over the model group:

* ``wqkv``: each rank fuses its own wq/wk/wv slices, which is chunk ``t``
  of the JAX package's SHARD-BLOCKED ``wqkv`` (``fuse_layer_params``);
* w1/w3 column-parallel, wo/w2 row-parallel, scales sliced with their q;
* the KV cache: kv heads on ``model``, slots on ``data``;
* with ``collective="ring"`` the two reduces are the ring collective
  matmul's (:mod:`.collective_matmul`: wo and w2 dequantized and cut into
  column chunks beside the hops) and the FFN the composed one (K10 off);
* the rank's view is a SMALLER LLAMA (:func:`local_config`: ``dim``,
  ``hidden_dim`` and the head counts over tp; head size and the GQA ratio
  do not change), so the decode layer runs unchanged but for the two
  reduces: wo (K6 without its residual) then an all-reduce and the add,
  the FFN (K10 with ``residual=False``) then an all-reduce and the add.
  The megakernels that span both reduces (K11, K12, K13) are off.

A reduce sums the ranks' partial outputs in float32 and adds the residual
in float32, rounding once to the activation dtype, as the single-card
kernels' residual epilogue does.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist

from llama2_tpu_torch.parallel.sharding import LocalParams, mesh_shape
from llama2_tpu_torch.quant.q8 import QuantTensor


def local_config(config, tp: int):
    """The per-rank model view: a 1/tp-width llama with the same head size,
    GQA ratio, seq_len and vocabulary."""
    if tp == 1:
        return config
    return dataclasses.replace(
        config,
        dim=config.dim // tp,
        hidden_dim=config.hidden_dim // tp,
        n_heads=config.n_heads // tp,
        n_kv_heads=config.n_kv_heads // tp,
    )


def _divides(config, tp: int) -> tuple[bool, str]:
    if config.n_heads % tp:
        return False, f"tp={tp} does not divide n_heads={config.n_heads}"
    if config.n_kv_heads % tp:
        return False, f"tp={tp} does not divide n_kv_heads={config.n_kv_heads}"
    if config.hidden_dim % tp:
        return False, f"tp={tp} does not divide hidden_dim={config.hidden_dim}"
    return True, ""


COLUMN = ("wq", "wk", "wv", "w1", "w3")
ROW = ("wo", "w2")


def tp_cuda_supported(params: dict, config, mesh) -> tuple[bool, str]:
    """Whether the INT8 CUDA kernels run under this mesh on local shards:
    the twin of the JAX ``tp_pallas_supported``, with its reasons.

    ``params`` is the whole UNFUSED tree. Every matmul weight must be a layer-stacked QuantTensor whose
    q AND scale split evenly on the model axis (a replicated scale would
    turn a partial sum into an over-counted one), and tp must divide the
    head counts so that each rank owns whole kv heads."""
    tp = mesh_shape(mesh)["model"]
    if tp == 1:
        return True, ""
    ok, why = _divides(config, tp)
    if not ok:
        return ok, why
    for k in COLUMN + ROW:
        w = params.get(k)
        if not (isinstance(w, QuantTensor) and w.q.ndim == 3):
            return False, f"{k} is not a layer-stacked QuantTensor"
        if k in COLUMN:
            if w.q.shape[-1] % tp or w.scale.shape[-1] % tp:
                return False, f"{k} out-features/scales not divisible by tp={tp}"
        else:
            if w.q.shape[1] % tp:
                return False, f"{k} in-features not divisible by tp={tp}"
            if w.scale.shape[1] % tp:
                return False, f"{k} scale groups not divisible by tp={tp}"
    return True, ""


def tp_ring_supported(params: dict, config, mesh) -> tuple[bool, str]:
    """Whether the plain path (``backend="torch"``) and the ring collective
    matmul (``collective="ring"``, :mod:`.collective_matmul`) shard this
    model: the twin of the JAX ``tp_ring_supported``, with its reasons.
    ``params`` is the whole UNFUSED tree as loaded (fp or quantized weights:
    the plain products and the ring's dequantize a QuantTensor shard); only
    divisibility is checked, so that each rank owns whole heads and hidden
    columns and a quantized weight's scales split with it. Else every rank
    holds the whole model."""
    tp = mesh_shape(mesh)["model"]
    if tp == 1:
        return True, ""
    if config.n_heads % tp or config.n_kv_heads % tp:
        return False, f"tp={tp} does not divide the head counts"
    if config.hidden_dim % tp:
        return False, f"tp={tp} does not divide hidden_dim={config.hidden_dim}"
    for k in COLUMN + ROW:
        w = params.get(k)
        if w is None:
            return False, f"{k} missing (fused layouts not supported with ring)"
        shape, sshape = (w.q.shape, w.scale.shape) if isinstance(w, QuantTensor) else (w.shape, None)
        d = -1 if k in COLUMN else 1
        if shape[d] % tp:
            return False, f"{k} not divisible by tp={tp}"
        if sshape is not None and sshape[d] % tp:
            return False, f"{k} scales not divisible by tp={tp}"
    return True, ""


def batch_rows(n: int, mesh) -> slice:
    """The rows of an ``n``-row batch this rank computes: its data index's
    share when ``n`` divides dp, else all of them (the B = 1 prefill plane,
    which every data group computes alike; a ragged batch warns)."""
    dp = mesh.shape["data"]
    if dp > 1 and n % dp == 0:
        d = mesh.coord[0]
        return slice(d * n // dp, (d + 1) * n // dp)
    if dp > 1 and n > 1:
        warnings.warn(
            f"batch {n} does not divide dp={dp}: replicating the batch over "
            "the data axis (every rank computes all rows)",
            stacklevel=3,
        )
    return slice(0, n)


def add_reduced(x: torch.Tensor, partial: torch.Tensor, group) -> torch.Tensor:
    """``x + sum over the group of partial``: the float32 all-reduce of the
    ranks' row-parallel partial outputs, added to the residual in float32
    and rounded once. Without a group, ``x + partial``."""
    if group is None:
        return x + partial
    total = partial.float()
    dist.all_reduce(total, group=group)
    return (x.float() + total).to(x.dtype)


def gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in rank order."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def run_layers_sharded(run_layers, params: dict, cache: dict, x, pos, cos, sin, config, backend: str, mesh,
                       ring: bool = False):
    """``models.llama._run_layers`` on this rank's shards: its rows of the
    embedded segment ``x`` (:func:`batch_rows`; per-row ``pos`` and RoPE
    rows with them), the local config, and the model group for the reduces
    (with ``ring``, the ring collective matmul's). Returns the rank's rows."""
    B = x.shape[0]
    rows = batch_rows(B, mesh)
    if rows != slice(0, B):
        x = x[rows]
        if isinstance(pos, torch.Tensor) and pos.numel() == B:
            pos, cos, sin = pos.reshape(-1)[rows], cos[rows], sin[rows]
    tp = mesh_shape(mesh)["model"]
    group = mesh.model_group if tp > 1 else None
    return run_layers(params, cache, x, pos, cos, sin, local_config(config, tp), backend, group,
                      ring and group is not None)


def vocab_split(params: dict, mesh) -> bool:
    """Whether this rank's classifier is its vocab slice (the spec it was
    cut by), or the whole classifier, replicated with a warning when the
    vocab does not split."""
    tp = mesh_shape(mesh)["model"]
    if tp == 1:
        return False
    if not isinstance(params, LocalParams):
        raise ValueError("under a tensor-parallel mesh the params are a rank's shards (sharding.shard_params)")
    spec = params.specs["wcls"]
    split = all(s[-1] == "model" for s in (spec if isinstance(spec[0], tuple) else (spec,)))
    if not split:
        V = params.global_shapes["wcls"][0][-1] if isinstance(params["wcls"], QuantTensor) else params["wcls"].shape[-1]
        warnings.warn(
            f"vocab {V} not divisible by tp={tp}: classifier head replicates "
            "(each rank computes the full vocab row)",
            stacklevel=3,
        )
    return split


def logits_sharded(hidden: torch.Tensor, params: dict, mesh, backend: str, linear) -> torch.Tensor:
    """The vocab-sharded classifier: ``linear`` (K5 on the CUDA backends) on
    this rank's (D, V/tp) slice, then an all-gather over the model group
    into the full vocab row; the replicated classifier computes it whole."""
    logits = linear(hidden, params["wcls"], backend).float()
    if vocab_split(params, mesh):
        logits = gather(logits, mesh.model_group, -1)
    return logits
