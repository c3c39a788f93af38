"""Partition specs, and the slices of them that a rank holds.

Port of ``llama2_tpu/parallel/sharding.py``. The layout is the same:

* column-parallel (out-features on ``model``): ``wq wk wv w1 w3``: the
  activations they make are head- or hidden-sharded, so attention and the
  SwiGLU gate run on each rank alone;
* row-parallel (in-features on ``model``): ``wo w2``: their outputs are
  partial sums, all-reduced over the model group once a block;
* the KV cache: kv heads on ``model`` (head size takes the remaining ways
  when tp exceeds the kv heads), slots on ``data``;
* the paged engine's page pools: kv heads on ``model``, and the page axis
  on ``data`` where each data group has its own allocator
  (``parallel/dp_paged.py``), else replicated (:func:`pool_specs`);
* the classifier ``wcls`` vocab-sharded on ``model``; norms and the
  embedding replicated.

A spec is a tuple with one entry a dimension, ``None``, ``"data"`` or
``"model"``, element for element the JAX ``PartitionSpec``. Specs are
divisibility-aware: an axis shards the first preferred dimension it
divides, else the array replicates on it. A ``QuantTensor``'s ``q`` and
``scale`` each take their own spec, so a scale sidecar whose groups do not
divide replicates (w2's (L, 172, D) scales at tp = 4).

Where the JAX package places a global array over the devices, a rank here
holds its own slices: :func:`local_slice` is the slice of one array at one
mesh coordinate, :func:`shard_params` / :func:`shard_cache` a rank's tree.
``mesh`` is a :class:`~llama2_tpu_torch.parallel.mesh.Mesh` or a ``(dp, tp)``
pair wherever only the shape is read.
"""

from __future__ import annotations

import numpy as np
import torch

from llama2_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from llama2_tpu_torch.quant.q8 import QuantTensor

# model-axis dim preferences per param name: column-parallel weights shard
# out-features (dim 2 of the layer-stacked (L, in, out)), row-parallel
# in-features (dim 1), the classifier the vocab; norms and the embedding
# replicate. Fused launch groups inherit their constituents' orientation.
MODEL_PREFS: dict[str, tuple[int, ...]] = {
    "tok_emb": (),
    "rms_att": (), "rms_ffn": (), "rms_final": (),
    "wq": (2,), "wk": (2,), "wv": (2,),
    "w1": (2,), "w3": (2,),
    "wqkv": (2,), "w13": (2,),
    "wo": (1,), "w2": (1,),
    "wcls": (1,),
}


def mesh_shape(mesh) -> dict[str, int]:
    """``{"data": dp, "model": tp}`` of a Mesh or a ``(dp, tp)`` pair. A
    ``seq`` or ``stage`` Mesh names its leading axis so, and has no
    ``data`` entry: the specs here serve the ``(data, model)`` engines (the
    ``seq`` and ``stage`` families cut their weights with
    ``sp.rank_params``)."""
    if isinstance(mesh, tuple):
        return {DATA_AXIS: mesh[0], MODEL_AXIS: mesh[1]}
    return mesh.shape


def _shard_dim(shape, specs: list, n: int, axis: str, prefs) -> None:
    """Assign ``axis`` to the first preferred dim it divides; else replicate."""
    for d in prefs:
        if d >= len(shape):  # e.g. the kv-quant scale planes' missing head dim
            continue
        if shape[d] % n == 0 and specs[d] is None:
            specs[d] = axis
            return


def _spec(shape, mesh, model_prefs, data_prefs=()) -> tuple:
    sizes = mesh_shape(mesh)
    specs: list = [None] * len(shape)
    if data_prefs:
        _shard_dim(shape, specs, sizes[DATA_AXIS], DATA_AXIS, data_prefs)
    if model_prefs:
        _shard_dim(shape, specs, sizes[MODEL_AXIS], MODEL_AXIS, model_prefs)
    return tuple(specs)


def leaf_spec(name: str, shape, mesh) -> tuple:
    """The spec of one array of param ``name`` (also of a QuantTensor's
    ``q`` or ``scale`` alone)."""
    return _spec(tuple(shape), mesh, model_prefs=MODEL_PREFS.get(name, ()))


def param_specs(params: dict, mesh) -> dict[str, tuple]:
    """Per-param spec from the actual shapes (a QuantTensor's ``q``'s)."""
    return {k: leaf_spec(k, params[k].shape, mesh) for k in params}


def cache_specs(cache: dict, mesh) -> dict[str, tuple]:
    """(n_layers, B, n_kv_heads, S, head_size) planes: kv heads on
    ``model`` (head size takes the ways past the kv heads), slots on
    ``data``; the int8 cache's (n_layers, B, n_kv_heads, S) scales alike."""
    return {k: _spec(tuple(v.shape), mesh, model_prefs=(2, 4), data_prefs=(1,)) for k, v in cache.items()}


def local_slice(array, spec: tuple, coord: tuple[int, int], mesh):
    """The slice of ``array`` (numpy or torch; a view) that the rank at
    mesh coordinate ``coord = (data index, model index)`` holds under
    ``spec``."""
    sizes = mesh_shape(mesh)
    index = {DATA_AXIS: coord[0], MODEL_AXIS: coord[1]}
    cut = []
    for dim, axis in enumerate(spec):
        if axis is None:
            cut.append(slice(None))
        else:
            c = array.shape[dim] // sizes[axis]
            cut.append(slice(index[axis] * c, (index[axis] + 1) * c))
    return array[tuple(cut)]


def _owned(array, spec, coord, mesh):
    """This rank's slice as a contiguous array of its own: only the slice's
    bytes are copied out of a memory-mapped file."""
    part = local_slice(array, spec, coord, mesh)
    if isinstance(part, torch.Tensor):
        return part.contiguous()
    return np.ascontiguousarray(part)


class LocalParams(dict):
    """A rank's param tree: its slices, and the specs and global shapes they
    were cut by (what the sharded classifier reads). Trees derived from it (:func:`derive`) keep that record."""

    mesh_shape: tuple[int, int] = (1, 1)
    coord: tuple[int, int] = (0, 0)
    specs: dict = {}
    global_shapes: dict = {}


def derive(source: dict, tree: dict) -> dict:
    """``tree`` carrying ``source``'s record when ``source`` is a
    :class:`LocalParams` (the fused or device-placed tree of a rank)."""
    if not isinstance(source, LocalParams):
        return tree
    out = LocalParams(tree)
    out.mesh_shape, out.coord, out.specs, out.global_shapes = (
        source.mesh_shape, source.coord, source.specs, source.global_shapes
    )
    return out


def _coord(mesh) -> tuple[int, int]:
    return (0, 0) if isinstance(mesh, tuple) else mesh.coord


def shard_params(params: dict, mesh, coord: tuple[int, int] | None = None) -> LocalParams:
    """The rank's slices of a whole param tree (numpy arrays, tensors or
    QuantTensors), each a contiguous copy; ``coord`` defaults to the mesh's."""
    coord = _coord(mesh) if coord is None else coord
    sizes = mesh_shape(mesh)
    out = LocalParams()
    out.mesh_shape = (sizes[DATA_AXIS], sizes[MODEL_AXIS])
    out.coord = coord
    out.specs, out.global_shapes = {}, {}
    for k, v in params.items():
        if isinstance(v, QuantTensor):
            qs, ss = leaf_spec(k, v.q.shape, mesh), leaf_spec(k, v.scale.shape, mesh)
            out[k] = QuantTensor(_owned(v.q, qs, coord, mesh), _owned(v.scale, ss, coord, mesh), v.group_size)
            out.specs[k] = (qs, ss)
            out.global_shapes[k] = (tuple(v.q.shape), tuple(v.scale.shape), v.group_size)
        else:
            spec = leaf_spec(k, v.shape, mesh)
            out[k] = _owned(v, spec, coord, mesh)
            out.specs[k] = spec
            out.global_shapes[k] = tuple(v.shape)
    return out


def shard_cache(cache: dict, mesh, coord: tuple[int, int] | None = None) -> dict:
    """The rank's slices of a whole cache, each a contiguous copy."""
    coord = _coord(mesh) if coord is None else coord
    specs = cache_specs(cache, mesh)
    return {k: _owned(v, specs[k], coord, mesh) for k, v in cache.items()}


def pool_specs(shapes: dict, mesh, pages_on_data: bool = False) -> dict[str, tuple]:
    """Specs of the paged KV pools, ``(L, P, KVH, page, hs)`` and the int8
    pool's ``(L, P, KVH, page)`` scales: kv heads on ``model`` (head size
    takes the ways past them, as the dense cache's), and the page axis on
    ``data`` with ``pages_on_data`` (per-data-group allocators: the JAX
    ``dp_paged._pool_spec``), else replicated over it (one allocator whose
    pages any slot may hold: the JAX ``pool_specs``)."""
    return {k: _spec(tuple(s), mesh, model_prefs=(2, 4), data_prefs=(1,) if pages_on_data else ())
            for k, s in shapes.items()}


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of a rank's slice of an array of ``shape`` under ``spec``."""
    sizes = mesh_shape(mesh)
    return tuple(n // sizes[axis] if axis else n for n, axis in zip(shape, spec))


def shard_pool(shape: tuple, mesh, dtype=torch.float32, device="cpu", kv_quant: bool = False,
               pages_on_data: bool = False):
    """A rank's shard of paged KV pools whose whole shape is ``shape`` (L,
    P, KVH, page, hs), allocated at its local shape (:func:`pool_specs`):
    nothing of the whole pool is built. Its page ids are local: 0 ..
    P/dp - 1 with ``pages_on_data``."""
    from llama2_tpu_torch.runtime.paged_cache import PagePool

    spec = pool_specs({"k": shape}, mesh, pages_on_data)["k"]
    if spec[4] is not None:
        raise ValueError(f"pool {shape} on mesh {mesh_shape(mesh)}: the head size would split ({spec})")
    return PagePool.zeros(local_shape(shape, spec, mesh), dtype, device, kv_quant)
