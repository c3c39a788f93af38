"""The two-axis mesh over the ranks of the process group: a leading axis,
then ``model``.

Counterpart of ``llama2_tpu/parallel/mesh.py`` (and of the mesh builders of
``parallel/sp.py`` and ``parallel/pp.py``). The leading axis is named:

* ``data`` (the default): independent requests; the engines' slots are cut
  over it. Collectives: the all-gather of each tick's sampled tokens.
* ``seq``: a segment's positions (``parallel/sp.py``, ``parallel/ring.py``)
  or the KV cache's rows (``parallel/ring_decode.py``). Collectives: the
  ring's hops of KV chunks, the decode attention's merge.
* ``stage``: the layer stack cut into pipeline stages (``parallel/pp.py``).
  Collectives: the stage hops of activations.

and ``model`` is tensor parallelism over attention heads, the FFN's hidden
width and the vocabulary. Collectives: the all-reduce of each row-parallel
output (wo, w2) and the all-gather of the vocab-sharded logits.

Rank ``r`` sits at ``(r // tp, r % tp)``, the row-major order in which the
JAX package reshapes its devices, whatever the leading axis. A :class:`Mesh`
names the rank's coordinate, its device and its groups: the ranks of its
leading index (the model group), those of its model index (the group along
the leading axis, ``data_group`` whatever its name; :meth:`Mesh.group`
takes the axis by name), and the world's group for the engine's lockstep
messages (gloo, so that Python objects can be broadcast whatever the
collective backend). Built without groups (a single process, or
:func:`single_device_mesh`) it still says where a rank would sit, which is
what the sharding functions read. ``Mesh.shape`` names the leading axis, so
that a ``seq`` or ``stage`` mesh is never read as a data-parallel one: the
engines refuse it (:func:`require_data_axis`).

The device defaults to the card, by the port's rule
(``runtime/generator.py::resolve_device``): without one, a mesh, and so an
engine over it, raises unless the caller asks for the CPU
(``device="cpu"``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
STAGE_AXIS = "stage"
AXES = (DATA_AXIS, MODEL_AXIS)
LEADING_AXES = (DATA_AXIS, SEQ_AXIS, STAGE_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place in a ``dp x tp`` mesh, with its process groups (None
    on an axis of size one, or without a process group). ``dp`` is the size
    of the leading axis, whose name is ``axis`` (``data``, ``seq`` or
    ``stage``), and ``data_group`` the group along it. ``device``: None
    means the card (raising without one)."""

    dp: int
    tp: int
    rank: int = 0
    device: torch.device | None = None
    model_group: object = None
    data_group: object = None
    control_group: object = None
    axis: str = DATA_AXIS

    def __post_init__(self):
        from llama2_tpu_torch.runtime.generator import resolve_device

        if self.axis not in LEADING_AXES:
            raise ValueError(f"leading axis {self.axis!r}: want one of {LEADING_AXES}")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def shape(self) -> dict[str, int]:
        """``{leading axis name: its size, "model": tp}``."""
        return {self.axis: self.dp, MODEL_AXIS: self.tp}

    def group(self, axis: str):
        """The process group along ``axis`` (None on an axis of size one);
        ``KeyError`` for an axis this mesh does not have."""
        if axis == MODEL_AXIS:
            return self.model_group
        if axis == self.axis:
            return self.data_group
        raise KeyError(f"mesh ({self.axis}, {MODEL_AXIS}) has no {axis!r} axis")

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if axis not in self.shape:
            raise KeyError(f"mesh ({self.axis}, {MODEL_AXIS}) has no {axis!r} axis")
        return self.coord[1] if axis == MODEL_AXIS else self.coord[0]

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def coord(self) -> tuple[int, int]:
        """``(data index, model index)``."""
        return self.rank // self.tp, self.rank % self.tp

    def replicated_over_model(self) -> "Mesh":
        """The mesh a model that does not shard runs on: the same data
        groups, every rank of a model group holding the whole model (a
        ``dp x 1`` mesh whose rank is the data index)."""
        return dataclasses.replace(self, tp=1, rank=self.coord[0], model_group=None)


def require_data_axis(mesh, who: str) -> None:
    """Raise ``ValueError`` unless ``mesh`` (None passes) leads with
    ``data``: what ``who`` reads as request parallelism must not be a
    ``seq`` or ``stage`` axis."""
    if mesh is not None and mesh.axis != DATA_AXIS:
        raise ValueError(f"{who}(mesh=) takes a ({DATA_AXIS}, {MODEL_AXIS}) mesh; this one leads with "
                         f"{mesh.axis!r} (its families: parallel/sp.py, ring_decode.py, pp.py)")


def make_mesh(dp: int = 1, tp: int | None = None, device=None, axis: str = DATA_AXIS) -> Mesh:
    """This rank's ``(axis, model)`` mesh over the initialized world (one
    rank without a process group); ``axis`` names the leading axis
    (``data``, ``seq`` or ``stage``) of size ``dp``. ``tp=None`` takes the
    ranks ``dp`` leaves. ``device``: the device type (None: the card,
    raising without one); the rank's device is ``distributed.rank_device``'s.
    Every rank must call it, in the same order: it makes the groups."""
    from llama2_tpu_torch.parallel.distributed import rank_device
    from llama2_tpu_torch.runtime.generator import resolve_device

    device_type = resolve_device(device).type
    world = _world()
    if tp is None:
        if world % dp != 0:
            raise ValueError(f"{world} ranks not divisible by dp={dp}")
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, have {world}")
    rank = dist.get_rank() if world > 1 else 0
    groups = {}
    if world > 1:
        for field, members in (
            ("model_group", [[d * tp + t for t in range(tp)] for d in range(dp)] if tp > 1 else []),
            ("data_group", [[d * tp + t for d in range(dp)] for t in range(tp)] if dp > 1 else []),
        ):
            for ranks in members:
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[field] = group
        control = dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
        groups["control_group"] = control
    return Mesh(dp, tp, rank, rank_device(rank, device_type), axis=axis, **groups)


def single_device_mesh(device=None) -> Mesh:
    """A one-rank mesh on ``device`` (None: the card, raising without one)."""
    return Mesh(1, 1, 0, device)


def make_seq_mesh(sp: int | None = None, device=None) -> Mesh:
    """A ``(seq,)`` mesh of ``sp`` ranks (None: the world) for
    sequence-parallel prefill and the sequence-sharded decoder (the JAX
    ``sp.make_seq_mesh``)."""
    return make_mesh(_world() if sp is None else sp, 1, device, SEQ_AXIS)


def make_sp_tp_mesh(sp: int, tp: int, device=None) -> Mesh:
    """A ``(seq, model)`` mesh: the ring over ``seq`` composes with tensor
    parallelism over ``model`` (the JAX ``sp.make_sp_tp_mesh``)."""
    return make_mesh(sp, tp, device, SEQ_AXIS)


def make_stage_mesh(pp: int | None = None, device=None) -> Mesh:
    """A ``(stage,)`` mesh of ``pp`` ranks (None: the world) for the
    pipeline (the JAX ``pp.make_stage_mesh``)."""
    return make_mesh(_world() if pp is None else pp, 1, device, STAGE_AXIS)


def make_pp_tp_mesh(pp: int, tp: int, device=None) -> Mesh:
    """A ``(stage, model)`` mesh: pipeline stages of tensor-sharded layers
    (the JAX ``pp.make_pp_tp_mesh``)."""
    return make_mesh(pp, tp, device, STAGE_AXIS)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
