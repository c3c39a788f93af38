"""The ``(data, model)`` mesh over the ranks of the process group.

Counterpart of ``llama2_tpu/parallel/mesh.py``. Two axes:

* ``data``: independent requests; the engine's slots are cut over it.
  Collectives: the all-gather of each tick's sampled tokens.
* ``model``: tensor parallelism over attention heads, the FFN's hidden
  width and the vocabulary. Collectives: the all-reduce of each row-parallel
  output (wo, w2) and the all-gather of the vocab-sharded logits.

Rank ``r`` sits at ``(r // tp, r % tp)``, the row-major order in which the
JAX package reshapes its devices. A :class:`Mesh` names the rank's
coordinate, its device and its groups: the ranks of its data index (the
model group), those of its model index (the data group), and the world's
group for the engine's lockstep messages (gloo, so that Python objects can
be broadcast whatever the collective backend). Built without groups (a
single process, or :func:`single_device_mesh`) it still says where a rank
would sit, which is what the sharding functions read.

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
AXES = (DATA_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place in a ``dp x tp`` mesh, with its process groups (None
    on an axis of size one, or without a process group). ``device``: None
    means the card (raising without one)."""

    dp: int
    tp: int
    rank: int = 0
    device: torch.device | None = None
    model_group: object = None
    data_group: object = None
    control_group: object = None

    def __post_init__(self):
        from llama2_tpu_torch.runtime.generator import resolve_device

        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

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


def make_mesh(dp: int = 1, tp: int | None = None, device=None) -> Mesh:
    """This rank's ``(data, model)`` mesh over the initialized world (one
    rank without a process group). ``tp=None`` takes the ranks ``dp``
    leaves. ``device``: the device type (None: the card, raising without
    one); the rank's device is ``distributed.rank_device``'s. Every rank
    must call it, in the same order: it makes the groups."""
    from llama2_tpu_torch.parallel.distributed import rank_device
    from llama2_tpu_torch.runtime.generator import resolve_device

    device_type = resolve_device(device).type
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        if world % dp != 0:
            raise ValueError(f"{world} ranks not divisible by dp={dp}")
        tp = world // dp
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, have {world}")
    rank = dist.get_rank() if world > 1 else 0
    groups = {}
    if world > 1:
        for axis, members in (
            ("model_group", [[d * tp + t for t in range(tp)] for d in range(dp)] if tp > 1 else []),
            ("data_group", [[d * tp + t for d in range(dp)] for t in range(tp)] if dp > 1 else []),
        ):
            for ranks in members:
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
        control = dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
        groups["control_group"] = control
    return Mesh(dp, tp, rank, rank_device(rank, device_type), **groups)


def single_device_mesh(device=None) -> Mesh:
    """A one-rank mesh on ``device`` (None: the card, raising without one)."""
    return Mesh(1, 1, 0, device)
