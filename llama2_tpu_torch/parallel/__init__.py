"""Tensor and data parallelism over ``torch.distributed``, one process a rank.

Port of ``llama2_tpu/parallel/``: :mod:`.distributed` (process groups, the
launcher), :mod:`.mesh` (the ``(data, model)`` mesh), :mod:`.sharding` (the
partition specs and each rank's slices, the paged pools' among them),
:mod:`.tp` (the sharded layer stack and classifier), :mod:`.collective_matmul`
(the overlapped ring collective matmul of ``collective="ring"``) and
:mod:`.dp_paged` (the paged engine over the mesh: pages on ``data``, kv heads
on ``model``). Where the JAX package runs one program over every device
(``shard_map``), here every rank runs the same engine on its own shards and
the row-parallel outputs are reduced over the model group. The submodules
are imported by name (``from llama2_tpu_torch.parallel import dp_paged``):
the models import this package, and :mod:`.dp_paged` imports the models.
"""
