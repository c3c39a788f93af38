"""Tensor and data parallelism over ``torch.distributed``, one process a rank.

Port of ``llama2_tpu/parallel/``: :mod:`.distributed` (process groups, the
launcher), :mod:`.mesh` (the ``(data, model)`` mesh), :mod:`.sharding` (the
partition specs and each rank's slices) and :mod:`.tp` (the sharded layer
stack and classifier). Where the JAX package runs one program over every
device (``shard_map``), here every rank runs the same engine on its own
shards and the row-parallel outputs are all-reduced over the model group.
"""
