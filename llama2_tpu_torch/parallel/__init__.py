"""The parallel families over ``torch.distributed``, one process a rank.

Port of ``llama2_tpu/parallel/``: :mod:`.distributed` (process groups, the
launcher), :mod:`.mesh` (the two-axis mesh: a leading ``data``, ``seq`` or
``stage`` axis, then ``model``), :mod:`.sharding` (the partition specs and
each rank's slices, the paged pools' among them), :mod:`.tp` (the sharded
layer stack and classifier), :mod:`.collective_matmul` (the overlapped ring
collective matmul of ``collective="ring"``) and :mod:`.dp_paged` (the paged
engine over the mesh: pages on ``data``, kv heads on ``model``) serve over a
``(data, model)`` mesh; :mod:`.ring` (ring attention) and :mod:`.sp`
(sequence-parallel prefill) run a segment cut over ``seq``,
:mod:`.ring_decode` (the sequence-sharded decoder of the CLI's
``--seq-shards``) a KV cache cut over ``seq``, and :mod:`.pp` (GPipe prefill
and decode) the layer stack cut over ``stage``, each with ``model`` beside
it. Where the JAX package runs one program over every device
(``shard_map``), here every rank runs the same code on its own shards: the
row-parallel outputs are reduced over the model group, and the ``seq`` and
``stage`` families move activations by point-to-point hops or merge
statistics by all-reduces. The submodules are imported by name (``from
llama2_tpu_torch.parallel import dp_paged``): the models import this
package, and :mod:`.dp_paged` imports the models.
"""
