"""parallel subsystem: ``shard_map`` over a JAX mesh becomes SPMD over the
ranks of a ``torch.distributed`` process group (a ``DeviceMesh`` axis),
NCCL on cards and gloo on the CPU.  ``spmm``, ``train``, ``pooled_model``,
``scaling``, ``multihost``, ``dense_pool`` (the dense cluster family's
sharded ``SᵀX``/``SᵀAS`` and losses) and ``sparse_pool`` (top-k and SAG
driven by the pooler's own parameters) mirror JAX's modules;
``launch.spawn_world`` starts a world of processes."""
