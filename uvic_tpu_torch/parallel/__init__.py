"""Spatial domain decomposition of the ocean over ranks.

Port of ``uvic_tpu.parallel`` onto ``torch.distributed``: ``mesh`` (the
(y, x) mesh of ranks, global fields cut into rank blocks and gathered
back), ``halo`` (the extended statics and the one packed halo exchange
a step), ``shard_step`` (``ShardedOceanStep``, the explicit-halo ocean
step), ``shard_segment`` (``ShardedCoupledModel``, the coupled segment
with the ocean on the mesh and the 2-D components replicated) and
``launch`` (starting the ranks of a mesh on one machine).
"""
