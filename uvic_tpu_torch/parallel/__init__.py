"""Spatial domain decomposition of the ocean step over ranks.

Port of ``uvic_tpu.parallel`` onto ``torch.distributed``: ``mesh`` (the
(y, x) mesh of ranks, global fields cut into rank blocks and gathered
back), ``halo`` (the extended statics and the one packed halo exchange
a step), ``shard_step`` (``ShardedOceanStep``, the explicit-halo ocean
step) and ``launch`` (starting the ranks of a mesh on one machine).
"""
