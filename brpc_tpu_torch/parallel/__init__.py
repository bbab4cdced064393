"""Collective data plane: combo-channel fan-out on the GPU.

The reference's ParallelChannel (src/brpc/parallel_channel.h:94) fans one
RPC out to N sub-channels and merges responses; PartitionChannel
(src/brpc/partition_channel.h:34) shards by partition tag. Here the
regular cases of these patterns run as torch.distributed collectives
over a world of ranks (`world`): `collective_echo` holds the
single-device echo step and the mesh steps (parallel echo, partition,
all-reduce, all-gather, all-to-all), one process a rank.
"""
