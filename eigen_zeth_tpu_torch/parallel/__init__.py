"""Parallelism: pipelined chunk proving beside host aggregation, and the
multi-device mesh with the domain-sharded NTT and the distributed MSM.

As in the JAX package, one controller drives every device: a mesh is a
(chunk, domain) grid of torch devices in one process (a device may appear
more than once, as logical shards), and the collectives are block copies
between the shards' tensors.
"""
