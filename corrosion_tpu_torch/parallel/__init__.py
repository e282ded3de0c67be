"""Mesh parallelism for the scale round (port of ``corrosion_tpu/parallel``).

The JAX package shards the simulated nodes axis over a ``jax.sharding.Mesh``
and lets XLA insert the collectives; the port runs one thread per shard in
one process and writes each cross-node exchange out (``exchange.py``). See
``mesh.py``.
"""

from corrosion_tpu_torch.parallel.mesh import (  # noqa: F401
    DCN_AXIS,
    NODE_AXIS,
    SHARDED_ENTRY_POINTS,
    HostLeafShards,
    Mesh,
    ShardedTree,
    assemble_shards,
    device_put_shards,
    drained_mesh_meta,
    elastic_sharding,
    host_shard_copy,
    make_mesh,
    make_multihost_mesh,
    node_sharding,
    shard_state,
    sharded_scale_run,
    sharded_scale_run_carry,
)
