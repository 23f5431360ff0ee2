"""Node-sharded placement over a device mesh (the port of the JAX
package's parallel/): one process, shards as device slices, collectives
outside the kernels (parallel/mesh.py)."""

from .mesh import make_mesh, shard_placement_inputs, sharded_placement

__all__ = ["make_mesh", "shard_placement_inputs", "sharded_placement"]
