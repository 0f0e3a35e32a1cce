"""Parallelism strategies over torch.distributed device meshes.

Counterpart of cluster_anywhere_tpu/parallel/.  A mesh is a DeviceMesh
over the six canonical axes (mesh.py); weights and batches are placed by
PartitionSpecs that map to DTensor placements (sharding.py).  The model
writes its collectives out (collectives.py, each differentiable with
JAX's transpose) where the JAX package leaves dp/fsdp/tp to GSPMD: PP by
the GPipe schedule over permutes (pipeline.py), SP by ring attention
(ring_attention.py) or Ulysses all_to_all (ulysses.py), EP by switch
MoE with all_to_all routing (moe.py).  The JAX package's compat.py, a
shard_map shim for old JAX releases, has no counterpart.
"""

from .mesh import AXES, MeshSpec, auto_spec, local_mesh, make_mesh
from .moe import MoEOutput, init_moe_params, moe_ffn, top1_route
from .sharding import DEFAULT_RULES, P, constraint, logical_to_spec, named_sharding, shard_pytree

__all__ = [
    "AXES",
    "MeshSpec",
    "auto_spec",
    "local_mesh",
    "make_mesh",
    "DEFAULT_RULES",
    "P",
    "constraint",
    "logical_to_spec",
    "named_sharding",
    "shard_pytree",
    "MoEOutput",
    "moe_ffn",
    "init_moe_params",
    "top1_route",
]
