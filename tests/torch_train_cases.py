"""What the ranks of tests/test_torch_train_lib.py's gloo pool run (not a
test module).  Module-level functions, called as fn(rank, world, *args) by
tests/torch_dist_pool.py; this module imports no JAX, so a rank starts
with torch and the port alone."""

import numpy as np
import torch

from cluster_anywhere_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from cluster_anywhere_tpu_torch.parallel.sharding import P, local_shard
from cluster_anywhere_tpu_torch.train import Checkpoint


def save_sharded(rank, world, tree, specs, axes, path):
    """Every rank saves its local shards of the whole numpy `tree` (laid out
    by `specs`, PartitionSpec entries given as tuples) into `path` on a
    mesh of `axes`, then restores them onto the same mesh: returns whether
    each restored local tensor equals the one saved."""
    mesh = make_mesh(MeshSpec(**axes), device="cpu")
    specs = {k: P(*v) for k, v in specs.items()}
    local = {k: local_shard(torch.from_numpy(v), specs[k], mesh) if k in specs else v
             for k, v in tree.items()}
    ck = Checkpoint(path)
    ck.save_pytree_sharded(local, mesh=mesh, specs={k: specs.get(k) for k in tree})
    torch.distributed.barrier()
    back = ck.load_pytree_sharded(mesh=mesh, specs={k: specs.get(k) for k in tree})
    return all(torch.equal(back[k], torch.as_tensor(np.asarray(local[k]))) for k in tree)
