"""What the gloo ranks of tests/test_torch_device_plane.py run (not a test
module).  It imports no JAX, so a rank starts with torch and the port
alone: DTensor leaves through the tensor transport on a mesh of `world`
ranks, with the landing mesh registered, with none, and (two ranks) an
envelope from another rank's coordinate."""

import os

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from cluster_anywhere_tpu_torch.channel import device_transport as dt
from cluster_anywhere_tpu_torch.core import serialization
from cluster_anywhere_tpu_torch.parallel.mesh import MeshSpec, make_mesh

STRICT = "CA_DEVICE_TRANSPORT_STRICT"


def _pack(value) -> bytes:
    return serialization.pack(dt.pack_device_value(value))


def _land(blob: bytes, strict: bool = False):
    """blob landed here; the landed tree, or the error's text."""
    os.environ[STRICT] = "1" if strict else "0"
    try:
        return dt.maybe_unpack(serialization.unpack(blob))
    except RuntimeError as e:
        return f"RuntimeError: {e}"
    finally:
        os.environ.pop(STRICT, None)


def _same(got, want) -> bool:
    """A landed DTensor equal to the sent one: type, placements, global
    shape and this rank's shard."""
    return (isinstance(got, DTensor) and tuple(got.placements) == tuple(want.placements)
            and got.shape == want.shape and torch.equal(got.to_local(), want.to_local()))


def dtensor_cases(rank, world):
    mesh = make_mesh(MeshSpec(dp=world), device="cpu", backend="gloo")
    rows = 4
    full = torch.arange(rows * world * 3, dtype=torch.float32).reshape(rows * world, 3)
    local = full[rank * rows:(rank + 1) * rows]
    shard, repl = [Shard(0)] + [Replicate()] * 5, [Replicate()] * 6

    def sharded(t):
        return DTensor.from_local(t.clone(), mesh, shard, run_check=False,
                                  shape=torch.Size((rows * world,) + tuple(t.shape[1:])),
                                  stride=(t.shape[1], 1))

    tree = {"s": sharded(local), "bf": sharded(local.to(torch.bfloat16)),
            "r": DTensor.from_local(full.clone(), mesh, repl, run_check=False), "tag": ("t", 1)}
    out = {}

    # the landing mesh registered: each leaf lands as a DTensor over it
    dt._mesh_registry.clear()
    dt.reset_stats()
    dt.set_transfer_mesh(mesh)
    got = _land(_pack(tree), strict=True)
    out["registered"] = [_same(got[k], tree[k]) for k in ("s", "bf", "r")] + [got["tag"]]
    out["registered_full"] = torch.equal(got["s"].full_tensor(), full)
    out["registered_stats"] = dt.stats()

    # no mesh registered: a Replicate-only leaf lands whole; a sharded one
    # lands whole (its sharding dropped) only where its shard is the whole
    # tensor and strict mode is off, and raises otherwise
    dt._mesh_registry.clear()
    dt.reset_stats()
    whole = _land(_pack({"r": tree["r"]}), strict=True)["r"]
    out["replicated_whole"] = [type(whole).__name__, torch.equal(whole, full)]
    blob = _pack({"s": tree["s"]})
    lax, strict = _land(blob), _land(blob, strict=True)
    out["sharded_lax"] = (lax if isinstance(lax, str)
                          else [type(lax["s"]).__name__, torch.equal(lax["s"], full)])
    out["sharded_strict"] = strict if isinstance(strict, str) else "landed"
    out["unregistered_stats"] = dt.stats()

    if world > 1:
        # rank 0's envelope on rank 1, over a mesh of the same shape: the
        # sharded leaf is rank 0's shard, which rank 1 does not hold;
        # and a Replicate-only leaf from rank 0 lands there whole
        dt.set_transfer_mesh(mesh)
        box = [_pack({"s": tree["s"]}), _pack({"r": tree["r"]})] if rank == 0 else [None, None]
        dist.broadcast_object_list(box, src=0)
        got = _land(box[0])
        out["from_rank0"] = got if isinstance(got, str) else "landed"
        got = _land(box[1])["r"]
        out["from_rank0_replicated"] = [isinstance(got, DTensor), torch.equal(
            got.to_local() if isinstance(got, DTensor) else got, full)]
    dt._mesh_registry.clear()
    return out
