"""Device meshes over torch.distributed with the canonical parallelism axes.

Counterpart of cluster_anywhere_tpu/parallel/mesh.py.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the six axes below, every
one present (size 1 = disabled) so specs stay stable, in this order with
dp outermost.  One process is one rank and holds one device: rank r uses
`cuda:(local_rank % device_count)`, or the CPU when asked.

Axes:
  dp    data parallel (gradient allreduce)
  fsdp  fully-sharded data parallel (weights sharded, gathered at use)
  pp    pipeline parallel (stage-partitioned layers, microbatches permuted)
  tp    tensor parallel (matmul-sharded heads, ff and vocab)
  sp    sequence parallel (ring attention / Ulysses all_to_all)
  ep    expert parallel (MoE experts sharded, all_to_all token routing)
"""

from __future__ import annotations

import os
import weakref
from dataclasses import dataclass, fields
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device

AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep")


@dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        n = 1
        for f in fields(self):
            n *= getattr(self, f.name)
        return n

    def axis_sizes(self):
        return tuple(getattr(self, a) for a in AXES)

    def __str__(self):
        return "x".join(f"{a}{getattr(self, a)}" for a in AXES if getattr(self, a) > 1) or "single"


def _default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_mesh(spec: Optional[MeshSpec] = None, *, device=None, backend: Optional[str] = None,
              **axes):
    """A DeviceMesh over every rank of the process group, shaped by `spec`
    (or the axis keywords) with dims named AXES.

    Joins the process group that is already initialised, or initialises
    one from the torch.distributed environment variables (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the card).
    device=None means CUDA and raises without a GPU; only device="cpu"
    runs on the host.  backend=None means NCCL on CUDA and gloo on the
    CPU.  Ranks that share one card pass backend="gloo" (NCCL refuses two
    ranks on one device).  A process group that runs another backend than
    the one asked for (or defaulted to) raises: the backend never changes
    without the caller's word."""
    if spec is None:
        spec = MeshSpec(**axes)
    elif axes:
        raise ValueError("pass either a MeshSpec or axis kwargs, not both")
    dev = resolve_device(device)
    want = backend or _default_backend(dev.type)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(want, init_method="env://")
    have = dist.get_backend()
    if have != want:
        raise ValueError(
            f"the process group runs {have!r}, and a mesh on {dev.type} "
            f"{'was asked for' if backend else 'defaults to'} {want!r}: pass backend={have!r} "
            "to use it")
    world = dist.get_world_size()
    if spec.size != world:
        raise ValueError(f"mesh spec {spec} needs {spec.size} ranks, the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, spec.axis_sizes(), mesh_dim_names=AXES)


def auto_spec(
    n_devices: int,
    tp: int = 1,
    pp: int = 1,
    sp: int = 1,
    ep: int = 1,
    fsdp: int = 1,
) -> MeshSpec:
    """Fill the dp axis with whatever is left after the explicit axes."""
    used = tp * pp * sp * ep * fsdp
    if n_devices % used != 0:
        raise ValueError(f"{n_devices} devices not divisible by tp*pp*sp*ep*fsdp={used}")
    return MeshSpec(dp=n_devices // used, fsdp=fsdp, pp=pp, tp=tp, sp=sp, ep=ep)


def local_mesh(*, device=None, backend: Optional[str] = None, **axes):
    """A mesh over this host's ranks: the axes given, or every rank on dp."""
    if axes:
        return make_mesh(device=device, backend=backend, **axes)
    if not dist.is_initialized():
        raise ValueError("local_mesh() without axes needs an initialised process group")
    return make_mesh(MeshSpec(dp=dist.get_world_size()), device=device, backend=backend)


# A DeviceMesh works its shape and coordinates out of its layout on every
# query; the collectives ask for them at every call, so keep them per mesh.
_COORDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _coords(mesh):
    """(sizes, this rank's coordinate) of a mesh with the AXES dims."""
    got = _COORDS.get(mesh)
    if got is None:
        if tuple(mesh.mesh_dim_names or ()) != AXES:
            raise ValueError(f"the mesh's dims are {mesh.mesh_dim_names}, not {AXES}")
        coord = mesh.get_coordinate()
        got = _COORDS[mesh] = (tuple(int(n) for n in mesh.mesh.shape), tuple(coord))
    return got


def mesh_spec(mesh) -> MeshSpec:
    """The MeshSpec of a DeviceMesh with the AXES dims."""
    return MeshSpec(*_coords(mesh)[0])


def axis_size(mesh, name: str) -> int:
    """The size of the mesh's `name` dim (1 with no mesh)."""
    if mesh is None:
        return 1
    return _coords(mesh)[0][AXES.index(name)]


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along the `name` dim (lax.axis_index)."""
    if mesh is None:
        return 0
    return _coords(mesh)[1][AXES.index(name)]


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on under `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
