"""Tensor transport: move trees of torch tensors between processes, landing
them on the consumer's device without losing dtype or DTensor placements.

Role analogue of the reference's NCCL tensor channels
(python/ray/experimental/channel/torch_tensor_nccl_channel.py:44 and
src/ray/core_worker/experimental_mutable_object_manager.h:49), staged
through the host as the JAX package's transport is:

- what travels: a value is a device value when its dict/list/tuple tree
  holds a CUDA tensor (the counterpart of a jax.Array).  On a transport
  edge (a DAG edge marked `with_tensor_transport()`, a DeviceRef fetch, a
  device value passed from the driver) every tensor leaf and every numeric
  numpy leaf is packed; everything else stays in the envelope's skeleton
  and is pickled normally (small metadata).
- producer side: a CUDA leaf is copied ONCE from the device into a fresh
  host tensor (detached, contiguous) that the envelope owns, so the packed
  value is never a view of device memory the producer may reuse.  Its raw
  bytes are handed to pickle protocol-5 as an out-of-band PickleBuffer, so
  a shm channel scatter-writes them with one memcpy and the tensor never
  passes through pickle bytes.  The dtype travels as torch's own name:
  bf16 (no numpy dtype) goes as raw bytes and is rebuilt with
  `view(torch.bfloat16)`, so no dtype is lost or widened.  CPU tensors and
  numpy leaves are packed as they are (a view, pinned by the envelope while
  it is written).
- the producing stream: a stored device value (a put, a task or actor
  result) is `settle`d when it is stored: the current stream of each of
  its devices is synchronised in the producer's thread, because a fetch
  packs it later on an executor thread whose stream would not wait for the
  producer's kernels.  A channel write packs in the producer's thread,
  after its own work on the same stream.
- consumer side: each leaf lands on the consumer's device, `cuda:<current>`
  in a process that sees a GPU and the CPU in one that sees none (as a
  jax.Array lands on the CPU backend of a CPU-only process); CPU landings
  are counted under their own key in stats().  Nothing lands on the CPU
  where a GPU is visible.
- DTensor leaves (the counterpart of a NamedSharding-ed array): one torch
  process holds only its local shard, so the envelope carries that shard
  with the mesh's shape, dim names, the producer's coordinate, the
  placements and the global shape.  It lands as a DTensor over a mesh
  registered with set_transfer_mesh whose shape and names match and at
  whose coordinate this process sits (the shard is this rank's own).  A
  Replicate-only DTensor lands whole anywhere.  A sharded one whose local
  shard is the whole tensor (every sharded dim of size 1) lands as a plain
  tensor, its sharding dropped: the JAX package's host assembly, counted
  in `host_assembles` and refused under strict mode.  Any other sharded
  DTensor with no matching mesh raises, naming its spec: its other shards
  are in other processes.

Strict mode (CA_DEVICE_TRANSPORT_STRICT=1) keeps the JAX package's
meaning: no host assembly, so a landing that would drop a sharding raises.

Out of scope: CUDA IPC handles between processes on one card and NCCL
channels; both would skip the host staging (ROADMAP performance
follow-ups).
"""

from __future__ import annotations

import copy
import os
import pickle
import sys
import threading
import warnings
from typing import Any, Dict, List

import numpy as np

__all__ = [
    "DeviceEnvelope",
    "pack_device_value",
    "unpack_device_value",
    "set_transfer_mesh",
    "stats",
    "reset_stats",
]

_lock = threading.Lock()
_stats = {
    "leaves_packed": 0,
    "d2h_copies": 0,  # CUDA leaves copied once to the host
    "d2h_bytes": 0,  # bytes of those copies
    "host_leaves": 0,  # numpy and CPU-tensor leaves, packed as they are
    "leaves_landed": 0,
    "cuda_landings": 0,  # landed on the process's current CUDA device
    "cpu_landings": 0,  # landed on the CPU (a process that sees no GPU)
    "sharded_landings": 0,  # landed as a DTensor over a registered mesh
    "whole_landings": 0,  # a Replicate-only DTensor landed as one tensor
    "host_assembles": 0,  # a sharding dropped (strict mode forbids)
}
# bounded: a long-lived worker registering per-step meshes must not grow it
_MESH_REGISTRY_CAP = 8
_mesh_registry: List[Any] = []


def stats() -> Dict[str, int]:
    with _lock:
        return dict(_stats)


def reset_stats() -> None:
    with _lock:
        for k in _stats:
            _stats[k] = 0


def _bump(key: str, n: int = 1) -> None:
    with _lock:
        _stats[key] += n


def _strict() -> bool:
    return os.environ.get("CA_DEVICE_TRANSPORT_STRICT", "") not in ("", "0")


def set_transfer_mesh(mesh) -> None:
    """Register the DeviceMesh incoming DTensor leaves should land on.  A
    leaf lands over the newest registration whose shape and dim names match
    its producer's mesh and at whose coordinate this process sits; the
    registry keeps only the last _MESH_REGISTRY_CAP meshes."""
    with _lock:
        _mesh_registry.append(mesh)
        del _mesh_registry[:-_MESH_REGISTRY_CAP]


def _torch():
    """torch when it is loaded (no tensor can exist otherwise), else None:
    the runtime's host-only processes never import it through here."""
    torch = sys.modules.get("torch")
    return torch if hasattr(torch, "Tensor") else None


def _is_dtensor(x) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _tree_map(fn, x):
    """fn over the leaves of a dict/list/tuple tree (namedtuples and dict
    subclasses keep their type)."""
    if isinstance(x, dict):
        items = [(k, _tree_map(fn, v)) for k, v in x.items()]
        if type(x) is dict:
            return dict(items)
        out = copy.copy(x)  # keeps a subclass's own state (a defaultdict's factory)
        out.clear()
        out.update(items)
        return out
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_map(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def settle(value: Any) -> None:
    """Wait for the current stream of every CUDA device a tensor leaf of
    `value` lives on, so that a copy made later on another thread reads
    finished data."""
    torch = _torch()
    if torch is None:
        return
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            devices.add(x.device)
        return x

    _tree_map(visit, value)
    for d in devices:
        torch.cuda.current_stream(d).synchronize()


class _LeafMarker:
    """Placeholder for a tensor leaf inside the envelope's skeleton."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __getstate__(self):
        return self.i

    def __setstate__(self, i):
        self.i = i


class _LeafPack:
    """One leaf: its (local) shape, dtype name, kind ("torch" or "numpy"),
    placement description and raw bytes.

    On the producer side `buf` is a pickle.PickleBuffer over the host copy
    (out-of-band on the wire); after deserialization it comes back as a
    memoryview (or ndarray shim) over the payload.
    """

    __slots__ = ("shape", "dtype", "kind", "desc", "buf")

    def __init__(self, shape, dtype, kind, desc, buf):
        self.shape = shape
        self.dtype = dtype
        self.kind = kind
        self.desc = desc
        self.buf = buf

    def __getstate__(self):
        return (self.shape, self.dtype, self.kind, self.desc, self.buf)

    def __setstate__(self, st):
        self.shape, self.dtype, self.kind, self.desc, self.buf = st


class DeviceEnvelope:
    """A tree in transit: skeleton with _LeafMarkers + packed leaves.

    `_keepalive` pins the source tensors and arrays while views of them are
    being written into the channel; it is dropped on serialization.
    """

    __slots__ = ("skeleton", "leaves", "_keepalive")

    def __init__(self, skeleton, leaves, keepalive):
        self.skeleton = skeleton
        self.leaves = leaves
        self._keepalive = keepalive

    def __getstate__(self):
        return (self.skeleton, self.leaves)

    def __setstate__(self, st):
        self.skeleton, self.leaves = st
        self._keepalive = None


# --------------------------------------------------------------------- pack


def _encode_placement(p) -> tuple:
    name = type(p).__name__
    if name == "Shard":
        return ("shard", int(p.dim))
    if name == "Replicate":
        return ("replicate",)
    if name == "Partial":
        return ("partial", str(p.reduce_op))
    raise TypeError(f"device transport: unsupported DTensor placement {p!r}")


def _dtensor_desc(x) -> Dict[str, Any]:
    mesh = x.device_mesh
    return {
        "kind": "dtensor",
        "global_shape": tuple(x.shape),
        "mesh_shape": tuple(int(n) for n in mesh.mesh.shape),
        "axis_names": tuple(mesh.mesh_dim_names or ()),
        "coord": tuple(mesh.get_coordinate()),
        "placements": tuple(_encode_placement(p) for p in x.placements),
    }


def pack_leaf(x) -> _LeafPack:
    """One tensor (CUDA, CPU or DTensor) as a _LeafPack owning or pinning
    its host bytes: a CUDA tensor is copied once to a fresh host tensor."""
    torch = _torch()
    desc: Dict[str, Any] = {"kind": "single"}
    if _is_dtensor(x):
        desc = _dtensor_desc(x)
        x = x.to_local()
    on_device = bool(x.is_cuda)
    x = x.detach().as_subclass(torch.Tensor)
    if on_device:
        host = torch.empty(tuple(x.shape), dtype=x.dtype)
        host.copy_(x)
        _bump("d2h_copies")
        _bump("d2h_bytes", host.numel() * host.element_size())
    else:
        host = x.contiguous()
        _bump("host_leaves")
    _bump("leaves_packed")
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return _LeafPack(tuple(x.shape), str(x.dtype).replace("torch.", ""), "torch", desc,
                     pickle.PickleBuffer(raw))


def _pack_numpy(x: np.ndarray) -> _LeafPack:
    v = np.ascontiguousarray(x)
    _bump("host_leaves")
    _bump("leaves_packed")
    return _LeafPack(tuple(x.shape), v.dtype.str, "numpy", {"kind": "single"},
                     pickle.PickleBuffer(v.reshape(-1).view(np.uint8)))


def pack_device_value(value: Any) -> DeviceEnvelope:
    """Tree -> DeviceEnvelope.  Tensor leaves (CUDA, CPU, DTensor) and
    numeric numpy leaves become packed leaves that land on the consumer's
    device; everything else stays in the skeleton."""
    torch = _torch()
    leaves: List[_LeafPack] = []
    keepalive: List[Any] = []

    def repl(x):
        if torch is not None and isinstance(x, torch.Tensor):
            packed = pack_leaf(x)
        elif isinstance(x, np.ndarray) and x.dtype.kind in "biufc":
            packed = _pack_numpy(x)
        else:
            return x
        keepalive.append(x)
        leaves.append(packed)
        return _LeafMarker(len(leaves) - 1)

    skeleton = _tree_map(repl, value)
    return DeviceEnvelope(skeleton, leaves, keepalive)


# ------------------------------------------------------------------- unpack


def _landing_device():
    """cuda:<current> where a GPU is visible, else the CPU."""
    import torch

    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _host_view(leaf: _LeafPack):
    """The leaf's bytes as a host tensor of its dtype and shape (a view of
    the payload: never written, copied by the landing)."""
    import torch

    with warnings.catch_warnings():
        # the payload is read-only; the view is only ever copied from
        warnings.simplefilter("ignore", UserWarning)
        if leaf.kind == "numpy":
            arr = np.frombuffer(leaf.buf, dtype=np.dtype(leaf.dtype))
            return torch.from_numpy(arr).reshape(leaf.shape)
        raw = torch.from_numpy(np.frombuffer(leaf.buf, dtype=np.uint8))
    return raw.view(getattr(torch, leaf.dtype)).reshape(leaf.shape)


def _to(t, device):
    """A copy of host view t on device, counted by where it landed."""
    _bump("cuda_landings" if device.type == "cuda" else "cpu_landings")
    return t.to(device) if device.type == "cuda" else t.clone()


def _decode_placement(p):
    from torch.distributed.tensor import Partial, Replicate, Shard

    if p[0] == "shard":
        return Shard(p[1])
    if p[0] == "replicate":
        return Replicate()
    return Partial(p[1])


def _landing_mesh(desc: Dict[str, Any]):
    with _lock:
        meshes = list(reversed(_mesh_registry))
    for m in meshes:
        if (tuple(int(n) for n in m.mesh.shape) == desc["mesh_shape"]
                and tuple(m.mesh_dim_names or ()) == desc["axis_names"]
                and tuple(m.get_coordinate() or ()) == desc["coord"]):
            return m
    return None


def _land_dtensor(leaf: _LeafPack, host):
    import torch

    desc = leaf.desc
    kinds = {p[0] for p in desc["placements"]}
    mesh = _landing_mesh(desc)
    if mesh is not None:
        from torch.distributed.tensor import DTensor

        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda" else torch.device(mesh.device_type))
        gshape = desc["global_shape"]
        stride, acc = [], 1
        for n in reversed(gshape):
            stride.insert(0, acc)
            acc *= n
        _bump("sharded_landings")
        return DTensor.from_local(
            _to(host, device), mesh, [_decode_placement(p) for p in desc["placements"]],
            run_check=False, shape=torch.Size(gshape), stride=tuple(stride),
        )
    spec = (f"DTensor {desc['global_shape']} placements {desc['placements']} on a mesh "
            f"{dict(zip(desc['axis_names'], desc['mesh_shape']))} at {desc['coord']}")
    if kinds == {"replicate"}:
        _bump("whole_landings")
        return _to(host, _landing_device())
    if "partial" not in kinds and tuple(leaf.shape) == tuple(desc["global_shape"]):
        if _strict():
            raise RuntimeError(
                f"device transport would drop the sharding of a {spec} (no matching mesh "
                "registered with set_transfer_mesh) under CA_DEVICE_TRANSPORT_STRICT"
            )
        _bump("host_assembles")
        return _to(host, _landing_device())
    raise RuntimeError(
        f"device transport cannot land a {spec}: no mesh registered with "
        "set_transfer_mesh has its shape and dim names with this process at that "
        "coordinate, and its other shards are held by other processes"
    )


def land_leaf(leaf: _LeafPack):
    """One packed leaf landed on this process's device (a DTensor leaf
    over the registered mesh); also the unpickling hook of a CUDA tensor
    that core/serialization.py's reducer met."""
    _bump("leaves_landed")
    host = _host_view(leaf)
    if leaf.desc["kind"] == "dtensor":
        return _land_dtensor(leaf, host)
    return _to(host, _landing_device())


def unpack_device_value(env: DeviceEnvelope) -> Any:
    """DeviceEnvelope -> tree with tensor leaves on this process's device
    (DTensor leaves over the registered mesh)."""
    landed = [land_leaf(leaf) for leaf in env.leaves]
    return _tree_map(lambda x: landed[x.i] if isinstance(x, _LeafMarker) else x, env.skeleton)


def maybe_unpack(value: Any) -> Any:
    """Pass-through helper for channel/RPC read sites."""
    if isinstance(value, DeviceEnvelope):
        return unpack_device_value(value)
    return value


def land_tree(value: Any) -> Any:
    """A tree whose tensor and numpy leaves have landed on this process's
    device (a plain value read from a tensor-transport channel)."""
    return unpack_device_value(pack_device_value(value))
