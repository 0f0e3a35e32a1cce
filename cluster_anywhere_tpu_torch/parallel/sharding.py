"""Sharding rules: logical array axes -> mesh axes -> DTensor placements.

Counterpart of cluster_anywhere_tpu/parallel/sharding.py.  Parameters and
activations are named by *logical* axes ("batch", "seq", "embed",
"heads", "mlp", "vocab", "layers", "experts"); a rule table maps each to a
mesh axis (or None = replicated), giving a PartitionSpec as in JAX: one
entry per tensor dim, each None, a mesh axis name, or a tuple of names
(major first).  `placements` turns a spec into the DTensor placements
over a mesh from parallel.mesh (one per mesh dim, Shard or Replicate), and
`named_sharding`, `shard_pytree` and `constraint` are the JAX helpers over
`distribute_tensor` and `redistribute`.  `local_shard` is the slice of a
full tensor that a rank holds under a spec, without a collective.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from .mesh import AXES, axis_index, axis_size


class PartitionSpec(tuple):
    """A tuple of per-dim mesh axes (None, a name, or a tuple of names),
    as jax.sharding.PartitionSpec."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec

# default logical->mesh rules for transformer training
DEFAULT_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "batch": ("dp", "fsdp"),  # batch sharded over both data axes
    "seq": "sp",
    "embed": None,
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
    "layers": None,  # pp handled by stage stacking, not by a placement
    "experts": "ep",
    "expert_mlp": "tp",
    # fsdp param sharding: applied to the largest axis of each weight
    "fsdp_shard": "fsdp",
}


def logical_to_spec(
    logical: Sequence[Optional[str]], rules: Optional[Dict] = None
) -> PartitionSpec:
    rules = {**DEFAULT_RULES, **(rules or {})}
    out = [None if name is None else rules.get(name) for name in logical]
    # trim trailing Nones for canonical specs
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: PartitionSpec) -> tuple:
    """The DTensor placements of `spec` over a mesh with the AXES dims (as
    parallel.make_mesh's): Shard(d) on each mesh dim that shards tensor
    dim d, Replicate elsewhere.  Several axes on one dim shard it in mesh
    order, dp outermost, so a tuple entry must list them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in AXES]
    for dim, entry in enumerate(spec):
        names = spec_axes(entry)
        if list(names) != sorted(names, key=AXES.index):
            raise ValueError(f"spec entry {entry!r} must list its axes in mesh order {AXES}")
        for name in names:
            if not isinstance(out[AXES.index(name)], Replicate):
                raise ValueError(f"mesh axis {name!r} shards two dims in {spec!r}")
            out[AXES.index(name)] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh, as jax.sharding.NamedSharding."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec)


def named_sharding(mesh, *logical, rules=None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical, rules))


def shard_pytree(tree: Any, specs: Any, mesh):
    """distribute_tensor every leaf of a nested dict/list by the matching
    PartitionSpec (None leaves stay None); the same full tensor on every
    rank becomes a DTensor holding this rank's shard."""
    from torch.distributed.tensor import distribute_tensor

    if tree is None:
        return None
    if isinstance(specs, PartitionSpec):
        return distribute_tensor(tree, mesh, placements(specs))
    if isinstance(tree, dict):
        return {k: shard_pytree(v, specs[k], mesh) for k, v in tree.items()}
    return type(tree)(shard_pytree(v, s, mesh) for v, s in zip(tree, specs))


def constraint(x, mesh, *logical, rules=None):
    """x (a DTensor) redistributed to the placements of its logical names."""
    return x.redistribute(mesh, placements(logical_to_spec(logical, rules)))


def local_shard(x, spec: PartitionSpec, mesh):
    """This rank's block of the full tensor x under `spec` (a view), the
    to_local() of distribute_tensor(x, mesh, placements(spec)) for sizes
    that divide evenly, with no collective."""
    for dim, entry in enumerate(spec):
        n, idx = 1, 0
        for name in spec_axes(entry):
            n, idx = n * axis_size(mesh, name), idx * axis_size(mesh, name) + axis_index(mesh, name)
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {entry!r} ({n})")
            c = x.shape[dim] // n
            x = x.narrow(dim, idx * c, c)
    return x


def full_tensor(x, spec: PartitionSpec, mesh):
    """The full tensor from every rank's block x under `spec` (allgathers
    over the spec's axes, minor first), on every rank; no autograd."""
    from .collectives import tensor_plane

    with torch.no_grad():
        for dim, entry in enumerate(spec):
            for name in reversed(spec_axes(entry)):
                x = tensor_plane.allgather(x, mesh, name, axis=dim)
    return x


# --- shard-chunk geometry (the resharding read path of sharded checkpoints) ---
#
# A "box" is a device shard's global index as plain data: [[start, stop], ...]
# one pair per dimension (a scalar's box is []).  Boxes serialize to JSON, so
# per-rank shard manifests can describe where each saved chunk lives in the
# global array without pickling slice objects; extract_region stitches any
# requested box back together from whatever chunking the SAVING mesh used —
# which is what lets an 8-way checkpoint restore onto a 6-way mesh.


def index_box(index, shape) -> list:
    """Normalize a shard index (a tuple of slices) into a box against the
    global `shape`."""
    box = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = int(dim) if sl.stop is None else int(sl.stop)
        box.append([start, stop])
    return box


def box_shape(box) -> tuple:
    return tuple(b[1] - b[0] for b in box)


def box_volume(box) -> int:
    n = 1
    for b in box:
        n *= b[1] - b[0]
    return n


def boxes_cover(boxes, shape) -> bool:
    """Do `boxes` exactly tile an array of `shape`?  In-bounds + pairwise
    disjoint + volumes summing to the array's volume is equivalent to an
    exact tiling on an integer grid (the union's volume equals the space's
    and the union is contained in it).  The disjointness check matters:
    volume alone would accept overlapping-but-gapped layouts — e.g. stale
    and fresh manifests with different chunkings in one dir — and a restore
    would then return uninitialized memory for the gap instead of raising."""
    total = 1
    for dim in shape:
        total *= int(dim)
    seen = [
        list(map(list, b))
        for b in {tuple(map(tuple, b)) for b in boxes}
    ]
    for b in seen:
        if any(lo < 0 or hi > int(dim) for (lo, hi), dim in zip(b, shape)):
            return False
    for i, a in enumerate(seen):
        for b in seen[i + 1:]:
            if all(
                max(x[0], y[0]) < min(x[1], y[1]) for x, y in zip(a, b)
            ):
                return False  # a (non-empty) overlap
    return sum(box_volume(b) for b in seen) == total


def extract_region(box, chunks):
    """Assemble the global region `box` from (chunk_box, ndarray) pairs.

    Chunks may be laid out by ANY partitioning of the global array; every
    element of the requested region must be covered (boxes_cover guards
    this at manifest-load time).  This is the topology-portable restore
    primitive: the target mesh asks for its shard's box, and the answer is
    stitched from whichever saved chunks overlap it."""
    import numpy as np

    if not box:  # scalar
        for cbox, arr in chunks:
            return np.asarray(arr).copy()
        raise ValueError("no chunk covers the requested scalar")
    if box_volume(box) == 0:
        # a zero-sized region has no elements to stitch, but still needs
        # the right shape and dtype — the overlap loop below would find no
        # intersecting chunk (every interval is empty) and misread an
        # empty leaf as missing coverage
        for cbox, arr in chunks:
            return np.empty(box_shape(box), dtype=np.asarray(arr).dtype)
        raise ValueError(f"no chunk describes empty region {box}")
    out = None
    for cbox, arr in chunks:
        inter = [
            (max(b[0], c[0]), min(b[1], c[1])) for b, c in zip(box, cbox)
        ]
        if any(lo >= hi for lo, hi in inter):
            continue
        if out is None:
            out = np.empty(box_shape(box), dtype=np.asarray(arr).dtype)
        dst = tuple(
            slice(lo - b[0], hi - b[0]) for (lo, hi), b in zip(inter, box)
        )
        src = tuple(
            slice(lo - c[0], hi - c[0]) for (lo, hi), c in zip(inter, cbox)
        )
        out[dst] = np.asarray(arr)[src]
    if out is None:
        raise ValueError(f"no chunk overlaps requested region {box}")
    return out
