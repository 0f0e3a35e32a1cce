"""Checkpoint: a directory of files, referenced by path.

Analogue of the reference's `ray.train.Checkpoint`
(python/ray/train/_checkpoint.py) and `_CheckpointManager`
(train/_internal/checkpoint_manager.py: keep-K by score attribute).

Counterpart of cluster_anywhere_tpu/train/checkpoint.py, whose
directory, metadata and keep-K logic it copies.  Model state is a tree of
dicts, lists and tuples over torch tensors (or numpy arrays, or scalars);
`save_pytree`/`load_pytree` store it with numpy .npz + a structure pickle,
in the JAX package's leaf order (dict keys sorted, as jax.tree_util does)
and with its `.npz` member names, so checkpoints are host-portable and
never require the saving mesh to reload.  Each tensor is copied to the host
explicitly (`.detach().cpu()`); a dtype numpy cannot hold (bfloat16)
raises rather than being converted.  The structure file holds the port's
own description of the tree (builtins only); the two packages' structure
files are not interchangeable.

The sharded variants take the mesh and the leaves' PartitionSpecs:
the port's sharded model holds each rank's LOCAL tensors (laid out by
models.transformer.param_specs), where a jax.Array knows its own global
boxes.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .config import CheckpointConfig

_METADATA_FILE = ".ca_checkpoint_metadata.json"


def _atomic_write(path: str, write_fn, mode: str = "wb") -> None:
    """Write via unique tmp + rename, unlinking the tmp on failure: a
    preemption kill mid-write must never leave a truncated shard (or tmp
    litter) where a restore expects a file."""
    tmp = os.path.join(
        os.path.dirname(path), f".{os.path.basename(path)}.{uuid.uuid4().hex[:6]}.tmp"
    )
    try:
        with open(tmp, mode) as f:
            write_fn(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _atomic_savez(path: str, arrays: Dict[str, Any]) -> None:
    import numpy as np

    _atomic_write(path, lambda f: np.savez(f, **arrays))


def _atomic_write_json(path: str, obj: Any) -> None:
    _atomic_write(path, lambda f: json.dump(obj, f), mode="w")


# ---- tree structure, in jax.tree_util's leaf order ------------------------
#
# A treedef is builtins only: "*" for a leaf, ("none",) for None (an empty
# subtree, as in JAX), ("dict", keys, children) with the keys sorted (an
# OrderedDict keeps its order, as in JAX), ("list", children) and
# ("tuple", children).  Anything else is a leaf.

_LEAF = "*"


def tree_flatten(tree: Any, is_leaf=None) -> Tuple[List[Any], Any]:
    """(leaves, treedef) of `tree`, leaves in jax.tree_util's order."""
    from collections import OrderedDict

    leaves: List[Any] = []

    def walk(x):
        if is_leaf is not None and is_leaf(x):
            leaves.append(x)
            return _LEAF
        if x is None:
            return ("none",)
        if isinstance(x, dict):
            keys = list(x) if isinstance(x, OrderedDict) else sorted(x)
            return ("dict", keys, [walk(x[k]) for k in keys])
        if type(x) in (list, tuple):
            return (type(x).__name__, [walk(v) for v in x])
        leaves.append(x)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(d):
        if d == _LEAF:
            return next(it)
        kind = d[0]
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        children = [build(c) for c in d[1]]
        return children if kind == "list" else tuple(children)

    return build(treedef)


class _TreedefUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"the structure file names {module}.{name}: it was not written by "
            "cluster_anywhere_tpu_torch (the JAX package's treedef files hold "
            "jax classes and are not interchangeable with the port's)"
        )


def _load_treedef(path: str) -> Any:
    with open(path, "rb") as f:
        return _TreedefUnpickler(io.BytesIO(f.read())).load()


def _torch_tensor(x) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _np_dtype(t):
    """The numpy dtype of a torch tensor's dtype; raises for one numpy
    cannot hold (bfloat16), which is never converted silently."""
    import torch

    try:
        return torch.empty(0, dtype=t.dtype).numpy().dtype
    except TypeError:
        raise TypeError(
            f"a checkpoint leaf of dtype {t.dtype} has no numpy dtype: cast it "
            "to one (e.g. float32) before saving"
        ) from None


def _host(leaf):
    """A leaf as a host numpy array: a tensor copied to the host explicitly."""
    import numpy as np

    if _torch_tensor(leaf):
        _np_dtype(leaf)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _spec_list(specs: Any, n: int) -> List[Any]:
    """One PartitionSpec (None = replicated) per leaf of an n-leaf tree."""
    from ..parallel.sharding import PartitionSpec

    if specs is None:
        return [PartitionSpec()] * n
    if isinstance(specs, PartitionSpec):
        return [specs] * n
    spec_list, _ = tree_flatten(
        specs, is_leaf=lambda x: x is None or isinstance(x, PartitionSpec)
    )
    if len(spec_list) != n:
        raise ValueError(f"specs pytree has {len(spec_list)} leaves, checkpoint has {n}")
    return [s if s is not None else PartitionSpec() for s in spec_list]


def _mesh_box(global_shape, spec, mesh) -> Tuple[list, bool]:
    """(this rank's box of a leaf of `global_shape` laid out by `spec` on
    `mesh`, whether this rank writes it): the box from the rank's mesh
    coordinates (dims split over several axes major first, as
    sharding.local_shard), and the writer is the rank whose coordinate is
    0 on every mesh axis the leaf is replicated over (JAX's replica 0)."""
    from ..parallel.mesh import AXES, axis_index, axis_size
    from ..parallel.sharding import index_box, spec_axes

    used = set()
    index = []
    for dim, size in enumerate(global_shape):
        entry = spec[dim] if dim < len(spec) else None
        n, idx = 1, 0
        for name in spec_axes(entry):
            n, idx = n * axis_size(mesh, name), idx * axis_size(mesh, name) + axis_index(mesh, name)
            used.add(name)
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(global_shape)} does not split over {entry!r} ({n})")
        c = size // n
        index.append(slice(idx * c, (idx + 1) * c))
    writer = all(axis_index(mesh, a) == 0 for a in AXES if a not in used)
    return index_box(tuple(index), global_shape), writer


def _global_shape(local_shape, spec, mesh) -> Tuple[int, ...]:
    from ..parallel.mesh import axis_size
    from ..parallel.sharding import spec_axes

    out = []
    for dim, size in enumerate(local_shape):
        n = 1
        for name in spec_axes(spec[dim] if dim < len(spec) else None):
            n *= axis_size(mesh, name)
        out.append(int(size) * n)
    return tuple(out)


def _process_rank_world(process_index, num_processes) -> Tuple[int, int]:
    if process_index is not None and num_processes is not None:
        return process_index, num_processes
    rank, world = 0, 1
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    return (
        rank if process_index is None else process_index,
        world if num_processes is None else num_processes,
    )


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        """Copy checkpoint contents into `path` (default: a temp dir)."""
        dest = path or os.path.join(
            tempfile.gettempdir(), f"ca_ckpt_{uuid.uuid4().hex[:8]}"
        )
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextmanager
    def as_directory(self):
        """Context manager yielding a local directory with the contents.
        Local-fs checkpoints are yielded in place (no copy)."""
        yield self.path

    # -- metadata --------------------------------------------------------
    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _METADATA_FILE)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(metadata, f)

    # -- pytree helpers ----------------------------------------------------
    def save_pytree(self, tree: Any, name: str = "state") -> None:
        """Store a tree of tensors / arrays: leaves as .npz members
        leaf_0..leaf_{n-1} in jax.tree_util's order, each tensor copied to
        the host; the structure pickled (the port's own, builtins only)."""
        import numpy as np

        leaves, treedef = tree_flatten(tree)
        np.savez(
            os.path.join(self.path, f"{name}.npz"),
            **{f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)},
        )
        with open(os.path.join(self.path, f"{name}.treedef.pkl"), "wb") as f:
            pickle.dump(treedef, f)

    def load_pytree(self, name: str = "state") -> Any:
        """The saved tree with numpy leaves (as the JAX package returns)."""
        import numpy as np

        with np.load(os.path.join(self.path, f"{name}.npz")) as z:
            leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
        treedef = _load_treedef(os.path.join(self.path, f"{name}.treedef.pkl"))
        if treedef is None:
            return leaves[0]
        return tree_unflatten(treedef, leaves)

    # -- sharded pytree helpers (multi-process / topology-portable) -------
    #
    # `save_pytree` needs the WHOLE state in one process, which a sharded
    # model does not have (each rank holds its own shards) — and it forces
    # the restoring mesh to fit the full state per host.  The sharded variant writes, per
    # process, only the shards that process can address:
    #
    #   {name}.shard<p>.npz   chunk arrays (this process's replica-0 shards)
    #   {name}.shard<p>.json  chunk -> (leaf index, global index box)
    #   {name}.index.json     world size + per-leaf global shape/dtype (rank 0)
    #   {name}.treedef.pkl    pytree structure (rank 0)
    #
    # Restore stitches any target sharding from whatever chunking the SAVING
    # mesh used (parallel/sharding.py extract_region), so a checkpoint
    # written by an 8-process world reshards onto the 6-process mesh the
    # surviving nodes form — optimizer state re-laid-out included (cf.
    # automatic cross-replica sharding, arxiv 2004.13336).

    def is_sharded(self, name: Optional[str] = None) -> bool:
        """Does this checkpoint hold a rank-cooperative sharded pytree?
        With name=None (the session's register-in-place check) ANY sharded
        save counts, whatever it was named; any rank's shard manifest
        suffices — rank 0's index may not have landed yet while the barrier
        is still draining."""
        try:
            files = os.listdir(self.path)
        except OSError:
            return False
        if name is None:
            return any(
                f.endswith(".index.json")
                or (".shard" in f and f.endswith(".json"))
                for f in files
            )
        return any(
            f == f"{name}.index.json"
            or (f.startswith(f"{name}.shard") and f.endswith(".json"))
            for f in files
        )

    def save_pytree_sharded(
        self,
        tree: Any,
        name: str = "state",
        process_index: Optional[int] = None,
        num_processes: Optional[int] = None,
        mesh: Any = None,
        specs: Any = None,
    ) -> None:
        """Store this process's shards of a sharded tree.  Every rank of a
        gang calls this against the SAME directory.  With a mesh, each
        tensor leaf is this rank's LOCAL shard, laid out on `mesh` by its
        PartitionSpec in `specs` (a matching tree of specs, one spec for
        every leaf, or None = replicated); the rank writes its shard with
        its global index box when its coordinate is 0 on every axis the
        leaf is replicated over (JAX's replica 0).  Other leaves, and every
        leaf without a mesh, are written whole by process 0.  The process
        index and count default to the torch.distributed rank and world
        size (0 and 1 without a group).  Writes are atomic (tmp + rename)
        so a preemption kill mid-save never leaves a half-written shard for
        the restore to trip on."""
        import numpy as np

        leaves, treedef = tree_flatten(tree)
        process_index, num_processes = _process_rank_world(process_index, num_processes)
        spec_list = _spec_list(specs, len(leaves)) if mesh is not None else None
        chunks: Dict[str, Any] = {}
        meta: List[Dict[str, Any]] = []
        leaf_specs: List[Dict[str, Any]] = []

        def _add(leaf_i: int, box: list, data) -> None:
            key = f"l{leaf_i}c{len(meta)}"
            chunks[key] = data
            meta.append({"leaf": leaf_i, "key": key, "box": box})

        for i, leaf in enumerate(leaves):
            if _torch_tensor(leaf) and mesh is not None:
                shape = _global_shape(tuple(leaf.shape), spec_list[i], mesh)
                leaf_specs.append({"shape": list(shape), "dtype": str(_np_dtype(leaf))})
                box, writer = _mesh_box(shape, spec_list[i], mesh)
                if writer:
                    _add(i, box, _host(leaf))
                continue
            if _torch_tensor(leaf):  # attributes only: no copy off the card
                shape, dtype = tuple(leaf.shape), _np_dtype(leaf)
            else:
                arr = np.asarray(leaf)
                shape, dtype = arr.shape, arr.dtype
            leaf_specs.append({"shape": list(shape), "dtype": str(dtype)})
            if process_index == 0:
                arr = _host(leaf)
                if arr.dtype == object:
                    # savez would pickle an object array silently, but
                    # np.load(allow_pickle=False) on restore can never
                    # read it back — and sharded_complete (manifest-only)
                    # would keep steering resume into the poisoned dir.
                    # Fail at save time, not resume time.
                    raise TypeError(
                        f"save_pytree_sharded: leaf {i} is not array-like "
                        "(numpy can only represent it as an object array, "
                        "which a pickle-free restore cannot read)"
                    )
                _add(i, [[0, d] for d in shape], arr)
        _atomic_savez(
            os.path.join(self.path, f"{name}.shard{process_index}.npz"), chunks
        )
        _atomic_write_json(
            os.path.join(self.path, f"{name}.shard{process_index}.json"),
            {"process_index": process_index, "chunks": meta},
        )
        if process_index == 0:
            _atomic_write_json(
                os.path.join(self.path, f"{name}.index.json"),
                {
                    "version": 1,
                    "world_size": num_processes,
                    "num_leaves": len(leaves),
                    "leaves": leaf_specs,
                },
            )
            _atomic_write(
                os.path.join(self.path, f"{name}.treedef.pkl"),
                lambda f: pickle.dump(treedef, f),
            )
            # overwriting a dir saved by a LARGER world leaves stale
            # high-rank shards behind whose boxes would double-cover the
            # leaves and fail the restore's coverage check — sweep them
            for fn in os.listdir(self.path):
                pref = f"{name}.shard"
                if not fn.startswith(pref):
                    continue
                rank_str = fn[len(pref):].split(".", 1)[0]
                if rank_str.isdigit() and int(rank_str) >= num_processes:
                    try:
                        os.unlink(os.path.join(self.path, fn))
                    except OSError:
                        pass

    def _read_shard_directory(self, name: str = "state"):
        """Read a sharded checkpoint's manifests (no array loads): returns
        (index, per-leaf chunk directory) and raises ValueError when the
        chunk boxes do not fully cover every leaf — the coverage check that
        keeps a missing rank's shard from silently zero-filling a restore."""
        import glob as _glob

        from ..parallel.sharding import boxes_cover

        with open(os.path.join(self.path, f"{name}.index.json")) as f:
            index = json.load(f)
        if not os.path.exists(os.path.join(self.path, f"{name}.treedef.pkl")):
            # rank 0 writes the treedef LAST: an index without it means the
            # save was killed between the two writes — restorable data but
            # no structure to unflatten into, so the dir is incomplete
            raise ValueError(
                f"incomplete sharded checkpoint {self.path!r}: "
                f"{name}.treedef.pkl never landed"
            )
        # chunk directory: leaf -> [(box, shard_npz_path, key)]
        per_leaf: List[List[Tuple[list, str, str]]] = [
            [] for _ in range(index["num_leaves"])
        ]
        for mpath in sorted(
            _glob.glob(os.path.join(self.path, f"{name}.shard*.json"))
        ):
            with open(mpath) as f:
                m = json.load(f)
            if int(m.get("process_index", 0)) >= index["world_size"]:
                # stale shard from an earlier larger-world save into this
                # dir (save-side sweep may not have run against it)
                continue
            npz = mpath[: -len(".json")] + ".npz"
            for c in m["chunks"]:
                if not 0 <= c["leaf"] < index["num_leaves"]:
                    # a manifest left over from a save with a DIFFERENT
                    # tree structure: corrupt, not merely incomplete
                    raise ValueError(
                        f"sharded checkpoint {self.path!r}: manifest "
                        f"{os.path.basename(mpath)} references leaf "
                        f"{c['leaf']} but the index has "
                        f"{index['num_leaves']} leaves"
                    )
                per_leaf[c["leaf"]].append((c["box"], npz, c["key"]))
        for i, spec in enumerate(index["leaves"]):
            if not boxes_cover([b for b, _, _ in per_leaf[i]], spec["shape"]):
                raise ValueError(
                    f"incomplete sharded checkpoint {self.path!r}: leaf {i} "
                    f"(shape {spec['shape']}) is not fully covered by the "
                    f"saved shards — a rank's shard file is missing"
                )
        return index, per_leaf

    def sharded_complete(self, name: Optional[str] = None) -> bool:
        """Cheap (manifest-only) validity probe: does every leaf have full
        shard coverage?  False for a dir where a rank's save never landed
        (killed mid-write) — the controller skips such checkpoints when
        picking a resume point instead of retrying into the same error.
        name=None validates every sharded save in the dir (whatever names
        the loop used); a dir with shard files but no index (rank 0 never
        finished) is incomplete by definition."""
        try:
            if name is None:
                names = [
                    f[: -len(".index.json")]
                    for f in os.listdir(self.path)
                    if f.endswith(".index.json")
                ]
                if not names:
                    return False  # no index landed: not restorable at all
            else:
                names = [name]
            for nm in names:
                self._read_shard_directory(nm)
            return True
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return False

    def load_pytree_sharded(
        self,
        name: str = "state",
        mesh: Any = None,
        specs: Any = None,
    ) -> Any:
        """Restore a sharded pytree, resharding onto `mesh`.

        mesh=None: assemble full host (numpy) arrays — the single-process /
        inspection path.  With a mesh: `specs` gives the target layout (a
        matching pytree of PartitionSpec, one spec for every leaf, or None =
        fully replicated) and each leaf comes back as this rank's LOCAL
        tensor on the mesh's device, read from only the saved chunks that
        overlap its box.  The saving and restoring
        world sizes are independent: coverage is validated from the chunk
        boxes, and a missing rank's shard raises instead of zero-filling."""
        import numpy as np

        from ..parallel.sharding import extract_region

        index, per_leaf = self._read_shard_directory(name)
        treedef = _load_treedef(os.path.join(self.path, f"{name}.treedef.pkl"))
        files: Dict[str, Any] = {}

        def _load(npz: str, key: str):
            if npz not in files:
                files[npz] = np.load(npz)
            return files[npz][key]

        def _chunks(leaf_i: int, want: Optional[list] = None) -> List[Tuple[list, Any]]:
            """Materialize leaf chunks — only the ones intersecting `want`
            when given.  npz members decompress per key, so a process
            restoring onto a mesh reads ONLY the saved bytes overlapping
            its own shards, not the whole global array."""
            out = []
            for box, npz, key in per_leaf[leaf_i]:
                if want is not None and any(
                    max(b[0], w[0]) >= min(b[1], w[1])
                    for b, w in zip(box, want)
                ):
                    continue  # no (non-empty) intersection with the request
                out.append((box, _load(npz, key)))
            return out

        try:
            if mesh is None:
                from ..parallel.sharding import box_volume

                # zero-sized leaves rebuild from the index's recorded
                # shape/dtype alone — they may have no chunk at all (a
                # zero-volume leaf passes coverage vacuously), and there
                # are no elements to read anyway
                leaves = [
                    np.empty(tuple(spec["shape"]), dtype=spec["dtype"])
                    if spec["shape"]
                    and box_volume([[0, d] for d in spec["shape"]]) == 0
                    else extract_region(
                        [[0, d] for d in spec["shape"]], _chunks(i)
                    )
                    for i, spec in enumerate(index["leaves"])
                ]
            else:
                import torch

                from ..parallel.mesh import mesh_device
                from ..parallel.sharding import box_shape, box_volume

                spec_list = _spec_list(specs, index["num_leaves"])
                dev = mesh_device(mesh)
                leaves = []
                for i, spec in enumerate(index["leaves"]):
                    shape, dtype = tuple(spec["shape"]), spec["dtype"]
                    box, _ = _mesh_box(shape, spec_list[i], mesh)
                    if box_volume(box) == 0:
                        # an empty target shard has nothing to read — the
                        # index records shape/dtype, no chunk IO needed
                        region = np.empty(box_shape(box), dtype=dtype)
                    else:
                        region = extract_region(box, _chunks(i, want=box))
                    leaves.append(  # np.require keeps a 0-d leaf 0-d
                        torch.from_numpy(np.require(region, requirements="C")).to(dev)
                    )
        finally:
            for z in files.values():
                z.close()
        if treedef is None:
            return leaves[0]
        return tree_unflatten(treedef, leaves)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))


@dataclass
class _TrackedCheckpoint:
    checkpoint: Checkpoint
    index: int
    metrics: Dict[str, Any] = field(default_factory=dict)


class CheckpointManager:
    """Registers reported checkpoints, retains the top-K by the configured
    score attribute, deletes evicted checkpoint directories."""

    def __init__(self, config: Optional[CheckpointConfig] = None):
        self.config = config or CheckpointConfig()
        self._lock = threading.Lock()
        self._checkpoints: List[_TrackedCheckpoint] = []
        self._pending_delete: List[Checkpoint] = []
        self._next_index = 0

    def register(
        self, checkpoint: Checkpoint, metrics: Optional[Dict[str, Any]] = None
    ) -> _TrackedCheckpoint:
        with self._lock:
            tracked = _TrackedCheckpoint(checkpoint, self._next_index, metrics or {})
            self._next_index += 1
            # a re-registered path supersedes its older entry (dropped
            # WITHOUT deleting: they share the directory).  Rank-shared
            # sharded dirs are keyed by step, so a retry attempt that
            # re-runs a step re-saves into — and re-registers — the same
            # dir; two tracked entries aliasing one path would let keep-K
            # eviction of the stale entry rmtree the live checkpoint
            self._checkpoints = [
                t
                for t in self._checkpoints
                if t.checkpoint.path != checkpoint.path
            ]
            self._checkpoints.append(tracked)
            self._evict_locked()
            return tracked

    def _score(self, t: _TrackedCheckpoint) -> Tuple[float, int]:
        attr = self.config.checkpoint_score_attribute
        sign = 1.0 if self.config.checkpoint_score_order == "max" else -1.0
        if attr is None or attr not in t.metrics:
            # fall back to recency so unscored checkpoints behave FIFO
            return (float("-inf"), t.index)
        return (sign * float(t.metrics[attr]), t.index)

    # sharded dirs written to this recently may have a lagging rank still
    # mid-save (register-in-place: every rank writes the SAME dir, and the
    # driver registers on rank 0's report, not on all ranks finishing) —
    # deleting under the writer would error that rank and charge the
    # attempt to max_failures for an eviction race
    _SHARDED_EVICT_GRACE_S = 60.0

    def _evict_locked(self):
        # retry deferred deletions FIRST, even when nothing new gets
        # evicted this pass — the early return below must not strand them
        pending, self._pending_delete = self._pending_delete, []
        for ck in pending:
            self._delete_or_defer(ck)
        k = self.config.num_to_keep
        if k is None or len(self._checkpoints) <= k:
            return
        latest = self._checkpoints[-1]
        ranked = sorted(self._checkpoints, key=self._score, reverse=True)
        keep = ranked[:k]
        if latest not in keep:  # the latest is always kept for resume
            keep = keep[: k - 1] + [latest]
        keep_paths = {t.checkpoint.path for t in keep}
        for t in self._checkpoints:
            if t not in keep and t.checkpoint.path not in keep_paths:
                self._delete_or_defer(t.checkpoint)
        self._checkpoints = [t for t in self._checkpoints if t in keep]

    def finalize(self):
        """Run teardown: force-delete evictions still deferred by the
        write-grace window.  The grace protects lagging ranks mid-save;
        once the worker group is down there are no writers left, and
        leaving the dirs would quietly turn keep-K into keep-K-plus-tail
        (multi-GB state per leaked dir)."""
        with self._lock:
            pending, self._pending_delete = self._pending_delete, []
            for ck in pending:
                shutil.rmtree(ck.path, ignore_errors=True)

    def _delete_or_defer(self, ck: Checkpoint) -> None:
        """rmtree an evicted checkpoint dir, unless it is a sharded dir
        whose files changed within the grace window (a lagging rank may
        still be writing) — those go to the pending list and are retried
        on the next eviction."""
        try:
            if ck.is_sharded() and (
                time.time() - os.path.getmtime(ck.path)
                < self._SHARDED_EVICT_GRACE_S
            ):
                self._pending_delete.append(ck)
                return
        except OSError:
            pass  # already gone / unreadable: fall through to rmtree
        shutil.rmtree(ck.path, ignore_errors=True)

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._checkpoints:
                return None
            return max(self._checkpoints, key=self._score).checkpoint

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._checkpoints:
                return None
            return self._checkpoints[-1].checkpoint

    def checkpoints_newest_first(self) -> List[Checkpoint]:
        """Registration order, newest first — the controller walks this to
        find the newest RESUMABLE checkpoint (skipping sharded dirs whose
        ranks were killed mid-save)."""
        with self._lock:
            return [t.checkpoint for t in reversed(self._checkpoints)]

    def best_checkpoints(self) -> List[Tuple[Checkpoint, Dict[str, Any]]]:
        with self._lock:
            ranked = sorted(self._checkpoints, key=self._score, reverse=True)
            return [(t.checkpoint, dict(t.metrics)) for t in ranked]
