"""Unique identifiers for jobs, tasks, actors, objects, nodes and workers.

Design parity: the reference packs lineage metadata into its IDs
(src/ray/common/id.h). We keep the same *derivation* property — an ObjectID is
derived from the TaskID that produces it plus a return index — so that lineage
reconstruction can recover "which task created this object" from the ID alone.
IDs are fixed-width random bytes, hex-printable.
"""

from __future__ import annotations

import os
import threading

# Fast unique-byte generator for hot ID paths (task submission creates 2+ IDs
# per call; os.urandom is a ~15-20us getrandom syscall each).  Uniqueness =
# per-process random prefix (refreshed on fork, keyed by pid) + 6-byte counter.
_uniq_lock = threading.Lock()
_uniq_pid: int = -1
_uniq_prefix: bytes = b""
_uniq_count: int = 0


def _unique_bytes(n: int) -> bytes:
    """n unique bytes: (n-6)-byte per-process random prefix + 6-byte counter
    (2^48 ids/process).  Cross-process collision bound is the prefix's
    min(n-6, 16) random bytes — >= 2^48 for the 12-byte TaskID suffix."""
    global _uniq_pid, _uniq_prefix, _uniq_count
    with _uniq_lock:
        pid = os.getpid()
        if pid != _uniq_pid:
            _uniq_pid = pid
            _uniq_prefix = os.urandom(16)
            _uniq_count = 0
        _uniq_count += 1
        c = _uniq_count
    return _uniq_prefix[: n - 6] + c.to_bytes(6, "big")

_JOB_ID_SIZE = 4
_ACTOR_ID_SIZE = 12
_TASK_ID_SIZE = 16
_OBJECT_ID_SIZE = 20
_NODE_ID_SIZE = 16
_WORKER_ID_SIZE = 16
_PG_ID_SIZE = 16

NIL = b"\x00"


class BaseID:
    SIZE = 16
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = id_bytes
        self._hash = None

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(NIL * cls.SIZE)

    @classmethod
    def from_hex(cls, h: str):
        return cls(bytes.fromhex(h))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def is_nil(self) -> bool:
        return self._bytes == NIL * self.SIZE

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self):
        # IDs key every hot-path dict (pending stores, ref counts, holders);
        # cache the hash instead of rehashing 16-20 bytes per lookup
        h = self._hash
        if h is None:
            h = self._hash = hash(self._bytes)
        return h

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE


class ActorID(BaseID):
    SIZE = _ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(cls.SIZE - JobID.SIZE) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bytes[-JobID.SIZE :])


class TaskID(BaseID):
    SIZE = _TASK_ID_SIZE

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        return cls(_unique_bytes(cls.SIZE - JobID.SIZE) + job_id.binary())

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        # Not derived from the 12-byte ActorID: embedding it would leave only
        # 4 distinguishing bytes — colliding with realistic call counts
        # (birthday bound ~2^16 calls).  Actor attribution lives in the task
        # spec instead.
        return cls(_unique_bytes(cls.SIZE))


class ObjectID(BaseID):
    """Derived from (producing TaskID, return index): first 16 bytes are the
    TaskID, last 4 bytes the big-endian return index. `ray.put` objects use a
    put-index with the high bit set, mirroring the reference's put/return split
    (src/ray/common/id.h ObjectID::FromIndex)."""

    SIZE = _OBJECT_ID_SIZE
    _PUT_BIT = 0x80000000

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        return cls(task_id.binary() + (cls._PUT_BIT | put_index).to_bytes(4, "big"))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def is_put(self) -> bool:
        return bool(int.from_bytes(self._bytes[-4:], "big") & self._PUT_BIT)

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[-4:], "big") & ~self._PUT_BIT


class NodeID(BaseID):
    SIZE = _NODE_ID_SIZE


class WorkerID(BaseID):
    SIZE = _WORKER_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = _PG_ID_SIZE


class _Counter:
    """Thread-safe monotonically increasing counter (per-process)."""

    def __init__(self, start: int = 0):
        self._value = start
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
