"""ObjectRef / DeviceRef handles.

ObjectRef is the future-like handle returned by `put()` and `.remote()`.
Mirrors the reference's ObjectRef (python/ray/includes/object_ref.pxi) incl.
refcount notification on destruction so the owner can GC shared-memory data.

DeviceRef is the device extension: a handle to CUDA tensors (or a tree of
them) that live on the card inside the owning process and are never copied
to the host when passed back into that process's methods: the owner
resolves it to the stored object itself.  Any other process that asks for
the value gets it through channel/device_transport, landed on its own
device.  A CUDA tensor put, passed as an argument or returned from a task
is kept so (core/worker.py `device_objects`).
"""

from __future__ import annotations

from typing import Any, Optional

from .ids import ObjectID


class ObjectRef:
    __slots__ = ("id", "owner", "_worker", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: Optional[str] = None, worker=None):
        self.id = object_id
        self.owner = owner  # client id of the owning process
        self._worker = worker
        if worker is not None:
            if owner is not None:
                # ownership plane: remember who settles this ref's counts so
                # inc/dec route to the owner's ledger, not the head
                worker.note_borrowed_owner(self.id.binary(), owner)
            if worker.reference_counter.add_local_ref(self.id) == 1:
                # a handle came back for an object whose local refs all died
                # (e.g. returned from an actor): its producing task's lineage
                # must no longer count it dead, or the spec could be dropped
                # while this ref still needs it for reconstruction
                worker.lineage_revive(self.id)

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def future(self):
        """A concurrent.futures.Future resolving to the object's value."""
        from .worker import global_worker

        return global_worker().resolve_future(self)

    def __await__(self):
        import asyncio

        return asyncio.wrap_future(self.future()).__await__()

    def __del__(self):
        w = self._worker
        if w is not None:
            try:
                w.reference_counter.remove_local_ref(self.id)
            except Exception:
                pass

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __reduce__(self):
        # Serialized refs travel through task specs; the receiving process
        # reconstructs a handle registered with its local worker so borrowed
        # references are counted.  The sender additionally captures every
        # nested ref it pickles (serialization.ref_capture) and pins it at
        # the head until the receiver's own registration lands — without the
        # pin, the sender dropping its handle mid-transit would let the head
        # GC an object the receiver is about to use (reference_count.h
        # borrowing protocol, centralized-ownership form).
        from .serialization import note_serialized_ref

        note_serialized_ref(self.id.binary())
        return (_rehydrate_ref, (type(self).__name__, self.id.binary(), self.owner))


class DeviceRef(ObjectRef):
    __slots__ = ("spec",)

    def __init__(self, object_id, owner=None, worker=None, spec: Any = None):
        super().__init__(object_id, owner, worker)
        # spec: lightweight description (shapes/dtypes/devices) for display
        # and for shape-checking without touching the device data.
        self.spec = spec

    def __repr__(self):
        return f"DeviceRef({self.id.hex()}, owner={self.owner}, spec={self.spec})"

    def __reduce__(self):
        from .serialization import note_serialized_ref

        note_serialized_ref(self.id.binary())
        return (_rehydrate_device_ref, (self.id.binary(), self.owner, self.spec))


def _rehydrate_ref(kind: str, id_bytes: bytes, owner):
    from .worker import try_global_worker

    w = try_global_worker()
    return ObjectRef(ObjectID(id_bytes), owner, w)


def _rehydrate_device_ref(id_bytes: bytes, owner, spec):
    from .worker import try_global_worker

    w = try_global_worker()
    return DeviceRef(ObjectID(id_bytes), owner, w, spec)
