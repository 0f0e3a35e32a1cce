"""In-process memory store + node-local shared-memory store client.

MemoryStore is the analogue of the reference's CoreWorkerMemoryStore
(src/ray/core_worker/store_provider/memory_store/memory_store.h): small
objects and inlined task returns, resolved in-process without shm.

ShmObjectStore is the plasma analogue (src/ray/object_manager/plasma/): a
node-local shared-memory arena for large immutable objects, zero-copy mapped
by every process on the node.  Unlike plasma there is no store daemon on the
data path: the *producer* creates and seals a per-object shm segment and
registers it with the head; readers mmap it directly.  Accounting/eviction is
centralized at the head (refcount-based GC).  A native C++ helper
(native/shmstore) accelerates large copies with parallel memcpy when built.
"""

from __future__ import annotations

import mmap
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from . import serialization
from .errors import ObjectStoreFullError, StaleObjectError, TaskError
from .ids import ObjectID

SHM_DIR = "/dev/shm"

# Arena slices carry an 8-byte seal sequence ahead of the payload; slice
# names embed the same sequence ("arena@off+size#seq").  A reader whose name
# no longer matches the in-memory sequence is holding a RECYCLED slice and
# gets StaleObjectError instead of silently reading another object's bytes
# (the store then re-resolves through the head: GC'd-and-reused, or spilled).
_SLICE_HDR = 8


@dataclass
class _Entry:
    state: str  # "pending" | "value" | "packed" | "shm" | "error"
    value: Any = None
    packed: Optional[bytes] = None
    shm_name: Optional[str] = None
    error: Optional[BaseException] = None
    size: int = 0


class _Waiter:
    """One blocked wait_ready call: a countdown over a pending-oid set.
    Stores do O(1) membership work per arriving object instead of the waiter
    rescanning its whole list per wakeup (which made a 4k-ref get O(N*wakeups)
    in both scans and thread wakeups)."""

    __slots__ = ("pending", "needed", "event")

    def __init__(self, pending: set, needed: int):
        self.pending = pending
        self.needed = needed
        self.event = threading.Event()


class MemoryStore:
    """Thread-safe in-process object table with blocking waits."""

    def __init__(self):
        self._entries: Dict[ObjectID, _Entry] = {}
        self._lock = threading.Lock()
        self._waiters: List[_Waiter] = []

    def _store(self, oid: ObjectID, entry: _Entry):
        with self._lock:
            self._entries[oid] = entry
            for w in self._waiters:
                if oid in w.pending:
                    w.pending.discard(oid)
                    w.needed -= 1
                    if w.needed <= 0:
                        w.event.set()

    def put_value(self, oid: ObjectID, value: Any, size: int = 0):
        self._store(oid, _Entry("value", value=value, size=size))

    def put_packed(self, oid: ObjectID, packed: bytes):
        self._store(oid, _Entry("packed", packed=packed, size=len(packed)))

    def put_shm(self, oid: ObjectID, shm_name: str, size: int):
        self._store(oid, _Entry("shm", shm_name=shm_name, size=size))

    def put_error(self, oid: ObjectID, error: BaseException):
        self._store(oid, _Entry("error", error=error))

    def mark_pending(self, oid: ObjectID):
        with self._lock:
            self._entries.setdefault(oid, _Entry("pending"))

    def reset_pending(self, oid: ObjectID):
        """Force an entry back to pending (lineage reconstruction re-executes
        the creating task and refills it)."""
        with self._lock:
            self._entries[oid] = _Entry("pending")

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(oid)
            return e is not None and e.state != "pending"

    def get_entry(self, oid: ObjectID) -> Optional[_Entry]:
        with self._lock:
            return self._entries.get(oid)

    def wait_ready(self, oids: List[ObjectID], num_returns: int, timeout: Optional[float]) -> Tuple[List[ObjectID], List[ObjectID]]:
        """Block until num_returns of oids are ready (or timeout). Returns
        (ready, not_ready) preserving input order — `wait()` semantics of the
        reference (python/ray/_private/worker.py:2868)."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            pending = {
                o
                for o in oids
                if (e := self._entries.get(o)) is None or e.state == "pending"
            }
            # duplicates in oids count once: needed is in unique-oid units
            n_unique = len(set(oids))
            needed = num_returns - (n_unique - len(pending))
            if needed > len(pending):
                needed = len(pending)
            waiter = _Waiter(pending, needed)
            if needed > 0:
                self._waiters.append(waiter)
        try:
            if waiter.needed > 0:
                remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
                waiter.event.wait(remaining)
        finally:
            with self._lock:
                if waiter in self._waiters:
                    self._waiters.remove(waiter)
                pending_set = set(waiter.pending)
        ready_list, rest = [], []
        for o in oids:
            if o not in pending_set and len(ready_list) < num_returns:
                ready_list.append(o)
            else:
                rest.append(o)
        return ready_list, rest

    def delete(self, oid: ObjectID):
        with self._lock:
            self._entries.pop(oid, None)

    def keys(self):
        with self._lock:
            return list(self._entries.keys())


_PAGE = 4096
_ARENA_DEFAULT = 256 * 1024 * 1024  # first arena size
# Objects up to this size ride the pre-faulted arena path (puts pay memcpy
# only); larger ones get dedicated segments.  16 GiB keeps multi-GiB objects
# (the reference's 100 GiB-object envelope is stitched from such puts) off
# the first-touch-fault path.
_ARENA_MAX_OBJ = 1 << 34


def _align_up(n: int, a: int = _PAGE) -> int:
    return (n + a - 1) & ~(a - 1)


class _Arena:
    """One pre-faulted shm file carved into object slices (plasma-style
    arena, design per src/ray/object_manager/plasma/plasma_allocator.h: touch
    pages once up front so puts pay memcpy, not first-touch fault + memcpy;
    freed slices are reused already-hot).

    First-fit free list sorted by offset, coalescing on free.  The owner
    process is the only allocator; readers map the file read-only and slice.
    """

    __slots__ = ("name", "path", "size", "mm", "free", "lock", "_prefault_thread")

    def __init__(self, name: str, path: str, size: int):
        self.name = name
        self.path = path
        self.size = size
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            self.mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self.free: List[Tuple[int, int]] = [(0, size)]  # (offset, size), sorted
        self.lock = threading.Lock()
        # fault pages in the background: a put that outruns the prefault just
        # faults normally; after a few seconds the whole arena is hot
        self._prefault_thread = threading.Thread(
            target=self._prefault, name="ca-arena-prefault", daemon=True
        )
        self._prefault_thread.start()

    def _reserve_range(self, off: int, size: int) -> bool:
        """Carve exactly [off, off+size) out of the free list if fully free."""
        with self.lock:
            for i, (foff, fsz) in enumerate(self.free):
                if foff <= off and off + size <= foff + fsz:
                    self.free.pop(i)
                    if foff < off:
                        self.free.insert(i, (foff, off - foff))
                        i += 1
                    if off + size < foff + fsz:
                        self.free.insert(i, (off + size, foff + fsz - (off + size)))
                    return True
                if foff > off:
                    break
        return False

    def _prefault(self):
        """Touch every free page once.  Chunks are RESERVED through the
        allocator while being zeroed, so concurrent puts can never have their
        freshly written data overwritten (nor allocate a page mid-zero)."""
        stride = 16 * 1024 * 1024
        zeros = b"\x00" * stride
        try:
            mv = memoryview(self.mm)
            for off in range(0, self.size, stride):
                end = min(off + stride, self.size)
                if not self._reserve_range(off, end - off):
                    continue  # (partially) allocated: the writer faulted it
                try:
                    mv[off:end] = zeros[: end - off]
                finally:
                    self.free_slice(off, end - off)
            mv.release()
        except (ValueError, IndexError):
            pass  # arena closed mid-prefault

    def alloc(self, size: int) -> Optional[int]:
        size = _align_up(size)
        with self.lock:
            for i, (off, sz) in enumerate(self.free):
                if sz >= size:
                    if sz == size:
                        self.free.pop(i)
                    else:
                        self.free[i] = (off + size, sz - size)
                    return off
        return None

    def free_slice(self, offset: int, size: int):
        size = _align_up(size)
        with self.lock:
            import bisect

            i = bisect.bisect_left(self.free, (offset, 0))
            self.free.insert(i, (offset, size))
            # coalesce with next, then previous
            if i + 1 < len(self.free) and offset + size == self.free[i + 1][0]:
                self.free[i] = (offset, size + self.free[i + 1][1])
                self.free.pop(i + 1)
            if i > 0 and self.free[i - 1][0] + self.free[i - 1][1] == self.free[i][0]:
                self.free[i - 1] = (
                    self.free[i - 1][0],
                    self.free[i - 1][1] + self.free[i][1],
                )
                self.free.pop(i)

    def close(self):
        try:
            self.mm.close()
        except (BufferError, ValueError):
            pass


class ShmObjectStore:
    """Producer/consumer interface to the node-local shared-memory store.

    Objects live as seal-sequenced slices of pre-faulted arena files
    (shm_name "<arena>@<offset>+<size>#<seq>") or, above _ARENA_MAX_OBJ, as
    dedicated sealed segments.  Segment layout = serialization.pack() format,
    written in place behind the 8-byte slice header.

    Memory management (plasma eviction_policy.h / external_storage.py
    analogue): `budget_bytes` caps total arena footprint; when growth would
    exceed it, `spill_cb(bytes_needed)` is invoked (the Worker spills the
    oldest live slices to disk via the head) before falling back to growth.
    """

    def __init__(
        self,
        session_name: str,
        owner_tag: Optional[str] = None,
        node_id: str = "n0",
        budget_bytes: int = 0,
    ):
        self.session_name = session_name
        self.node_id = node_id
        # per-node namespace: objects living in another node's namespace are
        # NOT mapped directly (even when the "nodes" share a host in the
        # simulated cluster) — they go through the node-to-node transfer path
        self.ns = f"{session_name}/{node_id}"
        self.dir = os.path.join(SHM_DIR, self.ns)
        os.makedirs(self.dir, exist_ok=True)
        self._native = None
        self._native_tried = False
        self._open_maps: Dict[str, Tuple[mmap.mmap, int]] = {}
        self._lock = threading.Lock()
        # producer-side arenas (keyed by arena shm_name); owner_tag namespaces
        # this process's arena files so the head can sweep them if it dies
        self._owner_tag = owner_tag or f"p{os.getpid()}"
        self._arenas: Dict[str, _Arena] = {}
        self._arena_seq = 0
        self._grow_lock = threading.Lock()  # one arena creation at a time
        # live slices this process sealed, insertion-ordered (spill picks the
        # oldest): name -> (alloc_offset, alloc_size, oid_bytes, seal_seq)
        self._live_slices: Dict[str, Tuple[int, int, bytes, int]] = {}
        # slices whose payload is still being written (packed locally or
        # filled from the network): NOT spill candidates — the background
        # spiller would persist torn bytes and recycle memory under the
        # writer.  seal_done() graduates them.
        self._writing: set = set()
        self._slice_seq = 0
        self._live_bytes = 0  # sum of live-slice allocations (watermark input)
        # dedicated segments this process sealed (objects > _ARENA_MAX_OBJ or
        # arena-exhausted puts): name -> (size, oid_bytes, seq).  Counted in
        # _live_bytes and offered as spill candidates — a huge-object
        # workload must trip the watermark too, not just the inline wall.
        self._live_segments: Dict[str, Tuple[int, bytes, int]] = {}
        self.budget_bytes = budget_bytes  # 0 = uncapped
        self.spill_cb = None  # set by the Worker; fn(bytes_needed) -> None
        # proactive spill (local_object_manager.h IO-worker analogue): when
        # live bytes cross the high watermark, kick the owner's background
        # spiller (non-blocking) so the hard inline path above stays a last
        # resort and puts don't eat spill latency
        self.spill_kick_cb = None  # fn() -> None, must not block
        self.spill_high_frac = 0.8

    def arena_bytes(self) -> int:
        with self._lock:
            return sum(a.size for a in self._arenas.values())

    def live_bytes(self) -> int:
        with self._lock:
            return self._live_bytes

    def live_slices_oldest_first(self) -> List[Tuple[str, int, bytes]]:
        """Spill-candidate view: (shm_name, payload_size, oid) oldest first.
        Only primary slices qualify — pulled copies are droppable, not
        spillable, and carry an empty oid tag.  Dedicated segments are
        candidates too, interleaved by seal sequence."""
        with self._lock:
            out = [
                (name, alloc - _SLICE_HDR, oid, seq)
                for name, (off, alloc, oid, seq) in self._live_slices.items()
                if oid and name not in self._writing
            ]
            out += [
                (name, size, oid, seq)
                for name, (size, oid, seq) in self._live_segments.items()
                if oid and name not in self._writing
            ]
        out.sort(key=lambda t: t[3])
        return [(name, size, oid) for name, size, oid, _seq in out]

    # -- native acceleration ------------------------------------------------
    def _native_lib(self):
        if not self._native_tried:
            self._native_tried = True
            try:
                from ..native import shmstore_binding

                self._native = shmstore_binding.load()
            except Exception:
                self._native = None
        return self._native

    # -- producer -----------------------------------------------------------
    def name_for(self, oid: ObjectID) -> str:
        return f"{self.ns}/obj_{oid.hex()}"

    def is_local(self, shm_name: str) -> bool:
        """True if this name lives in this node's namespace (directly
        mappable); False means it must be fetched node-to-node.  Spilled
        locations ("spill:<path>") are local when the path is under this
        node's spill directory."""
        if shm_name.startswith("spill:"):
            return f"/spill/{self.node_id}/" in shm_name
        return shm_name.startswith(self.ns + "/")

    def warm(self, capacity: int = _ARENA_DEFAULT):
        """Pre-create (and background-prefault) an arena so first puts pay
        memcpy only — the plasma analogue of pre-allocated store memory."""
        if self.budget_bytes:
            capacity = min(capacity, self.budget_bytes)
        with self._lock:
            if self._arenas:
                return
            self._arena_seq += 1
            name = f"{self.ns}/arena_{self._owner_tag}_{self._arena_seq}"
        try:
            arena = _Arena(name, os.path.join(SHM_DIR, name), capacity)
        except OSError:
            return
        with self._lock:
            self._arenas[name] = arena

    def _try_alloc(self, size: int) -> Optional[Tuple[_Arena, int]]:
        with self._lock:
            arenas = list(self._arenas.values())
        for a in arenas:
            off = a.alloc(size)
            if off is not None:
                return a, off
        return None

    def _arena_alloc(self, size: int) -> Optional[Tuple[_Arena, int]]:
        got = self._try_alloc(size)
        if got is not None:
            return got
        # over-budget growth first tries to spill old slices to disk (the
        # plasma-eviction analogue); only then does the arena set grow
        if (
            self.budget_bytes
            and self.spill_cb is not None
            and self.arena_bytes() + size > self.budget_bytes
        ):
            try:
                self.spill_cb(size)
            except Exception:
                pass
            got = self._try_alloc(size)
            if got is not None:
                return got
        # growth is serialized: concurrent put bursts must not each create a
        # full-size arena, and a prefault thread transiently reserving chunks
        # must not fake an out-of-space condition
        with self._grow_lock:
            got = self._try_alloc(size)  # another thread may have grown
            if got is not None:
                return got
            with self._lock:
                arenas = list(self._arenas.values())
            for a in arenas:  # drain in-flight prefault reservations
                t = a._prefault_thread
                if t is not None and t.is_alive():
                    t.join(timeout=10.0)
            got = self._try_alloc(size)
            if got is not None:
                return got
            # genuinely out of space: new arena, geometric in object size and
            # total footprint so sustained bursts create O(log) arenas.
            # Under a budget, over-budget growth (spill couldn't free a
            # contiguous fit) is sized to the request, not the geometric
            # schedule — the overshoot stays proportional to one object.
            total = sum(a.size for a in arenas)
            cap = max(_ARENA_DEFAULT, total)
            if self.budget_bytes and total + cap > self.budget_bytes:
                cap = max(self.budget_bytes - total, size * 2)
            while cap < size * 2:
                cap *= 2
            with self._lock:
                self._arena_seq += 1
                name = f"{self.ns}/arena_{self._owner_tag}_{self._arena_seq}"
            try:
                arena = _Arena(name, os.path.join(SHM_DIR, name), cap)
            except OSError:
                return None  # /dev/shm exhausted; caller falls back or errors
            with self._lock:
                self._arenas[name] = arena
            off = arena.alloc(size)
            return (arena, off) if off is not None else None

    def _seal_slice(
        self, arena: _Arena, off: int, payload_size: int, oid: ObjectID, primary: bool
    ) -> Tuple[str, memoryview]:
        """Stamp a fresh allocation's seal sequence and register it live.
        Returns (shm_name, payload view)."""
        with self._lock:
            self._slice_seq += 1
            seq = self._slice_seq
        arena.mm[off : off + _SLICE_HDR] = seq.to_bytes(_SLICE_HDR, "little")
        name = f"{arena.name}@{off}+{payload_size}#{seq}"
        alloc = _align_up(payload_size + _SLICE_HDR)
        with self._lock:
            self._live_slices[name] = (
                off, alloc, oid.binary() if primary else b"", seq
            )
            self._live_bytes += alloc
            self._writing.add(name)
        return name, memoryview(arena.mm)[off + _SLICE_HDR : off + _SLICE_HDR + payload_size]

    def seal_done(self, shm_name: str) -> None:
        """The slice's payload is fully written: it becomes a spill candidate,
        and crossing the high watermark kicks the background spiller (AFTER
        the write, so the spiller can never persist torn bytes)."""
        with self._lock:
            self._writing.discard(shm_name)
            over = (
                self.budget_bytes
                and self.spill_kick_cb is not None
                and self._live_bytes > self.budget_bytes * self.spill_high_frac
            )
        if over:
            self.spill_kick_cb()

    def _pack_into(self, mv, data: bytes, raws: List[Any]):
        native = self._native_lib()
        if native is not None:
            serialization_pack_into_native(native, mv, data, raws)
        else:
            serialization.pack_into(mv, data, raws)

    def create_and_pack(self, oid: ObjectID, data: bytes, raws: List[Any]) -> Tuple[str, int]:
        """Write a serialized value into the store. Returns (shm_name, size).
        shm_name addresses either an arena slice or a dedicated segment."""
        size = serialization.packed_size(data, raws)
        if size <= _ARENA_MAX_OBJ:
            got = self._arena_alloc(_align_up(size + _SLICE_HDR))
            if got is not None:
                arena, off = got
                name, mv = self._seal_slice(arena, off, size, oid, primary=True)
                try:
                    self._pack_into(mv, data, raws)
                except BaseException:
                    mv.release()
                    self.free_local(name)  # aborted write: reclaim, don't leak
                    raise
                mv.release()
                self.seal_done(name)
                return name, size
        # dedicated segment path (huge objects, or arena creation failed).
        # Same inline spill wall as _arena_alloc: a burst of huge puts over
        # budget must try to free room before asking /dev/shm for more —
        # the async watermark kick alone may not land in time.
        if (
            self.budget_bytes
            and self.spill_cb is not None
            and self.live_bytes() + size > self.budget_bytes
        ):
            try:
                self.spill_cb(size)
            except Exception:
                pass
        name = self.name_for(oid)
        path = os.path.join(SHM_DIR, name)
        tmp = path + ".tmp"
        try:
            fd = os.open(tmp, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
        except FileExistsError:
            raise ObjectStoreFullError(f"object {oid} already being written")
        try:
            os.ftruncate(fd, size)
            with mmap.mmap(fd, size) as m:
                mv = memoryview(m)
                self._pack_into(mv, data, raws)
                mv.release()
        except OSError as e:
            os.close(fd)
            os.unlink(tmp)
            raise ObjectStoreFullError(str(e)) from e
        except BaseException:
            # non-OSError pack failure: the O_EXCL tmp has a FIXED name, so
            # leaking it would brick every retry of this oid with
            # "already being written"
            os.close(fd)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.close(fd)
        os.rename(tmp, path)  # atomic seal
        with self._lock:
            self._slice_seq += 1
            self._live_segments[name] = (size, oid.binary(), self._slice_seq)
            self._live_bytes += size
        self.seal_done(name)  # watermark check (never in _writing: no-op discard)
        return name, size

    def create_for_import(self, oid: ObjectID, size: int, primary: bool = False) -> Tuple[str, memoryview]:
        """Allocate local space for a verbatim copy of an object's packed
        bytes (node-to-node transfer, or primary promotion of an inline
        value).  Returns (local shm_name, writable view of exactly `size`
        bytes); the caller writes into the view and releases it."""
        if size <= _ARENA_MAX_OBJ:
            got = self._arena_alloc(_align_up(size + _SLICE_HDR))
            if got is not None:
                arena, off = got
                return self._seal_slice(arena, off, size, oid, primary=primary)
        name = f"{self.ns}/import_{oid.hex()}"
        path = os.path.join(SHM_DIR, name)
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, size)
            m = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        with self._lock:
            self._open_maps[name] = (m, size)
            # dedicated import segments join the watermark accounting like
            # their arena-sized siblings (_seal_slice); _writing keeps them
            # out of the spill-candidate list until the fill seals
            self._slice_seq += 1
            self._live_segments[name] = (
                size, oid.binary() if primary else b"", self._slice_seq
            )
            self._live_bytes += size
            self._writing.add(name)
        return name, memoryview(m)

    @staticmethod
    def parse_slice(shm_name: str):
        """'arena@off+size#seq' -> (arena_name, off, payload_size, seq).
        seq is 0 for legacy names without a seal sequence."""
        arena_name, _, rest = shm_name.partition("@")
        off_s, _, rest = rest.partition("+")
        size_s, _, seq_s = rest.partition("#")
        return arena_name, int(off_s), int(size_s), int(seq_s or 0)

    def free_local(self, shm_name: str):
        """Owner-side reclaim of an arena slice (called when the head GCs the
        object); no-op for names this process doesn't own.  Idempotent: a
        slice already freed (e.g. spilled synchronously, then the head's
        reclaim broadcast arrives) is skipped — double-free would corrupt the
        coalescing free list.  Dedicated segments this process sealed are
        reclaimed too (unlink + accounting); import segments stay the
        province of abort_import (they hold writable mappings)."""
        if "@" not in shm_name:
            with self._lock:
                seg = self._live_segments.pop(shm_name, None)
                if seg is not None:
                    self._live_bytes -= seg[0]
                self._writing.discard(shm_name)
            if seg is None:
                return  # untracked segment, or already freed
            self.release(shm_name)
            try:
                os.unlink(os.path.join(SHM_DIR, shm_name))
            except OSError:
                pass
            return
        try:
            arena_name, off, size, _seq = self.parse_slice(shm_name)
        except ValueError:
            return
        with self._lock:
            entry = self._live_slices.pop(shm_name, None)
            if entry is not None:
                self._live_bytes -= entry[1]
            self._writing.discard(shm_name)  # free of an aborted write
        if entry is None:
            return  # unknown or already freed
        arena = self._arenas.get(arena_name)
        if arena is None:
            return
        arena.free_slice(entry[0], entry[1])

    def abort_import(self, shm_name: str) -> None:
        """Reclaim an import allocation whose fill failed (dropped pull,
        serialization error): arena slices go through free_local; dedicated
        segments (huge objects — no '@' in the name) unlink their file and
        drop the writable mapping, which free_local deliberately ignores."""
        if "@" in shm_name:
            self.free_local(shm_name)
            return
        with self._lock:
            cached = self._open_maps.pop(shm_name, None)
            seg = self._live_segments.pop(shm_name, None)
            if seg is not None:
                self._live_bytes -= seg[0]
            self._writing.discard(shm_name)
        if cached is not None:
            try:
                cached[0].close()
            except (BufferError, OSError):
                pass  # exported views: the mapping closes when they drop
        try:
            os.unlink(os.path.join(SHM_DIR, shm_name))
        except OSError:
            pass

    def put(self, oid: ObjectID, value: Any) -> Tuple[str, int]:
        data, buffers = serialization.serialize(value)
        return self.create_and_pack(oid, data, [b.raw() for b in buffers])

    # -- consumer -----------------------------------------------------------
    def _map_file(self, file_name: str) -> mmap.mmap:
        """Map a whole shm file (cached; arenas are mapped once per reader)."""
        with self._lock:
            cached = self._open_maps.get(file_name)
            if cached is not None:
                return cached[0]
        # the owner of this arena writes through its own rw mapping
        own = self._arenas.get(file_name)
        if own is not None:
            return own.mm
        path = os.path.join(SHM_DIR, file_name)
        fd = os.open(path, os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            m = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        with self._lock:
            prev = self._open_maps.get(file_name)
            if prev is not None:  # lost a map race; use the winner
                try:
                    m.close()
                except BufferError:
                    pass
                return prev[0]
            self._open_maps[file_name] = (m, size)
        return m

    def open(self, shm_name: str) -> memoryview:
        """Zero-copy read view of an object (arena slice or segment).
        Raises StaleObjectError if the slice was recycled since the name was
        minted (seal sequence mismatch) — the caller re-resolves through the
        head (the object was GC'd+reused, or spilled to disk)."""
        if shm_name.startswith("spill:"):
            return self.open_spill(shm_name[len("spill:"):])
        if "@" in shm_name:
            file_name, off, size, seq = self.parse_slice(shm_name)
            m = self._map_file(file_name)
            if seq:
                cur = int.from_bytes(bytes(m[off : off + _SLICE_HDR]), "little")
                if cur != seq:
                    raise StaleObjectError(
                        f"slice {shm_name} recycled (seq {cur} != {seq})"
                    )
                off += _SLICE_HDR
            return memoryview(m)[off : off + size]
        return memoryview(self._map_file(shm_name))

    def open_spill(self, path: str) -> memoryview:
        """Read view of a spilled object (disk file, serialization.pack
        format).  The mapping keeps the data alive even if the file is
        unlinked by GC while views exist."""
        fd = os.open(path, os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            m = mmap.mmap(fd, size, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        return memoryview(m)

    def get(self, shm_name: str) -> Any:
        return serialization.unpack(self.open(shm_name))

    def release(self, shm_name: str):
        if "@" in shm_name:
            return  # arena maps are long-lived; slices have no per-reader state
        with self._lock:
            cached = self._open_maps.pop(shm_name, None)
        if cached is not None:
            try:
                cached[0].close()
            except BufferError:
                # still referenced by a live numpy view; keep mapping alive
                with self._lock:
                    self._open_maps[shm_name] = cached

    def unlink(self, shm_name: str):
        if "@" in shm_name:
            self.free_local(shm_name)
            return
        with self._lock:
            tracked = shm_name in self._live_segments
        if tracked:
            self.free_local(shm_name)  # keeps _live_bytes accounting right
            return
        self.release(shm_name)
        try:
            os.unlink(os.path.join(SHM_DIR, shm_name))
        except FileNotFoundError:
            pass

    def cleanup_session(self):
        import shutil

        with self._lock:
            maps = list(self._open_maps.values())
            self._open_maps.clear()
            arenas = list(self._arenas.values())
            self._arenas.clear()
        for m, _ in maps:
            try:
                m.close()
            except BufferError:
                pass
        for a in arenas:
            a.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def serialization_pack_into_native(native, mv: memoryview, data: bytes, raws: List[Any]) -> int:
    """pack_into using the native parallel memcpy for large buffers."""
    import msgpack

    header = msgpack.packb({"p": data, "l": [len(r) for r in raws]}, use_bin_type=True)
    hlen = len(header)
    mv[:4] = hlen.to_bytes(4, "big")
    mv[4 : 4 + hlen] = header
    offset = 4 + hlen
    for r in raws:
        offset = serialization._align(offset)
        ln = len(r)
        native.copy_into(mv, offset, r)
        offset += ln
    return offset
