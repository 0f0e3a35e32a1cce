"""Local reference counting with batched release notifications.

Per-process HALF of the reference's distributed ReferenceCounter
(src/ray/core_worker/reference_count.h): local refcounts for every ObjectRef
handle, with zero-crossings batched into inc/dec updates.  Where those
updates SETTLE is the ownership plane's concern (core/ownership.py +
worker.py routing): for objects this process owns they land directly in its
OwnerLedger; for borrowed objects they flow to the owner process's ledger
over a direct connection (the AddBorrowedObject / WaitForRefRemoved
worker<->worker protocol, owner-resident form); the head is only the
fallback when an owner is unknown, unreachable, or dead — and the failover
arbiter that adopts a dead owner's ledger from its last synced digest.
(The round-1 note that deferred the borrowing ledger "for the multi-node
milestone" is settled: this IS that milestone.)
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .ids import ObjectID


class ReferenceCounter:
    def __init__(self, flush_cb: Optional[Callable[[List[bytes], List[bytes]], None]] = None):
        self._counts: Dict[ObjectID, int] = {}
        self._lock = threading.Lock()
        self._pending_inc: List[bytes] = []
        self._pending_dec: List[bytes] = []
        self._flush_cb = flush_cb
        # objects this process owns (created here); owner keeps data alive
        # until cluster count drops to zero.
        self._owned: set = set()
        # called (outside the lock) when an object's local count reaches 0 —
        # the worker evicts its read-cache entry so value pins can release
        self._on_zero: Optional[Callable[[ObjectID], None]] = None

    def set_flush_cb(self, cb):
        self._flush_cb = cb

    def set_on_zero(self, cb: Callable[[ObjectID], None]):
        self._on_zero = cb

    def add_owned(self, oid: ObjectID):
        with self._lock:
            self._owned.add(oid)

    def remove_owned(self, oid: ObjectID):
        with self._lock:
            self._owned.discard(oid)

    def add_local_ref(self, oid: ObjectID) -> int:
        """Returns the new count (1 = this ref revived the object locally)."""
        with self._lock:
            n = self._counts.get(oid, 0)
            self._counts[oid] = n + 1
            if n == 0:
                self._pending_inc.append(oid.binary())
            return n + 1

    def remove_local_ref(self, oid: ObjectID):
        flush = None
        zero = False
        with self._lock:
            n = self._counts.get(oid, 0) - 1
            if n <= 0:
                self._counts.pop(oid, None)
                self._pending_dec.append(oid.binary())
                zero = True
                if len(self._pending_dec) >= 64:
                    flush = self._take_pending_locked()
            else:
                self._counts[oid] = n
        if zero and self._on_zero is not None:
            try:
                self._on_zero(oid)
            except Exception as e:
                # a failing eviction callback is a GC bug (leaked pins /
                # unevictable cache entries) — surface it, rate-limited,
                # instead of silently swallowing it
                from .ownership import warn_ratelimited

                warn_ratelimited(
                    "refcount-on-zero",
                    f"on-zero eviction callback failed for {oid}: {e!r}",
                )
        if flush and self._flush_cb:
            self._flush_cb(*flush)

    def _take_pending_locked(self):
        inc, dec = self._pending_inc, self._pending_dec
        self._pending_inc, self._pending_dec = [], []
        return inc, dec

    def flush(self):
        with self._lock:
            inc, dec = self._take_pending_locked()
        if (inc or dec) and self._flush_cb:
            self._flush_cb(inc, dec)

    def local_count(self, oid: ObjectID) -> int:
        with self._lock:
            return self._counts.get(oid, 0)

    def is_owned(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._owned
