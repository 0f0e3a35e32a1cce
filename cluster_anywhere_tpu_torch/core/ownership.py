"""The ownership plane: owner-resident object lifetime.

The process that creates an object (its *owner* — `ReferenceCounter._owned`
already marks this) is the authority for its cluster-wide refcount and its
spill decision, the NSDI'21 ownership protocol of the reference
(src/ray/core_worker/reference_count.h AddBorrowedObject /
WaitForRefRemoved): when a ref crosses a process boundary, the borrower
registers with the owner over a direct worker<->worker connection
(`owner_refs`), NOT with the head.  The head is demoted to registry-of-owners
(obj_created / obj_release keep its location snapshot current) and failover
arbiter: each owner ships a versioned digest of its ledger with its
heartbeats (`owner_sync`), and when an owner dies the head adopts the
orphaned objects from the last digest so borrowers drain through the central
path without leaking shm segments or spill files.

This module is the bookkeeping half; the wiring lives in worker.py (routing,
RPC serving, GC actions) and head.py (relay, adoption, registry settlement).

`OwnerLedger` deliberately mirrors the head's holder semantics so the two
authorities stay interchangeable per object:
- holder ids are client ids, "<cid>#v" value pins, and "t:<cid>:<n>" transit
  tokens;
- a dec from the owner itself marks `released` (head: owner_released);
- transit acks that race ahead of their pin leave a spent-token tombstone;
- holder adds for unknown oids wait in a bounded, grace-windowed pending map
  (head: `_early_refs`) instead of relying on arrival order.

`DeltaReporter` is the ray_syncer-style versioned delta channel used by the
node agent's heartbeat loop: components (load, lease occupancy, pressure) are
re-sent only when their payload changes; an unchanged tick degenerates to a
~20-byte keepalive, and a reconnect triggers a full resync.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

# Ownership-plane counters (same plain-int discipline as protocol.WIRE_STATS
# / worker.LEASE_STATS: owned-thread increments, flusher-only reads).
# Shipped as ca_owner_* counters by util/metrics and summed into bench.py's
# BENCH-json `ownerplane` block.
OWNER_STATS: Dict[str, int] = {
    "refs_settled_local": 0,   # inc/dec applied to this process's own ledger
    "refs_sent_owner": 0,      # inc/dec sent to another process's ledger
    "refs_recv": 0,            # owner_refs updates served by this ledger
    "refs_head_fallback": 0,   # inc/dec that fell back to the head path
    "owner_gc": 0,             # objects whose lifetime this ledger settled
    "owner_gc_head_down": 0,   # of those, settled (and freed) with no head
    "pins_served": 0,          # owner_pin requests answered authoritatively
    "pending_expired": 0,      # grace-expired pending borrower adds (sweep)
    "spills_decided": 0,       # spill free/defer decisions made owner-side
    "syncs_sent": 0,           # owner_sync digests shipped to the head
    "syncs_full": 0,           # of those, full resyncs (reconnect)
}


def owner_stats() -> Dict[str, int]:
    """Snapshot of this process's ownership-plane counters."""
    return dict(OWNER_STATS)


# ---------------------------------------------------------------- log helper
_warn_lock = threading.Lock()
_warn_last: Dict[str, float] = {}
_warn_suppressed: Dict[str, int] = {}


def warn_ratelimited(key: str, msg: str, period_s: float = 10.0) -> None:
    """Print a warning at most once per `period_s` per key (with a
    suppressed-repeat count), through the log plane's capture when installed.
    Used where callbacks used to swallow exceptions with a bare `pass` —
    a GC bug must be visible without turning a hot loop into a log flood."""
    now = time.monotonic()
    with _warn_lock:
        last = _warn_last.get(key, 0.0)
        if now - last < period_s:
            _warn_suppressed[key] = _warn_suppressed.get(key, 0) + 1
            return
        _warn_last[key] = now
        n = _warn_suppressed.pop(key, 0)
    suffix = f" [{n} similar suppressed]" if n else ""
    # plain print: the log plane's StreamCapture (util/logplane) stamps and
    # ships stdout, so this reaches `ca logs` / the driver with attribution
    print(f"[ca][warn] {msg}{suffix}", flush=True)


class _Ent:
    """One owned object's cluster-wide lifetime state."""

    __slots__ = (
        "holders", "released", "registered", "shm_name", "size",
        "spill_path", "pending_free", "contains", "device_holder",
    )

    def __init__(self):
        self.holders: Set[str] = set()
        self.released = False      # the owner dropped its last local handle
        self.registered = False    # obj_created reached (or targets) the head
        self.shm_name: Optional[str] = None  # primary copy (owner's node)
        self.size = 0
        self.spill_path: Optional[str] = None
        # old shm slice of a spilled-while-pinned object: reclaimed by the
        # owner when the last "#v" value pin drops (head: rec.pending_free)
        self.pending_free: Optional[str] = None
        # nested ObjectRefs serialized inside this object's payload, as
        # (oid, owner_cid) pairs: each inner object carries a
        # "cnt:<container-hex>" holder at ITS owner's ledger for as long as
        # this entry lives (borrowing containment edges, owner-resident form).
        # The owner cid travels with the oid because the container's owner
        # may never deserialize the payload — it must still be able to route
        # the release to the right ledger.
        self.contains: List[Tuple[bytes, Optional[str]]] = []
        # a device result's holder: the process whose device_objects keeps
        # the value, told to free it when this entry settles
        self.device_holder: Optional[str] = None


class OwnerLedger:
    """Borrower ledger for the objects THIS process owns.

    Thread-safe (user threads release handles; the IO loop serves borrower
    RPCs and flushes).  Mutations bump `version` and mark the entry dirty so
    `digest_delta()` can ship owner_sync deltas; `on_clear` fires (outside
    the lock) when an entry's lifetime fully settles — owner released and no
    borrowers — handing GC to the worker; `on_pin_zero` fires when the last
    "#v" value pin drops, releasing a spill's pending old slice.
    """

    def __init__(
        self,
        owner_id: str,
        on_clear: Optional[Callable[[List[Tuple[bytes, dict]]], None]] = None,
        on_pin_zero: Optional[Callable[[bytes], None]] = None,
        pending_grace_s: float = 600.0,
    ):
        self.owner_id = owner_id
        self.on_clear = on_clear
        self.on_pin_zero = on_pin_zero
        self._lock = threading.Lock()
        self._ents: Dict[bytes, _Ent] = {}
        # holder adds that raced ahead of register() (mirrors the head's
        # _early_refs, bounded by the same explicit grace window)
        self._pending: Dict[bytes, Tuple[float, Set[str]]] = {}
        self._pending_grace_s = pending_grace_s
        # transit acks that arrived before their pin (different sockets)
        self._spent_transit: Dict[str, float] = {}
        # ttl-opted transit pins (owner_locate serving): reclaimed when the
        # ack was lost in flight
        self._ttl_pins: Dict[str, Tuple[float, List[bytes]]] = {}
        # delta-sync state for owner_sync digests
        self.version = 0
        self._dirty: Set[bytes] = set()
        self._removed: Set[bytes] = set()

    # ------------------------------------------------------------- lifecycle
    def register(self, oid: bytes) -> None:
        """The owner minted this object (add_owned time).  Must precede any
        borrower's knowledge of the ref — the ref cannot leave the process
        before it exists — so pending adds are adopted here."""
        with self._lock:
            if oid in self._ents:
                return
            ent = self._ents[oid] = _Ent()
            pend = self._pending.pop(oid, None)
            if pend is not None:
                ent.holders |= pend[1]
            self._mark_dirty_locked(oid)

    def set_location(
        self, oid: bytes, shm_name: Optional[str], size: int,
        registered: bool = True,
    ) -> None:
        """Record the primary copy's location (obj_created time) so the owner
        can serve owner_pin/owner_locate even after its local read-cache
        entry is evicted at local-zero.  Update-only: an entry whose lifetime
        already settled (every handle died before the data arrived) must not
        be resurrected — the head's registry entry is the orphan's record,
        reaped with the owner's other state at disconnect, as before."""
        with self._lock:
            ent = self._ents.get(oid)
            if ent is None:
                return
            ent.shm_name = shm_name
            ent.size = size
            ent.spill_path = None
            if registered:
                ent.registered = True

    def set_device_holder(self, oid: bytes, holder: str) -> bool:
        """Record the process holding this device result's value, released
        when the entry settles.  False when it settled already (every handle
        and borrower gone before the result came): the caller releases it."""
        with self._lock:
            ent = self._ents.get(oid)
            if ent is None:
                return False
            ent.device_holder = holder
            return True

    def set_contains(
        self, oid: bytes, refs: List[Tuple[bytes, Optional[str]]]
    ) -> Optional[List[Tuple[bytes, Optional[str]]]]:
        """Record the containment edges of an owned container; returns the
        PREVIOUS edge list (re-registration, e.g. reconstruction re-ran the
        creating task) so the caller can release the stale edges — or None
        when the container is no longer tracked (its lifetime settled before
        the edges arrived): the caller must release the NEW edges instead."""
        with self._lock:
            ent = self._ents.get(oid)
            if ent is None:
                return None
            old, ent.contains = ent.contains, list(refs)
            return old

    def spill_transition(self, oid: bytes, path: str) -> Optional[bool]:
        """Owner-side spill decision, atomic with the relocation: returns
        whether zero-copy value pins hold the old slice (True = defer its
        reclaim to the last pin drop — the old slice is remembered as
        pending_free and handed back via pop_pending_free on the pin-zero
        callback; False = the spiller frees it now), or None when the object
        is no longer tracked (GC won the race — the spiller drops the file
        and frees the slice)."""
        with self._lock:
            ent = self._ents.get(oid)
            if ent is None:
                return None
            pinned = any(h.endswith("#v") for h in ent.holders)
            if pinned:
                ent.pending_free = ent.shm_name
            ent.spill_path = path
            ent.shm_name = None
            self._mark_dirty_locked(oid)
            OWNER_STATS["spills_decided"] += 1
            return pinned

    def pop_pending_free(self, oid: bytes) -> Optional[str]:
        """Take the spilled-while-pinned old slice awaiting reclaim (fired
        from the on_pin_zero callback, or by GC settling the entry)."""
        with self._lock:
            ent = self._ents.get(oid)
            if ent is None:
                return None
            name, ent.pending_free = ent.pending_free, None
            return name

    def tracks(self, oid: bytes) -> bool:
        with self._lock:
            return oid in self._ents

    def entry_info(self, oid: bytes) -> Optional[dict]:
        """Location snapshot for owner_locate/owner_pin serving (no pin)."""
        with self._lock:
            ent = self._ents.get(oid)
            if ent is None:
                return None
            return {
                "shm_name": ent.shm_name, "size": ent.size,
                "spill_path": ent.spill_path, "registered": ent.registered,
                "device_holder": ent.device_holder,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._ents)

    # --------------------------------------------------------------- holders
    def _mark_dirty_locked(self, oid: bytes) -> None:
        self.version += 1
        self._dirty.add(oid)

    def apply(
        self,
        inc: List[bytes],
        dec: List[bytes],
        as_id: str,
        ttl: bool = False,
    ) -> None:
        """Apply one obj_refs-shaped update — the exact semantics of the
        head's `_h_obj_refs`, owner-resident."""
        cleared: List[Tuple[bytes, dict]] = []
        pin_zero: List[bytes] = []
        with self._lock:
            if as_id in self._spent_transit:
                # the receiver already acked this transit: the pin is moot
                del self._spent_transit[as_id]
            else:
                if inc and ttl and as_id.startswith("t:"):
                    self._ttl_pins[as_id] = (time.monotonic(), list(inc))
                for oid in inc:
                    ent = self._ents.get(oid)
                    if ent is not None:
                        ent.holders.add(as_id)
                        self._mark_dirty_locked(oid)
                    else:
                        # borrower registration racing object re-creation
                        # (reconstruction) — park it under the grace window
                        pend = self._pending.get(oid)
                        if pend is None:
                            pend = self._pending[oid] = (time.monotonic(), set())
                        pend[1].add(as_id)
            for oid in dec:
                ent = self._ents.get(oid)
                if ent is None:
                    pend = self._pending.get(oid)
                    if pend is not None:
                        pend[1].discard(as_id)
                        if not pend[1]:
                            del self._pending[oid]
                    continue
                ent.holders.discard(as_id)
                if as_id == self.owner_id:
                    ent.released = True
                self._mark_dirty_locked(oid)
                if (
                    as_id.endswith("#v")
                    and not any(h.endswith("#v") for h in ent.holders)
                ):
                    pin_zero.append(oid)
                if ent.released and not ent.holders:
                    cleared.append((oid, self._drop_locked(oid)))
        self._fire(cleared, pin_zero)

    def _drop_locked(self, oid: bytes) -> dict:
        ent = self._ents.pop(oid, None)
        self.version += 1
        self._dirty.discard(oid)
        self._removed.add(oid)
        if ent is None:
            return {}
        return {
            "registered": ent.registered, "shm_name": ent.shm_name,
            "size": ent.size, "spill_path": ent.spill_path,
            "pending_free": ent.pending_free, "contains": ent.contains,
            "device_holder": ent.device_holder,
        }

    def _fire(self, cleared: List[Tuple[bytes, dict]], pin_zero: List[bytes]) -> None:
        """Run callbacks outside the lock; failures are logged (rate-limited)
        rather than swallowed — a silent GC bug is invisible otherwise."""
        if pin_zero and self.on_pin_zero is not None:
            for oid in pin_zero:
                try:
                    self.on_pin_zero(oid)
                except Exception as e:
                    warn_ratelimited(
                        "ledger-pin-zero",
                        f"ownership ledger pin-release callback failed: {e!r}",
                    )
        if cleared and self.on_clear is not None:
            try:
                self.on_clear(cleared)
            except Exception as e:
                warn_ratelimited(
                    "ledger-clear",
                    f"ownership ledger GC callback failed: {e!r}",
                )

    def pin(self, oid: bytes, as_id: str) -> Optional[dict]:
        """Atomic pin + locate (the owner-side `obj_pin`): registering the
        pin and reading the current location under one lock means a reader
        can never map a slice this owner's spiller is about to recycle."""
        with self._lock:
            ent = self._ents.get(oid)
            if ent is None:
                return None
            if ent.shm_name is None and ent.spill_path is None:
                return None  # inline/pending/re-homed: head or value path
            ent.holders.add(as_id)
            self._mark_dirty_locked(oid)
            OWNER_STATS["pins_served"] += 1
            return {
                "shm_name": ent.shm_name, "size": ent.size,
                "spill_path": ent.spill_path,
            }

    def transit_done(
        self, token: str, oids: List[bytes], cid: str, register: bool = True
    ) -> None:
        """Receiver ack of in-transit borrowed refs (head `_h_transit_done`
        semantics): register the receiver, release the token pin, tombstone
        tokens whose pin hasn't landed yet."""
        cleared: List[Tuple[bytes, dict]] = []
        with self._lock:
            self._ttl_pins.pop(token, None)
            seen = False
            for oid in oids:
                ent = self._ents.get(oid)
                if ent is not None:
                    if register:
                        ent.holders.add(cid)
                    if token in ent.holders:
                        seen = True
                        ent.holders.discard(token)
                    self._mark_dirty_locked(oid)
                    if ent.released and not ent.holders:
                        cleared.append((oid, self._drop_locked(oid)))
                else:
                    pend = self._pending.get(oid)
                    if pend is None and register:
                        pend = self._pending[oid] = (time.monotonic(), set())
                    if pend is not None:
                        if register:
                            pend[1].add(cid)
                        if token in pend[1]:
                            seen = True
                            pend[1].discard(token)
            if not seen:
                self._spent_transit[token] = time.monotonic()
        self._fire(cleared, [])

    def purge_holder(self, cid: str) -> None:
        """A borrower process died (head `client_gone` broadcast): its
        holder id, value pin, transit tokens, and containment edges (the
        "cnt:<cid>:<container>" holders its containers' settlement would
        have dec'd) can never dec."""
        pin_id = f"{cid}#v"
        transit_prefix = f"t:{cid}:"
        edge_prefix = f"cnt:{cid}:"
        cleared: List[Tuple[bytes, dict]] = []
        pin_zero: List[bytes] = []
        with self._lock:
            for oid, ent in list(self._ents.items()):
                stale = [
                    h for h in ent.holders
                    if h == cid or h == pin_id
                    or h.startswith(transit_prefix)
                    or h.startswith(edge_prefix)
                ]
                if not stale:
                    continue
                had_pin = any(h.endswith("#v") for h in ent.holders)
                ent.holders.difference_update(stale)
                self._mark_dirty_locked(oid)
                if had_pin and not any(h.endswith("#v") for h in ent.holders):
                    pin_zero.append(oid)
                if ent.released and not ent.holders:
                    cleared.append((oid, self._drop_locked(oid)))
            for tok in [
                t for t in self._ttl_pins if t.startswith(transit_prefix)
            ]:
                del self._ttl_pins[tok]
        self._fire(cleared, pin_zero)

    # ----------------------------------------------------------------- sweep
    def sweep(self, now: Optional[float] = None) -> int:
        """Periodic reclamation (worker housekeeping): expire pending holder
        adds past the grace window and ttl transit pins whose ack was lost.
        Returns the number of expired pending entries (observability)."""
        if now is None:
            now = time.monotonic()
        expired = 0
        cleared: List[Tuple[bytes, dict]] = []
        with self._lock:
            cutoff = now - self._pending_grace_s
            for oid in [
                o for o, (ts, _) in self._pending.items() if ts < cutoff
            ]:
                del self._pending[oid]
                expired += 1
            tok_cutoff = now - 600.0
            for tok in [
                t for t, (ts, _) in self._ttl_pins.items() if ts < tok_cutoff
            ]:
                _, oids = self._ttl_pins.pop(tok)
                for oid in oids:
                    ent = self._ents.get(oid)
                    if ent is not None and tok in ent.holders:
                        ent.holders.discard(tok)
                        self._mark_dirty_locked(oid)
                        if ent.released and not ent.holders:
                            cleared.append((oid, self._drop_locked(oid)))
            spent_cutoff = now - 60.0
            for tok in [
                t for t, ts in self._spent_transit.items() if ts < spent_cutoff
            ]:
                del self._spent_transit[tok]
        self._fire(cleared, [])
        return expired

    # ----------------------------------------------------------- digest sync
    def digest_delta(self, full: bool = False) -> Optional[dict]:
        """The owner_sync payload: changed entries' borrower sets (the
        owner's own holds are excluded — they die with the owner) plus
        removed oids, or the full table on reconnect.  None = nothing to
        send (clean)."""
        with self._lock:
            if full:
                oids = list(self._ents)
                removed: List[bytes] = []
            else:
                if not self._dirty and not self._removed:
                    return None
                oids = [o for o in self._dirty if o in self._ents]
                removed = list(self._removed)
            self._dirty.clear()
            self._removed.clear()
            own_pin = f"{self.owner_id}#v"
            own_transit = f"t:{self.owner_id}:"
            entries = {}
            for oid in oids:
                ent = self._ents[oid]
                entries[oid] = {
                    "b": sorted(
                        h for h in ent.holders
                        if h != self.owner_id and h != own_pin
                        and not h.startswith(own_transit)
                    ),
                    "r": ent.released,
                    "g": ent.registered,
                }
            return {
                "v": self.version,
                "full": full,
                "e": entries,
                "rm": removed,
            }

    def holders_of(self, oid: bytes) -> Optional[Set[str]]:
        """Current holder set of one owned object (diagnostics/tests), or
        None when the ledger no longer tracks it."""
        with self._lock:
            ent = self._ents.get(oid)
            return set(ent.holders) if ent is not None else None


class DeltaReporter:
    """Versioned component-wise delta sync for the agent's node state (the
    ray_syncer.h role, head-ward form): `delta(components)` returns only the
    components whose payload changed since the last send — None when nothing
    did (the caller sends a bare keepalive) — and `reset()` forces the next
    delta to be a full resync (new head connection)."""

    def __init__(self):
        self._last: Dict[str, Any] = {}
        self.version = 0
        self._full_pending = True

    def reset(self) -> None:
        self._last = {}
        self._full_pending = True

    def delta(self, components: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        full = self._full_pending
        if full:
            changed = dict(components)
        else:
            changed = {
                k: v for k, v in components.items() if self._last.get(k) != v
            }
            if not changed:
                return None
        # deep-copy guard: store a stable snapshot for the next comparison
        import copy

        for k, v in changed.items():
            self._last[k] = copy.deepcopy(v)
        self.version += 1
        changed["v"] = self.version
        if full:
            changed["full"] = True
            self._full_pending = False
        return changed


def quantize_load(load: Dict[str, float]) -> Dict[str, float]:
    """Round load telemetry so jitter doesn't defeat delta sync: raw
    loadavg/mem fractions change every sample, which would re-send the
    component each tick and make the delta channel a full heartbeat with
    extra steps."""
    out = {}
    for k, v in load.items():
        out[k] = round(float(v), 1 if k == "load_1m" else 2)
    return out
