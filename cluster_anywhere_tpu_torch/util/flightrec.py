"""Flight recorder: a per-process bounded ring journal of plane *decision*
events (the analogue of the reference's GcsTaskManager events + export-API
event aggregator, but for control-plane decisions rather than task states).

Every plane already bumps a counter at its decision points — a fence mint, a
drain FSM transition, a netchaos window firing, a DAG recompile, a serve
shed, a train preemption-barrier phase, a transfer source-failover, an
owner-ledger adoption.  Counters answer "how many"; incidents need "what
happened, in what order, caused by what".  This module records the decision
itself as a small structured dict:

    {"ts", "seq", "plane", "event", "node", "proc", "trace"?, **fields}

into a bounded ring (drop-oldest, with accounting).  Events ship head-ward
by piggybacking the existing metrics-delta path (`util/metrics.flush_once`
attaches the drained slice to the `metrics_report` it already sends; node
agents forward on `node_sync` ticks) — zero new standalone RPCs.  The head
merges per-process journals into one cluster ring served by the `flightrec`
RPC (`ca events`, `ca incident`, dashboard `/api/flightrec`).

Off switch: `flightrec_plane=False` leaves the module-global `REC` as None
and every record site is a single `REC is None` branch — no allocation, no
lock, no dict build on the disabled path.

Typed failures (`FencedError`, `DeadActorError`, `DagTimeoutError`,
`ObjectLostError`) attach `recent()` slices at raise time so an exception
carries its own black box out of the crashing process.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

# Module-global recorder.  Hot call sites gate on `flightrec.REC is not
# None` (one attribute load + branch when disabled, the NET_CHAOS pattern).
REC: Optional["FlightRecorder"] = None

# flushed as ca_flightrec_* counter deltas by util/metrics (same contract as
# WIRE_STATS / DAG_STATS)
FLIGHTREC_STATS = {"recorded": 0, "dropped": 0, "shipped": 0}

# lazily bound tracing.current (top-level import would cycle through
# util.metrics when metrics imports this module for the flush piggyback)
_trace_current = None


def _current_trace():
    global _trace_current
    if _trace_current is None:
        from . import tracing

        _trace_current = tracing.current
    return _trace_current()


class FlightRecorder:
    """Bounded ring of decision events with a ship cursor.

    The ring is the journal: `recent()` reads it without consuming, so an
    error raised seconds after a fence still sees the fence.  Shipping
    advances a sequence cursor instead of draining the ring; a failed send
    just rewinds the cursor (`restage`).  When drop-oldest discards an
    event the cursor never reached, `dropped_unshipped` records the loss —
    the head-side journal is explicit about its own blind spots.
    """

    def __init__(
        self,
        cap: int = 4096,
        node_id: Optional[str] = None,
        proc: Optional[str] = None,
    ):
        self.cap = max(int(cap), 16)
        self.node_id = node_id
        self.proc = proc or f"pid-{os.getpid()}"
        self._lock = threading.Lock()
        self._ring: deque = deque()
        self._seq = 0
        self._ship_seq = 0  # events with seq > _ship_seq are unshipped
        self.dropped = 0
        self.dropped_unshipped = 0

    # ------------------------------------------------------------- record
    def record(self, plane: str, event: str, **fields: Any) -> None:
        """Append one decision event (thread-safe).  Stamps ts/seq/origin
        and the ambient trace context so cross-plane queries can join the
        journal against `ca timeline` spans."""
        ev: Dict[str, Any] = {
            "ts": time.time(),
            "plane": plane,
            "event": event,
            "node": self.node_id,
            "proc": self.proc,
        }
        tr = _current_trace()
        if tr is not None:
            ev["trace"] = {"tid": tr.get("tid"), "sid": tr.get("sid")}
        if fields:
            ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)
            FLIGHTREC_STATS["recorded"] += 1
            if len(self._ring) > self.cap:
                old = self._ring.popleft()
                self.dropped += 1
                FLIGHTREC_STATS["dropped"] += 1
                if old["seq"] > self._ship_seq:
                    self.dropped_unshipped += 1

    # -------------------------------------------------------------- query
    def recent(
        self,
        n: int = 64,
        plane: Optional[str] = None,
        trace: Optional[str] = None,
    ) -> List[dict]:
        """Newest-last slice of the journal (non-consuming).  `plane`
        filters by plane name; `trace` by trace id."""
        with self._lock:
            evs = list(self._ring)
        if plane is not None:
            evs = [e for e in evs if e.get("plane") == plane]
        if trace is not None:
            evs = [e for e in evs if (e.get("trace") or {}).get("tid") == trace]
        return evs[-n:]

    # --------------------------------------------------------------- ship
    def drain(self, max_n: int = 2000) -> List[dict]:
        """Take up to max_n unshipped events (advances the ship cursor; the
        ring itself is untouched so `recent()` keeps seeing them)."""
        with self._lock:
            if not self._ring or self._ring[-1]["seq"] <= self._ship_seq:
                return []
            out = [e for e in self._ring if e["seq"] > self._ship_seq][:max_n]
            if out:
                self._ship_seq = out[-1]["seq"]
                FLIGHTREC_STATS["shipped"] += len(out)
        return out

    def restage(self, evs: List[dict]) -> None:
        """Rewind the ship cursor after a failed send (head unreachable);
        the events re-drain next flush.  Events already rotated out of the
        ring by then count as dropped_unshipped."""
        if not evs:
            return
        with self._lock:
            first = evs[0]["seq"]
            if first <= self._ship_seq:
                self._ship_seq = first - 1
                FLIGHTREC_STATS["shipped"] -= len(evs)

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "len": len(self._ring),
                "cap": self.cap,
                "seq": self._seq,
                "shipped_seq": self._ship_seq,
                "dropped": self.dropped,
                "dropped_unshipped": self.dropped_unshipped,
            }

    def memory_bytes(self) -> int:
        """Approximate journal footprint (JSON-encoded size of the ring) —
        bench/diagnostic only, O(len)."""
        with self._lock:
            evs = list(self._ring)
        try:
            return sum(len(json.dumps(e, default=str)) for e in evs)
        except Exception:
            return 0


# ------------------------------------------------------------- module API
def init(
    cap: int = 4096, node_id: Optional[str] = None, proc: Optional[str] = None
) -> FlightRecorder:
    """Arm the per-process recorder (idempotent; re-init updates origin
    stamps so a worker that learns its node id late records it forward)."""
    global REC
    if REC is None:
        REC = FlightRecorder(cap=cap, node_id=node_id, proc=proc)
    else:
        if node_id is not None:
            REC.node_id = node_id
        if proc is not None:
            REC.proc = proc
    return REC


def shutdown() -> None:
    """Disarm (tests / flightrec_plane=False)."""
    global REC
    REC = None


def record(plane: str, event: str, **fields: Any) -> None:
    """Convenience for cold call sites; hot paths inline the REC gate."""
    if REC is not None:
        REC.record(plane, event, **fields)


def recent(
    n: int = 64, plane: Optional[str] = None, trace: Optional[str] = None
) -> List[dict]:
    """Recent journal slice, [] when disabled — safe to call from error
    constructors in any process."""
    if REC is None:
        return []
    return REC.recent(n, plane=plane, trace=trace)
