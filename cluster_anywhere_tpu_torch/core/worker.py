"""CoreWorker runtime: the per-process engine embedded in the driver and in
every worker process (analogue of src/ray/core_worker/core_worker.h).

Owns: the IO thread (asyncio loop), the connection to the head, direct
connections to other workers, the in-process memory store, the shm store
client, reference counting, function export, lease-based task submission with
pipelining (normal_task_submitter.h), actor call submission, and get/put/wait.

Threading model: user code calls the blocking public API from any thread; all
socket IO happens on the IO thread.  ObjectRef readiness is tracked in the
MemoryStore (condition-variable waits) so `get`/`wait` never touch the loop.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import netchaos, serialization
from .config import CAConfig, get_config
from .errors import (
    ActorDiedError,
    CAError,
    FencedError,
    GetTimeoutError,
    ObjectLostError,
    StaleObjectError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from .function_manager import FunctionManager
from .ids import ActorID, JobID, ObjectID, TaskID, _Counter
from .object_ref import ObjectRef
from .object_store import MemoryStore, ShmObjectStore, _Entry
from .protocol import (
    TRACE_FIELD,
    WIRE_STATS,
    AddrRing,
    Connection,
    MsgTemplate,
    addr_list,
    spawn_bg,
)
from .ownership import OWNER_STATS, OwnerLedger
from .reference_counter import ReferenceCounter

_global_worker: Optional["Worker"] = None
_global_lock = threading.Lock()

# set to the util.tracing module by tracing.enable() (None = tracing off).
# Submission hot paths read it with one attribute load + branch, so the
# disabled path adds no per-call allocations (acceptance constraint); a
# direct top-level import would also be circular (util.state imports this
# module at import time).
TRACE_HOOK: Optional[Any] = None

# Lease-plane counters (same plain-int discipline as protocol.WIRE_STATS:
# loop-owned increments, flusher-only reads).  local_* = grants/releases
# served by node agents out of delegated lease blocks; head_* = central
# grants; fallbacks = local attempts that fell through to the head (agent
# exhausted/unreachable).  Shipped as ca_lease_* counters by util/metrics.
LEASE_STATS: Dict[str, int] = {
    "local_grants": 0,
    "local_denied": 0,
    "local_released": 0,
    "head_grants": 0,
    "head_released": 0,
    "fallbacks": 0,
}


def lease_stats() -> Dict[str, int]:
    """Snapshot of this process's lease-plane counters."""
    return dict(LEASE_STATS)


# Drain-plane counters (shipped as ca_drain_* by util/metrics).  A task
# retry caused by a drained/preempted node is a SYSTEM failure: it is
# exempted from the user's max_retries budget and counted here instead.
DRAIN_STATS: Dict[str, int] = {
    "tasks_evacuated_total": 0,  # budget-exempt retries off draining nodes
    "leases_recalled_total": 0,  # idle leases returned early on a drain pub
}


def drain_stats() -> Dict[str, int]:
    """Snapshot of this process's drain-plane counters."""
    return dict(DRAIN_STATS)


# Train-plane counters (shipped as ca_train_* by util/metrics).  The elastic
# training story in numbers: proactive preemption restarts (the controller
# reacted to a drain warning BEFORE the kill), checkpoint-barrier outcomes
# inside the warning window, and attempts that were budget-exempt because
# the death was an announced exit rather than an application failure.
TRAIN_STATS: Dict[str, int] = {
    "preempt_restarts_total": 0,   # drain-triggered proactive group rebuilds
    "preempt_barrier_acked_total": 0,    # barriers where every rank checkpointed
    "preempt_barrier_timeout_total": 0,  # barriers torn down without full acks
    "budget_exempt_attempts_total": 0,   # restarts that did not consume max_failures
    "callback_errors_total": 0,    # run_config callback hooks that raised
    "shutdown_errors_total": 0,    # worker-group teardown errors (kill / PG removal)
}


def train_stats() -> Dict[str, int]:
    """Snapshot of this process's train-plane counters."""
    return dict(TRAIN_STATS)


# Transfer-plane counters (shipped as ca_transfer_* by util/metrics).  The
# bulk-byte data plane: windowed node-to-node object pulls, multi-source
# range splitting, client-mode uploads, and the quantized collective ring's
# wire savings.  window_peak_sum / pulls = average per-transfer peak of
# concurrent pull_chunk RPCs (the structural proof the window is open:
# serial pulls peak at exactly 1).
TRANSFER_STATS: Dict[str, int] = {
    "pulls": 0,                 # node-to-node object transfers completed
    "bytes_pulled": 0,          # object bytes received over pull_chunk
    "chunks_pulled": 0,         # pull_chunk responses applied
    "window_peak_sum": 0,       # sum over pulls of peak in-flight RPCs
    "sources_used": 0,          # holders that served >=1 chunk, summed
    "multi_source_pulls": 0,    # pulls that drew from >1 holder
    "source_failovers": 0,      # sources dropped mid-pull (range re-assigned)
    "pull_retry_rounds": 0,     # re-locate rounds after every source failed
    "bytes_uploaded": 0,        # client-mode put bytes streamed to the head
    "copy_notify_deferred": 0,  # obj_copy notifies queued for re-send
    "quant_bytes_saved": 0,     # f32-equivalent minus wire bytes, quantized ring
    "quant_ops": 0,             # quantized collective ops completed
}


def transfer_stats() -> Dict[str, int]:
    """Snapshot of this process's transfer-plane counters."""
    return dict(TRANSFER_STATS)


def _redial_backoff(attempt: int, rng: Optional[random.Random] = None) -> float:
    """Jittered exponential backoff for head redials: base doubles
    0.25s→4s with attempts, scaled by a uniform [0.5, 1.5) draw so N
    workers reconnecting to a restarted head spread out instead of
    arriving as one synchronized storm."""
    base = min(0.25 * (2 ** max(0, min(attempt - 1, 4))), 4.0)
    return base * (0.5 + (rng or random).random())


def _head_epoch_regressed(known: int, offered: Optional[int]) -> bool:
    """True when a register reply proves the answering head is a superseded
    zombie: it offers an authority epoch strictly below one this process
    already adopted from a successor.  Clients refuse such a head (close,
    rotate to the next ring address) instead of handing it their state."""
    return bool(known) and offered is not None and int(offered) < known


def global_worker() -> "Worker":
    if _global_worker is None:
        raise RuntimeError("not initialized — call init() first")
    return _global_worker


def try_global_worker() -> Optional["Worker"]:
    return _global_worker


def set_global_worker(w: Optional["Worker"]):
    global _global_worker
    with _global_lock:
        _global_worker = w


def _cuda_leaves(value: Any) -> list:
    """CUDA tensors among the leaves of a dict/list/tuple tree (the port's
    counterpart of a tree holding a jax.Array).  Only consulted once torch
    is loaded: no other process can hold one."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not hasattr(torch, "Tensor"):
        return []
    found, stack = [], [value]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                found.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return found


def _is_device_value(value: Any) -> bool:
    """True if the tree holds a CUDA tensor: such a value stays in the
    process that made it (device_objects) and other processes hold a
    "device" entry naming its owner; CPU tensors and numpy arrays are host
    values and take the object store's zero-copy shm path."""
    return bool(_cuda_leaves(value))


def _device_spec(value: Any) -> str:
    return ", ".join(f"Tensor{tuple(t.shape)}:{t.dtype}@{t.device}" for t in _cuda_leaves(value))


@dataclass
class _Lease:
    lease_id: str
    worker_id: str
    addr: str
    inflight: int = 0
    dead: bool = False
    last_idle: float = field(default_factory=time.monotonic)
    # which plane granted this lease: a node agent's address (local grant
    # out of a delegated lease block) or None for the head.  Releases go
    # back to the granter.
    granter: Optional[str] = None
    # node hosting the leased worker: lets the submitter tell a drain/
    # preemption kill (budget-exempt retry) from an app-level worker crash
    node: Optional[str] = None
    # node incarnation the grant was minted under (agent-granted leases):
    # a post-heal audit proves no outstanding grant predates the verdict
    inc: Optional[int] = None


class LeasePool:
    """Per-resource-shape pool of worker leases with pipelining.

    Mirrors the lease reuse + pipelining of NormalTaskSubmitter: hold up to
    `max_leases` concurrent leases per shape, pipeline up to
    `max_inflight_per_lease` pushes onto each, return leases idle beyond the
    timeout so other processes (nested tasks, actors) can use the CPUs.
    """

    def __init__(
        self,
        worker: "Worker",
        shape_key: tuple,
        shape: Dict[str, float],
        pg: Optional[Tuple[str, int]],
        strategy: Optional[Dict[str, Any]] = None,
    ):
        self.worker = worker
        self.shape = shape
        self.pg = pg
        self.strategy = strategy
        self.inflight_total = 0  # pushed + backlogged + acquiring, all lanes
        self.leases: List[_Lease] = []
        self.waiters: deque = deque()
        # fast lane for argless known-function tasks that found no pushable
        # lease: plain (task_id, fn_id, opts, oids) records drained by
        # release()/new-lease callbacks — no per-task coroutine, no Future
        # (the 4k-noop flood otherwise spawns one asyncio.Task per task)
        self.backlog: deque = deque()
        self._dialing: set = set()  # lease addrs with a connect in flight
        self.requests_outstanding = 0
        cfg = worker.config
        self.max_leases = cfg.max_leases_per_shape
        self.max_inflight = cfg.max_inflight_per_lease
        # contended-cluster fair share: while other clients' lease requests
        # are queued at the head, the head pushes a per-client lease cap;
        # this pool sheds down to it as pipelines drain and stops growing
        # past it.  Expires when the head stops re-nudging (contention over).
        self.contended_cap: Optional[int] = None
        self.contended_until = 0.0
        # every lease block denied us while we already hold capacity: the
        # cluster is saturated for this class — rate-limit further growth
        # attempts so a long flood pipelines instead of re-probing
        # agents/head on every release (the pipelining regime absorbs it)
        self._growth_backoff_until = 0.0

    def _pick(self) -> Optional[_Lease]:
        best = None
        for l in self.leases:
            if not l.dead and l.inflight < self.max_inflight:
                if best is None or l.inflight < best.inflight:
                    best = l
        return best

    async def acquire(self) -> _Lease:
        """Get a lease to push one task onto.

        Preference order balances parallelism against pipelining: (1) an idle
        lease — the task starts immediately; (2) grow the pool, but only up to
        the observed demand (inflight + waiting + this task) so a burst of N
        long tasks gets N parallel leases without flooding the head with
        max_leases speculative requests; (3) once growth is exhausted,
        pipeline onto the least-loaded busy lease (the tiny-task throughput
        path: beyond max_leases concurrent tasks, queueing at workers beats
        per-task lease RPCs)."""
        self.inflight_total += 1
        try:
            while True:
                lease = self._pick()
                if lease is not None and lease.inflight == 0:
                    lease.inflight += 1
                    return lease
                if not self._maybe_grow() and lease is not None and self._pipeline_ok():
                    lease.inflight += 1
                    return lease
                fut = asyncio.get_running_loop().create_future()
                self.waiters.append(fut)
                await fut  # raises if the lease request failed terminally
        except BaseException:
            self.inflight_total -= 1
            raise

    _MAX_OUTSTANDING = 8  # lease requests in flight at the head per pool

    def _should_grow(self) -> bool:
        """Grow towards observed demand, with a cap on in-flight lease
        requests so an ungrantable burst doesn't pile a max_leases-deep queue
        at the head (the head re-scans pending requests every release)."""
        if self.requests_outstanding >= self._MAX_OUTSTANDING:
            return False
        live = sum(1 for l in self.leases if not l.dead)
        if live > 0 and time.monotonic() < self._growth_backoff_until:
            return False  # saturated lease plane: pipeline, don't re-probe
        limit = min(self.max_leases, self.inflight_total)
        cap = self._fair_cap()
        if cap is not None:
            limit = min(limit, cap)
        return live + self.requests_outstanding < limit

    def _pipeline_ok(self) -> bool:
        return self._pipeline_ok_for(self.inflight_total)

    def _pipeline_ok_for(self, demand: int) -> bool:
        """Pushing onto a BUSY lease is right only when the leases we already
        have plus those on the way cannot cover demand (the tiny-task flood
        case).  While expected leases >= demand, waiting for one is right —
        pipelining there would serialize long tasks on one worker while the
        rest of the cluster idles.  SPREAD pools never pipeline before the
        lease cap: queueing depth on a warm node is exactly what the
        strategy exists to avoid, so they keep growing instead."""
        live = sum(1 for l in self.leases if not l.dead)
        expected = live + self.requests_outstanding
        if expected >= demand:
            return False
        if expected >= self.max_leases:
            return True
        if self.strategy is not None and self.strategy.get("type") == "SPREAD":
            return False
        return self.requests_outstanding >= self._MAX_OUTSTANDING

    def _delegatable(self) -> bool:
        """Is this pool's lease class grantable node-locally?  Only the hot
        default class qualifies ({"CPU": 1}, no PG, no strategy): PG bundle
        charging and placement policy stay centralized at the head, and
        remote (client-mode) drivers need the head's TCP address mapping."""
        return (
            self.pg is None
            and self.strategy is None
            and self.shape == {"CPU": 1.0}
            and not self.worker.client_mode
            and self.worker.config.lease_delegation
        )

    def _adopt_lease(self, lease: "_Lease"):
        if lease.node:
            # chaos labeling: map the leased worker's address to its node so
            # connections to it ride the right (src, dst) link policy
            netchaos.register_addr(lease.addr, lease.node)
            netchaos.register_addr(
                self.worker._normalize_peer_addr(lease.addr), lease.node
            )
        self.leases.append(lease)
        self.requests_outstanding -= 1
        self._drain_backlog()
        self._wake(self.max_inflight)

    # head-side ttl on lease-plane escalation probes: a delegatable-class
    # request queued at the head expires after this long and the coroutine
    # re-probes the agents — so overflow requests never pin central state
    # (the head only revokes lease blocks for no-ttl pendings)
    _HEAD_PROBE_TTL_S = 2.0

    async def _request_lease(self):
        # lease plane: try the node agents' delegated blocks first — a grant
        # there is one direct agent RPC, zero head traffic (the raylet-grant
        # split; the head stays the fallback granter)
        delegatable = self._delegatable()
        lease_plane = False  # delegated blocks exist somewhere
        if delegatable:
            lease, lease_plane = await self.worker.local_lease_grant("cpu")
            if lease is not None:
                LEASE_STATS["local_grants"] += 1
                self._adopt_lease(lease)
                return
            if lease_plane:
                # the plane exists but denied us — head fallback is an
                # ESCALATION PROBE, not the primary path
                LEASE_STATS["fallbacks"] += 1
                if any(not l.dead for l in self.leases):
                    # blocks exhausted while we already hold capacity:
                    # saturated.  Back off growth so a long flood pipelines
                    # on what it has instead of re-probing agents + head on
                    # every release.  A pool with NO leases never backs off
                    # — it must reach the head for its first grant.
                    self._growth_backoff_until = time.monotonic() + 0.25
                if self.requests_outstanding > 1:
                    # another of this pool's requests is already subscribed
                    # at the head; a second adds nothing the agents' churn
                    # won't deliver first — abandon this growth attempt
                    self.requests_outstanding -= 1
                    return
        kw = {}
        if self.pg is not None:
            kw = {"pg_id": self.pg[0], "bundle_index": self.pg[1]}
        if self.strategy is not None:
            kw["strategy"] = self.strategy
        if lease_plane:
            # without agents in play this stays a classic held-until-granted
            # request: single-node clusters keep their full pending queue
            # (the autoscaler's demand signal) and growth concurrency
            kw["ttl"] = self._HEAD_PROBE_TTL_S
        attempts = 0
        retry_local = False
        while True:
            if delegatable and retry_local:
                # between head (re)subscriptions — expiry or restart window —
                # probe the agents: the lease plane keeps granting while the
                # control plane is down or saturated
                lease, lease_plane = await self.worker.local_lease_grant("cpu")
                if lease is not None:
                    LEASE_STATS["local_grants"] += 1
                    self._adopt_lease(lease)
                    return
            retry_local = True
            try:
                reply = await self.worker.head.call(
                    "request_lease", shape=self.shape, timeout=None, **kw
                )
            except ConnectionError:
                # head died mid-request (restart window): re-issue once the
                # housekeeping loop has reconnected, instead of failing the
                # queued tasks
                attempts += 1
                if self.worker._stopped or self.worker._head_fenced or attempts > 120:
                    self.requests_outstanding -= 1
                    self._fail_waiters(ConnectionError("cluster head unreachable"))
                    return
                # jittered like every other head redial: a failover must not
                # turn N waiting lease pools into a synchronized retry storm
                await asyncio.sleep(_redial_backoff(attempts))
                continue
            except asyncio.CancelledError:
                raise  # shutdown: don't convert cancellation into waiter errors
            except Exception as e:
                # unrecoverable admission errors (e.g. removed placement
                # group) must surface on the waiting tasks, not spin forever
                self.requests_outstanding -= 1
                self._fail_waiters(e)
                return
            if reply.get("expired"):
                # at-capacity probe came back empty (not an error): re-probe
                # the agents, then re-subscribe — waiting for capacity is
                # legitimate indefinitely, exactly like a pending request
                await asyncio.sleep(0.1)
                continue
            LEASE_STATS["head_grants"] += 1
            self._adopt_lease(
                _Lease(
                    reply["lease_id"], reply["worker_id"], reply["addr"],
                    node=reply.get("node"),
                )
            )
            return

    def _wake(self, n: int = 1):
        while self.waiters and n > 0:
            fut = self.waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                n -= 1

    def _fail_waiters(self, exc: BaseException):
        while self.waiters:
            fut = self.waiters.popleft()
            if not fut.done():
                fut.set_exception(exc)
        while self.backlog:
            task_id, fn_id, opts, oids = self.backlog.popleft()
            self.inflight_total -= 1
            self.worker._store_error(oids, exc)

    def _maybe_grow(self) -> bool:
        """Issue one lease request when admission allows (the single place
        growth bookkeeping lives)."""
        if not self._should_grow():
            return False
        self.requests_outstanding += 1
        spawn_bg(self._request_lease())
        return True

    def enqueue_fast(self, task_id, fn_id, opts, oids) -> None:
        """Queue an argless known-function task for callback-drained push
        (IO thread only).  Counts as demand so growth/pipelining see it."""
        trace = opts.get("_trace")
        if trace is not None and TRACE_HOOK is not None:
            TRACE_HOOK.record_task_event(
                task_id.hex(), None, "task", "QUEUED", trace=trace,
                worker_id=self.worker.client_id, node_id=self.worker.node_id,
            )
        self.inflight_total += 1
        self.backlog.append((task_id, fn_id, opts, oids))
        self._maybe_grow()

    def _drain_backlog(self) -> None:
        """Push backlogged tasks onto leases while the same admission rules
        the submit path uses allow it (idle lease, or pipelining regime).
        A lease whose connection isn't established yet pauses the drain
        behind ONE dial coroutine (never a per-task coroutine); a lease
        whose connection broke is marked dead and the item retries on the
        next pick."""
        while self.backlog:
            lease = self._pick()
            if lease is None or (lease.inflight > 0 and not self._pipeline_ok()):
                self._maybe_grow()
                return
            conn = self.worker._conns.get(
                self.worker._normalize_peer_addr(lease.addr)
            )
            if conn is None or conn.closed:
                self._dial_then_drain(lease)
                return
            item = self.backlog.popleft()
            if item[0].binary() in self.worker._cancelled_tasks:
                self.inflight_total -= 1
                self.worker._store_error(
                    item[3], TaskCancelledError("task was cancelled")
                )
                continue
            if not self.worker._push_fast(self, lease, *item):
                # call_cb raised: _push_fast marked the lease dead; retry the
                # item on whatever _pick finds next round
                self.backlog.appendleft(item)

    def _dial_then_drain(self, lease: _Lease) -> None:
        """The granted lease's worker was never contacted (cold client):
        connect once in the background, then resume draining.  Without this,
        every backlogged item would divert to its own slow-path coroutine —
        exactly the flood the backlog lane exists to avoid.  A failed dial
        gives the lease BACK to the head (the worker may be fine — only this
        client's connect failed; keeping it would leak its capacity, since
        only return_lease or worker death ever releases it head-side)."""
        if lease.addr in self._dialing:
            return
        self._dialing.add(lease.addr)

        async def _dial():
            try:
                await self.worker.conn_to(lease.addr)
            except asyncio.CancelledError:
                raise  # the finally still clears _dialing
            except Exception:
                lease.dead = True
                # granter-aware give-back (head or agent); unreachable
                # granters reclaim via their own worker-death/disconnect paths
                self.worker.return_leases([lease])
            finally:
                self._dialing.discard(lease.addr)
                self._drain_backlog()

        spawn_bg(_dial())

    def release(self, lease: _Lease, dead: bool = False):
        self.inflight_total -= 1
        lease.inflight -= 1
        if dead:
            lease.dead = True
        if lease.inflight == 0:
            lease.last_idle = time.monotonic()
            self._maybe_shed(lease)
        self._drain_backlog()
        self._wake()

    def _fair_cap(self) -> Optional[int]:
        if (
            self.contended_cap is not None
            and time.monotonic() <= self.contended_until
        ):
            return self.contended_cap
        return None

    def _maybe_shed(self, lease: _Lease):
        """A pipelined lease just drained while the cluster is contended:
        give it back if this pool holds more than its fair share, so other
        clients' batches run CONCURRENTLY with ours instead of after it."""
        cap = self._fair_cap()
        if cap is None or lease.dead or lease.inflight:
            return
        live = sum(1 for l in self.leases if not l.dead)
        if live <= cap:
            return
        lease.dead = True
        self.leases = [l for l in self.leases if not l.dead]
        self.worker.return_leases([lease])

    def reap_idle(self, now: float, timeout: float) -> List[_Lease]:
        """Leases to give back to their granter (head or node agent)."""
        out = []
        keep = []
        for l in self.leases:
            if l.dead:
                continue
            if (
                l.inflight == 0
                and now - l.last_idle > timeout
                and not self.waiters
                and not self.backlog
            ):
                l.dead = True
                out.append(l)
            else:
                keep.append(l)
        self.leases = [l for l in self.leases if not l.dead]
        return out

    def reap_node(self, node_id: str) -> List[_Lease]:
        """Give back every IDLE lease hosted on `node_id` (drain recall:
        the node is leaving — new pushes must land on survivors).  Busy
        leases run on until the drain deadline; their deaths retry
        budget-exempt."""
        out = []
        for l in self.leases:
            if not l.dead and l.inflight == 0 and l.node == node_id:
                l.dead = True
                out.append(l)
        if out:
            self.leases = [l for l in self.leases if not l.dead]
        return out

    def reap_contended(self) -> List[_Lease]:
        """Another client's lease request is pending at the head: give back
        every idle lease this pool does not need for its own current demand
        (contended-cluster fairness; the 1s reap_idle horizon is for the
        UNcontended case, where keeping warm leases is pure latency win).
        Idle leases are kept only while live pipelining capacity cannot
        cover in-flight demand — and never beyond the fair-share cap."""
        out = []
        cap = self._fair_cap()
        live = sum(1 for l in self.leases if not l.dead)
        cover = sum(l.inflight for l in self.leases if not l.dead)
        demand = self.inflight_total
        for l in self.leases:
            if l.dead or l.inflight > 0:
                continue
            over_cap = cap is not None and live > cap
            if cover < demand and not over_cap:
                cover += self.max_inflight  # kept: about to absorb backlog
                continue
            l.dead = True
            live -= 1
            out.append(l)
        if out:
            self.leases = [l for l in self.leases if not l.dead]
        return out


class Worker:
    """Per-process core runtime."""

    _OWNER_ADDR_NEG_TTL = 5.0  # seconds a failed owner-address lookup caches
    _REFS_FLUSH_DELAY_S = 0.002  # refcount debounce window (IO-loop timer)

    def __init__(
        self,
        mode: str,
        session_dir: str,
        head_sock: str,
        config: Optional[CAConfig] = None,
        client_id: Optional[str] = None,
        loop: Optional[asyncio.AbstractEventLoop] = None,
        serve_addr: Optional[str] = None,
        serve_addr_tcp: Optional[str] = None,
        client_mode: bool = False,
    ):
        self.mode = mode  # "driver" | "worker"
        self.session_dir = session_dir
        self.session_name = os.path.basename(session_dir)
        # HA plane: head_sock may be a comma-separated ring (active head
        # first, then warm standbys).  Failed dials rotate through it; the
        # standbys list on every register reply merges in, so a client
        # started with one address still learns every promotion candidate.
        self._head_ring = AddrRing(addr_list(head_sock))
        self.head_sock = self._head_ring.current or head_sock
        self.head_epoch = 0  # highest head authority epoch observed
        self.config = config or get_config()
        self.client_id = client_id or f"{mode}-{os.getpid()}-{os.urandom(3).hex()}"
        self.serve_addr = serve_addr
        self.serve_addr_tcp = serve_addr_tcp
        # Ray-Client-analogue remote driver: reaches the cluster over TCP
        # only, claims a private client node id (its /dev/shm is invisible to
        # the cluster), and uploads escaping objects to the head's store
        self.client_mode = client_mode
        self.job_id = JobID.from_random()
        # which node this process runs on (n0 = the head's own node; agent
        # nodes set CA_NODE_ID for their workers)
        if client_mode:
            self.node_id = f"client-{self.client_id}"
        else:
            self.node_id = os.environ.get("CA_NODE_ID", "n0")
        self.memory_store = MemoryStore()
        self.shm_store = ShmObjectStore(
            self.session_name,
            owner_tag=self.client_id,
            node_id=self.node_id,
            budget_bytes=(config or get_config()).object_store_memory,
        )
        self.shm_store.spill_cb = self._spill_bytes
        self.shm_store.spill_kick_cb = self._spill_kick
        self._spill_lock = threading.Lock()  # one spill pass at a time
        self._spill_start_lock = threading.Lock()  # thread creation only
        self._spill_queue: Optional[Any] = None
        self._spill_thread: Optional[threading.Thread] = None
        # inline = a put paid spill latency (hard wall); background = the
        # watermark spiller ran instead.  Watched by tests and `ca status`.
        self.spill_stats = {"inline": 0, "background": 0}
        if mode == "driver" and not client_mode:
            # plasma-style pre-allocation: warm an arena while the driver is
            # still bootstrapping so early puts land in pre-faulted pages.
            # Client mode skips it: its local store only caches pulled
            # copies, and puts upload to the head instead
            self.shm_store.warm()
        self.fn_manager = FunctionManager()
        self.reference_counter = ReferenceCounter(self._flush_refs)
        # --- ownership plane (core/ownership.py) --------------------------
        # This process is the lifetime authority for the objects it creates:
        # its OwnerLedger holds their cluster-wide borrower sets, and other
        # processes settle inc/dec against it over direct connections.  The
        # head keeps only the registry (obj_created/obj_release) and adopts
        # orphaned ledgers on owner death (owner_sync digests).  Client-mode
        # drivers have no ledger — their puts are hosted (and their holders
        # kept) by the head — but still ROUTE updates for borrowed refs to
        # the owning worker over TCP.
        self._owner_plane = bool(getattr(self.config, "owner_plane", True))
        self.owner_ledger: Optional[OwnerLedger] = None
        if self._owner_plane and not client_mode:
            self.owner_ledger = OwnerLedger(
                self.client_id,
                on_clear=self._ledger_clear,
                on_pin_zero=self._ledger_pin_zero,
                pending_grace_s=getattr(self.config, "early_ref_grace_s", 600.0),
            )
        # borrowed oid -> owner client id (fed by ObjectRef rehydration);
        # routes that ref's inc/dec/pins to the owner's ledger.  NEVER
        # dropped eagerly — a value pin's release can fire from GC long
        # after the handle died, and misrouting it to the head would strand
        # the holder in the owner's ledger.  Pruned periodically instead
        # (housekeeping), skipping oids with live handles or queued updates;
        # pin callbacks re-seed their captured owner when they fire late.
        self._borrowed_owners: Dict[bytes, str] = {}
        # obj_release notifies that found the head down: re-sent by
        # housekeeping once the head is back (lifetime already settled —
        # only the registry record and remote copies remain to clean)
        self._deferred_releases: List[list] = []
        # obj_copy notifies that found the head down/unreachable: re-sent by
        # housekeeping so the directory eventually learns about pulled
        # copies (multi-source pulls split across them; eviction reclaims
        # them by name)
        self._deferred_copy_notifies: List[tuple] = []
        self._last_owner_sync = 0.0
        self._last_ledger_sweep = 0.0
        self._last_borrow_prune = 0.0
        self._owner_sync_full = True  # first sync after (re)connect is full
        # evict the cache when the last local ref drops: cached values hold
        # zero-copy views, which hold arena value-pins — without eviction,
        # pinned slices would never be reusable.  Owned INLINE values (no shm
        # backing) are kept: they are the only copy and stay resolvable
        self.reference_counter.set_on_zero(self._evict_on_zero)
        self._put_counter = _Counter()
        self._task_counter = _Counter()
        self.head: Optional[Connection] = None
        self._conns: Dict[str, Connection] = {}
        self._connecting: Dict[str, asyncio.Future] = {}
        self._lease_pools: Dict[tuple, LeasePool] = {}
        self._actor_addr_cache: Dict[str, Tuple[str, int]] = {}  # aid -> (addr, incarnation)
        self.total_resources: Dict[str, float] = {}
        # in-flight node-to-node object pulls, deduped by oid
        self._pulls: Dict[bytes, asyncio.Future] = {}
        # slices already spilled but whose memory awaits the last pin drop
        self._spilled_pinned: set = set()
        # in-flight streaming generators (ObjectRefGenerator consumers)
        self._streams: Dict[bytes, Any] = {}
        # cancellation (task_manager.h CancelTask role): task ids the owner
        # cancelled, and where each in-flight push currently executes
        self._cancelled_tasks: set = set()
        self._inflight_tasks: Dict[bytes, str] = {}  # task_id -> worker addr
        # drain plane: node_id -> monotonic expiry of the preemption window.
        # Fed by "drain" pubs from the head; worker/lease deaths on a node
        # inside its window are SYSTEM failures — retried without consuming
        # the task's max_retries budget (see _retry_exempt)
        self._draining_nodes: Dict[str, float] = {}
        # lineage: task specs of submitted normal tasks, so a lost object can
        # be recomputed by re-executing its creating task (object_recovery_
        # manager.h).  Holding the original arg ObjectRefs here pins the
        # dependency chain (lineage pinning).  FIFO-capped.
        self._lineage: Dict[bytes, dict] = {}
        self._lineage_order: deque = deque()
        self._recon_lock = threading.Lock()
        self._recon_events: Dict[bytes, threading.Event] = {}
        # device object table: oid-bytes -> live device value (owner side)
        self.device_objects: Dict[bytes, Any] = {}
        # --- p2p planes (ownership directory + direct collectives) --------
        # collective mailbox: (group, key, src_rank) -> (data, shape, dtype)
        # deliveries land on the IO loop (coll_push RPC); rank threads block
        # in coll_wait.  Bounded by op lockstep + cleared on group close.
        self._coll_cond = threading.Condition()
        self._coll_mail: Dict[Tuple[str, str, int], tuple] = {}
        # owner-addr cache for p2p location resolution: client_id ->
        # Connection-able addr (None = owner unreachable/non-serving; the
        # head fallback handles it).  One head lookup per OWNER, not per
        # object.
        # owner -> (addr | None, expiry | None): positive entries live for
        # the session, negative ones expire so transient head failures
        # don't permanently disable the p2p/owner path for a healthy peer
        self._owner_addr_cache: Dict[str, Tuple[Optional[str], Optional[float]]] = {}
        self._p2p_server = None  # driver-mode mini server (workers use theirs)
        self.current_task_id: Optional[TaskID] = None
        self.current_actor_id: Optional[ActorID] = None
        # submission pump: user threads enqueue coroutine factories here; one
        # threadsafe wakeup drains many submissions (hot-path amortization)
        self._submit_queue: deque = deque()
        self._submit_wakeup_pending = False
        self._submit_lock = threading.Lock()
        # refcount piggyback/debounce: every obj_refs update (owner counts,
        # value pins, transit pins) coalesces into this per-holder dirty map
        # on the IO loop and flushes as ONE notify per holder after a short
        # timer — a 4k-object burst of inc/dec churn becomes a handful of
        # logical messages riding the outgoing batch envelopes instead of a
        # message per object.  Keyed (as_id, ttl); values {"inc": set,
        # "dec": set}.
        self._ref_pending: Dict[tuple, dict] = {}
        self._ref_flush_scheduled = False
        # pre-encoded task-spec templates for the argless fast paths, keyed by
        # the spec's constant fields (fn/actor+method, num_returns, retriable)
        self._spec_templates: Dict[tuple, MsgTemplate] = {}
        # lease-plane directory cache: (fetched_at, entries|None).  Entries
        # survive head outages (stale beats nothing: agents keep granting
        # while the control plane restarts); refreshed at most once per
        # lease_dir_ttl_s and only while a pool is growing.
        self._lease_dir_cache: Tuple[float, Optional[list]] = (0.0, None)
        # fn_ids whose blob was already inlined per worker connection during
        # a head outage: one delivery per (conn, fn) — the worker caches the
        # definition, so repeating the blob on every push of a flood would
        # just multiply frame size (weak-keyed: dies with the connection)
        import weakref

        self._conn_fn_sent: "weakref.WeakKeyDictionary[Connection, set]" = (
            weakref.WeakKeyDictionary()
        )
        self._stopped = False
        self._head_fenced = False  # head refused/fenced this process: must exit
        # hook for the worker-process host: invoked (on the IO loop) the
        # moment a fence verdict lands, so zombie tasks are cancelled
        # immediately instead of on the next watch tick
        self._on_fenced_cb: Optional[Any] = None
        # head-redial backoff (jittered): a head restart with N workers must
        # not produce a synchronized reconnect storm on a fixed tick
        self._redial_attempts = 0
        self._redial_next = 0.0
        # network-chaos plane: per-link partition/straggler injection (spec
        # from config at start; runtime `ca chaos set` arrives as pushes)
        netchaos.maybe_install_from_config(self.config, self.node_id)
        # flight recorder: journal this process's plane decisions; slices
        # ship on the metrics-delta piggyback (util/metrics.flush_once)
        if getattr(self.config, "flightrec_plane", True):
            from ..util import flightrec, metrics as _metrics

            flightrec.init(
                cap=getattr(self.config, "flightrec_ring_len", 4096),
                node_id=self.node_id, proc=self.client_id,
            )
            # the journal ships on the metrics flush: arm the flusher now —
            # a process that never mints a Metric must still ship its events
            _metrics._ensure_flusher()
        # log plane: lazily-built printer for log_batch pushes (drivers
        # subscribed via log_sub; see util/logplane.DriverLogPrinter)
        self._log_printer = None
        self._external_loop = loop is not None
        if loop is None:
            self.loop = asyncio.new_event_loop()
            # eager tasks (3.12+): submission coroutines usually run to their
            # first await synchronously, skipping a schedule round-trip per task
            if hasattr(asyncio, "eager_task_factory"):
                self.loop.set_task_factory(asyncio.eager_task_factory)
            self._io_thread = threading.Thread(
                target=self._run_loop, name="ca-io", daemon=True
            )
            self._io_thread.start()
        else:
            self.loop = loop
            self._io_thread = None

    # ------------------------------------------------------------- io thread
    def _run_loop(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run_coro(self, coro, timeout: Optional[float] = None):
        """Run a coroutine on the IO loop from a user thread, blocking."""
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def _pump_submit(self, coro_factory):
        """Enqueue a submission coroutine with one amortized loop wakeup."""
        with self._submit_lock:
            self._submit_queue.append(coro_factory)
            if self._submit_wakeup_pending:
                return
            self._submit_wakeup_pending = True
        try:
            self.loop.call_soon_threadsafe(self._drain_submit_queue)
        except RuntimeError:
            # loop closed (shutdown): drop the queued submission and surface
            # the error instead of hanging a future get()
            with self._submit_lock:
                self._submit_queue.clear()
                self._submit_wakeup_pending = False
            raise RuntimeError("cannot submit work: runtime is shut down")

    def _drain_submit_queue(self):
        with self._submit_lock:
            items = list(self._submit_queue)
            self._submit_queue.clear()
            self._submit_wakeup_pending = False
        for factory in items:
            # a factory may complete synchronously (fast-path submission via
            # call_cb) and return None; only coroutines become tasks
            coro = factory()
            if coro is not None:
                task = spawn_bg(coro)
                task.add_done_callback(self._report_task_exc)

    @staticmethod
    def _report_task_exc(task):
        """Done-callback for fire-and-forget submissions (asyncio tasks and
        concurrent futures alike)."""
        if not task.cancelled():
            exc = task.exception()
            if exc is not None:
                import traceback

                print(
                    f"[ca] internal submission error: {exc!r}\n"
                    + "".join(traceback.format_exception(exc)),
                    flush=True,
                )

    # ------------------------------------------------------------- bootstrap
    def connect(self):
        self.run_coro(self.connect_async(), timeout=30)

    async def connect_async(self):
        if self.mode == "driver" and not self.client_mode and self.serve_addr is None:
            # the driver serves the p2p planes too (owner_locate for objects
            # it owns, coll_push for collective ranks) — in the reference
            # every worker INCLUDING the driver runs a core-worker gRPC
            # server (core_worker.h); without one, every driver-owned ref
            # resolution would fall back to polling the head
            await self._start_p2p_server()
        self.head = await self._dial_head()
        self.head.set_push_handler(self._on_push)
        reply = await self.head.call(
            "register",
            role=self.mode,
            client_id=self.client_id,
            pid=os.getpid(),
            addr=self.serve_addr or self._p2p_addr() or "",
            addr_tcp=self.serve_addr_tcp or self._p2p_addr_tcp() or "",
            node_id=self.node_id,
            remote=self.client_mode,
        )
        self.total_resources = reply["resources"]
        self._adopt_register_reply(reply)
        self._maybe_log_sub(self.head)
        self._housekeeping_task = spawn_bg(self._housekeeping())

    async def _dial_head(self) -> Connection:
        """Dial the head address ring: each candidate once, starting at the
        current pick, rotating on failure.  Raises the last error when every
        candidate is down (callers treat that as 'head still restarting')."""
        from ..util.aio import dial  # lazy: util/__init__ reaches into core

        last: Optional[BaseException] = None
        for _ in range(max(1, len(self._head_ring))):
            addr = self._head_ring.current or self.head_sock
            netchaos.register_addr(addr, "n0")
            try:
                conn = await dial(addr, purpose="head", peer_node="n0")
            except asyncio.CancelledError:
                raise
            except Exception as e:
                last = e
                self._head_ring.rotate()
                continue
            # `addr` is the ring slot this dial succeeded against; a ring
            # merge landing during the dial must not retarget it:
            # ca-lint: ignore[async-await-race]
            self.head_sock = addr
            return conn
        raise last if last is not None else ConnectionError("no head address")

    def _adopt_register_reply(self, reply: dict) -> None:
        """Post-register adoption: worker processes stamp their node's
        incarnation AND the head authority epoch onto every head RPC (the
        fencing tokens — a stale ninc after a partition verdict, or a stale
        hep after a head failover, is refused before side effects land), and
        any active runtime chaos schedule is installed locally."""
        ep = reply.get("head_epoch")
        if ep is not None:
            self.head_epoch = max(self.head_epoch, int(ep))
        if reply.get("standbys"):
            # learn every promotion candidate for the next failover
            self._head_ring.merge(reply["standbys"])
        if self.mode == "worker":
            # set OR clear: a reply without node_inc (snapshotless head
            # restart racing the agent's rejoin) must not leave any prior
            # stamp semantics ambiguous on the fresh connection
            ni = reply.get("node_inc")
            stamp = {}
            if ni is not None:
                stamp["ninc"] = ni
            if ep is not None:
                stamp["hep"] = int(ep)
            self.head.stamp = stamp or None
        if reply.get("net_chaos"):
            try:
                netchaos.install(
                    reply["net_chaos"], self.node_id,
                    epoch=reply.get("net_chaos_epoch"),
                )
            except (ValueError, TypeError):
                pass

    def _maybe_log_sub(self, conn) -> None:
        """Subscribe this driver to the cluster log stream (log plane):
        remote workers' prints land on our stdout/stderr with attribution.
        init(log_to_driver=False) opts out."""
        if self.mode != "driver" or not getattr(self.config, "log_to_driver", True):
            return
        try:
            conn.notify("log_sub")
        except Exception:
            pass

    def _on_log_batch(self, msg) -> None:
        printer = self._log_printer
        if printer is None:
            from ..util.logplane import DriverLogPrinter

            printer = self._log_printer = DriverLogPrinter()
        try:
            printer.print_records(msg.get("records") or ())
        except Exception:
            pass  # a printing hiccup must never take down the read loop

    async def _on_push(self, msg):
        if msg.get("m") == "log_batch":
            self._on_log_batch(msg)
            return
        if msg.get("m") == "fenced":
            # the head refused an RPC stamped with our (stale) node
            # incarnation: this process was declared dead — stop acting
            from .ownership import warn_ratelimited

            warn_ratelimited(
                "worker-fenced",
                f"head fenced this process (node {msg.get('node_id')} "
                f"incarnation {msg.get('ninc')} superseded): cancelling "
                f"zombie tasks and exiting",
            )
            self._fence_now()
            return
        if msg.get("m") == "net_chaos":
            # runtime chaos broadcast (`ca chaos set`)
            try:
                netchaos.install(
                    msg.get("spec") or "", self.node_id,
                    epoch=msg.get("epoch"),
                )
            except (ValueError, TypeError):
                pass
            return
        if msg.get("m") == "ha_ring":
            # runtime standby-ring dissemination (HA plane): learn failover
            # targets that subscribed after this worker registered
            self._head_ring.merge(msg.get("standbys") or [])
            ep = msg.get("head_epoch")
            if ep is not None and int(ep) > self.head_epoch:
                self.head_epoch = int(ep)
            return
        if msg.get("m") == "owner_refs":
            # the head settling against THIS owner's ledger: releasing a
            # settled ledgerless (client-mode) container's containment edges
            # (head._release_cnt_pairs), or relaying a borrower's inc/dec/pin
            # that fell back to it while we were transiently unreachable
            # (head._forward_to_owner)
            self.serve_owner_refs(
                msg.get("inc"), msg.get("dec"),
                msg.get("as_id") or "head", bool(msg.get("ttl")),
            )
            return
        if msg.get("m") == "owner_transit_done":
            # relayed receiver ack for a transit pin held in this ledger
            self.serve_owner_transit_done(
                msg["token"], msg.get("oids"), msg.get("cid", "?"),
                msg.get("register", True),
            )
            return
        if msg.get("m") != "pub":
            return
        ch = msg.get("ch")
        if ch == "actors":
            data = msg.get("data") or {}
            aid = data.get("actor_id")
            if (
                aid and data.get("addr") and not self.client_mode
                and data.get("state") == "alive"
            ):
                # remote clients can't use pub'd (unix) addrs; they refresh
                # through get_actor, which maps to the TCP dual.  Only an
                # alive incarnation may land in the cache: dead/restarting
                # pubs can still carry the old worker's addr
                self._actor_addr_cache[aid] = (data["addr"], data.get("incarnation", 0))
            elif aid and data.get("state") in ("restarting", "dead"):
                # drop the stale route immediately instead of waiting for a
                # failed dial to trigger the get_actor refresh
                self._actor_addr_cache.pop(aid, None)
        elif ch == f"shm_free:{self.client_id}":
            data = msg.get("data") or {}
            name = data.get("shm_name")
            if name:
                self.shm_store.free_local(name)
        elif ch == "drain":
            self._on_drain_pub(msg.get("data") or {})
        elif ch == "nodes":
            data = msg.get("data") or {}
            if data.get("alive") is False and data.get("node_id"):
                self._on_node_dead_pub(data["node_id"])
        elif ch == "client_gone":
            # a borrower process died: its holder ids, value pins, transit
            # tokens, and containment edges in this owner's ledger can never
            # dec — purge them (the head does the same for its own records)
            gone = (msg.get("data") or {}).get("client_id")
            if gone:
                if self.owner_ledger is not None:
                    self.owner_ledger.purge_holder(gone)
                # in-flight owner routing to it should fail over to the head
                self._owner_addr_cache[gone] = (
                    None, time.monotonic() + self._OWNER_ADDR_NEG_TTL
                )
        elif ch == "lease_reclaim":
            # another client's lease request is queued: return surplus idle
            # leases NOW instead of after the idle timeout, and shed down to
            # the head's fair-share cap as pipelines drain (multi-client
            # fairness — without this, client batches serialize on ~1s gaps)
            cap = (msg.get("data") or {}).get("cap")
            to_return = []
            for pool in self._lease_pools.values():
                if pool.pg is not None:
                    # PG leases return to the placement group's own
                    # reservation, never to free cluster capacity — shedding
                    # them can't satisfy the contending client and only costs
                    # this client re-acquisition latency
                    continue
                if cap is not None:
                    pool.contended_cap = int(cap)
                    pool.contended_until = time.monotonic() + 1.0
                to_return.extend(pool.reap_contended())
            self.return_leases(to_return)

    # drain kills may land a little after the announced deadline (the head's
    # monitor tick, worker teardown): the retry exemption outlives it by this
    _DRAIN_GRACE_S = 15.0

    def _on_drain_pub(self, data: dict) -> None:
        """Head announced a node drain (preemption warning, `ca drain`,
        autoscaler downscale).  From now until the deadline (+grace), any
        worker death on that node is a system failure: retries are exempt
        from the user's max_retries budget.  Idle leases on the node are
        returned immediately so new tasks land on survivors."""
        nid = data.get("node_id")
        if not nid:
            return
        window = float(data.get("deadline_s") or 0.0) + self._DRAIN_GRACE_S
        self._draining_nodes[nid] = time.monotonic() + window
        from ..util import flightrec

        if flightrec.REC is not None:
            flightrec.REC.record(
                "drain", "drain_pub", target_node=nid,
                reason=data.get("reason"), deadline_s=data.get("deadline_s"),
            )
        # steer new local grants away: the cached lease directory may name
        # the draining agent for up to a TTL — drop it now
        ts, entries = self._lease_dir_cache
        if entries:
            self._lease_dir_cache = (
                ts, [e for e in entries if e.get("node_id") != nid]
            )
        recalled = []
        for pool in self._lease_pools.values():
            recalled.extend(pool.reap_node(nid))
        if recalled:
            DRAIN_STATS["leases_recalled_total"] += len(recalled)
            self.return_leases(recalled)

    def _fence_now(self) -> None:
        """A death verdict landed (refused re-register, FencedError reply,
        or a `fenced` push): this process must stop acting on anything
        minted under its dead incarnation.  Sets the fence flag and fires
        the host callback — the worker process cancels its RUNNING zombie
        tasks immediately (side effects must not complete) instead of
        waiting for the next watch-loop tick."""
        if self._head_fenced:
            return
        self._head_fenced = True
        from ..util import flightrec

        if flightrec.REC is not None:
            flightrec.REC.record(
                "fence", "fenced", client_id=self.client_id,
            )
        cb = self._on_fenced_cb
        if cb is not None:
            try:
                cb()
            except Exception:
                pass

    def _on_node_dead_pub(self, nid: str) -> None:
        """The head declared a node dead (crash, or a partition verdict).
        A partitioned worker's socket never closes by itself — frames just
        vanish — so in-flight pushes toward that node would hang forever.
        Drop its leases, purge it from the cached lease directory, and
        close our connections to its workers NOW: pending push_task calls
        fail with ConnectionError and the normal retry machinery resubmits
        on surviving capacity."""
        if nid == self.node_id:
            return  # our own node: the fence/register path governs us
        dead_addrs = set()
        for pool in self._lease_pools.values():
            hit = False
            for l in pool.leases:
                if l.node == nid and not l.dead:
                    dead_addrs.add(self._normalize_peer_addr(l.addr))
                    l.dead = True  # busy or idle: never pick/return it again
                    hit = True
            if hit:
                pool.leases = [l for l in pool.leases if not l.dead]
        ts, entries = self._lease_dir_cache
        if entries:
            self._lease_dir_cache = (
                ts, [e for e in entries if e.get("node_id") != nid]
            )
        for addr in dead_addrs:
            conn = self._conns.pop(addr, None)
            if conn is not None and not conn.closed:
                spawn_bg(conn.close())

    def draining_node_ids(self) -> set:
        """Node ids currently inside an announced drain window (fed by the
        head's `drain` pubs; entries expire at deadline+grace).  The serve
        controller reads this to stop routing to / start replacing replicas
        on exiting nodes with ZERO extra head RPCs.  Thread-safe snapshot."""
        now = time.monotonic()
        return {n for n, exp in dict(self._draining_nodes).items() if exp > now}

    def _retry_exempt(self, node_id: Optional[str]) -> bool:
        """Is a worker death on `node_id` inside a drain window?  Exempt
        retries don't consume max_retries (announced exits are the system's
        fault, not the app's)."""
        if not node_id:
            return False
        exp = self._draining_nodes.get(node_id)
        if exp is None:
            return False
        if time.monotonic() > exp:
            del self._draining_nodes[node_id]
            return False
        return True

    async def _housekeeping(self):
        period = 0.25
        last_touch = time.monotonic()
        while not self._stopped:
            await asyncio.sleep(period)
            now = time.monotonic()
            if self.client_mode and now - last_touch > 30:
                # keep the client session dir's mtime fresh so another
                # ca.init on this host's stale-session sweep (api.py
                # _sweep_stale_sessions, 1h horizon) never reaps a live
                # client's scratch/pull-cache out from under it
                last_touch = now
                try:
                    os.utime(self.session_dir)
                except OSError:
                    pass
            if self.head is not None and self.head.closed and not self._head_fenced:
                # head died (restart-in-progress): keep redialing; the
                # restarted head re-adopts us from its snapshot.  Jittered
                # exponential backoff: a head restart with N workers on a
                # fixed tick produced a synchronized reconnect storm
                if now >= self._redial_next:
                    if await self._reconnect_head():
                        self._redial_attempts = 0
                        self._redial_next = 0.0
                    else:
                        self._redial_attempts += 1
                        self._redial_next = now + _redial_backoff(
                            self._redial_attempts
                        )
            to_return = []
            for pool in self._lease_pools.values():
                to_return.extend(pool.reap_idle(now, self.config.lease_idle_timeout_s))
            self.return_leases(to_return)
            if self._draining_nodes:
                # expired preemption windows (the node is gone or the drain
                # completed long ago) stop excluding/exempting
                self._draining_nodes = {
                    n: t for n, t in self._draining_nodes.items() if t > now
                }
            self.reference_counter.flush()
            if (
                self._deferred_copy_notifies
                and self.head is not None
                and not self.head.closed
            ):
                # transfer plane: copies the directory missed (notify raced
                # a head restart).  Dropped-meanwhile copies are skipped —
                # advertising a freed slice would feed multi-source pulls a
                # dead source.
                pend, self._deferred_copy_notifies = (
                    self._deferred_copy_notifies, [],
                )
                for oid_b, name in pend:
                    if not self.shm_store.is_local(name):
                        continue
                    try:
                        self.head.notify(
                            "obj_copy", oid=oid_b, node=self.node_id,
                            shm_name=name,
                        )
                    except Exception:
                        self._deferred_copy_notifies.append((oid_b, name))
            if self.owner_ledger is not None:
                self._owner_plane_tick(now)
            if (
                self._owner_plane
                and len(self._borrowed_owners) > 4096
                and now - self._last_borrow_prune > 10.0
            ):
                # bound the borrowed-owner map: drop routing entries for
                # oids with no live handle, no cached entry, and no queued
                # update (late pin releases re-seed their captured owner)
                self._last_borrow_prune = now
                queued: set = set()
                for ent in self._ref_pending.values():
                    queued |= ent["inc"]
                    queued |= ent["dec"]
                for oid_b in list(self._borrowed_owners):
                    o = ObjectID(oid_b)
                    if (
                        oid_b not in queued
                        and self.reference_counter.local_count(o) == 0
                        and self.memory_store.get_entry(o) is None
                    ):
                        del self._borrowed_owners[oid_b]
            self._flush_task_events()

    _TASK_EVENTS_CHUNK = 5000  # bounded notify frames after a long restage

    def _flush_task_events(self):
        """Ship buffered lifecycle/span events to the head's task_events ring
        (IO loop only).  Events drained while the head is unreachable are
        re-staged, not lost.  Sent in bounded chunks: a buffer that grew
        toward the cap during a head outage must not become one giant frame
        that stalls the IO loop right as the cluster recovers."""
        from ..util import tracing

        if self.head is None or self.head.closed:
            return  # leave the buffer in place; no drain/restage churn
        events = tracing.drain_events()
        if not events:
            return
        chunk = self._TASK_EVENTS_CHUNK
        for i in range(0, len(events), chunk):
            try:
                self.head.notify("task_events", events=events[i : i + chunk])
            except Exception:
                tracing.restage_events(events[i:])
                return

    async def _reconnect_head(self) -> bool:
        """Redial and re-register with the head (gcs_client_reconnection
        analogue), walking the HA address ring on failure.  Sets
        _head_fenced if the head refuses us (it declared this worker dead —
        the process must exit, not retry)."""
        if not self.client_mode:
            # failover: a promoted standby rewrites the session's head.addr
            # — fold the current occupant into the ring before dialing, so
            # even a client configured with only the dead head's address
            # finds the successor
            try:
                cur = open(
                    os.path.join(self.session_dir, "head.addr")
                ).read().strip()
                if cur:
                    self._head_ring.merge([cur])
            except OSError:
                pass
        try:
            conn = await self._dial_head()
        except asyncio.CancelledError:
            raise
        except Exception:
            return False
        conn.set_push_handler(self._on_push)
        try:
            reply = await conn.call(
                "register",
                role=self.mode,
                client_id=self.client_id,
                pid=os.getpid(),
                # same fallbacks as the initial registration: the driver's
                # only serving socket is its p2p listener — dropping it here
                # made driver-owned inline objects unresolvable for
                # borrowers after a head restart
                addr=self.serve_addr or self._p2p_addr() or "",
                addr_tcp=self.serve_addr_tcp or self._p2p_addr_tcp() or "",
                node_id=self.node_id,
                remote=self.client_mode,
                timeout=5,
            )
        except asyncio.CancelledError:
            await conn.close()
            raise  # shutdown mid-redial: release the socket, stay cancelled
        except FencedError:
            await conn.close()
            self._fence_now()  # death verdict: cancel zombies, then exit
            return False
        except Exception as e:
            await conn.close()  # before anything that could raise (str(e) can)
            if "declared dead" in str(e):
                self._fence_now()
            else:
                # a standby's refusal (or any other register failure): try
                # the next ring candidate on the following tick
                self._head_ring.rotate()
            return False
        if _head_epoch_regressed(self.head_epoch, reply.get("head_epoch")):
            # a resurrected OLD head answered this redial: refuse it — we
            # already adopted a successor's epoch, and handing this zombie
            # our registration would fork the registry
            from ..util import flightrec

            if flightrec.REC is not None:
                flightrec.REC.record(
                    "ha", "ha_fence_old_head", client_id=self.client_id,
                    offered=int(reply.get("head_epoch") or 0),
                    known=self.head_epoch,
                )
            await conn.close()
            self._head_ring.rotate()
            return False
        self.head = conn
        self._adopt_register_reply(reply)
        # the restarted head lost its subscriber table: re-join the stream
        self._maybe_log_sub(conn)
        # ... and this owner's ledger digest: next owner_sync is a full one
        self._owner_sync_full = True
        return True

    # ----------------------------------------------------------- lease plane
    async def _lease_directory(self) -> list:
        """Where are the delegated lease blocks?  One head RPC per TTL while
        pools grow; zero in steady state (leases are reused/pipelined).  The
        cached directory is intentionally kept through head outages and RPC
        failures — the agents it names keep granting regardless."""
        ts, entries = self._lease_dir_cache
        now = time.monotonic()
        if entries is not None and now - ts < self.config.lease_dir_ttl_s:
            return entries
        if self.head is None or self.head.closed:
            return entries or []
        try:
            r = await self.head.call("lease_dir", timeout=5)
            entries = (r.get("nodes") or []) if r.get("delegation", True) else []
        except asyncio.CancelledError:
            raise
        except Exception:
            entries = entries or []  # keep stale; back off one TTL either way
        self._lease_dir_cache = (now, entries)
        return entries

    async def local_lease_grant(self, pool: str) -> Tuple[Optional[_Lease], bool]:
        """Ask node agents for a lease out of their delegated blocks (IO
        loop).  Returns (lease, lease_plane_active): tries agents
        most-free-first; a denial (exhausted block) or unreachable agent
        falls through to the next, then to (None, True) — the caller falls
        back to the head.  (None, False) means NO delegated blocks exist
        (single-node cluster, delegation off): the caller must behave
        exactly like the classic central path — no probe ttl, no growth
        capping — or head-only topologies lose demand signal and
        concurrency."""
        entries = await self._lease_directory()
        if not entries:
            return None, False
        from . import scheduling

        denied = False
        for ent in scheduling.rank_delegation(
            entries, pool, exclude=self._draining_nodes
        ):
            try:
                conn = await self.conn_to(ent["addr"])
                r = await conn.call("lease_grant", pool=pool, timeout=5)
            except asyncio.CancelledError:
                raise
            except Exception:
                continue  # agent gone: the head's node-death path reclaims
            blk = (ent.get("pools") or {}).get(pool)
            if r.get("granted"):
                if blk is not None:  # optimistic: steer the next grant away
                    blk["used"] = blk.get("used", 0) + 1
                # chaos labeling: pushes to this worker belong to its node's
                # link (a partitioned node's pushes must vanish, not error)
                netchaos.register_addr(r["addr"], ent.get("node_id"))
                netchaos.register_addr(
                    self._normalize_peer_addr(r["addr"]), ent.get("node_id")
                )
                return _Lease(
                    r["lease_id"], r["worker_id"], r["addr"],
                    granter=ent["addr"], node=ent.get("node_id"),
                    inc=r.get("ninc"),
                ), True
            denied = True
            if blk is not None:
                blk["used"] = blk.get("size", 0)
        if denied:
            LEASE_STATS["local_denied"] += 1
            # the cached occupancy lied (all blocks full): refresh eagerly on
            # the next growth attempt instead of waiting out the TTL
            self._lease_dir_cache = (0.0, self._lease_dir_cache[1])
        return None, True

    def _fn_blob_for_push(self, conn: Connection, fn_id: bytes) -> Optional[bytes]:
        """Function blob to inline into a push, or None.  Only while the head
        (the normal blob directory) is down, and only ONCE per (connection,
        fn): the worker caches the definition after the first delivery, and
        concurrent pushes that race the first load fall into the worker's
        fetch-retry loop, which rechecks its local cache."""
        if self.head is not None and not self.head.closed:
            return None
        sent = self._conn_fn_sent.get(conn)
        if sent is None:
            sent = set()
            self._conn_fn_sent[conn] = sent
        if fn_id in sent:
            return None
        blob = self.fn_manager.blob_for(fn_id)
        if blob is not None:
            sent.add(fn_id)
        return blob

    def return_leases(self, leases: List[_Lease]) -> None:
        """Give leases back to their granters, grouped per plane: head
        leases ride one return_lease notify; agent-granted leases go back to
        their agent as lease_release.  A granter we can no longer reach
        needs nothing — both planes sweep leases on client disconnect and
        worker death (IO loop only)."""
        if not leases:
            return
        by_granter: Dict[Optional[str], List[str]] = {}
        for l in leases:
            by_granter.setdefault(l.granter, []).append(l.lease_id)
        for granter, lids in by_granter.items():
            if granter is None:
                if self.head is not None and not self.head.closed:
                    try:
                        self.head.notify("return_lease", lease_ids=lids)
                        LEASE_STATS["head_released"] += len(lids)
                    except Exception:
                        pass
            else:
                conn = self._conns.get(self._normalize_peer_addr(granter))
                if conn is not None and not conn.closed:
                    try:
                        conn.notify("lease_release", lease_ids=lids)
                        LEASE_STATS["local_released"] += len(lids)
                    except Exception:
                        pass

    def _flush_refs(self, inc: List[bytes], dec: List[bytes]):
        self._queue_refs(inc, dec)

    # ------------------------------------------------- refcount coalescing
    def _queue_refs(self, inc, dec, as_id: Optional[str] = None, ttl: bool = False):
        """Queue an obj_refs update from any thread (debounced send)."""
        try:
            self.loop.call_soon_threadsafe(
                self._queue_refs_on_loop, inc, dec, as_id, ttl
            )
        except RuntimeError:
            pass  # loop closed (shutdown)

    def _queue_refs_on_loop(self, inc, dec, as_id=None, ttl=False):
        """IO-loop half: merge into the dirty map and arm the flush timer.

        Merge rules (per holder id):
          - inc then dec in one window are BOTH kept — the head must process
            the add before the release, or `owner_released` (which only a dec
            from the owner sets) would never fire and the object would leak.
            The flush ships every inc of the window before any dec
            (two-phase), so the pair arrives in the safe order.
          - dec then inc (drop to zero, then a revived handle) CANCEL: the
            process holds the object again, and the head never stopped
            thinking so.  Shipping both would instead release a ref we
            still hold.
        """
        key = (as_id, ttl)
        ent = self._ref_pending.get(key)
        if ent is None:
            ent = self._ref_pending[key] = {"inc": set(), "dec": set()}
        else:
            WIRE_STATS["refcount_flushes_suppressed"] += 1
        for oid in inc:
            if oid in ent["dec"]:
                # a pending release followed by a revival: cancel the dec —
                # whatever inc state the window already carries is again the
                # truth (covers dec→inc and inc→dec→inc alike)
                ent["dec"].discard(oid)
            else:
                ent["inc"].add(oid)
        ent["dec"].update(dec)
        if not self._ref_flush_scheduled:
            self._ref_flush_scheduled = True
            self.loop.call_later(self._REFS_FLUSH_DELAY_S, self._flush_ref_pending)

    def _flush_ref_pending(self):
        """Settle the coalesced obj_refs updates with each object's lifetime
        AUTHORITY (ownership plane): oids this process owns apply directly
        to its own OwnerLedger (no IO at all); borrowed oids ride a direct
        `owner_refs` notify to the owner process's ledger; only oids with no
        known live owner — plane off, owner unknown, owner unreachable/dead
        — fall back to the head's centralized obj_refs path, which is also
        the failover authority after the head adopts a dead owner's ledger.

        Two phases per destination — every inc of the window ships before
        any dec — because holder keys are flushed independently and a dec
        that reaches an authority before a DIFFERENT key's inc for the same
        object could GC it under a live pin (the late inc would strand in
        the pending-refs grace buffer).  Promoting an inc is always safe: at
        worst the object lives until its paired dec in a later message of
        the same flush, processed in socket order.  Destinations need no
        cross-ordering: one object has exactly one authority."""
        self._ref_flush_scheduled = False
        if not self._ref_pending:
            return
        pending, self._ref_pending = self._ref_pending, {}
        if not self._owner_plane:
            self._send_head_refs(list(pending.items()))
            return
        # partition each (as_id, ttl) window's oids by authority
        local: List[tuple] = []   # (as_id, ttl, inc, dec) for my own ledger
        remote: Dict[str, List[tuple]] = {}  # owner cid -> windows
        central: List[tuple] = []  # head fallback
        for (as_id, ttl), ent in pending.items():
            buckets: Dict[Optional[str], List[List[bytes]]] = {}
            for oid in ent["inc"]:
                buckets.setdefault(self._ref_dest(oid), [[], []])[0].append(oid)
            for oid in ent["dec"]:
                buckets.setdefault(self._ref_dest(oid), [[], []])[1].append(oid)
            for dest, (inc, dec) in buckets.items():
                win = (as_id, ttl, inc, dec)
                if dest == "":
                    local.append(win)
                elif dest is None:
                    central.append(win)
                else:
                    remote.setdefault(dest, []).append(win)
        led = self.owner_ledger
        if local:
            OWNER_STATS["refs_settled_local"] += len(local)
            # same two-phase discipline as the wire paths: every window's
            # inc applies before any window's dec, so a cross-key pair for
            # one object can never GC it under a live pin
            for as_id, ttl, inc, _dec in local:
                if inc:
                    led.apply(inc, [], as_id if as_id is not None else self.client_id, ttl)
            for as_id, _ttl, _inc, dec in local:
                if dec:
                    led.apply([], dec, as_id if as_id is not None else self.client_id)
        for owner, wins in remote.items():
            self._send_owner_refs(owner, wins)
        if central:
            OWNER_STATS["refs_head_fallback"] += len(central)
            self._send_head_refs([((a, t), {"inc": i, "dec": d})
                                  for a, t, i, d in central])

    # ------------------------------------------------------ ownership plane
    def _ref_dest(self, oid: bytes) -> Optional[str]:
        """Which authority settles this oid's holder updates: "" = this
        process's own ledger, a client id = that owner's ledger, None = the
        head (plane off / owner unknown / resurrection after settle)."""
        led = self.owner_ledger
        if led is not None and led.tracks(oid):
            return ""
        owner = self._borrowed_owners.get(oid)
        if owner is not None:
            return owner
        if led is not None and self.reference_counter.is_owned(ObjectID(oid)):
            return ""
        return None

    def note_borrowed_owner(self, oid_b: bytes, owner: str) -> None:
        """An ObjectRef handle for another process's object materialized
        here: remember who settles its counts (ObjectRef.__init__)."""
        if self._owner_plane and owner != self.client_id:
            self._borrowed_owners[oid_b] = owner

    def _send_head_refs(self, items) -> None:
        """The classic centralized path: obj_refs notifies to the head, all
        incs of the flush window before any dec (IO loop only)."""
        head = self.head
        if head is None or head.closed:
            return  # head down: same drop-on-floor as the pre-plane path
        for phase in ("inc", "dec"):
            for (as_id, ttl), ent in items:
                oids = list(ent[phase])
                if not oids:
                    continue
                fields: Dict[str, Any] = {phase: oids}
                if as_id is not None:
                    fields["as_id"] = as_id
                if ttl and phase == "inc":
                    fields["ttl"] = True
                try:
                    head.notify("obj_refs", **fields)
                except Exception:
                    pass

    def _send_owner_refs(self, owner: str, wins: List[tuple]) -> None:
        """Ship one flush window's updates to a borrowed object's owner over
        the direct worker<->worker connection (AddBorrowedObject /
        WaitForRefRemoved, owner-resident form).  A cached open connection
        sends synchronously; otherwise a background dial sends (or fails
        over to the head — the arbiter for unreachable/dead owners)."""
        hit = self._cached_owner_addr(owner)
        if hit is not None and hit[0] is not None:
            conn = self._conns.get(self._normalize_peer_addr(hit[0]))
            if conn is not None and not conn.closed:
                try:
                    self._notify_owner_refs(conn, wins)
                    return
                except Exception:
                    pass
        t = spawn_bg(self._send_owner_refs_async(owner, wins))
        t.add_done_callback(self._report_task_exc)

    def _notify_owner_refs(self, conn: Connection, wins: List[tuple]) -> None:
        OWNER_STATS["refs_sent_owner"] += 1
        for phase in (0, 1):  # inc windows before dec windows
            for as_id, ttl, inc, dec in wins:
                oids = inc if phase == 0 else dec
                if not oids:
                    continue
                fields: Dict[str, Any] = {
                    ("inc" if phase == 0 else "dec"): oids,
                    "as_id": as_id if as_id is not None else self.client_id,
                }
                if ttl and phase == 0:
                    fields["ttl"] = True
                conn.notify("owner_refs", **fields)

    async def _send_owner_refs_async(self, owner: str, wins: List[tuple]) -> None:
        try:
            addr = await self._owner_addr_async(owner)
            if addr is None:
                raise ConnectionError(f"owner {owner} not dialable")
            conn = await self.conn_to(addr)
            self._notify_owner_refs(conn, wins)
        except asyncio.CancelledError:
            raise
        except Exception:
            # owner unreachable or dead: the head is the failover authority
            # (it adopts the owner's ledger from the last synced digest)
            OWNER_STATS["refs_head_fallback"] += len(wins)
            self._send_head_refs([((a, t), {"inc": i, "dec": d})
                                  for a, t, i, d in wins])

    def serve_owner_refs(self, inc, dec, as_id, ttl: bool = False) -> None:
        """A borrower's inc/dec landing on this process's ledger (the
        owner-resident settle path; workerproc/_p2p server `owner_refs`)."""
        led = self.owner_ledger
        if led is None:
            return  # plane raced off (shutdown): the disconnect sweep settles
        OWNER_STATS["refs_recv"] += 1
        led.apply(list(inc or ()), list(dec or ()), as_id, bool(ttl))

    def serve_owner_transit_done(self, token, roids, cid, register=True) -> None:
        led = self.owner_ledger
        if led is not None:
            led.transit_done(token, list(roids or ()), cid, bool(register))

    def serve_owner_pin(self, oid_b: bytes, as_id: str) -> dict:
        """Atomic pin+locate served by the owner (obj_pin, owner-resident):
        the pin registers in the ledger under the same lock that reads the
        location, so a reader can never map a slice the owner's spiller is
        about to recycle."""
        led = self.owner_ledger
        loc = led.pin(oid_b, as_id) if led is not None else None
        if loc is None:
            return {"found": False}
        return {"found": True, "node": self.node_id, "owner": self.client_id, **loc}

    def _is_my_slice(self, shm_name: str) -> bool:
        """Can this process reclaim these bytes itself?  Its own arena
        slices (only the creating allocator may recycle a slice) and its
        node's dedicated segments qualify; everything else needs the head's
        reclaim routing (shm_free pubs / agent unlinks)."""
        if "@" in shm_name:
            fname = shm_name.split("@", 1)[0].rsplit("/", 1)[-1]
            return fname.startswith(f"arena_{self.client_id}_")
        return self.shm_store.is_local(shm_name)

    def _ledger_clear(self, cleared: List[tuple]) -> None:
        """An owned object's cluster-wide lifetime settled (owner released +
        last borrower gone): free what this process can locally, release
        containment edges on nested refs, and tell the head to drop the
        registry record and reclaim the remote copies.  With the head down
        the LOCAL reclaim still completes (the acceptance property: GC does
        not need the control plane); the registry release is deferred."""
        release: List[list] = []
        for oid, info in cleared:
            OWNER_STATS["owner_gc"] += 1
            freed: List[str] = []
            for name in (info.get("shm_name"), info.get("pending_free")):
                if name and self._is_my_slice(name):
                    try:
                        self.shm_store.free_local(name)
                    except Exception:
                        pass
                    self._spilled_pinned.discard(name)
                    freed.append(name)
            spill = info.get("spill_path")
            if spill and os.path.exists(spill):
                try:
                    os.unlink(spill)
                    freed.append("spill:" + spill)
                except OSError:
                    pass
            for ioid, iowner in info.get("contains") or ():
                # the container dies: its borrow-pins on nested objects die
                # with it, routed to each inner object's own authority
                if iowner and iowner != self.client_id:
                    self._borrowed_owners.setdefault(ioid, iowner)
                self._queue_refs(
                    [], [ioid], as_id=f"cnt:{self.client_id}:{oid.hex()}"
                )
            if info.get("registered"):
                release.append([oid, freed])
        if not release:
            return
        head = self.head
        if head is not None and not head.closed:
            try:
                head.notify("obj_release", rel=release)
                return
            except Exception:
                pass
        OWNER_STATS["owner_gc_head_down"] += len(release)
        self._deferred_releases.extend(release)

    def _ledger_pin_zero(self, oid: bytes) -> None:
        """Last zero-copy value pin dropped on an object this owner spilled:
        the old slice's memory comes back now (owner-side pending_free)."""
        led = self.owner_ledger
        name = led.pop_pending_free(oid) if led is not None else None
        if name and self._is_my_slice(name):
            try:
                self.shm_store.free_local(name)
            except Exception:
                pass
            self._spilled_pinned.discard(name)

    def _add_owned(self, oid: ObjectID) -> None:
        """Mint ownership: local refcount authority + a ledger entry, BEFORE
        any handle can leave the process (borrower registrations race only
        reconstruction re-registration, absorbed by the pending buffer)."""
        self.reference_counter.add_owned(oid)
        if self.owner_ledger is not None:
            self.owner_ledger.register(oid.binary())

    def _register_contains(self, container_b: bytes, nested: List[bytes]) -> None:
        """Containment edges for a container THIS process owns: each nested
        ref gains a "cnt:<my-cid>:<container>" holder at its own authority,
        and the ledger remembers the edge list so settling the container
        releases them (head-resident obj_contains when the plane is off)."""
        led = self.owner_ledger
        if not self._owner_plane:
            self._notify_threadsafe(
                "obj_contains", oid=container_b, refs=list(nested)
            )
            return
        if led is None or not led.tracks(container_b):
            # ledgerless owner (client mode): the HEAD is this container's
            # lifetime authority.  The edges still register at each inner
            # object's OWN authority (head-side holders would not protect
            # owner-resident inners), and the head remembers the (oid,
            # authority) pairs so it can release them when the container
            # settles there.  Pair authority mirrors where the inc actually
            # routes ("" = the head itself).
            pairs = []
            for ioid in nested:
                d = self._ref_dest(ioid)
                pairs.append([ioid, self.client_id if d == "" else (d or "")])
            self._queue_refs(
                list(nested), [],
                as_id=f"cnt:{self.client_id}:{container_b.hex()}",
            )
            self._notify_threadsafe(
                "obj_contains", oid=container_b, refs=list(nested),
                pairs=pairs,
            )
            return
        pairs = [
            (ioid, self._borrowed_owners.get(ioid) or self.client_id)
            for ioid in nested
        ]
        old = led.set_contains(container_b, pairs)
        edge = f"cnt:{self.client_id}:{container_b.hex()}"
        self._queue_refs(list(nested), [], as_id=edge)
        for ioid, iowner in old or ():
            if iowner and iowner != self.client_id:
                self._borrowed_owners.setdefault(ioid, iowner)
            self._queue_refs([], [ioid], as_id=edge)

    def result_contains_pairs(
        self, container_b: bytes, nested: List[bytes], owner: str
    ) -> Optional[list]:
        """Worker-side half of owner-resident containment for a task RETURN
        (the container's owner is the submitter): register the edges at each
        nested ref's authority under the SUBMITTER's edge id and hand back
        the (oid, owner) pairs to ship with the result, so the submitter's
        ledger can release them when the container settles.  Returns None on
        the centralized path (caller falls back to obj_contains)."""
        if not self._owner_plane:
            return None
        pairs = [
            [ioid, self._borrowed_owners.get(ioid) or self.client_id]
            for ioid in nested
        ]
        self._queue_refs(
            list(nested), [], as_id=f"cnt:{owner}:{container_b.hex()}"
        )
        return pairs

    def _adopt_result_contains(self, oid_b: bytes, res: dict) -> None:
        """Owner-side half: a task result carried containment pairs for a
        container this process owns.  Record them — or, if the container's
        lifetime already settled (fire-and-forget), release the edges right
        away so the nested objects don't leak a dead container's pins.  A
        LEDGERLESS owner (client mode) cannot do either itself: it forwards
        the pairs to the head — its containers' lifetime authority — which
        releases the owner-resident edges when the record settles there."""
        pairs = [
            (bytes(i), (o if isinstance(o, str) else None))
            for i, o in (res.get("contains") or ())
        ]
        if not pairs:
            return
        led = self.owner_ledger
        if led is None:
            self._notify_threadsafe(
                "obj_contains", oid=oid_b,
                refs=[i for i, _ in pairs],
                pairs=[[i, o or ""] for i, o in pairs],
            )
            return
        old = led.set_contains(oid_b, pairs)
        edge = f"cnt:{self.client_id}:{oid_b.hex()}"
        stale = pairs if old is None else old
        for ioid, iowner in stale:
            if iowner and iowner != self.client_id:
                self._borrowed_owners.setdefault(ioid, iowner)
            self._queue_refs([], [ioid], as_id=edge)

    def _owner_plane_tick(self, now: float) -> None:
        """Housekeeping leg of the ownership plane (IO loop): ledger sweeps
        (expired pending adds / lost transit acks), deferred registry
        releases, and the owner_sync digest — versioned deltas of this
        ledger so the head can adopt it if this process dies.  A reconnect
        resets to a full sync (the restarted head lost the digest)."""
        led = self.owner_ledger
        if now - self._last_ledger_sweep > 5.0:
            self._last_ledger_sweep = now
            expired = led.sweep(now)
            if expired:
                # grace-expired borrower registrations are the owner-side
                # symptom of the same ordering bug the head counts as
                # early_refs_expired — surface them the same way
                OWNER_STATS["pending_expired"] += expired
                warn_ratelimited(
                    "ledger-pending-expired",
                    f"{expired} pending borrower registration(s) expired "
                    "past the grace window (lost registration ordering?)",
                )
        head = self.head
        if head is None or head.closed:
            return
        if self._deferred_releases:
            rel, self._deferred_releases = self._deferred_releases, []
            try:
                head.notify("obj_release", rel=rel)
            except Exception:
                self._deferred_releases = rel + self._deferred_releases
        if now - self._last_owner_sync < self.config.owner_sync_period_s:
            return
        self._last_owner_sync = now
        full = self._owner_sync_full
        d = led.digest_delta(full=full)
        if d is None:
            return
        try:
            head.notify("owner_sync", **d)
        except Exception:
            return
        OWNER_STATS["syncs_sent"] += 1
        if full:
            OWNER_STATS["syncs_full"] += 1
            self._owner_sync_full = False

    def _normalize_peer_addr(self, addr: str) -> str:
        """Remote clients may receive TCP duals bound to a wildcard host
        (head_host=0.0.0.0): substitute the host we actually dialed the head
        on — the cluster host as seen from here."""
        if (
            self.client_mode
            and addr.startswith(("tcp:0.0.0.0:", "tcp:::"))
            and self.head_sock.startswith("tcp:")
        ):
            head_host = self.head_sock[4:].rpartition(":")[0]
            port = addr.rpartition(":")[2]
            return f"tcp:{head_host}:{port}"
        return addr

    # ---------------------------------------------------- p2p serving plane
    def _p2p_addr(self) -> Optional[str]:
        if self._p2p_server is not None:
            return next(
                (a for a in self._p2p_server.bound_addrs if a.startswith("unix:")),
                None,
            )
        return None

    def _p2p_addr_tcp(self) -> Optional[str]:
        if self._p2p_server is not None:
            return next(
                (a for a in self._p2p_server.bound_addrs if a.startswith("tcp:")),
                None,
            )
        return None

    async def _start_p2p_server(self):
        """Driver-mode RPC listener for the p2p planes.  Worker processes
        already serve these methods on their task server (workerproc._handle
        delegates here); the driver needs its own socket because it owns
        puts and task returns — the objects borrowers resolve most."""
        if self._p2p_server is not None:
            return  # connect_async re-entry must not stack listeners
        from .protocol import Server

        sock = os.path.join(self.session_dir, f"drv_{self.client_id}.sock")

        async def handle(state, msg, reply, reply_err):
            m = msg["m"]
            if m == "owner_locate":
                reply(**await self.owner_locate_async(msg["oid"]))
            elif m == "owner_refs":
                # borrower inc/dec settling against this driver's ledger
                self.serve_owner_refs(
                    msg.get("inc"), msg.get("dec"),
                    msg.get("as_id") or state.get("client_id", "?"),
                    bool(msg.get("ttl")),
                )
                reply()
            elif m == "owner_transit_done":
                self.serve_owner_transit_done(
                    msg["token"], msg.get("oids"), msg.get("cid", "?"),
                    msg.get("register", True),
                )
                reply()
            elif m == "owner_pin":
                reply(**self.serve_owner_pin(msg["oid"], msg["as_id"]))
            elif m == "coll_push":
                self.coll_deliver(
                    msg["group"], msg["key"], msg["src"],
                    msg["data"], msg["shape"], msg["dtype"],
                    msg.get("meta"),
                )
                reply()
            # operator liveness probe: ca-lint: ignore[rpc-dead-handler]
            elif m == "ping":
                reply(worker_id=self.client_id)
            else:
                reply_err(ValueError(f"unknown p2p method {m}"))

        self._p2p_server = Server([sock, "tcp:0.0.0.0:0"], handle)
        await self._p2p_server.start()

    def owner_locate_local(self, oid_b: bytes) -> dict:
        """Sync shim over owner_locate_async for off-loop callers (tests,
        diagnostics); the serve handlers await the async form directly."""
        return self.run_coro(self.owner_locate_async(oid_b), timeout=30)

    async def owner_locate_async(self, oid_b: bytes) -> dict:
        """Answer a borrower's location query from THIS process's authority
        over objects it owns (ownership_based_object_directory.h read path).

        shm-backed objects return their location; INLINE results (small task
        returns / puts, which never register at the head at all) are served
        by value — the owner is their only copy, and before this path
        existed a borrowed ref to a pending-then-inline result could only
        resolve if something promoted it.  Pending / device / spilled states
        report not-found: the borrower keeps waiting or falls back to the
        head (the arbiter for spill relocation and GC)."""
        e = self.memory_store.get_entry(ObjectID(oid_b))
        if e is None:
            # local read-cache evicted (owner's last handle died) while
            # borrowers still hold: the ledger remembers the primary copy
            led = self.owner_ledger
            info = led.entry_info(oid_b) if led is not None else None
            if info is not None and info.get("shm_name"):
                return {
                    "found": True,
                    "shm_name": info["shm_name"],
                    "size": info["size"],
                    "node": self.node_id,
                }
            return {"found": False}
        if e.state in ("shm", "value", "packed") and e.shm_name:
            if e.shm_name.startswith("spill:"):
                # relocated to disk: the head arbitrates spill reads
                return {"found": False}
            return {
                "found": True,
                "shm_name": e.shm_name,
                "size": e.size,
                "node": self.node_id,
            }
        if e.state in ("packed", "value"):
            # inline result served by value.  Nested ObjectRefs smuggled in
            # the payload need the same transit-pin protocol as task args
            # (_pack_with_transit_async): without a pin, the head may GC the
            # inner object between our reply and the borrower registering
            # its handle.  Packed blobs are re-packed through capture for
            # the same reason — the original pack ran before this borrower
            # existed.
            try:
                value = (
                    serialization.unpack(e.packed) if e.state == "packed"
                    else e.value
                )
                spec = await self._pack_with_transit_async(value, ttl_pin=True)
            except asyncio.CancelledError:
                raise
            except Exception:
                return {"found": False}
            return {"found": True, **spec}
        return {"found": False}

    def coll_deliver(
        self, group: str, key: str, src: int, data, shape, dtype, meta=None
    ):
        """Landing half of the p2p collective transport: a peer rank pushed
        a tensor chunk; wake any coll_wait blocked on it.  `meta` rides
        along untouched (quantized payloads carry their scales/shape there;
        the transport stays encoding-agnostic)."""
        with self._coll_cond:
            self._coll_mail[(group, key, int(src))] = (
                data, tuple(shape or ()), dtype, meta,
            )
            self._coll_cond.notify_all()

    def _coll_take(self, group: str, key: str, src: int, timeout: float):
        deadline = time.monotonic() + timeout
        k = (group, key, int(src))
        with self._coll_cond:
            while k not in self._coll_mail:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"collective recv timed out waiting for {k}"
                    )
                self._coll_cond.wait(min(remaining, 1.0))
            return self._coll_mail.pop(k)

    def coll_wait(self, group: str, key: str, src: int, timeout: float):
        """Block (rank thread) until the (group, key, src) chunk arrives."""
        import numpy as _np

        data, shape, dtype, _meta = self._coll_take(group, key, src, timeout)
        return _np.frombuffer(data, dtype=dtype).reshape(shape)

    def coll_wait_raw(self, group: str, key: str, src: int, timeout: float):
        """Raw-payload twin of coll_wait: returns (payload bytes, meta dict)
        without imposing an array interpretation — the quantized collective
        ring decodes its own wire format."""
        data, _shape, _dtype, meta = self._coll_take(group, key, src, timeout)
        return data, (meta or {})

    def coll_clear(self, group: str):
        with self._coll_cond:
            for k in [k for k in self._coll_mail if k[0] == group]:
                del self._coll_mail[k]

    def coll_push_start(
        self, addr: str, group: str, key: str, src: int, arr, timeout: float
    ):
        """Sending half: push one tensor chunk directly into a peer rank's
        mailbox over the worker TCP/unix dual — no head, no object store.
        Returns a concurrent future immediately (double-buffered ring
        pipelining: the caller overlaps this send with its own receive and
        joins later).  The payload is serialized HERE, on the caller's
        thread, so the caller may mutate `arr` the moment this returns."""
        import numpy as np

        arr = np.ascontiguousarray(arr)
        return self._coll_send_start(
            addr, group, key, src, arr.tobytes(), list(arr.shape),
            str(arr.dtype), None, timeout,
        )

    def coll_push_raw_start(
        self, addr: str, group: str, key: str, src: int,
        payload: bytes, meta: dict, timeout: float,
    ):
        """Raw-payload twin of coll_push_start (quantized ring steps)."""
        return self._coll_send_start(
            addr, group, key, src, payload, [], "raw", meta, timeout
        )

    def _coll_send_start(
        self, addr, group, key, src, data, shape, dtype, meta, timeout
    ):
        async def _send():
            conn = await self.conn_to(addr)
            fields = dict(
                group=group, key=key, src=int(src), data=data,
                shape=shape, dtype=dtype, timeout=timeout,
            )
            if meta is not None:
                fields["meta"] = meta
            await conn.call("coll_push", **fields)

        return asyncio.run_coroutine_threadsafe(_send(), self.loop)

    def coll_push_to(
        self, addr: str, group: str, key: str, src: int, arr, timeout: float
    ):
        """Blocking send (broadcast/send paths, where nothing overlaps)."""
        self.coll_push_start(addr, group, key, src, arr, timeout).result(
            timeout
        )

    async def _owner_addr_async(self, owner: Optional[str]) -> Optional[str]:
        """Resolve (and cache) the serving address of an object owner.
        Positive results cache for the session (one head lookup per owner
        process); None = owner can't be dialed right now (dead, remote
        client, unknown, or the head was briefly unreachable) — callers fall
        back to the head.  Negative results only cache for a short TTL so a
        transient head hiccup can't permanently disable the owner/p2p path
        for a healthy peer."""
        if not owner or owner == self.client_id:
            return None
        hit = self._cached_owner_addr(owner)
        if hit is not None:
            return hit[0]
        addr = None
        try:
            reply = await self.head.call("client_addr", client_id=owner)
            if reply.get("found"):
                if reply.get("node") == self.node_id:
                    addr = reply.get("addr") or reply.get("addr_tcp") or None
                else:  # cross-node: unix sockets don't travel
                    addr = reply.get("addr_tcp") or reply.get("addr") or None
        except asyncio.CancelledError:
            raise
        except Exception:
            addr = None
        self._owner_addr_cache[owner] = (
            (addr, None) if addr is not None
            else (None, time.monotonic() + self._OWNER_ADDR_NEG_TTL)
        )
        return addr

    def _cached_owner_addr(self, owner: str):
        """Live cache entry as a (addr,) 1-tuple, or None on miss/expiry —
        the single place the (addr, expiry) format is interpreted."""
        cached = self._owner_addr_cache.get(owner)
        if cached is not None:
            addr, expiry = cached
            if expiry is None or time.monotonic() < expiry:
                return (addr,)
        return None

    def _owner_addr(self, owner: Optional[str]) -> Optional[str]:
        if not owner or owner == self.client_id:
            return None
        hit = self._cached_owner_addr(owner)
        if hit is not None:
            return hit[0]
        return self.run_coro(self._owner_addr_async(owner), timeout=30)

    async def conn_to(self, addr: str) -> Connection:
        """One connection per peer.  Concurrent first-callers share a single
        connect (a stampede would create several sockets and destroy
        per-caller actor-call ordering across them)."""
        addr = self._normalize_peer_addr(addr)
        conn = self._conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        pending = self._connecting.get(addr)
        if pending is not None:
            return await pending
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._connecting[addr] = fut
        try:
            from ..util.aio import dial  # lazy: util/__init__ reaches into core

            conn = await dial(addr, purpose="peer")
            conn.set_push_handler(self._on_peer_push)
            self._conns[addr] = conn
            fut.set_result(conn)
            return conn
        except BaseException as e:
            fut.set_exception(e)
            # mark retrieved for the no-other-waiter case (the creator
            # re-raises below), else GC logs "exception was never retrieved"
            # on every refused dial — e.g. racing a drained worker's address
            fut.exception()
            raise
        finally:
            del self._connecting[addr]

    # -------------------------------------------------------------- streaming
    async def _on_peer_push(self, msg):
        """Unsolicited frames from direct worker connections: streamed
        generator items (stream_item) land here in production order."""
        if msg.get("m") != "stream_item":
            return
        st = self._streams.get(msg["task_id"])
        if st is None:
            return  # stream abandoned
        idx = msg["idx"]
        oid = ObjectID.for_return(st.task_id, idx)
        self._add_owned(oid)
        self._store_results([oid], [msg["res"]], st.addr or "")
        st.on_item(idx)

    def stream_ack(self, st) -> None:
        """Consumer took one ref off the generator: advance the producer's
        backpressure window (thread-safe)."""
        def _send():
            conn = self._conns.get(st.addr)
            if conn is not None and not conn.closed:
                try:
                    conn.notify(
                        "stream_ack",
                        task_id=st.task_id.binary(),
                        consumed=st.next_read,
                    )
                except Exception:
                    pass

        try:
            self.loop.call_soon_threadsafe(_send)
        except RuntimeError:
            pass

    def cancel_stream(self, st) -> None:
        """Abandon one in-flight streaming task (ObjectRefGenerator.cancel):
        deliver a cancel to the executing worker so the producer generator
        stops, and drop the local stream state so late items are ignored
        (thread-safe; the _on_peer_push miss path treats unknown task ids as
        abandoned streams already)."""
        tid = st.task_id.binary()

        def _do():
            self._streams.pop(tid, None)
            self._cancelled_tasks.add(tid)
            addr = st.addr or self._inflight_tasks.get(tid)
            if addr is not None:
                conn = self._conns.get(self._normalize_peer_addr(addr)) or self._conns.get(addr)
                if conn is not None and not conn.closed:
                    try:
                        conn.notify("cancel", task_id=tid, force=False)
                    except Exception:
                        pass  # producer already gone: nothing left to stop

        try:
            self.loop.call_soon_threadsafe(_do)
        except RuntimeError:
            pass  # loop shutting down: the producer dies with the process

    def submit_streaming_task(self, fn, args, kwargs, opts: Dict[str, Any]):
        """Submit a generator task; returns an ObjectRefGenerator
        (_raylet.pyx ObjectRefGenerator analogue)."""
        from .streaming import ObjectRefGenerator, StreamState

        task_id = TaskID.for_normal_task(self.job_id)
        st = StreamState(task_id)
        self._streams[task_id.binary()] = st
        fn_id, blob = self.fn_manager.export(fn)
        if TRACE_HOOK is not None:
            _tr = TRACE_HOOK.begin_task_trace(
                task_id.hex(), getattr(fn, "__name__", "stream"), "task",
                self.client_id, self.node_id,
            )
            if _tr is not None:
                opts = dict(opts, _trace=_tr)
        self._pump_submit(
            lambda: self._submit_stream(task_id, st, fn_id, blob, args, kwargs, opts, None)
        )
        return ObjectRefGenerator(self, st, self.client_id)

    def submit_streaming_actor_task(self, actor_id: ActorID, method: str, args, kwargs, opts):
        from .streaming import ObjectRefGenerator, StreamState

        task_id = TaskID.for_actor_task(actor_id)
        st = StreamState(task_id)
        self._streams[task_id.binary()] = st
        opts = dict(opts, method=method)
        if TRACE_HOOK is not None:
            _tr = TRACE_HOOK.begin_task_trace(
                task_id.hex(), method, "actor_task", self.client_id, self.node_id
            )
            if _tr is not None:
                opts["_trace"] = _tr
        self._pump_submit(
            lambda: self._submit_stream(
                task_id, st, None, None, args, kwargs, opts, actor_id.hex()
            )
        )
        return ObjectRefGenerator(self, st, self.client_id)

    async def _submit_stream(self, task_id, st, fn_id, blob, args, kwargs, opts, actor_hex):
        """Slow-path push of a streaming task (no retries: replaying a
        partially consumed stream would duplicate side effects)."""
        lease = None
        pool = None
        try:
            if blob is not None:
                await self.head.call("register_function", fn_id=fn_id, blob=blob)
                self.fn_manager.mark_exported(fn_id)
            specs, kwspecs = await self._build_args(args, kwargs)
            if actor_hex is None:
                pool = self._lease_pool(opts)
                lease = await pool.acquire()
                addr = lease.addr
            else:
                addr = await self._actor_addr(actor_hex)
            st.addr = addr
            conn = await self.conn_to(addr)
            # cancellable like any pushed task: ca.cancel() needs the
            # executing worker's address to deliver the interrupt
            self._inflight_tasks[task_id.binary()] = self._normalize_peer_addr(addr)
            fields = dict(
                task_id=task_id.binary(),
                owner=self.client_id,
                args=specs,
                kwargs=kwspecs,
                num_returns="streaming",
                timeout=None,
            )
            trace = opts.get("_trace")
            if trace is not None:
                fields[TRACE_FIELD] = trace
                if TRACE_HOOK is not None:
                    TRACE_HOOK.record_task_event(
                        task_id.hex(), None,
                        "task" if actor_hex is None else "actor_task",
                        "SCHEDULED", trace=trace, worker_id=self.client_id,
                        node_id=self.node_id,
                    )
            if actor_hex is None:
                reply = await conn.call(
                    "push_task", fn_id=fn_id,
                    runtime_env=opts.get("runtime_env"), **fields,
                )
            else:
                reply = await conn.call(
                    "actor_call", actor_id=actor_hex, method=opts["method"], **fields
                )
            err = None
            if reply.get("stream_error") is not None:
                import pickle

                err = pickle.loads(reply["stream_error"])
            st.on_end(err)
        except asyncio.CancelledError:
            # unblock consumers before propagating the cancellation — a
            # swallowed cancel here would hang shutdown, a silent one would
            # hang the stream's readers
            st.on_end(TaskError("stream pump cancelled"))
            raise
        except BaseException as e:
            st.on_end(e if isinstance(e, CAError) else TaskError(repr(e)))
        finally:
            self._inflight_tasks.pop(task_id.binary(), None)
            if lease is not None:
                pool.release(lease, dead=False)
            self._streams.pop(task_id.binary(), None)

    # ------------------------------------------------------------------ put
    def new_owned_ref(self) -> ObjectRef:
        """Allocate a fresh owned ObjectRef with no value yet; the caller
        fulfills it later via memory_store.put_value/put_error (used by put()
        and by futures like PlacementGroup.ready())."""
        task_id = self.current_task_id or TaskID.for_normal_task(self.job_id)
        oid = ObjectID.for_put(task_id, self._put_counter.next())
        self._add_owned(oid)
        return ObjectRef(oid, owner=self.client_id, worker=self)

    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() of an ObjectRef is not allowed")
        ref = self.new_owned_ref()
        self._put_value(ref.id, value)
        return ref

    def _put_value(self, oid: ObjectID, value: Any):
        if _is_device_value(value):
            from ..channel.device_transport import settle

            # the producer's kernels must be done before a fetch copies the
            # value on another thread (fetch_object packs on an executor)
            settle(value)
            self.device_objects[oid.binary()] = value
            self.memory_store.put_value(oid, value)
            return
        with serialization.ref_capture() as nested:
            data, buffers = serialization.serialize(value)
        raws = [b.raw() for b in buffers]
        total = len(data) + sum(len(r) for r in raws)
        if total < self.config.inline_object_max_bytes:
            self.memory_store.put_value(oid, value, size=total)
        else:
            if self.client_mode:
                # remote client: this host's shm is invisible to the cluster;
                # stream the packed bytes to the head's store instead
                shm_name, size = self._client_upload(oid, data, raws)
            else:
                shm_name, size = self.shm_store.create_and_pack(oid, data, raws)
            self.memory_store.put_shm(oid, shm_name, size)
            if nested:
                self._promote_nested(nested)
            if not self.client_mode:
                self._notify_threadsafe(
                    "obj_created", oid=oid.binary(), shm_name=shm_name, size=size
                )
                if self.owner_ledger is not None:
                    # the ledger serves owner_pin/owner_locate from this even
                    # after the local read-cache entry is evicted
                    self.owner_ledger.set_location(oid.binary(), shm_name, size)
            if nested:
                # borrowed refs inside the stored value live as long as the
                # containing object (containment edges at each inner object's
                # authority; head-resident when the plane is off)
                self._register_contains(oid.binary(), nested)

    def _client_upload(self, oid: ObjectID, data: bytes, raws: List[Any]) -> Tuple[str, int]:
        """Client-mode put: chunk the packed bytes to the head, which hosts
        them in its n0 namespace and registers this client as owner."""
        from .serialization import pack_chunks_from_parts

        total, chunks = pack_chunks_from_parts(data, raws)
        return self._client_upload_chunks(oid, total, chunks)

    def _client_upload_blob(self, oid: ObjectID, blob: bytes) -> Tuple[str, int]:
        """Upload an already pack()-framed blob verbatim (client mode)."""
        return self._client_upload_chunks(oid, len(blob), [blob])

    def _client_upload_chunks(self, oid: ObjectID, total: int, chunks) -> Tuple[str, int]:
        return self.run_coro(self._client_upload_chunks_async(oid, total, chunks))

    def _upload_packets(self, chunks, limit: int):
        """Yield (off, bytes) packets straight off each chunk's memory: no
        concat buffer, no O(N^2) drain — one bytes() copy per packet
        (msgpack needs it) is the only extra traffic."""
        off = 0
        for c in chunks:
            mv = memoryview(c)
            if mv.ndim != 1 or mv.itemsize != 1:
                mv = mv.cast("B")
            pos = 0
            while pos < len(mv):
                n = min(limit, len(mv) - pos)
                yield off, bytes(mv[pos : pos + n])
                off += n
                pos += n

    async def _client_upload_chunks_async(
        self, oid: ObjectID, total: int, chunks
    ) -> Tuple[str, int]:
        """Client-mode put upload with the transfer window applied: up to
        config.transfer_window client_put_chunk RPCs stay in flight (each
        packet carries its offset, so completion order is irrelevant —
        the head writes them into the mmap'd segment out of order)."""
        oid_b = oid.binary()
        await self.head.call("client_put_begin", oid=oid_b, size=total)
        limit = self.config.transfer_chunk_bytes
        window = max(1, int(getattr(self.config, "transfer_window", 4)))
        inflight: set = set()
        try:
            for off, data in self._upload_packets(chunks, limit):
                while len(inflight) >= window:
                    done, inflight = await asyncio.wait(
                        inflight, return_when=asyncio.FIRST_COMPLETED
                    )
                    err = None
                    for d in done:
                        # consume EVERY done task's exception (several sends
                        # can fail in one wait — leaving any unretrieved
                        # logs 'Task exception was never retrieved'), then
                        # surface the first
                        e = None if d.cancelled() else d.exception()
                        err = err or e
                    if err is not None:
                        raise err
                inflight.add(
                    asyncio.ensure_future(
                        self.head.call(
                            "client_put_chunk", oid=oid_b, off=off, data=data
                        )
                    )
                )
                TRANSFER_STATS["bytes_uploaded"] += len(data)
            if inflight:
                await asyncio.gather(*inflight)
                inflight = set()
        except BaseException:
            for f in inflight:
                if not f.done():
                    f.cancel()
                elif not f.cancelled():
                    f.exception()  # consumed: no never-retrieved warnings
            raise
        r = await self.head.call("client_put_seal", oid=oid_b)
        return r["name"], total

    async def _promote_nested_async(self, nested: List[bytes], depth: int = 0):
        """Loop-thread-safe promotion for client mode: uploads await the
        head directly instead of blocking head_call (which cannot run on
        the IO loop).  Non-client promotion is local and needs no await."""
        if not self.client_mode:
            self._promote_nested(nested, depth)
            return
        if depth > 5:
            return
        for oid_b in nested:
            oid = ObjectID(oid_b)
            e = self.memory_store.get_entry(oid)
            if e is None or e.shm_name is not None or e.state not in ("value", "packed"):
                continue
            try:
                if e.state == "packed":
                    sub: List[bytes] = []
                    name, size = await self._client_upload_chunks_async(
                        oid, len(e.packed), [e.packed]
                    )
                else:
                    with serialization.ref_capture() as sub:
                        data, buffers = serialization.serialize(e.value)
                    from .serialization import pack_chunks_from_parts

                    total, chunks = pack_chunks_from_parts(
                        data, [b.raw() for b in buffers]
                    )
                    name, size = await self._client_upload_chunks_async(
                        oid, total, chunks
                    )
            except asyncio.CancelledError:
                raise
            except Exception:
                continue
            e.shm_name = name
            e.size = size
            if sub:
                await self._promote_nested_async(sub, depth + 1)
                self._notify_threadsafe("obj_contains", oid=oid_b, refs=list(sub))

    # ------------------------------------------------------------------ get
    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
        oids = [r.id for r in ref_list]
        for r in ref_list:
            self._seed_borrowed(r.id, owner=r.owner)
        notified = False
        if self.mode == "worker" and not all(self.memory_store.contains(o) for o in oids):
            self._notify_blocked(True)
            notified = True
        try:
            ready, not_ready = self.memory_store.wait_ready(oids, len(oids), timeout)
            if not_ready:
                raise GetTimeoutError(f"get() timed out waiting for {len(not_ready)} objects")
            values = [self._resolve_entry(r) for r in ref_list]
        finally:
            if notified:
                self._notify_blocked(False)
        return values[0] if single else values

    def _notify_blocked(self, blocked: bool):
        def _send():
            if self.head and not self.head.closed:
                try:
                    self.head.notify(
                        "worker_blocked" if blocked else "worker_unblocked",
                        client_id=self.client_id,
                    )
                except Exception:
                    pass

        try:
            self.loop.call_soon_threadsafe(_send)
        except RuntimeError:
            pass

    def _seed_borrowed(self, oid: ObjectID, owner: Optional[str] = None):
        """A borrowed handle (deserialized from another process) has no local
        entry: seed one from the object directory so get()/wait() can resolve
        it.  Objects not yet created (ref to an unfinished task's return,
        forwarded ahead of completion) are polled until they appear.

        Ownership-based read path (future_resolver.h /
        ownership_based_object_directory.h): the poll goes to the OWNER
        process over a direct connection — its answer is authoritative for
        objects it created — so N borrowers polling M pending objects land
        on the owners, not on the head's single loop.  The head is consulted
        as a periodic fallback (owner dead, object spilled/relocated, owner
        not dialable)."""
        if self.memory_store.get_entry(oid) is not None:
            return
        self.memory_store.mark_pending(oid)
        oid_b = oid.binary()

        async def _poll():
            # no deadline: the object may belong to a task still running (ref
            # forwarded ahead of completion) — the caller's get() timeout
            # governs.  The poll ends when the entry fills, or when the local
            # handle is dropped (eviction deletes the entry).
            interval = 0.02
            owner_addr = await self._owner_addr_async(owner)
            owner_conn = None
            attempt = 0
            dead_strikes = 0
            first_strike_t = 0.0
            _now_mono = time.monotonic
            while True:
                e = self.memory_store.get_entry(oid)
                if e is None or e.state != "pending":
                    return  # filled or dropped meanwhile
                reply = {}
                asked_head = False
                if owner_addr is not None:
                    dialing = owner_conn is None or owner_conn.closed
                    try:
                        if dialing:
                            # bounded dial: an unreachable host must fail fast
                            # into the head fallback, not sit in the kernel
                            # SYN timeout with the every-8th head check stuck
                            # behind it.  shield: conn_to's in-flight future
                            # is shared per-addr — a bare wait_for would
                            # cancel-poison every other coroutine awaiting
                            # the same dial
                            owner_conn = await asyncio.wait_for(
                                asyncio.shield(self.conn_to(owner_addr)),
                                timeout=5,
                            )
                        reply = await owner_conn.call(
                            "owner_locate", oid=oid_b, timeout=10
                        )
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        owner_conn = None
                        if dialing:
                            # undialable: expire the session-long positive
                            # cache so resolutions re-ask the head instead of
                            # re-dialing a dead address
                            owner_addr = None
                            self._owner_addr_cache[owner] = (
                                None,
                                time.monotonic() + self._OWNER_ADDR_NEG_TTL,
                            )
                        # a mere call timeout (owner busy running the task)
                        # keeps the address: inline-only objects exist ONLY
                        # at the owner, so giving up on it for the rest of
                        # the poll could make them unresolvable
                elif attempt % 8 == 7:
                    # the owner path may have recovered (restarted head,
                    # momentary blip at first resolution): re-ask under the
                    # neg-TTL cache, which bounds head traffic
                    owner_addr = await self._owner_addr_async(owner)
                # every 8th attempt (and always without an owner), check the
                # head too — it alone knows spill relocations and survives
                # owner death
                if not reply.get("found") and (
                    owner_addr is None or attempt % 8 == 7
                ):
                    asked_head = True
                    try:
                        reply = await self.head.call("obj_locate", oid=oid_b)
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        reply = {}
                    if (
                        not reply.get("found")
                        and owner
                        and owner_addr is None
                        and attempt % 8 == 7
                    ):
                        # OwnerDiedError role: the head has no copy AND the
                        # owner's client record is tombstoned — the object's
                        # only authority is gone, so fail fast instead of
                        # polling to the caller's timeout.  Probed at the
                        # same every-8th cadence as owner re-resolution (no
                        # per-attempt head RPC), and requiring TWO strikes
                        # >= 3s apart: a restarting head briefly marks live
                        # workers dead before re-adoption, and a transient
                        # disconnect of a live client-mode driver tombstones
                        # it until its housekeeping reconnect — neither
                        # window may condemn the object.
                        try:
                            cr = await self.head.call(
                                "client_addr", client_id=owner
                            )
                        except asyncio.CancelledError:
                            raise
                        except Exception:
                            cr = {}
                        if cr.get("dead"):
                            if dead_strikes == 0:
                                first_strike_t = _now_mono()
                            dead_strikes += 1
                        else:
                            dead_strikes = 0
                        if dead_strikes >= 2 and _now_mono() - first_strike_t >= 3.0:
                            e2 = self.memory_store.get_entry(oid)
                            if e2 is not None and e2.state == "pending":
                                self.memory_store.put_error(
                                    oid,
                                    ObjectLostError(
                                        f"object {oid} is unrecoverable: its "
                                        f"owner ({owner}) died and no other "
                                        "copy or lineage is known to the head"
                                    ),
                                )
                            return
                if reply.get("found"):
                    if reply.get("v") is not None:
                        # inline payload served straight from the owner; seed
                        # ack routing first — an unpack failure must still
                        # release the pin at the ledger that holds it
                        self._note_transit_owners(reply)
                        try:
                            value = serialization.unpack(reply["v"])
                        except Exception:
                            if reply.get("t"):
                                # we can't consume it: release the owner's
                                # transit pin without claiming holdership, or
                                # every retry tick leaks another pin
                                self.transit_done(
                                    reply["t"], reply.get("roids") or [],
                                    register=False,
                                )
                            reply = {}  # corrupt/unreadable: keep polling
                        else:
                            self.memory_store.put_value(oid, value)
                            if reply.get("t"):
                                # our handles for smuggled nested refs are
                                # registered by unpack: release the owner's
                                # transit pin (borrowing protocol)
                                self.transit_done(
                                    reply["t"], reply.get("roids") or []
                                )
                            return
                    else:
                        self.memory_store.put_shm(
                            oid, reply["shm_name"], reply["size"]
                        )
                        return
                attempt += 1
                await asyncio.sleep(interval)
                # owner polls back off to a low cap (direct and distributed,
                # but the owner's IO loop is also running the producing task);
                # head-only polls back off further to protect the shared loop
                cap = 1.0 if (owner_addr is None or asked_head) else 0.2
                interval = min(interval * 2, cap)

        try:
            self.loop.call_soon_threadsafe(lambda: spawn_bg(_poll()))
        except RuntimeError:
            pass

    def _evict_on_zero(self, oid: ObjectID):
        e = self.memory_store.get_entry(oid)
        if e is None:
            return
        # Always safe to drop the local entry at local-zero:
        #  - shm-backed / borrowed: the head (cluster refcount) owns lifetime;
        #    this is just a read-cache eviction.
        #  - owned, never promoted to shm: inline-only objects are invisible
        #    to every other process (escaping refs get promoted by
        #    _promote_nested), so nothing can ever resolve this oid again —
        #    retaining it leaked one entry per completed task.
        self.memory_store.delete(oid)
        if self.reference_counter.is_owned(oid):
            self.reference_counter.remove_owned(oid)
            self.device_objects.pop(oid.binary(), None)
            # lineage is only useful while some ref could still ask for
            # reconstruction: when every return object of the producing task
            # has dropped to zero local refs, the task spec can go too
            # (otherwise the table pins 8k specs of long-dead tasks)
            if not oid.is_put():
                rec = self._lineage.get(oid.task_id().binary())
                if rec is not None:
                    dead = rec.setdefault("dead", set())
                    dead.add(oid)
                    if len(dead) >= len(rec["oids"]):
                        self._lineage.pop(oid.task_id().binary(), None)

    def lineage_revive(self, oid: ObjectID):
        """A new local handle appeared for `oid` (count 0 -> 1): un-mark it
        dead so its producing task's spec stays reconstruction-eligible."""
        if oid.is_put():
            return
        rec = self._lineage.get(oid.task_id().binary())
        if rec is not None:
            d = rec.get("dead")
            if d is not None:
                d.discard(oid)

    def _make_value_pin(self, oid: ObjectID):
        """Register a value-holder for an arena-backed object and return the
        callback that releases it (runs from GC in any thread).  Pin and
        unpin ride the debounced obj_refs coalescer: a flood of zero-copy
        reads costs a handful of logical messages, not one per object.  The
        unpin captures the owner at pin time — a view can outlive both the
        handle and the borrowed-owner map entry, and its release must still
        reach the ledger that holds the pin."""
        pin_id = f"{self.client_id}#v"
        oid_b = oid.binary()
        owner = self._borrowed_owners.get(oid_b)
        self._queue_refs([oid_b], [], as_id=pin_id)

        def _unpin():
            if owner is not None:
                self._borrowed_owners.setdefault(oid_b, owner)
            self._queue_refs([], [oid_b], as_id=pin_id)

        return _unpin

    def _resolve_entry(self, ref: ObjectRef) -> Any:
        """Resolve an ObjectRef to its value; a lost object (node death,
        producer crash) is transparently recomputed from lineage by
        re-executing its creating task (ObjectRecoveryManager analogue),
        recursively for lost dependencies."""
        try:
            return self._resolve_entry_once(ref)
        except (ObjectLostError, FileNotFoundError) as err:
            if not self._reconstruct_object(ref.id):
                if isinstance(err, ObjectLostError):
                    raise
                raise ObjectLostError(f"object {ref.id} lost: {err}") from err
            return self._resolve_entry_once(ref)

    def _resolve_entry_once(self, ref: ObjectRef) -> Any:
        e = self.memory_store.get_entry(ref.id)
        if e is None:
            raise ObjectLostError(f"object {ref.id} unknown")
        if e.state == "value":
            return e.value
        if e.state == "error":
            raise e.error
        if e.state == "packed":
            value = serialization.unpack(e.packed)
            self.memory_store.put_value(ref.id, value, size=e.size)
            return value
        if e.state == "shm":
            return self._read_shm_entry(ref, e)
        if e.state == "device":
            # device value owned by another process: explicit materialization
            return self._fetch_remote(ref, e)
        raise ObjectLostError(f"object {ref.id} in unexpected state {e.state}")

    def _fetch_remote(self, ref: ObjectRef, e: _Entry) -> Any:
        """Fetch a device value from its owner: its tensors land on this
        process's device (channel/device_transport), and the landed value
        is cached here, so a second get returns the same object."""
        owner_addr = e.shm_name  # device entries store owner addr here
        reply = self.run_coro(self._fetch_remote_async(owner_addr, ref.id.binary()))
        from ..channel.device_transport import maybe_unpack

        value = maybe_unpack(serialization.unpack(reply["packed"]))
        self.memory_store.put_value(ref.id, value)
        return value

    async def _fetch_remote_async(self, addr: str, oid: bytes):
        conn = await self.conn_to(addr)
        return await conn.call("fetch_object", oid=oid, timeout=self.config.push_timeout_s)

    def _on_io_thread(self) -> bool:
        try:
            asyncio.get_running_loop()
            return True
        except RuntimeError:
            return False

    def _pin_unref_cb(self, oid_b: bytes):
        pin_id = f"{self.client_id}#v"
        # capture the pin's authority: the unpin may fire from GC after the
        # borrowed-owner map entry was pruned (see _make_value_pin)
        owner = self._borrowed_owners.get(oid_b)

        def _unpin():
            if owner is not None:
                self._borrowed_owners.setdefault(oid_b, owner)
            self._queue_refs([], [oid_b], as_id=pin_id)

        return _unpin

    def _owner_pin_blocking(self, oid_b: bytes) -> Optional[dict]:
        """Confirmed zero-copy pin at the object's OWNER (the head-free read
        path of the ownership plane): our own ledger when we own it, an
        owner_pin RPC otherwise.  None = no authoritative answer (owner
        unknown/unreachable, entry gone) — the caller falls back to the
        head, which arbitrates for adopted/centralized objects."""
        if not self._owner_plane:
            return None
        pin_id = f"{self.client_id}#v"
        led = self.owner_ledger
        if led is not None and led.tracks(oid_b):
            # led.pin counts pins_served itself (shared with the RPC path)
            loc = led.pin(oid_b, pin_id)
            if loc is None:
                return None
            return {"found": True, "node": self.node_id, **loc}
        owner = self._borrowed_owners.get(oid_b)
        if not owner:
            return None
        addr = self._owner_addr(owner)
        if not addr:
            return None

        async def _pin():
            conn = await self.conn_to(addr)
            return await conn.call("owner_pin", oid=oid_b, as_id=pin_id, timeout=10)

        try:
            r = self.run_coro(_pin(), timeout=15)
        except Exception:
            return None
        return r if r.get("found") else None

    def _read_shm_entry(self, ref: ObjectRef, e: _Entry) -> Any:
        """Materialize a shm-backed entry: confirmed pin + authoritative
        location from the head (atomic, so spilling can never recycle a slice
        under the mapping), node-to-node pull when remote, disk read when
        spilled, and relocation retry on stale slices."""
        oid_b = ref.id.binary()
        on_loop = self._on_io_thread()
        last_err: Optional[BaseException] = None
        for _ in range(3):
            name = e.shm_name
            pin_cb = None
            loc = None
            if on_loop:
                # rare loop-thread resolution (serving fetch_object): the
                # notify-based pin accepts a tiny pin-vs-spill race
                if "@" in name:
                    pin_cb = self._make_value_pin(ref.id)
            else:
                loc = self._owner_pin_blocking(oid_b)
                if loc is None:
                    loc = self.head_call(
                        "obj_pin", oid=oid_b, as_id=f"{self.client_id}#v"
                    )
                if not loc.get("found"):
                    # obj_created may still be in flight on the producer's
                    # socket while our entry (from the task reply) is already
                    # readable locally: read it directly — spilling cannot
                    # touch an unregistered object.  The notify-style pin
                    # lands in the head's early-refs buffer.
                    if name and self.shm_store.is_local(name):
                        pin_cb = self._make_value_pin(ref.id) if "@" in name else None
                        value = serialization.unpack(
                            self.shm_store.open(name), pin_cb=pin_cb
                        )
                        e.value = value
                        e.state = "value"
                        return value
                    raise ObjectLostError(f"object {ref.id} not in the directory")
                pin_cb = self._pin_unref_cb(oid_b)
                if loc.get("spill_path"):
                    name = "spill:" + loc["spill_path"]
                elif loc.get("node") == self.node_id and loc.get("shm_name"):
                    name = loc["shm_name"]
            try:
                if not self.shm_store.is_local(name):
                    name, _ = self.run_coro(self._ensure_local_shm(oid_b, name, e.size))
                value = serialization.unpack(self.shm_store.open(name), pin_cb=pin_cb)
                if not name.startswith("spill:"):
                    e.shm_name = name
                e.value = value
                e.state = "value"
                return value
            except (StaleObjectError, FileNotFoundError) as err:
                last_err = err
                if pin_cb is not None:
                    pin_cb()  # release this attempt's pin before retrying
                continue  # re-pin for a fresh location
        raise ObjectLostError(f"object {ref.id} unreadable after relocation: {last_err}")

    # ----------------------------------------------- node-to-node transfer
    async def _ensure_local_shm(self, oid_b: bytes, shm_name: Optional[str] = None, size: int = 0):
        """Make a shm object local to this node, pulling it in chunks from
        the node(s) holding live copies if necessary (the client side of
        the reference's ObjectManager pull protocol).  Returns (local
        shm_name, size).  Concurrent pulls of the same object share one
        transfer; a CANCELLED leader must not poison the surviving waiters
        — they inherit only the leader's real failures, and retry (becoming
        the new leader) when the shared future died of cancellation."""
        while True:
            if shm_name is not None and self.shm_store.is_local(shm_name):
                return shm_name, size
            fut = self._pulls.get(oid_b)
            if fut is None:
                break
            try:
                # shield: a waiter's own cancellation must not cancel the
                # SHARED future out from under every other waiter
                return await asyncio.shield(fut)
            except asyncio.CancelledError:
                if fut.cancelled() or (
                    fut.done()
                    and isinstance(fut.exception(), asyncio.CancelledError)
                ):
                    # the LEADER was cancelled (its getter timed out or its
                    # task died) — the transfer never completed and never
                    # really failed.  Loop: take over as the new leader.
                    continue
                raise  # WE were cancelled: propagate our own cancellation
        fut = asyncio.get_running_loop().create_future()
        self._pulls[oid_b] = fut
        try:
            result = await self._pull_object(oid_b)
            fut.set_result(result)
            return result
        except BaseException as e:
            fut.set_exception(e)
            # consume the exception if nobody else awaited the future
            if not fut.cancelled():
                fut.exception()
            raise
        finally:
            del self._pulls[oid_b]

    def _pull_sources(self, reply: dict) -> List[dict]:
        """Dialable holders for a located object: the directory's `sources`
        list (primary first, then secondary copies), de-duplicated, with a
        legacy single-source fallback for mixed-version heads.  With
        transfer_multi_source off only the primary is used."""
        srcs: List[dict] = []
        seen = set()
        for s in reply.get("sources") or ():
            addr, name = s.get("pull_addr"), s.get("shm_name")
            if addr and name and (addr, name) not in seen:
                seen.add((addr, name))
                srcs.append({"addr": addr, "shm_name": name})
        if not srcs:
            name = reply.get("shm_name")
            if reply.get("spill_path"):
                name = "spill:" + reply["spill_path"]
            if name and reply.get("pull_addr"):
                srcs.append({"addr": reply["pull_addr"], "shm_name": name})
        if not getattr(self.config, "transfer_multi_source", True):
            srcs = srcs[:1]
        return srcs

    async def _pull_object(self, oid_b: bytes):
        reply = await self.head.call("obj_locate", oid=oid_b)
        if not reply.get("found"):
            raise ObjectLostError(
                f"object {oid_b.hex()} not found in the cluster (node lost?)"
            )
        total = reply["size"]
        name = reply.get("shm_name")
        if reply.get("spill_path"):
            name = "spill:" + reply["spill_path"]
        if name is not None and self.shm_store.is_local(name):
            return name, total  # a copy (or local spill file) on this node
        if name is None and not reply.get("sources"):
            raise ObjectLostError(f"object {oid_b.hex()} has no readable location")
        oid = ObjectID(oid_b)
        local_name, mv = self.shm_store.create_for_import(oid, total)
        try:
            # cross-plane tracing: the pull is a span under whatever task
            # is waiting on it (no-op without an ambient trace)
            from ..util import tracing as _tracing

            with _tracing.span(f"transfer:pull:{oid_b.hex()[:8]}"):
                await self._pull_into(oid_b, mv, total, reply)
        except BaseException:
            mv.release()
            self.shm_store.abort_import(local_name)  # aborted pull: reclaim
            raise
        mv.release()
        self.shm_store.seal_done(local_name)
        self._notify_obj_copy(oid_b, local_name)
        return local_name, total

    async def _pull_into(self, oid_b: bytes, mv, total: int, reply: dict):
        """Windowed, multi-source chunk transfer into an import arena slice.

        Up to config.transfer_window pull_chunk RPCs stay in flight PER
        SOURCE (the reference ObjectManager's windowed pull discipline)
        instead of one serial request-response round-trip at a time, and
        completed chunks land out of order (each carries its offset).  When
        the directory reports several live copies, every holder's lanes
        drain one shared chunk queue, so the byte range splits across
        sources by throughput.  A failing source re-queues its in-flight
        chunk and drops out (failover, not fatal); when every source died
        with chunks left, the object is re-located and the pull resumes —
        only the missing chunks are re-fetched."""
        chunk = self.config.transfer_chunk_bytes
        window = max(1, int(getattr(self.config, "transfer_window", 4)))
        pending: deque = deque(
            (off, min(chunk, total - off)) for off in range(0, total, chunk)
        )
        inflight = 0
        peak = 0
        completed = 0
        served: set = set()  # sources that landed >= 1 chunk
        last_err: Optional[BaseException] = None

        async def _lane(src: dict) -> None:
            nonlocal inflight, peak, completed
            conn = await self.conn_to(src["addr"])
            while pending:
                off, ln = pending.popleft()
                inflight += 1
                peak = max(peak, inflight)
                try:
                    r = await conn.call(
                        "pull_chunk", shm_name=src["shm_name"], off=off,
                        len=ln, timeout=self.config.push_timeout_s,
                    )
                    data = r["data"]
                    if len(data) != ln:
                        # short read: size metadata disagrees with the
                        # served file — treat the source as bad
                        raise ObjectLostError(
                            f"short read pulling {oid_b.hex()}: got "
                            f"{len(data)} of {ln} bytes at {off}/{total}"
                        )
                except BaseException:
                    # the chunk is NOT lost: back on the queue for the
                    # surviving lanes/sources (or the next locate round)
                    pending.appendleft((off, ln))
                    raise
                finally:
                    inflight -= 1
                mv[off : off + ln] = data
                completed += 1
                TRANSFER_STATS["bytes_pulled"] += ln
                TRANSFER_STATS["chunks_pulled"] += 1
                served.add(src["addr"])

        async def _source(src: dict) -> None:
            nonlocal last_err
            lanes = min(window, max(1, len(pending)))
            results = await asyncio.gather(
                *(_lane(src) for _ in range(lanes)), return_exceptions=True
            )
            errs = [e for e in results if isinstance(e, BaseException)]
            for e in errs:
                if isinstance(e, asyncio.CancelledError):
                    raise e
            if errs:
                # the source dropped out and its re-queued chunks were (or
                # will be) re-assigned — failover, whether the survivors
                # already drained them or a re-locate round picks them up
                last_err = errs[0]
                TRANSFER_STATS["source_failovers"] += 1
                from ..util import flightrec

                if flightrec.REC is not None:
                    flightrec.REC.record(
                        "transfer", "source_failover", oid=oid_b.hex(),
                        source=src.get("addr"), error=repr(errs[0]),
                        chunks_left=len(pending),
                    )

        stalled = 0
        rounds = 0
        while pending:
            sources = self._pull_sources(reply)
            if not sources:
                raise ObjectLostError(
                    f"object {oid_b.hex()} is on node {reply.get('node')} "
                    f"with no reachable object server"
                ) from last_err
            before = completed
            # _source never raises except on cancellation, so a plain gather
            # is a barrier that propagates cancellation and nothing else
            await asyncio.gather(*(_source(s) for s in sources))
            if not pending:
                break
            rounds += 1
            stalled = stalled + 1 if completed == before else 0
            TRANSFER_STATS["pull_retry_rounds"] += 1
            if stalled >= 3 or rounds >= 16:
                raise ObjectLostError(
                    f"pull of {oid_b.hex()} failed after {rounds} rounds "
                    f"({len(pending)} chunks missing): {last_err!r}"
                ) from last_err
            await asyncio.sleep(0.2 * stalled)
            # every source died mid-transfer: ask the directory again — a
            # survivor copy / relocated spill can finish the remainder
            reply = await self.head.call("obj_locate", oid=oid_b)
            if not reply.get("found"):
                raise ObjectLostError(
                    f"object {oid_b.hex()} lost mid-pull "
                    f"({len(pending)} chunks missing)"
                ) from last_err
        TRANSFER_STATS["pulls"] += 1
        TRANSFER_STATS["window_peak_sum"] += peak if peak else 1
        TRANSFER_STATS["sources_used"] += len(served)
        if len(served) > 1:
            TRANSFER_STATS["multi_source_pulls"] += 1

    def _notify_obj_copy(self, oid_b: bytes, local_name: str) -> None:
        """Record the freshly pulled copy in the head's directory so later
        pulls can multi-source from this node.  A failed notify DEFERS for
        housekeeping re-send (the obj_release idiom) instead of being
        swallowed: losing it silently meant the head never learned about
        the copy — invisible to multi-source splitting and never reclaimed
        by name on eviction."""
        head = self.head
        if head is not None and not head.closed:
            try:
                head.notify(
                    "obj_copy", oid=oid_b, node=self.node_id,
                    shm_name=local_name,
                )
                return
            except Exception:
                pass
        TRANSFER_STATS["copy_notify_deferred"] += 1
        self._deferred_copy_notifies.append((oid_b, local_name))

    def ensure_local_shm_blocking(self, oid_b: bytes, shm_name: str, size: int = 0) -> str:
        """Thread-safe blocking wrapper (used by executor threads resolving
        task args that reference another node's objects)."""
        name, _ = self.run_coro(self._ensure_local_shm(oid_b, shm_name, size))
        return name

    # ------------------------------------------------- lineage reconstruction
    def _object_available(self, oid: ObjectID) -> bool:
        """Is the object's data still reachable (locally or in the cluster)?"""
        e = self.memory_store.get_entry(oid)
        if e is None or e.state == "error":
            return False
        if e.state == "shm":
            try:
                reply = self.head_call("obj_locate", oid=oid.binary())
            except Exception:
                return False
            return bool(reply.get("found"))
        return True  # value/packed/pending/device resolved in-process

    def _reconstruct_object(self, oid: ObjectID, depth: int = 0) -> bool:
        """Recompute a lost object by re-executing its creating task
        (lineage-based recovery, object_recovery_manager.h:38).  Blocking;
        must run on a user thread (it drives RPCs through the IO loop).
        Returns True when the object's entries were refilled."""
        try:
            asyncio.get_running_loop()
            return False  # on the IO thread: cannot block on reconstruction
        except RuntimeError:
            pass
        if depth > 20 or oid.is_put():
            return False
        tid = oid.task_id().binary()
        rec = self._lineage.get(tid)
        if rec is None:
            return False
        # single-flight per creating task: concurrent getters of its returns
        # share one re-execution
        with self._recon_lock:
            ev = self._recon_events.get(tid)
            leader = ev is None
            if leader:
                ev = self._recon_events[tid] = threading.Event()
        if not leader:
            ev.wait(self.config.push_timeout_s)
            e = self.memory_store.get_entry(oid)
            return e is not None and e.state not in ("pending", "error")
        try:
            if rec["budget"] <= 0:
                return False
            rec["budget"] -= 1
            # dependencies first: a lost arg is recomputed recursively
            deps = list(rec["args"]) + list(rec["kwargs"].values())
            for a in deps:
                if isinstance(a, ObjectRef) and not self._object_available(a.id):
                    if not self._reconstruct_object(a.id, depth + 1):
                        return False
            oids = rec["oids"]
            reset = []
            for o in oids:
                # only resurrect siblings somebody can still read — a dead
                # sibling refilled here would pin an unevictable entry (and
                # _store_results would refuse to fill it, so waiting on it
                # below would stall the full push timeout)
                if (
                    o == oid
                    or self.memory_store.get_entry(o) is not None
                    or self.reference_counter.local_count(o) > 0
                ):
                    self.memory_store.reset_pending(o)
                    reset.append(o)
            task_id = TaskID(tid)
            self._pump_submit(
                lambda: self._task_entry(
                    task_id, rec["fn_id"], None, rec["args"], rec["kwargs"],
                    rec["opts"], oids,
                )
            )
            ready, not_ready = self.memory_store.wait_ready(
                reset, len(reset), self.config.push_timeout_s
            )
            return not not_ready
        finally:
            ev.set()
            with self._recon_lock:
                self._recon_events.pop(tid, None)

    # ------------------------------------------------------------------ wait
    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1, timeout: Optional[float] = None):
        ref_list = list(refs)
        if num_returns > len(ref_list):
            raise ValueError("num_returns exceeds number of refs")
        for r in ref_list:
            self._seed_borrowed(r.id, owner=r.owner)
        ready_ids, rest_ids = self.memory_store.wait_ready(
            [r.id for r in ref_list], num_returns, timeout
        )
        ready_set = set(ready_ids)
        ready, rest = [], []
        for r in ref_list:
            (ready if r.id in ready_set and len(ready) < num_returns else rest).append(r)
        return ready, rest

    def resolve_future(self, ref: ObjectRef):
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _wait():
            try:
                fut.set_result(self.get(ref))
            except BaseException as e:
                fut.set_exception(e)

        threading.Thread(target=_wait, daemon=True).start()
        return fut

    # ----------------------------------------------------------- arg packing
    def _notify_threadsafe(self, _method: str, **fields):
        """head.notify from any thread (the cork needs the running loop)."""
        def _send():
            if self.head is not None and not self.head.closed:
                try:
                    self.head.notify(_method, **fields)
                except Exception:
                    pass

        try:
            self.loop.call_soon_threadsafe(_send)
        except RuntimeError:
            pass

    # ------------------------------------------------------------- spilling
    def _spill_kick(self):
        """Non-blocking: wake (or start) the background spill thread — the
        IO-worker analogue of local_object_manager.h.  Called from the
        store's seal path when live bytes cross the high watermark, so the
        allocating put never waits on disk."""
        import queue as _queue

        with self._spill_start_lock:
            if self._spill_thread is None:
                self._spill_queue = _queue.Queue(maxsize=2)
                self._spill_thread = threading.Thread(
                    target=self._spill_loop, name="ca-spill", daemon=True
                )
                self._spill_thread.start()
        try:
            self._spill_queue.put_nowait(1)
        except _queue.Full:
            pass  # a pass is already queued; it will see the latest usage

    def _spill_loop(self):
        import queue as _queue

        low_frac = 0.5  # spill down to this fraction of the budget
        while not self._stopped:
            try:
                self._spill_queue.get(timeout=0.5)
            except _queue.Empty:
                continue
            store = self.shm_store
            if not store.budget_bytes:
                continue
            need = store.live_bytes() - int(store.budget_bytes * low_frac)
            if need > 0:
                self.spill_stats["background"] += 1
                self._spill_pass(need)

    def _spill_bytes(self, need: int):
        """Hard-wall spill on the allocating path: an allocation could not
        fit the budget even after the watermark spiller's work.  Kept as the
        correctness backstop; the proactive path (_spill_kick) exists so
        this rarely runs."""
        try:
            asyncio.get_running_loop()
            return  # IO-loop context (pull imports): cannot block on RPCs
        except RuntimeError:
            pass
        self.spill_stats["inline"] += 1
        self._spill_pass(max(need, self.shm_store.budget_bytes // 8))

    def _spill_pass(self, target: int):
        """Move the oldest live slices of this process to disk until `target`
        bytes are freed (LocalObjectManager spill analogue).  The slice's
        OWNER arbitrates when it is this process (ownership plane: the
        free-now-vs-defer decision is one ledger transition, the head just
        learns `obj_spilled` asynchronously for its snapshot); the head
        arbitrates for slices backing other owners' objects and on the
        centralized path.  Either way a slice under zero-copy pins is
        relocated but its memory reclaim is deferred to the last pin drop.
        Serialized: concurrent inline + background passes would re-spill the
        same slices."""
        if (self.head is None or self.head.closed) and self.owner_ledger is None:
            return
        with self._spill_lock:
            self._spill_pass_locked(target)

    def _spill_pass_locked(self, target: int):
        spill_dir = os.path.join(self.session_dir, "spill", self.node_id)
        os.makedirs(spill_dir, exist_ok=True)
        freed = 0
        for name, size, oid_b in self.shm_store.live_slices_oldest_first():
            if freed >= target:
                break
            if name in self._spilled_pinned:
                # already relocated to disk; its memory comes back only when
                # the last zero-copy pin drops — re-spilling would just
                # rewrite the same file for nothing
                continue
            led = self.owner_ledger
            if (
                (self.head is None or self.head.closed)
                and not (led is not None and led.tracks(oid_b))
            ):
                # borrowed slice with no arbiter reachable: it can only stay
                # in memory — check BEFORE the file write, or a head outage
                # under pressure rewrites and deletes the same multi-MB
                # files every pass
                continue
            try:
                mv = self.shm_store.open(name)
            except Exception:
                continue
            path = os.path.join(spill_dir, f"{oid_b.hex()}.bin")
            try:
                with open(path, "wb") as f:
                    f.write(mv)
            except OSError:
                mv.release()
                return  # disk full: stop spilling
            finally:
                try:
                    mv.release()
                except Exception:
                    pass
            led = self.owner_ledger
            if led is not None and led.tracks(oid_b):
                # owner-side decision: one ledger transition, no head RPC on
                # the allocating path (works with the head down, too)
                pinned = led.spill_transition(oid_b, path)
                if pinned is None:
                    # GC won the race: drop the file, reclaim the slice
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    self.shm_store.free_local(name)
                    freed += size
                    continue
                # the registry learns asynchronously (snapshot/pull routing)
                # (no `freed` field: the head never read it — the owner's
                # ledger is the pin authority, the registry only needs the
                # path; ca lint rpc-unread-field)
                self._notify_threadsafe(
                    "obj_spilled", oid=oid_b, path=path, size=size,
                    decided=True,
                )
                if pinned:
                    # memory comes back on the last value-pin drop
                    # (_ledger_pin_zero); never a spill candidate again
                    self._spilled_pinned.add(name)
                else:
                    self.shm_store.free_local(name)
                    freed += size
                continue
            if self.head is None or self.head.closed:
                # borrowed slice, no arbiter reachable: leave it in memory —
                # but keep scanning: later candidates may be OWNED slices
                # this process can settle head-free (spill_transition above)
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            try:
                reply = self.head_call("obj_spilled", oid=oid_b, path=path, size=size)
            except Exception:
                # head died mid-pass: same story — owned candidates later in
                # the scan still settle without it
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if not reply.get("found"):
                # object already GC'd: drop the file, reclaim the slice
                try:
                    os.unlink(path)
                except OSError:
                    pass
                self.shm_store.free_local(name)
                freed += size
            elif reply.get("free_now"):
                self.shm_store.free_local(name)
                freed += size
            else:
                # pinned: relocated but memory comes back later (pin drop);
                # never pick it as a spill candidate again
                self._spilled_pinned.add(name)

    def _promote_nested(self, nested: List[bytes], depth: int = 0):
        """Nested refs to inline-only objects have no cluster-visible data
        (inline values never register at the head): spill them to shm and
        register, so a borrower on any process/node can locate and read them.
        Thread-safe; recurses for refs nested inside the promoted values."""
        if depth > 5:
            return
        for oid_b in nested:
            oid = ObjectID(oid_b)
            e = self.memory_store.get_entry(oid)
            if e is None or e.shm_name is not None or e.state not in ("value", "packed"):
                continue
            try:
                if e.state == "packed":
                    sub: List[bytes] = []
                    if self.client_mode:
                        # already pack()-framed: upload the blob verbatim
                        name, size = self._client_upload_blob(oid, e.packed)
                    else:
                        name, mv = self.shm_store.create_for_import(
                            oid, len(e.packed), primary=True
                        )
                        try:
                            mv[:] = e.packed
                        except BaseException:
                            mv.release()
                            self.shm_store.abort_import(name)
                            raise
                        mv.release()
                        self.shm_store.seal_done(name)
                        size = len(e.packed)
                else:
                    with serialization.ref_capture() as sub:
                        data, buffers = serialization.serialize(e.value)
                    if self.client_mode:
                        name, size = self._client_upload(
                            oid, data, [b.raw() for b in buffers]
                        )
                    else:
                        name, size = self.shm_store.create_and_pack(
                            oid, data, [b.raw() for b in buffers]
                        )
            except Exception:
                continue
            e.shm_name = name
            e.size = size
            if not self.client_mode:
                self._notify_threadsafe(
                    "obj_created", oid=oid_b, shm_name=name, size=size, node=self.node_id
                )
                if self.owner_ledger is not None and self.owner_ledger.tracks(oid_b):
                    self.owner_ledger.set_location(oid_b, name, size)
            if sub:
                self._promote_nested(sub, depth + 1)
                self._register_contains(oid_b, list(sub))

    def transit_pin(self, nested: List[bytes]) -> str:
        """Pin in-transit borrowed refs at the head under a fresh token (the
        receiver releases it via transit_done).  Also promotes inline-only
        nested objects to shm so borrowers can actually fetch them."""
        self._promote_nested(nested)
        token = f"t:{self.client_id}:{self._put_counter.next()}"
        self._queue_refs(list(nested), [], as_id=token)
        return token

    def transit_owners(self, nested: List[bytes]) -> List[str]:
        """Per-roid authority metadata ("rown") shipped alongside a transit
        envelope: the cid whose ledger the sender's pin lands at ("" = the
        head).  The receiver seeds its routing from this BEFORE unpacking,
        so an ack for a payload that never unpacks still reaches the ledger
        holding the pin instead of tombstoning the token at the head."""
        if not self._owner_plane:
            return ["" for _ in nested]
        out = []
        for oid in nested:
            d = self._ref_dest(oid)
            out.append(self.client_id if d == "" else (d or ""))
        return out

    def _note_transit_owners(self, env: dict) -> None:
        """Seed borrowed-owner routing from a transit envelope's rown
        metadata (see transit_owners) so transit_done — and any later dec —
        routes to the authority the sender actually pinned at, even when
        the payload fails to unpack and no ObjectRef ever rehydrates."""
        owners = env.get("rown")
        if not owners or not self._owner_plane:
            return
        for oid, owner in zip(env.get("roids") or (), owners):
            if owner and owner != self.client_id:
                self._borrowed_owners.setdefault(bytes(oid), owner)

    def transit_done(self, token: str, roids: List[bytes],
                     register: bool = True) -> None:
        """Receiver-side ack: register this process as holder of the smuggled
        refs and release the sender's transit pin (thread-safe).
        register=False releases the pin without claiming holdership — for
        payloads the receiver failed to unpack.

        Routed per-oid to each object's lifetime authority (the pin was
        registered there by the sender's transit_pin): our own ledger, the
        owner's ledger over a direct connection, or the head fallback."""
        def _send():
            if not self._owner_plane:
                self._transit_done_head(token, roids, register)
                return
            groups: Dict[Optional[str], List[bytes]] = {}
            for oid in roids:
                groups.setdefault(self._ref_dest(oid), []).append(oid)
            for dest, oids in groups.items():
                if dest == "":
                    self.owner_ledger.transit_done(
                        token, oids, self.client_id, register
                    )
                elif dest is None:
                    self._transit_done_head(token, oids, register)
                else:
                    t = spawn_bg(
                        self._owner_transit_done_async(dest, token, oids, register)
                    )
                    t.add_done_callback(self._report_task_exc)

        try:
            self.loop.call_soon_threadsafe(_send)
        except RuntimeError:
            pass

    def _transit_done_head(self, token, oids, register) -> None:
        if self.head is not None and not self.head.closed:
            try:
                self.head.notify(
                    "transit_done", token=token, oids=oids, register=register
                )
            except Exception:
                pass

    async def _owner_transit_done_async(self, owner, token, oids, register) -> None:
        try:
            addr = await self._owner_addr_async(owner)
            if addr is None:
                raise ConnectionError(f"owner {owner} not dialable")
            conn = await self.conn_to(addr)
            conn.notify(
                "owner_transit_done", token=token, oids=oids,
                cid=self.client_id, register=register,
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            # dead owner: the head adopted its ledger — settle there
            self._transit_done_head(token, oids, register)

    async def _pack_with_transit_async(self, value: Any, ttl_pin: bool = False) -> dict:
        """_pack_with_transit usable on the IO loop: client-mode promotion
        awaits the head instead of blocking head_call.

        ttl_pin=True marks the pin for the head's lost-ack TTL sweep — ONLY
        for protocols whose ack time is bounded (the owner_locate serve path,
        where the borrower acks on unpack or promptly re-polls).  Task-arg
        pins must NOT set it: a queued task's ack waits for execution, which
        lease contention can delay indefinitely; their cleanup is sender
        liveness (head disconnect sweep)."""
        with serialization.ref_capture() as nested:
            blob = serialization.pack(value)
        if not nested:
            return {"v": blob}
        await self._promote_nested_async(nested)
        token = f"t:{self.client_id}:{self._put_counter.next()}"
        self._queue_refs(list(nested), [], as_id=token, ttl=bool(ttl_pin))
        return {
            "v": blob, "t": token, "roids": nested,
            "rown": self.transit_owners(nested),
        }

    async def _build_arg(self, value: Any) -> dict:
        """Build the wire spec for one task argument."""
        if isinstance(value, ObjectRef):
            oid = value.id
            # dependency resolution: wait until the local entry is ready
            while True:
                e = self.memory_store.get_entry(oid)
                if e is None:
                    raise ObjectLostError(f"arg object {oid} unknown to this process")
                if e.state != "pending":
                    break
                await asyncio.sleep(0.002)
            if e.state == "error":
                raise e.error
            if e.state == "device":
                return {"dev": oid.binary(), "owner": e.shm_name, "spec": e.value}
            if e.shm_name and e.state in ("shm", "value"):
                # keep shm provenance even after a local zero-copy read
                return {"shm": e.shm_name, "size": e.size, "oid": oid.binary()}
            if oid.binary() in self.device_objects:
                if not self.serve_addr:
                    # driver has no serving socket: ship inline, as a
                    # transport envelope (raw host buffers out of band)
                    from ..channel.device_transport import pack_device_value

                    return {
                        "v": serialization.pack(
                            pack_device_value(self.device_objects[oid.binary()])
                        )
                    }
                return {
                    "dev": oid.binary(),
                    "owner": self.serve_addr,
                    "spec": _device_spec(self.device_objects[oid.binary()]),
                }
            # small local value: inline (packed)
            if e.state == "packed":
                return {"v": e.packed}
            return await self._pack_with_transit_async(e.value)
        # plain value: device values stay on device when this process can
        # serve them (workers/actors); the driver ships an envelope.
        if _is_device_value(value):
            from ..channel.device_transport import pack_device_value, settle

            if not self.serve_addr:
                return {"v": serialization.pack(pack_device_value(value))}
            # kept under an id no local handle counts (a put's handle would
            # be dropped, and the value evicted, before the callee fetched
            # it): it stays until this process exits, as a device result
            # this process returned does
            settle(value)
            task_id = self.current_task_id or TaskID.for_normal_task(self.job_id)
            oid = ObjectID.for_put(task_id, self._put_counter.next())
            self.device_objects[oid.binary()] = value
            return {
                "dev": oid.binary(),
                "owner": self.serve_addr,
                "spec": _device_spec(value),
            }
        return await self._pack_with_transit_async(value)

    async def _build_args(self, args: Sequence[Any], kwargs: Dict[str, Any]):
        if not args and not kwargs:
            return [], {}
        specs = [await self._build_arg(a) for a in args]
        kwspecs = {k: await self._build_arg(v) for k, v in kwargs.items()}
        return specs, kwspecs

    def _prepare_runtime_env(self, runtime_env: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Package a runtime_env into wire form, cached per env spec so a
        working_dir is zipped+uploaded once, not per task. (Packaging does
        blocking head RPCs: only call from user threads, never the IO loop.
        Caveat: edits to a working_dir after first use are not re-uploaded
        within one driver session — matches the reference's upload-once URIs.)
        """
        import json as _json

        from . import runtime_env as _re

        key = _json.dumps(runtime_env, sort_keys=True, default=repr)
        if not hasattr(self, "_runtime_env_cache"):
            self._runtime_env_cache = {}
        if key not in self._runtime_env_cache:
            self._runtime_env_cache[key] = _re.prepare(runtime_env, self)
        return self._runtime_env_cache[key]

    # ---------------------------------------------------------- task submit
    def submit_task(self, fn, args, kwargs, opts: Dict[str, Any]) -> List[ObjectRef]:
        if opts.get("runtime_env"):
            opts = dict(opts)
            opts["runtime_env"] = self._prepare_runtime_env(opts["runtime_env"])
        num_returns = opts.get("num_returns", 1)
        task_id = TaskID.for_normal_task(self.job_id)
        if TRACE_HOOK is not None:
            _tr = TRACE_HOOK.begin_task_trace(
                task_id.hex(), getattr(fn, "__name__", "task"), "task",
                self.client_id, self.node_id,
            )
            if _tr is not None:
                opts = dict(opts, _trace=_tr)
        oids = [ObjectID.for_return(task_id, i) for i in range(num_returns)]
        for oid in oids:
            self.memory_store.mark_pending(oid)
            self._add_owned(oid)
        refs = [ObjectRef(oid, owner=self.client_id, worker=self) for oid in oids]
        fn_id, blob = self.fn_manager.export(fn)
        self._record_lineage(task_id, fn_id, args, kwargs, opts, oids)
        self._pump_submit(
            lambda: self._task_entry(task_id, fn_id, blob, args, kwargs, opts, oids)
        )
        return refs

    def _record_lineage(self, task_id, fn_id, args, kwargs, opts, oids):
        budget = opts.get("max_retries", self.config.default_max_retries)
        if budget == 0:
            return  # max_retries=0 means not reconstructable either
        tid = task_id.binary()
        self._lineage[tid] = {
            "fn_id": fn_id,
            "args": args,
            "kwargs": kwargs,
            "opts": opts,
            "oids": oids,
            "budget": budget,
        }
        self._lineage_order.append(tid)
        while len(self._lineage_order) > self.config.lineage_cap:
            self._lineage.pop(self._lineage_order.popleft(), None)

    def _task_entry(self, task_id, fn_id, blob, args, kwargs, opts, oids):
        """Runs on the IO thread.  Fast path: an argless task of an
        already-exported function pushed onto an available lease entirely via
        callbacks — no per-task coroutine/Task.  When every lease is
        saturated, the task joins the pool's backlog (still no coroutine;
        release callbacks drain it).  Anything needing awaiting (arg
        resolution, function export) returns the slow coroutine instead."""
        if task_id.binary() in self._cancelled_tasks:
            self._store_error(oids, TaskCancelledError("task was cancelled"))
            return None
        if blob is not None or args or kwargs or opts.get("runtime_env"):
            return self._submit_task(task_id, fn_id, blob, args, kwargs, opts, oids)
        pool = self._lease_pool(opts)
        lease = pool._pick()
        # count this task as demand BEFORE deciding (both predicates read
        # inflight_total); a busy lease is only used when pipelining is the
        # right regime, else the task backlogs until growth/release
        if (
            lease is None
            or (lease.inflight > 0 and not pool._pipeline_ok_for(pool.inflight_total + 1))
        ):
            pool.enqueue_fast(task_id, fn_id, opts, oids)
            return None
        pool.inflight_total += 1
        if not self._push_fast(pool, lease, task_id, fn_id, opts, oids):
            pool.inflight_total -= 1
            return self._submit_task(task_id, fn_id, None, args, kwargs, opts, oids)
        return None

    def _push_fast(self, pool, lease, task_id, fn_id, opts, oids) -> bool:
        """Push one argless task onto `lease` purely via callbacks.  Returns
        False (without touching counters) if the connection is unusable —
        the caller decides the fallback.  On success the reply callback
        releases the lease and stores results/errors, retrying worker death
        within the task's budget."""
        addr = self._normalize_peer_addr(lease.addr)
        conn = self._conns.get(addr)
        if conn is None or conn.closed:
            return False
        lease.inflight += 1
        self._inflight_tasks[task_id.binary()] = addr

        def on_reply(msg):
            self._inflight_tasks.pop(task_id.binary(), None)
            pool.release(lease, dead=msg is None)
            if msg is None:
                if task_id.binary() in self._cancelled_tasks:
                    # force-cancel killed the worker mid-task: cancelled, not
                    # crashed, and never retried
                    self._store_error(oids, TaskCancelledError("task was cancelled"))
                    return
                # worker died with the push in flight: retry on a fresh lease
                # only within the task's retry budget (at-most-once otherwise).
                # Death on a DRAINING node is a preemption, not an app
                # failure: the retry is free — the budget is not touched
                retries = opts.get("max_retries", self.config.default_max_retries)
                if self._retry_exempt(lease.node):
                    DRAIN_STATS["tasks_evacuated_total"] += 1
                    t = spawn_bg(
                        self._submit_task(task_id, fn_id, None, (), {}, opts, oids)
                    )
                    t.add_done_callback(self._report_task_exc)
                elif retries > 0:
                    retry_opts = dict(opts, max_retries=retries - 1)
                    t = spawn_bg(
                        self._submit_task(task_id, fn_id, None, (), {}, retry_opts, oids)
                    )
                    t.add_done_callback(self._report_task_exc)
                else:
                    self._store_error(
                        oids, WorkerCrashedError("worker died executing task")
                    )
            elif not msg.get("ok", True):
                import pickle

                self._store_error(oids, pickle.loads(msg["err"]))
            else:
                self._store_results(oids, msg["results"], addr)

        trace = opts.get("_trace")
        num_returns = opts.get("num_returns", 1)
        retriable = opts.get("max_retries", self.config.default_max_retries) > 0
        # head down (restart window): inline the function definition — the
        # lease plane keeps granting, so a push must not strand its worker
        # on a head blob fetch it cannot make (once per conn+fn)
        fn_blob = self._fn_blob_for_push(conn, fn_id)

        def spec_fields():
            # one definition for both the template constants and the traced
            # full-encode path — they must never drift apart
            return {
                "m": "push_task",
                "fn_id": fn_id,
                "owner": self.client_id,
                "args": [],
                "kwargs": {},
                "num_returns": num_returns,
                "retriable": retriable,
            }

        try:
            if trace is None and fn_blob is None:
                tmpl = self._task_spec_template(
                    ("task", fn_id, num_returns), spec_fields, retriable=retriable
                )
                conn.call_template("push_task", tmpl, on_reply, task_id.binary())
            else:
                # traced or blob-inlined push: the pre-encoded template
                # cannot carry a per-call field, so the spec is encoded in
                # full, riding the same corked envelope
                if trace is not None and TRACE_HOOK is not None:
                    TRACE_HOOK.record_task_event(
                        task_id.hex(), None, "task", "SCHEDULED", trace=trace,
                        worker_id=self.client_id, node_id=self.node_id,
                        target=lease.worker_id,
                    )
                fields = spec_fields()
                del fields["m"]  # call_cb supplies the method
                if fn_blob is not None:
                    fields["fn_blob"] = fn_blob
                if trace is not None:
                    fields[TRACE_FIELD] = trace
                conn.call_cb(
                    "push_task", on_reply,
                    task_id=task_id.binary(),
                    **fields,
                )
        except ConnectionError:
            self._inflight_tasks.pop(task_id.binary(), None)
            lease.inflight -= 1
            lease.dead = True
            return False
        return True

    def _task_spec_template(self, key: tuple, fields_fn, retriable: bool) -> MsgTemplate:
        """Cached pre-encoded spec for the argless fast paths: the constant
        fields (function descriptor / actor method, options) are msgpack'd
        once; per call only the request id and task id are encoded."""
        key = key + (retriable,)
        tmpl = self._spec_templates.get(key)
        if tmpl is None:
            if len(self._spec_templates) > 4096:
                self._spec_templates.clear()  # runaway-fn_id backstop
            tmpl = self._spec_templates[key] = MsgTemplate(
                fields_fn(), ("i", "task_id")
            )
        return tmpl

    def _shape_of(self, opts) -> Dict[str, float]:
        shape = dict(opts.get("resources") or {})
        shape["CPU"] = float(opts.get("num_cpus", 1))
        if opts.get("num_gpus"):
            shape["GPU"] = float(opts["num_gpus"])
        return {k: v for k, v in shape.items() if v}

    def _lease_pool(self, opts) -> LeasePool:
        shape = self._shape_of(opts)
        pg = None
        if opts.get("placement_group") is not None:
            pg = (opts["placement_group"], opts.get("placement_group_bundle_index", 0))
        strat = opts.get("strategy")
        # canonical JSON: NODE_LABEL strategies carry nested selector dicts,
        # which a tuple-of-items key cannot hash
        strat_key = json.dumps(strat, sort_keys=True) if strat else None
        key = (tuple(sorted(shape.items())), pg, strat_key)
        pool = self._lease_pools.get(key)
        if pool is None:
            pool = LeasePool(self, key, shape, pg, strat)
            self._lease_pools[key] = pool
        return pool

    async def _submit_task(self, task_id, fn_id, blob, args, kwargs, opts, oids):
        try:
            if blob is not None:
                await self.head.call("register_function", fn_id=fn_id, blob=blob)
                self.fn_manager.mark_exported(fn_id)
            specs, kwspecs = await self._build_args(args, kwargs)
        except asyncio.CancelledError:
            # unblock get() waiters, then stay cancelled (a swallowed cancel
            # here would wedge worker shutdown mid-submission)
            self._store_error(oids, TaskCancelledError("submission cancelled"))
            raise
        except BaseException as e:
            self._store_error(oids, e)
            return
        retries = opts.get("max_retries", self.config.default_max_retries)
        pool = self._lease_pool(opts)
        trace = opts.get("_trace")
        if trace is not None and TRACE_HOOK is not None:
            TRACE_HOOK.record_task_event(
                task_id.hex(), None, "task", "QUEUED", trace=trace,
                worker_id=self.client_id, node_id=self.node_id,
            )
        while True:
            try:
                lease = await pool.acquire()
            except asyncio.CancelledError:
                self._store_error(oids, TaskCancelledError("submission cancelled"))
                raise
            except BaseException as e:
                self._store_error(oids, e)
                return
            if task_id.binary() in self._cancelled_tasks:
                # cancelled while waiting for a lease: never push
                pool.release(lease)
                self._store_error(oids, TaskCancelledError("task was cancelled"))
                return
            dead = False
            self._inflight_tasks[task_id.binary()] = self._normalize_peer_addr(
                lease.addr
            )
            try:
                conn = await self.conn_to(lease.addr)
                if trace is not None and TRACE_HOOK is not None:
                    TRACE_HOOK.record_task_event(
                        task_id.hex(), None, "task", "SCHEDULED", trace=trace,
                        worker_id=self.client_id, node_id=self.node_id,
                        target=lease.worker_id,
                    )
                # head down: inline the function definition (see _push_fast)
                extra = {}
                fn_blob = self._fn_blob_for_push(conn, fn_id)
                if fn_blob is not None:
                    extra["fn_blob"] = fn_blob
                if trace is not None:
                    extra[TRACE_FIELD] = trace
                # no RPC timeout here: the reply arrives only after the task
                # finishes, which may legitimately take arbitrarily long;
                # worker death is detected by the connection breaking.
                reply = await conn.call(
                    "push_task",
                    task_id=task_id.binary(),
                    fn_id=fn_id,
                    owner=self.client_id,
                    args=specs,
                    kwargs=kwspecs,
                    num_returns=opts.get("num_returns", 1),
                    runtime_env=opts.get("runtime_env"),
                    retriable=retries > 0,
                    timeout=None,
                    **extra,
                )
            except ConnectionError as e:
                dead = True
                if task_id.binary() in self._cancelled_tasks:
                    self._store_error(oids, TaskCancelledError("task was cancelled"))
                    return
                if self._retry_exempt(lease.node):
                    # preemption/drain kill: free retry, budget untouched
                    DRAIN_STATS["tasks_evacuated_total"] += 1
                    continue
                if retries > 0:
                    retries -= 1
                    continue
                self._store_error(
                    oids, WorkerCrashedError(f"worker died executing task: {e}")
                )
                return
            finally:
                self._inflight_tasks.pop(task_id.binary(), None)
                pool.release(lease, dead=dead)
            self._store_results(oids, reply["results"], lease.addr)
            return

    def _store_error(self, oids: List[ObjectID], e: BaseException):
        err = e if isinstance(e, CAError) else TaskError(repr(e))
        if oids:
            tid = oids[0].task_id().binary()
            if tid in self._cancelled_tasks and not isinstance(
                e, TaskCancelledError
            ):
                # the caller cancelled this task; whatever error the push
                # path surfaced afterwards (arg-resolution failure, backlog
                # drain) must not outrank the cancellation — a sibling ref's
                # get() may already have raised TaskCancelledError
                err = TaskCancelledError("task was cancelled")
            self._cancelled_tasks.discard(tid)
        for oid in oids:
            self.memory_store.put_error(oid, err)

    def _store_results(self, oids: List[ObjectID], results: List[dict], exec_addr: str):
        if oids:
            tid = oids[0].task_id().binary()
            if tid in self._cancelled_tasks:
                # the task outran its cancellation (value arrived anyway):
                # the caller asked for cancel semantics, and an earlier
                # get() may already have raised — stay consistent
                self._store_error(oids, TaskCancelledError("task was cancelled"))
                return
            self._cancelled_tasks.discard(tid)
        for oid, res in zip(oids, results):
            if "contains" in res:
                # owner-resident containment: the executing worker registered
                # the nested refs' edges; this (owner) ledger must remember —
                # or immediately release — them
                self._adopt_result_contains(oid.binary(), res)
            if (
                self.memory_store.get_entry(oid) is None
                and self.reference_counter.local_count(oid) == 0
                and oid.task_id().binary() not in self._streams
            ):
                # (stream items are exempt: they arrive before the consumer
                # creates a ref — the StreamState, not a ref count, keeps
                # them alive until read or the stream is abandoned)
                # fire-and-forget: every local handle died before the result
                # arrived (local-zero eviction already ran), so storing would
                # resurrect an entry nothing can ever read or evict again.
                # Smuggled refs still need their transit pin released: ack as
                # holder, then drop the holds we just acquired — but ONLY for
                # roids with no live local ref (holders is a set at the head,
                # so a dec here would erase a legitimate concurrent hold)
                if "t" in res:
                    self._note_transit_owners(res)
                    self.transit_done(res["t"], res["roids"])
                    dec = [
                        r
                        for r in res["roids"]
                        if self.reference_counter.local_count(ObjectID(r)) == 0
                    ]
                    if dec:
                        self._queue_refs([], dec)
                continue
            if "e" in res:
                import pickle

                self.memory_store.put_error(oid, pickle.loads(res["e"]))
            elif "v" in res:
                if "t" in res:
                    # inline value smuggling ObjectRefs: unpack eagerly so the
                    # rehydrated handles register before we release the
                    # sender's transit pin (lazy unpack would leave the
                    # nested refs unprotected once the sender drops its own).
                    # Seed ack routing first: the except path below never
                    # rehydrates, and its ack must still reach the pin
                    self._note_transit_owners(res)
                    try:
                        value = serialization.unpack(res["v"])
                    except Exception:
                        # undeserializable here (e.g. worker-only class): keep
                        # the refs safe by registering this process as holder
                        # anyway, and let the getter surface the real error
                        self.transit_done(res["t"], res["roids"])
                        self.memory_store.put_packed(oid, res["v"])
                    else:
                        self.memory_store.put_value(oid, value, size=len(res["v"]))
                        self.transit_done(res["t"], res["roids"])
                else:
                    self.memory_store.put_packed(oid, res["v"])
            elif "shm" in res:
                self.memory_store.put_shm(oid, res["shm"], res.get("size", 0))
                if self.owner_ledger is not None:
                    # this submitter owns the return: the ledger serves its
                    # location to borrowers even after local eviction
                    self.owner_ledger.set_location(
                        oid.binary(), res["shm"], res.get("size", 0)
                    )
            elif "dev" in res:
                e = _Entry("device", value=res.get("spec"), shm_name=res.get("owner", exec_addr))
                self.memory_store._store(oid, e)
            if self.reference_counter.local_count(oid) == 0 and not self.reference_counter.is_owned(oid):
                # the last handle died between the guard above and the store
                # (eviction already ran and found nothing): drop the entry we
                # just resurrected
                self.memory_store.delete(oid)

    # ------------------------------------------------------------- actors
    def create_actor(self, cls, args, kwargs, opts: Dict[str, Any]) -> Tuple[ActorID, str]:
        actor_id = ActorID.of(self.job_id)
        fn_id, blob = self.fn_manager.export(cls)
        wire_env = None
        if opts.get("runtime_env"):
            wire_env = self._prepare_runtime_env(opts["runtime_env"])  # user thread

        async def _create():
            if blob is not None:
                await self.head.call("register_function", fn_id=fn_id, blob=blob)
                self.fn_manager.mark_exported(fn_id)
            specs, kwspecs = await self._build_args(args, kwargs)
            init_spec = serialization.pack((specs, kwspecs))
            shape = dict(opts.get("resources") or {})
            if opts.get("num_cpus"):
                shape["CPU"] = float(opts["num_cpus"])
            if opts.get("num_gpus"):
                shape["GPU"] = float(opts["num_gpus"])
            reply = await self.head.call(
                "create_actor",
                actor_id=actor_id.hex(),
                name=opts.get("name"),
                fn_id=fn_id,
                init_spec=init_spec,
                resources=shape,
                max_restarts=opts.get("max_restarts", self.config.default_actor_max_restarts),
                detached=(opts.get("lifetime") == "detached"),
                max_concurrency=opts.get("max_concurrency", 1),
                concurrency_groups=opts.get("concurrency_groups"),
                method_options=opts.get("method_options"),
                pg_id=opts.get("placement_group"),
                bundle_index=opts.get("placement_group_bundle_index", -1),
                runtime_env=wire_env,
                strategy=opts.get("strategy"),
                drain_migration=bool(opts.get("drain_migration", True)),
                timeout=None,
            )
            return reply

        reply = self.run_coro(_create())
        self._actor_addr_cache[actor_id.hex()] = (reply["addr"], reply["incarnation"])
        return actor_id, reply["addr"]

    async def _actor_addr(self, actor_id_hex: str, refresh: bool = False) -> str:
        if not refresh:
            cached = self._actor_addr_cache.get(actor_id_hex)
            if cached is not None:
                return cached[0]
        deadline = time.monotonic() + 30.0
        while True:
            reply = await self.head.call("get_actor", actor_id=actor_id_hex)
            state = reply["state"]
            if state == "alive":
                self._actor_addr_cache[actor_id_hex] = (reply["addr"], reply["incarnation"])
                return reply["addr"]
            if state == "dead":
                raise ActorDiedError(reply.get("death_cause") or "actor is dead")
            if time.monotonic() > deadline:
                raise ActorDiedError(f"actor stuck in state {state}")
            await asyncio.sleep(0.1)

    def submit_actor_task(self, actor_id: ActorID, method: str, args, kwargs, opts) -> List[ObjectRef]:
        num_returns = opts.get("num_returns", 1)
        task_id = TaskID.for_actor_task(actor_id)
        if TRACE_HOOK is not None:
            _tr = TRACE_HOOK.begin_task_trace(
                task_id.hex(), method, "actor_task", self.client_id, self.node_id,
            )
            if _tr is not None:
                opts = dict(opts, _trace=_tr)
        oids = [ObjectID.for_return(task_id, i) for i in range(num_returns)]
        for oid in oids:
            self.memory_store.mark_pending(oid)
            self._add_owned(oid)
        refs = [ObjectRef(oid, owner=self.client_id, worker=self) for oid in oids]
        self._pump_submit(
            lambda: self._actor_call_entry(actor_id, method, args, kwargs, opts, task_id, oids)
        )
        return refs

    def _actor_call_entry(self, actor_id, method, args, kwargs, opts, task_id, oids):
        """IO-thread fast path for argless actor calls on a known-alive
        incarnation: pure callback RPC, no coroutine.  Falls back to the
        retrying slow path for args, unknown addresses, or failures."""
        if args or kwargs:
            return self._submit_actor_task(actor_id, method, args, kwargs, opts, task_id, oids)
        aid = actor_id.hex()
        cached = self._actor_addr_cache.get(aid)
        conn = self._conns.get(cached[0]) if cached is not None else None
        if conn is None or conn.closed:
            return self._submit_actor_task(actor_id, method, args, kwargs, opts, task_id, oids)
        addr = cached[0]
        self._inflight_tasks[task_id.binary()] = addr

        def on_reply(msg):
            self._inflight_tasks.pop(task_id.binary(), None)
            if msg is None:
                if task_id.binary() in self._cancelled_tasks:
                    # force-cancel killed the actor process mid-call: the
                    # cancelled call must NOT re-execute on a restart
                    self._store_error(oids, TaskCancelledError("task was cancelled"))
                    return
                # connection died mid-call: slow path refreshes the actor
                # address (restart transparency) and retries
                t = spawn_bg(
                    self._submit_actor_task(actor_id, method, args, kwargs, opts, task_id, oids)
                )
                t.add_done_callback(self._report_task_exc)
            elif not msg.get("ok", True):
                import pickle

                e = pickle.loads(msg["err"])
                self._store_error(oids, e)
            else:
                self._store_results(oids, msg["results"], addr)

        trace = opts.get("_trace")
        num_returns = opts.get("num_returns", 1)
        retriable = opts.get("max_task_retries", 0) > 0

        def spec_fields():
            # shared by the template constants and the traced full encode
            return {
                "m": "actor_call",
                "actor_id": aid,
                "method": method,
                "owner": self.client_id,
                "args": [],
                "kwargs": {},
                "num_returns": num_returns,
                "retriable": retriable,
            }

        try:
            if trace is None:
                tmpl = self._task_spec_template(
                    ("actor", aid, method, num_returns), spec_fields,
                    retriable=retriable,
                )
                conn.call_template("actor_call", tmpl, on_reply, task_id.binary())
            else:
                # traced call: full spec with the trace context (the template
                # cannot carry a per-call field)
                if TRACE_HOOK is not None:
                    TRACE_HOOK.record_task_event(
                        task_id.hex(), None, "actor_task", "SCHEDULED",
                        trace=trace, worker_id=self.client_id,
                        node_id=self.node_id, target=aid,
                    )
                fields = spec_fields()
                del fields["m"]  # call_cb supplies the method
                conn.call_cb(
                    "actor_call", on_reply,
                    task_id=task_id.binary(),
                    **fields,
                    **{TRACE_FIELD: trace},
                )
        except ConnectionError:
            return self._submit_actor_task(actor_id, method, args, kwargs, opts, task_id, oids)
        return None

    async def _submit_actor_task(self, actor_id, method, args, kwargs, opts, task_id, oids):
        aid = actor_id.hex()
        try:
            specs, kwspecs = await self._build_args(args, kwargs)
        except asyncio.CancelledError:
            self._store_error(oids, TaskCancelledError("submission cancelled"))
            raise
        except BaseException as e:
            self._store_error(oids, e)
            return
        attempts = 1 + max(0, opts.get("max_task_retries", 0))
        # the +1 grants one address-refresh resend after an ambiguous
        # ConnectionError (restart transparency for idempotent calls).
        # no_resend suppresses it: incarnation-bound calls — compiled-DAG
        # actor loops — must fail with ActorDiedError rather than silently
        # re-run on the restarted actor, where they would reopen their
        # channels at stale stream positions and wedge the whole DAG.
        resend = 0 if opts.get("no_resend") else 1
        last_err: Optional[BaseException] = None
        refresh = False
        trace = opts.get("_trace")
        for _ in range(attempts + resend):
            try:
                addr = await self._actor_addr(aid, refresh=refresh)
                conn = await self.conn_to(addr)
                if trace is not None and TRACE_HOOK is not None:
                    TRACE_HOOK.record_task_event(
                        task_id.hex(), None, "actor_task", "SCHEDULED",
                        trace=trace, worker_id=self.client_id,
                        node_id=self.node_id, target=aid,
                    )
                self._inflight_tasks[task_id.binary()] = self._normalize_peer_addr(addr)
                try:
                    reply = await conn.call(
                        "actor_call",
                        actor_id=aid,
                        method=method,
                        task_id=task_id.binary(),
                        owner=self.client_id,
                        args=specs,
                        kwargs=kwspecs,
                        num_returns=opts.get("num_returns", 1),
                        retriable=opts.get("max_task_retries", 0) > 0,
                        timeout=None,
                        **({TRACE_FIELD: trace} if trace is not None else {}),
                    )
                finally:
                    self._inflight_tasks.pop(task_id.binary(), None)
                self._store_results(oids, reply["results"], addr)
                return
            except (ConnectionError, asyncio.TimeoutError) as e:
                if task_id.binary() in self._cancelled_tasks:
                    self._store_error(oids, TaskCancelledError("task was cancelled"))
                    return
                last_err = ActorDiedError(
                    f"actor {aid} died during call to {method!r}: {e}"
                )
                refresh = True
                await asyncio.sleep(0.05)
            except ActorDiedError as e:
                last_err = e
                break
        if task_id.binary() in self._cancelled_tasks:
            last_err = TaskCancelledError("task was cancelled")
        self._store_error(oids, last_err or ActorDiedError("actor call failed"))

    def cancel(self, ref, force: bool = False, recursive: bool = False):
        """Cancel the task that produces `ref` (ray.cancel semantics,
        task_manager.h CancelTask role): a task still queued owner-side is
        dropped immediately; a running one gets TaskCancelledError raised in
        its executing thread (best-effort — lands at a bytecode boundary);
        force=True hard-kills the executing worker process instead (the only
        way out of C-level blocking calls).  Either way the ref's get()
        raises TaskCancelledError and the task is never retried.  A task
        that already finished is untouched (no-op).  `recursive` is accepted
        for API parity; child tasks cancel when their own refs are
        cancelled."""
        oid = ref.id
        task_id = oid.task_id().binary()

        def _do():
            # task-level liveness first: a STREAM item's value arriving does
            # not mean the generator finished, and an in-flight push may
            # have already satisfied this particular return
            active = task_id in self._inflight_tasks or task_id in self._streams
            if not active:
                e = self.memory_store.get_entry(oid)
                if e is not None and e.state != "pending":
                    return  # already finished: no-op
            self._cancelled_tasks.add(task_id)
            # queued in a backlog: drop it right now
            for pool in self._lease_pools.values():
                for item in list(pool.backlog):
                    if item[0].binary() == task_id:
                        pool.backlog.remove(item)
                        pool.inflight_total -= 1
                        self._store_error(
                            item[3], TaskCancelledError("task was cancelled")
                        )
                        return
            addr = self._inflight_tasks.get(task_id)
            if addr is not None:
                conn = self._conns.get(addr)
                if conn is not None and not conn.closed:
                    try:
                        conn.notify("cancel", task_id=task_id, force=force)
                    except ConnectionError:
                        pass  # worker already gone; death path settles the ref
            else:
                # not pushed yet (awaiting a lease / resolving args): settle
                # THIS ref immediately — a cancelled task must not stay
                # pending until cluster capacity frees — and leave the
                # cancelled mark so the submit path releases its lease and
                # settles any sibling return oids when it wakes
                self.memory_store.put_error(
                    oid, TaskCancelledError("task was cancelled")
                )

        self.loop.call_soon_threadsafe(_do)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self.head_call("kill_actor", actor_id=actor_id.hex(), no_restart=no_restart)

    def get_actor_info(self, name: Optional[str] = None, actor_id: Optional[str] = None) -> dict:
        return self.head_call("get_actor", name=name, actor_id=actor_id)

    # ------------------------------------------------------------- cluster
    def head_call(self, method: str, **fields) -> dict:
        """Blocking control-plane RPC.  Rides through a head restart: while
        the housekeeping loop is redialing, retry instead of surfacing
        ConnectionError (gcs client reconnection semantics)."""
        deadline = time.monotonic() + 15.0
        while True:
            try:
                return self.run_coro(self.head.call(method, **fields))
            except FencedError:
                # the head refused our stamped incarnation: death verdict.
                # Never retry — completing this call would be the duplicate
                # side effect fencing exists to prevent.
                self._fence_now()
                raise
            except ConnectionError:
                if (
                    self._stopped
                    or self._head_fenced
                    or time.monotonic() > deadline
                ):
                    raise
                time.sleep(0.25)

    def shutdown(self, stop_cluster: bool = False):
        self._stopped = True
        try:
            self.reference_counter.flush()
        except Exception:
            pass
        if stop_cluster and self.head is not None and not self.head.closed:
            try:
                self.run_coro(self.head.call("job_stop", timeout=2.0), timeout=3.0)
            except Exception:
                pass

        async def _close_all():
            # force out any debounce-window refcount updates before the
            # connections close (the timer may not have fired yet)
            try:
                self._flush_ref_pending()
            except Exception:
                pass
            # last lifecycle events out before the head connection closes
            try:
                self._flush_task_events()
            except Exception:
                pass
            # cancel + await housekeeping first: a bare loop.stop() would
            # destroy it mid-await ("Task was destroyed but it is pending")
            task = getattr(self, "_housekeeping_task", None)
            if task is not None and not task.done():
                task.cancel()
                try:
                    await task
                # awaiting a task WE just cancelled: its CancelledError is
                # the expected completion signal, not our own cancellation
                except (asyncio.CancelledError, Exception):  # ca-lint: ignore[async-swallowed-cancel]
                    pass
            if self.head is not None:
                await self.head.close()
            for c in self._conns.values():
                await c.close()
            if self._p2p_server is not None:
                await self._p2p_server.stop()
                for a in self._p2p_server.bound_addrs:
                    if a.startswith("unix:"):
                        try:
                            os.unlink(a[5:])
                        except OSError:
                            pass
                self._p2p_server = None

        try:
            self.run_coro(_close_all(), timeout=5)
        except Exception:
            pass
        if self._io_thread is not None:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._io_thread.join(timeout=2)
        set_global_worker(None)
