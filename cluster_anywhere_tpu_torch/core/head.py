"""Head control plane ("GCS" analogue).

One process per cluster.  Owns cluster metadata and cluster-wide decisions,
mirroring the subsystem split of the reference's GCS server
(src/ray/gcs/gcs_server/gcs_server.h): node table with joins/deaths
(gcs_node_manager.h), worker tables, per-node worker pools, resource
accounting + lease scheduler with pluggable policies (scheduling.py),
actor directory with restart FSM, placement groups with multi-node bundle
placement, namespaced KV, pubsub, object directory with locations + refcount
GC, and health checking.  Workers and drivers talk to it over the msgpack
protocol (protocol.py: unix sockets same-host, TCP across hosts); the hot
task path does NOT go through the head — drivers lease workers and push tasks
directly (normal_task_submitter.h lease model).

Multi-node topology: the head embeds the local node ("n0": it spawns and
monitors that node's workers directly, and serves that node's object pulls).
Every other node runs a node agent (nodeagent.py, the raylet analogue) that
registers here over TCP, spawns workers on head request, reports their
deaths, and serves chunked object pulls from its node's shm namespace.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import signal
import subprocess
import sys
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import netchaos, scheduling
from .config import CAConfig
from .errors import (
    ActorDiedError,
    FencedError,
    ObjectStoreFullError,
    PlacementGroupError,
)
from .protocol import (
    Connection,
    Server,
    fence_close,
    fence_close_conn,
    spawn_bg,
    write_frame,
)

LOCAL_NODE = "n0"

# Lease plane: pools whose unit-shape lease class is delegatable to node
# agents, and the resource shape ONE delegated slot backs.  Only the hot
# default class ({"CPU": 1}, no PG, no strategy) moves off the head; PG
# leases, custom shapes, and placement strategies always grant centrally so
# every bundle-charging / policy invariant stays in one place.
LEASE_UNIT_SHAPES = {"cpu": {"CPU": 1.0}}

# A worker's heartbeats come from its IO loop, which a thread holding the
# GIL for long (importing torch, creating a CUDA context) starves.  A local
# worker silent past the heartbeat bound whose process is still working
# (over each BUSY_WINDOW_S it used at least BUSY_CPU_SHARE of a core: a
# thread waiting for a GIL that a sleeping thread holds uses far less) is
# given up to this many bounds before it is declared dead (the widest
# silences seen on a GPU host, actors starting under load, were 1.3 bounds);
# a stopped or vanished one is declared dead at the bound, an idle one one
# window later.
BUSY_SILENCE_FACTOR = 2
BUSY_WINDOW_S, BUSY_CPU_SHARE = 1.0, 0.1

# An actor whose shape fits no node's total fails at once, unless an
# autoscaler read this head's demand (autoscaler_state) within this many
# seconds: it then waits as demand for the node the autoscaler launches,
# as long as the autoscaler keeps reading (autoscaler v2's pending actors).
AUTOSCALER_WATCH_S = 10.0

# --------------------------------------------------------------------------
# state records
# --------------------------------------------------------------------------


@dataclass
class NodeRec:
    node_id: str
    addr: Optional[str]  # agent RPC address; None = head-embedded local node
    total: Dict[str, float]
    avail: Dict[str, float]
    index: int = 0  # join order (scheduling tiebreak: pack onto earliest)
    # drain-plane FSM: alive -> draining -> drained | dead.  A draining node
    # is still UP (accounting, pulls, heartbeats) but no longer SCHEDULABLE
    # (grants, delegation, PG placement, actor placement all skip it).
    state: str = "alive"  # alive | draining | drained | dead
    drain_reason: str = ""  # preemption | idle | manual (while draining/drained)
    drain_deadline: float = 0.0  # monotonic deadline for the evacuation window
    # fencing token, minted at register and bumped on every rejoin after a
    # death verdict: authority-bearing RPCs stamped with an older value are
    # refused with FencedError (partition tolerance — a node the head
    # declared dead must not keep acting out of its pre-verdict state)
    incarnation: int = 1
    pid: int = 0
    last_heartbeat: float = field(default_factory=time.monotonic)
    idle: Dict[str, deque] = field(default_factory=lambda: {"cpu": deque(), "gpu": deque()})
    conn: Optional[Connection] = None  # head -> agent connection
    max_workers: int = 64
    mem_pressured: bool = False  # agent-reported memory pressure (monitor)
    load: Dict[str, float] = field(default_factory=dict)  # heartbeat telemetry
    labels: Dict[str, str] = field(default_factory=dict)  # static node labels
    # lease plane: workers whose unit-shape lease capacity is delegated to
    # this node's agent (pool -> set of wids).  Their shape is pre-charged
    # against avail, so agent-side grants need no head accounting.
    delegated: Dict[str, set] = field(default_factory=dict)
    # agent-reported block occupancy/counters, disseminated via heartbeats
    lease_used: Dict[str, dict] = field(default_factory=dict)
    # last node_sync delta version applied (delta-synced node state)
    sync_version: int = 0
    # metrics plane: the agent's HTTP scrape endpoint (Prometheus dials it
    # directly; `ca metrics --node` resolves through here when the head is up)
    metrics_addr: Optional[str] = None

    @property
    def is_local(self) -> bool:
        return self.addr is None

    @property
    def up(self) -> bool:
        """Node process is running (accounting/pulls valid) — includes
        draining nodes, which are up but not schedulable."""
        return self.state in ("alive", "draining")


@dataclass
class WorkerRec:
    worker_id: str
    pid: int
    addr: str  # address it serves (unix: same host, tcp: other nodes)
    node_id: str = LOCAL_NODE
    proc: Optional[subprocess.Popen] = None
    state: str = "starting"  # starting | idle | leased | actor | dead
    purpose: str = "pool"  # pool | actor — actor workers never join the idle pool
    pool: str = "cpu"  # cpu | gpu — only gpu workers may see the card
    lease_id: Optional[str] = None
    actor_id: Optional[str] = None
    last_heartbeat: float = field(default_factory=time.monotonic)
    blocked: bool = False  # blocked in get(); its cpus are released
    busy_since: float = 0.0  # monotonic time the current lease/actor began
    gpu_id: Optional[str] = None  # pinned GPU id (multi-GPU hosts only)
    addr_tcp: Optional[str] = None  # TCP dual of addr, for remote clients
    # why the head declared it dead (_on_worker_death), and the last lines
    # of its log then: what a caller of its actor is told
    death_cause: str = ""
    log_tail: str = ""
    # during a silence past the bound: its process's CPU ticks when the
    # current window began (-1: no window yet), and when that was
    silent_ticks: int = -1
    silent_window_at: float = 0.0


@dataclass
class ActorRec:
    actor_id: str
    name: Optional[str]
    fn_id: bytes
    init_spec: bytes  # packed (args, kwargs, options)
    resources: Dict[str, float]
    max_restarts: int
    restarts_used: int = 0
    incarnation: int = 0
    state: str = "pending"  # pending | alive | restarting | dead
    worker_id: Optional[str] = None
    addr: Optional[str] = None
    detached: bool = False
    max_concurrency: int = 1
    concurrency_groups: Optional[dict] = None
    method_options: Optional[dict] = None  # method name -> @method(**opts)
    death_cause: str = ""
    pg_id: Optional[str] = None
    bundle_index: int = -1
    runtime_env: Optional[dict] = None
    strategy: Optional[dict] = None  # scheduling strategy wire dict
    node_id: Optional[str] = None  # where this incarnation runs
    # drain hook: False opts this actor out of automatic drain migration —
    # a supervisor (e.g. the serve controller) owns its lifecycle and drains
    # it application-aware (replacements first, in-flight streams finish)
    # instead of the head's restart-FSM migration killing it mid-request
    drain_migration: bool = True
    # where this incarnation's resources are currently charged:
    # "pg" (bundle.used) | "node" (node.avail) | None (not charged) — guards
    # against double-crediting when a PG is removed before the actor's
    # worker-death event is processed
    charged: Optional[str] = None

    @property
    def can_restart(self) -> bool:
        """Restart budget remains (max_restarts=-1 means unlimited)."""
        return self.max_restarts != 0 and (
            self.max_restarts < 0 or self.restarts_used < self.max_restarts
        )


@dataclass
class ObjectRec:
    oid: bytes
    shm_name: Optional[str]
    size: int
    owner: str  # client id of owner process
    node_id: str = LOCAL_NODE  # node holding the primary copy
    copies: Dict[str, str] = field(default_factory=dict)  # node_id -> shm_name
    holders: set = field(default_factory=set)  # client ids holding refs
    owner_released: bool = False
    # oids of ObjectRefs serialized inside this object's payload: they are
    # held alive (holder "cnt:<oid>") for as long as this object exists
    # (borrowed-reference containment edges)
    contains: List[bytes] = field(default_factory=list)
    # ownership-plane form of the same, for containers whose owner has no
    # ledger (client mode): [oid, authority-cid-or-""] pairs whose edges
    # live at each inner object's OWN authority — released by the registry
    # when this record settles (see _release_cnt_pairs)
    cnt_pairs: Optional[list] = None
    # spill state (external_storage.py analogue): when set, the bytes live in
    # a disk file on `node_id`; pending_free is the old shm slice awaiting
    # reclaim until the last zero-copy pin drops
    spill_path: Optional[str] = None
    pending_free: Optional[str] = None
    # a ledgerless owner's device result: the address of the process that
    # holds the value; settling the record tells the owner to release it
    device_holder: Optional[str] = None


@dataclass
class LeaseReq:
    shape: Dict[str, float]
    reply: Any
    reply_err: Any
    client: str
    pg_id: Optional[str] = None
    bundle_index: int = -1
    strategy: Optional[dict] = None
    remote: bool = False  # requester is a remote client: hand out TCP addrs
    # expiry deadline for lease-plane escalation probes: a submitter that can
    # also be served by agents' delegated blocks marks its head request with a
    # ttl; the head answers {"expired": True} past the deadline instead of
    # holding it pending — so delegatable-class overflow never pins central
    # capacity reclamation (the submitter re-probes the agents and
    # re-subscribes).  None = classic request, held until grantable.
    deadline: Optional[float] = None


@dataclass
class BundleRec:
    resources: Dict[str, float]
    used: Dict[str, float] = field(default_factory=dict)
    node_id: Optional[str] = None  # assigned node (None until placed)
    labels: Optional[dict] = None  # hard label selector constraining placement


@dataclass
class PGRec:
    pg_id: str
    bundles: List[BundleRec]
    strategy: str
    state: str = "created"  # "pending" until all bundles placed, then "created"


# --------------------------------------------------------------------------


class Head:
    def __init__(self, session_dir: str, config: CAConfig, resources: Dict[str, float]):
        self.session_dir = session_dir
        self.session_name = os.path.basename(session_dir)
        self.config = config
        self.sock_path = os.path.join(session_dir, "head.sock")
        self.tcp_addr: Optional[str] = None  # filled after server start
        # -- node table (gcs_node_manager.h analogue); the head embeds n0 --
        self.nodes: Dict[str, NodeRec] = {}
        self._node_index = 0
        from .accelerators import detect_node_labels

        self._add_node(
            NodeRec(
                LOCAL_NODE, None, dict(resources), dict(resources),
                labels=detect_node_labels(LOCAL_NODE),
            )
        )
        # allocator for GPU-worker pinning; active only on multi-GPU hosts
        # (a single GPU needs no CUDA_VISIBLE_DEVICES restriction)
        n_chips = int(resources.get("GPU", 0))
        self._chip_alloc = None
        if n_chips > 1:
            from .accelerators import ChipAllocator

            self._chip_alloc = ChipAllocator(n_chips)
        # highest incarnation ever minted per node id (snapshot-persisted):
        # a rejoining node always gets a strictly larger token than any
        # verdict it may have zombied through
        self._node_incarnations: Dict[str, int] = {LOCAL_NODE: 1}
        # network-chaos plane: the spec last broadcast via `net_chaos` (new
        # registrants receive it in their register reply).  The epoch
        # travels WITH it everywhere: a spec re-anchored at each receiver's
        # install time would re-open already-healed windows (observed: a
        # healed agent re-partitioning itself out of its register reply).
        self._net_chaos_spec = ""
        self._net_chaos_epoch: Optional[float] = None
        netchaos.maybe_install_from_config(config, LOCAL_NODE)
        # -- tables --
        self.workers: Dict[str, WorkerRec] = {}
        self.actors: Dict[str, ActorRec] = {}
        self.named_actors: Dict[str, str] = {}
        self.objects: Dict[bytes, ObjectRec] = {}
        # refs reported before obj_created arrived (cross-socket ordering).
        # Bounded by an EXPLICIT grace window (config.early_ref_grace_s, the
        # same bound owner ledgers use for their pending adds): entries older
        # than the window are swept by the monitor loop instead of relying on
        # the obj_created eventually arriving — a crashed producer must not
        # pin its early refs forever.
        self._early_refs: Dict[bytes, set] = {}
        self._early_ref_ts: Dict[bytes, float] = {}
        # ownership plane: per-owner ledger digests (owner_sync deltas).
        # The head is the failover arbiter — when an owner dies, the last
        # synced digest is what it adopts (borrower sets + released flags)
        # so orphaned objects drain through the central path without leaking
        # shm segments or spill files.
        self.owner_digests: Dict[str, Dict[bytes, dict]] = {}
        self.kv: Dict[str, Dict[str, bytes]] = {}
        self.pgs: Dict[str, PGRec] = {}
        self.pending_pgs: deque = deque()  # PG ids awaiting resources, FIFO
        self._pg_waiters: Dict[str, List[asyncio.Future]] = {}
        self.pending_leases: deque[LeaseReq] = deque()
        # actors waiting for a node an autoscaler launches: id -> shape
        self._actor_demands: Dict[str, Dict[str, float]] = {}
        self._autoscaler_read_at = float("-inf")
        self.leases: Dict[str, str] = {}  # lease_id -> worker_id
        self._lease_shapes: Dict[str, Dict[str, float]] = {}
        self._lease_pg: Dict[str, tuple] = {}  # lease_id -> (pg_id, bundle_index)
        self._lease_node: Dict[str, str] = {}  # lease_id -> node_id
        self._lease_client: Dict[str, str] = {}  # lease_id -> holder client_id
        self._last_reclaim_nudge = 0.0  # debounce for lease_reclaim pushes
        self._spawn_count = 0
        # -- conns --
        self._worker_conns: Dict[str, Connection] = {}
        self._clients: Dict[str, dict] = {}  # client_id -> conn state
        self._register_waiters: Dict[str, asyncio.Future] = {}
        self.subscribers: Dict[str, List[Any]] = {}  # channel -> [writer]
        # --- HA plane (warm-standby replication / epoch-fenced authority) --
        # role FSM: standby --promote--> active --observe higher epoch-->
        # demoted.  A standby holds the replicated cluster state in memory
        # (self._ha_shadow, fed by the active head's replication stream) and
        # serves only ha_status/head_promote until it promotes; a demoted
        # head refuses everything, releases its sockets, and exits.
        self.ha_role = "standby" if os.environ.get("CA_HEAD_STANDBY") else "active"
        self.ha_rank = int(os.environ.get("CA_HEAD_STANDBY_RANK", "0") or 0)
        # monotonic authority epoch, minted at promotion and persisted next
        # to the node-incarnation table: the incarnations' "which head is
        # authoritative for this node" generalized to "which head is
        # authoritative, period".  Stamped (`hep`) on authority-bearing
        # traffic exactly like node incarnations (`ninc`).
        self.head_epoch = 1
        self._ha_observed_epoch = 0  # highest successor epoch seen (demoted)
        self._ha_restored_addr: Optional[str] = None  # own addr from snapshot
        self._repl_seq = 0
        self._repl_dirty = False
        self._repl_log: deque = deque(
            maxlen=int(getattr(config, "ha_repl_log_max", 4096))
        )
        self._repl_subs: Dict[str, dict] = {}  # standby client_id -> sub
        self._repl_table_digests: Dict[str, int] = {}
        self._repl_last_lag_event = 0.0
        # standby-side stream/apply state
        self._ha_shadow: Optional[dict] = None
        self._ha_watermark = 0
        self._ha_active_conn = None
        self._ha_active_addr: Optional[str] = None
        self._ha_last_rx = 0.0
        self._ha_loops_started = False
        self._ha_tasks: List[Any] = []
        self._ha_replog = None
        self._sock_server: Optional[Server] = None
        self.stats = {
            "leases_granted": 0,
            "tasks_pushed": 0,
            "actors_created": 0,
            "actor_restarts": 0,
            "objects_created": 0,
            "objects_gc": 0,
            "workers_spawned": 0,
            "nodes_joined": 0,
            "nodes_died": 0,
            "objects_transferred": 0,
            "oom_kills": 0,
            "lease_blocks_delegated": 0,  # worker-slots handed to agents
            "lease_blocks_returned": 0,  # slots revoked/returned to the head
            # drain plane (per-reason drain_nodes_<reason> keys appear lazily)
            "nodes_drained": 0,  # drains completed (node reached `drained`)
            "drain_actors_migrated": 0,  # actors proactively restarted off a draining node
            "drain_objects_migrated": 0,  # sole-copy primaries re-homed to survivors
            "drain_deadline_kills": 0,  # busy workers killed at the drain deadline
        }
        # draining nodes whose background evacuation pass has finished (the
        # quiesce check refuses to finalize before actors/objects are out)
        self._drain_evac_done: set = set()
        self._last_deleg_reclaim = 0.0  # debounce for block revocations
        # (node_id, wid) -> pool: block workers an agent reported that the
        # head didn't know yet (snapshotless restart, agent registered before
        # its workers).  Their re-registration adopts them straight into the
        # delegated state instead of the central idle pool — without this the
        # same worker would be grantable by BOTH planes.
        self._pending_block_adopt: Dict[Tuple[str, str], str] = {}
        # last time CENTRAL-only work (no-ttl leases, PGs) was queued:
        # delegation holds off until demand has been quiet for a beat, so
        # wave-shaped central floods (SPREAD bursts) don't lose capacity to
        # the lease blocks between waves
        self._last_central_demand = 0.0
        # per-method RPC counters (saturation diagnostics: the owner-based
        # directory and p2p collectives exist to keep hot-path traffic OFF
        # this loop — these counters are how tests/benchmarks prove it)
        from collections import defaultdict

        self.rpc_counts: Dict[str, int] = defaultdict(int)
        # p2p directory: client_id -> {addr, addr_tcp, node} for every
        # registered client that serves RPCs (workers AND drivers).  Lets a
        # borrower dial an object's owner directly (owner_locate) instead of
        # polling this loop.
        self.client_addrs: Dict[str, Dict[str, str]] = {}
        # node memory monitor (memory_monitor.h:52): the head watches its own
        # node; agents report pressure in heartbeats and the head picks the
        # victim (worker_killing_policy.h) since only it knows worker state
        self.mem_monitor = None
        if config.memory_monitor_refresh_ms > 0 and config.memory_usage_threshold > 0:
            from .memory_monitor import MemoryMonitor

            self.mem_monitor = MemoryMonitor(config.memory_usage_threshold)
        self._last_mem_check = 0.0
        self._last_dir_touch = 0.0
        self._shutdown = asyncio.Event()
        self._driver_clients: set = set()
        # observability: task-event ring buffer (GcsTaskManager analogue) and
        # aggregated user metrics (MetricsAgent analogue)
        self.task_events: deque = deque(maxlen=50_000)
        self.metrics: Dict[str, dict] = {}  # name -> {type, desc, data{tags_key: ...}}
        # flight recorder: cluster-merged journal of plane decision events.
        # Worker/agent slices arrive piggybacked on metrics_report /
        # node_sync; head-origin decisions mirror in via _log_event and the
        # head's own recorder (netchaos etc. running in this process).
        self.flightrec: deque = deque(
            maxlen=int(getattr(config, "flightrec_head_len", 50_000))
        )
        self._flightrec_on = bool(getattr(config, "flightrec_plane", True))
        if self._flightrec_on:
            from ..util import flightrec as _flightrec

            _flightrec.init(
                cap=int(getattr(config, "flightrec_ring_len", 4096)),
                node_id=LOCAL_NODE, proc="head",
            )
        # metrics plane: time-series retention (ring buffers, two downsample
        # tiers) sampled off this table + head stats by the monitor loop, so
        # dashboards/`ca top` get rates and history without Prometheus
        from ..util.timeseries import TimeSeriesStore

        ts_len = int(getattr(config, "timeseries_len", 360))
        ts_int = float(getattr(config, "timeseries_interval_s", 10.0))
        self.timeseries = None
        if ts_int > 0:
            self.timeseries = TimeSeriesStore(
                tiers=(
                    (ts_int, ts_len),
                    (ts_int * int(getattr(config, "timeseries_tier1_mult", 12)), ts_len),
                ),
                max_series=int(getattr(config, "timeseries_max_series", 1024)),
            )
        self._last_ts_sample = 0.0
        # head self-instrumentation: per-RPC-type dispatch latency and
        # inflight-handler histograms + an event-loop lag gauge, written
        # straight into the metrics table (this process has no flusher —
        # it IS the aggregator).  These series are how the dispatch
        # saturation knee (SCALE.md "Head saturation") becomes measurable
        # instead of inferred.
        self._dispatch_inflight = 0
        self._self_tags_keys: Dict[str, str] = {}  # method -> cached tags_key
        # log plane: drivers subscribed to the cluster log stream (log_sub);
        # agents' log_batch notifies and the local-node tailer fan out here.
        # Bounded by drop-not-backpressure: a subscriber whose socket buffer
        # is full loses the batch (counted), workers never block on logs.
        self._log_subs: Dict[str, Any] = {}  # client_id -> writer
        self.stats["log_lines_shipped"] = 0
        self.stats["log_lines_dropped"] = 0
        if config.log_capture:
            # the head captures its own output the same way workers do
            # (nodes/n0/head.jsonl rides the local tail loop)
            try:
                from ..util.logplane import install_capture

                install_capture(
                    session_dir, LOCAL_NODE, "head",
                    max_bytes=config.log_rotate_bytes,
                )
            except Exception:
                pass
        # structured lifecycle event log (util/event.h analogue): JSONL file
        self._event_log = open(os.path.join(session_dir, "events.jsonl"), "a", buffering=1)
        # transit tokens acked by the receiver BEFORE the sender's pin landed
        # (the two travel on different sockets): tombstones cancel the late
        # pin instead of leaking a permanent holder
        self._spent_transit: Dict[str, float] = {}
        # live transit pins: token -> (created_at, pinned oids).  Normally
        # released by the receiver's transit_done; the TTL sweep reclaims
        # pins whose reply was lost in flight (e.g. the borrower's RPC timed
        # out after the owner had already pinned and replied) — without it
        # such a pin would hold the objects for the owner's whole lifetime
        self._transit_pins: Dict[str, Tuple[float, List[bytes]]] = {}
        # tombstones of disconnected client ids (drivers/workers): lets
        # client_addr answer "dead", which borrowers use to fail fast with
        # ObjectLostError instead of polling a dead owner to their timeout
        # (OwnerDiedError role).  Bounded FIFO.
        self._departed_clients: "OrderedDict[str, None]" = OrderedDict()
        # fault tolerance (gcs_server.h StorageType analogue, file-backed):
        # debounced snapshots of the cluster tables; a restarted head loads
        # them and re-adopts live workers/agents/drivers
        self._ckpt_path = os.environ.get("CA_HEAD_CKPT") or os.path.join(
            session_dir, "head.ckpt"
        )
        self._dirty = False
        self._restored = False
        # torn-snapshot tolerance: head.ckpt is written via tmp+rename and
        # rotated to .bak first, so a corrupt/missing primary (kill -9 inside
        # _save_snapshot, disk fault) falls back to the previous good one.
        # Standbys skip this — their state comes from the replication stream
        # (plus their own journal), never from the active head's snapshot.
        if self.ha_role == "active":
            for path in (self._ckpt_path, self._ckpt_path + ".bak"):
                if not os.path.exists(path):
                    continue
                try:
                    self._load_snapshot(path)
                    self._restored = True
                    if path != self._ckpt_path:
                        self._log_event("snapshot_fallback_bak", path=path)
                    break
                except Exception as e:
                    self._log_event(
                        "snapshot_load_failed", path=path, error=repr(e)
                    )
        # pull-side file maps for serving n0's object chunks
        self._pull_maps: Dict[str, Any] = {}
        # listener — constructed AFTER the snapshot load so a restored
        # `ha.tcp_addr` can pin the port.  An active head rebinds the SAME
        # tcp port (agents/remote workers reconnect to the address they were
        # given), preferring its own persisted addr over the head.addr file,
        # which a successor head may have claimed since (failover); a
        # standby binds an ephemeral port and its own rank-suffixed socket.
        host = getattr(config, "head_host", "127.0.0.1")
        port = 0
        # deferred-socket restart: when head.addr names a DIFFERENT head than
        # the one this snapshot belonged to, a successor may own the session
        # unix socket — don't bind (or unlink!) head.sock until the boot
        # probe proves this head is still authoritative
        self._ha_sock_deferred = False
        if self.ha_role == "active":
            cur = ""
            try:
                cur = open(os.path.join(session_dir, "head.addr")).read().strip()
            except OSError:
                pass
            prev = self._ha_restored_addr or cur
            if prev.startswith("tcp:"):
                try:
                    port = int(prev.rpartition(":")[2])
                except ValueError:
                    port = 0
            if (
                self._restored and cur and prev and cur != prev
                and bool(getattr(config, "ha_boot_probe", True))
            ):
                self._ha_sock_deferred = True
        else:
            self.sock_path = os.path.join(
                session_dir, f"head.standby{self.ha_rank}.sock"
            )
        addrs = (
            [f"tcp:{host}:{port}"]
            if self._ha_sock_deferred
            else [self.sock_path, f"tcp:{host}:{port}"]
        )
        self.server = Server(addrs, self._handle, self._on_disconnect)

    def _add_node(self, node: NodeRec) -> NodeRec:
        node.index = self._node_index
        self._node_index += 1
        node.max_workers = int(node.total.get("CPU", 4)) * 4 + 4
        self.nodes[node.node_id] = node
        return node

    @property
    def local_node(self) -> NodeRec:
        return self.nodes[LOCAL_NODE]

    def _alive_nodes(self) -> List[NodeRec]:
        """SCHEDULABLE nodes: draining nodes are excluded — nothing new is
        placed on capacity that is announced to be leaving."""
        return [n for n in self.nodes.values() if n.state == "alive"]

    def _up_nodes(self) -> List[NodeRec]:
        return [n for n in self.nodes.values() if n.up]

    def _node_views(self, nodes: Optional[List[NodeRec]] = None) -> List[scheduling.NodeView]:
        return [
            scheduling.NodeView(n.node_id, n.total, n.avail, n.index, labels=n.labels)
            for n in (nodes if nodes is not None else self._alive_nodes())
        ]

    def _agg_total(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self._alive_nodes():
            for k, v in n.total.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def _agg_avail(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self._alive_nodes():
            for k, v in n.avail.items():
                out[k] = out.get(k, 0.0) + v
        return out

    # ------------------------------------------------------ fault tolerance
    def _snapshot_state(self) -> dict:
        """The cluster tables as one plain dict — the unit of persistence
        (snapshot file) AND of replication (full transfers / table deltas to
        warm standbys all serialize the same tables)."""
        state = {
            "nodes": [
                {
                    "node_id": n.node_id, "addr": n.addr, "total": n.total,
                    "avail": n.avail, "index": n.index, "state": n.state,
                    "pid": n.pid, "labels": n.labels,
                    "incarnation": n.incarnation,
                    "drain_reason": n.drain_reason,
                    # monotonic deadlines don't survive a restart: persist
                    # the remaining window and re-anchor it at load
                    "drain_in": (
                        max(0.0, n.drain_deadline - time.monotonic())
                        if n.state == "draining"
                        else 0.0
                    ),
                    # delegated lease blocks survive a head restart: avail
                    # already carries their unit charges, so membership must
                    # be restored with it or the accounting desyncs
                    "delegated": {p: sorted(w) for p, w in n.delegated.items() if w},
                }
                for n in self.nodes.values()
            ],
            "node_index": self._node_index,
            "workers": [
                {
                    "worker_id": w.worker_id, "pid": w.pid, "addr": w.addr,
                    "addr_tcp": w.addr_tcp,
                    "node_id": w.node_id, "state": w.state, "purpose": w.purpose,
                    "pool": w.pool, "lease_id": w.lease_id, "actor_id": w.actor_id,
                }
                for w in self.workers.values()
                if w.state != "dead"
            ],
            "spawn_count": self._spawn_count,
            "actors": [
                {
                    "actor_id": a.actor_id, "name": a.name, "fn_id": a.fn_id,
                    "init_spec": a.init_spec, "resources": a.resources,
                    "max_restarts": a.max_restarts, "restarts_used": a.restarts_used,
                    "incarnation": a.incarnation, "state": a.state,
                    "worker_id": a.worker_id, "addr": a.addr, "detached": a.detached,
                    "max_concurrency": a.max_concurrency,
                    "concurrency_groups": a.concurrency_groups,
                    "method_options": a.method_options,
                    "death_cause": a.death_cause,
                    "pg_id": a.pg_id, "bundle_index": a.bundle_index,
                    "runtime_env": a.runtime_env, "strategy": a.strategy,
                    "node_id": a.node_id, "charged": a.charged,
                    "drain_migration": a.drain_migration,
                }
                for a in self.actors.values()
            ],
            "named_actors": self.named_actors,
            "departed_clients": list(self._departed_clients),
            "kv": self.kv,
            "pgs": [
                {
                    "pg_id": p.pg_id, "strategy": p.strategy, "state": p.state,
                    "bundles": [
                        {
                            "resources": b.resources, "used": b.used,
                            "node_id": b.node_id, "labels": b.labels,
                        }
                        for b in p.bundles
                    ],
                }
                for p in self.pgs.values()
            ],
            "pending_pgs": list(self.pending_pgs),
            "node_incarnations": self._node_incarnations,
            "objects": [
                {
                    "oid": r.oid, "shm_name": r.shm_name, "size": r.size,
                    "owner": r.owner, "node_id": r.node_id, "copies": r.copies,
                    "holders": list(r.holders), "owner_released": r.owner_released,
                    "contains": r.contains, "cnt_pairs": r.cnt_pairs,
                    "spill_path": r.spill_path,
                    "pending_free": r.pending_free,
                    "device_holder": r.device_holder,
                }
                for r in self.objects.values()
            ],
            "leases": self.leases,
            "lease_shapes": self._lease_shapes,
            "lease_pg": {k: list(v) for k, v in self._lease_pg.items()},
            "lease_node": self._lease_node,
            "stats": self.stats,
            # ownership plane: owners whose death lands in the restart
            # window must still be adoptable from their last synced digest
            "owner_digests": [
                [cid, [[oid, info] for oid, info in d.items()]]
                for cid, d in self.owner_digests.items()
            ],
            # HA plane: the authority epoch rides the snapshot next to the
            # node-incarnation table, plus our own tcp addr so a restarted
            # head rebinds ITS port (not a successor's from head.addr)
            "ha": {
                "epoch": self.head_epoch,
                "tcp_addr": self.tcp_addr or self._ha_restored_addr or "",
            },
        }
        return state

    def _save_snapshot(self):
        """Atomically persist the cluster tables (kill -9 of the head must
        not lose actors/PGs/KV/object locations; gcs_table_storage.h role)."""
        import msgpack

        blob = msgpack.packb(self._snapshot_state(), use_bin_type=True)
        tmp = self._ckpt_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        # keep the previous snapshot as .bak before the atomic swap: a head
        # killed mid-save leaves at worst a torn .tmp (ignored) — and even a
        # torn/corrupted head.ckpt (operator error, disk fault) still
        # restarts from the last good state instead of empty tables
        try:
            os.replace(self._ckpt_path, self._ckpt_path + ".bak")
        except FileNotFoundError:
            pass
        os.replace(tmp, self._ckpt_path)

    def _load_snapshot(self, path: Optional[str] = None):
        import msgpack

        with open(path or self._ckpt_path, "rb") as f:
            state = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
        self._load_state(state)

    def _load_state(self, state: dict):
        """Adopt a full cluster-state dict (_snapshot_state schema) — shared
        by snapshot restore and standby promotion (the replicated shadow)."""
        now = time.monotonic()
        for cid in state.get("departed_clients") or []:
            self._departed_clients[cid] = None
        self.nodes = {}
        for n in state["nodes"]:
            rec = NodeRec(
                n["node_id"], n["addr"], n["total"], n["avail"],
                index=n["index"], state=n["state"], pid=n["pid"],
                labels=n.get("labels") or {},
                incarnation=int(n.get("incarnation") or 1),
            )
            rec.drain_reason = n.get("drain_reason") or ""
            if rec.state == "draining":
                rec.drain_deadline = now + float(n.get("drain_in") or 0.0)
            rec.delegated = {
                p: set(w) for p, w in (n.get("delegated") or {}).items()
            }
            rec.max_workers = int(rec.total.get("CPU", 4)) * 4 + 4
            rec.last_heartbeat = now  # grace: agents get time to reconnect
            self.nodes[rec.node_id] = rec
        self._node_index = state["node_index"]
        self._spawn_count = state["spawn_count"]
        for w in state["workers"]:
            rec = WorkerRec(
                w["worker_id"], w["pid"], w["addr"], node_id=w["node_id"],
                purpose=w["purpose"], pool=w["pool"],
            )
            rec.addr_tcp = w.get("addr_tcp")
            rec.state = w["state"]
            rec.lease_id = w["lease_id"]
            rec.actor_id = w["actor_id"]
            rec.last_heartbeat = now
            self.workers[rec.worker_id] = rec
            if rec.state == "idle":
                node = self.nodes.get(rec.node_id)
                if node is not None and node.state == "alive":
                    node.idle[rec.pool].append(rec.worker_id)
        for a in state["actors"]:
            self.actors[a["actor_id"]] = ActorRec(**a)
        self.named_actors = state["named_actors"]
        self.kv = state["kv"]
        for p in state["pgs"]:
            self.pgs[p["pg_id"]] = PGRec(
                pg_id=p["pg_id"], strategy=p["strategy"], state=p["state"],
                bundles=[BundleRec(**b) for b in p["bundles"]],
            )
        self.pending_pgs = deque(state["pending_pgs"])
        for nid, inc in (state.get("node_incarnations") or {}).items():
            self._node_incarnations[nid] = max(
                int(inc), self._node_incarnations.get(nid, 0)
            )
        for r in state["objects"]:
            rec = ObjectRec(
                oid=r["oid"], shm_name=r["shm_name"], size=r["size"],
                owner=r["owner"], node_id=r["node_id"], copies=r["copies"],
                owner_released=r["owner_released"], contains=r["contains"],
                cnt_pairs=r.get("cnt_pairs"),
                spill_path=r.get("spill_path"), pending_free=r.get("pending_free"),
                device_holder=r.get("device_holder"),
            )
            rec.holders = set(r["holders"])
            self.objects[rec.oid] = rec
        self.leases = state["leases"]
        self._lease_shapes = state["lease_shapes"]
        self._lease_pg = {k: tuple(v) for k, v in state["lease_pg"].items()}
        self._lease_node = state["lease_node"]
        self.stats.update(state["stats"])
        for cid, entries in state.get("owner_digests") or ():
            self.owner_digests[cid] = {bytes(oid): info for oid, info in entries}
        ha = state.get("ha") or {}
        self.head_epoch = max(self.head_epoch, int(ha.get("epoch") or 1))
        self._ha_restored_addr = ha.get("tcp_addr") or None

    async def _persist_loop(self):
        """Debounced snapshot writer: at most one disk write per interval.
        Doubles as the lease-contention re-nudge tick: while requests are
        still queued, keep hinting holders to shed idle leases (the arrival-
        time nudge alone misses holders whose leases go idle later)."""
        while not self._shutdown.is_set():
            await asyncio.sleep(0.25)
            if self.ha_role == "demoted":
                # a fenced zombie must not clobber the successor's snapshot
                # or keep streaming stale deltas
                continue
            if self.pending_leases:
                self._last_reclaim_nudge = 0.0  # bypass the debounce
                self._nudge_lease_holders(requester="")
                self._expire_lease_requests()
            if self._needs_reclaim():
                # central work starved while capacity sits in agents' lease
                # blocks: revoke the unleased slots (reclaim arbiter role)
                self._last_central_demand = time.monotonic()
                self._reclaim_delegations()
            if self._repl_subs:
                self._repl_tick()
            if self._dirty:
                self._dirty = False
                try:
                    self._save_snapshot()
                except Exception as e:
                    self._log_event("snapshot_save_failed", error=repr(e))

    # head event kind -> flight-recorder plane (prefix match, first wins);
    # unmatched kinds file under "head"
    _FLIGHTREC_PLANES = (
        ("ha_", "ha"),
        ("rpc_fenced", "fence"),
        ("agent_register_fenced", "fence"),
        ("node_readopted", "fence"),
        ("net_chaos", "chaos"),
        ("drain", "drain"),
        ("node_drain", "drain"),
        ("object_lost", "ownership"),
        ("owners_adopted", "ownership"),
        ("owner", "ownership"),
        ("actor", "actor"),
        ("node", "node"),
        ("serve", "serve"),
        ("train", "train"),
        ("job", "job"),
    )

    def _log_event(self, kind: str, **fields):
        import json as _json

        ts = time.time()
        if self._flightrec_on:
            # mirror into the merged journal: head decisions and shipped
            # worker slices interleave in one queryable ring
            plane = "head"
            for prefix, p in self._FLIGHTREC_PLANES:
                if kind.startswith(prefix):
                    plane = p
                    break
            self.flightrec.append(
                {"ts": ts, "plane": plane, "event": kind, "node": LOCAL_NODE,
                 "proc": "head", **fields}
            )
        try:
            self._event_log.write(
                _json.dumps({"ts": ts, "event": kind, **fields}) + "\n"
            )
        except Exception:
            pass

    def _ingest_flightrec(self, evs) -> None:
        """Merge a shipped journal slice (metrics_report / node_sync
        piggyback) into the cluster ring.  Slices from different nodes
        interleave by arrival; queries sort by timestamp."""
        if not evs or not self._flightrec_on:
            return
        for ev in evs:
            if isinstance(ev, dict):
                self.flightrec.append(ev)

    # ------------------------------------------------------------- HA plane
    # Warm-standby replication + epoch-fenced promotion.  The active head
    # streams its registry mutations — the same tables _snapshot_state
    # serializes — to subscribed standbys over a versioned record stream
    # (the DeltaReporter idiom from core/ownership.py, head-scale): per-table
    # deltas ride the persist tick, KV commits replicate SYNCHRONOUSLY
    # before their reply (acked == survives head death), and a bounded
    # in-memory log re-stages records for standbys that reconnect with a
    # watermark.  Authority is the monotonic head epoch; see _handle's gate.

    _HA_PASSIVE_METHODS = frozenset({"ha_status", "head_promote"})

    def _ha_standby_addrs(self) -> List[str]:
        return sorted(
            {s["addr"] for s in self._repl_subs.values() if s.get("addr")}
        )

    def _ha_ring_broadcast(self) -> None:
        """Push the current standby ring + head epoch to every connected
        agent.  Register replies already carry both, but an agent that
        joined BEFORE a standby subscribed would otherwise never learn the
        successor's address — and a one-head ring means no failover."""
        standbys = self._ha_standby_addrs()
        for node in list(self.nodes.values()):
            if node.state == "dead" or node.conn is None:
                continue
            try:
                node.conn.notify(
                    "ha_ring", standbys=standbys, head_epoch=self.head_epoch,
                )
            except Exception:
                pass
        frame = {"m": "ha_ring", "standbys": standbys,
                 "head_epoch": self.head_epoch}
        for cid, state in list(self._clients.items()):
            if cid in self._repl_subs:
                continue  # the standby already knows the ring (it IS in it)
            try:
                write_frame(state["writer"], frame)
            except Exception:
                pass

    def _ha_status_dict(self) -> dict:
        lag = 0
        if self._repl_subs:
            lag = self._repl_seq - min(s["acked"] for s in self._repl_subs.values())
        return {
            "role": self.ha_role,
            "epoch": self.head_epoch,
            "rank": self.ha_rank,
            "seq": self._repl_seq,
            "watermark": self._ha_watermark,
            "addr": self.tcp_addr,
            "active_addr": self._ha_active_addr,
            "repl_lag": lag,
            "standbys": [
                {"addr": s.get("addr"), "rank": s.get("rank", 0),
                 "acked": s["acked"], "lag": self._repl_seq - s["acked"]}
                for s in self._repl_subs.values()
            ],
            "promotions": self.stats.get("ha_promotions", 0),
            "demotions": self.stats.get("ha_demotions", 0),
        }

    async def _h_ha_status(self, state, msg, reply, reply_err):
        reply(**self._ha_status_dict())

    def _ha_refuse(self, state, msg, reply_err, stale_client: bool = False) -> None:
        """Refuse an RPC this head has no authority to execute (standby or
        demoted role, or a client stamped with a superseded head epoch).

        Deliberately NOT a FencedError: that error (and the `fenced` push)
        tells a worker ITS node was declared dead, making it cancel leases
        and exit — wrong when the HEAD is the stale party.  A plain
        ConnectionError + closed socket sends the client back through its
        redial ring, where the register reply teaches it the real epoch."""
        self.stats["ha_refused_rpcs"] = self.stats.get("ha_refused_rpcs", 0) + 1
        if msg.get("i") is not None:
            if self.ha_role == "standby":
                reply_err(ConnectionError(
                    f"standby head (rank {self.ha_rank}) is not active; "
                    f"active head: {self._ha_active_addr or 'unknown'}"
                ))
            else:
                reply_err(ConnectionError(
                    f"head epoch {self.head_epoch} is no longer "
                    f"authoritative (successor epoch "
                    f"{self._ha_observed_epoch or '>' + str(self.head_epoch)})"
                    if self.ha_role == "demoted"
                    else f"request stamped with a superseded head epoch "
                         f"(current: {self.head_epoch}); re-register"
                ))
        if self.ha_role == "demoted" or stale_client:
            try:
                fence_close(state["writer"])
            except Exception:
                pass

    # -- active side: record stream --------------------------------------
    async def _h_head_replicate(self, state, msg, reply, reply_err):
        """A standby subscribes to the replication stream.  Records then
        flow as `repl` push frames on this connection — one ordered stream,
        so a table delta can never overtake a KV record it already
        contains.  Re-subscribes send their durable watermark: inside the
        re-stage window they get just the gap, otherwise a full transfer."""
        peer_epoch = int(msg.get("hepoch") or 0)
        if peer_epoch > self.head_epoch:
            # the subscriber outranks us — it was promoted while we were
            # away.  Demote; the FencedError marks this as an authority
            # verdict (the one case a head fences a head).
            self._ha_demote(peer_epoch, via="head_replicate")
            reply_err(FencedError(
                f"head epoch {self.head_epoch} superseded by promoted "
                f"standby at epoch {peer_epoch}"
            ))
            return
        cid = (msg.get("client_id") or state.get("client_id")
               or f"standby@{msg.get('addr') or id(state)}")
        state["client_id"] = cid
        self._clients[cid] = state
        sub = {
            "writer": state["writer"],
            "addr": msg.get("addr") or "",
            "rank": int(msg.get("rank") or 0),
            "acked": int(msg.get("watermark") or 0),
            "event": asyncio.Event(),
        }
        self._repl_subs[cid] = sub
        self._repl_table_digests.clear()  # next delta tick re-baselines
        self._log_event(
            "ha_standby_sub", addr=sub["addr"], rank=sub["rank"],
            watermark=sub["acked"], seq=self._repl_seq,
        )
        self._ha_ring_broadcast()
        reply(epoch=self.head_epoch, seq=self._repl_seq)
        watermark = sub["acked"]
        base = self._repl_log[0][0] if self._repl_log else self._repl_seq + 1
        if watermark and watermark + 1 >= base and watermark <= self._repl_seq:
            # bounded re-stage: replay only the records past the standby's
            # durable watermark (all still in the in-memory window)
            for seq, rec in list(self._repl_log):
                if seq > watermark:
                    self._repl_push(cid, sub, rec)
        else:
            # fresh standby, or a watermark older than the window: full
            # state transfer supersedes whatever it holds
            import msgpack

            blob = msgpack.packb(self._snapshot_state(), use_bin_type=True)
            sub["acked"] = 0
            self._repl_push(
                cid, sub,
                {"t": "full", "seq": self._repl_seq, "state": blob,
                 "epoch": self.head_epoch},
            )

    async def _h_head_replicate_ack(self, state, msg, reply, reply_err):
        sub = self._repl_subs.get(state.get("client_id") or "")
        if sub is not None:
            sub["acked"] = max(sub["acked"], int(msg.get("seq") or 0))
            sub["event"].set()

    def _repl_push(self, cid: str, sub: dict, rec: dict) -> None:
        try:
            # push stream consumed by _ha_on_repl_push on the standby:
            # ca-lint: ignore[rpc-unknown-method]
            write_frame(sub["writer"], {"m": "repl", **rec})
        except Exception:
            self._repl_drop_sub(cid, "write_failed")

    def _repl_send(self, rec: dict) -> None:
        """Append to the bounded re-stage log and push to every standby."""
        self._repl_log.append((rec["seq"], rec))
        self.stats["ha_records_streamed"] = (
            self.stats.get("ha_records_streamed", 0) + 1
        )
        for cid, sub in list(self._repl_subs.items()):
            self._repl_push(cid, sub, rec)

    def _repl_drop_sub(self, cid: str, reason: str) -> None:
        sub = self._repl_subs.pop(cid, None)
        if sub is None:
            return
        sub["event"].set()  # wake any sync commit waiting on this replica
        self.stats["ha_standbys_lost"] = (
            self.stats.get("ha_standbys_lost", 0) + 1
        )
        self._log_event("ha_standby_lost", addr=sub.get("addr"), reason=reason)
        self._ha_ring_broadcast()

    async def _repl_commit(self, rec: dict) -> None:
        """Synchronously replicate one record: return once every live
        standby acked it (applied in memory AND journaled) or got dropped
        at the timeout (availability over sync once a replica is gone).
        The caller's reply is the client-visible ack, so this is what makes
        'acked' mean 'survives head death'."""
        self._repl_seq += 1
        rec = {**rec, "seq": self._repl_seq, "epoch": self.head_epoch}
        self._repl_send(rec)
        self.stats["ha_sync_commits"] = self.stats.get("ha_sync_commits", 0) + 1
        loop = asyncio.get_running_loop()
        deadline = loop.time() + float(
            getattr(self.config, "ha_sync_commit_timeout_s", 2.0)
        )
        for cid in list(self._repl_subs):
            while True:
                sub = self._repl_subs.get(cid)
                if sub is None or sub["acked"] >= rec["seq"]:
                    break
                remaining = deadline - loop.time()
                if remaining <= 0:
                    self.stats["ha_sync_commit_timeouts"] = (
                        self.stats.get("ha_sync_commit_timeouts", 0) + 1
                    )
                    self._repl_drop_sub(cid, "sync_commit_timeout")
                    break
                sub["event"].clear()
                try:
                    # asyncio.Event.wait (coroutine), awaited via wait_for:
                    # ca-lint: ignore[async-blocking-call]
                    await asyncio.wait_for(sub["event"].wait(), remaining)
                except asyncio.TimeoutError:
                    pass

    def _repl_tick(self) -> None:
        """Table-delta replication (rides the persist loop): serialize the
        snapshot tables and stream only those whose bytes changed since the
        last tick.  A no-op tick degrades to a bare heartbeat so standbys
        can tell a quiet head from a dead one."""
        import zlib as _zlib

        import msgpack

        if self._repl_dirty:
            self._repl_dirty = False
            changed = {}
            for name, val in self._snapshot_state().items():
                blob = msgpack.packb(val, use_bin_type=True)
                digest = _zlib.crc32(blob)
                if self._repl_table_digests.get(name) != digest:
                    self._repl_table_digests[name] = digest
                    changed[name] = blob
            if changed:
                self._repl_seq += 1
                self._repl_send(
                    {"t": "tables", "seq": self._repl_seq,
                     "tables": changed, "epoch": self.head_epoch}
                )
                return
        self._repl_send(
            {"t": "hb", "seq": self._repl_seq, "epoch": self.head_epoch}
        )

    # -- standby side: subscribe/apply loop ------------------------------
    async def _ha_standby_loop(self):
        """Standby FSM: recover the local journal, subscribe to the active
        head with the durable watermark, apply pushed records, and promote
        when the active head stays unreachable past the grace window
        (rank-staggered so replicas never race for the epoch)."""
        from ..util import replog
        from ..util.aio import dial

        path = os.path.join(
            self.session_dir, f"head.standby{self.ha_rank}.replog"
        )
        records, torn = replog.recover(path)
        if torn:
            self._log_event("ha_repl_torn_tail", path=path, intact=len(records))
        self._ha_shadow, self._ha_watermark = replog.replay(records)
        self._ha_replog = replog.ReplLogWriter(path)
        addrs = [
            a for a in (os.environ.get("CA_HEAD_ADDR") or "").split(",") if a
        ]
        grace = float(getattr(self.config, "ha_failover_grace_s", 2.0))
        grace *= 1.0 + self.ha_rank  # rank stagger
        auto = bool(getattr(self.config, "ha_auto_promote", True))
        from .worker import _redial_backoff

        down_since: Optional[float] = None
        attempt = 0
        while not self._shutdown.is_set() and self.ha_role == "standby":
            loop = asyncio.get_running_loop()
            now = loop.time()
            conn = self._ha_active_conn
            if conn is not None and not conn.closed:
                if now - self._ha_last_rx > max(grace, 2.0):
                    # socket open but the stream went silent (partitioned
                    # or wedged active): treat as down and redial
                    await conn.close()
                else:
                    down_since = None
                    attempt = 0
                    await asyncio.sleep(0.1)
                    continue
            self._ha_active_conn = None
            if down_since is None:
                down_since = now
            for addr in addrs:
                try:
                    conn = await dial(
                        addr, purpose="head (standby sync)",
                        timeout=min(2.0, self.config.dial_timeout_s),
                    )
                except asyncio.CancelledError:
                    raise
                except Exception:
                    continue
                conn.set_push_handler(self._ha_on_repl_push)
                # assigned before the subscribe call: replayed records can
                # arrive on this conn before call() returns, and the push
                # handler acks through _ha_active_conn
                self._ha_active_conn = conn
                self._ha_last_rx = loop.time()
                try:
                    r = await conn.call(
                        "head_replicate",
                        client_id=f"standby-{self.ha_rank}-{os.getpid()}",
                        addr=self.tcp_addr, rank=self.ha_rank,
                        watermark=self._ha_watermark,
                        hepoch=self.head_epoch, timeout=5,
                    )
                except asyncio.CancelledError:
                    raise
                except Exception:
                    self._ha_active_conn = None
                    try:
                        await conn.close()
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        pass
                    continue
                self.head_epoch = max(self.head_epoch, int(r.get("epoch") or 1))
                self._ha_active_addr = addr
                down_since = None
                attempt = 0
                self._log_event(
                    "ha_standby_synced", active=addr, epoch=self.head_epoch,
                    watermark=self._ha_watermark,
                )
                break
            if self._ha_active_conn is not None:
                continue
            now = loop.time()
            if auto and down_since is not None and now - down_since > grace:
                await self._ha_promote(reason="active head unreachable")
                return
            attempt += 1
            await asyncio.sleep(min(_redial_backoff(attempt), 0.5))

    async def _ha_on_repl_push(self, msg):
        if msg.get("m") != "repl":
            return
        loop = asyncio.get_running_loop()
        self._ha_last_rx = loop.time()
        ep = int(msg.get("epoch") or 0)
        if ep > self.head_epoch:
            self.head_epoch = ep
        t = msg.get("t")
        if t == "hb":
            return
        seq = int(msg.get("seq") or 0)
        if t != "full" and seq <= self._ha_watermark:
            return  # re-stage overlap: already applied and journaled
        from ..util import replog

        rec = {k: v for k, v in msg.items() if k != "m"}
        try:
            self._ha_shadow = replog.apply_record(self._ha_shadow, rec)
        except Exception as e:
            # never ack a record we could not apply: drop the stream and
            # resubscribe from the durable watermark instead
            self._log_event("ha_apply_failed", seq=seq, error=repr(e))
            conn = self._ha_active_conn
            if conn is not None:
                await conn.close()
            return
        if self._ha_replog is not None:
            try:
                if t == "full":
                    self._ha_replog.reset()  # full state supersedes history
                self._ha_replog.append(rec)
            except OSError:
                pass
        self._ha_watermark = seq
        conn = self._ha_active_conn
        if conn is not None and not conn.closed:
            try:
                conn.notify("head_replicate_ack", seq=seq)
            except Exception:
                pass

    # -- role transitions --------------------------------------------------
    async def _ha_promote(self, reason: str) -> dict:
        """Standby -> active: adopt the replicated state, mint the successor
        epoch, claim the session discovery files (head.addr / head.sock /
        head.ready), and start the active-only loops."""
        if self.ha_role == "active":
            return self._ha_status_dict()
        if self.ha_role == "demoted":
            raise RuntimeError("demoted head cannot promote")
        if self._ha_shadow is not None:
            self._load_state(self._ha_shadow)  # maxes head_epoch with ha.epoch
        self.head_epoch += 1  # the successor epoch: strictly above anything seen
        self.ha_role = "active"
        self._restored = True  # suppress prestart; re-adopt live survivors
        self.stats["ha_promotions"] = self.stats.get("ha_promotions", 0) + 1
        conn, self._ha_active_conn = self._ha_active_conn, None
        if conn is not None and not conn.closed:
            try:
                await conn.close()
            except asyncio.CancelledError:
                raise
            except Exception:
                pass
        # re-anchor liveness: the restored tables carry the OLD head's view;
        # survivors get the same reconnect grace a snapshot restart gives
        now = time.monotonic()
        for node in self.nodes.values():
            node.last_heartbeat = now
        for w in self.workers.values():
            w.last_heartbeat = now
        # claim the discovery files: session-dir drivers and head.addr
        # readers now find THIS head
        sock = os.path.join(self.session_dir, "head.sock")
        try:
            os.unlink(sock)
        except OSError:
            pass
        try:
            self._sock_server = Server([sock], self._handle, self._on_disconnect)
            await self._sock_server.start()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._log_event("ha_promote_sock_failed", error=repr(e))
            self._sock_server = None
        addr_file = os.path.join(self.session_dir, "head.addr")
        with open(addr_file + ".tmp", "w") as f:
            f.write(self.tcp_addr or "")
        os.replace(addr_file + ".tmp", addr_file)
        ready = os.path.join(self.session_dir, "head.ready")
        with open(ready + ".tmp", "w") as f:
            f.write(str(os.getpid()))
        os.replace(ready + ".tmp", ready)
        self._ckpt_path = os.path.join(self.session_dir, "head.ckpt")
        self._dirty = True
        try:
            self._save_snapshot()
        except Exception as e:
            self._log_event("snapshot_save_failed", error=repr(e))
        self._ha_start_active_loops()
        self._log_event(
            "ha_promote", epoch=self.head_epoch, reason=reason,
            watermark=self._ha_watermark, nodes=len(self.nodes),
            workers=len(self.workers),
        )
        return self._ha_status_dict()

    async def _h_head_promote(self, state, msg, reply, reply_err):
        try:
            reply(**(await self._ha_promote(reason=msg.get("reason") or "rpc")))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            reply_err(e)

    def _ha_demote(self, observed: Optional[int], via: str) -> None:
        """Active -> demoted: a successor epoch exists, so every table here
        is a zombie's view.  Stop persisting/streaming, drop all clients so
        nothing keeps talking to this registry, and exit shortly — the
        successor owns the workers and the shm namespace now."""
        if self.ha_role == "demoted":
            return
        was = self.ha_role
        self.ha_role = "demoted"
        if observed:
            self._ha_observed_epoch = max(self._ha_observed_epoch, observed)
        self.stats["ha_demotions"] = self.stats.get("ha_demotions", 0) + 1
        self._log_event(
            "ha_demote", epoch=self.head_epoch,
            observed=observed or self._ha_observed_epoch, via=via, was=was,
        )
        for st in list(self._clients.values()):
            try:
                fence_close(st["writer"])
            except Exception:
                pass
        spawn_bg(self._ha_demote_exit())

    async def _ha_demote_exit(self):
        # small grace so refusal replies flush before the process exits
        await asyncio.sleep(0.5)
        self._shutdown.set()

    async def _ha_boot_probe(self) -> bool:
        """A restarting head checks whether head.addr now names a DIFFERENT
        live head before claiming authority: if that head answers with an
        epoch >= ours, THIS process is the stale one — demote at boot
        instead of split-braining the registry.  True = demoted."""
        if not bool(getattr(self.config, "ha_boot_probe", True)):
            return False
        try:
            other = open(
                os.path.join(self.session_dir, "head.addr")
            ).read().strip()
        except OSError:
            return False
        if not other or other == self.tcp_addr:
            return False
        from ..util.aio import dial

        from ..util.aio import finally_await

        try:
            conn = await dial(other, purpose="head (boot probe)", timeout=2.0)
        except asyncio.CancelledError:
            raise
        except Exception:
            return False  # unreachable: nothing live to defer to
        try:
            st = await conn.call("ha_status", timeout=2.0)
        except asyncio.CancelledError:
            raise
        except Exception:
            return False
        finally:
            await finally_await(conn.close(), "boot-probe close")
        ep = int(st.get("epoch") or 0)
        if st.get("role") == "active" and ep >= self.head_epoch:
            self._ha_demote(ep, via="boot_probe")
            return True
        return False

    def _ha_start_active_loops(self) -> None:
        from ..util.aio import spawn_logged

        if self._ha_loops_started:
            return
        self._ha_loops_started = True
        self._ha_tasks = [
            spawn_logged(self._monitor_loop(), "head-monitor"),
            spawn_logged(self._persist_loop(), "head-persist"),
            spawn_logged(self._log_tail_loop(), "head-log-tail"),
            spawn_logged(self._loop_lag_loop(), "head-loop-lag"),
        ]

    # ---------------------------------------------------------------- utils
    def _pub(self, channel: str, data: dict):
        dead = []
        for w in self.subscribers.get(channel, []):
            try:
                write_frame(w, {"m": "pub", "ch": channel, "data": data})
            except Exception:
                dead.append(w)
        for w in dead:
            self.subscribers[channel].remove(w)

    def _fits(self, avail: Dict[str, float], shape: Dict[str, float]) -> bool:
        return scheduling.fits(avail, shape)

    def _take(self, avail: Dict[str, float], shape: Dict[str, float]):
        for k, v in shape.items():
            avail[k] = avail.get(k, 0.0) - v

    def _give(self, avail: Dict[str, float], shape: Dict[str, float]):
        for k, v in shape.items():
            avail[k] = avail.get(k, 0.0) + v

    # ------------------------------------------------------------ worker pool
    def _new_wid(self) -> str:
        self._spawn_count += 1
        return f"w{self._spawn_count:04d}"

    def _spawn_worker(self, purpose: str = "pool", pool: str = "cpu") -> WorkerRec:
        """Spawn a worker process on the local (head-embedded) node."""
        wid = self._new_wid()
        addr = os.path.join(self.session_dir, f"{wid}.sock")
        log_path = os.path.join(self.session_dir, f"{wid}.log")
        env = dict(os.environ)
        env["CA_SESSION_DIR"] = self.session_dir
        env["CA_HEAD_SOCK"] = self.sock_path
        env["CA_WORKER_ID"] = wid
        env["CA_WORKER_SOCK"] = addr
        env["CA_NODE_ID"] = LOCAL_NODE
        env["CA_CONFIG_JSON"] = self.config.to_json()
        if pool != "gpu":
            # CPU workers must not grab the card: with no visible device,
            # user code that imports torch opens no CUDA context on it
            env["CUDA_VISIBLE_DEVICES"] = ""
        chip = None
        if pool == "gpu" and self._chip_alloc is not None:
            # pin each GPU worker to one GPU (set_current_process_visible_
            # accelerator_ids analogue) so concurrent workers don't fight
            # over the device; single-GPU hosts leave the env untouched
            from . import accelerators

            chip = self._chip_alloc.acquire()
            env.update(accelerators.visible_chips_env_for_worker(chip))
        logf = open(log_path, "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "cluster_anywhere_tpu_torch.core.workerproc"],
            env=env,
            stdout=logf,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        logf.close()
        rec = WorkerRec(
            worker_id=wid, pid=proc.pid, addr=addr, proc=proc, purpose=purpose, pool=pool,
            gpu_id=chip,
        )
        self.workers[wid] = rec
        self.stats["workers_spawned"] += 1
        return rec

    def _spawn_worker_on(self, node: NodeRec, purpose: str = "pool", pool: str = "cpu") -> WorkerRec:
        """Spawn a worker on any node: directly for the local node, via the
        node agent RPC otherwise (the agent is the raylet-analogue process
        that owns worker lifecycles on its host)."""
        if node.is_local:
            return self._spawn_worker(purpose=purpose, pool=pool)
        wid = self._new_wid()
        rec = WorkerRec(worker_id=wid, pid=0, addr="", node_id=node.node_id,
                        purpose=purpose, pool=pool)
        self.workers[wid] = rec
        self.stats["workers_spawned"] += 1

        async def _ask_agent():
            try:
                await node.conn.call("spawn_worker", wid=wid, purpose=purpose, pool=pool)
            except asyncio.CancelledError:
                raise  # head shutdown: not a spawn failure
            except Exception:
                rec.state = "dead"
                fut = self._register_waiters.pop(wid, None)
                if fut is not None and not fut.done():
                    fut.set_result(False)
                # a pending lease may have been waiting on this spawn; give
                # the scheduler a chance to spawn elsewhere
                self._service_queue()

        spawn_bg(_ask_agent())
        return rec

    async def _worker_conn(self, rec: WorkerRec) -> Connection:
        conn = self._worker_conns.get(rec.worker_id)
        if conn is None or conn.closed:
            from ..util.aio import dial  # lazy: util/__init__ reaches into core

            conn = await dial(
                rec.addr, purpose=f"worker {rec.worker_id}",
                peer_node=rec.node_id,
            )
            self._worker_conns[rec.worker_id] = conn
        return conn

    async def _wait_registered(self, rec: WorkerRec) -> bool:
        if rec.state != "starting":
            return rec.state != "dead"
        fut = self._register_waiters.setdefault(
            rec.worker_id, asyncio.get_running_loop().create_future()
        )
        try:
            await asyncio.wait_for(fut, self.config.worker_register_timeout_s)
            return True
        except asyncio.TimeoutError:
            return False

    @staticmethod
    def _pool_key(shape: Dict[str, float]) -> str:
        return "gpu" if shape.get("GPU") else "cpu"

    def _ensure_pool(self):
        """Prestart/grow per-node worker pools when demand outstrips idle
        workers.  Demand is computed by simulating placement of the queued
        lease requests onto the alive nodes (policy-faithful: spawn where the
        scheduler will grant), capped by each node's free resources."""
        alive = self._alive_nodes()
        if not alive:
            return
        views = self._node_views(alive)
        demand: Dict[tuple, int] = {}
        for r in self.pending_leases:
            pool = self._pool_key(r.shape)
            if r.pg_id:
                pg = self.pgs.get(r.pg_id)
                if pg is None or pg.state != "created":
                    continue
                if not (0 <= r.bundle_index < len(pg.bundles)):
                    continue
                nid = pg.bundles[r.bundle_index].node_id
                if nid is None:
                    continue
                demand[(nid, pool)] = demand.get((nid, pool), 0) + 1
            else:
                view = scheduling.pick_node(
                    views, r.shape, r.strategy, self.config.scheduler_spread_threshold
                )
                if view is None:
                    continue
                scheduling.take(view.avail, r.shape)
                demand[(view.node_id, pool)] = demand.get((view.node_id, pool), 0) + 1
        per_node_alive: Dict[str, int] = {}
        per_node_starting: Dict[tuple, int] = {}
        for w in self.workers.values():
            if w.state != "dead":
                per_node_alive[w.node_id] = per_node_alive.get(w.node_id, 0) + 1
            if w.state == "starting" and w.purpose == "pool":
                key = (w.node_id, w.pool)
                per_node_starting[key] = per_node_starting.get(key, 0) + 1
        for (nid, pool), d in demand.items():
            node = self.nodes.get(nid)
            if node is None or node.state != "alive":
                continue
            want = d - len(node.idle[pool]) - per_node_starting.get((nid, pool), 0)
            n_alive = per_node_alive.get(nid, 0)
            while want > 0 and n_alive < node.max_workers:
                self._spawn_worker_on(node, pool=pool)
                want -= 1
                n_alive += 1
                per_node_alive[nid] = n_alive

    # ------------------------------------------------------------- scheduler
    def _bundle_avail(self, pg_id: str, bundle_index: int) -> Optional[Dict[str, float]]:
        pg = self.pgs.get(pg_id)
        if pg is None or not (0 <= bundle_index < len(pg.bundles)):
            return None
        b = pg.bundles[bundle_index]
        return {k: v - b.used.get(k, 0.0) for k, v in b.resources.items()}

    def _grant_on_node(self, node: NodeRec, req: LeaseReq) -> bool:
        """Pop an idle worker of the right pool on `node` and grant the lease.
        Returns False if the node has no usable idle worker."""
        pool = node.idle[self._pool_key(req.shape)]
        while pool:
            wid = pool.popleft()
            rec = self.workers.get(wid)
            if rec is None or rec.state != "idle":
                continue
            if req.pg_id:
                b = self.pgs[req.pg_id].bundles[req.bundle_index]
                for k, v in req.shape.items():
                    b.used[k] = b.used.get(k, 0.0) + v
            else:
                self._take(node.avail, req.shape)
            lease_id = f"l{os.urandom(6).hex()}"
            rec.state = "leased"
            rec.busy_since = time.monotonic()
            rec.lease_id = lease_id
            self.leases[lease_id] = wid
            self._lease_shapes[lease_id] = dict(req.shape)
            self._lease_node[lease_id] = node.node_id
            self._lease_client[lease_id] = req.client
            if req.pg_id:
                self._lease_pg[lease_id] = (req.pg_id, req.bundle_index)
            self.stats["leases_granted"] += 1
            # node travels with the grant so the submitter can tell a drain
            # kill (system failure, free retry) from an app crash
            req.reply(
                lease_id=lease_id,
                worker_id=wid,
                addr=self._addr_for(rec, req.remote),
                node=node.node_id,
            )
            return True
        return False

    def _try_grant(self, req: LeaseReq) -> bool:
        # resource admission: from a PG bundle (on the bundle's node) or from
        # a node chosen by the scheduling policy
        if req.pg_id:
            pg = self.pgs.get(req.pg_id)
            if pg is not None and pg.state != "created":
                # bundles of a pending PG were never deducted from any node's
                # avail; granting against them would oversubscribe — wait
                # (requeue) until _service_pending_pgs places the PG
                return False
            avail = self._bundle_avail(req.pg_id, req.bundle_index)
            if avail is None:
                req.reply_err(PlacementGroupError(f"placement group {req.pg_id} not found"))
                return True
            if not self._fits(avail, req.shape):
                return False
            nid = pg.bundles[req.bundle_index].node_id
            node = self.nodes.get(nid)
            if node is None or node.state != "alive":
                return False
            return self._grant_on_node(node, req)
        # policy-ranked candidates; grant on the first that has an idle
        # worker.  Ranking reads NodeRecs in place (no snapshot copies): this
        # runs per queued request per scheduling pass, and the single-node
        # case must stay allocation-free for task-throughput.
        alive = self._alive_nodes()
        threshold = self.config.scheduler_spread_threshold
        kind = (req.strategy or {}).get("type", "DEFAULT")
        if kind == "NODE_AFFINITY":
            want = req.strategy.get("node_id")
            node = self.nodes.get(want)
            if node is not None and node.state == "alive" and self._fits(node.avail, req.shape):
                if self._grant_on_node(node, req):
                    return True
                return False  # wait for a worker on that node
            if not req.strategy.get("soft", False):
                if node is None or node.state != "alive":
                    req.reply_err(
                        ValueError(f"node {want!r} not available for NODE_AFFINITY")
                    )
                    return True
                return False
            kind = "DEFAULT"
        if kind == "NODE_LABEL":
            # label-filtered candidates (hard drops, soft prefers); an
            # unmatchable selector leaves the request pending, same as an
            # unsatisfiable resource shape — a matching node may join later
            alive = scheduling.filter_rank_labels(alive, req.strategy, threshold)
        elif len(alive) > 1:
            # rank over the live NodeRecs in place (no snapshot copies)
            if kind == "SPREAD":
                alive = scheduling.rank_spread(alive)
            else:
                alive = scheduling.rank_hybrid(alive, threshold)
        if kind == "SPREAD":
            # spread semantics: hold the request for the policy-chosen node
            # even when its worker pool is still spawning — skipping to
            # whichever node already has an idle worker would pack the flood
            # onto the few warm nodes (the opposite of SPREAD)
            for node in alive:
                if not scheduling.fits(node.avail, req.shape):
                    continue
                return self._grant_on_node(node, req)
            return False
        for node in alive:
            if not scheduling.fits(node.avail, req.shape):
                continue
            if self._grant_on_node(node, req):
                return True
        return False

    def _service_queue(self):
        # pending PGs reserve first: their creation was requested before the
        # queued leases could possibly run inside them
        self._service_pending_pgs()
        made_progress = True
        while made_progress and self.pending_leases:
            made_progress = False
            for _ in range(len(self.pending_leases)):
                req = self.pending_leases.popleft()
                if self._try_grant(req):
                    made_progress = True
                else:
                    self.pending_leases.append(req)
        self._ensure_pool()
        # whatever idle capacity central work didn't claim flows out to the
        # agents' lease blocks (node-local granting)
        self._maybe_delegate()

    def _release_lease(self, lease_id: str, worker_ok: bool = True):
        wid = self.leases.pop(lease_id, None)
        shape = self._lease_shapes.pop(lease_id, None)
        pg = self._lease_pg.pop(lease_id, None)
        nid = self._lease_node.pop(lease_id, None)
        self._lease_client.pop(lease_id, None)
        if shape is not None:
            if pg is not None:
                pgrec = self.pgs.get(pg[0])
                if pgrec is not None:
                    b = pgrec.bundles[pg[1]]
                    for k, v in shape.items():
                        b.used[k] = b.used.get(k, 0.0) - v
            else:
                node = self.nodes.get(nid or LOCAL_NODE)
                if node is not None and node.up:
                    self._give(node.avail, shape)
        if wid is not None:
            rec = self.workers.get(wid)
            if rec is not None and rec.state == "leased":
                if worker_ok:
                    rec.state = "idle"
                    rec.lease_id = None
                    node = self.nodes.get(rec.node_id)
                    if node is not None and node.state == "alive":
                        node.idle[rec.pool].append(wid)
        self._service_queue()

    # ---------------------------------------------------------- lease plane
    def _lease_block_cap(self, node: NodeRec) -> int:
        cap = self.config.lease_block_max
        return cap if cap > 0 else int(node.total.get("CPU", 0))

    def _maybe_delegate(self):
        """Delegate idle agent-node workers into lease blocks (the head ->
        raylet capacity split).  Runs only when no central work is queued:
        pending leases/PGs get first claim on fresh idle workers, which also
        keeps delegation and revocation from ping-ponging."""
        if not self.config.lease_delegation:
            return
        if self._needs_reclaim():
            # the queued work needs CENTRAL capacity; ttl-marked escalation
            # probes don't block delegation — their submitters poll the
            # agents, so the capacity serves them faster delegated
            self._last_central_demand = time.monotonic()
            return
        if time.monotonic() - self._last_central_demand < 0.5:
            # central demand was queued moments ago (wave-shaped floods):
            # freshly idle workers serve the next wave centrally instead of
            # vanishing into blocks the next wave can't see
            return
        for node in self.nodes.values():
            if (
                node.is_local
                or node.state != "alive"
                or node.conn is None
                or node.conn.closed
            ):
                continue
            cap = self._lease_block_cap(node)
            for pool, unit in LEASE_UNIT_SHAPES.items():
                idle = node.idle.get(pool)
                if not idle:
                    continue
                delegated = node.delegated.setdefault(pool, set())
                grant: List[dict] = []
                while (
                    idle
                    and len(delegated) < cap
                    and scheduling.fits(node.avail, unit)
                ):
                    wid = idle.popleft()
                    rec = self.workers.get(wid)
                    if rec is None or rec.state != "idle":
                        continue
                    # charge the slot's unit shape NOW: central scheduling
                    # can never over-commit capacity an agent may grant
                    self._take(node.avail, unit)
                    rec.state = "delegated"
                    delegated.add(wid)
                    grant.append({"wid": wid, "addr": rec.addr})
                if grant:
                    try:
                        # the block carries the node's incarnation: an agent
                        # whose token disagrees discards the delegation (it
                        # is mid-fence and must not grant from stale blocks)
                        node.conn.notify(
                            "lease_block", pool=pool, workers=grant,
                            ninc=node.incarnation,
                        )
                        self.stats["lease_blocks_delegated"] += len(grant)
                        self._dirty = True
                    except Exception:
                        # push failed: undo — the agent never saw the block
                        for g in grant:
                            self._undelegate_wid(node, pool, g["wid"])

    def _undelegate_wid(self, node: NodeRec, pool: str, wid: str, dead: bool = False):
        """Take one worker slot back from a node's block accounting: credit
        the unit charge and (for live workers) rejoin the idle pool."""
        if wid not in node.delegated.get(pool, ()):
            return
        node.delegated[pool].discard(wid)
        if node.up:
            self._give(node.avail, LEASE_UNIT_SHAPES[pool])
        rec = self.workers.get(wid)
        if not dead and rec is not None and rec.state == "delegated":
            rec.state = "idle"
            if node.state == "alive" and wid not in node.idle[rec.pool]:
                node.idle[rec.pool].append(wid)

    def _expire_lease_requests(self):
        """Answer lease-plane escalation probes past their ttl with
        {"expired": True}: the submitter re-probes the agents' blocks and
        re-subscribes here.  Without expiry, one saturated-burst overflow
        request would sit pending forever and force block revocation —
        re-centralizing the exact traffic the lease plane exists to move."""
        now = time.monotonic()
        if not any(
            r.deadline is not None and r.deadline < now for r in self.pending_leases
        ):
            return
        keep: deque = deque()
        for r in self.pending_leases:
            if r.deadline is not None and r.deadline < now:
                r.reply(expired=True)
            else:
                keep.append(r)
        self.pending_leases = keep

    def _needs_reclaim(self) -> bool:
        """Should delegated capacity be pulled back?  Only for work the head
        ALONE can serve: pending PGs and classic (no-ttl) lease requests —
        PG-charged, strategy-constrained, custom-shaped, or remote-client
        leases.  ttl-marked requests are lease-plane escalation probes: their
        submitters are already polling the agents, so revoking for them would
        just re-centralize the hot class under load."""
        if self.pending_pgs:
            return True
        return any(r.deadline is None for r in self.pending_leases)

    def _reclaim_delegations(self):
        """Central work is queued while capacity sits delegated: ask agents
        to return their UNLEASED slots (the head is the reclaim arbiter).
        Debounced; runs from the 0.25s persist tick so transient queue blips
        during normal churn never thrash the blocks."""
        now = time.monotonic()
        if now - self._last_deleg_reclaim < 0.25:
            return
        self._last_deleg_reclaim = now
        for node in self.nodes.values():
            if node.state != "alive" or node.conn is None or node.conn.closed:
                continue
            for pool, wids in node.delegated.items():
                if wids:
                    try:
                        node.conn.notify("lease_block_revoke", pool=pool, n=len(wids))
                    except Exception:
                        pass

    async def _h_lease_block_return(self, state, msg, reply, reply_err):
        """Agent returned unleased block slots (revocation reply or agent-
        initiated shed): credit the charges, rejoin the idle pools, and let
        the queued central work grab the capacity."""
        node = self.nodes.get(msg.get("node_id", state.get("node_id")))
        if node is None:
            return
        pool = msg.get("pool", "cpu")
        n = 0
        for wid in msg.get("wids") or ():
            if wid in node.delegated.get(pool, ()):
                self._undelegate_wid(node, pool, wid)
                n += 1
        if n:
            self.stats["lease_blocks_returned"] += n
            self._service_queue()

    def _placeable_with_delegated(self, a: ActorRec) -> bool:
        """Would the actor place if every delegated-but-unleased slot came
        back?  Credits each block's full unit capacity to a hypothetical
        view — optimistic (leased slots won't return), so it gates a bounded
        reclaim-and-wait, never an unconditional one."""
        views = []
        for n in self._alive_nodes():
            avail = dict(n.avail)
            for pool, wids in n.delegated.items():
                for k, v in LEASE_UNIT_SHAPES[pool].items():
                    avail[k] = avail.get(k, 0.0) + v * len(wids)
            views.append(
                scheduling.NodeView(n.node_id, n.total, avail, n.index, labels=n.labels)
            )
        return (
            scheduling.pick_node(
                views, a.resources, a.strategy, self.config.scheduler_spread_threshold
            )
            is not None
        )

    def _autoscaler_watching(self) -> bool:
        return time.monotonic() - self._autoscaler_read_at < AUTOSCALER_WATCH_S

    async def _await_autoscaled_node(self, a: ActorRec):
        """Hold an actor that fits no node as demand (autoscaler_state's
        pending_demands) until a node it fits joins, the actor is killed,
        or no autoscaler reads the demand any more; returns the node's view
        or None."""
        self._actor_demands[a.actor_id] = dict(a.resources)
        view = None
        try:
            while view is None and a.state != "dead" and self._autoscaler_watching():
                await asyncio.sleep(0.25)
                view = scheduling.pick_node(
                    self._node_views(), a.resources, a.strategy,
                    self.config.scheduler_spread_threshold,
                )
        finally:
            self._actor_demands.pop(a.actor_id, None)
        return view

    def _fits_eventually(self, a: ActorRec) -> bool:
        """Could the actor place once currently-leased capacity returns?
        True when its shape fits some schedulable node's TOTAL resources —
        gates the bounded reclaim-and-wait above for busy-but-placeable
        actors; infeasible shapes keep their immediate failure."""
        views = [
            scheduling.NodeView(
                n.node_id, n.total, dict(n.total), n.index, labels=n.labels
            )
            for n in self._alive_nodes()
        ]
        return (
            scheduling.pick_node(
                views, a.resources, a.strategy,
                self.config.scheduler_spread_threshold,
            )
            is not None
        )

    def _reconcile_lease_blocks(self, node: NodeRec, blocks: Dict[str, dict]):
        """Adopt the agent's authoritative view of its delegated blocks (sent
        with every agent (re)registration).  After a head kill -9 + restart
        the snapshot may trail reality — grants and delegations made while
        the head was down — so the block membership reconciles both ways:
        workers the agent holds become `delegated` here (charged), workers
        the head thought delegated but the agent no longer holds go back to
        the idle pool (credited)."""
        for key in [k for k in self._pending_block_adopt if k[0] == node.node_id]:
            del self._pending_block_adopt[key]  # superseded by this snapshot
        for pool, unit in LEASE_UNIT_SHAPES.items():
            agent_wids = set((blocks.get(pool) or {}).get("wids") or ())
            head_wids = set(node.delegated.get(pool, ()))
            for wid in agent_wids - head_wids:
                rec = self.workers.get(wid)
                if rec is None:
                    # snapshotless restart, agent registered before this
                    # worker: adopt it into the block when IT re-registers
                    # (joining the idle pool instead would make one worker
                    # grantable by both planes)
                    self._pending_block_adopt[(node.node_id, wid)] = pool
                    continue
                if rec.state == "leased" and rec.lease_id:
                    # snapshot-stale central lease (returned pre-crash, after
                    # the last snapshot): the agent's newer block membership
                    # wins — retire the lease record first, then adopt, or a
                    # later release would rejoin the worker to the idle pool
                    # while the agent still grants it (dual-plane worker)
                    self._release_lease(rec.lease_id, worker_ok=True)
                if rec.state not in ("idle", "delegated", "starting"):
                    continue  # dead here: worker_exit settles it agent-side
                try:
                    node.idle[pool].remove(wid)
                except ValueError:
                    pass
                if rec.state != "delegated":
                    self._take(node.avail, unit)
                rec.state = "delegated"
                node.delegated.setdefault(pool, set()).add(wid)
            for wid in head_wids - agent_wids:
                self._undelegate_wid(node, pool, wid)
        self._dirty = True

    # --------------------------------------------------------------- actors
    async def _place_actor(self, a: ActorRec):
        """Pick a node for the actor, spawn a dedicated worker there, and run
        the actor creation task on it.  Mirrors GcsActorScheduler: lease
        resources, push creation, publish."""
        node: Optional[NodeRec] = None
        if a.pg_id:
            pg = self.pgs.get(a.pg_id)
            if pg is not None and pg.state == "pending":
                # wait for the PG's resources to actually be reserved; placing
                # into a pending PG would charge a bundle whose capacity was
                # never taken from a node (oversubscription)
                fut: asyncio.Future = asyncio.get_running_loop().create_future()
                self._pg_waiters.setdefault(a.pg_id, []).append(fut)
                try:
                    await fut
                except PlacementGroupError:
                    pass  # removed while pending: falls through to dead below
            avail = self._bundle_avail(a.pg_id, a.bundle_index)
            ok = avail is not None and self._fits(avail, a.resources)
            if ok:
                b = self.pgs[a.pg_id].bundles[a.bundle_index]
                node = self.nodes.get(b.node_id) if b.node_id else None
                ok = node is not None and node.state == "alive"
                if ok:
                    for k, v in a.resources.items():
                        b.used[k] = b.used.get(k, 0.0) + v
                    a.charged = "pg"
        else:
            view = scheduling.pick_node(
                self._node_views(), a.resources, a.strategy,
                self.config.scheduler_spread_threshold,
            )
            if view is None and (
                self._placeable_with_delegated(a) or self._fits_eventually(a)
            ):
                # the capacity exists but is parked in agents' lease blocks
                # or held by running task leases: reclaim (the head is the
                # arbiter) / wait for leases to idle-return instead of
                # failing a valid actor.  Restart/migration placements hit
                # this constantly — a drain evacuating an actor onto a
                # survivor whose CPUs are briefly all leased must wait out
                # the tasks, not die "resources unavailable".  Genuinely
                # infeasible shapes (fit no node's TOTAL) still fail fast.
                deadline = time.monotonic() + 10.0
                while view is None and time.monotonic() < deadline:
                    # re-stamped EVERY round: a lease_block_return landing
                    # after the quiet period would otherwise be re-delegated
                    # by its own _service_queue before this coroutine wakes
                    self._last_central_demand = time.monotonic()
                    self._last_deleg_reclaim = 0.0  # bypass the debounce
                    self._reclaim_delegations()
                    await asyncio.sleep(0.25)
                    view = scheduling.pick_node(
                        self._node_views(), a.resources, a.strategy,
                        self.config.scheduler_spread_threshold,
                    )
            if view is None and not self._fits_eventually(a) and self._autoscaler_watching():
                view = await self._await_autoscaled_node(a)
                if a.state == "dead":
                    return  # killed while it waited
            ok = view is not None
            if ok:
                node = self.nodes[view.node_id]
                self._take(node.avail, a.resources)
                a.charged = "node"
        if not ok or node is None:
            a.state = "dead"
            a.death_cause = "resources unavailable for actor"
            self._pub("actors", self._actor_info(a))
            return
        a.node_id = node.node_id
        # incarnation guard: if this placement's worker dies mid-start (node
        # death, partition verdict), _on_worker_death fires a NEW restart at
        # a bumped incarnation — this superseded coroutine must then return
        # silently instead of stomping the actor dead over the fresh attempt
        placing_inc = a.incarnation
        rec = self._spawn_worker_on(node, purpose="actor", pool=self._pool_key(a.resources))
        rec.actor_id = a.actor_id
        a.worker_id = rec.worker_id
        if not await self._wait_registered(rec):
            if a.incarnation == placing_inc:
                a.state = "dead"
                a.death_cause = "actor worker failed to start"
                self._pub("actors", self._actor_info(a))
            return
        a.addr = rec.addr
        try:
            conn = await self._worker_conn(rec)
            await conn.call(
                "spawn_actor",
                actor_id=a.actor_id,
                fn_id=a.fn_id,
                init_spec=a.init_spec,
                max_concurrency=a.max_concurrency,
                concurrency_groups=a.concurrency_groups,
                incarnation=a.incarnation,
                runtime_env=a.runtime_env,
            )
            if a.incarnation != placing_inc:
                # superseded while spawning: the newer incarnation owns the
                # record now; this worker will be reaped as an orphan
                return
            a.state = "alive"
            self.stats["actors_created"] += 1
            self._log_event(
                "actor_alive", actor_id=a.actor_id, worker_id=a.worker_id, node_id=a.node_id
            )
        except asyncio.CancelledError:
            raise  # head shutdown mid-create: not an actor death
        except Exception as e:
            if isinstance(e, ConnectionError) and rec.state != "dead":
                # the worker went away mid-__init__: declare it dead now, so
                # that the error names its cause
                await self._on_worker_death(rec)
            if a.incarnation != placing_inc:
                return
            a.state = "dead"
            a.death_cause = f"actor __init__ failed: {e!r}"
            if rec.death_cause:
                a.death_cause += "; " + self._death_message(rec)
        self._pub("actors", self._actor_info(a))

    def _actor_info(self, a: ActorRec) -> dict:
        return {
            "actor_id": a.actor_id,
            "state": a.state,
            "addr": a.addr,
            "incarnation": a.incarnation,
            "name": a.name,
            "death_cause": a.death_cause,
            "node_id": a.node_id,
            # the hosting worker: what `ca profile <actor>` resolves through
            # (and how list_actors() users find the process to inspect)
            "worker_id": a.worker_id,
            "method_options": a.method_options,
        }

    def _silent_but_working(self, rec: WorkerRec) -> bool:
        """Whether a local worker past the heartbeat bound is still at work,
        so that its silence is a starved IO loop, not a hang: its process
        (/proc/<pid>/stat, the CPU time of all its threads) used at least
        BUSY_CPU_SHARE of a core over the last whole BUSY_WINDOW_S.  A
        stopped process, a worker on another node or one whose stat is
        unreadable counts as not working."""
        if rec.node_id != LOCAL_NODE or not rec.pid:
            return False
        try:
            with open(f"/proc/{rec.pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            return False
        if fields[0] in ("T", "t", "Z", "X"):
            return False  # stopped or gone
        now, ticks = time.monotonic(), int(fields[11]) + int(fields[12])
        if rec.silent_ticks < 0:
            rec.silent_ticks, rec.silent_window_at = ticks, now
            self.stats["busy_silences"] = self.stats.get("busy_silences", 0) + 1
            self._log_event(
                "worker_silent", worker_id=rec.worker_id, state=rec.state,
                proc_state=fields[0],
            )
            return True
        elapsed = now - rec.silent_window_at
        if elapsed < BUSY_WINDOW_S:
            return True
        used = (ticks - rec.silent_ticks) / os.sysconf("SC_CLK_TCK")
        rec.silent_ticks, rec.silent_window_at = ticks, now
        return used >= BUSY_CPU_SHARE * elapsed

    @staticmethod
    def _exit_status(rc: Optional[int]) -> Optional[str]:
        if rc is None:
            return None
        return f"signal {-rc}" if rc < 0 else f"exit {rc}"

    def _worker_log_tail(self, rec: WorkerRec, n: int = 20) -> str:
        """The last n lines of the worker's log (<session>/<wid>.log; a
        worker an agent spawned logs on its own node, not read here)."""
        path = os.path.join(self.session_dir, f"{rec.worker_id}.log")
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - 16384))
                lines = f.read().decode("utf-8", "replace").splitlines()
        except OSError:
            return ""
        return "\n".join(lines[-n:])

    def _death_message(self, rec: WorkerRec) -> str:
        msg = f"worker {rec.worker_id} (pid {rec.pid}) died: {rec.death_cause}"
        if rec.log_tail:
            msg += f"\nlast lines of {rec.worker_id}.log:\n{rec.log_tail}"
        return msg

    async def _on_worker_death(self, rec: WorkerRec, cause: str = "connection lost"):
        """Declare the worker dead, for `cause`: "exit <code>" or "signal
        <n>" (its process ended), "process gone" (a re-adopted worker's pid),
        "no heartbeat for <s> s in state <state>", "agent reported",
        "connection lost", "node died" or "node drained".
        A lost connection to a worker this head spawned is replaced by its
        exit status when the process has one within half a second."""
        if rec.state == "dead":
            return
        prev_state = rec.state
        rec.state, rec.death_cause = "dead", cause  # until its exit status is read
        if rec.proc is not None:
            deadline = time.monotonic() + (0.5 if cause == "connection lost" else 0.0)
            while rec.proc.poll() is None and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            cause = self._exit_status(rec.proc.poll()) or cause
        rec.death_cause = cause
        rec.log_tail = self._worker_log_tail(rec)
        self._log_event(
            "worker_died", worker_id=rec.worker_id, prev_state=prev_state,
            node_id=rec.node_id, cause=cause,
        )
        fut = self._register_waiters.pop(rec.worker_id, None)
        if fut is not None and not fut.done():
            fut.set_result(False)
        conn = self._worker_conns.pop(rec.worker_id, None)
        if conn is not None:
            fence_close_conn(conn)
        # fence the worker: close its registration connection so a live-but-
        # declared-dead process exits instead of acting on stale leases.
        # Under an active blackhole both closes defer until the link heals —
        # a partition delivers no FIN; the zombie instead learns its verdict
        # at heal (refused re-register / FencedError on its stamped RPCs).
        client_state = self._clients.get(rec.worker_id)
        if client_state is not None:
            fence_close(client_state["writer"])
        node = self.nodes.get(rec.node_id)
        if node is not None:
            try:
                node.idle[rec.pool].remove(rec.worker_id)
            except ValueError:
                pass
        if rec.gpu_id is not None:
            if self._chip_alloc is not None:
                self._chip_alloc.release(rec.gpu_id)
            rec.gpu_id = None
        if rec.blocked:
            # its cpus were returned to the pool at block time; take them back
            # before the lease/actor release re-adds them (double-free guard)
            shape = None
            if rec.lease_id:
                shape = self._lease_shapes.get(rec.lease_id)
            elif rec.actor_id and rec.actor_id in self.actors:
                shape = self.actors[rec.actor_id].resources
            elif prev_state == "delegated":
                # agent-granted lease blocked in get(): the blocked release
                # was the slot's unit charge (_blocked_shape_node) — take it
                # back here or the delegated credit below over-credits the
                # node by one unit per blocked-death
                shape = LEASE_UNIT_SHAPES.get(rec.pool)
            cpus = (shape or {}).get("CPU", 0.0)
            if cpus and node is not None and node.up:
                self._take(node.avail, {"CPU": cpus})
            rec.blocked = False
        if prev_state == "delegated":
            # the slot's unit charge returns to the node (the agent reaps the
            # process itself and shrinks its block; any outstanding local
            # grant dies with the worker — submitters see the broken
            # connection and retry on a fresh lease)
            node2 = self.nodes.get(rec.node_id)
            if node2 is not None:
                self._undelegate_wid(node2, rec.pool, rec.worker_id, dead=True)
        if rec.lease_id:
            self._release_lease(rec.lease_id, worker_ok=False)
        if rec.actor_id:
            a = self.actors.get(rec.actor_id)
            if a is not None and a.state in ("alive", "restarting", "pending"):
                # return the actor's lifetime resources to wherever they were
                # charged; a PG-charged actor whose PG is already removed
                # credits nothing (the reservation went back with the PG)
                if a.charged == "pg":
                    if a.pg_id in self.pgs:
                        b = self.pgs[a.pg_id].bundles[a.bundle_index]
                        for k, v in a.resources.items():
                            b.used[k] = b.used.get(k, 0.0) - v
                elif a.charged == "node":
                    anode = self.nodes.get(a.node_id or LOCAL_NODE)
                    if anode is not None and anode.up:
                        self._give(anode.avail, a.resources)
                a.charged = None
                if a.can_restart:
                    a.restarts_used += 1
                    a.incarnation += 1
                    a.state = "restarting"
                    a.addr = None
                    self.stats["actor_restarts"] += 1
                    self._log_event("actor_restarting", actor_id=a.actor_id, attempt=a.restarts_used)
                    self._pub("actors", self._actor_info(a))

                    async def _restart(a=a):
                        await asyncio.sleep(self.config.actor_restart_backoff_s)
                        await self._place_actor(a)

                    # BACKGROUND, never awaited here: _on_worker_death runs
                    # on the monitor loop, and a restart placement can block
                    # up to worker_register_timeout_s against a node that is
                    # silently partitioned — wedging the very failure
                    # detector that would declare that node dead.  (Observed:
                    # an actor restart aimed at a blackholed node froze node
                    # death detection for 30s.)
                    spawn_bg(_restart())
                else:
                    a.state = "dead"
                    a.death_cause = a.death_cause or (
                        "actor worker died: " + self._death_message(rec)
                    )
                    self._log_event("actor_dead", actor_id=a.actor_id, cause=a.death_cause)
                    self._drop_actor_name(a)
                    self._pub("actors", self._actor_info(a))
        self._service_queue()

    def _drop_actor_name(self, a: ActorRec):
        if a.name and self.named_actors.get(a.name) == a.actor_id:
            del self.named_actors[a.name]

    # ---------------------------------------------------------------- nodes
    async def _connect_agent(self, node: NodeRec):
        from ..util.aio import dial  # lazy: util/__init__ reaches into core

        try:
            node.conn = await dial(
                node.addr, purpose=f"agent {node.node_id}",
                peer_node=node.node_id,
            )
            # head->agent calls carry the authority epoch: after a failover
            # the agent fences any call still arriving from the OLD head
            node.conn.stamp = {"hep": self.head_epoch}
        except asyncio.CancelledError:
            raise  # head shutdown: must not declare the node dead
        except Exception as e:
            self._log_event("agent_connect_failed", node_id=node.node_id, error=repr(e))
            await self._on_node_death(node)

    async def _on_node_death(self, node: NodeRec):
        """Node agent died or went silent: everything on it is gone.
        Mirrors GcsNodeManager::OnNodeFailure + per-manager node-death hooks."""
        if node.state in ("dead", "drained"):
            # a drained node's agent exiting is the PLANNED end of the drain
            # FSM — its tables were already settled by _drain_finalize
            return
        node.state = "dead"
        self._drain_evac_done.discard(node.node_id)  # died mid-drain
        self.stats["nodes_died"] += 1
        self._log_event("node_died", node_id=node.node_id)
        if node.conn is not None:
            fence_close_conn(node.conn)
            node.conn = None
        node.lease_used = {}  # stale agent-reported occupancy
        for key in [k for k in self._pending_block_adopt if k[0] == node.node_id]:
            del self._pending_block_adopt[key]
        # fence the agent: close its registration connection so an agent
        # declared dead by heartbeat timeout tears itself down (kills its
        # workers, sweeps its shm namespace) instead of zombieing on.
        # Deferred while a blackhole covers the link (no FIN through a
        # partition): the healed agent discovers the verdict via FencedError
        # on its next stamped RPC or refused re-register, then purges and
        # rejoins at a fresh incarnation.
        agent_state = self._clients.get(node.node_id)
        if agent_state is not None:
            fence_close(agent_state["writer"])
        # workers on the node are dead (their lease/actor cleanup runs through
        # the normal worker-death path; node.avail credits are skipped because
        # the node is already marked dead)
        for rec in list(self.workers.values()):
            if rec.node_id == node.node_id and rec.state != "dead":
                await self._on_worker_death(rec, "node died")
        # objects: promote a surviving copy to primary, else the object is
        # lost (locate -> not found -> ObjectLostError / reconstruction)
        for rec in list(self.objects.values()):
            rec.copies.pop(node.node_id, None)
            if rec.node_id == node.node_id:
                if rec.copies:
                    new_node, new_name = next(iter(rec.copies.items()))
                    rec.node_id, rec.shm_name = new_node, new_name
                    del rec.copies[new_node]
                else:
                    self.objects.pop(rec.oid, None)
                    self._log_event("object_lost", oid=rec.oid.hex(), node_id=node.node_id)
        # placement groups: bundles on the dead node lose their reservation
        # and the PG goes back to pending for re-placement (reference:
        # GcsPlacementGroupManager::OnNodeDead reschedules)
        for pg in self.pgs.values():
            hit = False
            for b in pg.bundles:
                if b.node_id == node.node_id:
                    b.node_id = None
                    b.used = {}
                    hit = True
            if hit and pg.state == "created":
                pg.state = "pending"
                self.pending_pgs.append(pg.pg_id)
                self._log_event("pg_rescheduling", pg_id=pg.pg_id)
        self._pub("nodes", {"node_id": node.node_id, "alive": False})
        self._service_queue()

    # ----------------------------------------------------------- drain plane
    # FSM: alive -> draining -> drained (DrainNode protocol analogue,
    # gcs_node_manager.h HandleDrainNode).  A drain converts an announced
    # exit (preemption warning, autoscaler downscale, `ca drain`) into
    # zero-loss evacuation: placement stops immediately, delegated lease
    # blocks are recalled, actors restart on survivors through the normal
    # restart FSM (without consuming their restart budget), sole-copy
    # primary objects re-replicate, and running tasks get until the deadline
    # before the kill — whose retries clients exempt from max_retries.

    DRAIN_REASONS = ("preemption", "idle", "manual")

    # ------------------------------------------------------ net-chaos plane
    async def _h_net_chaos(self, state, msg, reply, reply_err):
        """Install (or clear, spec="") a network-chaos schedule cluster-wide:
        the head applies it locally and broadcasts it to every connected
        client (workers, drivers, agents — agents' registration conns are
        clients too), so all processes drop/delay the same links from the
        same seeded schedule.  Scheduled windows (blackhole@S+D, flap) are
        the way to inject a PARTITION: the heal must come from the schedule,
        because a `clear` broadcast cannot reach a process it partitioned.
        Status-only callers omit `spec`."""
        if "spec" in msg:
            spec = msg.get("spec") or ""
            # one shared anchor for every process's window offsets: default
            # it HERE so late joiners and rebroadcasts agree with the
            # original installation instead of re-opening healed windows
            epoch = msg.get("epoch")
            if epoch is None:
                epoch = time.time()
            try:
                netchaos.install(spec, LOCAL_NODE, epoch=epoch)
            except (ValueError, TypeError) as e:
                reply_err(e)
                return
            self._net_chaos_spec = spec
            self._net_chaos_epoch = epoch if spec else None
            self._log_event("net_chaos", spec=spec)
            frame = {"m": "net_chaos", "spec": spec, "epoch": epoch}
            for st in list(self._clients.values()):
                try:
                    write_frame(st["writer"], frame)
                except Exception:
                    pass
        reply(spec=self._net_chaos_spec, status=netchaos.status())

    async def _h_drain_node(self, state, msg, reply, reply_err):
        nid = msg.get("node_id")
        node = self.nodes.get(nid)
        if node is None:
            reply_err(ValueError(f"unknown node {nid!r}"))
            return
        if node.is_local:
            reply_err(ValueError(
                "cannot drain the head node n0 (stop the cluster instead)"
            ))
            return
        if node.state != "alive":
            reply(state=node.state)  # idempotent: already draining/gone
            return
        reason = msg.get("reason") or "manual"
        if reason not in self.DRAIN_REASONS:
            reply_err(ValueError(
                f"drain reason must be one of {self.DRAIN_REASONS}, got {reason!r}"
            ))
            return
        raw = msg.get("deadline_s")
        # explicit 0 is a valid "drain NOW" — only None takes the default
        deadline_s = float(self.config.drain_deadline_s if raw is None else raw)
        self._drain_begin(node, reason, deadline_s)
        reply(state="draining", deadline_s=deadline_s)

    def _drain_begin(self, node: NodeRec, reason: str, deadline_s: float):
        node.state = "draining"
        node.drain_reason = reason
        node.drain_deadline = time.monotonic() + deadline_s
        key = f"drain_nodes_{reason}"
        self.stats[key] = self.stats.get(key, 0) + 1
        self._log_event(
            "node_draining", node_id=node.node_id, reason=reason,
            deadline_s=deadline_s,
        )
        # recall the delegated lease blocks: unleased slots come back now;
        # outstanding local grants keep their workers until the deadline
        if node.conn is not None and not node.conn.closed:
            for pool, wids in node.delegated.items():
                if wids:
                    try:
                        node.conn.notify("lease_block_revoke", pool=pool, n=len(wids))
                    except Exception:
                        pass
        # PG bundles reserved here lose their reservation and the PG goes
        # back to pending for placement on survivors (node-death semantics,
        # but the capacity is credited back — the node is still accounted
        # while draining)
        for pg in self.pgs.values():
            hit = False
            for b in pg.bundles:
                if b.node_id == node.node_id:
                    self._give(node.avail, b.resources)
                    b.node_id = None
                    b.used = {}
                    hit = True
            if hit:
                # actors charged against the wiped reservations went back
                # WITH them (b.used reset): drop their charge marker, or the
                # migrate/finalize charge-return would decrement the re-placed
                # bundle's fresh accounting negative (permanent overcommit)
                for a in self.actors.values():
                    if (
                        a.pg_id == pg.pg_id
                        and a.charged == "pg"
                        and a.node_id == node.node_id
                    ):
                        a.charged = None
                if pg.state == "created":
                    pg.state = "pending"
                    self.pending_pgs.append(pg.pg_id)
                    self._log_event("pg_rescheduling", pg_id=pg.pg_id)
        # tell every client: task deaths on this node inside the window are
        # preemptions — retried without consuming the user's max_retries
        self._pub_drain(node)
        self._pub(
            "nodes", {"node_id": node.node_id, "alive": True, "state": "draining"}
        )
        self._drain_evac_done.discard(node.node_id)
        spawn_bg(self._drain_evacuate(node))
        self._dirty = True
        self._service_queue()

    def _drain_pub_frame(self, node: NodeRec) -> dict:
        """The one definition of the drain announcement (broadcast AND the
        register-time late-joiner push read it — they must never drift)."""
        return {
            "m": "pub",
            "ch": "drain",
            "data": {
                "node_id": node.node_id,
                "reason": node.drain_reason,
                "state": node.state,
                "deadline_s": max(0.0, node.drain_deadline - time.monotonic()),
            },
        }

    def _pub_drain(self, node: NodeRec):
        """Fan a drain announcement out to every connected client (drivers
        and workers both submit tasks).  Direct push, not channel pubsub:
        clients must not need a subscription round-trip to learn their
        retries are about to be free."""
        frame = self._drain_pub_frame(node)
        for st in list(self._clients.values()):
            try:
                write_frame(st["writer"], frame)
            except Exception:
                pass

    async def _drain_evacuate(self, node: NodeRec):
        """Background evacuation pass: re-home sole-copy primary objects
        FIRST, then migrate live actors off the node through the restart
        FSM.  Objects go first because they are bounded data moves, while
        an actor migration may legitimately WAIT for capacity (survivors'
        CPUs briefly all leased to evacuating tasks) — object safety must
        not sit behind that wait and lose the race with the deadline.
        Finishing arms the quiesce check in the monitor loop."""
        try:
            await self._evacuate_objects(node)
            for a in list(self.actors.values()):
                if node.state != "draining":
                    return
                if a.node_id == node.node_id and a.state == "alive":
                    if not a.drain_migration:
                        # supervisor-managed (serve replicas): the owner
                        # drains it app-aware; the deadline kill still
                        # applies if the supervisor doesn't finish in time
                        continue
                    await self._migrate_actor(a, node)
        except asyncio.CancelledError:
            raise  # the finally still arms/skips the quiesce check
        except Exception as e:
            self._log_event(
                "drain_evacuate_failed", node_id=node.node_id, error=repr(e)
            )
        finally:
            if node.state == "draining":
                # arm the quiesce check — unless the node died or finalized
                # mid-pass, where adding would leak a stale id in the set
                self._drain_evac_done.add(node.node_id)

    async def _migrate_actor(self, a: ActorRec, node: NodeRec):
        """Proactively restart one actor on a survivor (drain evacuation).
        Rides the normal restart FSM (clients see restarting -> alive and
        re-resolve the address) but does NOT consume restarts_used: a drain
        is a system event, not an app failure."""
        old_rec = self.workers.get(a.worker_id) if a.worker_id else None
        # return the old incarnation's charge to wherever it was taken
        if a.charged == "pg":
            if a.pg_id in self.pgs:
                b = self.pgs[a.pg_id].bundles[a.bundle_index]
                for k, v in a.resources.items():
                    b.used[k] = b.used.get(k, 0.0) - v
        elif a.charged == "node":
            anode = self.nodes.get(a.node_id or LOCAL_NODE)
            if anode is not None and anode.up:
                self._give(anode.avail, a.resources)
        a.charged = None
        a.incarnation += 1
        a.state = "restarting"
        a.addr = None
        self.stats["drain_actors_migrated"] += 1
        self.stats["actor_restarts"] += 1
        self._log_event(
            "actor_migrating", actor_id=a.actor_id, from_node=node.node_id
        )
        self._pub("actors", self._actor_info(a))
        if old_rec is not None:
            # detach BEFORE the kill: the old worker's death event must not
            # re-fire the restart FSM against the new incarnation
            old_rec.actor_id = None
            self._kill_worker_rec(old_rec)
        await self._place_actor(a)

    async def _evacuate_objects(self, node: NodeRec):
        """Re-home every primary copy whose only holder is the draining
        node: promote an existing survivor copy when one exists, else pull
        the bytes into the head's n0 namespace (obj_copy/spill machinery in
        reverse — the head is always a valid transfer target).  After this,
        an announced exit can never fire ObjectLostError/reconstruction."""
        for rec in list(self.objects.values()):
            if node.state != "draining":
                return
            if rec.node_id != node.node_id or rec.oid not in self.objects:
                continue
            if self._promote_copy(rec):
                self.stats["drain_objects_migrated"] += 1
                continue
            await self._pull_object_to_head(node, rec)

    def _promote_copy(self, rec: ObjectRec) -> bool:
        """Make an existing copy on a schedulable survivor the primary.  The
        old primary's bytes stay on the draining node untracked — its whole
        shm namespace is swept when the agent terminates."""
        for nid in list(rec.copies):
            n2 = self.nodes.get(nid)
            if n2 is not None and n2.state == "alive":
                rec.node_id = nid
                rec.shm_name = rec.copies.pop(nid)
                rec.spill_path = None
                rec.pending_free = None
                return True
        return False

    async def _pull_object_to_head(self, node: NodeRec, rec: ObjectRec):
        """Chunk-pull one object off the draining node into a dedicated n0
        segment and promote it to primary (the same wire path workers use
        for node-to-node transfer, served by the node's agent)."""
        if node.conn is None or node.conn.closed:
            return
        src = rec.shm_name or (f"spill:{rec.spill_path}" if rec.spill_path else None)
        if src is None:
            return
        name = f"{self.session_name}/{LOCAL_NODE}/drain_{rec.oid.hex()}"
        path = os.path.join("/dev/shm", name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        chunk = self.config.transfer_chunk_bytes
        window = max(1, int(getattr(self.config, "transfer_window", 4)))
        from collections import deque as _deque

        pending = _deque(
            (off, min(chunk, rec.size - off))
            for off in range(0, rec.size, chunk)
        )

        failed: list = []

        async def _lane(fd: int) -> None:
            # windowed evacuation: drain deadlines are real — the serial
            # ping-pong wasted most of the window on round-trip latency.
            # One lane's failure aborts the transfer, so siblings stop at
            # the flag instead of draining the rest of a doomed object.
            while pending and not failed:
                off, ln = pending.popleft()
                try:
                    r = await node.conn.call(
                        "pull_chunk", shm_name=src, off=off, len=ln,
                        timeout=30,
                    )
                    data = r["data"]
                    if len(data) != ln:
                        raise ConnectionError("short read evacuating object")
                except BaseException as e:
                    failed.append(e)
                    raise
                os.pwrite(fd, data, off)  # out-of-order completions are fine

        try:
            fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o600)
            try:
                if rec.size:
                    os.ftruncate(fd, rec.size)
                    # return_exceptions: every lane must settle before the
                    # fd closes (a plain gather leaves siblings pwriting a
                    # closed fd after the first failure)
                    results = await asyncio.gather(
                        *(_lane(fd) for _ in range(min(window, len(pending)))),
                        return_exceptions=True,
                    )
                    for e in results:
                        if isinstance(e, BaseException):
                            raise e
            finally:
                os.close(fd)
        except asyncio.CancelledError:
            try:
                os.unlink(path)  # don't leak the partial segment either way
            except OSError:
                pass
            raise
        except Exception as e:
            try:
                os.unlink(path)
            except OSError:
                pass
            self._log_event(
                "drain_object_evac_failed", oid=rec.oid.hex(),
                node_id=node.node_id, error=repr(e),
            )
            return
        if rec.oid not in self.objects or rec.node_id != node.node_id:
            # freed or re-homed while the pull ran: drop the orphan bytes
            try:
                os.unlink(path)
            except OSError:
                pass
            return
        rec.node_id = LOCAL_NODE
        rec.shm_name = name
        rec.spill_path = None
        rec.pending_free = None
        self.stats["drain_objects_migrated"] += 1
        self.stats["objects_transferred"] += 1

    def _drain_quiesced(self, node: NodeRec) -> bool:
        """Evacuation finished and nothing is still running on the node —
        the drain can complete before its deadline."""
        if node.node_id not in self._drain_evac_done:
            return False
        for w in self.workers.values():
            if w.node_id == node.node_id and w.state in ("leased", "actor"):
                return False
        # agent-granted local leases (heartbeat-fed block occupancy)
        for hb in node.lease_used.values():
            if int((hb or {}).get("used", 0)) > 0:
                return False
        return True

    async def _drain_finalize(self, node: NodeRec):
        """Deadline reached or the node quiesced: the drain completes.  Any
        still-busy workers are deadline kills (their submitters retry for
        free), the worker table settles through the normal death path, and
        the agent is told to shut down so the provider can reclaim the VM."""
        if node.state != "draining":
            return
        busy = sum(
            1
            for w in self.workers.values()
            if w.node_id == node.node_id and w.state in ("leased", "actor")
        )
        busy += sum(
            int((hb or {}).get("used", 0)) for hb in node.lease_used.values()
        )
        if busy:
            self.stats["drain_deadline_kills"] += busy
        node.state = "drained"
        self.stats["nodes_drained"] += 1
        self._drain_evac_done.discard(node.node_id)
        self._log_event(
            "node_drained", node_id=node.node_id, reason=node.drain_reason,
            deadline_kills=busy,
        )
        # residual primaries (evacuation raced a new put, or a pull failed):
        # promote a survivor copy, else the object is genuinely lost
        for rec in list(self.objects.values()):
            rec.copies.pop(node.node_id, None)
            if rec.node_id == node.node_id:
                if not self._promote_copy(rec):
                    self.objects.pop(rec.oid, None)
                    self._log_event(
                        "object_lost", oid=rec.oid.hex(), node_id=node.node_id
                    )
        # the no-budget retry window must outlive the kills below
        self._pub_drain(node)
        for rec in list(self.workers.values()):
            if rec.node_id == node.node_id and rec.state != "dead":
                await self._on_worker_death(rec, "node drained")
        # the agent tears itself down (kills workers, sweeps shm, exits);
        # providers watching for `drained` may now terminate the VM
        if node.conn is not None and not node.conn.closed:
            try:
                node.conn.notify("node_shutdown")
            except Exception:
                pass
        self._pub("nodes", {"node_id": node.node_id, "alive": False, "state": "drained"})
        self._dirty = True
        self._service_queue()

    # --------------------------------------------------------------- objects
    def _free_shm_name(self, shm_name: str, node_id: str):
        """Release one physical copy: arena slices are reclaimed by their
        creating process's allocator (pubsub), dedicated segments unlinked on
        the node that holds them (locally for n0, via the agent otherwise)."""
        if "@" in shm_name:
            # arena slice: only the creating process's allocator can reclaim
            # it — parse the creator out of the arena file name,
            # .../arena_<client_id>_<seq>.
            fname = shm_name.split("@", 1)[0].rsplit("/", 1)[-1]
            cid = fname[len("arena_"): fname.rfind("_")]
            self._pub(f"shm_free:{cid}", {"shm_name": shm_name})
            return
        if node_id == LOCAL_NODE:
            drop_pull_map(self._pull_maps, shm_name)
            path = os.path.join("/dev/shm", shm_name)
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        else:
            node = self.nodes.get(node_id)
            if node is not None and node.conn is not None and not node.conn.closed:
                try:
                    node.conn.notify("unlink_shm", shm_name=shm_name)
                except Exception:
                    pass

    def _free_spill(self, path: str, node_id: str):
        if node_id == LOCAL_NODE:
            try:
                os.unlink(path)
            except OSError:
                pass
        else:
            node = self.nodes.get(node_id)
            if node is not None and node.conn is not None and not node.conn.closed:
                try:
                    node.conn.notify("unlink_spill", path=path)
                except Exception:
                    pass

    def _early_ref_add(self, oid: bytes, holder: str) -> None:
        """Park a holder registration that raced ahead of obj_created
        (cross-socket ordering).  The grace window is EXPLICIT and bounded:
        the first add stamps the entry, and the monitor loop expires entries
        older than config.early_ref_grace_s — a producer that died before
        registering must not pin its early refs forever (and dict insertion
        order is no longer load-bearing for cleanup)."""
        e = self._early_refs.get(oid)
        if e is None:
            e = self._early_refs[oid] = set()
            self._early_ref_ts[oid] = time.monotonic()
        e.add(holder)

    def _take_early_refs(self, oid: bytes) -> set:
        """Adopt (and clear) the parked holders at obj_created time."""
        self._early_ref_ts.pop(oid, None)
        return self._early_refs.pop(oid, set())

    def _obj_maybe_gc(self, rec: ObjectRec):
        if rec.owner_released and not rec.holders:
            self.objects.pop(rec.oid, None)
            self.stats["objects_gc"] += 1
            if rec.shm_name:
                self._free_shm_name(rec.shm_name, rec.node_id)
            if rec.pending_free:
                self._free_shm_name(rec.pending_free, rec.node_id)
            if rec.spill_path:
                self._free_spill(rec.spill_path, rec.node_id)
            for nid, name in rec.copies.items():
                self._free_shm_name(name, nid)
            if rec.device_holder:
                self._release_device_holder(rec)
            if rec.contains:
                # release this object's containment pins on nested refs
                edge = f"cnt:{rec.oid.hex()}"
                for r in rec.contains:
                    inner = self.objects.get(r)
                    if inner is not None:
                        inner.holders.discard(edge)
                        self._obj_maybe_gc(inner)
            if rec.cnt_pairs:
                # owner-resident edges of a ledgerless (client-mode) owner's
                # container: route each dec to the ledger holding the pin
                self._release_cnt_pairs(
                    f"cnt:{rec.owner}:{rec.oid.hex()}", rec.cnt_pairs
                )
                rec.cnt_pairs = None

    # --------------------------------------------------------------- handler
    _READONLY_METHODS = frozenset(
        {
            "heartbeat", "node_heartbeat", "node_sync", "kv_get", "kv_keys",
            "get_function",
            "obj_locate", "pull_chunk", "nodes", "cluster_resources", "stats",
            "client_addr", "lease_dir",
            "list_actors", "list_workers", "list_task_events", "list_objects",
            "metrics_snapshot", "autoscaler_state", "list_pgs", "pg_wait",
            "get_actor", "task_events", "metrics_report", "flightrec",
            "log_sub", "log_batch", "log_fetch", "timeseries", "profile",
            "ha_status", "head_replicate", "head_replicate_ack",
            "head_promote",
        }
    )

    # head dispatch latency: fine-grained low end (the hot handlers are
    # tens of µs; the knee shows up as mass shifting right)
    _DISPATCH_BOUNDS = [
        1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0,
    ]
    _INFLIGHT_BOUNDS = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0]

    def _self_hist_observe(
        self, name: str, desc: str, bounds, value: float, tags_key: str
    ) -> None:
        """Observe into a histogram owned BY the head (this process has no
        metric flusher — it writes the aggregation table directly, so the
        series flows to /metrics, snapshots, and the time-series store like
        any shipped metric)."""
        rec = self.metrics.get(name)
        if rec is None:
            rec = self.metrics[name] = {
                "type": "histogram", "desc": desc, "data": {}
            }
        cur = rec["data"].get(tags_key)
        if cur is None:
            cur = rec["data"][tags_key] = {
                "buckets": [0] * (len(bounds) + 1), "sum": 0.0, "count": 0,
                "bounds": list(bounds),
            }
        import bisect

        cur["buckets"][bisect.bisect_left(bounds, value)] += 1
        cur["sum"] += value
        cur["count"] += 1

    def _self_gauge_set(self, name: str, desc: str, value: float) -> None:
        rec = self.metrics.get(name)
        if rec is None:
            rec = self.metrics[name] = {"type": "gauge", "desc": desc, "data": {}}
        rec["data"]["[]"] = float(value)

    def _method_tags_key(self, m: str) -> str:
        tk = self._self_tags_keys.get(m)
        if tk is None:
            tk = self._self_tags_keys[m] = json.dumps([["method", m]])
        return tk

    def _fence_refuse(self, state, msg, reply_err, nid, inc) -> None:
        """Refuse an RPC minted under a dead/superseded node incarnation.

        Requests get a FencedError reply; notifies (no "i") are dropped.
        Either way the sender is told via a `fenced` push frame, so a zombie
        that only ever notifies (heartbeats, ledger syncs) still learns its
        death verdict at heal time and can cancel its leases/tasks instead
        of completing duplicate side effects."""
        self.stats["fenced_rpcs"] = self.stats.get("fenced_rpcs", 0) + 1
        self._log_event(
            "rpc_fenced", method=msg.get("m"), node_id=nid, inc=inc,
            client_id=state.get("client_id"),
        )
        try:
            write_frame(state["writer"], {"m": "fenced", "node_id": nid, "ninc": inc})
        except Exception:
            pass
        if msg.get("i") is not None:
            node = self.nodes.get(nid)
            reply_err(FencedError(
                f"node {nid!r} incarnation {inc} was declared dead and its "
                f"state adopted (current: "
                f"{node.incarnation if node else 'unregistered'}); cancel "
                f"outstanding leases/tasks, tear down, and rejoin fresh"
            ))

    async def _handle(self, state, msg, reply, reply_err):
        m = msg["m"]
        h = getattr(self, "_h_" + m, None)
        if h is None:
            reply_err(ValueError(f"unknown head method {m}"))
            return
        # head-epoch authority gate (HA plane) — the node-incarnation fence
        # below, generalized to the head itself.  Ordering matters: learn of
        # a successor (demote) BEFORE refusing anything, and refuse
        # non-active roles BEFORE stale-stamp clients, so a standby/zombie
        # never executes an authority-bearing handler.
        hep = msg.get("hep")
        if hep is not None and hep > self.head_epoch:
            # a peer proves a successor head was promoted past us: THIS
            # process is the zombie — demote before touching any table
            self._ha_demote(hep, via=f"rpc:{m}")
        if self.ha_role != "active" and m not in self._HA_PASSIVE_METHODS:
            self._ha_refuse(state, msg, reply_err)
            return
        if hep is not None and hep < self.head_epoch and m != "register":
            # an RPC stamped under a superseded head epoch: make the sender
            # re-register (adopting the current epoch) before any
            # authority-bearing side effect can land
            self._ha_refuse(state, msg, reply_err, stale_client=True)
            return
        # incarnation fence: authority-bearing RPCs from workers/agents are
        # stamped with their node's incarnation (Connection.stamp / agent
        # fields); a stamp that no longer matches the node table means the
        # head declared that node dead and adopted its state — refuse before
        # dispatch so no stale-authority side effect (grant use, ledger
        # write, object/task report, KV commit) can land.  register is
        # exempt: its own dead-worker/stale-agent logic issues the verdict.
        inc = msg.get("ninc")
        if inc is not None and m != "register":
            nid = msg.get("node_id") or state.get("node_id")
            node = self.nodes.get(nid) if nid else None
            if node is None or node.state == "dead" or node.incarnation != inc:
                self._fence_refuse(state, msg, reply_err, nid, inc)
                return
        self.rpc_counts[m] += 1
        if m not in self._READONLY_METHODS:
            self._dirty = True  # persisted by the debounced snapshot loop
            self._repl_dirty = True  # replicated by the next HA delta tick
        tk = self._method_tags_key(m)
        self._dispatch_inflight += 1
        self._self_hist_observe(
            "ca_head_dispatch_inflight",
            "handlers in flight on the head loop when each RPC dispatched "
            "(queue-depth proxy), by method",
            self._INFLIGHT_BOUNDS, float(self._dispatch_inflight), tk,
        )
        t0 = time.perf_counter()
        try:
            await h(state, msg, reply, reply_err)
        except FencedError as e:
            # one of OUR outbound calls (made from inside the handler) was
            # epoch-fenced by an agent or successor head: a newer authority
            # exists somewhere — demote instead of retrying as a zombie.
            # Incarnation fences (node-scoped) pass through untouched.
            if "head epoch" in str(e):
                self._ha_demote(None, via=f"handler:{m}")
            reply_err(e)
        finally:
            self._dispatch_inflight -= 1
            self._self_hist_observe(
                "ca_head_dispatch_seconds",
                "head handler dispatch latency by RPC method",
                self._DISPATCH_BOUNDS, time.perf_counter() - t0, tk,
            )

    async def _h_register(self, state, msg, reply, reply_err):
        role = msg["role"]
        client_id = msg["client_id"]
        state["client_id"] = client_id
        state["role"] = role
        self._clients[client_id] = state
        if role == "agent":
            await self._register_agent(state, msg, reply, reply_err)
            return
        state["node_id"] = msg.get("node_id", LOCAL_NODE)
        # network-chaos labeling: this registration socket's peer lives on
        # that node — replies/pushes toward a partitioned node must drop
        netchaos.label_writer(state["writer"], state["node_id"])
        # remote (Ray-Client-analogue) drivers: they reach workers over TCP
        # only, and their node is a client-private namespace no one schedules
        # onto — worker/actor addresses handed to them must be the TCP duals
        state["remote"] = bool(msg.get("remote"))
        # every client gets its private shm-reclaim channel (arena slices can
        # only be freed by their owner's allocator)
        self.subscribers.setdefault(f"shm_free:{client_id}", []).append(state["writer"])
        if role == "driver":
            self._driver_clients.add(client_id)
            # actor address pubs (create/restart) keep the driver's
            # _actor_addr_cache warm.  Subscribed here, server-side, like the
            # shm_free channel: `ca lint` found the old client-side
            # `subscribe` RPC had no caller, so these pubs fanned out to
            # nobody and every driver paid a get_actor refresh per restart
            self.subscribers.setdefault("actors", []).append(state["writer"])
        if role in ("driver", "worker"):
            # node-death pubs: a PARTITIONED node's sockets never close by
            # themselves (frames just vanish), so every SUBMITTER — drivers
            # AND worker processes running nested tasks — needs the death
            # verdict pushed to fail its in-flight pushes over to survivors
            # (worker._on_node_dead_pub)
            self.subscribers.setdefault("nodes", []).append(state["writer"])
        self._departed_clients.pop(client_id, None)  # it's back: not dead
        if msg.get("addr") or msg.get("addr_tcp"):
            self.client_addrs[client_id] = {
                "addr": msg.get("addr") or "",
                "addr_tcp": msg.get("addr_tcp") or "",
                "node": state["node_id"],
            }
        if role == "worker":
            rec = self.workers.get(client_id)
            if rec is not None and rec.state == "dead":
                # fenced: a worker this head declared dead must not rejoin
                # (it may hold stale leases/actor state)
                reply_err(ConnectionError("worker was declared dead; exit"))
                return
            if rec is None:
                # externally started worker; register it on its node
                rec = WorkerRec(
                    client_id, msg.get("pid", 0), msg["addr"],
                    node_id=msg.get("node_id", LOCAL_NODE),
                )
                self.workers[client_id] = rec
            if msg.get("addr"):
                rec.addr = msg["addr"]
            if msg.get("addr_tcp"):
                rec.addr_tcp = msg["addr_tcp"]
            if msg.get("pid"):
                rec.pid = msg["pid"]
            rec.last_heartbeat = time.monotonic()
            if rec.purpose == "actor":
                rec.state = "actor"
                rec.busy_since = time.monotonic()
            elif rec.state in ("starting", "idle"):
                # leased workers reconnecting after a head restart keep their
                # lease; only fresh/idle ones (re)join the pool
                node = self.nodes.get(rec.node_id)
                pool_adopt = self._pending_block_adopt.pop(
                    (rec.node_id, client_id), None
                )
                if pool_adopt is not None and node is not None and node.state == "alive":
                    # the node's agent already holds this worker in a lease
                    # block (reported at its re-registration, before the
                    # worker re-registered here): adopt it as delegated —
                    # NOT idle — or both planes would grant it
                    self._take(node.avail, LEASE_UNIT_SHAPES[pool_adopt])
                    rec.state = "delegated"
                    node.delegated.setdefault(pool_adopt, set()).add(client_id)
                else:
                    rec.state = "idle"
                    if node is not None and node.state == "alive":
                        if client_id not in node.idle[rec.pool]:
                            node.idle[rec.pool].append(client_id)
            fut = self._register_waiters.pop(client_id, None)
            if fut is not None and not fut.done():
                fut.set_result(True)
            netchaos.register_addr(msg.get("addr"), rec.node_id)
            netchaos.register_addr(msg.get("addr_tcp"), rec.node_id)
            self._service_queue()
        extra = {}
        reg_node = self.nodes.get(state["node_id"])
        if reg_node is not None:
            # the client's node incarnation: workers stamp it onto every
            # authority-bearing RPC (Connection.stamp) so stale-incarnation
            # survivors of a partition are fenced, not believed
            extra["node_inc"] = reg_node.incarnation
        if self._net_chaos_spec:
            # a runtime-installed chaos schedule covers late joiners too —
            # with its ORIGINAL epoch, or healed windows would re-open
            extra["net_chaos"] = self._net_chaos_spec
            extra["net_chaos_epoch"] = self._net_chaos_epoch
        reply(
            node_id=state["node_id"],
            session=self.session_name,
            resources=self._agg_total(),
            head_tcp=self.tcp_addr,
            head_epoch=self.head_epoch,
            standbys=self._ha_standby_addrs(),
            **extra,
        )
        # late joiners learn about in-progress drains (their retries on those
        # nodes must be budget-exempt too)
        for node in self.nodes.values():
            if node.state == "draining":
                try:
                    write_frame(state["writer"], self._drain_pub_frame(node))
                except Exception:
                    pass

    async def _register_agent(self, state, msg, reply, reply_err):
        node_id = msg["client_id"]
        netchaos.label_writer(state["writer"], node_id)
        existing = self.nodes.get(node_id)
        reported_inc = msg.get("ninc")
        if (
            existing is not None
            and existing.state == "dead"
            and reported_inc is not None
        ):
            # a partitioned-then-healed agent re-registering with the token
            # of an incarnation this head already declared dead: deliver the
            # verdict.  The agent reacts by killing its (zombie) workers,
            # dropping every delegated block and local grant, sweeping its
            # shm namespace, and re-registering WITHOUT a token — which the
            # fresh-join path below accepts at a bumped incarnation.
            self.stats["fenced_rpcs"] = self.stats.get("fenced_rpcs", 0) + 1
            self._log_event(
                "agent_register_fenced", node_id=node_id, inc=reported_inc
            )
            reply_err(FencedError(
                f"node {node_id!r} incarnation {reported_inc} was declared "
                f"dead; purge local state (workers, lease blocks, shm) and "
                f"rejoin fresh"
            ))
            return
        if existing is not None and existing.up:
            if existing.conn is None or existing.conn.closed:
                # agent reconnecting to a restarted head: re-adopt in place
                # (resource accounting was restored from the snapshot)
                existing.addr = msg["addr"]
                existing.pid = msg.get("pid", existing.pid)
                existing.last_heartbeat = time.monotonic()
                existing.metrics_addr = msg.get("metrics_addr") or existing.metrics_addr
                state["node_id"] = node_id
                await self._connect_agent(existing)
                if not existing.up:
                    reply_err(ConnectionError(f"head cannot reach agent at {existing.addr}"))
                    return
                self._log_event("node_readopted", node_id=node_id)
                # local grants kept flowing while the head was down; adopt
                # the agent's authoritative block state before scheduling
                self._reconcile_lease_blocks(existing, msg.get("lease_blocks") or {})
                reply(
                    node_id=node_id, session=self.session_name,
                    head_tcp=self.tcp_addr, incarnation=existing.incarnation,
                    head_epoch=self.head_epoch,
                    standbys=self._ha_standby_addrs(),
                )
                self._service_queue()
                return
            reply_err(ValueError(f"node id {node_id!r} already registered"))
            return
        # fresh join (first registration, or a purged rejoin over a dead
        # record): mint a strictly increasing incarnation — larger than any
        # token this node id ever held, even across snapshotless restarts
        # (the agent reports its last token for exactly that reason)
        inc = max(
            self._node_incarnations.get(node_id, 0), int(reported_inc or 0)
        ) + 1
        self._node_incarnations[node_id] = inc
        node = self._add_node(
            NodeRec(
                node_id,
                msg["addr"],
                dict(msg.get("resources") or {}),
                dict(msg.get("resources") or {}),
                pid=msg.get("pid", 0),
                incarnation=inc,
                # the agent detects its own labels (its env, not the head's)
                labels={
                    **{str(k): str(v) for k, v in (msg.get("labels") or {}).items()},
                    "ca.io/node-id": node_id,
                },
            )
        )
        state["node_id"] = node_id
        node.metrics_addr = msg.get("metrics_addr") or None
        netchaos.register_addr(msg["addr"], node_id)
        self.stats["nodes_joined"] += 1
        self._log_event(
            "node_joined", node_id=node_id, resources=node.total,
            incarnation=inc,
        )
        await self._connect_agent(node)
        if node.state != "alive":
            # dial-back failed (unreachable advertised address): the join is
            # a failure, not a silent capacity loss
            reply_err(ConnectionError(f"head cannot reach agent at {node.addr}"))
            return
        if msg.get("lease_blocks"):
            # agent outlived a snapshotless head restart: its blocks are the
            # only record of the delegation
            self._reconcile_lease_blocks(node, msg["lease_blocks"])
        self._pub("nodes", {"node_id": node_id, "alive": True, "resources": node.total})
        extra = {}
        if self._net_chaos_spec:
            extra["net_chaos"] = self._net_chaos_spec
            extra["net_chaos_epoch"] = self._net_chaos_epoch
        reply(
            node_id=node_id, session=self.session_name,
            head_tcp=self.tcp_addr, incarnation=inc,
            head_epoch=self.head_epoch, standbys=self._ha_standby_addrs(),
            **extra,
        )
        self._service_queue()

    async def _h_node_heartbeat(self, state, msg, reply, reply_err):
        node = self.nodes.get(msg.get("node_id", state.get("node_id")))
        if node is not None:
            node.last_heartbeat = time.monotonic()
            if "mem_pressured" in msg:
                node.mem_pressured = bool(msg["mem_pressured"])
            if "load" in msg:
                node.load = msg["load"]
            if "lease_stats" in msg:
                # agent-side block occupancy (delegated vs used) for
                # `ca status` / /api/nodes / lease_dir freshness
                node.lease_used = msg["lease_stats"] or {}
            if "metrics" in msg:
                # metrics-plane piggyback: the node's queued worker deltas
                from ..util.metrics import merge_metric_records

                merge_metric_records(self.metrics, msg["metrics"])
            if "flightrec" in msg:
                self._ingest_flightrec(msg["flightrec"])

    async def _h_node_sync(self, state, msg, reply, reply_err):
        """Delta-synced node state (the ray_syncer analogue, head-ward):
        agents send versioned component deltas instead of full per-tick
        heartbeats.  A bare {node_id} frame is a keepalive (liveness only);
        components present in the frame replace the stored state; a frame
        with full=True replaces everything (reconnect resync).  The
        mem-pressure component carries a [flag, tick] pair while pressured
        so the kill policy's clear-after-acting re-arm keeps working."""
        node = self.nodes.get(msg.get("node_id", state.get("node_id")))
        if node is None:
            return
        node.last_heartbeat = time.monotonic()
        if "v" in msg:
            node.sync_version = msg["v"]
        if "load" in msg:
            node.load = msg["load"]
        if "lease_stats" in msg:
            node.lease_used = msg["lease_stats"] or {}
        if "mem_pressured" in msg:
            v = msg["mem_pressured"]
            node.mem_pressured = (
                bool(v[0]) if isinstance(v, (list, tuple)) else bool(v)
            )
        if "metrics" in msg:
            # metrics-plane piggyback: worker metric deltas the node's agent
            # queued since its last tick ride the sync frame — the head's
            # cluster table stays fed with ZERO standalone metric RPCs from
            # agent-node workers
            from ..util.metrics import merge_metric_records

            merge_metric_records(self.metrics, msg["metrics"])
        if "flightrec" in msg:
            # flight-recorder piggyback: the node's queued journal slices
            # (workers + agent) merge into the cluster ring the same way
            self._ingest_flightrec(msg["flightrec"])

    async def _h_owner_sync(self, state, msg, reply, reply_err):
        """An owner's ledger digest (versioned delta, or full on reconnect):
        what the head adopts if that owner dies.  Entries carry the borrower
        set ("b"), the owner-released flag ("r"), and whether the object is
        registered here ("g"); removed oids settle out of the digest."""
        cid = state.get("client_id", "?")
        digest = self.owner_digests.setdefault(cid, {})
        if msg.get("full"):
            digest.clear()
        for oid, info in (msg.get("e") or {}).items():
            digest[oid] = info
        for oid in msg.get("rm") or ():
            digest.pop(oid, None)

    async def _h_obj_release(self, state, msg, reply, reply_err):
        """An owner's ledger settled an object's cluster-wide lifetime (the
        registry half of ownership-plane GC): drop the record and reclaim
        whatever physical copies the owner could not free itself — it
        already freed its local slices/spill files and says so in `freed`,
        which must not be double-freed (arena slices get recycled)."""
        cid = state.get("client_id", "?")
        digest = self.owner_digests.get(cid)
        released = 0
        for pair in msg.get("rel") or ():
            oid, freed = pair[0], set(pair[1] or ())
            if digest is not None:
                digest.pop(oid, None)
            rec = self.objects.get(oid)
            if rec is None:
                # never registered (inline-only) or already reaped: drop any
                # stray early refs so they don't age out as "expired"
                if self._early_refs.pop(oid, None) is not None:
                    self._early_ref_ts.pop(oid, None)
                continue
            if rec.shm_name in freed:
                rec.shm_name = None
            if rec.pending_free in freed:
                rec.pending_free = None
            if rec.spill_path and ("spill:" + rec.spill_path) in freed:
                rec.spill_path = None
            # the owner is the lifetime authority: its settle overrides any
            # head-side holder residue (early strays, fallback pins)
            rec.owner_released = True
            rec.holders.clear()
            self._obj_maybe_gc(rec)
            released += 1
        if released:
            self.stats["objects_released_by_owner"] = (
                self.stats.get("objects_released_by_owner", 0) + released
            )

    async def _h_worker_exit(self, state, msg, reply, reply_err):
        """Node agent reports one of its worker processes exited."""
        rec = self.workers.get(msg["wid"])
        if rec is not None:
            await self._on_worker_death(
                rec, self._exit_status(msg.get("rc")) or "agent reported"
            )

    async def _h_heartbeat(self, state, msg, reply, reply_err):
        rec = self.workers.get(msg.get("client_id", state.get("client_id")))
        if rec is not None:
            rec.last_heartbeat = time.monotonic()

    async def _h_request_lease(self, state, msg, reply, reply_err):
        ttl = msg.get("ttl")
        req = LeaseReq(
            shape=msg.get("shape") or {"CPU": 1.0},
            reply=reply,
            reply_err=reply_err,
            client=state.get("client_id", "?"),
            pg_id=msg.get("pg_id"),
            bundle_index=msg.get("bundle_index", -1),
            strategy=msg.get("strategy"),
            remote=bool(state.get("remote")),
            deadline=(time.monotonic() + float(ttl)) if ttl else None,
        )
        if not self._try_grant(req):
            self.pending_leases.append(req)
            if req.deadline is None:
                self._last_central_demand = time.monotonic()
            self._ensure_pool()
            self._nudge_lease_holders(req.client)

    def _nudge_lease_holders(self, requester: str):
        """A lease request just queued while other clients hold leases:
        push a reclaim hint so holders return their IDLE leases now instead
        of after the 1s idle timeout.  Without this, concurrent client
        batches serialize with ~1s gaps (each waits out the previous
        holder's idle-return) — the multi-client aggregate collapse.
        Debounced: a queued burst nudges once per 100ms."""
        now = time.monotonic()
        if now - self._last_reclaim_nudge < 0.1:
            return
        self._last_reclaim_nudge = now
        holders = set(self._lease_client.values())
        parties = holders | {r.client for r in self.pending_leases}
        if requester:
            parties.add(requester)
        if len(parties) <= 1:
            # a single client contending with itself (e.g. SPREAD growth
            # waiting on cold nodes' workers to spawn) is not a fairness
            # problem — capping it would defeat the growth it is waiting for
            return
        n_workers = sum(
            1
            for w in self.workers.values()
            if w.purpose == "pool" and w.state in ("starting", "idle", "leased")
        )
        cap = max(1, n_workers // max(1, len(parties)))
        for cid in holders:
            if cid == requester:
                continue  # its own pools keep leases they still need
            state = self._clients.get(cid)
            if state is None:
                continue
            try:
                write_frame(
                    state["writer"],
                    {"m": "pub", "ch": "lease_reclaim", "data": {"cap": cap}},
                )
            except Exception:
                pass

    async def _h_return_lease(self, state, msg, reply, reply_err):
        for lid in msg["lease_ids"]:
            self._release_lease(lid)

    def _blocked_shape_node(self, rec: WorkerRec):
        shape = None
        if rec.lease_id:
            shape = self._lease_shapes.get(rec.lease_id)
        elif rec.actor_id and rec.actor_id in self.actors:
            shape = self.actors[rec.actor_id].resources
        elif rec.state == "delegated":
            # agent-granted lease: the head holds no per-lease record, but
            # the slot's unit charge is known — blocked-in-get() workers
            # release it so nested tasks can run (deadlock avoidance)
            shape = LEASE_UNIT_SHAPES.get(rec.pool)
        return shape, self.nodes.get(rec.node_id)

    async def _h_worker_blocked(self, state, msg, reply, reply_err):
        # a leased/actor worker blocked in get(): release its cpus so nested
        # tasks can run (deadlock avoidance, as the reference raylet does when
        # a worker blocks — local_task_manager ReleaseCpuResourcesFromBlockedWorker)
        wid = msg.get("client_id", state.get("client_id"))
        rec = self.workers.get(wid)
        if rec is not None and not rec.blocked:
            rec.blocked = True
            shape, node = self._blocked_shape_node(rec)
            cpus = (shape or {}).get("CPU", 0.0)
            if cpus and node is not None and node.up:
                self._give(node.avail, {"CPU": cpus})
                self._service_queue()

    async def _h_worker_unblocked(self, state, msg, reply, reply_err):
        wid = msg.get("client_id", state.get("client_id"))
        rec = self.workers.get(wid)
        if rec is not None and rec.blocked:
            rec.blocked = False
            shape, node = self._blocked_shape_node(rec)
            cpus = (shape or {}).get("CPU", 0.0)
            if cpus and node is not None and node.up:
                # oversubscribe temporarily rather than deadlock
                self._take(node.avail, {"CPU": cpus})

    async def _h_create_actor(self, state, msg, reply, reply_err):
        a = ActorRec(
            actor_id=msg["actor_id"],
            name=msg.get("name"),
            fn_id=msg["fn_id"],
            init_spec=msg["init_spec"],
            resources=msg.get("resources") or {},
            max_restarts=msg.get("max_restarts", 0),
            detached=msg.get("detached", False),
            max_concurrency=msg.get("max_concurrency", 1),
            concurrency_groups=msg.get("concurrency_groups"),
            method_options=msg.get("method_options"),
            pg_id=msg.get("pg_id"),
            bundle_index=msg.get("bundle_index", -1),
            runtime_env=msg.get("runtime_env"),
            strategy=msg.get("strategy"),
            drain_migration=msg.get("drain_migration", True),
        )
        if a.name:
            if a.name in self.named_actors:
                reply_err(ValueError(f"actor name {a.name!r} already taken"))
                return
            self.named_actors[a.name] = a.actor_id
        self.actors[a.actor_id] = a
        await self._place_actor(a)
        if a.state == "alive":
            reply(addr=self._actor_addr_for(a, state), incarnation=a.incarnation)
        else:
            self._drop_actor_name(a)
            reply_err(ActorDiedError(a.death_cause))

    def _actor_addr_for(self, a: ActorRec, state) -> Optional[str]:
        if state.get("remote") and a.worker_id:
            rec = self.workers.get(a.worker_id)
            if rec is not None and rec.addr_tcp:
                return rec.addr_tcp
        return a.addr

    async def _h_get_actor(self, state, msg, reply, reply_err):
        aid = msg.get("actor_id")
        if aid is None and msg.get("name") is not None:
            aid = self.named_actors.get(msg["name"])
            if aid is None:
                reply_err(ValueError(f"no actor named {msg['name']!r}"))
                return
        a = self.actors.get(aid)
        if a is None:
            reply_err(ValueError("actor not found"))
            return
        info = self._actor_info(a)
        info["fn_id"] = a.fn_id
        info["addr"] = self._actor_addr_for(a, state)
        reply(**info)

    async def _h_kill_actor(self, state, msg, reply, reply_err):
        a = self.actors.get(msg["actor_id"])
        if a is None:
            reply()
            return
        if msg.get("no_restart", True):
            a.max_restarts = 0
        a.death_cause = "killed via kill()"
        rec = self.workers.get(a.worker_id) if a.worker_id else None
        if rec is not None:
            self._kill_worker_rec(rec)
        reply()

    def _kill_worker_rec(self, rec: WorkerRec):
        if rec.proc is not None and rec.proc.poll() is None:
            try:
                os.kill(rec.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        elif rec.proc is None and rec.node_id == LOCAL_NODE and rec.pid:
            # re-adopted after head restart: no Popen handle, kill by pid
            try:
                os.kill(rec.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        elif rec.proc is None:
            node = self.nodes.get(rec.node_id)
            if node is not None and node.conn is not None and not node.conn.closed:
                try:
                    node.conn.notify("kill_worker", wid=rec.worker_id)
                except Exception:
                    pass

    async def _h_actor_exited(self, state, msg, reply, reply_err):
        # graceful actor exit (__ray_terminate__ analogue): no restart
        a = self.actors.get(msg["actor_id"])
        if a is not None:
            a.max_restarts = 0
            a.death_cause = "actor exited"

    # KV ------------------------------------------------------------------
    async def _h_kv_put(self, state, msg, reply, reply_err):
        ns = self.kv.setdefault(msg.get("ns", ""), {})
        exists = msg["key"] in ns
        if not (msg.get("overwrite", True) is False and exists):
            ns[msg["key"]] = msg["value"]
            if self._repl_subs:
                # acked-commit guarantee: the reply below IS the ack the
                # client keys side effects off, so the commit must be
                # standby-resident (synchronously replicated) first
                await self._repl_commit(
                    {"t": "kv", "op": "put", "ns": msg.get("ns", ""),
                     "key": msg["key"], "value": msg["value"],
                     "overwrite": msg.get("overwrite", True)}
                )
        reply(added=not exists)

    async def _h_kv_get(self, state, msg, reply, reply_err):
        ns = self.kv.get(msg.get("ns", ""), {})
        reply(value=ns.get(msg["key"]))

    async def _h_kv_del(self, state, msg, reply, reply_err):
        ns_name = msg.get("ns", "")
        ns = self.kv.get(ns_name, {})
        deleted = 1 if ns.pop(msg["key"], None) is not None else 0
        if not ns and ns_name in self.kv:
            # drop emptied namespaces: per-op rendezvous namespaces
            # (collectives) would otherwise leave O(ops) empty dicts in
            # the KV and in every debounced snapshot
            del self.kv[ns_name]
        if deleted and self._repl_subs:
            await self._repl_commit(
                {"t": "kv", "op": "del", "ns": ns_name, "key": msg["key"]}
            )
        reply(deleted=deleted)

    async def _h_kv_keys(self, state, msg, reply, reply_err):
        ns = self.kv.get(msg.get("ns", ""), {})
        prefix = msg.get("prefix", "")
        reply(keys=[k for k in ns.keys() if k.startswith(prefix)])

    async def _h_register_function(self, state, msg, reply, reply_err):
        ns = self.kv.setdefault("__functions__", {})
        ns[msg["fn_id"]] = msg["blob"]
        reply()

    async def _h_get_function(self, state, msg, reply, reply_err):
        blob = self.kv.get("__functions__", {}).get(msg["fn_id"])
        if blob is None:
            reply_err(KeyError(f"function {msg['fn_id']!r} not registered"))
        else:
            reply(blob=blob)

    # pubsub ---------------------------------------------------------------
    # (the old `subscribe`/`publish` RPC handlers are gone: no call site ever
    # existed — rpc-dead-handler — and client-facing pubsub happens by
    # server-side subscription at register: shm_free:<cid> and `actors`)

    # log plane -------------------------------------------------------------
    async def _h_log_sub(self, state, msg, reply, reply_err):
        """Driver (un)subscribes to the cluster log stream.  Sent as a
        notify right after register when log_to_driver is on."""
        cid = state.get("client_id") or f"anon-{id(state)}"
        if msg.get("on", True):
            self._log_subs[cid] = state["writer"]
        else:
            self._log_subs.pop(cid, None)
        reply()

    async def _h_log_batch(self, state, msg, reply, reply_err):
        """A node agent shipped a batch of captured records: fan out to
        subscribed drivers (the GCS-pubsub leg of the log monitor path)."""
        self._forward_logs(msg.get("records") or [])

    def _forward_logs(self, records) -> None:
        if not records or not self._log_subs:
            return
        dead = []
        delivered = False
        for cid, writer in self._log_subs.items():
            try:
                buf = writer.transport.get_write_buffer_size()
            except Exception:
                buf = 0
            if buf > (4 << 20):
                # bounded buffers, not backpressure: a stalled subscriber
                # loses this batch rather than stalling capture or workers
                self.stats["log_lines_dropped"] += len(records)
                continue
            try:
                write_frame(writer, {"m": "log_batch", "records": records})
                delivered = True
            except Exception:
                dead.append(cid)
        for cid in dead:
            self._log_subs.pop(cid, None)
        if delivered:
            self.stats["log_lines_shipped"] += len(records)

    async def _log_tail_loop(self):
        """Tail the head node's own capture files (n0 workers + the head
        itself) and forward — the local-node twin of the agents' ship loop."""
        from ..util.logplane import LogTailer, node_log_dir

        tailer = LogTailer(
            node_log_dir(self.session_dir, LOCAL_NODE),
            max_records=self.config.log_ship_batch,
        )
        period = max(self.config.log_ship_interval_s, 0.05)
        while not self._shutdown.is_set():
            await asyncio.sleep(period)
            if not self._log_subs:
                continue  # offsets hold; a late subscriber gets the backlog
            try:
                records = tailer.poll()
            except Exception:
                continue
            if records:
                self._forward_logs(records)

    def _resolve_log_target(self, ident) -> Tuple[str, str]:
        """Resolve a worker/actor/task/node id (or "head"/None) to
        (node_id, file base name) for the query plane."""
        if not ident or ident == "head":
            return (LOCAL_NODE, "head")
        if ident in self.nodes:
            return (ident, "head" if ident == LOCAL_NODE else "agent")
        rec = self.workers.get(ident)
        if rec is None:
            a = self.actors.get(ident)
            if a is not None and a.worker_id:
                rec = self.workers.get(a.worker_id)
        if rec is None:
            # task id: newest attribution wins (retries may have moved it)
            for e in reversed(self.task_events):
                if e.get("task_id") == ident and e.get("worker_id"):
                    rec = self.workers.get(e["worker_id"])
                    break
        if rec is None:
            raise FileNotFoundError(
                f"no log found for {ident!r}: not a known worker/actor/task/"
                "node id (try `ca list workers`)"
            )
        return (rec.node_id, rec.worker_id)

    async def _log_fetch_data(self, ident, tail: int = 200, off=None,
                              structured: bool = False,
                              trace: Optional[str] = None) -> dict:
        """Read/tail a log wherever it lives: local files directly, other
        nodes through their agent's log_read RPC (no shared filesystem).
        `trace` filters to lines stamped with that trace id (log records
        carry the ambient span of the code that printed them) — it implies
        the structured JSONL read, since the raw capture has no stamps."""
        from ..util.logplane import node_log_dir, tail_file

        if trace:
            structured = True
        node_id, name = self._resolve_log_target(ident)
        if node_id == LOCAL_NODE:
            if structured:
                path = os.path.join(
                    node_log_dir(self.session_dir, LOCAL_NODE), f"{name}.jsonl"
                )
            else:
                # raw fd-redirect logs: head.log and head-spawned workers
                # live at the session root
                path = os.path.join(self.session_dir, f"{name}.log")
            try:
                data, new_off = tail_file(path, tail=tail, off=off)
            except (FileNotFoundError, OSError):
                raise FileNotFoundError(
                    f"no log for {ident!r} yet (expected at {path})"
                )
            if trace:
                data = self._filter_log_trace(data, trace)
            return {"data": data, "off": new_off, "node_id": node_id}
        node = self.nodes.get(node_id)
        if node is None or not node.up or node.conn is None or node.conn.closed:
            # RuntimeError, not ConnectionError: a pickled ConnectionError
            # would look like "head down" to head_call's reconnect retry loop
            raise RuntimeError(
                f"node {node_id!r} (owner of {ident!r}) is unreachable"
            )
        try:
            r = await node.conn.call(
                "log_read", name=name, tail=tail, off=off,
                structured=structured, timeout=10,
            )
        except (ConnectionError, asyncio.TimeoutError):
            raise RuntimeError(
                f"node {node_id!r} (owner of {ident!r}) stopped answering"
            )
        out = {"data": r["data"], "off": r["off"], "node_id": node_id}
        if trace:
            out["data"] = self._filter_log_trace(out["data"], trace)
        return out

    @staticmethod
    def _filter_log_trace(data: str, trace: str) -> str:
        """Keep only JSONL records stamped with this trace id."""
        kept = []
        for line in data.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if (rec.get("trace") or {}).get("tid") == trace:
                kept.append(line)
        return "\n".join(kept) + ("\n" if kept else "")

    def _log_counter_totals(self) -> Dict[str, int]:
        """Cluster-wide ca_log_* capture counters summed from the metrics
        table (shared by `ca status` stats and the dashboard /api/logplane)."""
        out = {}
        for mname in (
            "ca_log_lines_total", "ca_log_bytes_total", "ca_log_dropped_total"
        ):
            rec = self.metrics.get(mname)
            out[mname] = (
                int(sum(rec["data"].values())) if rec and rec.get("data") else 0
            )
        return out

    async def _h_log_fetch(self, state, msg, reply, reply_err):
        try:
            out = await self._log_fetch_data(
                msg.get("id"),
                tail=int(msg.get("tail") or 200),
                off=msg.get("off"),
                structured=bool(msg.get("structured")),
                trace=msg.get("trace"),
            )
        except (FileNotFoundError, RuntimeError, ValueError) as e:
            reply_err(e)
            return
        reply(**out)

    # objects --------------------------------------------------------------
    # ---- remote-client object upload (Ray-Client analogue data path) ----
    # A remote driver's /dev/shm is invisible to the cluster, so its puts
    # stream here in chunks; the head hosts the bytes in its own n0
    # namespace and registers the object with the client as owner.

    async def _h_client_put_begin(self, state, msg, reply, reply_err):
        import mmap as _mmap

        oid = msg["oid"]
        size = int(msg["size"])
        if size > self.config.object_store_memory:
            # no spill path exists for client uploads: refuse anything the
            # head's store budget could never hold rather than filling
            # /dev/shm until the whole node falls over
            reply_err(ObjectStoreFullError(
                f"client put of {size} bytes exceeds the head's object store "
                f"budget ({self.config.object_store_memory})"
            ))
            return
        name = f"{self.session_name}/{LOCAL_NODE}/cput_{oid.hex()}"
        path = os.path.join("/dev/shm", name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o600)
        try:
            os.ftruncate(fd, max(size, 1))
            m = _mmap.mmap(fd, max(size, 1))
        finally:
            os.close(fd)
        state.setdefault("cput", {})[oid] = (name, m, size)
        reply(name=name)

    async def _h_client_put_chunk(self, state, msg, reply, reply_err):
        ent = state.get("cput", {}).get(msg["oid"])
        if ent is None:
            reply_err(ValueError("client_put_begin missing for this oid"))
            return
        _, m, _ = ent
        off = msg["off"]
        data = msg["data"]
        m[off : off + len(data)] = data
        reply()

    async def _h_client_put_seal(self, state, msg, reply, reply_err):
        oid = msg["oid"]
        ent = state.get("cput", {}).pop(oid, None)
        if ent is None:
            reply_err(ValueError("client_put_begin missing for this oid"))
            return
        name, m, size = ent
        m.close()
        existing = self.objects.get(oid)
        if existing is not None:
            if existing.shm_name and existing.shm_name != name:
                self._free_shm_name(existing.shm_name, existing.node_id)
            existing.shm_name = name
            existing.size = size
            existing.node_id = LOCAL_NODE
            existing.copies.clear()
        else:
            rec = ObjectRec(
                oid=oid,
                shm_name=name,
                size=size,
                owner=state.get("client_id", "?"),
                node_id=LOCAL_NODE,
            )
            rec.holders |= self._take_early_refs(oid)
            self.objects[oid] = rec
            self.stats["objects_created"] += 1
        reply(name=name)

    async def _h_obj_created(self, state, msg, reply, reply_err):
        oid = msg["oid"]
        existing = self.objects.get(oid)
        if existing is not None:
            # re-registration (lineage reconstruction re-ran the creating
            # task, or a second borrower promoted the same object): keep the
            # holders; adopt the new physical location, free the old one
            new_name = msg.get("shm_name")
            new_node = msg.get("node") or state.get("node_id", LOCAL_NODE)
            if existing.shm_name and existing.shm_name != new_name:
                self._free_shm_name(existing.shm_name, existing.node_id)
            existing.shm_name = new_name
            existing.size = msg.get("size", existing.size)
            existing.node_id = new_node
            existing.copies.clear()
            return
        rec = ObjectRec(
            oid=oid,
            shm_name=msg.get("shm_name"),
            size=msg.get("size", 0),
            # the submitter owns task returns; the connecting client owns puts
            owner=msg.get("owner") or state.get("client_id", "?"),
            node_id=msg.get("node") or state.get("node_id", LOCAL_NODE),
            device_holder=msg.get("device_holder"),
            owner_released=bool(msg.get("owner_released")),
        )
        rec.holders |= self._take_early_refs(oid)
        self.objects[oid] = rec
        self.stats["objects_created"] += 1
        if rec.owner_released:
            self._obj_maybe_gc(rec)

    def _release_device_holder(self, rec: ObjectRec) -> None:
        """A ledgerless owner's device result settled here: push
        `release_device` to the owner over its head connection, and the
        owner tells the holder (worker._release_device_objects).  An owner
        that is gone makes this a no-op, as a dead holder does."""
        st = self._clients.get(rec.owner)
        if st is None:
            return
        try:
            write_frame(st["writer"], {
                "m": "release_device", "holder": rec.device_holder,
                "oids": [rec.oid],
            })
        except Exception:
            pass

    def _forward_to_owner(self, owner: str, frame: dict) -> bool:
        """Push a settlement frame to a live owner's ledger over its own head
        connection (the worker side serves owner_refs/owner_transit_done on
        that socket).  Only owners that run a ledger qualify — a synced
        digest is the proof (client-mode drivers never sync one).  Returns
        False when the owner is dead/ledgerless/unwritable: the caller keeps
        the central path, which is also the post-adoption authority."""
        if owner not in self.owner_digests:
            return False
        st = self._clients.get(owner)
        if st is None:
            return False
        try:
            write_frame(st["writer"], frame)
            return True
        except Exception:
            return False

    def _release_cnt_pairs(self, edge: str, pairs) -> None:
        """Release owner-resident containment edges held under `edge` for a
        container whose lifetime settled HERE (its owner has no ledger):
        each dec routes to the ledger that actually holds the pin — a live
        owner's, pushed over its own head connection (the worker side
        serves `owner_refs` on that socket), or this registry for
        head-resident/adopted inners."""
        for p in pairs:
            ioid, iowner = bytes(p[0]), p[1]
            if iowner and self._forward_to_owner(
                iowner, {"m": "owner_refs", "dec": [ioid], "as_id": edge}
            ):
                continue
            # head-resident inner (incl. one owned by a LEDGERLESS client —
            # the digest qualification inside _forward_to_owner refuses
            # those, whose serve_owner_refs would drop the dec), or a dead
            # owner whose ledger this registry adopted: settle centrally
            rec = self.objects.get(ioid)
            if rec is not None:
                rec.holders.discard(edge)
                self._obj_maybe_gc(rec)
            else:
                e = self._early_refs.get(ioid)
                if e is not None:
                    e.discard(edge)

    async def _h_obj_contains(self, state, msg, reply, reply_err):
        """Register containment edges: the object's payload embeds serialized
        ObjectRefs, which must outlive it (borrowing, reference_count.h).
        Two forms: the head-resident one (refs only — this registry adds
        `cnt:<container>` holders to inner records), and the ownership-plane
        `pairs` form from a LEDGERLESS owner (client mode), whose edges
        already live at each inner object's own authority under
        `cnt:<owner>:<container>` — the registry only remembers the pairs so
        it can release them when the container settles here."""
        rec = self.objects.get(msg["oid"])
        refs = msg.get("refs") or []
        pairs = msg.get("pairs")
        if rec is None:
            if pairs:
                # container already settled or never registered: nobody else
                # will release these edges
                cid = state.get("client_id", "?")
                self._release_cnt_pairs(
                    f"cnt:{cid}:{msg['oid'].hex()}", pairs
                )
            return  # container unknown (already GC'd): nothing to pin
        if pairs is not None:
            edge = f"cnt:{rec.owner}:{rec.oid.hex()}"
            if rec.cnt_pairs:
                # re-registration (e.g. reconstruction re-ran the creating
                # task): release the previous edges or the old inners leak
                self._release_cnt_pairs(edge, rec.cnt_pairs)
            rec.cnt_pairs = [[bytes(i), o] for i, o in pairs]
            return
        edge = f"cnt:{rec.oid.hex()}"
        if rec.contains:
            # re-registration (e.g. reconstruction re-ran the creating task):
            # release the previous edges or the old inner objects leak
            for r in rec.contains:
                inner = self.objects.get(r)
                if inner is not None:
                    inner.holders.discard(edge)
                    self._obj_maybe_gc(inner)
        rec.contains = list(refs)
        for r in refs:
            inner = self.objects.get(r)
            if inner is not None:
                inner.holders.add(edge)
            else:
                self._early_ref_add(r, edge)

    async def _h_transit_done(self, state, msg, reply, reply_err):
        """Receiver ack of in-transit borrowed refs: the receiver now holds
        its own registration; drop the sender's transit pin.  If the pin
        hasn't landed yet (different sockets), tombstone the token so the
        late pin is cancelled instead of leaking a permanent holder."""
        cid = state.get("client_id", "?")
        token = msg["token"]
        # register=False: the receiver could NOT consume the payload
        # (corrupt/unreadable) — drop the pin without recording the caller
        # as a holder it isn't
        register = msg.get("register", True)
        self._transit_pins.pop(token, None)
        seen = False
        for oid in msg.get("oids") or []:
            rec = self.objects.get(oid)
            if rec is not None:
                if token not in rec.holders and self._forward_to_owner(
                    rec.owner,
                    {
                        "m": "owner_transit_done", "token": token,
                        "oids": [oid], "cid": cid, "register": register,
                    },
                ):
                    # ack fallback for a pin living in the (alive) owner's
                    # ledger: settle it there — tombstone semantics and the
                    # borrower registration must land at the same authority
                    continue
                if register:
                    rec.holders.add(cid)
                if token in rec.holders:
                    seen = True
                    rec.holders.discard(token)
                self._obj_maybe_gc(rec)
            else:
                early = self._early_refs.get(oid)
                if early is not None:
                    if register:
                        early.add(cid)
                    if token in early:
                        seen = True
                        early.discard(token)
                elif register:
                    self._early_ref_add(oid, cid)
        if not seen:
            self._spent_transit[token] = time.monotonic()

    async def _h_obj_copy(self, state, msg, reply, reply_err):
        """A node finished pulling a copy of an object (node-to-node
        transfer): record the secondary location.  Redundant copies (two
        workers on one node raced the same pull) are freed immediately rather
        than silently overwritten — only one copy per node is tracked."""
        rec = self.objects.get(msg["oid"])
        if rec is not None:
            nid = msg.get("node") or state.get("node_id", LOCAL_NODE)
            if nid == rec.node_id or nid in rec.copies:
                self._free_shm_name(msg["shm_name"], nid)
            else:
                rec.copies[nid] = msg["shm_name"]
            self.stats["objects_transferred"] += 1
        reply()

    def _addr_for(self, rec: WorkerRec, remote: bool) -> str:
        """The address a client should dial for this worker: remote (Ray-
        Client-analogue) drivers can only reach TCP listeners."""
        return rec.addr_tcp if remote and rec.addr_tcp else rec.addr

    def _pull_addr_for(self, node_id: str) -> Optional[str]:
        """Where to pull a node's objects from: the head itself serves n0's
        namespace; agents serve theirs; remote-client namespaces have no
        server (their puts are uploaded to n0, so nothing lives there that
        another node would pull)."""
        if node_id == LOCAL_NODE:
            return self.tcp_addr
        node = self.nodes.get(node_id)
        # draining nodes keep serving pulls: drain evacuation and borrowers
        # both read from them until the deadline
        return node.addr if node is not None and node.up else None

    def _locate_fields(self, rec: ObjectRec, caller_node: str) -> dict:
        # every live holder, so a puller can split the byte range across
        # copies (windowed multi-source pulls).  The primary leads; the
        # legacy single-source fields stay for mixed-version pullers.
        # The caller's own copy is never offered as a pull source — if it
        # were readable the caller would not be asking.
        sources = []
        primary_addr = self._pull_addr_for(rec.node_id)
        if primary_addr is not None:
            name = rec.shm_name or (
                f"spill:{rec.spill_path}" if rec.spill_path else None
            )
            if name:
                sources.append(
                    {"node": rec.node_id, "shm_name": name,
                     "pull_addr": primary_addr}
                )
        for nid, name in rec.copies.items():
            addr = self._pull_addr_for(nid)
            if addr is not None and nid != caller_node:
                sources.append(
                    {"node": nid, "shm_name": name, "pull_addr": addr}
                )
        if rec.node_id != caller_node and caller_node in rec.copies:
            # prefer the caller's local copy — but KEEP the sources list, so
            # a stale local copy (evicted under the directory's feet) still
            # fails over to the live remote holders instead of erroring
            return {
                "found": True, "shm_name": rec.copies[caller_node],
                "size": rec.size, "owner": rec.owner, "node": caller_node,
                "pull_addr": None, "sources": sources,
            }
        return {
            "found": True, "shm_name": rec.shm_name, "size": rec.size,
            "owner": rec.owner, "node": rec.node_id,
            "pull_addr": primary_addr,
            "spill_path": rec.spill_path,
            "sources": sources,
        }

    async def _h_obj_locate(self, state, msg, reply, reply_err):
        rec = self.objects.get(msg["oid"])
        if rec is None:
            reply(found=False)
            return
        # prefer a copy on the caller's node
        reply(**self._locate_fields(rec, state.get("node_id", LOCAL_NODE)))

    def _routable_tcp(self, addr_tcp: str, node_id: str) -> str:
        """Worker/driver TCP listeners bind loopback or wildcard; a dial
        from ANOTHER host needs the node's reachable address.  Substitute
        the host this head (or the node's agent) registered for that node —
        the one component that knows the cluster topology."""
        if not addr_tcp:
            return addr_tcp
        proto, _, rest = addr_tcp.partition(":")
        host, _, port = rest.rpartition(":")
        if host not in ("127.0.0.1", "0.0.0.0", "localhost", "::", "::1"):
            return addr_tcp
        if node_id == LOCAL_NODE:
            reach = self.tcp_addr
        else:
            node = self.nodes.get(node_id)
            reach = node.addr if node is not None else None
        if not reach:
            return addr_tcp
        reach_host = reach.partition(":")[2].rpartition(":")[0]
        return f"{proto}:{reach_host}:{port}" if reach_host else addr_tcp

    async def _h_client_addr(self, state, msg, reply, reply_err):
        """p2p directory lookup: where does client_id serve RPCs?  One call
        per OWNER (cached by the consumer), after which location resolution
        for every object that owner creates goes worker-to-worker
        (owner_locate) — the ownership-based object directory's read path
        (ownership_based_object_directory.h role).  The head remains the
        arbiter for pins/spill/GC and the fallback when an owner dies."""
        cid = msg["client_id"]
        info = self.client_addrs.get(cid)
        if info is None:
            rec = self.workers.get(cid)
            if rec is None or rec.state == "dead":
                dead = (
                    (rec is not None and rec.state == "dead")
                    or cid in self._departed_clients
                )
                reply(found=False, dead=dead)
                return
            info = {
                "addr": rec.addr or "",
                "addr_tcp": rec.addr_tcp or "",
                "node": rec.node_id,
            }
        addr_tcp = self._routable_tcp(info.get("addr_tcp") or "", info["node"])
        if state.get("remote"):
            # TCP-only callers can't dial unix sockets
            if not addr_tcp:
                reply(found=False)
                return
            reply(found=True, addr=addr_tcp, node=info["node"])
            return
        reply(
            found=True,
            addr=info.get("addr") or addr_tcp,
            addr_tcp=addr_tcp,
            node=info["node"],
        )

    async def _h_obj_spilled(self, state, msg, reply, reply_err):
        """Producer moved an object's bytes to disk under memory pressure
        (local_object_manager.h spill).  The old shm slice is reclaimed
        immediately when nothing holds a zero-copy view of it; otherwise the
        reclaim waits for the last pin to drop."""
        self.stats["objects_spilled_bytes"] = (
            self.stats.get("objects_spilled_bytes", 0) + int(msg.get("size") or 0)
        )
        if msg.get("decided"):
            # ownership plane: the OWNER already made the free-now-vs-defer
            # call against its ledger's pin state; this notify just keeps
            # the registry snapshot (locate/pull routing, failover) current
            rec = self.objects.get(msg["oid"])
            if rec is not None:
                for nid, name in rec.copies.items():
                    self._free_shm_name(name, nid)
                rec.copies.clear()
                rec.spill_path = msg["path"]
                rec.shm_name = None
                rec.pending_free = None
                self.stats["objects_spilled"] = (
                    self.stats.get("objects_spilled", 0) + 1
                )
            reply(found=rec is not None, free_now=False)
            return
        rec = self.objects.get(msg["oid"])
        if rec is None:
            reply(found=False, free_now=False)
            return
        old = rec.shm_name
        rec.spill_path = msg["path"]
        rec.shm_name = None
        # secondary copies are droppable outright — free them on their nodes
        # before forgetting them, or their arena slices leak
        for nid, name in rec.copies.items():
            self._free_shm_name(name, nid)
        rec.copies.clear()
        pinned = any(h.endswith("#v") for h in rec.holders)
        if not pinned:
            # the holder truth is owner-resident: a reader's #v pin on this
            # object lives in the OWNER's ledger (owner_pin), not here —
            # consult the last synced digest before freeing a slice a view
            # may be mapping.  The residual window is one owner_sync period
            # (plus the owner's own pins, which the digest excludes by
            # design); deferral via pending_free is the safe direction —
            # worst case the slice is reclaimed at object settle instead.
            info = self.owner_digests.get(rec.owner, {}).get(rec.oid)
            if info is not None:
                pinned = any(
                    h.endswith("#v") for h in info.get("b") or ()
                )
        if old is None:
            reply(found=True, free_now=False)
        elif pinned:
            rec.pending_free = old
            reply(found=True, free_now=False)
        else:
            # the producer frees its slice synchronously (it needs the space
            # now); no reclaim broadcast needed
            reply(found=True, free_now=True)
        self.stats["objects_spilled"] = self.stats.get("objects_spilled", 0) + 1

    async def _h_obj_pin(self, state, msg, reply, reply_err):
        """Confirmed zero-copy pin: registering the pin and learning the
        object's CURRENT location is one atomic head-side step, so a reader
        can never map a slice that spilling is about to recycle."""
        rec = self.objects.get(msg["oid"])
        if rec is None:
            reply(found=False)
            return
        if not self._forward_to_owner(
            rec.owner,
            {"m": "owner_refs", "inc": [msg["oid"]], "as_id": msg["as_id"]},
        ):
            rec.holders.add(msg["as_id"])
        # else: pin fallback for an owner-resident object (owner_pin dial
        # failed) — the pin must land in the owner's ledger or its
        # spill_transition would free the slice under the reader.  The
        # location replied below is the registry's view; the owner's notify
        # keeps it current, so the residual race window is one in-flight
        # obj_spilled, same as the pre-plane path.
        reply(**self._locate_fields(rec, state.get("node_id", LOCAL_NODE)))

    async def _h_pull_chunk(self, state, msg, reply, reply_err):
        """Serve a chunk of one of n0's objects for node-to-node transfer
        (object_manager.h chunked push analogue; the head doubles as n0's
        object server since n0 has no agent)."""
        delay = getattr(self.config, "testing_transfer_delay_s", 0.0)
        if delay:
            # test/bench hook: simulated link latency, so the windowed-pull
            # A/B measures pipelining rather than loopback memcpy speed
            await asyncio.sleep(delay)
        reply(data=read_shm_chunk(
            self.session_name, self._pull_maps, msg["shm_name"], msg["off"], msg["len"]
        ))

    async def _h_obj_refs(self, state, msg, reply, reply_err):
        # as_id: synthetic holder ids ("<cid>#v" value pins keep an arena
        # slice alive while zero-copy views of it outlive the ObjectRef)
        cid = msg.get("as_id") or state.get("client_id", "?")
        if cid in self._spent_transit:
            # the receiver already acked this transit: the pin is moot
            del self._spent_transit[cid]
        else:
            inc = msg.get("inc", [])
            if inc and msg.get("ttl") and cid.startswith("t:"):
                # track for the TTL sweep (lost-reply reclamation).  Only
                # pins that opt in (bounded-ack protocols like owner_locate
                # serving); task-arg pins ack at execution time, which lease
                # queueing can delay past any fixed TTL — those are cleaned
                # by sender liveness (the disconnect sweep) instead
                self._transit_pins[cid] = (time.monotonic(), list(inc))
            for oid in inc:
                rec = self.objects.get(oid)
                if rec is not None:
                    if cid != rec.owner and self._forward_to_owner(
                        rec.owner,
                        {
                            "m": "owner_refs", "inc": [oid], "as_id": cid,
                            "ttl": bool(msg.get("ttl")),
                        },
                    ):
                        # a borrower's registration that fell back here while
                        # the owner (the lifetime authority) is alive: land
                        # it in the owner's ledger, not as head-side residue
                        # an owner settle would silently clobber
                        continue
                    rec.holders.add(cid)
                else:
                    # inc may race ahead of obj_created (different sockets)
                    self._early_ref_add(oid, cid)
        for oid in msg.get("dec", []):
            rec = self.objects.get(oid)
            if rec is not None:
                if (
                    cid not in rec.holders
                    and cid != rec.owner
                    and self._forward_to_owner(
                        rec.owner,
                        {"m": "owner_refs", "dec": [oid], "as_id": cid},
                    )
                ):
                    # release fallback for a hold that lives in the (alive)
                    # owner's ledger — e.g. the direct dial failed once at
                    # release time; without the forward the hold would pin
                    # the object until the borrower process dies
                    continue
                rec.holders.discard(cid)
                if cid == rec.owner:
                    rec.owner_released = True
                if (
                    rec.pending_free
                    and cid.endswith("#v")
                    and not any(h.endswith("#v") for h in rec.holders)
                ):
                    # last zero-copy pin on a spilled object's old slice gone
                    self._free_shm_name(rec.pending_free, rec.node_id)
                    rec.pending_free = None
                self._obj_maybe_gc(rec)
            else:
                early = self._early_refs.get(oid)
                if early is not None:
                    early.discard(cid)
                    if not early:
                        del self._early_refs[oid]
                        self._early_ref_ts.pop(oid, None)

    # placement groups ------------------------------------------------------
    @staticmethod
    def _pg_demand(bundles: List[BundleRec]) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for b in bundles:
            for k, v in b.resources.items():
                total[k] = total.get(k, 0.0) + v
        return total

    def _pg_infeasible(self, bundles: List[BundleRec], strategy: str) -> Optional[str]:
        """A PG is infeasible only if it can never fit the current cluster's
        TOTAL capacity (strategy-aware); temporary shortage means pending."""
        alive = self._alive_nodes()
        if strategy == "STRICT_PACK":
            demand = self._pg_demand(bundles)
            if not any(self._fits(n.total, demand) for n in alive):
                return f"STRICT_PACK: no node's total capacity fits {demand}"
            return None
        if strategy == "STRICT_SPREAD" and len(bundles) > len(alive):
            return f"STRICT_SPREAD: {len(bundles)} bundles > {len(alive)} nodes"
        for b in bundles:
            cands = [
                n for n in alive
                if b.labels is None or scheduling.match_labels(n.labels, b.labels)
            ]
            if not cands:
                return f"bundle label selector {b.labels} matches no alive node"
            if not any(self._fits(n.total, b.resources) for n in cands):
                return f"bundle {b.resources} fits no eligible node's total capacity"
        demand = self._pg_demand(bundles)
        if not self._fits(self._agg_total(), demand):
            return f"need {demand}, cluster total {self._agg_total()}"
        return None

    def _try_place_pg(self, rec: PGRec) -> bool:
        """Assign nodes to all unplaced bundles (taking node resources).
        Returns True when the whole PG is placed."""
        unplaced = [i for i, b in enumerate(rec.bundles) if b.node_id is None]
        if not unplaced:
            rec.state = "created"
            return True
        nodes = self._alive_nodes()
        if rec.strategy == "STRICT_SPREAD":
            placed_on = {b.node_id for b in rec.bundles if b.node_id is not None}
            nodes = [n for n in nodes if n.node_id not in placed_on]
        views = self._node_views(nodes)
        assignment = scheduling.place_bundles(
            views,
            [rec.bundles[i].resources for i in unplaced],
            rec.strategy,
            self.config.scheduler_spread_threshold,
            bundle_labels=[rec.bundles[i].labels for i in unplaced],
        )
        if assignment is None:
            return False
        for i, nid in zip(unplaced, assignment):
            rec.bundles[i].node_id = nid
            self._take(self.nodes[nid].avail, rec.bundles[i].resources)
        rec.state = "created"
        return True

    async def _h_create_pg(self, state, msg, reply, reply_err):
        """PG semantics mirror GcsPlacementGroupManager: infeasible only if
        the demand exceeds the cluster's TOTAL capacity (strategy-aware); a PG
        that fits total but not currently-free resources is PENDING and is
        created FIFO as leases/actors/PGs release resources (pg_wait blocks
        on it).  Bundles are placed onto nodes per PACK/SPREAD/STRICT_*."""
        blabels = msg.get("bundle_labels") or [None] * len(msg["bundles"])
        bundles = [
            BundleRec(resources=b, labels=l)
            for b, l in zip(msg["bundles"], blabels)
        ]
        strategy = msg.get("strategy", "PACK")
        why = self._pg_infeasible(bundles, strategy)
        if why is not None:
            reply_err(PlacementGroupError(f"infeasible placement group: {why}"))
            return
        rec = PGRec(pg_id=msg["pg_id"], bundles=bundles, strategy=strategy)
        if self._try_place_pg(rec):
            self._log_event("pg_created", pg_id=rec.pg_id, bundles=len(bundles))
        else:
            rec.state = "pending"
            self.pending_pgs.append(rec.pg_id)
            self._log_event("pg_pending", pg_id=rec.pg_id, bundles=len(bundles))
        self.pgs[rec.pg_id] = rec
        reply(state=rec.state)

    def _service_pending_pgs(self):
        """Create pending PGs FIFO as resources free up (no overtaking: a
        large PG at the head of the queue is not starved by later small ones)."""
        while self.pending_pgs:
            pgid = self.pending_pgs[0]
            rec = self.pgs.get(pgid)
            if rec is None or rec.state != "pending":
                self.pending_pgs.popleft()
                continue
            if not self._try_place_pg(rec):
                break
            self.pending_pgs.popleft()
            self._log_event("pg_created", pg_id=pgid, bundles=len(rec.bundles))
            self._wake_pg_waiters(pgid)

    def _wake_pg_waiters(self, pgid: str, exc: Optional[BaseException] = None):
        for fut in self._pg_waiters.pop(pgid, []):
            if not fut.done():
                if exc is None:
                    fut.set_result(True)
                else:
                    fut.set_exception(exc)

    async def _h_pg_wait(self, state, msg, reply, reply_err):
        """Block until the PG is created (or removed / timeout)."""
        pgid = msg["pg_id"]
        rec = self.pgs.get(pgid)
        if rec is None:
            reply_err(PlacementGroupError(f"placement group {pgid} not found"))
            return
        if rec.state == "created":
            reply(ready=True)
            return
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pg_waiters.setdefault(pgid, []).append(fut)
        try:
            # field is named wait_timeout because Connection.call() consumes
            # a kwarg named `timeout` as the RPC deadline instead of sending it
            await asyncio.wait_for(fut, msg.get("wait_timeout"))
            reply(ready=True)
        except asyncio.TimeoutError:
            reply(ready=False)
        except PlacementGroupError as e:
            reply_err(e)

    async def _h_remove_pg(self, state, msg, reply, reply_err):
        pg = self.pgs.pop(msg["pg_id"], None)
        if pg is not None:
            for b in pg.bundles:
                if b.node_id is not None:
                    node = self.nodes.get(b.node_id)
                    if node is not None and node.up:
                        self._give(node.avail, b.resources)
            if pg.state != "created":
                try:
                    self.pending_pgs.remove(msg["pg_id"])
                except ValueError:
                    pass
            self._wake_pg_waiters(
                msg["pg_id"],
                PlacementGroupError(f"placement group {msg['pg_id']} removed"),
            )
            self._service_queue()
        reply()

    async def _h_list_pgs(self, state, msg, reply, reply_err):
        reply(
            pgs=[
                {
                    "pg_id": p.pg_id,
                    "strategy": p.strategy,
                    "state": p.state,
                    "bundles": [b.resources for b in p.bundles],
                    "bundle_nodes": [b.node_id for b in p.bundles],
                }
                for p in self.pgs.values()
            ]
        )

    # introspection ---------------------------------------------------------
    def _node_lease_blocks(self, n: NodeRec) -> Dict[str, dict]:
        """Merged delegated/used view of one node's lease blocks: size is the
        head's authoritative delegation count, used/counters come from the
        agent's latest heartbeat."""
        out: Dict[str, dict] = {}
        for pool, wids in n.delegated.items():
            if not wids and pool not in n.lease_used:
                continue
            hb = n.lease_used.get(pool) or {}
            out[pool] = {
                "size": len(wids),
                "used": int(hb.get("used", 0)),
                "granted": int(hb.get("granted", 0)),
                "denied": int(hb.get("denied", 0)),
            }
        return out

    async def _h_lease_dir(self, state, msg, reply, reply_err):
        """Submitter-side lease directory: which agents hold delegated lease
        blocks, at what occupancy.  Read once per pool per TTL while a pool
        grows (cached client-side) — NOT per lease and never per task, so
        steady-state floods put zero load here."""
        nodes = []
        for n in self._alive_nodes():
            if n.is_local or n.conn is None:
                continue
            # only pools with live slots: a fully-revoked block (size 0)
            # would make every submitter probe the agent, get denied, and
            # eagerly re-fetch this directory — MORE head traffic than the
            # central path, the opposite of the plane's purpose
            blocks = {
                p: b
                for p, b in self._node_lease_blocks(n).items()
                if b["size"] > 0
            }
            if blocks:
                nodes.append({"node_id": n.node_id, "addr": n.addr, "pools": blocks})
        reply(nodes=nodes, delegation=self.config.lease_delegation)

    async def _h_nodes(self, state, msg, reply, reply_err):
        from .nodeagent import node_load_sample

        out = []
        for n in self.nodes.values():
            out.append(
                {
                    "node_id": n.node_id,
                    "alive": n.up,  # draining nodes are up (but unschedulable)
                    "state": n.state,
                    # fencing token: bumps every time this node id rejoins
                    # after a death verdict (partition heals prove freshness)
                    "incarnation": n.incarnation,
                    "drain": (
                        {
                            "reason": n.drain_reason,
                            "deadline_in_s": round(
                                max(0.0, n.drain_deadline - time.monotonic()), 3
                            ),
                        }
                        if n.state == "draining"
                        else None
                    ),
                    "resources": n.total,
                    "available": n.avail,
                    "labels": n.labels,
                    "load": n.load if not n.is_local else node_load_sample(),
                    "is_head_node": n.is_local,
                    # agent pid (same-host test tooling: PreemptionSimulator
                    # sends the preemption SIGTERM straight to it)
                    "pid": n.pid,
                    # Prometheus scrape endpoint (node-agent HTTP, head-free)
                    "metrics_addr": n.metrics_addr,
                    "lease_blocks": self._node_lease_blocks(n),
                    "n_workers": sum(
                        1
                        for w in self.workers.values()
                        if w.node_id == n.node_id and w.state != "dead"
                    ),
                }
            )
        reply(nodes=out)

    async def _h_cluster_resources(self, state, msg, reply, reply_err):
        reply(total=self._agg_total(), available=self._agg_avail())

    async def _h_stats(self, state, msg, reply, reply_err):
        from .protocol import wire_stats

        # the head's own frame/message counters prove control-plane
        # amortization end-to-end: rpc_messages_* / rpc_frames_* > 1 means
        # batch envelopes are doing their job (shown by `ca status`)
        wire = {f"rpc_{k}": v for k, v in wire_stats().items()}
        # lease-plane aggregates: delegated slots and the agents' lifetime
        # local-grant counters (heartbeat-fed) vs this head's central grants
        # — `ca status` shows regressions without the dashboard
        lease_local_granted = 0
        lease_local_used = 0
        lease_delegated = 0
        for n in self._alive_nodes():
            for pool, wids in n.delegated.items():
                lease_delegated += len(wids)
            seen_granted = {
                pool: int((hb or {}).get("granted", 0))
                for pool, hb in n.lease_used.items()
            }
            lease_local_granted += sum(seen_granted.values())
            lease_local_used += sum(
                int((hb or {}).get("used", 0)) for hb in n.lease_used.values()
            )
        # log-plane counters: cluster-wide ca_log_* aggregates (capture-side,
        # flushed by every worker) next to this head's own shipped/dropped
        # stats — `ca status` shows both
        log_counters = self._log_counter_totals()
        # drain plane: the client-side evacuated-task counter aggregates
        # through the metrics table (submitters count their exempted retries)
        evac = self.metrics.get("ca_drain_tasks_evacuated_total")
        drain_tasks_evacuated = (
            int(sum(evac["data"].values())) if evac and evac.get("data") else 0
        )
        reply(
            rpc_counts=dict(self.rpc_counts),
            stats=dict(
                self.stats,
                **wire,
                **log_counters,
                lease_delegated_slots=lease_delegated,
                lease_local_used=lease_local_used,
                lease_local_granted=lease_local_granted,
                lease_head_granted=self.stats["leases_granted"],
                drain_tasks_evacuated=drain_tasks_evacuated,
                nodes_draining=sum(
                    1 for n in self.nodes.values() if n.state == "draining"
                ),
                pending_leases=len(self.pending_leases),
                idle_workers=sum(
                    len(d) for n in self._alive_nodes() for d in n.idle.values()
                ),
                n_workers=sum(1 for w in self.workers.values() if w.state != "dead"),
                n_actors=len(self.actors),
                n_objects=len(self.objects),
                n_nodes=len(self._alive_nodes()),
            )
        )

    async def _h_list_actors(self, state, msg, reply, reply_err):
        # limit applied server-side: a 10k-actor table must not cross the
        # wire to honor limit=10.  Explicit limit=0 means zero, not default.
        limit = msg.get("limit")
        limit = 10_000 if limit is None else limit
        reply(
            actors=[
                self._actor_info(a)
                for a in itertools.islice(self.actors.values(), limit)
            ]
        )

    async def _h_list_workers(self, state, msg, reply, reply_err):
        limit = msg.get("limit")
        limit = 10_000 if limit is None else limit
        reply(
            workers=[
                {
                    "worker_id": w.worker_id,
                    "pid": w.pid,
                    "state": w.state,
                    "actor_id": w.actor_id,
                    "node_id": w.node_id,
                }
                for w in itertools.islice(self.workers.values(), limit)
            ]
        )

    async def _h_task_events(self, state, msg, reply, reply_err):
        self.task_events.extend(msg.get("events") or [])

    async def _h_list_task_events(self, state, msg, reply, reply_err):
        events = list(self.task_events)
        if msg.get("terminal"):
            # terminal-executions view: drop lifecycle phases and app spans
            # BEFORE the limit, so limit=N means N executions even when
            # tracing multiplies ring entries per task
            events = [
                e for e in events
                if e.get("end") is not None
                and e.get("state") in ("FINISHED", "FAILED")
            ]
        name = msg.get("name")
        if name:
            events = [e for e in events if e.get("name") == name]
        st = msg.get("state")
        if st:
            events = [e for e in events if e.get("state") == st]
        tid = msg.get("task_id")
        if tid:
            # trace assembly: all lifecycle phases of one task
            events = [e for e in events if e.get("task_id") == tid]
        limit = msg.get("limit") or 10_000
        reply(events=events[-limit:])

    def digest_holders(self, rec) -> tuple:
        """(num_holders, from_ledger) for display surfaces: the holder truth
        is owner-resident, so when the owner has synced a digest surface it
        (borrower set + implied owner hold unless released) — head-side
        holders are empty by design in steady state.  Shared by
        _h_list_objects and the dashboard's /api/objects."""
        info = self.owner_digests.get(rec.owner, {}).get(rec.oid)
        if info is None:
            return len(rec.holders), False
        return len(info.get("b") or ()) + (0 if info.get("r") else 1), True

    async def _h_list_objects(self, state, msg, reply, reply_err):
        limit = msg.get("limit") or 10_000
        out = []
        for rec in list(self.objects.values())[:limit]:
            holders, ledger = self.digest_holders(rec)
            out.append(
                {
                    "object_id": rec.oid.hex(),
                    "size": rec.size,
                    "owner": rec.owner,
                    "in_shm": rec.shm_name is not None,
                    "num_holders": holders,
                    "owner_ledger": ledger,
                    "node_id": rec.node_id,
                }
            )
        reply(objects=out)

    async def _h_metrics_report(self, state, msg, reply, reply_err):
        from ..util.metrics import merge_metric_records

        merge_metric_records(self.metrics, msg.get("metrics"))
        self._ingest_flightrec(msg.get("flightrec"))

    def _flightrec_query(
        self, *, trace=None, plane=None, node=None, event=None,
        since=None, limit=1000,
    ) -> Dict[str, Any]:
        """Filter/sort the cluster-merged flight-recorder journal.  Shared
        by the `flightrec` RPC and the dashboard's /api/flightrec route."""
        events = list(self.flightrec)
        if trace:
            events = [
                e for e in events if (e.get("trace") or {}).get("tid") == trace
            ]
        if plane:
            events = [e for e in events if e.get("plane") == plane]
        if node:
            events = [e for e in events if e.get("node") == node]
        if event:
            events = [e for e in events if event in (e.get("event") or "")]
        if since is not None:
            events = [e for e in events if e.get("ts", 0) >= float(since)]
        events.sort(key=lambda e: e.get("ts", 0))
        limit = int(limit)
        if limit and len(events) > limit:
            events = events[-limit:]
        return {
            "events": events, "total": len(self.flightrec),
            "enabled": self._flightrec_on,
        }

    async def _h_flightrec(self, state, msg, reply, reply_err):
        """Flight-recorder query: the cluster-merged decision journal,
        filtered by trace id / plane / node / event substring / since-ts,
        sorted by timestamp.  Backs `ca events`, `ca incident`,
        `util.state.flightrec_events`, and dashboard /api/flightrec."""
        reply(**self._flightrec_query(
            trace=msg.get("trace"), plane=msg.get("plane"),
            node=msg.get("node"), event=msg.get("event"),
            since=msg.get("since"), limit=msg.get("limit", 1000),
        ))

    async def _h_metrics_snapshot(self, state, msg, reply, reply_err):
        reply(metrics=self.metrics)

    async def _h_timeseries(self, state, msg, reply, reply_err):
        """Metrics-plane history: ring-buffered series at the requested tier
        (0 = scrape resolution, 1 = coarse), optionally counter→rate derived
        server-side.  Backs `/api/timeseries`, `util.state.timeseries()`,
        dashboard sparklines, and `ca top`."""
        if self.timeseries is None:
            reply(series={}, meta={"disabled": True})
            return
        reply(
            series=self.timeseries.query(
                names=msg.get("names"),
                prefix=msg.get("prefix"),
                tier=int(msg.get("tier", 0)),
                rate=bool(msg.get("rate")),
            ),
            meta=self.timeseries.meta(),
        )

    async def _h_profile(self, state, msg, reply, reply_err):
        """`ca profile` routing: resolve a worker / actor / task / node /
        "head" id to the owning process and trigger its in-process stack
        sampler; the folded stacks + speedscope JSON stream back through
        here.  The head samples itself off-loop (the sampler thread reads
        sys._current_frames; the loop keeps dispatching)."""
        ident = msg.get("id") or "head"
        duration = float(msg.get("duration", 2.0))
        hz = float(msg.get("hz", 100.0))
        node = self.nodes.get(ident)
        if ident == "head" or (node is not None and node.is_local):
            # the head node has no separate agent: its node id profiles the
            # head process itself (not a "no such id" error)
            from ..util import profiler

            res = await asyncio.get_running_loop().run_in_executor(
                None, profiler.sample_stacks, duration, hz
            )
            reply(
                target="head", node_id=LOCAL_NODE,
                folded=profiler.render_folded(res["folded"]),
                speedscope=profiler.speedscope_json(res["folded"], "head", hz),
                samples=res["samples"], duration_s=res["duration_s"],
            )
            return
        # node id -> that node's agent process
        if node is not None and not node.is_local:
            if node.conn is None or node.conn.closed:
                reply_err(ConnectionError(f"agent for node {ident!r} unreachable"))
                return
            try:
                out = await node.conn.call(
                    "profile", duration=duration, hz=hz, timeout=duration + 15
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:
                reply_err(RuntimeError(f"profile of node {ident!r} failed: {e}"))
                return
            reply(target=ident, node_id=ident, **{
                k: out[k] for k in ("folded", "speedscope", "samples", "duration_s")
            })
            return
        wid = ident
        # actor id -> its worker
        for a in self.actors.values():
            if a.actor_id == ident or a.actor_id.startswith(ident):
                wid = a.worker_id
                break
        else:
            # task id -> the worker its most recent lifecycle event ran on
            if ident not in self.workers:
                for ev in reversed(self.task_events):
                    if ev.get("task_id") == ident and ev.get("worker_id"):
                        wid = ev["worker_id"]
                        break
        rec = self.workers.get(wid)
        if rec is None or rec.state == "dead" or not rec.addr:
            reply_err(ValueError(
                f"no live worker/actor/task/node with id {ident!r}"
            ))
            return
        try:
            conn = await self._worker_conn(rec)
            out = await conn.call(
                "profile", duration=duration, hz=hz, timeout=duration + 15
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:
            reply_err(RuntimeError(f"profile of {wid!r} failed: {e}"))
            return
        reply(target=wid, node_id=rec.node_id, **{
            k: out[k] for k in ("folded", "speedscope", "samples", "duration_s")
        })

    async def _h_autoscaler_state(self, state, msg, reply, reply_err):
        """What the autoscaler reconciler consumes (autoscaler.proto analogue):
        pending demand shapes + current utilization."""
        self._autoscaler_read_at = time.monotonic()
        reply(
            pending_demands=[dict(r.shape) for r in self.pending_leases]
            + [dict(d) for d in self._actor_demands.values()],
            total=self._agg_total(),
            available=self._agg_avail(),
            idle_workers=sum(
                len(d) for n in self._alive_nodes() for d in n.idle.values()
            ),
            n_workers=sum(1 for w in self.workers.values() if w.state != "dead"),
        )

    async def _h_update_resources(self, state, msg, reply, reply_err):
        """Autoscaler grows/shrinks the local node's capacity as provider
        nodes join/leave (the v1 provider models capacity, not real hosts;
        real hosts join as agent nodes via register)."""
        delta = msg.get("delta") or {}
        node = self.local_node
        for k, v in delta.items():
            node.total[k] = node.total.get(k, 0.0) + v
            node.avail[k] = node.avail.get(k, 0.0) + v
        node.max_workers = int(node.total.get("CPU", 4)) * 4 + 4
        self._log_event("resources_updated", delta=delta, total=node.total)
        self._service_queue()
        reply(total=self._agg_total())

    async def _h_job_stop(self, state, msg, reply, reply_err):
        reply()
        self._shutdown.set()

    # ------------------------------------------------------------ lifecycle
    def _sweep_client_arenas(self, cid: str, node_id: str):
        """Unlink a departed client's arena files (on its node).  Readers with
        live maps keep their data; objects owned by a dead process are lost
        either way (ObjectLostError) until lineage reconstruction recovers
        them."""
        if node_id == LOCAL_NODE:
            import glob

            for path in glob.glob(
                os.path.join("/dev/shm", self.session_name, LOCAL_NODE, f"arena_{cid}_*")
            ):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        else:
            node = self.nodes.get(node_id)
            if node is not None and node.conn is not None and not node.conn.closed:
                try:
                    node.conn.notify("sweep_arenas", cid=cid)
                except Exception:
                    pass

    async def _on_disconnect(self, state):
        cid = state.get("client_id")
        if cid is None:
            return
        cur = self._clients.get(cid)
        if cur is not None and cur is not state:
            # a NEWER registration under the same id superseded this
            # connection (e.g. a fenced agent's deferred transport close
            # firing after its fresh-incarnation rejoin): tearing down the
            # live registrant over a stale socket would re-kill the node
            # that just healed
            return
        self._clients.pop(cid, None)
        self.client_addrs.pop(cid, None)  # p2p dials now fall back to head
        self._log_subs.pop(cid, None)  # departed drivers stop receiving logs
        if cid in self._repl_subs:
            # a departed standby must not gate sync commits
            self._repl_drop_sub(cid, "disconnect")
        if state.get("role") == "agent":
            node = self.nodes.get(state.get("node_id"))
            if node is not None:
                await self._on_node_death(node)
            return
        self._sweep_client_arenas(cid, state.get("node_id", LOCAL_NODE))
        # abort any client uploads cut off mid-stream: close the mmaps and
        # unlink the partial cput files, or crashed-client retries accumulate
        # leaked multi-GB segments until teardown
        for name, m, _size in state.pop("cput", {}).values():
            try:
                m.close()
            except Exception:
                pass
            try:
                os.unlink(os.path.join("/dev/shm", name))
            except OSError:
                pass
        # drop this client's pubsub channel and its holder entries (incl. the
        # "<cid>#v" value pins) so departed readers can't pin objects forever
        self.subscribers.pop(f"shm_free:{cid}", None)
        writer = state.get("writer")
        if writer is not None:
            # departed drivers leave the broadcast channels (`actors`), or
            # the lists grow a dead writer per driver lifetime
            for subs in self.subscribers.values():
                if writer in subs:
                    subs.remove(writer)
        pin_id = f"{cid}#v"
        transit_prefix = f"t:{cid}:"
        # cnt:<cid>: containment edges die with the client too — its
        # containers can never release them (OwnerLedger.purge_holder does
        # the same for owner-resident records; adopted records live here)
        cnt_prefix = f"cnt:{cid}:"
        for rec in list(self.objects.values()):
            stale = [
                h
                for h in rec.holders
                if h == cid
                or h == pin_id
                or h.startswith(transit_prefix)
                or h.startswith(cnt_prefix)
            ]
            if stale:
                rec.holders.difference_update(stale)
                self._obj_maybe_gc(rec)
        for tok in [t for t in self._transit_pins if t.startswith(transit_prefix)]:
            del self._transit_pins[tok]
        # ownership plane: every OTHER owner's ledger must purge this
        # client's holder ids/pins/tokens/containment edges too — they can
        # never dec (broadcast, like the drain pub: no subscription
        # round-trip may gate lifetime correctness)
        gone_frame = {"m": "pub", "ch": "client_gone", "data": {"client_id": cid}}
        for st in list(self._clients.values()):
            try:
                write_frame(st["writer"], gone_frame)
            except Exception:
                pass
        # ... and this OWNER's orphaned objects are adopted from its last
        # owner_sync digest: the borrowers recorded there drain through the
        # central path; the owner itself is dead, so its release is implied
        digest = self.owner_digests.pop(cid, None)
        if digest:
            adopted = 0
            for oid, info in digest.items():
                rec = self.objects.get(oid)
                if rec is None:
                    continue
                rec.holders |= set(info.get("b") or ())
                rec.owner_released = True
                adopted += 1
                self._obj_maybe_gc(rec)
            if adopted:
                self.stats["owners_adopted"] = (
                    self.stats.get("owners_adopted", 0) + 1
                )
                self._log_event(
                    "owner_ledger_adopted", client_id=cid, objects=adopted
                )
        self._departed_clients[cid] = None
        while len(self._departed_clients) > 10_000:
            self._departed_clients.popitem(last=False)
        if state.get("role") == "worker":
            rec = self.workers.get(cid)
            if rec is not None:
                await self._on_worker_death(rec)
        elif state.get("role") == "driver":
            self._driver_clients.discard(cid)
            if not self._driver_clients and os.environ.get("CA_HEAD_PERSIST") != "1":
                # last driver gone -> tear down the job (detached actors would
                # survive in the multi-job milestone)
                self._shutdown.set()

    async def _loop_lag_loop(self):
        """Measure this loop's own scheduling lag: sleep a fixed period and
        observe the overshoot.  Lag is THE head-saturation signal — every
        handler that blocks the loop (big snapshot, O(n) scan, dispatch
        flood) shows up here before it shows up as client timeouts.  Gauge =
        latest sample (`ca_head_loop_lag_seconds`); histogram accumulates
        the distribution for p50/p99 in bench/`ca top`."""
        period = max(float(getattr(self.config, "loop_lag_period_s", 0.25)), 0.01)
        loop = asyncio.get_running_loop()
        while not self._shutdown.is_set():
            t0 = loop.time()
            await asyncio.sleep(period)
            lag = max(loop.time() - t0 - period, 0.0)
            self._self_gauge_set(
                "ca_head_loop_lag_seconds",
                "head asyncio event-loop scheduling lag (latest sample)",
                lag,
            )
            self._self_hist_observe(
                "ca_head_loop_lag_hist_seconds",
                "head asyncio event-loop scheduling lag distribution",
                self._DISPATCH_BOUNDS, lag, "[]",
            )

    def _timeseries_tick(self, wall: float) -> None:
        """One retention sample: head stats (cumulative counters), computed
        cluster gauges (incl. the drain/owner-plane aggregates, so the PR
        5/6 surfaces get history, not just current values), and the whole
        aggregated metrics table (counters, gauges, histogram _count/_sum)."""
        store = self.timeseries
        for k, v in self.stats.items():
            if isinstance(v, (int, float)):
                store.record(f"head_{k}", "[]", float(v), "counter", wall)
        gauges = {
            "nodes_draining": sum(
                1 for n in self.nodes.values() if n.state == "draining"
            ),
            "n_nodes": sum(1 for n in self.nodes.values() if n.up),
            "n_workers": sum(1 for w in self.workers.values() if w.state != "dead"),
            "n_actors": len(self.actors),
            "n_objects": len(self.objects),
            "pending_leases": len(self.pending_leases),
            "idle_workers": sum(
                len(d) for n in self._alive_nodes() for d in n.idle.values()
            ),
            "owner_digest_entries": sum(
                len(d) for d in self.owner_digests.values()
            ),
        }
        for k, v in gauges.items():
            store.record(f"head_{k}", "[]", float(v), "gauge", wall)
        from .protocol import wire_stats

        for k, v in wire_stats().items():
            store.record(f"head_rpc_{k}", "[]", float(v), "counter", wall)
        store.sample_metrics(self.metrics, wall)

    async def _monitor_loop(self):
        period = self.config.health_check_period_s
        from ..util import flightrec as _flightrec

        while not self._shutdown.is_set():
            await asyncio.sleep(min(period, 0.2))
            now = time.monotonic()
            if self._flightrec_on and _flightrec.REC is not None:
                # head-process recorder (netchaos and other shared code
                # running here) drains straight into the merged ring — the
                # head is its own aggregator, no piggyback needed
                self._ingest_flightrec(_flightrec.REC.drain())
            if (
                self.timeseries is not None
                and now - self._last_ts_sample
                >= float(getattr(self.config, "timeseries_interval_s", 10.0))
            ):
                self._last_ts_sample = now
                try:
                    self._timeseries_tick(time.time())
                except Exception:
                    pass  # retention must never take down the monitor
            # HA observability: the epoch gauge is always live; replication
            # lag (records the slowest standby hasn't acked) gauges + a
            # throttled flight-recorder event while standbys are subscribed
            self._self_gauge_set(
                "ca_head_ha_epoch", "current head authority epoch",
                float(self.head_epoch),
            )
            if self._repl_subs:
                lag = self._repl_seq - min(
                    s["acked"] for s in self._repl_subs.values()
                )
                self._self_gauge_set(
                    "ca_head_ha_repl_lag",
                    "replication records not yet acked by the slowest standby",
                    float(lag),
                )
                if now - self._repl_last_lag_event > 10.0:
                    self._repl_last_lag_event = now
                    self._log_event(
                        "ha_replicate_lag", lag=lag, seq=self._repl_seq,
                        standbys=len(self._repl_subs),
                    )
            for rec in list(self.workers.values()):
                if rec.state == "dead":
                    continue
                if rec.proc is not None and rec.proc.poll() is not None:
                    await self._on_worker_death(rec, self._exit_status(rec.proc.poll()))
                    continue
                if rec.proc is None and rec.node_id == LOCAL_NODE and rec.pid:
                    # re-adopted after a head restart: no Popen handle, poll
                    # the pid directly
                    try:
                        os.kill(rec.pid, 0)
                    except ProcessLookupError:
                        await self._on_worker_death(rec, "process gone")
                        continue
                    except PermissionError:
                        pass
                if rec.state == "starting":
                    continue
                gap = now - rec.last_heartbeat
                if gap > self.stats.get("max_heartbeat_gap_s", 0.0):
                    # the widest silence seen from a live worker: how close
                    # the cluster came to the bound below
                    self.stats["max_heartbeat_gap_s"] = gap
                    self.stats["max_heartbeat_gap_worker"] = (
                        f"{rec.worker_id} in state {rec.state}"
                    )
                bound = period * self.config.health_check_failure_threshold
                if gap <= bound:
                    rec.silent_ticks = -1
                    continue
                if gap <= bound * BUSY_SILENCE_FACTOR and self._silent_but_working(rec):
                    continue
                await self._on_worker_death(
                    rec, f"no heartbeat for {gap:.1f} s in state {rec.state}"
                )
            for node in list(self.nodes.values()):
                if not node.up or node.is_local:
                    continue
                if (
                    now - node.last_heartbeat
                    > period * self.config.health_check_failure_threshold
                ):
                    await self._on_node_death(node)
                    continue
                if node.state == "draining" and (
                    now >= node.drain_deadline or self._drain_quiesced(node)
                ):
                    await self._drain_finalize(node)
            if self._spent_transit:
                # expire tombstones whose late pin never arrived (sender died)
                cutoff = now - 60.0
                for tok in [t for t, ts in self._spent_transit.items() if ts < cutoff]:
                    del self._spent_transit[tok]
            if self._transit_pins:
                # reclaim pins whose transit_done was lost (receiver's RPC
                # timed out after the sender pinned).  10 minutes is far
                # beyond any live transfer, so this can only fire on a
                # genuinely lost ack
                cutoff = now - 600.0
                for tok in [
                    t for t, (ts, _) in self._transit_pins.items() if ts < cutoff
                ]:
                    _, oids = self._transit_pins.pop(tok)
                    for oid in oids:
                        rec = self.objects.get(oid)
                        if rec is not None and tok in rec.holders:
                            rec.holders.discard(tok)
                            self._obj_maybe_gc(rec)
                        early = self._early_refs.get(oid)
                        if early is not None:
                            early.discard(tok)
            if self._early_refs:
                # explicit, bounded grace for refs that arrived before their
                # obj_created: entries older than the window can only belong
                # to producers that died before registering — sweep them so
                # they can't pin future records or grow without bound
                cutoff = now - getattr(self.config, "early_ref_grace_s", 600.0)
                expired = [
                    o for o, ts in self._early_ref_ts.items() if ts < cutoff
                ]
                for o in expired:
                    self._early_ref_ts.pop(o, None)
                    self._early_refs.pop(o, None)
                if expired:
                    self.stats["early_refs_expired"] = (
                        self.stats.get("early_refs_expired", 0) + len(expired)
                    )
                    self._log_event("early_refs_expired", count=len(expired))
            if (
                self.mem_monitor is not None
                and now - self._last_mem_check
                >= self.config.memory_monitor_refresh_ms / 1000.0
            ):
                self._last_mem_check = now
                self._memory_pressure_check()
            if now - self._last_dir_touch > 30.0:
                # liveness marker: concurrent inits skip sweeping session
                # dirs with a recent mtime, protecting idle clusters and the
                # head-restart window from _sweep_stale_sessions
                self._last_dir_touch = now
                try:
                    os.utime(self.session_dir)
                except OSError:
                    pass

    def _memory_pressure_check(self):
        """Kill at most one worker per pressured node per refresh period
        (worker_killing_policy.h).  The retry/restart machinery turns the
        SIGKILL into a task retry or actor restart downstream."""
        from . import memory_monitor as mm

        for node in self.nodes.values():
            if node.state != "alive":
                continue
            if node.is_local:
                if not self.mem_monitor.is_pressured():
                    continue
            elif node.mem_pressured:
                node.mem_pressured = False  # re-armed by the next heartbeat
            else:
                continue
            cands = []
            for rec in self.workers.values():
                if rec.node_id != node.node_id or rec.state not in (
                    "idle",
                    "leased",
                    "actor",
                    # block workers are valid victims too: on an agent node
                    # in steady state EVERY pool worker is delegated, and
                    # excluding them would leave memory pressure with no
                    # candidate at all.  The head can't see whether a local
                    # lease is running on one, so it is treated like a
                    # leased worker (retriable: the submitter's retry budget
                    # absorbs the kill; the agent reaps and shrinks the
                    # block).
                    "delegated",
                ):
                    continue
                a = self.actors.get(rec.actor_id) if rec.actor_id else None
                cands.append(mm.Candidate(
                    worker=rec,
                    is_idle=rec.state == "idle",
                    retriable=rec.state in ("leased", "delegated")
                    or (a is not None and a.can_restart),
                    busy_since=rec.busy_since,
                ))
            victim = mm.pick_victim(cands)
            if victim is None:
                continue
            self.stats["oom_kills"] += 1
            self._log_event(
                "worker_oom_killed",
                worker_id=victim.worker_id,
                node_id=node.node_id,
                state=victim.state,
            )
            self._kill_worker_rec(victim)

    async def run(self):
        if not self._ha_sock_deferred:
            try:
                os.unlink(self.sock_path)  # stale socket from a killed head
            except FileNotFoundError:
                pass
        await self.server.start()
        # advertise the TCP endpoint for agents / cross-host clients
        for a in self.server.bound_addrs:
            if a.startswith("tcp:"):
                self.tcp_addr = a
        if self.ha_role == "standby":
            await self._run_standby()
            return
        if self._restored and await self._ha_boot_probe():
            # a successor head owns this session: stay demoted (refusing
            # everything) until the demote-exit grace fires.  head.addr is
            # left alone — it names the real head.
            await self._shutdown.wait()
            await self._teardown()
            return
        if self._ha_sock_deferred:
            # the probe found no live authority behind head.addr: this head
            # IS the cluster again — claim the session socket like a
            # promotion does
            try:
                os.unlink(self.sock_path)
            except OSError:
                pass
            self._sock_server = Server(
                [self.sock_path], self._handle, self._on_disconnect
            )
            await self._sock_server.start()
            self._ha_sock_deferred = False
        with open(os.path.join(self.session_dir, "head.addr"), "w") as f:
            f.write(self.tcp_addr or "")
        # prestart one worker per CPU (worker_pool.h prestart behavior);
        # a restarted head re-adopts its surviving workers instead
        if self.config.worker_prestart and not self._restored:
            for _ in range(int(self.local_node.total.get("CPU", 1))):
                self._spawn_worker()
        if self._restored:
            self._log_event(
                "head_restarted",
                workers=len(self.workers),
                actors=len(self.actors),
                nodes=len(self.nodes),
            )
            # resume drains interrupted by the restart: re-announce to the
            # re-registering clients and re-run the evacuation pass (idempotent
            # — already-migrated actors/objects are no longer on the node)
            for node in self.nodes.values():
                if node.state == "draining":
                    self._pub_drain(node)
                    spawn_bg(self._drain_evacuate(node))
        # HTTP dashboard (dashboard/head.py analogue): zero extra process,
        # the head answers from its own tables
        self.dashboard = None
        try:
            from ..dashboard import Dashboard

            self.dashboard = Dashboard(self)
            await self.dashboard.start(
                getattr(self.config, "head_host", "127.0.0.1"),
                int(os.environ.get("CA_DASHBOARD_PORT", "0")),
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self._log_event("dashboard_failed", error=repr(e))
        # named + exception-logged: a dead monitor/persist loop is a head
        # that stops detecting node death or persisting state — it must
        # warn the moment it dies, not at GC time
        self._ha_start_active_loops()
        # readiness marker for the driver — atomic rename: a reader must
        # never observe the file existing but empty (the pid parse treats
        # that as a dead cluster and refuses to connect)
        ready_path = os.path.join(self.session_dir, "head.ready")
        with open(ready_path + ".tmp", "w") as f:
            f.write(str(os.getpid()))
        os.replace(ready_path + ".tmp", ready_path)
        await self._shutdown.wait()
        for t in self._ha_tasks:
            t.cancel()
        if self.dashboard is not None:
            await self.dashboard.stop()
        await self._teardown()

    async def _run_standby(self):
        """Warm-standby service loop: advertise the rank-suffixed discovery
        files, run the subscribe/apply FSM, and — on promotion — continue
        as the active head (the standby loop already started the active
        loops and claimed the session files)."""
        from ..util.aio import spawn_logged

        addr_file = os.path.join(
            self.session_dir, f"head.standby{self.ha_rank}.addr"
        )
        with open(addr_file + ".tmp", "w") as f:
            f.write(self.tcp_addr or "")
        os.replace(addr_file + ".tmp", addr_file)
        standby_task = spawn_logged(
            self._ha_standby_loop(), f"head-standby{self.ha_rank}"
        )
        ready = os.path.join(
            self.session_dir, f"head.standby{self.ha_rank}.ready"
        )
        with open(ready + ".tmp", "w") as f:
            f.write(str(os.getpid()))
        os.replace(ready + ".tmp", ready)
        await self._shutdown.wait()
        standby_task.cancel()
        for t in self._ha_tasks:
            t.cancel()
        if self._ha_replog is not None:
            self._ha_replog.close()
        await self._teardown()

    async def _teardown(self):
        if self.ha_role != "active":
            # a never-promoted standby or a fenced zombie owns NOTHING of
            # the session (workers, shm namespace, discovery files all
            # belong to the active head): just release the sockets
            if self._sock_server is not None:
                await self._sock_server.stop()
            await self.server.stop()
            return
        for node in self.nodes.values():
            if node.conn is not None and not node.conn.closed:
                try:
                    node.conn.notify("node_shutdown")
                    from .protocol import flush_writer

                    flush_writer(node.conn.writer)
                except Exception:
                    pass
        for rec in self.workers.values():
            if rec.state == "dead":
                continue
            if rec.proc is not None and rec.proc.poll() is None or (
                rec.proc is None and rec.node_id == LOCAL_NODE and rec.pid
            ):
                try:
                    os.kill(rec.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        if self._sock_server is not None:
            await self._sock_server.stop()
        await self.server.stop()
        # GC all shm segments of this session (local host; agents clean their
        # own namespaces on shutdown)
        import shutil

        shutil.rmtree(os.path.join("/dev/shm", self.session_name), ignore_errors=True)


def read_shm_chunk(session_name: str, map_cache: Dict[str, Any], shm_name: str, off: int, length: int) -> bytes:
    """Read one chunk of a local object for node-to-node transfer.  Shared by
    the head (serving n0) and node agents (serving their node).  Serves shm
    arena slices (seal-sequence verified), dedicated segments, and spilled
    disk files ("spill:<path>").  Names/paths are validated against the
    session namespace (no path escapes)."""
    import mmap as _mmap

    from .errors import StaleObjectError
    from .object_store import _SLICE_HDR, ShmObjectStore

    if shm_name.startswith("spill:"):
        path = shm_name[len("spill:"):]
        if f"/{session_name}/" not in path or ".." in path or "/spill/" not in path:
            raise ValueError(f"invalid spill path {path!r}")
        fd = os.open(path, os.O_RDONLY)
        try:
            m = _mmap.mmap(fd, os.fstat(fd).st_size, prot=_mmap.PROT_READ)
            return bytes(memoryview(m)[off : off + length])
        finally:
            os.close(fd)
    if not shm_name.startswith(session_name + "/") or ".." in shm_name:
        raise ValueError(f"invalid shm name {shm_name!r}")
    file_name = shm_name.split("@", 1)[0]
    base = 0
    seq = 0
    if "@" in shm_name:
        _, base, _size, seq = ShmObjectStore.parse_slice(shm_name)
    m = map_cache.get(file_name)
    if m is None:
        fd = os.open(os.path.join("/dev/shm", file_name), os.O_RDONLY)
        try:
            m = _mmap.mmap(fd, os.fstat(fd).st_size, prot=_mmap.PROT_READ)
        finally:
            os.close(fd)
        map_cache[file_name] = m
    if seq:
        cur = int.from_bytes(bytes(m[base : base + _SLICE_HDR]), "little")
        if cur != seq:
            raise StaleObjectError(f"slice {shm_name} recycled while serving")
        base += _SLICE_HDR
    return bytes(memoryview(m)[base + off : base + off + length])


def drop_pull_map(map_cache: Dict[str, Any], shm_name: str) -> None:
    """Invalidate the serving-side map of an unlinked shm file, so transfer
    caches don't pin pages of deleted objects (arena files are owned by their
    producer and are never dropped here)."""
    file_name = shm_name.split("@", 1)[0]
    if "@" in shm_name:
        return  # arena slice: the arena file outlives the object
    m = map_cache.pop(file_name, None)
    if m is not None:
        try:
            m.close()
        except (BufferError, ValueError):
            pass


def main():
    session_dir = os.environ["CA_SESSION_DIR"]
    config = CAConfig.from_json(os.environ["CA_CONFIG_JSON"])
    import json

    resources = json.loads(os.environ.get("CA_RESOURCES", '{"CPU": 4}'))
    head = Head(session_dir, config, resources)

    def _loop_factory():
        loop = asyncio.new_event_loop()
        if hasattr(asyncio, "eager_task_factory"):
            loop.set_task_factory(asyncio.eager_task_factory)
        return loop

    if hasattr(asyncio, "Runner"):  # 3.11+
        with asyncio.Runner(loop_factory=_loop_factory) as runner:
            runner.run(head.run())
    else:
        loop = _loop_factory()
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(head.run())
        finally:
            try:
                loop.run_until_complete(loop.shutdown_asyncgens())
            finally:
                asyncio.set_event_loop(None)
                loop.close()


if __name__ == "__main__":
    main()
