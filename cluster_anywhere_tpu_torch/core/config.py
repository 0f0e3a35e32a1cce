"""Central tunables table, the analogue of the reference's RAY_CONFIG macro
table (src/ray/common/ray_config_def.h): every knob has a typed default and an
environment-variable override `CA_<NAME>`.  The resolved config dict is handed
to every spawned process so the whole cluster agrees on values.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import MISSING, dataclass, field, fields
from typing import Any

_ENV_PREFIX = "CA_"


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(_ENV_PREFIX + name.upper())
    if raw is None:
        return default
    t = type(default)
    if t is bool:
        return raw.lower() in ("1", "true", "yes")
    if t is int:
        return int(raw)
    if t is float:
        return float(raw)
    return raw


# longest tail a session root gets: "/session_<13-digit ms>_<7-digit pid>"
# plus "/drv_driver-<7-digit pid>-<6 hex>.sock", the longest socket name
_SOCK_TAIL = len("/session_1234567890123_1234567") + len("/drv_driver-1234567-abcdef.sock")
_SUN_PATH_MAX = 107  # AF_UNIX sun_path holds 108 bytes with its NUL


def _default_session_root() -> str:
    """`<temp dir>/ca_torch`: each temp dir (TMPDIR) holds its own sessions,
    so the sweeper and `address="auto"` never reach a session of another
    tree or of the JAX package.  A temp dir too long for the AF_UNIX
    sockets under it falls back to a short dir under /tmp named after a
    hash of the temp dir, which keeps the separation."""
    tmp = tempfile.gettempdir()
    root = os.path.join(tmp, "ca_torch")
    if len(root.encode()) + _SOCK_TAIL > _SUN_PATH_MAX:
        digest = hashlib.sha256(os.path.abspath(tmp).encode()).hexdigest()[:16]
        root = os.path.join("/tmp", f"ca_torch_{digest}")
    return root


@dataclass
class CAConfig:
    # --- object store ---
    inline_object_max_bytes: int = 100 * 1024  # larger objects go to shm
    object_store_memory: int = 2 * 1024**3  # shm budget per node
    shm_parallel_copy_threshold: int = 8 * 1024**2  # use parallel memcpy above
    shm_copy_threads: int = 8

    # --- scheduler / leases ---
    max_leases_per_shape: int = 64  # cap on concurrently held leases per resource shape
    lease_idle_timeout_s: float = 1.0  # return leases idle longer than this
    max_inflight_per_lease: int = 16  # pipelined task pushes per leased worker
    worker_prestart: bool = True
    scheduler_spread_threshold: float = 0.5  # hybrid policy: pack below, spread above
    # --- lease plane (node-local granting; raylet LocalTaskManager analogue) ---
    # the head delegates bounded per-pool lease capacity ("lease blocks") to
    # node agents; submitters dial agents directly for the hot unit-shape
    # lease class, keeping per-task traffic off the head
    lease_delegation: bool = True
    # max delegated workers per (node, pool); 0 = auto (the node's CPU count)
    lease_block_max: int = 0
    # submitter-side lease-directory cache TTL (one lease_dir RPC per pool
    # per TTL while growing, zero in steady state)
    lease_dir_ttl_s: float = 3.0

    # --- ownership plane (core/ownership.py; NSDI'21 ownership protocol) ---
    # owner-resident object lifetime: borrowers settle inc/dec with the
    # OWNER process's ledger over direct connections; the head keeps only
    # the registry (obj_created/obj_release) and adopts orphaned ledgers on
    # owner death.  Off = classic centralized holders at the head.
    owner_plane: bool = True
    # owner_sync digest cadence (ledger deltas ride the housekeeping loop)
    owner_sync_period_s: float = 1.0
    # how long the head (and owner ledgers) hold a refcount inc that arrived
    # before its obj_created/registration (cross-socket ordering), before the
    # entry is swept as orphaned.  Must comfortably exceed the longest task
    # whose return ref is forwarded before completion.
    early_ref_grace_s: float = 600.0

    # --- multi-node ---
    head_host: str = "127.0.0.1"  # TCP bind host for the head (cross-host: 0.0.0.0)
    transfer_chunk_bytes: int = 4 * 1024**2  # node-to-node object pull chunk
    # --- transfer plane (windowed multi-source bulk pulls) ---
    # pull_chunk RPCs kept in flight per source during a node-to-node object
    # pull / client upload / head evacuation (1 = the old serial
    # request-response ping-pong); the same window applies per holder when a
    # pull fans out across multiple live copies
    transfer_window: int = 4
    # when the directory reports several live copies, split the byte range
    # across them and pull concurrently (failed sources re-assign their
    # remaining chunks to survivors instead of failing the transfer)
    transfer_multi_source: bool = True
    # host collective ring default payload encoding ("" = f32 wire bytes,
    # untouched default; "int8"/"bf16" = EQuARX-style block-quantized ring).
    # Per-call allreduce(..., quantize=...) overrides the group default.
    collective_quantize: str = ""
    # elements per quantization block (one f32 scale per block on the wire)
    collective_quant_block: int = 4096
    # test/bench hook: per-pull_chunk serving delay (seconds) — simulates a
    # high-latency link so the windowed-pull A/B measures pipelining, not
    # this host's memcpy speed.  0 = off (production).
    testing_transfer_delay_s: float = 0.0
    # delta-synced node state (ray_syncer analogue): agents send versioned
    # component deltas (node_sync) instead of full per-tick heartbeats; an
    # idle node's tick is a bare keepalive.  Off = legacy full node_heartbeat.
    delta_sync: bool = True

    # --- health / failure detection ---
    health_check_period_s: float = 2.0
    health_check_failure_threshold: int = 5
    worker_register_timeout_s: float = 30.0
    # node memory monitor (memory_monitor.h analogue): kill a worker when
    # node used/total exceeds the threshold; 0 disables the monitor
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_ms: int = 250
    # drain plane: default evacuation window for `drain_node` / agent SIGTERM
    # self-drain — running tasks get this long to finish before the deadline
    # kill; actors and sole-copy objects migrate to survivors inside it
    drain_deadline_s: float = 30.0
    # bounded-IO defaults (util/aio.py): every control-plane dial goes
    # through aio.dial() with this connect bound — on preemptible VMs a peer
    # can vanish mid-handshake and an unbounded connect parks the caller
    # forever; io_timeout_s bounds single request/response reads and
    # writer drains (NOT persistent-connection read loops, which idle
    # legitimately)
    dial_timeout_s: float = 15.0
    io_timeout_s: float = 60.0

    # --- HA plane (warm-standby head replication / epoch-fenced failover) ---
    # master switch for the head-replication machinery.  With no standby
    # subscribed the active head's only HA cost is a per-snapshot-tick flag
    # check, so this stays on by default.
    ha_plane: bool = True
    # table-delta replication tick on the active head (rides the persist
    # loop); also the standby-liveness heartbeat period on the stream
    ha_repl_interval_s: float = 0.25
    # bounded re-stage window: replication records kept in memory for
    # standbys that reconnect with a watermark; older watermarks get a full
    # state transfer instead
    ha_repl_log_max: int = 4096
    # how long an acked KV commit waits for standby acks before the slow
    # standby is dropped from the sync set (availability over sync once a
    # replica is gone)
    ha_sync_commit_timeout_s: float = 2.0
    # standby-side: how long the active head must stay unreachable (stream
    # closed AND redials failing) before self-promotion; each standby rank
    # waits one extra grace period per rank so replicas don't race
    ha_failover_grace_s: float = 2.0
    # standby self-promotes after the grace window (off = promotion only via
    # `ca head promote` / head_promote RPC)
    ha_auto_promote: bool = True
    # restarting head probes the current head.addr occupant before claiming
    # authority: a live head with a >= epoch means THIS process is the stale
    # one — demote at boot instead of split-braining the registry
    ha_boot_probe: bool = True

    # --- tasks / actors ---
    default_max_retries: int = 3
    lineage_cap: int = 8192  # task specs kept for object reconstruction
    streaming_backpressure: int = 8  # unconsumed items before a generator blocks
    default_actor_max_restarts: int = 0
    actor_restart_backoff_s: float = 0.2
    push_timeout_s: float = 60.0

    # --- misc ---
    session_dir_root: str = field(default_factory=_default_session_root)
    log_to_driver: bool = True
    # --- log plane (util/logplane.py; raylet log-monitor analogue) ---
    log_capture: bool = True  # structured stdout/stderr capture in spawned procs
    log_rotate_bytes: int = 1024 * 1024  # per-process JSONL cap before .1 rollover
    log_ship_interval_s: float = 0.25  # agent/head tail-and-ship period
    log_ship_batch: int = 500  # max records per shipped log_batch
    event_buffer_flush_period_s: float = 1.0
    metrics_report_period_s: float = 5.0
    # --- metrics plane (util/timeseries.py, node-agent /metrics scrape) ---
    # head-free scrape topology: workers ship metric deltas to their node's
    # agent, which serves `GET /metrics` over HTTP (Prometheus exposition)
    # and piggybacks the deltas onto node_sync ticks head-ward.  Off =
    # legacy per-worker metrics_report RPCs straight to the head.
    metrics_plane: bool = True
    # head-side time-series retention: tier-0 sampling cadence (seconds) and
    # ring length; tier 1 is timeseries_tier1_mult x coarser, same length.
    # 0 disables retention entirely.
    timeseries_interval_s: float = 10.0
    timeseries_len: int = 360
    timeseries_tier1_mult: int = 12
    timeseries_max_series: int = 1024
    # event-loop lag self-measurement period for the head (seconds)
    loop_lag_period_s: float = 0.25
    # --- flight recorder (util/flightrec.py) ---
    # per-process bounded ring journal of plane decision events (fence
    # mints/refusals, drain FSM transitions, netchaos firings, DAG
    # recompiles/timeouts, serve shed/drain, train barrier phases, transfer
    # failover, owner adoption), shipped head-ward on the metrics-delta
    # path.  Off = util.flightrec.REC stays None and every record site is a
    # single `is None` branch.
    flightrec_plane: bool = True
    # per-process ring capacity (drop-oldest beyond this)
    flightrec_ring_len: int = 4096
    # head-side merged journal capacity
    flightrec_head_len: int = 50_000
    # deterministic RPC fault injection, modeled on the reference's
    # RAY_testing_rpc_failure (src/ray/rpc/rpc_chaos.h): "method=N" pairs,
    # failing the first N matching RPCs.
    testing_rpc_failure: str = ""
    # deterministic per-method RPC latency injection: "method=MS" pairs add
    # MS milliseconds before each matching send (straggler RPCs; names
    # validated against the protocol contract exactly like the failure knob)
    testing_rpc_delay: str = ""
    # network-chaos plane (core/netchaos.py): per-link blackhole / delay /
    # flap schedules, e.g. "seed=7;n0<>node1:blackhole@1+8".  Empty = every
    # injection hook disabled (no per-frame overhead).
    testing_net_chaos: str = ""

    def __post_init__(self):
        for f in fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))

    def to_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})

    @classmethod
    def from_json(cls, s: str) -> "CAConfig":
        cfg = cls.__new__(cls)
        data = json.loads(s)
        for f in fields(cls):
            if f.name in data:
                setattr(cfg, f.name, data[f.name])
            else:
                setattr(cfg, f.name, f.default if f.default_factory is MISSING else f.default_factory())
        return cfg


_global_config: CAConfig | None = None


def get_config() -> CAConfig:
    global _global_config
    if _global_config is None:
        _global_config = CAConfig()
    return _global_config


def set_config(cfg: CAConfig) -> None:
    global _global_config
    _global_config = cfg
