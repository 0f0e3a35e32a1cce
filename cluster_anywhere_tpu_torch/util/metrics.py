"""User-defined metrics: Counter / Gauge / Histogram (analogue of the
reference's python/ray/util/metrics.py over the C++ stats pipeline
src/ray/stats/metric.h -> MetricsAgent -> Prometheus).

Metrics record locally (lock-free per-process dicts) and a background flusher
ships deltas to the head, which aggregates across the cluster. Snapshot via
`get_metrics_snapshot()`; Prometheus exposition text via `prometheus_text()`.
"""

from __future__ import annotations

import bisect
import functools
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: List["Metric"] = []
_by_name: Dict[str, "Metric"] = {}
_flusher_started = False

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0,
]


def _tags_key(tags: Optional[Dict[str, str]]) -> str:
    return json.dumps(sorted((tags or {}).items()))


def _ensure_flusher():
    global _flusher_started
    with _registry_lock:
        if _flusher_started:
            return
        _flusher_started = True
    t = threading.Thread(target=_flush_loop, daemon=True, name="ca-metrics-flush")
    t.start()


def _flush_loop():
    while True:
        time.sleep(1.0)
        flush_once()


# last-shipped WIRE_STATS values, so flush_once sends deltas (counter
# semantics at the head aggregator)
_wire_shipped: Dict[str, int] = {}
_WIRE_DESCS = {
    "frames_sent": "physical RPC frames written by this process",
    "messages_sent": "logical RPC messages written by this process",
    "batch_frames_sent": "frames that were batch envelopes (>1 message)",
    "frames_recv": "physical RPC frames read by this process",
    "messages_recv": "logical RPC messages read by this process",
    "template_renders": "task-spec template fast-path encodes",
    "refcount_flushes_suppressed": "obj_refs sends merged by the debouncer",
}


_logplane_shipped: Dict[str, int] = {}
_LOGPLANE_DESCS = {
    "lines_total": "log lines captured by this process's log-plane writers",
    "bytes_total": "bytes of captured log line text",
    "dropped_total": "log lines dropped (ship failure, malformed tail read)",
}


_train_shipped: Dict[str, int] = {}
_TRAIN_DESCS = {
    "preempt_restarts_total": (
        "worker-group rebuilds triggered proactively by a drain warning "
        "(before the preemption kill, not after a poll failure)"
    ),
    "preempt_barrier_acked_total": (
        "checkpoint-on-preempt barriers where every rank checkpointed "
        "inside the warning window"
    ),
    "preempt_barrier_timeout_total": (
        "checkpoint-on-preempt barriers torn down without full acks"
    ),
    "budget_exempt_attempts_total": (
        "train attempts restarted without consuming failure_config."
        "max_failures (preemption-caused deaths are the system's fault)"
    ),
    "callback_errors_total": "run_config callback hooks that raised",
    "shutdown_errors_total": "train worker-group teardown errors",
}


_drain_shipped: Dict[str, int] = {}
_DRAIN_DESCS = {
    "tasks_evacuated_total": (
        "task retries exempted from max_retries because the worker died on "
        "a draining/preempted node"
    ),
    "leases_recalled_total": "idle leases returned early on a drain pub",
}


_owner_shipped: Dict[str, int] = {}
_OWNER_DESCS = {
    "refs_settled_local": "refcount windows applied to this process's own ledger",
    "refs_sent_owner": "refcount updates sent to another owner's ledger (direct)",
    "refs_recv": "borrower refcount updates served by this process's ledger",
    "refs_head_fallback": "refcount windows that fell back to the head path",
    "owner_gc": "objects whose cluster lifetime this ledger settled",
    "owner_gc_head_down": "of those, settled with the head unreachable",
    "pins_served": "owner_pin requests answered authoritatively",
    "pending_expired": "grace-expired pending borrower registrations",
    "spills_decided": "spill free/defer decisions made owner-side",
    "syncs_sent": "owner_sync ledger digests shipped to the head",
    "syncs_full": "of those, full resyncs (reconnect)",
}


_transfer_shipped: Dict[str, int] = {}
_TRANSFER_DESCS = {
    "pulls": "node-to-node object transfers completed by this process",
    "bytes_pulled": "object bytes received over pull_chunk",
    "chunks_pulled": "pull_chunk responses applied to import arenas",
    "window_peak_sum": "sum over pulls of the peak in-flight pull_chunk RPCs",
    "sources_used": "holders that served >=1 chunk, summed over pulls",
    "multi_source_pulls": "pulls that drew bytes from more than one holder",
    "source_failovers": "sources dropped mid-pull (their range re-assigned)",
    "pull_retry_rounds": "re-locate rounds after every source failed",
    "bytes_uploaded": "client-mode put bytes streamed to the head",
    "copy_notify_deferred": "obj_copy notifies deferred for re-send",
    "quant_bytes_saved": "f32-equivalent bytes minus wire bytes, quantized ring",
    "quant_ops": "quantized collective ops completed",
}

_channel_shipped: Dict[str, int] = {}
_CHANNEL_DESCS = {
    "writes": "shm-channel payloads published by this process",
    "reads": "shm-channel payloads consumed by this process",
    "spills": "oversized channel payloads routed through the object store",
    "backpressure_waits": "channel writes that blocked on a reader ack",
    "closes": "channel close flags raised",
}

_dag_shipped: Dict[str, int] = {}
_DAG_DESCS = {
    "compiles": "compiled DAGs built (incl. recompiles)",
    "recompiles": "compiled DAGs rebuilt after an actor restart",
    "executions": "compiled-DAG execute() submissions",
    "results": "compiled-DAG ticks whose outputs the driver consumed",
    "backpressure_waits": "executes that blocked at max_inflight_executions",
    "timeouts": "DagTimeoutError raised (stalled node named)",
    "actor_deaths": "DeadActorError raised (loop died mid-execute)",
    "teardowns": "compiled-DAG teardowns",
}


_lease_shipped: Dict[str, int] = {}
_LEASE_DESCS = {
    "local_grants": "leases granted node-locally by agents (lease blocks)",
    "local_denied": "local grant attempts denied everywhere (blocks full)",
    "local_released": "leases released back to their granting agent",
    "head_grants": "leases granted centrally by the head",
    "head_released": "leases returned to the head",
    "fallbacks": "local grant attempts that fell back to the head",
}


def _counter_deltas(
    prefix: str, stats: Dict[str, int], shipped: Dict[str, int], descs: Dict[str, str]
) -> List[dict]:
    """Delta-ship a module counter dict as `<prefix><key>` counter records
    (counter semantics at the head aggregator; first-seen zeros included so
    the series exists from the first flush)."""
    out = []
    tags = _tags_key(None)
    for k, v in stats.items():
        delta = v - shipped.get(k, 0)
        if delta or k not in shipped:
            shipped[k] = v
            out.append(
                {"name": f"{prefix}{k}", "type": "counter",
                 "desc": descs.get(k, ""), "tags_key": tags,
                 "value": float(delta)}
            )
    return out


def _wire_records() -> List[dict]:
    """Runtime wire counters (core/protocol.py WIRE_STATS) as ca_rpc_*
    counter records — the observability path for the control-plane batching
    layer (dashboard /metrics, `get_metrics_snapshot`, grafana)."""
    from ..core.protocol import WIRE_STATS

    return _counter_deltas("ca_rpc_", WIRE_STATS, _wire_shipped, _WIRE_DESCS)


def _channel_records() -> List[dict]:
    """Shm-channel counters (channel/shm_channel.py CHANNEL_STATS) as
    ca_channel_* records — the data plane under compiled DAGs and the serve
    token-stream path."""
    from ..channel.shm_channel import CHANNEL_STATS

    return _counter_deltas(
        "ca_channel_", CHANNEL_STATS, _channel_shipped, _CHANNEL_DESCS
    )


def _dag_records() -> List[dict]:
    """Compiled-DAG driver counters (dag/compiled.py DAG_STATS) as ca_dag_*
    records: executions/results volume plus the failure-semantics series
    (timeouts, actor deaths, recompiles)."""
    from ..dag.compiled import DAG_STATS

    return _counter_deltas("ca_dag_", DAG_STATS, _dag_shipped, _DAG_DESCS)


def _lease_records() -> List[dict]:
    """Lease-plane counters (core/worker.py LEASE_STATS) as ca_lease_*
    records: local (agent-granted) vs head (central) grants/releases — the
    series that proves the hot lease class stays off the head."""
    from ..core.worker import LEASE_STATS

    return _counter_deltas("ca_lease_", LEASE_STATS, _lease_shipped, _LEASE_DESCS)


def _owner_records() -> List[dict]:
    """Ownership-plane counters (core/ownership.py OWNER_STATS) as
    ca_owner_* records: owner-resident vs head-fallback refcount settlement,
    ledger GC, owner-side spill decisions, and digest sync volume — the
    series that proves steady-state object lifetime stays off the head."""
    from ..core.ownership import OWNER_STATS

    return _counter_deltas("ca_owner_", OWNER_STATS, _owner_shipped, _OWNER_DESCS)


def _transfer_records() -> List[dict]:
    """Transfer-plane counters (core/worker.py TRANSFER_STATS) as
    ca_transfer_* records: windowed/multi-source pull volume, window
    occupancy, failovers, and the quantized ring's wire savings — the series
    behind `ca microbenchmark --transfer`'s structural claims."""
    from ..core.worker import TRANSFER_STATS

    return _counter_deltas(
        "ca_transfer_", TRANSFER_STATS, _transfer_shipped, _TRANSFER_DESCS
    )


def _drain_records() -> List[dict]:
    """Drain-plane counters (core/worker.py DRAIN_STATS) as ca_drain_*
    records: budget-exempt task evacuations and early lease recalls — the
    client-side half of the drain plane (the head ships its own
    nodes_drained / drain_actors_migrated / drain_objects_migrated /
    drain_deadline_kills through the stats table)."""
    from ..core.worker import DRAIN_STATS

    return _counter_deltas("ca_drain_", DRAIN_STATS, _drain_shipped, _DRAIN_DESCS)


def _train_records() -> List[dict]:
    """Train-plane counters (core/worker.py TRAIN_STATS) as ca_train_*
    records: proactive preemption restarts, checkpoint-barrier outcomes,
    and budget-exempt attempts — the series behind `ca microbenchmark
    --train-elastic`'s proactive-vs-reactive claim."""
    from ..core.worker import TRAIN_STATS

    return _counter_deltas("ca_train_", TRAIN_STATS, _train_shipped, _TRAIN_DESCS)


def _logplane_records() -> List[dict]:
    """Log-plane counters (util/logplane.py LOG_STATS) as ca_log_lines_total
    / ca_log_bytes_total / ca_log_dropped_total — capture volume and drop
    visibility for `ca status`, the dashboard, and Prometheus."""
    from .logplane import LOG_STATS

    return _counter_deltas("ca_log_", LOG_STATS, _logplane_shipped, _LOGPLANE_DESCS)


_flightrec_shipped: Dict[str, int] = {}
_FLIGHTREC_DESCS = {
    "recorded": "flight-recorder decision events journaled by this process",
    "dropped": "flight-recorder events rotated out of the bounded ring",
    "shipped": "flight-recorder events shipped head-ward (metrics piggyback)",
}


def _flightrec_records() -> List[dict]:
    """Flight-recorder health counters (util/flightrec.py FLIGHTREC_STATS)
    as ca_flightrec_* records: journal volume plus ring-drop accounting."""
    from .flightrec import FLIGHTREC_STATS

    return _counter_deltas(
        "ca_flightrec_", FLIGHTREC_STATS, _flightrec_shipped, _FLIGHTREC_DESCS
    )


# drained-but-unsent records: a send that fails after the drain (head closed
# or unreachable in the window between drain and notify) re-stages its batch
# here instead of losing the deltas; the next flush ships them first so
# counter order is preserved at the head aggregator.  BOUNDED: a long outage
# with a chatty process would otherwise grow this without limit — at the cap
# the oldest deltas drop (counted in ca_metrics_dropped_total, warned once
# per period) because fresh deltas carry the live picture an operator needs.
_restage_lock = threading.Lock()
_restaged: List[dict] = []
RESTAGE_CAP = 10_000  # records; ~a few MB worst case

# the metrics plane's own health counters (shipped like every module dict)
METRICS_STATS = {"dropped_total": 0, "agent_shipped": 0, "head_shipped": 0}
_metrics_shipped: Dict[str, int] = {}
_METRICS_DESCS = {
    "dropped_total": "metric delta records dropped at the bounded re-stage buffer",
    "agent_shipped": "metric delta records shipped to this node's agent",
    "head_shipped": "metric delta records shipped directly to the head",
}


def _metrics_records() -> List[dict]:
    return _counter_deltas("ca_metrics_", METRICS_STATS, _metrics_shipped, _METRICS_DESCS)


def _restage(batch: List[dict]) -> None:
    """Re-stage an unsent batch, enforcing the cap (drop-oldest)."""
    with _restage_lock:
        _restaged.extend(batch)
        over = len(_restaged) - RESTAGE_CAP
        if over > 0:
            del _restaged[:over]
            METRICS_STATS["dropped_total"] += over
    if over > 0:
        from ..core.ownership import warn_ratelimited

        warn_ratelimited(
            "metrics-restage-cap",
            f"metrics re-stage buffer full: dropped {over} oldest delta "
            f"records (head/agent unreachable too long)",
        )

# samplers run at the top of every flush (e.g. CUDA device-memory gauges);
# registered via register_flush_hook
_flush_hooks: List[Callable[[], None]] = []


def register_flush_hook(fn: Callable[[], None]) -> None:
    """Register a sampler called at the start of every metrics flush."""
    _flush_hooks.append(fn)


def _agent_ship_addr() -> Optional[str]:
    """This process's node-agent metrics sink, when the metrics plane is on.
    Agent-spawned workers carry CA_AGENT_ADDR; head-node workers and drivers
    have no agent and keep the direct head path."""
    from ..core.config import get_config

    if not getattr(get_config(), "metrics_plane", True):
        return None
    import os

    return os.environ.get("CA_AGENT_ADDR") or None


def flush_once():
    """Ship pending deltas (called by the background flusher; also directly
    from tests for determinism).  Metrics-plane routing: workers with a node
    agent ship to IT (the agent aggregates the node table for head-free
    Prometheus scrape and piggybacks the deltas onto its node_sync ticks);
    everyone else ships straight to the head.  The agent path works with the
    head DOWN — that is the point."""
    from ..core.worker import try_global_worker

    w = try_global_worker()
    if w is None:
        return
    agent_addr = _agent_ship_addr()
    head_ok = w.head is not None and not w.head.closed
    if agent_addr is None and not head_ok:
        return
    for hook in list(_flush_hooks):
        try:
            hook()
        except Exception:
            pass
    batch = []
    with _restage_lock:
        if _restaged:
            batch.extend(_restaged)
            _restaged.clear()
    with _registry_lock:
        metrics = list(_registry)
    for m in metrics:
        batch.extend(m._drain())
    batch.extend(_wire_records())
    batch.extend(_channel_records())
    batch.extend(_dag_records())
    batch.extend(_lease_records())
    batch.extend(_owner_records())
    batch.extend(_transfer_records())
    batch.extend(_drain_records())
    batch.extend(_train_records())
    batch.extend(_logplane_records())
    batch.extend(_flightrec_records())
    batch.extend(_metrics_records())
    # flight-recorder piggyback: the journal's unshipped slice rides the
    # metrics_report this flush already sends (zero new standalone RPCs); a
    # failed send rewinds the recorder's ship cursor alongside _restage
    from . import flightrec as _fr

    frev = _fr.REC.drain() if _fr.REC is not None else []
    if not batch and not frev:
        return

    def _restage_all():
        _restage(batch)
        if frev and _fr.REC is not None:
            _fr.REC.restage(frev)

    async def _send_agent():
        try:
            conn = await w.conn_to(agent_addr)
            conn.notify("metrics_report", metrics=batch, flightrec=frev)
            METRICS_STATS["agent_shipped"] += len(batch)
        except asyncio.CancelledError:
            raise  # shutdown: drop the batch rather than re-route it
        except Exception:
            # agent unreachable (crashing node): fall back to the head so a
            # lone agent death doesn't blind the whole node's metrics
            _send_head()

    def _send_head():
        if w.head is None or w.head.closed:
            _restage_all()
            return
        try:
            w.head.notify("metrics_report", metrics=batch, flightrec=frev)
            METRICS_STATS["head_shipped"] += len(batch)
        except Exception:
            # head died between drain and send: the deltas are already out of
            # the metric objects — re-stage them or they are lost for good
            _restage_all()

    def _send():
        if agent_addr is not None:
            from ..core.protocol import spawn_bg

            spawn_bg(_send_agent())
        else:
            _send_head()

    try:
        w.loop.call_soon_threadsafe(_send)
    except RuntimeError:
        _restage(batch)


class Metric:
    _type = "gauge"

    def __init__(self, name: str, description: str = "", tag_keys: Sequence[str] = ()):
        if not name or not name.replace("_", "a").replace(":", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()

    def _register(self):
        """Dedup by name: re-constructing a metric (e.g. per task invocation)
        shares the first instance's state instead of growing the registry and
        leaking one object per construction."""
        with _registry_lock:
            ex = _by_name.get(self.name)
            if ex is not None and type(ex) is type(self):
                self._adopt(ex)
                return
            _by_name[self.name] = self
            _registry.append(self)
        _ensure_flusher()

    def _adopt(self, other: "Metric"):
        raise NotImplementedError

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        out = dict(self._default_tags)
        if tags:
            unknown = set(tags) - set(self.tag_keys) - set(self._default_tags)
            if self.tag_keys and unknown:
                raise ValueError(f"undeclared tag keys {sorted(unknown)}")
            out.update(tags)
        return out

    def _drain(self) -> List[dict]:
        raise NotImplementedError


class Counter(Metric):
    _type = "counter"

    def __init__(self, name, description: str = "", tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._pending: Dict[str, float] = {}
        self._register()

    def _adopt(self, other):
        self._lock = other._lock
        self._pending = other._pending

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("Counter.inc value must be >= 0")
        key = _tags_key(self._merged(tags))
        with self._lock:
            self._pending[key] = self._pending.get(key, 0.0) + value

    def _drain(self) -> List[dict]:
        with self._lock:
            pending, self._pending = self._pending, {}
        return [
            {"name": self.name, "type": "counter", "desc": self.description,
             "tags_key": k, "value": v}
            for k, v in pending.items()
        ]


class Gauge(Metric):
    _type = "gauge"

    def __init__(self, name, description: str = "", tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[str, float] = {}
        self._dirty: set = set()
        self._register()

    def _adopt(self, other):
        self._lock = other._lock
        self._values = other._values
        self._dirty = other._dirty

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = _tags_key(self._merged(tags))
        with self._lock:
            self._values[key] = float(value)
            self._dirty.add(key)

    def _drain(self) -> List[dict]:
        with self._lock:
            dirty, self._dirty = self._dirty, set()
            out = [
                {"name": self.name, "type": "gauge", "desc": self.description,
                 "tags_key": k, "value": self._values[k]}
                for k in dirty
            ]
        return out


class Histogram(Metric):
    _type = "histogram"

    def __init__(
        self,
        name,
        description: str = "",
        boundaries: Optional[Sequence[float]] = None,
        tag_keys: Sequence[str] = (),
    ):
        super().__init__(name, description, tag_keys)
        self.bounds = list(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        if sorted(self.bounds) != self.bounds:
            raise ValueError("histogram boundaries must be sorted")
        # bound once: observe() is the hot path, so the bucket lookup is a
        # single pre-bound call (no per-observation import or attribute walk)
        self._bucket_index = functools.partial(bisect.bisect_left, self.bounds)
        self._pending: Dict[str, dict] = {}
        self._register()

    def _adopt(self, other):
        self._lock = other._lock
        self._pending = other._pending
        self.bounds = other.bounds
        self._bucket_index = other._bucket_index

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = _tags_key(self._merged(tags))
        with self._lock:
            cur = self._pending.setdefault(
                key, {"buckets": [0] * (len(self.bounds) + 1), "sum": 0.0, "count": 0}
            )
            cur["buckets"][self._bucket_index(value)] += 1
            cur["sum"] += value
            cur["count"] += 1

    def _drain(self) -> List[dict]:
        with self._lock:
            pending, self._pending = self._pending, {}
        return [
            {"name": self.name, "type": "histogram", "desc": self.description,
             "tags_key": k, "value": {**v, "bounds": self.bounds}}
            for k, v in pending.items()
        ]


# ------------------------------------------------------------- aggregation


def merge_metric_records(table: Dict[str, dict], records) -> None:
    """Merge a batch of delta records into an aggregation table (the shape
    the head keeps in `self.metrics` and node agents keep per node:
    name -> {type, desc, data{tags_key: value|hist}}).  Counter deltas add,
    gauges replace, histogram buckets/sum/count accumulate.  One malformed
    record must not drop the whole batch."""
    for m in records or []:
        try:
            rec = table.setdefault(
                m["name"],
                {"type": m["type"], "desc": m.get("desc", ""), "data": {}},
            )
            data = rec["data"]
            key = m["tags_key"]
            if m["type"] == "counter":
                data[key] = data.get(key, 0.0) + m["value"]
            elif m["type"] == "gauge":
                data[key] = m["value"]
            elif m["type"] == "histogram":
                nbuckets = len(m["value"]["buckets"])
                cur = data.setdefault(
                    key, {"buckets": [0] * nbuckets, "sum": 0.0, "count": 0}
                )
                if len(cur["buckets"]) < nbuckets:
                    # same name reported with different boundaries (e.g.
                    # rolling code change): widen rather than IndexError
                    cur["buckets"].extend([0] * (nbuckets - len(cur["buckets"])))
                for i, c in enumerate(m["value"]["buckets"]):
                    cur["buckets"][i] += c
                cur["sum"] += m["value"]["sum"]
                cur["count"] += m["value"]["count"]
                if len(m["value"]["bounds"]) >= len(cur.get("bounds", [])):
                    cur["bounds"] = m["value"]["bounds"]
        except Exception:
            continue


# ---------------------------------------------------------------- inspection


def get_metrics_snapshot() -> Dict[str, dict]:
    """Cluster-wide aggregated metrics from the head."""
    from ..core.worker import global_worker

    flush_once()
    return global_worker().head_call("metrics_snapshot")["metrics"]


def merged_histogram(rec: Optional[dict]) -> Tuple[List[float], List[int], int]:
    """Merge a snapshot histogram's tagged cells into one
    (bounds, cumulative-ready buckets, count) triple — the shape
    histogram_quantile() consumes.  Shared by bench.py's BENCH-json blocks
    and util.state's plane summaries (one definition, not N copies)."""
    bounds: List[float] = []
    buckets: List[int] = []
    count = 0
    for cell in (rec or {}).get("data", {}).values():
        b = cell.get("bounds", [])
        if len(b) > len(bounds):
            bounds = b
            buckets = buckets + [0] * (len(b) + 1 - len(buckets))
        for i, c in enumerate(cell.get("buckets", [])):
            if i < len(buckets):
                buckets[i] += c
        count += cell.get("count", 0)
    return bounds, buckets, count


def histogram_quantile(
    bounds: List[float], buckets: List[int], count: int, q: float
) -> float:
    """Quantile upper bound from a bucketed histogram (the Prometheus
    histogram_quantile estimate, conservative: returns the bucket's upper
    boundary; the overflow bucket reports 2x the top boundary)."""
    if not count:
        return 0.0
    target = q * count
    cum = 0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= target:
            return bounds[i] if i < len(bounds) else (bounds[-1] * 2 if bounds else 0.0)
    return bounds[-1] * 2 if bounds else 0.0


def prometheus_text() -> str:
    """Prometheus exposition format of the cluster metrics snapshot."""
    return render_prometheus(get_metrics_snapshot())


def _escape_label_value(v: Any) -> str:
    """Prometheus exposition label-value escaping: backslash, double quote
    and newline must be escaped or the line is unparseable (label values
    carry arbitrary user tags — routes, device names, exception text)."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(v: Any) -> str:
    """HELP text escaping (backslash and newline per the exposition spec)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def render_prometheus(snap: Dict[str, dict]) -> str:
    """Render a metrics snapshot dict (head-side table or RPC copy) to the
    Prometheus exposition format."""
    lines: List[str] = []
    for name, rec in sorted(snap.items()):
        if rec.get("desc"):
            lines.append(f"# HELP {name} {_escape_help(rec['desc'])}")
        ptype = {"counter": "counter", "gauge": "gauge", "histogram": "histogram"}[
            rec["type"]
        ]
        lines.append(f"# TYPE {name} {ptype}")
        for key, val in rec["data"].items():
            tags = dict(json.loads(key))
            label = ",".join(
                f'{k}="{_escape_label_value(v)}"' for k, v in sorted(tags.items())
            )
            if rec["type"] in ("counter", "gauge"):
                lines.append(f"{name}{{{label}}} {val}" if label else f"{name} {val}")
            else:
                bounds = val.get("bounds", [])
                cum = 0
                for b, c in zip(bounds + ["+Inf"], val["buckets"]):
                    cum += c
                    le = f'le="{b}"'
                    full = f"{label},{le}" if label else le
                    lines.append(f"{name}_bucket{{{full}}} {cum}")
                suffix = f"{{{label}}}" if label else ""
                lines.append(f"{name}_sum{suffix} {val['sum']}")
                lines.append(f"{name}_count{suffix} {val['count']}")
    return "\n".join(lines) + ("\n" if lines else "")
