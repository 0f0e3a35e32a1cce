"""State observability API (analogue of the reference's python/ray/util/state/
— list_tasks/list_actors/list_objects/list_nodes/list_workers/
list_placement_groups, summarize_*, get_log, and `timeline` Chrome-trace
export backed by the head's task-event buffer).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional

from ..core.worker import global_worker


def _head(method: str, **kw) -> dict:
    return global_worker().head_call(method, **kw)


# ------------------------------------------------------------------- listing


def list_tasks(
    *,
    filters: Optional[List[tuple]] = None,
    limit: int = 10_000,
) -> List[Dict[str, Any]]:
    """Finished/failed task executions (the head keeps a 50k ring buffer).
    Lifecycle phase events (SUBMITTED/QUEUED/SCHEDULED/RUNNING, recorded
    when tracing is enabled) share the same ring; this view keeps only the
    terminal executions — `task_lifecycle()`/`timeline()` read the phases."""
    kw: Dict[str, Any] = {"limit": limit, "terminal": True}
    for f in filters or []:
        key, op, value = f
        if op != "=":
            raise ValueError("only '=' filters are supported")
        if key in ("name", "state"):
            kw[key] = value
    events = _head("list_task_events", **kw)["events"]
    out = []
    for e in events:
        # belt over the server-side `terminal` filter (phase/span events
        # share the ring and also carry no end / a SPAN state)
        if e.get("end") is None or e.get("state") not in ("FINISHED", "FAILED"):
            continue
        out.append(
            {
                "task_id": e["task_id"],
                "name": e["name"],
                "type": e["type"].upper(),
                "state": e["state"],
                "worker_id": e["worker_id"],
                "actor_id": e.get("actor_id"),
                "trace_id": (e.get("trace") or {}).get("tid"),
                "start_time_ms": e["start"] * 1000,
                "end_time_ms": e["end"] * 1000,
                "duration_ms": (e["end"] - e["start"]) * 1000,
            }
        )
    return out


def task_lifecycle(task_id: str) -> List[Dict[str, Any]]:
    """Every recorded lifecycle event of one task (hex id), oldest first:
    SUBMITTED → [QUEUED] → SCHEDULED → RUNNING → FINISHED/FAILED, each with
    process/node attribution and its trace context."""
    events = _head("list_task_events", task_id=task_id, limit=50_000)["events"]
    events.sort(key=_event_ts)
    return events


def list_actors(*, limit: int = 10_000) -> List[Dict[str, Any]]:
    # limit is pushed server-side (the head slices its table before replying)
    return _head("list_actors", limit=limit)["actors"]


def list_workers(*, limit: int = 10_000) -> List[Dict[str, Any]]:
    return _head("list_workers", limit=limit)["workers"]


def list_nodes() -> List[Dict[str, Any]]:
    return _head("nodes")["nodes"]


def list_objects(*, limit: int = 10_000) -> List[Dict[str, Any]]:
    return _head("list_objects", limit=limit)["objects"]


def list_placement_groups() -> List[Dict[str, Any]]:
    return _head("list_pgs")["pgs"]


# ------------------------------------------------------------------ summary


def summarize_tasks() -> Dict[str, Any]:
    """Group task executions by (name) with counts per state and latency stats."""
    tasks = list_tasks()
    groups: Dict[str, dict] = defaultdict(
        lambda: {"states": defaultdict(int), "count": 0, "total_ms": 0.0, "max_ms": 0.0}
    )
    for t in tasks:
        g = groups[t["name"]]
        g["states"][t["state"]] += 1
        g["count"] += 1
        g["total_ms"] += t["duration_ms"]
        g["max_ms"] = max(g["max_ms"], t["duration_ms"])
    return {
        name: {
            "count": g["count"],
            "states": dict(g["states"]),
            "mean_ms": g["total_ms"] / g["count"] if g["count"] else 0.0,
            "max_ms": g["max_ms"],
        }
        for name, g in groups.items()
    }


def summarize_actors() -> Dict[str, int]:
    counts: Dict[str, int] = defaultdict(int)
    for a in list_actors():
        counts[a["state"]] += 1
    return dict(counts)


def summarize_objects() -> Dict[str, Any]:
    objs = list_objects()
    return {
        "total_objects": len(objs),
        "total_size_bytes": sum(o["size"] for o in objs),
        "in_shm": sum(1 for o in objs if o["in_shm"]),
    }


def lease_plane() -> Dict[str, Any]:
    """Delegated vs used lease capacity per node and per pool, plus the
    local-vs-head grant counters — the one-call diagnosis for an exhausted
    lease block or a pool silently falling back to head grants."""
    stats = _head("stats")["stats"]
    nodes = {
        n["node_id"]: n.get("lease_blocks") or {}
        for n in list_nodes()
        if n["alive"] and not n.get("is_head_node")
    }
    return {
        "nodes": nodes,
        "delegated_slots": stats.get("lease_delegated_slots", 0),
        "local_used": stats.get("lease_local_used", 0),
        "local_granted": stats.get("lease_local_granted", 0),
        "head_granted": stats.get("lease_head_granted", 0),
        "blocks_delegated": stats.get("lease_blocks_delegated", 0),
        "blocks_returned": stats.get("lease_blocks_returned", 0),
    }


def owner_plane() -> Dict[str, Any]:
    """Ownership-plane summary: cluster-aggregated ca_owner_* counters
    (owner-resident vs head-fallback refcount settlement, ledger GC,
    owner-side spill decisions, digest sync volume) plus the head's
    registry/failover counters — the one-call proof that steady-state
    object lifetime traffic stays off the head."""
    from .metrics import get_metrics_snapshot

    r = _head("stats")
    stats = r["stats"]
    rpc = r.get("rpc_counts", {})
    counters: Dict[str, int] = {}
    try:
        for name, rec in get_metrics_snapshot().items():
            if name.startswith("ca_owner_"):
                counters[name[len("ca_owner_"):]] = int(
                    sum(rec.get("data", {}).values())
                )
    except Exception:
        pass
    return {
        "counters": counters,
        "objects_released_by_owner": stats.get("objects_released_by_owner", 0),
        "owners_adopted": stats.get("owners_adopted", 0),
        "early_refs_expired": stats.get("early_refs_expired", 0),
        "head_obj_refs_rpcs": rpc.get("obj_refs", 0),
        "head_owner_sync_rpcs": rpc.get("owner_sync", 0),
    }


def transfer_plane() -> Dict[str, Any]:
    """Transfer-plane summary: cluster-aggregated ca_transfer_* counters
    (windowed/multi-source pull volume, window occupancy, source failovers,
    quantized-ring wire savings) plus the head's transfer registry stats —
    the one-call view of the bulk-byte data plane."""
    from .metrics import get_metrics_snapshot

    r = _head("stats")
    stats = r["stats"]
    counters: Dict[str, int] = {}
    try:
        for name, rec in get_metrics_snapshot().items():
            if name.startswith("ca_transfer_"):
                counters[name[len("ca_transfer_"):]] = int(
                    sum(rec.get("data", {}).values())
                )
    except Exception:
        pass
    pulls = counters.get("pulls", 0)
    return {
        "counters": counters,
        # avg per-transfer peak of concurrent pull_chunk RPCs (>1 = the
        # window is really open; serial pulls peak at exactly 1)
        "window_occupancy": (
            counters.get("window_peak_sum", 0) / pulls if pulls else 0.0
        ),
        "objects_transferred": stats.get("objects_transferred", 0),
    }


def dag_plane() -> Dict[str, Any]:
    """Compiled-DAG-plane summary: cluster-aggregated ca_dag_* counters
    (executions/results, backpressure, the failure-semantics series —
    timeouts, actor deaths, recompiles) and the ca_channel_* counters of the
    shm transport underneath (writes/reads, spill-throughs, backpressure
    waits) — the one-call view of the sub-millisecond hot path."""
    from .metrics import get_metrics_snapshot

    dag: Dict[str, int] = {}
    channel: Dict[str, int] = {}
    try:
        for name, rec in get_metrics_snapshot().items():
            if rec.get("type") != "counter":
                continue
            if name.startswith("ca_dag_"):
                dag[name[len("ca_dag_"):]] = int(sum(rec.get("data", {}).values()))
            elif name.startswith("ca_channel_"):
                channel[name[len("ca_channel_"):]] = int(
                    sum(rec.get("data", {}).values())
                )
    except Exception:
        pass
    return {"dag": dag, "channel": channel}


def serve_plane() -> Dict[str, Any]:
    """Serving-plane summary: per-deployment target vs actual replicas,
    per-replica node/queue/draining state and the last autoscale decision
    (live from the controller, falling back to its ~1s head-KV digest when
    the controller is busy/unreachable), plus the cluster-aggregated
    ca_serve_* counters and request/backpressure latency quantiles — the
    one-call view of admission, routing, prefix reuse, and drain health."""
    from .metrics import get_metrics_snapshot, histogram_quantile, merged_histogram

    deployments: Dict[str, Any] = {}
    source = "none"
    try:
        from ..core import api as ca
        from ..core.actor import get_actor
        from ..serve.controller import CONTROLLER_NAME

        ctrl = get_actor(CONTROLLER_NAME)
        deployments = ca.get(ctrl.serve_plane_info.remote(), timeout=5)
        source = "controller"
    except Exception:
        try:
            raw = _head("kv_get", key="serve:plane").get("value")
            if raw:
                deployments = json.loads(raw)
                source = "kv_digest"
        except Exception:
            pass
    counters: Dict[str, int] = {}
    quantiles: Dict[str, float] = {}
    try:
        snap = get_metrics_snapshot()
        for name, rec in snap.items():
            if name.startswith("ca_serve_") and rec.get("type") == "counter":
                counters[name[len("ca_serve_"):]] = int(
                    sum(rec.get("data", {}).values())
                )
        for name, label in (
            ("ca_serve_request_latency_seconds", "request_latency"),
            ("ca_serve_backpressure_seconds", "backpressure"),
        ):
            b, bk, n = merged_histogram(snap.get(name))
            if n:
                quantiles[f"{label}_p50_s"] = histogram_quantile(b, bk, n, 0.50)
                quantiles[f"{label}_p99_s"] = histogram_quantile(b, bk, n, 0.99)
                quantiles[f"{label}_count"] = n
    except Exception:
        pass
    return {
        "deployments": deployments,
        "source": source,
        "counters": counters,
        "quantiles": quantiles,
    }


def train_plane() -> Dict[str, Any]:
    """Train-plane summary: every run's controller digest from the head KV
    (status / attempt / world size / failure count / preemption restarts /
    last registered checkpoint — controllers publish `train:run:<name>` at
    ~1s while polling and on every attempt transition), plus the
    cluster-aggregated ca_train_* counters behind the elastic story
    (proactive preempt restarts, barrier acks, budget-exempt attempts)."""
    from .metrics import get_metrics_snapshot

    runs: Dict[str, Any] = {}
    try:
        for key in _head("kv_keys", prefix="train:run:")["keys"]:
            raw = _head("kv_get", key=key).get("value")
            if raw:
                runs[key[len("train:run:"):]] = json.loads(raw)
    except Exception:
        pass
    counters: Dict[str, int] = {}
    try:
        snap = get_metrics_snapshot()
        for name, rec in snap.items():
            if name.startswith("ca_train_") and rec.get("type") == "counter":
                counters[name[len("ca_train_"):]] = int(
                    sum(rec.get("data", {}).values())
                )
    except Exception:
        pass
    return {"runs": runs, "counters": counters}


def ha_plane() -> Dict[str, Any]:
    """HA-plane summary straight from the active head: role, head epoch,
    replication seq, subscribed standbys (addr/rank/acked watermark),
    replication lag (records the slowest standby hasn't acked), and the
    failover counters (promotions, demotions, fenced zombie RPCs, sync-
    commit timeouts) — the one-call answer to 'can this cluster lose its
    head right now?'."""
    r = _head("ha_status")
    stats = {}
    try:
        stats = _head("stats")["stats"]
    except Exception:
        pass
    return {
        "role": r.get("role"),
        "epoch": r.get("epoch"),
        "seq": r.get("seq"),
        "addr": r.get("addr"),
        "standbys": r.get("standbys") or [],
        "repl_lag": r.get("repl_lag"),
        "promotions": stats.get("ha_promotions", 0),
        "demotions": stats.get("ha_demotions", 0),
        "standbys_lost": stats.get("ha_standbys_lost", 0),
        "sync_commit_timeouts": stats.get("ha_sync_commit_timeouts", 0),
        "records_streamed": stats.get("ha_records_streamed", 0),
        "refused_rpcs": stats.get("ha_refused_rpcs", 0),
    }


def timeseries(
    names: Optional[List[str]] = None,
    *,
    prefix: Optional[str] = None,
    tier: int = 0,
    rate: bool = False,
) -> Dict[str, Any]:
    """Metrics-plane history from the head's retention store: ring-buffered
    series at `tier` 0 (scrape resolution, default 10 s x 360) or 1 (coarse,
    default 2 min x 360), as {"series": {name: {tags_key: {"kind",
    "points": [[ts, value], ...]}}}, "meta": {...}}.  `rate=True` derives
    per-second rates from counter series server-side (gauges pass through).
    `meta` carries tier shapes, series count, and the store's memory
    footprint."""
    return _head(
        "timeseries", names=names, prefix=prefix, tier=tier, rate=rate
    )


def profile(
    target: str = "head", *, duration: float = 2.0, hz: float = 100.0
) -> Dict[str, Any]:
    """Trigger the in-process sampling profiler on a worker / actor / task /
    node-agent / the head ("head").  Returns {"target", "node_id", "folded"
    (flamegraph.pl text), "speedscope" (speedscope.app JSON), "samples",
    "duration_s"}.  The sampled process keeps serving while the sampler
    thread reads its stacks."""
    return _head("profile", id=target, duration=duration, hz=hz)


def metrics_plane() -> Dict[str, Any]:
    """Metrics-plane summary: per-node scrape endpoints, head loop-lag and
    dispatch-histogram status, retention-store meta, and the plane's own
    ship/drop counters — the one-call health check for the scrape topology."""
    from .metrics import get_metrics_snapshot

    ts = _head("timeseries", names=[])
    snap = {}
    try:
        snap = get_metrics_snapshot()
    except Exception:
        pass
    counters: Dict[str, float] = {}
    for name in (
        "ca_metrics_dropped_total", "ca_metrics_agent_shipped",
        "ca_metrics_head_shipped",
    ):
        rec = snap.get(name)
        if rec and rec.get("data"):
            counters[name] = float(sum(rec["data"].values()))
    lag = snap.get("ca_head_loop_lag_seconds", {}).get("data", {})
    dispatch = snap.get("ca_head_dispatch_seconds", {}).get("data", {})
    return {
        "scrape_endpoints": {
            n["node_id"]: n.get("metrics_addr")
            for n in list_nodes()
            if n["alive"] and not n.get("is_head_node")
        },
        "loop_lag_s": next(iter(lag.values()), None),
        "dispatch_methods": len(dispatch),
        "retention": ts.get("meta", {}),
        "counters": counters,
    }


# ------------------------------------------------------------- flight recorder


def flightrec_events(
    *,
    trace: Optional[str] = None,
    plane: Optional[str] = None,
    node: Optional[str] = None,
    event: Optional[str] = None,
    since: Optional[float] = None,
    limit: int = 1000,
) -> Dict[str, Any]:
    """The head's merged flight-recorder journal: per-process decision
    events (fence mints/refusals, drain FSM transitions, netchaos firings,
    DAG recompiles/timeouts, serve shed/drain/migration, train preemption
    barriers, transfer failovers, owner adoption), shipped on the metrics
    piggyback and merged into one ts-ordered cluster ring.  Filters:
    `trace` (trace id), `plane`, `node`, `event` (substring), `since`
    (epoch seconds).  Returns {"events", "total", "enabled"}."""
    return _head(
        "flightrec", trace=trace, plane=plane, node=node, event=event,
        since=since, limit=limit,
    )


def incident(
    *,
    trace: Optional[str] = None,
    node: Optional[str] = None,
    plane: Optional[str] = None,
    window_s: float = 600.0,
    limit: int = 2000,
) -> Dict[str, Any]:
    """Reconstruct a causal incident timeline from the flight recorder: the
    last `window_s` of decision events across every node and plane, ordered
    by time, with per-plane counts and the node set involved — the view that
    turns 'the job failed' into 'blackhole → fence → cancel → heal →
    rejoin'.  Filter to one `trace` to follow a single request/job."""
    import time as _time

    since = (_time.time() - window_s) if window_s else None
    r = flightrec_events(
        trace=trace, node=node, plane=plane, since=since, limit=limit
    )
    evs = r.get("events", [])
    planes: Dict[str, int] = defaultdict(int)
    nodes = set()
    for e in evs:
        planes[e.get("plane") or "?"] += 1
        if e.get("node"):
            nodes.add(e["node"])
    return {
        "events": evs,
        "planes": dict(planes),
        "nodes": sorted(nodes),
        "span_s": (evs[-1]["ts"] - evs[0]["ts"]) if len(evs) > 1 else 0.0,
        "total": r.get("total", len(evs)),
        "enabled": r.get("enabled", True),
    }


# ------------------------------------------------------------------ timeline

_PHASE_ORDER = {
    "SUBMITTED": 0, "QUEUED": 1, "SCHEDULED": 2, "RUNNING": 3,
    "FINISHED": 4, "FAILED": 4,
}


def _event_ts(e: Dict[str, Any]) -> float:
    ts = e.get("ts")
    if ts is None:
        ts = e.get("start") or 0.0
    return ts


class _Lanes:
    """Greedy interval packing: overlapping slices of one process get
    separate Chrome-trace tid rows; non-overlapping ones reuse rows."""

    def __init__(self):
        self._rows: Dict[Any, List[float]] = {}

    def assign(self, pid: Any, start: float, end: float) -> int:
        rows = self._rows.setdefault(pid, [])
        for i, busy_until in enumerate(rows):
            if busy_until <= start:
                rows[i] = end
                return i + 2  # row 1 is the execute lane
        rows.append(end)
        return len(rows) + 1


def timeline(
    filename: Optional[str] = None, *, limit: int = 100_000
) -> List[Dict[str, Any]]:
    """Assemble the head's task-event ring into Chrome-trace / Perfetto JSON
    (analogue of `ray timeline`).

    Execute spans land on each worker process's lane (tid 1); with tracing
    enabled, the driver-side lifecycle phases (submit → queued → scheduled)
    appear as slices on the submitting process with `s`→`f` flow arrows
    connecting the submit span to the execute span across processes, and
    `tracing.span()` app spans render as nested slices.  All
    durations are microseconds; `ts` is wall-clock.  The output is a bare
    event array — loadable by chrome://tracing and Perfetto alike."""
    raw = _head("list_task_events", limit=limit)["events"]
    pids: Dict[Any, int] = {}

    def pid_of(proc: Any) -> int:
        proc = proc or "?"
        if proc not in pids:
            pids[proc] = len(pids) + 1
        return pids[proc]

    lanes = _Lanes()
    events: List[Dict[str, Any]] = []
    by_task: Dict[str, List[dict]] = defaultdict(list)
    spans: List[dict] = []
    for e in raw:
        if e.get("state") == "SPAN":
            spans.append(e)
        elif e.get("task_id"):
            by_task[e["task_id"]].append(e)

    for task_id, evs in by_task.items():
        evs.sort(key=lambda e: (_event_ts(e), _PHASE_ORDER.get(e.get("state"), 9)))
        name = next((e.get("name") for e in evs if e.get("name")), "task")
        kind = next((e.get("type") for e in evs if e.get("type")), "task")
        trace = next((e.get("trace") for e in evs if e.get("trace")), None)
        trace_id = (trace or {}).get("tid")
        term = next((e for e in evs if e.get("end") is not None), None)
        phases = {
            e["state"]: e
            for e in evs
            if e.get("end") is None and e.get("state") in _PHASE_ORDER
        }
        args = {"task_id": task_id, "trace_id": trace_id}

        exec_pid = None
        if term is not None:
            exec_pid = pid_of(term.get("worker_id"))
            events.append(
                {
                    "name": name,
                    "cat": kind,
                    "ph": "X",
                    "ts": term["start"] * 1e6,
                    "dur": max((term["end"] - term["start"]) * 1e6, 1.0),
                    "pid": exec_pid,
                    "tid": 1,
                    "args": {
                        **args,
                        "state": term.get("state"),
                        "actor_id": term.get("actor_id"),
                        "node_id": term.get("node_id"),
                        "running_ts": (phases.get("RUNNING") or {}).get("ts"),
                    },
                }
            )

        sub = phases.get("SUBMITTED")
        if sub is None:
            continue
        drv_pid = pid_of(sub.get("worker_id"))
        run_ts = (phases.get("RUNNING") or {}).get("ts") or (
            term["start"] if term else None
        )
        task_end = (term["end"] if term else None) or run_ts
        # driver-side phase slices: submit → [queued →] scheduled, one lane
        # per concurrently-inflight task
        points = [
            (p, phases[p]["ts"])
            for p in ("SUBMITTED", "QUEUED", "SCHEDULED")
            if p in phases
        ]
        if run_ts is not None:
            points.append(("RUNNING", run_ts))
        lane_end = task_end or points[-1][1]
        lane = lanes.assign(drv_pid, sub["ts"], lane_end)
        seg_label = {"SUBMITTED": "submit", "QUEUED": "queued", "SCHEDULED": "sched"}
        for (p, t0), (_, t1) in zip(points, points[1:]):
            events.append(
                {
                    "name": f"{name} [{seg_label[p]}]",
                    "cat": "lifecycle",
                    "ph": "X",
                    "ts": t0 * 1e6,
                    "dur": max((t1 - t0) * 1e6, 1.0),
                    "pid": drv_pid,
                    "tid": lane,
                    "args": {**args, "phase": p,
                             "target": phases[p].get("target") if p in phases else None},
                }
            )
        # causal flow arrow: submit span → execute span (cross-process)
        if term is not None and exec_pid is not None:
            sched = phases.get("SCHEDULED") or sub
            flow = {
                "name": "submit→run",
                "cat": "task_flow",
                "id": task_id,
                "args": args,
            }
            events.append(
                {**flow, "ph": "s", "ts": sched["ts"] * 1e6, "pid": drv_pid, "tid": lane}
            )
            events.append(
                {**flow, "ph": "f", "bp": "e", "ts": term["start"] * 1e6,
                 "pid": exec_pid, "tid": 1}
            )

    # app spans (tracing.span blocks)
    for e in spans:
        if e.get("start") is None or e.get("end") is None:
            continue
        pid = pid_of(e.get("worker_id"))
        lane = lanes.assign(pid, e["start"], e["end"])
        events.append(
            {
                "name": e.get("name") or "span",
                "cat": e.get("type") or "span",
                "ph": "X",
                "ts": e["start"] * 1e6,
                "dur": max((e["end"] - e["start"]) * 1e6, 1.0),
                "pid": pid,
                "tid": lane,
                "args": {"trace": e.get("trace"), "node_id": e.get("node_id")},
            }
        )

    # flight-recorder instants: control-plane decisions (fence, drain, shed,
    # recompile, chaos windows) as instant markers on their origin process's
    # lane, so causal context lines up with the spans it explains
    try:
        fr = _head("flightrec", limit=min(limit, 5000)).get("events", [])
    except Exception:
        fr = []
    for e in fr:
        if e.get("ts") is None:
            continue
        pid = pid_of(e.get("proc") or e.get("node") or "flightrec")
        events.append(
            {
                "name": f"{e.get('plane', '?')}:{e.get('event', '?')}",
                "cat": "flightrec",
                "ph": "i",
                "s": "p",
                "ts": e["ts"] * 1e6,
                "pid": pid,
                "tid": 1,
                "args": {k: v for k, v in e.items() if k != "ts"},
            }
        )

    # process-name metadata so Perfetto shows client ids, not bare pids
    for proc, pid in pids.items():
        events.append(
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": str(proc)}}
        )
        events.append(
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
             "args": {"name": "execute"}}
        )
    events.sort(key=lambda e: e.get("ts", 0))
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events


# ----------------------------------------------------------------------- logs


def get_log(worker_id: Optional[str] = None, tail: int = 200) -> str:
    """Read a worker's (or an actor's, a task's, a node agent's, or the
    head's) captured stdout/stderr, wherever it lives: the head resolves the
    id to the owning node and proxies the read through that node's agent
    (`log_fetch` -> `log_read`), so no shared filesystem is assumed — the
    old direct `session_dir/<wid>.log` read only worked for head-spawned
    workers.  Raises FileNotFoundError when no such log exists."""
    return _head("log_fetch", id=worker_id, tail=tail)["data"]


def get_log_records(
    worker_id: Optional[str] = None, tail: int = 200
) -> List[Dict[str, Any]]:
    """Structured log records (the JSONL capture) for one process: each has
    line text plus `(node, wid, pid, task, actor, name, stream, ts)`
    attribution stamped by the log plane at print time."""
    data = _head("log_fetch", id=worker_id, tail=tail, structured=True)["data"]
    out: List[Dict[str, Any]] = []
    for line in data.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out[-tail:]


__all__ = [
    "list_tasks",
    "task_lifecycle",
    "list_actors",
    "list_workers",
    "list_nodes",
    "list_objects",
    "list_placement_groups",
    "summarize_tasks",
    "summarize_actors",
    "summarize_objects",
    "lease_plane",
    "owner_plane",
    "ha_plane",
    "metrics_plane",
    "timeseries",
    "profile",
    "flightrec_events",
    "incident",
    "timeline",
    "get_log",
    "get_log_records",
]
