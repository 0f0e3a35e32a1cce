"""Command-line interface (analogue of the reference's python/ray/scripts/
scripts.py: ray start/stop/status/submit/memory/timeline/summary/logs/
microbenchmark).

Usage: python -m cluster_anywhere_tpu_torch.cli <command> [...]
(or the `ca` console script when the package is installed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _connect(args):
    import cluster_anywhere_tpu_torch as ca

    # no log-stream subscription for one-shot CLI commands: live worker
    # echoes would interleave with (and for `ca logs --follow`, duplicate)
    # the command's own output
    ca.init(address=getattr(args, "address", None) or "auto", log_to_driver=False)
    return ca


def cmd_start(args):
    """Start a persistent head (survives driver disconnects) for other
    drivers/jobs to join via init(address=...)."""
    import cluster_anywhere_tpu_torch as ca

    os.environ["CA_HEAD_PERSIST"] = "1"
    info = ca.init(num_cpus=args.num_cpus, num_gpus=args.num_gpus)
    print(f"started cluster at {info['session_dir']}")
    print(f"resources: {info['resources']}")
    print("connect with: cluster_anywhere_tpu_torch.init(address='auto')")
    # detach without stopping the cluster
    from cluster_anywhere_tpu_torch.core import api as _api
    from cluster_anywhere_tpu_torch.core.worker import global_worker

    global_worker().shutdown(stop_cluster=False)
    _api._head_proc = None  # leave the head running


def cmd_join(args):
    """Join THIS host to a running cluster as a node (foreground agent) —
    the command an SSH/command-runner provider executes on each machine
    (reference `ray start --address=...` worker-node role).

        ca join --head tcp:headhost:6379 --num-cpus 8 \\
                --labels '{"zone": "a"}'
    """
    import json as _json
    import uuid as _uuid

    from cluster_anywhere_tpu_torch.core.config import CAConfig

    node_id = args.node_id or f"host-{_uuid.uuid4().hex[:6]}"
    root = args.session_root or CAConfig().session_dir_root
    sdir = os.path.join(root, f"joined_{node_id}")
    os.makedirs(sdir, exist_ok=True)
    os.environ["CA_SESSION_DIR"] = sdir
    os.environ["CA_HEAD_ADDR"] = args.head
    os.environ["CA_NODE_ID"] = node_id
    shape = {"CPU": float(args.num_cpus)}
    if args.num_gpus:
        shape["GPU"] = float(args.num_gpus)
    if args.resources:
        shape.update({k: float(v) for k, v in _json.loads(args.resources).items()})
    shape.setdefault("memory", float(CAConfig().object_store_memory))
    os.environ["CA_NODE_RESOURCES"] = _json.dumps(shape)
    if args.labels:
        os.environ["CA_NODE_LABELS"] = args.labels
    os.environ.setdefault("CA_CONFIG_JSON", CAConfig().to_json())
    from cluster_anywhere_tpu_torch.core.nodeagent import main as agent_main

    print(f"joining {args.head} as node {node_id} with {shape}")
    agent_main()


def cmd_up(args):
    """Bring up a cluster from a YAML config (reference `ray up` role: local
    provider by default, or a command-runner provider for real machines).

    Config shape:
        head: {num_cpus: 4, num_gpus: 0}
        provider:            # optional; omit for local agent nodes
          type: command      # ssh/command-runner seam
          hosts: [host-a, host-b]
          launch_cmd: "ssh {host} 'ca join --head {head_addr} --node-id {node_id} --resources {resources_json} --labels {labels_json}'"
          terminate_cmd: "..."   # optional
          quote_levels: 2        # shells the JSON traverses (2 for ssh)
        nodes:
          - {count: 2, num_cpus: 2, labels: {zone: a}}
          - {count: 1, num_cpus: 2, num_gpus: 1}
          - {count: 1, num_cpus: 1, resources: {fast_disk: 1}}

    `num_gpus` declares a node's `GPU` resource; its agent pins GPU-pool
    workers to the card.  The head's `num_gpus` left out detects the cards
    as `ca.init()` does.
    """
    import yaml

    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.autoscaler.provider import (
        AgentNodeProvider,
        CommandRunnerNodeProvider,
        NodeType,
    )

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}
    head = cfg.get("head") or {}
    os.environ["CA_HEAD_PERSIST"] = "1"
    info = ca.init(
        num_cpus=head.get("num_cpus"), num_gpus=head.get("num_gpus")
    )
    print(f"head up at {info['session_dir']}")
    pspec = cfg.get("provider") or {}
    if pspec.get("type") == "command":
        provider = CommandRunnerNodeProvider(
            hosts=pspec["hosts"],
            launch_cmd=pspec["launch_cmd"],
            terminate_cmd=pspec.get("terminate_cmd"),
            wait_s=float(pspec.get("wait_s", 60)),
            quote_levels=int(pspec.get("quote_levels", 1)),
        )
    else:
        provider = AgentNodeProvider()
    n_started = 0
    for spec in cfg.get("nodes") or []:
        shape = {"CPU": float(spec.get("num_cpus", 2))}
        if spec.get("num_gpus"):
            shape["GPU"] = float(spec["num_gpus"])
        shape.update({k: float(v) for k, v in (spec.get("resources") or {}).items()})
        for _ in range(int(spec.get("count", 1))):
            node = provider.create_node(
                NodeType("yaml", shape, labels=spec.get("labels"))
            )
            n_started += 1
            print(f"node {node.node_id} up: {shape}")
    from cluster_anywhere_tpu_torch.core.worker import global_worker

    w = global_worker()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        alive = [n for n in w.head_call("nodes")["nodes"] if n["alive"]]
        if len(alive) >= 1 + n_started:
            break
        time.sleep(0.2)
    print(f"cluster up: {len(alive)} nodes, resources {ca.cluster_resources()}")
    from cluster_anywhere_tpu_torch.core import api as _api

    w.shutdown(stop_cluster=False)
    _api._head_proc = None  # persists until `ca down`


def cmd_down(args):
    """Tear down the running cluster (reference `ray down`): agents exit on
    head shutdown notification, the head cleans the shm namespace."""
    cmd_stop(args)


def cmd_serve(args):
    """`ca serve deploy <yaml>` / `ca serve status` (reference serve CLI)."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch import serve

    if args.action == "deploy" and not args.config:
        print("usage: ca serve deploy <config.yaml>", file=sys.stderr)
        sys.exit(2)
    ca.init(address=getattr(args, "address", None) or "auto")
    if args.action == "deploy":
        handles = serve.run_config(args.config)
        for name in handles:
            print(f"deployed application {name!r}")
    elif args.action == "status":
        print(json.dumps(serve.status(), indent=2, default=str))
    elif args.action == "shutdown":
        serve.shutdown()
        print("serve shut down")
    from cluster_anywhere_tpu_torch.core import api as _api
    from cluster_anywhere_tpu_torch.core.worker import global_worker

    global_worker().shutdown(stop_cluster=False)
    _api._head_proc = None


def cmd_stop(args):
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.core.worker import global_worker

    try:
        ca.init(address=getattr(args, "address", None) or "auto", log_to_driver=False)
    except ConnectionError as e:
        print(e)
        return
    w = global_worker()
    print(f"stopping cluster at {w.session_dir}")
    w.shutdown(stop_cluster=True)


def cmd_drain(args):
    """Gracefully drain a node: evacuate actors/objects, let running tasks
    finish until the deadline, then let the provider reclaim the VM."""
    ca = _connect(args)
    try:
        kw = {"reason": args.reason}
        if args.deadline is not None:
            kw["deadline_s"] = args.deadline
        r = ca.drain_node(args.node, **kw)
    except Exception as e:
        print(f"drain failed: {e}")
        ca.shutdown()
        sys.exit(1)
    state = r.get("state")
    print(f"node {args.node}: {state}"
          + (f" (deadline {r['deadline_s']:g}s)" if "deadline_s" in r else ""))
    if args.wait and state == "draining":
        while True:
            time.sleep(0.2)
            rec = next(
                (n for n in ca.nodes() if n["node_id"] == args.node), None
            )
            if rec is None or rec.get("state") in ("drained", "dead"):
                print(f"node {args.node}: {rec['state'] if rec else 'gone'}")
                break
    ca.shutdown()


def cmd_chaos(args):
    """Network-chaos plane control: install/clear/inspect a cluster-wide
    per-link fault schedule (blackhole/delay/flap, seeded+deterministic).
    The head installs the spec locally and broadcasts it to every connected
    process, so both ends of each named link inject symmetrically."""
    from cluster_anywhere_tpu_torch.core.worker import global_worker

    ca = _connect(args)
    try:
        w = global_worker()
        if args.action == "set":
            if not args.spec:
                print("usage: ca chaos set '<spec>'  (e.g. "
                      "'seed=7;n0<>node1:blackhole@0+8')")
                sys.exit(2)
            r = w.head_call(
                "net_chaos", spec=args.spec, epoch=args.epoch or time.time()
            )
            print(f"installed: {r.get('spec')}")
        elif args.action == "clear":
            w.head_call("net_chaos", spec="")
            print("cleared (reachable processes only — scheduled windows "
                  "heal partitioned ones)")
        else:  # status
            r = w.head_call("net_chaos")
            st = r.get("status") or {}
            if not st.get("active"):
                print("net chaos: inactive")
            else:
                print(f"net chaos: {st.get('spec')}")
                print(f"  seed={st.get('seed')} epoch={st.get('epoch'):.3f} "
                      f"local={st.get('local')}")
                print(f"  links: {', '.join(st.get('links') or [])}")
                for k, v in (st.get("stats") or {}).items():
                    print(f"  {k}: {v}")
                for ev in st.get("events") or []:
                    print(f"  event: {ev}")
    except Exception as e:
        print(f"chaos command failed: {e}")
        ca.shutdown()
        sys.exit(1)
    ca.shutdown()


def cmd_status(args):
    ca = _connect(args)
    total = ca.cluster_resources()
    avail = ca.available_resources()
    stats = ca.cluster_stats()
    print("== cluster status ==")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0):g} / {total[k]:g} available")
    for k, v in sorted(stats.items()):
        print(f"  {k}: {v}")
    # node states: draining nodes show their reason + remaining window so an
    # announced exit (preemption, downscale) is visible before it completes
    draining = [
        n for n in ca.nodes() if n.get("state") not in ("alive", None)
    ]
    if draining:
        print("== nodes not alive ==")
        for n in draining:
            d = n.get("drain") or {}
            extra = (
                f" reason={d.get('reason')} deadline_in={d.get('deadline_in_s')}s"
                if n.get("state") == "draining"
                else ""
            )
            print(f"  {n['node_id']}: {n.get('state')}{extra}")
    # lease plane: delegated vs used block capacity per node and pool, so an
    # exhausted block (every local grant denied -> head fallback) is
    # diagnosable without the dashboard
    nodes = ca.nodes()
    blocks = [
        (n["node_id"], p, b)
        for n in nodes
        if n["alive"]
        for p, b in (n.get("lease_blocks") or {}).items()
    ]
    if blocks:
        print("== lease plane (per-node delegated blocks) ==")
        for nid, pool, b in blocks:
            print(
                f"  {nid}/{pool}: {b.get('used', 0)}/{b.get('size', 0)} used/"
                f"delegated (granted {b.get('granted', 0)}, "
                f"denied {b.get('denied', 0)})"
            )
    # ownership plane: owner-resident vs head-fallback settlement volume —
    # the structural proof (or diagnosis) that object lifetime traffic
    # stays off the head in steady state
    try:
        from .util.state import owner_plane

        op = owner_plane()
        if op["counters"] or op["objects_released_by_owner"]:
            print("== ownership plane (cluster-aggregated) ==")
            for k, v in sorted(op["counters"].items()):
                print(f"  {k}: {v}")
            for k in (
                "objects_released_by_owner", "owners_adopted",
                "early_refs_expired", "head_obj_refs_rpcs",
            ):
                print(f"  {k}: {op[k]}")
    except Exception:
        pass  # pre-plane head (rolling upgrade): status stays usable
    # transfer plane: pull volume, window occupancy, failovers, and the
    # quantized ring's wire savings — the bulk-byte data plane at a glance
    try:
        from .util.state import transfer_plane

        tp = transfer_plane()
        if tp["counters"].get("pulls") or tp["counters"].get("quant_ops"):
            print("== transfer plane (cluster-aggregated) ==")
            for k, v in sorted(tp["counters"].items()):
                print(f"  {k}: {v}")
            print(f"  window_occupancy: {tp['window_occupancy']:.2f}")
            print(f"  objects_transferred: {tp['objects_transferred']}")
    except Exception:
        pass
    # serving plane: per-deployment target/actual replicas, last autoscale
    # decision, drain state, and the admission/prefix/backpressure counters
    try:
        from .util.state import serve_plane

        sp = serve_plane()
        if sp["deployments"] or sp["counters"]:
            print("== serving plane ==")
            for app, deps in sorted(sp["deployments"].items()):
                for dep, d in sorted(deps.items()):
                    drain_note = (
                        f" draining={len(d['draining_replicas'])}"
                        if d.get("draining_replicas") else ""
                    )
                    scale = d.get("last_scale")
                    scale_note = (
                        f" last_scale={scale['direction']} "
                        f"{scale['from']}->{scale['to']} "
                        f"(avg_ongoing={scale['avg_ongoing']})"
                        if scale else ""
                    )
                    print(
                        f"  {app}/{dep}: {d['actual_replicas']}/"
                        f"{d['target_replicas']} replicas ({d['status']})"
                        f"{drain_note}{scale_note}"
                    )
            for k, v in sorted(sp["counters"].items()):
                print(f"  {k}: {v}")
            for k, v in sorted(sp["quantiles"].items()):
                print(f"  {k}: {v:.4g}" if isinstance(v, float) else f"  {k}: {v}")
    except Exception:
        pass
    # compiled-DAG plane: execute/result volume, channel traffic, and the
    # failure-semantics counters (timeouts, actor deaths, recompiles) — the
    # hot path that bypasses RPC should be visible without the dashboard
    try:
        from .util.state import dag_plane

        dp = dag_plane()
        if dp["dag"].get("executions") or dp["channel"].get("writes"):
            print("== compiled DAG plane (cluster-aggregated) ==")
            for k, v in sorted(dp["dag"].items()):
                print(f"  dag_{k}: {v}")
            for k, v in sorted(dp["channel"].items()):
                print(f"  channel_{k}: {v}")
    except Exception:
        pass
    # train plane: active/recent runs (attempt, world size, last checkpoint)
    # and the elastic counters — a preemption mid-run should read as a
    # PREEMPTING->RUNNING transition with a fresh checkpoint, not a mystery
    try:
        from .util.state import train_plane

        tp = train_plane()
        if tp["runs"] or tp["counters"]:
            print("== train plane ==")
            for name, r in sorted(tp["runs"].items()):
                ck = r.get("last_checkpoint")
                ck_note = f" last_ckpt={os.path.basename(ck)}" if ck else ""
                pre = r.get("preempt_restarts") or 0
                pre_note = f" preempt_restarts={pre}" if pre else ""
                print(
                    f"  {name}: {r.get('status')} attempt={r.get('attempt')} "
                    f"world={r.get('world_size')}"
                    f"{pre_note}{ck_note}"
                )
            for k, v in sorted(tp["counters"].items()):
                print(f"  ca_train_{k}: {v}")
    except Exception:
        pass
    ca.shutdown()


def cmd_submit(args):
    from cluster_anywhere_tpu_torch.jobs import JobSubmissionClient

    client = JobSubmissionClient(getattr(args, "address", None) or "auto")
    entry = " ".join(args.entrypoint)
    # run in the submitter's cwd so `ca submit -- python x.py` resolves
    # relative paths the way the user expects
    sid = client.submit_job(
        entrypoint=entry, runtime_env={"working_dir": args.working_dir or os.getcwd()}
    )
    print(f"submitted {sid}: {entry}")
    if args.no_wait:
        return
    for chunk in client.tail_job_logs(sid):
        sys.stdout.write(chunk)
        sys.stdout.flush()
    status = client.get_job_status(sid)
    print(f"\njob {sid} {status}")
    sys.exit(0 if status == "SUCCEEDED" else 1)


def cmd_jobs(args):
    from cluster_anywhere_tpu_torch.jobs import JobSubmissionClient

    client = JobSubmissionClient(getattr(args, "address", None) or "auto")
    for info in client.list_jobs():
        dur = (info.end_time or time.time()) - info.start_time
        print(f"{info.submission_id}  {info.status:10s}  {dur:8.1f}s  {info.entrypoint}")


def cmd_memory(args):
    ca = _connect(args)
    from cluster_anywhere_tpu_torch.util import state

    objs = state.list_objects()
    print(f"{len(objs)} objects, {sum(o['size'] for o in objs)} bytes")
    for o in objs[: args.limit]:
        loc = "shm" if o["in_shm"] else "inline"
        print(f"  {o['object_id'][:16]}  {o['size']:>12}  {loc:6}  holders={o['num_holders']}")
    ca.shutdown()


def cmd_timeline(args):
    ca = _connect(args)
    events = ca.timeline(args.output, limit=args.limit)
    n_flows = sum(1 for e in events if e.get("ph") == "s")
    n_procs = sum(1 for e in events if e.get("name") == "process_name")
    print(
        f"wrote {len(events)} events ({n_procs} processes, {n_flows} "
        f"submit→run flows) to {args.output}"
    )
    print("open in https://ui.perfetto.dev or chrome://tracing")
    ca.shutdown()


def cmd_summary(args):
    ca = _connect(args)
    from cluster_anywhere_tpu_torch.util import state

    if args.kind == "tasks":
        out = state.summarize_tasks()
    elif args.kind == "actors":
        out = state.summarize_actors()
    else:
        out = state.summarize_objects()
    print(json.dumps(out, indent=2, default=str))
    ca.shutdown()


def cmd_list(args):
    ca = _connect(args)
    from cluster_anywhere_tpu_torch.util import state

    fn = {
        "tasks": state.list_tasks,
        "actors": state.list_actors,
        "workers": state.list_workers,
        "nodes": state.list_nodes,
        "objects": state.list_objects,
        "placement-groups": state.list_placement_groups,
    }[args.kind]
    print(json.dumps(fn(), indent=2, default=str))
    ca.shutdown()


def _render_log_trace(data: str) -> str:
    """Pretty-print trace-filtered JSONL records as `[wid span] line`."""
    out = []
    for line in data.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        sid = (rec.get("trace") or {}).get("sid", "")
        out.append(f"[{rec.get('wid', '?')} {sid}] {rec.get('line', '')}")
    return "\n".join(out)


def cmd_logs(args):
    """`ca logs [<worker|task|actor|node|head>] [--tail N] [--follow]
    [--trace <id>]` — reads/tails wherever the log lives: the head proxies
    cross-node reads through the owning node's agent (no shared filesystem
    needed).  `--trace` keeps only lines whose print site ran under that
    trace id (span stamps from the structured capture)."""
    ca = _connect(args)
    from cluster_anywhere_tpu_torch.core.worker import global_worker

    w = global_worker()
    trace = getattr(args, "trace", None)
    failed = False
    try:
        try:
            reply = w.head_call(
                "log_fetch", id=args.worker_id, tail=args.tail, trace=trace
            )
        except (FileNotFoundError, RuntimeError, ConnectionError) as e:
            print(f"ca logs: {e}", file=sys.stderr)
            failed = True
            return
        if reply["data"]:
            print(_render_log_trace(reply["data"]) if trace else reply["data"])
        if not args.follow:
            return
        off = reply["off"]
        try:
            while True:
                time.sleep(0.3)
                try:
                    reply = w.head_call(
                        "log_fetch", id=args.worker_id, off=off, trace=trace
                    )
                except FileNotFoundError:
                    continue  # rotated away: keep polling from the new file
                except (RuntimeError, ConnectionError) as e:
                    print(f"ca logs: {e}", file=sys.stderr)
                    failed = True
                    return
                if reply["data"]:
                    data = (
                        _render_log_trace(reply["data"]) + "\n"
                        if trace else reply["data"]
                    )
                    sys.stdout.write(data)
                    sys.stdout.flush()
                off = reply["off"]
        except KeyboardInterrupt:
            pass
    finally:
        ca.shutdown()
        if failed:
            sys.exit(1)


def _format_flight_event(e, t0=None):
    """One journal line: `+12.345s node/proc plane:event {fields}`."""
    ts = e.get("ts") or 0.0
    rel = f"+{ts - t0:8.3f}s" if t0 is not None else time.strftime(
        "%H:%M:%S", time.localtime(ts)
    )
    origin = f"{e.get('node') or '?'}/{e.get('proc') or '?'}"
    tr = (e.get("trace") or {}).get("tid")
    skip = {"ts", "seq", "plane", "event", "node", "proc", "trace"}
    fields = " ".join(
        f"{k}={v}" for k, v in e.items() if k not in skip
    )
    line = f"{rel}  {origin:24s} {e.get('plane', '?')}:{e.get('event', '?')}"
    if fields:
        line += f"  {fields}"
    if tr:
        line += f"  [trace {tr}]"
    return line


def cmd_events(args):
    """`ca events [--trace <id>] [--plane <p>] [--node <n>]` — the head's
    merged flight-recorder journal, newest-last."""
    ca = _connect(args)
    from cluster_anywhere_tpu_torch.util import state

    try:
        r = state.flightrec_events(
            trace=args.trace, plane=args.plane, node=args.node,
            event=args.event, limit=args.limit,
        )
        if args.json:
            print(json.dumps(r, indent=2, default=str))
            return
        evs = r.get("events", [])
        if not r.get("enabled", True):
            print("flight recorder disabled (flightrec_plane=False)")
        print(f"== ca events: {len(evs)} shown / {r.get('total', 0)} in ring ==")
        for e in evs:
            print(_format_flight_event(e))
    finally:
        ca.shutdown()


def cmd_incident(args):
    """`ca incident` — reconstruct the causal cross-node timeline of the
    recent window: every plane's decision events in time order, with
    relative offsets from the first event (the incident trigger)."""
    ca = _connect(args)
    from cluster_anywhere_tpu_torch.util import state

    try:
        r = state.incident(
            trace=args.trace, plane=args.plane, node=args.node,
            window_s=args.window, limit=args.limit,
        )
        if args.json:
            print(json.dumps(r, indent=2, default=str))
            return
        evs = r.get("events", [])
        if not r.get("enabled", True):
            print("flight recorder disabled (flightrec_plane=False)")
        if not evs:
            print(f"no flight-recorder events in the last {args.window:g}s")
            return
        planes = ", ".join(
            f"{p}={n}" for p, n in sorted(r.get("planes", {}).items())
        )
        print(
            f"== ca incident: {len(evs)} events over {r.get('span_s', 0):.1f}s "
            f"across {len(r.get('nodes', []))} node(s) =="
        )
        print(f"   planes: {planes}")
        t0 = evs[0].get("ts") or 0.0
        print(f"   t0 = {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(t0))}")
        for e in evs:
            print(_format_flight_event(e, t0=t0))
    finally:
        ca.shutdown()


def _node_metrics_addr(args, node_id: str):
    """Resolve a node agent's HTTP scrape endpoint: addr files first
    (head-free, same-host — deliberately WITHOUT _find_session's
    head-liveness check, since scraping a node with the head dead is the
    point), then the head's node table."""
    import glob

    from cluster_anywhere_tpu_torch.core.config import get_config

    addr_arg = getattr(args, "address", None) or "auto"
    candidates = []
    if os.path.isdir(addr_arg):
        candidates.append(addr_arg)
    elif addr_arg == "auto":
        # newest sessions first, head alive or not
        candidates.extend(sorted(
            glob.glob(os.path.join(get_config().session_dir_root, "session_*")),
            key=os.path.getmtime, reverse=True,
        ))
    for sdir in candidates:
        path = os.path.join(sdir, "nodes", node_id, "metrics.addr")
        if os.path.exists(path):
            return open(path).read().strip()
    ca = _connect(args)
    try:
        for n in ca.nodes():
            if n["node_id"] == node_id:
                return n.get("metrics_addr")
    finally:
        ca.shutdown()
    return None


def cmd_metrics(args):
    node_id = getattr(args, "node", None)
    if node_id:
        # scrape the node agent's HTTP endpoint directly — works with the
        # head dead (that is the metrics plane's whole point)
        import urllib.request

        try:
            addr = _node_metrics_addr(args, node_id)
        except (RuntimeError, ConnectionError, FileNotFoundError, TimeoutError) as e:
            print(f"ca metrics: {e}", file=sys.stderr)
            sys.exit(1)
        if not addr:
            print(
                f"ca metrics: no scrape endpoint known for node {node_id!r} "
                f"(node down, or metrics_plane disabled)",
                file=sys.stderr,
            )
            sys.exit(1)
        try:
            with urllib.request.urlopen(addr.rstrip("/") + "/metrics", timeout=10) as r:
                sys.stdout.write(r.read().decode())
        except OSError as e:
            print(f"ca metrics: scrape of {addr} failed: {e}", file=sys.stderr)
            sys.exit(1)
        return
    try:
        ca = _connect(args)
    except (RuntimeError, ConnectionError, FileNotFoundError, TimeoutError) as e:
        # friendly one-liner, not a traceback (the `ca logs` convention)
        print(f"ca metrics: {e}", file=sys.stderr)
        sys.exit(1)
    from cluster_anywhere_tpu_torch.util import metrics

    if getattr(args, "grafana_out", None):
        from cluster_anywhere_tpu_torch.util.grafana import write_grafana_dashboards

        snap = metrics.get_metrics_snapshot()
        for p in write_grafana_dashboards(args.grafana_out, snapshot=snap):
            print(p)
    else:
        print(metrics.prometheus_text(), end="")
    ca.shutdown()


def cmd_profile(args):
    """`ca profile <worker|actor|task|node|head> [--duration]`: trigger the
    target process's in-process stack sampler and print folded stacks (plus
    a hot-function summary); --speedscope saves the speedscope.app JSON."""
    try:
        ca = _connect(args)
    except (RuntimeError, ConnectionError, FileNotFoundError, TimeoutError) as e:
        print(f"ca profile: {e}", file=sys.stderr)
        sys.exit(1)
    from cluster_anywhere_tpu_torch.core.worker import global_worker

    failed = False
    try:
        try:
            out = global_worker().head_call(
                "profile", id=args.target, duration=args.duration, hz=args.hz,
                timeout=args.duration + 30,
            )
        except (ValueError, RuntimeError, ConnectionError) as e:
            print(f"ca profile: {e}", file=sys.stderr)
            failed = True
            return
        from cluster_anywhere_tpu_torch.util.profiler import top_functions

        print(
            f"# {out['target']} (node {out['node_id']}): {out['samples']} "
            f"samples over {out['duration_s']:.1f}s"
        )
        folded = {}
        for line in out["folded"].splitlines():
            stack, _, count = line.rpartition(" ")
            if stack:
                folded[stack] = int(count)
        for fn, n in top_functions(folded, limit=10):
            pct = 100.0 * n / max(out["samples"], 1)
            print(f"  {pct:5.1f}%  {fn}")
        if args.speedscope:
            with open(args.speedscope, "w") as f:
                json.dump(out["speedscope"], f)
            print(f"speedscope profile -> {args.speedscope}")
        if args.folded_out:
            with open(args.folded_out, "w") as f:
                f.write(out["folded"] + "\n")
            print(f"folded stacks -> {args.folded_out}")
        elif not args.speedscope:
            print(out["folded"])
    finally:
        ca.shutdown()
        if failed:
            sys.exit(1)


def cmd_top(args):
    """`ca top`: refreshing live cluster view — resource occupancy, node
    table, and metrics-plane RATES (tasks/s, objects/s, RPC msg/s, head
    loop lag) derived from the head's time-series store."""
    try:
        ca = _connect(args)
    except (RuntimeError, ConnectionError, FileNotFoundError, TimeoutError) as e:
        print(f"ca top: {e}", file=sys.stderr)
        sys.exit(1)
    from cluster_anywhere_tpu_torch.core.worker import global_worker

    w = global_worker()
    rate_rows = [
        ("head_tasks_pushed", "tasks/s"),
        ("head_objects_created", "objects/s"),
        ("head_leases_granted", "head leases/s"),
        ("head_rpc_messages_recv", "head RPC msg/s"),
        ("head_actor_restarts", "actor restarts/s"),
        # post-PR-7 planes: compiled-DAG ticks, serve requests + sheds,
        # train reports, transfer pulls, flight-recorder events
        ("ca_dag_executions", "dag ticks/s"),
        ("ca_serve_request_latency_seconds_count", "serve reqs/s"),
        ("ca_serve_shed_total", "serve sheds/s"),
        ("ca_train_preempt_restarts_total", "train preempts/s"),
        ("ca_transfer_pulls", "transfer pulls/s"),
        ("ca_flightrec_recorded", "flightrec ev/s"),
    ]
    gauge_rows = [
        ("head_n_workers", "workers"),
        ("head_n_actors", "actors"),
        ("head_n_objects", "objects"),
        ("head_pending_leases", "pending leases"),
        ("head_nodes_draining", "nodes draining"),
        ("ca_head_loop_lag_seconds", "head loop lag (s)"),
    ]
    names = [n for n, _ in rate_rows + gauge_rows]
    it = 0
    try:
        while True:
            it += 1
            summary = w.head_call("stats")["stats"]
            ts = w.head_call("timeseries", names=names, rate=True)
            series = ts.get("series", {})

            def latest(name):
                tagged = series.get(name) or {}
                for rec in tagged.values():
                    if rec["points"]:
                        return rec["points"][-1][1]
                return None

            lines = ["== ca top =="]
            lines.append(
                f"nodes {summary.get('n_nodes', '?')}  "
                f"workers {summary.get('n_workers', '?')}  "
                f"actors {summary.get('n_actors', '?')}  "
                f"objects {summary.get('n_objects', '?')}"
            )
            lines.append("-- rates (tier-0 window) --")
            for name, label in rate_rows:
                v = latest(name)
                lines.append(
                    f"  {label:20s} {v:10.2f}" if v is not None
                    else f"  {label:20s}          -"
                )
            lines.append("-- levels --")
            for name, label in gauge_rows:
                # gauges pass rate=True through untouched
                v = latest(name)
                lines.append(
                    f"  {label:20s} {v:10.4g}" if v is not None
                    else f"  {label:20s}          -"
                )
            meta = ts.get("meta", {})
            lines.append(
                f"-- retention: {meta.get('n_series', 0)} series, "
                f"{meta.get('memory_bytes', 0) / 1024:.0f} KiB --"
            )
            if args.iterations and not args.no_clear:
                pass  # finite runs print consecutively (test/pipe friendly)
            elif not args.no_clear:
                sys.stdout.write("\x1b[2J\x1b[H")
            print("\n".join(lines), flush=True)
            if args.iterations and it >= args.iterations:
                return
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        ca.shutdown()


def cmd_debug(args):
    """List active remote breakpoints and attach (reference `ray debug`)."""
    ca = _connect(args)
    from cluster_anywhere_tpu_torch.core.worker import global_worker
    from cluster_anywhere_tpu_torch.util import rpdb

    try:
        bps = rpdb.list_breakpoints(global_worker())
        if not bps:
            print("no active breakpoints")
            return
        for i, bp in enumerate(bps):
            print(f"[{i}] {bp['label']}  (pid {bp['pid']}, {bp['host']}:{bp['port']})")
        idx = args.index
        if idx is None:
            if len(bps) == 1:
                idx = 0
            else:
                idx = int(input("attach to which breakpoint? "))
        bp = bps[idx]
        print(f"attaching to {bp['label']} ... (Ctrl-D to detach)")
        rpdb.attach(bp["host"], bp["port"])
    finally:
        ca.shutdown()


def cmd_lint(args):
    """Static analysis over this checkout (no cluster needed): `ca lint`,
    `ca lint --update-baseline`, `ca lint --contract`, `ca lint --format
    json` — see cluster_anywhere_tpu_torch/analysis/."""
    from cluster_anywhere_tpu_torch.analysis.lint import main as lint_main

    rest = args.rest
    if rest and rest[0] == "--":
        rest = rest[1:]
    raise SystemExit(lint_main(rest))


def cmd_dashboard(args):
    """Print the running cluster's dashboard URL."""
    import os

    from cluster_anywhere_tpu_torch.core.api import _find_session
    from cluster_anywhere_tpu_torch.core.config import get_config

    sdir = _find_session(args.address or "auto", get_config().session_dir_root)
    path = os.path.join(sdir, "dashboard.addr")
    if not os.path.exists(path):
        raise SystemExit("no dashboard.addr in the session (head predates it?)")
    print(open(path).read().strip())


def cmd_head(args):
    """HA plane control: run a warm-standby head (foreground, like `ca
    join`), promote a standby to active, or print every head's role/epoch/
    replication watermark."""
    import glob as _glob
    import json as _json

    from cluster_anywhere_tpu_torch.core.api import _find_session
    from cluster_anywhere_tpu_torch.core.config import CAConfig
    from cluster_anywhere_tpu_torch.core.protocol import BlockingClient

    if args.action == "standby":
        if args.head:
            # cross-host standby: its own session dir, replicating over TCP
            root = CAConfig().session_dir_root
            sdir = os.path.join(root, f"standby{args.rank}_{os.getpid()}")
            os.makedirs(sdir, exist_ok=True)
            head_addr = args.head
        else:
            sdir = _find_session(args.address or "auto", CAConfig().session_dir_root)
            head_addr = open(os.path.join(sdir, "head.addr")).read().strip()
        os.environ["CA_SESSION_DIR"] = sdir
        os.environ["CA_HEAD_ADDR"] = head_addr
        os.environ["CA_HEAD_STANDBY"] = "1"
        os.environ["CA_HEAD_STANDBY_RANK"] = str(args.rank)
        os.environ["CA_HEAD_PERSIST"] = "1"
        os.environ.setdefault("CA_CONFIG_JSON", CAConfig().to_json())
        from cluster_anywhere_tpu_torch.core.head import main as head_main

        print(f"standby head (rank {args.rank}) replicating from {head_addr}")
        head_main()
        return

    sdir = _find_session(args.address or "auto", CAConfig().session_dir_root)

    def _ha_status(addr):
        c = BlockingClient(addr)
        c._sock.settimeout(5.0)
        try:
            r = c.call("ha_status")
        finally:
            c.close()
        return {k: v for k, v in r.items() if k not in ("i", "ok")}

    if args.action == "promote":
        path = os.path.join(sdir, f"head.standby{args.rank}.addr")
        if not os.path.exists(path):
            raise SystemExit(f"no standby at rank {args.rank} in {sdir}")
        addr = open(path).read().strip()
        c = BlockingClient(addr)
        c._sock.settimeout(30.0)
        try:
            r = c.call("head_promote")
        finally:
            c.close()
        print(
            f"promoted {addr}: epoch {r.get('epoch')} "
            f"(replicated seq {r.get('seq')}, watermark {r.get('watermark')})"
        )
        return

    # status: the active head plus every advertised standby
    rows = []
    try:
        active = open(os.path.join(sdir, "head.addr")).read().strip()
    except FileNotFoundError:
        active = ""
    if active:
        try:
            rows.append(_ha_status(active))
        except Exception as e:
            rows.append({"addr": active, "role": f"unreachable ({e})"})
    for path in sorted(_glob.glob(os.path.join(sdir, "head.standby*.addr"))):
        addr = open(path).read().strip()
        if any(r.get("addr") == addr for r in rows):
            continue  # a promoted standby already answered as the active
        try:
            rows.append(_ha_status(addr))
        except Exception as e:
            rows.append({"addr": addr, "role": f"unreachable ({e})"})
    if getattr(args, "json", False):
        print(_json.dumps(rows, indent=2, default=str))
        return
    for r in rows:
        role = r.get("role", "?")
        line = f"{r.get('addr', '?'):<28} {role:<9} epoch={r.get('epoch', '?')}"
        if role == "active":
            line += (
                f" seq={r.get('seq')} standbys={len(r.get('standbys') or [])}"
                f" repl_lag={r.get('repl_lag')}"
            )
        elif role == "standby":
            line += (
                f" rank={r.get('rank')} watermark={r.get('watermark')}"
                f" syncing_from={r.get('active_addr')}"
            )
        print(line)


def cmd_microbenchmark(args):
    """Single-node microbenchmarks (reference _private/ray_perf.py main):
    the canonical table — tasks/actors sync+async, put/get call rates, put
    bandwidth, placement-group churn — and one A/B per flag.  `--serve` and
    `--dag` serve from LLM replicas on the card."""
    if getattr(args, "saturation", False):
        from .microbenchmark import head_saturation

        head_saturation(quick=getattr(args, "quick", False))
        return
    if getattr(args, "lease_plane", False):
        # owns its own multi-node clusters (local-grant vs head-grant A/B)
        from .microbenchmark import run_lease_plane

        run_lease_plane(quick=getattr(args, "quick", False))
        return
    if getattr(args, "owner_plane", False):
        # owns its own clusters (owner-resident vs centralized object A/B
        # plus the GC-with-the-head-down proof)
        from .microbenchmark import run_owner_plane

        run_owner_plane(quick=getattr(args, "quick", False))
        return
    if getattr(args, "metrics_plane", False):
        # owns its own clusters (node-scrape vs head-RPC metrics A/B plus
        # the scrape-with-the-head-down proof)
        from .microbenchmark import run_metrics_plane

        run_metrics_plane(quick=getattr(args, "quick", False))
        return
    if getattr(args, "transfer", False):
        # owns its own clusters (serial vs windowed pulls on a latency-
        # injected link, 1 vs 2 sources, f32 vs int8/bf16 quantized ring)
        from .microbenchmark import run_transfer_plane

        run_transfer_plane(quick=getattr(args, "quick", False))
        return
    if getattr(args, "serve_plane", False):
        # owns its own clusters (open-loop SSE envelope, shedding and
        # prefix-cache A/Bs, drain-under-load zero-drop proof)
        from .microbenchmark import run_serve_plane

        run_serve_plane(quick=getattr(args, "quick", False))
        return
    if getattr(args, "dag", False):
        # owns its own clusters (compiled-DAG vs RPC actor-call latency and
        # throughput, 3-actor chain A/B, serve TTFT on/off A/B)
        from .microbenchmark import run_dag_plane

        run_dag_plane(quick=getattr(args, "quick", False))
        return
    if getattr(args, "train_elastic", False):
        # owns its own clusters (drain-aware proactive restart vs reactive
        # poll-failure restart: warning->resumed latency + steps lost)
        from .microbenchmark import run_train_elastic

        run_train_elastic(quick=getattr(args, "quick", False))
        return
    if getattr(args, "partition", False):
        # owns its own clusters (head<->node blackhole mid-workload:
        # detect->fence->heal timeline + at-most-once commit proof)
        from .microbenchmark import run_partition_chaos

        run_partition_chaos(quick=getattr(args, "quick", False))
        return
    if getattr(args, "obsplane", False):
        # owns its own clusters (flight-recorder cost model: armed record
        # rate, disabled-path gate, journal memory, tasks/s on/off A/B)
        from .microbenchmark import run_obsplane

        run_obsplane(quick=getattr(args, "quick", False))
        return
    if getattr(args, "ha", False):
        # owns its own clusters (SIGKILL the active head mid-workload:
        # detect->promote->first-successful-op latency, acked-KV loss=0,
        # duplicate side effects=0, replication-lag ceiling)
        from .microbenchmark import run_ha_plane

        run_ha_plane(quick=getattr(args, "quick", False))
        return

    import cluster_anywhere_tpu_torch as ca

    from . import microbenchmark as mb

    runner = mb.run_microbenchmarks
    if getattr(args, "multi", False):
        runner = mb.run_multiclient
    elif getattr(args, "scalability", False):
        runner = mb.run_scalability
    elif getattr(args, "collective", False):
        runner = mb.run_collective_bw

    ca.init(num_cpus=args.num_cpus)
    try:
        runner(quick=getattr(args, "quick", False))
    finally:
        ca.shutdown()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["lint"]:
        # hand the whole tail to the lint parser: argparse REMAINDER would
        # reject leading option tokens (`ca lint --format json`)
        from cluster_anywhere_tpu_torch.analysis.lint import main as lint_main

        raise SystemExit(lint_main(argv[1:]))
    p = argparse.ArgumentParser(prog="ca", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def addr(sp):
        sp.add_argument("--address", default=None, help="session dir (default: auto)")

    sp = sub.add_parser("start", help="start a persistent local cluster")
    sp.add_argument("--num-cpus", type=int, default=None)
    sp.add_argument("--num-gpus", type=int, default=None,
                    help="GPUs to declare (default: detect the cards)")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("join", help="join this host to a cluster as a node")
    sp.add_argument("--head", required=True, help="head TCP address (tcp:host:port)")
    sp.add_argument("--node-id", default=None)
    sp.add_argument("--num-cpus", type=float, default=4)
    sp.add_argument("--num-gpus", type=float, default=0)
    sp.add_argument("--resources", default=None, help="extra resources, JSON")
    sp.add_argument("--labels", default=None, help="node labels, JSON")
    sp.add_argument("--session-root", default=None)
    sp.set_defaults(fn=cmd_join)

    sp = sub.add_parser("up", help="bring up a cluster from a YAML config")
    sp.add_argument("config", help="path to the cluster YAML")
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser("down", help="tear down the running cluster")
    addr(sp)
    sp.set_defaults(fn=cmd_down)

    sp = sub.add_parser("serve", help="serve deploy <yaml> / status / shutdown")
    sp.add_argument("action", choices=["deploy", "status", "shutdown"])
    sp.add_argument("config", nargs="?", help="YAML for deploy")
    addr(sp)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("stop", help="stop the running cluster")
    addr(sp)
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="cluster resources and stats")
    addr(sp)
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser(
        "drain",
        help="gracefully drain a node (evacuate, then release to the provider)",
    )
    sp.add_argument("node", help="node id to drain (see ca status / ca list nodes)")
    sp.add_argument(
        "--reason",
        choices=("manual", "idle", "preemption"),
        default="manual",
        help="drain reason recorded in events/metrics (default: manual)",
    )
    sp.add_argument(
        "--deadline",
        type=float,
        default=None,
        help="evacuation window in seconds (default: cluster drain_deadline_s)",
    )
    sp.add_argument(
        "--wait", action="store_true",
        help="block until the node reaches drained/dead",
    )
    addr(sp)
    sp.set_defaults(fn=cmd_drain)

    sp = sub.add_parser(
        "chaos",
        help="network-chaos plane: install/clear/inspect a per-link "
        "blackhole/delay/flap schedule cluster-wide",
    )
    addr(sp)
    sp.add_argument("action", choices=["set", "clear", "status"])
    sp.add_argument(
        "spec", nargs="?", default=None,
        help="chaos spec for `set`, e.g. 'seed=7;n0<>node1:blackhole@0+8'",
    )
    sp.add_argument(
        "--epoch", type=float, default=None,
        help="wall-clock anchor for window offsets (default: now)",
    )
    sp.set_defaults(fn=cmd_chaos)

    sp = sub.add_parser("submit", help="submit a job: ca submit -- python x.py")
    addr(sp)
    sp.add_argument("--no-wait", action="store_true")
    sp.add_argument("--working-dir", default=None)
    sp.add_argument("entrypoint", nargs=argparse.REMAINDER)
    sp.set_defaults(fn=cmd_submit)

    sp = sub.add_parser("jobs", help="list submitted jobs")
    addr(sp)
    sp.set_defaults(fn=cmd_jobs)

    sp = sub.add_parser("memory", help="object store contents")
    addr(sp)
    sp.add_argument("--limit", type=int, default=50)
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser(
        "timeline",
        help="export a Chrome-trace/Perfetto timeline of task lifecycles",
    )
    sp.add_argument("--limit", type=int, default=100_000,
                    help="max task events to assemble")
    addr(sp)
    sp.add_argument("--output", "-o", default="timeline.json")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("summary", help="summarize tasks/actors/objects")
    addr(sp)
    sp.add_argument("kind", choices=["tasks", "actors", "objects"])
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("list", help="list cluster entities")
    addr(sp)
    sp.add_argument(
        "kind",
        choices=["tasks", "actors", "workers", "nodes", "objects", "placement-groups"],
    )
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser(
        "logs", help="read/tail head/worker/task/actor logs across nodes"
    )
    addr(sp)
    sp.add_argument(
        "worker_id", nargs="?", default=None,
        help="worker/task/actor/node id, or 'head' (default)",
    )
    sp.add_argument("--tail", type=int, default=200)
    sp.add_argument(
        "--follow", "-f", action="store_true",
        help="keep streaming new lines (Ctrl-C to stop)",
    )
    sp.add_argument(
        "--trace", default=None, metavar="TRACE_ID",
        help="only lines printed under this trace id (structured capture)",
    )
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser(
        "events",
        help="flight recorder: cross-node control-plane decision events",
    )
    addr(sp)
    sp.add_argument("--trace", default=None, help="filter by trace id")
    sp.add_argument(
        "--plane", default=None,
        help="filter by plane (fence/drain/chaos/dag/serve/train/transfer/"
        "ownership/node/actor/ha)",
    )
    sp.add_argument("--node", default=None, help="filter by node id")
    sp.add_argument("--event", default=None, help="filter by event substring")
    sp.add_argument("--limit", type=int, default=200, help="newest N events")
    sp.add_argument("--json", action="store_true", help="raw JSON output")
    sp.set_defaults(fn=cmd_events)

    sp = sub.add_parser(
        "incident",
        help="causal incident timeline from the flight recorder "
        "(fence → cancel → heal → rejoin, cross-node)",
    )
    addr(sp)
    sp.add_argument("--trace", default=None, help="follow one trace id")
    sp.add_argument("--plane", default=None, help="restrict to one plane")
    sp.add_argument("--node", default=None, help="restrict to one node")
    sp.add_argument(
        "--window", type=float, default=600.0,
        help="look back this many seconds (default 600)",
    )
    sp.add_argument("--limit", type=int, default=2000)
    sp.add_argument("--json", action="store_true", help="raw JSON output")
    sp.set_defaults(fn=cmd_incident)

    sp = sub.add_parser("metrics", help="Prometheus metrics snapshot")
    addr(sp)
    sp.add_argument(
        "--grafana-out", default=None, metavar="DIR",
        help="write Grafana dashboard JSON + provisioning stub to DIR",
    )
    sp.add_argument(
        "--node", default=None, metavar="NODE_ID",
        help="scrape that node agent's /metrics endpoint directly "
        "(head-free: works with the head down)",
    )
    sp.set_defaults(fn=cmd_metrics)

    sp = sub.add_parser(
        "profile",
        help="sampling profiler: fold a live process's stacks (ca profile "
        "<worker|actor|task|node|head>)",
    )
    addr(sp)
    sp.add_argument(
        "target", nargs="?", default="head",
        help="worker/actor/task/node id, or 'head' (default)",
    )
    sp.add_argument("--duration", type=float, default=2.0, help="seconds to sample")
    sp.add_argument("--hz", type=float, default=100.0, help="sampling frequency")
    sp.add_argument(
        "--speedscope", default=None, metavar="FILE",
        help="write speedscope.app JSON to FILE",
    )
    sp.add_argument(
        "--folded-out", default=None, metavar="FILE",
        help="write folded stacks to FILE instead of stdout",
    )
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser(
        "top", help="live cluster view: occupancy + metrics-plane rates"
    )
    addr(sp)
    sp.add_argument("--interval", type=float, default=2.0, help="refresh period")
    sp.add_argument(
        "--iterations", type=int, default=0,
        help="render N frames then exit (0 = until Ctrl-C)",
    )
    sp.add_argument(
        "--no-clear", action="store_true",
        help="append frames instead of clearing the screen (pipes/logs)",
    )
    sp.set_defaults(fn=cmd_top)

    sp = sub.add_parser(
        "lint",
        help="static analysis: RPC contract checker + asyncio hazard "
        "analyzer (see `ca lint --help`)",
    )
    sp.add_argument("rest", nargs=argparse.REMAINDER)
    sp.set_defaults(fn=cmd_lint)

    sp = sub.add_parser("debug", help="attach to a remote breakpoint (rpdb)")
    addr(sp)
    sp.add_argument("index", nargs="?", type=int, default=None)
    sp.set_defaults(fn=cmd_debug)

    sp = sub.add_parser("dashboard", help="print the dashboard URL")
    addr(sp)
    sp.set_defaults(fn=cmd_dashboard)

    sp = sub.add_parser(
        "head",
        help="HA plane: run a warm-standby head / promote a standby / "
        "show head roles+epochs",
    )
    sp.add_argument("action", choices=["standby", "promote", "status"])
    addr(sp)
    sp.add_argument(
        "--rank", type=int, default=0,
        help="standby rank (promotion order; rank 0 self-promotes first)",
    )
    sp.add_argument(
        "--head", default=None,
        help="active head TCP address for a cross-host standby "
        "(tcp:host:port[,tcp:host2:port2...])",
    )
    sp.add_argument("--json", action="store_true", help="raw JSON status")
    sp.set_defaults(fn=cmd_head)

    sp = sub.add_parser("microbenchmark", help="single-node perf microbenchmarks")
    sp.add_argument("--quick", action="store_true", help="scaled-down run")
    sp.add_argument(
        "--saturation", action="store_true",
        help="head-saturation sweep: control-plane ops/s vs clients and nodes",
    )
    sp.add_argument(
        "--multi", action="store_true",
        help="multi-client aggregate rows (client actors drive concurrently)",
    )
    sp.add_argument(
        "--scalability", action="store_true",
        help="envelope probes: many-args/returns/gets + queued-task flood",
    )
    sp.add_argument(
        "--collective", action="store_true",
        help="p2p host allreduce bandwidth + head-traffic proof",
    )
    sp.add_argument(
        "--lease-plane", dest="lease_plane", action="store_true",
        help="node-local vs head lease granting tasks/s + head-RPC proof",
    )
    sp.add_argument(
        "--owner-plane", dest="owner_plane", action="store_true",
        help="owner-resident vs centralized object settlement A/B + "
        "head-down GC proof",
    )
    sp.add_argument(
        "--metrics-plane", dest="metrics_plane", action="store_true",
        help="node-scrape vs head-RPC metrics A/B: head metric traffic "
        "per scrape + head-down scrape proof",
    )
    sp.add_argument(
        "--transfer", action="store_true",
        help="bulk-transfer A/B: serial vs windowed pulls (latency-injected "
        "link), 1 vs 2 sources, f32 vs int8/bf16 quantized ring",
    )
    sp.add_argument(
        "--serve", dest="serve_plane", action="store_true",
        help="serving-plane envelope: open-loop SSE req/s + TTFT/p99, "
        "admission shedding A/B, prefix-cache A/B, drain-under-load proof",
    )
    sp.add_argument(
        "--dag", action="store_true",
        help="compiled-DAG plane A/B: compiled tick vs RPC actor-call "
        "latency/throughput, 3-actor chain, serve TTFT on/off",
    )
    sp.add_argument(
        "--train-elastic", dest="train_elastic", action="store_true",
        help="preemption-elastic train A/B: drain-aware proactive restart "
        "vs reactive poll-failure restart (warning->resumed latency, "
        "steps lost, max_failures consumed)",
    )
    sp.add_argument(
        "--partition", action="store_true",
        help="partition-tolerance chaos: head<->node blackhole mid-workload "
        "(detect->fence->heal timeline, at-most-once side effects, "
        "zombie-free rejoin at a fresh incarnation)",
    )
    sp.add_argument(
        "--obsplane", action="store_true",
        help="flight-recorder cost model: armed record events/s, disabled "
        "gate rate, journal memory at cap, tasks/s with the plane on/off",
    )
    sp.add_argument(
        "--ha", action="store_true",
        help="HA-plane failover chaos: SIGKILL the active head mid-workload "
        "(detect->promote->first-op latency, acked-KV loss=0, duplicate "
        "side effects=0)",
    )
    sp.add_argument("--num-cpus", type=int, default=None)
    sp.set_defaults(fn=cmd_microbenchmark)

    args = p.parse_args(argv)
    if getattr(args, "entrypoint", None) and args.entrypoint and args.entrypoint[0] == "--":
        args.entrypoint = args.entrypoint[1:]
    args.fn(args)


if __name__ == "__main__":
    main()
