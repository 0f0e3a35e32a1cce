"""HTTP dashboard served by the head process (compact analogue of the
reference's dashboard/head.py + state aggregator modules: cluster status over
HTTP for humans and tools).

Endpoints:
  GET /               single-page HTML UI (auto-refreshing)
  GET /api/summary    nodes/resources/stats in one call
  GET /api/nodes      node table
  GET /api/actors     actor table
  GET /api/workers    worker table
  GET /api/objects    object directory sample
  GET /api/tasks      recent task events
  GET /api/pgs        placement groups
  GET /api/serve      serving plane (replica targets, drain, last autoscale)
  GET /api/flightrec  flight-recorder journal (trace/plane/node/event filters)
  GET /metrics        Prometheus text (user + runtime metrics)

Zero extra process: the head owns every table locally, so requests are
answered without RPC.  The listen address is written to
<session>/dashboard.addr.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import threading
import time
import uuid
from typing import Any

_PAGE = """<!doctype html>
<html><head><title>cluster_anywhere_tpu_torch dashboard</title>
<style>
body { font-family: ui-monospace, monospace; margin: 24px; background: #101418; color: #d8dee6; }
h1 { font-size: 18px; } h2 { font-size: 14px; margin: 18px 0 6px; color: #8ab4f8; }
table { border-collapse: collapse; width: 100%; font-size: 12px; }
th, td { text-align: left; padding: 3px 10px; border-bottom: 1px solid #2a3038; }
th { color: #9aa5b1; font-weight: 600; }
.ok { color: #7ee787; } .bad { color: #ff7b72; } .warn { color: #e3b341; }
#res { font-size: 13px; margin: 8px 0; }
#tl { position: relative; background: #161b22; border: 1px solid #2a3038; margin-top: 4px; }
.lane-label { position: absolute; left: 4px; font-size: 10px; color: #9aa5b1; }
.bar { position: absolute; height: 12px; border-radius: 2px; min-width: 2px; }
.bar.FINISHED { background: #2ea04366; border: 1px solid #7ee787; }
.bar.FAILED { background: #da363366; border: 1px solid #ff7b72; }
.bar.PENDING { background: #6e768166; border: 1px solid #9aa5b1; }
.bar.SCHED { background: #e3b34144; border: 1px solid #e3b341; }
#tlaxis { font-size: 10px; color: #9aa5b1; }
</style></head><body>
<h1>cluster_anywhere_tpu_torch</h1>
<div id="res"></div>
<h2>Metrics <span id="tsmeta" style="color:#9aa5b1;font-weight:400"></span></h2>
<div id="sparks" style="display:flex;flex-wrap:wrap;gap:14px"></div>
<h2>Nodes</h2><table id="nodes"></table>
<h2>Actors</h2><table id="actors"></table>
<h2>Workers</h2><table id="workers"></table>
<h2>Jobs</h2><table id="jobs"></table>
<h2>Placement groups</h2><table id="pgs"></table>
<h2>Task timeline <span id="tlaxis"></span></h2><div id="tl"></div>
<h2>Recent tasks</h2><table id="tasks"></table>
<h2>Flight recorder <span id="frstats" style="color:#9aa5b1;font-weight:400"></span></h2>
<table id="flightrec"></table>
<h2>Logs <select id="logsel"><option value="">(choose a process)</option></select>
<span id="logstats"></span></h2>
<pre id="logview" style="background:#161b22;border:1px solid #2a3038;padding:8px;
max-height:300px;overflow:auto;font-size:11px;white-space:pre-wrap"></pre>
<script>
function row(cells, tag) {
  return "<tr>" + cells.map(c => "<" + (tag||"td") + ">" + c + "</" + (tag||"td") + ">").join("") + "</tr>";
}
function esc(s) {
  // attribute-safe: esc() output lands inside title="..." too
  return String(s == null ? "" : s).replace(/&/g, "&amp;").replace(/</g, "&lt;")
    .replace(/"/g, "&quot;");
}
function timeline(events) {
  // chrome-trace-style lanes: one per worker, bars = task spans.  With
  // tracing enabled the ring also carries lifecycle phase events
  // (SUBMITTED/QUEUED/SCHEDULED/RUNNING without start/end); those prepend
  // grey (pending at the submitter) and yellow (scheduled -> running)
  // segments before each green/red execute bar.
  const el = document.getElementById("tl");
  const byTask = {};
  events.forEach(e => {
    if (!e.task_id) return;
    (byTask[e.task_id] = byTask[e.task_id] || []).push(e);
  });
  const segs = [];
  let nSpans = 0;
  for (const evs of Object.values(byTask)) {
    const term = evs.find(e => e.end && e.start);
    if (!term) continue;
    nSpans++;
    const ph = {};
    evs.forEach(e => { if (!e.end && e.ts) ph[e.state] = e.ts; });
    const title = term.name + " (" + term.type + ")";
    const runStart = ph.RUNNING || term.start;
    if (ph.SUBMITTED && ph.SUBMITTED < runStart) {
      const schedAt = ph.SCHEDULED || runStart;
      segs.push({w: term.worker_id, s: ph.SUBMITTED, e: schedAt,
                 cls: "PENDING", title: title + " pending"});
      if (schedAt < runStart)
        segs.push({w: term.worker_id, s: schedAt, e: runStart,
                   cls: "SCHED", title: title + " scheduled"});
    }
    segs.push({w: term.worker_id, s: term.start, e: term.end, cls: term.state,
               title: title + " " + ((term.end - term.start) * 1000).toFixed(1) + " ms"});
  }
  if (!segs.length) { el.style.height = "20px"; el.innerHTML = ""; return; }
  const t0 = Math.min(...segs.map(t => t.s));
  const t1 = Math.max(...segs.map(t => t.e));
  const span = Math.max(t1 - t0, 1e-6);
  const lanes = [...new Set(segs.map(t => t.w))];
  const W = el.clientWidth || 900, LH = 16, PAD = 70;
  el.style.height = (lanes.length * LH + 4) + "px";
  let html = "";
  lanes.forEach((w, i) => {
    html += '<div class="lane-label" style="top:' + (i * LH + 2) + 'px">' + esc(w) + "</div>";
  });
  segs.forEach(t => {
    const lane = lanes.indexOf(t.w);
    const x = PAD + (t.s - t0) / span * (W - PAD - 8);
    const w = Math.max((t.e - t.s) / span * (W - PAD - 8), 2);
    html += '<div class="bar ' + esc(t.cls) + '" style="left:' + x + "px;top:" +
      (lane * LH + 2) + "px;width:" + w + 'px" title="' + esc(t.title) + '"></div>';
  });
  el.innerHTML = html;
  document.getElementById("tlaxis").textContent =
    "window " + (span).toFixed(2) + "s, " + nSpans + " spans";
}
async function refresh() {
  const s = await (await fetch("/api/summary")).json();
  document.getElementById("res").innerHTML =
    "CPU " + (s.total.CPU - (s.available.CPU||0)).toFixed(1) + "/" + (s.total.CPU||0) +
    " &nbsp; nodes " + s.stats.n_nodes + " &nbsp; workers " + s.stats.n_workers +
    " &nbsp; actors " + s.stats.n_actors + " &nbsp; objects " + s.stats.n_objects +
    " &nbsp; pending leases " + s.stats.pending_leases;
  const nodes = await (await fetch("/api/nodes")).json();
  document.getElementById("nodes").innerHTML = row(["node", "state", "head", "CPU avail/total", "workers", "leases used/delegated", "labels"], "th") +
    nodes.map(n => row([n.node_id,
      n.state == "alive" ? "<span class=ok>alive</span>" :
      n.state == "draining" ? "<span class=warn>draining " + esc((n.drain||{}).reason||"") +
        " " + ((n.drain||{}).deadline_in_s||0).toFixed(0) + "s</span>" :
      "<span class=bad>" + esc((n.state||"dead").toUpperCase()) + "</span>",
      n.is_head_node ? "*" : "", (n.available.CPU||0) + "/" + (n.resources.CPU||0), n.n_workers,
      esc(Object.entries(n.lease_blocks||{})
        .map(([p, b]) => p + " " + b.used + "/" + b.size).join(" ") || "-"),
      esc(Object.entries(n.labels||{}).filter(([k]) => k != "ca.io/node-id")
        .map(([k, v]) => k.replace("ca.io/", "") + "=" + v).join(" "))])).join("");
  const actors = await (await fetch("/api/actors")).json();
  document.getElementById("actors").innerHTML = row(["actor", "name", "state", "node", "restarts"], "th") +
    actors.slice(0, 50).map(a => row([a.actor_id.slice(0, 12), esc(a.name), a.state, a.node_id||"", a.incarnation])).join("");
  const workers = await (await fetch("/api/workers")).json();
  document.getElementById("workers").innerHTML = row(["worker", "pid", "state", "node"], "th") +
    workers.slice(0, 80).map(w => row([w.worker_id, w.pid, w.state, w.node_id])).join("");
  const jobs = await (await fetch("/api/jobs")).json();
  const jcls = {RUNNING: "warn", SUCCEEDED: "ok", FAILED: "bad", STOPPED: "bad"};
  document.getElementById("jobs").innerHTML = row(["job", "status", "entrypoint", "runtime s"], "th") +
    jobs.slice(0, 30).map(j => row([esc(j.submission_id),
      '<span class="' + (jcls[j.status]||"") + '">' + esc(j.status) + "</span>",
      esc((j.entrypoint||"").slice(0, 80)),
      (j.runtime_s == null ? "" : j.runtime_s.toFixed(1))])).join("");
  const pgs = await (await fetch("/api/pgs")).json();
  document.getElementById("pgs").innerHTML = row(["pg", "strategy", "state", "bundle nodes"], "th") +
    pgs.slice(0, 30).map(p => row([p.pg_id.slice(0, 12), p.strategy, p.state,
      esc((p.bundle_nodes||[]).join(" "))])).join("");
  const tasks = await (await fetch("/api/tasks?limit=600")).json();
  timeline(tasks);
  const done = tasks.filter(t => t.task_id && t.end && t.start && t.state != "SPAN");
  document.getElementById("tasks").innerHTML = row(["name", "type", "state", "worker", "ms"], "th") +
    done.slice(-30).reverse().map(t => row([esc(t.name), t.type, t.state, t.worker_id,
      ((t.end - t.start) * 1000).toFixed(1)])).join("");
}
async function refreshLogs() {
  const sel = document.getElementById("logsel");
  const ids = await (await fetch("/api/logs")).json();
  const cur = sel.value;
  sel.innerHTML = '<option value="">(choose a process)</option>' +
    ids.map(i => '<option' + (i === cur ? " selected" : "") + '>' + esc(i) + "</option>").join("");
  const lp = await (await fetch("/api/logplane")).json();
  document.getElementById("logstats").textContent =
    " lines " + (lp.ca_log_lines_total||0) + " shipped " + (lp.log_lines_shipped||0) +
    " dropped " + ((lp.ca_log_dropped_total||0) + (lp.log_lines_dropped||0));
  if (!sel.value) return;
  const r = await (await fetch("/api/logs?id=" + encodeURIComponent(sel.value) + "&tail=100")).json();
  document.getElementById("logview").textContent = r.data != null ? r.data : (r.error || "");
}
function spark(label, pts, unit) {
  // inline SVG sparkline over the tier-0 window (newest right)
  const W = 180, H = 36;
  let path = "", cur = "";
  if (pts.length > 1) {
    const vs = pts.map(p => p[1]);
    const vmax = Math.max(...vs, 1e-9), t0 = pts[0][0],
          span = Math.max(pts[pts.length-1][0] - t0, 1e-9);
    path = pts.map((p, i) =>
      (i ? "L" : "M") + ((p[0]-t0)/span*W).toFixed(1) + "," +
      (H - 2 - (p[1]/vmax)*(H-6)).toFixed(1)).join(" ");
    cur = vs[vs.length-1] >= 100 ? vs[vs.length-1].toFixed(0)
        : vs[vs.length-1].toPrecision(3);
  }
  return '<div style="background:#161b22;border:1px solid #2a3038;padding:6px 8px">' +
    '<div style="font-size:11px;color:#9aa5b1">' + esc(label) + "</div>" +
    '<svg width="' + W + '" height="' + H + '"><path d="' + path +
    '" fill="none" stroke="#8ab4f8" stroke-width="1.5"/></svg>' +
    '<div style="font-size:12px" class="ok">' + cur + " " + unit + "</div></div>";
}
async function refreshSparks() {
  // one sparkline per plane: core scheduling + the post-PR-7 planes
  // (dag / serve / train / transfer) + the flight recorder itself
  const names = [
    ["head_tasks_pushed", "tasks/s", 1],
    ["head_objects_created", "obj/s", 1],
    ["head_rpc_messages_recv", "msg/s", 1],
    ["ca_head_loop_lag_seconds", "ms lag", 0],
    ["head_nodes_draining", "draining", 0],
    ["ca_owner_owner_gc", "owner gc/s", 1],
    ["ca_dag_executions", "dag ticks/s", 1, "dag_executions"],
    ["ca_serve_request_latency_seconds_count", "req/s", 1, "serve_requests"],
    ["ca_serve_shed_total", "shed/s", 1, "serve_shed"],
    ["ca_train_preempt_restarts_total", "preempt/s", 1, "train_preempts"],
    ["ca_transfer_pulls", "pulls/s", 1, "transfer_pulls"],
    ["ca_flightrec_recorded", "ev/s", 1, "flightrec_events"],
  ];
  const r = await (await fetch("/api/timeseries?rate=1&names=" +
    names.map(n => n[0]).join(","))).json();
  if (r.meta && r.meta.disabled) return;
  let html = "";
  names.forEach(([n, unit, isRate, label]) => {
    const tagged = r.series[n];
    if (!tagged) return;
    let pts = Object.values(tagged)[0].points;
    if (n === "ca_head_loop_lag_seconds") pts = pts.map(p => [p[0], p[1]*1000]);
    if (pts.length > 1)
      html += spark(label || n.replace(/^head_|^ca_head_/, ""), pts, unit);
  });
  document.getElementById("sparks").innerHTML = html;
  document.getElementById("tsmeta").textContent =
    (r.meta.n_series||0) + " series, " +
    ((r.meta.memory_bytes||0)/1024).toFixed(0) + " KiB retained";
}
async function refreshFlight() {
  const r = await (await fetch("/api/flightrec?limit=25")).json();
  document.getElementById("frstats").textContent = r.enabled
    ? " " + (r.total||0) + " events retained"
    : " (disabled: flightrec_plane=false)";
  const evs = (r.events||[]).slice().reverse();
  document.getElementById("flightrec").innerHTML =
    row(["time", "node/proc", "event", "detail", "trace"], "th") +
    evs.map(e => {
      const extra = Object.entries(e)
        .filter(([k]) => !["ts","seq","plane","event","node","proc","trace"].includes(k))
        .map(([k, v]) => k + "=" + (typeof v === "object" ? JSON.stringify(v) : v))
        .join(" ");
      return row([new Date(e.ts * 1000).toLocaleTimeString(),
        esc((e.node||"") + (e.proc ? "/" + e.proc : "")),
        esc(e.plane + ":" + e.event), esc(extra.slice(0, 120)),
        esc(e.trace ? e.trace.tid : "")]);
    }).join("");
}
document.getElementById("logsel").addEventListener("change", refreshLogs);
refresh(); setInterval(refresh, 2000);
refreshLogs(); setInterval(refreshLogs, 3000);
refreshSparks(); setInterval(refreshSparks, 5000);
refreshFlight(); setInterval(refreshFlight, 4000);
</script></body></html>"""


class Dashboard:
    def __init__(self, head):
        self.head = head
        self._server = None
        self.addr = None
        self._loop = None
        self._rest_jobs = {}  # submission_id -> Popen (REST-submitted)

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(self._on_client, host, port)
        h, p = self._server.sockets[0].getsockname()[:2]
        self.addr = f"http://{h}:{p}"
        with open(os.path.join(self.head.session_dir, "dashboard.addr"), "w") as f:
            f.write(self.addr)
        return self.addr

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ---------------------------------------------------------------- http
    async def _on_client(self, reader, writer):
        try:
            req = await asyncio.wait_for(reader.readline(), 10)
            parts = req.decode("latin1").split()
            if len(parts) < 2 or parts[0] not in ("GET", "POST"):
                await self._respond(writer, 405, "text/plain", b"GET/POST only")
                return
            method, path = parts[0], parts[1]
            clen = 0
            while True:  # drain headers, keep content-length
                line = await asyncio.wait_for(reader.readline(), 10)
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin1").partition(":")
                if k.strip().lower() == "content-length":
                    try:
                        clen = min(int(v.strip()), 1 << 20)
                    except ValueError:
                        clen = 0
            body = (
                await asyncio.wait_for(reader.readexactly(clen), 10)
                if clen else b""
            )
            if method == "POST":
                status, ctype, resp = self._route_post(path, body)
            elif path.split("?", 1)[0] == "/api/logs":
                # async route: cross-node reads proxy through the owning
                # node's agent (head._log_fetch_data awaits the agent RPC)
                status, ctype, resp = await self._route_logs(path)
            else:
                status, ctype, resp = self._route(path)
            await self._respond(writer, status, ctype, resp)
        except asyncio.CancelledError:
            raise  # dashboard shutdown: the finally still closes the socket
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _respond(self, writer, status: int, ctype: str, body: bytes):
        reason = {200: "OK", 404: "Not Found", 405: "Method Not Allowed"}.get(status, "OK")
        writer.write(
            f"HTTP/1.1 {status} {reason}\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
        )
        writer.write(body)
        from .util.aio import drain

        await drain(writer, timeout=10)

    def _route(self, path: str):
        if "?" in path:
            path, _, query = path.partition("?")
        else:
            query = ""
        params = dict(p.partition("=")[::2] for p in query.split("&") if p)
        h = self.head
        if path == "/":
            return 200, "text/html", _PAGE.encode()
        if path == "/api/summary":
            return self._json(
                {
                    "total": h._agg_total(),
                    "available": h._agg_avail(),
                    "stats": dict(
                        h.stats,
                        pending_leases=len(h.pending_leases),
                        n_workers=sum(1 for w in h.workers.values() if w.state != "dead"),
                        n_actors=len(h.actors),
                        n_objects=len(h.objects),
                        n_nodes=len(h._alive_nodes()),
                    ),
                    # HA plane: role/epoch/replication state so the summary
                    # answers "can this cluster lose its head right now?"
                    "ha": h._ha_status_dict(),
                }
            )
        if path == "/api/nodes":
            return self._json(
                [
                    {
                        "node_id": n.node_id,
                        "alive": n.up,  # draining: up but unschedulable
                        "state": n.state,
                        "drain": (
                            {
                                "reason": n.drain_reason,
                                "deadline_in_s": round(
                                    max(
                                        0.0,
                                        n.drain_deadline - time.monotonic(),
                                    ),
                                    3,
                                ),
                            }
                            if n.state == "draining"
                            else None
                        ),
                        "is_head_node": n.is_local,
                        "resources": n.total,
                        "available": n.avail,
                        "load": n.load,
                        "labels": n.labels,
                        # delegated vs used lease-block capacity per pool:
                        # an exhausted block is diagnosable at a glance
                        "lease_blocks": h._node_lease_blocks(n),
                        "n_workers": sum(
                            1
                            for w in h.workers.values()
                            if w.node_id == n.node_id and w.state != "dead"
                        ),
                    }
                    for n in h.nodes.values()
                ]
            )
        if path == "/api/actors":
            return self._json([h._actor_info(a) for a in h.actors.values()])
        if path == "/api/workers":
            return self._json(
                [
                    {
                        "worker_id": w.worker_id, "pid": w.pid, "state": w.state,
                        "node_id": w.node_id, "actor_id": w.actor_id,
                    }
                    for w in h.workers.values()
                ]
            )
        if path == "/api/objects":
            limit = int(params.get("limit", 200))
            out = []
            for rec in list(h.objects.values())[:limit]:
                holders, ledger = h.digest_holders(rec)
                out.append(
                    {
                        "object_id": rec.oid.hex(), "size": rec.size,
                        "node_id": rec.node_id, "holders": holders,
                        "owner_ledger": ledger,
                        "spilled": rec.spill_path is not None,
                    }
                )
            return self._json(out)
        if path == "/api/jobs":
            # runtime computed with the SERVER clock (start_time is ours; a
            # skewed browser clock would show negative runtimes otherwise)
            now = time.time()
            out = []
            for v in self._job_kv().values():
                j = json.loads(v)
                if j.get("start_time"):
                    j["runtime_s"] = (j.get("end_time") or now) - j["start_time"]
                out.append(j)
            return self._json(out)
        if path.startswith("/api/jobs/"):
            sid = path[len("/api/jobs/"):]
            raw = self._job_kv().get(sid)
            if raw is None:
                return 404, "application/json", b'{"error": "unknown job"}'
            return self._json(json.loads(raw))
        if path == "/api/tasks":
            limit = int(params.get("limit", 100))
            return self._json(list(h.task_events)[-limit:])
        if path == "/api/pgs":
            return self._json(
                [
                    {
                        "pg_id": p.pg_id, "strategy": p.strategy, "state": p.state,
                        "bundle_nodes": [b.node_id for b in p.bundles],
                    }
                    for p in h.pgs.values()
                ]
            )
        if path == "/api/serve":
            # serving plane: the controller's ~1s digest (target/actual
            # replicas, per-replica node/queue/draining, last autoscale
            # decision) rides the head KV, so this works even while the
            # controller actor is busy reconciling
            raw = h.kv.get("", {}).get("serve:plane")
            plane = {}
            if raw:
                try:
                    plane = json.loads(raw)
                except Exception:
                    plane = {}
            return self._json({"deployments": plane})
        if path == "/api/timeseries":
            # metrics-plane history: the head's retention store (ring
            # buffers, two tiers), counter→rate derivable server-side
            ts = h.timeseries
            if ts is None:
                return self._json({"series": {}, "meta": {"disabled": True}})
            names = params.get("names")
            return self._json(
                {
                    "series": ts.query(
                        names=names.split(",") if names else None,
                        prefix=params.get("prefix") or None,
                        tier=int(params.get("tier", 0)),
                        rate=params.get("rate") in ("1", "true"),
                    ),
                    "meta": ts.meta(),
                }
            )
        if path == "/api/logplane":
            # log-plane counter snapshot: capture-side aggregates from the
            # metrics table + this head's ship/drop stats
            out = {
                "log_lines_shipped": h.stats.get("log_lines_shipped", 0),
                "log_lines_dropped": h.stats.get("log_lines_dropped", 0),
                **h._log_counter_totals(),
            }
            return self._json(out)
        if path == "/api/flightrec":
            # flight-recorder journal: cluster-merged decision events with
            # the same filters as the `flightrec` head RPC / `ca events`
            return self._json(
                h._flightrec_query(
                    trace=params.get("trace") or None,
                    plane=params.get("plane") or None,
                    node=params.get("node") or None,
                    event=params.get("event") or None,
                    since=float(params["since"]) if params.get("since") else None,
                    limit=int(params.get("limit", 200)),
                )
            )
        if path == "/metrics":
            from .util.metrics import render_prometheus

            try:
                text = render_prometheus(h.metrics)
            except Exception:
                text = ""
            return 200, "text/plain; version=0.0.4", text.encode()
        return 404, "text/plain", b"not found"

    # ------------------------------------------------------------- log view
    async def _route_logs(self, path: str):
        """GET /api/logs            -> available log ids
        GET /api/logs?id=X&tail=N[&off=M] -> that process's log text (any
        node; reads proxy through the owning agent)."""
        query = path.partition("?")[2]
        params = dict(p.partition("=")[::2] for p in query.split("&") if p)
        h = self.head
        ident = params.get("id")
        if not ident:
            # dead workers stay listed: a crashed worker's log is exactly
            # the one worth reading (readable as long as its node is up)
            ids = (
                ["head"]
                + sorted(w.worker_id for w in h.workers.values())
                + sorted(
                    n.node_id
                    for n in h.nodes.values()
                    if not n.is_local and n.state == "alive"
                )
            )
            return self._json(ids)
        try:
            out = await h._log_fetch_data(
                ident,
                tail=int(params.get("tail", 200)),
                off=int(params["off"]) if params.get("off") else None,
                structured=params.get("structured") in ("1", "true"),
            )
        except (FileNotFoundError, RuntimeError, ValueError) as e:
            return 404, "application/json", json.dumps({"error": str(e)}).encode()
        return self._json(
            {"id": ident, "node_id": out["node_id"], "off": out["off"],
             "data": out["data"]}
        )

    # --------------------------------------------------------- job REST API
    # Reference parity: dashboard/modules/job REST surface (JobSubmissionClient
    # speaks HTTP to the dashboard).  The head spawns and tracks the job's
    # driver subprocess itself — same contract as jobs.JobSupervisor, same KV
    # namespace, so `ca jobs` and the SDK see REST-submitted jobs too.

    def _job_kv(self):
        return self.head.kv.setdefault("__jobs__", {})

    def _route_post(self, path: str, body: bytes):
        if path == "/api/jobs":
            try:
                spec = json.loads(body or b"{}")
                entrypoint = spec["entrypoint"]
            except (ValueError, KeyError):
                return 400, "application/json", b'{"error": "entrypoint required"}'
            sid = spec.get("submission_id") or f"cajob_{uuid.uuid4().hex[:10]}"
            info = {
                "submission_id": sid,
                "status": "RUNNING",
                "entrypoint": entrypoint,
                "start_time": time.time(),
                "end_time": None,
                "return_code": None,
                "message": "submitted via REST",
            }
            env = dict(os.environ)
            env.update(spec.get("env_vars") or {})
            env["CA_ADDRESS"] = self.head.session_dir
            env["CA_JOB_SUBMISSION_ID"] = sid
            log_path = os.path.join(self.head.session_dir, f"job-{sid}.log")
            logf = open(log_path, "ab")
            try:
                proc = subprocess.Popen(
                    entrypoint,
                    shell=True,
                    env=env,
                    cwd=spec.get("cwd"),
                    stdout=logf,
                    stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
            except OSError as e:
                return 500, "application/json", json.dumps({"error": repr(e)}).encode()
            finally:
                logf.close()
            self._rest_jobs[sid] = proc
            self._job_kv()[sid] = json.dumps(info).encode()
            threading.Thread(
                target=self._watch_job, args=(sid, proc, dict(info)), daemon=True
            ).start()
            return self._json({"submission_id": sid})
        if path.startswith("/api/jobs/") and path.endswith("/stop"):
            sid = path[len("/api/jobs/") : -len("/stop")]
            proc = self._rest_jobs.get(sid)
            if proc is None:
                return 404, "application/json", b'{"error": "unknown job"}'
            if proc.poll() is None:
                import signal as _signal

                raw = self._job_kv().get(sid)
                if raw:
                    info = json.loads(raw)
                    info["status"] = "STOPPED"
                    self._job_kv()[sid] = json.dumps(info).encode()
                try:
                    os.killpg(os.getpgid(proc.pid), _signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    pass
            return self._json({"submission_id": sid, "status": "STOPPED"})
        return 404, "text/plain", b"not found"

    def _watch_job(self, sid: str, proc, info: dict):
        rc = proc.wait()

        def _update():
            raw = self._job_kv().get(sid)
            final = json.loads(raw) if raw else dict(info)
            if final.get("status") == "RUNNING":
                final["status"] = "SUCCEEDED" if rc == 0 else "FAILED"
            final["return_code"] = rc
            final["end_time"] = time.time()
            self._job_kv()[sid] = json.dumps(final).encode()

        # marshal onto the head loop: the kv dict is also walked by the
        # snapshot persister there
        if self._loop is not None:
            self._loop.call_soon_threadsafe(_update)

    @staticmethod
    def _json(obj: Any):
        return 200, "application/json", json.dumps(obj, default=str).encode()
