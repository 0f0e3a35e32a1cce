"""Node agent: the per-node daemon (raylet analogue, src/ray/raylet/
node_manager.h) for every node other than the head's own.

Responsibilities, mirroring the reference raylet:
- register the node (its resources) with the head over TCP and heartbeat;
- spawn/kill/monitor this node's worker processes on head request
  (worker_pool.h role) and report their deaths;
- grant worker leases NODE-LOCALLY out of head-delegated "lease blocks"
  (the LocalTaskManager/raylet-grant analogue, see LeaseGranter below);
- serve chunked reads of this node's shm objects for node-to-node transfer
  (object_manager.h push analogue);
- sweep departed clients' arena files and clean the node's shm namespace on
  shutdown.

Lease plane: the head remains the global placement policy (node choice,
spillover, PG bundle charging, fairness) but delegates bounded per-pool
lease capacity to each agent as lease blocks — specific registered idle
workers whose unit resource shape the head pre-charges against the node.
Submitters dial this agent directly (`lease_grant`/`lease_release`) for the
hot unit-shape lease class, so steady-state task floods never touch the
head's loop; exhausted blocks and every other lease class fall back to the
head, which also revokes delegated capacity on demand and reclaims it
wholesale when an agent dies.  Task pushes still go driver->worker directly;
the agent is only on the lease path, never the task path.
"""

from __future__ import annotations

import asyncio
import os
import random
import signal
import subprocess
import sys
import time
from typing import Any, Dict, Optional

from . import netchaos
from .config import CAConfig, set_config
from .errors import FencedError
from .head import read_shm_chunk
from .ownership import DeltaReporter, quantize_load
from .protocol import AddrRing, Server, addr_list, spawn_bg


def node_load_sample() -> Dict[str, float]:
    """Point-in-time node utilization, disseminated with heartbeats (the
    centralized stand-in for ray_syncer.h:83's NodeResourceUsage broadcast:
    one scheduler needs the data, so it flows head-ward, not peer-to-peer)."""
    out: Dict[str, float] = {}
    try:
        out["load_1m"] = os.getloadavg()[0]
    except OSError:
        pass
    try:
        from .memory_monitor import MemoryMonitor

        s = MemoryMonitor().sample()
        if s is not None:
            used, total = s
            out["mem_used_frac"] = round(used / total, 4) if total else 0.0
    except Exception:
        pass
    return out


class LeaseGranter:
    """Node-local lease granting over head-delegated lease blocks (the
    LocalTaskManager analogue of src/ray/raylet/local_task_manager.h).

    The head delegates specific idle workers (wid + dialable address) per
    pool; their unit resource shape was charged against the node centrally
    at delegation time, so granting here requires no further accounting —
    a grant is a dictionary move.  Lease liveness is connection liveness:
    each lease remembers the granting client's connection state, and the
    agent releases every lease of a departed connection (mirroring the
    head's client-disconnect lease sweep).  Worker death (reaped by the
    agent) frees the slot and shrinks the block.
    """

    def __init__(self, node_id: str):
        self.node_id = node_id
        # pool -> wid -> {"addr": str, "lease": Optional[str]}
        self.workers: Dict[str, Dict[str, dict]] = {}
        # lease_id -> (pool, wid, granting conn-state dict)
        self.leases: Dict[str, tuple] = {}
        # per-pool lifetime counters (attribution must stay per pool: the
        # head sums them across pools for ca status / lease_plane())
        self.counters: Dict[str, Dict[str, int]] = {}
        self._seq = 0

    def _pool_counters(self, pool: str) -> Dict[str, int]:
        return self.counters.setdefault(
            pool, {"granted": 0, "denied": 0, "released": 0, "revoked": 0}
        )

    def add_workers(self, pool: str, workers) -> int:
        """Absorb a lease_block delegation; duplicate wids are idempotent
        (re-delegation after head-restart reconciliation)."""
        slot = self.workers.setdefault(pool, {})
        added = 0
        for w in workers or ():
            if w["wid"] not in slot:
                slot[w["wid"]] = {"addr": w["addr"], "lease": None}
                added += 1
        return added

    def grant(self, pool: str, conn_state) -> Optional[dict]:
        """Grant one unit-shape lease from the pool's block, or None when
        the block is exhausted (the submitter falls back to the head)."""
        for wid, ent in self.workers.get(pool, {}).items():
            if ent["lease"] is None:
                self._seq += 1
                lease_id = f"L{self.node_id}:{self._seq}:{os.urandom(3).hex()}"
                ent["lease"] = lease_id
                self.leases[lease_id] = (pool, wid, conn_state)
                self._pool_counters(pool)["granted"] += 1
                return {"lease_id": lease_id, "worker_id": wid, "addr": ent["addr"]}
        self._pool_counters(pool)["denied"] += 1
        return None

    def release(self, lease_id: str) -> None:
        rec = self.leases.pop(lease_id, None)
        if rec is None:
            return  # idempotent: worker-exit or disconnect already freed it
        pool, wid, _ = rec
        ent = self.workers.get(pool, {}).get(wid)
        if ent is not None and ent["lease"] == lease_id:
            ent["lease"] = None
        self._pool_counters(pool)["released"] += 1

    def release_for_conn(self, conn_state) -> int:
        """A granting client's connection closed: its leases are dead (the
        agent-side analogue of the head's disconnect lease sweep)."""
        gone = [lid for lid, (_, _, st) in self.leases.items() if st is conn_state]
        for lid in gone:
            self.release(lid)
        return len(gone)

    def on_worker_exit(self, wid: str) -> None:
        for pool, slot in self.workers.items():
            ent = slot.pop(wid, None)
            if ent is not None:
                if ent["lease"] is not None:
                    self.leases.pop(ent["lease"], None)
                return

    def revoke(self, pool: str, n: int) -> list:
        """Give back up to n UNLEASED workers (head revocation / fairness
        reclaim); outstanding grants keep their workers."""
        out = []
        slot = self.workers.get(pool, {})
        for wid in list(slot):
            if len(out) >= n:
                break
            if slot[wid]["lease"] is None:
                del slot[wid]
                out.append(wid)
        self._pool_counters(pool)["revoked"] += len(out)
        return out

    def stats(self) -> Dict[str, dict]:
        """Per-pool block occupancy + lifetime counters, shipped to the head
        with every heartbeat (the existing dissemination path)."""
        out = {}
        for pool, slot in self.workers.items():
            used = sum(1 for e in slot.values() if e["lease"] is not None)
            out[pool] = {"size": len(slot), "used": used, **self._pool_counters(pool)}
        return out

    def block_snapshot(self) -> Dict[str, dict]:
        """What a (re)registration reports so a restarted head re-adopts the
        delegated blocks instead of double-granting the same workers."""
        return {
            pool: {
                "wids": list(slot),
                "used": sum(1 for e in slot.values() if e["lease"] is not None),
            }
            for pool, slot in self.workers.items()
            if slot
        }


class NodeAgent:
    def __init__(self):
        self.session_dir = os.environ["CA_SESSION_DIR"]
        self.session_name = os.path.basename(self.session_dir)
        # CA_HEAD_ADDR may be a comma-separated list (active head first,
        # warm standbys after): the ring rotates through candidates on
        # failover, and register replies merge in standbys learned later
        self._head_ring = AddrRing(addr_list(os.environ["CA_HEAD_ADDR"]))
        self.head_addr = self._head_ring.current or os.environ["CA_HEAD_ADDR"]
        self.node_id = os.environ["CA_NODE_ID"]
        import json

        self.resources = json.loads(os.environ.get("CA_NODE_RESOURCES", '{"CPU": 4}'))
        # labels travel with registration: detected HERE (the agent's env,
        # not the head's); the head adds ca.io/node-id when recording
        from .accelerators import detect_node_labels

        self.labels = detect_node_labels()
        self.config = CAConfig.from_json(os.environ["CA_CONFIG_JSON"])
        set_config(self.config)
        self.serve_addr_spec = os.environ.get("CA_AGENT_SERVE", "tcp:127.0.0.1:0")
        self.node_dir = os.path.join(self.session_dir, "nodes", self.node_id)
        os.makedirs(self.node_dir, exist_ok=True)
        if self.config.log_capture:
            # the agent captures its own output the same way its workers do:
            # agent.jsonl rides the same tail-and-ship loop, so agent prints
            # reach subscribed drivers prefixed "(agent ... node=...)"
            from ..util.logplane import install_capture

            install_capture(
                self.session_dir, self.node_id, "agent",
                max_bytes=self.config.log_rotate_bytes,
            )
        self.shm_ns_dir = os.path.join("/dev/shm", self.session_name, self.node_id)
        os.makedirs(self.shm_ns_dir, exist_ok=True)
        self.server = Server(
            [self.serve_addr_spec], self._handle, on_disconnect=self._on_client_gone
        )
        # node-local lease granting over head-delegated blocks (raylet
        # LocalTaskManager analogue)
        self.granter = LeaseGranter(self.node_id)
        # GPU pinning for this node's GPU workers (same policy as the head's
        # local node; the agent owns spawns here, so it owns the allocator)
        from .accelerators import ChipAllocator

        n_chips = int(self.resources.get("GPU", 0))
        self.chip_alloc = ChipAllocator(n_chips) if n_chips > 1 else None
        self._worker_chips: Dict[str, str] = {}
        self.mem_monitor = None
        if self.config.memory_monitor_refresh_ms > 0 and self.config.memory_usage_threshold > 0:
            from .memory_monitor import MemoryMonitor

            self.mem_monitor = MemoryMonitor(self.config.memory_usage_threshold)
        self.head = None
        self.procs: Dict[str, subprocess.Popen] = {}  # wid -> proc
        self._pull_maps: Dict[str, Any] = {}
        self._shutdown = asyncio.Event()
        self._draining = False  # SIGTERM self-drain already requested
        # fencing token minted by the head at registration; stamped onto
        # every authority-bearing notify (node_sync, worker_exit, block
        # returns) so a partitioned-then-healed agent is refused instead of
        # believed.  None = not yet registered / purged for a fresh rejoin.
        self.incarnation: Optional[int] = None
        self._fencing = False  # single-flight guard for _fence_reset
        # HA plane: highest head epoch this agent has observed (register
        # replies and hep-stamped head RPCs).  A call stamped with a LOWER
        # epoch comes from a superseded head (a zombie that healed from a
        # partition still believing it owns the cluster): refuse it with
        # FencedError — the refusal is how the old head learns to demote.
        self.head_epoch = 0
        self.ha_zombie_rpcs = 0  # fenced old-head calls (chaos test hook)
        # network-chaos plane: partition/straggler injection from the spec
        # this process was started with (runtime `ca chaos set` broadcasts
        # arrive as net_chaos pushes)
        netchaos.maybe_install_from_config(self.config, self.node_id)
        # delta-synced node state (ray_syncer role, head-ward): components
        # re-send only when their payload changes; an idle node's tick
        # degenerates to a bare node_sync keepalive.  reset() on every
        # (re)registration forces a full resync to the (new) head.
        self.reporter = DeltaReporter()
        self._mp_tick = 0  # re-send the pressure component while pressured
        # metrics plane: this node's aggregated metrics table (the per-node
        # MetricsAgent role).  Workers ship delta records here instead of to
        # the head; the table is served over HTTP in Prometheus exposition
        # format (head-free scrape) and the deltas piggyback onto node_sync
        # ticks so the head's cluster-wide table stays fed for dashboards.
        self.node_metrics: Dict[str, dict] = {}
        self._metrics_pending: list = []
        self.metrics_stats = {
            "reports_total": 0, "scrapes_total": 0, "head_ship_dropped": 0,
        }
        self._http_server = None
        self.metrics_addr = None
        # flight recorder: the agent journals its own decisions (fence
        # resets, drain handling) and forwards workers' journal slices
        # head-ward on the same node_sync piggyback as metric deltas
        self._flightrec_pending: list = []
        if getattr(self.config, "flightrec_plane", True):
            from ..util import flightrec

            flightrec.init(
                cap=getattr(self.config, "flightrec_ring_len", 4096),
                node_id=self.node_id, proc="agent",
            )

    # --------------------------------------------------------------- workers
    def _spawn_worker(self, wid: str, purpose: str, pool: str) -> None:
        env = dict(os.environ)
        env["CA_SESSION_DIR"] = self.session_dir
        # workers dial the head over TCP; they inherit the whole head ring
        # (live active first) so a worker spawned pre-failover can re-anchor
        # to a promoted standby it never registered with
        ring = list(self._head_ring.addrs)
        if self.head_addr in ring:
            ring.remove(self.head_addr)
        env["CA_HEAD_SOCK"] = ",".join([self.head_addr] + ring)
        env["CA_WORKER_ID"] = wid
        env["CA_WORKER_SOCK"] = "tcp:127.0.0.1:0"  # bind ephemeral, advertise
        env["CA_NODE_ID"] = self.node_id
        env["CA_AGENT_ADDR"] = self.serve_addr  # local pulls dedup through us
        env["CA_CONFIG_JSON"] = self.config.to_json()
        if pool != "gpu":
            env["CUDA_VISIBLE_DEVICES"] = ""
        elif self.chip_alloc is not None:
            from .accelerators import visible_chips_env_for_worker

            chip = self.chip_alloc.acquire()
            if chip is not None:
                self._worker_chips[wid] = chip
                env.update(visible_chips_env_for_worker(chip))
        log_path = os.path.join(self.node_dir, f"{wid}.log")
        logf = open(log_path, "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "cluster_anywhere_tpu_torch.core.workerproc"],
            env=env,
            stdout=logf,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        logf.close()
        self.procs[wid] = proc

    def _kill_worker(self, wid: str):
        proc = self.procs.get(wid)
        if proc is not None and proc.poll() is None:
            try:
                os.kill(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    # --------------------------------------------------------------- handler
    async def _on_client_gone(self, state):
        # a submitter's connection died: its locally-granted leases are dead
        # (lease liveness IS connection liveness on the local plane)
        self.granter.release_for_conn(state)

    async def _handle(self, state, msg, reply, reply_err):
        m = msg["m"]
        hep = msg.get("hep")
        if hep is not None:
            if hep > self.head_epoch:
                self.head_epoch = hep
            elif hep < self.head_epoch:
                # a superseded head's RPC (zombie authority): refuse and tell
                # it WHY — the "head epoch" marker in the message is the old
                # head's demote trigger.  Never execute the body: spawns and
                # kills from a fenced head are duplicate side effects.
                self.ha_zombie_rpcs += 1
                from ..util import flightrec

                if flightrec.REC is not None:
                    flightrec.REC.record(
                        "ha", "ha_fence_old_head",
                        method=m, offered=hep, known=self.head_epoch,
                    )
                reply_err(FencedError(
                    f"call stamped by superseded head epoch {hep} "
                    f"(current head epoch: {self.head_epoch})"
                ))
                return
        if m == "lease_grant":
            # node-local grant (hot path): a dict move, no head round-trip.
            # An exhausted block replies granted=False — the submitter falls
            # back to the head, which may revoke/re-balance capacity.
            g = self.granter.grant(msg.get("pool", "cpu"), state)
            if g is None:
                reply(granted=False)
            else:
                # grants carry the node incarnation: a post-heal audit can
                # prove no outstanding grant was minted pre-verdict
                reply(granted=True, ninc=self.incarnation, **g)
        elif m == "lease_release":
            for lid in msg.get("lease_ids") or ():
                self.granter.release(lid)
            reply()
        elif m == "lease_block":
            # head delegation push: absorb the block's workers — unless the
            # delegation names a different incarnation (this agent is
            # mid-fence: granting from a stale block would mint zombies)
            if msg.get("ninc") is not None and msg["ninc"] != self.incarnation:
                reply(rejected=True)
            else:
                self.granter.add_workers(msg.get("pool", "cpu"), msg.get("workers"))
                reply()
        elif m == "lease_block_revoke":
            # head wants capacity back (pending central work / fairness):
            # return unleased workers; outstanding grants keep theirs
            pool = msg.get("pool", "cpu")
            wids = self.granter.revoke(pool, int(msg.get("n", 1 << 30)))
            if wids:
                try:
                    self.head.notify(
                        "lease_block_return",
                        **self._auth(
                            {"node_id": self.node_id, "pool": pool, "wids": wids}
                        ),
                    )
                except Exception:
                    pass  # head gone: re-register reconciles the block
            reply(wids=wids)
        elif m == "spawn_worker":
            self._spawn_worker(msg["wid"], msg.get("purpose", "pool"), msg.get("pool", "cpu"))
            reply()
        elif m == "kill_worker":
            self._kill_worker(msg["wid"])
            reply()
        elif m == "log_read":
            # query plane: the head proxies cross-node log reads through the
            # owning agent, so `ca logs`/get_log need no shared filesystem
            from ..util.logplane import tail_file

            name = msg["name"]
            if "/" in name or ".." in name or name.startswith("."):
                reply_err(ValueError(f"bad log name {name!r}"))
                return
            suffix = ".jsonl" if msg.get("structured") else ".log"
            path = os.path.join(self.node_dir, name + suffix)
            try:
                data, off = tail_file(
                    path, tail=int(msg.get("tail", 200)), off=msg.get("off")
                )
            except (FileNotFoundError, OSError):
                reply_err(FileNotFoundError(
                    f"no log for {name!r} on node {self.node_id}"
                ))
            else:
                reply(data=data, off=off, node_id=self.node_id)
        elif m == "pull_chunk":
            delay = getattr(self.config, "testing_transfer_delay_s", 0.0)
            if delay:
                # test/bench hook: simulated link latency (see head twin)
                await asyncio.sleep(delay)
            reply(data=read_shm_chunk(
                self.session_name, self._pull_maps, msg["shm_name"], msg["off"], msg["len"]
            ))
        elif m == "sweep_arenas":
            import glob

            for path in glob.glob(os.path.join(self.shm_ns_dir, f"arena_{msg['cid']}_*")):
                name = os.path.relpath(path, "/dev/shm")
                mm = self._pull_maps.pop(name, None)
                if mm is not None:
                    try:
                        mm.close()
                    except (BufferError, ValueError):
                        pass
                try:
                    os.unlink(path)
                except OSError:
                    pass
            reply()
        elif m == "unlink_shm":
            name = msg["shm_name"]
            if name.startswith(f"{self.session_name}/{self.node_id}/") and ".." not in name:
                from .head import drop_pull_map

                drop_pull_map(self._pull_maps, name)
                try:
                    os.unlink(os.path.join("/dev/shm", name))
                except OSError:
                    pass
        elif m == "unlink_spill":
            path = msg["path"]
            if f"/{self.session_name}/" in path and "/spill/" in path and ".." not in path:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        elif m == "metrics_report":
            # metrics plane ingest: a local worker's delta batch lands in the
            # node table (scrape truth, head-free) and queues for the next
            # node_sync tick (head dashboard truth).  The pending queue is
            # bounded like the worker-side re-stage buffer: a long head
            # outage drops the OLDEST deltas, never the node table.
            from ..util.metrics import RESTAGE_CAP, merge_metric_records

            records = msg.get("metrics") or []
            merge_metric_records(self.node_metrics, records)
            self.metrics_stats["reports_total"] += len(records)
            self._metrics_pending.extend(records)
            over = len(self._metrics_pending) - RESTAGE_CAP
            if over > 0:
                del self._metrics_pending[:over]
                self.metrics_stats["head_ship_dropped"] += over
                from .ownership import warn_ratelimited

                warn_ratelimited(
                    "agent-metrics-pending-cap",
                    f"node {self.node_id}: metrics head-ship queue full, "
                    f"dropped {over} oldest delta records",
                )
            # flight-recorder piggyback: worker journal slices queue for the
            # next node_sync tick, bounded with the same drop-oldest policy
            frev = msg.get("flightrec") or []
            if frev:
                from ..util.flightrec import FLIGHTREC_STATS

                self._flightrec_pending.extend(frev)
                over = len(self._flightrec_pending) - RESTAGE_CAP
                if over > 0:
                    del self._flightrec_pending[:over]
                    FLIGHTREC_STATS["dropped"] += over
        elif m == "profile":
            # sampling profiler relay target: profile THIS agent process
            # (workers serve their own `profile`; the head resolves routing)
            from ..util import profiler

            res = await asyncio.get_running_loop().run_in_executor(
                None, profiler.sample_stacks,
                float(msg.get("duration", 2.0)), float(msg.get("hz", 100.0)),
            )
            reply(
                folded=profiler.render_folded(res["folded"]),
                speedscope=profiler.speedscope_json(
                    res["folded"], f"agent {self.node_id}", res["hz"]
                ),
                samples=res["samples"],
                duration_s=res["duration_s"],
            )
        elif m == "node_shutdown":
            self._shutdown.set()
        elif m == "net_chaos":
            # runtime chaos broadcast from the head (`ca chaos set`)
            try:
                netchaos.install(
                    msg.get("spec") or "", self.node_id,
                    epoch=msg.get("epoch"),
                )
            except (ValueError, TypeError):
                pass  # malformed spec was already rejected head-side
            reply()
        elif m == "fenced":
            # the head refused one of our stamped RPCs: this incarnation
            # (echoed in the push) was declared dead — purge and rejoin
            # fresh (zombie-free heal)
            if msg.get("ninc") is None or msg.get("ninc") == self.incarnation:
                spawn_bg(self._fence_reset())
            reply()
        elif m == "ha_ring":
            # runtime standby-ring dissemination (HA plane): an agent that
            # registered before any standby subscribed learns failover
            # targets here, not just via its register reply
            self._head_ring.merge(msg.get("standbys") or [])
            ep = msg.get("head_epoch")
            if ep is not None and ep > self.head_epoch:
                self.head_epoch = ep
            reply()
        # operator liveness probe: ca-lint: ignore[rpc-dead-handler]
        elif m == "ping":
            reply(node_id=self.node_id, n_workers=len(self.procs),
                  head_epoch=self.head_epoch)
        else:
            reply_err(ValueError(f"unknown agent method {m}"))

    # ------------------------------------------------------- metrics scrape
    def _scrape_table(self) -> Dict[str, dict]:
        """The node table plus the agent's own liveness counters — what a
        Prometheus scrape of this node returns."""
        table = dict(self.node_metrics)
        tags = "[]"
        table["ca_node_agent_metrics_reports_total"] = {
            "type": "counter",
            "desc": "worker metric delta records ingested by this node agent",
            "data": {tags: float(self.metrics_stats["reports_total"])},
        }
        table["ca_node_agent_scrapes_total"] = {
            "type": "counter",
            "desc": "HTTP /metrics scrapes served by this node agent",
            "data": {tags: float(self.metrics_stats["scrapes_total"])},
        }
        table["ca_node_agent_workers"] = {
            "type": "gauge",
            "desc": "worker processes currently supervised by this agent",
            "data": {tags: float(len(self.procs))},
        }
        table["ca_node_agent_head_ship_dropped_total"] = {
            "type": "counter",
            "desc": "metric delta records dropped at this agent's bounded "
            "head-ship queue (head unreachable too long)",
            "data": {tags: float(self.metrics_stats["head_ship_dropped"])},
        }
        return table

    async def _http_client(self, reader, writer):
        """Minimal HTTP endpoint: GET /metrics (Prometheus exposition text
        of this node's table — served with NO head involvement, so scrapes
        survive a dead head) and GET /healthz."""
        try:
            req = await asyncio.wait_for(reader.readline(), 10)
            parts = req.decode("latin1").split()
            while True:  # drain headers
                line = await asyncio.wait_for(reader.readline(), 10)
                if line in (b"\r\n", b"\n", b""):
                    break
            path = parts[1].split("?", 1)[0] if len(parts) >= 2 else ""
            if len(parts) < 2 or parts[0] != "GET":
                status, ctype, body = 405, "text/plain", b"GET only"
            elif path == "/metrics":
                from ..util.metrics import render_prometheus

                self.metrics_stats["scrapes_total"] += 1
                body = render_prometheus(self._scrape_table()).encode()
                status, ctype = 200, "text/plain; version=0.0.4"
            elif path == "/healthz":
                status, ctype, body = 200, "text/plain", b"ok\n"
            else:
                status, ctype, body = 404, "text/plain", b"not found"
            reason = {200: "OK", 404: "Not Found", 405: "Method Not Allowed"}[status]
            writer.write(
                f"HTTP/1.1 {status} {reason}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
            )
            writer.write(body)
            from ..util.aio import drain  # lazy: util/__init__ reaches into core

            await drain(writer, timeout=10)
        except asyncio.CancelledError:
            raise  # agent shutdown: the finally still closes the socket
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def _routable_host(self):
        """This host's address on the interface that routes to the head (a
        connected UDP socket never sends a packet; getsockname reveals the
        chosen source address)."""
        import socket

        head = self.head_addr
        if not head.startswith("tcp:"):
            return None
        head_host = head[4:].rpartition(":")[0]
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.connect((head_host, 9))
                return s.getsockname()[0]
            finally:
                s.close()
        except OSError:
            return None

    async def _start_metrics_http(self):
        """Bind the scrape endpoint (host of the agent's RPC listener,
        CA_AGENT_METRICS_PORT or ephemeral) and advertise it: in the node
        dir for same-host tools and in the register payload for `ca
        metrics --node` / the dashboard."""
        host = "127.0.0.1"
        spec = self.serve_addr_spec
        if spec.startswith("tcp:"):
            host = spec.split(":")[1] or "127.0.0.1"
        port = int(os.environ.get("CA_AGENT_METRICS_PORT", "0"))
        try:
            self._http_server = await asyncio.start_server(
                self._http_client, host, port
            )
        except OSError:
            return  # port taken: the node runs without a scrape endpoint
        h, p = self._http_server.sockets[0].getsockname()[:2]
        if h in ("0.0.0.0", "::", ""):
            # a wildcard bind must not be ADVERTISED as-is (Prometheus and
            # `ca metrics --node` would dial 0.0.0.0): use the interface
            # that routes to the head — the address peers reach us on
            h = self._routable_host() or "127.0.0.1"
        self.metrics_addr = f"http://{h}:{p}"
        path = os.path.join(self.node_dir, "metrics.addr")
        with open(path + ".tmp", "w") as f:
            f.write(self.metrics_addr)
        os.replace(path + ".tmp", path)

    # ------------------------------------------------------------ lifecycle
    def _auth(self, fields: Dict[str, Any]) -> Dict[str, Any]:
        """Stamp an authority-bearing head notify with this node's
        incarnation (fencing: a stale stamp is refused, and the refusal is
        how a healed zombie learns its death verdict).  The head epoch rides
        beside it: a demoted head that still answers this node's RPCs sees
        its successor's epoch and learns the same verdict in reverse."""
        if self.incarnation is not None:
            fields["ninc"] = self.incarnation
        if self.head_epoch:
            fields["hep"] = self.head_epoch
        return fields

    async def _heartbeat_loop(self):
        period = self.config.health_check_period_s / 2
        while not self._shutdown.is_set():
            await asyncio.sleep(min(period, 1.0))
            try:
                if getattr(self.config, "delta_sync", True):
                    self._send_node_sync()
                else:
                    hb = {"node_id": self.node_id, "load": node_load_sample()}
                    if self.mem_monitor is not None:
                        hb["mem_pressured"] = self.mem_monitor.is_pressured()
                    # delegated/used block occupancy rides the heartbeat (the
                    # same dissemination path as load): the head's `ca
                    # status`, /api/nodes, and revocation sizing read it
                    hb["lease_stats"] = self.granter.stats()
                    pending = (
                        self._take_pending_metrics()
                        if self._metrics_pending else []
                    )
                    if pending:
                        hb["metrics"] = pending
                    frp = self._take_pending_flightrec()
                    if frp:
                        hb["flightrec"] = frp
                    try:
                        self.head.notify("node_heartbeat", **self._auth(hb))
                    except Exception:
                        if pending:
                            self._restage_pending_metrics(pending)
                        if frp:
                            self._restage_pending_flightrec(frp)
                        raise
            except Exception:
                pass
            # reap exited worker processes and report them (the head cannot
            # poll processes it didn't spawn)
            for wid, proc in list(self.procs.items()):
                if proc.poll() is not None:
                    del self.procs[wid]
                    # free the lease slot first: a delegated worker's death
                    # shrinks the block and kills its outstanding grant
                    self.granter.on_worker_exit(wid)
                    if self.chip_alloc is not None:
                        self.chip_alloc.release(self._worker_chips.pop(wid, None))
                    try:
                        self.head.notify(
                            "worker_exit",
                            **self._auth({"wid": wid, "rc": proc.returncode}),
                        )
                    except Exception:
                        pass

    def _take_pending_metrics(self) -> list:
        pending, self._metrics_pending = self._metrics_pending, []
        return pending

    def _take_pending_flightrec(self) -> list:
        """Queued worker journal slices plus this agent's own unshipped
        events, in arrival order (the agent's recorder drains here — agents
        run no metrics flusher of their own)."""
        from ..util import flightrec

        pending, self._flightrec_pending = self._flightrec_pending, []
        if flightrec.REC is not None:
            pending.extend(flightrec.REC.drain())
        return pending

    def _restage_pending_flightrec(self, evs: list) -> None:
        from ..util.flightrec import FLIGHTREC_STATS
        from ..util.metrics import RESTAGE_CAP

        self._flightrec_pending[:0] = evs
        over = len(self._flightrec_pending) - RESTAGE_CAP
        if over > 0:
            del self._flightrec_pending[:over]
            FLIGHTREC_STATS["dropped"] += over

    def _restage_pending_metrics(self, records: list) -> None:
        """A head send failed after the queue was drained: put the records
        back at the FRONT (counter order matters at the aggregator), then
        enforce the cap with the same drop-OLDEST-and-count policy as the
        ingest path — the restaged batch is the oldest data in the queue."""
        from ..util.metrics import RESTAGE_CAP

        self._metrics_pending[:0] = records
        over = len(self._metrics_pending) - RESTAGE_CAP
        if over > 0:
            del self._metrics_pending[:over]
            self.metrics_stats["head_ship_dropped"] += over
            from .ownership import warn_ratelimited

            warn_ratelimited(
                "agent-metrics-pending-cap",
                f"node {self.node_id}: metrics head-ship queue full on "
                f"restage, dropped {over} oldest delta records",
            )

    def _send_node_sync(self):
        """Versioned delta heartbeat (node_sync): only components whose
        payload changed since the last send travel; an unchanged tick is a
        bare {node_id} keepalive (liveness only).  Load telemetry is
        quantized first — raw loadavg jitter would re-send the component
        every tick and make delta sync a full heartbeat with extra steps.
        The mem-pressure component re-sends every tick WHILE pressured: the
        head clears its flag after acting on it (kill one worker per refresh
        period), so a level-triggered single send would stop the policy
        after the first kill.  Queued worker metric deltas piggyback on the
        same tick (the metrics plane's head-ward dashboard feed) — they ride
        whatever frame the tick produces, keepalive included."""
        comps: Dict[str, Any] = {
            "load": quantize_load(node_load_sample()),
            "lease_stats": self.granter.stats(),
        }
        if self.mem_monitor is not None:
            if self.mem_monitor.is_pressured():
                self._mp_tick += 1
                comps["mem_pressured"] = [True, self._mp_tick]
            else:
                comps["mem_pressured"] = False
        d = self.reporter.delta(comps)
        extra: Dict[str, Any] = self._auth({})
        pending = self._take_pending_metrics() if self._metrics_pending else []
        if pending:
            extra["metrics"] = pending
        frp = self._take_pending_flightrec()
        if frp:
            extra["flightrec"] = frp
        try:
            if d is None:
                self.head.notify("node_sync", node_id=self.node_id, **extra)
            else:
                self.head.notify("node_sync", node_id=self.node_id, **d, **extra)
        except Exception:
            if pending:
                self._restage_pending_metrics(pending)
            if frp:
                self._restage_pending_flightrec(frp)
            raise

    async def _log_ship_loop(self):
        """Tail this node's structured capture files and batch new records
        to the head (log-monitor analogue).  The files are the buffer: a
        closed head connection just leaves records on disk for the next
        tick; only a send that fails after the tailer advanced is a loss
        (counted in ca_log_dropped_total)."""
        from ..util.logplane import LOG_STATS, LogTailer

        tailer = LogTailer(self.node_dir, max_records=self.config.log_ship_batch)
        period = max(self.config.log_ship_interval_s, 0.05)
        while not self._shutdown.is_set():
            await asyncio.sleep(period)
            if self.head is None or self.head.closed:
                continue
            try:
                records = tailer.poll()
            except Exception:
                continue
            if not records:
                continue
            try:
                # records carry their own node stamp; a top-level node_id
                # was wire bytes nothing read (ca lint rpc-unread-field)
                self.head.notify("log_batch", records=records)
            except Exception:
                LOG_STATS["dropped_total"] += len(records)

    async def _on_head_push(self, msg):
        # the head reaches us both through its own connection (requests)
        # and as pushes on ours; route pushes through the same handler
        if "m" in msg:
            await self._handle({}, msg, lambda **kw: None, lambda e: None)

    async def _amain(self):
        await self.server.start()
        self.serve_addr = self.server.bound_addrs[0]
        if getattr(self.config, "metrics_plane", True):
            # scrape endpoint first: metrics_addr travels in the register
            await self._start_metrics_http()
        from ..util.aio import dial  # lazy: util/__init__ reaches into core

        netchaos.register_addr(self.head_addr, "n0")
        self.head = await dial(self.head_addr, purpose="head", peer_node="n0")
        self.head.set_push_handler(self._on_head_push)
        reply = await self.head.call(
            "register",
            role="agent",
            client_id=self.node_id,
            addr=self.serve_addr,
            resources=self.resources,
            labels=self.labels,
            pid=os.getpid(),
            lease_blocks=self.granter.block_snapshot(),
            metrics_addr=self.metrics_addr,
        )
        self._adopt_register_reply(reply)
        # readiness marker for the cluster fixture
        ready = os.path.join(self.node_dir, "agent.ready")
        with open(ready + ".tmp", "w") as f:
            f.write(f"{os.getpid()}\n{self.serve_addr}\n")
        os.replace(ready + ".tmp", ready)  # atomic: never visible half-written
        # preemption warning: spot/preemptible VMs deliver SIGTERM tens of
        # seconds before the kill — convert it into a head-driven drain
        # (zero-loss evacuation) instead of dying by heartbeat timeout
        try:
            loop = asyncio.get_running_loop()
            loop.add_signal_handler(
                signal.SIGTERM, lambda: spawn_bg(self._self_drain())
            )
        except (NotImplementedError, RuntimeError):
            pass  # non-unix loop: preemption warnings degrade to hard kills
        hb = spawn_bg(self._heartbeat_loop())
        head_watch = spawn_bg(self._watch_head())
        log_ship = spawn_bg(self._log_ship_loop())
        await self._shutdown.wait()
        hb.cancel()
        head_watch.cancel()
        log_ship.cancel()
        self._teardown()

    def _adopt_register_reply(self, reply: dict) -> None:
        """Take the head-minted incarnation (the authority token every
        stamped RPC carries), the head epoch and standby list (HA plane),
        and any active runtime chaos schedule."""
        if reply.get("incarnation") is not None:
            self.incarnation = reply["incarnation"]
        ep = reply.get("head_epoch")
        if ep is not None:
            self.head_epoch = max(self.head_epoch, int(ep))
        if reply.get("standbys"):
            self._head_ring.merge(reply["standbys"])
        if reply.get("net_chaos"):
            try:
                netchaos.install(
                    reply["net_chaos"], self.node_id,
                    epoch=reply.get("net_chaos_epoch"),
                )
            except (ValueError, TypeError):
                pass

    async def _fence_reset(self):
        """Zombie-free heal: this incarnation was declared dead while we
        were partitioned.  Everything minted under it must die BEFORE the
        node rejoins — workers (their tasks would complete duplicate side
        effects), delegated lease blocks and local grants (granting from
        them mints more zombies), the shm namespace (the head already
        declared those object copies lost), and the delta-sync state.  Then
        drop the incarnation token and force a re-register, which the head
        accepts as a FRESH node at a bumped incarnation."""
        if self._fencing:
            return
        self._fencing = True
        try:
            from ..util import flightrec
            from .ownership import warn_ratelimited

            if flightrec.REC is not None:
                flightrec.REC.record(
                    "fence", "fence_reset",
                    incarnation=self.incarnation, n_workers=len(self.procs),
                )
            warn_ratelimited(
                "agent-fenced",
                f"node {self.node_id} incarnation {self.incarnation} was "
                f"declared dead (partition?): purging workers/leases/shm "
                f"and rejoining fresh",
            )
            for wid in list(self.procs):
                self._kill_worker(wid)
            deadline = asyncio.get_running_loop().time() + 10.0
            while self.procs and asyncio.get_running_loop().time() < deadline:
                for wid, proc in list(self.procs.items()):
                    if proc.poll() is not None:
                        del self.procs[wid]
                        if self.chip_alloc is not None:
                            self.chip_alloc.release(
                                self._worker_chips.pop(wid, None)
                            )
                if self.procs:
                    await asyncio.sleep(0.05)
            # every local grant and delegated block dies with the verdict
            self.granter = LeaseGranter(self.node_id)
            self._worker_chips.clear()
            # the node's object copies were declared lost: sweep the
            # namespace so nothing serves stale reads out of it
            import shutil

            for name, mm in list(self._pull_maps.items()):
                try:
                    mm.close()
                except (BufferError, ValueError, OSError):
                    pass
                self._pull_maps.pop(name, None)
            shutil.rmtree(self.shm_ns_dir, ignore_errors=True)
            os.makedirs(self.shm_ns_dir, exist_ok=True)
            self.reporter.reset()
            self.incarnation = None  # rejoin as a fresh incarnation
            if self.head is not None and not self.head.closed:
                # drop the stale-stamped connection; _watch_head re-registers
                await self.head.close()
        finally:
            self._fencing = False

    async def _self_drain(self):
        """SIGTERM landed (preemption warning / graceful stop request): ask
        the head to drain this node instead of dying by heartbeat timeout.
        The agent keeps serving (object pulls, heartbeats, lease releases)
        through the evacuation window; the head's `node_shutdown` notify ends
        it.  A second SIGTERM — or an unreachable head — shuts down now."""
        if self._draining:
            self._shutdown.set()  # impatient supervisor: obey immediately
            return
        self._draining = True
        try:
            await self.head.call(
                "drain_node", node_id=self.node_id, reason="preemption",
                timeout=5,
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            # no head to evacuate through: the warning buys nothing — exit
            # so workers die with the process group, not mid-RPC later
            self._shutdown.set()

    async def _watch_head(self):
        """Watch the head connection, redialing through restarts (a restarted
        head re-adopts this node from its snapshot).  Tear down only when the
        head stays unreachable past the grace window — the reference raylet's
        GCS-unreachable exit."""
        grace = (
            self.config.health_check_period_s * self.config.health_check_failure_threshold
            + 10.0
        )
        down_since = None
        while not self._shutdown.is_set():
            await asyncio.sleep(0.2)
            if not self.head.closed:
                down_since = None
                continue
            now = asyncio.get_running_loop().time()
            if down_since is None:
                down_since = now
            elif now - down_since > grace:
                self._shutdown.set()
                return
            conn = None
            try:
                from ..util.aio import dial  # lazy: util/__init__ → core

                # walk the head ring: after a failover the successor standby
                # answers on a different addr than the dead active
                addr = self._head_ring.current or self.head_addr
                netchaos.register_addr(addr, "n0")
                conn = await dial(
                    addr, purpose="head",
                    timeout=self.config.dial_timeout_s, peer_node="n0",
                )
                conn.set_push_handler(self._on_head_push)
                fields = {
                    # local grants kept flowing while the head was down; the
                    # block snapshot lets the restarted head re-adopt the
                    # delegation (and reconcile grants made in the outage)
                    "lease_blocks": self.granter.block_snapshot(),
                    "metrics_addr": self.metrics_addr,
                }
                if self.incarnation is not None:
                    # our token travels with the re-register: a head that
                    # declared this incarnation dead refuses with
                    # FencedError instead of silently re-adopting a zombie
                    fields["ninc"] = self.incarnation
                reg_reply = await conn.call(
                    "register",
                    role="agent",
                    client_id=self.node_id,
                    addr=self.serve_addr,
                    resources=self.resources,
                    labels=self.labels,
                    pid=os.getpid(),
                    timeout=5,
                    **fields,
                )
                offered = reg_reply.get("head_epoch")
                if (offered is not None and self.head_epoch
                        and int(offered) < self.head_epoch):
                    # a resurrected OLD head answered here: re-anchoring to
                    # it would split the cluster — rotate toward the
                    # successor instead (the zombie demotes on its own once
                    # it sees the higher epoch on stamped traffic)
                    from ..util import flightrec

                    if flightrec.REC is not None:
                        flightrec.REC.record(
                            "ha", "ha_fence_old_head",
                            method="register", offered=int(offered),
                            known=self.head_epoch,
                        )
                    await conn.close()
                    self._head_ring.rotate()
                    continue
                # the restarted head has no delta state for this node: the
                # next node_sync must be a full resync.  Reset BEFORE
                # adopting the connection so a failure here still closes
                # `conn` below instead of stranding a half-registered head.
                self.reporter.reset()
                self._adopt_register_reply(reg_reply)
                self.head = conn
                # _watch_head is the sole writer of head_addr; `addr` is the
                # ring slot THIS register round-trip succeeded against, so a
                # concurrent ring merge must not retarget the assignment:
                # ca-lint: ignore[async-await-race]
                self.head_addr = addr
                down_since = None
            except asyncio.CancelledError:
                if conn is not None:
                    await conn.close()
                raise  # agent shutdown beats head-watching
            except FencedError:
                # death verdict discovered at re-register (partition healed):
                # purge everything minted under the dead incarnation, then
                # let the next loop iteration rejoin fresh
                if conn is not None:
                    await conn.close()
                await self._fence_reset()
                down_since = asyncio.get_running_loop().time()  # fresh grace
            except Exception:
                if conn is not None:
                    # registering failed: a leaked half-open socket per retry
                    # tick adds up fast while the head flaps
                    await conn.close()
                # this candidate is dead or refusing: try the next head in
                # the ring on the following attempt (single-head rings are a
                # no-op rotate)
                self._head_ring.rotate()
                # jittered: N agents redialing a restarted head must not
                # arrive as one synchronized thundering herd
                await asyncio.sleep(0.3 + random.random() * 0.4)

    def _teardown(self):
        import shutil

        if self._http_server is not None:
            try:
                self._http_server.close()
            except Exception:
                pass
        for wid in list(self.procs):
            self._kill_worker(wid)
        shutil.rmtree(self.shm_ns_dir, ignore_errors=True)

    def main(self):
        loop = asyncio.new_event_loop()
        if hasattr(asyncio, "eager_task_factory"):
            loop.set_task_factory(asyncio.eager_task_factory)
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._amain())
        except (KeyboardInterrupt, SystemExit):
            self._teardown()


def main():
    NodeAgent().main()


if __name__ == "__main__":
    main()
