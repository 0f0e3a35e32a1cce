"""Node providers (analogue of the reference's
python/ray/autoscaler/node_provider.py NodeProvider + the fake_multi_node
local provider used in its tests).

A "node" contributes a fixed resource shape to the cluster. The
LocalNodeProvider launches real worker processes that register with the head
(the in-process analogue of launching a VM) and credits their capacity via
the head's update_resources RPC.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class NodeType:
    name: str
    resources: Dict[str, float]
    max_nodes: int = 4
    labels: Optional[Dict[str, str]] = None  # scheduling labels for launched nodes


@dataclass
class NodeInfo:
    node_id: str
    node_type: str
    state: str = "running"  # launching | running | terminated
    created_at: float = field(default_factory=time.monotonic)
    resources: Dict[str, float] = field(default_factory=dict)
    handle: Any = None  # provider-private


class NodeProvider:
    def create_node(self, node_type: NodeType) -> NodeInfo:
        raise NotImplementedError

    def terminate_node(self, node: NodeInfo) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[NodeInfo]:
        raise NotImplementedError


def _drain_at_head(w, node_id: str, reason: str = "idle") -> bool:
    """Drain-then-kill, step one: ask the head to drain `node_id` (recall
    lease blocks, evacuate actors and sole-copy objects, let running tasks
    finish) and wait until the node reaches `drained`/`dead` — so provider
    termination never strands in-flight work.  Returns True once the node is
    out of the cluster; False when it never was a head node (LocalNodeProvider
    capacity credits), the head is unreachable, or the window expired (the
    caller falls back to the hard kill — exactly the old behavior)."""
    try:
        r = w.head_call("drain_node", node_id=node_id, reason=reason, timeout=5)
    except Exception:
        return False
    if r.get("state") in ("drained", "dead"):
        return True
    deadline = time.monotonic() + float(w.config.drain_deadline_s) + 10.0
    errors = 0
    while time.monotonic() < deadline:
        try:
            for n in w.head_call("nodes", timeout=5)["nodes"]:
                if n["node_id"] == node_id:
                    if n.get("state") in ("drained", "dead"):
                        return True
                    break
            else:
                return True  # gone from the table entirely
            errors = 0
        except Exception:
            # one dropped/slow poll must not abort a healthy mid-flight
            # drain into a hard kill; only a head that stays unreachable
            # ends the wait early
            errors += 1
            if errors >= 10:
                return False
        time.sleep(0.1)
    return False


class LocalNodeProvider(NodeProvider):
    """Launches worker processes against the connected cluster. Each "node"
    is `workers_per_node` pool worker processes plus a capacity credit."""

    def __init__(self, workers_per_node: Optional[int] = None):
        from ..core.worker import global_worker

        self.w = global_worker()
        self.nodes: Dict[str, NodeInfo] = {}
        self.workers_per_node = workers_per_node

    def _spawn_worker(self, node_id: str, index: int) -> subprocess.Popen:
        w = self.w
        wid = f"ext-{node_id}-{index}"
        addr = os.path.join(w.session_dir, f"{wid}.sock")
        env = dict(os.environ)
        env["CA_SESSION_DIR"] = w.session_dir
        env["CA_HEAD_SOCK"] = w.head_sock
        env["CA_WORKER_ID"] = wid
        env["CA_WORKER_SOCK"] = addr
        env["CA_CONFIG_JSON"] = w.config.to_json()
        # CPU workers: a GPU credit of the node type places GPU work in the
        # head's GPU pool, never on these (they join the CPU pool)
        env["CUDA_VISIBLE_DEVICES"] = ""
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        logf = open(os.path.join(w.session_dir, f"{wid}.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "cluster_anywhere_tpu_torch.core.workerproc"],
            env=env,
            stdout=logf,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        logf.close()
        return proc

    def create_node(self, node_type: NodeType) -> NodeInfo:
        node_id = uuid.uuid4().hex[:8]
        n_workers = self.workers_per_node or max(1, int(node_type.resources.get("CPU", 1)))
        procs = [self._spawn_worker(node_id, i) for i in range(n_workers)]
        self.w.head_call("update_resources", delta=dict(node_type.resources))
        info = NodeInfo(
            node_id=node_id,
            node_type=node_type.name,
            resources=dict(node_type.resources),
            handle=procs,
        )
        self.nodes[node_id] = info
        return info

    def terminate_node(self, node: NodeInfo) -> None:
        import signal

        if node.state == "terminated":
            return
        node.state = "terminated"
        # drain-then-kill: this provider's "node" is ext-worker processes on
        # the head node (no head node record to drain), so the evacuation is
        # local — debit the capacity first so nothing NEW is granted on these
        # workers, then give in-flight leases until the drain deadline to
        # finish before the kill
        if node.resources:
            delta = {k: -v for k, v in node.resources.items()}
            self.w.head_call("update_resources", delta=delta)
        prefix = f"ext-{node.node_id}-"
        deadline = time.monotonic() + float(self.w.config.drain_deadline_s)
        killed: set = set()
        while time.monotonic() < deadline:
            try:
                mine = [
                    w
                    for w in self.w.head_call("list_workers")["workers"]
                    if w["worker_id"].startswith(prefix) and w["state"] != "dead"
                ]
            except Exception:
                break  # head gone: nothing to wait for
            busy = [w for w in mine if w["state"] in ("leased", "actor", "delegated")]
            # kill IDLE workers now: each one gone is one fewer slot a new
            # lease could land on mid-wait (and then die a budgeted death —
            # these workers never get a drain pub, n0 is not draining)
            for w in mine:
                if w not in busy and w["pid"] and w["pid"] not in killed:
                    killed.add(w["pid"])
                    try:
                        os.kill(w["pid"], signal.SIGKILL)
                    except ProcessLookupError:
                        pass
            if not busy:
                break
            time.sleep(0.1)
        for p in node.handle or []:
            try:
                os.kill(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self.nodes.pop(node.node_id, None)

    def non_terminated_nodes(self) -> List[NodeInfo]:
        return [n for n in self.nodes.values() if n.state != "terminated"]


class CommandRunnerNodeProvider(NodeProvider):
    """Launches nodes by executing user-supplied COMMANDS — the seam a real
    cloud deployment plugs into (reference autoscaler/_private/
    command_runner.py SSHCommandRunner role).  The provider knows nothing
    about transport: `launch_cmd` is typically
    ``ssh {host} 'ca join --head {head_addr} --node-id {node_id}
    --resources {resources_json}'`` with ``quote_levels=2`` (the JSON
    traverses the local AND remote shell) against a pool of machines, but
    any shell command that ends with the node registering at the head
    works (tests use a local `ca join` with the default quote_levels=1).

    Template variables: {host} {node_id} {head_addr} {resources_json}
    {labels_json}.  Liveness is judged by the HEAD's node table, not the
    runner process (an ssh session dying does not mean the node died);
    terminate falls back to killing the runner when no terminate_cmd is
    given (fine for local/ssh-with-tty runners)."""

    def __init__(
        self,
        hosts: List[str],
        launch_cmd: str,
        terminate_cmd: Optional[str] = None,
        wait_s: float = 60.0,
        quote_levels: int = 1,
    ):
        """quote_levels: how many shells the JSON template values traverse —
        1 for a local command, 2 for `ssh host '...'` (the remote shell
        word-splits again, so values need one more quoting layer)."""
        from ..core.worker import global_worker

        self.w = global_worker()
        self.session_dir = self.w.session_dir
        self.head_tcp = open(os.path.join(self.session_dir, "head.addr")).read().strip()
        if not self.head_tcp:
            raise RuntimeError("head has no TCP endpoint; cannot launch remote nodes")
        self.hosts = list(hosts)
        self.launch_cmd = launch_cmd
        self.terminate_cmd = terminate_cmd
        self.wait_s = wait_s
        self.quote_levels = max(1, int(quote_levels))
        self._host_of: Dict[str, str] = {}  # node_id -> host
        self.nodes: Dict[str, NodeInfo] = {}

    def _alive_at_head(self, node_id: str) -> bool:
        for n in self.w.head_call("nodes")["nodes"]:
            if n["node_id"] == node_id:
                return n["alive"]
        return False

    def _fmt(self, template: str, host: str, node_id: str, shape, labels) -> str:
        import json
        import shlex

        def q(s: str) -> str:
            for _ in range(self.quote_levels):
                s = shlex.quote(s)
            return s

        return template.format(
            host=host,
            node_id=node_id,
            head_addr=self.head_tcp,
            resources_json=q(json.dumps(shape)),
            labels_json=q(json.dumps(labels or {})),
        )

    def create_node(self, node_type: NodeType) -> NodeInfo:
        used = set(self._host_of.values())
        free = [h for h in self.hosts if h not in used]
        if not free:
            raise RuntimeError("no free hosts in the provider pool")
        host = free[0]
        node_id = f"cr-{uuid.uuid4().hex[:8]}"
        shape = dict(node_type.resources)
        shape.setdefault("memory", float(self.w.config.object_store_memory))
        if node_type.labels and "{labels_json}" not in self.launch_cmd:
            # fail loud: silently launching without the labels would strand
            # every NodeLabelSchedulingStrategy targeting this node type
            raise ValueError(
                f"node type {node_type.name!r} has labels but launch_cmd has no "
                "{labels_json} placeholder to carry them"
            )
        cmd = self._fmt(self.launch_cmd, host, node_id, shape, node_type.labels)
        logf = open(os.path.join(self.session_dir, f"runner-{node_id}.log"), "ab")
        proc = subprocess.Popen(
            cmd, shell=True, stdout=logf, stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        logf.close()
        deadline = time.monotonic() + self.wait_s
        while not self._alive_at_head(node_id):
            if proc.poll() is not None and not self._alive_at_head(node_id):
                raise RuntimeError(
                    f"launch command exited rc={proc.returncode} before node "
                    f"{node_id} registered (see runner-{node_id}.log)"
                )
            if time.monotonic() > deadline:
                # kill the launcher before giving up: a node registering
                # AFTER the raise would be untracked live capacity on a host
                # the provider still considers free (double-booking)
                self._kill_runner(proc)
                raise RuntimeError(f"node {node_id} did not register within {self.wait_s}s")
            time.sleep(0.1)
        self._host_of[node_id] = host
        info = NodeInfo(
            node_id=node_id, node_type=node_type.name, resources=shape, handle=proc
        )
        self.nodes[node_id] = info
        return info

    @staticmethod
    def _kill_runner(proc) -> None:
        import signal

        if proc is None or proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            proc.wait(timeout=10)
        except (ProcessLookupError, subprocess.TimeoutExpired, PermissionError):
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def terminate_node(self, node: NodeInfo) -> None:
        if node.state == "terminated":
            return
        node.state = "terminated"
        host = self._host_of.pop(node.node_id, "")
        # command-runner nodes are real agent nodes (ca join): evacuate via
        # the head before running the terminate command / killing the runner
        _drain_at_head(self.w, node.node_id, reason="idle")
        if self.terminate_cmd:
            try:
                subprocess.run(
                    self._fmt(self.terminate_cmd, host, node.node_id, node.resources, None),
                    shell=True,
                    timeout=30,
                )
            except (subprocess.TimeoutExpired, OSError):
                pass  # dead host: the runner kill below is the fallback
        self._kill_runner(node.handle)
        self.nodes.pop(node.node_id, None)

    def non_terminated_nodes(self) -> List[NodeInfo]:
        alive = {
            n["node_id"]: n["alive"] for n in self.w.head_call("nodes")["nodes"]
        }
        for n in list(self.nodes.values()):
            if not alive.get(n.node_id, False):
                # head declared it dead (crash, network cut): kill the
                # runner BEFORE freeing the host slot, or a lingering agent
                # would share the host with the reconciler's relaunch
                self._kill_runner(n.handle)
                n.state = "terminated"
                self._host_of.pop(n.node_id, None)
                self.nodes.pop(n.node_id, None)
        return [n for n in self.nodes.values() if n.state != "terminated"]


class AgentNodeProvider(NodeProvider):
    """Launches REAL node-agent processes against the connected cluster —
    each autoscaled "node" is a full raylet-analogue with its own worker
    pool, shm namespace, and TCP link to the head (the in-process analogue
    of a cloud provider booting a VM; reference fake_multi_node provider).

    Scheduling spillover, per-node stores, and node-death semantics all
    behave exactly as for cluster_utils.Cluster nodes, so autoscaled
    capacity is indistinguishable from statically added nodes."""

    def __init__(self):
        import json

        from ..core.worker import global_worker

        self.w = global_worker()
        self.session_dir = self.w.session_dir
        self.head_tcp = open(os.path.join(self.session_dir, "head.addr")).read().strip()
        if not self.head_tcp:
            raise RuntimeError("head has no TCP endpoint; cannot add agent nodes")
        self.nodes: Dict[str, NodeInfo] = {}
        self._json = json

    def create_node(self, node_type: NodeType) -> NodeInfo:
        node_id = f"as-{uuid.uuid4().hex[:8]}"
        shape = dict(node_type.resources)
        shape.setdefault("memory", float(self.w.config.object_store_memory))
        env = dict(os.environ)
        env["CA_SESSION_DIR"] = self.session_dir
        env["CA_HEAD_ADDR"] = self.head_tcp
        env["CA_NODE_ID"] = node_id
        env["CA_NODE_RESOURCES"] = self._json.dumps(shape)
        if node_type.labels:
            env["CA_NODE_LABELS"] = self._json.dumps(node_type.labels)
        env["CA_CONFIG_JSON"] = self.w.config.to_json()
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        node_dir = os.path.join(self.session_dir, "nodes", node_id)
        os.makedirs(node_dir, exist_ok=True)
        logf = open(os.path.join(node_dir, "agent.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "cluster_anywhere_tpu_torch.core.nodeagent"],
            env=env,
            stdout=logf,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        logf.close()
        ready = os.path.join(node_dir, "agent.ready")
        deadline = time.monotonic() + 30
        while not os.path.exists(ready):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"agent node {node_id} failed to start")
            time.sleep(0.02)
        info = NodeInfo(
            node_id=node_id,
            node_type=node_type.name,
            resources=shape,
            handle=proc,
        )
        self.nodes[node_id] = info
        return info

    def terminate_node(self, node: NodeInfo) -> None:
        import signal

        if node.state == "terminated":
            return
        node.state = "terminated"
        proc = node.handle
        # drain-then-kill: evacuate through the head first (autoscaler
        # downscale must never strand in-flight tasks, actors, or sole-copy
        # objects).  On drain completion the head's node_shutdown notify makes
        # the agent exit on its own; the signals below are the fallback for
        # an unreachable head or a hung agent.
        drained = _drain_at_head(self.w, node.node_id, reason="idle")
        if proc is not None:
            try:
                proc.wait(timeout=10 if drained else 0.1)
            except subprocess.TimeoutExpired:
                try:
                    os.kill(proc.pid, signal.SIGTERM)
                    proc.wait(timeout=10)
                except (ProcessLookupError, subprocess.TimeoutExpired):
                    try:
                        os.kill(proc.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
        self.nodes.pop(node.node_id, None)

    def non_terminated_nodes(self) -> List[NodeInfo]:
        for n in list(self.nodes.values()):
            proc = n.handle
            if proc is not None and proc.poll() is not None:
                n.state = "terminated"  # crashed out from under us
                self.nodes.pop(n.node_id, None)
        return [n for n in self.nodes.values() if n.state != "terminated"]
