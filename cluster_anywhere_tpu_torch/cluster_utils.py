"""In-process multi-node cluster fixture (analogue of
python/ray/cluster_utils.py:135 `Cluster`).

Starts a head process plus any number of node-agent processes on this host,
each with its own shm namespace and resource pool, talking to the head over
TCP exactly as real remote hosts would.  This is how all distributed behavior
(scheduling spillover, node-to-node object transfer, node death, actor
restart across nodes) is tested without real multi-host hardware — the same
strategy the reference uses (cluster_utils.py:202,286 add_node/remove_node).

Usage:
    cluster = Cluster(head_resources={"CPU": 1})
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.connect()          # ca.init(address=...) as the driver
    ...
    cluster.remove_node(nid)   # SIGKILL the agent: simulates node power-off
    cluster.shutdown()
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .core.config import CAConfig


class Cluster:
    def __init__(
        self,
        head_resources: Optional[Dict[str, float]] = None,
        config: Optional[CAConfig] = None,
        connect: bool = False,
    ):
        self.config = config or CAConfig()
        root = self.config.session_dir_root
        os.makedirs(root, exist_ok=True)
        self.session_dir = os.path.join(
            root, f"session_{int(time.time() * 1000)}_{os.getpid()}"
        )
        os.makedirs(self.session_dir, exist_ok=True)
        self._node_seq = 0
        self._agents: Dict[str, subprocess.Popen] = {}
        self._standbys: Dict[int, subprocess.Popen] = {}  # rank -> proc
        self._connected = False
        resources = dict(head_resources or {"CPU": 0.0})
        resources.setdefault("memory", float(self.config.object_store_memory))
        self._head_resources = resources
        self._spawn_head()
        self.head_tcp = open(os.path.join(self.session_dir, "head.addr")).read().strip()
        if connect:
            self.connect()

    def _spawn_head(self):
        env = self._base_env()
        env["CA_RESOURCES"] = json.dumps(self._head_resources)
        env["CA_HEAD_PERSIST"] = "1"  # fixture controls teardown, not drivers
        ready = os.path.join(self.session_dir, "head.ready")
        try:
            os.unlink(ready)
        except FileNotFoundError:
            pass
        head_log = open(os.path.join(self.session_dir, "head.log"), "ab")
        self._head_proc = subprocess.Popen(
            [sys.executable, "-m", "cluster_anywhere_tpu_torch.core.head"],
            env=env,
            stdout=head_log,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        head_log.close()
        self._wait_for_file(ready, 30)

    # -------------------------------------------------------- fault injection
    def kill_head(self):
        """SIGKILL the head (control-plane crash; state survives in the
        snapshot, data plane keeps running)."""
        try:
            os.kill(self._head_proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self._head_proc.wait(timeout=10)

    def restart_head(self):
        """Start a fresh head process for the same session: it loads the
        snapshot and re-adopts live workers, agents, and drivers."""
        self._spawn_head()

    # ---------------------------------------------------------------- HA plane
    def add_standby(self, rank: int = 0, env_overrides: Optional[Dict[str, str]] = None) -> str:
        """Start a warm-standby head at `rank` (promotion order: rank 0
        self-promotes first).  It subscribes to the active head's replication
        stream and holds the full registry in memory; returns its TCP addr."""
        env = self._base_env()
        env["CA_RESOURCES"] = json.dumps(self._head_resources)
        env["CA_HEAD_PERSIST"] = "1"
        env["CA_HEAD_STANDBY"] = "1"
        env["CA_HEAD_STANDBY_RANK"] = str(rank)
        env["CA_HEAD_ADDR"] = self.head_ring()
        if env_overrides:
            env.update(env_overrides)
        ready = os.path.join(self.session_dir, f"head.standby{rank}.ready")
        try:
            os.unlink(ready)
        except FileNotFoundError:
            pass
        log = open(
            os.path.join(self.session_dir, f"head.standby{rank}.log"), "ab"
        )
        proc = subprocess.Popen(
            [sys.executable, "-m", "cluster_anywhere_tpu_torch.core.head"],
            env=env,
            stdout=log,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        log.close()
        self._standbys[rank] = proc
        self._wait_for_file(ready, 30)
        return self.standby_addr(rank)

    def standby_addr(self, rank: int = 0) -> str:
        return open(
            os.path.join(self.session_dir, f"head.standby{rank}.addr")
        ).read().strip()

    def head_ring(self) -> str:
        """Comma-separated head address list: active first, then standbys in
        rank order — the CA_HEAD_ADDR / init(address=...) failover spec."""
        addrs = [self.head_tcp]
        for rank in sorted(self._standbys):
            try:
                a = self.standby_addr(rank)
            except FileNotFoundError:
                continue
            if a and a not in addrs:
                addrs.append(a)
        return ",".join(addrs)

    def kill_standby(self, rank: int = 0):
        proc = self._standbys.pop(rank, None)
        if proc is None:
            raise ValueError(f"no standby at rank {rank}")
        try:
            os.kill(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=10)

    def promote_standby(self, rank: int = 0, timeout: float = 10) -> dict:
        """Explicitly promote the rank's standby (the `ca head promote`
        path); returns its ha_status afterwards.  With ha_auto_promote on,
        standbys promote themselves after the grace window and this is only
        needed for deterministic tests / manual failover."""
        from .core.protocol import BlockingClient

        c = BlockingClient(self.standby_addr(rank))
        c._sock.settimeout(timeout)
        try:
            return c.call("head_promote")
        finally:
            c.close()

    def wait_promoted(self, timeout: float = 30) -> str:
        """Block until a standby has claimed head.addr (promotion rewrites
        it); adopts the promoted process as the cluster's head proc and
        returns the new active addr."""
        deadline = time.monotonic() + timeout
        old = self.head_tcp
        addr_path = os.path.join(self.session_dir, "head.addr")
        while time.monotonic() < deadline:
            try:
                cur = open(addr_path).read().strip()
            except FileNotFoundError:
                cur = ""
            if cur and cur != old:
                self.head_tcp = cur
                for rank, proc in list(self._standbys.items()):
                    try:
                        if self.standby_addr(rank) == cur:
                            self._head_proc = self._standbys.pop(rank)
                    except FileNotFoundError:
                        pass
                return cur
            time.sleep(0.05)
        raise TimeoutError("no standby promoted within the window")

    def _base_env(self) -> dict:
        env = dict(os.environ)
        env["CA_SESSION_DIR"] = self.session_dir
        env["CA_CONFIG_JSON"] = self.config.to_json()
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        return env

    @staticmethod
    def _wait_for_file(path: str, timeout: float):
        deadline = time.monotonic() + timeout
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"timed out waiting for {path}")
            time.sleep(0.01)

    # ------------------------------------------------------------------ nodes
    def add_node(
        self,
        num_cpus: float = 4,
        num_gpus: float = 0,
        resources: Optional[Dict[str, float]] = None,
        node_id: Optional[str] = None,
        labels: Optional[Dict[str, str]] = None,
        env_overrides: Optional[Dict[str, str]] = None,
    ) -> str:
        """Start a node-agent process and wait for it to join the cluster.
        `labels` become the node's scheduling labels; `env_overrides` lets a
        test set e.g. CUDA_VISIBLE_DEVICES on the agent.  `num_gpus` declares
        the node's `GPU` resource: its agent pins GPU-pool workers to the
        cards (all of them share one card when the node declares one) and
        gives CPU-pool workers CUDA_VISIBLE_DEVICES=""."""
        self._node_seq += 1
        nid = node_id or f"node{self._node_seq}"
        shape: Dict[str, float] = {"CPU": float(num_cpus)}
        if num_gpus:
            shape["GPU"] = float(num_gpus)
        shape.setdefault("memory", float(self.config.object_store_memory))
        if resources:
            shape.update({k: float(v) for k, v in resources.items()})
        env = self._base_env()
        env["CA_HEAD_ADDR"] = self.head_ring()  # active first, then standbys
        env["CA_NODE_ID"] = nid
        env["CA_NODE_RESOURCES"] = json.dumps(shape)
        if labels:
            env["CA_NODE_LABELS"] = json.dumps(labels)
        if env_overrides:
            env.update(env_overrides)
        node_dir = os.path.join(self.session_dir, "nodes", nid)
        os.makedirs(node_dir, exist_ok=True)
        agent_log = open(os.path.join(node_dir, "agent.log"), "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "cluster_anywhere_tpu_torch.core.nodeagent"],
            env=env,
            stdout=agent_log,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        agent_log.close()
        self._agents[nid] = proc
        self._wait_for_file(os.path.join(node_dir, "agent.ready"), 30)
        return nid

    def remove_node(self, node_id: str, graceful: bool = False):
        """Kill a node.  Default: SIGKILL the agent (simulated power-off;
        the head detects the death via connection drop / missed heartbeats
        and fences the node's workers).  graceful=True sends SIGTERM — the
        preemption warning — and the agent SELF-DRAINS through the head
        (evacuation, then a clean exit), so the wait below can take up to
        the drain deadline when the node is busy."""
        proc = self._agents.pop(node_id, None)
        if proc is None:
            raise ValueError(f"unknown node {node_id!r}")
        try:
            os.kill(proc.pid, signal.SIGTERM if graceful else signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=(self.config.drain_deadline_s + 15) if graceful else 10)

    def nodes(self) -> List[dict]:
        from .core import api

        return api.nodes()

    def wait_for_nodes(self, n: int, timeout: float = 30) -> None:
        """Block until `n` nodes (including the head node) are alive."""
        from .core.worker import global_worker

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = [x for x in self.nodes() if x["alive"]]
            if len(alive) >= n:
                return
            time.sleep(0.05)
        raise TimeoutError(f"cluster did not reach {n} alive nodes")

    # ----------------------------------------------------------------- driver
    def connect(self) -> dict:
        from .core import api

        # the driver must run the SAME plane configuration as the cluster it
        # joins (e.g. owner_plane off in an A/B) — a default-config driver
        # would settle its objects owner-resident against a centralized head
        info = api.init(address=self.session_dir, config=self.config)
        self._connected = True
        return info

    def shutdown(self):
        from .core import api

        if self._connected:
            try:
                api.shutdown()
            except Exception:
                pass
            self._connected = False
        for nid in list(self._agents):
            try:
                self.remove_node(nid)
            except Exception:
                pass
        for rank in list(self._standbys):
            try:
                self.kill_standby(rank)
            except Exception:
                pass
        if self._head_proc.poll() is None:
            try:
                os.kill(self._head_proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self._head_proc.wait(timeout=10)
        import shutil

        shutil.rmtree(
            os.path.join("/dev/shm", os.path.basename(self.session_dir)),
            ignore_errors=True,
        )
        shutil.rmtree(self.session_dir, ignore_errors=True)
