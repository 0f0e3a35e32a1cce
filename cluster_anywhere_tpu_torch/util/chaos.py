"""Fault-injection utilities (analogue of the reference's killer actors,
python/ray/_private/test_utils.py:1512 ResourceKillerActor/WorkerKillerActor,
and the RPC chaos env described in src/ray/rpc/rpc_chaos.h).

Four layers:
- RPC chaos: set CA_TESTING_RPC_FAILURE="method=N,method2=M" (or the
  testing_rpc_failure config field) before init(); the first N sends of each
  named method raise ConnectionError in the sending process.  Deterministic —
  the standard way to exercise retry paths.  CA_TESTING_RPC_DELAY="method=MS"
  injects per-method latency instead (straggler RPCs).
- Network chaos (core/netchaos.py): per-link blackhole/delay/flap from a
  seeded schedule — the failure class RPC chaos cannot express (frames
  vanish, connections hang).  NetworkPartition below drives it at runtime
  through the head's `net_chaos` broadcast.
- WorkerKiller: kills random pool-worker processes on a cadence while a
  workload runs, from a thread in the driver (same-host process kill; the
  multi-node analogue is Cluster.remove_node).
- PreemptionSimulator: replays a spot/preemptible-VM termination against a
  node agent — SIGTERM (the cloud's warning, which the agent converts into
  a self-drain), then SIGKILL once the warning window expires (the cloud
  reclaiming the VM regardless of drain progress).
"""

from __future__ import annotations

import logging
import os
import random
import signal
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)


class WorkerKiller:
    """Kills up to `max_kills` random idle/leased pool workers, one every
    `period_s`, until stop() or the budget runs out."""

    def __init__(self, period_s: float = 0.5, max_kills: int = 5, seed: int = 0):
        self.period_s = period_s
        self.max_kills = max_kills
        self.kills = 0
        self.skipped = 0  # rounds where listing failed or the pid was gone
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _victims(self):
        from ..core.worker import global_worker

        workers = global_worker().head_call("list_workers")["workers"]
        return [
            w
            for w in workers
            if w["state"] in ("idle", "leased") and w["pid"] and w["actor_id"] is None
        ]

    def _loop(self):
        while not self._stop.is_set() and self.kills < self.max_kills:
            try:
                victims = self._victims()
            except (ConnectionError, RuntimeError, KeyError) as e:
                # head unreachable / worker not initialized: skip this round,
                # loudly — a killer that silently stops killing invalidates
                # the chaos test it is supposed to drive
                self.skipped += 1
                log.warning("WorkerKiller: victim listing failed (%r), skipping", e)
                self._stop.wait(self.period_s)
                continue
            if victims:
                victim = self._rng.choice(victims)
                try:
                    os.kill(victim["pid"], signal.SIGKILL)
                except ProcessLookupError:
                    # victim exited between listing and kill: not a kill,
                    # try again next round
                    self.skipped += 1
                    log.info(
                        "WorkerKiller: pid %s already gone, skipped", victim["pid"]
                    )
                else:
                    self.kills += 1
            self._stop.wait(self.period_s)

    def start(self) -> "WorkerKiller":
        self._thread = threading.Thread(target=self._loop, daemon=True, name="ca-killer")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class NetworkPartition:
    """Partition two nodes for a scheduled window, cluster-wide.

    start() broadcasts a seeded blackhole schedule through the head's
    `net_chaos` RPC: every process (head, agents, workers, this driver)
    installs the same spec against the same epoch, so both sides of the
    link drop frames for `duration_s` and then HEAL BY SCHEDULE — a `clear`
    broadcast could never reach the processes it partitioned, which is why
    the heal must be pre-agreed.  Deterministic: the same seed + duration
    yields the same injected event sequence (log the seed on test failure
    and the run replays)."""

    def __init__(self, node_a: str, node_b: str = "n0",
                 duration_s: float = 8.0, seed: int = 0,
                 start_after_s: float = 0.2):
        self.node_a = node_a
        self.node_b = node_b
        self.duration_s = duration_s
        self.seed = seed
        self.start_after_s = start_after_s
        self.epoch: Optional[float] = None

    @property
    def spec(self) -> str:
        return (
            f"seed={self.seed};{self.node_a}<>{self.node_b}:"
            f"blackhole@{self.start_after_s}+{self.duration_s}"
        )

    def start(self) -> "NetworkPartition":
        from ..core.worker import global_worker

        self.epoch = time.time()
        global_worker().head_call(
            "net_chaos", spec=self.spec, epoch=self.epoch
        )
        return self

    def heals_at(self) -> float:
        """Wall-clock time the schedule re-opens the link."""
        if self.epoch is None:
            raise RuntimeError("partition not started")
        return self.epoch + self.start_after_s + self.duration_s

    def wait_heal(self, grace_s: float = 0.5) -> None:
        """Sleep until just past the scheduled heal."""
        time.sleep(max(0.0, self.heals_at() - time.time()) + grace_s)

    def clear(self) -> None:
        """Broadcast an empty spec (reachable processes only — use after
        the scheduled heal to drop the bookkeeping everywhere)."""
        from ..core.worker import global_worker

        global_worker().head_call("net_chaos", spec="")


class PreemptionSimulator:
    """Replay a spot/preemptible-VM termination against one node agent
    (same-host processes only): SIGTERM now — the cloud's advance warning,
    which the agent turns into a head-driven self-drain — then SIGKILL after
    `kill_after_s` if the agent is still up, the cloud reclaiming the VM
    whether or not the drain finished.  A well-tuned drain deadline finishes
    the evacuation first, so the SIGKILL usually finds the process gone."""

    def __init__(self, node_id: str, kill_after_s: float = 30.0):
        self.node_id = node_id
        self.kill_after_s = kill_after_s
        self.sigterm_at: Optional[float] = None
        self.sigkilled = False  # the warning window expired before exit
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _agent_pid(self) -> int:
        from ..core.worker import global_worker

        for n in global_worker().head_call("nodes")["nodes"]:
            if n["node_id"] == self.node_id:
                if not n.get("pid"):
                    raise RuntimeError(f"node {self.node_id} has no known agent pid")
                return n["pid"]
        raise ValueError(f"unknown node {self.node_id!r}")

    def _loop(self, pid: int):
        if self._stop.wait(self.kill_after_s):
            return  # cancelled: the preemption never completed
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass  # drained and exited inside the window: the good ending
        else:
            self.sigkilled = True
            log.warning(
                "PreemptionSimulator: node %s still up after %.1fs, SIGKILLed",
                self.node_id, self.kill_after_s,
            )

    def start(self) -> "PreemptionSimulator":
        pid = self._agent_pid()
        os.kill(pid, signal.SIGTERM)  # the preemption warning
        self.sigterm_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._loop, args=(pid,), daemon=True, name="ca-preempt"
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
