"""Declarative autoscaler (analogue of the reference's autoscaler v2 —
python/ray/autoscaler/v2/autoscaler.py Autoscaler +
instance_manager/reconciler.py Reconciler + scheduler.py bin-packing).

Loop: read the head's autoscaler state (pending demand shapes + utilization)
-> bin-pack unmet demand onto node types -> launch; terminate nodes idle
beyond the timeout. `step()` is a single reconcile pass (tests drive it
directly); `Autoscaler.start()` runs it on a background thread.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..core.worker import global_worker
from .provider import NodeInfo, NodeProvider, NodeType


@dataclass
class AutoscalerConfig:
    node_types: List[NodeType] = None
    idle_timeout_s: float = 30.0
    interval_s: float = 1.0
    max_total_nodes: int = 8

    def __post_init__(self):
        if self.node_types is None:
            self.node_types = [NodeType("cpu2", {"CPU": 2.0})]


def _fits(avail: Dict[str, float], shape: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in shape.items())


def _take(avail: Dict[str, float], shape: Dict[str, float]):
    for k, v in shape.items():
        avail[k] = avail.get(k, 0.0) - v


class Reconciler:
    def __init__(self, provider: NodeProvider, config: AutoscalerConfig, state_fn=None):
        self.provider = provider
        self.config = config
        # state_fn() -> the head's autoscaler_state dict; injectable so tests
        # drive step() through synthetic cluster states without a live head
        self._state_fn = state_fn or (lambda: global_worker().head_call("autoscaler_state"))
        self._idle_since: Optional[float] = None
        self.requested_min: Dict[str, float] = {}

    def request_resources(self, shape: Dict[str, float]):
        """SDK hint (reference autoscaler/sdk/request_resources): keep at
        least this much capacity regardless of observed demand."""
        self.requested_min = dict(shape)

    def step(self) -> Dict[str, int]:
        """One reconcile pass. Returns {'launched': n, 'terminated': m}."""
        state = self._state_fn()
        launched = self._scale_up(state)
        terminated = self._scale_down(state) if not launched else 0
        return {"launched": launched, "terminated": terminated}

    # ------------------------------------------------------------- scale up
    def _scale_up(self, state) -> int:
        demands = [dict(d) for d in state["pending_demands"]]
        # demand that the current free capacity cannot serve
        free = dict(state["available"])
        unmet = []
        for d in demands:
            if _fits(free, d):
                _take(free, d)
            else:
                unmet.append(d)
        # bin-pack unmet demand onto new nodes, smallest node type first
        current = self.provider.non_terminated_nodes()
        count_by_type = {}
        for n in current:
            count_by_type[n.node_type] = count_by_type.get(n.node_type, 0) + 1
        to_launch: List[NodeType] = []
        packing: List[Dict[str, float]] = []

        def can_launch(nt: NodeType) -> bool:
            used = count_by_type.get(nt.name, 0) + sum(
                1 for t in to_launch if t.name == nt.name
            )
            return (
                used < nt.max_nodes
                and len(current) + len(to_launch) < self.config.max_total_nodes
            )

        for d in unmet:
            placed = False
            for cap in packing:  # try already-planned nodes
                if _fits(cap, d):
                    _take(cap, d)
                    placed = True
                    break
            if placed:
                continue
            for nt in sorted(self.config.node_types, key=lambda t: sum(t.resources.values())):
                if not can_launch(nt):
                    continue
                if _fits(dict(nt.resources), d):
                    cap = dict(nt.resources)
                    _take(cap, d)
                    packing.append(cap)
                    to_launch.append(nt)
                    placed = True
                    break
            # unplaceable demand (too big for any node type): skip
        if self.requested_min:
            # the requested minimum is an AGGREGATE capacity floor, not a
            # single-node shape: launch nodes until free + planned covers it
            floor_free = dict(state["available"])
            for nt in to_launch:
                self._give(floor_free, nt.resources)
            guard = 0
            while not _fits(floor_free, self.requested_min) and guard < 64:
                guard += 1
                deficit = {
                    k: v - floor_free.get(k, 0.0)
                    for k, v in self.requested_min.items()
                    if v - floor_free.get(k, 0.0) > 1e-9
                }
                chosen = None
                for nt in sorted(
                    self.config.node_types, key=lambda t: sum(t.resources.values())
                ):
                    if can_launch(nt) and any(nt.resources.get(k, 0.0) > 0 for k in deficit):
                        chosen = nt
                        break
                if chosen is None:
                    break  # caps reached or no type contributes
                to_launch.append(chosen)
                self._give(floor_free, chosen.resources)
        for nt in to_launch:
            self.provider.create_node(nt)
        return len(to_launch)

    @staticmethod
    def _give(avail: Dict[str, float], shape: Dict[str, float]):
        for k, v in shape.items():
            avail[k] = avail.get(k, 0.0) + v

    # ----------------------------------------------------------- scale down
    def _scale_down(self, state) -> int:
        nodes = self.provider.non_terminated_nodes()
        if not nodes:
            self._idle_since = None
            return 0
        busy = state["pending_demands"] or self._capacity_in_use(state)
        if busy:
            self._idle_since = None
            return 0
        if self._idle_since is None:
            self._idle_since = time.monotonic()
            return 0
        if time.monotonic() - self._idle_since < self.config.idle_timeout_s:
            return 0
        # terminate provider nodes while staying above any requested minimum
        terminated = 0
        for node in sorted(nodes, key=lambda n: n.created_at):
            remaining_total = dict(state["total"])
            for k, v in node.resources.items():
                remaining_total[k] = remaining_total.get(k, 0.0) - v
            if self.requested_min and not _fits(remaining_total, self.requested_min):
                continue
            self.provider.terminate_node(node)
            state["total"] = remaining_total
            terminated += 1
        if terminated:
            self._idle_since = None
        return terminated

    def _capacity_in_use(self, state) -> bool:
        """Provider-node capacity is in use when cluster-wide used resources
        exceed what the base (non-provider) capacity could absorb."""
        base_total = dict(state["total"])
        for n in self.provider.non_terminated_nodes():
            for k, v in n.resources.items():
                base_total[k] = base_total.get(k, 0.0) - v
        for k, total in state["total"].items():
            used = total - state["available"].get(k, 0.0)
            if used - 1e-9 > base_total.get(k, 0.0):
                return True
        return False


class Autoscaler:
    """Background reconcile loop (monitor.py analogue)."""

    def __init__(self, provider: NodeProvider, config: Optional[AutoscalerConfig] = None):
        self.config = config or AutoscalerConfig()
        self.reconciler = Reconciler(provider, self.config)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True, name="ca-autoscaler")
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.reconciler.step()
            except Exception:
                pass
            self._stop.wait(self.config.interval_s)

    def request_resources(self, shape: Dict[str, float]):
        self.reconciler.request_resources(shape)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
