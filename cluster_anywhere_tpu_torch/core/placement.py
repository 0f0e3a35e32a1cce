"""Placement groups (analogue of python/ray/util/placement_group.py).

A placement group atomically reserves a list of resource bundles; tasks and
actors scheduled into a bundle consume from that reservation.  Strategies
(PACK/SPREAD/STRICT_PACK/STRICT_SPREAD) control node placement; on the
current single-node milestone they are recorded and validated but equivalent.

A PG whose demand exceeds the cluster's *total* capacity errors immediately
(truly infeasible); one that merely exceeds currently-free resources is
PENDING and created FIFO as resources release — ready()/wait() block on that
(mirrors GcsPlacementGroupManager's PENDING->CREATED lifecycle).
"""

from __future__ import annotations

import asyncio

from typing import Dict, List, Optional

from .errors import PlacementGroupError
from .ids import PlacementGroupID
from .worker import global_worker

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self.bundles = bundles

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return self.bundles

    def ready(self):
        """Returns an ObjectRef that resolves (to True) once the head has
        reserved all bundles — immediately for a created PG, later for a
        pending one; errors if the PG is removed while pending."""
        w = global_worker()
        ref = w.new_owned_ref()
        oid = ref.id
        pg_hex = self.id.hex()

        async def _wait():
            try:
                await w.head.call("pg_wait", pg_id=pg_hex)
                w.memory_store.put_value(oid, True)
            except asyncio.CancelledError:
                # loop shutdown: unblock ref waiters, then stay cancelled
                w.memory_store.put_error(oid, ConnectionError("pg_wait cancelled"))
                raise
            except BaseException as e:  # noqa: BLE001 - propagate via the ref
                w.memory_store.put_error(oid, e)

        asyncio.run_coroutine_threadsafe(_wait(), w.loop)
        return ref

    def wait(self, timeout_seconds: float = 30) -> bool:
        try:
            r = global_worker().head_call(
                "pg_wait", pg_id=self.id.hex(), wait_timeout=timeout_seconds
            )
        except PlacementGroupError:
            return False
        return bool(r.get("ready"))

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles))


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
    bundle_label_selectors: Optional[List[Optional[dict]]] = None,
) -> PlacementGroup:
    """`bundle_label_selectors` optionally gives one label selector per bundle
    (dict of label key -> In/NotIn/Exists/DoesNotExist or bare string); that
    bundle is then only placed on nodes matching it — e.g. pin a bundle to a
    node labelled via CA_NODE_LABELS {"rack": "a"} with {"rack": "a"}."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    for b in bundles:
        if any(v < 0 for v in b.values()):
            raise ValueError("bundle resources must be non-negative")
    wire_labels = None
    if bundle_label_selectors is not None:
        from .scheduling_strategies import selector_wire

        if len(bundle_label_selectors) != len(bundles):
            raise ValueError("bundle_label_selectors must match bundles 1:1")
        wire_labels = [selector_wire(s) for s in bundle_label_selectors]
    pg_id = PlacementGroupID.from_random()
    w = global_worker()
    w.head_call(
        "create_pg",
        pg_id=pg_id.hex(),
        bundles=[{k: float(v) for k, v in b.items()} for b in bundles],
        strategy=strategy,
        bundle_labels=wire_labels,
    )
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup):
    global_worker().head_call("remove_pg", pg_id=pg.id.hex())


def placement_group_table() -> List[dict]:
    return global_worker().head_call("list_pgs")["pgs"]
