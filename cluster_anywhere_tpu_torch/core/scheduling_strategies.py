"""Scheduling strategy objects (analogue of python/ray/util/scheduling_strategies.py)."""

from __future__ import annotations

from typing import Dict, Optional, Union


class PlacementGroupSchedulingStrategy:
    def __init__(
        self,
        placement_group,
        placement_group_bundle_index: int = 0,
        placement_group_capture_child_tasks: bool = False,
    ):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


class SpreadSchedulingStrategy:
    pass


# ---------------------------------------------------------------------------
# node-label scheduling (python/ray/util/scheduling_strategies.py:135
# NodeLabelSchedulingStrategy + In/NotIn/Exists/DoesNotExist operators)
# ---------------------------------------------------------------------------


class In:
    def __init__(self, *values: str):
        if not values:
            raise ValueError("In() needs at least one value")
        self.values = [str(v) for v in values]


class NotIn:
    def __init__(self, *values: str):
        if not values:
            raise ValueError("NotIn() needs at least one value")
        self.values = [str(v) for v in values]


class Exists:
    pass


class DoesNotExist:
    pass


LabelCondition = Union[In, NotIn, Exists, DoesNotExist, str]


def _cond_wire(cond: LabelCondition) -> dict:
    """Wire form consumed by scheduling.match_labels.  A bare string is
    shorthand for In(value)."""
    if isinstance(cond, str):
        return {"op": "in", "values": [cond]}
    if isinstance(cond, In):
        return {"op": "in", "values": cond.values}
    if isinstance(cond, NotIn):
        return {"op": "!in", "values": cond.values}
    if isinstance(cond, Exists):
        return {"op": "exists"}
    if isinstance(cond, DoesNotExist):
        return {"op": "!exists"}
    raise TypeError(f"label condition must be In/NotIn/Exists/DoesNotExist/str, got {cond!r}")


def selector_wire(selector: Optional[Dict[str, LabelCondition]]) -> Optional[dict]:
    if not selector:
        return None
    return {str(k): _cond_wire(v) for k, v in selector.items()}


class NodeLabelSchedulingStrategy:
    """Schedule onto nodes whose labels satisfy `hard` (required), preferring
    nodes that also satisfy `soft`.  Nodes carry the labels of their
    CA_NODE_LABELS env and ca.io/node-id."""

    def __init__(
        self,
        hard: Optional[Dict[str, LabelCondition]] = None,
        soft: Optional[Dict[str, LabelCondition]] = None,
    ):
        if not hard and not soft:
            raise ValueError("NodeLabelSchedulingStrategy needs hard and/or soft constraints")
        self.hard = hard or {}
        self.soft = soft or {}

    def to_wire(self) -> dict:
        return {
            "type": "NODE_LABEL",
            "hard": selector_wire(self.hard),
            "soft": selector_wire(self.soft),
        }
