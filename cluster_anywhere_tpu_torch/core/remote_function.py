"""@remote function machinery (analogue of python/ray/remote_function.py).

`@remote` wraps a function into a RemoteFunction whose `.remote(*args)`
submits a task and returns ObjectRef(s).  `.options(...)` returns a shallow
override, like the reference's options resolution
(python/ray/_private/ray_option_utils.py).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Union

from .object_ref import ObjectRef
from .worker import global_worker

_VALID_OPTIONS = {
    "num_cpus",
    "num_gpus",
    "resources",
    "num_returns",
    "max_retries",
    "retry_exceptions",
    "name",
    "placement_group",
    "placement_group_bundle_index",
    "scheduling_strategy",
    "runtime_env",
}


def _check_options(opts: Dict[str, Any]):
    unknown = set(opts) - _VALID_OPTIONS
    if unknown:
        raise ValueError(f"unknown option(s): {sorted(unknown)}")
    nr = opts.get("num_returns")
    if nr is not None and nr != "streaming" and (not isinstance(nr, int) or nr < 1):
        raise ValueError('num_returns must be a positive int or "streaming"')
    nt = opts.get("num_gpus")
    if nt:
        from .accelerators import validate_chip_request

        validate_chip_request(float(nt))


def _normalize_pg(opts: Dict[str, Any]) -> Dict[str, Any]:
    """Accept PlacementGroup objects or scheduling strategies in options."""
    from .placement import PlacementGroup
    from .scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
        NodeLabelSchedulingStrategy,
        PlacementGroupSchedulingStrategy,
        SpreadSchedulingStrategy,
    )

    out = dict(opts)
    strat = out.pop("scheduling_strategy", None)
    if isinstance(strat, PlacementGroupSchedulingStrategy):
        out["placement_group"] = strat.placement_group
        out["placement_group_bundle_index"] = strat.placement_group_bundle_index
    elif isinstance(strat, NodeAffinitySchedulingStrategy):
        out["strategy"] = {
            "type": "NODE_AFFINITY",
            "node_id": strat.node_id,
            "soft": strat.soft,
        }
    elif isinstance(strat, NodeLabelSchedulingStrategy):
        out["strategy"] = strat.to_wire()
    elif isinstance(strat, SpreadSchedulingStrategy) or strat == "SPREAD":
        out["strategy"] = {"type": "SPREAD"}
    pg = out.get("placement_group")
    if isinstance(pg, PlacementGroup):
        out["placement_group"] = pg.id.hex()
    if out.get("placement_group") is not None:
        out.setdefault("placement_group_bundle_index", 0)
    return out


class RemoteFunction:
    def __init__(self, fn, default_options: Optional[Dict[str, Any]] = None):
        self._function = fn
        self._default_options = default_options or {}
        _check_options(self._default_options)
        functools.update_wrapper(self, fn)

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        return self._remote(args, kwargs, self._default_options)

    def options(self, **opts) -> "RemoteFunction":
        _check_options(opts)
        merged = {**self._default_options, **opts}
        return RemoteFunction(self._function, merged)

    def _remote(self, args, kwargs, opts):
        w = global_worker()
        if opts.get("num_returns") == "streaming":
            return w.submit_streaming_task(self._function, args, kwargs, _normalize_pg(opts))
        refs = w.submit_task(self._function, args, kwargs, _normalize_pg(opts))
        return refs[0] if opts.get("num_returns", 1) == 1 else refs

    def bind(self, *args, **kwargs):
        """Task DAG nodes (reference: dag/function_node.py) come with the
        port of dag/; until then this raises."""
        from .errors import not_ported

        raise not_ported("task .bind (DAG nodes)", "4")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._function.__name__!r} cannot be called directly; "
            f"use .remote()"
        )

    @property
    def underlying(self):
        return self._function
