"""Actor API: @remote on classes (analogue of python/ray/actor.py).

ActorClass.remote() registers + places the actor via the head; ActorHandle
holds the actor id and submits method calls directly to the hosting worker.
Handles are serializable and can be passed to tasks/other actors.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from .ids import ActorID
from .object_ref import ObjectRef
from .remote_function import _normalize_pg
from .worker import global_worker

_VALID_ACTOR_OPTIONS = {
    "num_cpus",
    "num_gpus",
    "resources",
    "name",
    "lifetime",
    "max_restarts",
    "max_task_retries",
    "max_concurrency",
    "concurrency_groups",
    "placement_group",
    "placement_group_bundle_index",
    "scheduling_strategy",
    "runtime_env",
    # False = exempt from automatic drain migration (supervisor-managed
    # lifecycles, e.g. serve replicas: the controller drains them app-aware)
    "drain_migration",
}


def method(**options):
    """Per-method options decorator (analogue of ray.method): currently
    num_returns and concurrency_group (see `concurrency_groups` actor
    option; reference concurrency_group_manager.h)."""
    allowed = {"num_returns", "concurrency_group"}
    unknown = set(options) - allowed
    if unknown:
        raise ValueError(f"unknown method option(s): {sorted(unknown)}")

    def wrap(fn):
        fn.__ca_method_options__ = options
        return fn

    return wrap


def _collect_method_options(cls) -> Dict[str, dict]:
    """Gather @method(**opts) annotations from an actor class (method name ->
    options dict); drives caller-side num_returns and creation-time
    concurrency-group validation."""
    out: Dict[str, dict] = {}
    for name in dir(cls):
        if name.startswith("__"):
            continue
        fn = getattr(cls, name, None)
        opts = getattr(fn, "__ca_method_options__", None)
        if opts:
            out[name] = dict(opts)
    return out


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        return self._handle._submit(
            self._method_name, args, kwargs, {"num_returns": self._num_returns}
        )

    def bind(self, *args, **kwargs):
        """DAG nodes from actor methods (reference: dag/class_node.py;
        compiled graphs) come with the port of dag/; until then this raises."""
        from .errors import not_ported

        raise not_ported("actor method .bind (DAG nodes)", "4")

    def options(self, num_returns: Optional[int] = None, **_ignored) -> "ActorMethod":
        n = self._num_returns if num_returns is None else num_returns
        return ActorMethod(self._handle, self._method_name, n)


class ActorHandle:
    def __init__(
        self,
        actor_id: ActorID,
        max_task_retries: int = 0,
        method_options: Optional[Dict[str, dict]] = None,
    ):
        self._actor_id = actor_id
        self._max_task_retries = max_task_retries
        self._method_options = method_options or {}

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def _submit(self, method: str, args, kwargs, opts: Dict[str, Any]):
        w = global_worker()
        merged = {"max_task_retries": self._max_task_retries, **opts}
        if merged.get("num_returns") == "streaming":
            return w.submit_streaming_actor_task(self._actor_id, method, args, kwargs, merged)
        refs = w.submit_actor_task(self._actor_id, method, args, kwargs, merged)
        return refs[0] if merged.get("num_returns", 1) == 1 else refs

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        n = self._method_options.get(name, {}).get("num_returns", 1)
        return ActorMethod(self, name, num_returns=n)

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()})"

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._max_task_retries, self._method_options),
        )


class ActorClass:
    def __init__(self, cls, default_options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._default_options = default_options or {}
        unknown = set(self._default_options) - _VALID_ACTOR_OPTIONS
        if unknown:
            raise ValueError(f"unknown actor option(s): {sorted(unknown)}")
        nt = self._default_options.get("num_gpus")
        if nt:
            from .accelerators import validate_chip_request

            validate_chip_request(float(nt))
        self.__name__ = getattr(cls, "__name__", "ActorClass")

    def remote(self, *args, **kwargs) -> ActorHandle:
        return self._remote(args, kwargs, self._default_options)

    def options(self, **opts) -> "ActorClass":
        unknown = set(opts) - _VALID_ACTOR_OPTIONS
        if unknown:
            raise ValueError(f"unknown actor option(s): {sorted(unknown)}")
        return ActorClass(self._cls, {**self._default_options, **opts})

    def _remote(self, args, kwargs, opts) -> ActorHandle:
        w = global_worker()
        method_options = _collect_method_options(self._cls)
        declared = set(opts.get("concurrency_groups") or {})
        referenced = {
            o["concurrency_group"]
            for o in method_options.values()
            if o.get("concurrency_group") is not None
        }
        undeclared = referenced - declared
        if undeclared:
            raise ValueError(
                f"concurrency group(s) {sorted(undeclared)} used by @method but "
                f"not declared in the actor's concurrency_groups option "
                f"(declared: {sorted(declared)})"
            )
        wire_opts = dict(_normalize_pg(opts))
        wire_opts["method_options"] = method_options or None
        actor_id, _addr = w.create_actor(self._cls, args, kwargs, wire_opts)
        return ActorHandle(
            actor_id,
            max_task_retries=opts.get("max_task_retries", 0),
            method_options=method_options,
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self.__name__!r} cannot be instantiated directly; "
            f"use .remote()"
        )

    @property
    def underlying(self):
        return self._cls


def get_actor(name: str) -> ActorHandle:
    """Look up a named actor (python/ray/_private/worker.py get_actor)."""
    w = global_worker()
    info = w.get_actor_info(name=name)
    return ActorHandle(
        ActorID.from_hex(info["actor_id"]),
        method_options=info.get("method_options"),
    )


def kill(actor: ActorHandle, no_restart: bool = True):
    global_worker().kill_actor(actor._actor_id, no_restart)


def exit_actor():
    """Terminate the current actor from inside one of its methods."""
    raise SystemExit(0)
