"""cluster_anywhere_tpu_torch: the PyTorch/CUDA port of cluster_anywhere_tpu.

The same surface as the JAX package: tasks, actors, a distributed object
store and placement groups (core/), Serve (serve/), and on top the model
(models/, ops/, parallel/), training and the LLM serving classes and
deployments (llm/), with the flash-attention kernels written for Hopper
(ops/csrc/).  Entry points run on the card unless called with device="cpu";
the runtime counts GPUs as the `GPU` resource.  The package imports torch
and numpy, never JAX or the JAX package.

Keep this module import-light: the head and CPU-pool workers import it, and
torch is only loaded when the tensor modules (`models`, `ops`, `llm`,
`resolve_device`) are used.
"""

from ._version import version as __version__
from .core import errors as exceptions
from .core.actor import ActorHandle, exit_actor, get_actor, kill, method
from .core.api import (
    available_resources,
    timeline,
    cancel,
    cluster_resources,
    cluster_stats,
    drain_node,
    get,
    init,
    is_initialized,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from .core.errors import (
    ActorDiedError,
    ActorError,
    CAError,
    DagTimeoutError,
    DeadActorError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from .core.object_ref import DeviceRef, ObjectRef
from .core.placement import (
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from .core.runtime_context import get_runtime_context
from .core.scheduling_strategies import (
    DoesNotExist,
    Exists,
    In,
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    NotIn,
    PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy,
)


def __getattr__(name):
    # resolve_device imports torch: load it on first use, not at import
    if name == "resolve_device":
        from ._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "__version__",
    "init",
    "shutdown",
    "is_initialized",
    "put",
    "get",
    "wait",
    "cancel",
    "remote",
    "ObjectRef",
    "DeviceRef",
    "ActorHandle",
    "get_actor",
    "method",
    "kill",
    "exit_actor",
    "nodes",
    "cluster_resources",
    "available_resources",
    "cluster_stats",
    "drain_node",
    "timeline",
    "placement_group",
    "remove_placement_group",
    "placement_group_table",
    "PlacementGroup",
    "PlacementGroupSchedulingStrategy",
    "NodeAffinitySchedulingStrategy",
    "SpreadSchedulingStrategy",
    "NodeLabelSchedulingStrategy",
    "In",
    "NotIn",
    "Exists",
    "DoesNotExist",
    "get_runtime_context",
    "exceptions",
    "CAError",
    "TaskError",
    "ActorError",
    "ActorDiedError",
    "DeadActorError",
    "DagTimeoutError",
    "WorkerCrashedError",
    "ObjectLostError",
    "GetTimeoutError",
    "TaskCancelledError",
    "resolve_device",
]
