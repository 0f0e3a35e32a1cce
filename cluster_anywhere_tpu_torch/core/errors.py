"""Exception hierarchy, mirroring the user-visible error surface of the
reference (python/ray/exceptions.py): task errors wrap the remote traceback,
actor errors mark dead actors, object-loss and timeout errors are distinct.

Failure-class errors (FencedError, DeadActorError, DagTimeoutError,
ObjectLostError) carry a flight-recorder slice: the raising process's recent
decision events (`.flight_events`, plain picklable dicts), so the exception
that reaches the driver brings its own black box — `ca incident` and plain
repr-debugging both read it without another round trip to the cluster.
"""

from __future__ import annotations


def _flight_slice(plane=None):
    """Recent flight-recorder events from THIS process ([] when the plane is
    disabled).  Lazy import: errors must stay importable everywhere."""
    try:
        from ..util import flightrec

        return flightrec.recent(32, plane=plane)
    except Exception:
        return []


class CAError(Exception):
    """Base class for all framework errors."""


class TaskError(CAError):
    """A remote task raised an exception. Re-raised at `get()` on the caller,
    carrying the remote traceback as text."""

    def __init__(self, cause_repr: str, traceback_str: str = ""):
        self.cause_repr = cause_repr
        self.traceback_str = traceback_str
        super().__init__(cause_repr)

    def __str__(self):
        if self.traceback_str:
            return f"{self.cause_repr}\n\n--- remote traceback ---\n{self.traceback_str}"
        return self.cause_repr


class WorkerCrashedError(CAError):
    """The worker process executing the task died unexpectedly."""


class ActorError(CAError):
    """Generic actor-related failure."""


class ActorDiedError(ActorError):
    """The actor is dead (crashed, killed, or out of restart budget); pending
    and future calls fail with this."""


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (e.g. restarting)."""


class DeadActorError(ActorDiedError):
    """An actor hosting a compiled-DAG loop died mid-execute (infrastructure
    death, as opposed to an application error — those travel through the
    channels as _DagError payloads).  Carries the failed actor and the DAG
    nodes it hosted; the DAG is torn down and `recompile()` rebuilds it
    against the restarted actor."""

    def __init__(self, actor_id: str, nodes: tuple = (), detail: str = ""):
        self.actor_id = actor_id
        self.nodes = tuple(nodes)
        self.flight_events = _flight_slice(plane="dag")
        names = ", ".join(self.nodes) or "?"
        msg = (
            f"compiled-DAG actor {actor_id} died mid-execute "
            f"(hosted nodes: {names})"
        )
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class DagTimeoutError(CAError, TimeoutError):
    """A compiled-DAG execute did not produce its outputs within
    config.dag_execute_timeout_s (or the per-call timeout).  Names the node
    whose output channel stalled so the hang is attributable."""

    def __init__(self, node: str, timeout_s: float, phase: str = "read"):
        self.node = node
        self.timeout_s = timeout_s
        self.phase = phase
        self.flight_events = _flight_slice(plane="dag")
        super().__init__(
            f"compiled-DAG {phase} timed out after {timeout_s:g}s waiting on "
            f"node {node}"
        )


class ObjectLostError(CAError):
    """Object data is unavailable and could not be recovered."""

    def __init__(self, *args):
        self.flight_events = _flight_slice()
        super().__init__(*args)


class GetTimeoutError(CAError, TimeoutError):
    """`get()` exceeded its timeout."""


class TaskCancelledError(CAError):
    """The task was cancelled before/while running."""


class RuntimeEnvSetupError(CAError):
    """Preparing the runtime environment for a task/actor failed."""


class ObjectStoreFullError(CAError):
    """The shared-memory object store could not allocate."""


class StaleObjectError(CAError):
    """A shared-memory slice was recycled since this reference was taken
    (its seal sequence no longer matches); the reader must re-resolve the
    object's current location through the directory."""


class PlacementGroupError(CAError):
    """Placement group could not be created or was removed."""


class FencedError(CAError):
    """An RPC carried a stale node incarnation: the head declared that node
    dead (partition, crash) and adopted its state, so nothing minted under
    the old incarnation may act anymore.  A fenced agent/worker must cancel
    its outstanding leases and zombie tasks, tear down, and rejoin as a
    fresh incarnation — completing in-flight side effects would duplicate
    work the head already resubmitted elsewhere."""

    def __init__(self, *args):
        self.flight_events = _flight_slice(plane="fence")
        super().__init__(*args)
