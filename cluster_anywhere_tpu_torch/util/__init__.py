"""Utility APIs layered on the core (analogue of the reference's
python/ray/util/: ActorPool at util/actor_pool.py, Queue at util/queue.py,
inspect_serializability at util/check_serialize.py, metrics at
util/metrics.py, the state API at util/state/, tracing at util/tracing/,
the log plane at util/logplane.py)."""

from . import logplane, metrics, multiprocessing, state, tracing
from .actor_pool import ActorPool
from .check_serialize import inspect_serializability
from .queue import Empty, Full, Queue

__all__ = [
    "ActorPool",
    "Queue",
    "Empty",
    "Full",
    "inspect_serializability",
    "logplane",
    "metrics",
    "multiprocessing",
    "state",
    "tracing",
]
