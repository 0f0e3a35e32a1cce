"""ActorPool: multiplex work over a fixed set of actors (analogue of the
reference's python/ray/util/actor_pool.py ActorPool)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional, TypeVar

from ..core import api as ca

V = TypeVar("V")


class ActorPool:
    """Round-robins submitted work onto idle actors.

    >>> pool = ActorPool([Worker.remote() for _ in range(4)])
    >>> list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    """

    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool requires at least one actor")
        # future -> (actor, submission index)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    # -- submission ---------------------------------------------------------

    def submit(self, fn: Callable[[Any, V], Any], value: V):
        """Apply fn(actor, value) on an idle actor; raises if none idle."""
        if not self._idle:
            raise RuntimeError("no idle actors; call get_next() first")
        actor = self._idle.pop()
        future = fn(actor, value)
        if isinstance(future, list):  # num_returns > 1
            future = future[0]
        self._future_to_actor[future] = (actor, self._next_task_index)
        self._index_to_future[self._next_task_index] = future
        self._next_task_index += 1

    def has_free(self) -> bool:
        return bool(self._idle)

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    # -- retrieval ----------------------------------------------------------

    def get_next(self, timeout: Optional[float] = None, ignore_if_timedout: bool = False):
        """Next result in submission order."""
        if not self.has_next():
            raise StopIteration("no more results")
        from ..core.errors import GetTimeoutError

        future = self._index_to_future[self._next_return_index]
        try:
            result = ca.get(future, timeout=timeout)
        except GetTimeoutError:
            if ignore_if_timedout:
                return None
            raise
        except Exception:
            self._return_actor(future)
            raise
        self._return_actor(future)
        return result

    def get_next_unordered(self, timeout: Optional[float] = None):
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("no more results")
        ready, _ = ca.wait(list(self._future_to_actor), num_returns=1, timeout=timeout)
        if not ready:
            from ..core.errors import GetTimeoutError

            raise GetTimeoutError("get_next_unordered timed out")
        future = ready[0]
        try:
            return ca.get(future)
        finally:
            self._return_actor(future)

    def _return_actor(self, future):
        actor, index = self._future_to_actor.pop(future)
        del self._index_to_future[index]
        if index == self._next_return_index:
            # advance past any already-consumed indices (_index_to_future and
            # _future_to_actor are updated in lockstep, so one check suffices)
            while (
                self._next_return_index < self._next_task_index
                and self._next_return_index not in self._index_to_future
            ):
                self._next_return_index += 1
        self._idle.append(actor)

    # -- bulk helpers -------------------------------------------------------

    def map(self, fn: Callable[[Any, V], Any], values: Iterable[V]):
        """Ordered streaming map; yields results as they become ready in order."""
        values = list(values)
        i = 0
        while i < len(values) and self.has_free():
            self.submit(fn, values[i])
            i += 1
        while self.has_next():
            yield self.get_next()
            if i < len(values):
                self.submit(fn, values[i])
                i += 1

    def map_unordered(self, fn: Callable[[Any, V], Any], values: Iterable[V]):
        values = list(values)
        i = 0
        while i < len(values) and self.has_free():
            self.submit(fn, values[i])
            i += 1
        while self.has_next():
            yield self.get_next_unordered()
            if i < len(values):
                self.submit(fn, values[i])
                i += 1

    # -- membership ---------------------------------------------------------

    def push(self, actor: Any):
        """Add an idle actor to the pool."""
        self._idle.append(actor)

    def pop_idle(self) -> Optional[Any]:
        """Remove and return an idle actor, if any."""
        return self._idle.pop() if self._idle else None
