"""Distributed FIFO queue backed by an actor (analogue of the reference's
python/ray/util/queue.py Queue).

Blocking get/put are implemented with client-side polling against non-blocking
actor methods, so a blocked consumer never wedges the queue actor's task loop.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

from ..core import api as ca


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        from collections import deque

        self.maxsize = maxsize
        self._q = deque()

    def qsize(self) -> int:
        return len(self._q)

    def empty(self) -> bool:
        return not self._q

    def full(self) -> bool:
        return self.maxsize > 0 and len(self._q) >= self.maxsize

    def put_nowait(self, item) -> bool:
        if self.full():
            return False
        self._q.append(item)
        return True

    def put_nowait_batch(self, items: List[Any]) -> bool:
        # atomic: all items fit or none are inserted (retrying on Full must
        # not duplicate a prefix)
        if self.maxsize > 0 and len(self._q) + len(items) > self.maxsize:
            return False
        self._q.extend(items)
        return True

    def get_nowait(self):
        if not self._q:
            return False, None
        return True, self._q.popleft()

    def get_nowait_batch(self, num_items: int):
        out = []
        while self._q and len(out) < num_items:
            out.append(self._q.popleft())
        return out


class Queue:
    """FIFO queue usable from any worker/driver in the cluster.

    >>> q = Queue(maxsize=100)
    >>> q.put(1); q.get()
    """

    _POLL_S = 0.005

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        self.maxsize = maxsize
        self.actor = ca.remote(_QueueActor).options(**opts).remote(maxsize)

    def qsize(self) -> int:
        return ca.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ca.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ca.get(self.actor.full.remote())

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # only ship the payload when the queue has room — while full, poll
            # with the cheap full() call instead of re-serializing the item
            # (unbounded queues skip the probe: put_nowait cannot fail)
            if self.maxsize <= 0 or not ca.get(self.actor.full.remote()):
                if ca.get(self.actor.put_nowait.remote(item)):
                    return
            if not block:
                raise Full("queue is full")
            if deadline is not None and time.monotonic() > deadline:
                raise Full("queue put timed out")
            time.sleep(self._POLL_S)

    def put_nowait(self, item: Any):
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]):
        if not ca.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full(f"batch of {len(items)} does not fit")

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ca.get(self.actor.get_nowait.remote())
            if ok:
                return item
            if not block:
                raise Empty("queue is empty")
            if deadline is not None and time.monotonic() > deadline:
                raise Empty("queue get timed out")
            time.sleep(self._POLL_S)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return ca.get(self.actor.get_nowait_batch.remote(num_items))

    def shutdown(self, force: bool = False):
        from ..core.actor import kill

        if not force:
            # graceful: barrier on the actor's queue so in-flight RPCs finish
            try:
                ca.get(self.actor.qsize.remote(), timeout=5)
            except Exception:
                pass
        kill(self.actor)
