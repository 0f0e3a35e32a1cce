"""@serve.batch: transparent request batching inside replicas (analogue of
python/ray/serve/batching.py).

Decorates an async method taking a list of inputs and returning a list of
outputs; concurrent callers are coalesced into batches of up to
max_batch_size, waiting at most batch_wait_timeout_s for the batch to fill.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional

from ..util.aio import spawn_logged


class _BatchQueue:
    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = batch_wait_timeout_s
        self.queue: List = []  # [(item, future)]
        self._flusher: Optional[asyncio.Task] = None

    async def submit(self, item: Any):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self.queue.append((item, fut))
        if len(self.queue) >= self.max_batch_size:
            self._flush()
        elif self._flusher is None or self._flusher.done():
            self._flusher = loop.create_task(self._wait_then_flush())
        return await fut

    async def _wait_then_flush(self):
        await asyncio.sleep(self.timeout_s)
        self._flush()

    def _flush(self):
        if not self.queue:
            return
        batch, self.queue = self.queue, []
        # _run settles every batch future itself; spawn_logged guards the
        # residual failure modes (a fut.set_* race) from vanishing silently
        spawn_logged(self._run(batch), "serve-batch-run")

    async def _run(self, batch):
        items = [item for item, _ in batch]
        try:
            outs = await self.fn(items)
            if not isinstance(outs, list) or len(outs) != len(items):
                raise TypeError(
                    f"@serve.batch function must return a list of {len(items)} "
                    f"results, got {type(outs).__name__}"
                )
            for (_, fut), out in zip(batch, outs):
                if not fut.done():
                    fut.set_result(out)
        except asyncio.CancelledError as e:
            # fail the waiters, then stay cancelled: swallowing here would
            # wedge replica shutdown with a batch forever "in flight"
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            raise
        except BaseException as e:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 8,
    batch_wait_timeout_s: float = 0.01,
):
    """Usage:
        @serve.batch(max_batch_size=32, batch_wait_timeout_s=0.05)
        async def handle_batch(self, inputs: list) -> list: ...
    """

    def deco(fn):
        # per-method attribute name: queues live ON the instance so their
        # lifetime matches it (a module-level id()-keyed dict would pin every
        # instance forever)
        attr = f"__ca_batch_queue_{fn.__qualname__.replace('.', '_')}"
        free_q: List[Optional[_BatchQueue]] = [None]

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            if kwargs:
                raise TypeError("@serve.batch calls must use positional args")
            if len(args) == 2:  # bound method: (self, item)
                self_obj, item = args
                q = getattr(self_obj, attr, None)
                if q is None:
                    q = _BatchQueue(
                        lambda items: fn(self_obj, items), max_batch_size, batch_wait_timeout_s
                    )
                    setattr(self_obj, attr, q)
            elif len(args) == 1:  # free function: (item,)
                (item,) = args
                if free_q[0] is None:
                    free_q[0] = _BatchQueue(fn, max_batch_size, batch_wait_timeout_s)
                q = free_q[0]
            else:
                raise TypeError("@serve.batch functions take exactly one request arg")
            return await q.submit(item)

        wrapper._is_serve_batch = True
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
