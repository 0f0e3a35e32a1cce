"""multiprocessing.Pool shim over the task runtime.

Reference parity: ``python/ray/util/multiprocessing/pool.py`` — a drop-in
``Pool`` whose workers are cluster tasks/actors instead of forked processes,
so existing ``multiprocessing`` code scales past one host unchanged.

Covered surface: ``apply/apply_async/map/map_async/imap/imap_unordered/
starmap/starmap_async``, context manager, ``close/terminate/join``.
``initializer`` runs once per pool actor (same semantics as stdlib).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

from ..core import api as _ca
from ..core.actor import kill
from ..core.errors import CAError


class TimeoutError(CAError, Exception):
    """multiprocessing.TimeoutError analogue for AsyncResult.get."""


class _PoolWorker:
    """One pool process: runs the initializer once, then applies functions."""

    def __init__(self, initializer=None, initargs=()):
        if initializer is not None:
            initializer(*initargs)

    def run(self, fn, args, kwargs):
        return fn(*args, **(kwargs or {}))

    def run_batch(self, fn, chunk):
        return [fn(*a) for a in chunk]


class AsyncResult:
    """multiprocessing.pool.AsyncResult analogue wrapping ObjectRefs."""

    def __init__(self, refs: List[Any], single: bool, chunked: bool, callback=None,
                 error_callback=None):
        self._refs = refs
        self._single = single
        self._chunked = chunked
        self._callback = callback
        self._error_callback = error_callback
        self._value: Any = None
        self._done = False
        self._error: Optional[BaseException] = None

    def _resolve(self, timeout=None):
        if self._done:
            return
        try:
            outs = _ca.get(self._refs, timeout=timeout)
        except Exception as e:
            from ..core.errors import GetTimeoutError

            if isinstance(e, GetTimeoutError):
                raise TimeoutError(str(e)) from None
            self._error = e
            self._done = True
            if self._error_callback is not None:
                try:
                    self._error_callback(e)
                except Exception:
                    pass
            return
        if self._chunked:
            outs = list(itertools.chain.from_iterable(outs))
        self._value = outs[0] if self._single else outs
        self._done = True
        if self._callback is not None:
            try:
                self._callback(self._value)
            except Exception:
                pass

    def get(self, timeout: Optional[float] = None):
        self._resolve(timeout)
        if self._error is not None:
            raise self._error
        return self._value

    def wait(self, timeout: Optional[float] = None):
        try:
            self._resolve(timeout)
        except TimeoutError:
            pass

    def ready(self) -> bool:
        if self._done:
            return True
        ready, _ = _ca.wait(self._refs, num_returns=len(self._refs), timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        if not self._done:
            raise ValueError("result is not ready")
        return self._error is None


class Pool:
    def __init__(
        self,
        processes: Optional[int] = None,
        initializer: Optional[Callable] = None,
        initargs: tuple = (),
    ):
        if not _ca.is_initialized():
            _ca.init()
        if processes is None:
            processes = max(1, int(_ca.cluster_resources().get("CPU", 1)))
        if processes < 1:
            raise ValueError("processes must be >= 1")
        self._size = processes
        Worker = _ca.remote(_PoolWorker)
        self._workers = [
            Worker.remote(initializer, tuple(initargs)) for _ in range(processes)
        ]
        self._rr = 0
        self._closed = False

    # -- internals --------------------------------------------------------
    def _next_worker(self):
        if self._closed:
            raise ValueError("Pool not running")
        w = self._workers[self._rr % self._size]
        self._rr += 1
        return w

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]) -> List[list]:
        items = [(x,) if not isinstance(x, tuple) else x for x in iterable]
        if chunksize is None:
            chunksize = max(1, len(items) // (self._size * 4) or 1)
        return [items[i : i + chunksize] for i in range(0, len(items), chunksize)]

    def _submit_chunks(self, func, iterable, chunksize):
        return [
            self._next_worker().run_batch.remote(func, chunk)
            for chunk in self._chunks(iterable, chunksize)
        ]

    # -- public surface ---------------------------------------------------
    def apply(self, func, args: tuple = (), kwds: Optional[dict] = None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func, args: tuple = (), kwds: Optional[dict] = None,
                    callback=None, error_callback=None) -> AsyncResult:
        ref = self._next_worker().run.remote(func, tuple(args), kwds)
        return AsyncResult([ref], single=True, chunked=False,
                           callback=callback, error_callback=error_callback)

    def map(self, func, iterable: Iterable, chunksize: Optional[int] = None) -> list:
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func, iterable: Iterable, chunksize: Optional[int] = None,
                  callback=None, error_callback=None) -> AsyncResult:
        refs = self._submit_chunks(func, [(x,) for x in iterable], chunksize)
        return AsyncResult(refs, single=False, chunked=True,
                           callback=callback, error_callback=error_callback)

    def starmap(self, func, iterable: Iterable, chunksize: Optional[int] = None) -> list:
        refs = self._submit_chunks(func, iterable, chunksize)
        return AsyncResult(refs, single=False, chunked=True).get()

    def starmap_async(self, func, iterable, chunksize=None) -> AsyncResult:
        refs = self._submit_chunks(func, iterable, chunksize)
        return AsyncResult(refs, single=False, chunked=True)

    def imap(self, func, iterable: Iterable, chunksize: int = 1):
        """Ordered lazy iterator of results."""
        refs = self._submit_chunks(func, [(x,) for x in iterable], chunksize)
        for ref in refs:
            yield from _ca.get(ref)

    def imap_unordered(self, func, iterable: Iterable, chunksize: int = 1):
        """Results in completion order."""
        refs = self._submit_chunks(func, [(x,) for x in iterable], chunksize)
        pending = list(refs)
        while pending:
            ready, pending = _ca.wait(pending, num_returns=1)
            yield from _ca.get(ready[0])

    # -- lifecycle --------------------------------------------------------
    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True
        for w in self._workers:
            try:
                kill(w)
            except Exception:
                pass
        self._workers = []

    def join(self):
        if not self._closed:
            raise ValueError("Pool is still running")
        # outstanding work is ref-tracked; nothing to wait on beyond actors

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
