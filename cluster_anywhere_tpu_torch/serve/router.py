"""DeploymentHandle + Router: the request path (analogue of
python/ray/serve/handle.py DeploymentHandle -> serve/_private/router.py
Router -> replica_scheduler/pow_2_scheduler.py PowerOfTwoChoicesReplicaScheduler).

The router keeps a local in-flight count per replica and picks the less-loaded
of two random replicas (power-of-two-choices with locally-observed queue
lengths), refreshing replica membership from the controller when its cached
version goes stale.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ..core import api as ca
from ..core.actor import get_actor
from .controller import CONTROLLER_NAME

_REFRESH_PERIOD_S = 1.0


class DeploymentResponse:
    """Future-like result of handle.remote() (reference serve/handle.py
    DeploymentResponse). Wraps a future-of-ObjectRef: routing happens on the
    router's dispatch thread, so .remote() never blocks — critical inside
    async replica code, where blocking the event loop would deadlock the
    process's IO."""

    def __init__(self, ref_future):
        self._ref_future = ref_future

    def result(self, timeout_s: Optional[float] = None):
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        ref = self._ref_future.result(timeout_s)
        remain = None if deadline is None else max(0.0, deadline - time.monotonic())
        return ca.get(ref, timeout=remain)

    def _to_object_ref(self, timeout_s: Optional[float] = 30.0):
        return self._ref_future.result(timeout_s)

    def __await__(self):
        import asyncio

        async def _wait():
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(None, self.result)

        return _wait().__await__()


class DeploymentResponseGenerator:
    """Iterable result of handle.options(stream=True).remote() (reference
    serve/handle.py DeploymentResponseGenerator): yields the replica
    generator's items in production order with streaming backpressure."""

    def __init__(self, gen_future):
        self._gen_future = gen_future
        self._gen = None  # resolved ObjectRefGenerator (cancel target)

    def _resolve(self):
        if self._gen is None:
            self._gen = self._gen_future.result(30)  # ObjectRefGenerator
        return self._gen

    def __iter__(self):
        gen = self._resolve()
        try:
            for ref in gen:
                yield ca.get(ref, timeout=60)
        except GeneratorExit:
            # consumer close()d us mid-stream: stop the replica-side
            # generator too, or it decodes to completion for nobody
            self.cancel()
            raise

    def cancel(self):
        """Abandon the stream: interrupt the replica-side generator (it gets
        TaskCancelledError at its next yield) and release this consumer.
        Call when the downstream client is gone (proxy SSE disconnect).
        Runs off-loop (callers use an executor): still-queued routing is
        cancelled outright; in-flight routing gets a grace LONGER than
        _acquire_replica's 30 s backpressure deadline — under saturation
        (exactly when clients give up) the submit resolves late, and a
        shorter wait would swallow the cancel and let the replica decode
        the whole abandoned stream for nobody."""
        try:
            if self._gen is None and not self._gen_future.done():
                if self._gen_future.cancel():
                    return  # routing never started: nothing replica-side
            self._gen = self._gen_future.result(35)
            self._gen.cancel()
        except Exception:
            pass  # routing itself failed / replica dead: nothing to stop


_backpressure_hist = None


def _backpressure_metric():
    """ca_serve_backpressure_seconds: time route() spent waiting because
    every pickable replica was saturated — the visible form of what used to
    be an invisible CPU-burning spin-wait."""
    global _backpressure_hist
    if _backpressure_hist is None:
        from ..util import metrics as m

        _backpressure_hist = m.Histogram(
            "ca_serve_backpressure_seconds",
            "serve router wait for replica capacity",
            boundaries=[0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 1.0, 5.0, 30.0],
            tag_keys=("deployment",),
        )
    return _backpressure_hist


class Router:
    def __init__(self, app: str, deployment: str):
        import concurrent.futures

        self.app = app
        self.deployment = deployment
        # all blocking work (controller RPCs, backpressure waits) happens on
        # this thread so handle.remote() stays non-blocking for callers
        self._dispatch = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-router"
        )
        self._lock = threading.Lock()
        self._replicas: List[Dict[str, Any]] = []
        self._handles: Dict[str, Any] = {}  # replica_id -> actor handle
        self._inflight: Dict[str, int] = {}
        self._version = -1
        self._max_ongoing = 8
        self._last_refresh = 0.0
        self._watched: List = []  # [(replica_id, ref)]
        self._watch_cv = threading.Condition(self._lock)
        # saturation backpressure: route() waits HERE (bounded, no spin)
        # until the watch loop's completion decrements free capacity
        self._capacity_cv = threading.Condition(self._lock)
        self._watcher: Optional[threading.Thread] = None
        self._metric_tags = {"deployment": f"{app}/{deployment}"}

    def _controller(self):
        return get_actor(CONTROLLER_NAME)

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        with self._lock:
            if not force and self._replicas and now - self._last_refresh < _REFRESH_PERIOD_S:
                return
            self._last_refresh = now
        info = ca.get(
            self._controller().get_deployment_info.remote(self.app, self.deployment)
        )
        with self._lock:
            stale = info["version"] == self._version and self._replicas
            self._version = info["version"]
            self._max_ongoing = info.get("max_ongoing_requests", 8)
            self._replicas = info["replicas"]
            if stale:
                # same membership, but the controller-reported queue_lens
                # (merged in _pick) are fresh — keep them
                self._capacity_cv.notify_all()
                return
            live = {r["replica_id"] for r in self._replicas}
            self._handles = {k: v for k, v in self._handles.items() if k in live}
            self._inflight = {
                k: self._inflight.get(k, 0) for k in live
            }
            self._capacity_cv.notify_all()

    def _handle_for(self, rid: str, actor_name: str):
        h = self._handles.get(rid)
        if h is None:
            h = get_actor(actor_name)
            self._handles[rid] = h
        return h

    def _load(self, rep: Dict[str, Any]) -> int:
        """Replica load estimate for power-of-two-choices: the max of this
        router's own in-flight count and the controller-reported ongoing
        count (which sees EVERY router's traffic plus the replica's own
        concurrency, ~1s stale).  max() rather than sum: the reported number
        already includes whatever of our in-flight work reached the replica."""
        return max(
            self._inflight.get(rep["replica_id"], 0),
            int(rep.get("queue_len", 0)),
        )

    def _pick_locked(self) -> Optional[Dict[str, Any]]:
        reps = [r for r in self._replicas if not r.get("draining")]
        if not reps:
            # every replica draining (replacements still starting): keep
            # serving on the draining ones — they're alive until the drain
            # deadline, and refusing would drop requests a drain promised
            # to preserve
            reps = list(self._replicas)
        if not reps:
            return None
        if len(reps) == 1:
            return reps[0]
        a, b = random.sample(reps, 2)
        return a if self._load(a) <= self._load(b) else b

    def _acquire_replica(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        """Pick a replica with free capacity, waiting on the capacity
        condition when saturated (bounded waits, visible in the
        ca_serve_backpressure_seconds histogram) instead of spinning."""
        deadline = time.monotonic() + 30.0
        t_wait0 = None
        while True:
            self._refresh()
            with self._capacity_cv:
                pick = self._pick_locked()
                if (
                    pick is not None
                    and self._inflight.get(pick["replica_id"], 0) < self._max_ongoing
                ):
                    if t_wait0 is not None:
                        _backpressure_metric().observe(
                            time.monotonic() - t_wait0, tags=self._metric_tags
                        )
                    return pick
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RuntimeError(
                        f"no available replica for {self.app}/{self.deployment}"
                    )
                if t_wait0 is None:
                    t_wait0 = time.monotonic()
                # bounded: completions notify; the cap also forces a
                # periodic membership refresh while saturated/empty
                self._capacity_cv.wait(timeout=min(0.25, remaining))
            if pick is None:
                self._refresh(force=True)

    def route(self, meta: Dict[str, Any], args, kwargs):
        """Blocking routing + submission; runs on the dispatch thread only.
        Returns the ObjectRef of the replica call."""
        pick = self._acquire_replica(meta)
        rid = pick["replica_id"]
        h = self._handle_for(rid, pick["actor_name"])
        with self._lock:
            self._inflight[rid] = self._inflight.get(rid, 0) + 1
        try:
            ref = h.handle_request.remote(meta, *args, **kwargs)
        except Exception:
            with self._lock:
                self._inflight[rid] -= 1
                self._capacity_cv.notify_all()
            raise
        self._watch_completion(rid, ref)
        return ref

    def route_streaming(self, meta: Dict[str, Any], args, kwargs):
        """Like route(), but invokes the replica's streaming twin and returns
        an ObjectRefGenerator.  Inflight is released at submit: stream
        lifetimes are unbounded (token generation), so queue-gating on them
        would starve the replica for regular traffic.  (The controller-side
        queue_len still counts streams — the replica's num_ongoing covers
        the stream's whole life — so P2C and drain retirement see them.)"""
        pick = self._acquire_replica(meta)
        h = self._handle_for(pick["replica_id"], pick["actor_name"])
        return h.handle_request_streaming.options(num_returns="streaming").remote(
            meta, *args, **kwargs
        )

    def _watch_completion(self, rid: str, ref):
        """One watcher thread per router drains completions in batches (a
        thread per request would be far too heavy for the request path)."""
        with self._watch_cv:
            self._watched.append((rid, ref))
            if self._watcher is None:
                self._watcher = threading.Thread(
                    target=self._watch_loop, daemon=True, name="serve-router-watch"
                )
                self._watcher.start()
            self._watch_cv.notify()

    def _watch_loop(self):
        while True:
            with self._watch_cv:
                while not self._watched:
                    self._watch_cv.wait()
                batch = list(self._watched)
            refs = [ref for _, ref in batch]
            ready, _ = ca.wait(refs, num_returns=len(refs), timeout=0.05)
            if not ready:
                continue
            done = set(id(r) for r in ready)
            with self._watch_cv:
                still = []
                for rid, ref in self._watched:
                    if id(ref) in done:
                        if rid in self._inflight:
                            self._inflight[rid] -= 1
                    else:
                        still.append((rid, ref))
                self._watched = still
                # capacity freed: wake saturated route() waiters
                self._capacity_cv.notify_all()


_router_cache: Dict[tuple, Router] = {}
_router_cache_lock = threading.Lock()


def _shared_router(app: str, deployment: str) -> Router:
    """One router (and dispatch thread) per deployment per process — handle
    objects are created freely (handle.method.remote()), routers are not."""
    key = (app, deployment)
    r = _router_cache.get(key)
    if r is None:
        with _router_cache_lock:
            r = _router_cache.get(key)
            if r is None:
                r = Router(app, deployment)
                _router_cache[key] = r
    return r


class DeploymentHandle:
    """Serializable handle to a deployment; each process lazily builds its own
    Router on first use."""

    def __init__(self, app: str, deployment: str, method: str = "__call__", multiplexed_model_id: str = ""):
        self.app = app
        self.deployment = deployment
        self._method = method
        self._multiplexed_model_id = multiplexed_model_id
        self._stream = False
        self._router: Optional[Router] = None

    # serialization: drop the router; the receiving process builds a new one
    def __getstate__(self):
        return {
            "app": self.app,
            "deployment": self.deployment,
            "_method": self._method,
            "_multiplexed_model_id": self._multiplexed_model_id,
            "_stream": self._stream,
        }

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._stream = state.get("_stream", False)
        self._router = None

    def options(
        self,
        *,
        method_name: Optional[str] = None,
        multiplexed_model_id: Optional[str] = None,
        stream: Optional[bool] = None,
    ) -> "DeploymentHandle":
        h = DeploymentHandle(
            self.app,
            self.deployment,
            method_name or self._method,
            multiplexed_model_id
            if multiplexed_model_id is not None
            else self._multiplexed_model_id,
        )
        h._stream = self._stream if stream is None else bool(stream)
        return h

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_") or name in ("app", "deployment"):
            raise AttributeError(name)
        h = DeploymentHandle(self.app, self.deployment, name, self._multiplexed_model_id)
        h._stream = self._stream  # h.options(stream=True).method.remote() keeps streaming
        return h

    def remote(self, *args, **kwargs):
        if self._router is None:
            self._router = _shared_router(self.app, self.deployment)
        meta = {
            "request_id": uuid.uuid4().hex,
            "method": self._method,
            "multiplexed_model_id": self._multiplexed_model_id,
        }
        # the dispatch thread starts with an empty context: carry the
        # caller's contextvars (ambient trace, log attribution) across so
        # the replica call joins the request's trace instead of losing it
        # at the thread hop
        ctx = contextvars.copy_context()
        if self._stream:
            fut = self._router._dispatch.submit(
                ctx.run, self._router.route_streaming, meta, args, kwargs
            )
            return DeploymentResponseGenerator(fut)
        fut = self._router._dispatch.submit(
            ctx.run, self._router.route, meta, args, kwargs
        )
        return DeploymentResponse(fut)

    def to_spec(self) -> Dict[str, str]:
        return {
            "__ca_serve_handle__": True,
            "app": self.app,
            "deployment": self.deployment,
        }
