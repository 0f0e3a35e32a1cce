"""Replica actor: hosts one copy of a deployment's user callable (analogue of
python/ray/serve/_private/replica.py Replica + UserCallableWrapper).
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import time
from typing import Any, Dict, Optional

_request_context: contextvars.ContextVar = contextvars.ContextVar(
    "ca_serve_request_context", default=None
)


class RequestContext:
    def __init__(self, request_id: str = "", multiplexed_model_id: str = ""):
        self.request_id = request_id
        self.multiplexed_model_id = multiplexed_model_id


def get_request_context() -> RequestContext:
    ctx = _request_context.get()
    return ctx if ctx is not None else RequestContext()


_metrics_cache = {}


def _serve_metrics():
    """Per-request Prometheus series (reference serve metrics:
    ray_serve_deployment_request_counter / _processing_latency_ms — here
    ca_serve_requests_total / ca_serve_request_latency_seconds /
    ca_serve_request_errors_total, tagged by deployment).  Lazy: replicas
    that never serve a request register nothing."""
    if not _metrics_cache:
        from ..util import metrics as m

        _metrics_cache["requests"] = m.Counter(
            "ca_serve_requests_total", "serve requests handled",
            tag_keys=("deployment",),
        )
        _metrics_cache["errors"] = m.Counter(
            "ca_serve_request_errors_total", "serve requests errored",
            tag_keys=("deployment",),
        )
        _metrics_cache["latency"] = m.Histogram(
            "ca_serve_request_latency_seconds", "serve request latency",
            boundaries=[0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 1.0, 5.0],
            tag_keys=("deployment",),
        )
    return _metrics_cache


class Replica:
    """One replica process. Methods are async so many requests interleave on
    the actor's event loop up to max_ongoing_requests."""

    def __init__(
        self,
        payload: bytes,
        user_config: Optional[Dict[str, Any]],
        replica_id: str,
        handle_specs: Optional[Dict[str, Any]] = None,
        deployment_name: Optional[str] = None,
    ):
        import pickle

        # late-bind nested DeploymentHandles (model composition): bound
        # sub-deployments arrive as specs and materialize into handles here
        from .router import DeploymentHandle

        # serve.run's pickled (deployment_def, init_args, init_kwargs), which
        # the controller passes on unread
        deployment_def, init_args, init_kwargs = pickle.loads(payload)

        def resolve(v):
            if isinstance(v, dict) and v.get("__ca_serve_handle__"):
                return DeploymentHandle(v["app"], v["deployment"])
            if isinstance(v, list):
                return [resolve(x) for x in v]
            if isinstance(v, tuple):
                return tuple(resolve(x) for x in v)
            if isinstance(v, dict):
                return {k: resolve(x) for k, x in v.items()}
            return v

        init_args = tuple(resolve(a) for a in init_args)
        init_kwargs = {k: resolve(v) for k, v in init_kwargs.items()}
        self.replica_id = replica_id
        self._metric_tags = {"deployment": deployment_name or replica_id}
        self._is_function = not inspect.isclass(deployment_def)
        if self._is_function:
            self.instance = deployment_def
        else:
            self.instance = deployment_def(*init_args, **init_kwargs)
        self.num_ongoing = 0
        self.total_requests = 0
        if user_config is not None:
            self._apply_user_config(user_config)

    def _apply_user_config(self, cfg: Dict[str, Any]):
        fn = getattr(self.instance, "reconfigure", None)
        if fn is not None:
            fn(cfg)

    # ----------------------------------------------------------- control API
    def reconfigure(self, user_config: Dict[str, Any]):
        self._apply_user_config(user_config)
        return "ok"

    def check_health(self) -> str:
        fn = getattr(self.instance, "check_health", None)
        if fn is not None:
            fn()
        return "ok"

    def get_queue_len(self) -> int:
        return self.num_ongoing

    def telemetry(self) -> Dict[str, Any]:
        """One RPC for the controller's reconcile pass: liveness (raises if
        the user's check_health hook does), ongoing-request count (router
        P2C signal, drain retirement gate, autoscale input), and the hosting
        node (drain detection)."""
        fn = getattr(self.instance, "check_health", None)
        if fn is not None:
            fn()
        try:
            from ..core.worker import global_worker

            node_id = global_worker().node_id
        except Exception:
            node_id = None
        return {
            "queue_len": self.num_ongoing,
            "node_id": node_id,
            "total": self.total_requests,
        }

    def stats(self) -> Dict[str, Any]:
        return {
            "replica_id": self.replica_id,
            "num_ongoing": self.num_ongoing,
            "total": self.total_requests,
        }

    def prepare_shutdown(self) -> str:
        """Run user cleanup before the controller hard-kills the process —
        GC finalizers never fire on kill()."""
        fn = getattr(self.instance, "__del__", None)
        if fn is not None:
            try:
                fn()
            except Exception:
                pass
        return "ok"

    # ----------------------------------------------------------- request path
    async def handle_request(self, meta: Dict[str, Any], *args, **kwargs):
        self.num_ongoing += 1
        self.total_requests += 1
        mets = _serve_metrics()
        mets["requests"].inc(1, tags=self._metric_tags)
        t0 = time.perf_counter()
        token = _request_context.set(
            RequestContext(
                request_id=meta.get("request_id", ""),
                multiplexed_model_id=meta.get("multiplexed_model_id", ""),
            )
        )
        try:
            target = self.instance
            method_name = meta.get("method", "__call__")
            if self._is_function:
                fn = target
            else:
                fn = getattr(target, method_name)
            if inspect.iscoroutinefunction(fn):
                return await fn(*args, **kwargs)
            # sync user code must not block the replica's event loop
            loop = asyncio.get_running_loop()
            ctx = contextvars.copy_context()
            return await loop.run_in_executor(None, lambda: ctx.run(fn, *args, **kwargs))
        except Exception:
            # Exception only: client cancellation (CancelledError /
            # GeneratorExit are BaseException) is not a deployment error and
            # must not feed the errors series alerts watch
            mets["errors"].inc(1, tags=self._metric_tags)
            raise
        finally:
            mets["latency"].observe(
                time.perf_counter() - t0, tags=self._metric_tags
            )
            _request_context.reset(token)
            self.num_ongoing -= 1

    def handle_request_streaming(self, meta: Dict[str, Any], *args, **kwargs):
        """Generator twin of handle_request: iterates the user method's
        generator so items stream back as ObjectRefGenerator frames
        (reference replica.py streaming path)."""
        self.num_ongoing += 1
        self.total_requests += 1
        mets = _serve_metrics()
        mets["requests"].inc(1, tags=self._metric_tags)
        t0 = time.perf_counter()
        token = _request_context.set(
            RequestContext(
                request_id=meta.get("request_id", ""),
                multiplexed_model_id=meta.get("multiplexed_model_id", ""),
            )
        )
        try:
            target = self.instance
            fn = target if self._is_function else getattr(
                target, meta.get("method", "__call__")
            )
            out = fn(*args, **kwargs)
            if not hasattr(out, "__iter__") or isinstance(out, (str, bytes, dict)):
                yield out  # non-generator result: one-item stream
                return
            yield from out
        except Exception as e:
            # Exception only: client cancellation (CancelledError /
            # GeneratorExit are BaseException) is not a deployment error and
            # must not feed the errors series alerts watch.  TaskCancelledError
            # is the consumer abandoning the stream (proxy SSE disconnect) —
            # same story, different spelling.
            from ..core.errors import TaskCancelledError

            if not isinstance(e, TaskCancelledError):
                mets["errors"].inc(1, tags=self._metric_tags)
            raise
        finally:
            # latency covers the full stream (first byte to exhaustion)
            mets["latency"].observe(
                time.perf_counter() - t0, tags=self._metric_tags
            )
            _request_context.reset(token)
            self.num_ongoing -= 1
