"""gRPC ingress for Serve (reference serve/_private/proxy.py gRPCProxy:532).

Two surfaces on one port:

- TYPED (protos/serve.proto — compile it in any language):
  ``CAServeUserService/Call`` takes a CallRequest{application, payload}
  where payload is msgpack-encoded [args, kwargs] and returns a
  CallResponse{payload} of the msgpack-encoded result — no Python pickle
  anywhere, so non-Python clients are first-class.
  ``CAServeAPIService/{ListApplications,Healthz}`` is the management
  surface (reference RayServeAPIService analogue).
- LEGACY pickle: ``Ingress/Call`` with pickled (args, kwargs), app routing
  by metadata — kept for in-process Python callers shipping arbitrary
  objects.

Both route through the same controller-synced table the HTTP proxy uses.
Client side: ``grpc_call`` (pickle) / ``grpc_call_typed`` (proto+msgpack).
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Dict, Optional

from . import proto_wire

SERVICE = "cluster_anywhere_tpu.serve.Ingress"
METHOD = f"/{SERVICE}/Call"
USER_CALL = "/cluster_anywhere_tpu.serve.CAServeUserService/Call"
API_LIST = "/cluster_anywhere_tpu.serve.CAServeAPIService/ListApplications"
API_HEALTHZ = "/cluster_anywhere_tpu.serve.CAServeAPIService/Healthz"

_MAX_CALL_S = 60.0


def _deadline_s(context) -> float:
    """Block no longer than the client's RPC deadline (capped): a handler
    still waiting after the client gave up would pin one of the server's
    pool threads and starve Healthz/ListApplications."""
    remaining = context.time_remaining()
    if remaining is None:
        return _MAX_CALL_S
    return max(0.1, min(_MAX_CALL_S, remaining))


class GrpcProxyActor:
    """Serve's gRPC ingress: one generic unary-unary method, app routing by
    metadata, replica scheduling through DeploymentHandle."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        import grpc

        self._apps: Dict[str, Any] = {}  # app name -> DeploymentHandle
        self._lock = threading.Lock()

        outer = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                method = handler_call_details.method
                if method == METHOD:
                    md = dict(handler_call_details.invocation_metadata or ())
                    app = md.get("application", "default")

                    def _unary(request_bytes, context):
                        handle = outer._handle_for(app)
                        if handle is None:
                            context.abort(
                                grpc.StatusCode.NOT_FOUND,
                                f"no serve application {app!r}",
                            )
                        try:
                            args, kwargs = pickle.loads(request_bytes)
                            result = handle.remote(*args, **kwargs).result(
                                timeout_s=_deadline_s(context)
                            )
                            return pickle.dumps(result)
                        except Exception as e:  # noqa: BLE001 — surfaced as status
                            context.abort(grpc.StatusCode.INTERNAL, repr(e))

                elif method == USER_CALL:

                    def _unary(request_bytes, context):
                        import msgpack

                        try:
                            app, payload = proto_wire.decode_call_request(request_bytes)
                            args, kwargs = msgpack.unpackb(payload, raw=False)
                        except (ValueError, TypeError, msgpack.UnpackException) as e:
                            # malformed bytes from a non-Python client must
                            # say so, not surface as UNKNOWN with no detail
                            context.abort(
                                grpc.StatusCode.INVALID_ARGUMENT,
                                f"bad CallRequest: {e}",
                            )
                        handle = outer._handle_for(app or "default")
                        if handle is None:
                            context.abort(
                                grpc.StatusCode.NOT_FOUND,
                                f"no serve application {app!r}",
                            )
                        try:
                            result = handle.remote(*args, **kwargs).result(
                                timeout_s=_deadline_s(context)
                            )
                            return proto_wire.encode_call_response(
                                msgpack.packb(result, use_bin_type=True)
                            )
                        except Exception as e:  # noqa: BLE001 — surfaced as status
                            context.abort(grpc.StatusCode.INTERNAL, repr(e))

                elif method == API_LIST:

                    def _unary(request_bytes, context):
                        with outer._lock:
                            names = sorted(outer._apps)
                        return proto_wire.encode_list_applications_response(names)

                elif method == API_HEALTHZ:

                    def _unary(request_bytes, context):
                        return proto_wire.encode_healthz_response("success")

                else:
                    return None

                return grpc.unary_unary_rpc_method_handler(
                    _unary,
                    request_deserializer=None,  # raw bytes in
                    response_serializer=None,  # raw bytes out
                )

        from concurrent.futures import ThreadPoolExecutor

        self._server = grpc.server(ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((_Handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host
        self._server.start()
        self._refresher = threading.Thread(
            target=self._refresh_loop, daemon=True, name="grpc-proxy-routes"
        )
        self._refresher.start()

    def ready(self) -> str:
        return f"{self.host}:{self.port}"

    def _handle_for(self, app: str) -> Optional[Any]:
        with self._lock:
            return self._apps.get(app)

    def _refresh_loop(self):
        from ..core import api as ca
        from ..core.actor import get_actor
        from .controller import CONTROLLER_NAME
        from .router import DeploymentHandle

        while True:
            try:
                ctrl = get_actor(CONTROLLER_NAME)
                routes = ca.get(ctrl.list_routes.remote(), timeout=10)
                new = {
                    app: DeploymentHandle(app, info["ingress"])
                    for app, info in routes.items()
                    if info["ingress"]
                }
                with self._lock:
                    for app, h in new.items():
                        cur = self._apps.get(app)
                        if cur is None or cur.deployment != h.deployment:
                            self._apps[app] = h
                    for app in list(self._apps):
                        if app not in new:
                            del self._apps[app]
            except Exception:
                pass
            time.sleep(0.5)

    def stop(self):
        self._server.stop(grace=1.0)


def grpc_call(target: str, application: str, *args, timeout: float = 60.0, **kwargs):
    """Invoke a serve application through the gRPC ingress (legacy pickle)."""
    import grpc

    with grpc.insecure_channel(target) as channel:
        fn = channel.unary_unary(METHOD)
        out = fn(
            pickle.dumps((args, kwargs)),
            metadata=(("application", application),),
            timeout=timeout,
        )
        return pickle.loads(out)


def grpc_call_typed(target: str, application: str, *args, timeout: float = 60.0, **kwargs):
    """Invoke through the TYPED service (protos/serve.proto + msgpack) —
    exactly what a non-Python client would send after compiling the proto."""
    import grpc
    import msgpack

    with grpc.insecure_channel(target) as channel:
        fn = channel.unary_unary(USER_CALL)
        out = fn(
            proto_wire.encode_call_request(
                application,
                msgpack.packb([list(args), kwargs], use_bin_type=True),
            ),
            timeout=timeout,
        )
        return msgpack.unpackb(proto_wire.decode_call_response(out), raw=False)


def grpc_list_applications(target: str, timeout: float = 10.0):
    import grpc

    with grpc.insecure_channel(target) as channel:
        out = channel.unary_unary(API_LIST)(b"", timeout=timeout)
        return proto_wire.decode_list_applications_response(out)


def grpc_healthz(target: str, timeout: float = 10.0) -> str:
    import grpc

    with grpc.insecure_channel(target) as channel:
        out = channel.unary_unary(API_HEALTHZ)(b"", timeout=timeout)
        return proto_wire.decode_healthz_response(out)
