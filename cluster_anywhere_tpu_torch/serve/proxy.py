"""HTTP proxy actor (analogue of python/ray/serve/_private/proxy.py
HTTPProxy/ProxyActor): a minimal asyncio HTTP/1.1 server that routes requests
by route prefix to application ingress deployments.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import traceback
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, unquote, urlparse

from ..util import flightrec
from ..util import tracing as _tracing
from ..util.aio import drain, spawn_logged

_proxy_metrics = {}


def _shed_metrics():
    """Admission-control + stream-lifecycle series (lazy like the replica's
    request metrics): ca_serve_shed_total{deployment,reason} counts requests
    refused at the gate; ca_serve_stream_abandoned_total{deployment} counts
    SSE streams whose client vanished mid-stream (their replica-side
    generators get cancelled, not left decoding)."""
    if not _proxy_metrics:
        from ..util import metrics as m

        _proxy_metrics["shed"] = m.Counter(
            "ca_serve_shed_total", "serve requests shed at the admission gate",
            tag_keys=("deployment", "reason"),
        )
        _proxy_metrics["abandoned"] = m.Counter(
            "ca_serve_stream_abandoned_total",
            "serve SSE streams abandoned by their client mid-stream",
            tag_keys=("deployment",),
        )
    return _proxy_metrics


class _Shed(Exception):
    """Admission refusal: HTTP code + reason + the Retry-After hint."""

    def __init__(self, code: int, reason: str, retry_after: float, limit: int):
        super().__init__(reason)
        self.code = code
        self.reason = reason
        self.retry_after = retry_after
        self.limit = limit


class _AdmissionState:
    """Per-deployment admission bookkeeping in THIS proxy: in-flight request
    count and summed token-cost estimate, gated by the deployment's
    AdmissionPolicy (refreshed with the route table)."""

    __slots__ = ("policy", "replicas", "max_ongoing", "inflight", "tokens")

    def __init__(self):
        self.policy = None  # dict from AdmissionPolicy.to_wire(), or None
        self.replicas = 1
        self.max_ongoing = 8
        self.inflight = 0
        self.tokens = 0


class Request:
    """What ingress callables receive for HTTP requests (a compact stand-in
    for the reference's starlette.requests.Request)."""

    def __init__(self, method: str, path: str, query_params: Dict[str, str], headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query_params = query_params
        self.headers = headers
        self._body = body

    def body(self) -> bytes:
        return self._body

    def json(self) -> Any:
        return json.loads(self._body or b"null")

    def text(self) -> str:
        return self._body.decode("utf-8", "replace")


class ProxyActor:
    def __init__(self, host: str, port: int):
        from ..core.worker import global_worker

        self.host = host
        self.port = port
        self._routes: Dict[str, Any] = {}  # route_prefix -> DeploymentHandle
        self._admission: Dict[str, _AdmissionState] = {}  # route_prefix ->
        self._routes_lock = threading.Lock()
        self._miss_lock = threading.Lock()
        self._refresh_gen = 0
        self._loop = global_worker().loop
        self._server = None
        self._started = threading.Event()
        self._start_error: Optional[str] = None
        fut = asyncio.run_coroutine_threadsafe(self._start_server(), self._loop)
        fut.result(timeout=30)
        self._refresher = threading.Thread(
            target=self._refresh_routes_loop, daemon=True, name="proxy-routes"
        )
        self._refresher.start()

    async def _start_server(self):
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        # port 0 asks the OS for a free port: report the one it bound
        self.port = self._server.sockets[0].getsockname()[1]

    def ready(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------ route sync
    def _refresh_routes_loop(self):
        while True:
            self._refresh_routes_once()
            time.sleep(0.5)

    def _miss_refresh(self):
        # true single-flight via a generation counter: a waiter whose miss
        # preceded a refresh that has since COMPLETED skips its own RPC —
        # a 404 burst costs one controller round-trip total, while the
        # serve.run() -> immediate-request race still gets a refresh that
        # finished after its miss.  Short RPC timeout: a dead controller
        # costs a miss ~2s, not 10.
        my_gen = self._refresh_gen
        with self._miss_lock:
            if self._refresh_gen != my_gen:
                return
            self._refresh_routes_once(rpc_timeout=2)
            self._refresh_gen += 1

    def _refresh_routes_once(self, rpc_timeout: float = 10):
        from ..core import api as ca
        from ..core.actor import get_actor
        from .controller import CONTROLLER_NAME
        from .router import DeploymentHandle

        try:
            ctrl = get_actor(CONTROLLER_NAME)
            routes = ca.get(ctrl.list_routes.remote(), timeout=rpc_timeout)
            new = {}
            for app, info in routes.items():
                if info["ingress"]:
                    new[info["route_prefix"]] = (DeploymentHandle(app, info["ingress"]), info)
            with self._routes_lock:
                # keep existing handles (their routers have warm caches)
                for prefix, (h, info) in new.items():
                    if prefix not in self._routes or (
                        self._routes[prefix].app != h.app
                        or self._routes[prefix].deployment != h.deployment
                    ):
                        self._routes[prefix] = h
                    # admission state rides the refresh: the policy is
                    # deployment config, capacity tracks the autoscaler
                    adm = self._admission.get(prefix)
                    if adm is None:
                        adm = self._admission[prefix] = _AdmissionState()
                    adm.policy = info.get("admission")
                    adm.replicas = int(info.get("replicas", 1) or 1)
                    adm.max_ongoing = int(info.get("max_ongoing_requests", 8))
                for prefix in list(self._routes):
                    if prefix not in new:
                        del self._routes[prefix]
                        self._admission.pop(prefix, None)
        except Exception:
            pass

    def _match(self, path: str):
        with self._routes_lock:
            best = None
            for prefix, handle in self._routes.items():
                norm = prefix.rstrip("/") or ""
                if path == norm or path.startswith(norm + "/") or prefix == "/":
                    if best is None or len(prefix) > len(best[0]):
                        best = (prefix, handle)
            return best

    # ---------------------------------------------------------- http server
    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        """One request per connection (responses carry Connection: close)."""
        req = None
        try:
            req = await self._read_request(reader)
        except asyncio.CancelledError:
            try:
                writer.close()
            except Exception:
                pass
            raise  # proxy shutdown: release the socket, stay cancelled
        except Exception:
            pass
        if req is None:
            # malformed/empty request: close or the fd leaks per connection
            try:
                writer.close()
            except Exception:
                pass
            return
        spawn_logged(self._dispatch(req, writer), "serve-proxy-dispatch")

    # request-size guards (ADVICE r1: unbounded header/body reads let a
    # client exhaust proxy memory); generous defaults, overridable per proxy
    MAX_HEADER_LINE = 16 * 1024
    MAX_HEADERS = 128
    MAX_BODY = 64 * 1024 * 1024
    # ... and a time guard: a client that dials and then goes silent must
    # not pin a proxy coroutine (and its fd) forever.  TimeoutError rides
    # the same close-and-drop path as a malformed request.
    READ_TIMEOUT_S = 30.0

    async def _read_request(self, reader) -> Optional[Request]:
        try:
            line = await asyncio.wait_for(reader.readline(), self.READ_TIMEOUT_S)
        except (asyncio.LimitOverrunError, ValueError):
            return None
        if not line or len(line) > self.MAX_HEADER_LINE:
            return None
        try:
            method, target, _ = line.decode("latin1").split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        n_lines = 0  # count lines, not dict keys: repeated names must still trip the cap
        while True:
            try:
                h = await asyncio.wait_for(reader.readline(), self.READ_TIMEOUT_S)
            except (asyncio.LimitOverrunError, ValueError):
                return None
            if h in (b"\r\n", b"\n", b""):
                break
            n_lines += 1
            if len(h) > self.MAX_HEADER_LINE or n_lines > self.MAX_HEADERS:
                return None
            k, _, v = h.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        try:
            n = int(headers.get("content-length", 0) or 0)
        except ValueError:
            return None
        if n < 0 or n > self.MAX_BODY:
            return None
        if n:
            body = await asyncio.wait_for(reader.readexactly(n), self.READ_TIMEOUT_S)
        parsed = urlparse(target)
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        return Request(method.upper(), unquote(parsed.path), query, headers, body)

    # ------------------------------------------------------------- admission
    @staticmethod
    def _estimate_tokens(policy: Dict[str, Any], req: Request) -> int:
        """Token-cost estimate for the budget gate: prompt chars/4 +
        max_new_tokens when the body (or query) carries them, else the
        policy's default.  Deliberately cheap and rough — the gate bounds
        aggregate decode work, it doesn't meter exact usage."""
        body: Dict[str, Any] = {}
        default = int(policy.get("default_request_tokens") or 64)
        if len(req._body) > 256 * 1024:
            # don't json-parse megabyte prompts on the event loop just for
            # an estimate: for a body this large the prompt dominates —
            # charge its size directly
            return max(1, default + len(req._body) // 4)
        try:
            if req.method == "POST" and req._body[:1] in (b"{", b"["):
                parsed = json.loads(req._body)
                if isinstance(parsed, dict):
                    body = parsed
            elif req.query_params:
                body = dict(req.query_params)
        except Exception:
            pass
        try:
            new_toks = int(body["max_new_tokens"]) if "max_new_tokens" in body else None
        except (TypeError, ValueError):
            new_toks = None
        prompt = body.get("prompt")
        prompt_toks = len(str(prompt)) // 4 if isinstance(prompt, (str, bytes)) else 0
        if new_toks is None and not prompt_toks:
            return default
        return max(1, (new_toks if new_toks is not None else default) + prompt_toks)

    def _try_admit(self, prefix: str, req: Request):
        """Admission gate.  Returns (None, 0) when no policy applies,
        (adm, tokens) when admitted, or raises _Shed with the refusal.
        The token estimate (a json.loads of the body) runs OUTSIDE the
        routes lock — holding it there would serialize every concurrent
        dispatch/release/refresh behind one request's body parse; the
        verdict + reservation then re-check under the lock atomically."""
        with self._routes_lock:
            adm = self._admission.get(prefix)
            pol = adm.policy if adm is not None else None
        if pol is None:
            return None, 0
        tokens = (
            self._estimate_tokens(pol, req)
            if pol.get("max_tokens_in_flight") is not None
            else 0
        )
        with self._routes_lock:
            adm = self._admission.get(prefix)
            if adm is None or adm.policy is None:
                return None, 0  # route/policy changed mid-check: admit
            pol = adm.policy
            depth = pol.get("max_queue_depth")
            if depth is None:
                depth = max(
                    1,
                    int(
                        float(pol.get("queue_depth_factor") or 2.0)
                        * max(1, adm.replicas) * adm.max_ongoing
                    ),
                )
            retry = float(pol.get("retry_after_s") or 1.0)
            if adm.inflight >= depth:
                raise _Shed(503, "queue_depth", retry, depth)
            budget = pol.get("max_tokens_in_flight")
            if budget is not None:
                if adm.tokens + tokens > int(budget):
                    raise _Shed(429, "token_budget", retry, int(budget))
            else:
                tokens = 0
            adm.inflight += 1
            adm.tokens += tokens
            return adm, tokens

    def _release(self, adm, tokens: int):
        if adm is not None:
            with self._routes_lock:
                adm.inflight -= 1
                adm.tokens -= tokens

    async def _dispatch(self, req: Request, writer: asyncio.StreamWriter):
        admitted = None
        # cross-plane trace (tentpole): adopt the client's W3C traceparent
        # header, or mint a root when tracing is enabled — the request span
        # parents every downstream task/stream, so `ca timeline` renders
        # proxy -> replica -> channel ops as one connected trace
        tr_in = _tracing.parse_traceparent(req.headers.get("traceparent"))
        if tr_in is not None:
            tr_req = {
                "tid": tr_in["tid"], "sid": _tracing.new_span_id(),
                "psid": tr_in["sid"],
            }
        elif _tracing.is_enabled():
            tr_req = {"tid": _tracing.new_trace_id(), "sid": _tracing.new_span_id()}
        else:
            tr_req = None
        wire = {"tid": tr_req["tid"], "sid": tr_req["sid"]} if tr_req else None
        tr_hdr = {"traceparent": _tracing.format_traceparent(wire)} if wire else None
        t0 = time.time()
        try:
            match = self._match(req.path)
            if match is None:
                # a route deployed milliseconds ago may not have reached the
                # 0.5s poller yet: EVERY miss gets one fresh look at the
                # controller before 404ing, serialized through one lock so a
                # 404 burst (scanners, favicon probes) queues behind a
                # single in-flight RPC instead of flooding the controller
                loop = asyncio.get_running_loop()
                await loop.run_in_executor(None, self._miss_refresh)
                match = self._match(req.path)
            if match is None:
                await self._respond(writer, 404, {"error": f"no route for {req.path}"})
                return
            prefix, handle = match
            dep_tag = {"deployment": f"{handle.app}/{handle.deployment}"}
            try:
                admitted = self._try_admit(prefix, req)
            except _Shed as s:
                # load-shedding: refuse NOW with Retry-After instead of
                # queueing unboundedly — past the saturation knee a bounded
                # queue is the only way p99 stays bounded
                _shed_metrics()["shed"].inc(1, tags={**dep_tag, "reason": s.reason})
                if flightrec.REC is not None:
                    flightrec.REC.record(
                        "serve", "serve_shed",
                        deployment=dep_tag["deployment"], reason=s.reason,
                        code=s.code, limit=s.limit, path=req.path,
                        **({"trace": wire} if wire else {}),
                    )
                await self._respond(
                    writer, s.code,
                    {"error": "request shed", "reason": s.reason, "limit": s.limit},
                    extra_headers={"Retry-After": f"{s.retry_after:g}", **(tr_hdr or {})},
                )
                return
            loop = asyncio.get_running_loop()
            if "text/event-stream" in req.headers.get("accept", ""):
                # SSE: iterate the deployment's generator, one event per item
                # (reference proxy StreamingResponse path; LLM token streams)
                await self._respond_sse(
                    writer, handle, req, loop, dep_tag, wire=wire, tr_hdr=tr_hdr
                )
                return

            # handle.remote() blocks briefly (routing) and result() blocks
            # until done — run both off the event loop.  run_in_executor does
            # NOT propagate contextvars, so the request trace is installed
            # inside the worker thread, around the submission.
            def _call():
                if wire is None:
                    return handle.remote(req).result(timeout_s=60)
                tok = _tracing.push_execution(wire)
                try:
                    return handle.remote(req).result(timeout_s=60)
                finally:
                    _tracing.pop_execution(tok)

            result = await loop.run_in_executor(None, _call)
            await self._respond(writer, 200, result, extra_headers=tr_hdr)
        except asyncio.CancelledError:
            try:
                writer.close()
            except Exception:
                pass
            raise  # proxy shutdown: don't dress cancellation up as a 500
        except Exception as e:
            traceback.print_exc()
            await self._respond(writer, 500, {"error": repr(e)})
        finally:
            if admitted is not None:
                self._release(*admitted)
            if tr_req is not None:
                w = _tracing._current_worker()
                _tracing.record_task_event(
                    "", f"serve:{req.method} {req.path}", "span", "SPAN",
                    trace=tr_req,
                    worker_id=w.client_id if w is not None else None,
                    node_id=w.node_id if w is not None else None,
                    start=t0, end=time.time(),
                )

    async def _open_stream(self, handle, req: Request, loop, wire=None):
        """Open the token stream for one SSE request: one streaming-RPC
        frame per token.  The compiled-DAG transport (a pre-opened shm
        channel per request) comes with the port of dag/ and channel/
        (ROADMAP Queue 1 item 4)."""

        def _traced(fn):
            # executor threads start with a fresh context: install the
            # request trace around the submission so the replica-side spans
            # chain under the proxy's span
            if wire is None:
                return fn

            def wrapped():
                tok = _tracing.push_execution(wire)
                try:
                    return fn()
                finally:
                    _tracing.pop_execution(tok)

            return wrapped

        return await loop.run_in_executor(
            None, _traced(lambda: handle.options(stream=True).remote(req))
        )

    async def _respond_sse(self, writer, handle, req: Request, loop, dep_tag=None,
                           wire=None, tr_hdr=None):
        import json as _json
        import queue as _queue

        extras = "".join(f"{k}: {v}\r\n" for k, v in (tr_hdr or {}).items())
        writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n" + extras.encode()
            + b"Connection: close\r\n\r\n"
        )
        await drain(writer)
        q: _queue.Queue = _queue.Queue(maxsize=64)
        _END = object()
        abandoned = threading.Event()
        resp_gen = await self._open_stream(handle, req, loop, wire=wire)

        def qput(item) -> bool:
            # abandonment-aware put: a dead consumer stops reading the
            # queue, so a plain put() would block this thread forever once
            # the buffer fills — but a merely SLOW consumer must still get
            # every item (especially _END: dropping it would hang the
            # consumer and leak its admission slot), so keep trying until
            # delivered or abandoned.
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        def pump():
            try:
                for item in resp_gen:
                    if not qput(item):
                        return
            except Exception as e:  # noqa: BLE001 — forwarded as an event
                qput({"error": repr(e)})
            finally:
                qput(_END)

        loop.run_in_executor(None, pump)
        try:
            while True:
                item = await loop.run_in_executor(None, q.get)
                if item is _END:
                    break
                if isinstance(item, bytes):
                    data = item.decode("utf-8", "replace")
                elif isinstance(item, str):
                    data = item
                else:
                    data = _json.dumps(item, default=str)
                try:
                    writer.write(f"data: {data}\n\n".encode())
                    # bounded: a consumer that stops reading mid-stream must
                    # not pin this coroutine (or the replica's generator)
                    await drain(writer)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # client went away mid-stream: cancel the replica-side
                    # generator — the bounded buffer only protected MEMORY;
                    # without this the replica keeps decoding tokens nobody
                    # will ever read.  cancel() can block briefly on an
                    # unresolved routing future, so it runs off-loop.
                    abandoned.set()
                    loop.run_in_executor(None, resp_gen.cancel)
                    _shed_metrics()["abandoned"].inc(
                        1, tags=dep_tag or {"deployment": f"{handle.app}/{handle.deployment}"}
                    )
                    if flightrec.REC is not None:
                        flightrec.REC.record(
                            "serve", "serve_stream_abandoned",
                            deployment=(dep_tag or {}).get(
                                "deployment", f"{handle.app}/{handle.deployment}"
                            ),
                            path=req.path,
                            **({"trace": wire} if wire else {}),
                        )
                    return
        except asyncio.CancelledError:
            # proxy shutdown: stop the upstream too, then stay cancelled
            abandoned.set()
            loop.run_in_executor(None, resp_gen.cancel)
            raise
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _respond(self, writer, code: int, payload: Any, extra_headers=None):
        try:
            if isinstance(payload, bytes):
                body, ctype = payload, "application/octet-stream"
            elif isinstance(payload, str):
                body, ctype = payload.encode(), "text/plain; charset=utf-8"
            else:
                body, ctype = json.dumps(_json_default(payload)).encode(), "application/json"
            status = {
                200: "OK",
                404: "Not Found",
                429: "Too Many Requests",
                500: "Internal Server Error",
                503: "Service Unavailable",
            }.get(code, "OK")
            extras = "".join(
                f"{k}: {v}\r\n" for k, v in (extra_headers or {}).items()
            )
            writer.write(
                f"HTTP/1.1 {code} {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"{extras}"
                f"Connection: close\r\n\r\n".encode() + body
            )
            await drain(writer)
            writer.close()
        except asyncio.CancelledError:
            try:
                writer.close()
            except Exception:
                pass
            raise
        except Exception:
            pass


def _json_default(obj):
    import numpy as np

    if isinstance(obj, dict):
        return {k: _json_default(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_default(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
