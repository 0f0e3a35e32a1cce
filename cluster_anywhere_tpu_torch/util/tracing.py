"""Cluster-wide distributed tracing (analogue of the reference's
python/ray/util/tracing/tracing_helper.py, which propagates OpenTelemetry
context through every task/actor submission, plus the per-task state machine
GcsTaskManager exports as a Chrome timeline).

Three planes, one buffer:

* **Trace context.**  `enable()` turns on trace generation: every `remote()`
  submission mints a span under the ambient trace context (a fresh trace id
  at the driver, the executing task's context inside a worker) and the
  context rides the RPC as a small optional ``tr`` field on the logical
  message (`core/protocol.TRACE_FIELD`) — batch-envelope splicing carries
  whole message bodies, so the field survives corking untouched.  Workers
  install the received context as ambient for the executing thread/coroutine,
  so nested submissions and `span()` blocks chain into one trace.

* **Task lifecycle events.**  Submission-side (SUBMITTED / QUEUED /
  SCHEDULED, recorded by `core/worker.py`) and execution-side (RUNNING /
  FINISHED / FAILED, recorded by `core/workerproc.py`) phases land in this
  module's per-process buffer via `record_task_event()` and ship to the
  head's 50k `task_events` ring on the existing ``task_events`` notify path
  (drained by every Worker's housekeeping loop).  Terminal events always
  flow (tracing off or on); the richer phases and the ``tr`` wire field are
  gated on `enable()` so the disabled submit fast path pays one branch.

* **Export.**  `util/state.timeline()` / `ca timeline` assemble the ring
  into Chrome-trace/Perfetto JSON with causal flow arrows between the
  submit and execute spans; `span("name")` records nested app spans into
  the same buffer (and a `ca_trace_span_seconds` histogram).

Device hook: `enable_torch_profiling()` (called automatically by `enable()`
when torch is already imported) samples each initialised CUDA device's
allocator into `ca_device_memory_bytes` gauges at each metrics flush.  The
port compiles nothing at run time beyond its kernels' first build, so there
is no compile histogram.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from . import metrics

_enabled = False
_patched = False
_patch_lock = threading.Lock()
_submit_hist: Optional[metrics.Histogram] = None
_span_hist: Optional[metrics.Histogram] = None

# ambient trace context for the current thread/coroutine:
# {"tid": trace id, "sid": span id[, "psid": parent span id]}
_ctx: "contextvars.ContextVar[Optional[Dict[str, str]]]" = contextvars.ContextVar(
    "ca_trace_ctx", default=None
)

# ------------------------------------------------------------- event buffer
# Per-process lifecycle/span event buffer, drained by Worker._housekeeping
# onto the head's `task_events` ring.  Appends come from user threads,
# executor threads and the IO loop alike; a plain lock keeps it simple (the
# hot disabled path never reaches here).
_events_lock = threading.Lock()
_events: List[dict] = []
_EVENTS_CAP = 100_000  # headless processes (no flusher) must not grow forever

# lazily bound core.worker.try_global_worker (a top-level import would be
# circular: util.state imports core.worker at import time)
_try_global_worker = None


def _current_worker():
    global _try_global_worker
    if _try_global_worker is None:
        from ..core.worker import try_global_worker

        _try_global_worker = try_global_worker
    return _try_global_worker()


def record_task_event(
    task_id: str,
    name: Optional[str],
    kind: str,
    state: str,
    *,
    trace: Optional[Dict[str, str]] = None,
    worker_id: Optional[str] = None,
    node_id: Optional[str] = None,
    ts: Optional[float] = None,
    **extra: Any,
) -> None:
    """Buffer one lifecycle event (thread-safe).  Terminal events pass
    start=/end= through `extra` and keep the legacy schema the state API
    reads; phase events carry only `ts`."""
    ev: Dict[str, Any] = {
        "task_id": task_id,
        "name": name,
        "type": kind,
        "state": state,
        "ts": time.time() if ts is None else ts,
        "worker_id": worker_id,
        "node_id": node_id,
    }
    if trace:
        ev["trace"] = trace
    if extra:
        ev.update(extra)
    with _events_lock:
        _events.append(ev)
        if len(_events) > _EVENTS_CAP:
            del _events[: _EVENTS_CAP // 2]


def drain_events() -> List[dict]:
    """Take the buffered events (called by the housekeeping flusher)."""
    global _events
    if not _events:
        return []
    with _events_lock:
        out, _events = _events, []
    return out


def restage_events(evs: List[dict]) -> None:
    """Put drained events back (head unreachable at send time)."""
    if not evs:
        return
    with _events_lock:
        _events[:0] = evs


# ------------------------------------------------------------ trace context
def is_enabled() -> bool:
    return _enabled


def new_trace_id() -> str:
    return os.urandom(8).hex()


def new_span_id() -> str:
    return os.urandom(4).hex()


def current() -> Optional[Dict[str, str]]:
    """The ambient trace context of this thread/coroutine (None = no trace)."""
    return _ctx.get()


def begin_task_trace(
    task_id: str, name: str, kind: str, worker_id: str, node_id: str
) -> Optional[Dict[str, str]]:
    """Mint the submit span for a task submission under the ambient trace
    (a fresh trace at the root) and record its SUBMITTED event.  Returns the
    wire context: {"tid", "sid"} — the executing side parents on "sid".

    Returns None when there is nothing to trace: a worker process armed only
    by an incoming traced task (hook set, tracing not locally enabled) must
    not mint fresh root traces for unrelated submissions."""
    parent = _ctx.get()
    if parent is None:
        if not _enabled:
            return None
        ctx = {"tid": new_trace_id(), "sid": new_span_id()}
    else:
        ctx = {"tid": parent["tid"], "sid": new_span_id(), "psid": parent["sid"]}
    record_task_event(
        task_id, name, kind, "SUBMITTED",
        trace=ctx, worker_id=worker_id, node_id=node_id,
    )
    return {"tid": ctx["tid"], "sid": ctx["sid"]}


def _ensure_hook() -> None:
    """Arm the submission-side hook in this process.  Workers never call
    enable(); receiving a traced task is the signal that this process's
    nested submissions must propagate context."""
    from ..core import worker as worker_mod

    if worker_mod.TRACE_HOOK is None:
        worker_mod.TRACE_HOOK = sys.modules[__name__]


def push_execution(tr: Dict[str, str]):
    """Install a received wire context as the ambient context of the
    executing thread/coroutine (the execute span parents on the submit
    span).  Returns a token for `pop_execution`."""
    _ensure_hook()
    ctx = {"tid": tr["tid"], "sid": new_span_id(), "psid": tr["sid"]}
    return _ctx.set(ctx)


def pop_execution(token) -> None:
    _ctx.reset(token)


# --------------------------------------------------------- W3C traceparent
# Serve HTTP requests carry trace context as a standard `traceparent`
# header (https://www.w3.org/TR/trace-context/): 00-<32hex>-<16hex>-<flags>.
# Internal ids are shorter (16-hex trace, 8-hex span) so formatting
# zero-pads; parsing keeps the incoming ids verbatim — ids are opaque
# strings everywhere in this codebase, so an externally-minted 32-hex trace
# id flows through tasks, spans and the flight recorder unchanged.
def format_traceparent(tr: Dict[str, str]) -> str:
    tid = (tr.get("tid") or "")[:32].ljust(32, "0")
    sid = (tr.get("sid") or "")[:16].ljust(16, "0")
    return f"00-{tid}-{sid}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Dict[str, str]]:
    """Parse an incoming traceparent into a wire context {"tid", "sid"}
    (the receiving side parents on "sid", exactly like a task's tr field).
    Returns None on anything malformed — a bad header is not an error,
    just an untraced request."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    tid, sid = parts[1], parts[2]
    try:
        int(tid, 16), int(sid, 16)
    except ValueError:
        return None
    if int(tid, 16) == 0 or int(sid, 16) == 0:
        return None
    # strip the zero-padding format_traceparent added so internally-minted
    # ids round-trip to their native width
    if tid.endswith("0" * 16) and int(tid[:16], 16):
        tid = tid[:16]
    if sid.endswith("0" * 8) and int(sid[:8], 16):
        sid = sid[:8]
    return {"tid": tid, "sid": sid}


# ------------------------------------------------------------------ enable
def enable():
    """Idempotently enable tracing: trace-context generation + propagation,
    lifecycle phase events, submit-latency/span histograms, and (when torch
    is already loaded) the device-memory gauges."""
    global _enabled, _patched, _submit_hist, _span_hist
    with _patch_lock:
        already_patched, _patched = _patched, True
        if _enabled:
            return
        _enabled = True
        _submit_hist = metrics.Histogram(
            "ca_trace_submit_latency_seconds",
            "client-side remote() submission latency",
            tag_keys=("kind", "name"),
        )
        _span_hist = metrics.Histogram(
            "ca_trace_span_seconds", "custom app spans", tag_keys=("name",)
        )

    # submission-side trace hook: core/worker.py checks this module ref with
    # one attribute load + branch per submission (no call, no allocation on
    # the disabled path)
    from ..core import worker as worker_mod

    worker_mod.TRACE_HOOK = sys.modules[__name__]

    if "torch" in sys.modules:
        enable_torch_profiling()

    if already_patched:
        return

    from ..core import actor as actor_mod
    from ..core import remote_function as rf_mod

    orig_task = rf_mod.RemoteFunction._remote

    def traced_task(self, args, kwargs, opts):
        if not _enabled:
            return orig_task(self, args, kwargs, opts)
        t0 = time.perf_counter()
        try:
            return orig_task(self, args, kwargs, opts)
        finally:
            _submit_hist.observe(
                time.perf_counter() - t0,
                {"kind": "task", "name": getattr(self._function, "__name__", "?")},
            )

    rf_mod.RemoteFunction._remote = traced_task

    orig_actor = actor_mod.ActorHandle._submit

    def traced_actor(self, method, args, kwargs, opts):
        if not _enabled:
            return orig_actor(self, method, args, kwargs, opts)
        t0 = time.perf_counter()
        try:
            return orig_actor(self, method, args, kwargs, opts)
        finally:
            _submit_hist.observe(
                time.perf_counter() - t0, {"kind": "actor", "name": method}
            )

    actor_mod.ActorHandle._submit = traced_actor


def disable():
    """Turn tracing back off (the monkeypatches stay installed but inert)."""
    global _enabled
    _enabled = False
    from ..core import worker as worker_mod

    worker_mod.TRACE_HOOK = None


# -------------------------------------------------------------------- spans
@contextlib.contextmanager
def span(name: str):
    """Record a custom application span.  Attaches to the ambient trace
    context (the executing task's trace inside a worker; spans nest), lands
    in the lifecycle event buffer for `timeline()` assembly, and observes
    the ca_trace_span_seconds histogram.

    Active when tracing is locally enabled OR the span runs inside a traced
    execution (worker processes never call enable(); the ambient context is
    the signal there).  An inactive span installs NO context — otherwise a
    disabled-tracing span block would make every nested span/remote() look
    traced and leak events onto the wire."""
    parent = _ctx.get()
    active = _enabled or parent is not None
    ctx = token = None
    if active:
        if parent is None:
            ctx = {"tid": new_trace_id(), "sid": new_span_id()}
        else:
            ctx = {"tid": parent["tid"], "sid": new_span_id(), "psid": parent["sid"]}
        token = _ctx.set(ctx)
    t0 = time.time()
    p0 = time.perf_counter()
    try:
        yield ctx
    finally:
        if token is not None:
            _ctx.reset(token)
        dur = time.perf_counter() - p0
        # inactive spans touch nothing — after disable() the histogram must
        # stop mutating too, not just the event stream
        if active and _span_hist is not None:
            _span_hist.observe(dur, {"name": name})
        if active:
            w = _current_worker()
            record_task_event(
                "", name, "span", "SPAN",
                trace=ctx,
                worker_id=w.client_id if w is not None else None,
                node_id=w.node_id if w is not None else None,
                start=t0,
                end=t0 + dur,
            )


# ------------------------------------------------------------- device hook
_torch_hooked = False

# torch.cuda.memory_stats() key -> the gauge's `kind` tag
_MEMORY_KINDS = {
    "allocated_bytes.all.current": "bytes_in_use",
    "allocated_bytes.all.peak": "peak_bytes_in_use",
    "reserved_bytes.all.current": "bytes_reserved",
}


def enable_torch_profiling() -> bool:
    """Surface device memory in the same pipeline: `ca_device_memory_bytes`
    gauges sampled from the CUDA caching allocator at each metrics flush.
    Only a process that already opened CUDA is sampled (sampling never
    creates a context).  Returns False when torch is not loaded — callers
    treat that as "nothing to profile", never an error."""
    global _torch_hooked
    if _torch_hooked:
        return True
    torch = sys.modules.get("torch")
    if torch is None:
        return False

    mem_gauge = metrics.Gauge(
        "ca_device_memory_bytes",
        "per-device memory stats from the CUDA caching allocator",
        tag_keys=("device", "kind"),
    )

    def _sample_device_memory():
        try:
            if not torch.cuda.is_initialized():
                return
            n = torch.cuda.device_count()
        except Exception:
            return
        for i in range(n):
            try:
                stats = torch.cuda.memory_stats(i)
            except Exception:
                continue
            for key, kind in _MEMORY_KINDS.items():
                if key in stats:
                    mem_gauge.set(float(stats[key]), {"device": f"cuda:{i}", "kind": kind})

    metrics.register_flush_hook(_sample_device_memory)
    _torch_hooked = True
    return True
