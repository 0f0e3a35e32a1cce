"""Worker process main: executes pushed tasks and hosts actors.

The analogue of the reference's worker-side TaskReceiver + scheduling queues
(src/ray/core_worker/transport/task_receiver.h): a unix-socket server receives
direct task pushes from drivers/other workers, executes them on an executor
(single thread by default; a pool for max_concurrency>1; the asyncio loop for
async-def actor methods), and replies with inline / shm / device-ref results.

Each worker process embeds a full Worker runtime so task code can itself call
remote()/get()/put() (nested tasks), sharing the process's asyncio loop.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import os
import sys
import threading
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from . import serialization
from .config import CAConfig, set_config
from .errors import TaskCancelledError, TaskError
from .ids import ActorID, ObjectID, TaskID
from .object_ref import ObjectRef
from .protocol import (
    TRACE_FIELD,
    MsgTemplate,
    Server,
    spawn_bg,
    write_frame,
    write_frame_body,
)

# completion replies on the fast path share one pre-encoded prefix; per reply
# only the request id and the results payload are packed.  Batched with
# whatever else the cork holds this tick, so a burst of completions travels
# worker→submitter as a few envelope frames (amortized acks).
_REPLY_TMPL = MsgTemplate({"ok": True}, ("i", "results"))
from .worker import Worker, _device_spec, _is_device_value, set_global_worker

# imported after .worker so the util package's own core imports resolve
# against a fully-initialized module
from ..util import logplane, tracing


class ActorContext:
    def __init__(self, actor_id: str, instance: Any, max_concurrency: int, incarnation: int):
        self.actor_id = actor_id
        self.instance = instance
        self.max_concurrency = max_concurrency
        self.incarnation = incarnation
        # concurrency groups (concurrency_group_manager.h): named thread
        # pools; methods are routed by their @method(concurrency_group=...)
        self.group_executors: Dict[str, Any] = {}
        # same bound for async methods, which run on the event loop rather
        # than a thread pool (fiber-concurrency analogue)
        self.group_semaphores: Dict[str, Any] = {}


class WorkerProcess:
    def __init__(self):
        self.session_dir = os.environ["CA_SESSION_DIR"]
        self.head_sock = os.environ["CA_HEAD_SOCK"]
        self.worker_id = os.environ["CA_WORKER_ID"]
        self.sock_path = os.environ["CA_WORKER_SOCK"]
        self.config = CAConfig.from_json(os.environ["CA_CONFIG_JSON"])
        set_config(self.config)
        self.node_id = os.environ.get("CA_NODE_ID", "n0")
        if self.config.log_capture:
            # log plane capture: stdout/stderr pass through to the raw .log
            # fd AND stamp each line (task/actor identity from the ambient
            # execution context) into nodes/<node_id>/<wid>.jsonl, which the
            # node's agent (or the head, on n0) tails and ships to drivers
            logplane.install_capture(
                self.session_dir, self.node_id, self.worker_id,
                max_bytes=self.config.log_rotate_bytes,
            )
        self.loop = asyncio.new_event_loop()
        if hasattr(asyncio, "eager_task_factory"):
            self.loop.set_task_factory(asyncio.eager_task_factory)
        self.worker: Optional[Worker] = None
        # dual-bind: unix for same-host peers, a TCP dual so remote (Ray-
        # Client-analogue) drivers can push tasks/actor calls directly
        specs = [self.sock_path]
        if not self.sock_path.startswith("tcp:"):
            host = getattr(self.config, "head_host", "127.0.0.1")
            specs.append(f"tcp:{host}:0")
        self.server = Server(specs, self._handle, fast_handler=self._fast_handle)
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ca-exec"
        )
        # compiled-DAG loops (__ca_exec__) live for the DAG's lifetime and
        # block on channel reads; hosting them on the actor's single dispatch
        # executor would freeze every other sync RPC to this actor for as
        # long as a DAG is compiled.  Lazy dedicated pool instead — one
        # thread per live loop, created on first compile.
        self._dag_executor: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self.actor: Optional[ActorContext] = None
        self._exiting = False
        # producer-side backpressure state per streaming task:
        # task_id -> {"acked": int, "event": threading.Event}
        self._streams: Dict[bytes, dict] = {}
        # task_id -> executing thread id (cancellation target)
        self._running_tasks: Dict[bytes, int] = {}
        # cancels that arrived BEFORE their task started executing (the push
        # may still be resolving args / fetching the function definition):
        # checked at _exec_sync entry.  FIFO-capped — a stale entry for a
        # task that already finished elsewhere must not pin memory forever.
        self._precancelled: "deque[bytes]" = deque(maxlen=1024)
        # every task id a cancel was ever requested for on this worker: lets
        # the execution wrapper distinguish a LEGITIMATE TaskCancelledError
        # from one that was async-delivered into the wrong task (the target
        # finished and the pool thread moved on in the race window).
        # FIFO-capped: eviction drops OLDEST marks first (a clear() could
        # wipe a mark whose async exception is still in flight)
        self._cancel_requested: "deque[bytes]" = deque(maxlen=1024)
        # async actor-method tasks in flight: task_id -> asyncio.Task
        # (cancellation for coroutines is task.cancel(), not async exc)
        self._async_running: Dict[bytes, Any] = {}
        # task_id -> rusage probe at execution start (metrics plane: the
        # terminal event carries CPU%/RSS/arena deltas derived from it)
        self._task_rusage0: Dict[bytes, dict] = {}

    # ----------------------------------------------------------- args/results
    def _resolve_arg(self, spec: dict) -> Any:
        if "v" in spec:
            if "t" in spec:
                # seed ack routing before unpack: a failed unpack raises out
                # of here, and the submitter's pin cleanup (sender liveness)
                # must not be confused by a misrouted late ack
                self.worker._note_transit_owners(spec)
            from ..channel.device_transport import maybe_unpack

            value = maybe_unpack(serialization.unpack(spec["v"]))
            if "t" in spec:
                # ack smuggled refs: our rehydrated handles are registered,
                # release the sender's transit pin (borrowing protocol)
                self.worker.transit_done(spec["t"], spec["roids"])
            return value
        if "shm" in spec:
            from .errors import StaleObjectError

            name = spec["shm"]
            if not self.worker.shm_store.is_local(name):
                # arg lives on another node: pull it over (runs on the
                # executor thread; the transfer itself rides the IO loop)
                name = self.worker.ensure_local_shm_blocking(
                    spec["oid"], name, spec.get("size", 0)
                )
            try:
                return self.worker.shm_store.get(name)
            except (StaleObjectError, FileNotFoundError):
                # the slice moved since the spec was minted (GC+recycle or
                # spill): re-resolve through the directory
                name = self.worker.ensure_local_shm_blocking(
                    spec["oid"], None, spec.get("size", 0)
                )
                return self.worker.shm_store.get(name)
        if "dev" in spec:
            oid = spec["dev"]
            if spec.get("owner") == self.sock_path and oid in self.worker.device_objects:
                # the owner's own device value: the stored object itself
                return self.worker.device_objects[oid]
            reply = asyncio.run_coroutine_threadsafe(
                self.worker._fetch_remote_async(spec["owner"], oid), self.loop
            ).result(self.config.push_timeout_s)
            from ..channel.device_transport import maybe_unpack

            # a DeviceEnvelope lands on this process's device (DTensor
            # leaves over its registered mesh)
            return maybe_unpack(serialization.unpack(reply["packed"]))
        raise ValueError(f"bad arg spec keys: {list(spec)}")

    def _resolve_args(self, specs, kwspecs):
        args = [self._resolve_arg(s) for s in specs]
        kwargs = {k: self._resolve_arg(s) for k, s in (kwspecs or {}).items()}
        return args, kwargs

    def _package_result(self, oid_bytes: bytes, value: Any, owner: str) -> dict:
        if _is_device_value(value):
            from ..channel.device_transport import settle

            # the device value stays here: its producer's work must be done
            # before a fetch packs it on another thread
            settle(value)
            self.worker.device_objects[oid_bytes] = value
            return {"dev": oid_bytes, "owner": self.sock_path, "spec": _device_spec(value)}
        with serialization.ref_capture() as nested:
            data, buffers = serialization.serialize(value)
        raws = [b.raw() for b in buffers]
        total = len(data) + sum(len(r) for r in raws)
        if total < self.config.inline_object_max_bytes:
            if nested:
                # returned value smuggles ObjectRefs: pin them under a
                # transit token until the submitter's handles register
                token = self.worker.transit_pin(nested)
                return {
                    "v": serialization.pack(value), "t": token, "roids": nested,
                    "rown": self.worker.transit_owners(nested),
                }
            return {"v": serialization.pack(value)}
        oid = ObjectID(oid_bytes)
        shm_name, size = self.worker.shm_store.create_and_pack(oid, data, raws)
        if nested:
            self.worker._promote_nested(nested)
        # ownership of the returned object belongs to the *submitter*
        # (reference ownership model): it decides when the segment dies.
        self.worker._notify_threadsafe(
            "obj_created", oid=oid_bytes, shm_name=shm_name, size=size, owner=owner
        )
        out = {"shm": shm_name, "size": size}
        if nested:
            # refs inside the stored value live as long as it does: edges
            # register at each nested ref's lifetime authority under the
            # SUBMITTER's edge id, and the pairs travel with the result so
            # the submitter's ledger releases them when the container dies
            pairs = self.worker.result_contains_pairs(oid_bytes, nested, owner)
            if pairs is None:
                self.worker._notify_threadsafe(
                    "obj_contains", oid=oid_bytes, refs=nested
                )
            else:
                out["contains"] = pairs
        return out

    def _package_results(
        self, task_id: bytes, num_returns: int, value: Any, owner: str
    ) -> List[dict]:
        tid = TaskID(task_id)
        if num_returns == 1:
            values = [value]
        else:
            if not isinstance(value, (tuple, list)) or len(value) != num_returns:
                raise TaskError(
                    f"task declared num_returns={num_returns} but returned {type(value).__name__}"
                )
            values = list(value)
        return [
            self._package_result(ObjectID.for_return(tid, i).binary(), v, owner)
            for i, v in enumerate(values)
        ]

    def _error_results(self, num_returns: int, exc: BaseException) -> List[dict]:
        import pickle

        from .errors import CAError

        # CAError subclasses keep their type across the wire: the submitter
        # reacts to them (e.g. ObjectLostError triggers lineage
        # reconstruction); everything else becomes a TaskError with traceback
        if not isinstance(exc, CAError):
            tb = traceback.format_exc()
            # the last lines this worker printed travel with the error: the
            # caller sees what the task said right before it died without a
            # separate `ca logs` round-trip
            tail = logplane.recent_lines(20)
            if tail:
                tb += (
                    "\n--- last captured worker output ---\n"
                    + "\n".join(tail)
                    + "\n"
                )
            exc = TaskError(repr(exc), tb)
        blob = pickle.dumps(exc)
        return [{"e": blob} for _ in range(num_returns)]

    # --------------------------------------------------------------- execute
    def _exec_sync(self, fn, msg, task_id: bytes, actor_id: Optional[str]) -> List[dict]:
        """Arg resolution + user code + result packaging in ONE executor job
        (per-caller actor-call ordering preserved end-to-end, one thread
        hop).  TaskCancelledError delivered here when the task was never
        actually cancel-requested means the async exception landed in the
        wrong task (cancel raced the pool thread finishing its target and
        starting us): re-run once — same at-least-once semantics as a
        worker-death retry."""
        tr = msg.get(TRACE_FIELD)
        token = None
        # log-plane attribution for everything this task prints (always on,
        # unlike the trace context which only rides traced submissions)
        ltok = logplane.push_context(
            task=task_id.hex(),
            actor=actor_id,
            name=msg.get("method") or getattr(fn, "__name__", "task"),
        )
        if tr is not None:
            # install the submitter's trace context as ambient for this
            # executor thread: nested remote() calls and tracing.span()
            # blocks inside user code chain into the same trace
            token = tracing.push_execution(tr)
            self._record_running(
                task_id,
                msg.get("method") or getattr(fn, "__name__", "task"),
                "actor_task" if actor_id else "task",
                tr,
            )
        try:
            return self._exec_sync_inner(fn, msg, task_id, actor_id)
        except TaskCancelledError:
            if task_id in self._cancel_requested:
                try:
                    self._cancel_requested.remove(task_id)
                except ValueError:
                    pass
                raise
            if msg.get("retriable", True):
                return self._exec_sync_inner(fn, msg, task_id, actor_id)
            raise TaskError(
                "task interrupted by a cancellation aimed at another task "
                "and declared non-retriable (max_retries=0)"
            )
        except BaseException as e:
            # CA_POST_MORTEM=1 (reference RAY_DEBUG_POST_MORTEM role): serve
            # a remote pdb on the failure frame before the error propagates.
            # Runs on the executor thread, so the worker's IO loop (and its
            # health checks) stay live while a human is attached.
            if os.environ.get("CA_POST_MORTEM") == "1" and not isinstance(
                e, (SystemExit, KeyboardInterrupt)
            ):
                try:
                    from ..util.rpdb import post_mortem

                    post_mortem(e)
                except Exception:
                    pass
            raise
        finally:
            logplane.pop_context(ltok)
            if token is not None:
                tracing.pop_execution(token)
            if self._cancel_requested or self._precancelled:
                # backstop for the delivery race: retract any async
                # exception still pending on THIS thread before it returns
                # to the pool (an escape there kills the executor thread)
                import ctypes

                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(threading.get_ident()), None
                )

    def _exec_sync_inner(self, fn, msg, task_id: bytes, actor_id: Optional[str]) -> List[dict]:
        args, kwargs = self._resolve_args(msg["args"], msg.get("kwargs"))
        w = self.worker
        w.current_task_id = TaskID(task_id)
        if actor_id:
            w.current_actor_id = ActorID.from_hex(actor_id)
        ctx = None
        # cancellation point: ca.cancel() raises TaskCancelledError in this
        # thread via PyThreadState_SetAsyncExc (task_canceller.h role); a
        # cancel that raced ahead of execution start fires here instead
        if task_id in self._precancelled:
            try:
                self._precancelled.remove(task_id)
            except ValueError:
                pass
            w.current_task_id = None
            raise TaskCancelledError("task was cancelled")
        self._running_tasks[task_id] = threading.get_ident()
        try:
            if msg.get("runtime_env"):
                from .runtime_env import RuntimeEnvContext

                ctx = RuntimeEnvContext(msg["runtime_env"], w)
                ctx.apply()  # inside try: a partial apply must still restore
            value = fn(*args, **kwargs)
        finally:
            self._running_tasks.pop(task_id, None)
            w.current_task_id = None
            if ctx is not None:
                ctx.restore()  # pool workers are reused
        return self._package_results(
            task_id, msg.get("num_returns", 1), value, msg.get("owner", "")
        )

    def _h_cancel_task(self, msg):
        """Owner-requested cancellation of a task running HERE.  Non-force:
        raise TaskCancelledError inside the executing thread (CPython async
        exception — lands at the next bytecode boundary, so C-level blocking
        calls are not interruptible; that is what force is for).  Force:
        hard-exit the process; the owner maps the resulting worker death to
        TaskCancelledError instead of a retry."""
        task_id = msg["task_id"]
        self._cancel_requested.append(task_id)
        atask = self._async_running.get(task_id)
        if atask is not None:
            # coroutine actor method: asyncio cancellation is exact (no
            # async-exc race).  force cannot rely on cooperation (the method
            # may suppress CancelledError): hard-exit if it is still running
            # after a grace period
            atask.cancel()
            if msg.get("force"):
                def _enforce():
                    if task_id in self._async_running:
                        os._exit(1)

                self.loop.call_later(1.0, _enforce)
            return
        if msg.get("force"):
            if task_id in self._running_tasks:
                os._exit(1)
            # not running yet: the pre-cancel check at _exec_sync entry stops
            # it before user code, which force semantics subsume
            self._precancelled.append(task_id)
            return
        tid = self._running_tasks.get(task_id)
        if tid is None:
            # the push may still be resolving args / fetching the function:
            # remember the cancel so execution start aborts (finished tasks
            # leave a harmless FIFO-capped entry; the owner no-ops those)
            self._precancelled.append(task_id)
            return
        import ctypes

        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(tid), ctypes.py_object(TaskCancelledError)
        )
        if self._running_tasks.get(task_id) != tid:
            # the target finished between lookup and delivery: try to
            # retract before the pending exception fires in whatever that
            # thread runs next (best-effort; the _exec_sync wrapper's
            # trailing clear is the backstop)
            ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(tid), None)

    def _arena_bytes(self) -> Optional[int]:
        """Live bytes in this worker's shm arenas (metrics-plane resource
        attribution on terminal task events); None when unavailable."""
        try:
            return sum(
                a.size - sum(sz for _, sz in a.free)
                for a in self.worker.shm_store._arenas.values()
            )
        except Exception:
            return None

    def _record_event(
        self, task_id: bytes, name: str, kind: str, t0: float, ok: bool,
        trace: Optional[dict] = None,
    ):
        import time as _time

        extra = {}
        p0 = self._task_rusage0.pop(task_id, None)
        if p0 is not None:
            # CPU%/RSS/arena sample pair bracketing the task: rides the
            # task-event path into timeline()/`ca summary` (process-wide
            # numbers — concurrent tasks on one worker share them)
            from ..util import profiler

            try:
                extra["rusage"] = profiler.rusage_delta(
                    t0, p0, self._arena_bytes()
                )
            except Exception:
                pass
        tracing.record_task_event(
            task_id.hex(), name, kind,
            "FINISHED" if ok else "FAILED",
            trace=trace,
            worker_id=self.worker_id,
            node_id=self.worker.node_id if self.worker is not None else None,
            actor_id=self.actor.actor_id if self.actor else None,
            start=t0,
            end=_time.time(),
            **extra,
        )

    def _record_running(self, task_id: bytes, name: Optional[str], kind: str, tr: dict):
        """Lifecycle RUNNING phase (only for traced tasks: `tr` came over
        the wire, so tracing was enabled at the submitter)."""
        tracing.record_task_event(
            task_id.hex(), name, kind, "RUNNING",
            trace=tr,
            worker_id=self.worker_id,
            node_id=self.worker.node_id if self.worker is not None else None,
        )

    async def _execute(self, msg, is_actor_call: bool) -> List[dict]:
        import time as _time

        num_returns = msg.get("num_returns", 1)
        task_id = msg.get("task_id") or os.urandom(16)
        t0 = _time.time()
        from ..util import profiler as _profiler

        self._task_rusage0[task_id] = _profiler.rusage_probe()
        tr = msg.get(TRACE_FIELD)
        ev_name = msg.get("method") if is_actor_call else None
        try:
            if is_actor_call:
                if self.actor is None or self.actor.actor_id != msg["actor_id"]:
                    raise TaskError(f"actor {msg.get('actor_id')} not hosted here")
                if msg["method"] == "__ca_exec__":
                    # built-in escape hatch: first arg is a function applied to
                    # the actor instance (used by compiled DAG loops; analogue
                    # of the reference's __ray_call__)
                    inst = self.actor.instance

                    def method(fn, *a, **kw):
                        return fn(inst, *a, **kw)

                else:
                    method = getattr(self.actor.instance, msg["method"])
                if asyncio.iscoroutinefunction(method):
                    args, kwargs = await self.loop.run_in_executor(
                        None, self._resolve_args, msg["args"], msg.get("kwargs")
                    )
                    sem = self._semaphore_for(method)
                    async with sem if sem is not None else contextlib.nullcontext():
                        # tracked so ca.cancel() can asyncio-cancel it.  The
                        # ambient trace context is installed around task
                        # creation only: coroutines snapshot it then, so the
                        # method body (and anything it submits) is traced
                        # without leaking context onto the shared loop
                        token = None
                        # the coroutine snapshots the ambient context at task
                        # creation: log attribution and (when traced) trace
                        # context both ride into the method body
                        ltok = logplane.push_context(
                            task=task_id.hex(), actor=msg["actor_id"],
                            name=msg["method"],
                        )
                        if tr is not None:
                            token = tracing.push_execution(tr)
                            self._record_running(task_id, ev_name, "actor_task", tr)
                        try:
                            coro_task = asyncio.ensure_future(method(*args, **kwargs))
                        finally:
                            logplane.pop_context(ltok)
                            if token is not None:
                                tracing.pop_execution(token)
                        self._async_running[task_id] = coro_task
                        if task_id in self._precancelled:
                            # cancel landed while args resolved / semaphore
                            # queued: apply it now instead of dropping it
                            try:
                                self._precancelled.remove(task_id)
                            except ValueError:
                                pass
                            coro_task.cancel()
                        try:
                            value = await coro_task
                        # the CancelledError is coro_task's (ca.cancel /
                        # precancel landed on the CHILD task), not this
                        # dispatch task's: converting it to the cancel
                        # protocol's reply is the designed behavior
                        except asyncio.CancelledError:  # ca-lint: ignore[async-swallowed-cancel]
                            raise TaskCancelledError("task was cancelled")
                        finally:
                            self._async_running.pop(task_id, None)
                    out = await self.loop.run_in_executor(
                        None,
                        self._package_results,
                        task_id,
                        num_returns,
                        value,
                        msg.get("owner", ""),
                    )
                    self._record_event(task_id, ev_name, "actor_task", t0, True, trace=tr)
                    return out
                sem = self._semaphore_for(method)
                async with sem if sem is not None else contextlib.nullcontext():
                    ex = (
                        self._dag_pool()
                        if msg["method"] == "__ca_exec__"
                        else self._executor_for(method)
                    )
                    out = await self.loop.run_in_executor(
                        ex,
                        self._exec_sync, method, msg, task_id, msg["actor_id"],
                    )
                self._record_event(task_id, ev_name, "actor_task", t0, True, trace=tr)
                return out
            fn = self.worker.fn_manager.get(msg["fn_id"])
            if fn is None:
                if msg.get("fn_blob") is not None:
                    # definition inlined by a submitter that saw the head
                    # down — no head dependency on this push at all
                    fn = self.worker.fn_manager.load(msg["fn_id"], msg["fn_blob"])
                else:
                    fn = await self._fetch_function(msg["fn_id"])
            ev_name = getattr(fn, "__name__", "task")
            out = await self.loop.run_in_executor(
                self.executor, self._exec_sync, fn, msg, task_id, None
            )
            self._record_event(task_id, ev_name, "task", t0, True, trace=tr)
            return out
        except SystemExit:
            self._exiting = True
            self._task_rusage0.pop(task_id, None)
            if self.actor is not None:
                try:
                    self.worker.head.notify("actor_exited", actor_id=self.actor.actor_id)
                except Exception:
                    pass
            return self._error_results(num_returns, TaskError("actor exited via exit_actor()"))
        except asyncio.CancelledError:
            raise  # worker shutdown: the peer sees the drop, not a "result"
        except BaseException as e:
            self._record_event(
                task_id,
                ev_name or "task",
                "actor_task" if is_actor_call else "task",
                t0,
                False,
                trace=tr,
            )
            return self._error_results(num_returns, e)

    # ------------------------------------------------------------- streaming
    def _exec_streaming(self, fn, msg, writer, actor_id: Optional[str]):
        """Run a generator task on the executor thread, streaming each yield
        to the submitter with bounded unconsumed items (generator_waiter.h
        backpressure).  Returns the frames-level terminal reply fields."""
        import time as _time

        task_id = msg.get("task_id") or os.urandom(16)
        owner = msg.get("owner", "")
        limit = self.config.streaming_backpressure
        stream = {"acked": 0, "event": threading.Event()}
        self._streams[task_id] = stream
        # generator tasks are cancellable too (async exc lands between
        # yields; force kills the process like any running task)
        self._running_tasks[task_id] = threading.get_ident()
        t0 = _time.time()
        from ..util import profiler as _profiler

        self._task_rusage0[task_id] = _profiler.rusage_probe()
        idx = 0
        tr = msg.get(TRACE_FIELD)
        token = None
        ltok = logplane.push_context(
            task=task_id.hex(), actor=actor_id,
            name=msg.get("method") or getattr(fn, "__name__", "stream"),
        )
        if tr is not None:
            token = tracing.push_execution(tr)
            self._record_running(
                task_id, getattr(fn, "__name__", "stream"), "task", tr
            )
        try:
            args, kwargs = self._resolve_args(msg["args"], msg.get("kwargs"))
            w = self.worker
            w.current_task_id = TaskID(task_id)
            try:
                gen = fn(*args, **kwargs)
                for item in gen:
                    # backpressure: wait for the consumer before running ahead
                    while idx - stream["acked"] >= limit:
                        stream["event"].clear()
                        if idx - stream["acked"] < limit:
                            break  # ack landed between check and clear
                        if not stream["event"].wait(self.config.push_timeout_s):
                            raise TaskError(
                                "streaming consumer stalled past the timeout"
                            )
                    res = self._package_result(
                        ObjectID.for_return(TaskID(task_id), idx).binary(), item, owner
                    )

                    def _push(res=res, i=idx):
                        write_frame(
                            writer,
                            {"m": "stream_item", "task_id": task_id, "idx": i, "res": res},
                        )

                    self.loop.call_soon_threadsafe(_push)
                    idx += 1
            finally:
                w.current_task_id = None
            self._record_event(
                task_id, getattr(fn, "__name__", "stream"), "task", t0, True,
                trace=tr,
            )
            return {"results": [], "stream_end": True, "count": idx}
        except TaskCancelledError as e:
            self._record_event(
                task_id, getattr(fn, "__name__", "stream"), "task", t0, False,
                trace=tr,
            )
            if task_id not in self._cancel_requested:
                # stray delivery (cancel aimed at a task this thread just
                # finished): a stream cannot re-run mid-way, so surface an
                # explicit error rather than a false "cancelled"
                e = TaskError(
                    "stream interrupted by a cancellation aimed at another task"
                )
            else:
                try:
                    self._cancel_requested.remove(task_id)
                except ValueError:
                    pass
            err = self._error_results(1, e)[0]["e"]
            return {"results": [], "stream_end": True, "count": idx, "stream_error": err}
        except BaseException as e:
            self._record_event(
                task_id, getattr(fn, "__name__", "stream"), "task", t0, False,
                trace=tr,
            )
            err = self._error_results(1, e)[0]["e"]
            return {"results": [], "stream_end": True, "count": idx, "stream_error": err}
        finally:
            logplane.pop_context(ltok)
            if token is not None:
                tracing.pop_execution(token)
            self._streams.pop(task_id, None)
            self._running_tasks.pop(task_id, None)
            if self._cancel_requested or self._precancelled:
                # same backstop as _exec_sync: retract a pending async
                # exception before this pool thread is reused
                import ctypes

                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(threading.get_ident()), None
                )

    def _h_stream_ack(self, msg):
        stream = self._streams.get(msg["task_id"])
        if stream is not None:
            stream["acked"] = max(stream["acked"], msg["consumed"])
            stream["event"].set()

    # --------------------------------------------------------------- handlers
    def _fast_handle(self, state, msg, writer) -> bool:
        """Synchronous hot path run directly in the server read loop: execute
        sync tasks/actor calls by handing the executor a job whose done-
        callback writes the reply — no per-frame asyncio Task, no coroutine.
        Returns False to fall back to the general async handler (async
        methods, uncached functions, control RPCs)."""
        m = msg.get("m")
        if msg.get("num_returns") == "streaming":
            return False  # generator tasks take the streaming path
        if m == "actor_call":
            ctx = self.actor
            if ctx is None or ctx.actor_id != msg.get("actor_id"):
                return False
            name = msg.get("method")
            if name == "__ca_exec__":
                return False
            fn = getattr(ctx.instance, name, None)
            if fn is not None and self._semaphore_for(fn) is not None:
                # grouped methods take the slow path so the group semaphore
                # is the single width gate across sync/async/streaming
                return False
            if fn is None or asyncio.iscoroutinefunction(fn):
                return False
            self._submit_fast(fn, msg, writer, msg["actor_id"], "actor_task", name)
            return True
        if m == "push_task":
            fn = self.worker.fn_manager.get(msg["fn_id"])
            if fn is None:
                return False  # definition needs a head fetch: slow path
            self._submit_fast(
                fn, msg, writer, None, "task", getattr(fn, "__name__", "task")
            )
            return True
        if m == "stream_ack":
            self._h_stream_ack(msg)
            return True
        return False

    def _executor_for(self, fn):
        """Route a method to its concurrency group's thread pool (default:
        the actor's main executor)."""
        if self.actor is not None and self.actor.group_executors:
            group = getattr(fn, "__ca_method_options__", {}).get("concurrency_group")
            if group is not None:
                ex = self.actor.group_executors.get(group)
                if ex is not None:
                    return ex
        return self.executor

    def _dag_pool(self):
        """Dedicated executor for compiled-DAG loops, pinned off the RPC
        dispatch path: the cap bounds runaway compiles, not steady state
        (one thread per concurrently-compiled DAG on this actor)."""
        if self._dag_executor is None:
            self._dag_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="ca-dag-loop"
            )
        return self._dag_executor

    def _semaphore_for(self, fn):
        """Concurrency-group bound for async methods: thread pools can't cap
        coroutines, so declared groups get an asyncio.Semaphore of the same
        width. Ungrouped async methods stay unbounded (interleaving is the
        point of an async actor)."""
        if self.actor is None or not self.actor.group_semaphores:
            return None
        group = getattr(fn, "__ca_method_options__", {}).get("concurrency_group")
        if group is None:
            return None
        return self.actor.group_semaphores.get(group)

    def _submit_fast(self, fn, msg, writer, actor_id, kind, ev_name):
        import time as _time

        rid = msg.get("i")
        task_id = msg.get("task_id") or os.urandom(16)
        num_returns = msg.get("num_returns", 1)
        t0 = _time.time()

        def job():
            ok = True
            exited_actor = None
            try:
                results = self._exec_sync(fn, msg, task_id, actor_id)
            except SystemExit:
                self._exiting = True
                results = self._error_results(
                    num_returns, TaskError("actor exited via exit_actor()")
                )
                if self.actor is not None:
                    exited_actor = self.actor.actor_id
            except BaseException as e:
                ok = False
                results = self._error_results(num_returns, e)

            def finish():
                # notify/write only from the loop thread (the cork needs a
                # running loop); actor_exited must precede the process death
                # so the head records a graceful exit, not a crash-to-restart
                if exited_actor is not None:
                    try:
                        self.worker.head.notify("actor_exited", actor_id=exited_actor)
                    except Exception:
                        pass
                if rid is not None:
                    write_frame_body(writer, _REPLY_TMPL.render(rid, results))
                self._record_event(task_id, ev_name, kind, t0, ok, trace=msg.get(TRACE_FIELD))
                if self._exiting:
                    spawn_bg(self._graceful_exit())

            self.loop.call_soon_threadsafe(finish)

        self._executor_for(fn).submit(job)

    async def _handle(self, state, msg, reply, reply_err):
        m = msg["m"]
        if msg.get("num_returns") == "streaming" and m in ("push_task", "actor_call"):
            fn = await self._resolve_callable(msg, is_actor_call=(m == "actor_call"))
            if isinstance(fn, dict):  # resolution error -> terminal reply
                reply(**fn)
                return
            sem = self._semaphore_for(fn)
            async with sem if sem is not None else contextlib.nullcontext():
                out = await self.loop.run_in_executor(
                    self._executor_for(fn), self._exec_streaming, fn, msg,
                    state["writer"], msg.get("actor_id"),
                )
            reply(**out)
        elif m == "push_task":
            results = await self._execute(msg, is_actor_call=False)
            reply(results=results)
        elif m == "actor_call":
            results = await self._execute(msg, is_actor_call=True)
            reply(results=results)
            if self._exiting:
                await self._graceful_exit()
        elif m == "stream_ack":
            self._h_stream_ack(msg)
        elif m == "spawn_actor":
            try:
                await self._spawn_actor(msg)
                reply()
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                reply_err(TaskError(repr(e), traceback.format_exc()))
        elif m == "fetch_object":
            try:
                reply(packed=await self._fetch_object(msg["oid"]))
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                reply_err(e)
        elif m == "owner_locate":
            # ownership-based object directory read path: this process is
            # authoritative for objects it owns (see Worker.owner_locate_async)
            reply(**await self.worker.owner_locate_async(msg["oid"]))
        elif m == "owner_refs":
            # ownership plane write path: a borrower settling inc/dec
            # against this process's OwnerLedger (worker<->worker, no head)
            self.worker.serve_owner_refs(
                msg.get("inc"), msg.get("dec"),
                msg.get("as_id") or state.get("client_id", "?"),
                bool(msg.get("ttl")),
            )
            reply()
        elif m == "owner_transit_done":
            self.worker.serve_owner_transit_done(
                msg["token"], msg.get("oids"), msg.get("cid", "?"),
                msg.get("register", True),
            )
            reply()
        elif m == "owner_pin":
            reply(**self.worker.serve_owner_pin(msg["oid"], msg["as_id"]))
        elif m == "coll_push":
            # p2p collective transport: land the chunk in the rank mailbox
            # (meta rides along for quantized payloads — scales, block size)
            self.worker.coll_deliver(
                msg["group"], msg["key"], msg["src"],
                msg["data"], msg["shape"], msg["dtype"],
                msg.get("meta"),
            )
            reply()
        elif m == "profile":
            # metrics plane: in-process stack sampler (`ca profile`).  Runs
            # on the loop's DEFAULT executor, never the task executor — the
            # busy task being profiled is occupying that one, and the whole
            # point is to observe it
            from ..util import profiler

            res = await self.loop.run_in_executor(
                None, profiler.sample_stacks,
                float(msg.get("duration", 2.0)), float(msg.get("hz", 100.0)),
            )
            reply(
                folded=profiler.render_folded(res["folded"]),
                speedscope=profiler.speedscope_json(
                    res["folded"], f"worker {self.worker_id}", res["hz"]
                ),
                samples=res["samples"],
                duration_s=res["duration_s"],
            )
        # operator liveness probe (BlockingClient / manual socket debugging):
        # ca-lint: ignore[rpc-dead-handler]
        elif m == "ping":
            reply(worker_id=self.worker_id, actor=self.actor.actor_id if self.actor else None)
        elif m == "cancel":
            self._h_cancel_task(msg)
            reply()
        else:
            reply_err(ValueError(f"unknown worker method {m}"))

    async def _fetch_function(self, fn_id):
        """Fetch + load a function blob from the head, riding through a head
        restart: the task asking for it was legitimately pushed (lease-plane
        grants keep flowing while the control plane is down), so a transient
        head outage must not turn it into a spurious TaskError.  The
        housekeeping loop redials; this retries until the push timeout."""
        deadline = self.loop.time() + self.worker.config.push_timeout_s
        while True:
            # a concurrent push may have inlined the definition (submitters
            # ship fn_blob once per connection during head outages) — the
            # local cache beats another head round-trip
            fn = self.worker.fn_manager.get(fn_id)
            if fn is not None:
                return fn
            try:
                reply = await self.worker.head.call("get_function", fn_id=fn_id)
                break
            except ConnectionError:
                if self.loop.time() > deadline:
                    raise
                await asyncio.sleep(0.5)
        return self.worker.fn_manager.load(fn_id, reply["blob"])

    async def _resolve_callable(self, msg, is_actor_call: bool):
        """Resolve the task function / actor method for the streaming path.
        Returns the callable, or a terminal-reply dict on failure."""
        try:
            if is_actor_call:
                if self.actor is None or self.actor.actor_id != msg["actor_id"]:
                    raise TaskError(f"actor {msg.get('actor_id')} not hosted here")
                return getattr(self.actor.instance, msg["method"])
            fn = self.worker.fn_manager.get(msg["fn_id"])
            if fn is None:
                if msg.get("fn_blob") is not None:
                    fn = self.worker.fn_manager.load(msg["fn_id"], msg["fn_blob"])
                else:
                    fn = await self._fetch_function(msg["fn_id"])
            return fn
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            err = self._error_results(1, e)[0]["e"]
            return {"results": [], "stream_end": True, "count": 0, "stream_error": err}

    async def _spawn_actor(self, msg):
        cls = self.worker.fn_manager.get(msg["fn_id"])
        if cls is None:
            reply = await self.worker.head.call("get_function", fn_id=msg["fn_id"])
            cls = self.worker.fn_manager.load(msg["fn_id"], reply["blob"])
        specs, kwspecs = serialization.unpack(msg["init_spec"])
        max_concurrency = msg.get("max_concurrency", 1)
        if max_concurrency > 1:
            self.executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=max_concurrency, thread_name_prefix="ca-exec"
            )
        group_executors = {
            name: concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, int(n)), thread_name_prefix=f"ca-cg-{name}"
            )
            for name, n in (msg.get("concurrency_groups") or {}).items()
        }

        def _make():
            if msg.get("runtime_env"):
                # dedicated actor process: the env applies for its lifetime
                from .runtime_env import RuntimeEnvContext

                RuntimeEnvContext(msg["runtime_env"], self.worker).apply()
            args, kwargs = self._resolve_args(specs, kwspecs)
            return cls(*args, **kwargs)

        instance = await self.loop.run_in_executor(self.executor, _make)
        self.actor = ActorContext(
            msg["actor_id"], instance, max_concurrency, msg.get("incarnation", 0)
        )
        self.actor.group_executors = group_executors
        self.actor.group_semaphores = {
            name: asyncio.Semaphore(max(1, int(n)))
            for name, n in (msg.get("concurrency_groups") or {}).items()
        }
        self.worker.current_actor_id = ActorID.from_hex(msg["actor_id"])

    async def _fetch_object(self, oid: bytes) -> bytes:
        value = self.worker.device_objects.get(oid)
        if value is None:
            e = self.worker.memory_store.get_entry(ObjectID(oid))
            if e is None or e.state == "pending":
                raise KeyError(f"object {oid.hex()} not found on this worker")
            # resolve on an executor thread, NOT the IO loop: the full
            # recovery path (confirmed pins, relocation after spill,
            # reconstruction) drives RPCs through the loop and would
            # deadlock/degrade if entered from it
            value = await self.loop.run_in_executor(
                None, self.worker._resolve_entry, ObjectRef(ObjectID(oid))
            )
        if _is_device_value(value):
            # device-native: each CUDA leaf copied once to the host and
            # handed out of band (channel/device_transport), never pickled
            # as bytes.  The copy runs on an executor thread, not the IO
            # loop, or a multi-GB transfer stalls heartbeats and RPC
            # serving; the value was settled when it was stored, so that
            # thread's stream reads finished data
            from ..channel.device_transport import pack_device_value

            return await self.loop.run_in_executor(
                None, lambda: serialization.pack(pack_device_value(value))
            )
        return await self.loop.run_in_executor(None, serialization.pack, value)

    async def _graceful_exit(self):
        await asyncio.sleep(0.05)  # let replies flush
        os._exit(0)

    async def _heartbeat_loop(self):
        period = self.config.health_check_period_s / 2
        while True:
            await asyncio.sleep(min(period, 1.0))
            try:
                self.worker.head.notify("heartbeat", client_id=self.worker_id)
            except Exception:
                pass

    # ------------------------------------------------------------------ main
    async def _amain(self):
        # start serving first: with "tcp:host:0" the advertised address is
        # only known after bind (agent-spawned workers on other nodes)
        await self.server.start()
        self.sock_path = self.server.bound_addrs[0]
        addr_tcp = next(
            (a for a in self.server.bound_addrs if a.startswith("tcp:")), None
        )
        self.worker = Worker(
            mode="worker",
            session_dir=self.session_dir,
            head_sock=self.head_sock,
            config=self.config,
            client_id=self.worker_id,
            loop=self.loop,
            serve_addr=self.sock_path,
            serve_addr_tcp=addr_tcp,
        )
        set_global_worker(self.worker)
        # fence hook: a death verdict (FencedError / refused re-register /
        # `fenced` push) cancels running zombie tasks IMMEDIATELY — their
        # side effects must not complete — instead of waiting a watch tick
        self.worker._on_fenced_cb = self._fenced_now
        await self.worker.connect_async()
        spawn_bg(self._heartbeat_loop())
        spawn_bg(self._watch_head())
        # park forever; the head kills us at job teardown
        await asyncio.Event().wait()

    def _fenced_now(self):
        """Death-verdict entry point; may fire from a user thread (a task's
        own head_call raising FencedError) — hop to the loop."""
        try:
            self.loop.call_soon_threadsafe(self._fenced_on_loop)
        except RuntimeError:
            os._exit(1)

    def _fenced_on_loop(self):
        """Death verdict landed: this worker's node incarnation was declared
        dead (partition heal discovery).  Cancel every RUNNING task — the
        head already resubmitted them elsewhere, so letting them finish
        would commit duplicate side effects — then exit.  The cancellation
        is the difference between "zombie completed, then died" and "zombie
        died mid-flight": only the latter is at-most-once."""
        import ctypes

        for task_id in list(self._async_running):
            t = self._async_running.get(task_id)
            if t is not None:
                t.cancel()
        for task_id, tid in list(self._running_tasks.items()):
            self._cancel_requested.append(task_id)
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid), ctypes.py_object(TaskCancelledError)
            )
        # brief grace for the cancellations to unwind, then hard exit (the
        # agent's fence reset SIGKILLs us anyway if we linger)
        self.loop.call_later(0.25, os._exit, 1)

    async def _watch_head(self):
        """Watch the head connection.  A dead head gets a reconnect grace
        window (the Worker housekeeping loop redials; a restarted head
        re-adopts us from its snapshot).  Exit when (a) the head explicitly
        fenced us — it declared this worker dead, a stale lease must not keep
        acting — or (b) the grace expires with no head (orphan reaping)."""
        grace = self.config.health_check_period_s * self.config.health_check_failure_threshold + 10.0
        down_since = None
        while True:
            await asyncio.sleep(0.5)
            if self.worker._head_fenced:
                os._exit(1)
            if self.worker.head is None or self.worker.head.closed:
                if down_since is None:
                    down_since = asyncio.get_running_loop().time()
                elif asyncio.get_running_loop().time() - down_since > grace:
                    os._exit(1)
            else:
                down_since = None

    def main(self):
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self._amain())
        except (KeyboardInterrupt, SystemExit):
            pass


def main():
    # debugging facility: SIGUSR1 dumps all thread stacks to the worker log
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    WorkerProcess().main()


if __name__ == "__main__":
    main()
