"""CompiledDAG: turn a DAG of actor-method nodes into per-actor executable
loops wired with shared-memory channels (analogue of the reference's
dag/compiled_dag_node.py:767 CompiledDAG + :446 ExecutableTask; hot-path
semantics per §3.6 of SURVEY.md — the driver leaves the per-call RPC loop).

Compilation:
  - every compute node must be a ClassMethodNode (actor-owned);
  - edges between different processes become BufferedShmChannels
    (num_buffers = max_inflight_executions, giving pipelined backpressure);
  - same-actor edges pass values in memory within a tick;
  - the driver writes one input channel per execute() and reads the output
    channels; errors are forwarded through the graph as _DagError payloads.
"""

from __future__ import annotations

import traceback
from typing import Any, Dict, List, Optional, Tuple

from ..channel.shm_channel import (
    BufferedShmChannel,
    ChannelClosedError,
    open_channel,
)
from ..core.errors import DagTimeoutError, DeadActorError
from ..util import flightrec
from .node import (
    ClassMethodNode,
    DAGNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

# driver-side DAG-plane counters (plain ints, same contract as
# channel.shm_channel.CHANNEL_STATS): util/metrics delta-ships them as
# ca_dag_* cluster counters; `ca status` and util.state.dag_plane() read the
# aggregate
DAG_STATS = {
    "compiles": 0,            # CompiledDAG graphs compiled (incl. recompiles)
    "recompiles": 0,          # rebuilds after an actor restart
    "executions": 0,          # execute() submissions
    "results": 0,             # ticks whose outputs the driver consumed
    "backpressure_waits": 0,  # execute() blocked at max_inflight_executions
    "timeouts": 0,            # DagTimeoutError raised
    "actor_deaths": 0,        # DeadActorError raised (loop died mid-execute)
    "teardowns": 0,           # teardown() completions
}

# driver poll slice while waiting on channels: short enough that actor death
# surfaces promptly, long enough that a healthy tick never pays for it (the
# futex read wakes on publish, not at the slice boundary)
_DEATH_POLL_S = 0.2


class _TraceEnv:
    """Trace context riding a channel payload (tentpole: span id in channel
    meta).  The driver wraps the input payload with its ambient context, each
    actor re-wraps its cross-process writes with its own tick span, so a
    compiled-DAG tick renders in `ca timeline` as one connected trace.  Only
    minted while a trace is active — untraced ticks ship bare payloads and
    pay nothing but one isinstance on the read side."""

    __slots__ = ("tr", "value")

    def __init__(self, tr, value):
        self.tr = tr
        self.value = value

    def __reduce__(self):
        return (_TraceEnv, (self.tr, self.value))


class _DagError:
    """An execution error traveling through channels."""

    def __init__(self, exc: BaseException):
        self.exc = exc
        self.tb = traceback.format_exc()

    def raise_(self):
        raise self.exc


def _extract_input(input_payload, key):
    """input_payload is (args tuple, kwargs dict)."""
    args, kwargs = input_payload
    if key is None:
        if not kwargs and len(args) == 1:
            return args[0]
        return (args, kwargs) if kwargs else tuple(args)
    if isinstance(key, int):
        return args[key]
    if key in kwargs:
        return kwargs[key]
    raise KeyError(key)


def _dag_actor_loop(instance, schedule: List[tuple], node_ops: Dict[int, dict],
                    reader_specs: Dict[int, Tuple[dict, int]],
                    writer_specs: Dict[int, dict], timeout: float):
    """Runs inside the actor (via the __ca_exec__ builtin): loop until the
    input side closes, executing this actor's operation schedule each tick.

    `schedule` is this actor's projection of the global operation schedule
    (dag/operation.py, reference dag_node_operation.py): an ordered list of
    ("read", channel_id) / ("compute", node_id) / ("write", node_id) ops.
    Scheduled reads replace lazy ones — the schedule is a slice of one
    global topological order, so a blocking read here can never deadlock
    against another actor's schedule, and each channel is read exactly once
    per tick (readers desynchronize from writers otherwise)."""
    readers = {nid: open_channel(spec, ridx) for nid, (spec, ridx) in reader_specs.items()}
    writers = {nid: open_channel(spec) for nid, spec in writer_specs.items()}
    tensor_chans = {nid for nid, (spec, _) in reader_specs.items() if spec.get("tensor")}
    tensor_writers = {nid for nid, spec in writer_specs.items() if spec.get("tensor")}

    def _to_device(v):
        """with_tensor_transport consumer side: a DeviceEnvelope's leaves
        land on this actor's device (cuda:<current>, or the CPU in a
        process that sees no GPU), DTensor leaves over the registered mesh;
        a plain payload's numpy and CPU-tensor leaves land there too."""
        from ..channel.device_transport import DeviceEnvelope, land_tree, unpack_device_value

        if isinstance(v, DeviceEnvelope):
            return unpack_device_value(v)
        return land_tree(v)

    def _pack_tensor(v):
        """with_tensor_transport producer side: each CUDA leaf copied once
        to the host and handed out of band (never pickled as bytes; dtype
        and DTensor placements ride along)."""
        from ..channel.device_transport import pack_device_value

        return pack_device_value(v)

    try:
        from ..util import tracing as _trc
    except Exception:  # pragma: no cover — tracing must never kill the loop
        _trc = None
    import time as _time

    ticks = 0
    try:
        while True:
            chan_vals: Dict[int, Any] = {}
            tick_vals: Dict[int, Any] = {}
            err: Optional[_DagError] = None
            closed = False
            tick_tok = None  # trace token: set by the first enveloped read
            tick_t0 = 0.0

            def resolve(spec):
                kind, ref = spec
                if kind == "const":
                    return ref
                if kind == "chan":
                    return chan_vals[ref]
                if kind == "local":
                    return tick_vals[ref]
                if kind == "input":
                    payload = chan_vals[ref[0]]
                    if isinstance(payload, _DagError):
                        return payload
                    return _extract_input(payload, ref[1])
                raise ValueError(kind)

            for kind, ref in schedule:
                try:
                    if kind == "read":
                        # block without deadline: teardown closes the channel
                        # to wake us
                        v = readers[ref].read(None)
                        if isinstance(v, _TraceEnv):
                            # channel meta: adopt the upstream trace for this
                            # tick (first envelope wins) before touching the
                            # payload, so tensor landing runs inside the span
                            if tick_tok is None and _trc is not None:
                                tick_tok = _trc.push_execution(v.tr)
                                tick_t0 = _time.time()
                            v = v.value
                        if ref in tensor_chans and not isinstance(v, _DagError):
                            try:
                                v = _to_device(v)
                            except BaseException as e:  # noqa: BLE001
                                # a bad landing (device OOM, shard-spec
                                # mismatch) is this tick's error, not the
                                # loop's death: forward it to the driver
                                v = _DagError(e)
                                err = err or v
                        chan_vals[ref] = v
                    elif kind == "compute":
                        op = node_ops[ref]
                        if err is not None:
                            # actor-local poisoning: once an op on this actor
                            # fails in a tick, later ops forward the error so
                            # the driver sees the root cause, not knock-ons
                            result = err
                        else:
                            try:
                                args = [resolve(s) for s in op["args"]]
                                kwargs = {k: resolve(s) for k, s in op["kwargs"].items()}
                                bad = next((a for a in args + list(kwargs.values())
                                            if isinstance(a, _DagError)), None)
                                if bad is not None:
                                    result = bad
                                else:
                                    result = getattr(instance, op["method"])(*args, **kwargs)
                            except BaseException as e:  # noqa: BLE001 — forwarded to driver
                                result = _DagError(e)
                                err = result
                        tick_vals[ref] = result
                    else:  # write
                        out = tick_vals[ref]
                        if ref in tensor_writers and not isinstance(out, _DagError):
                            try:
                                out = _pack_tensor(out)
                            except BaseException as e:  # noqa: BLE001 — surfaced to driver
                                out = _DagError(e)
                                err = err or out
                        if tick_tok is not None:
                            # re-wrap under THIS actor's tick span: the next
                            # hop (actor or driver) parents on it, chaining
                            # the channel ops into one causal trace
                            cur = _trc.current()
                            if cur is not None:
                                out = _TraceEnv(
                                    {"tid": cur["tid"], "sid": cur["sid"]}, out
                                )
                        writers[ref].write(out, timeout)
                except ChannelClosedError:
                    closed = True
                    break
            if tick_tok is not None:
                if not closed:
                    cur = _trc.current()
                    w = _trc._current_worker()
                    _trc.record_task_event(
                        "", "dag:tick", "span", "SPAN",
                        trace=cur,
                        worker_id=w.client_id if w is not None else None,
                        node_id=w.node_id if w is not None else None,
                        start=tick_t0,
                        end=_time.time(),
                    )
                _trc.pop_execution(tick_tok)
            if closed:
                break
            ticks += 1
    finally:
        for w in writers.values():
            w.close()
    return {"ticks": ticks}


class CompiledDAGRef:
    """Future for one execute() (reference: CompiledDAGRef)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._consumed = False

    def get(self, timeout: Optional[float] = None):
        if self._consumed:
            raise ValueError("CompiledDAGRef.get() may only be called once")
        result = self._dag._read_result(self._seq, timeout)
        # only mark consumed on success: a TimeoutError leaves the ref
        # retryable (the DAG's partial-read state keeps channels aligned)
        self._consumed = True
        return result

    def __repr__(self):
        return f"CompiledDAGRef(seq={self._seq})"

    async def get_async(self, timeout: Optional[float] = None):
        """Awaitable result read; the blocking channel read runs off-loop."""
        import asyncio

        return await asyncio.to_thread(self.get, timeout)

    def __await__(self):
        return self.get_async().__await__()


class CompiledDAG:
    def __init__(self, root: DAGNode, max_inflight_executions: int = 2,
                 buffer_size: Optional[int] = None,
                 execute_timeout_s: Optional[float] = None):
        from ..core.config import get_config

        self._root = root
        self._max_inflight = max(1, max_inflight_executions)
        self._buffer_size = buffer_size or 8 * 1024 * 1024
        self._timeout = (
            execute_timeout_s if execute_timeout_s is not None
            else get_config().dag_execute_timeout_s
        )
        self._torn_down = False
        self._dead: Optional[DeadActorError] = None
        self._exec_seq = 0
        self._read_seq = 0
        self._result_cache: Dict[int, Any] = {}
        self._compile()

    # ------------------------------------------------------------------ build

    def _compile(self):
        nodes = self._root._walk()
        self._input_node: Optional[InputNode] = None
        compute: List[ClassMethodNode] = []
        output_leaves: List[DAGNode] = []
        root = self._root
        if isinstance(root, MultiOutputNode):
            output_leaves = list(root._upstream())
        else:
            output_leaves = [root]
        for n in nodes:
            if isinstance(n, InputNode):
                if self._input_node is not None and n is not self._input_node:
                    raise ValueError("compiled DAGs support a single InputNode")
                self._input_node = n
            elif isinstance(n, (InputAttributeNode, MultiOutputNode)):
                pass
            elif isinstance(n, ClassMethodNode):
                compute.append(n)
            else:
                raise TypeError(
                    f"compiled DAGs require actor-method nodes; got {n._label()} "
                    "(tasks run via DAGNode.execute())"
                )
        for leaf in output_leaves:
            if not isinstance(leaf, ClassMethodNode):
                raise TypeError("compiled DAG outputs must be actor-method nodes")

        # node -> owning actor key
        def owner(n: ClassMethodNode):
            return n._actor.actor_id.hex()

        actors: Dict[str, List[ClassMethodNode]] = {}
        handles: Dict[str, Any] = {}
        for n in compute:
            actors.setdefault(owner(n), []).append(n)
            handles[owner(n)] = n._actor
        if not actors:
            raise ValueError("compiled DAG has no actor-method nodes")

        # which (producer node, consumer actor) edges cross processes, and
        # whether the driver consumes the producer
        consumers: Dict[int, set] = {}  # producer node_id -> set of actor keys ("<driver>" for driver)
        input_consumers: set = set()

        def record_edge(dep: DAGNode, consumer_key: str):
            if isinstance(dep, (InputNode, InputAttributeNode)):
                input_consumers.add(consumer_key)
            elif isinstance(dep, ClassMethodNode):
                if owner(dep) != consumer_key:
                    consumers.setdefault(dep._id, set()).add(consumer_key)
            elif isinstance(dep, MultiOutputNode):
                raise TypeError("MultiOutputNode must be the DAG root")

        for n in compute:
            for dep in n._upstream():
                record_edge(dep, owner(n))
        for leaf in output_leaves:
            consumers.setdefault(leaf._id, set()).add("<driver>")

        if self._input_node is None and input_consumers:
            raise ValueError("InputAttributeNode without InputNode")

        # allocate channels; assign reader indices deterministically
        self._channels: Dict[int, BufferedShmChannel] = {}
        reader_index: Dict[Tuple[int, str], int] = {}
        INPUT_ID = -1
        if self._input_node is not None:
            if not input_consumers:
                raise ValueError("InputNode is never consumed")
            chan = BufferedShmChannel(
                num_readers=len(input_consumers),
                num_buffers=self._max_inflight,
                buffer_size=self._buffer_size,
            )
            self._channels[INPUT_ID] = chan
            for i, key in enumerate(sorted(input_consumers)):
                reader_index[(INPUT_ID, key)] = i
        for nid, cons in consumers.items():
            chan = BufferedShmChannel(
                num_readers=len(cons),
                num_buffers=self._max_inflight,
                buffer_size=self._buffer_size,
            )
            self._channels[nid] = chan
            for i, key in enumerate(sorted(cons)):
                reader_index[(nid, key)] = i

        # per-actor operation schedules from the global operation graph
        # (dag/operation.py; reference dag_node_operation.py).  The schedule
        # decides when each channel read happens, so multi-stage actors
        # front-load shallow-stage work instead of blocking a whole tick on
        # a deeper stage's upstream — GPipe-style microbatch pipelining.
        from .operation import build_operation_graph, generate_actor_schedules

        channel_node_ids = {nid for nid in self._channels if nid != INPUT_ID}
        ops, op_edges = build_operation_graph(
            compute, owner, channel_node_ids, INPUT_ID
        )
        raw_schedules = generate_actor_schedules(ops, op_edges)

        self._loop_refs = []
        self._loop_actors: List[str] = []  # parallel to _loop_refs
        self._handles = handles
        # node labels for typed errors: "<method> (node <id>)" and the set
        # of nodes each actor hosts (DeadActorError names the failed ones)
        self._node_methods = {n._id: n._method_name for n in compute}
        self._actor_nodes = {
            key: tuple(
                f"{n._method_name} (node {n._id})"
                for n in compute if owner(n) == key
            )
            for key in handles
        }
        self._actor_schedules: Dict[str, List[tuple]] = {}
        for key, handle in handles.items():
            node_ops: Dict[int, dict] = {}
            reader_specs: Dict[int, Tuple[dict, int]] = {}
            writer_specs: Dict[int, dict] = {}
            for n in compute:
                if owner(n) != key:
                    continue

                def chan_spec(nid, producer):
                    spec = dict(self._channels[nid].spec())
                    if getattr(producer, "_tensor_transport", False):
                        spec["tensor"] = True
                    return spec

                def arg_spec(dep):
                    if isinstance(dep, InputNode):
                        reader_specs[INPUT_ID] = (
                            chan_spec(INPUT_ID, self._input_node),
                            reader_index[(INPUT_ID, key)],
                        )
                        return ("input", (INPUT_ID, None))
                    if isinstance(dep, InputAttributeNode):
                        reader_specs[INPUT_ID] = (
                            chan_spec(INPUT_ID, self._input_node),
                            reader_index[(INPUT_ID, key)],
                        )
                        return ("input", (INPUT_ID, dep._key))
                    if isinstance(dep, ClassMethodNode):
                        if owner(dep) == key:
                            return ("local", dep._id)
                        reader_specs[dep._id] = (
                            chan_spec(dep._id, dep),
                            reader_index[(dep._id, key)],
                        )
                        return ("chan", dep._id)
                    return ("const", dep)

                node_ops[n._id] = {
                    "method": n._method_name,
                    "args": [
                        arg_spec(a) if isinstance(a, DAGNode) else ("const", a)
                        for a in n._bound_args
                    ],
                    "kwargs": {
                        k: arg_spec(v) if isinstance(v, DAGNode) else ("const", v)
                        for k, v in n._bound_kwargs.items()
                    },
                }
                if n._id in self._channels:
                    wspec = dict(self._channels[n._id].spec())
                    if getattr(n, "_tensor_transport", False):
                        wspec["tensor"] = True
                    writer_specs[n._id] = wspec

            # project the actor's OpIds into loop ops: READ carries the
            # channel id, COMPUTE/WRITE carry the node id
            schedule: List[tuple] = []
            for opid in raw_schedules.get(key, []):
                kind, ref = opid
                schedule.append(("read", ref[0]) if kind == "read" else (kind, ref))
            self._actor_schedules[key] = schedule

            # no_resend: the loop is incarnation-bound.  If the actor dies
            # the ref must resolve with ActorDiedError (feeding _check_loops)
            # instead of being transparently re-sent to the restarted
            # incarnation, whose re-run loop would reopen these channels at
            # stale stream positions and never produce the lost tick.
            ref = handle._submit(
                "__ca_exec__",
                (_dag_actor_loop, schedule, node_ops, reader_specs,
                 writer_specs, self._timeout),
                {},
                {"num_returns": 1, "no_resend": True},
            )
            self._loop_refs.append(ref)
            self._loop_actors.append(key)

        # driver-side reader handles for outputs; duplicate leaves in a
        # MultiOutputNode share one channel that is read once per tick
        self._driver_readers = {}
        self._driver_read_order: List[int] = []
        for leaf in output_leaves:
            if leaf._id in self._driver_readers:
                continue
            spec = self._channels[leaf._id].spec()
            self._driver_readers[leaf._id] = open_channel(
                spec, reader_index[(leaf._id, "<driver>")]
            )
            self._driver_read_order.append(leaf._id)
        self._output_leaves = output_leaves
        self._multi_output = isinstance(root, MultiOutputNode)
        self._INPUT_ID = INPUT_ID
        # partially-read tick state (survives a TimeoutError so channel
        # streams never misalign): node_id -> value for the current tick
        self._partial_vals: Dict[int, Any] = {}
        DAG_STATS["compiles"] += 1
        from ..util.metrics import _ensure_flusher

        _ensure_flusher()  # stats dicts only ship while the flusher runs

    # ----------------------------------------------------------- fault watch

    def _check_loops(self):
        """Distinguish infrastructure death from a slow tick: a loop ref only
        resolves when its actor loop EXITS, which before teardown means the
        actor died (or the loop crashed outside user code).  App errors never
        come this way — they travel through the channels as _DagError.
        Raises DeadActorError (after tearing the DAG down) on death."""
        if not self._loop_refs:
            return
        from ..core import api as ca

        try:
            done, _ = ca.wait(
                self._loop_refs, num_returns=len(self._loop_refs), timeout=0
            )
        except Exception:
            return  # wait plumbing unavailable: the deadline still bounds us
        if not done:
            return
        ref = done[0]
        key = self._loop_actors[self._loop_refs.index(ref)]
        detail = "actor loop exited mid-execute"
        try:
            ca.get(ref)
        except BaseException as e:  # noqa: BLE001 — folded into the typed error
            detail = repr(e)
        # record BEFORE constructing the error: DeadActorError snapshots the
        # recent dag-plane events into .flight_events, and this one is the
        # root cause the incident view must lead with
        if flightrec.REC is not None:
            flightrec.REC.record(
                "dag", "dag_actor_death", actor=key, detail=detail,
                nodes=list(self._actor_nodes.get(key, ())),
            )
        err = DeadActorError(key, self._actor_nodes.get(key, ()), detail)
        DAG_STATS["actor_deaths"] += 1
        self._dead = err
        self.teardown()
        raise err

    def _raise_if_unusable(self):
        if self._dead is not None:
            raise self._dead
        if self._torn_down:
            raise RuntimeError("compiled DAG has been torn down")

    # ---------------------------------------------------------------- execute

    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        import contextlib
        import time as _time

        from ..util import tracing as _trc

        self._raise_if_unusable()
        if self._input_node is not None:
            payload = (tuple(args), kwargs)
            if getattr(self._input_node, "_tensor_transport", False):
                from ..channel.device_transport import pack_device_value

                payload = pack_device_value(payload)
            chan = self._channels[self._INPUT_ID]
            # trace propagation (tentpole): the input write carries the
            # driver's span in the channel meta; actor ticks parent on it.
            # Untraced path: one contextvar read + one branch.
            traced = _trc.is_enabled() or _trc.current() is not None
            span_cm = (
                _trc.span("dag:execute") if traced
                else contextlib.nullcontext(None)
            )
            with span_cm as sctx:
                if sctx is not None:
                    payload = _TraceEnv(
                        {"tid": sctx["tid"], "sid": sctx["sid"]}, payload
                    )
                deadline = _time.monotonic() + self._timeout
                waited = False
                # sliced write: at max_inflight the input channel blocks on
                # the slowest reader's ack (backpressure); slicing keeps
                # actor death from turning that into a silent hang
                while True:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        DAG_STATS["timeouts"] += 1
                        if flightrec.REC is not None:
                            flightrec.REC.record(
                                "dag", "dag_timeout", node="InputNode",
                                phase="execute", timeout_s=self._timeout,
                            )
                        raise DagTimeoutError(
                            "InputNode (backpressure)", self._timeout,
                            phase="execute",
                        )
                    try:
                        chan.write(payload, min(_DEATH_POLL_S, remaining))
                        break
                    except TimeoutError:
                        if not waited:
                            waited = True
                            DAG_STATS["backpressure_waits"] += 1
                        self._check_loops()
        DAG_STATS["executions"] += 1
        ref = CompiledDAGRef(self, self._exec_seq)
        self._exec_seq += 1
        return ref

    async def execute_async(self, *args, **kwargs) -> CompiledDAGRef:
        """Async submission (reference compiled_dag_node.py:2336): the input
        -channel write (which blocks under backpressure at max inflight)
        runs off-loop; `await ref.get_async()` or `await ref` reads."""
        import asyncio

        return await asyncio.to_thread(self.execute, *args, **kwargs)

    def _read_one(self, nid: int, deadline: float, timeout_s: float):
        """Read one output channel in death-aware slices: a healthy tick
        wakes on publish (futex), a dead producer surfaces as DeadActorError
        from _check_loops, and the deadline surfaces as a typed error naming
        the stalled node — never a bare hang."""
        import time as _time

        reader = self._driver_readers[nid]
        while True:
            # clamp to 0 rather than pre-raising: a 0-timeout read still
            # returns a value that is already published (poll semantics)
            remaining = max(0.0, deadline - _time.monotonic())
            try:
                v = reader.read(min(_DEATH_POLL_S, remaining))
                if isinstance(v, _TraceEnv):
                    v = v.value  # driver consumes; trace ends here
                return v
            except TimeoutError:
                self._check_loops()
                if _time.monotonic() >= deadline:
                    DAG_STATS["timeouts"] += 1
                    node = f"{self._node_methods.get(nid, '?')} (node {nid})"
                    if flightrec.REC is not None:
                        flightrec.REC.record(
                            "dag", "dag_timeout", node=node, phase="read",
                            timeout_s=timeout_s,
                        )
                    raise DagTimeoutError(node, timeout_s) from None

    def _read_result(self, seq: int, timeout: Optional[float]):
        import time as _time

        self._raise_if_unusable()
        t = self._timeout if timeout is None else timeout
        deadline = _time.monotonic() + t
        while self._read_seq <= seq:
            for nid in self._driver_read_order:
                if nid in self._partial_vals:
                    continue  # already read before an earlier timeout
                v = self._read_one(nid, deadline, t)
                if not isinstance(v, _DagError):
                    from ..channel.device_transport import maybe_unpack

                    v = maybe_unpack(v)
                self._partial_vals[nid] = v
            outs = [self._partial_vals[leaf._id] for leaf in self._output_leaves]
            self._partial_vals = {}
            self._result_cache[self._read_seq] = outs
            self._read_seq += 1
            DAG_STATS["results"] += 1
        outs = self._result_cache.pop(seq)
        for o in outs:
            if isinstance(o, _DagError):
                o.raise_()
        return outs if self._multi_output else outs[0]

    # ---------------------------------------------------------------- teardown

    def teardown(self):
        if self._torn_down:
            return
        self._torn_down = True
        for chan in self._channels.values():
            try:
                chan.close()
            except Exception:
                pass
        for r in getattr(self, "_driver_readers", {}).values():
            try:
                r.close()
            except Exception:
                pass
        from ..core import api as ca

        try:
            ca.wait(self._loop_refs, num_returns=len(self._loop_refs), timeout=10)
        except Exception:
            pass
        for chan in self._channels.values():
            try:
                chan.release()
            except Exception:
                pass
        for r in getattr(self, "_driver_readers", {}).values():
            try:
                r.release()
            except Exception:
                pass
        DAG_STATS["teardowns"] += 1

    def recompile(self):
        """Rebuild channels and actor loops against the CURRENT incarnation
        of every actor — recovery path after DeadActorError when the failed
        actor has a restart budget (max_restarts).  In-flight executions are
        lost (their results died with the old loops); sequence numbers reset
        so fresh executes read fresh channels."""
        self.teardown()
        self._torn_down = False
        self._dead = None
        self._exec_seq = 0
        self._read_seq = 0
        self._result_cache = {}
        DAG_STATS["recompiles"] += 1
        if flightrec.REC is not None:
            flightrec.REC.record(
                "dag", "dag_recompile", actors=len(self._handles),
                channels=len(self._channels),
            )
        self._compile()

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass

    def visualize(self) -> str:
        return self._root.visualize()

    def actor_schedules(self) -> Dict[str, List[tuple]]:
        """The per-actor operation schedules this DAG executes (reference:
        CompiledDAG.actor_to_execution_schedule).  Read-only introspection
        for tests and debugging."""
        return {k: list(v) for k, v in self._actor_schedules.items()}
