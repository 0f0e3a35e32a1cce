"""Wire protocol between processes: length-prefixed msgpack frames over unix
domain sockets (same host) or TCP (cross host).

This is the analogue of the reference's gRPC services + local-socket
flatbuffer protocol (src/ray/protobuf/*.proto, src/ray/raylet/format/): a
small set of typed messages between driver <-> head <-> node agents <->
workers.  msgpack maps keep the schema explicit and language-neutral so the
head can later be swapped for the C++ implementation without changing clients.

Addresses are strings with a scheme prefix: "unix:/path/to.sock" or
"tcp:host:port"; a bare path is treated as unix for backward compatibility.
A Server can listen on several addresses at once (unix for same-host clients,
TCP for the rest of the cluster) and shares one handler across them.

Frame format: [u32 big-endian length][msgpack map]
Every request carries "m" (method), "i" (request id); responses echo "i" and
carry "ok" plus method-specific fields, or "err" with a pickled exception.

Batching: logical messages corked during one event-loop iteration are packed
into ONE physical frame — a `batch` envelope {"m": "batch", "b": [msg, ...]}
— so a 4000-call burst pays dozens of frame/encode/dispatch cycles instead of
4000.  Receivers (Connection read loop, Server dispatch, BlockingClient)
transparently expand envelopes back into logical messages; chaos budgets and
per-method stats count LOGICAL messages, never physical frames.

Lease plane: the node-local lease granting subsystem rides this same frame
protocol and its batch envelopes.  Head -> agent: `lease_block` (delegate
workers into a block), `lease_block_revoke` (reclaim unleased slots).
Agent -> head: `lease_block_return` (returned slots), plus per-pool
`lease_stats` piggybacked on `node_heartbeat`.  Submitter -> agent:
`lease_grant` / `lease_release` — the hot lease class, which therefore
never crosses the head's loop in steady state.  Submitter -> head:
`request_lease` may carry `ttl` (escalation probe; the head replies
{"expired": true} past it), and `push_task` may carry `fn_blob` (function
definition inlined while the head — the blob directory — is down).  All of
these are ordinary logical messages: they cork, batch, and charge chaos
budgets exactly like every other method.

Log plane: the structured log pipeline rides the same frames and envelopes.
Agent -> head: `log_batch` (notify; a tick's tailed records from that node's
capture files).  Driver -> head: `log_sub` (notify; join/leave the cluster
log stream) and `log_fetch` (request; resolve a worker/actor/task/node id
and read/tail its log, proxied cross-node).  Head -> agent: `log_read`
(request; tail a file in the agent's node dir).  Head -> driver: `log_batch`
pushes (unsolicited frames, expanded by the Connection push handler).  All
of them cork and batch like any other logical message; delivery to a stalled
subscriber drops (bounded buffers + a dropped-line counter) rather than
backpressuring the printing worker.

Trace context: logical task/actor-call messages may carry a small optional
`tr` field (TRACE_FIELD) — {"tid": trace id, "sid": parent span id} — minted
at remote() submission when util/tracing is enabled.  Batch envelopes splice
already-encoded whole message bodies, so the field survives corking/batching
untouched; receivers read it off the logical message like any other field.
Disabled tracing sends nothing (no field, no bytes).

A deterministic fault-injection hook mirrors the reference's RPC chaos
(src/ray/rpc/rpc_chaos.h): CA_TESTING_RPC_FAILURE="method=N,method2=M" makes
the first N sends of `method` raise ConnectionError before the write.  The
budget is charged at call()/call_cb()/notify() time — one logical message,
one decrement — so injected failures keep their meaning whether the survivors
travel as single frames or inside a batch envelope.
"""

from __future__ import annotations

import asyncio
import itertools
import socket as _socket
import struct
import weakref
from typing import Any, Awaitable, Callable, Dict, Optional

import msgpack

from . import netchaos
from .config import get_config

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 31

# optional trace-context field on logical task/actor-call messages (see
# util/tracing.py); single definition so submit and execute sides agree
TRACE_FIELD = "tr"

# Per-process wire counters (control-plane amortization observability).
# Plain ints in a module dict: incremented on hot paths, so no locks — the
# asyncio loop owns sends/recvs, and the metrics flusher only reads.
WIRE_STATS: Dict[str, int] = {
    "frames_sent": 0,        # physical frames written
    "messages_sent": 0,      # logical messages written
    "batch_frames_sent": 0,  # physical frames that were batch envelopes
    "frames_recv": 0,        # physical frames read
    "messages_recv": 0,      # logical messages read
    "template_renders": 0,   # task-spec template fast-path encodes
    "refcount_flushes_suppressed": 0,  # obj_refs sends merged away (worker.py)
}


def wire_stats() -> Dict[str, int]:
    """Snapshot of this process's wire counters."""
    return dict(WIRE_STATS)

# The event loop holds only weak references to tasks; anything fire-and-forget
# must be pinned here or it can be garbage-collected mid-execution (observed:
# silently vanishing task submissions under load).
_background_tasks: set = set()


def spawn_bg(coro) -> asyncio.Task:
    task = asyncio.ensure_future(coro)
    _background_tasks.add(task)
    task.add_done_callback(_background_tasks.discard)
    return task


class RpcChaos:
    """Counts down per-method failure budgets from config.testing_rpc_failure
    and holds per-method latency injections from config.testing_rpc_delay
    ("method=MS" pairs: every matching send waits MS milliseconds first —
    the straggler-RPC knob, where the failure knob models clean errors).

    Method names in BOTH specs are validated against the generated RPC
    contract (docs/PROTOCOL_CONTRACT_TORCH.json, `ca lint --contract`) at
    parse time: a typo'd method in a chaos spec would otherwise never fire,
    and its test would pass while injecting nothing.  Unknown names raise
    immediately.
    """

    def __init__(self, spec: str, delay_spec: str = ""):
        self._budget: Dict[str, int] = {}
        for part in filter(None, (spec or "").split(",")):
            method, _, n = part.partition("=")
            self._budget[method.strip()] = int(n or 1)
        self._delay: Dict[str, float] = {}
        for part in filter(None, (delay_spec or "").split(",")):
            method, _, ms = part.partition("=")
            self._delay[method.strip()] = float(ms or 0.0) / 1000.0
        if self._budget or self._delay:
            self._validate_methods()

    def _validate_methods(self) -> None:
        from ..analysis.contract import load_contract  # lazy: cold path only

        doc = load_contract()
        if doc is None:
            return  # no checked-out contract (installed package): best effort
        known = set(doc.get("methods") or ())
        if not known:
            return
        unknown = sorted((set(self._budget) | set(self._delay)) - known)
        if unknown:
            raise ValueError(
                f"CA_TESTING_RPC_FAILURE/CA_TESTING_RPC_DELAY name unknown "
                f"RPC method(s) {unknown}: not in the extracted protocol "
                f"contract ({len(known)} methods; regenerate with `ca lint "
                f"--contract` if the protocol changed)"
            )

    def maybe_fail(self, method: str):
        left = self._budget.get(method)
        if left:
            self._budget[method] = left - 1
            raise ConnectionError(f"[chaos] injected RPC failure for {method}")

    def delay_s(self, method: str) -> float:
        """Injected pre-send latency for `method` (0.0 = none)."""
        return self._delay.get(method, 0.0) if self._delay else 0.0


_chaos: Optional[RpcChaos] = None


def rpc_chaos() -> RpcChaos:
    global _chaos
    if _chaos is None:
        cfg = get_config()
        _chaos = RpcChaos(
            cfg.testing_rpc_failure, getattr(cfg, "testing_rpc_delay", "")
        )
    return _chaos


def reset_rpc_chaos(spec: str = "", delay_spec: str = ""):
    global _chaos
    _chaos = RpcChaos(spec, delay_spec)


async def read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    """Read one length-prefixed frame; None on clean EOF.

    Deliberately unbounded: every caller is a persistent-connection read
    loop (Connection._read_loop, Server._on_client) where waiting forever
    for the NEXT frame is the correct idle state.  Request/response
    contexts that must not trust the peer use util.aio.read_frame, which
    bounds this with config.io_timeout_s."""
    try:
        # ca-lint: ignore[async-unbounded-io] — persistent read loop (see docstring)
        hdr = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (length,) = _LEN.unpack(hdr)
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    # body follows the header immediately; a peer that sent 4 length bytes
    # and then stalls is torn down by the health plane, not a per-read timer
    # ca-lint: ignore[async-unbounded-io]
    body = await reader.readexactly(length)
    msg = msgpack.unpackb(body, raw=False, strict_map_key=False)
    WIRE_STATS["frames_recv"] += 1
    if msg.get("m") == "batch":
        WIRE_STATS["messages_recv"] += len(msg.get("b") or ())
    else:
        WIRE_STATS["messages_recv"] += 1
    return msg


def iter_messages(msg: dict):
    """Expand a frame into its logical messages (identity for plain frames)."""
    if msg.get("m") == "batch":
        return msg.get("b") or ()
    return (msg,)


# batch envelope, built by hand so already-encoded message bodies can be
# spliced in without a decode/re-encode round trip:
#   map{ "m": "batch", "b": [ <body>, <body>, ... ] }
_BATCH_PREFIX = (
    b"\x82"
    + msgpack.packb("m", use_bin_type=True)
    + msgpack.packb("batch", use_bin_type=True)
    + msgpack.packb("b", use_bin_type=True)
)


def _array_header(n: int) -> bytes:
    if n < 16:
        return bytes((0x90 | n,))
    if n < 1 << 16:
        return b"\xdc" + n.to_bytes(2, "big")
    return b"\xdd" + n.to_bytes(4, "big")


# one envelope never exceeds this payload size: keeps a flood of large
# messages (object chunks, collective pushes) from assembling frames near the
# MAX_FRAME limit, and bounds the receiver's single-unpack working set
_BATCH_BYTES_CAP = 32 << 20


class _Cork:
    """Per-writer message batcher: logical messages queued during one
    event-loop iteration are packed into a single `batch` envelope frame and
    one transport write — one frame header, one receiver unpack, one send
    syscall for the whole tick's traffic (the dominant costs of high-rate
    task/actor fan-out on few cores).  A lone message goes out as a plain
    frame.  Latency cost is at most one loop callback."""

    __slots__ = ("writer", "bodies", "scheduled", "_next_due")

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.bodies: list = []  # encoded msgpack map bodies (no length prefix)
        self.scheduled = False
        self._next_due = 0.0  # delayed-emission FIFO watermark (net chaos)

    def write_body(self, body: bytes):
        self.bodies.append(body)
        if not self.scheduled:
            self.scheduled = True
            asyncio.get_running_loop().call_soon(self.flush)

    def flush(self):
        self.scheduled = False
        if not self.bodies:
            return
        bodies = self.bodies
        self.bodies = []
        # network-chaos send filter (one module-global check when disabled):
        # frames to a blackholed/flap-down peer vanish silently — the
        # connection stays open and callers HANG, which is what a real
        # partition does; a delayed link defers the transport write instead
        chaos_delay = 0.0
        ch = netchaos.NET_CHAOS
        if ch is not None:
            dst = netchaos.link_of(self.writer)
            if dst is not None:
                if ch.link_down(ch.local, dst):
                    ch.count("frames_dropped", len(bodies))
                    return
                chaos_delay = ch.frame_delay(ch.local, dst)
        out = []
        i = 0
        n = len(bodies)
        while i < n:
            # greedy envelope up to the byte cap (almost always one pass)
            j = i + 1
            size = len(bodies[i])
            while j < n and size + len(bodies[j]) <= _BATCH_BYTES_CAP:
                size += len(bodies[j])
                j += 1
            if j - i == 1:
                out.append(_LEN.pack(len(bodies[i])))
                out.append(bodies[i])
            else:
                hdr = _array_header(j - i)
                payload_len = len(_BATCH_PREFIX) + len(hdr) + size
                out.append(_LEN.pack(payload_len))
                out.append(_BATCH_PREFIX)
                out.append(hdr)
                out.extend(bodies[i:j])
                WIRE_STATS["batch_frames_sent"] += 1
            WIRE_STATS["frames_sent"] += 1
            i = j
        WIRE_STATS["messages_sent"] += n
        data = b"".join(out)
        if chaos_delay > 0.0:
            # straggler link: emit later, FIFO per connection (a jittered
            # shorter delay never reorders past an earlier longer one)
            ch.count("frames_delayed")
            loop = asyncio.get_running_loop()
            due = max(loop.time() + chaos_delay, self._next_due)
            self._next_due = due
            loop.call_at(due, self._emit, data)
            return
        self._emit(data)

    def _emit(self, data: bytes):
        try:
            self.writer.write(data)
        except Exception:
            pass  # peer gone; readers/futures surface the error


_corks: "weakref.WeakKeyDictionary[asyncio.StreamWriter, _Cork]" = (
    weakref.WeakKeyDictionary()
)


def _cork_for(writer: asyncio.StreamWriter) -> _Cork:
    cork = _corks.get(writer)
    if cork is None:
        cork = _corks[writer] = _Cork(writer)
    return cork


def write_frame(writer: asyncio.StreamWriter, msg: dict) -> None:
    _cork_for(writer).write_body(msgpack.packb(msg, use_bin_type=True))


def write_frame_body(writer: asyncio.StreamWriter, body: bytes) -> None:
    """Queue an already-encoded msgpack map body (template render output)."""
    _cork_for(writer).write_body(body)


class MsgTemplate:
    """Pre-encoded msgpack prefix for messages whose field set repeats.

    Repeated submissions of the same remote function / actor method re-send
    an identical spec modulo the request id and task id: pack the constant
    key/value pairs ONCE and splice only the varying fields per call.  msgpack
    maps are a count header followed by packed k/v pairs in any order, so the
    render is header + constant-bytes + per-var (key-bytes + packb(value))."""

    __slots__ = ("_header", "_const", "_var_keys")

    def __init__(self, const_fields: dict, var_keys: tuple):
        n = len(const_fields) + len(var_keys)
        if n < 16:
            self._header = bytes((0x80 | n,))
        elif n < 1 << 16:
            self._header = b"\xde" + n.to_bytes(2, "big")
        else:
            self._header = b"\xdf" + n.to_bytes(4, "big")
        self._const = b"".join(
            msgpack.packb(k, use_bin_type=True) + msgpack.packb(v, use_bin_type=True)
            for k, v in const_fields.items()
        )
        self._var_keys = tuple(
            msgpack.packb(k, use_bin_type=True) for k in var_keys
        )

    def render(self, *var_values) -> bytes:
        if len(var_values) != len(self._var_keys):
            # a silently-truncated zip would emit a corrupt map (declared
            # pair count > encoded pairs) and poison the whole envelope
            raise ValueError(
                f"template expects {len(self._var_keys)} var values, "
                f"got {len(var_values)}"
            )
        parts = [self._header, self._const]
        for kb, v in zip(self._var_keys, var_values):
            parts.append(kb)
            parts.append(msgpack.packb(v, use_bin_type=True))
        WIRE_STATS["template_renders"] += 1
        return b"".join(parts)


def flush_writer(writer: asyncio.StreamWriter) -> None:
    """Force out corked frames (call before closing a writer)."""
    cork = _corks.get(writer)
    if cork is not None:
        cork.flush()


def fence_close(writer: asyncio.StreamWriter) -> None:
    """Close a peer transport as part of a death-fencing decision.

    With no active network chaos this is flush+close.  While a blackhole
    covers the link the close is DEFERRED until the link heals: a real
    partition delivers no FIN, so the fenced peer must discover its death
    verdict at heal time (refused re-register / FencedError on its next
    authority RPC) instead of being tipped off mid-partition by an EOF that
    could never have reached it."""
    ch = netchaos.NET_CHAOS
    if ch is not None:
        dst = netchaos.link_of(writer)
        if dst is not None and ch.link_down(ch.local, dst):
            ch.count("closes_deferred")

            async def _close_when_healed():
                deadline = asyncio.get_running_loop().time() + 300.0
                while asyncio.get_running_loop().time() < deadline:
                    await asyncio.sleep(0.05)
                    c = netchaos.NET_CHAOS
                    if c is None or not c.link_down(c.local, dst):
                        break
                try:
                    writer.close()
                except Exception:
                    pass

            spawn_bg(_close_when_healed())
            return
    try:
        flush_writer(writer)
        writer.close()
    except Exception:
        pass


def fence_close_conn(conn: "Connection") -> None:
    """Connection.close with fence_close transport semantics (no await:
    fencing paths must not block on a partitioned peer's FIN)."""
    conn._closed = True
    conn._reader_task.cancel()
    fence_close(conn.writer)


class Connection:
    """A client connection with request/response correlation.

    Multiple outstanding requests are multiplexed over one socket; responses
    are matched by request id.  One-way notifications (no reply expected) use
    notify().  Thread-compat: must only be used from the owning event loop.
    """

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._req_ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._closed = False
        self._on_push: Optional[Callable[[dict], Awaitable[None]]] = None
        # authority stamp: fields merged into every outgoing request/notify
        # (worker processes set {"ninc": <node incarnation>, "hep": <head
        # epoch>} after register, so the head can fence RPCs minted under a
        # dead incarnation — and agents can fence calls from a superseded
        # head).  Drivers never stamp; the template fast path is driver-only.
        self.stamp: Optional[dict] = None
        self._reader_task = asyncio.ensure_future(self._read_loop())

    def set_push_handler(self, fn: Callable[[dict], Awaitable[None]]):
        """Handler for unsolicited server->client frames (pubsub pushes)."""
        self._on_push = fn

    async def _read_loop(self):
        try:
            while True:
                frame = await read_frame(self.reader)
                if frame is None:
                    break
                # network-chaos receive filter: frames FROM a partitioned
                # peer are dropped too, so a chaos-enabled process gets a
                # symmetric partition even against peers without a spec
                ch = netchaos.NET_CHAOS
                if ch is not None:
                    peer = netchaos.link_of(self.writer)
                    if peer is not None and ch.link_down(peer, ch.local):
                        ch.count("recv_dropped")
                        continue
                # batch envelopes carry many logical replies/pushes in one
                # physical frame; expand and dispatch each in arrival order
                for msg in iter_messages(frame):
                    rid = msg.get("i")
                    fut = self._pending.pop(rid, None) if rid is not None else None
                    if fut is not None:
                        if callable(fut):  # call_cb fast path: plain callback
                            try:
                                fut(msg)
                            except Exception:
                                # a raising reply callback must not tear down
                                # the connection (and fail every other
                                # pending call)
                                import traceback

                                traceback.print_exc()
                        elif not fut.done():
                            fut.set_result(msg)
                    elif self._on_push is not None:
                        await self._on_push(msg)
        except asyncio.CancelledError:
            raise  # close() cancels the read loop; the finally still settles
        except Exception:
            pass
        finally:
            self._closed = True
            err = ConnectionError("connection closed")
            for fut in self._pending.values():
                if callable(fut):
                    try:
                        fut(None)  # None = connection closed
                    except Exception:
                        pass
                elif not fut.done():
                    fut.set_exception(err)
            self._pending.clear()

    async def call(self, _method: str, timeout: Optional[float] = None, **fields) -> dict:
        chaos = rpc_chaos()
        chaos.maybe_fail(_method)
        if self._closed:
            raise ConnectionError("connection closed")
        d = chaos.delay_s(_method)
        if d:
            await asyncio.sleep(d)  # injected straggler-RPC latency
        rid = next(self._req_ids)
        msg = {"m": _method, "i": rid, **fields}
        if self.stamp:
            msg.update(self.stamp)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        write_frame(self.writer, msg)
        # wait_for wraps the future in a Task + timer handle; skip it on the
        # (hot) untimed path
        reply = await fut if timeout is None else await asyncio.wait_for(fut, timeout)
        if not reply.get("ok", True):
            import pickle

            raise pickle.loads(reply["err"])
        return reply

    def call_cb(self, _method: str, _cb, **fields) -> None:
        """Fire a request and invoke `_cb(reply_msg)` from the read loop when
        the response arrives (`_cb(None)` if the connection dies first).

        The allocation-lean RPC path: no Future, no awaiting coroutine, no
        Task — used by the driver's hot task/actor submission loop where a
        per-call Task measurably caps throughput."""
        chaos = rpc_chaos()
        chaos.maybe_fail(_method)
        if self._closed:
            raise ConnectionError("connection closed")
        rid = next(self._req_ids)
        self._pending[rid] = _cb
        msg = {"m": _method, "i": rid, **fields}
        if self.stamp:
            msg.update(self.stamp)
        d = chaos.delay_s(_method)
        if d:
            asyncio.get_running_loop().call_later(
                d, write_frame, self.writer, msg
            )
            return
        write_frame(self.writer, msg)

    def call_template(self, _method: str, _template: MsgTemplate, _cb, *var_values) -> None:
        """call_cb over a pre-encoded MsgTemplate: the constant part of the
        spec (method, function descriptor, options) was packed once at cache
        time; only the request id and the template's declared var fields are
        encoded per call.  The request id is always the template's FIRST var
        key ("i")."""
        rpc_chaos().maybe_fail(_method)
        if self._closed:
            raise ConnectionError("connection closed")
        rid = next(self._req_ids)
        self._pending[rid] = _cb
        _cork_for(self.writer).write_body(_template.render(rid, *var_values))

    def notify(self, _method: str, **fields) -> None:
        chaos = rpc_chaos()
        chaos.maybe_fail(_method)
        if self._closed:
            raise ConnectionError("connection closed")
        msg = {"m": _method, **fields}
        if self.stamp:
            msg.update(self.stamp)
        d = chaos.delay_s(_method)
        if d:
            asyncio.get_running_loop().call_later(
                d, write_frame, self.writer, msg
            )
            return
        write_frame(self.writer, msg)

    async def close(self):
        self._closed = True
        self._reader_task.cancel()
        try:
            flush_writer(self.writer)  # corked frames out before the FIN
            self.writer.close()
            await self.writer.wait_closed()
        except asyncio.CancelledError:
            raise  # the transport close already went out; don't stall shutdown
        except Exception:
            pass

    @property
    def closed(self) -> bool:
        return self._closed


def addr_list(spec) -> list:
    """Split a comma-separated address list (CA_HEAD_ADDR / CA_HEAD_SOCK may
    name the active head plus its warm standbys)."""
    return [a.strip() for a in (spec or "").split(",") if a.strip()]


class AddrRing:
    """Head-address rotation for HA failover: dialers walk the ring on
    connect failure (active head first, then each standby) and merge the
    `standbys` list every register reply carries, so a client started with
    one address still learns every promotion candidate."""

    def __init__(self, addrs):
        self._addrs: list = []
        self._i = 0
        self.merge(addrs)

    def merge(self, addrs) -> int:
        """Append unseen addresses (order preserved); returns # added."""
        added = 0
        for a in addrs or ():
            if a and a not in self._addrs:
                self._addrs.append(a)
                added += 1
        return added

    @property
    def addrs(self) -> list:
        return list(self._addrs)

    @property
    def current(self):
        return self._addrs[self._i % len(self._addrs)] if self._addrs else None

    def rotate(self):
        """Advance to the next candidate (after a dial/register failure)."""
        if self._addrs:
            self._i = (self._i + 1) % len(self._addrs)
        return self.current

    def promote(self, addr: str) -> None:
        """Make `addr` the ring's current pick (a successful connect)."""
        if addr not in self._addrs:
            self._addrs.append(addr)
        self._i = self._addrs.index(addr)

    def __len__(self) -> int:
        return len(self._addrs)


def parse_addr(addr: str):
    """Split a scheme-prefixed address into ("unix", path) or ("tcp", host, port)."""
    if addr.startswith("unix:"):
        return ("unix", addr[5:])
    if addr.startswith("tcp:"):
        host, _, port = addr[4:].rpartition(":")
        return ("tcp", host, int(port))
    return ("unix", addr)  # bare path


async def connect_addr(addr: str) -> Connection:
    """Dial a scheme-prefixed address (TCP_NODELAY on tcp: small RPC frames
    must not sit in Nagle buffers).

    RAW primitive, deliberately unbounded: production call sites route
    through util.aio.dial(), which wraps this in asyncio.wait_for with
    config.dial_timeout_s and counts/warns on timeouts."""
    parsed = parse_addr(addr)
    if parsed[0] == "unix":
        # ca-lint: ignore[async-unbounded-io] — raw dial primitive (see docstring)
        reader, writer = await asyncio.open_unix_connection(parsed[1])
    else:
        # ca-lint: ignore[async-unbounded-io] — raw dial primitive (see docstring)
        reader, writer = await asyncio.open_connection(parsed[1], parsed[2])
        try:
            sock = writer.get_extra_info("socket")
            if sock is not None:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except BaseException:
            # the socket dialed but configuring it failed (or the dial's
            # wait_for deadline cancelled us right here): don't leak the
            # transport
            writer.close()
            raise
    return Connection(reader, writer)


class BlockingClient:
    """Minimal synchronous client over the same frame protocol — for probe
    tools (head-saturation microbenchmark) that want N independent OS
    threads hammering the head without N event loops.  Sequential
    request/response only; interleaved push frames are skipped."""

    def __init__(self, addr: str):
        parsed = parse_addr(addr)
        if parsed[0] == "unix":
            self._sock = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            self._sock.connect(parsed[1])
        else:
            self._sock = _socket.create_connection((parsed[1], parsed[2]))
            self._sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._seq = itertools.count(1)
        self._buf = b""
        self._pending_msgs: list = []  # logical messages from a batch frame

    def _read_frame(self) -> dict:
        if self._pending_msgs:
            return self._pending_msgs.pop(0)
        while True:
            while len(self._buf) < 4:
                chunk = self._sock.recv(65536)
                if not chunk:
                    raise ConnectionError("connection closed")
                self._buf += chunk
            (length,) = _LEN.unpack(self._buf[:4])
            while len(self._buf) < 4 + length:
                chunk = self._sock.recv(65536)
                if not chunk:
                    raise ConnectionError("connection closed")
                self._buf += chunk
            frame = msgpack.unpackb(self._buf[4 : 4 + length], raw=False)
            self._buf = self._buf[4 + length :]
            if frame.get("m") == "batch":
                # server cork batched our reply with other traffic
                self._pending_msgs = list(frame.get("b") or ())
                if not self._pending_msgs:
                    continue
                return self._pending_msgs.pop(0)
            return frame

    def call(self, method: str, **fields) -> dict:
        rid = next(self._seq)
        fields["m"] = method
        fields["i"] = rid
        payload = msgpack.packb(fields, use_bin_type=True)
        self._sock.sendall(_LEN.pack(len(payload)) + payload)
        while True:
            msg = self._read_frame()
            if msg.get("i") != rid:
                continue  # push/pubsub frame interleaved: not our reply
            if not msg.get("ok", True) and "err" in msg:
                import pickle

                raise pickle.loads(msg["err"])
            return msg

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class Server:
    """Asyncio socket server dispatching frames to a handler; listens on one
    or more addresses (unix and/or tcp) with a shared handler.

    handler(conn_state, msg, reply) — `reply(**fields)` sends the response for
    request-style frames; notifications have no "i" and get no reply.
    """

    def __init__(self, path, handler, on_disconnect=None, fast_handler=None):
        # `path` may be a single address or a list; bare paths mean unix
        self.addrs = [path] if isinstance(path, str) else list(path)
        self.handler = handler
        self.on_disconnect = on_disconnect
        # fast_handler(state, msg, writer) -> bool: synchronous pre-dispatch
        # hook run directly in the read loop; returning True consumes the
        # frame without creating a per-frame asyncio Task (hot-path RPCs)
        self.fast_handler = fast_handler
        self._servers: list = []
        self.bound_addrs: list = []  # resolved (tcp port 0 -> real port)

    async def start(self):
        for addr in self.addrs:
            parsed = parse_addr(addr)
            if parsed[0] == "unix":
                srv = await asyncio.start_unix_server(self._on_client, path=parsed[1])
                self.bound_addrs.append(f"unix:{parsed[1]}")
            else:
                srv = await asyncio.start_server(self._on_client, parsed[1], parsed[2])
                host, port = srv.sockets[0].getsockname()[:2]
                self.bound_addrs.append(f"tcp:{host}:{port}")
            self._servers.append(srv)

    async def _on_client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        sock = writer.get_extra_info("socket")
        if sock is not None and sock.family in (_socket.AF_INET, _socket.AF_INET6):
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        state: Dict[str, Any] = {"writer": writer}
        fast = self.fast_handler
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                # network-chaos receive filter (server side): once this
                # connection's peer is identified (the head labels it at
                # register), frames from a partitioned peer are dropped
                ch = netchaos.NET_CHAOS
                if ch is not None:
                    peer = netchaos.link_of(writer)
                    if peer is not None and ch.link_down(peer, ch.local):
                        ch.count("recv_dropped")
                        continue
                # A batch envelope fans out in-process: every logical message
                # inside it is dispatched exactly as if it had arrived as its
                # own frame, in envelope order.
                for msg in iter_messages(frame):
                    if fast is not None and fast(state, msg, writer):
                        continue
                    # Dispatch each message as its own task so a slow handler
                    # (e.g. actor creation, task execution) doesn't
                    # head-of-line block other requests multiplexed on this
                    # connection.  Tasks start in arrival order (FIFO loop
                    # scheduling), which preserves per-caller actor-call
                    # ordering up to the executor queue.
                    spawn_bg(self._dispatch(state, msg, writer))
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            if self.on_disconnect is not None:
                # masking-safe: a cancelled server task must still run the
                # disconnect bookkeeping AND close the transport below
                # (lazy import: util/__init__ reaches back into core)
                from ..util.aio import finally_await

                await finally_await(self.on_disconnect(state), "on-disconnect")
            try:
                flush_writer(writer)
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, state, msg, writer):
        rid = msg.get("i")

        def reply(**fields):
            if rid is not None:
                write_frame(writer, {"i": rid, "ok": True, **fields})

        def reply_err(exc: BaseException):
            if rid is not None:
                import pickle

                write_frame(writer, {"i": rid, "ok": False, "err": pickle.dumps(exc)})

        try:
            await self.handler(state, msg, reply, reply_err)
        except asyncio.CancelledError:
            raise  # loop shutdown: don't convert cancellation into a reply
        except Exception as e:  # handler bug: report to client
            reply_err(e)

    async def stop(self):
        for srv in self._servers:
            srv.close()
            await srv.wait_closed()
        self._servers = []
