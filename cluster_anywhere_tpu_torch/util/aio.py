"""Asyncio hygiene helpers: tasks that can't vanish, IO that can't hang,
cleanup that can't mask.

The event loop holds only weak references to tasks: a bare
`create_task`/`ensure_future` whose result is dropped can be garbage-
collected mid-flight, and an exception it raises is parked on the Task until
GC prints "Task exception was never retrieved" — minutes later, with no
context.  `ca lint`'s async-dropped-task rule flags such sites; spawn_logged
is the helper they should use instead: it pins the task in a process-global
set, names it (visible in `ca profile` stacks and asyncio debug), and logs
any exception through the rate-limited warner — a crashed background loop is
one grep away instead of silent.

Distinct from core.protocol.spawn_bg, which pins but deliberately does not
log: the protocol dispatch path wraps every handler in its own try/except
and reports errors to the peer, so a second report there would be noise.

Bounded IO (`ca lint`'s async-unbounded-io rule): on preemptible VMs a peer
can vanish mid-handshake, and an unbounded `await asyncio.open_connection`
parks the coroutine forever — the drain plane can't finish a node that is
waiting on a dead socket.  dial() / read_frame() / drain() wrap the raw
core.protocol primitives in asyncio.wait_for with config-driven defaults
(config.dial_timeout_s / config.io_timeout_s), count timeouts in AIO_STATS,
and warn rate-limited, so a flapping peer is visible without flooding logs.
Timeouts surface as ConnectionError: every existing dial call site already
handles that (an unreachable peer and a silent one are the same failure).

Masking-safe cleanup (`ca lint`'s finally-await rule): an `await` inside
`finally:` while the task is being cancelled raises CancelledError
immediately — the in-flight exception is replaced and the rest of the
cleanup never runs.  finally_await() shields the cleanup so it completes,
logs a cleanup failure instead of raising (a close() error must not mask
the error that got us into the finally), and re-raises cancellation only
when there is no in-flight exception to preserve.
"""

from __future__ import annotations

import asyncio
import sys
from typing import Dict

_tasks: set = set()

# per-process counters for the bounded-IO helpers (flushed into the metrics
# plane by callers that care; plain ints — the loop owns all increments)
AIO_STATS: Dict[str, int] = {
    "dial_timeouts": 0,
    "read_timeouts": 0,
    "drain_timeouts": 0,
}


def _warn(key: str, msg: str) -> None:
    from ..core.ownership import warn_ratelimited  # lazy: avoid import cycle

    warn_ratelimited(key, msg)


async def dial(addr: str, timeout: float = None, purpose: str = "peer",
               peer_node: str = None):
    """Timeout-bounded protocol.connect_addr: THE way to dial a peer.

    Default bound is config.dial_timeout_s.  A timed-out dial raises
    ConnectionError (counted + rate-limited-warned), which every existing
    dial site already treats as peer-unreachable.

    `peer_node` labels the connection for the network-chaos plane (the
    address registry is the fallback): a dial toward a blackholed peer
    hangs — SYN into the void — until the link heals or the bound expires,
    exactly like a real partitioned connect."""
    from ..core import netchaos, protocol  # lazy: util imports without core
    from ..core.config import get_config

    t = get_config().dial_timeout_s if timeout is None else timeout
    budget = t  # connect budget shrinks by any blackhole heal-wait below
    dst = peer_node if peer_node is not None else netchaos.node_for_addr(addr)
    ch = netchaos.NET_CHAOS
    if ch is not None:
        if dst is not None and ch.link_down(ch.local, dst):
            ch.count("dials_blocked")
            deadline = asyncio.get_running_loop().time() + t
            while asyncio.get_running_loop().time() < deadline:
                await asyncio.sleep(0.05)
                c = netchaos.NET_CHAOS
                if c is None or not c.link_down(c.local, dst):
                    break  # link healed mid-wait: the SYN gets through now
            else:
                AIO_STATS["dial_timeouts"] += 1
                raise ConnectionError(
                    f"dial {addr} timed out after {t:.1f}s"
                ) from None
            # the heal-wait spent part of the bound: the connect gets only
            # the remainder, so the caller's total never exceeds ~t
            budget = max(
                0.05, deadline - asyncio.get_running_loop().time()
            )
    try:
        conn = await asyncio.wait_for(protocol.connect_addr(addr), budget)
    except asyncio.TimeoutError:
        AIO_STATS["dial_timeouts"] += 1
        _warn(
            "aio-dial-timeout",
            f"dial {purpose} {addr}: no connection after {t:.1f}s "
            f"(peer preempted or partitioned?)",
        )
        raise ConnectionError(f"dial {addr} timed out after {t:.1f}s") from None
    # label unconditionally (a weak-dict insert): chaos installed at RUNTIME
    # (`ca chaos set`) must cover connections that predate it
    netchaos.label_writer(conn.writer, dst)
    return conn


async def read_frame(reader: "asyncio.StreamReader", timeout: float = None):
    """Timeout-bounded protocol.read_frame for request/response contexts.

    Default bound is config.io_timeout_s; pass an explicit timeout for
    stricter callers.  Persistent-connection read loops (a server waiting
    for the NEXT request) should keep using protocol.read_frame directly —
    idling there is legitimate.  Returns None on clean EOF, raises
    asyncio.TimeoutError on a silent peer (counted)."""
    from ..core import protocol
    from ..core.config import get_config

    t = get_config().io_timeout_s if timeout is None else timeout
    try:
        return await asyncio.wait_for(protocol.read_frame(reader), t)
    except asyncio.TimeoutError:
        AIO_STATS["read_timeouts"] += 1
        raise


async def drain(writer: "asyncio.StreamWriter", timeout: float = None) -> None:
    """Timeout-bounded writer.drain(): a stalled peer with a full TCP window
    otherwise parks the writer coroutine forever.  Raises ConnectionError on
    timeout (counted + warned) — the peer is as good as gone."""
    from ..core.config import get_config

    t = get_config().io_timeout_s if timeout is None else timeout
    try:
        await asyncio.wait_for(writer.drain(), t)
    except asyncio.TimeoutError:
        AIO_STATS["drain_timeouts"] += 1
        _warn(
            "aio-drain-timeout",
            f"drain stalled for {t:.1f}s: peer not reading (dead or wedged)",
        )
        raise ConnectionError(f"drain timed out after {t:.1f}s") from None


async def finally_await(coro, what: str = "cleanup") -> None:
    """Await cleanup work inside a `finally:` without masking.

    Rules a raw `await` in a finally breaks:
      - if the task is being cancelled, the await raises CancelledError
        IMMEDIATELY, replacing the in-flight exception and skipping the
        rest of the cleanup — here the cleanup runs shielded to completion;
      - if the cleanup itself fails, its exception would replace the
        in-flight one — here it is logged (rate-limited) instead;
      - cancellation arriving with NO in-flight exception must not be
        swallowed — here it re-raises after the shielded cleanup settles
        (with an in-flight exception, completing the finally re-raises it
        anyway, so suppressing the local CancelledError is exactly right).
    """
    inflight = sys.exc_info()[1]
    task = asyncio.ensure_future(coro)
    try:
        await asyncio.shield(task)
    except asyncio.CancelledError:
        if not task.done():
            # detach: let the cleanup finish; surface ITS failure if any
            _tasks.add(task)
            task.add_done_callback(lambda t: _reap(t, f"finally:{what}"))
        if inflight is None:
            raise
    except Exception as e:
        _warn(
            f"aio-finally-{what}",
            f"cleanup {what!r} in finally failed: {e!r}"
            + (" (in-flight exception preserved)" if inflight else ""),
        )


def spawn_logged(coro, name: str) -> "asyncio.Task":
    """Schedule `coro` as a named, pinned task whose exception (if any) is
    logged instead of parked.  Returns the Task for callers that also want
    to cancel/await it; dropping the return value is safe."""
    task = asyncio.ensure_future(coro)
    try:
        task.set_name(f"ca:{name}")
    except AttributeError:  # pragma: no cover - py<3.8
        pass
    _tasks.add(task)
    task.add_done_callback(lambda t: _reap(t, name))
    return task


def _reap(task: "asyncio.Task", name: str) -> None:
    _tasks.discard(task)
    if task.cancelled():
        return
    exc = task.exception()  # marks the exception retrieved
    if exc is None:
        return
    from ..core.ownership import warn_ratelimited  # lazy: avoid import cycle

    warn_ratelimited(
        f"task-{name}",
        f"background task {name!r} died: {exc!r}",
    )
