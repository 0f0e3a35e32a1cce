"""Pass 4: unbounded network awaits.

async-unbounded-io   an `await` on a network dial / stream read / drain that
                     no timeout dominates.  On preemptible VMs a peer can
                     vanish mid-handshake (or mid-write with a full TCP
                     window) and an unbounded await parks the coroutine
                     forever — the drain plane can't finish a node that's
                     waiting on a dead socket.

What counts as network IO:
  dials   asyncio.open_connection / open_unix_connection, the repo's own
          protocol.connect_addr / connect_unix, loop.create_connection /
          sock_connect
  reads   .readline() / .readexactly() / .readuntil() on a stream reader
  drains  .drain() on a stream writer

What counts as a dominating timeout:
  - the call sits inside `asyncio.wait_for(...)`'s arguments
  - an enclosing `async with asyncio.timeout(...)` / `timeout_at(...)` block
  - the call itself carries a `timeout=` keyword (timeout-aware helpers)
  - the call IS a registered timeout-carrying helper: `util.aio.dial` /
    `aio.read_frame` / `aio.drain` bound it internally

Deliberately-unbounded sites (a server's persistent-connection read loop
idles legitimately) carry a justified `# ca-lint: ignore[async-unbounded-io]`
pragma at the await.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .engine import Finding, dotted_name as _dotted

RULES = {
    "async-unbounded-io": (
        "an await on a network dial/read/drain with no dominating timeout "
        "(asyncio.wait_for, asyncio.timeout block, timeout= kwarg, or a "
        "util.aio bounded helper) can hang forever on a dead peer"
    ),
}

# dial-class callees, matched on the exact dotted name
_DIAL_CALLS = {
    "asyncio.open_connection", "asyncio.open_unix_connection",
    "open_connection", "open_unix_connection",
    "connect_addr", "connect_unix",
    "protocol.connect_addr", "protocol.connect_unix",
}
# dial/read/drain-class method names, matched on the attribute regardless of
# receiver (stream readers/writers are passed around under many names)
_IO_METHODS = {
    "readline", "readexactly", "readuntil",
    "drain",
    "create_connection", "sock_connect",
}
# helpers that bound their IO internally (util/aio.py): awaiting them bare
# is the FIX for this rule, not a finding
_BOUNDED_HELPERS = {"dial", "aio.dial", "aio.read_frame", "aio.drain"}

_WAIT_WRAPPERS = {"wait_for", "asyncio.wait_for"}
_TIMEOUT_CTX = {"timeout", "timeout_at"}  # asyncio.timeout(...) blocks


def _flags(call: ast.Call) -> Optional[str]:
    """The short name of the IO class this call belongs to, or None."""
    dotted = _dotted(call.func)
    if dotted in _DIAL_CALLS:
        return dotted
    if isinstance(call.func, ast.Attribute) and call.func.attr in _IO_METHODS:
        recv = _dotted(call.func.value) or "<expr>"
        return f"{recv}.{call.func.attr}"
    return None


def _is_bounded_call(call: ast.Call) -> bool:
    dotted = _dotted(call.func)
    if dotted in _BOUNDED_HELPERS:
        return True
    if isinstance(call.func, ast.Attribute) and call.func.attr in _BOUNDED_HELPERS:
        return True
    return any(kw.arg == "timeout" for kw in call.keywords)


def check(files) -> List[Finding]:
    from .contract import _qualname_index

    findings: List[Finding] = []
    for sf in files:
        if sf.tree is None:
            continue
        for node, qual in _qualname_index(sf.tree).items():
            if isinstance(node, ast.AsyncFunctionDef):
                _check_fn(sf, node, qual, findings)
    return findings


def _check_fn(sf, fn, qual, findings: List[Finding]) -> None:
    def visit(node, bounded: bool):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return  # nested scopes are visited as their own functions
        if isinstance(node, ast.AsyncWith):
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Call):
                    callee = _dotted(ce.func) or ""
                    if callee.rsplit(".", 1)[-1] in _TIMEOUT_CTX:
                        bounded = True
        if isinstance(node, ast.Call):
            callee = _dotted(node.func) or (
                node.func.attr if isinstance(node.func, ast.Attribute) else ""
            )
            if callee in _WAIT_WRAPPERS or (
                callee.rsplit(".", 1)[-1] == "wait_for"
            ):
                for child in ast.iter_child_nodes(node):
                    visit(child, True)
                return
        if isinstance(node, ast.Await) and isinstance(node.value, ast.Call):
            call = node.value
            what = _flags(call)
            if what is not None and not bounded and not _is_bounded_call(call):
                findings.append(Finding(
                    rule="async-unbounded-io", file=sf.relpath,
                    line=node.lineno, context=qual,
                    message=(
                        f"await {what}(...) has no dominating timeout: a "
                        f"dead peer parks this coroutine forever — wrap in "
                        f"asyncio.wait_for or use the util.aio bounded helper"
                    ),
                    detail=what,
                ))
        for child in ast.iter_child_nodes(node):
            visit(child, bounded)

    for stmt in fn.body:
        visit(stmt, False)
