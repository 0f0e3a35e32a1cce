"""Pass 2: asyncio hazard analysis over every `async def` in the tree.

async-blocking-call   a synchronous blocking call on the event loop —
                      `time.sleep`, `subprocess.run/…`, socket dials,
                      unawaited `.wait()`/`.result()`/`.communicate()`,
                      `urlopen` — stalls every connection the loop serves
                      (the head is ONE loop; a 1 s sleep is a 1 s cluster
                      outage for control RPCs).
async-dropped-task    `create_task`/`ensure_future` whose Task object is
                      discarded at statement level: the loop holds only a
                      weak ref (the task can vanish mid-flight) and its
                      exception is silently parked until GC.  Use
                      util.aio.spawn_logged (names the task, pins it, logs
                      the exception) or keep a handle + done-callback.
async-await-race      read-modify-write of `self.*` state split across an
                      `await`: the value read before the yield is stale by
                      the time it's written back if any other task touched
                      the attribute.  Detected both across statements
                      (x = self.a … await … self.a = f(x)) and within one
                      (self.a = self.a + await f(), self.a += await f()).

Nested `def`s inside an async function are skipped: they execute wherever
they're called (usually an executor thread), not necessarily on the loop.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .engine import Finding, dotted_name as _dotted

RULES = {
    "async-blocking-call": (
        "a synchronous blocking call (time.sleep, subprocess, socket dials, "
        "unawaited .wait()/.result()) inside async def stalls every "
        "connection the event loop serves"
    ),
    "async-dropped-task": (
        "create_task/ensure_future whose Task is dropped at statement level "
        "can be GC'd mid-flight and parks its exception — use "
        "util.aio.spawn_logged or hold the Task"
    ),
    "async-await-race": (
        "read-modify-write of self.* state split across an await: another "
        "task can interleave between the read and the write"
    ),
}

# module.attr callables that block the loop outright
_BLOCKING_DOTTED = {
    ("time", "sleep"),
    ("subprocess", "run"),
    ("subprocess", "call"),
    ("subprocess", "check_call"),
    ("subprocess", "check_output"),
    ("subprocess", "getoutput"),
    ("subprocess", "getstatusoutput"),
    ("socket", "create_connection"),
    ("socket", "getaddrinfo"),
    ("socket", "gethostbyname"),
    ("urllib.request", "urlopen"),
}

# method names that block when the call is NOT awaited (sync socket/proc/
# future APIs share these names with awaitable asyncio duals)
_BLOCKING_METHODS_UNAWAITED = {
    "result", "wait", "communicate", "accept", "recv", "recvfrom", "sendall",
}

_SPAWN_NAMES = {"create_task", "ensure_future"}
# wrappers that pin the task and guard its exception; calling them bare is fine
_SAFE_SPAWN_WRAPPERS = {"spawn_bg", "spawn_logged"}


def _self_attr_reads(expr) -> Set[str]:
    """Attribute paths `self.x` loaded anywhere in expr (subscripts of
    self.d[...] count as reads of self.d)."""
    out: Set[str] = set()
    for node in ast.walk(expr):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and isinstance(node.ctx, ast.Load)
        ):
            out.add(node.attr)
    return out


def _write_target_attr(target) -> Optional[str]:
    """`self.x = …` / `self.x[k] = …` -> "x"."""
    if isinstance(target, ast.Subscript):
        target = target.value
    if (
        isinstance(target, ast.Attribute)
        and isinstance(target.value, ast.Name)
        and target.value.id == "self"
    ):
        return target.attr
    return None


def _awaits_in(node) -> bool:
    """True if node yields to the loop (await / async for / async with),
    skipping nested function bodies."""
    stack = [node]
    while stack:
        cur = stack.pop()
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
                return True
            stack.append(child)
    return isinstance(node, (ast.Await, ast.AsyncFor, ast.AsyncWith))


def check(files) -> List[Finding]:
    from .contract import _qualname_index

    findings: List[Finding] = []
    for sf in files:
        if sf.tree is None:
            continue
        quals = _qualname_index(sf.tree)
        for node, qual in quals.items():
            if isinstance(node, ast.AsyncFunctionDef):
                _check_async_fn(sf, node, qual, findings)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # dropped fire-and-forget tasks are a hazard from sync code
                # too: create_task only works with a running loop, so any
                # caller is loop-adjacent
                _check_dropped_tasks(sf, node, qual, findings)
    return findings


def _iter_own_nodes(fn):
    """Every node in fn's body, excluding nested function/lambda bodies."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # a nested def that is a DIRECT statement of the body lands on
            # the stack itself; its body is that function's own concern
            continue
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.append(child)


def _check_async_fn(sf, fn, qual, findings: List[Finding]):
    awaited_calls = {
        id(n.value) for n in _iter_own_nodes(fn) if isinstance(n, ast.Await)
        if isinstance(n.value, ast.Call)
    }

    for node in _iter_own_nodes(fn):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted is not None and tuple(dotted.rsplit(".", 1)) in _BLOCKING_DOTTED:
            findings.append(Finding(
                rule="async-blocking-call", file=sf.relpath, line=node.lineno,
                context=qual,
                message=f"blocking call {dotted}() inside async def {fn.name}",
                detail=dotted,
            ))
            continue
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _BLOCKING_METHODS_UNAWAITED
            and id(node) not in awaited_calls
        ):
            recv = _dotted(node.func.value) or "<expr>"
            findings.append(Finding(
                rule="async-blocking-call", file=sf.relpath, line=node.lineno,
                context=qual,
                message=(
                    f"unawaited .{node.func.attr}() on {recv} inside async "
                    f"def {fn.name} blocks the event loop if it is the sync API"
                ),
                detail=f"{recv}.{node.func.attr}",
            ))

    _check_await_races(sf, fn, qual, findings)


def _check_dropped_tasks(sf, fn, qual, findings: List[Finding]):
    """Statement-level Expr of create_task/ensure_future: the Task object is
    discarded, so it can be GC'd mid-flight and its exception vanishes."""
    for node in _iter_own_nodes(fn):
        if not (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)):
            continue
        call = node.value
        name = (
            call.func.attr if isinstance(call.func, ast.Attribute)
            else call.func.id if isinstance(call.func, ast.Name) else None
        )
        if name in _SPAWN_NAMES:
            findings.append(Finding(
                rule="async-dropped-task", file=sf.relpath, line=node.lineno,
                context=qual,
                message=(
                    f"{name}(...) result dropped: the loop keeps only a weak "
                    f"ref and the task's exception is lost — use "
                    f"util.aio.spawn_logged or hold the Task"
                ),
                detail=_first_arg_repr(call),
            ))


def _first_arg_repr(call: ast.Call) -> str:
    if call.args:
        try:
            return ast.unparse(call.args[0])[:80]
        except Exception:
            pass
    return "?"


def _check_await_races(sf, fn, qual, findings: List[Finding]):
    def scan_block(stmts, bindings: Dict[str, Tuple[Set[str], bool]]):
        """bindings: local var -> (self attrs its value was read from,
        awaited-since-binding)."""
        for stmt in stmts:
            stmt_awaits = _awaits_in(stmt)

            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                )
                value = stmt.value
                for target in targets:
                    attr = _write_target_attr(target)
                    if attr is None:
                        continue
                    stale_vars = set()
                    if value is not None:
                        for v in ast.walk(value):
                            if isinstance(v, ast.Name) and isinstance(v.ctx, ast.Load):
                                bound = bindings.get(v.id)
                                if bound and attr in bound[0] and (
                                    bound[1] or stmt_awaits
                                ):
                                    stale_vars.add(v.id)
                    direct_rmw = (
                        stmt_awaits and value is not None and (
                            isinstance(stmt, ast.AugAssign)
                            or attr in _self_attr_reads(value)
                        )
                    )
                    if stale_vars or direct_rmw:
                        how = (
                            f"via stale local {sorted(stale_vars)[0]!r}"
                            if stale_vars else "in the same statement"
                        )
                        findings.append(Finding(
                            rule="async-await-race", file=sf.relpath,
                            line=stmt.lineno, context=qual,
                            message=(
                                f"read-modify-write of self.{attr} crosses an "
                                f"await ({how}): another task can interleave "
                                f"between the read and the write"
                            ),
                            detail=f"self.{attr}",
                        ))
                # a plain rebind invalidates staleness tracking for the var;
                # record fresh bindings reading self attrs
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and stmt.value is not None:
                    reads = _self_attr_reads(stmt.value)
                    name = stmt.targets[0].id
                    if reads and not stmt_awaits:
                        bindings[name] = (reads, False)
                    else:
                        bindings.pop(name, None)
            elif isinstance(stmt, (ast.If,)):
                scan_block(stmt.body, dict(bindings))
                scan_block(stmt.orelse, dict(bindings))
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                scan_block(stmt.body, dict(bindings))
                scan_block(stmt.orelse, dict(bindings))
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                scan_block(stmt.body, bindings)
            elif isinstance(stmt, ast.Try):
                scan_block(stmt.body, bindings)
                for h in stmt.handlers:
                    scan_block(h.body, dict(bindings))
                scan_block(stmt.finalbody, bindings)

            if stmt_awaits:
                for name, (attrs, _) in list(bindings.items()):
                    bindings[name] = (attrs, True)

    scan_block(fn.body, {})
