"""Pass 5: cancellation hygiene inside `async def`.

async-swallowed-cancel  a `try` whose body awaits, whose except chain
                        reaches a generic handler (`except Exception`, bare
                        `except`, `except BaseException`, or an explicit
                        CancelledError catch) that neither re-raises nor is
                        preceded by a CancelledError handler that does.  The
                        drain plane shuts nodes down by cancelling their
                        loops; a generic handler inside such a loop turns
                        "stop now" into "log and keep going" (bare/
                        BaseException catches today, `except Exception` the
                        moment someone widens it or the code runs on an old
                        asyncio).  Fix idiom:

                            except asyncio.CancelledError:
                                raise
                            except Exception:
                                ...

finally-await           an `await` inside a `finally:` while the task is
                        being cancelled raises CancelledError *immediately*,
                        masking the in-flight exception and abandoning the
                        rest of the cleanup.  Route cleanup awaits through
                        util.aio.finally_await (shields the cleanup, logs
                        instead of masking) or make the cleanup synchronous.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .engine import Finding, dotted_name as _dotted

RULES = {
    "async-swallowed-cancel": (
        "a generic except around an await swallows (or will swallow) task "
        "cancellation — re-raise CancelledError before the generic handler"
    ),
    "finally-await": (
        "an await inside finally: raises immediately under cancellation, "
        "masking the in-flight exception and skipping the rest of the "
        "cleanup — use util.aio.finally_await"
    ),
}

# awaited callees that are safe inside a finally (they guard themselves)
_SAFE_FINALLY_CALLS = {"finally_await", "aio.finally_await"}


def _own_nodes(stmts):
    """Every node under `stmts`, not descending into nested functions (an
    await in a nested async def is that function's concern)."""
    stack = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue  # a nested def seeded directly: its body is its own
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.append(child)


def _has_await(stmts) -> bool:
    return any(
        isinstance(n, (ast.Await, ast.AsyncFor, ast.AsyncWith))
        for n in _own_nodes(stmts)
    )


def _handler_names(handler: ast.ExceptHandler):
    if handler.type is None:
        yield "<bare>"
        return
    def walk(node):
        if isinstance(node, ast.Tuple):
            for elt in node.elts:
                yield from walk(elt)
        else:
            d = _dotted(node)
            if d is not None:
                yield d.rsplit(".", 1)[-1]
    yield from walk(handler.type)


def _reraises(handler: ast.ExceptHandler) -> bool:
    """A bare `raise` anywhere in the handler body counts: the common shapes
    re-raise unconditionally or behind an isinstance check."""
    return any(
        isinstance(n, ast.Raise) and n.exc is None
        for n in _own_nodes(handler.body)
    )


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
    tries = sorted(
        (n for n in _own_nodes(fn.body) if isinstance(n, ast.Try)),
        key=lambda n: (n.lineno, n.col_offset),
    )
    # the ordinal keeps fingerprints distinct for same-shaped try blocks in
    # one function without baking line numbers into them
    for ordinal, node in enumerate(tries):
        if node.handlers and _has_await(node.body):
            _check_handlers(sf, node, qual, ordinal, findings)
        if node.finalbody:
            _check_finally(sf, node, qual, ordinal, findings)


def _check_handlers(sf, try_node, qual, ordinal, findings: List[Finding]) -> None:
    for handler in try_node.handlers:
        names = set(_handler_names(handler))
        catches_cancel = bool(names & {"<bare>", "BaseException", "CancelledError"})
        generic = bool(names & {"<bare>", "BaseException", "Exception"})
        if not (catches_cancel or generic):
            continue  # narrow handler: cancellation flows past it
        if _reraises(handler):
            if catches_cancel:
                return  # cancellation is re-raised here; done
            # an `except Exception: ...; raise` cannot catch cancellation:
            # keep scanning — a later broader handler may still swallow it
            continue
        what = (
            "catches CancelledError and does not re-raise it"
            if catches_cancel else
            "is not preceded by a CancelledError re-raise"
        )
        findings.append(Finding(
            rule="async-swallowed-cancel", file=sf.relpath,
            line=handler.lineno, context=qual,
            message=(
                f"except {'/'.join(sorted(names))} around an await {what}: "
                f"task cancellation (drain-plane shutdown) can be swallowed "
                f"— add `except asyncio.CancelledError: raise` first"
            ),
            detail=f"try{ordinal}:{'/'.join(sorted(names))}",
        ))
        return  # one finding per try statement


def _check_finally(sf, try_node, qual, ordinal, findings: List[Finding]) -> None:
    # fingerprint by the await's ordinal AMONG AWAITS (not among all nodes):
    # unrelated edits to the finally body must not churn fingerprints
    awaits = sorted(
        (n for n in _own_nodes(try_node.finalbody) if isinstance(n, ast.Await)),
        key=lambda n: (n.lineno, n.col_offset),
    )
    for idx, node in enumerate(awaits):
        call = node.value
        if isinstance(call, ast.Call):
            callee = _dotted(call.func)
            if callee in _SAFE_FINALLY_CALLS or (
                isinstance(call.func, ast.Attribute)
                and call.func.attr == "finally_await"
            ):
                continue
        findings.append(Finding(
            rule="finally-await", file=sf.relpath, line=node.lineno,
            context=qual,
            message=(
                "await inside finally: under cancellation this raises "
                "immediately, masking the in-flight exception and skipping "
                "the rest of the cleanup — use util.aio.finally_await"
            ),
            detail=f"try{ordinal}:finally-await:{idx}",
        ))
