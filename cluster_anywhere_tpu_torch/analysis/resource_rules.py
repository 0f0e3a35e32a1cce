"""Pass 3: resource-lifetime leak detection (CFG + dataflow).

res-leak-on-raise    an execution path exists from an acquire to the
                     function's *exceptional* exit with no release: the slice
                     / fd / socket / lock leaks exactly when something goes
                     wrong — the path chaos tests (and preempted VMs) take.
res-leak-on-return   a path from an acquire to a normal return with no
                     release and no escape (the resource wasn't returned,
                     stored, or handed to anyone who could release it).
                     Re-acquiring or rebinding a variable that may still
                     hold a live resource reports here too: the previous
                     resource becomes unreachable at the overwrite (the
                     loop-carried-acquire shape).
res-double-release   a release reaches a variable that may already be
                     released on some path — only for pairs whose release is
                     NOT idempotent (lock.release raises RuntimeError,
                     double os.close can close a stranger's recycled fd).

The analysis is intraprocedural, per function: a forward may-analysis over
analysis/cfg.py graphs tracking, per variable, the set of (state, pair,
acquire-line) facts.  Escape analysis keeps the false-positive rate down —
a resource that is returned, yielded, stored into an attribute/container,
passed to an unknown callee, or captured by a nested function stops being
this function's responsibility and is dropped from tracking.  `with` /
`async with` managed acquires are never tracked (release is structural).
Branch narrowing understands `if fd:` / `if conn is None:` guards so the
guarded-release idiom doesn't fire.

WHAT COUNTS as an acquire/release is declared in REGISTRY below; a new
resource class is a one-line Pair(...) addition.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Tuple

from .cfg import build_cfg, header_exprs
from .dataflow import Analysis, solve
from .engine import Finding, dotted_name as _dotted

RULES = {
    "res-leak-on-raise": (
        "a path from an acquire (fd/file/socket/lock/arena slice) to the "
        "function's exceptional exit has no release — leaks exactly when "
        "something goes wrong"
    ),
    "res-leak-on-return": (
        "a path from an acquire to a normal return (or a rebind/re-acquire, "
        "incl. loop-carried) drops the resource without releasing it"
    ),
    "res-double-release": (
        "a non-idempotent release (lock.release, os.close, free_slice) may "
        "run twice on the same resource along some path"
    ),
}


@dataclasses.dataclass(frozen=True)
class Pair:
    """One acquire/release discipline.  Adding a resource class is one entry."""

    name: str
    # value-producing acquires, matched on the exact dotted callee
    # ("os.open", bare "open"); the bound name becomes the tracked resource
    acquire_calls: frozenset = frozenset()
    # value-producing acquires matched on the METHOD name regardless of
    # receiver (arena.alloc -> slice offset).  `self.<method>(...)` never
    # matches: calling your own method is policy, not acquisition from a
    # resource-manager object
    acquire_methods: frozenset = frozenset()
    # statement-style acquires on an existing object: `lock.acquire()` as a
    # bare Expr marks the RECEIVER acquired
    receiver_acquire: frozenset = frozenset()
    # when the acquire returns a tuple, which element is the resource
    # (asyncio.open_connection -> (reader, writer)[1]; mkstemp -> fd[0])
    tuple_index: Optional[int] = None
    # releases: method on the resource (conn.close), function taking it as
    # first arg (os.close(fd)), or method on anything taking it as first arg
    # (arena.free_slice(off, sz))
    release_methods: frozenset = frozenset()
    release_funcs: frozenset = frozenset()
    release_arg_methods: frozenset = frozenset()
    # dotted callees that USE the resource as an argument without taking
    # ownership (os.read(fd, n) must not count as an escape)
    neutral_funcs: frozenset = frozenset()
    double_release_is_error: bool = False


_FD_NEUTRAL = frozenset({
    "os.read", "os.write", "os.pread", "os.pwrite", "os.lseek", "os.ftruncate",
    "os.fsync", "os.fstat", "os.fchmod", "os.fdatasync", "os.sendfile",
    "os.get_blocking", "os.set_blocking",
})

REGISTRY: Tuple[Pair, ...] = (
    Pair(
        name="file",
        acquire_calls=frozenset({"open", "io.open", "os.fdopen", "gzip.open"}),
        release_methods=frozenset({"close"}),
    ),
    Pair(
        name="fd",
        acquire_calls=frozenset({"os.open", "os.dup", "os.memfd_create"}),
        release_funcs=frozenset({"os.close"}),
        neutral_funcs=_FD_NEUTRAL,
        double_release_is_error=True,
    ),
    Pair(
        name="tmpfile-fd",
        acquire_calls=frozenset({"tempfile.mkstemp", "mkstemp"}),
        tuple_index=0,
        release_funcs=frozenset({"os.close"}),
        neutral_funcs=_FD_NEUTRAL,
        double_release_is_error=True,
    ),
    Pair(
        name="connection",
        acquire_calls=frozenset({
            "connect_addr", "connect_unix", "protocol.connect_addr",
            "protocol.connect_unix", "dial", "aio.dial",
        }),
        release_methods=frozenset({"close"}),
    ),
    Pair(
        name="stream",
        acquire_calls=frozenset({
            "asyncio.open_connection", "asyncio.open_unix_connection",
            "open_connection", "open_unix_connection",
        }),
        tuple_index=1,
        release_methods=frozenset({"close"}),
    ),
    Pair(
        name="lock",
        receiver_acquire=frozenset({"acquire"}),
        release_methods=frozenset({"release"}),
        double_release_is_error=True,
    ),
    Pair(
        name="arena-slice",
        acquire_methods=frozenset({"alloc"}),
        release_arg_methods=frozenset({"free_slice"}),
        double_release_is_error=True,
    ),
    # shm channels (channel/shm_channel.py): the backing /dev/shm segment is
    # freed by release(), not close() — close() only raises the shared
    # shutdown flag; a channel that is closed but never released leaks its
    # mmap and (writer-side) the on-disk segment until session sweep
    Pair(
        name="shm-channel",
        acquire_calls=frozenset({
            "ShmChannel", "BufferedShmChannel",
            "ShmChannel.open", "BufferedShmChannel.open",
            "open_channel", "shm_channel.open_channel",
        }),
        release_methods=frozenset({"release"}),
    ),
    # spill files ride the fd pair at creation (os.open O_EXCL) and the
    # unlink below for the on-disk name
    Pair(
        name="spill-path",
        acquire_calls=frozenset({"mktemp", "tempfile.mktemp"}),
        release_funcs=frozenset({"os.unlink", "os.remove"}),
        double_release_is_error=True,
    ),
)

_ALL_ACQUIRE_TOKENS = frozenset(
    tok
    for pair in REGISTRY
    for entry in (pair.acquire_calls | pair.acquire_methods | pair.receiver_acquire)
    for tok in (entry.rsplit(".", 1)[-1],)
)

_PAIRS_BY_NAME = {p.name: p for p in REGISTRY}

# fact tuples: ("acq" | "rel", pair-name, source line)
ACQ, REL = "acq", "rel"


def _acquire_binding(stmt) -> Optional[Tuple[str, Pair, int]]:
    """`x = open(...)` / `r, w = await asyncio.open_connection(...)` ->
    (bound name, pair, line)."""
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
        target, value = stmt.targets[0], stmt.value
    elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
        target, value = stmt.target, stmt.value
    else:
        return None
    if isinstance(value, ast.Await):
        value = value.value
    if not isinstance(value, ast.Call):
        return None
    dotted = _dotted(value.func)
    for pair in REGISTRY:
        hit = (dotted is not None and dotted in pair.acquire_calls) or (
            isinstance(value.func, ast.Attribute)
            and value.func.attr in pair.acquire_methods
            and not (
                isinstance(value.func.value, ast.Name)
                and value.func.value.id == "self"
            )
        )
        if not hit:
            continue
        if pair.tuple_index is None:
            if isinstance(target, ast.Name):
                return (target.id, pair, value.lineno)
        elif isinstance(target, ast.Tuple) and len(target.elts) > pair.tuple_index:
            elt = target.elts[pair.tuple_index]
            if isinstance(elt, ast.Name):
                return (elt.id, pair, value.lineno)
        return None
    return None


def _build_parents(exprs) -> Dict[ast.AST, ast.AST]:
    parents: Dict[ast.AST, ast.AST] = {}
    for root in exprs:
        for node in ast.walk(root):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
    return parents


def _under_lambda(node, parents) -> bool:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.Lambda):
            return True
        cur = parents.get(cur)
    return False


# pass-through containers between a value and the context that consumes it
_WRAPPERS = (ast.Tuple, ast.List, ast.Set, ast.Starred, ast.IfExp, ast.NamedExpr)


def _classify(node, parents):
    """How one Load occurrence of a tracked variable is used.

    Returns one of:
      ("method", attr, call)  receiver of a method call
      ("arg", call)           positional/keyword argument of a call
      ("escape",)             returned / yielded / raised / stored / aliased
      ("neutral",)            test, comparison, arithmetic, subscript index
    """
    p = parents.get(node)
    if isinstance(p, ast.Attribute) and p.value is node:
        gp = parents.get(p)
        if isinstance(gp, ast.Call) and gp.func is p:
            return ("method", p.attr, gp)
        return ("neutral",)
    if isinstance(p, ast.Call) and node in p.args:
        return ("arg", p)
    if isinstance(p, ast.keyword):
        return ("arg", parents.get(p))
    n, q = node, p
    while isinstance(q, _WRAPPERS):
        n, q = q, parents.get(q)
    if isinstance(q, (ast.Return, ast.Yield, ast.YieldFrom, ast.Raise)):
        return ("escape",)
    if isinstance(q, ast.Assign) and n is q.value:
        return ("escape",)
    if isinstance(q, (ast.AnnAssign, ast.AugAssign)) and n is getattr(q, "value", None):
        return ("escape",)
    if isinstance(q, ast.Await):
        return ("neutral",)
    if isinstance(q, ast.Call):  # wrapped (starred/tuple) into a call
        return ("arg", q)
    if isinstance(q, ast.Dict):
        return ("escape",)
    return ("neutral",)


def _narrow_test(test) -> Optional[Tuple[str, str]]:
    """`if fd:` / `if conn is None:` style guards -> (key, arm-to-drop-on).
    Returns (dotted key, "false"|"true"): the arm on which the variable is
    known falsy/None, so acquire facts can be dropped there."""
    node = test
    drop_on = "false"
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        node, drop_on = node.operand, "true"
    if isinstance(node, ast.Compare) and len(node.ops) == 1 and (
        isinstance(node.comparators[0], ast.Constant)
        and node.comparators[0].value is None
    ):
        key = _dotted(node.left)
        if key is None:
            return None
        if isinstance(node.ops[0], (ast.Is, ast.Eq)):
            return (key, "true" if drop_on == "false" else "false")
        if isinstance(node.ops[0], (ast.IsNot, ast.NotEq)):
            return (key, drop_on)
        return None
    key = _dotted(node)
    if key is not None:
        return (key, drop_on)
    return None


class _ResourceAnalysis(Analysis):
    """Per-variable acquire/release facts; transfer doubles as the event
    reporter when `report` is set (post-fixpoint pass)."""

    def __init__(self):
        self.report = None  # callable(rule, line, key, pair, message) | None

    # ------------------------------------------------------------- transfer
    def transfer(self, block, state):
        s = block.stmt
        if s is None:
            return {"normal": state, "exc": state}
        if isinstance(s, ast.ExceptHandler):
            out = dict(state)
            if s.name:
                out.pop(s.name, None)
            return {"normal": out, "exc": out}

        out = dict(state)
        acquired_this_stmt = False

        exprs = header_exprs(s)
        parents = _build_parents(exprs)

        # nested function/class bodies: anything they capture escapes
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            for node in ast.walk(s):
                if isinstance(node, ast.Name) and node.id in out:
                    out.pop(node.id, None)

        acq = _acquire_binding(s)
        acq_value_call = None
        if acq is not None:
            value = s.value.value if isinstance(s.value, ast.Await) else s.value
            acq_value_call = value

        # classify every use of a tracked key in the header expressions
        releases: List[Tuple[str, Pair, int]] = []
        for root in exprs:
            for node in ast.walk(root):
                if isinstance(node, ast.Lambda):
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Name) and sub.id in out:
                            out.pop(sub.id, None)
            for node in ast.walk(root):
                key = None
                if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                    getattr(node, "ctx", None), ast.Load
                ):
                    key = _dotted(node)
                if key is None or key not in out:
                    continue
                if _under_lambda(node, parents):
                    out.pop(key, None)
                    continue
                use = _classify(node, parents)
                pair = self._pair_of(out.get(key, state.get(key)))
                if use[0] == "method":
                    _kind, attr, call = use
                    if pair is not None and attr in pair.release_methods:
                        releases.append((key, pair, node.lineno))
                    # other method calls on the resource are neutral reads
                elif use[0] == "arg":
                    call = use[1]
                    callee = _dotted(call.func) if call is not None else None
                    if pair is not None and callee in pair.release_funcs \
                            and call.args and _dotted(call.args[0]) == key:
                        releases.append((key, pair, node.lineno))
                    elif pair is not None and isinstance(
                        getattr(call, "func", None), ast.Attribute
                    ) and call.func.attr in pair.release_arg_methods \
                            and call.args and _dotted(call.args[0]) == key:
                        releases.append((key, pair, node.lineno))
                    elif pair is not None and callee in pair.neutral_funcs:
                        pass
                    else:
                        out.pop(key, None)  # unknown callee takes the resource
                elif use[0] == "escape":
                    out.pop(key, None)

        # statement-style lock acquire: `x.acquire()` as a bare Expr
        if isinstance(s, ast.Expr) and isinstance(s.value, ast.Call):
            call = s.value
            if isinstance(call.func, ast.Attribute):
                key = _dotted(call.func.value)
                for pair in REGISTRY:
                    if call.func.attr in pair.receiver_acquire and key is not None:
                        self._note_overwrite(out, key, s.lineno)
                        out[key] = frozenset({(ACQ, pair.name, s.lineno)})
                        acquired_this_stmt = True

        # apply releases (after use-classification so `conn.close()` isn't
        # first treated as an escape)
        for key, pair, line in releases:
            facts = out.get(key, frozenset())
            if pair.double_release_is_error and any(f[0] == REL for f in facts):
                self._emit(
                    "res-double-release", line, key, pair,
                    f"{pair.name} {key!r} may already be released on some "
                    f"path reaching this release",
                )
            out[key] = frozenset({(REL, pair.name, line)})

        # value-producing acquire binds last (its call args were evaluated
        # against the PRE state above)
        if acq is not None:
            key, pair, line = acq
            self._note_overwrite(out, key, line)
            out[key] = frozenset({(ACQ, pair.name, line)})
            acquired_this_stmt = True
        else:
            self._apply_rebinds(s, out)

        self._apply_structural(s, out)

        # a statement whose only calls are non-awaited methods on the tracked
        # resource itself (`conn.set_push_handler(cb)`) is not a realistic
        # raise point between acquire and release: treating it as one would
        # flag every configure-then-store idiom
        calls = [
            n for root in exprs for n in ast.walk(root)
            if isinstance(n, ast.Call)
        ]
        has_yield_point = isinstance(s, (ast.Raise, ast.Assert)) or any(
            isinstance(n, (ast.Await, ast.Yield, ast.YieldFrom))
            for root in exprs for n in ast.walk(root)
        )
        benign_exc = bool(calls) and not has_yield_point and all(
            isinstance(c.func, ast.Attribute)
            and _dotted(c.func.value) in state
            for c in calls
        )

        exc_state = None if benign_exc else (state if acquired_this_stmt else out)
        result = {"normal": out, "exc": exc_state}
        if isinstance(s, (ast.If, ast.While)):
            narrowed = _narrow_test(s.test)
            if narrowed is not None:
                key, arm = narrowed
                if key in out:
                    dropped = dict(out)
                    dropped.pop(key, None)
                    result[arm] = dropped
        return result

    # ------------------------------------------------------------- helpers
    @staticmethod
    def _pair_of(facts) -> Optional[Pair]:
        if not facts:
            return None
        for _state, pairname, _line in facts:
            return _PAIRS_BY_NAME.get(pairname)
        return None

    def _emit(self, rule, line, key, pair, message):
        if self.report is not None:
            self.report(rule, line, key, pair, message)

    def _note_overwrite(self, out, key, line):
        facts = out.get(key)
        if not facts:
            return
        for state, pairname, acq_line in facts:
            if state == ACQ:
                pair = _PAIRS_BY_NAME[pairname]
                self._emit(
                    "res-leak-on-return", line, key, pair,
                    f"{pair.name} {key!r} acquired at line {acq_line} is "
                    f"rebound here while possibly still held — the previous "
                    f"resource leaks (loop-carried acquires hit this)",
                )
                break

    def _apply_rebinds(self, s, out):
        """A plain rebind of a tracked name drops tracking (and reports if a
        live resource is overwritten); `del x` drops tracking silently."""
        targets = []
        if isinstance(s, ast.Assign):
            targets = s.targets
        elif isinstance(s, (ast.AnnAssign, ast.AugAssign)):
            targets = [s.target]
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                key = _dotted(t)
                if key is not None:
                    out.pop(key, None)
            return
        for t in targets:
            for node in ast.walk(t):
                key = None
                if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                    getattr(node, "ctx", None), ast.Store
                ):
                    key = _dotted(node)
                if key is not None and key in out:
                    # rebinding to None after a release is the common idiom;
                    # rebinding while acquired loses the resource
                    if not (
                        isinstance(s, ast.Assign)
                        and isinstance(s.value, ast.Constant)
                        and s.value.value is None
                    ):
                        self._note_overwrite(out, key, s.lineno)
                    out.pop(key, None)

    @staticmethod
    def _apply_structural(s, out):
        """`with acquire() as x:` manages x's release structurally; a `for`
        target is rebound every iteration; both end tracking."""
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                key = _dotted(item.context_expr)
                if key is not None:
                    out.pop(key, None)  # `with lock:` — managed
                if item.optional_vars is not None:
                    for node in ast.walk(item.optional_vars):
                        k = _dotted(node)
                        if k is not None:
                            out.pop(k, None)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            for node in ast.walk(s.target):
                k = _dotted(node)
                if k is not None:
                    out.pop(k, None)


def _fn_mentions_acquire(fn) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id if isinstance(node.func, ast.Name) else None
            )
            if name in _ALL_ACQUIRE_TOKENS:
                return True
    return False


def check(files) -> List[Finding]:
    from .contract import _qualname_index

    findings: List[Finding] = []
    for sf in files:
        if sf.tree is None:
            continue
        for node, qual in _qualname_index(sf.tree).items():
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _fn_mentions_acquire(node):
                continue
            _check_fn(sf, node, qual, findings)
    return findings


def _check_fn(sf, fn, qual, findings: List[Finding]) -> None:
    cfg = build_cfg(fn)
    analysis = _ResourceAnalysis()
    states = solve(cfg, analysis)

    seen = set()

    def emit(rule, line, key, pair, message):
        f = Finding(
            rule=rule, file=sf.relpath, line=line, context=qual,
            message=f"{message} (in {fn.name})",
            detail=f"{pair.name}:{key}:{rule}",
        )
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            findings.append(f)

    # exit-state leaks
    for exit_block, rule, how in (
        (cfg.exit, "res-leak-on-return", "a normal return path"),
        (cfg.raise_exit, "res-leak-on-raise", "an exception path"),
    ):
        for key, facts in (states.get(exit_block.id) or {}).items():
            for state, pairname, line in sorted(facts):
                if state != ACQ:
                    continue
                pair = _PAIRS_BY_NAME[pairname]
                emit(
                    rule, line, key, pair,
                    f"{pair.name} {key!r} acquired here can reach {how} "
                    f"without a release",
                )

    # event findings (double release, overwrite) against fixpoint in-states
    analysis.report = emit
    for block in cfg.blocks:
        st = states.get(block.id)
        if st is not None and block.stmt is not None:
            analysis.transfer(block, st)
    analysis.report = None
