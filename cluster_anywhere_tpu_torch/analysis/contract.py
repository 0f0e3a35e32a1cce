"""RPC contract extraction: handler tables + call sites, from the AST.

The protocol is msgpack maps dispatched on a string method name, so the
"schema" lives in three code shapes:

  handlers   head: `_h_<method>` methods (dispatch is
             `getattr(self, "_h_" + m)`); worker/agent/driver-push: if/elif
             chains comparing `m` / `msg.get("m")` against string literals.
  reads      handlers read `msg["x"]` (required) or `msg.get("x")` /
             `"x" in msg` (optional).  A `msg["x"]` read under any
             conditional (if/try/loop/boolop) is demoted to optional: role-
             polymorphic handlers like `register` require different fields
             per branch, and only unconditional reads are a hard contract.
             A handler that hands the whole `msg` to a helper is resolved
             into same-module helpers; anything deeper marks its reads
             "opaque" (unread-field checks are skipped for that method
             rather than guessed).
  call sites `conn.call("method", field=...)` / `call_cb` / `notify` /
             `head_call` / `call_template` / `_notify_threadsafe` with a
             literal method name, plus message-shaped dict literals
             (`{"m": "pub", ...}`) fed to `write_frame` and the task-spec
             template builders.  `**kwargs` at a site makes its field set
             dynamic (method checks still apply; field checks are skipped).

Extraction is deliberately table-driven (SURFACES below): a new peer surface
is one line here, and the generated contract names every surface so drift is
visible in review.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Dict, List, Optional, Set, Tuple

# envelope fields supplied by the transport, never by call-site kwargs
RESERVED_FIELDS = {"m", "i", "tr", "ok", "err"}

# Connection.call()/head_call() consume `timeout` client-side (wait_for);
# it is an RPC deadline, not a wire field
_CLIENT_ONLY_KWARGS = {"timeout"}

_CALL_NAMES = {
    "call": "request",
    "request": "request",
    "head_call": "request",
    "call_cb": "request",
    "call_template": "request",
    "notify": "notify",
    "_notify_threadsafe": "notify",
}

# bare-name wrappers around a blocking head call (first arg = method)
_WRAPPER_NAMES = {"_head"}

# the committed contract and its human tables, relative to the repo root
CONTRACT_JSON = ("docs", "PROTOCOL_CONTRACT_TORCH.json")
CONTRACT_MD = ("docs", "PROTOCOL_CONTRACT_TORCH.md")

# (surface name, file, kind, spec) — kind "prefix": every `_h_<m>` def in the
# file; kind "chain": if/elif dispatch inside the named functions
SURFACES = (
    ("head", "cluster_anywhere_tpu_torch/core/head.py", "prefix", "_h_"),
    ("worker", "cluster_anywhere_tpu_torch/core/workerproc.py", "chain",
     ("_handle", "_fast_handle")),
    ("agent", "cluster_anywhere_tpu_torch/core/nodeagent.py", "chain", ("_handle",)),
    ("driver_push", "cluster_anywhere_tpu_torch/core/worker.py", "chain",
     ("_on_push", "_on_peer_push")),
    # the driver's own RPC listener (owner_locate/owner_refs/coll_push/…):
    # a nested `handle` closure inside Worker._start_p2p_server
    ("driver_p2p", "cluster_anywhere_tpu_torch/core/worker.py", "chain", ("handle",)),
)


@dataclasses.dataclass
class HandlerInfo:
    surface: str
    method: str
    file: str
    line: int
    context: str
    required: Set[str] = dataclasses.field(default_factory=set)
    optional: Set[str] = dataclasses.field(default_factory=set)
    opaque: bool = False  # msg escaped: the read set is not closed


@dataclasses.dataclass
class CallSite:
    file: str
    line: int
    context: str
    method: str
    kind: str                       # "request" | "notify" | "spec"
    fields: Optional[Set[str]]      # None = dynamic (**kwargs / template)

    @property
    def loc(self) -> str:
        return f"{self.file}:{self.line}"


@dataclasses.dataclass
class Contract:
    handlers: List[HandlerInfo]
    call_sites: List[CallSite]

    def handlers_for(self, method: str) -> List[HandlerInfo]:
        return [h for h in self.handlers if h.method == method]

    def handler_methods(self) -> Set[str]:
        return {h.method for h in self.handlers}

    def called_methods(self) -> Set[str]:
        return {c.method for c in self.call_sites}

    def known_methods(self) -> Set[str]:
        return self.handler_methods() | self.called_methods()


# ------------------------------------------------------------ AST utilities

def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _qualname_index(tree) -> Dict[ast.AST, str]:
    """def/class node -> dotted qualname."""
    out: Dict[ast.AST, str] = {}

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                q = f"{prefix}.{child.name}" if prefix else child.name
                out[child] = q
                walk(child, q)
            else:
                walk(child, prefix)

    walk(tree, "")
    return out


class _ModuleIndex:
    """Same-module lookup for one-level msg-flow resolution: method name ->
    def node (per class), plus module-level functions."""

    def __init__(self, tree):
        self.module_funcs: Dict[str, ast.AST] = {}
        self.class_methods: Dict[str, Dict[str, ast.AST]] = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.module_funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                methods = {}
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        methods[sub.name] = sub
                self.class_methods[node.name] = methods

    def resolve(self, call: ast.Call, cls: Optional[str]):
        """The def node a call dispatches to, when it's statically a
        same-module function or a method on the same class; else None."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return self.module_funcs.get(fn.id)
        if (
            isinstance(fn, ast.Attribute)
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "self"
            and cls is not None
        ):
            return self.class_methods.get(cls, {}).get(fn.attr)
        return None


def _analyze_msg_use(
    stmts, msg_name: str, index: _ModuleIndex, cls: Optional[str],
    _visited: Optional[set] = None,
) -> Tuple[Set[str], Set[str], bool]:
    """(required, optional, opaque) for how `msg_name` is consumed in stmts.

    required: `msg["x"]` loads.  optional: `.get/.pop/.setdefault("x")`,
    `"x" in msg`.  opaque: the dict escaped somewhere we can't follow
    (stored, returned, `**msg`, non-literal key, passed out of module)."""
    required: Set[str] = set()
    optional: Set[str] = set()
    opaque = False
    _visited = _visited if _visited is not None else set()

    parents: Dict[ast.AST, ast.AST] = {}
    roots = list(stmts)
    for root in roots:
        for node in ast.walk(root):
            for child in ast.iter_child_nodes(node):
                parents[child] = node

    _COND = (
        ast.If, ast.IfExp, ast.Try, ast.ExceptHandler, ast.While, ast.For,
        ast.AsyncFor, ast.BoolOp, ast.ListComp, ast.SetComp, ast.DictComp,
        ast.GeneratorExp, ast.Assert,
        # a read inside a nested def/lambda runs only if the closure does
        ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
    )

    def conditional(node) -> bool:
        """True when `node` may not execute on every message (so a
        `msg["x"]` there is not a hard requirement on senders)."""
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, _COND):
                return True
            cur = parents.get(cur)
        return False

    def follow(call: ast.Call, name_node: ast.AST) -> bool:
        """Resolve msg flowing into a same-module helper; True if followed."""
        target = index.resolve(call, cls)
        if target is None or id(target) in _visited:
            return False
        # positional index / keyword name -> parameter name
        params = [a.arg for a in target.args.args]
        if params and params[0] == "self":
            params = params[1:]
        param = None
        args = call.args
        if name_node in args:
            pos = args.index(name_node)
            if pos < len(params):
                param = params[pos]
        else:
            for kw in call.keywords:
                if kw.value is name_node and kw.arg is not None:
                    param = kw.arg
        if param is None:
            return False
        _visited.add(id(target))
        r, o, op = _analyze_msg_use(target.body, param, index, cls, _visited)
        if conditional(call):
            # the helper only runs on some branch: its hard reads are
            # conditional from the sender's point of view
            optional.update(r)
        else:
            required.update(r)
        optional.update(o)
        return not op

    for root in roots:
        for node in ast.walk(root):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue  # closures over msg are rare; names inside still walk —
                # accepted: over-collection beats missing a read
            if not (isinstance(node, ast.Name) and node.id == msg_name):
                continue
            p = parents.get(node)
            if isinstance(p, ast.Subscript) and p.value is node:
                key = _const_str(p.slice)
                if key is None:
                    opaque = True
                elif isinstance(p.ctx, ast.Load):
                    (optional if conditional(node) else required).add(key)
                continue
            if isinstance(p, ast.Attribute) and p.value is node:
                gp = parents.get(p)
                if isinstance(gp, ast.Call) and gp.func is p:
                    if p.attr in ("get", "pop", "setdefault"):
                        key = _const_str(gp.args[0]) if gp.args else None
                        if key is None:
                            opaque = True
                        else:
                            optional.add(key)
                        continue
                opaque = True
                continue
            if (
                isinstance(p, ast.Compare)
                and node in p.comparators
                and all(isinstance(op, (ast.In, ast.NotIn)) for op in p.ops)
            ):
                key = _const_str(p.left)
                if key is not None:
                    optional.add(key)
                else:
                    opaque = True
                continue
            if isinstance(p, ast.Call) and (node in p.args):
                if not follow(p, node):
                    opaque = True
                continue
            if isinstance(p, ast.keyword) and p.value is node:
                gp = parents.get(p)
                if not (isinstance(gp, ast.Call) and follow(gp, node)):
                    opaque = True
                continue
            opaque = True
    return required, optional, opaque


# --------------------------------------------------------- handler surfaces

def _msg_param(fndef) -> str:
    names = [a.arg for a in fndef.args.args]
    if "msg" in names:
        return "msg"
    # _h_*(self, state, msg, reply, reply_err) convention
    return names[2] if len(names) > 2 else (names[-1] if names else "msg")


def _extract_prefix_surface(sf, surface: str, prefix: str) -> List[HandlerInfo]:
    index = _ModuleIndex(sf.tree)
    quals = _qualname_index(sf.tree)
    out = []
    for node, qual in quals.items():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not node.name.startswith(prefix):
            continue
        cls = qual.rsplit(".", 2)[0] if "." in qual else None
        req, opt, opaque = _analyze_msg_use(
            node.body, _msg_param(node), index, cls
        )
        out.append(HandlerInfo(
            surface=surface, method=node.name[len(prefix):], file=sf.relpath,
            line=node.lineno, context=qual,
            required=req - {"m"}, optional=opt - {"m"}, opaque=opaque,
        ))
    return out


def _dispatch_methods(test, dispatch_names: Set[str]) -> Tuple[List[str], bool]:
    """Match a chain branch test against the dispatch var.  Returns
    (methods, negated): `m == "x"` -> (["x"], False); `m in ("x","y")` ->
    (["x","y"], False); `msg.get("m") != "x"` -> (["x"], True)."""

    def is_dispatch(expr) -> bool:
        if isinstance(expr, ast.Name) and expr.id in dispatch_names:
            return True
        if isinstance(expr, ast.Subscript) and _const_str(expr.slice) == "m":
            return True
        if (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "get"
            and expr.args
            and _const_str(expr.args[0]) == "m"
        ):
            return True
        return False

    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for sub in test.values:
            methods, neg = _dispatch_methods(sub, dispatch_names)
            if methods and not neg:
                return methods, False
        return [], False
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return [], False
    if not is_dispatch(test.left):
        return [], False
    op, right = test.ops[0], test.comparators[0]
    if isinstance(op, (ast.Eq, ast.NotEq)):
        lit = _const_str(right)
        return ([lit] if lit is not None else []), isinstance(op, ast.NotEq)
    if isinstance(op, ast.In) and isinstance(right, (ast.Tuple, ast.List, ast.Set)):
        lits = [s for s in (_const_str(e) for e in right.elts) if s is not None]
        return lits, False
    return [], False


def _extract_chain_surface(sf, surface: str, fn_names) -> List[HandlerInfo]:
    index = _ModuleIndex(sf.tree)
    quals = _qualname_index(sf.tree)
    out = []
    for node, qual in quals.items():
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name not in fn_names:
            continue
        cls = qual.rsplit(".", 2)[0] if "." in qual else None
        # names assigned from msg["m"] / msg.get("m") act as the dispatch var
        dispatch_names: Set[str] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                v = sub.value
                if isinstance(v, ast.Subscript) and _const_str(v.slice) == "m":
                    dispatch_names.add(sub.targets[0].id)
                elif (
                    isinstance(v, ast.Call)
                    and isinstance(v.func, ast.Attribute)
                    and v.func.attr == "get"
                    and v.args and _const_str(v.args[0]) == "m"
                ):
                    dispatch_names.add(sub.targets[0].id)

        def emit(methods, body, line):
            req, opt, opaque = _analyze_msg_use(body, _msg_param(node), index, cls)
            for m in methods:
                out.append(HandlerInfo(
                    surface=surface, method=m, file=sf.relpath, line=line,
                    context=qual, required=req - {"m"}, optional=opt - {"m"},
                    opaque=opaque,
                ))

        def walk_block(stmts):
            for i, stmt in enumerate(stmts):
                if isinstance(stmt, ast.If):
                    methods, negated = _dispatch_methods(stmt.test, dispatch_names)
                    if methods and negated and all(
                        isinstance(s, (ast.Return, ast.Raise, ast.Continue))
                        for s in stmt.body
                    ):
                        # `if m != "pub": return` — the rest of this block IS
                        # the "pub" handler
                        emit(methods, stmts[i + 1:], stmt.lineno)
                    elif methods and not negated:
                        emit(methods, stmt.body, stmt.lineno)
                        walk_block(stmt.orelse)  # elif chain continues
                        continue
                    walk_block(stmt.body)
                    walk_block(stmt.orelse)
                elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                    walk_block(stmt.body)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    walk_block(stmt.body)
                elif isinstance(stmt, ast.Try):
                    walk_block(stmt.body)
                    for h in stmt.handlers:
                        walk_block(h.body)
                    walk_block(stmt.finalbody)

        walk_block(node.body)
    return out


# -------------------------------------------------------------- call sites

def _extract_call_sites(sf) -> List[CallSite]:
    quals = _qualname_index(sf.tree)
    out: List[CallSite] = []

    def context_of(stack) -> str:
        for node in reversed(stack):
            q = quals.get(node)
            if q is not None:
                return q
        return "<module>"

    stack: List[ast.AST] = []

    def visit(node):
        stack.append(node)
        if isinstance(node, ast.Call):
            site = _call_site_from_call(sf, node, context_of(stack))
            out.extend(site)
        elif isinstance(node, ast.Dict):
            site = _call_site_from_dict(sf, node, context_of(stack))
            if site is not None:
                out.append(site)
        for child in ast.iter_child_nodes(node):
            visit(child)
        stack.pop()

    visit(sf.tree)
    return out


def _call_site_from_call(sf, node: ast.Call, context: str) -> List[CallSite]:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr not in _CALL_NAMES:
            return []
        # subprocess.call("cmd") is not an RPC
        if isinstance(fn.value, ast.Name) and fn.value.id in ("subprocess", "sp"):
            return []
        name = fn.attr
    elif isinstance(fn, ast.Name) and fn.id in _WRAPPER_NAMES:
        # module-level blocking-RPC wrappers (util/state._head)
        name = "call"
    else:
        return []
    if not node.args:
        return []  # cond.notify() and friends
    methods: List[str] = []
    first = node.args[0]
    lit = _const_str(first)
    if lit is not None:
        methods = [lit]
    elif isinstance(first, ast.IfExp):
        # "worker_blocked" if blocked else "worker_unblocked"
        lits = [_const_str(first.body), _const_str(first.orelse)]
        methods = [s for s in lits if s is not None]
    if not methods:
        return []  # dynamic method (generic forwarder): nothing to check
    kind = _CALL_NAMES[name]
    fields: Optional[Set[str]] = set()
    if name == "call_template":
        fields = None  # fields ride the pre-encoded template
    else:
        for kw in node.keywords:
            if kw.arg is None:
                fields = None  # **fields: open field set
                break
            fields.add(kw.arg)
        if fields is not None and name in ("call", "head_call", "request"):
            fields -= _CLIENT_ONLY_KWARGS
    return [
        CallSite(file=sf.relpath, line=node.lineno, context=context,
                 method=m, kind=kind, fields=fields)
        for m in methods
    ]


def _call_site_from_dict(sf, node: ast.Dict, context: str) -> Optional[CallSite]:
    """Message-shaped dict literal: {"m": "<method>", ...} — push frames fed
    to write_frame, the task-spec field dicts, drain/gone pub frames."""
    method = None
    fields: Optional[Set[str]] = set()
    for k, v in zip(node.keys, node.values):
        if k is None:
            fields = None  # **expansion
            continue
        key = _const_str(k)
        if key is None:
            fields = None
            continue
        if key == "m":
            method = _const_str(v)
        elif fields is not None:
            fields.add(key)
    if method is None:
        return None
    return CallSite(file=sf.relpath, line=node.lineno, context=context,
                    method=method, kind="spec", fields=fields)


# ------------------------------------------------------------- entry points

def extract_contract(files) -> Contract:
    by_path = {sf.relpath: sf for sf in files}
    handlers: List[HandlerInfo] = []
    for surface, path, kind, spec in SURFACES:
        sf = by_path.get(path)
        if sf is None or sf.tree is None:
            continue
        if kind == "prefix":
            handlers.extend(_extract_prefix_surface(sf, surface, spec))
        else:
            handlers.extend(_extract_chain_surface(sf, surface, spec))
    # the protocol layer itself consumes `batch` envelopes (iter_messages)
    handlers.append(HandlerInfo(
        surface="protocol", method="batch",
        file="cluster_anywhere_tpu_torch/core/protocol.py", line=1,
        context="iter_messages", optional={"b"},
    ))
    call_sites: List[CallSite] = []
    for sf in files:
        if sf.tree is not None:
            call_sites.extend(_extract_call_sites(sf))
    # chain branches that handle multiple methods produce duplicate
    # HandlerInfo rows per method; merge them (union reads, OR opaque)
    merged: Dict[Tuple[str, str], HandlerInfo] = {}
    for h in handlers:
        key = (h.surface, h.method)
        cur = merged.get(key)
        if cur is None:
            merged[key] = h
        else:
            cur.required |= h.required
            cur.optional |= h.optional
            cur.opaque = cur.opaque or h.opaque
    return Contract(handlers=list(merged.values()), call_sites=call_sites)


def contract_to_json(contract: Contract) -> dict:
    surfaces: Dict[str, dict] = {}
    callers: Dict[str, List[str]] = {}
    for c in sorted(contract.call_sites, key=lambda c: (c.file, c.line)):
        callers.setdefault(c.method, []).append(c.loc)
    for h in sorted(contract.handlers, key=lambda h: (h.surface, h.method)):
        surf = surfaces.setdefault(h.surface, {"file": h.file, "methods": {}})
        surf["methods"][h.method] = {
            "line": h.line,
            "context": h.context,
            "required": sorted(h.required),
            "optional": sorted(h.optional),
            "opaque": h.opaque,
            "callers": callers.get(h.method, []),
        }
    return {
        "version": 1,
        "generated_by": "ca lint --contract",
        "surfaces": surfaces,
        "methods": sorted(contract.known_methods()),
    }


def render_markdown(contract: Contract) -> str:
    """The human table for docs/PROTOCOL_CONTRACT_TORCH.md, one row per
    (surface, method)."""
    lines = [
        "| surface | method | required fields | optional fields | call sites |",
        "|---|---|---|---|---|",
    ]
    callers: Dict[str, int] = {}
    for c in contract.call_sites:
        callers[c.method] = callers.get(c.method, 0) + 1
    for h in sorted(contract.handlers, key=lambda h: (h.surface, h.method)):
        req = ", ".join(sorted(h.required)) or "—"
        opt = ", ".join(sorted(h.optional)) or "—"
        if h.opaque:
            opt += " …"
        lines.append(
            f"| {h.surface} | `{h.method}` | {req} | {opt} | {callers.get(h.method, 0)} |"
        )
    return "\n".join(lines)


def load_contract(root: Optional[str] = None) -> Optional[dict]:
    """The committed contract (docs/PROTOCOL_CONTRACT_TORCH.json, or the
    file CA_CONTRACT_PATH names), for runtime consumers (the chaos-spec
    validator).  None when not checked out."""
    if root is None:
        from .engine import default_root

        root = default_root()
    path = os.environ.get("CA_CONTRACT_PATH") or os.path.join(
        root, *CONTRACT_JSON
    )
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
