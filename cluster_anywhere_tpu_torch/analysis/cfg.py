"""Intraprocedural control-flow graphs over stdlib AST.

Statement-local passes can see *a* blocking call or *a*
dropped task, but not a *path* property — "this file descriptor is opened on
line 10 and there exists an execution path to the function's exceptional exit
on which nobody closed it".  Path properties need a CFG; this module builds
one per function, and analysis/dataflow.py runs worklist fixpoints over it.

Shape
-----
One statement per block (lint-scale functions are small; merging basic blocks
buys nothing here).  Compound statements contribute a *header* block holding
only the expressions the statement itself evaluates (an `if` test, a `for`
iterable, a `with` item list) — their bodies become separate blocks wired
with edges.  Three distinguished virtual blocks:

  entry       no statement; predecessor of the first real block
  exit        every normal return path ends here
  raise_exit  every path on which an unhandled exception leaves the function

Edges carry a kind:

  normal      sequential flow
  true/false  the two arms of a branch test (dataflow clients may narrow:
              `if fd:` implies fd is live on the true arm only)
  back        a loop back-edge (body bottom -> loop header)
  exc         exceptional flow out of a statement that can raise, into the
              innermost handler dispatch / finally copy / raise_exit.  A
              dataflow transfer provides a *separate* state for exc edges
              (e.g. the acquire statement itself raising means the resource
              was never acquired).
  endfinally  the re-raise continuation at the bottom of an exception-path
              `finally` copy: flow continues to the outer exception target,
              but with the block's NORMAL out-state (the finally body ran to
              completion; the in-flight exception is what propagates).

try/except/finally
------------------
Exceptions from the protected body flow to a virtual `except.dispatch` block
with an `exc` edge to every handler entry, plus a no-match `exc` edge onward
(suppressed when a catch-all handler — bare, Exception, BaseException — is
present).  `finally` bodies are *inlined by duplication*, the standard lint
trick: one copy on the normal path, one on the exception path (ending in an
`endfinally` edge to the outer exception target), and one fresh copy per
abrupt exit (`return`/`break`/`continue`) threaded before the jump resolves.
Duplication introduces no infeasible-path trouble for may-analyses and keeps
the solver oblivious to finally semantics.

`with` statements contribute their item expressions as a header block; the
managed release on block exit is a *client* concern (the resource pass simply
never tracks context-managed acquires).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

__all__ = ["Block", "CFG", "build_cfg", "header_exprs", "may_raise"]

# edge kinds a dataflow transfer receives its exceptional out-state on
EXC_KINDS = ("exc",)


class Block:
    __slots__ = ("id", "stmt", "label", "succs", "preds")

    def __init__(self, bid: int, label: str = "", stmt: Optional[ast.AST] = None):
        self.id = bid
        self.stmt = stmt          # None for virtual blocks (entry/exit/joins)
        self.label = label
        self.succs: List[Tuple["Block", str]] = []
        self.preds: List[Tuple["Block", str]] = []

    def add_succ(self, other: "Block", kind: str = "normal") -> None:
        self.succs.append((other, kind))
        other.preds.append((self, kind))

    def __repr__(self):  # pragma: no cover - debugging aid
        line = getattr(self.stmt, "lineno", "-")
        return f"<Block {self.id} {self.label or type(self.stmt).__name__ if self.stmt else self.label}:{line}>"


class CFG:
    def __init__(self, fn: ast.AST):
        self.fn = fn
        self.blocks: List[Block] = []
        self.entry = self.new_block("entry")
        self.exit = self.new_block("exit")
        self.raise_exit = self.new_block("raise")

    def new_block(self, label: str = "", stmt: Optional[ast.AST] = None) -> Block:
        b = Block(len(self.blocks), label, stmt)
        self.blocks.append(b)
        return b

    def stmt_blocks(self) -> List[Block]:
        """Real (non-virtual) blocks, in creation (~source) order."""
        return [b for b in self.blocks if b.stmt is not None]


def header_exprs(stmt: ast.AST) -> List[ast.AST]:
    """The expressions a compound statement's header block evaluates itself
    (bodies are separate blocks).  Simple statements evaluate themselves."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter, stmt.target]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        out: List[ast.AST] = []
        for item in stmt.items:
            out.append(item.context_expr)
            if item.optional_vars is not None:
                out.append(item.optional_vars)
        return out
    if isinstance(stmt, ast.Try):
        return []
    if isinstance(stmt, ast.ExceptHandler):
        return [stmt.type] if stmt.type is not None else []
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
        # the def statement evaluates decorators and defaults; the body is a
        # separate scope (clients handle captures themselves)
        return list(stmt.decorator_list) + [
            d for d in (stmt.args.defaults + stmt.args.kw_defaults) if d is not None
        ]
    if isinstance(stmt, ast.ClassDef):
        return list(stmt.decorator_list) + list(stmt.bases)
    return [stmt]


def may_raise(stmt: ast.AST) -> bool:
    """Conservative can-this-statement-raise, at lint granularity: calls,
    awaits, explicit raises, asserts, and iteration can; plain data plumbing
    (name binds, attribute reads, arithmetic) is treated as safe — treating
    *everything* as raising would put an exc edge after every acquire and
    drown the leak rules in noise."""
    if isinstance(stmt, (ast.Raise, ast.Assert)):
        return True
    if isinstance(stmt, (ast.For, ast.AsyncFor, ast.With, ast.AsyncWith)):
        return True  # iteration / __enter__ can raise
    for expr in header_exprs(stmt):
        for node in ast.walk(expr):
            if isinstance(node, (ast.Call, ast.Await, ast.Yield, ast.YieldFrom)):
                return True
    return False


def _is_catch_all(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True

    def names(node):
        if isinstance(node, ast.Tuple):
            for elt in node.elts:
                yield from names(elt)
        elif isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr

    return any(n in ("Exception", "BaseException") for n in names(handler.type))


class _Ctx:
    """Build-time context: where exceptions go, which finally bodies an
    abrupt exit must thread through, and the innermost loop's targets."""

    __slots__ = ("exc", "finallies", "loop")

    def __init__(self, exc, finallies=(), loop=None):
        self.exc = exc                # Block receiving exc edges
        self.finallies = finallies    # tuple of (finalbody, ctx-at-try)
        self.loop = loop              # (continue_target, break_edges, fin_depth)

    def replace(self, **kw) -> "_Ctx":
        out = _Ctx(self.exc, self.finallies, self.loop)
        for k, v in kw.items():
            setattr(out, k, v)
        return out


# frontier: list of (Block, kind) edges waiting to be attached to whatever
# block comes next; an empty frontier means the point is unreachable
Frontier = List[Tuple[Block, str]]


class _Builder:
    def __init__(self, cfg: CFG):
        self.cfg = cfg

    def attach(self, frontier: Frontier, block: Block) -> None:
        for src, kind in frontier:
            src.add_succ(block, kind)

    def block_for(self, stmt, frontier: Frontier, label: str = "") -> Block:
        blk = self.cfg.new_block(label, stmt)
        self.attach(frontier, blk)
        return blk

    def seq(self, stmts, frontier: Frontier, ctx: _Ctx) -> Frontier:
        for s in stmts:
            if not frontier:
                break  # unreachable (code after return/raise): not modeled
            frontier = self.stmt(s, frontier, ctx)
        return frontier

    def unwind_finallies(self, frontier: Frontier, ctx: _Ctx, upto: int) -> Frontier:
        """Inline a fresh copy of every finally body between the abrupt exit
        and `upto` entries deep, innermost first."""
        for fb, fctx in reversed(ctx.finallies[upto:]):
            frontier = self.seq(fb, frontier, fctx)
        return frontier

    def stmt(self, s, frontier: Frontier, ctx: _Ctx) -> Frontier:
        if isinstance(s, ast.Return):
            blk = self.block_for(s, frontier, "return")
            if may_raise(s):
                blk.add_succ(ctx.exc, "exc")
            out = self.unwind_finallies([(blk, "normal")], ctx, 0)
            self.attach(out, self.cfg.exit)
            return []
        if isinstance(s, ast.Raise):
            blk = self.block_for(s, frontier, "raise")
            blk.add_succ(ctx.exc, "exc")
            return []
        if isinstance(s, (ast.Break, ast.Continue)):
            blk = self.block_for(s, frontier)
            if ctx.loop is None:
                return []  # malformed source; nothing sensible to wire
            cont, brk, depth = ctx.loop
            out = self.unwind_finallies([(blk, "normal")], ctx, depth)
            if isinstance(s, ast.Break):
                brk.extend(out)
            else:
                self.attach(out, cont)
            return []
        if isinstance(s, ast.If):
            return self._if(s, frontier, ctx)
        if isinstance(s, ast.While):
            return self._loop(s, frontier, ctx, header_may_raise=may_raise(s))
        if isinstance(s, (ast.For, ast.AsyncFor)):
            return self._loop(s, frontier, ctx, header_may_raise=True)
        if isinstance(s, (ast.With, ast.AsyncWith)):
            blk = self.block_for(s, frontier, "with")
            blk.add_succ(ctx.exc, "exc")
            return self.seq(s.body, [(blk, "normal")], ctx)
        if isinstance(s, ast.Try):
            return self._try(s, frontier, ctx)
        # simple statement (including nested def/class, whose body is a
        # separate scope the clients inspect for captures)
        blk = self.block_for(s, frontier)
        if may_raise(s):
            blk.add_succ(ctx.exc, "exc")
        return [(blk, "normal")]

    def _if(self, s: ast.If, frontier: Frontier, ctx: _Ctx) -> Frontier:
        blk = self.block_for(s, frontier, "if")
        if may_raise(s):
            blk.add_succ(ctx.exc, "exc")
        body_f = self.seq(s.body, [(blk, "true")], ctx)
        if s.orelse:
            else_f = self.seq(s.orelse, [(blk, "false")], ctx)
        else:
            else_f = [(blk, "false")]
        return body_f + else_f

    def _loop(self, s, frontier: Frontier, ctx: _Ctx, header_may_raise: bool) -> Frontier:
        head = self.block_for(s, frontier, "loop")
        if header_may_raise:
            head.add_succ(ctx.exc, "exc")
        break_edges: Frontier = []
        body_ctx = ctx.replace(loop=(head, break_edges, len(ctx.finallies)))
        body_f = self.seq(s.body, [(head, "true")], body_ctx)
        for src, kind in body_f:
            # keep branch-arm kinds on the back edge so dataflow narrowing
            # (`if off is not None: return` -> the false arm loops) survives
            src.add_succ(head, "back" if kind == "normal" else kind)
        const_true = (
            isinstance(s, ast.While)
            and isinstance(s.test, ast.Constant)
            and bool(s.test.value)
        )
        if const_true:
            out: Frontier = []  # `while True:` only leaves via break/raise
        elif s.orelse:
            out = self.seq(s.orelse, [(head, "false")], ctx)
        else:
            out = [(head, "false")]
        return out + break_edges

    def _try(self, s: ast.Try, frontier: Frontier, ctx: _Ctx) -> Frontier:
        # exception-path finally copy: runs, then re-raises outward with its
        # normal out-state (endfinally edge)
        if s.finalbody:
            fent = self.cfg.new_block("finally.exc")
            ftail = self.seq(s.finalbody, [(fent, "normal")], ctx)
            for src, _kind in ftail:
                src.add_succ(ctx.exc, "endfinally")
            exc_base: Block = fent
            inner_finallies = ctx.finallies + ((s.finalbody, ctx),)
        else:
            exc_base = ctx.exc
            inner_finallies = ctx.finallies

        if s.handlers:
            dispatch = self.cfg.new_block("except.dispatch")
            body_exc: Block = dispatch
        else:
            body_exc = exc_base

        body_ctx = ctx.replace(exc=body_exc, finallies=inner_finallies)
        body_f = self.seq(s.body, frontier, body_ctx)

        # the else clause runs after normal body completion and is NOT
        # protected by the handlers
        after_ctx = ctx.replace(exc=exc_base, finallies=inner_finallies)
        if s.orelse:
            body_f = self.seq(s.orelse, body_f, after_ctx)

        handler_f: Frontier = []
        if s.handlers:
            catch_all = False
            for h in s.handlers:
                hblk = self.cfg.new_block("except", stmt=h)
                dispatch.add_succ(hblk, "exc")
                handler_f += self.seq(h.body, [(hblk, "normal")], after_ctx)
                catch_all = catch_all or _is_catch_all(h)
            if not catch_all:
                dispatch.add_succ(exc_base, "exc")

        normal_f = body_f + handler_f
        if s.finalbody and normal_f:
            normal_f = self.seq(s.finalbody, normal_f, ctx)
        return normal_f


def build_cfg(fn) -> CFG:
    """Build the CFG for one ast.FunctionDef / ast.AsyncFunctionDef."""
    cfg = CFG(fn)
    builder = _Builder(cfg)
    ctx = _Ctx(exc=cfg.raise_exit)
    tail = builder.seq(fn.body, [(cfg.entry, "normal")], ctx)
    builder.attach(tail, cfg.exit)  # falling off the end returns None
    return cfg
