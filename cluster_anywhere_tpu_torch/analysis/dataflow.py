"""Worklist dataflow solver over analysis/cfg.py graphs.

Forward may-analysis framework: a client provides an initial state, a join,
and a per-block transfer; the solver iterates to fixpoint and returns every
block's IN state.  States are per-variable maps to *fact sets* — joining is
pointwise union, so the lattice has finite height (facts are drawn from the
finitely many acquire/release sites in one function) and termination is
structural, not fuel-based.

The transfer returns per-edge-kind out-states:

    transfer(block, in_state) -> {"normal": state, "exc": state | None, ...}

Edges of kind "exc" receive the "exc" entry; every other kind ("true",
"false", "back", "endfinally", "normal") receives its own entry if present,
else "normal".  A None state marks the edge infeasible for this client
(e.g. "this statement cannot actually raise"), and nothing propagates.
Returning per-kind states is what lets clients be flow-precise where it
matters: the acquire statement's own exc edge carries the PRE state (the
acquire failed, nothing was held), a branch on `if fd:` can drop facts on
the false arm, and an `endfinally` edge carries the normal out-state of a
completed finally body.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

from .cfg import CFG, Block

__all__ = ["Analysis", "solve", "State", "join_states"]

# var name (possibly dotted, e.g. "self._lock") -> frozenset of fact tuples
State = Dict[str, frozenset]


def join_states(a: State, b: State) -> State:
    """Pointwise union join (may-analysis)."""
    if not a:
        return dict(b)
    if not b:
        return dict(a)
    out = dict(a)
    for k, facts in b.items():
        cur = out.get(k)
        out[k] = facts if cur is None else (cur | facts)
    return out


class Analysis:
    """Client interface; subclass and override transfer()."""

    def initial(self) -> State:
        return {}

    def join(self, a: State, b: State) -> State:
        return join_states(a, b)

    def transfer(self, block: Block, state: State) -> Dict[str, Optional[State]]:
        return {"normal": state, "exc": state}


def solve(cfg: CFG, analysis: Analysis) -> Dict[int, State]:
    """Run to fixpoint; returns block id -> IN state.  Blocks never reached
    (dead code, infeasible handlers) have no entry."""
    in_states: Dict[int, State] = {cfg.entry.id: analysis.initial()}
    work = deque([cfg.entry])
    queued = {cfg.entry.id}

    while work:
        block = work.popleft()
        queued.discard(block.id)
        outs = analysis.transfer(block, in_states[block.id])
        normal = outs.get("normal")
        for succ, kind in block.succs:
            out = outs.get(kind, normal)
            if out is None:
                continue
            cur = in_states.get(succ.id)
            if cur is None:
                merged = dict(out)
            else:
                merged = analysis.join(cur, out)
                if merged == cur:
                    continue
            in_states[succ.id] = merged
            if succ.id not in queued:
                queued.add(succ.id)
                work.append(succ)
    return in_states
