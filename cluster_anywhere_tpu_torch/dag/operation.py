"""Per-actor operation schedules for compiled DAGs (analogue of the
reference's dag/dag_node_operation.py: _DAGNodeOperation /
_DAGOperationGraphNode / _generate_actor_to_execution_schedule).

Each compute node decomposes into up to three operations:

  READ(channel, actor)  — pull one value from a cross-process channel
                          (one op per (channel, actor) pair, because a
                          channel must be read exactly once per tick no
                          matter how many of the actor's nodes consume it);
  COMPUTE(node)         — run the bound method;
  WRITE(node)           — push the result into the node's output channel.

The global operation graph links READ -> COMPUTE -> WRITE within a node,
WRITE(producer) -> READ(channel, consumer-actor) across processes, and
COMPUTE(producer) -> COMPUTE(consumer) for same-actor in-memory edges.
Schedules are produced by a deterministic Kahn traversal prioritised by
*stage depth* (longest path from the DAG input), so that when one actor
hosts nodes from several pipeline stages — the interleaved-pipeline shape,
e.g. actor A holding stages 0 and 2 with actor B holding stage 1 — every
microbatch's stage-0 work is scheduled before A blocks on B's stage-1
output.  A naive depth-first program order would serialise the microbatches
(A cannot start microbatch 1 until microbatch 0 has come back from B);
the schedule turns the same DAG into a GPipe-style pipeline.

Because every per-actor schedule is a projection of one global topological
order, scheduled blocking reads cannot deadlock against each other; a cycle
in the operation graph is detected here and raised at compile time instead
of hanging an actor loop at runtime.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, List, Set, Tuple

READ = "read"
COMPUTE = "compute"
WRITE = "write"
_KIND_ORDER = {READ: 0, COMPUTE: 1, WRITE: 2}

# Op identity: (READ, (channel_id, actor_key)) | (COMPUTE, node_id) |
# (WRITE, node_id).  Keys never mix types within a kind, so OpIds are
# totally ordered and usable as deterministic heap tie-breakers.
OpId = Tuple[str, Any]


class ScheduleError(ValueError):
    """The operation graph admits no schedule (cyclic dependencies)."""


def node_depths(compute_nodes) -> Dict[int, int]:
    """Longest-path-from-input depth per compute node id.  Input nodes sit
    at depth 0; a node is one deeper than its deepest DAGNode argument."""
    from .node import ClassMethodNode

    depth: Dict[int, int] = {}
    for n in compute_nodes:  # already in topological order (deps first)
        d = 0
        for dep in n._upstream():
            if isinstance(dep, ClassMethodNode):
                d = max(d, depth[dep._id] + 1)
            else:
                d = max(d, 1)
        depth[n._id] = d
    return depth


def build_operation_graph(
    compute_nodes,
    owner_of,
    channel_ids: Set[int],
    input_id: int,
):
    """Return (ops, edges) of the global operation graph.

    ops: OpId -> {"actor": key, "depth": int, "order": int}
    edges: OpId -> set of successor OpIds
    """
    from .node import ClassMethodNode, InputAttributeNode, InputNode

    depths = node_depths(compute_nodes)
    ops: Dict[OpId, Dict[str, Any]] = {}
    edges: Dict[OpId, Set[OpId]] = {}

    def add_op(opid: OpId, actor: str, depth: int, order: int):
        if opid not in ops:
            ops[opid] = {"actor": actor, "depth": depth, "order": order}
            edges[opid] = set()
        else:
            # a READ shared by several of the actor's nodes runs as early as
            # its earliest consumer needs it
            ops[opid]["depth"] = min(ops[opid]["depth"], depth)
            ops[opid]["order"] = min(ops[opid]["order"], order)

    for n in compute_nodes:
        key = owner_of(n)
        comp: OpId = (COMPUTE, n._id)
        add_op(comp, key, depths[n._id], n._id)
        for dep in n._upstream():
            if isinstance(dep, (InputNode, InputAttributeNode)):
                rd: OpId = (READ, (input_id, key))
                add_op(rd, key, depths[n._id], n._id)
                edges[rd].add(comp)
            elif isinstance(dep, ClassMethodNode):
                if owner_of(dep) == key:
                    edges[(COMPUTE, dep._id)].add(comp)
                else:
                    rd = (READ, (dep._id, key))
                    add_op(rd, key, depths[n._id], n._id)
                    edges[rd].add(comp)
                    if dep._id in channel_ids:
                        wr: OpId = (WRITE, dep._id)
                        # producer WRITE op is added when the producer node
                        # is visited; deps-first topo order guarantees it
                        # exists by now
                        edges[wr].add(rd)
        if n._id in channel_ids:
            wr = (WRITE, n._id)
            add_op(wr, key, depths[n._id], n._id)
            edges[comp].add(wr)
    return ops, edges


def generate_actor_schedules(ops, edges) -> Dict[str, List[OpId]]:
    """Deterministic priority-Kahn linearisation of the operation graph,
    projected onto each actor (reference:
    _generate_actor_to_execution_schedule, dag_node_operation.py:360).

    Priority = (stage depth, node creation order, READ < COMPUTE < WRITE):
    shallow-stage work schedules first, which is exactly the interleaving
    that keeps every pipeline stage busy.  Raises ScheduleError on a cycle.
    """
    indeg: Dict[OpId, int] = {o: 0 for o in ops}
    for a, succs in edges.items():
        for b in succs:
            indeg[b] += 1

    def push(o: OpId):
        meta = ops[o]
        heapq.heappush(heap, (meta["depth"], meta["order"], _KIND_ORDER[o[0]], o))

    heap: list = []
    for o, d in indeg.items():
        if d == 0:
            push(o)
    schedules: Dict[str, List[OpId]] = {}
    done = 0
    while heap:
        _, _, _, o = heapq.heappop(heap)
        schedules.setdefault(ops[o]["actor"], []).append(o)
        done += 1
        for b in edges[o]:
            indeg[b] -= 1
            if indeg[b] == 0:
                push(b)
    if done != len(ops):
        stuck = sorted(o for o, d in indeg.items() if d > 0)
        raise ScheduleError(
            f"compiled DAG operation graph has a cycle; unschedulable ops: {stuck[:8]}"
        )
    return schedules
