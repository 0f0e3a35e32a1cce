"""Compiled graphs: a static DAG of actor-method calls executed as per-actor
loops with shared-memory channel I/O instead of per-call RPC (analogue of the
reference's ray.dag — dag_node.py / compiled_dag_node.py:767 CompiledDAG).

Usage:
    with InputNode() as inp:
        x = a.step.bind(inp)
        y = b.step.bind(x)
    dag = y  # or MultiOutputNode([x, y])
    out_ref = dag.execute(5)            # eager: per-call task submission
    compiled = dag.experimental_compile()
    fut = compiled.execute(5)           # channel-driven, driver out of hot loop
    fut.get()
"""

from .node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)
from ..core.errors import DagTimeoutError, DeadActorError
from .compiled import DAG_STATS, CompiledDAG, CompiledDAGRef

__all__ = [
    "DagTimeoutError",
    "DeadActorError",
    "DAGNode",
    "InputNode",
    "InputAttributeNode",
    "FunctionNode",
    "ClassMethodNode",
    "MultiOutputNode",
    "CompiledDAG",
    "CompiledDAGRef",
]
