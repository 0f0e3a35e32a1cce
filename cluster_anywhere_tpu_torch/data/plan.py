"""Logical plan: a linear chain of operators over blocks (counterpart of
cluster_anywhere_tpu/data/plan.py).

Map-like operators that execute with the same compute strategy are *fused*
into a single remote task per block by the executor (the reference does this
in its OperatorFusionRule); all-to-all operators are barriers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .datasource import Datasource


class LogicalOp:
    name: str = "op"


@dataclass
class Read(LogicalOp):
    datasource: Datasource
    parallelism: int = -1

    @property
    def name(self) -> str:
        return f"Read{self.datasource.name}"


@dataclass
class MapLike(LogicalOp):
    """map_batches / map / filter / flat_map / column ops.

    fn is either a plain callable (task compute) or a class (actor compute,
    instantiated `concurrency` times).
    """

    kind: str
    fn: Any
    fn_args: Tuple = ()
    fn_kwargs: Dict[str, Any] = field(default_factory=dict)
    fn_constructor_args: Tuple = ()
    fn_constructor_kwargs: Dict[str, Any] = field(default_factory=dict)
    batch_size: Optional[int] = None
    batch_format: Optional[str] = "numpy"
    concurrency: Optional[int] = None
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None
    is_actor: bool = False

    @property
    def name(self) -> str:
        fn_name = getattr(self.fn, "__name__", type(self.fn).__name__)
        return f"{self.kind}({fn_name})"


@dataclass
class AllToAll(LogicalOp):
    kind: str  # repartition | random_shuffle | sort | aggregate
    options: Dict[str, Any] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.kind


@dataclass
class Limit(LogicalOp):
    n: int

    @property
    def name(self) -> str:
        return f"limit({self.n})"


@dataclass
class UnionOp(LogicalOp):
    others: List["LogicalPlan"]
    name = "union"


@dataclass
class ZipOp(LogicalOp):
    other: "LogicalPlan"
    name = "zip"


@dataclass
class InputData(LogicalOp):
    """Already-materialized bundles (output of a previous execution)."""

    bundles: List[Any]
    name = "input"


@dataclass
class ReadIterator(LogicalOp):
    """Blocks produced lazily by ONE remote generator task with streaming
    returns: end-to-end backpressure from iter_batches down to the producing
    python generator (num_returns='streaming')."""

    gen_fn: Any  # picklable generator function yielding rows or dict batches
    rows_per_block: int = 256
    name = "ReadIterator"


class LogicalPlan:
    def __init__(self, ops: List[LogicalOp]):
        self.ops = ops

    def with_op(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def __repr__(self):
        return " -> ".join(op.name for op in self.ops)
