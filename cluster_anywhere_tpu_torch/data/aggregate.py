"""Aggregations (counterpart of cluster_anywhere_tpu/data/aggregate.py).

All aggregations are vectorized over numpy columns within a partition; the
executor hash-partitions rows by key so each group lives wholly in one
partition.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .block import Block, BlockAccessor, build_block


class AggregateFn:
    name: str = "agg"

    def __init__(self, on: Optional[str] = None, alias_name: Optional[str] = None):
        self.on = on
        if alias_name:
            self.name = alias_name

    def compute(self, values: np.ndarray) -> Any:
        raise NotImplementedError

    def out_name(self) -> str:
        return self.name if not self.on else f"{self.name}({self.on})"


class Count(AggregateFn):
    name = "count"

    def compute(self, values):
        return len(values)

    def out_name(self) -> str:
        return "count()"


class Sum(AggregateFn):
    name = "sum"

    def compute(self, values):
        return values.sum() if len(values) else 0


class Min(AggregateFn):
    name = "min"

    def compute(self, values):
        return values.min() if len(values) else None


class Max(AggregateFn):
    name = "max"

    def compute(self, values):
        return values.max() if len(values) else None


class Mean(AggregateFn):
    name = "mean"

    def compute(self, values):
        return float(values.mean()) if len(values) else None


class Std(AggregateFn):
    name = "std"

    def __init__(self, on=None, ddof: int = 1, alias_name=None):
        super().__init__(on, alias_name)
        self.ddof = ddof

    def compute(self, values):
        if len(values) <= self.ddof:
            return None
        return float(values.std(ddof=self.ddof))


class AbsMax(AggregateFn):
    name = "abs_max"

    def compute(self, values):
        return np.abs(values).max() if len(values) else None


class Quantile(AggregateFn):
    name = "quantile"

    def __init__(self, on=None, q: float = 0.5, alias_name=None):
        super().__init__(on, alias_name)
        self.q = q

    def compute(self, values):
        return float(np.quantile(values, self.q)) if len(values) else None


def aggregate_block(block: Block, key: Optional[str], aggs: List[AggregateFn]) -> Block:
    """Group rows of `block` by `key` (or globally if None) and apply aggs."""
    acc = BlockAccessor.for_block(block)
    batch = acc.to_numpy_batch() if acc.num_rows() else {}
    if key is None:
        row: Dict[str, Any] = {}
        for agg in aggs:
            col = batch.get(agg.on, np.array([])) if agg.on else _first_col(batch)
            row[agg.out_name()] = agg.compute(np.asarray(col))
        return build_block({k: np.asarray([v]) for k, v in row.items()})
    if not batch:
        return []
    keys = batch[key]
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    uniq, starts = np.unique(sorted_keys, return_index=True)
    out: Dict[str, list] = {key: list(uniq)}
    for agg in aggs:
        col = batch[agg.on] if agg.on else keys
        col = col[order]
        vals = []
        bounds = list(starts) + [len(col)]
        for i in range(len(uniq)):
            vals.append(agg.compute(np.asarray(col[bounds[i] : bounds[i + 1]])))
        out[agg.out_name()] = vals
    return build_block({k: np.asarray(v) for k, v in out.items()})


def _first_col(batch: Dict[str, np.ndarray]) -> np.ndarray:
    for v in batch.values():
        return v
    return np.array([])
