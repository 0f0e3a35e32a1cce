"""GroupedData (counterpart of cluster_anywhere_tpu/data/grouped_data.py)."""

from __future__ import annotations

from typing import Callable, Optional

from .aggregate import AggregateFn, Count, Max, Mean, Min, Std, Sum
from .plan import AllToAll


class GroupedData:
    def __init__(self, dataset, key: Optional[str]):
        self._dataset = dataset
        self._key = key

    def aggregate(self, *aggs: AggregateFn):
        from .dataset import Dataset

        return Dataset(
            self._dataset._plan.with_op(
                AllToAll("aggregate", {"key": self._key, "aggs": list(aggs)})
            )
        )

    def count(self):
        return self.aggregate(Count())

    def sum(self, on: str):
        return self.aggregate(Sum(on))

    def min(self, on: str):
        return self.aggregate(Min(on))

    def max(self, on: str):
        return self.aggregate(Max(on))

    def mean(self, on: str):
        return self.aggregate(Mean(on))

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(Std(on, ddof=ddof))

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy"):
        """Sort by key, then apply fn per group (runs as a map over
        key-partitioned blocks; each group lives wholly in one block)."""
        if self._key is None:
            return self._dataset.map_batches(fn, batch_format=batch_format)
        sorted_ds = self._dataset.sort(self._key)

        key = self._key

        def apply_groups(batch):
            import numpy as np

            from .block import BlockAccessor, build_block

            keys = batch[key]
            outs = []
            if len(keys) == 0:
                return None
            bounds = [0] + [
                i for i in range(1, len(keys)) if keys[i] != keys[i - 1]
            ] + [len(keys)]
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                group = {k: v[lo:hi] for k, v in batch.items()}
                out = fn(group)
                if out is not None:
                    outs.append(build_block(out))
            if not outs:
                return None
            return BlockAccessor.for_block(BlockAccessor.concat(outs)).to_numpy_batch()

        return sorted_ds.map_batches(apply_groups, batch_format="numpy")
