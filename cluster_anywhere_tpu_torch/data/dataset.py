"""Dataset: lazy, distributed collection of blocks (counterpart of
cluster_anywhere_tpu/data/dataset.py).

All transforms are lazy — they append to the logical plan; execution happens
on consumption (iterate/take/write/materialize) through the streaming
executor with backpressure (python/ray/data/_internal/execution/streaming_executor.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

from ..core import api as ca
from .block import Block, BlockAccessor, ITEM_COL
from .executor import ExecStats, RefBundle, StreamingExecutor
from .plan import (
    AllToAll,
    InputData,
    Limit,
    LogicalPlan,
    MapLike,
    Read,
    UnionOp,
    ZipOp,
)


class Dataset:
    def __init__(self, plan: LogicalPlan):
        self._plan = plan
        self._stats = ExecStats()

    # ------------------------------------------------------------ transforms
    def _map_op(self, kind: str, fn, **kw) -> "Dataset":
        is_actor = isinstance(fn, type)
        concurrency = kw.pop("concurrency", None)
        if isinstance(concurrency, tuple):
            concurrency = concurrency[1]
        op = MapLike(
            kind=kind,
            fn=fn,
            fn_args=kw.pop("fn_args", ()),
            fn_kwargs=kw.pop("fn_kwargs", {}),
            fn_constructor_args=kw.pop("fn_constructor_args", ()),
            fn_constructor_kwargs=kw.pop("fn_constructor_kwargs", {}),
            batch_size=kw.pop("batch_size", None),
            batch_format=kw.pop("batch_format", "numpy"),
            concurrency=concurrency,
            num_cpus=kw.pop("num_cpus", None),
            num_gpus=kw.pop("num_gpus", None),
            is_actor=is_actor,
        )
        if kw:
            raise TypeError(f"unknown arguments: {sorted(kw)}")
        return Dataset(self._plan.with_op(op))

    def map_batches(
        self,
        fn: Union[Callable, type],
        *,
        batch_size: Optional[int] = None,
        batch_format: Optional[str] = "numpy",
        compute=None,
        concurrency=None,
        fn_args: Tuple = (),
        fn_kwargs: Optional[Dict] = None,
        fn_constructor_args: Tuple = (),
        fn_constructor_kwargs: Optional[Dict] = None,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        **_ignored,
    ) -> "Dataset":
        return self._map_op(
            "map_batches",
            fn,
            batch_size=batch_size,
            batch_format=batch_format,
            concurrency=concurrency,
            fn_args=fn_args,
            fn_kwargs=fn_kwargs or {},
            fn_constructor_args=fn_constructor_args,
            fn_constructor_kwargs=fn_constructor_kwargs or {},
            num_cpus=num_cpus,
            num_gpus=num_gpus,
        )

    def map(self, fn, *, concurrency=None, num_cpus=None, **_ignored) -> "Dataset":
        return self._map_op("map", fn, concurrency=concurrency, num_cpus=num_cpus)

    def flat_map(self, fn, *, concurrency=None, **_ignored) -> "Dataset":
        return self._map_op("flat_map", fn, concurrency=concurrency)

    def filter(self, fn, *, concurrency=None, **_ignored) -> "Dataset":
        return self._map_op("filter", fn, concurrency=concurrency)

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        return self._map_op("add_column", _named("add_column", fn), fn_args=(name, fn))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self._map_op("drop_columns", _named("drop_columns"), fn_args=(cols,))

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self._map_op("select_columns", _named("select_columns"), fn_args=(cols,))

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self._map_op("rename_columns", _named("rename_columns"), fn_args=(mapping,))

    def repartition(self, num_blocks: int, **_ignored) -> "Dataset":
        return Dataset(
            self._plan.with_op(AllToAll("repartition", {"num_blocks": num_blocks}))
        )

    def random_shuffle(self, *, seed: Optional[int] = None, **_ignored) -> "Dataset":
        return Dataset(self._plan.with_op(AllToAll("random_shuffle", {"seed": seed})))

    def randomize_block_order(self, *, seed: Optional[int] = None) -> "Dataset":
        return Dataset(
            self._plan.with_op(AllToAll("randomize_block_order", {"seed": seed}))
        )

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return Dataset(
            self._plan.with_op(AllToAll("sort", {"key": key, "descending": descending}))
        )

    def groupby(self, key: Optional[str]) -> "GroupedData":
        from .grouped_data import GroupedData

        return GroupedData(self, key)

    def limit(self, n: int) -> "Dataset":
        return Dataset(self._plan.with_op(Limit(n)))

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(self._plan.with_op(UnionOp([o._plan for o in others])))

    def zip(self, other: "Dataset") -> "Dataset":
        return Dataset(self._plan.with_op(ZipOp(other._plan)))

    # ----------------------------------------------------------- consumption
    def _execute(self) -> Iterator[RefBundle]:
        self._stats = ExecStats()
        return StreamingExecutor(self._plan, self._stats).execute()

    def iter_internal_ref_bundles(self) -> Iterator[RefBundle]:
        return self._execute()

    def materialize(self) -> "MaterializedDataset":
        bundles = list(self._execute())
        return MaterializedDataset(bundles, self._stats)

    def take(self, limit: int = 20) -> List[Any]:
        out: List[Any] = []
        for bundle in self.limit(limit)._execute():
            block = ca.get(bundle.ref)
            out.extend(BlockAccessor.for_block(block).iter_rows())
            if len(out) >= limit:
                break
        return out[:limit]

    def take_all(self, limit: Optional[int] = None) -> List[Any]:
        out: List[Any] = []
        for bundle in self._execute():
            block = ca.get(bundle.ref)
            out.extend(BlockAccessor.for_block(block).iter_rows())
            if limit is not None and len(out) > limit:
                raise ValueError(f"dataset has more than {limit} rows")
        return out

    def take_batch(self, batch_size: int = 20, *, batch_format: str = "numpy") -> Any:
        blocks = []
        rows = 0
        for bundle in self.limit(batch_size)._execute():
            blocks.append(ca.get(bundle.ref))
            rows += bundle.num_rows
            if rows >= batch_size:
                break
        if not blocks:
            return {}
        acc = BlockAccessor.for_block(BlockAccessor.concat(blocks))
        return BlockAccessor.for_block(acc.slice(0, min(batch_size, acc.num_rows()))).to_batch(
            batch_format
        )

    def show(self, limit: int = 20):
        for row in self.take(limit):
            print(row)

    def count(self) -> int:
        return sum(b.num_rows for b in self._execute())

    def num_blocks(self) -> int:
        return sum(1 for _ in self._execute())

    def size_bytes(self) -> int:
        return sum(b.size_bytes for b in self._execute())

    def columns(self) -> Optional[List[str]]:
        sch = self.schema()
        return list(sch.names) if sch is not None and hasattr(sch, "names") else None

    def schema(self):
        for bundle in self.limit(1)._execute():
            block = ca.get(bundle.ref)
            return BlockAccessor.for_block(block).schema()
        return None

    def stats(self) -> str:
        return self._stats.summary()

    # ----------------------------------------------------------- iteration
    def iterator(self) -> "DataIterator":
        from .iterator import DataIterator

        return DataIterator(self)

    def iter_rows(self) -> Iterator[Any]:
        return self.iterator().iter_rows()

    def iter_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_batches(**kw)

    def iter_torch_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_torch_batches(**kw)

    # ----------------------------------------------------------------- split
    def split(self, n: int, *, equal: bool = False) -> List["MaterializedDataset"]:
        mat = self.materialize()
        total = sum(b.num_rows for b in mat._bundles)
        if equal:
            per = total // n
            indices = [per * i for i in range(1, n)]
        else:
            indices = [(total * i) // n for i in range(1, n)]
        parts = self._split_at(mat._bundles, indices, truncate=total - (total // n) * n if equal else 0)
        return [MaterializedDataset(p, self._stats) for p in parts]

    def split_at_indices(self, indices: List[int]) -> List["MaterializedDataset"]:
        mat = self.materialize()
        parts = self._split_at(mat._bundles, list(indices))
        return [MaterializedDataset(p, self._stats) for p in parts]

    def split_proportionately(self, proportions: List[float]) -> List["MaterializedDataset"]:
        if not proportions or any(p <= 0 for p in proportions) or sum(proportions) >= 1:
            raise ValueError("proportions must be positive and sum to < 1")
        mat = self.materialize()
        total = mat.count()
        indices, acc = [], 0.0
        for p in proportions:
            acc += p
            indices.append(int(total * acc))
        return mat.split_at_indices(indices)

    def train_test_split(
        self, test_size: float, *, shuffle: bool = False, seed: Optional[int] = None
    ) -> Tuple["MaterializedDataset", "MaterializedDataset"]:
        ds = self.random_shuffle(seed=seed) if shuffle else self
        mat = ds.materialize()  # single execution: count + split reuse blocks
        total = mat.count()
        split = int(total * (1 - test_size))
        train, test = mat.split_at_indices([split])
        return train, test

    @staticmethod
    def _split_at(bundles: List[RefBundle], indices: List[int], truncate: int = 0):
        from .executor import _select_range, _slice_concat

        bounds = [0] + sorted(indices)
        total = sum(b.num_rows for b in bundles)
        bounds.append(total - truncate if truncate else total)
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            need = _select_range(bundles, lo, hi)
            aligned = [
                bundles[i]
                for (i, s, e) in need
                if s == 0 and e == bundles[i].num_rows
            ]
            if len(aligned) == len(need):  # no block straddles the boundary
                parts.append(aligned)
                continue
            ranges = [r[1:] for r in need]
            refs = [bundles[r[0]].ref for r in need]
            block_ref, meta_ref = _slice_concat.options(num_returns=2).remote(ranges, *refs)
            meta = ca.get(meta_ref)
            parts.append([RefBundle(block_ref, meta["num_rows"], meta["size_bytes"])])
        return parts

    def streaming_split(self, n: int, *, equal: bool = False) -> List["DataIterator"]:
        return [s.iterator() for s in self.split(n, equal=equal)]

    # ---------------------------------------------------------------- writes
    def _write(self, path: str, file_format: str, **kw) -> List[str]:
        from .datasource import write_block

        @ca.remote
        def write(block, index):
            return write_block(block, path, file_format, index, **kw)

        refs = [
            write.remote(b.ref, i) for i, b in enumerate(self._execute())
        ]
        return ca.get(refs)

    def write_parquet(self, path: str, **kw) -> List[str]:
        return self._write(path, "parquet", **kw)

    def write_csv(self, path: str, **kw) -> List[str]:
        return self._write(path, "csv", **kw)

    def write_json(self, path: str, **kw) -> List[str]:
        return self._write(path, "json", **kw)

    def write_numpy(self, path: str, *, column: Optional[str] = None) -> List[str]:
        return self._write(path, "npy", column=column)

    # ------------------------------------------------------------ converters
    def to_pandas(self, limit: Optional[int] = None):
        import pandas as pd

        frames = []
        for bundle in self._execute():
            frames.append(BlockAccessor.for_block(ca.get(bundle.ref)).to_pandas())
        if not frames:
            return pd.DataFrame()
        out = pd.concat(frames, ignore_index=True)
        if limit is not None and len(out) > limit:
            raise ValueError(f"dataset has more than {limit} rows")
        return out

    def to_arrow_refs(self) -> List[Any]:
        @ca.remote
        def conv(block):
            return BlockAccessor.for_block(block).to_arrow()

        return [conv.remote(b.ref) for b in self._execute()]

    def to_numpy_refs(self) -> List[Any]:
        @ca.remote
        def conv(block):
            return BlockAccessor.for_block(block).to_numpy_batch()

        return [conv.remote(b.ref) for b in self._execute()]

    # ------------------------------------------------------------- aggregates
    def aggregate(self, *aggs) -> Dict[str, Any]:
        return self.groupby(None).aggregate(*aggs).take(1)[0]

    def sum(self, on: str):
        from .aggregate import Sum

        return self.aggregate(Sum(on))[f"sum({on})"]

    def min(self, on: str):
        from .aggregate import Min

        return self.aggregate(Min(on))[f"min({on})"]

    def max(self, on: str):
        from .aggregate import Max

        return self.aggregate(Max(on))[f"max({on})"]

    def mean(self, on: str):
        from .aggregate import Mean

        return self.aggregate(Mean(on))[f"mean({on})"]

    def std(self, on: str, ddof: int = 1):
        from .aggregate import Std

        return self.aggregate(Std(on, ddof=ddof))[f"std({on})"]

    def random_sample(self, fraction: float, *, seed: Optional[int] = None) -> "Dataset":
        if not 0 <= fraction <= 1:
            raise ValueError("fraction must be in [0, 1]")

        def sample(batch):
            import zlib

            import numpy as np

            from .block import BlockAccessor, build_block

            acc = BlockAccessor.for_block(build_block(batch))
            n = max(0, round(acc.num_rows() * fraction))
            block_seed = seed
            if seed is not None:
                # derive a per-block seed from the data: a single seed would
                # pick identical row positions in every equal-sized block
                first = np.asarray(next(iter(batch.values()), np.array([])))
                raw = (
                    first.tobytes()[:4096]
                    if first.dtype != object
                    else str(first[:16]).encode()
                )
                token = zlib.crc32(raw)
                block_seed = np.random.SeedSequence([seed, token]).generate_state(1)[0]
            return BlockAccessor.for_block(acc.sample_rows(n, block_seed)).to_numpy_batch()

        return self.map_batches(sample, batch_format="numpy")

    def unique(self, column: str) -> List[Any]:
        rows = self.groupby(column).count().take_all()
        return [r[column] for r in rows]

    def __repr__(self):
        return f"Dataset(plan={self._plan!r})"


class MaterializedDataset(Dataset):
    """A Dataset whose blocks are computed and held by refs (analogue of
    ray.data.MaterializedDataset)."""

    def __init__(self, bundles: List[RefBundle], stats: Optional[ExecStats] = None):
        super().__init__(LogicalPlan([InputData(bundles)]))
        self._bundles = bundles
        if stats is not None:
            self._stats = stats

    def count(self) -> int:
        return sum(b.num_rows for b in self._bundles)

    def num_blocks(self) -> int:
        return len(self._bundles)

    def size_bytes(self) -> int:
        return sum(b.size_bytes for b in self._bundles)

    def materialize(self) -> "MaterializedDataset":
        return self


def _named(name: str, fn=None):
    def f():
        raise RuntimeError("placeholder; handled by transform kind")

    f.__name__ = name if fn is None else f"{name}:{getattr(fn, '__name__', 'fn')}"
    return f
