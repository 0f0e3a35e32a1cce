"""Data library of the port: lazy streaming datasets over the port's object
store (counterpart of cluster_anywhere_tpu/data/).  Blocks are numpy columns
(block.py), so nothing here needs pyarrow or pandas except the functions
that name them; torch is imported only by `iter_torch_batches` and
`from_torch`.

    import cluster_anywhere_tpu_torch.data as cad
    ds = cad.range(1000).map_batches(lambda b: {"x": b["id"] * 2})
    for batch in ds.iter_batches(batch_size=128):
        ...
    for batch in cad.from_numpy(ids).iter_torch_batches(batch_size=8):
        ...  # batch["data"] is on the card
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from .aggregate import AbsMax, AggregateFn, Count, Max, Mean, Min, Quantile, Std, Sum
from .block import Block, BlockAccessor, build_block
from .dataset import Dataset, MaterializedDataset
from .datasource import (
    BinaryDatasource,
    BlocksDatasource,
    CSVDatasource,
    Datasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    ReadTask,
    TextDatasource,
)
from .iterator import DataIterator
from .plan import LogicalPlan, Read, ReadIterator


def _from_source(source: Datasource, parallelism: int = -1) -> Dataset:
    return Dataset(LogicalPlan([Read(source, parallelism)]))


def range(n: int, *, parallelism: int = -1, override_num_blocks: Optional[int] = None) -> Dataset:  # noqa: A001
    return _from_source(RangeDatasource(n), override_num_blocks or parallelism)


def range_tensor(n: int, *, shape=(1,), parallelism: int = -1, override_num_blocks=None) -> Dataset:
    return _from_source(RangeDatasource(n, tuple(shape)), override_num_blocks or parallelism)


def from_items(items: Sequence[Any], *, parallelism: int = -1, override_num_blocks=None) -> Dataset:
    return _from_source(ItemsDatasource(items), override_num_blocks or parallelism)


def from_torch(torch_dataset, *, override_num_blocks: Optional[int] = None) -> Dataset:
    """Dataset over a torch map-style dataset: the dataset's values become
    the Dataset's rows (a CPU tensor value as its numpy array; the object
    store takes no CUDA tensor)."""
    import builtins

    # builtins.range: this module's own range() is the Dataset factory.
    # Raw values, not {"item": ...} wrappers: ItemsDatasource already speaks
    # from_items row semantics
    import torch

    def host(v):
        return v.numpy() if isinstance(v, torch.Tensor) else v

    n = len(torch_dataset)
    items = [host(torch_dataset[i]) for i in builtins.range(n)]
    return _from_source(
        ItemsDatasource(items), override_num_blocks or -1
    )


def from_huggingface(hf_dataset, *, override_num_blocks: Optional[int] = None) -> Dataset:
    """Dataset over a Hugging Face datasets.Dataset (reference
    from_huggingface): column-dict rows pass through unchanged."""
    items = [dict(r) for r in hf_dataset]
    return _from_source(ItemsDatasource(items), override_num_blocks or -1)


def from_numpy(arr, column: str = "data") -> Dataset:
    import numpy as np

    arrs = arr if isinstance(arr, list) else [arr]
    blocks = [build_block({column: np.asarray(a)}) for a in arrs]
    return _from_source(BlocksDatasource(blocks))


def from_pandas(dfs) -> Dataset:
    """One block per DataFrame, its columns as numpy arrays."""
    dfs = dfs if isinstance(dfs, list) else [dfs]
    return _from_source(BlocksDatasource([build_block(df) for df in dfs]))


def from_arrow(tables) -> Dataset:
    """One block per pyarrow Table, its columns as numpy arrays."""
    tables = tables if isinstance(tables, list) else [tables]
    return _from_source(BlocksDatasource([build_block(t) for t in tables]))


def read_datasource(source: Datasource, *, parallelism: int = -1) -> Dataset:
    return _from_source(source, parallelism)


def from_generator(gen_fn, *, rows_per_block: int = 256) -> Dataset:
    """Dataset fed lazily by a python generator running as ONE streaming
    remote task (num_returns="streaming"): blocks materialize with
    producer-side backpressure as iter_batches consumes them."""
    return Dataset(LogicalPlan([ReadIterator(gen_fn, rows_per_block)]))


def read_parquet(paths, *, columns: Optional[List[str]] = None, parallelism: int = -1, **kw) -> Dataset:
    return _from_source(ParquetDatasource(paths, columns=columns, **kw), parallelism)


def read_csv(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return _from_source(CSVDatasource(paths, **kw), parallelism)


def read_json(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return _from_source(JSONDatasource(paths, **kw), parallelism)


def read_text(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return _from_source(TextDatasource(paths, **kw), parallelism)


def read_binary_files(paths, *, include_paths: bool = False, parallelism: int = -1) -> Dataset:
    return _from_source(BinaryDatasource(paths, include_paths=include_paths), parallelism)


def read_numpy(paths, *, parallelism: int = -1, **kw) -> Dataset:
    return _from_source(NumpyDatasource(paths, **kw), parallelism)


__all__ = [
    "Dataset",
    "MaterializedDataset",
    "DataIterator",
    "Datasource",
    "ReadTask",
    "BlockAccessor",
    "Block",
    "AggregateFn",
    "Count",
    "Sum",
    "Min",
    "Max",
    "Mean",
    "Std",
    "AbsMax",
    "Quantile",
    "range",
    "range_tensor",
    "from_items",
    "from_torch",
    "from_huggingface",
    "from_generator",
    "from_numpy",
    "from_pandas",
    "from_arrow",
    "read_datasource",
    "read_parquet",
    "read_csv",
    "read_json",
    "read_text",
    "read_binary_files",
    "read_numpy",
]
