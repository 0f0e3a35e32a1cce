"""Datasources: pluggable readers producing ReadTasks, and file writers
(counterpart of cluster_anywhere_tpu/data/datasource.py).  The parquet and
csv readers and writers use pyarrow, imported when they run; every other
reader and writer needs numpy alone.

A ``ReadTask`` is a zero-arg callable returning an iterator of blocks; read
tasks execute remotely inside the streaming executor like any other map task.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .block import Block, _require, build_block


class ReadTask:
    def __init__(self, fn: Callable[[], Iterator[Block]], num_rows: Optional[int] = None):
        self._fn = fn
        self.num_rows = num_rows

    def __call__(self) -> Iterator[Block]:
        return self._fn()


class Datasource:
    """Override get_read_tasks; optionally estimate size."""

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    @property
    def name(self) -> str:
        return type(self).__name__


# --------------------------------------------------------------------- range


class RangeDatasource(Datasource):
    def __init__(self, n: int, tensor_shape: Optional[tuple] = None):
        self.n = n
        self.tensor_shape = tensor_shape

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        n, shape = self.n, self.tensor_shape
        parallelism = max(1, min(parallelism, n) if n else 1)
        per = -(-n // parallelism) if n else 0
        tasks = []
        for start in range(0, n, per):
            end = min(start + per, n)

            def read(start=start, end=end) -> Iterator[Block]:
                ids = np.arange(start, end, dtype=np.int64)
                if shape is None:
                    yield build_block({"id": ids})
                else:
                    data = np.broadcast_to(
                        ids.reshape((-1,) + (1,) * len(shape)), (end - start,) + shape
                    ).copy()
                    yield build_block({"data": data})

            tasks.append(ReadTask(read, num_rows=end - start))
        return tasks or [ReadTask(lambda: iter([build_block({"id": np.array([], np.int64)})]), 0)]


class ItemsDatasource(Datasource):
    def __init__(self, items: Sequence[Any]):
        self.items = list(items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        from .block import ITEM_COL

        items = self.items
        n = len(items)
        parallelism = max(1, min(parallelism, n) if n else 1)
        per = -(-n // parallelism) if n else 0
        tasks = []
        for start in range(0, n, per):
            chunk = items[start : start + per]

            def read(chunk=chunk) -> Iterator[Block]:
                if chunk and all(isinstance(r, dict) for r in chunk):
                    keys = list(chunk[0].keys())
                    if all(list(r.keys()) == keys for r in chunk):
                        yield build_block(
                            {k: np.asarray([r[k] for r in chunk]) for k in keys}
                        )
                        return
                try:
                    yield build_block({ITEM_COL: np.asarray(chunk)})
                except Exception:
                    yield chunk  # heterogeneous rows: simple list block

            tasks.append(ReadTask(read, num_rows=len(chunk)))
        return tasks or [ReadTask(lambda: iter([[]]), 0)]


class BlocksDatasource(Datasource):
    """Pre-materialized blocks (from_numpy/from_pandas/from_arrow)."""

    def __init__(self, blocks: List[Block]):
        self.blocks = blocks

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        from .block import BlockAccessor

        return [
            ReadTask(lambda b=b: iter([b]), num_rows=BlockAccessor(b).num_rows())
            for b in self.blocks
        ]


# --------------------------------------------------------------------- files


def _expand_paths(paths, suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                sorted(
                    f
                    for f in glob.glob(os.path.join(p, "**", "*"), recursive=True)
                    if os.path.isfile(f) and (suffix is None or f.endswith(suffix))
                )
            )
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no input files for {paths}")
    return out


class FileBasedDatasource(Datasource):
    _suffix: Optional[str] = None

    def __init__(self, paths, **kw):
        self.paths = _expand_paths(paths, self._suffix)
        self.kw = kw

    def _read_file(self, path: str) -> Iterator[Block]:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        # one task per group of files, groups sized to hit `parallelism`
        n = len(self.paths)
        parallelism = max(1, min(parallelism, n))
        per = -(-n // parallelism)
        tasks = []
        for start in range(0, n, per):
            group = self.paths[start : start + per]

            def read(group=group) -> Iterator[Block]:
                for path in group:
                    yield from self._read_file(path)

            tasks.append(ReadTask(read))
        return tasks


class ParquetDatasource(FileBasedDatasource):
    _suffix = ".parquet"

    def _read_file(self, path: str) -> Iterator[Block]:
        pq = _require("pyarrow.parquet", "read_parquet")
        yield build_block(pq.read_table(path, columns=self.kw.get("columns")))


class CSVDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        pacsv = _require("pyarrow.csv", "read_csv")
        yield build_block(pacsv.read_csv(path))


class JSONDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        import json

        rows = []
        with open(path) as f:
            first = f.read(1)
            f.seek(0)
            if first == "[":
                rows = json.load(f)
            else:  # jsonl
                rows = [json.loads(line) for line in f if line.strip()]
        yield _rows_block(rows)


class TextDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        with open(path) as f:
            lines = [line.rstrip("\n") for line in f]
        if self.kw.get("drop_empty_lines", True):
            lines = [line for line in lines if line]
        yield build_block({"text": np.asarray(lines, dtype=object)})


class BinaryDatasource(FileBasedDatasource):
    def _read_file(self, path: str) -> Iterator[Block]:
        with open(path, "rb") as f:
            data = f.read()
        block = {"bytes": np.asarray([data], dtype=object)}
        if self.kw.get("include_paths"):
            block["path"] = np.asarray([path], dtype=object)
        yield block


class NumpyDatasource(FileBasedDatasource):
    _suffix = ".npy"

    def _read_file(self, path: str) -> Iterator[Block]:
        arr = np.load(path, allow_pickle=True)
        yield build_block({"data": arr})


# -------------------------------------------------------------------- writes


def write_block(block: Block, path: str, file_format: str, index: int, **kw) -> str:
    from .block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    acc = BlockAccessor.for_block(block)
    fn = os.path.join(path, f"part-{index:06d}.{file_format}")
    if file_format == "parquet":
        _require("pyarrow.parquet", "write_parquet").write_table(acc.to_arrow(), fn, **kw)
    elif file_format == "csv":
        _require("pyarrow.csv", "write_csv").write_csv(acc.to_arrow(), fn)
    elif file_format == "json":
        import json

        with open(fn, "w") as f:
            for row in acc.iter_rows():
                if not isinstance(row, dict):
                    row = {"item": row}
                f.write(json.dumps({k: _json_safe(v) for k, v in row.items()}) + "\n")
    elif file_format == "npy":
        batch = acc.to_numpy_batch()
        col = kw.get("column") or next(iter(batch))
        np.save(fn, batch[col])
    else:
        raise ValueError(f"unknown write format {file_format}")
    return fn


def _rows_block(rows: List[dict]) -> Block:
    """JSON rows as one columnar block, a key missing from a row read as
    None (Arrow's from_pylist); list and dict values stay one object a row."""
    cols = {}
    for k in dict.fromkeys(k for r in rows for k in r):
        values = [r.get(k) for r in rows]
        if any(isinstance(v, (list, dict)) for v in values):
            cols[k] = np.empty(len(values), dtype=object)
            for i, v in enumerate(values):
                cols[k][i] = v
        else:
            cols[k] = np.asarray(values)
    return build_block(cols)


def _json_safe(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return v
