"""Block representation + accessor (counterpart of
cluster_anywhere_tpu/data/block.py).

A *block* is the unit of parallelism in the data library.  Two physical
layouts, the same on every machine:

- ``dict`` of equal-length numpy columns: the default for tabular and tensor
  data.  A tensor column is an ndarray with ndim > 1 (one tensor per row);
  strings and other Python values live in object columns.
- ``list`` of arbitrary Python rows: fallback for heterogeneous objects.

No block needs pyarrow or pandas: they are imported only at the edges that
name them (``to_arrow``, ``to_pandas``, the "pyarrow" and "pandas" batch
formats, and a Table or DataFrame handed to ``build_block``).  Rows come out
as the JAX package's Arrow blocks give them: Python scalars for scalar
columns, ndarrays for tensor columns.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], List[Any]]

# column name used when the user provides scalar items (mirrors the
# reference's "item" column for simple datasets)
ITEM_COL = "item"

# the metadata key prefix the JAX package's Arrow tables record a tensor
# column's per-row shape under; kept so their files read back as tensors
_TENSOR_META = "tensor:"


def _is_tensor_like(col: np.ndarray) -> bool:
    return isinstance(col, np.ndarray) and col.ndim > 1


def _loaded(module: str):
    """The module if this process has imported it, else None: a value can
    only be a pyarrow Table or a pandas DataFrame if its package is loaded."""
    return sys.modules.get(module)


def _require(module: str, what: str):
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the {module.split('.')[0]} package, which is not "
                          f"installed") from e


def _column(col: Any) -> np.ndarray:
    """A column as the block stores it: strings and bytes as object arrays,
    as Arrow's to_numpy gives them."""
    col = np.asarray(col)
    if col.ndim == 0:
        raise ValueError("a batch column must be a sequence, not a scalar")
    if col.dtype.kind in "US":
        col = col.astype(object)
    return col


def _columns_block(d: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {str(name): _column(col) for name, col in d.items()}
    lengths = {len(c) for c in out.values()}
    if len(lengths) > 1:
        raise ValueError(f"batch columns differ in length: "
                         f"{ {k: len(c) for k, c in out.items()} }")
    return out


def build_block(batch: Any) -> Block:
    """Normalize any supported batch format into a block."""
    if isinstance(batch, list):
        return batch
    if isinstance(batch, dict):
        return _columns_block(batch)
    if isinstance(batch, np.ndarray):
        return _columns_block({"data": batch})
    pa = _loaded("pyarrow")
    if pa is not None and isinstance(batch, pa.Table):
        return _from_arrow(batch)
    pd = _loaded("pandas")
    if pd is not None and isinstance(batch, pd.DataFrame):
        return _columns_block({c: batch[c].to_numpy() for c in batch.columns})
    raise TypeError(f"cannot build a block from {type(batch)}")


def _from_arrow(table) -> Dict[str, np.ndarray]:
    """A pyarrow Table as a block: fixed-size-list columns that the JAX
    package's tensor metadata names come back as tensors."""
    meta = table.schema.metadata or {}
    shapes = {}
    for k, v in meta.items():
        k = k.decode()
        if k.startswith(_TENSOR_META):
            shapes[k[len(_TENSOR_META):]] = tuple(int(s) for s in v.decode().strip("[]").split(",")
                                                  if s.strip())
    out = {}
    for name in table.column_names:
        col = table.column(name).combine_chunks()
        if name in shapes:
            values = col.values.to_numpy(zero_copy_only=False)
            out[name] = values.reshape((len(col),) + shapes[name])
        else:
            out[name] = col.to_numpy(zero_copy_only=False)
    return _columns_block(out)


def _to_arrow(batch: Dict[str, np.ndarray]):
    """A block's columns as a pyarrow Table, tensor columns as fixed-size
    lists with their per-row shape in the schema metadata (the JAX
    package's layout)."""
    pa = _require("pyarrow", "an Arrow table")
    cols, meta = {}, {}
    for name, col in batch.items():
        if _is_tensor_like(col):
            flat = np.ascontiguousarray(col).reshape(len(col), -1)
            cols[name] = pa.FixedSizeListArray.from_arrays(pa.array(flat.ravel()), flat.shape[1])
            meta[f"{_TENSOR_META}{name}".encode()] = repr(list(col.shape[1:])).encode()
        elif col.dtype == object:
            cols[name] = pa.array(col.tolist())
        else:
            cols[name] = pa.array(col)
    t = pa.table(cols)
    return t.replace_schema_metadata(meta) if meta else t


def _as_py(v: Any) -> Any:
    return v.item() if isinstance(v, np.generic) else v


class Schema:
    """Column names and types of a columnar block (what the reference's
    Arrow schema answers for)."""

    def __init__(self, names: List[str], types: List[Any]):
        self.names = names
        self.types = types

    def __repr__(self):
        return "Schema(" + ", ".join(f"{n}: {t}" for n, t in zip(self.names, self.types)) + ")"


class BlockAccessor:
    """Uniform view over a block (analogue of ray.data.block.BlockAccessor)."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def _columnar(self) -> bool:
        return isinstance(self._block, dict)

    # ------------------------------------------------------------- structure
    def num_rows(self) -> int:
        if self._columnar():
            return len(next(iter(self._block.values()))) if self._block else 0
        return len(self._block)

    def size_bytes(self) -> int:
        if self._columnar():
            return sum(c.nbytes for c in self._block.values())
        return sum(sys.getsizeof(r) for r in self._block)

    def schema(self):
        if self._columnar():
            return Schema(list(self._block),
                          [(c.dtype, c.shape[1:]) if c.ndim > 1 else c.dtype
                           for c in self._block.values()])
        if self._block:
            return type(self._block[0])
        return None

    def slice(self, start: int, end: int) -> Block:
        if self._columnar():
            return {k: c[start:end] for k, c in self._block.items()}
        return self._block[start:end]

    @staticmethod
    def concat(blocks: Sequence[Block]) -> Block:
        blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0] or list(blocks[:1])
        if not blocks:
            return []
        if not all(isinstance(b, dict) for b in blocks):
            out: List[Any] = []
            for b in blocks:
                out.extend(BlockAccessor(b).iter_rows())
            return out
        names = list(dict.fromkeys(k for b in blocks for k in b))
        cols = {}
        for name in names:
            parts = [b[name] if name in b else np.full(BlockAccessor(b).num_rows(), None, object)
                     for b in blocks]
            cols[name] = np.concatenate(parts)
        return cols

    # ----------------------------------------------------------- conversion
    def to_numpy_batch(self) -> Dict[str, np.ndarray]:
        if self._columnar():
            return dict(self._block)
        # list block: rows must be dicts for a columnar view
        if self._block and isinstance(self._block[0], dict):
            keys = self._block[0].keys()
            return {k: np.asarray([r[k] for r in self._block]) for k in keys}
        return {ITEM_COL: np.asarray(self._block, dtype=object)}

    def to_arrow(self):
        return _to_arrow(self.to_numpy_batch())

    def to_pandas(self):
        pd = _require("pandas", "a pandas DataFrame")
        batch = self.to_numpy_batch()
        return pd.DataFrame({k: list(v) if v.ndim > 1 else v for k, v in batch.items()})

    def to_batch(self, batch_format: Optional[str]) -> Any:
        if batch_format in (None, "default", "numpy"):
            return self.to_numpy_batch()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format == "pyarrow":
            return self.to_arrow()
        if batch_format == "rows":
            return list(self.iter_rows())
        raise ValueError(f"unknown batch_format {batch_format!r}")

    # ------------------------------------------------------------------ rows
    def iter_rows(self) -> Iterator[Any]:
        if not self._columnar():
            yield from self._block
            return
        cols = self._block
        simple = list(cols) == [ITEM_COL] and not _is_tensor_like(cols[ITEM_COL])
        # Python scalars for scalar columns (Arrow's as_py); a tensor
        # column's rows stay ndarrays
        values = {k: list(c) if _is_tensor_like(c) else [_as_py(v) for v in c.tolist()]
                  for k, c in cols.items()}
        for i in range(self.num_rows()):
            if simple:
                yield values[ITEM_COL][i]
            else:
                yield {k: v[i] for k, v in values.items()}

    def sample_rows(self, n: int, seed: Optional[int] = None) -> Block:
        rng = np.random.default_rng(seed)
        total = self.num_rows()
        idx = rng.choice(total, size=min(n, total), replace=False)
        return self.take_indices(np.sort(idx))

    def take_indices(self, idx) -> Block:
        if self._columnar():
            idx = np.asarray(idx, dtype=np.int64)
            return {k: c[idx] for k, c in self._block.items()}
        return [self._block[int(i)] for i in idx]
