"""Transform specs: the serializable description of one map-like operator,
applied to blocks inside remote tasks (counterpart of
cluster_anywhere_tpu/data/transform.py).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Iterator, List

import numpy as np

from .block import Block, BlockAccessor, ITEM_COL, build_block
from .plan import MapLike


def to_spec(op: MapLike) -> Dict[str, Any]:
    return {
        "kind": op.kind,
        "fn": op.fn,
        "fn_args": op.fn_args,
        "fn_kwargs": op.fn_kwargs,
        "ctor_args": op.fn_constructor_args,
        "ctor_kwargs": op.fn_constructor_kwargs,
        "batch_size": op.batch_size,
        "batch_format": op.batch_format,
        "is_actor": op.is_actor,
    }


def instantiate_callables(chain: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Instantiate class UDFs once per worker (actor-compute path)."""
    out = []
    for spec in chain:
        spec = dict(spec)
        if isinstance(spec["fn"], type):
            spec["fn"] = spec["fn"](*spec["ctor_args"], **spec["ctor_kwargs"])
        out.append(spec)
    return out


def _iter_batches(block: Block, batch_size, batch_format) -> Iterator[Any]:
    acc = BlockAccessor.for_block(block)
    n = acc.num_rows()
    if batch_size is None or batch_size >= n:
        yield acc.to_batch(batch_format)
        return
    for start in range(0, n, batch_size):
        yield BlockAccessor.for_block(acc.slice(start, min(start + batch_size, n))).to_batch(
            batch_format
        )


def _wrap_row(row: Any) -> Any:
    return row if isinstance(row, dict) else {ITEM_COL: row}


def apply_transform(spec: Dict[str, Any], block: Block) -> Iterator[Block]:
    kind = spec["kind"]
    fn = spec["fn"]
    if isinstance(fn, type):  # task-compute class UDF: construct per block
        fn = fn(*spec["ctor_args"], **spec["ctor_kwargs"])
    args, kwargs = spec.get("fn_args", ()), spec.get("fn_kwargs", {})
    acc = BlockAccessor.for_block(block)

    if kind == "map_batches":
        for batch in _iter_batches(block, spec["batch_size"], spec["batch_format"]):
            out = fn(batch, *args, **kwargs)
            if out is None:
                continue
            # generator UDFs yield multiple batches; anything else (dict,
            # DataFrame, Table, ndarray, list of rows) is a single batch
            if inspect.isgenerator(out) or (
                hasattr(out, "__next__") and hasattr(out, "__iter__")
            ):
                for o in out:
                    yield build_block(o)
            else:
                yield build_block(out)
    elif kind == "map":
        rows = [_wrap_row(fn(r, *args, **kwargs)) for r in acc.iter_rows()]
        yield _rows_to_block(rows)
    elif kind == "flat_map":
        rows = []
        for r in acc.iter_rows():
            rows.extend(_wrap_row(o) for o in fn(r, *args, **kwargs))
        yield _rows_to_block(rows)
    elif kind == "filter":
        keep = [i for i, r in enumerate(acc.iter_rows()) if fn(r, *args, **kwargs)]
        yield acc.take_indices(np.asarray(keep, dtype=np.int64))
    elif kind == "add_column":
        name, col_fn = args
        batch = acc.to_numpy_batch()
        yield build_block({**batch, name: col_fn(batch)})
    elif kind == "drop_columns":
        yield {k: c for k, c in acc.to_numpy_batch().items() if k not in args[0]}
    elif kind == "select_columns":
        batch = acc.to_numpy_batch()
        missing = [c for c in args[0] if c not in batch]
        if missing:
            raise KeyError(f"select_columns: no column {missing} in {list(batch)}")
        yield {c: batch[c] for c in args[0]}
    elif kind == "rename_columns":
        mapping = args[0]
        yield {mapping.get(k, k): c for k, c in acc.to_numpy_batch().items()}
    else:
        raise ValueError(f"unknown transform kind {kind}")


def _rows_to_block(rows: List[dict]) -> Block:
    if not rows:
        return []
    keys = list(rows[0].keys())
    if all(isinstance(r, dict) and list(r.keys()) == keys for r in rows):
        try:
            return build_block({k: np.asarray([r[k] for r in rows]) for k in keys})
        except Exception:
            pass
    return rows
