"""DataIterator: batched iteration with prefetch and local shuffle
(counterpart of cluster_anywhere_tpu/data/iterator.py), and the device
iterator that lands batches on the card (`iter_torch_batches`, in the role
of the JAX package's `iter_jax_batches`).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..core import api as ca
from .block import Block, BlockAccessor


class DataIterator:
    def __init__(self, dataset):
        self._dataset = dataset

    def _block_iter(self, prefetch_blocks: int = 2) -> Iterator[Block]:
        """Pull blocks with a small prefetch window (refs are fetched ahead
        while the consumer processes the current block)."""
        bundles = self._dataset._execute()
        window: deque = deque()
        for bundle in bundles:
            window.append(bundle.ref)
            if len(window) > prefetch_blocks:
                yield ca.get(window.popleft())
        while window:
            yield ca.get(window.popleft())

    def iter_rows(self) -> Iterator[Any]:
        for block in self._block_iter():
            yield from BlockAccessor.for_block(block).iter_rows()

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: Optional[str] = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: int = 1,
        **_ignored,
    ) -> Iterator[Any]:
        if local_shuffle_buffer_size:
            yield from self._iter_shuffled(
                batch_size or 256,
                batch_format,
                drop_last,
                local_shuffle_buffer_size,
                local_shuffle_seed,
            )
            return
        carry: Optional[Block] = None
        for block in self._block_iter(prefetch_blocks=max(1, prefetch_batches)):
            if carry is not None:
                block = BlockAccessor.concat([carry, block])
                carry = None
            acc = BlockAccessor.for_block(block)
            n = acc.num_rows()
            if batch_size is None:
                if n:
                    yield acc.to_batch(batch_format)
                continue
            start = 0
            while n - start >= batch_size:
                yield BlockAccessor.for_block(
                    acc.slice(start, start + batch_size)
                ).to_batch(batch_format)
                start += batch_size
            if start < n:
                carry = acc.slice(start, n)
        if carry is not None:
            acc = BlockAccessor.for_block(carry)
            if acc.num_rows() and not drop_last:
                yield acc.to_batch(batch_format)

    def _iter_shuffled(self, batch_size, batch_format, drop_last, buffer_size, seed):
        rng = np.random.default_rng(seed)
        buf: Optional[Block] = None
        for block in self._block_iter():
            buf = block if buf is None else BlockAccessor.concat([buf, block])
            acc = BlockAccessor.for_block(buf)
            while acc.num_rows() >= max(buffer_size, batch_size):
                idx = rng.permutation(acc.num_rows())
                take, rest = idx[:batch_size], idx[batch_size:]
                # keep the permuted order within the batch (sorting would undo
                # the shuffle for time-ordered data); the remainder buffer can
                # stay sorted for cheaper slicing
                yield BlockAccessor.for_block(acc.take_indices(take)).to_batch(
                    batch_format
                )
                buf = acc.take_indices(np.sort(rest))
                acc = BlockAccessor.for_block(buf)
        if buf is not None:
            acc = BlockAccessor.for_block(buf)
            idx = rng.permutation(acc.num_rows())
            start = 0
            while start < len(idx):
                chunk = idx[start : start + batch_size]
                if len(chunk) < batch_size and drop_last:
                    break
                yield BlockAccessor.for_block(acc.take_indices(chunk)).to_batch(
                    batch_format
                )
                start += batch_size

    def iter_torch_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        dtypes=None,
        device=None,
        prefetch: int = 1,
        sharding=None,
        **kw,
    ) -> Iterator[Dict[str, Any]]:
        """numpy batches as torch tensors on `device` (None: the card, which
        raises without one; "cpu" stays on the host).  ``dtypes``: one torch
        dtype (or its name) for every column, or a dict by column.  Object
        columns pass through as numpy.

        On the card each batch is copied from pinned host memory on a side
        stream, ``prefetch`` batches ahead of the one being consumed, so the
        next host-to-device copy overlaps the caller's work on the current
        batch; the caller's stream waits for a batch's copy when it gets
        the batch.

        ``sharding``: a placement from models.make_batch_sharding (a
        parallel.sharding.NamedSharding) in place of ``device``: every
        rank of its mesh iterates the same rows, and each tensor column
        comes as a DTensor on the mesh's device holding this rank's block
        (its rows, and its sequence slice on dim 1 when sp shards it), as
        jax.device_put with a NamedSharding does in iter_jax_batches."""
        import torch

        from .._device import resolve_device

        if sharding is not None:
            from ..parallel.mesh import mesh_device
            from ..parallel.sharding import NamedSharding, local_shard

            if not isinstance(sharding, NamedSharding):
                raise TypeError(f"sharding must be a parallel.sharding.NamedSharding (from "
                                f"models.make_batch_sharding), not {type(sharding).__name__}")
            device = mesh_device(sharding.mesh)
        dev = resolve_device(device)
        on_card = dev.type == "cuda"
        side = torch.cuda.Stream(dev) if on_card else None

        def dtype_of(name):
            dt = dtypes.get(name) if isinstance(dtypes, dict) else dtypes
            return getattr(torch, dt) if isinstance(dt, str) else dt

        def to_device(batch):
            out = {}
            for k, v in batch.items():
                if v.dtype == object:
                    out[k] = v
                    continue
                v = np.ascontiguousarray(v)
                t = torch.from_numpy(v if v.flags.writeable else v.copy())
                dt = dtype_of(k)
                if dt is not None:
                    t = t.to(dt)
                if on_card:
                    with torch.cuda.stream(side):
                        t = t.pin_memory().to(dev, non_blocking=True)
                out[k] = t
            done = None
            if on_card:
                done = torch.cuda.Event()
                done.record(side)
            return out, done

        def handed_over(item):
            out, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                for t in out.values():
                    if isinstance(t, torch.Tensor):
                        # memory made on the side stream is used on the caller's
                        t.record_stream(consumer)
            return out if sharding is None else {k: placed(v) for k, v in out.items()}

        def placed(t):
            if not isinstance(t, torch.Tensor):
                return t
            from torch.distributed.tensor import DTensor

            if len(sharding.spec) > t.dim():
                raise ValueError(f"sharding {sharding.spec} has more dims than a column of "
                                 f"shape {tuple(t.shape)}")
            return DTensor.from_local(local_shard(t, sharding.spec, sharding.mesh).contiguous(),
                                      sharding.mesh, sharding.placements, run_check=False,
                                      shape=t.shape, stride=t.stride())

        window: deque = deque()
        for batch in self.iter_batches(batch_size=batch_size, batch_format="numpy", **kw):
            window.append(to_device(batch))
            if len(window) > max(prefetch, 0):
                yield handed_over(window.popleft())
        while window:
            yield handed_over(window.popleft())

    def materialize(self):
        return self._dataset.materialize()

    def stats(self) -> str:
        return self._dataset.stats()
