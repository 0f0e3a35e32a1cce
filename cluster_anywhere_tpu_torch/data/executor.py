"""Streaming executor: drives the logical plan over the cluster with bounded
in-flight tasks (counterpart of cluster_anywhere_tpu/data/executor.py).

Execution model:
- the plan is compiled into *segments*: [source] -> fused map chain ->
  (barrier all-to-all) -> fused map chain -> ...
- map segments stream: one remote task per block, at most `max_in_flight`
  outstanding (backpressure), results yielded in submission order;
- all-to-all segments materialize their input bundles, then run a 2-phase
  remote shuffle (partition tasks with num_returns=N, then N merge tasks).

A bundle is (block_ref, meta) where meta = {"num_rows": int, "size_bytes": int}.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core import api as ca
from .block import Block, BlockAccessor, build_block
from .plan import AllToAll, InputData, Limit, LogicalPlan, MapLike, Read, ReadIterator, UnionOp, ZipOp


class RefBundle:
    __slots__ = ("ref", "num_rows", "size_bytes")

    def __init__(self, ref, num_rows: int, size_bytes: int):
        self.ref = ref
        self.num_rows = num_rows
        self.size_bytes = size_bytes


class ExecStats:
    def __init__(self):
        self.stages: List[Dict[str, Any]] = []

    def add(self, name: str, wall_s: float, blocks: int, rows: int):
        self.stages.append(
            {"stage": name, "wall_s": round(wall_s, 4), "blocks": blocks, "rows": rows}
        )

    def summary(self) -> str:
        lines = []
        for s in self.stages:
            lines.append(
                f"Stage {s['stage']}: {s['blocks']} blocks, {s['rows']} rows, "
                f"{s['wall_s']}s"
            )
        return "\n".join(lines) or "(not executed)"


# ----------------------------------------------------------- remote task fns


def _apply_chain(chain: List[Dict[str, Any]], block: Block) -> Block:
    """Apply a fused chain of map-like transforms to one block."""
    from .transform import apply_transform

    blocks = [block]
    for spec in chain:
        out: List[Block] = []
        for b in blocks:
            out.extend(apply_transform(spec, b))
        blocks = out
    if not blocks:
        return []
    return BlockAccessor.concat(blocks)


def _gen_blocks(gen_fn, rows_per_block: int):
    """Streaming-read driver: run the user generator on a worker, batch its
    rows into blocks, and yield (meta, block) pairs as streamed returns."""
    import numpy as np

    from .block import ITEM_COL, BlockAccessor, build_block

    def emit(rows):
        if rows and all(isinstance(r, dict) for r in rows):
            keys = list(rows[0].keys())
            if all(list(r.keys()) == keys for r in rows):
                return build_block({k: np.asarray([r[k] for r in rows]) for k in keys})
        try:
            return build_block({ITEM_COL: np.asarray(rows)})
        except Exception:
            return rows

    buf: List[Any] = []
    for row in gen_fn():
        buf.append(row)
        if len(buf) >= rows_per_block:
            block = emit(buf)
            acc = BlockAccessor.for_block(block)
            yield {"num_rows": acc.num_rows(), "size_bytes": acc.size_bytes()}
            yield block
            buf = []
    if buf:
        block = emit(buf)
        acc = BlockAccessor.for_block(block)
        yield {"num_rows": acc.num_rows(), "size_bytes": acc.size_bytes()}
        yield block


def _read_and_map(read_task, chain: List[Dict[str, Any]]):
    blocks = []
    for b in read_task():
        blocks.append(_apply_chain(chain, b) if chain else b)
    block = BlockAccessor.concat(blocks) if blocks else []
    acc = BlockAccessor.for_block(block)
    return block, {"num_rows": acc.num_rows(), "size_bytes": acc.size_bytes()}


def _map_block(chain: List[Dict[str, Any]], block: Block):
    out = _apply_chain(chain, block)
    if isinstance(out, list) and not out:
        # preserve the input schema on fully-filtered blocks
        out = BlockAccessor.for_block(block).slice(0, 0)
    acc = BlockAccessor.for_block(out)
    return out, {"num_rows": acc.num_rows(), "size_bytes": acc.size_bytes()}


class _MapWorker:
    """Actor for class-based UDFs (reference: ActorPoolMapOperator)."""

    def __init__(self, chain: List[Dict[str, Any]]):
        from .transform import instantiate_callables

        self.chain = instantiate_callables(chain)

    def ready(self):
        return "ok"

    def apply(self, block: Block):
        return _map_block(self.chain, block)


# ------------------------------------------------------------------ executor


def _cluster_cpus() -> int:
    try:
        return int(ca.cluster_resources().get("CPU", 4))
    except Exception:
        return 4


def _check_gpus(n: int, per_actor: float, name: str) -> None:
    """Refuse an actor pool the cluster's GPUs can never hold: its actors
    would wait for placement, and the pool for them, forever."""
    have = ca.cluster_resources().get("GPU", 0)
    if n * per_actor > have:
        raise ValueError(f"{name}: {n} actors of {per_actor:g} GPU each need {n * per_actor:g} "
                         f"GPUs, and the cluster has {have:g}")


class StreamingExecutor:
    def __init__(self, plan: LogicalPlan, stats: Optional[ExecStats] = None):
        self.plan = plan
        self.stats = stats or ExecStats()

    # -- public -------------------------------------------------------------
    def execute(self) -> Iterator[RefBundle]:
        segments = self._compile(self.plan)
        stream: Iterator[RefBundle] = iter(())
        for seg in segments:
            stream = seg(stream)
        return stream

    # -- compilation ---------------------------------------------------------
    def _compile(self, plan: LogicalPlan) -> List[Callable]:
        from .transform import to_spec

        segments: List[Callable] = []
        i = 0
        ops = plan.ops
        while i < len(ops):
            op = ops[i]
            if isinstance(op, (Read, InputData)):
                # fuse following resource-free task-compute maps into the read
                chain, i2 = self._collect_chain(ops, i + 1)
                if chain and not chain[0].is_actor and (
                    chain[0].num_cpus or chain[0].num_gpus
                ):
                    chain, i2 = [], i + 1
                segments.append(self._source_segment(op, chain))
                i = i2
            elif isinstance(op, MapLike):
                chain, i2 = self._collect_chain(ops, i)
                segments.append(self._map_segment(chain))
                i = i2
            elif isinstance(op, ReadIterator):
                segments.append(self._iterator_segment(op))
                i += 1
            elif isinstance(op, AllToAll):
                segments.append(self._all_to_all_segment(op))
                i += 1
            elif isinstance(op, Limit):
                segments.append(self._limit_segment(op.n))
                i += 1
            elif isinstance(op, UnionOp):
                segments.append(self._union_segment(op))
                i += 1
            elif isinstance(op, ZipOp):
                segments.append(self._zip_segment(op))
                i += 1
            else:
                raise TypeError(f"unknown op {op}")
        return segments

    def _collect_chain(self, ops, i) -> Tuple[List[MapLike], int]:
        """Collect a run of task-compute MapLike ops (fusable). Actor-compute
        ops and resource-spec changes break fusion (an op requesting GPUs must
        not be fused into a CPU-shaped task)."""
        chain: List[MapLike] = []
        while i < len(ops) and isinstance(ops[i], MapLike):
            op = ops[i]
            if op.is_actor:
                if not chain:
                    chain.append(op)
                    i += 1
                break
            if chain and (op.num_cpus, op.num_gpus) != (
                chain[0].num_cpus,
                chain[0].num_gpus,
            ):
                break
            chain.append(op)
            i += 1
        return chain, i

    # -- segments -------------------------------------------------------------
    def _source_segment(self, op, chain: List[MapLike]) -> Callable:
        from .transform import to_spec

        specs = [to_spec(m) for m in chain if not m.is_actor]
        actor_ops = [m for m in chain if m.is_actor]

        def run(_: Iterator[RefBundle]) -> Iterator[RefBundle]:
            t0 = time.monotonic()
            if isinstance(op, InputData):
                if specs:
                    yield from self._run_map_tasks(
                        iter(op.bundles), specs, None, f"{op.name}+map"
                    )
                else:
                    yield from op.bundles
                return
            parallelism = op.parallelism if op.parallelism > 0 else _cluster_cpus() * 2
            tasks = op.datasource.get_read_tasks(parallelism)
            name = op.name + ("+map" if specs else "")
            remote_read = ca.remote(_read_and_map).options(num_returns=2)
            thunks = deque(
                (lambda rt=rt: remote_read.remote(rt, specs)) for rt in tasks
            )
            yield from self._drive(thunks, name, t0)

        if actor_ops:
            inner = run
            actor_seg = self._map_segment(actor_ops)
            return lambda stream: actor_seg(inner(stream))
        return run

    def _iterator_segment(self, op) -> Callable:
        """Streaming-generator source: ONE remote task yields blocks with
        producer-side backpressure; the consumer pulls them through
        iter_batches at its own pace (ObjectRefGenerator wiring)."""

        def run(_: Iterator[RefBundle]) -> Iterator[RefBundle]:
            t0 = time.monotonic()
            gen = ca.remote(_gen_blocks).options(num_returns="streaming").remote(
                op.gen_fn, op.rows_per_block
            )
            rows = nblocks = 0
            it = iter(gen)
            for meta_ref in it:
                block_ref = next(it)
                meta = ca.get(meta_ref)
                rows += meta["num_rows"]
                nblocks += 1
                yield RefBundle(block_ref, meta["num_rows"], meta["size_bytes"])
            self.stats.add(op.name, time.monotonic() - t0, nblocks, rows)

        return run

    def _map_segment(self, chain: List[MapLike]) -> Callable:
        from .transform import to_spec

        name = "+".join(m.name for m in chain)
        if chain[0].is_actor:
            op = chain[0]
            return lambda stream: self._run_actor_map(stream, op, name)
        specs = [to_spec(m) for m in chain]
        opts = {}
        if chain[0].num_cpus:
            opts["num_cpus"] = chain[0].num_cpus
        if chain[0].num_gpus:
            opts["num_gpus"] = chain[0].num_gpus
        return lambda stream: self._run_map_tasks(stream, specs, opts or None, name)

    def _run_map_tasks(self, stream, specs, opts, name) -> Iterator[RefBundle]:
        t0 = time.monotonic()
        remote_map = ca.remote(_map_block).options(num_returns=2, **(opts or {}))

        def thunk_iter():
            for bundle in stream:
                yield lambda b=bundle: remote_map.remote(specs, b.ref)

        yield from self._drive_lazy(thunk_iter(), name, t0)

    def _run_actor_map(self, stream, op: MapLike, name) -> Iterator[RefBundle]:
        from .transform import to_spec

        t0 = time.monotonic()
        n = op.concurrency or 2
        spec = to_spec(op)
        opts: Dict[str, Any] = {}
        if op.num_cpus:
            opts["num_cpus"] = op.num_cpus
        if op.num_gpus:
            opts["num_gpus"] = op.num_gpus
            _check_gpus(n, op.num_gpus, name)
        Worker = ca.remote(_MapWorker)
        if opts:
            Worker = Worker.options(**opts)
        actors = [Worker.remote([spec]) for _ in range(n)]
        ca.get([a.ready.remote() for a in actors])
        # round-robin with at most 2 in-flight per actor
        inflight: deque = deque()
        per_actor: Dict[int, int] = {i: 0 for i in range(n)}
        rows = blocks = 0

        def pick_actor() -> Optional[int]:
            free = [i for i, c in per_actor.items() if c < 2]
            return min(free, key=lambda i: per_actor[i]) if free else None

        stream = iter(stream)
        exhausted = False
        try:
            while True:
                while not exhausted:
                    i = pick_actor()
                    if i is None:
                        break
                    bundle = next(stream, None)
                    if bundle is None:
                        exhausted = True
                        break
                    refs = actors[i].apply.options(num_returns=2).remote(bundle.ref)
                    per_actor[i] += 1
                    inflight.append((i, refs))
                if not inflight:
                    break
                i, (block_ref, meta_ref) = inflight.popleft()
                meta = ca.get(meta_ref)
                per_actor[i] -= 1
                rows += meta["num_rows"]
                blocks += 1
                yield RefBundle(block_ref, meta["num_rows"], meta["size_bytes"])
        finally:
            # also reached via GeneratorExit when the consumer stops early
            # (limit/take) — the pool must not leak worker processes
            from ..core.actor import kill

            for a in actors:
                try:
                    kill(a)
                except Exception:
                    pass
            self.stats.add(name, time.monotonic() - t0, blocks, rows)

    def _drive(self, thunks: deque, name: str, t0: float) -> Iterator[RefBundle]:
        yield from self._drive_lazy(iter(list(thunks)), name, t0)

    def _drive_lazy(self, thunk_iter, name: str, t0: float) -> Iterator[RefBundle]:
        """Submit thunks with bounded in-flight; yield in submission order."""
        max_in_flight = _cluster_cpus() * 2
        inflight: deque = deque()
        rows = blocks = 0
        exhausted = False
        while True:
            while not exhausted and len(inflight) < max_in_flight:
                thunk = next(thunk_iter, None)
                if thunk is None:
                    exhausted = True
                    break
                inflight.append(thunk())
            if not inflight:
                break
            block_ref, meta_ref = inflight.popleft()
            meta = ca.get(meta_ref)
            rows += meta["num_rows"]
            blocks += 1
            yield RefBundle(block_ref, meta["num_rows"], meta["size_bytes"])
        self.stats.add(name, time.monotonic() - t0, blocks, rows)

    def _limit_segment(self, n: int) -> Callable:
        def run(stream: Iterator[RefBundle]) -> Iterator[RefBundle]:
            remaining = n
            for bundle in stream:
                if bundle.num_rows <= remaining:
                    remaining -= bundle.num_rows
                    yield bundle
                else:
                    ref, meta_ref = _slice_task.options(num_returns=2).remote(
                        bundle.ref, remaining
                    )
                    meta = ca.get(meta_ref)
                    remaining = 0
                    yield RefBundle(ref, meta["num_rows"], meta["size_bytes"])
                if remaining <= 0:
                    break  # close upstream immediately: no further submissions

        return run

    def _union_segment(self, op: UnionOp) -> Callable:
        def run(stream: Iterator[RefBundle]) -> Iterator[RefBundle]:
            yield from stream
            for other in op.others:
                yield from StreamingExecutor(other, self.stats).execute()

        return run

    def _zip_segment(self, op: ZipOp) -> Callable:
        def run(stream: Iterator[RefBundle]) -> Iterator[RefBundle]:
            left = list(stream)
            right = list(StreamingExecutor(op.other, self.stats).execute())
            lrows = sum(b.num_rows for b in left)
            rrows = sum(b.num_rows for b in right)
            if lrows != rrows:
                raise ValueError(f"zip row-count mismatch: {lrows} vs {rrows}")
            # align right to left's block boundaries
            offsets = []
            off = 0
            for b in left:
                offsets.append((off, off + b.num_rows))
                off += b.num_rows
            for lb, (start, end) in zip(left, offsets):
                need = _select_range(right, start, end)
                ranges = [r[1:] for r in need]
                refs = [right[r[0]].ref for r in need]
                ref, meta_ref = _zip_task.options(num_returns=2).remote(
                    lb.ref, ranges, *refs
                )
                meta = ca.get(meta_ref)
                yield RefBundle(ref, meta["num_rows"], meta["size_bytes"])

        return run

    # -- all-to-all -----------------------------------------------------------
    def _all_to_all_segment(self, op: AllToAll) -> Callable:
        def run(stream: Iterator[RefBundle]) -> Iterator[RefBundle]:
            t0 = time.monotonic()
            all_bundles = list(stream)
            bundles = [b for b in all_bundles if b.num_rows > 0] or all_bundles[:1]
            if not bundles:  # upstream yielded nothing at all
                self.stats.add(op.kind, time.monotonic() - t0, 0, 0)
                return
            kind = op.kind
            if kind == "repartition":
                out = self._repartition(bundles, op.options["num_blocks"])
            elif kind == "random_shuffle":
                out = self._random_shuffle(bundles, op.options.get("seed"))
            elif kind == "sort":
                out = self._sort(bundles, op.options["key"], op.options.get("descending", False))
            elif kind == "aggregate":
                out = self._aggregate(bundles, op.options["key"], op.options["aggs"])
            elif kind == "randomize_block_order":
                rng = np.random.default_rng(op.options.get("seed"))
                out = [bundles[i] for i in rng.permutation(len(bundles))]
            else:
                raise ValueError(f"unknown all-to-all {kind}")
            rows = sum(b.num_rows for b in out)
            self.stats.add(kind, time.monotonic() - t0, len(out), rows)
            yield from out

        return run

    def _collect(self, pairs) -> List[RefBundle]:
        out = []
        for block_ref, meta_ref in pairs:
            meta = ca.get(meta_ref)
            out.append(RefBundle(block_ref, meta["num_rows"], meta["size_bytes"]))
        return out

    def _repartition(self, bundles: List[RefBundle], n: int) -> List[RefBundle]:
        total = sum(b.num_rows for b in bundles)
        splits = [(total * i) // n for i in range(n + 1)]
        pairs = []
        for j in range(n):
            start, end = splits[j], splits[j + 1]
            need = _select_range(bundles, start, end)
            ranges = [r[1:] for r in need]
            refs = [bundles[r[0]].ref for r in need]
            pairs.append(_slice_concat.options(num_returns=2).remote(ranges, *refs))
        return self._collect(pairs)

    def _random_shuffle(self, bundles, seed) -> List[RefBundle]:
        n = max(1, len(bundles))
        parts: List[List] = [[] for _ in range(n)]
        for i, b in enumerate(bundles):
            s = None if seed is None else seed + i
            refs = _shuffle_partition.options(num_returns=n).remote(b.ref, n, s)
            if n == 1:
                refs = [refs]
            for j, r in enumerate(refs):
                parts[j].append(r)
        pairs = []
        for j in range(n):
            s = None if seed is None else seed * 100003 + j
            pairs.append(_concat_shuffle.options(num_returns=2).remote(s, *parts[j]))
        return self._collect(pairs)

    def _sort(self, bundles, key, descending) -> List[RefBundle]:
        n = max(1, len(bundles))
        if n == 1:
            pairs = [_merge_sorted.options(num_returns=2).remote(key, descending, bundles[0].ref)]
            return self._collect(pairs)
        samples = ca.get([_sample_key.remote(b.ref, key, 64) for b in bundles])
        allv = np.concatenate([s for s in samples if len(s)]) if samples else np.array([])
        allv.sort()
        qs = [(len(allv) * i) // n for i in range(1, n)]
        boundaries = [allv[q] for q in qs] if len(allv) else []
        parts: List[List] = [[] for _ in range(n)]
        for b in bundles:
            refs = _range_partition.options(num_returns=n).remote(
                b.ref, key, boundaries, descending
            )
            if n == 1:
                refs = [refs]
            for j, r in enumerate(refs):
                parts[j].append(r)
        order = range(n - 1, -1, -1) if descending else range(n)
        pairs = [
            _merge_sorted.options(num_returns=2).remote(key, descending, *parts[j])
            for j in order
        ]
        return self._collect(pairs)

    def _aggregate(self, bundles, key, aggs) -> List[RefBundle]:
        n = max(1, min(len(bundles), 16))
        if key is None:
            n = 1
        parts: List[List] = [[] for _ in range(n)]
        for b in bundles:
            refs = _hash_partition.options(num_returns=n).remote(b.ref, key, n)
            if n == 1:
                refs = [refs]
            for j, r in enumerate(refs):
                parts[j].append(r)
        pairs = [
            _agg_partition.options(num_returns=2).remote(key, aggs, *parts[j])
            for j in range(n)
        ]
        out = self._collect(pairs)
        if key is not None:
            out = [b for b in out if b.num_rows > 0] or out[:1]
        return out


def _select_range(bundles: List[RefBundle], start: int, end: int):
    """Which (bundle_idx, local_start, local_end) cover global rows [start,end)."""
    out = []
    off = 0
    for i, b in enumerate(bundles):
        b_start, b_end = off, off + b.num_rows
        lo, hi = max(start, b_start), min(end, b_end)
        if lo < hi:
            out.append((i, lo - b_start, hi - b_start))
        off = b_end
    return out


# ------------------------------------------------------- remote helper tasks


def _meta(block: Block):
    acc = BlockAccessor.for_block(block)
    return block, {"num_rows": acc.num_rows(), "size_bytes": acc.size_bytes()}


@ca.remote
def _slice_task(block: Block, n: int):
    return _meta(BlockAccessor.for_block(block).slice(0, n))


@ca.remote
def _slice_concat(ranges, *blocks):
    parts = [
        BlockAccessor.for_block(b).slice(s, e) for b, (s, e) in zip(blocks, ranges)
    ]
    return _meta(BlockAccessor.concat(parts) if parts else [])


@ca.remote
def _zip_task(left: Block, ranges, *rights):
    lacc = BlockAccessor.for_block(left)
    rparts = [BlockAccessor.for_block(b).slice(s, e) for b, (s, e) in zip(rights, ranges)]
    right = BlockAccessor.concat(rparts) if rparts else []
    out = lacc.to_numpy_batch()
    for name, col in BlockAccessor.for_block(right).to_numpy_batch().items():
        out[name if name not in out else name + "_1"] = col
    return _meta(out)


@ca.remote
def _shuffle_partition(block: Block, n: int, seed):
    acc = BlockAccessor.for_block(block)
    rows = acc.num_rows()
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, n, size=rows)
    outs = []
    for j in range(n):
        idx = np.nonzero(assign == j)[0]
        outs.append(acc.take_indices(idx))
    return tuple(outs) if n > 1 else outs[0]


@ca.remote
def _concat_shuffle(seed, *parts):
    block = BlockAccessor.concat(list(parts)) if parts else []
    acc = BlockAccessor.for_block(block)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(acc.num_rows())
    return _meta(acc.take_indices(perm))


@ca.remote
def _sample_key(block: Block, key: str, n: int):
    acc = BlockAccessor.for_block(block)
    col = acc.to_numpy_batch()[key]
    if len(col) == 0:
        return col
    rng = np.random.default_rng(0)
    return col[rng.choice(len(col), size=min(n, len(col)), replace=False)]


@ca.remote
def _range_partition(block: Block, key: str, boundaries, descending: bool):
    acc = BlockAccessor.for_block(block)
    col = acc.to_numpy_batch()[key]
    n = len(boundaries) + 1
    assign = np.searchsorted(np.asarray(boundaries), col, side="right")
    outs = []
    for j in range(n):
        idx = np.nonzero(assign == j)[0]
        outs.append(acc.take_indices(idx))
    return tuple(outs) if n > 1 else outs[0]


@ca.remote
def _merge_sorted(key: str, descending: bool, *parts):
    block = BlockAccessor.concat(list(parts)) if parts else []
    acc = BlockAccessor.for_block(block)
    if acc.num_rows() == 0:
        return _meta(block)
    col = acc.to_numpy_batch()[key]
    order = np.argsort(col, kind="stable")
    if descending:
        order = order[::-1]
    return _meta(acc.take_indices(order))


def _stable_hash(x) -> int:
    """Deterministic across processes (hash() of str/bytes is per-process
    randomized, which would scatter one key over several partitions)."""
    import zlib

    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, bytes):
        return zlib.crc32(x)
    return zlib.crc32(str(x).encode())


@ca.remote
def _hash_partition(block: Block, key, n: int):
    acc = BlockAccessor.for_block(block)
    if key is None or n == 1:
        return _meta_free(acc, n)
    col = acc.to_numpy_batch()[key]
    hashes = np.asarray([_stable_hash(x) % n for x in col.tolist()], dtype=np.int64)
    outs = []
    for j in range(n):
        idx = np.nonzero(hashes == j)[0]
        outs.append(acc.take_indices(idx))
    return tuple(outs) if n > 1 else outs[0]


def _meta_free(acc, n):
    outs = [acc._block] + [acc.slice(0, 0) for _ in range(n - 1)]
    return tuple(outs) if n > 1 else outs[0]


@ca.remote
def _agg_partition(key, aggs, *parts):
    from .aggregate import aggregate_block

    block = BlockAccessor.concat(list(parts)) if parts else []
    return _meta(aggregate_block(block, key, aggs))
