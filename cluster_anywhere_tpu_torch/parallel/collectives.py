"""Device-plane collectives over a mesh's named dims, each differentiable.

Counterpart of the `xla` class of cluster_anywhere_tpu/parallel/
collectives.py (in-graph lax collectives, the TPU tensor plane) and of its
`quantized_psum`.  `tensor_plane.<op>(x, mesh, axis_name, ...)` runs the
collective among the ranks that differ from this one only along
`axis_name`, and is a torch.autograd.Function whose backward is JAX's
transpose of the op:

    allreduce      <-> allreduce
    allgather      <-> reducescatter
    permute        <-> the inverse permute
    all_to_all     <-> all_to_all with split and concat swapped
    broadcast       -> a sum to the source

The model's tensor- and pipeline-parallel regions also need the two
operators whose consumers are replicas (every tp rank, or every pp stage,
computes the same loss from the same activations): `copy_to` (identity,
backward allreduce) and `reduce_from` (allreduce, backward identity), and
the pair `gather_from` (allgather, backward this rank's slice) and
`split_to` (this rank's slice, backward allgather).

On a gloo group a collective that gloo does not run on a CUDA tensor
stages through pinned host memory.  `HOST_STAGED` (by backend and
collective) decides that, and `counts` keeps the bytes each kind of collective moved and the
bytes staged.

The second half of the module is the runtime's host plane: the JAX
module's out-of-graph collective groups (HostCollectiveGroup,
P2PCollectiveGroup, init_collective_group and the module-level allreduce
... recv) between processes of the runtime, on host arrays.
"""

from __future__ import annotations

import functools
import pickle
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import axis_index, axis_size

# Which collectives stage a CUDA tensor through host memory, by backend.
# On the card's torch (2.11) gloo takes CUDA tensors for allreduce,
# broadcast, allgather, reduce-scatter and all_to_all, but its
# point-to-point ops do not (send/recv of a CUDA tensor aborts the
# process: writev "Bad address"), so the permute stages there.
KINDS = ("allreduce", "broadcast", "allgather", "reducescatter", "all_to_all", "permute")
HOST_STAGED = {"gloo": ("permute",)}


class CollectiveCounts:
    """Bytes each kind of collective sent from this rank, and bytes copied
    to and from host memory for gloo."""

    def __init__(self):
        self.moved = Counter()
        self.staged = 0

    def reset(self):
        self.moved.clear()
        self.staged = 0


counts = CollectiveCounts()


def _group(mesh, axis_name: str):
    return mesh.get_group(axis_name)


def _staged(kind: str, group, tensors: Sequence[torch.Tensor]) -> bool:
    return tensors[0].is_cuda and kind in HOST_STAGED.get(dist.get_backend(group), ())


def _run(kind: str, group, fn, out: torch.Tensor, *ins: torch.Tensor):
    """fn(out, *ins) (an in-place op on `out` when there are no ins) on the
    group's device, or through pinned host copies where HOST_STAGED says
    so; counts the payload's bytes."""
    payload = ins or (out,)
    counts.moved[kind] += sum(x.numel() * x.element_size() for x in payload)
    if not _staged(kind, group, (out,) + ins):
        fn(out, *ins)
        return out
    host_out = _pinned(out) if not ins else torch.empty(out.shape, dtype=out.dtype,
                                                        pin_memory=True)
    host_ins = [_pinned(x) for x in ins]
    fn(host_out, *host_ins)
    out.copy_(host_out)
    counts.staged += sum(x.numel() * x.element_size() for x in payload) + _nbytes(out)
    return out


def _nbytes(x):
    return x.numel() * x.element_size()


def _pinned(x):
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


# ---------------------------------------------------------------- raw ops

def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    return _run("allreduce", group, lambda o: dist.all_reduce(o, op=op, group=group), out)


# The three below hand torch.distributed flat 1-D buffers, the layout every
# backend takes for them.  all_gather_into_tensor and reduce_scatter_tensor
# are the names both torch releases the port meets have (2.13 deprecates
# them for *_single, which 2.11 lacks).

def _all_gather(x, group, n):
    """[n, *x.shape]: every rank's x, in group order."""
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty(n * flat.numel())
    _run("allgather", group, lambda o, i: dist.all_gather_into_tensor(o, i, group=group),
         out, flat)
    return out.view(n, *x.shape)


def _reduce_scatter(x, group):
    """x [n, ...] -> the sum over ranks of x[rank]."""
    flat = x.contiguous().reshape(-1)
    out = flat.new_empty(flat.numel() // x.shape[0])
    _run("reducescatter", group, lambda o, i: dist.reduce_scatter_tensor(o, i, group=group),
         out, flat)
    return out.view(x.shape[1:])


def _all_to_all(x, group):
    """x [n, ...] -> out [n, ...] with out[j] = rank j's x[this rank]."""
    flat = x.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    _run("all_to_all", group, lambda o, i: dist.all_to_all_single(o, i, group=group), out, flat)
    return out.view(x.shape)


def _permute(x, group, pairs, me):
    """Send x to each dst of (me, dst) and receive from the src of
    (src, me); a rank that no pair sends to gets zeros."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    sends = [d for s, d in pairs if s == me]
    recvs = [s for s, d in pairs if d == me]
    if len(recvs) > 1:
        raise ValueError(f"permutation {pairs} sends two tensors to index {me}")
    ranks = dist.get_process_group_ranks(group)

    def run(o, i):
        ops = [dist.P2POp(dist.isend, i, ranks[d], group) for d in sends]
        ops += [dist.P2POp(dist.irecv, o, ranks[s], group) for s in recvs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    counts.moved["permute"] += len(sends) * _nbytes(x)
    if not _staged("permute", group, (x,)):
        run(out, x)
        return out
    h_out = torch.zeros(x.shape, dtype=x.dtype, pin_memory=True)
    run(h_out, _pinned(x))
    out.copy_(h_out)
    counts.staged += 2 * _nbytes(x)
    return out


def _broadcast(x, group, src_index):
    out = x.contiguous().clone()
    src = dist.get_process_group_ranks(group)[src_index]
    return _run("broadcast", group, lambda o: dist.broadcast(o, src, group=group), out)


# ------------------------------------------------------- layout helpers

def _gathered_to(g, axis, tiled):
    """[n, *chunk] -> stacked at `axis` (untiled) or concatenated along it."""
    g = g.movedim(0, axis)
    if not tiled:
        return g
    shape = list(g.shape)
    return g.reshape(shape[:axis] + [shape[axis] * shape[axis + 1]] + shape[axis + 2:])


def _split_from(x, axis, n, tiled):
    """x -> [n, *chunk]: its `axis` (size n untiled) or n chunks of it."""
    if tiled:
        if x.shape[axis] % n:
            raise ValueError(f"dim {axis} of size {x.shape[axis]} does not split into {n}")
        x = x.reshape(*x.shape[:axis], n, x.shape[axis] // n, *x.shape[axis + 1:])
    elif x.shape[axis] != n:
        raise ValueError(f"dim {axis} has size {x.shape[axis]}, not the axis size {n}")
    return x.movedim(axis, 0)


def _gather(x, group, n, axis, tiled):
    return _gathered_to(_all_gather(x, group, n), axis, tiled)


def _scatter_sum(x, group, n, axis, tiled):
    return _reduce_scatter(_split_from(x, axis, n, tiled), group)


def _a2a(x, group, n, split_axis, concat_axis, tiled):
    return _gathered_to(_all_to_all(_split_from(x, split_axis, n, tiled), group), concat_axis,
                        tiled)


# ------------------------------------------------------ autograd Functions

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, axis, tiled):
        ctx.args = (group, n, axis, tiled)
        return _gather(x, group, n, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, *ctx.args), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, axis, tiled):
        ctx.args = (group, n, axis, tiled)
        return _scatter_sum(x, group, n, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs, me):
        ctx.group, ctx.pairs, ctx.me = group, pairs, me
        return _permute(x, group, pairs, me)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.pairs)
        return _permute(g, ctx.group, inverse, ctx.me), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis, tiled):
        ctx.args = (group, n, split_axis, concat_axis, tiled)
        return _a2a(x, group, n, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis, tiled = ctx.args
        return _a2a(g, group, n, concat_axis, split_axis, tiled), None, None, None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src_index, me):
        ctx.group, ctx.src_index, ctx.me = group, src_index, me
        return _broadcast(x, group, src_index)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g, ctx.group)
        return (total if ctx.me == ctx.src_index else torch.zeros_like(total)), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, axis):
        ctx.n, ctx.me, ctx.axis = n, me, axis
        return _gather(x, group, n, axis, True)

    @staticmethod
    def backward(ctx, g):
        c = g.shape[ctx.axis] // ctx.n
        return g.narrow(ctx.axis, ctx.me * c, c), None, None, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, axis):
        ctx.args = (group, n, axis)
        c = x.shape[axis] // n
        return x.narrow(axis, me * c, c).clone()

    @staticmethod
    def backward(ctx, g):
        group, n, axis = ctx.args
        return _gather(g, group, n, axis, True), None, None, None, None


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.deps)


def tie(x, *deps):
    """x, with `deps` in its autograd graph at zero gradient.  A rank whose
    result does not use a tensor that came through a collective still runs
    that collective's backward, which its peers' backward waits on (a ring
    rank that skips the blocks of later shards under causal masking)."""
    if not torch.is_grad_enabled() or not any(d.requires_grad for d in deps):
        return x
    return _Tie.apply(x, *deps)


def _axis(x, axis):
    return axis % x.dim()


class tensor_plane:
    """Collectives over a mesh dim, each differentiable with JAX's
    transpose (the port's `xla` class).  A size-1 dim is the identity."""

    @staticmethod
    def allreduce(x, mesh, axis_name: str):
        if axis_size(mesh, axis_name) == 1:
            return x
        return _AllReduce.apply(x, _group(mesh, axis_name))

    @staticmethod
    def allgather(x, mesh, axis_name: str, axis: int = 0, tiled: bool = True):
        n = axis_size(mesh, axis_name)
        if n == 1:
            return x if tiled else x.unsqueeze(axis)
        axis = axis % (x.dim() + (0 if tiled else 1))
        return _AllGather.apply(x, _group(mesh, axis_name), n, axis, tiled)

    @staticmethod
    def reducescatter(x, mesh, axis_name: str, axis: int = 0, tiled: bool = True):
        n = axis_size(mesh, axis_name)
        if n == 1:
            return x if tiled else x.squeeze(axis)
        return _ReduceScatter.apply(x, _group(mesh, axis_name), n, _axis(x, axis), tiled)

    @staticmethod
    def broadcast(x, mesh, axis_name: str, src_index: int = 0):
        if axis_size(mesh, axis_name) == 1:
            return x
        return _Broadcast.apply(x, _group(mesh, axis_name), src_index,
                                axis_index(mesh, axis_name))

    @staticmethod
    def permute(x, mesh, axis_name: str, perm: Sequence[Tuple[int, int]]):
        """lax.ppermute: (src, dst) index pairs along the dim; a rank no
        pair sends to gets zeros."""
        pairs = tuple((int(s), int(d)) for s, d in perm)
        if axis_size(mesh, axis_name) == 1:
            return x if (0, 0) in pairs else torch.zeros_like(x)
        return _Permute.apply(x, _group(mesh, axis_name), pairs, axis_index(mesh, axis_name))

    @staticmethod
    def all_to_all(x, mesh, axis_name: str, split_axis: int, concat_axis: int,
                   tiled: bool = True):
        n = axis_size(mesh, axis_name)
        if n == 1:
            if tiled:
                return x
            return x.squeeze(split_axis).unsqueeze(concat_axis)
        return _AllToAll.apply(x, _group(mesh, axis_name), n, _axis(x, split_axis),
                               _axis(x, concat_axis), tiled)

    @staticmethod
    def quantized_psum(x, mesh, axis_name: str, quantize: Optional[str] = "int8",
                       block: int = 2048):
        return quantized_psum(x, mesh, axis_name, quantize, block)


def copy_to(x, mesh, axis_name: str):
    """Identity whose backward sums the cotangent over `axis_name`: where a
    replicated activation enters a computation sharded over that dim."""
    if axis_size(mesh, axis_name) == 1:
        return x
    return _CopyTo.apply(x, _group(mesh, axis_name))


def all_max(x, mesh, axis_name: str):
    """The elementwise max over `axis_name`; no autograd."""
    if axis_size(mesh, axis_name) == 1:
        return x
    return _all_reduce(x.detach(), _group(mesh, axis_name), dist.ReduceOp.MAX)


def reduce_from(x, mesh, axis_name: str):
    """Sum over `axis_name` whose backward is the identity: the partial
    results of a sharded computation, summed for replicas that each go on
    to compute the same loss."""
    if axis_size(mesh, axis_name) == 1:
        return x
    return _ReduceFrom.apply(x, _group(mesh, axis_name))


def gather_from(x, mesh, axis_name: str, axis: int = -1):
    """Concatenate the shards along `axis` for replicas that each use the
    whole; the backward keeps this rank's slice of the cotangent."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return x
    return _GatherFrom.apply(x, _group(mesh, axis_name), n, axis_index(mesh, axis_name),
                             _axis(x, axis))


def split_to(x, mesh, axis_name: str, axis: int = -1):
    """This rank's slice along `axis` of a tensor every rank holds whole;
    the backward gathers the slices' cotangents, so every rank gets the
    whole gradient (the transpose pair of gather_from)."""
    n = axis_size(mesh, axis_name)
    if n == 1:
        return x
    axis = _axis(x, axis)
    if x.shape[axis] % n:
        raise ValueError(f"dim {axis} of size {x.shape[axis]} does not split over {axis_name}={n}")
    return _SplitTo.apply(x, _group(mesh, axis_name), n, axis_index(mesh, axis_name), axis)


QUANT_MODES = ("int8", "bf16")


def _resolve_quant(quantize: Optional[str]) -> Optional[str]:
    """None/''/'f32'/'none' = exact; 'int8'/'bf16' = quantized."""
    if quantize in (None, "", "f32", "none"):
        return None
    if quantize not in QUANT_MODES:
        raise ValueError(f"quantize must be one of {QUANT_MODES} (or None for f32), "
                         f"got {quantize!r}")
    return quantize


def quantize_int8(x, block: int):
    """(q [nb, block] int8, scale [nb] fp32) of x's elements in blocks of
    `block` (the last zero-padded): scale = max|block| / 127 and
    q = round(x / scale), half to even as jnp.round."""
    flat = x.float().reshape(-1)
    n = flat.numel()
    block = max(1, min(int(block), max(n, 1)))
    nb = max(1, (n + block - 1) // block)
    pad = nb * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    b = flat.reshape(nb, block)
    scale = b.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    inv = torch.where(scale > 0, 1.0 / safe, torch.zeros_like(scale))
    return torch.round(b * inv[:, None]).to(torch.int8), scale


def quantized_psum(x, mesh, axis_name: str, quantize: Optional[str] = "int8",
                   block: int = 2048):
    """Quantized gradient sum over `axis_name` (JAX: collectives.quantized_psum).

    int8: each rank block-quantizes its contribution once (per-block fp32
    scales), the ranks allgather the int8 payloads and the scales, and
    every rank sums the dequantized blocks: sum_r Dq(Q(x_r)).  Not
    differentiable.  bf16: the allreduce of bf16-cast operands.
    quantize=None/'f32' is the exact allreduce."""
    mode = _resolve_quant(quantize)
    if mode is None:
        return tensor_plane.allreduce(x, mesh, axis_name)
    if mode == "bf16":
        return tensor_plane.allreduce(x.to(torch.bfloat16), mesh, axis_name).to(x.dtype)
    n = axis_size(mesh, axis_name)
    q, scale = quantize_int8(x, block)
    if n == 1:
        qs, ss = q[None], scale[None]
    else:
        group = _group(mesh, axis_name)
        qs, ss = _all_gather(q, group, n), _all_gather(scale, group, n)
    out = (qs.float() * ss[:, :, None]).sum(dim=0).reshape(-1)[: x.numel()]
    return out.reshape(x.shape).to(x.dtype)


_groups: Dict[str, Any] = {}


# ---------------------------------------------------------------------------
# The host collective groups: the runtime's host plane
# ---------------------------------------------------------------------------
#
# Counterpart of the out-of-graph groups of cluster_anywhere_tpu/parallel/
# collectives.py, which these copy: collectives between processes of the
# runtime (actors, tasks, the driver) on host arrays, apart from any mesh.
# "host" (default, alias "gloo"): PEER-TO-PEER, the head's KV carries ONE
# rendezvous record per rank, and every tensor byte then moves worker to
# worker (ring allreduce/allgather, direct-push broadcast and send/recv),
# so nothing per op reaches the head.  "kv": refs through the head's KV,
# payloads through the object store, for remote clients that cannot serve
# direct connections.  A numpy input returns numpy; a torch tensor is
# copied to the host explicitly and the result comes back as a tensor on
# the input's device.
#
# Block quantization (EQuARX-style wire encodings for the host ring).  The
# wire format (it rides the coll_push `meta` dict) is the JAX package's:
#   int8: payload = int8 elements, row-major in blocks of `bk` elements
#         (last block zero-padded); meta = {"qm": "int8", "n": element
#         count, "bk": block size, "sc": one f32 LE scale per block —
#         value = q * scale, scale = max|block| / 127, q rounded half to
#         even}.
#   bf16: payload = uint16 elements (f32 rounded to the upper 16 bits,
#         nearest even); meta = {"qm": "bf16", "n": count}.
# The JAX package encodes int8 with a jax.jit on the host CPU and bf16 with
# ml_dtypes; here both are numpy and torch on the host, with the same bytes.


def quantize_chunk(flat, mode: str, block: int) -> Tuple[bytes, dict]:
    """Encode a float vector for the wire.  Returns (payload, meta); the
    pair round-trips through dequantize_chunk with the documented error
    bound (int8: per element <= max|block| / 254 + float rounding)."""
    flat = np.ascontiguousarray(flat, dtype=np.float32).reshape(-1)
    n = flat.size
    if mode == "bf16":
        q = torch.from_numpy(flat).to(torch.bfloat16).view(torch.int16).numpy()
        return q.view(np.uint16).tobytes(), {"qm": "bf16", "n": n}
    if mode != "int8":
        raise ValueError(f"unsupported quantization mode {mode!r}")
    block = max(1, int(block))
    nb = (n + block - 1) // block
    padded = flat
    if nb * block != n:
        padded = np.zeros(nb * block, np.float32)
        padded[:n] = flat
    b = padded.reshape(nb, block)
    # times the fp32 reciprocal of 127, not divided by 127: what XLA makes
    # of the JAX package's `max / 127.0`, whose bytes the wire keeps (the
    # two differ in the last bit of about 5% of scales)
    scale = np.abs(b).max(axis=1) * np.float32(1.0 / 127.0)
    inv = np.where(scale > 0.0, np.float32(1.0) / np.where(
        scale > 0.0, scale, np.float32(1.0)), np.float32(0.0))
    q = np.rint(b * inv[:, None]).astype(np.int8)
    return q.tobytes(), {
        "qm": "int8", "n": n, "bk": block,
        "sc": scale.astype(np.float32).tobytes(),
    }


def dequantize_chunk(payload: bytes, meta: dict) -> np.ndarray:
    """Decode a quantize_chunk wire pair back to float32."""
    qm = meta.get("qm")
    n = int(meta.get("n", 0))
    if qm == "bf16":
        u = np.frombuffer(payload, dtype=np.uint16).astype(np.uint32)
        return (u << np.uint32(16)).view(np.float32)[:n]
    if qm == "int8":
        block = int(meta["bk"])
        scale = np.frombuffer(meta["sc"], dtype=np.float32)
        q = np.frombuffer(payload, dtype=np.int8)
        out = (
            q.astype(np.float32).reshape(scale.size, block) * scale[:, None]
        ).reshape(-1)
        return out[:n]
    raise ValueError(
        f"peer sent unknown quantized payload {qm!r} — mixed-version group? "
        f"(this build decodes {QUANT_MODES})"
    )


def _host_io(method):
    """A group method on host arrays that also takes a torch tensor: the
    tensor is copied to the host explicitly and the result (each of a
    list's) comes back as a tensor on the input's device."""

    @functools.wraps(method)
    def wrapper(self, tensor, *args, **kwargs):
        if not isinstance(tensor, torch.Tensor):
            return method(self, tensor, *args, **kwargs)
        dev = tensor.device
        out = method(self, tensor.detach().cpu().numpy(), *args, **kwargs)

        def back(a):
            return torch.from_numpy(np.array(a, copy=True)).to(dev)

        if out is None:
            return None
        return [back(a) for a in out] if isinstance(out, list) else back(out)

    return wrapper


# ---------------------------------------------------------------------------
# host backend (Gloo-equivalent): KV-rendezvous reductions between processes
# ---------------------------------------------------------------------------


class HostCollectiveGroup:
    """Gloo-role host collectives (util/collective GLOOGroup analogue).

    The KV store carries only rendezvous metadata — pickled ObjectRefs, a
    few hundred bytes — while tensor payloads ride the object store's data
    plane: zero-copy shm between same-host ranks, chunked TCP pulls across
    nodes.  Reductions are rooted: every rank publishes one chunk, the root
    reduces and publishes one result, every other rank polls exactly one
    key — O(world) tensor movements per op, not the O(world^2) of all-ranks
    -fetch-all-chunks.
    """

    # refs published for recent ops are retained so a lagging consumer's
    # borrow registration always lands while the producer still holds the
    # object (SPMD lockstep bounds consumer lag to ~2 ops; 4 is margin)
    _RETAIN_OPS = 4

    def __init__(self, world_size: int, rank: int, group_name: str = "default"):
        from collections import deque

        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for world_size {world_size}")
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self._seq = 0
        self.sent_bytes = 0  # payload bytes this rank published
        self._live = deque(maxlen=self._RETAIN_OPS * max(world_size, 2))
        # (seq, ns, key) for every rooted-collective KV entry this rank
        # published; entries older than _RETAIN_OPS ops are kv_del'd so a
        # long run's rendezvous keys don't accumulate in the head's KV (and
        # its debounced snapshots).  p2p send keys are tracked separately:
        # they are consumed (and deleted) by recv, which is NOT lockstep-
        # bounded, so they must never be horizon-GC'd.
        self._published: deque = deque()
        # bounded: recv deletes consumed keys itself, so old entries here
        # are almost certainly already gone — the cap keeps a long-running
        # sender's bookkeeping (and close()'s kv_del sweep) O(1), at the
        # cost of not sweeping ancient unconsumed sends on close
        self._p2p_published: deque = deque(maxlen=512)
        # p2p sequence numbers are per-destination and independent of the
        # collective op counter: bumping the shared _seq on send() would
        # desynchronize the per-op rendezvous namespaces between ranks
        # that send and ranks that only recv
        self._p2p_seq: Dict[int, int] = {}

    def _ns(self, op: str) -> str:
        return f"__collective__/{self.group_name}/{self._seq}/{op}"

    def _kv(self):
        from ..core.worker import global_worker

        return global_worker()

    def _publish(self, ns: str, key: str, value: np.ndarray, p2p: bool = False):
        """ca.put the tensor; only the ref crosses the head's KV.  Small
        tensors put inline must be promoted to cluster-visible shm first —
        a ref smuggled through KV bypasses the task-arg promotion path."""
        from ..core import api as ca_api

        value = np.ascontiguousarray(value)
        self.sent_bytes += value.nbytes
        ref = ca_api.put(value)
        self._kv()._promote_nested([ref.id.binary()])
        self._live.append(ref)
        self._kv().head_call("kv_put", ns=ns, key=key, value=pickle.dumps(ref))
        # rooted ops bump _seq before publishing, so the op being published
        # is _seq - 1; recording _seq itself would widen retention by one op
        (self._p2p_published if p2p else self._published).append(
            (self._seq if p2p else self._seq - 1, ns, key)
        )
        self._gc_published()

    def _gc_published(self):
        """Delete this rank's rooted rendezvous keys older than _RETAIN_OPS
        ops.  By then every peer has fetched (SPMD lockstep bounds lag), so
        the keys are dead weight in the head KV and every snapshot write."""
        w = self._kv()
        horizon = self._seq - self._RETAIN_OPS
        while self._published and self._published[0][0] < horizon:
            _, ns, key = self._published.popleft()
            try:
                w.head_call("kv_del", ns=ns, key=key)
            except Exception:
                pass  # head restart mid-run: stale keys die with the old KV

    def close(self):
        """Drop this rank's expired rendezvous keys and unconsumed p2p sends.
        Keys from the most recent _RETAIN_OPS rooted ops are deliberately
        left alive — a lagging peer may still be fetching them (barrier()
        before destroy for a fully clean teardown); at most _RETAIN_OPS
        keys per rank remain, bounded, not a leak-over-time.  A no-op after
        ca.shutdown (cleanup must stay safe in any teardown order)."""
        from ..core.worker import try_global_worker

        w = try_global_worker()
        if w is None:
            self._published.clear()
            self._p2p_published.clear()
            return
        for q in (self._published, self._p2p_published):
            while q:
                seq, ns, key = q.popleft()
                if q is self._published and seq >= self._seq - self._RETAIN_OPS:
                    continue
                try:
                    w.head_call("kv_del", ns=ns, key=key)
                except Exception:
                    return

    def _fetch(self, ns: str, key: str, timeout: float = 60.0) -> np.ndarray:
        """Poll one KV key for a ref, then read the payload from the store."""
        from ..core import api as ca_api

        w = self._kv()
        deadline = time.monotonic() + timeout
        while True:
            v = w.head_call("kv_get", ns=ns, key=key)["value"]
            if v is not None:
                return np.asarray(ca_api.get(pickle.loads(v)))
            if time.monotonic() > deadline:
                raise TimeoutError(f"collective {ns}/{key} timed out")
            time.sleep(0.002)

    @staticmethod
    def _reduce(stack: np.ndarray, op: str) -> np.ndarray:
        if op == "sum":
            return stack.sum(axis=0)
        if op == "max":
            return stack.max(axis=0)
        if op == "min":
            return stack.min(axis=0)
        if op == "mean":
            return stack.mean(axis=0)
        raise ValueError(f"unsupported op {op}")

    @_host_io
    def allreduce(
        self, tensor: np.ndarray, op: str = "sum",
        quantize: Optional[str] = None,
    ) -> np.ndarray:
        if _resolve_quant(quantize) is not None:
            raise ValueError(
                "quantized allreduce needs the p2p 'host' transport; this "
                "group uses the 'kv' rendezvous backend (remote clients)"
            )
        ns = self._ns("allreduce")
        self._seq += 1
        if self.rank == 0:
            parts = [np.asarray(tensor)]
            for r in range(1, self.world_size):
                parts.append(self._fetch(ns, str(r)))
            result = self._reduce(np.stack(parts), op)
            if self.world_size > 1:
                self._publish(ns, "result", result)
            return result
        self._publish(ns, str(self.rank), np.asarray(tensor))
        return self._fetch(ns, "result")

    @_host_io
    def allgather(self, tensor: np.ndarray) -> List[np.ndarray]:
        ns = self._ns("allgather")
        self._seq += 1
        self._publish(ns, str(self.rank), np.asarray(tensor))
        # every rank reads every chunk, but through the data plane (shm
        # locally), so the head only serves world_size tiny ref lookups
        return [self._fetch(ns, str(r)) for r in range(self.world_size)]

    @_host_io
    def reducescatter(self, tensor: np.ndarray, op: str = "sum") -> np.ndarray:
        full = self.allreduce(tensor, op)
        return np.array_split(full, self.world_size)[self.rank]

    @_host_io
    def broadcast(self, tensor: Optional[np.ndarray], src_rank: int = 0) -> np.ndarray:
        ns = self._ns("broadcast")
        self._seq += 1
        if self.rank == src_rank:
            arr = np.asarray(tensor)
            if self.world_size > 1:
                self._publish(ns, "0", arr)
            return arr
        return self._fetch(ns, "0")

    def barrier(self):
        self.allreduce(np.zeros(1))

    @_host_io
    def send(self, tensor: np.ndarray, dst_rank: int):
        ns = f"__collective__/{self.group_name}/p2p/{self.rank}->{dst_rank}"
        k = self._p2p_seq.get(dst_rank, 0)
        self._p2p_seq[dst_rank] = k + 1
        self._publish(ns, str(k), np.asarray(tensor), p2p=True)

    def recv(self, src_rank: int, timeout: float = 60.0) -> np.ndarray:
        from ..core import api as ca_api

        ns = f"__collective__/{self.group_name}/p2p/{src_rank}->{self.rank}"
        w = self._kv()
        deadline = time.monotonic() + timeout
        while True:
            keys = sorted(w.head_call("kv_keys", ns=ns)["keys"], key=int)
            if keys:
                key = keys[0]
                v = w.head_call("kv_get", ns=ns, key=key)["value"]
                w.head_call("kv_del", ns=ns, key=key)
                return np.asarray(ca_api.get(pickle.loads(v)))
            if time.monotonic() > deadline:
                raise TimeoutError("recv timed out")
            time.sleep(0.002)


# ---------------------------------------------------------------------------
# p2p backend (Gloo role): direct worker-to-worker tensor movement
# ---------------------------------------------------------------------------


class P2PCollectiveGroup:
    """Host collectives whose tensor bytes move directly between the member
    processes (ring allreduce/allgather; direct-push broadcast/send/recv).

    The head KV holds exactly one record per rank — the rank's serving
    address, written once at init and deleted at close.  Every subsequent
    op is rank-to-rank RPC into a peer's collective mailbox
    (Worker.coll_deliver / coll_wait): zero per-op head traffic, unlike the
    KV transport this replaces (r4 weak #2).  Reference role:
    gloo_collective_group.py:184 (direct transport), redesigned over this
    runtime's existing worker duals instead of a separate Gloo context."""

    _TIMEOUT = 60.0

    def __init__(
        self, world_size: int, rank: int, group_name: str = "default",
        quantize: Optional[str] = None,
    ):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for world_size {world_size}")
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        # group-default wire encoding for allreduce: explicit arg wins, else
        # config.collective_quantize; per-CALL quantize= overrides both.
        # Must agree across ranks — it is part of the group contract, like
        # the backend (a mixed group would decode garbage; unknown modes
        # raise at the receiver).
        if quantize is None:
            from ..core.config import get_config

            quantize = getattr(get_config(), "collective_quantize", "") or None
        self._quantize = _resolve_quant(quantize)
        self._seq = 0
        self.sent_bytes = 0  # payload bytes this rank pushed to its peers
        self._p2p_send_seq: Dict[int, int] = {}
        self._p2p_recv_seq: Dict[int, int] = {}
        self._peer_addrs: Dict[int, str] = {}
        w = self._worker()
        if not (w.serve_addr or w.serve_addr_tcp or w._p2p_addr()):
            raise RuntimeError(
                "p2p collectives need a serving process (worker/actor/driver); "
                "remote clients should use backend='kv'"
            )
        # rendezvous record = this rank's CLIENT ID only; peers resolve it to
        # a dialable address through the head's p2p directory (client_addr),
        # which rewrites loopback/wildcard hosts per node — publishing raw
        # bound addresses here would hand cross-host peers 127.0.0.1
        self._members_ns = f"__collective__/{group_name}/members"
        w.head_call(
            "kv_put",
            ns=self._members_ns,
            key=str(rank),
            value=pickle.dumps({"client": w.client_id}),
        )

    def _worker(self):
        from ..core.worker import global_worker

        return global_worker()

    def _peer(self, rank: int) -> str:
        """Resolve (once) where a peer rank serves: poll the rendezvous KV
        for its client id, then the head's p2p directory for a dialable
        address (unix same-node, rewritten TCP cross-node)."""
        addr = self._peer_addrs.get(rank)
        if addr is not None:
            return addr
        w = self._worker()
        deadline = time.monotonic() + self._TIMEOUT
        while True:
            v = w.head_call("kv_get", ns=self._members_ns, key=str(rank))["value"]
            if v is not None:
                client = pickle.loads(v)["client"]
                addr = w._owner_addr(client)
                if addr is None:
                    raise RuntimeError(
                        f"rank {rank} (client {client}) of group "
                        f"{self.group_name!r} has no dialable p2p address — "
                        "every member of a 'host' group must be a serving "
                        "process; use backend='kv' for remote-client members"
                    )
                self._peer_addrs[rank] = addr
                return addr
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rank {rank} never joined group {self.group_name!r}"
                )
            time.sleep(0.005)

    # ------------------------------------------------------------- transport
    def _push(self, dst: int, key: str, arr: np.ndarray):
        self.sent_bytes += arr.nbytes
        self._worker().coll_push_to(
            self._peer(dst), self.group_name, key, self.rank, arr, self._TIMEOUT
        )

    def _push_start(self, dst: int, key: str, arr: np.ndarray):
        """Non-blocking send for the pipelined ring: serialize now, ship in
        the background, join via .result() after the overlapped receive."""
        self.sent_bytes += arr.nbytes
        return self._worker().coll_push_start(
            self._peer(dst), self.group_name, key, self.rank, arr, self._TIMEOUT
        )

    def _push_raw_start(self, dst: int, key: str, payload: bytes, meta: dict):
        self.sent_bytes += len(payload) + len(meta.get("sc", b""))
        return self._worker().coll_push_raw_start(
            self._peer(dst), self.group_name, key, self.rank, payload, meta,
            self._TIMEOUT,
        )

    def _wait(self, key: str, src: int) -> np.ndarray:
        return self._worker().coll_wait(
            self.group_name, key, src, self._TIMEOUT
        )

    def _wait_raw(self, key: str, src: int):
        return self._worker().coll_wait_raw(
            self.group_name, key, src, self._TIMEOUT
        )

    # ------------------------------------------------------------ collectives
    @staticmethod
    def _acc_dtype(dtype: np.dtype, op: str):
        # mirror the kv backend's np.stack(...).<op>(axis=0) result dtypes so
        # the two interchangeable backends agree bit-for-bit in type
        if op == "mean":
            return np.result_type(dtype, np.float64)
        if op == "sum":
            if np.issubdtype(dtype, np.unsignedinteger):
                return np.uint64  # np.sum keeps unsigned unsigned
            if dtype == np.bool_ or np.issubdtype(dtype, np.integer):
                return np.int64  # bools count (not saturate), ints widen like np.sum
        return dtype  # max/min (and float sum) preserve the input dtype

    @staticmethod
    def _combine(acc: np.ndarray, incoming: np.ndarray, op: str):
        if op in ("sum", "mean"):
            np.add(acc, incoming, out=acc)
        elif op == "max":
            np.maximum(acc, incoming, out=acc)
        elif op == "min":
            np.minimum(acc, incoming, out=acc)
        else:
            raise ValueError(f"unsupported op {op}")

    @_host_io
    def allreduce(
        self, tensor: np.ndarray, op: str = "sum",
        quantize: Optional[str] = None,
    ) -> np.ndarray:
        """Ring allreduce, double-buffered: each step STARTS its send (bytes
        serialized before the call returns) and then blocks on the incoming
        chunk, so rank r's send of chunk i overlaps its receive of chunk i —
        instead of the strict send-ack-then-wait alternation.  quantize=
        "int8"/"bf16" selects the EQuARX-style block-quantized wire payload
        (per-call; the group/config default applies when omitted); the f32
        path below is bit-for-bit the untouched default."""
        arr = np.asarray(tensor)
        mode = self._quantize if quantize is None else _resolve_quant(quantize)
        if mode is not None:
            return self._allreduce_quantized(arr, op, mode)
        n = self.world_size
        self._seq += 1
        acc_dt = self._acc_dtype(arr.dtype, op)
        if n == 1:
            out = arr.astype(acc_dt, copy=True)  # mean of one = itself
            return self._mean_result_dtype(out, arr.dtype, op)
        seq = self._seq
        left, right = (self.rank - 1) % n, (self.rank + 1) % n
        flat = arr.astype(acc_dt).reshape(-1)
        chunks = [c.copy() for c in np.array_split(flat, n)]
        # ring reduce-scatter: after n-1 steps this rank holds the fully
        # reduced chunk (rank+1) % n
        for s in range(n - 1):
            send_idx = (self.rank - s) % n
            recv_idx = (self.rank - s - 1) % n
            pend = self._push_start(right, f"{seq}/rs{s}", chunks[send_idx])
            incoming = self._wait(f"{seq}/rs{s}", src=left)
            self._combine(chunks[recv_idx], incoming.reshape(chunks[recv_idx].shape), op)
            pend.result(self._TIMEOUT)
        # ring allgather of the reduced chunks
        for s in range(n - 1):
            send_idx = (self.rank + 1 - s) % n
            recv_idx = (self.rank - s) % n
            pend = self._push_start(right, f"{seq}/ag{s}", chunks[send_idx])
            chunks[recv_idx] = self._wait(f"{seq}/ag{s}", src=left).reshape(
                chunks[recv_idx].shape
            ).copy()
            pend.result(self._TIMEOUT)
        out = np.concatenate([c.reshape(-1) for c in chunks]).reshape(arr.shape)
        if op == "mean":
            out = out / n
        return self._mean_result_dtype(out, arr.dtype, op)

    def _allreduce_quantized(
        self, arr: np.ndarray, op: str, mode: str
    ) -> np.ndarray:
        """Block-quantized ring (EQuARX, arxiv 2506.17615): reduce-scatter
        quantizes each outgoing chunk (quantize-on-send), dequantizes the
        incoming one, reduces in f32, and requantizes at the next hop; the
        allgather phase quantizes each fully-reduced chunk ONCE at its
        owner and forwards the wire bytes verbatim, so every rank decodes
        identical values.  Wire bytes per hop: n/4 + 4/block scales (int8)
        or n/2 (bf16) versus the f32 ring's n bytes."""
        if not np.issubdtype(arr.dtype, np.floating):
            raise ValueError(
                f"quantized allreduce needs a floating tensor, got {arr.dtype}"
            )
        from ..core.config import get_config
        from ..core.worker import TRANSFER_STATS

        block = int(getattr(get_config(), "collective_quant_block", 4096))
        n = self.world_size
        self._seq += 1
        saved = 0
        if n == 1:
            payload, meta = quantize_chunk(arr.reshape(-1), mode, block)
            out = dequantize_chunk(payload, meta)  # same error model as n>1
            TRANSFER_STATS["quant_ops"] += 1
            return out.reshape(arr.shape).astype(arr.dtype, copy=False)
        seq = self._seq
        left, right = (self.rank - 1) % n, (self.rank + 1) % n
        flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
        chunks = [c.copy() for c in np.array_split(flat, n)]
        for s in range(n - 1):
            send_idx = (self.rank - s) % n
            recv_idx = (self.rank - s - 1) % n
            payload, meta = quantize_chunk(chunks[send_idx], mode, block)
            saved += chunks[send_idx].nbytes - len(payload) - len(meta.get("sc", b""))
            pend = self._push_raw_start(right, f"{seq}/qrs{s}", payload, meta)
            pdata, pmeta = self._wait_raw(f"{seq}/qrs{s}", src=left)
            self._combine(chunks[recv_idx], dequantize_chunk(pdata, pmeta), op)
            pend.result(self._TIMEOUT)
        own = (self.rank + 1) % n
        payload, meta = quantize_chunk(chunks[own], mode, block)
        # adopt the decoded form locally so this rank's result matches what
        # every peer reconstructs from the forwarded bytes
        chunks[own] = dequantize_chunk(payload, meta)
        for s in range(n - 1):
            recv_idx = (self.rank - s) % n
            saved += 4 * int(meta.get("n", 0)) - len(payload) - len(meta.get("sc", b""))
            pend = self._push_raw_start(right, f"{seq}/qag{s}", payload, meta)
            payload, meta = self._wait_raw(f"{seq}/qag{s}", src=left)
            chunks[recv_idx] = dequantize_chunk(payload, meta)
            pend.result(self._TIMEOUT)
        out = np.concatenate(chunks)
        if op == "mean":
            out = out / n
        TRANSFER_STATS["quant_ops"] += 1
        TRANSFER_STATS["quant_bytes_saved"] += max(0, saved)
        return out.reshape(arr.shape).astype(arr.dtype, copy=False)

    @staticmethod
    def _mean_result_dtype(out: np.ndarray, in_dtype: np.dtype, op: str):
        # match the kv backend (np.stack(...).mean(axis=0)): mean preserves
        # an inexact input dtype and yields float64 for integers — the f64
        # ring accumulator must not leak into the result
        if op == "mean" and np.issubdtype(in_dtype, np.inexact):
            return out.astype(in_dtype)
        return out

    @_host_io
    def allgather(self, tensor: np.ndarray) -> List[np.ndarray]:
        arr = np.ascontiguousarray(tensor)
        n = self.world_size
        self._seq += 1
        if n == 1:
            return [arr.copy()]
        seq = self._seq
        left, right = (self.rank - 1) % n, (self.rank + 1) % n
        got: Dict[int, np.ndarray] = {self.rank: arr}
        carry = arr
        for s in range(n - 1):  # ring pass-along (shapes may differ per rank)
            self._push(right, f"{seq}/ag{s}", carry)
            carry = self._wait(f"{seq}/ag{s}", src=left).copy()
            got[(self.rank - 1 - s) % n] = carry
        return [got[r] for r in range(n)]

    @_host_io
    def reducescatter(self, tensor: np.ndarray, op: str = "sum") -> np.ndarray:
        full = self.allreduce(tensor, op)
        return np.array_split(full, self.world_size)[self.rank]

    @_host_io
    def broadcast(self, tensor: Optional[np.ndarray], src_rank: int = 0) -> np.ndarray:
        self._seq += 1
        seq = self._seq
        if self.rank == src_rank:
            arr = np.ascontiguousarray(tensor)
            for r in range(self.world_size):
                if r != self.rank:
                    self._push(r, f"{seq}/bc", arr)
            return np.asarray(tensor)
        return self._wait(f"{seq}/bc", src=src_rank).copy()

    def barrier(self):
        self.allreduce(np.zeros(1))

    @_host_io
    def send(self, tensor: np.ndarray, dst_rank: int):
        k = self._p2p_send_seq.get(dst_rank, 0)
        self._p2p_send_seq[dst_rank] = k + 1
        self._push(dst_rank, f"p2p/{k}", np.asarray(tensor))

    def recv(self, src_rank: int, timeout: float = 60.0) -> np.ndarray:
        k = self._p2p_recv_seq.get(src_rank, 0)
        self._p2p_recv_seq[src_rank] = k + 1
        return self._worker().coll_wait(
            self.group_name, f"p2p/{k}", src_rank, timeout
        ).copy()

    def close(self):
        """Drop this rank's rendezvous record and any unconsumed mailbox
        entries.  Safe after ca.shutdown (any teardown order)."""
        from ..core.worker import try_global_worker

        w = try_global_worker()
        if w is None:
            return
        w.coll_clear(self.group_name)
        try:
            w.head_call("kv_del", ns=self._members_ns, key=str(self.rank))
        except Exception:
            pass


# ---------------------------------------------------------------------------
# public API (reference-parity surface)
# ---------------------------------------------------------------------------


def init_collective_group(
    world_size: int, rank: int, backend: str = "host",
    group_name: str = "default", quantize: Optional[str] = None,
):
    """backend='host'/'gloo': p2p transport (direct worker-to-worker bytes).
    backend='kv': the KV-rendezvous transport (required when ANY member is a
    remote client, which cannot serve direct connections).  The backend is
    per-GROUP, never per-rank: a silent per-rank fallback would build a
    mixed-transport group whose halves share no rendezvous and deadlock.
    `quantize` sets the group's default allreduce wire encoding (see
    allreduce; must agree across ranks, like the backend)."""
    if backend not in ("host", "gloo", "kv"):
        raise ValueError(
            "out-of-graph groups support the 'host' (p2p) and 'kv' backends; "
            "tensors on a mesh use the device plane "
            "(cluster_anywhere_tpu_torch.parallel.collectives.tensor_plane)"
        )
    if backend == "kv":
        if _resolve_quant(quantize) is not None:
            raise ValueError(
                "quantized collectives need the p2p 'host' backend"
            )
        g: Any = HostCollectiveGroup(world_size, rank, group_name)
    else:
        from ..core.worker import global_worker

        w = global_worker()
        if w.client_mode or not (
            w.serve_addr or w.serve_addr_tcp or w._p2p_addr()
        ):
            raise RuntimeError(
                "this rank cannot serve the p2p 'host' transport (remote "
                "client / no listener); create the WHOLE group with "
                "backend='kv' instead — transports cannot be mixed within "
                "a group"
            )
        g = P2PCollectiveGroup(world_size, rank, group_name, quantize=quantize)
    _groups[group_name] = g
    return g


def create_collective_group(
    actors,
    world_size: int,
    ranks: List[int],
    backend: str = "host",
    group_name: str = "default",
):
    """Declarative setup (reference: util/collective/collective.py:151
    create_collective_group): tells each actor to init_collective_group with
    its rank.  Actors must define
    `collective_init(self, world_size, rank, backend, group_name)` that calls
    `init_collective_group` (mixin: CollectiveActorMixin)."""
    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must have equal length")
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world_size for r in ranks):
        raise ValueError(
            f"ranks must be unique and in [0, {world_size}); got {ranks}"
        )
    from ..core import api as ca

    refs = [
        a.collective_init.remote(world_size, r, backend, group_name)
        for a, r in zip(actors, ranks)
    ]
    ca.get(refs)


class CollectiveActorMixin:
    """Inherit in an actor class to make it usable with create_collective_group."""

    def collective_init(self, world_size, rank, backend="host", group_name="default"):
        init_collective_group(world_size, rank, backend=backend, group_name=group_name)
        return rank

    def collective_close(self, group_name="default"):
        """Teardown hook: kv_del this rank's rendezvous record + drop its
        mailbox entries.  Call it before killing the actor — ca.kill alone
        leaks the member record into the head KV (and its snapshots), and a
        later group reusing the name could resolve a dead rank's address."""
        destroy_collective_group(group_name)
        return True


def destroy_group_on(actors, group_name: str = "default"):
    """Close `group_name` on every member actor (the teardown twin of
    create_collective_group)."""
    from ..core import api as ca

    ca.get(
        [a.collective_close.remote(group_name) for a in actors], timeout=30
    )


def get_group(group_name: str = "default"):
    if group_name not in _groups:
        raise ValueError(f"collective group {group_name!r} not initialized")
    return _groups[group_name]


def destroy_collective_group(group_name: str = "default"):
    g = _groups.pop(group_name, None)
    if g is not None:
        g.close()


def allreduce(
    tensor, op: str = "sum", group_name: str = "default",
    quantize: Optional[str] = None,
):
    """quantize="int8"/"bf16" selects the block-quantized ring payload for
    this call (p2p 'host' groups only); None defers to the group's default
    (init arg / config.collective_quantize), which itself defaults to the
    exact f32 wire path."""
    return get_group(group_name).allreduce(tensor, op, quantize=quantize)


def allgather(tensor, group_name: str = "default"):
    return get_group(group_name).allgather(tensor)


def reducescatter(tensor, op: str = "sum", group_name: str = "default"):
    return get_group(group_name).reducescatter(tensor, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(tensor, src_rank)


def barrier(group_name: str = "default"):
    return get_group(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default"):
    return get_group(group_name).send(tensor, dst_rank)


def recv(src_rank: int, group_name: str = "default"):
    return get_group(group_name).recv(src_rank)
