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
bytes staged.  The host collective groups of the JAX module (the runtime's
host plane) are not here.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence, Tuple

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
