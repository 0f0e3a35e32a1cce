"""Pipeline parallelism: the GPipe microbatch schedule over the mesh's 'pp'
dim.

Counterpart of cluster_anywhere_tpu/parallel/pipeline.py.  Every rank
holds one stage and steps through the M + n - 1 steps of the schedule:
at step t stage 0 takes microbatch t and every other stage the activation
its predecessor made at step t - 1, which arrives by tensor_plane.permute.
The last stage's outputs are summed to every stage.  The backward is the
transposed schedule, through the permutes' autograd: no second schedule
is written for it.

Two things differ from the JAX scan in how, not in what they compute.  A
stage does no work on a bubble step (a step outside its M microbatches,
whose result JAX computes and then masks): its activation passes
through.  And every step's activation stays in the autograd graph on
every rank (selects, not branches), so each rank runs every permute's
backward and the send/receive pairs of the backward match across ranks.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .collectives import reduce_from, split_to, tensor_plane
from .mesh import axis_index, axis_size


def _select(cond: bool, a, b):
    """a if cond else b, with both in the autograd graph."""
    return torch.where(torch.tensor(cond, device=a.device), a, b)


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], Any],
    stage_params: Any,
    x: torch.Tensor,
    mesh,
    *,
    axis_name: str = "pp",
    num_microbatches: int,
    with_aux: bool = False,
):
    """Run a stage-partitioned function over microbatches.

    stage_fn(params_of_my_stage, activ) -> activ, same shape and dtype
    (uniform stages).  x: [B, ...], which stage 0 reads (the others may
    pass anything of its shape); returns [B, ...] on every stage: the last
    stage's outputs summed to every stage, each stage then consuming them
    alike (the sum's backward is the identity).

    with_aux=True: stage_fn returns (activ, aux_scalar), an auxiliary loss
    per microbatch per stage (MoE load balance).  Bubble steps add
    nothing; the result is the per-microbatch mean summed over stages,
    what the unpipelined stack computes over the full batch for
    batch-linear aux terms.  Returns (out, aux)."""
    n = axis_size(mesh, axis_name)
    idx = axis_index(mesh, axis_name)
    m = num_microbatches
    batch = x.shape[0]
    if batch % m != 0:
        raise ValueError(f"batch {batch} not divisible by num_microbatches {m}")
    micro = x.reshape(m, batch // m, *x.shape[1:])

    # stage i -> i+1; stage 0 receives zeros (no wraparound source).  The
    # first carry requires grad on every rank, so every step's permute is
    # in every rank's graph.
    prev = torch.zeros_like(micro[0]).requires_grad_(torch.is_grad_enabled())
    outs = [torch.zeros_like(micro[0]) for _ in range(m)]
    fwd_perm = [(i, i + 1) for i in range(n - 1)]
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(m + n - 1):
        incoming = tensor_plane.permute(prev, mesh, axis_name, fwd_perm)
        x_t = _select(idx == 0, micro[min(t, m - 1)], incoming)
        # stage idx holds microbatch t - idx at step t: real work only
        # for 0 <= t - idx < m, the rest is pipeline bubble
        if 0 <= t - idx < m:
            if with_aux:
                y, aux = stage_fn(stage_params, x_t)
                aux_acc = aux_acc + aux.float()
            else:
                y = stage_fn(stage_params, x_t)
        else:
            y = x_t
        j = min(max(t - (n - 1), 0), m - 1)
        outs[j] = _select(idx == n - 1 and t >= n - 1, y.to(outs[j].dtype), outs[j])
        prev = y
    # only the last stage holds real outputs; sum them to every stage
    out = torch.stack(outs)
    out = reduce_from(_select(idx == n - 1, out, torch.zeros_like(out)), mesh, axis_name)
    out = out.reshape(batch, *x.shape[1:])
    if with_aux:
        return out, reduce_from(aux_acc, mesh, axis_name) / m
    return out


def pipeline_sharded(stage_fn, mesh, *, axis_name="pp", num_microbatches):
    """pipeline_apply over parameters stacked with a leading pp dim
    (params[i] = stage i) and an input x, both the same on every rank; each
    rank takes its stage's slice, and the backward gives every rank the
    whole stacked gradient."""

    def apply(stacked_params, x):
        def mine(p):
            return split_to(p, mesh, axis_name, axis=0)[0]

        if isinstance(stacked_params, dict):
            my_params = {k: mine(v) for k, v in stacked_params.items()}
        else:
            my_params = mine(stacked_params)
        return pipeline_apply(stage_fn, my_params, x, mesh, axis_name=axis_name,
                              num_microbatches=num_microbatches)

    return apply


def num_pipeline_stages(mesh, axis_name: str = "pp") -> int:
    return axis_size(mesh, axis_name)
