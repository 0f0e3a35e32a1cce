"""Switch-style mixture-of-experts FFN: top-1 routing with a per-expert
capacity, the Switch Transformer load-balance loss, and expert
parallelism over the mesh's 'ep' dim.

Counterpart of cluster_anywhere_tpu/parallel/moe.py.  Dispatch and
combine keep the JAX package's static shapes: token n goes to flat slot
expert[n] * capacity + its position in that expert's queue, a token past
capacity goes to one overflow row that is sliced away, and the combine
gathers each token's slot back, scaled by its gate (zero for a dropped
token, whose residual carries it).  The expert products are batched
matmuls over the experts.

With a mesh, the experts are sharded over 'ep' and the slots travel to
their expert's rank and back by two all_to_alls in JAX's tiled=False
layout [ep_src, local_experts, rows, E]; the capacity comes from the
local token count, as in JAX.  `token_axes` names mesh dims whose ranks
each hold a part of one routing group (the model's dp and fsdp, which JAX
shards automatically inside its manual region): queue positions,
capacity and the loss's means are then taken over the whole group.  The
ranks' per-expert counts are gathered, and each expert's block carries
`rows` slots, the most that any rank fills in one expert's queue, rather
than the capacity: the tokens kept are the same, and neither the exchange
nor the expert products grow with the ranks of a routing group.  Without
a mesh (ep = 1) the function is the one-device version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .collectives import copy_to, reduce_from, tensor_plane
from .mesh import axis_index, axis_size


class MoEOutput(NamedTuple):
    out: torch.Tensor  # [N, E]
    aux_loss: torch.Tensor  # load-balance loss (Switch Transformer style), a scalar


def top1_route(logits: torch.Tensor):
    """(probs, expert index, gate) of a top-1 router over logits [..., X]:
    the softmax in the logits' dtype, the argmax over the rounded probs (the
    first index on ties, as jnp.argmax) and the winner's probability."""
    probs = torch.softmax(logits, dim=-1)
    idx = probs.argmax(dim=-1)
    return probs, idx, probs.gather(-1, idx[..., None])[..., 0]


def moe_ffn(
    x: torch.Tensor,  # [N, E]
    router_w: torch.Tensor,  # [E, X]
    w_in: torch.Tensor,  # [X_local, E, F]
    w_out: torch.Tensor,  # [X_local, F, E]
    *,
    capacity_factor: float = 1.25,
    mesh=None,
    axis_name: str = "ep",
    token_axes: Tuple[str, ...] = (),
    ffn_axis: Optional[str] = None,
) -> MoEOutput:
    """The routed FFN delta for N tokens in flat (B-major, then T) order,
    and the load-balance loss sum(fraction routed * mean prob) * X.  The
    router's softmax and the top-1 argmax run in x's dtype, as in the JAX
    package (its training forward feeds bf16 activations and weights).

    mesh: experts sharded over `axis_name` (X = ep * X_local), tokens
    exchanged by all_to_all.  token_axes: mesh dims over which this
    rank's tokens are one part of the routing group, in group order (major
    first).  ffn_axis: a mesh dim that shards the experts' hidden dim F
    (the model's tp), whose ranks hold the same tokens."""
    n, e = x.shape
    ep = axis_size(mesh, axis_name)
    local_experts = w_in.shape[0]
    n_experts = ep * local_experts

    probs, expert_idx, gate = top1_route(x @ router_w)  # [N, X], [N], [N]

    group = 1
    for name in token_axes:
        group *= axis_size(mesh, name)
    capacity = int(max(1, (n * group * capacity_factor) // n_experts + 1))
    # [N, X] bool; F.one_hot would check the indices' range, a device sync
    onehot = expert_idx[:, None] == torch.arange(n_experts, device=x.device)
    # position of each token in its expert's queue: same-expert tokens
    # before it, scanned along each expert's row of [X, N] (a scan down the
    # N rows of [N, X] runs as X serial scans on the card)
    queues = onehot.t().contiguous().long().cumsum(dim=1) - 1  # [X, N]
    pos = queues.gather(0, expert_idx[None])[0]
    rows = capacity  # the rows of each expert's block in the exchange
    if ep * group > 1:
        # every rank's per-expert counts: this rank's group (its queue
        # offsets and the loss), and the most slots any rank fills in one
        # expert, so the exchange carries the filled rows of each queue and
        # not the group-wide capacity
        every = _counts(onehot.sum(dim=0), mesh, (axis_name,) + tuple(token_axes))
        every = every.reshape(ep, group, n_experts)
        before = every.cumsum(dim=1) - every  # [ep, G, X] queue offsets
        filled = torch.minimum(every, (capacity - before).clamp_min(0))
        rows = max(1, int(filled.max().item()))
        counts = every[axis_index(mesh, axis_name)]  # [G, X]
        me = 0
        for name in token_axes:
            me = me * axis_size(mesh, name) + axis_index(mesh, name)
        keep = pos + before[axis_index(mesh, axis_name), me][expert_idx] < capacity
    else:
        keep = pos < capacity
    n_slots = n_experts * rows
    slot = torch.where(keep, expert_idx * rows + pos, torch.full_like(pos, n_slots))
    # unique slots below n_slots (a copy, not an add); every dropped token
    # lands on the overflow row n_slots, which is sliced away
    expert_in = x.new_zeros(n_slots + 1, e).index_copy(0, slot, x)[:n_slots]
    expert_in = expert_in.reshape(ep, local_experts, rows, e)
    # each rank receives, for its local experts, the token slots from every
    # source rank: [ep_src, local_experts, rows, E]
    expert_in = tensor_plane.all_to_all(expert_in, mesh, axis_name, 0, 0, tiled=False)
    expert_in = expert_in.transpose(0, 1).reshape(local_experts, ep * rows, e)
    if ffn_axis is not None:
        expert_in = copy_to(expert_in, mesh, ffn_axis)
    h = F.silu(torch.bmm(expert_in, w_in))
    expert_out = torch.bmm(h, w_out)
    if ffn_axis is not None:
        expert_out = reduce_from(expert_out, mesh, ffn_axis)
    # route back
    expert_out = expert_out.reshape(local_experts, ep, rows, e).transpose(0, 1)
    expert_out = tensor_plane.all_to_all(expert_out, mesh, axis_name, 0, 0, tiled=False)
    expert_out = expert_out.reshape(n_slots, e)

    out = expert_out.index_select(0, slot.clamp_max(n_slots - 1))
    out = out * (gate * keep.to(gate.dtype))[:, None]

    if group > 1:
        frac = (counts.sum(dim=0).float() / (n * group)).to(probs.dtype)
        prob_sum = probs.float().sum(dim=0)
        for name in token_axes:
            prob_sum = tensor_plane.allreduce(prob_sum, mesh, name)
        mean_prob = (prob_sum / (n * group)).to(probs.dtype)
    else:
        frac = onehot.to(probs.dtype).mean(dim=0)
        mean_prob = probs.mean(dim=0)
    aux = (frac * mean_prob).sum() * n_experts
    return MoEOutput(out, aux)


def _counts(local, mesh, axes):
    """[prod of axes' sizes, X]: every rank's per-expert token counts over
    the mesh dims `axes`, the first major."""
    with torch.no_grad():
        for name in reversed(axes):
            local = tensor_plane.allgather(local, mesh, name, axis=0, tiled=False)
    return local.reshape(-1, local.shape[-1])


def init_moe_params(
    generator: torch.Generator,
    e_model: int,
    f_hidden: int,
    n_experts: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[Union[str, torch.device]] = None,
):
    """{"router" [E, X], "w_in" [X, E, F], "w_out" [X, F, E]}, normal draws
    from `generator` (on `device`) with the JAX package's scales: router
    0.02, w_in sqrt(2 / E), w_out sqrt(2 / F)."""

    def normal(shape, std):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype) * std

    return {
        "router": normal((e_model, n_experts), 0.02),
        "w_in": normal((n_experts, e_model, f_hidden), (2.0 / e_model) ** 0.5),
        "w_out": normal((n_experts, f_hidden, e_model), (2.0 / f_hidden) ** 0.5),
    }
