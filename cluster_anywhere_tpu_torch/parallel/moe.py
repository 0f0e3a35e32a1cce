"""Switch-style mixture-of-experts FFN: top-1 routing with a per-expert
capacity, and the Switch Transformer load-balance loss.

Counterpart of cluster_anywhere_tpu/parallel/moe.py at ep = 1 (every
expert on this device).  Dispatch and combine keep the JAX package's
static shapes: token n goes to flat slot expert[n] * capacity + its
position in that expert's queue, a token past capacity goes to one
overflow row that is sliced away, and the combine gathers each token's
slot back, scaled by its gate (zero for a dropped token, whose residual
carries it).  The expert products are batched matmuls over the experts.

Expert parallelism over several devices (ep > 1: the two all_to_all
exchanges of the JAX version, identities at ep = 1) belongs to the
parallel-stack slice of the port: TransformerConfig refuses it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F


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
    w_in: torch.Tensor,  # [X, E, F]
    w_out: torch.Tensor,  # [X, F, E]
    *,
    capacity_factor: float = 1.25,
) -> MoEOutput:
    """The routed FFN delta for N tokens in flat (B-major, then T) order,
    and the load-balance loss sum(fraction routed * mean prob) * X.  The
    router's softmax and the top-1 argmax run in x's dtype, as in the JAX
    package (its training forward feeds bf16 activations and weights)."""
    n, e = x.shape
    n_experts = w_in.shape[0]

    probs, expert_idx, gate = top1_route(x @ router_w)  # [N, X], [N], [N]

    capacity = int(max(1, (n * capacity_factor) // n_experts + 1))
    # [N, X] bool; F.one_hot would check the indices' range, a device sync
    onehot = expert_idx[:, None] == torch.arange(n_experts, device=x.device)
    # position of each token in its expert's queue: same-expert tokens
    # before it, scanned along each expert's row of [X, N] (a scan down the
    # N rows of [N, X] runs as X serial scans on the card)
    queues = onehot.t().contiguous().long().cumsum(dim=1) - 1  # [X, N]
    pos = queues.gather(0, expert_idx[None])[0]
    keep = pos < capacity
    n_slots = n_experts * capacity
    slot = torch.where(keep, expert_idx * capacity + pos, torch.full_like(pos, n_slots))
    # unique slots below n_slots (a copy, not an add); every dropped token
    # lands on the overflow row n_slots, which is sliced away
    expert_in = x.new_zeros(n_slots + 1, e).index_copy(0, slot, x)[:n_slots]
    h = F.silu(torch.bmm(expert_in.reshape(n_experts, capacity, e), w_in))
    expert_out = torch.bmm(h, w_out).reshape(n_slots, e)

    out = expert_out.index_select(0, slot.clamp_max(n_slots - 1))
    out = out * (gate * keep.to(gate.dtype))[:, None]

    frac = onehot.to(probs.dtype).mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = (frac * mean_prob).sum() * n_experts
    return MoEOutput(out, aux)


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
