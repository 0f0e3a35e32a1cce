"""Ring attention: exact attention over sequence shards with O(T/sp) memory
per rank.

Counterpart of cluster_anywhere_tpu/parallel/ring_attention.py.  Each rank
holds a sequence shard of Q, K and V.  The K/V blocks rotate around the
mesh's 'sp' dim (tensor_plane.permute, K and V in one message) while every
rank accumulates its Q shard's attention, so the [T, T] score matrix never
materializes.

On the card each arriving block goes through the flash kernels
(ops.attention.flash_attention with its LSE): full attention for blocks
from earlier shards, causal for the diagonal block, nothing for later
shards (a skipped block launches nothing and merges as LSE -1e30), and
the (O, LSE) partials combine with ops.attention.merge_attention; the
backward reaches both backward kernels through the LSE cotangent.  On the
CPU, or where T_local does not tile by 128, the same schedule runs as a
streaming-softmax loop in plain tensor code.  Both are differentiable.

    out = ring_attention(q, k, v, mesh, axis_name="sp", causal=True)

with q, k, v this rank's [batch, seq_shard, heads, head_dim].
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import NEG_INF, flash_attention, merge_attention
from ..ops.attention import reference_attention  # noqa: F401  (re-export; test oracle)
from .collectives import gather_from, split_to, tensor_plane, tie
from .mesh import axis_index, axis_size


def _block_attention(q, k, v, scale, mask, m_prev, l_prev, o_prev):
    """One streaming-softmax accumulation step, in fp32.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D]; mask: [Tq, Tk] bool (True=keep)
    m, l: [B, H, Tq]; o: [B, Tq, H, D]
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    # fully-masked rows: exp() stays finite, and the mask zeroes p
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask[None, None], p, torch.zeros_like(p))
    alpha = torch.exp(m_prev - m_new)
    l_new = l_prev * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    o_new = o_prev * alpha.permute(0, 2, 1)[..., None] + pv
    return m_new, l_new, o_new


def _flash_tiles(t_local: int, device: torch.device) -> bool:
    return device.type == "cuda" and t_local >= 128 and t_local % 128 == 0


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None, use_flash: Optional[bool] = None):
    """Exact attention over a ring of sequence shards.

    Shapes (per rank): q, k, v: [B, T_local, H, D] -> out [B, T_local, H, D].
    For GQA repeat K/V heads to H before calling.  use_flash=None takes
    the flash schedule on the card when T_local tiles by 128."""
    n = axis_size(mesh, axis_name)
    my_idx = axis_index(mesh, axis_name)
    b, t_local, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if use_flash is None:
        use_flash = _flash_tiles(t_local, q.device)
    if use_flash:
        return _ring_flash(q, k, v, mesh, axis_name, causal, scale, n, my_idx)

    m = torch.full((b, h, t_local), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t_local), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, t_local, h, d), dtype=torch.float32, device=q.device)
    q32 = q.float()
    perm = [(i, (i + 1) % n) for i in range(n)]
    local_pos = torch.arange(t_local, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        # the block arriving at step s originated at rank (my_idx - s) mod n
        src = (my_idx - step) % n
        mask = None
        if causal:
            q_pos = my_idx * t_local + local_pos
            k_pos = src * t_local + local_pos
            mask = q_pos[:, None] >= k_pos[None, :]
        m, l, o = _block_attention(q32, kv[0].float(), kv[1].float(), scale, mask, m, l, o)
        if step < n - 1:  # the last rotation would only bring the blocks home
            kv = tensor_plane.permute(kv, mesh, axis_name, perm)
    # final normalization; fully-masked rows (l == 0) return 0
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = o / l_safe.permute(0, 2, 1)[..., None]
    return out.to(q.dtype)


def _ring_flash(q, k, v, mesh, axis_name, causal, scale, n, my_idx):
    """Flash-kernel ring schedule: each arriving K/V block runs the flash
    kernel in the right causality mode and its (O, LSE) merges into the
    running partial.  Under causal masking a block from a later shard
    contributes nothing (JAX merges it as LSE -1e30, which leaves the
    partial unchanged), so it launches nothing."""
    b, t_local, h, d = q.shape
    perm = [(i, (i + 1) % n) for i in range(n)]
    o = torch.zeros((b, t_local, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, t_local), NEG_INF, dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        src = (my_idx - step) % n
        if not causal or src <= my_idx:
            ob, lb = flash_attention(q, kv[0], kv[1], causal=causal and src == my_idx,
                                     scale=scale, return_lse=True)
            o, lse = merge_attention(o, lse, ob.float(), lb)
        if step < n - 1:
            kv = tensor_plane.permute(kv, mesh, axis_name, perm)
    # the last block may have been skipped: keep it in the graph, so every
    # rank runs every permute's backward
    return tie(o, kv).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=True, use_flash=None):
    """ring_attention over the full [batch, seq, heads, dim] tensors, the
    same on every rank: each rank takes its sequence shard and every rank
    gets the whole output (the backward gives each rank the whole input
    gradient), as the JAX shard_map wrapper's global arrays.  Q, K and V
    split as one tensor, so their gradients gather in one collective,
    after the ring's (ranks that skip blocks would otherwise reach the
    gathers in another order than the ring's permutes)."""
    shards = split_to(torch.stack([q, k, v]), mesh, axis_name, axis=2).unbind(0)
    out = ring_attention(*shards, mesh, axis_name=axis_name, causal=causal, use_flash=use_flash)
    return gather_from(out, mesh, axis_name, axis=1)
