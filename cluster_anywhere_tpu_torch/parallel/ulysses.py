"""Ulysses-style sequence parallelism: all_to_all head/sequence re-sharding.

Counterpart of cluster_anywhere_tpu/parallel/ulysses.py.  Re-shard
[B, T/sp, H, D] -> [B, T, H/sp, D] with one all_to_all, run full-sequence
attention on the local heads (the flash kernels on the card), then
all_to_all back: two collectives per attention call instead of sp
permutes; needs H divisible by the sp dim.
"""

from __future__ import annotations

import functools

import torch

from ..ops.attention import attention as _dispatch_attention
from .collectives import gather_from, split_to, tensor_plane
from .mesh import axis_size


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True, attn_fn=None):
    """q, k, v: this rank's [B, T_local, H, D] (heads complete, sequence
    sharded).  Requires H % sp == 0.  The default attention over the
    gathered sequence is the dispatcher: the flash kernels on the card."""
    n = axis_size(mesh, axis_name)
    if q.shape[2] % n != 0:
        raise ValueError(f"heads {q.shape[2]} not divisible by {axis_name}={n}")
    if attn_fn is None:
        attn_fn = functools.partial(_dispatch_attention, causal=causal)

    def scatter_heads(x):  # [B, T/sp, H, D] -> [B, T, H/sp, D]
        return tensor_plane.all_to_all(x, mesh, axis_name, split_axis=2, concat_axis=1)

    out = attn_fn(scatter_heads(q), scatter_heads(k), scatter_heads(v))
    # [B, T, H/sp, D] -> [B, T/sp, H, D]
    return tensor_plane.all_to_all(out, mesh, axis_name, split_axis=1, concat_axis=2)


def ulysses_attention_sharded(q, k, v, mesh, axis_name="sp", causal=True):
    """ulysses_attention over full tensors, the same on every rank (see
    ring_attention_sharded)."""
    shards = split_to(torch.stack([q, k, v]), mesh, axis_name, axis=2).unbind(0)
    out = ulysses_attention(*shards, mesh, axis_name=axis_name, causal=causal)
    return gather_from(out, mesh, axis_name, axis=1)
