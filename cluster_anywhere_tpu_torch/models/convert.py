"""Weights between the JAX package's param tree and the port's module.

The JAX tree (cluster_anywhere_tpu/models/transformer.py::init_params) is
{"embed", "blocks": {name: [L, ...]}, "ln_f", "lm_head"} with blocks
stacked on a leading layer axis, or [pp, L/pp, ...] when cfg.pp > 1 (a
MoE config's blocks hold router, w_in and w_out in place of w_gate, w_up
and w_down); both packages keep the [in, out] layout, so the arrays move
over unchanged.  On a mesh each rank keeps its shards, and to_jax_params
gathers them back.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import resolve_device
from ..parallel.mesh import mesh_device
from ..parallel.sharding import P, full_tensor
from .transformer import _BLOCK_SPECS, _TOP_SPECS, TransformerConfig, TransformerLM, shard_params


def from_jax_params(tree: Dict[str, Any], cfg: TransformerConfig, device=None,
                    mesh=None) -> TransformerLM:
    """A TransformerLM holding the JAX package's params, given as numpy
    arrays (or anything np.asarray takes) with blocks stacked [L, ...] or
    [pp, L/pp, ...].  With a mesh every rank passes the whole tree and
    keeps its shards (on the mesh's device)."""
    dev = mesh_device(mesh) if mesh is not None else resolve_device(device)
    model = TransformerLM(cfg, dev)
    if set(tree["blocks"]) != set(model.block_keys):
        raise ValueError(f"block params {sorted(tree['blocks'])} do not fit the config, which "
                         f"holds {sorted(model.block_keys)}")

    def put(param, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"param shape {arr.shape} != expected {tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))

    with torch.no_grad():
        put(model.embed, tree["embed"])
        put(model.ln_f, tree["ln_f"])
        put(model.lm_head, tree["lm_head"])
        for name in model.block_keys:
            stacked = np.asarray(tree["blocks"][name])
            if stacked.ndim == model.blocks[0].get_parameter(name).dim() + 2:  # [pp, L/pp, ...]
                stacked = stacked.reshape(-1, *stacked.shape[2:])
            for i, blk in enumerate(model.blocks):
                put(getattr(blk, name), stacked[i])
    return shard_params(model, mesh)


def to_jax_params(model: TransformerLM, grads: bool = False) -> Dict[str, Any]:
    """The module's fp32 weights (or, with grads=True, their gradients) as
    the JAX package's numpy param tree, blocks [pp, L/pp, ...] when
    cfg.pp > 1.  A sharded model gathers its shards: every rank calls it
    and gets the whole tree."""
    mesh = model.mesh

    def value(p):
        t = p.grad if grads else p
        return torch.zeros_like(p) if t is None else t.detach()

    def host(t, spec):
        if mesh is not None:
            t = full_tensor(t, spec, mesh)
        return t.to("cpu", torch.float32).numpy()

    blocks = {}
    for n in model.block_keys:
        t = torch.stack([value(getattr(blk, n)) for blk in model.blocks])
        if mesh is not None:
            t = full_tensor(t, P("pp", *_BLOCK_SPECS[n]), mesh)
        arr = t.to("cpu", torch.float32).numpy()
        if model.cfg.pp > 1:
            arr = arr.reshape(model.cfg.pp, -1, *arr.shape[1:])
        blocks[n] = arr
    return {
        "embed": host(value(model.embed), _TOP_SPECS["embed"]),
        "blocks": blocks,
        "ln_f": host(value(model.ln_f), _TOP_SPECS["ln_f"]),
        "lm_head": host(value(model.lm_head), _TOP_SPECS["lm_head"]),
    }
