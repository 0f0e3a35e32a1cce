"""Weights between the JAX package's param tree and the port's module.

The JAX tree (cluster_anywhere_tpu/models/transformer.py::init_params) is
{"embed", "blocks": {name: [L, ...]}, "ln_f", "lm_head"} with blocks
stacked on a leading layer axis, or [pp, L/pp, ...] when cfg.pp > 1 (a
MoE config's blocks hold router, w_in and w_out in place of w_gate, w_up
and w_down); both packages keep the [in, out] layout, so the arrays move
over unchanged.  On a mesh each rank keeps its shards, and to_jax_params
gathers them back.

train_state / load_train_state hold a model and its AdamW state as a tree
in the JAX param tree's layout, each rank's own shards only, for
train.Checkpoint.save_pytree(_sharded) with train_state_specs as specs.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import resolve_device
from ..parallel.mesh import mesh_device
from ..parallel.sharding import P, full_tensor
from .transformer import (
    _BLOCK_SPECS,
    _TOP_SPECS,
    TransformerConfig,
    TransformerLM,
    param_specs,
    shard_params,
)


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


def _local_tree(model: TransformerLM, value) -> Dict[str, Any]:
    """value(param) of every parameter, in the JAX tree's layout: blocks
    stacked [L, ...] (this rank's stage's, [1 or pp, L/pp, ...] when
    cfg.pp > 1), each rank's own shards, no gathering."""
    cfg = model.cfg

    def stacked(n):
        t = torch.stack([value(getattr(blk, n)) for blk in model.blocks])
        if cfg.pp > 1:
            t = t.reshape(-1, cfg.layers_per_stage, *t.shape[1:])
        return t

    return {
        "embed": value(model.embed),
        "blocks": {n: stacked(n) for n in model.block_keys},
        "ln_f": value(model.ln_f),
        "lm_head": value(model.lm_head),
    }


def _adam_states(model: TransformerLM, opt: torch.optim.Optimizer):
    for key in ("betas", "amsgrad"):
        if any(key not in g for g in opt.param_groups):
            raise TypeError(f"train_state holds Adam or AdamW state, not {type(opt).__name__}'s")
    if any(g["amsgrad"] for g in opt.param_groups):
        raise TypeError("train_state does not hold amsgrad's max_exp_avg_sq")
    return [opt.state.get(p, {}) for p in model.parameters()]


def train_state(model: TransformerLM, opt: torch.optim.Optimizer) -> Dict[str, Any]:
    """{"params": tree, "opt": {"count", "mu", "nu"}}: the fp32 weights and
    Adam's step count and moments (optax's ScaleByAdamState names), the
    trees in the JAX param tree's layout; each rank's own shards, detached,
    on their device.  Before the first step the moments are zeros and the
    count 0."""
    states = _adam_states(model, opt)
    first = states[0] if states else {}
    count = first.get("step", 0.0)
    moments = {id(p): st for p, st in zip(model.parameters(), states)}

    def moment(key):
        def value(p):
            st = moments[id(p)]
            return st[key].detach() if key in st else torch.zeros_like(p, memory_format=torch.contiguous_format)
        return value

    return {
        "params": _local_tree(model, lambda p: p.detach()),
        "opt": {
            "count": torch.as_tensor(count, dtype=torch.float32).detach().cpu().clone(),
            "mu": _local_tree(model, moment("exp_avg")),
            "nu": _local_tree(model, moment("exp_avg_sq")),
        },
    }


def train_state_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The PartitionSpecs of train_state's tree on a mesh (param_specs for
    the weights and both moments, the count replicated)."""
    specs = param_specs(cfg)
    return {"params": specs, "opt": {"count": P(), "mu": specs, "nu": specs}}


def load_train_state(model: TransformerLM, opt: torch.optim.Optimizer, tree: Dict[str, Any]) -> None:
    """Put a train_state tree (tensors or numpy arrays, this rank's shards)
    back into the model's weights and the optimizer's Adam state, in place."""
    _adam_states(model, opt)
    cfg = model.cfg

    def leaves(t):
        out = [(model.embed, t["embed"]), (model.ln_f, t["ln_f"]), (model.lm_head, t["lm_head"])]
        for n in model.block_keys:
            stacked = torch.as_tensor(t["blocks"][n])
            if cfg.pp > 1:
                stacked = stacked.reshape(-1, *stacked.shape[2:])
            out += [(getattr(blk, n), stacked[i]) for i, blk in enumerate(model.blocks)]
        return out

    def put(dst, src):
        src = torch.as_tensor(src)
        if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
            raise ValueError(f"checkpoint leaf {tuple(src.shape)} {src.dtype} does not fit the "
                             f"parameter {tuple(dst.shape)} {dst.dtype}")
        return src.to(dst.device).clone()

    count = float(torch.as_tensor(tree["opt"]["count"]))
    with torch.no_grad():
        for p, v in leaves(tree["params"]):
            p.copy_(put(p, v))
        mus, nus = dict(leaves(tree["opt"]["mu"])), dict(leaves(tree["opt"]["nu"]))
        for p in model.parameters():
            opt.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": put(p, mus[p]),
                "exp_avg_sq": put(p, nus[p]),
            }


def rl_from_jax_params(module, tree: Dict[str, Any]):
    """Put the JAX package's RL params (its rl/ tree of numpy arrays: a
    module's `init(key)` or a learner's `params`) into a port RL module or
    learner (anything with `param_tree()`, rl/module.py) in place, on its
    device; returns it.  Both keep the [in, out] layout."""
    from ..rl.module import load_tree

    load_tree(module.param_tree(), tree)
    return module


def rl_to_jax_params(module) -> Dict[str, Any]:
    """A port RL module's or learner's weights as the JAX package's rl/
    tree of float32 numpy arrays (what its Algorithm.save writes)."""
    from ..rl.module import to_numpy

    return to_numpy(module.param_tree())
