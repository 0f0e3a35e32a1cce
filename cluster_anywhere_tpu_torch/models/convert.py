"""Weights between the JAX package's param tree and the port's module.

The JAX tree (cluster_anywhere_tpu/models/transformer.py::init_params) is
{"embed", "blocks": {name: [L, ...]}, "ln_f", "lm_head"} with blocks
stacked on a leading layer axis (a MoE config's blocks hold router, w_in
and w_out in place of w_gate, w_up and w_down); both packages keep the
[in, out] layout, so the arrays move over unchanged.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import resolve_device
from .transformer import TransformerConfig, TransformerLM


def from_jax_params(tree: Dict[str, Any], cfg: TransformerConfig, device=None) -> TransformerLM:
    """A TransformerLM holding the JAX package's params, given as numpy
    arrays (or anything np.asarray takes) with blocks stacked [L, ...]."""
    dev = resolve_device(device)
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
        for i, blk in enumerate(model.blocks):
            for name in model.block_keys:
                put(getattr(blk, name), np.asarray(tree["blocks"][name])[i])
    return model


def to_jax_params(model: TransformerLM) -> Dict[str, Any]:
    """The module's fp32 weights as the JAX package's numpy param tree."""

    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    return {
        "embed": host(model.embed),
        "blocks": {
            n: np.stack([host(getattr(blk, n)) for blk in model.blocks]) for n in model.block_keys
        },
        "ln_f": host(model.ln_f),
        "lm_head": host(model.lm_head),
    }
