"""Flat npz save/load of model params, in the JAX package's format
(cluster_anywhere_tpu/llm/_params_io.py): one `params.npz` whose keys are
the tree paths joined by "/", e.g. "embed", "blocks/wq" (stacked [L, ...]).
A checkpoint saved by either package loads in the other."""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def save_params(params: Any, path: str) -> None:
    """params: a TransformerLM, or a param tree of arrays or tensors (on
    any device)."""
    if isinstance(params, torch.nn.Module):
        from ..models.convert import to_jax_params

        params = to_jax_params(params)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "params.npz"), **_flatten(params))


def load_params(path: str) -> Dict[str, Any]:
    """The saved param tree, as numpy arrays (models.convert.from_jax_params
    turns it into a TransformerLM)."""
    with np.load(os.path.join(path, "params.npz")) as f:
        tree: Dict[str, Any] = {}
        for key in f.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = f[key]
    return _relist(tree)


def _relist(node):
    """An all-digit-keyed dict came from a list and round-trips as one."""
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node):
            return [_relist(node[str(i)]) for i in range(len(node))]
        return {k: _relist(v) for k, v in node.items()}
    return node
