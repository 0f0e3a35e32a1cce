"""The model's weights, made from the run's seed on the device: one seeded
generator and one large call per kind of weight, stacked over the layers,
in the type they are used in.  The program and the reference each get them
from here, so both start from the same numbers and neither takes the
other's.

Kinds and layouts follow the port's [in, out] names: embed [V, E]; per
layer ln1, ln2 [L, E], wq [L, E, H*D], wk and wv [L, E, KV*D], wo [L, H*D,
E], w_gate and w_up [L, E, F], w_down [L, F, E]; ln_f [E]; lm_head [E, V].
Scales: the embedding 0.02, every matrix fan_in^-0.5, the norms 1.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .generator import derive

BLOCK_KINDS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down")
KINDS = ("embed",) + BLOCK_KINDS + ("ln_f", "lm_head")


def shapes(m: Dict) -> Dict[str, Tuple[int, ...]]:
    e, L, v = m["d_model"], m["n_layers"], m["vocab"]
    hd, kvd, f = m["n_heads"] * m["d_head"], m["n_kv_heads"] * m["d_head"], m["d_ff"]
    return {
        "embed": (v, e), "ln1": (L, e), "wq": (L, e, hd), "wk": (L, e, kvd), "wv": (L, e, kvd),
        "wo": (L, hd, e), "ln2": (L, e), "w_gate": (L, e, f), "w_up": (L, e, f),
        "w_down": (L, f, e), "ln_f": (e,), "lm_head": (e, v),
    }


def make(m: Dict, seed: int, kind: str, device, dtype):
    """One kind of weight, every layer of it, in one call."""
    import torch

    shape = shapes(m)[kind]
    if kind.startswith("ln"):
        return torch.ones(shape, device=device, dtype=dtype)
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights", kind))
    std = 0.02 if kind == "embed" else shape[-2] ** -0.5
    return torch.randn(shape, generator=g, device=device, dtype=dtype).mul_(std)


def make_all(m: Dict, seed: int, device, dtype) -> Dict:
    return {k: make(m, seed, k, device, dtype) for k in KINDS}


def leaves(m: Dict):
    """(leaf name, kind, layer or None) of every weight, named as the port's
    TransformerLM.named_parameters() names them."""
    out = [("embed", "embed", None)]
    for i in range(m["n_layers"]):
        out += [(f"blocks.{i}.{k}", k, i) for k in BLOCK_KINDS]
    return out + [("ln_f", "ln_f", None), ("lm_head", "lm_head", None)]


def pick(t, layer):
    """One leaf of a kind's tensor: the whole of it, or its layer's slice."""
    return t if layer is None else t[layer]
