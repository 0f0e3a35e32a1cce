"""What the drivers share: the port's model built to a configuration, the
seed's weights copied into it, device housekeeping, and the statistics of
the result line."""

from __future__ import annotations

import gc
from typing import Dict, List, Sequence

import numpy as np

from . import weights as W


def port_config_fields(m: Dict) -> Dict:
    """The port's TransformerConfig fields for a configuration (without
    vocab_size)."""
    return {k: m[k] for k in ("d_model", "n_layers", "n_heads", "n_kv_heads", "d_head", "d_ff",
                              "max_seq_len", "rope_theta", "dtype", "param_dtype")}


def load_weights(model, m: Dict, seed: int) -> None:
    """Overwrite every weight of a port TransformerLM with the seed's, one
    kind at a time (made on the model's device in its parameter dtype)."""
    import torch

    params = dict(model.named_parameters())
    with torch.no_grad():
        for kind in W.KINDS:
            w = W.make(m, seed, kind, model.device, next(iter(params.values())).dtype)
            for name, k, i in W.leaves(m):
                if k == kind:
                    params[name].copy_(W.pick(w, i))
            del w


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def launches() -> Dict[str, int]:
    """The port's own counts of its flash kernels' launches."""
    import importlib

    attn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")

    return {"flash_fwd": attn.flash_attention.launches, "bwd_dq": attn.flash_bwd_dq.launches,
            "bwd_dkv": attn.flash_bwd_dkv.launches}


def p95(values: Sequence[float]) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def tail_mean(values: Sequence[float], share: float) -> float:
    """The mean of the largest `share` of the values (at least one)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[-max(1, int(np.ceil(len(v) * share))):].mean())


def check(value: float, limit: float, below: bool = True) -> Dict:
    ok = bool(np.isfinite(value)) and (value <= limit if below else value >= limit)
    return {"value": float(value), "limit": float(limit), "pass": ok}


def log(msg: str) -> None:
    import sys

    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def median_leaf(norms: Dict[str, float]) -> float:
    return float(np.median(list(norms.values())))


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> tuple:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref),
    and the leaf that gives it."""
    med = float(np.median([ref[k] for k in leaves]))
    worst, at = 0.0, None
    for k in leaves:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        if not np.isfinite(gap) or gap > worst:
            worst, at = (float("inf") if not np.isfinite(gap) else gap), k
    return worst, at
