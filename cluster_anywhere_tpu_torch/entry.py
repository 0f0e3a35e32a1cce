"""The port's flagship model and its forward step, the counterpart of the
JAX package's __graft_entry__.py (`_flagship_cfg`, `entry`).

    fn, args = entry()        # on the card; entry(device="cpu") on the host
    logits = fn(*args)        # [4, 1024, 32000] bf16
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .models.transformer import TransformerConfig, forward, init_params


def flagship_cfg() -> TransformerConfig:
    """The one full-width model of the repo: vocab 32000, d_model 1024,
    8 layers, 8 heads over 4 KV heads of 128, d_ff 4096, bf16 activations
    over fp32 params."""
    return TransformerConfig(
        vocab_size=32000,
        d_model=1024,
        n_layers=8,
        n_heads=8,
        n_kv_heads=4,
        d_head=128,
        d_ff=4096,
        max_seq_len=2048,
        dtype=torch.bfloat16,
    )


def entry(device=None, seed: int = 0):
    """The flagship's forward step: returns (fn, (model, ids)) with random
    weights from `seed` and ids [4, 1024] drawn from a numpy generator of
    the same seed.  fn(model, ids) is `forward` without autograd."""
    dev = resolve_device(device)
    cfg = flagship_cfg()
    model = init_params(cfg, seed, device=dev)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 1024))
    ids = torch.from_numpy(ids).to(dev)

    @torch.no_grad()
    def fn(model, ids):
        return forward(model, ids)

    return fn, (model, ids)
