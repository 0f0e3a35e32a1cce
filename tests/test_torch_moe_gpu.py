"""One mixture-of-experts layer of the flagship's MoE variant (d_model 1024,
8 heads over 4 KV heads of 128, 4 top-1 experts of d_ff 4096, bf16 over
fp32 masters) through its training forward and backward on the card: the
flash kernels against the plain attention.  Skipped without a GPU; this
file imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_moe_gpu.py -q -m gpu
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

tattn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
tmoe = importlib.import_module("cluster_anywhere_tpu_torch.parallel.moe")

# chip_smoke.py's limits for one training step, kernels against plain attention
LOSS_REL, GRAD_REL_L2 = 1e-3, 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_moe_layer_kernels_match_plain_attention_on_card(cuda, monkeypatch):
    """Loss and every gradient of a one-layer MoE flagship on B 2 x T 1024,
    the plain run's routes pinned to the kernel run's (a bf16 route can flip
    on a near-tie when attention rounds differently, which would move that
    token's whole FFN output); the kernels launch once each."""
    from cluster_anywhere_tpu_torch.entry import flagship_cfg
    from cluster_anywhere_tpu_torch.models import init_params, make_loss_fn

    cfg = dataclasses.replace(flagship_cfg(), n_layers=1, n_experts=4)
    model = init_params(cfg, 0, device=cuda)
    params = list(model.parameters())
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 1025))
    batch = {"ids": torch.from_numpy(ids).to(cuda)}
    loss_fn = make_loss_fn(cfg)
    real_route, routes = tmoe.top1_route, []

    def recording(logits):
        probs, idx, gate = real_route(logits)
        routes.append(idx)
        return probs, idx, gate

    def pinned(logits):
        probs = torch.softmax(logits, dim=-1)
        idx = routes.pop(0)
        return probs, idx, probs.gather(-1, idx[:, None])[:, 0]

    before = (tattn.flash_attention.launches, tattn.flash_bwd_dq.launches,
              tattn.flash_bwd_dkv.launches)
    monkeypatch.setattr(tmoe, "top1_route", recording)
    loss_k = loss_fn(model, batch)
    grads_k = torch.autograd.grad(loss_k, params)
    after = (tattn.flash_attention.launches, tattn.flash_bwd_dq.launches,
             tattn.flash_bwd_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)

    def plain(q, k, v, *, causal=True, scale=None, pad=None, return_lse=False):
        o, lse = tattn._flash_attention_plain(
            q, k, v, causal=causal, scale=q.shape[-1] ** -0.5 if scale is None else scale, pad=pad)
        return (o, lse) if return_lse else o

    monkeypatch.setattr(tattn, "flash_attention", plain)
    monkeypatch.setattr(tmoe, "top1_route", pinned)
    loss_p = loss_fn(model, batch)
    grads_p = torch.autograd.grad(loss_p, params)
    assert not routes
    assert abs(loss_k.item() - loss_p.item()) <= LOSS_REL * abs(loss_p.item())
    for (name, _), gk, gp in zip(model.named_parameters(), grads_k, grads_p):
        assert torch.isfinite(gk).all(), name
        rel = ((gk.double() - gp.double()).norm() / gp.double().norm()).item()
        assert rel <= GRAD_REL_L2, (name, rel)
