"""The plain reference against the port at a tiny width on the CPU: the
same logits as the port's prefill, the same loss and gradients as its
training loss, and a control in fp8 that reads far from it."""

import pytest
import torch

from perfbench import harness, manifest, reference
from perfbench import weights as W
from perfbench.tests.tiny_cells import tiny_cell

SEED = 2**33 + 7


def dims():
    return manifest.model_dims(tiny_cell("dsllm7b.chat")["config"])


def port_model(m):
    from cluster_anywhere_tpu_torch.models.transformer import TransformerConfig, TransformerLM

    cfg = TransformerConfig(vocab_size=m["vocab"], **harness.port_config_fields(m))
    model = TransformerLM(cfg, "cpu")
    harness.load_weights(model, m, SEED)
    return cfg, model


def test_served_logits_match_the_ports_prefill():
    from cluster_anywhere_tpu_torch.models.generate import prefill

    m = dims()
    cfg, model = port_model(m)
    ids = torch.randint(0, m["vocab"], (1, 23), generator=torch.Generator().manual_seed(1))
    want, _ = prefill(model, ids, cfg, 32)
    w = W.make_all(m, SEED, "cpu", torch.float32)
    got = reference.served_logits(w, m, [ids[0].tolist()], [[22]])[0]
    torch.testing.assert_close(got, want.float(), rtol=1e-4, atol=1e-4)
    low = reference.served_logits(w, m, [ids[0].tolist()], [[22]], fmt="fp8")[0]
    assert (low - got).abs().max() > 1e-2


def test_loss_and_gradients_match_the_ports():
    from cluster_anywhere_tpu_torch.models.transformer import make_loss_fn

    m = dims()
    cfg, model = port_model(m)
    ids = torch.randint(0, m["vocab"], (2, 17), generator=torch.Generator().manual_seed(2))
    loss = make_loss_fn(cfg)(model, {"ids": ids})
    loss.backward()
    params = {k: W.make(m, SEED, k, "cpu", torch.float32).requires_grad_() for k in W.KINDS}
    ref = reference.loss_fn(params, ids, m)
    ref.backward()
    assert float(ref.detach()) == pytest.approx(float(loss.detach()), rel=1e-5)
    got = {n: p.grad.norm().item() for n, p in model.named_parameters()}
    want = reference.leaf_norms({k: p.grad for k, p in params.items()}, m)
    for name in got:
        assert got[name] == pytest.approx(want[name], rel=1e-4, abs=1e-7), name


def test_adamw_is_torchs():
    g = torch.Generator().manual_seed(3)
    p0 = torch.randn(5, 3, generator=g)
    grads = [torch.randn(5, 3, generator=g) for _ in range(3)]
    a = torch.nn.Parameter(p0.clone())
    opt = torch.optim.AdamW([a], lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    b = {"w": p0.clone().requires_grad_()}
    mine = reference.AdamW(b, 3e-4, weight_decay=0.01)
    for gr in grads:
        a.grad = gr.clone()
        opt.step()
        b["w"].grad = gr.clone()
        mine.step()
    torch.testing.assert_close(b["w"].detach(), a.detach(), rtol=1e-6, atol=1e-7)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(4))
    e8 = (reference._round(x, "fp8") - x).abs().max()
    e16 = (reference._round(x, "bf16") - x).abs().max()
    assert e8 > 4 * e16 > 0
    assert torch.isfinite(reference._round(x * 1e6, "fp8")).all()
