"""The port's configs accept every field of the JAX package's configs, and
the serving classes' Serve hook: TransformerConfig takes the parallel-stack
fields with the JAX package's checks, remat
and attn_impl work in the training forward, ProcessorConfig takes the Data
fields, and LLMServer.reconfigure sets the sampling defaults.

On the CPU at tests/test_torch_train.py's TINY size.  remat changes only
what the backward keeps, so with and without it the port's fp32 loss and
gradients agree to 1e-6 of each tensor's largest element; against the JAX
package's remat step they are held to test_torch_train.py's tolerances.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cluster_anywhere_tpu.llm import processor as jproc
from cluster_anywhere_tpu.models import transformer as jtf
from cluster_anywhere_tpu_torch import llm
from cluster_anywhere_tpu_torch.llm import processor as tproc
from cluster_anywhere_tpu_torch.models import transformer as ttf
from cluster_anywhere_tpu_torch.models.convert import from_jax_params, to_jax_params
from cluster_anywhere_tpu_torch.ops.attention import reference_attention

TINY = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
            max_seq_len=64)


def _ids(b=4, t=16, seed=1):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, t + 1)).astype(np.int32)


def _jax_leaves(tree):
    out = {n: np.asarray(tree[n]) for n in ("embed", "ln_f", "lm_head")}
    out.update({n: np.asarray(a) for n, a in tree["blocks"].items()})
    return out


def _port_loss_and_grads(tcfg, tree, ids):
    model = from_jax_params(tree, tcfg, device="cpu")
    loss = ttf.make_loss_fn(tcfg)(model, {"ids": ids})
    loss.backward()
    grads = {n: getattr(model, n).grad.numpy() for n in ("embed", "ln_f", "lm_head")}
    for n in model.block_keys:
        grads[n] = np.stack([getattr(blk, n).grad.numpy() for blk in model.blocks])
    return loss.item(), grads


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_every_jax_transformer_field_exists_in_the_port():
    jfields = {f.name for f in dataclasses.fields(jtf.TransformerConfig)}
    tfields = {f.name for f in dataclasses.fields(ttf.TransformerConfig)}
    assert jfields <= tfields, jfields - tfields


@pytest.mark.parametrize("field, value", [
    ("attn_impl", "auto"), ("attn_impl", "dense"), ("attn_impl", "jnp"), ("attn_impl", "flash"),
    ("flash_block_q", 128), ("flash_block_k", 64), ("pp", 1), ("sp", 1),
    ("num_microbatches", 1), ("remat", True), ("remat", False), ("unroll_layers", False),
    ("unroll_layers", True),
])
def test_one_device_values_are_accepted(field, value):
    cfg = ttf.TransformerConfig(**TINY, **{field: value})
    assert getattr(cfg, field) == value
    # the deployment path passes config_overrides straight through
    spec = tproc.ModelSpec(preset="tiny", config_overrides={field: value})
    assert getattr(spec.transformer_config(259), field) == value


def _raised(fn):
    """The type of the exception fn() raises, or None."""
    try:
        fn()
    except Exception as e:  # the outcome is what the test compares
        return type(e)
    return None


@pytest.mark.parametrize("field, value", [
    ("pp", 2), ("sp", 2), ("num_microbatches", 4), ("attn_impl", "ring"),
    ("attn_impl", "ulysses"), ("ep", 2),
])
def test_parallel_values_are_refused_naming_the_roadmap_item(field, value):
    """The parallel stack is ported: each parallel value the JAX package
    takes is accepted (through config_overrides too), with JAX's derived
    values, and a forward without a mesh raises exactly where JAX's does
    (pp and manual sp need one; the test's name is from before the port)."""
    cfg = ttf.TransformerConfig(**TINY, **{field: value})
    jcfg = jtf.TransformerConfig(**TINY, **{field: value})
    assert getattr(cfg, field) == value
    assert cfg.resolved_attn() == jcfg.resolved_attn()
    assert cfg.layers_per_stage == jcfg.layers_per_stage
    spec = tproc.ModelSpec(preset="tiny", config_overrides={field: value})
    assert getattr(spec.transformer_config(259), field) == value
    ids = _ids(b=2, t=8)[:, :-1]
    want = _raised(lambda: jtf.forward(jtf.init_params(jax.random.key(0), jcfg), ids, jcfg))
    got = _raised(lambda: ttf.forward(ttf.init_params(cfg, 0, device="cpu"),
                                      torch.tensor(ids).long()))
    assert got is want and want in (None, ValueError), (got, want)


def test_layers_per_stage_check_raises_as_in_jax():
    for pkg in (jtf, ttf):
        with pytest.raises(ValueError, match="not divisible by pp 3"):
            pkg.TransformerConfig(**TINY, pp=3).layers_per_stage


def test_unknown_attn_impl_is_a_value_error():
    with pytest.raises(ValueError, match="attn_impl"):
        ttf.TransformerConfig(**TINY, attn_impl="sdpa")


def test_remat_keeps_loss_and_gradients():
    """fp32: the same loss and gradients with and without remat (1e-6)."""
    jcfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jtf.init_params(jax.random.key(7), jcfg))
    ids = _ids(seed=8)
    base = ttf.TransformerConfig(**TINY, dtype="float32")
    loss0, g0 = _port_loss_and_grads(base, tree, ids)
    loss1, g1 = _port_loss_and_grads(dataclasses.replace(base, remat=True), tree, ids)
    assert abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    for name in g0:
        assert _rel(g1[name], g0[name]) <= 1e-6, name


def _remat_trace(remat, monkeypatch):
    """(block forwards run in the backward, bytes the autograd graph keeps
    outside the checkpointed blocks) for one fp32 loss and backward."""
    calls = []
    block_forward = ttf._block_forward

    def counted(*args):
        calls.append(1)
        return block_forward(*args)

    monkeypatch.setattr(ttf, "_block_forward", counted)
    jcfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jtf.init_params(jax.random.key(7), jcfg))
    tcfg = ttf.TransformerConfig(**TINY, dtype="float32", remat=remat)
    model = from_jax_params(tree, tcfg, device="cpu")
    kept = []

    def pack(t):
        kept.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = ttf.make_loss_fn(tcfg)(model, {"ids": _ids(seed=8)})
    assert len(calls) == TINY["n_layers"]
    del calls[:]
    loss.backward()
    return len(calls), sum(kept)


def test_remat_recomputes_each_block_in_the_backward(monkeypatch):
    """remat=True runs every block's forward again in the backward and keeps
    less for the backward; remat=False runs none again.  The counterpart of
    jax.checkpoint around the JAX block, which the loss and gradient
    comparisons alone cannot tell from a forward without it."""
    recomputed, kept = _remat_trace(False, monkeypatch)
    assert recomputed == 0
    recomputed_remat, kept_remat = _remat_trace(True, monkeypatch)
    assert recomputed_remat == TINY["n_layers"]
    assert kept_remat < kept / 2, (kept_remat, kept)


def test_remat_train_step_matches_jax_remat():
    """One AdamW step with remat on both sides: the loss and gradients to
    2e-5 relative (test_torch_train.py's fp32 tolerance), and the updated
    weights to 1e-7 + 2e-6 relative (its AdamW tolerance) plus what the
    gradient tolerance moves Adam's first update by: lr * g / (|g| + eps)
    moves by lr * eps * dg / (|g| + eps)^2 for a gradient error dg, which
    is large only where |g| is within a few eps of zero."""
    lr = 3e-4
    jcfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32, remat=True)
    tcfg = ttf.TransformerConfig(**TINY, dtype="float32", remat=True)
    jstep, jinit = jtf.make_train_step(jcfg, None, learning_rate=lr)
    jparams, jopt = jinit(jax.random.key(9))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    ids = _ids(seed=11)
    jloss, jgrads = jax.value_and_grad(jtf.make_loss_fn(jcfg))(jparams, {"ids": jnp.asarray(ids)})
    loss, grads = _port_loss_and_grads(tcfg, tree, ids)
    assert abs(loss - float(jloss)) <= 2e-5 * abs(float(jloss))
    want_g = _jax_leaves(jgrads)
    for name in want_g:
        assert _rel(grads[name], want_g[name]) <= 2e-5, name
    jparams, jopt, _ = jax.jit(jstep)(jparams, jopt, {"ids": jnp.asarray(ids)})
    tstep, tinit = ttf.make_train_step(tcfg, learning_rate=lr, device="cpu")
    model, opt = tinit(from_jax_params(tree, tcfg, device="cpu"))
    model, opt, _ = tstep(model, opt, {"ids": ids})
    got, want = _jax_leaves(to_jax_params(model)), _jax_leaves(jparams)
    eps = 1e-8
    for name in want:
        g = np.abs(want_g[name])
        dg = 2e-5 * g.max()
        bound = 1e-7 + 2e-6 * np.abs(want[name]) + lr * eps * dg / (g + eps) ** 2
        diff = np.abs(got[name] - want[name])
        assert (diff <= bound).all(), (name, diff.max())


def test_attn_impl_jnp_is_reference_attention(monkeypatch):
    """attn_impl="jnp" routes every layer of the training forward through
    reference_attention; its fp32 logits equal attn_impl="flash"'s (the
    flash kernels' plain version on the CPU) to 1e-5."""
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return reference_attention(*a, **kw)

    cfg = ttf.TransformerConfig(**TINY, dtype="float32", attn_impl="jnp")
    model = ttf.init_params(cfg, 0, device="cpu")
    ids = torch.as_tensor(_ids(b=2, t=8)[:, :-1]).long()
    with monkeypatch.context() as m:
        m.setitem(ttf._ATTENTION, "jnp", spy)
        logits = ttf.forward(model, ids)
    assert len(calls) == TINY["n_layers"]
    model.cfg = dataclasses.replace(cfg, attn_impl="flash")
    torch.testing.assert_close(ttf.forward(model, ids), logits, rtol=1e-5, atol=1e-5)


def test_jax_processor_config_builds_in_the_port():
    """A ProcessorConfig valid for the JAX package, every field set, builds
    in the port with the same values."""
    kw = dict(batch_size=4, concurrency=2, max_prompt_len=24, max_new_tokens=5, temperature=0.5,
              top_k=3, top_p=0.9, apply_chat_template=True, system_prompt="be brief",
              prefix_cache_entries=2, prefix_block=8)
    jfields = {f.name for f in dataclasses.fields(jproc.ProcessorConfig)}
    assert jfields <= {f.name for f in dataclasses.fields(tproc.ProcessorConfig)}
    jcfg = jproc.ProcessorConfig(model=jproc.ModelSpec(preset="tiny"), **kw)
    tcfg = tproc.ProcessorConfig(model=tproc.ModelSpec(preset="tiny"), **kw)
    for name in kw:
        assert getattr(tcfg, name) == getattr(jcfg, name)


def test_llm_server_reconfigure_sets_sampling_defaults():
    srv = llm.LLMServer(llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny"), max_new_tokens=3),
                        device="cpu")
    assert srv({"prompt": "hi"})["num_generated_tokens"] == 3
    srv.reconfigure({"max_new_tokens": 5, "temperature": 0.7})
    assert srv.config.max_new_tokens == 5 and srv.config.temperature == 0.7
    assert srv({"prompt": "hi"})["num_generated_tokens"] == 5
