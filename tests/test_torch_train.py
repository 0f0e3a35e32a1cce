"""Parity of the port's training path (cluster_anywhere_tpu_torch.models:
forward, cross_entropy_loss, make_loss_fn, make_train_step) with the JAX
package, on the CPU at tests/test_model.py's TINY size.

Both packages start from the same weights (JAX-initialised, converted with
from_jax_params) and take the same numpy batches.  On the CPU the JAX
forward runs its dense reference attention, and the port's runs the plain
versions of the flash kernels through its autograd Function.  Tolerances: fp32 logits, loss and gradients to 2e-5 of each
tensor's largest element (summation order only).  bf16 to 5e-2 in
relative L2 norm: bf16 activations round at other points in XLA's fused
CPU code than in eager torch (2^-8 relative a rounding, through 4
layers of width 32); at this size each package's bf16 gradients lie 1-5%
(L2) from the fp32 gradients of the same weights, and the two packages
agree with each other to about 2.5%.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cluster_anywhere_tpu.models import transformer as jtf
from cluster_anywhere_tpu_torch.models import generate as tgen
from cluster_anywhere_tpu_torch.models import transformer as ttf
from cluster_anywhere_tpu_torch.models.convert import from_jax_params, to_jax_params

TINY = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
            max_seq_len=64)
TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _pair(dtype="float32", seed=0):
    """(JAX cfg, JAX params, port cfg, port model) on the same weights."""
    jcfg = jtf.TransformerConfig(**TINY, dtype=jnp.dtype(dtype))
    jparams = jtf.init_params(jax.random.key(seed), jcfg)
    tcfg = ttf.TransformerConfig(**TINY, dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg, device="cpu")


def _ids(b=4, t=16, seed=1):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, t + 1)).astype(np.int32)


def _rel_err(got, want, dtype="float32"):
    """fp32: max |got - want| over max |want|; bf16: the relative L2 error."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "bfloat16":
        return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_grads(model):
    """{name: grad} in the JAX tree's names, blocks stacked [L, ...]."""
    out = {n: getattr(model, n).grad.numpy() for n in ("embed", "ln_f", "lm_head")}
    for n in model.block_keys:
        out[n] = np.stack([getattr(blk, n).grad.numpy() for blk in model.blocks])
    return out


def _jax_leaves(tree):
    out = {n: np.asarray(tree[n]) for n in ("embed", "ln_f", "lm_head")}
    out.update({n: np.asarray(a) for n, a in tree["blocks"].items()})
    return out


def test_forward_shapes():
    cfg = ttf.TransformerConfig(**TINY, dtype="float32")
    model = ttf.init_params(cfg, 0, device="cpu")
    logits = ttf.forward(model, torch.zeros((2, 16), dtype=torch.long))
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(dtype):
    jcfg, jparams, tcfg, model = _pair(dtype)
    ids = _ids()[:, :-1]
    want = jtf.forward(jparams, jnp.asarray(ids), jcfg)
    got = ttf.forward(model, torch.tensor(ids).long())
    assert got.dtype == tcfg.dtype
    assert _rel_err(got.float().detach(), want, dtype) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked, dtype):
    """Both cast the logits to fp32 first: equal to fp32 rounding."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 11)) * 3).astype(np.float32)
    targets = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jtf.cross_entropy_loss(jnp.asarray(logits, jnp.dtype(dtype)), jnp.asarray(targets),
                                  None if mask is None else jnp.asarray(mask))
    got = ttf.cross_entropy_loss(torch.tensor(logits).to(getattr(torch, dtype)),
                                 torch.tensor(targets), None if mask is None else torch.tensor(mask))
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))


def test_cross_entropy_all_masked_is_zero():
    logits = torch.randn(2, 3, 5)
    loss = ttf.cross_entropy_loss(logits, torch.zeros(2, 3, dtype=torch.long), torch.zeros(2, 3))
    assert loss.item() == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(dtype):
    jcfg, jparams, tcfg, model = _pair(dtype, seed=2)
    batch = {"ids": _ids(seed=4)}
    want_loss, want_grads = jax.value_and_grad(jtf.make_loss_fn(jcfg))(
        jparams, {"ids": jnp.asarray(batch["ids"])})
    loss = ttf.make_loss_fn(tcfg)(model, batch)
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(loss.item() - float(want_loss)) <= TOL[dtype] * abs(float(want_loss))
    got, want = _port_grads(model), _jax_leaves(want_grads)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == np.float32
        err = _rel_err(got[name], want[name], dtype)
        assert err <= TOL[dtype], (name, err)


def test_adamw_steps_match_jax():
    """Three AdamW steps (learning rate 3e-4, weight decay 0.01) on three
    batches: losses to 2e-5 relative, and every parameter within 1e-7 + 2e-6
    relative of JAX's (fp32 rounding of the updates; dropping the weight
    decay would move a weight by 9e-6 of itself over the 3 steps).  Adam's first update is about lr * sign(g), so an
    element whose gradient is within rounding noise of zero can move by up
    to lr on one side and not on the other: such elements (|g| below 1e-7
    times the tensor's largest gradient on some step) are held to 3 * lr
    instead, and there must be few of them."""
    lr = 3e-4
    jcfg, jparams, tcfg, model = _pair("float32", seed=5)
    jstep, jinit = jtf.make_train_step(jcfg, None, learning_rate=lr)
    jparams, jopt = jinit(jax.random.key(5))
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    tstep, tinit = ttf.make_train_step(tcfg, learning_rate=lr, device="cpu")
    model, opt = tinit(model)
    near_zero = {}
    jstep = jax.jit(jstep)
    for i in range(3):
        ids = _ids(seed=10 + i)
        grads = jax.grad(jtf.make_loss_fn(jcfg))(jparams, {"ids": jnp.asarray(ids)})
        for name, g in _jax_leaves(grads).items():
            small = np.abs(g) <= 1e-7 * np.abs(g).max()
            near_zero[name] = near_zero.get(name, False) | small
        jparams, jopt, jloss = jstep(jparams, jopt, {"ids": jnp.asarray(ids)})
        model, opt, loss = tstep(model, opt, {"ids": ids})
        assert abs(loss.item() - float(jloss)) <= 2e-5 * abs(float(jloss))
    got = _jax_leaves(to_jax_params(model))
    want = _jax_leaves(jparams)
    for name in want:
        diff = np.abs(got[name] - want[name])
        ok = diff <= 1e-7 + 2e-6 * np.abs(want[name])
        ok |= near_zero[name] & (diff <= 3 * lr)
        assert ok.all(), (name, diff.max())
        assert near_zero[name].mean() < 0.02 or name == "embed", name


def test_loss_decreases_single_device():
    cfg = ttf.TransformerConfig(**TINY, dtype="float32")
    step, init_state = ttf.make_train_step(cfg, learning_rate=1e-2, device="cpu")
    model, opt = init_state(0)
    batch = {"ids": _ids(b=8, t=16, seed=1)}
    losses = []
    for _ in range(8):
        model, opt, loss = step(model, opt, batch)
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.8, losses


@pytest.mark.parametrize("foreach", [False, True])
def test_generate_after_train_step_serves_the_new_weights(foreach):
    """compute_weights (the serving copy in the activation dtype) follows an
    optimizer step, by AdamW's single-tensor path and by its multi-tensor
    (foreach) path, the default on the card: greedy generation after a step
    equals generation on a fresh model holding the trained weights."""
    cfg = ttf.TransformerConfig(**TINY, dtype="bfloat16")

    def adamw(params):
        return torch.optim.AdamW(params, lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                                 foreach=foreach)

    step, init_state = ttf.make_train_step(cfg, optimizer=adamw, device="cpu")
    model, opt = init_state(3)
    prompts = torch.tensor(_ids(b=2, t=8, seed=6)[:, :8]).long()
    before = model.compute_weights()["blocks"][0]["wq"].clone()
    tgen.generate(model, prompts, cfg=cfg, max_new_tokens=4)
    model, opt, _ = step(model, opt, {"ids": _ids(b=4, t=16, seed=7)})
    assert not torch.equal(model.compute_weights()["blocks"][0]["wq"], before)
    got = tgen.generate(model, prompts, cfg=cfg, max_new_tokens=6)
    fresh = from_jax_params(to_jax_params(model), cfg, device="cpu")
    want = tgen.generate(fresh, prompts, cfg=cfg, max_new_tokens=6)
    assert torch.equal(got, want)


def test_train_step_refuses_a_mesh(tmp_path):
    """A mesh must span the process group: one of 2 ranks in a world of 1
    raises (the sharded step itself is tests/test_torch_parallel_model.py's)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from cluster_anywhere_tpu_torch.parallel.mesh import AXES

    cfg = ttf.TransformerConfig(**TINY, dtype="float32")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 1, 1, 2, 1, 1), mesh_dim_names=AXES,
                          _init_backend=False)
        with pytest.raises(ValueError, match="a mesh spans every rank"):
            ttf.make_train_step(cfg, mesh=mesh)
    finally:
        dist.destroy_process_group()


def test_entry_points_default_to_the_card():
    """device=None means CUDA: without a card the training entry points
    raise instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from cluster_anywhere_tpu_torch import entry

    cfg = ttf.TransformerConfig(**TINY, dtype="float32")
    with pytest.raises(RuntimeError):
        ttf.make_train_step(cfg)[1](0)
    with pytest.raises(RuntimeError):
        entry.entry()


def test_flagship_cfg_matches_graft_entry():
    import __graft_entry__

    from cluster_anywhere_tpu_torch.entry import flagship_cfg

    want = __graft_entry__._flagship_cfg()
    got = flagship_cfg()
    for field in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_head", "d_ff",
                  "max_seq_len", "rope_theta"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.dtype == torch.bfloat16 and jnp.dtype(want.dtype) == jnp.bfloat16
    assert got.param_dtype == torch.float32
