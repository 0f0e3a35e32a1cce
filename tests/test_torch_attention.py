"""The port's attention (cluster_anywhere_tpu_torch.ops.attention) against
the JAX package's, on the CPU (the CUDA kernel against its plain version
on the card is tests/test_torch_flash_kernel.py).

On the CPU `flash_attention` runs its plain PyTorch version; it is held to
the JAX Pallas kernel run in interpret mode, real rows to 2e-5 as
tests/test_ops.py holds that kernel to its reference (fp32, summation
order only differs).
"""

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

# by module path: both ops packages export an `attention` function that
# shadows the submodule's attribute
jattn = importlib.import_module("cluster_anywhere_tpu.ops.attention")
tattn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")

B, H, D = 2, 3, 16


def _qkv(t, t_kv, seed=0, d=D, b=B, h=H):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, t, h, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, t_kv, h, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, t_kv, h, d)) * 0.5).astype(np.float32)
    return q, k, v


def _pad(padded, t_kv):
    return np.array([min(5, t_kv - 1), 0], np.int32)[:B] if padded else None


@pytest.mark.parametrize("t,t_kv", [(64, 64), (64, 128)])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_interpret(causal, padded, t, t_kv):
    q, k, v = _qkv(t, t_kv, seed=t_kv + padded)
    pad = _pad(padded, t_kv)
    jo, jlse = jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True,
        pad=None if pad is None else jnp.asarray(pad), return_lse=True,
    )
    to, tlse = tattn.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        pad=None if pad is None else torch.tensor(pad), return_lse=True,
    )
    assert to.shape == (B, t, H, D) and tlse.shape == (B, H, t) and tlse.dtype == torch.float32
    jo, jlse = np.asarray(jo), np.asarray(jlse)
    np.testing.assert_allclose(to.numpy(), jo, atol=2e-5, rtol=2e-5)
    real = jlse > tattn.NEG_INF / 2
    np.testing.assert_array_equal(tlse.numpy() > tattn.NEG_INF / 2, real)
    np.testing.assert_allclose(tlse.numpy()[real], jlse[real], atol=2e-5, rtol=2e-5)
    # fully masked rows (left-pad query rows under causal): O = 0, LSE = -1e30
    assert np.all(tlse.numpy()[~real] == tattn.NEG_INF)
    masked_rows = ~real.transpose(0, 2, 1)  # [B, T, H]
    assert np.all(to.numpy()[masked_rows] == 0.0)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal, padded):
    q, k, v = _qkv(24, 24, seed=3)
    pad = _pad(padded, 24)
    want = jattn.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, pad=None if pad is None else jnp.asarray(pad))
    got = tattn.reference_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                    causal=causal, pad=None if pad is None else torch.tensor(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("t,t_kv", [(37, 37), (37, 50), (50, 37), (1, 9)])
def test_flash_plain_matches_reference_on_ragged_shapes(t, t_kv):
    """Any T and T_kv: rows that see a key equal the dense reference."""
    q, k, v = _qkv(t, t_kv, seed=t * t_kv)
    pad = torch.tensor([2, 0])
    args = [torch.tensor(a) for a in (q, k, v)]
    o, lse = tattn.flash_attention(*args, causal=True, pad=pad, return_lse=True)
    ref = tattn.reference_attention(*args, causal=True, pad=pad)
    real = (lse > tattn.NEG_INF / 2).permute(0, 2, 1)  # [B, T, H]
    torch.testing.assert_close(o[real], ref[real], atol=2e-5, rtol=2e-5)


def test_dispatcher_on_cpu_is_the_reference():
    q, k, v = (torch.tensor(a) for a in _qkv(20, 20, seed=9))
    pad = torch.tensor([4, 1])
    assert torch.equal(tattn.attention(q, k, v, causal=True, pad=pad),
                       tattn.reference_attention(q, k, v, causal=True, pad=pad))


def test_bf16_plain_computes_in_fp32():
    q, k, v = (torch.tensor(a) for a in _qkv(32, 32, seed=11))
    o16, lse16 = tattn.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), return_lse=True)
    o32, lse32 = tattn.flash_attention(q.bfloat16().float(), k.bfloat16().float(),
                                       v.bfloat16().float(), return_lse=True)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    assert torch.equal(o16, o32.bfloat16()) and torch.equal(lse16, lse32)


@pytest.mark.parametrize("case", ["d_head", "dtype", "kv_shape", "pad_shape", "rank"])
def test_kernel_input_checks(case):
    q, k, v = (torch.tensor(a) for a in _qkv(8, 8))
    pad = None
    if case == "d_head":
        q, k, v = (torch.tensor(a) for a in _qkv(8, 8, d=24))
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "kv_shape":
        k = k[:, :, :2]
    elif case == "pad_shape":
        pad = torch.tensor([1, 2, 3])
    elif case == "rank":
        q = q[0]
    with pytest.raises(ValueError):
        tattn.check_kernel_inputs(q, k, v, pad)
    tattn.check_kernel_inputs(*(torch.tensor(a) for a in _qkv(8, 8)), torch.tensor([1, 0]))


# ------------------------------------------------------------------ backward
#
# The port's gradients through `flash_attention` (on the CPU: the autograd
# Function over the plain versions of the three kernels) against jax.grad through
# the JAX package's Pallas kernels in interpret mode, on one loss of O (and
# of LSE with return_lse).  fp32 to 2e-5 relative to the gradient's largest
# element: both sides compute the same FA2 formulas in fp32 and differ in
# summation order only.  bf16 to 1e-2 of that: both compute in fp32 from the
# same bf16 inputs and round the gradients to bf16 (2^-8 relative), so they
# may differ by one bf16 step where the fp32 values straddle a rounding
# boundary.

_GRAD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _grad_loss_weights(t, t_kv, seed):
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal((B, t, H, D)).astype(np.float32),
            rng.standard_normal((B, H, t)).astype(np.float32))


def _jax_grads(q, k, v, pad, causal, dtype, with_lse, w_o, w_lse):
    import jax

    def loss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=causal, interpret=True, pad=pad,
                                    return_lse=with_lse)
        if not with_lse:
            return jnp.sum(jnp.sin(out.astype(jnp.float32)) * w_o)
        o, lse = out
        real = lse > tattn.NEG_INF / 2
        return (jnp.sum(jnp.sin(o.astype(jnp.float32)) * w_o)
                + jnp.sum(jnp.where(real, lse, 0.0) * w_lse))

    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _torch_grads(q, k, v, pad, causal, dtype, with_lse, w_o, w_lse):
    args = [torch.tensor(a).to(getattr(torch, dtype)).requires_grad_() for a in (q, k, v)]
    out = tattn.flash_attention(*args, causal=causal, pad=pad, return_lse=with_lse)
    if with_lse:
        o, lse = out
        real = lse > tattn.NEG_INF / 2
        loss = ((torch.sin(o.float()) * torch.tensor(w_o)).sum()
                + (torch.where(real, lse, torch.zeros_like(lse)) * torch.tensor(w_lse)).sum())
    else:
        loss = (torch.sin(out.float()) * torch.tensor(w_o)).sum()
    loss.backward()
    for a in args:
        assert a.grad.dtype == a.dtype
    return [a.grad.float().numpy() for a in args]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,t_kv,causal,padded,with_lse", [
    (64, 64, True, False, False),
    (64, 64, False, False, False),
    (64, 64, True, True, False),
    (64, 64, False, True, False),
    (64, 128, True, False, False),
    (128, 64, False, True, False),
    (64, 64, True, True, True),
    (64, 128, False, False, True),
])
def test_flash_grads_match_jax_interpret(dtype, t, t_kv, causal, padded, with_lse):
    q, k, v = _qkv(t, t_kv, seed=7 * t + t_kv + padded)
    pad = _pad(padded, t_kv)
    w_o, w_lse = _grad_loss_weights(t, t_kv, seed=t_kv)
    want = _jax_grads(q, k, v, None if pad is None else jnp.asarray(pad), causal,
                      jnp.dtype(dtype), with_lse, w_o, w_lse)
    got = _torch_grads(q, k, v, None if pad is None else torch.tensor(pad), causal, dtype,
                       with_lse, w_o, w_lse)
    for name, g, w in zip("qkv", got, want):
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= _GRAD_TOL[dtype], (name, err)


def test_lse_cotangent_moves_the_gradient():
    """With return_lse the loss on LSE changes dQ and dK (the dlse term of
    delta); with it dropped, the gradients are those of the O loss alone."""
    q, k, v = _qkv(64, 64, seed=5)
    w_o, w_lse = _grad_loss_weights(64, 64, seed=5)
    with_lse = _torch_grads(q, k, v, None, True, "float32", True, w_o, w_lse)
    without = _torch_grads(q, k, v, None, True, "float32", True, w_o, 0 * w_lse)
    plain = _torch_grads(q, k, v, None, True, "float32", False, w_o, w_lse)
    np.testing.assert_array_equal(without[0], plain[0])
    assert np.abs(with_lse[0] - plain[0]).max() > 1e-2 * np.abs(plain[0]).max()
    assert np.abs(with_lse[2] - plain[2]).max() == 0  # dV does not see dlse


@pytest.mark.parametrize("t,t_kv", [(37, 37), (37, 50), (50, 37), (1, 9)])
def test_flash_bwd_plain_matches_autograd_on_ragged_shapes(t, t_kv):
    """Any T and T_kv, with pad and causal: `_flash_bwd_plain` equals
    autograd through the dense reference on the rows that see a key, and
    gives fully masked rows no gradient."""
    q, k, v = (torch.tensor(a) for a in _qkv(t, t_kv, seed=t + t_kv))
    pad = torch.tensor([3, 0])
    scale = D ** -0.5
    o, lse = tattn._flash_attention_plain(q, k, v, causal=True, scale=scale, pad=pad)
    real = (lse > tattn.NEG_INF / 2).permute(0, 2, 1)[..., None].float()  # [B, T, H, 1]
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(t)) * real
    dq, dk, dv = tattn._flash_bwd_plain(q, k, v, o, lse, do, causal=True, scale=scale, pad=pad)
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    ref = tattn.reference_attention(qa, ka, va, causal=True, pad=pad)
    (ref * do).sum().backward()
    torch.testing.assert_close(dq, qa.grad, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(dk, ka.grad, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(dv, va.grad, atol=2e-5, rtol=2e-5)
    assert torch.all(dq * (1 - real) == 0)


def test_no_grad_path_saves_nothing():
    """Serving (no input requires grad) takes the plain forward, not the
    autograd Function; with grad the dispatcher goes through it on the CPU."""
    q, k, v = (torch.tensor(a) for a in _qkv(16, 16, seed=1))
    assert tattn.flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    out = tattn.attention(qg, k, v, causal=True)
    assert type(out.grad_fn).__name__.startswith("_FlashAttentionFn")
    with torch.no_grad():
        assert tattn.attention(qg, k, v, causal=True).grad_fn is None


def test_bwd_kernel_wrappers_on_cpu_run_the_plain_version():
    """flash_bwd_dq / flash_bwd_dkv take delta (not O): on CPU tensors they
    give _flash_bwd_plain's gradients and count no launch."""
    q, k, v = (torch.tensor(a) for a in _qkv(24, 40, seed=2))
    pad, scale = torch.tensor([4, 0]), D ** -0.5
    o, lse = tattn._flash_attention_plain(q, k, v, causal=True, scale=scale, pad=pad)
    do, dlse = torch.randn_like(o), torch.randn_like(lse)
    want = tattn._flash_bwd_plain(q, k, v, o, lse, do, causal=True, scale=scale, pad=pad, dlse=dlse)
    delta = tattn._bwd_delta(o, do, dlse)
    before = (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches)
    dq = tattn.flash_bwd_dq(q, k, v, do, lse, delta, causal=True, scale=scale, pad=pad)
    dk, dv = tattn.flash_bwd_dkv(q, k, v, do, lse, delta, causal=True, scale=scale, pad=pad)
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), want))
    assert (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches) == before
