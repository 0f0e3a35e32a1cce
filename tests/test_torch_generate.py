"""Parity of the port's model and generation path (cluster_anywhere_tpu_torch
.models) with the JAX package, on the CPU at a small size.

Both packages run on the same weights: the JAX params are initialised by
the JAX package and converted with from_jax_params.  Tolerances: fp32
logits to 1e-4 (two frameworks' fp32 matmuls and softmaxes differ in
summation order only); bf16 logits to 3e-2 (bf16 rounds at other points in
XLA's fused CPU code than in eager torch).  Greedy tokens are compared for
identity in fp32.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cluster_anywhere_tpu.models import generate as jgen
from cluster_anywhere_tpu.models import transformer as jtf
from cluster_anywhere_tpu_torch.models import generate as tgen
from cluster_anywhere_tpu_torch.models import transformer as ttf
from cluster_anywhere_tpu_torch.models.convert import from_jax_params, to_jax_params

WIDTHS = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _pair(dtype="float32", seed=0, **over):
    """(JAX cfg, JAX params, port cfg, port model) on the same weights."""
    widths = {**WIDTHS, **over}
    jcfg = jtf.TransformerConfig(**widths, dtype=jnp.dtype(dtype))
    jparams = jtf.init_params(jax.random.key(seed), jcfg)
    tcfg = ttf.TransformerConfig(**widths, dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg, device="cpu")


def _prompts(b=3, t=12, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (b, t)).astype(np.int32)
    lens = np.array([t, t - 5, 4][:b], np.int32)
    for i, n in enumerate(lens):
        ids[i, : t - n] = 0
    return ids, lens


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=tol)


def test_convert_roundtrip_and_shapes():
    jcfg, jparams, tcfg, model = _pair()
    back = to_jax_params(model)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == 3 + len(back["blocks"])
    for name, arr in back["blocks"].items():
        np.testing.assert_array_equal(arr, np.asarray(jparams["blocks"][name]))
    np.testing.assert_array_equal(back["embed"], np.asarray(jparams["embed"]))
    assert model.embed.dtype == torch.float32 and model.blocks[0].wq.shape == (32, 32)


def test_init_params_seeded_and_scaled():
    cfg = ttf.TransformerConfig(**WIDTHS, dtype="float32")
    a = ttf.init_params(cfg, 7, device="cpu")
    b = ttf.init_params(cfg, 7, device="cpu")
    c = ttf.init_params(cfg, 8, device="cpu")
    assert torch.equal(a.blocks[1].w_up, b.blocks[1].w_up)
    assert not torch.equal(a.blocks[1].w_up, c.blocks[1].w_up)
    assert torch.all(a.blocks[0].ln1 == 1)
    std = a.blocks[0].w_down.std().item()
    assert abs(std - WIDTHS["d_ff"] ** -0.5) < 0.3 * WIDTHS["d_ff"] ** -0.5


def test_expert_parallel_config_refused():
    """ep = 2 builds, and needs a mesh: the experts' all_to_all exchange
    runs over the mesh's ep ranks, so a forward without one raises (the
    test's name is from before the parallel stack was ported)."""
    assert ttf.TransformerConfig(**WIDTHS, n_experts=4).ep == 1
    cfg = ttf.TransformerConfig(**WIDTHS, n_experts=4, ep=2)
    model = ttf.init_params(cfg, 0, device="cpu")
    assert cfg.ep == 2 and model.blocks[0].w_in.shape[0] == 4
    with pytest.raises(ValueError, match="mesh required"):
        ttf.forward(model, torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.tensor(x).to(ttf.as_torch_dtype(dtype))
    _close(jtf._rms_norm(jx, jnp.asarray(w)), ttf._rms_norm(tx, torch.tensor(w)).float(), TOL[dtype])
    jcfg = jtf.TransformerConfig(**WIDTHS)
    tcfg = ttf.TransformerConfig(**WIDTHS)
    pos = np.maximum(np.arange(5)[None] - np.array([[0], [2]]), 0)
    jq, jk = jtf._rope(jx, jx * 2, jnp.asarray(pos), jcfg)
    tq, tk = ttf._rope(tx, tx * 2, torch.tensor(pos), tcfg)
    _close(jq, tq.float(), TOL[dtype])
    _close(jk, tk.float(), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padded", [False, True])
def test_prefill_and_decode_logits_match_jax(dtype, padded):
    jcfg, jparams, tcfg, model = _pair(dtype)
    ids, lens = _prompts()
    pad = (ids.shape[1] - lens).astype(np.int32) if padded else None
    t_max = ids.shape[1] + 4
    jl, jcache = jgen.prefill(jparams, jnp.asarray(ids), jcfg, t_max,
                              None if pad is None else jnp.asarray(pad))
    tpad = None if pad is None else torch.tensor(pad).long()
    tl, tcache = tgen.prefill(model, torch.tensor(ids).long(), tcfg, t_max, tpad)
    _close(jl, tl, TOL[dtype])
    tok = np.array([5, 9, 17], np.int32)
    pos = ids.shape[1]
    jl2, _ = jgen.decode_one(jparams, jcache, jnp.asarray(tok), jnp.int32(pos), jcfg,
                             None if pad is None else jnp.asarray(pad))
    tl2, _ = tgen.decode_one(model, tcache, torch.tensor(tok).long(), pos, tcfg, tpad)
    _close(jl2, tl2, TOL[dtype])


@pytest.mark.parametrize("with_lens", [False, True])
def test_generate_greedy_tokens_match_jax(with_lens):
    jcfg, jparams, tcfg, model = _pair()
    ids, lens = _prompts(seed=3)
    kw = dict(max_new_tokens=8)
    want = jgen.generate(jparams, jnp.asarray(ids), jax.random.key(1), cfg=jcfg,
                         prompt_lens=jnp.asarray(lens) if with_lens else None, **kw)
    got = tgen.generate(model, torch.tensor(ids), cfg=tcfg,
                        prompt_lens=torch.tensor(lens) if with_lens else None, **kw)
    assert got.dtype == torch.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_left_padding_invariance():
    _, _, tcfg, model = _pair()
    real = [7, 3, 11, 2, 9]
    alone = tgen.generate(model, torch.tensor([real]), cfg=tcfg, max_new_tokens=6)
    padded = tgen.generate(model, torch.tensor([[0, 0, 0] + real]), cfg=tcfg,
                           max_new_tokens=6, prompt_lens=torch.tensor([5]))
    assert torch.equal(alone, padded)


def test_stream_generate_matches_jax():
    jcfg, jparams, tcfg, model = _pair(seed=2)
    ids, lens = _prompts(seed=4)
    want = list(jgen.stream_generate(jparams, jnp.asarray(ids), jax.random.key(0), cfg=jcfg,
                                     max_new_tokens=6, prompt_lens=jnp.asarray(lens)))
    got = list(tgen.stream_generate(model, torch.tensor(ids), cfg=tcfg, max_new_tokens=6,
                                    prompt_lens=torch.tensor(lens)))
    assert len(got) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    full = tgen.generate(model, torch.tensor(ids), cfg=tcfg, max_new_tokens=6,
                         prompt_lens=torch.tensor(lens))
    np.testing.assert_array_equal(np.stack(got, 1), full.numpy())


def _fixed_logits():
    # distinct, well-separated values: no mask decision sits on a rounding tie
    rng = np.random.default_rng(5)
    base = rng.permutation(24).astype(np.float32) * 0.37 - 4.0
    return np.stack([base, base[::-1] * 1.3, np.roll(base, 7) * 0.5])


@pytest.mark.parametrize("top_p", [0.3, 0.75, 0.95, 1.0, 0.0])
def test_nucleus_mask_matches_jax(top_p):
    x = _fixed_logits()
    want = np.asarray(jgen._nucleus_mask(jnp.asarray(x), top_p))
    got = tgen._nucleus_mask(torch.tensor(x), top_p).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_array_equal(got[got > -1e29], want[want > -1e29])


@pytest.mark.parametrize("top_k", [1, 3, 10])
def test_top_k_mask_matches_jax(top_k):
    """Greedy with top-k at a vanishing temperature isolates the mask: the
    survivors of top-k are exactly the logits >= the k-th largest."""
    x = _fixed_logits()
    jtop = np.asarray(jax.lax.top_k(jnp.asarray(x), top_k)[0][..., -1:])
    ttop = torch.topk(torch.tensor(x), top_k, dim=-1).values[..., -1:].numpy()
    np.testing.assert_array_equal(ttop, jtop)
    # the port's sampler with top_k draws only among the k largest
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([tgen._sample(torch.tensor(x), gen, 5.0, top_k) for _ in range(200)])
    allowed = x >= jtop
    for row in range(x.shape[0]):
        assert allowed[row][draws[:, row].numpy()].all()


def test_temperature_sampling_distribution():
    """Gumbel-max draws follow softmax(logits / T) (checked in distribution:
    the port's generator gives other numbers than jax.random)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    gen = torch.Generator().manual_seed(123)
    n = 20000
    draws = tgen._sample(logits.expand(n, 4), gen, 0.8, 0).numpy()
    freq = np.bincount(draws, minlength=4) / n
    want = torch.softmax(logits[0] / 0.8, -1).numpy()
    assert np.abs(freq - want).max() < 0.015, (freq, want)
    assert tgen._sample(logits, gen, 0.0, 0).item() == 0  # greedy
