"""Parity of the port's mixture-of-experts FFN (cluster_anywhere_tpu_torch
.parallel.moe, the MoE branches of models.transformer and models.generate)
with the JAX package, on the CPU at tests/test_model.py's MoE widths.

Both packages run on the same numpy inputs from a seed, and the models on
the same JAX-initialised weights (converted with from_jax_params).  The
JAX training forward runs moe_ffn under shard_map, so it gets a one-device
mesh with ep = 1 and runs under jit (eagerly, shard_map refuses the
mesh's automatic axes); its attention is the dense reference on the CPU.

Tolerances:
- fp32: routes and dropped tokens exactly equal; outputs, losses and
  gradients to 2e-5 of each tensor's largest element (summation order
  only, as tests/test_torch_train.py).
- bf16: the router's probabilities are near-uniform at the 0.02 init
  scale, and in bf16 5 of moe_ffn's 96 tokens here have two equal top
  probabilities.  The two packages round the softmax at other points
  (XLA's fused CPU code against eager torch), so a route flips now and
  then, and a flip moves that token's whole FFN output and the queue
  positions of the tokens behind it.  So (the tests print what is
  quoted):
  - moe_ffn: at least 95% of routes agree (98.96% on the inputs here);
    where a token's route and its keep flag agree, its output is held to
    3e-2 of the largest output (bf16's 2^-8 relative rounding through two
    products), and the aux loss to 3e-2 relative.
  - the whole step: the loss to 1e-2 relative (3.1e-3).  Against its own
    fp32 step, the port's bf16 step flips 3 and 4 of the 64 tokens in its
    two layers, which moves its gradients by 8-37% in relative L2; with
    the routes pinned they lie 0.5-2% from fp32.  So the port's bf16
    gradients are held to JAX's at 0.5 in relative L2 per parameter
    (7-34%; a dropped or doubled term reads about 1), and, with each
    token's route pinned to the one the fp32 step takes, to the port's
    fp32 gradients at the dense bf16 step's 5e-2
    (tests/test_torch_train.py), which the fp32 test ties to JAX.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from cluster_anywhere_tpu.llm import continuous as jcont
from cluster_anywhere_tpu.models import generate as jgen
from cluster_anywhere_tpu.models import transformer as jtf
from cluster_anywhere_tpu.parallel import MeshSpec, make_mesh
from cluster_anywhere_tpu.parallel import moe as jmoe
from cluster_anywhere_tpu.parallel.compat import shard_map
from cluster_anywhere_tpu_torch import llm
from cluster_anywhere_tpu_torch.llm import continuous as tcont
from cluster_anywhere_tpu_torch.llm import processor as tproc
from cluster_anywhere_tpu_torch.models import generate as tgen
from cluster_anywhere_tpu_torch.models import transformer as ttf
from cluster_anywhere_tpu_torch.models.convert import from_jax_params, to_jax_params
from cluster_anywhere_tpu_torch.parallel import moe as tmoe

MOE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
           max_seq_len=64, n_experts=4)
FP32_TOL = 2e-5
ROUTE_AGREE_BF16 = 0.95
OUT_TOL_BF16 = 3e-2
STEP_TOL_BF16 = dict(loss_rel=1e-2, grad_rel_l2=0.5, pinned_grad_rel_l2=5e-2)
EXPERT_KEYS = ("router", "w_in", "w_out")


def _mesh():
    return make_mesh(MeshSpec(ep=1), devices=jax.devices()[:1])


def _jax_moe_ffn(x, router, w_in, w_out, capacity_factor=1.25):
    """The JAX moe_ffn at ep = 1: under shard_map over a one-device mesh."""
    fn = shard_map(lambda *a: tuple(jmoe.moe_ffn(*a, capacity_factor=capacity_factor)), _mesh(),
                   (P(),) * 4, (P(), P()))
    return jax.jit(fn)(x, router, w_in, w_out)


def _expert_params(seed=0, e=32, f=64, x=4):
    """init_moe_params of the JAX package, as numpy."""
    p = jmoe.init_moe_params(jax.random.key(seed), e, f, x)
    return [np.array(p[k]) for k in EXPERT_KEYS]


def _pair(dtype="float32", seed=0, **over):
    """(JAX cfg, JAX params, port cfg, port model) on the same weights."""
    widths = {**MOE, **over}
    jcfg = jtf.TransformerConfig(**widths, dtype=jnp.dtype(dtype))
    jparams = jtf.init_params(jax.random.key(seed), jcfg)
    tcfg = ttf.TransformerConfig(**widths, dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg, device="cpu")


def _max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _both_ffns(x, params, dtype, capacity_factor=1.25):
    """(JAX out, JAX aux, port out, port aux, JAX routes, port routes) on
    the same inputs in `dtype`; the routes from each package's router."""
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jd), [jnp.asarray(w, jd) for w in params]
    tx, tw = torch.tensor(x).to(td), [torch.tensor(w).to(td) for w in params]
    jout, jaux = _jax_moe_ffn(jx, *jw, capacity_factor=capacity_factor)
    tout, taux = tmoe.moe_ffn(tx, *tw, capacity_factor=capacity_factor)
    jroute = np.asarray(jnp.argmax(jax.nn.softmax(jx @ jw[0], axis=-1), axis=-1))
    troute = tmoe.top1_route(tx @ tw[0])[1].numpy()
    return (np.asarray(jout, np.float32), float(jaux), tout.float().numpy(), taux.item(),
            jroute, troute)


def test_moe_ffn_fp32_matches_jax_routes_exactly():
    x = np.random.default_rng(0).standard_normal((96, 32)).astype(np.float32)
    jout, jaux, tout, taux, jroute, troute = _both_ffns(x, _expert_params(), "float32")
    np.testing.assert_array_equal(troute, jroute)
    np.testing.assert_array_equal(np.abs(tout).sum(1) == 0, np.abs(jout).sum(1) == 0)
    assert _max_rel(tout, jout) <= FP32_TOL
    assert abs(taux - jaux) <= FP32_TOL * abs(jaux)


def test_moe_ffn_bf16_route_agreement():
    """See the module docstring: the share of agreeing routes, and the
    outputs of tokens routed and kept alike."""
    x = np.random.default_rng(0).standard_normal((96, 32)).astype(np.float32)
    jout, jaux, tout, taux, jroute, troute = _both_ffns(x, _expert_params(), "bfloat16")
    agree = (jroute == troute).mean()
    probs = np.sort(tmoe.top1_route(torch.tensor(x).bfloat16()
                                    @ torch.tensor(_expert_params()[0]).bfloat16())[0].float().numpy())
    print(f"bf16 moe_ffn routes agreeing: {agree:.4f}; tokens whose top two bf16 probs are "
          f"equal: {(probs[:, -1] == probs[:, -2]).mean():.4f}")
    assert agree >= ROUTE_AGREE_BF16
    same = (jroute == troute) & ((np.abs(jout).sum(1) == 0) == (np.abs(tout).sum(1) == 0))
    assert same.mean() >= ROUTE_AGREE_BF16
    scale = np.abs(jout).max()
    assert np.abs(tout[same] - jout[same]).max() <= OUT_TOL_BF16 * scale
    assert abs(taux - jaux) <= OUT_TOL_BF16 * abs(jaux)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_ffn_capacity_overflow_drops_the_same_tokens(capacity_factor):
    """A planted router sends most tokens to expert 0: tokens past its
    capacity are dropped (zero delta), the same ones as in JAX, and every
    expert keeps at most `capacity` tokens in flat order."""
    rng = np.random.default_rng(1)
    n, e = 64, 32
    x = rng.standard_normal((n, e)).astype(np.float32)
    x[:, 0] = 3.0 + rng.random(n).astype(np.float32)
    router, w_in, w_out = _expert_params(seed=1)
    router[0] = [2.0, 0.0, 0.0, 0.0]
    jout, jaux, tout, taux, jroute, troute = _both_ffns(x, [router, w_in, w_out], "float32",
                                                        capacity_factor)
    np.testing.assert_array_equal(troute, jroute)
    dropped = np.abs(tout).sum(1) == 0
    np.testing.assert_array_equal(dropped, np.abs(jout).sum(1) == 0)
    capacity = int(max(1, (n * capacity_factor) // 4 + 1))
    for k in range(4):
        mine = np.flatnonzero(troute == k)
        kept = mine[~dropped[mine]]
        np.testing.assert_array_equal(kept, mine[:capacity])  # the first `capacity` in flat order
    counts = np.bincount(troute, minlength=4)
    assert dropped.sum() == np.maximum(counts - capacity, 0).sum() > 0
    assert _max_rel(tout, jout) <= FP32_TOL
    assert abs(taux - jaux) <= FP32_TOL * abs(jaux)


def test_moe_ffn_grads_reach_the_router():
    """fp32 gradients of sum(out * g) + aux through both packages: equal to
    2e-5, the router's included (through the gate and the aux loss)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((48, 32)).astype(np.float32)
    g = rng.standard_normal((48, 32)).astype(np.float32)
    params = _expert_params(seed=2)

    def jloss(x, *w):
        out, aux = _jax_moe_ffn(x, *w)
        return jnp.sum(out * g) + aux

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(jnp.asarray(x), *map(jnp.asarray, params))
    leaves = [torch.tensor(a, requires_grad=True) for a in [x, *params]]
    out, aux = tmoe.moe_ffn(*leaves)
    ((out * torch.tensor(g)).sum() + aux).backward()
    for name, leaf, w in zip(("x",) + EXPERT_KEYS, leaves, want):
        assert leaf.grad is not None and bool(leaf.grad.abs().sum() > 0), name
        assert _max_rel(leaf.grad.numpy(), w) <= FP32_TOL, name
    # the aux loss alone reaches the router too
    r = torch.tensor(params[0], requires_grad=True)
    w_in, w_out = torch.tensor(params[1]), torch.tensor(params[2])
    tmoe.moe_ffn(torch.tensor(x), r, w_in, w_out).aux_loss.backward()
    assert r.grad.abs().sum() > 0


@pytest.mark.parametrize("t", [10, 64, 150])
def test_moe_infer_matches_jax(t):
    """Serving's all-experts FFN (nothing dropped), one pass at T <= 64 and
    chunked by 64 tokens beyond: fp32 to 2e-5 (a flipped route would move
    a token's output by O(1))."""
    jcfg, jparams, tcfg, model = _pair()
    y = np.random.default_rng(3).standard_normal((2, t, 32)).astype(np.float32)
    jbp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])
    want = np.asarray(jax.jit(lambda bp, y: jgen._moe_infer(bp, y, jcfg))(jbp, jnp.asarray(y)))
    got = tgen._moe_infer(model.compute_weights()["blocks"][0], torch.tensor(y), tcfg).numpy()
    assert got.shape == (2, t, 32)
    assert _max_rel(got, want) <= FP32_TOL
    assert (np.abs(got).sum(-1) > 0).all()  # no token dropped


@pytest.mark.parametrize("with_lens", [False, True])
def test_moe_generate_greedy_tokens_match_jax(with_lens):
    jcfg, jparams, tcfg, model = _pair()
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 64, (3, 12)).astype(np.int32)
    lens = np.array([12, 7, 4], np.int32)
    for i, n in enumerate(lens):
        ids[i, : 12 - n] = 0
    kw = dict(max_new_tokens=8)
    want = jgen.generate(jparams, jnp.asarray(ids), jax.random.key(1), cfg=jcfg,
                         prompt_lens=jnp.asarray(lens) if with_lens else None, **kw)
    got = tgen.generate(model, torch.tensor(ids), cfg=tcfg,
                        prompt_lens=torch.tensor(lens) if with_lens else None, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_continuous_batcher_matches_generate_and_jax():
    """As tests/test_llm.py's MoE test: the batcher over an MoE model gives
    generate()'s tokens, and the JAX batcher's."""
    jcfg, jparams, tcfg, model = _pair()
    want = tgen.generate(model, torch.tensor([[1, 5, 9]]), cfg=tcfg, max_new_tokens=6)[0].tolist()
    cb = tcont.ContinuousBatcher(model, tcfg, slots=2, t_max=32, prefill_buckets=(8,))
    req = cb.submit([1, 5, 9], max_new_tokens=6)
    other = cb.submit([2, 3, 4, 7], max_new_tokens=4)
    cb.pump()
    assert req.done and req.out_tokens == want
    jcb = jcont.ContinuousBatcher(jparams, jcfg, slots=2, t_max=32, prefill_buckets=(8,))
    jreq = jcb.submit([1, 5, 9], max_new_tokens=6)
    jother = jcb.submit([2, 3, 4, 7], max_new_tokens=4)
    jcb.pump()
    assert (req.out_tokens, other.out_tokens) == (jreq.out_tokens, jother.out_tokens)


def test_moe_continuous_llm_server_serves():
    """ContinuousLLMServer with n_experts in config_overrides answers, and
    as the static worker does."""
    cfg = llm.ProcessorConfig(
        model=llm.ModelSpec(preset="tiny", config_overrides={"dtype": "float32", "n_experts": 4}),
        max_prompt_len=16, max_new_tokens=5)
    srv = llm.ContinuousLLMServer(cfg, slots=2, device="cpu")
    try:
        assert srv.cb.cfg.n_experts == 4
        out = srv({"prompt": "hello there"})
        assert out["num_generated_tokens"] == 5
        static = tproc._InferenceWorker(cfg, device="cpu")(
            {"prompt": np.asarray(["hello there"], dtype=object)})
        assert out["generated_text"] == str(static["generated_text"][0])
        srv.check_health()
    finally:
        srv.close()


def _port_grads(model):
    out = {n: getattr(model, n).grad.numpy() for n in ("embed", "ln_f", "lm_head")}
    for n in model.block_keys:
        out[n] = np.stack([getattr(blk, n).grad.numpy() for blk in model.blocks])
    return out


def _jax_leaves(tree):
    out = {n: np.asarray(tree[n]) for n in ("embed", "ln_f", "lm_head")}
    out.update({n: np.asarray(a) for n, a in tree["blocks"].items()})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_loss_and_grads_match_jax(dtype):
    """The whole MoE training loss (cross-entropy + 0.01 x the summed
    load-balance loss) and every gradient, router and experts included;
    tolerances in the module docstring."""
    jcfg, jparams, tcfg, model = _pair(dtype, seed=2)
    ids = np.random.default_rng(5).integers(0, 64, (4, 17)).astype(np.int32)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jtf.make_loss_fn(jcfg, _mesh())))(
        jparams, {"ids": jnp.asarray(ids)})
    loss = ttf.make_loss_fn(tcfg)(model, {"ids": ids})
    loss.backward()
    got, want = _port_grads(model), _jax_leaves(want_grads)
    assert set(got) == set(want) and {"router", "w_in", "w_out"} <= set(got)
    loss_rel = abs(loss.item() - float(want_loss)) / abs(float(want_loss))
    for name in want:
        if dtype == "float32":
            assert _max_rel(got[name], want[name]) <= FP32_TOL, name
        else:
            err = np.linalg.norm(got[name] - want[name]) / np.linalg.norm(want[name])
            print(f"bf16 step, port vs JAX: {name} gradient relative L2 {err:.4f}")
            assert err <= STEP_TOL_BF16["grad_rel_l2"], (name, err)
    print(f"{dtype} step, port vs JAX: loss relative {loss_rel:.3g}")
    assert loss_rel <= (FP32_TOL if dtype == "float32" else STEP_TOL_BF16["loss_rel"])


def test_moe_bf16_step_with_pinned_routes_matches_fp32(monkeypatch):
    """The port's bf16 step, each layer's routes pinned to those its fp32
    step takes, against its fp32 gradients (module docstring).  Prints
    how many routes the bf16 step flips on its own, and how far its
    gradients lie from fp32 with and without the pin."""
    ids = np.random.default_rng(5).integers(0, 64, (4, 17)).astype(np.int32)
    logs, grads = {"float32": [], "bfloat16": []}, {}
    real_route = tmoe.top1_route

    def recording(log):
        def route(logits):
            probs, idx, gate = real_route(logits)
            log.append(idx)
            return probs, idx, gate
        return route

    def pinned(logits):
        probs = torch.softmax(logits, dim=-1)
        idx = fp32_routes.pop(0)
        return probs, idx, probs.gather(-1, idx[:, None])[:, 0]

    for run, dtype, route in (("float32", "float32", recording(logs["float32"])),
                              ("bfloat16", "bfloat16", recording(logs["bfloat16"])),
                              ("pinned", "bfloat16", pinned)):
        fp32_routes = list(logs["float32"])
        monkeypatch.setattr(tmoe, "top1_route", route)
        _, _, tcfg, model = _pair(dtype, seed=2)
        ttf.make_loss_fn(tcfg)(model, {"ids": ids}).backward()
        grads[run] = _port_grads(model)
    assert not fp32_routes  # every pinned route was used
    flips = [int((a != b).sum()) for a, b in zip(logs["float32"], logs["bfloat16"])]
    print(f"bf16 step's routes differing from the fp32 step's, per layer: {flips} of "
          f"{logs['float32'][0].numel()}")
    for name, want in grads["float32"].items():
        free, err = (np.linalg.norm(grads[run][name] - want) / np.linalg.norm(want)
                     for run in ("bfloat16", "pinned"))
        print(f"bf16 vs fp32 gradient relative L2, {name}: {free:.4f} unpinned, {err:.4f} pinned")
        assert err <= STEP_TOL_BF16["pinned_grad_rel_l2"], (name, err)


def test_moe_forward_aux_matches_jax():
    """forward(return_aux=True): the load-balance loss summed over layers."""
    jcfg, jparams, tcfg, model = _pair(seed=3)
    ids = np.random.default_rng(6).integers(0, 64, (2, 16)).astype(np.int32)
    jlogits, jaux = jax.jit(lambda p, i: jtf.forward(p, i, jcfg, _mesh(), return_aux=True))(
        jparams, jnp.asarray(ids))
    logits, aux = ttf.forward(model, torch.tensor(ids).long(), return_aux=True)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert abs(aux.item() - float(jaux)) <= FP32_TOL * abs(float(jaux))
    assert _max_rel(logits.detach(), jlogits) <= FP32_TOL
    dense = ttf.TransformerConfig(**{**MOE, "n_experts": 0}, dtype="float32")
    _, zero = ttf.forward(ttf.init_params(dense, 0, device="cpu"), torch.tensor(ids).long(),
                          return_aux=True)
    assert zero.item() == 0.0


def test_moe_train_step_learns_and_moves_the_router():
    """make_train_step over an MoE config: the loss falls on a fixed batch
    and the router moves (tests/test_model.py's MoE test, ep = 1)."""
    cfg = ttf.TransformerConfig(**MOE, dtype="float32")
    step, init_state = ttf.make_train_step(cfg, learning_rate=1e-2, device="cpu")
    model, opt = init_state(0)
    router = model.blocks[0].router.detach().clone()
    ids = np.random.default_rng(0).integers(0, 64, (8, 33))
    losses = [step(model, opt, {"ids": ids})[2].item() for _ in range(8)]
    assert losses[-1] < losses[0], losses
    assert not torch.allclose(router, model.blocks[0].router)


def test_moe_params_roundtrip_through_jax_tree():
    jcfg, jparams, tcfg, model = _pair()
    back = to_jax_params(model)
    assert set(back["blocks"]) == set(jparams["blocks"])
    for name, arr in back["blocks"].items():
        np.testing.assert_array_equal(arr, np.asarray(jparams["blocks"][name]))
    assert model.blocks[0].w_in.shape == (4, 32, 64) and model.blocks[0].router.shape == (32, 4)
    again = to_jax_params(from_jax_params(back, tcfg, device="cpu"))
    for name in back["blocks"]:
        np.testing.assert_array_equal(again["blocks"][name], back["blocks"][name])
    dense = ttf.TransformerConfig(**{**MOE, "n_experts": 0})
    with pytest.raises(ValueError, match="do not fit"):
        from_jax_params(back, dense, device="cpu")


def test_moe_init_params_scales():
    """init_params draws the MoE weights at init_moe_params' scales:
    router 0.02, w_in sqrt(2 / d_model), w_out sqrt(2 / d_ff)."""
    cfg = ttf.TransformerConfig(**{**MOE, "d_model": 64, "d_ff": 256}, dtype="float32")
    model = ttf.init_params(cfg, 0, device="cpu")
    blk = model.blocks[1]
    assert not hasattr(blk, "w_gate") and model.block_keys == tuple(ttf.block_shapes(cfg))
    for name, want in (("router", 0.02), ("w_in", (2 / 64) ** 0.5), ("w_out", (2 / 256) ** 0.5)):
        std = getattr(blk, name).std().item()
        assert abs(std - want) < 0.1 * want, (name, std, want)
    assert torch.equal(ttf.init_params(cfg, 0, device="cpu").blocks[1].w_in, blk.w_in)
