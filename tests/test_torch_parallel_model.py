"""Parity of the port's sharded model (cluster_anywhere_tpu_torch.models on a
parallel.make_mesh mesh: forward, make_loss_fn, make_train_step,
from_jax_params / to_jax_params, make_batch_sharding) with the JAX
package's make_train_step on the same mesh, on the CPU at
tests/test_model.py's TINY widths in fp32.

JAX runs in this process on 4 devices of its virtual CPU mesh; the port
runs in 4 gloo processes (torch_dist_pool, running torch_parallel_cases)
with device="cpu", on the same JAX-initialised weights carried across by
from_jax_params and the same numpy batch.  Configs A-E are __graft_entry__'s dry-run configs at 4
devices (A pp x tp, B sp x tp with ring and with Ulysses attention, C MoE
dp x ep, D MoE pp x ep, E fsdp x tp), plus dp x tp.
Tolerances: logits 2e-3 (tests/test_model.py's _logits_close); the loss
and every parameter's gradient (gathered from the shards) 1e-3 of the
tensor's largest element, and the loss after one AdamW step 1e-3.  For
the dense configs JAX's sharded step equals its one-device step, and the
port's sharded step is held to the port's one-device step too.  The MoE
configs route each ep group's tokens under its own capacity (JAX's
manual region), which the one-device step does not (ROADMAP Queue 3).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding as JNamedSharding

from cluster_anywhere_tpu.models import transformer as jtf
from cluster_anywhere_tpu.parallel import MeshSpec as JMeshSpec
from cluster_anywhere_tpu.parallel import make_mesh as jmake_mesh
from cluster_anywhere_tpu_torch.models import transformer as ttf
from cluster_anywhere_tpu_torch.models.convert import from_jax_params, to_jax_params
import torch_parallel_cases as cases
from torch_parallel_cases import LR, TINY
from torch_dist_pool import RankPool

WORLD = 4
CONFIGS = {
    "A-pp2-tp2": (dict(pp=2, num_microbatches=2), dict(pp=2, tp=2)),
    "B-ring-sp2-tp2": (dict(sp=2, attn_impl="ring"), dict(sp=2, tp=2)),
    "B-ulysses-sp2-tp2": (dict(sp=2, attn_impl="ulysses"), dict(sp=2, tp=2)),
    "C-dp2-ep2": (dict(n_experts=4, ep=2, attn_impl="dense"), dict(dp=2, ep=2)),
    "D-pp2-ep2": (dict(n_experts=4, ep=2, pp=2, num_microbatches=2, attn_impl="dense"),
                  dict(pp=2, ep=2)),
    "E-fsdp2-tp2": (dict(), dict(fsdp=2, tp=2)),
    "dp2-tp2": (dict(), dict(dp=2, tp=2)),
}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD, deadline=90)
    p.start()
    yield p
    p.close()


def _ids(b=8, t=16, seed=1):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, t + 1)).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_program(over, axes, ids):
    """JAX's config, mesh, params and batch on the 4-device mesh, and its
    step's loss, gradients and logits as one lowered program."""
    cfg = jtf.TransformerConfig(**TINY, **over, dtype=jnp.float32)
    mesh = jmake_mesh(JMeshSpec(**axes), devices=jax.devices()[:WORLD])
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    batch = {"ids": jnp.asarray(ids)}
    loss_fn = jtf.make_loss_fn(cfg, mesh)
    run = jax.jit(lambda p, b: (jax.value_and_grad(loss_fn)(p, b),
                                jtf.forward(p, b["ids"][:, :-1], cfg, mesh)))
    return (cfg, mesh, params, batch), run.lower(jtf.shard_params(params, cfg, mesh), batch)


@pytest.fixture(scope="module")
def jax_programs():
    """Every config's JAX program, lowered here and compiled in threads
    (XLA compiles outside the GIL) so that the compiles overlap; each test
    runs its own in this thread, one program at a time."""
    ids = _ids()
    with ThreadPoolExecutor(4) as pool:
        out = {}
        for name in sorted(CONFIGS):
            inputs, lowered = _jax_program(*CONFIGS[name], ids)
            out[name] = (inputs, pool.submit(lowered.compile))
        yield out


def _jax_reference(programs, name):
    """JAX's logits, loss, gradients and loss after one AdamW step on the
    4-device mesh, and its params."""
    (cfg, mesh, params, batch), compiled = programs[name]
    run = compiled.result()
    (loss1, grads), logits = run(jtf.shard_params(params, cfg, mesh), batch)
    opt = optax.adamw(LR, weight_decay=0.01)
    updates, _ = opt.update(grads, opt.init(params), params)
    (loss2, _), _ = run(jtf.shard_params(optax.apply_updates(params, updates), cfg, mesh), batch)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return tree, np.asarray(logits), float(loss1), jax.tree_util.tree_map(np.asarray, grads), \
        float(loss2)


def _port_single(over, tree, ids):
    """The port's one-device loss and gradients on the same weights."""
    cfg = ttf.TransformerConfig(**TINY, **{**over, "pp": 1, "sp": 1, "num_microbatches": 1},
                                dtype="float32")
    model = from_jax_params(tree, cfg, device="cpu")
    loss = ttf.make_loss_fn(cfg)(model, {"ids": ids})
    loss.backward()
    return loss.item(), to_jax_params(model, grads=True)


def _blocks_flat(tree, pp):
    out = dict(tree)
    if pp > 1:
        out["blocks"] = {k: v.reshape(-1, *v.shape[2:]) for k, v in tree["blocks"].items()}
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_step_matches_jax(pool, jax_programs, name):
    over, axes = CONFIGS[name]
    ids = _ids()
    tree, want_logits, want_loss, want_grads, want_loss2 = _jax_reference(jax_programs, name)
    got = pool.run(cases.case_model, over, axes, tree, ids)
    loss1, loss2, logits, grads = got[0]
    assert all(r[:2] == (loss1, loss2) for r in got), [r[:2] for r in got]
    np.testing.assert_allclose(logits, want_logits, rtol=2e-3, atol=2e-3)
    assert abs(loss1 - want_loss) <= 1e-3 * abs(want_loss)
    assert abs(loss2 - want_loss2) <= 1e-3 * abs(want_loss2)
    pp = over.get("pp", 1)
    g, w = _blocks_flat(grads, pp), _blocks_flat(want_grads, pp)
    for k in ("embed", "ln_f", "lm_head"):
        assert _rel(g[k], w[k]) <= 1e-3, (k, _rel(g[k], w[k]))
    for k in w["blocks"]:
        assert _rel(g["blocks"][k], w["blocks"][k]) <= 1e-3, (k, _rel(g["blocks"][k],
                                                                       w["blocks"][k]))
    if not over.get("n_experts"):
        single_loss, single = _port_single(over, tree, ids)
        assert abs(loss1 - single_loss) <= 1e-3 * abs(single_loss)
        for k in ("embed", "ln_f", "lm_head"):
            assert _rel(g[k], single[k]) <= 1e-3, k
        for k in single["blocks"]:
            assert _rel(g["blocks"][k], single["blocks"][k]) <= 1e-3, k


def test_iter_torch_batches_places_each_ranks_block(pool):
    from cluster_anywhere_tpu.parallel import MeshSpec as JSpec

    rows = _ids(b=8, t=15, seed=2).astype(np.int64)
    got = pool.run(cases.case_batches, rows)
    jcfg = jtf.TransformerConfig(**TINY, sp=2, attn_impl="dense", dtype=jnp.float32)
    jmesh = jmake_mesh(JSpec(dp=2, sp=2), devices=jax.devices()[:WORLD])
    sharding = jtf.make_batch_sharding(jcfg, jmesh)
    assert isinstance(sharding, JNamedSharding)
    for i in range(2):
        arr = jax.device_put(rows[4 * i:4 * (i + 1)], sharding)
        by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for rank in range(WORLD):
            np.testing.assert_array_equal(got[rank][0][i], by_device[jmesh.devices.flat[rank]])
            placed, whole = got[rank][1][i]
            assert placed == whole
