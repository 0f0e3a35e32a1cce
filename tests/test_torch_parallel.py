"""Parity of the port's parallel stack (cluster_anywhere_tpu_torch.parallel:
mesh, sharding, the tensor-plane collectives, merge_attention, ring and
Ulysses attention, the pipeline and MoE at ep = 2) with the JAX package,
on the CPU.

JAX runs in this process on its virtual CPU mesh (4 of the 8 devices
tests/conftest.py makes), under shard_map; the port runs in 4 gloo
processes with device="cpu", spawned once for the file (torch_dist_pool),
rank r standing where JAX's device r stands; what the ranks run is in
torch_parallel_cases.  Inputs are numpy from a seed.
Tolerances: collectives exact to 1e-6 (fp32 adds in another order); ring
attention values 2e-4 and gradients 1e-3, Ulysses 2e-4, the pipeline 1e-5
and its gradients 1e-4 (tests/test_parallel.py's); moe_ffn 2e-5 of the
largest output (tests/test_torch_moe.py's fp32 bound).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as JP

from cluster_anywhere_tpu.parallel import MeshSpec as JMeshSpec
from cluster_anywhere_tpu.parallel import collectives as jcol
from cluster_anywhere_tpu.parallel import make_mesh as jmake_mesh
from cluster_anywhere_tpu.parallel import moe as jmoe
from cluster_anywhere_tpu.parallel import pipeline as jpipe
from cluster_anywhere_tpu.parallel import sharding as jshard
from cluster_anywhere_tpu.parallel.compat import shard_map
from cluster_anywhere_tpu.parallel.ring_attention import ring_attention_sharded as jring
from cluster_anywhere_tpu.parallel.ulysses import ulysses_attention_sharded as julysses
from cluster_anywhere_tpu_torch.parallel import mesh as tmesh
from cluster_anywhere_tpu_torch.parallel import sharding as tshard
import torch_parallel_cases as cases
from torch_dist_pool import RankPool

WORLD = 4
# the ops packages export a function named `attention` over the module's name
jattn = importlib.import_module("cluster_anywhere_tpu.ops.attention")
tattn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")


@pytest.fixture(scope="module")
def pool():
    p = RankPool(WORLD)
    p.start()
    yield p
    p.close()


def _jmesh(**axes):
    return jmake_mesh(JMeshSpec(**axes), devices=jax.devices()[:WORLD])


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------- mesh, specs


def test_mesh_spec_and_auto_spec():
    for kw in ({}, {"tp": 2, "pp": 2}, {"sp": 4}, {"ep": 2, "fsdp": 2}):
        j, t = JMeshSpec(**kw), tmesh.MeshSpec(**kw)
        assert (t.size, t.axis_sizes(), str(t)) == (j.size, j.axis_sizes(), str(j))
    from cluster_anywhere_tpu.parallel import auto_spec as jauto

    assert tmesh.auto_spec(8, tp=2, pp=2) == tmesh.MeshSpec(**vars(jauto(8, tp=2, pp=2)))
    with pytest.raises(ValueError):
        tmesh.auto_spec(6, tp=4)
    assert tmesh.AXES == ("dp", "fsdp", "pp", "tp", "sp", "ep")


def test_make_mesh_over_the_world(pool):
    out = pool.run(cases.case_make_mesh)
    for rank, (names, shape, coord, tp, pp, size_error, backend_error) in enumerate(out):
        assert names == tmesh.AXES and shape == (1, 1, 2, 2, 1, 1)
        # dp outermost, row-major: rank r sits where JAX's device r does
        assert list(coord) == list(np.unravel_index(rank, shape))
        assert (pp, tp) == divmod(rank, 2)
        assert "needs 2 ranks" in size_error
        assert "runs 'gloo'" in backend_error


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from cluster_anywhere_tpu_torch.entry import dryrun_multichip

    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(tmesh.MeshSpec())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(WORLD)


@pytest.mark.parametrize("logical", [
    ("batch", "seq", "embed"), ("embed", "heads"), ("vocab", "embed"), ("layers", "experts", None),
    ("fsdp_shard", "mlp"), ("embed",), (None, None),
])
def test_logical_to_spec_and_placements(logical):
    from torch.distributed.tensor import Replicate, Shard

    want = jshard.logical_to_spec(logical)
    got = tshard.logical_to_spec(logical)
    assert tuple(got) == tuple(want)
    place = tshard.placements(got)
    for axis, p in zip(tmesh.AXES, place):
        dims = [d for d, e in enumerate(got) if axis in tshard.spec_axes(e)]
        assert p == (Shard(dims[0]) if dims else Replicate())
    assert tshard.DEFAULT_RULES == jshard.DEFAULT_RULES


def test_placements_refuse_out_of_order_axes():
    with pytest.raises(ValueError, match="mesh order"):
        tshard.placements(tshard.P(("fsdp", "dp")))


def test_shard_pytree_and_constraint_place_each_ranks_block(pool):
    rng = _rng(2)
    tree = {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "b": [rng.standard_normal(3).astype(np.float32),
                  rng.standard_normal(4).astype(np.float32)]}
    for placed, local, moved, want_moved, named, whole in pool.run(cases.case_shard_pytree, tree):
        for a, b in zip(placed, local):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(moved, want_moved)
        np.testing.assert_array_equal(whole, tree["w"])
        assert named == (("dp", "fsdp"), "tp")


_BOXES = [
    ("index_box", ((slice(None), slice(2, 4)), (3, 8))),
    ("index_box", ((slice(1, 2),), (5,))),
    ("box_shape", ([[0, 3], [2, 4]],)),
    ("box_volume", ([[0, 3], [2, 4]],)),
    ("box_volume", ([],)),
    ("boxes_cover", ([[[0, 2]], [[2, 4]]], (4,))),
    ("boxes_cover", ([[[0, 3]], [[2, 4]]], (4,))),
    ("boxes_cover", ([[[0, 2]], [[3, 4]]], (4,))),
    ("boxes_cover", ([[[0, 2], [0, 2]], [[2, 4], [0, 2]], [[0, 4], [2, 3]]], (4, 3))),
    ("boxes_cover", ([[[0, 5]]], (4,))),
]


@pytest.mark.parametrize("fn, args", _BOXES)
def test_box_helpers_match_jax(fn, args):
    assert getattr(tshard, fn)(*args) == getattr(jshard, fn)(*args)


def test_extract_region_matches_jax():
    full = np.arange(24.0).reshape(4, 6)
    chunks = [([[0, 2], [0, 3]], full[:2, :3]), ([[0, 2], [3, 6]], full[:2, 3:]),
              ([[2, 4], [0, 6]], full[2:])]
    for box in ([[1, 3], [2, 5]], [[0, 4], [0, 6]], [[3, 4], [5, 6]], [[1, 1], [0, 6]]):
        got, want = tshard.extract_region(box, chunks), jshard.extract_region(box, chunks)
        assert got.shape == want.shape and np.array_equal(got, want)
    assert tshard.extract_region([], [([], np.float32(3))]) == 3
    with pytest.raises(ValueError):
        tshard.extract_region([[0, 1], [0, 1]], [([[2, 4], [0, 6]], full[2:])])


# ------------------------------------------------------------- collectives

# (local shape, JAX op) of each collective; the port's ops are
# torch_parallel_cases.PORT_OPS.  Both ops take (x, axis_name).
_OPS = {
    "allreduce": ((3, 5), lambda x, a: jcol.xla.allreduce(x, a)),
    "allgather-tiled-0": ((2, 3), lambda x, a: jcol.xla.allgather(x, a, axis=0)),
    "allgather-untiled-1": ((2, 3), lambda x, a: jcol.xla.allgather(x, a, axis=1, tiled=False)),
    "reducescatter-tiled-1": ((3, 8), lambda x, a: jcol.xla.reducescatter(x, a, axis=1)),
    "reducescatter-untiled-0": ((None, 3),
                                lambda x, a: jcol.xla.reducescatter(x, a, axis=0, tiled=False)),
    "broadcast": ((4,), lambda x, a: jcol.xla.broadcast(x, a, src_index=1)),
    "permute-ring": ((2, 2), lambda x, a: jcol.xla.permute(x, a, _jring(a))),
    "permute-partial": ((3,), lambda x, a: jcol.xla.permute(x, a, [(0, 1)])),
    "all_to_all-tiled": ((3, 8), lambda x, a: jcol.xla.all_to_all(x, a, 1, 0)),
    # moe_ffn's layout; JAX's own transpose of an untiled all_to_all with
    # split_axis != concat_axis fails on its cotangent's shape
    "all_to_all-untiled": ((None, 2, 3), lambda x, a: jcol.xla.all_to_all(x, a, 0, 0, tiled=False)),
}


def _jring(a):
    n = jax.lax.psum(1, a)
    return [(i, (i + 1) % n) for i in range(n)]


def _local_shape(op, n):
    shape = _OPS[op][0]
    return tuple(n if s is None else s for s in shape)


@pytest.mark.parametrize("axes_key", sorted(cases.COLLECTIVE_AXES))
@pytest.mark.parametrize("op", sorted(_OPS))
def test_collective_and_its_gradient_match_jax(pool, op, axes_key):
    axes, a = cases.COLLECTIVE_AXES[axes_key]
    n = axes[a]
    xs = _rng(3).standard_normal((WORLD,) + _local_shape(op, n)).astype(np.float32)
    jm = _jmesh(**axes)
    spec = JP(tuple(k for k in ("dp", "tp") if k in axes))

    def run(x):
        f = shard_map(lambda xl: _OPS[op][1](xl[0], a)[None], mesh=jm, in_specs=spec,
                      out_specs=spec, check_vma=False)
        return f(x)

    want = np.asarray(jax.jit(run)(jnp.asarray(xs)))
    ws = _rng(4).standard_normal(want.shape).astype(np.float32)
    want_grad = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(run(x) * ws)))(jnp.asarray(xs)))
    got = pool.run(cases.case_collective, op, axes_key, xs, ws)
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][0], want[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[r][1], want_grad[r], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["int8", "bf16", None])
def test_quantized_psum_matches_jax(pool, mode):
    # 1000 elements in blocks of 128: a last partial block, and a row of
    # exact halves that int8 rounds half to even
    xs = _rng(5).standard_normal((WORLD, 1000)).astype(np.float32)
    xs[:, :128] = np.arange(128, dtype=np.float32) / 2 - 32
    jm = _jmesh(dp=WORLD)
    f = shard_map(lambda xl: jcol.quantized_psum(xl[0], "dp", mode, 128)[None], mesh=jm,
                  in_specs=JP("dp"), out_specs=JP("dp"), check_vma=False)
    want = np.asarray(jax.jit(f)(jnp.asarray(xs)))
    got = pool.run(cases.case_quantized, xs, mode, 128)
    for r in range(WORLD):
        if mode == "bf16":
            # each package rounds its partial sums to bf16 (2^-9 of their
            # size an add, 3 adds) in its own order
            assert np.all(np.abs(got[r] - want[r]) <= 2.0 ** -6 * np.abs(xs).sum(0))
        else:
            np.testing.assert_allclose(got[r], want[r], rtol=1e-6, atol=1e-6)
    if mode == "int8":
        scales = np.abs(xs.reshape(WORLD, -1)[:, :896].reshape(WORLD, 7, 128)).max(-1) / 127
        assert np.abs(got[0][:896] - xs.sum(0)[:896]).reshape(7, 128).max(-1).max() <= (
            scales.sum(0) / 2 + 1e-5).max()


# ------------------------------------------------------ merge, ring, Ulysses


def test_merge_attention_matches_jax():
    rng = _rng(6)
    b, t, h, d = 2, 5, 3, 4
    o1, o2 = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(2))
    l1, l2 = (rng.standard_normal((b, h, t)).astype(np.float32) for _ in range(2))
    l1[0, 0, :2] = tattn.NEG_INF  # one side saw no keys
    l2[0, 0, 1:3] = tattn.NEG_INF  # row 1 on both sides: no keys at all
    o1[0, :2, 0] = 0.0
    o2[0, 1:3, 0] = 0.0
    jo, jl = jattn.merge_attention(*(jnp.asarray(a) for a in (o1, l1, o2, l2)))
    to, tl = tattn.merge_attention(*(torch.tensor(a) for a in (o1, l1, o2, l2)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)
    assert tl[0, 0, 1].item() == np.float32(tattn.NEG_INF) and torch.all(to[0, 1, 0] == 0)


def _qkv(seed, shape):
    return [_rng(seed + i).standard_normal(shape).astype(np.float32) for i in range(3)]


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(pool, causal, use_flash):
    # the flash schedule at 32 keys a shard: JAX's Pallas kernel in
    # interpret mode against the port's plain kernel versions
    shape = (1, 128, 2, 16) if use_flash else (2, 32, 4, 16)
    q, k, v = _qkv(7, shape)
    jm = _jmesh(sp=WORLD)
    want = np.asarray(jax.jit(lambda q, k, v: jring(q, k, v, jm, causal=causal,
                                                    use_flash=use_flash))(q, k, v))
    got = pool.run(cases.case_seq_attention, "ring", q, k, v, causal, use_flash, False)
    for r in range(WORLD):
        np.testing.assert_allclose(got[r], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("use_flash", [False, True])
def test_ring_attention_grads_match_jax(pool, use_flash):
    shape = (1, 64, 2, 8) if use_flash else (1, 16, 2, 8)
    q, k, v = _qkv(10, shape)
    jm = _jmesh(sp=WORLD)

    def loss(q, k, v):
        return jnp.sum(jring(q, k, v, jm, causal=True, use_flash=use_flash) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    got = pool.run(cases.case_seq_attention, "ring", q, k, v, True, use_flash, True)
    for r in range(WORLD):
        for g, w in zip(got[r][1], want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-3)


def test_ulysses_matches_jax(pool):
    q, k, v = _qkv(13, (2, 32, 8, 16))
    jm = _jmesh(sp=WORLD)
    want = np.asarray(jax.jit(lambda q, k, v: julysses(q, k, v, jm))(q, k, v))
    got = pool.run(cases.case_seq_attention, "ulysses", q, k, v, True, None, False)
    for r in range(WORLD):
        np.testing.assert_allclose(got[r], want, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------- pipeline


def _stage(w, x):
    return jnp.tanh(x @ w)


def _stage_aux(w, x):
    y = jnp.tanh(x @ w)
    return y, jnp.mean(y ** 2)


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("m", [4, 2])
def test_pipeline_matches_jax(pool, m, with_aux):
    dim = 16
    ws = (_rng(14).standard_normal((WORLD, dim, dim)) * 0.3).astype(np.float32)
    x = _rng(15).standard_normal((8, dim)).astype(np.float32)
    jm = _jmesh(pp=WORLD)

    def apply(ws, x):
        if not with_aux:
            return jpipe.pipeline_sharded(_stage, jm, num_microbatches=m)(ws, x)

        def inner(stacked, x):
            return jpipe.pipeline_apply(_stage_aux, stacked[0], x, axis_name="pp",
                                        num_microbatches=m, with_aux=True)

        return shard_map(inner, mesh=jm, in_specs=(JP("pp"), JP()), out_specs=(JP(), JP()),
                         check_vma=False)(ws, x)

    res = jax.jit(apply)(jnp.asarray(ws), jnp.asarray(x))
    want, want_aux = (res if with_aux else (res, 0.0))
    # the unpipelined stack, for the gradient (JAX's own test's bar)
    def seq_loss(ws):
        y, aux = jnp.asarray(x), 0.0
        for i in range(WORLD):
            ys = [_stage_aux(ws[i], c) for c in jnp.split(y, m)]
            y = jnp.concatenate([c for c, _ in ys])
            aux = aux + sum(a for _, a in ys) / m
        return jnp.mean(y ** 2) + (aux if with_aux else 0.0)

    want_grad = np.asarray(jax.jit(jax.grad(seq_loss))(jnp.asarray(ws)))
    got = pool.run(cases.case_pipeline, ws, x, m, with_aux)
    for out, aux, grad in got:
        np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(aux, float(want_aux), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grad, want_grad, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------- MoE at ep 2


@pytest.mark.parametrize("cap", [1.25, 2.0])
def test_moe_ffn_ep2_matches_jax(pool, cap):
    e_model, f_hidden, n_experts, n_tokens = 16, 32, 4, 96
    params = jax.tree_util.tree_map(
        np.asarray, jmoe.init_moe_params(jax.random.PRNGKey(7), e_model, f_hidden, n_experts))
    x = _rng(16).standard_normal((n_tokens, e_model)).astype(np.float32)
    jm = _jmesh(dp=2, ep=2)

    def inner(x, router, w_in, w_out):
        r = jmoe.moe_ffn(x, router, w_in, w_out, capacity_factor=cap)
        return r.out, r.aux_loss[None]

    spec = JP(("dp", "ep"))
    out, aux = jax.jit(shard_map(inner, mesh=jm, in_specs=(spec, JP(), JP("ep"), JP("ep")),
                                 out_specs=(spec, spec), check_vma=False))(
        jnp.asarray(x), params["router"], params["w_in"], params["w_out"])
    want, want_aux = np.asarray(out).reshape(WORLD, -1, e_model), np.asarray(aux)
    got = pool.run(cases.case_moe, x, params["router"], params["w_in"], params["w_out"], cap)
    scale = np.abs(want).max()
    for r, (o, a) in enumerate(got):
        assert np.abs(o - want[r]).max() <= 2e-5 * scale
        np.testing.assert_allclose(a, want_aux[r], rtol=2e-5)


# ------------------------------------------------------------- dry run


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    from cluster_anywhere_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(WORLD, device="cpu", timeout=120)
    out = capsys.readouterr().out
    for name in "ABCDE":
        assert out.count(f"{name}-loss") == WORLD, out[-2000:]
    assert "identical on every rank" in out
