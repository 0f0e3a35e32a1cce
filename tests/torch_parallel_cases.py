"""The port's side of tests/test_torch_parallel.py and
tests/test_torch_parallel_model.py (not a test module): the functions that
torch_dist_pool's ranks run, fn(rank, world, *args).  This module imports
no JAX, so a rank starts with torch and the port alone; the test modules
compute JAX's side in the pytest process."""

import torch

from cluster_anywhere_tpu_torch.models import transformer as ttf
from cluster_anywhere_tpu_torch.models.convert import from_jax_params, to_jax_params
from cluster_anywhere_tpu_torch.parallel import mesh as tmesh
from cluster_anywhere_tpu_torch.parallel import sharding as tshard


# ------------------------------------------------- tests/test_torch_parallel.py

_MESHES = {}


def mesh_for(**axes):
    """The port's mesh for `axes` in this rank (made once per shape)."""
    key = tuple(sorted(axes.items()))
    if key not in _MESHES:
        _MESHES[key] = tmesh.make_mesh(tmesh.MeshSpec(**axes), device="cpu")
    return _MESHES[key]


def case_make_mesh(rank, world):
    m = tmesh.make_mesh(tmesh.MeshSpec(pp=2, tp=2), device="cpu")
    try:
        tmesh.make_mesh(tmesh.MeshSpec(tp=2), device="cpu")
        size_error = None
    except ValueError as e:
        size_error = str(e)
    try:
        tmesh.make_mesh(tmesh.MeshSpec(dp=world), device="cpu", backend="nccl")
        backend_error = None
    except ValueError as e:
        backend_error = str(e)
    local = tmesh.local_mesh(device="cpu")
    assert tmesh.mesh_spec(local) == tmesh.MeshSpec(dp=world)
    return (tuple(m.mesh_dim_names), tuple(m.mesh.shape), m.get_coordinate(),
            tmesh.axis_index(m, "tp"), tmesh.axis_index(m, "pp"), size_error, backend_error)


def case_shard_pytree(rank, world, tree):
    mesh = mesh_for(dp=2, tp=2)
    specs = {"w": tshard.P("dp", "tp"), "b": [tshard.P(None), tshard.P("tp")]}
    full = {"w": torch.tensor(tree["w"]), "b": [torch.tensor(t) for t in tree["b"]]}
    placed = tshard.shard_pytree(full, specs, mesh)
    moved = tshard.constraint(placed["w"], mesh, "vocab", "batch")  # ("tp", ("dp", "fsdp"))
    named = tshard.named_sharding(mesh, "batch", "heads")
    return ([placed["w"].to_local().numpy(), placed["b"][1].to_local().numpy(),
             placed["b"][0].to_local().numpy()],
            [tshard.local_shard(full["w"], specs["w"], mesh).numpy(),
             tshard.local_shard(full["b"][1], specs["b"][1], mesh).numpy(), tree["b"][0]],
            moved.to_local().numpy(),
            tshard.local_shard(full["w"], tshard.logical_to_spec(("vocab", "batch")), mesh).numpy(),
            tuple(named.spec), moved.full_tensor().numpy())


# the collectives' meshes: (axes, the dim the collective runs over)
COLLECTIVE_AXES = {"dp4": ({"dp": 4}, "dp"), "tp2": ({"dp": 2, "tp": 2}, "tp")}


def _ring(mesh, a):
    n = tmesh.axis_size(mesh, a)
    return [(i, (i + 1) % n) for i in range(n)]


# each collective as the port runs it: op(tensor_plane, x, mesh, axis_name)
PORT_OPS = {
    "allreduce": lambda tp, x, m, a: tp.allreduce(x, m, a),
    "allgather-tiled-0": lambda tp, x, m, a: tp.allgather(x, m, a, axis=0),
    "allgather-untiled-1": lambda tp, x, m, a: tp.allgather(x, m, a, axis=1, tiled=False),
    "reducescatter-tiled-1": lambda tp, x, m, a: tp.reducescatter(x, m, a, axis=1),
    "reducescatter-untiled-0": lambda tp, x, m, a: tp.reducescatter(x, m, a, axis=0, tiled=False),
    "broadcast": lambda tp, x, m, a: tp.broadcast(x, m, a, src_index=1),
    "permute-ring": lambda tp, x, m, a: tp.permute(x, m, a, _ring(m, a)),
    "permute-partial": lambda tp, x, m, a: tp.permute(x, m, a, [(0, 1)]),
    "all_to_all-tiled": lambda tp, x, m, a: tp.all_to_all(x, m, a, 1, 0),
    "all_to_all-untiled": lambda tp, x, m, a: tp.all_to_all(x, m, a, 0, 0, tiled=False),
}


def case_collective(rank, world, op, axes_key, xs, ws):
    from cluster_anywhere_tpu_torch.parallel.collectives import tensor_plane

    axes, a = COLLECTIVE_AXES[axes_key]
    mesh = mesh_for(**axes)
    x = torch.tensor(xs[rank], requires_grad=True)
    out = PORT_OPS[op](tensor_plane, x, mesh, a)
    (out * torch.tensor(ws[rank])).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def case_quantized(rank, world, xs, mode, block):
    from cluster_anywhere_tpu_torch.parallel.collectives import quantized_psum

    mesh = mesh_for(dp=world)
    return quantized_psum(torch.tensor(xs[rank]), mesh, "dp", mode, block).numpy()


def case_seq_attention(rank, world, kind, q, k, v, causal, use_flash, grads):
    from cluster_anywhere_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from cluster_anywhere_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    mesh = mesh_for(sp=world)
    q, k, v = (torch.tensor(a, requires_grad=grads) for a in (q, k, v))
    if kind == "ring":
        out = ring_attention_sharded(q, k, v, mesh, causal=causal, use_flash=use_flash)
    else:
        out = ulysses_attention_sharded(q, k, v, mesh, causal=causal)
    if not grads:
        return out.detach().numpy()
    (out ** 2).sum().backward()
    return out.detach().numpy(), [a.grad.numpy() for a in (q, k, v)]


def _tstage(w, x):
    return torch.tanh(x @ w)


def _tstage_aux(w, x):
    y = torch.tanh(x @ w)
    return y, (y ** 2).mean()


def case_pipeline(rank, world, ws, x, m, with_aux):
    from cluster_anywhere_tpu_torch.parallel.collectives import split_to
    from cluster_anywhere_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_sharded

    mesh = mesh_for(pp=world)
    ws = torch.tensor(ws, requires_grad=True)
    mine = split_to(ws, mesh, "pp", axis=0)[0]
    if with_aux:
        out, aux = pipeline_apply(_tstage_aux, mine, torch.tensor(x), mesh, num_microbatches=m,
                                  with_aux=True)
        loss = (out ** 2).mean() + aux
    else:
        out = pipeline_sharded(_tstage, mesh, num_microbatches=m)(ws, torch.tensor(x))
        aux = torch.zeros(())
        loss = (out ** 2).mean()
    loss.backward()
    return out.detach().numpy(), float(aux), ws.grad.numpy()


def case_moe(rank, world, x, router, w_in, w_out, cap):
    from cluster_anywhere_tpu_torch.parallel.moe import moe_ffn

    mesh = mesh_for(dp=2, ep=2)
    e = tmesh.axis_index(mesh, "ep")
    local = w_in.shape[0] // 2
    rows = x.shape[0] // world
    r = moe_ffn(torch.tensor(x[rank * rows:(rank + 1) * rows]), torch.tensor(router),
                torch.tensor(w_in[e * local:(e + 1) * local]),
                torch.tensor(w_out[e * local:(e + 1) * local]),
                capacity_factor=cap, mesh=mesh, axis_name="ep")
    return r.out.numpy(), float(r.aux_loss)



# ------------------------------------------- tests/test_torch_parallel_model.py

TINY = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
            max_seq_len=64)
LR = 1e-2
def case_model(rank, world, over, axes, tree, ids):
    cfg = ttf.TransformerConfig(**TINY, **over, dtype="float32")
    mesh = tmesh.make_mesh(tmesh.MeshSpec(**axes), device="cpu")
    model = from_jax_params(tree, cfg, mesh=mesh)
    with torch.no_grad():
        logits = ttf.forward(model, torch.from_numpy(ids[:, :-1]).long(), mesh)
    step, init_state = ttf.make_train_step(cfg, mesh, learning_rate=LR)
    model, opt = init_state(model)
    batch = {"ids": torch.from_numpy(ids)}
    model, opt, loss1 = step(model, opt, batch)
    grads = to_jax_params(model, grads=True)
    model, opt, loss2 = step(model, opt, batch)
    if rank:
        return float(loss1), float(loss2)
    return float(loss1), float(loss2), logits.numpy(), grads


def case_batches(rank, world, rows):
    import cluster_anywhere_tpu_torch as ca
    import cluster_anywhere_tpu_torch.data as cad

    # sp shards the batch's sequence; dense attention keeps sp a replica axis,
    # so the loss takes a sequence of any length
    cfg = ttf.TransformerConfig(**TINY, sp=2, attn_impl="dense", dtype="float32")
    mesh = tmesh.make_mesh(tmesh.MeshSpec(dp=2, sp=2), device="cpu")
    sharding = ttf.make_batch_sharding(cfg, mesh)
    ca.init(num_cpus=1, num_gpus=0)  # each rank's own runtime
    try:
        ds = cad.from_items([{"ids": r} for r in rows])
        batches = list(ds.iter_torch_batches(batch_size=4, sharding=sharding))
    finally:
        ca.shutdown()
    model = ttf.init_params(cfg, 0, mesh=mesh)
    loss_fn = ttf.make_loss_fn(cfg, mesh)
    with torch.no_grad():
        losses = [(float(loss_fn(model, {"ids": b["ids"]})),
                   float(loss_fn(model, {"ids": b["ids"].full_tensor()}))) for b in batches]
    return [b["ids"].to_local().numpy() for b in batches], losses
