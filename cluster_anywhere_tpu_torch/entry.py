"""The port's flagship model, its forward step and the multi-rank dry run,
the counterpart of the JAX package's __graft_entry__.py (`_flagship_cfg`,
`entry`, `dryrun_multichip`, `_dryrun_device_plane`).

    fn, args = entry()        # on the card; entry(device="cpu") on the host
    logits = fn(*args)        # [4, 1024, 32000] bf16
    dryrun_multichip(4, device="cpu")   # configs A-E on 4 gloo ranks, then
                                        # the device plane's DAG hop
"""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ._device import resolve_device
from .models.transformer import TransformerConfig, forward, init_params


def flagship_cfg() -> TransformerConfig:
    """The one full-width model of the repo: vocab 32000, d_model 1024,
    8 layers, 8 heads over 4 KV heads of 128, d_ff 4096, bf16 activations
    over fp32 params."""
    return TransformerConfig(
        vocab_size=32000,
        d_model=1024,
        n_layers=8,
        n_heads=8,
        n_kv_heads=4,
        d_head=128,
        d_ff=4096,
        max_seq_len=2048,
        dtype=torch.bfloat16,
    )


def entry(device=None, seed: int = 0):
    """The flagship's forward step: returns (fn, (model, ids)) with random
    weights from `seed` and ids [4, 1024] drawn from a numpy generator of
    the same seed.  fn(model, ids) is `forward` without autograd."""
    dev = resolve_device(device)
    cfg = flagship_cfg()
    model = init_params(cfg, seed, device=dev)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 1024))
    ids = torch.from_numpy(ids).to(dev)

    @torch.no_grad()
    def fn(model, ids):
        return forward(model, ids)

    return fn, (model, ids)


def _split3(n):
    """Factor n into (a, b, c), c >= b >= a (__graft_entry__._split3)."""
    factors = [1, 1, 1]
    i = 2
    while n > 1:
        for p in (2, 3, 5, 7):
            if n % p == 0:
                factors[i % 3] *= p
                n //= p
                i -= 1
                break
        else:
            factors[i % 3] *= n
            n = 1
    return tuple(sorted(factors))


def dryrun_configs(n: int):
    """The dry run's configs on n ranks, as __graft_entry__'s: [(name,
    config overrides, mesh axes, batch size)] at its tiny fp32 widths."""
    from .parallel.mesh import MeshSpec

    a_fsdp, a_pp, a_tp = _split3(n)
    a_pp = min(a_pp, 4)  # n_layers=4 must divide
    a_fsdp = n // (a_pp * a_tp)
    b_dp, b_sp, b_tp = _split3(n)
    c_ep = 2 if n % 2 == 0 else 1
    c_dp = n // c_ep
    out = [
        ("A", dict(pp=a_pp, num_microbatches=2 if a_pp > 1 else 1),
         MeshSpec(fsdp=a_fsdp, pp=a_pp, tp=a_tp), max(4, 2 * a_fsdp)),
        ("B", dict(sp=b_sp, attn_impl="ring" if b_sp > 1 else "dense"),
         MeshSpec(dp=b_dp, sp=b_sp, tp=b_tp), max(4, 2 * b_dp)),
        ("C", dict(n_experts=4, ep=c_ep, attn_impl="dense"), MeshSpec(dp=c_dp, ep=c_ep),
         max(4, 2 * c_dp)),
    ]
    if n % 4 == 0:
        out.append(("D", dict(n_experts=4, ep=2, pp=2, num_microbatches=2, attn_impl="dense"),
                    MeshSpec(fsdp=n // 4, pp=2, ep=2), max(4, 2 * (n // 4) * 2)))
    fsdp = 2 if n % 2 == 0 else 1
    out.append(("E", {}, MeshSpec(fsdp=fsdp, tp=n // fsdp), max(4, 2 * fsdp)))
    return out


_TINY = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4, n_kv_heads=4, d_head=8,
             d_ff=64, max_seq_len=64, dtype=torch.float32)


def _dryrun_rank(rank: int, n: int, device, backend) -> None:
    """One rank of dryrun_multichip: each config's mesh and one train step
    on the same batch on every rank; prints "<name>-loss <value>"."""
    from .models.transformer import make_train_step
    from .parallel.mesh import make_mesh

    torch.set_num_threads(1)
    for name, over, spec, batch in dryrun_configs(n):
        cfg = TransformerConfig(**_TINY, **over)
        mesh = make_mesh(spec, device=device, backend=backend)
        step, init_state = make_train_step(cfg, mesh)
        model, opt = init_state(0)
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, 33))
        model, opt, loss = step(model, opt, {"ids": torch.from_numpy(ids)})
        loss = float(loss)
        if not np.isfinite(loss):
            raise RuntimeError(f"non-finite loss under {spec}")
        print(f"[rank {rank}/{n}] {name} {spec}: {name}-loss {loss!r}", flush=True)
    torch.distributed.destroy_process_group()


def dryrun_multichip(n: int, device=None, backend=None, timeout: float = 900.0) -> None:
    """Run configs A-E (pp x tp, ring sp, MoE over ep, MoE through the
    pipeline, fsdp x tp) one train step each on `n` ranks: n processes on
    one torch.distributed group, spawned and joined under one deadline,
    the survivors killed when a rank fails.  Every rank's loss must be
    finite and config E's the same on every rank.  device=None is the card
    (raising without one); backend as parallel.make_mesh takes it (ranks
    sharing one card need "gloo")."""
    dev = resolve_device(device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        code = ("from cluster_anywhere_tpu_torch.entry import _dryrun_rank; "
                f"_dryrun_rank({rank}, {n}, {str(dev)!r}, {backend!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=repo,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    deadline = time.monotonic() + timeout
    outs, fail = {}, None
    try:
        pending = set(range(n))
        while pending and fail is None:
            if time.monotonic() > deadline:
                fail = (min(pending), "timeout")
                break
            for rank in sorted(pending):
                p = procs[rank]
                if p.poll() is None:
                    continue
                outs[rank] = p.communicate()[0]
                pending.discard(rank)
                if p.returncode != 0:
                    fail = (rank, p.returncode)
                    break
            time.sleep(0.1)
    finally:
        for rank, p in enumerate(procs):  # failure or timeout: reap the survivors
            if rank not in outs:
                if p.poll() is None:
                    p.kill()
                outs[rank] = p.communicate()[0]
    if fail:
        rank, rc = fail
        raise RuntimeError(f"dryrun_multichip({n}) rank {rank} failed rc={rc}:\n"
                           f"{outs.get(rank, '')[-2000:]}")
    for rank in range(n):
        sys.stdout.write(outs[rank])
    losses = {re.search(r"E-loss (\S+)", outs[r]).group(1) for r in range(n)}
    if len(losses) != 1:
        raise RuntimeError(f"the ranks disagree on config E's loss: {losses}")
    print(f"[dryrun] configs A-E on {n} ranks: one train step each, config E's loss "
          f"identical on every rank ({losses.pop()})")
    dryrun_device_plane(dev)


_STRICT = "CA_DEVICE_TRANSPORT_STRICT"
_PLANE_PLACEMENTS = (("shard", 0),) + (("replicate",),) * 5


class _PlaneRank:
    """A one-rank gloo group and mesh of its own in an actor process, on
    `device`, with the transport in strict mode."""

    def __init__(self, device: str, port: int):
        from .parallel.mesh import MeshSpec, make_mesh

        os.environ[_STRICT] = "1"
        os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        self.mesh = make_mesh(MeshSpec(), device=device, backend="gloo")
        self.device = torch.device(device if device == "cpu" else
                                   f"cuda:{torch.cuda.current_device()}")


class _PlaneProducer(_PlaneRank):
    def make(self, scale: float):
        """A DTensor sharded on dim 0 of the mesh and a bf16 tensor."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        x = torch.arange(16, dtype=torch.float32, device=self.device) * scale
        placements = [Shard(0)] + [Replicate()] * 5
        return {"x": DTensor.from_local(x, self.mesh, placements, run_check=False),
                "kv": x.to(torch.bfloat16).reshape(4, 4), "scale": scale}


class _PlaneConsumer(_PlaneRank):
    def __init__(self, device: str, port: int):
        super().__init__(device, port)
        from .channel import device_transport

        device_transport.set_transfer_mesh(self.mesh)

    def reduce(self, v):
        """The sums of the landed leaves and the transport's counters;
        raises where a leaf lost its placements, dtype or device."""
        from torch.distributed.tensor import DTensor

        from .channel import device_transport

        x, kv = v["x"], v["kv"]
        if not isinstance(x, DTensor) or tuple(
                device_transport._encode_placement(p) for p in x.placements) != _PLANE_PLACEMENTS:
            raise RuntimeError(f"the DTensor leaf landed as {type(x).__name__} "
                               f"{getattr(x, 'placements', None)}")
        if x.to_local().device != self.device or kv.device != self.device:
            raise RuntimeError(f"landed on {x.to_local().device} and {kv.device}, "
                               f"want {self.device}")
        if kv.dtype != torch.bfloat16:
            raise RuntimeError(f"the bf16 leaf landed as {kv.dtype}")
        return float(x.to_local().sum()), float(kv.float().sum()), device_transport.stats()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_device_plane(device=None) -> None:
    """One compiled-DAG step in which two actor processes pass a DTensor
    (Shard(0) on a one-rank mesh) and a bf16 tensor through the
    tensor-transport channel under strict mode, so that a landing that
    drops a placement raises: the runtime layer between programs, which
    the SPMD dry run cannot cover (__graft_entry__._dryrun_device_plane).
    device=None is the card (each actor holds half of it); device="cpu"
    runs on the host.  Starts and shuts down a session of its own."""
    import cluster_anywhere_tpu_torch as ca

    from .dag import InputNode

    dev = resolve_device(device)
    gpu = 0.5 if dev.type == "cuda" else 0
    prev = os.environ.get(_STRICT)
    os.environ[_STRICT] = "1"
    ca.init(num_cpus=2, **({} if gpu else {"num_gpus": 0}))
    try:
        producer = ca.remote(_PlaneProducer).options(num_gpus=gpu).remote(dev.type, _free_port())
        consumer = ca.remote(_PlaneConsumer).options(num_gpus=gpu).remote(dev.type, _free_port())
        with InputNode() as inp:
            out = consumer.reduce.bind(producer.make.bind(inp).with_tensor_transport())
        dag = out.experimental_compile()
        try:
            x_sum, kv_sum, st = dag.execute(2.0).get(timeout=120)
        finally:
            dag.teardown()
        want = 2.0 * 15 * 16 / 2
        landed = "cuda_landings" if dev.type == "cuda" else "cpu_landings"
        if ((x_sum, kv_sum) != (want, want) or st["leaves_landed"] != 2
                or st[landed] != 2 or st["sharded_landings"] != 1 or st["host_assembles"]):
            raise RuntimeError(f"device plane: sums {x_sum}, {kv_sum} (want {want}), "
                               f"transport stats {st}")
    finally:
        ca.shutdown()
        if prev is None:
            os.environ.pop(_STRICT, None)
        else:
            os.environ[_STRICT] = prev
    print(f"[dryrun] device plane: DAG hop across processes ok (a Shard(0) DTensor and a "
          f"bf16 tensor, strict, landed on {dev.type}, sum={x_sum})")
