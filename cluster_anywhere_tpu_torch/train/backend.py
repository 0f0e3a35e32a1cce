"""Framework backends: per-worker process-group setup hooks.

Analogue of the reference's `_TorchBackend` (train/torch/config.py:66-153,
which calls torch.distributed.init_process_group).  Counterpart of
cluster_anywhere_tpu/train/backend.py: the base backend exports the rank
env vars, as the JAX package's JaxBackend does without
`jax.distributed`; TorchBackend also joins the workers into one
torch.distributed process group and exports torch's RANK / WORLD_SIZE /
LOCAL_RANK, so that parallel.make_mesh inside the loop joins the group the
backend made (and picks `cuda:(LOCAL_RANK % device_count)`: workers that
share one card each see it as device 0).  The JAX package's
ensure_cpu_collectives and _init_jax_distributed have no counterpart.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List

from .config import BackendConfig

if TYPE_CHECKING:
    from .worker_group import WorkerGroup


def _rank_envs(worker_group: "WorkerGroup") -> List[Dict[str, str]]:
    n = worker_group.num_workers
    local_ranks = worker_group.local_ranks()
    node_ranks = worker_group.node_ranks()
    return [
        {
            "CA_WORLD_SIZE": str(n),
            "CA_WORLD_RANK": str(rank),
            "CA_LOCAL_RANK": str(local_ranks[rank]),
            "CA_NODE_RANK": str(node_ranks[rank]),
        }
        for rank in range(n)
    ]


class Backend:
    """Base backend: exports the rank env vars to every worker."""

    def on_start(self, worker_group: "WorkerGroup", backend_config: BackendConfig):
        import cluster_anywhere_tpu_torch as ca

        ca.get(
            [
                w.set_env.remote(env)
                for w, env in zip(worker_group.workers, _rank_envs(worker_group))
            ]
        )

    def on_training_start(
        self, worker_group: "WorkerGroup", backend_config: BackendConfig
    ):
        pass

    def on_shutdown(self, worker_group: "WorkerGroup", backend_config: BackendConfig):
        pass


def _init_torch_pg(master_addr: str, master_port: int, world_size: int, rank: int,
                   backend: str, timeout_s: float):
    import datetime
    import os as _os

    import torch.distributed as dist

    _os.environ["MASTER_ADDR"] = master_addr
    _os.environ["MASTER_PORT"] = str(master_port)
    dist.init_process_group(
        backend=backend,
        world_size=world_size,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _destroy_torch_pg():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class TorchBackend(Backend):
    """torch.distributed process group across the worker group (reference
    _TorchBackend, train/torch/config.py:66-153): rank-0's node hosts the
    TCP store; every worker joins with its rank envs, enabling DDP/FSDP
    training loops and parallel.make_mesh unchanged.  The backend is the
    config's (gloo by default) and is never switched."""

    def on_start(self, worker_group: "WorkerGroup", backend_config):
        import cluster_anywhere_tpu_torch as ca

        n = worker_group.num_workers
        port = backend_config.port or ca.get(
            worker_group.workers[0].free_port.remote()
        )
        host = worker_group.node_infos[0]["addr"]
        refs = []
        for rank, (w, env) in enumerate(
            zip(worker_group.workers, _rank_envs(worker_group))
        ):
            env.update(
                RANK=str(rank),
                WORLD_SIZE=str(n),
                LOCAL_RANK=env["CA_LOCAL_RANK"],
                MASTER_ADDR=host,
                MASTER_PORT=str(port),
            )
            refs.append(w.set_env.remote(env))
        ca.get(refs)
        ca.get(
            [
                w.execute.remote(
                    _init_torch_pg, host, port, n, rank,
                    backend_config.backend, backend_config.timeout_s,
                )
                for rank, w in enumerate(worker_group.workers)
            ]
        )

    def on_shutdown(self, worker_group: "WorkerGroup", backend_config):
        import cluster_anywhere_tpu_torch as ca

        try:
            ca.get([w.execute.remote(_destroy_torch_pg) for w in worker_group.workers])
        except Exception:
            pass
