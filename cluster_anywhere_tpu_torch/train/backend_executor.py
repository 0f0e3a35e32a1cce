"""BackendExecutor: drives a WorkerGroup through one training run attempt.

Analogue of the reference's train/_internal/backend_executor.py:69
(`start`, `start_training`) — the driver-side polling loop lives in the
TrainController, this class owns group lifecycle + per-attempt start.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

from .backend import Backend
from .checkpoint import Checkpoint
from .config import BackendConfig, RunConfig, ScalingConfig
from .worker_group import WorkerGroup


def _split_dataset(ds: Any, n: int) -> List[Any]:
    """Split a dataset-ish object into n per-worker shards."""
    if ds is None:
        return [None] * n
    if hasattr(ds, "streaming_split"):
        return ds.streaming_split(n)
    if hasattr(ds, "split"):
        return ds.split(n)
    if isinstance(ds, (list, tuple)):
        return [list(ds[i::n]) for i in range(n)]
    return [ds] * n


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
        run_config: RunConfig,
        experiment_name: str,
    ):
        self.backend_config = backend_config
        self.backend: Backend = backend_config.backend_cls()()
        self.scaling_config = scaling_config
        self.run_config = run_config
        self.experiment_name = experiment_name
        self.worker_group: Optional[WorkerGroup] = None

    def start(self, num_workers: Optional[int] = None):
        n = num_workers or self.scaling_config.num_workers
        self.worker_group = WorkerGroup(
            num_workers=n,
            bundle=self.scaling_config.bundle(),
            placement_strategy=self.scaling_config.placement_strategy,
            label_selector=self.scaling_config.label_selector,
        )
        self.backend.on_start(self.worker_group, self.backend_config)

    def start_training(
        self,
        train_fn: Callable,
        train_fn_config: Optional[Dict[str, Any]],
        datasets: Optional[Dict[str, Any]],
        resume_checkpoint: Optional[Checkpoint],
        attempt: int = 0,
    ):
        wg = self.worker_group
        assert wg is not None, "call start() first"
        n = wg.num_workers
        storage = self.run_config.resolved_storage_path()
        trial_dir = os.path.join(storage, self.experiment_name)
        os.makedirs(trial_dir, exist_ok=True)
        shards: Dict[str, List[Any]] = {
            name: _split_dataset(ds, n) for name, ds in (datasets or {}).items()
        }
        local_ranks = wg.local_ranks()
        node_ranks = wg.node_ranks()
        self.backend.on_training_start(wg, self.backend_config)
        import cluster_anywhere_tpu_torch as ca

        refs = []
        for rank, w in enumerate(wg.workers):
            ctx = dict(
                world_size=n,
                world_rank=rank,
                local_rank=local_ranks[rank],
                node_rank=node_ranks[rank],
                experiment_name=self.experiment_name,
                storage_path=storage,
                trial_dir=trial_dir,
                attempt=attempt,
            )
            refs.append(
                w.start_training.remote(
                    train_fn,
                    train_fn_config,
                    ctx,
                    {name: s[rank] for name, s in shards.items()},
                    resume_checkpoint.path if resume_checkpoint else None,
                )
            )
        ca.get(refs)

    def poll(self) -> List[Dict[str, Any]]:
        """Per-rank poll results; a dead rank yields a synthetic error
        entry instead of raising.  Resolving the batch with one ca.get
        would discard every SURVIVING rank's already-drained reports when
        any single ref raises — their poll() executed remotely (emptying
        the session deque) before the batch get failed, losing e.g. the
        barrier checkpoint report the preempt ack protocol just delivered."""
        import cluster_anywhere_tpu_torch as ca

        assert self.worker_group is not None
        refs = [w.poll.remote() for w in self.worker_group.workers]
        out = []
        for ref in refs:
            try:
                out.append(ca.get(ref))
            except Exception as e:
                out.append(
                    {
                        "reports": [],
                        "done": False,
                        "error": f"worker actor lost: {e!r}",
                        "ckpt_acked": False,
                    }
                )
        return out

    def worker_node_ids(self) -> List[str]:
        """Per-rank node ids of the running group ([] before start())."""
        if self.worker_group is None:
            return []
        return self.worker_group.node_ids()

    def request_checkpoint(self) -> List[bool]:
        """Fan the checkpoint-on-preempt request out to every rank's
        session.  All requests launch up front and are gathered under ONE
        shared 2s window (ca.wait), not a per-rank timeout: N unreachable
        ranks on the dying node must cost 2s total, not 2s each — every
        second spent here comes out of the barrier window."""
        import cluster_anywhere_tpu_torch as ca

        assert self.worker_group is not None
        refs = [w.request_checkpoint.remote() for w in self.worker_group.workers]
        ready, _ = ca.wait(refs, num_returns=len(refs), timeout=2.0)
        ready_set = set(ready)
        out = []
        for ref in refs:
            if ref not in ready_set:
                out.append(False)  # rank unreachable inside the window
                continue
            try:
                out.append(bool(ca.get(ref)))
            except Exception:
                out.append(False)
        return out

    def shutdown(self):
        if self.worker_group is not None:
            self.backend.on_shutdown(self.worker_group, self.backend_config)
            self.worker_group.shutdown()
            self.worker_group = None
