"""WorkerGroup: a gang of TrainWorker actors scheduled via a placement group.

Analogue of the reference's train/_internal/worker_group.py:102 — but the
worker actor here hosts the training thread AND the session, and the
driver polls reports instead of using a results queue actor.
Counterpart of cluster_anywhere_tpu/train/worker_group.py: a worker that
asks for the GPU resource is a GPU-pool actor (it keeps the card in view),
and its loop loads the kernels the driver built (build/torch_kernels/ of
the same checkout; a worker needs no nvcc).
"""

from __future__ import annotations

import os
import socket
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

import cluster_anywhere_tpu_torch as ca

from .checkpoint import Checkpoint
from .session import TrainContext, _Session, _set_session


class TrainWorker:
    """Actor hosting one training process' session + train thread."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._session = None
        self._error: Optional[str] = None
        self._done = False

    def node_info(self) -> Dict[str, Any]:
        host = socket.gethostname()
        try:
            addr = socket.gethostbyname(host)
        except OSError:  # a host whose name does not resolve: this node only
            addr = "127.0.0.1"
        return {
            "hostname": host,
            "addr": addr,
            "pid": os.getpid(),
            "node_id": ca.get_runtime_context().node_id,
        }

    def free_port(self) -> int:
        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def set_env(self, env: Dict[str, str]) -> None:
        os.environ.update(env)

    def start_training(
        self,
        train_fn: Callable,
        train_fn_config: Optional[Dict[str, Any]],
        context_kwargs: Dict[str, Any],
        dataset_shards: Optional[Dict[str, Any]],
        resume_checkpoint_path: Optional[str],
    ) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("training already running on this worker")
        ctx = TrainContext(**context_kwargs)
        os.makedirs(ctx.trial_dir, exist_ok=True)
        resume = (
            Checkpoint(resume_checkpoint_path) if resume_checkpoint_path else None
        )
        self._session = _Session(ctx, dataset_shards, resume)
        self._error = None
        self._done = False
        _set_session(self._session)

        def _run():
            try:
                if train_fn_config is not None:
                    train_fn(train_fn_config)
                else:
                    train_fn()
            except BaseException:
                self._error = traceback.format_exc()
            finally:
                self._done = True
                self._session.finished.set()

        self._thread = threading.Thread(target=_run, daemon=True, name="ca-train")
        self._thread.start()

    def poll(self) -> Dict[str, Any]:
        s = self._session
        # checkpoint-on-preempt barrier: True once this rank reported a
        # checkpoint after the controller's request_checkpoint.  Read BEFORE
        # draining: the ack is set after its report is queued, so an ack
        # observed here guarantees the checkpoint entry rides this (or an
        # earlier) drain — the controller tears the group down on it
        acked = bool(s.ckpt_acked) if s else False
        return {
            "reports": s.drain_reports() if s else [],
            "done": self._done,
            "error": self._error,
            "ckpt_acked": acked,
        }

    def request_checkpoint(self) -> bool:
        """Controller->session control channel: ask the training loop to
        checkpoint at its next step boundary (train.should_checkpoint()).
        Returns False when no session is running (nothing to barrier on)."""
        s = self._session
        if s is None or self._done:
            return False
        s.ckpt_acked = False
        s.ckpt_request.set()
        return True

    def join(self, timeout: Optional[float] = None) -> bool:
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary function in the worker process (backend setup)."""
        return fn(*args, **kwargs)


def _node_sorted_permutation(node_infos: List[Dict[str, Any]]) -> List[int]:
    """Stable permutation grouping workers by first-seen node: ranks on the
    same node become contiguous (and keep their relative order), which is
    what local_ranks()/node_ranks() assume.  Raw placement order can
    interleave nodes (e.g. SPREAD, or PACK across partially-full nodes),
    which would hand two workers of one node non-consecutive local ranks."""
    order: Dict[str, int] = {}
    for info in node_infos:
        order.setdefault(info["node_id"], len(order))
    return sorted(
        range(len(node_infos)),
        key=lambda i: (order[node_infos[i]["node_id"]], i),
    )


class WorkerGroup:
    """N TrainWorker actors gang-scheduled through one placement group."""

    def __init__(
        self,
        num_workers: int,
        bundle: Dict[str, float],
        placement_strategy: str = "PACK",
        max_restarts: int = 0,
        label_selector=None,
    ):
        self.num_workers = num_workers
        self._pg = ca.placement_group(
            [dict(bundle) for _ in range(num_workers)],
            strategy=placement_strategy,
            # slice targeting: every bundle carries the gang's hard selector
            bundle_label_selectors=(
                [label_selector] * num_workers if label_selector else None
            ),
        )
        self._pg.wait(timeout_seconds=60)
        cls = ca.remote(TrainWorker)
        custom = {
            k: v for k, v in bundle.items() if k not in ("CPU", "GPU", "memory")
        }
        self.workers: List[Any] = [
            cls.options(
                max_concurrency=4,
                max_restarts=max_restarts,
                placement_group=self._pg,
                placement_group_bundle_index=i,
                num_cpus=bundle.get("CPU", 0),
                num_gpus=bundle.get("GPU", 0),
                resources=custom,
                # the TrainController handles node drains app-aware
                # (checkpoint barrier + group rebuild on survivors); the
                # head's generic drain evacuation restarting a TrainWorker
                # elsewhere would race the barrier and lose the training
                # thread's state anyway
                drain_migration=False,
            ).remote()
            for i in range(num_workers)
        ]
        # sorted by node for stable local_rank assignment: workers and their
        # infos are reordered TOGETHER so rank i always maps to workers[i]
        infos = ca.get([w.node_info.remote() for w in self.workers])
        perm = _node_sorted_permutation(infos)
        self.workers = [self.workers[i] for i in perm]
        self.node_infos = [infos[i] for i in perm]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ca.get(self.execute_async(fn, *args, **kwargs))

    def execute_async(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute_single(self, index: int, fn: Callable, *args, **kwargs) -> Any:
        return ca.get(self.workers[index].execute.remote(fn, *args, **kwargs))

    def local_ranks(self) -> List[int]:
        counts: Dict[str, int] = {}
        ranks = []
        for info in self.node_infos:
            nid = info["node_id"]
            ranks.append(counts.get(nid, 0))
            counts[nid] = counts.get(nid, 0) + 1
        return ranks

    def node_ranks(self) -> List[int]:
        order: Dict[str, int] = {}
        ranks = []
        for info in self.node_infos:
            nid = info["node_id"]
            if nid not in order:
                order[nid] = len(order)
            ranks.append(order[nid])
        return ranks

    def node_ids(self) -> List[str]:
        """Per-rank node ids — what the controller intersects with the
        drain plane's draining_node_ids() to spot a preemption warning."""
        return [info["node_id"] for info in self.node_infos]

    def shutdown(self):
        from ..core.ownership import warn_ratelimited
        from ..core.worker import TRAIN_STATS

        for rank, w in enumerate(self.workers):
            try:
                ca.kill(w)
            except Exception as e:
                # a worker that is already gone (preempted node) is normal
                # here, but it must stay visible: a kill that fails for any
                # OTHER reason leaks an actor slot for the group's lifetime
                TRAIN_STATS["shutdown_errors_total"] += 1
                warn_ratelimited(
                    "train_wg_kill",
                    f"train worker group: killing rank {rank} failed: {e!r}",
                )
        self.workers = []
        try:
            ca.remove_placement_group(self._pg)
        except Exception as e:
            TRAIN_STATS["shutdown_errors_total"] += 1
            warn_ratelimited(
                "train_wg_pg",
                f"train worker group: removing placement group failed: {e!r}",
            )
