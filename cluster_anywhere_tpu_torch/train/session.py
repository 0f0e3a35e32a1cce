"""Per-worker training session: the in-loop API.

Analogue of the reference's train/_internal/session.py — `train.report`,
`train.get_checkpoint`, `train.get_dataset_shard`, `train.get_context()`.

The session lives inside a TrainWorker actor. `report()` persists any
checkpoint to storage (worker-side upload, like the reference's
StorageContext train/_internal/storage.py) and enqueues the report for
the driver to poll. By default it does NOT block the training thread.
Counterpart of cluster_anywhere_tpu/train/session.py: a report carries
host values only, and a CUDA tensor in its metrics is refused (device
objects are not ported), never copied to the host quietly.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..util import flightrec
from ..util import tracing as _tracing
from .checkpoint import Checkpoint


@dataclass
class TrainContext:
    world_size: int
    world_rank: int
    local_rank: int
    node_rank: int
    experiment_name: str
    storage_path: str
    trial_dir: str
    # controller-assigned attempt number, identical on every rank of the
    # gang — what keys rank-shared sharded checkpoint dirs so a retry that
    # re-runs a step never re-saves into a previous attempt's directory
    attempt: int = 0

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_dir(self) -> str:
        return self.trial_dir


class _Session:
    def __init__(
        self,
        context: TrainContext,
        dataset_shards: Optional[Dict[str, Any]] = None,
        resume_checkpoint: Optional[Checkpoint] = None,
    ):
        self.context = context
        self.dataset_shards = dataset_shards or {}
        self.resume_checkpoint = resume_checkpoint
        self.reports: deque = deque()
        self.lock = threading.Lock()
        self.report_seq = 0
        self.finished = threading.Event()
        # checkpoint-on-preempt barrier (controller -> session control
        # channel): the controller sets ckpt_request on every rank when a
        # gang node enters a drain window; the training loop observes it via
        # train.should_checkpoint() and answers by reporting a checkpoint at
        # its next step boundary, which flips ckpt_acked for the driver's
        # barrier poll.  Resume then loses at most ONE step, not one
        # checkpoint interval.
        self.ckpt_request = threading.Event()
        self.ckpt_acked = False
        # distinguishes checkpoint dirs across retry attempts: report_seq
        # restarts at 0 in a new session, and a colliding path would let the
        # driver's keep-K eviction of the old attempt's entry delete the new
        # attempt's data
        self.attempt_token = uuid.uuid4().hex[:8]
        # step-span clock: report() boundaries delimit train:step spans in
        # `ca timeline` (the loop itself is user code we cannot wrap)
        self._step_t0 = time.time()

    def report(
        self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None
    ) -> None:
        from ..core.worker import _is_device_value, refuse_device_value

        if _is_device_value(metrics):
            refuse_device_value(metrics, "train.report")
        entry: Dict[str, Any] = {"metrics": dict(metrics), "seq": self.report_seq}
        if checkpoint is not None:
            if checkpoint.is_sharded():
                # rank-cooperative sharded checkpoint: every rank wrote its
                # own shards into ONE shared dir (shared_checkpoint_dir) —
                # register it in place; a per-rank copy would capture only
                # the shards that happened to have landed at copy time
                entry["checkpoint_path"] = checkpoint.path
            else:
                # Persist into the trial dir so it survives the worker
                # process.  Only rank 0's copy is registered by the driver,
                # but every rank may pass a checkpoint (they are rank-tagged
                # to avoid collision).
                dest = os.path.join(
                    self.context.trial_dir,
                    f"checkpoint_{self.attempt_token}_{self.report_seq:06d}"
                    f"_rank{self.context.world_rank}",
                )
                if os.path.abspath(checkpoint.path) != dest:
                    os.makedirs(os.path.dirname(dest), exist_ok=True)
                    shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
                entry["checkpoint_path"] = dest
        barrier_ack = False
        with self.lock:
            self.reports.append(entry)
            self.report_seq += 1
            if checkpoint is not None and self.ckpt_request.is_set():
                # the barrier is answered by the FIRST checkpoint-carrying
                # report after the request, whatever triggered the save.
                # Acked strictly AFTER the entry is queued (and inside the
                # lock): the controller's poll must never observe the ack
                # without also draining the checkpoint report it acks —
                # it tears the group down on the strength of that ack
                self.ckpt_request.clear()
                self.ckpt_acked = True
                barrier_ack = True
        if barrier_ack and flightrec.REC is not None:
            # rank-side half of the preemption barrier: pairs with the
            # controller's train_preempt_barrier phases in `ca incident`
            flightrec.REC.record(
                "train", "train_ckpt_barrier_ack",
                rank=self.context.world_rank, seq=entry["seq"],
                attempt=getattr(self.context, "attempt", None),
            )
        now = time.time()
        tr = _tracing.current()
        if tr is not None or _tracing.is_enabled():
            ctx = (
                {"tid": tr["tid"], "sid": _tracing.new_span_id(), "psid": tr["sid"]}
                if tr is not None
                else {"tid": _tracing.new_trace_id(), "sid": _tracing.new_span_id()}
            )
            w = _tracing._current_worker()
            _tracing.record_task_event(
                "", f"train:step:{entry['seq']}", "span", "SPAN",
                trace=ctx,
                worker_id=w.client_id if w is not None else None,
                node_id=w.node_id if w is not None else None,
                start=self._step_t0, end=now,
                rank=self.context.world_rank,
            )
        self._step_t0 = now

    def drain_reports(self) -> List[Dict[str, Any]]:
        with self.lock:
            out = list(self.reports)
            self.reports.clear()
            return out

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.resume_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        return self.dataset_shards.get(name)


_session_lock = threading.Lock()
_session: Optional[_Session] = None


def _set_session(s: Optional[_Session]):
    global _session
    with _session_lock:
        _session = s


def _get_session() -> _Session:
    if _session is None:
        raise RuntimeError(
            "No training session active: this API must be called from inside "
            "a train_loop_per_worker launched by a Trainer."
        )
    return _session


# ---- public in-loop API (mirrors `ray.train.*`) -------------------------

def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None) -> None:
    _get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _get_session().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return _get_session().get_dataset_shard(name)


def get_context() -> TrainContext:
    return _get_session().context


def make_temp_checkpoint_dir() -> str:
    """A scratch dir for building a checkpoint before report()."""
    d = os.path.join(
        _get_session().context.trial_dir, f"_tmp_ckpt_{uuid.uuid4().hex[:8]}"
    )
    os.makedirs(d, exist_ok=True)
    return d


def should_checkpoint() -> bool:
    """Has the controller asked this rank to checkpoint at the next step
    boundary?  Set when a node hosting a gang member enters a preemption
    drain window; answer by reporting a checkpoint (the report clears the
    flag and acks the barrier).  Ranks of a multi-process mesh should agree
    on the boundary by reducing the flag across the mesh (max) before
    branching — the request lands on every rank, but not atomically between
    steps (see ARCHITECTURE.md "Elastic train plane")."""
    return _get_session().ckpt_request.is_set()


def shared_checkpoint_dir(tag: Any) -> str:
    """The rank-SHARED directory for a cooperative sharded checkpoint:
    every rank calling with the same `tag` (use the step number) resolves
    the same trial-dir path, writes its own shards there
    (Checkpoint.save_pytree_sharded), and reports it; the session registers
    sharded checkpoints in place instead of making per-rank copies.  The
    path is keyed by the controller-assigned attempt too: a retry that
    re-runs a step must save into a FRESH dir — a kill mid-re-save into the
    previous attempt's dir would leave a mix of old and new shards that
    passes the coverage check and restores inconsistent state."""
    ctx = _get_session().context
    d = os.path.join(ctx.trial_dir, f"shard_ckpt_a{ctx.attempt}_{tag}")
    os.makedirs(d, exist_ok=True)
    return d
