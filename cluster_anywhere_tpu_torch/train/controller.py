"""TrainController: the v2-style run loop with pluggable scaling + failure
policies (analogue of reference train/v2/_internal/execution/controller/
controller.py:91).

State machine per attempt:
  INIT -> STARTING (worker group up, backend bootstrapped)
       -> RUNNING  (polling worker reports)
       -> PREEMPTING (drain warning for a gang node: checkpoint barrier)
       -> FINISHED | ERRORED
On worker failure, FailurePolicy decides RETRY (rebuild the group, resume
from the latest registered checkpoint) or RAISE.  ScalingPolicy decides
the world size of each (re)start — ElasticScalingPolicy shrinks to what
the cluster can actually place, enabling elastic training.

Preemption elasticity (drain_aware, the default): the controller watches
the drain plane's warnings (`worker.draining_node_ids()`, fed by the head's
`drain` pubs with zero extra RPCs — the same surface the serve controller
uses) and reacts BEFORE the kill instead of waiting for a poll failure:
request a checkpoint at every rank's next step boundary
(`train.should_checkpoint()`), wait for the barrier, register rank 0's
checkpoint, tear the group down, and rebuild on survivors — with sharded
checkpoints resharding onto whatever mesh the shrunk world forms.
Preemption-caused attempts are budget-exempt: FailureKind.PREEMPTION never
consumes failure_config.max_failures (the drain plane's budget-exempt task
retry, applied to whole training attempts).

Counterpart of cluster_anywhere_tpu/train/controller.py, which it copies,
with one addition: run() refuses a gang the cluster can never hold (more
GPUs, or CPUs, than it has) before any worker starts, naming the resource,
where the placement would otherwise wait for it forever.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..util import flightrec
from .backend_executor import BackendExecutor
from .checkpoint import Checkpoint, CheckpointManager
from .config import (
    BackendConfig,
    RunConfig,
    ScalingConfig,
    TrainingFailedError,
)


class RunAttemptStatus(Enum):
    INIT = "INIT"
    STARTING = "STARTING"
    RUNNING = "RUNNING"
    PREEMPTING = "PREEMPTING"  # drain warning: checkpoint barrier in flight
    FINISHED = "FINISHED"
    ERRORED = "ERRORED"


@dataclass
class Result:
    """What fit() returns (reference air Result)."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    path: Optional[str] = None
    error: Optional[BaseException] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    best_checkpoints: List[Any] = field(default_factory=list)


class ScalingPolicy:
    def target_num_workers(self, scaling_config: ScalingConfig, attempt: int) -> int:
        return scaling_config.num_workers


class FixedScalingPolicy(ScalingPolicy):
    pass


class ElasticScalingPolicy(ScalingPolicy):
    """Shrink the group to what the cluster can place, within
    [min_workers, max_workers]."""

    def target_num_workers(self, scaling_config: ScalingConfig, attempt: int) -> int:
        import cluster_anywhere_tpu_torch as ca

        lo = scaling_config.min_workers or 1
        hi = scaling_config.max_workers or scaling_config.num_workers
        bundle = scaling_config.bundle()
        avail = ca.available_resources()
        fit = hi
        for key, per in bundle.items():
            if per > 0:
                fit = min(fit, int(avail.get(key, 0) // per))
        return max(lo, min(hi, fit))


class FailureDecision(Enum):
    RETRY = "RETRY"
    RAISE = "RAISE"


class FailureKind(Enum):
    """Why an attempt ended early.  WORKER failures consume the
    max_failures budget; PREEMPTION (a death or proactive restart inside an
    announced drain window) is the system's fault and never does —
    mirroring the drain plane's budget-exempt task retry."""

    WORKER = "worker"
    PREEMPTION = "preemption"


class FailurePolicy:
    def __init__(self, max_failures: int = 0):
        self.max_failures = max_failures

    def decide(
        self,
        failure_count: int,
        error: str,
        kind: FailureKind = FailureKind.WORKER,
    ) -> FailureDecision:
        if kind == FailureKind.PREEMPTION:
            return FailureDecision.RETRY  # budget-exempt: announced exit
        if self.max_failures < 0 or failure_count <= self.max_failures:
            return FailureDecision.RETRY
        return FailureDecision.RAISE


@dataclass
class _RunHandle:
    """Trial-shaped handle for run_config.callbacks on the Train path."""

    trial_id: str
    config: Dict[str, Any]
    local_dir: str


class TrainController:
    def __init__(
        self,
        train_fn: Callable,
        train_fn_config: Optional[Dict[str, Any]],
        scaling_config: ScalingConfig,
        run_config: RunConfig,
        backend_config: BackendConfig,
        datasets: Optional[Dict[str, Any]] = None,
        experiment_name: Optional[str] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        scaling_policy: Optional[ScalingPolicy] = None,
        poll_interval_s: float = 0.02,
    ):
        self.train_fn = train_fn
        self.train_fn_config = train_fn_config
        self.scaling_config = scaling_config
        self.run_config = run_config
        self.backend_config = backend_config
        self.datasets = datasets
        self.experiment_name = experiment_name or run_config.name or (
            f"train_run_{int(time.time())}"
        )
        self.checkpoint_manager = CheckpointManager(run_config.checkpoint_config)
        self.failure_policy = FailurePolicy(run_config.failure_config.max_failures)
        if scaling_policy is None:
            elastic = (
                scaling_config.min_workers is not None
                or scaling_config.max_workers is not None
            )
            scaling_policy = ElasticScalingPolicy() if elastic else FixedScalingPolicy()
        self.scaling_policy = scaling_policy
        self.poll_interval_s = poll_interval_s
        self.status = RunAttemptStatus.INIT
        self._resume_checkpoint = resume_from_checkpoint
        self._latest_metrics: Dict[str, Any] = {}
        self._metrics_history: List[Dict[str, Any]] = []
        # run_config.callbacks (tune/callback.py hook surface) fire here too:
        # the whole train run presents as one "trial" to the loggers
        self._run_handle = _RunHandle(
            trial_id=self.experiment_name,
            config=dict(train_fn_config or {}),
            local_dir=os.path.join(
                run_config.resolved_storage_path(), self.experiment_name
            ),
        )
        self.drain_aware = run_config.failure_config.drain_aware
        self._attempt = 0
        self._world_size = 0
        self._failure_count = 0
        self._preempt_restarts = 0
        self._last_pub = 0.0

    def _cb(self, hook: str, *args):
        from ..core.ownership import warn_ratelimited
        from ..core.worker import TRAIN_STATS

        for cb in self.run_config.callbacks:
            try:
                getattr(cb, hook)(self._run_handle, *args)
            except Exception as e:
                # logging must never take down the run — but a silently
                # broken logger invalidates every experiment it "recorded"
                TRAIN_STATS["callback_errors_total"] += 1
                warn_ratelimited(
                    f"train_cb_{hook}",
                    f"train run {self.experiment_name!r}: callback "
                    f"{type(cb).__name__}.{hook} raised {e!r}",
                )

    # -- drain plane ------------------------------------------------------
    def _draining_node_ids(self) -> set:
        """Nodes inside an announced drain window.  The head pushes `drain`
        pubs to every client — including this controller's process — so
        the read is a local dict lookup, zero RPCs (serve controller idiom,
        serve/controller.py)."""
        if not self.drain_aware:
            return set()
        try:
            from ..core.worker import global_worker

            return global_worker().draining_node_ids()
        except Exception:
            return set()

    def _preempt_barrier(self, executor: BackendExecutor) -> bool:
        """Checkpoint-on-preempt: ask every rank to checkpoint at its next
        step boundary, then poll until all live ranks acked (reported a
        checkpoint), finished, or the barrier window closes.  Reports keep
        being ingested throughout, so rank 0's barrier checkpoint registers
        before the caller tears the group down.  Returns True when every
        rank answered inside the window."""
        from ..core.worker import TRAIN_STATS

        self.status = RunAttemptStatus.PREEMPTING
        self._publish_digest(force=True)
        timeout = self.run_config.failure_config.preempt_barrier_timeout_s
        deadline = time.monotonic() + timeout
        accepted = executor.request_checkpoint()
        if flightrec.REC is not None:
            flightrec.REC.record(
                "train", "train_preempt_barrier", phase="requested",
                run=self.experiment_name, attempt=self._attempt,
                accepted=sum(bool(a) for a in accepted), ranks=len(accepted),
                timeout_s=timeout,
            )
        if not any(accepted):
            # no rank had a running session to barrier on (the warning
            # raced group bring-up, or every loop already returned):
            # nothing can ever ack — rebuild now rather than burning the
            # shrinking warning window on a provably futile wait
            return False
        acked = False
        died = False
        while time.monotonic() < deadline:
            try:
                polls = executor.poll()
            except Exception:
                died = True  # a rank died inside the window: keep what we have
                break
            self._ingest_reports(polls)
            if any(p["error"] for p in polls):
                died = True
                break
            # a rank that could not take the request (no session yet /
            # unreachable on the dying node) will never ack: wait only on
            # the ranks that accepted
            if all(
                p["ckpt_acked"] or p["done"] or not accepted[i]
                for i, p in enumerate(polls)
            ):
                acked = True
                break
            time.sleep(self.poll_interval_s)
        if flightrec.REC is not None:
            flightrec.REC.record(
                "train", "train_preempt_barrier",
                phase=("acked" if acked else "rank_died" if died else "timeout"),
                run=self.experiment_name, attempt=self._attempt,
            )
        if acked:
            TRAIN_STATS["preempt_barrier_acked_total"] += 1
        elif not died:
            # only a genuinely expired window counts as a timeout — the
            # counter tunes preempt_barrier_timeout_s, and a node dying 1s
            # into a 15s window says nothing about the window being short
            # (deaths surface through the attempt error path instead)
            TRAIN_STATS["preempt_barrier_timeout_total"] += 1
        return acked

    def _pick_resume_checkpoint(self) -> Optional[Checkpoint]:
        """Newest RESUMABLE checkpoint: a sharded dir whose ranks were
        killed mid-save (e.g. the reactive drain-deadline kill landing
        during a periodic save) fails its coverage check — retrying into it
        would burn every max_failures slot on the same ValueError.  Skip to
        the previous registered checkpoint instead, loudly."""
        from ..core.ownership import warn_ratelimited

        for ck in self.checkpoint_manager.checkpoints_newest_first():
            if ck.is_sharded() and not ck.sharded_complete():
                warn_ratelimited(
                    "train_resume_incomplete",
                    f"train run {self.experiment_name!r}: skipping "
                    f"incomplete sharded checkpoint {ck.path} (a rank's "
                    "shards never landed); resuming from the previous one",
                )
                continue
            return ck
        return self._resume_checkpoint

    # -- one attempt -----------------------------------------------------
    def _run_attempt(
        self, attempt: int
    ) -> Tuple[FailureKind, Optional[str]]:
        """Returns (kind, None) on success, or (kind, error string) when the
        attempt must be rebuilt — kind=PREEMPTION when the cause was an
        announced node exit (budget-exempt)."""
        from ..core.worker import TRAIN_STATS

        n = self.scaling_policy.target_num_workers(self.scaling_config, attempt)
        executor = BackendExecutor(
            self.backend_config,
            self.scaling_config,
            self.run_config,
            self.experiment_name,
        )
        self.status = RunAttemptStatus.STARTING
        self._attempt = attempt
        self._world_size = n
        self._publish_digest(force=True)
        if flightrec.REC is not None:
            flightrec.REC.record(
                "train", "train_attempt_start", run=self.experiment_name,
                attempt=attempt, world_size=n,
            )

        def _kind() -> FailureKind:
            gang = set(executor.worker_node_ids())
            draining = self._draining_node_ids()
            if gang:
                return (
                    FailureKind.PREEMPTION
                    if gang & draining
                    else FailureKind.WORKER
                )
            # the group died before its node map existed (placement /
            # node_info raced the exit): with a drain window open anywhere,
            # the announced exit is the likeliest cause — exempt it.  The
            # exemption is bounded: drain windows expire, after which a
            # persistent start failure counts against the budget again
            return FailureKind.PREEMPTION if draining else FailureKind.WORKER

        try:
            try:
                executor.start(num_workers=n)
                resume = self._pick_resume_checkpoint()
                executor.start_training(
                    self.train_fn,
                    self.train_fn_config,
                    self.datasets,
                    resume,
                    attempt=attempt,
                )
            except Exception as e:
                # group bring-up raced a node exit (placement, env push):
                # classify like any other death so a drain-window loss of
                # the half-built gang retries budget-exempt
                return (_kind(), f"worker group start failed: {e!r}")
            self.status = RunAttemptStatus.RUNNING
            self._publish_digest(force=True)
            while True:
                try:
                    polls = executor.poll()
                except Exception as e:  # a worker actor died mid-poll
                    return (_kind(), f"worker group failure: {e!r}")
                self._ingest_reports(polls)
                for rank, p in enumerate(polls):
                    if p["error"]:
                        return (
                            _kind(),
                            f"rank {rank} failed: {p['error']}",
                        )
                # done wins over a concurrent drain warning: a run whose
                # ranks all finished must return FINISHED, not be rebuilt
                # because its (now idle) node is being downscaled
                if all(p["done"] for p in polls):
                    self.status = RunAttemptStatus.FINISHED
                    return (FailureKind.WORKER, None)
                gang_draining = sorted(
                    self._draining_node_ids()
                    & set(executor.worker_node_ids())
                )
                if gang_draining:
                    # preemption warning for a gang member: checkpoint at
                    # the next step boundary and rebuild BEFORE the kill
                    TRAIN_STATS["preempt_restarts_total"] += 1
                    self._preempt_restarts += 1
                    if flightrec.REC is not None:
                        flightrec.REC.record(
                            "train", "train_preempt_detected",
                            run=self.experiment_name, attempt=attempt,
                            draining_nodes=gang_draining,
                        )
                    self._preempt_barrier(executor)
                    return (
                        FailureKind.PREEMPTION,
                        f"node(s) {gang_draining} entered a preemption "
                        "drain window: proactive checkpoint + restart",
                    )
                self._publish_digest()
                time.sleep(self.poll_interval_s)
        finally:
            executor.shutdown()

    def _ingest_reports(self, polls: List[Dict[str, Any]]):
        # rank 0 is authoritative for metrics + checkpoint registration
        for rank, poll in enumerate(polls):
            for rep in poll["reports"]:
                if rank == 0:
                    self._latest_metrics = rep["metrics"]
                    self._metrics_history.append(rep["metrics"])
                    self._cb("on_trial_result", rep["metrics"])
                    if "checkpoint_path" in rep:
                        self.checkpoint_manager.register(
                            Checkpoint(rep["checkpoint_path"]), rep["metrics"]
                        )

    # -- observability ---------------------------------------------------
    _DIGEST_RETENTION_S = 3600.0  # finished-run digests kept this long

    def _prune_stale_digests(self):
        """Head-KV hygiene: digests have no TTL head-side, so without this
        every run ever executed would accumulate in the KV (and in
        `ca status` output) for the head's lifetime.  Each starting
        controller sweeps digests of runs that reached a terminal state
        more than _DIGEST_RETENTION_S ago — recently finished runs stay
        visible, the store stays bounded by the active set + a 1h tail."""
        try:
            from ..core.worker import global_worker

            w = global_worker()
            cutoff = time.time() - self._DIGEST_RETENTION_S
            for key in w.head_call("kv_keys", prefix="train:run:")["keys"]:
                raw = w.head_call("kv_get", key=key).get("value")
                if not raw:
                    continue
                try:
                    info = json.loads(raw)
                except ValueError:
                    w.head_call("kv_del", key=key)  # undecodable: drop
                    continue
                if (
                    info.get("status")
                    in (
                        RunAttemptStatus.FINISHED.value,
                        RunAttemptStatus.ERRORED.value,
                    )
                    and info.get("updated_at", 0) < cutoff
                ):
                    w.head_call("kv_del", key=key)
        except Exception:
            pass  # hygiene only: never block a run on it

    def _publish_digest(self, force: bool = False):
        """~1s head-KV digest (`train:run:<name>`): `ca status`, the
        dashboard, and util.state.train_plane() see every active run's
        attempt / world size / last checkpoint without reaching into the
        driver process (serve controller's plane-digest idiom)."""
        now = time.monotonic()
        if not force and now - self._last_pub < 1.0:
            return
        self._last_pub = now
        try:
            from ..core.worker import global_worker

            latest = self.checkpoint_manager.latest_checkpoint
            info = {
                "status": self.status.value,
                "attempt": self._attempt,
                "world_size": self._world_size,
                "failure_count": self._failure_count,
                "preempt_restarts": self._preempt_restarts,
                "last_checkpoint": latest.path if latest else None,
                "last_metrics": {
                    k: v
                    for k, v in self._latest_metrics.items()
                    if isinstance(v, (int, float, str, bool))
                },
                "updated_at": time.time(),
            }
            global_worker().head_call(
                "kv_put",
                key=f"train:run:{self.experiment_name}",
                value=json.dumps(info, default=str).encode(),
            )
        except Exception:
            pass  # head briefly unreachable / not connected: next tick

    def _check_capacity(self):
        """Raise ValueError, naming the resource, when even the smallest
        gang the scaling policy may start needs more of a resource than the
        whole cluster has: there is no fallback to CPU workers."""
        import cluster_anywhere_tpu_torch as ca

        sc = self.scaling_config
        if isinstance(self.scaling_policy, ElasticScalingPolicy):
            n = sc.min_workers or 1
        else:
            n = self.scaling_policy.target_num_workers(sc, 0)
        have = ca.cluster_resources()
        for key, per in sc.bundle().items():
            if per > 0 and n * per > have.get(key, 0):
                raise ValueError(
                    f"train run {self.experiment_name!r}: {n} workers of "
                    f"{per:g} {key} each need {n * per:g} {key}, and the "
                    f"cluster has {have.get(key, 0):g} {key}"
                )

    # -- full run --------------------------------------------------------
    def run(self) -> Result:
        from ..core.worker import TRAIN_STATS

        self._check_capacity()
        failure_count = 0
        attempt = 0
        final_error: Optional[BaseException] = None
        self._prune_stale_digests()
        self._cb("on_trial_start")
        while True:
            kind, error = self._run_attempt(attempt)
            attempt += 1
            if error is None:
                break
            if kind == FailureKind.PREEMPTION:
                # announced exit: the restart is the system's to absorb
                TRAIN_STATS["budget_exempt_attempts_total"] += 1
            else:
                failure_count += 1
            self._failure_count = failure_count
            decision = self.failure_policy.decide(
                failure_count, error, kind=kind
            )
            if decision != FailureDecision.RETRY:
                self.status = RunAttemptStatus.ERRORED
                final_error = TrainingFailedError(message=error)
                break
        self._cb("on_trial_error" if final_error is not None else "on_trial_complete")
        # every attempt's worker group is down: safe to reclaim evictions
        # the write-grace window deferred
        self.checkpoint_manager.finalize()
        self._publish_digest(force=True)
        return Result(
            metrics=self._latest_metrics,
            checkpoint=self.checkpoint_manager.latest_checkpoint,
            path=os.path.join(
                self.run_config.resolved_storage_path(), self.experiment_name
            ),
            error=final_error,
            metrics_history=self._metrics_history,
            best_checkpoints=self.checkpoint_manager.best_checkpoints(),
        )
