"""TuneController: the experiment event loop (analogue of
python/ray/tune/execution/tune_controller.py TuneController).

Drives trial actors: starts trials as the searcher suggests configs and
resources admit, polls running trials for reports, feeds results to the
scheduler (early stopping) and searcher (model-based search), handles
failures with retry-from-checkpoint, applies PBT perturbations, and
persists experiment state for resume.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..core import api as ca
from ..core.actor import kill
from .hyperband import PAUSE
from .schedulers import CONTINUE, STOP, FIFOScheduler, TrialScheduler
from .search import BasicVariantGenerator, Searcher
from .trial import (
    ERRORED,
    PAUSED,
    PENDING,
    RUNNING,
    TERMINATED,
    Trial,
    TrialRunner,
)

_STATE_FILE = "experiment_state.json"


class TuneController:
    def __init__(
        self,
        trainable,
        param_space: Dict[str, Any],
        *,
        metric: Optional[str] = None,
        mode: str = "max",
        num_samples: int = 1,
        max_concurrent_trials: Optional[int] = None,
        search_alg: Optional[Searcher] = None,
        scheduler: Optional[TrialScheduler] = None,
        stop: Optional[Dict[str, Any]] = None,
        time_budget_s: Optional[float] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        max_failures: int = 0,
        experiment_dir: str = "",
        experiment_name: str = "exp",
        seed: Optional[int] = None,
        restored_trials: Optional[List[Trial]] = None,
        callbacks: Optional[List] = None,
    ):
        self.trainable = trainable
        self.metric = metric
        self.mode = mode
        self.stop_criteria = stop or {}
        self.time_budget_s = time_budget_s
        self.resources = resources_per_trial or {"num_cpus": 1}
        self.max_failures = max_failures
        self.experiment_dir = experiment_dir
        self.experiment_name = experiment_name
        self.searcher = search_alg or BasicVariantGenerator(
            num_samples=num_samples, seed=seed
        )
        self.searcher.set_search_properties(metric, mode, param_space)
        # model-based searchers (TPE/BOHB/...) suggest forever; an explicit
        # num_samples (> 1; the default 1 has always meant "unset" alongside
        # a search_alg here — searchers bound themselves by returning None,
        # or stop criteria end the run) is the experiment's trial budget for
        # them.  Without this cap a forever-suggesting searcher plus a
        # bracket scheduler creates trials unboundedly.
        self._sample_cap = (
            num_samples if search_alg is not None and num_samples > 1 else None
        )
        self.scheduler = scheduler or FIFOScheduler()
        self.scheduler.set_properties(metric or "_", mode)
        self.scheduler._controller = self
        if hasattr(self.scheduler, "attach_searcher"):
            # BOHB coupling: rung completions feed the searcher's
            # per-budget model (hyperband.HyperBandForBOHB)
            self.scheduler.attach_searcher(self.searcher)
        self.max_concurrent = max_concurrent_trials or max(
            1, int(ca.cluster_resources().get("CPU", 4))
        )
        self.callbacks = list(callbacks or [])
        self.trials: List[Trial] = list(restored_trials or [])
        self._trial_counter = len(self.trials)
        self._searcher_exhausted = False
        os.makedirs(experiment_dir, exist_ok=True)
        if param_space and restored_trials is None:
            import cloudpickle

            with open(os.path.join(experiment_dir, "search_space.pkl"), "wb") as f:
                cloudpickle.dump(param_space, f)

    # ------------------------------------------------------------------ loop
    def run(self) -> List[Trial]:
        deadline = (
            time.monotonic() + self.time_budget_s if self.time_budget_s else None
        )
        last_state_write = 0.0
        while True:
            self._drain_scheduler_queues()
            self._maybe_start_trials()
            running = [t for t in self.trials if t.status == RUNNING]
            if not running and (
                self._searcher_exhausted
                or not any(t.status == PENDING for t in self.trials)
            ):
                if any(t.status == PAUSED for t in self.trials):
                    # tell a sync scheduler no reinforcements are coming so
                    # partial cohorts promote; if that frees work, loop on
                    if hasattr(self.scheduler, "on_no_more_trials"):
                        self.scheduler.on_no_more_trials()
                        self._drain_scheduler_queues()
                        if any(
                            t.status in (PENDING, RUNNING) for t in self.trials
                        ):
                            continue
                    # remaining paused trials can never resume: close them out
                    for t in self.trials:
                        if t.status == PAUSED:
                            self._stop_trial(t, TERMINATED)
                break
            self._poll_running(running)
            if deadline is not None and time.monotonic() > deadline:
                for t in self.trials:
                    if t.status == RUNNING:
                        self._stop_trial(t, TERMINATED)
                break
            now = time.monotonic()
            if now - last_state_write > 2.0:
                self.save_state()
                last_state_write = now
            time.sleep(0.02)
        self.save_state()
        self._cb("on_experiment_end", self.trials)
        return self.trials

    # ------------------------------------------------------------- lifecycle
    def _drain_scheduler_queues(self):
        """Sync-scheduler hooks (hyperband.py): resume promoted paused
        trials from their checkpoints; terminate rung losers."""
        if hasattr(self.scheduler, "trials_to_stop"):
            for tid in self.scheduler.trials_to_stop():
                t = next((x for x in self.trials if x.trial_id == tid), None)
                if t is not None and t.status == PAUSED:
                    self._stop_trial(t, TERMINATED)
        if hasattr(self.scheduler, "trials_to_resume"):
            for tid, _budget in self.scheduler.trials_to_resume():
                t = next((x for x in self.trials if x.trial_id == tid), None)
                if t is not None and t.status == PAUSED:
                    # PENDING: _maybe_start_trials restarts it from
                    # trial.latest_checkpoint_path under the concurrency cap
                    t.status = PENDING

    @staticmethod
    def _release_actor(trial: Trial):
        """Kill the trial's actor (if any) and clear the handle — the one
        place actor-release semantics live."""
        if trial.actor is not None:
            try:
                kill(trial.actor)
            except Exception:
                pass
            trial.actor = None

    def _pause_trial(self, trial: Trial):
        """Checkpointed barrier stop: release the actor, keep the trial
        resumable (reference trial_runner PAUSED semantics)."""
        self._release_actor(trial)
        trial.status = PAUSED
        self._cb("on_trial_pause", trial)

    def _maybe_start_trials(self):
        while True:
            running = sum(1 for t in self.trials if t.status == RUNNING)
            if running >= self.max_concurrent:
                return
            pending = next((t for t in self.trials if t.status == PENDING), None)
            if pending is not None:
                self._start_trial(pending)
                continue
            if self._searcher_exhausted:
                return
            if (
                self._sample_cap is not None
                and self._trial_counter >= self._sample_cap
            ):
                self._searcher_exhausted = True
                return
            trial_id = f"{self.experiment_name}_{self._trial_counter:05d}"
            cfg = self.searcher.suggest(trial_id)
            if cfg is None:
                self._searcher_exhausted = True
                return
            if cfg == "pending":
                return
            self._trial_counter += 1
            trial = Trial(trial_id, cfg, self.experiment_dir)
            self.trials.append(trial)
            self._start_trial(trial)

    def _actor_options(self, trial: Optional[Trial] = None) -> Dict[str, Any]:
        opts = dict(self.resources)
        if trial is not None and getattr(trial, "resources", None):
            # per-trial override (ResourceChangingScheduler reallocation)
            opts.update(trial.resources)
        opts.setdefault("max_concurrency", 2)  # poll() while the fn runs
        return opts

    def _start_trial(self, trial: Trial, checkpoint_path: Optional[str] = None):
        Runner = ca.remote(TrialRunner).options(**self._actor_options(trial))
        trial.actor = Runner.remote(
            self.trainable,
            trial.config,
            trial.trial_id,
            trial.local_dir,
            self.experiment_name,
            self.experiment_dir,
            resume_checkpoint_path=checkpoint_path or trial.latest_checkpoint_path,
        )
        trial.status = RUNNING
        self._cb("on_trial_start", trial)

    def _cb(self, hook: str, *args):
        for cb in self.callbacks:
            try:
                getattr(cb, hook)(*args)
            except Exception:
                pass  # logging must never take down the experiment loop

    def _stop_trial(self, trial: Trial, status: str, error: Optional[str] = None):
        self._release_actor(trial)
        trial.status = status
        trial.error = error
        self.searcher.on_trial_complete(
            trial.trial_id, trial.last_result, error=status == ERRORED
        )
        self.scheduler.on_trial_complete(trial, trial.last_result)
        # terminal failures route through _on_trial_error, so this is always
        # a clean completion
        self._cb("on_trial_complete", trial)

    # ------------------------------------------------------------- polling
    def _poll_running(self, running: List[Trial]):
        if not running:
            return
        polls = []
        for t in running:
            try:
                polls.append(t.actor.poll.remote())
            except Exception:
                polls.append(None)
        for trial, ref in zip(running, polls):
            if ref is None:
                self._on_trial_error(trial, "actor submission failed")
                continue
            try:
                out = ca.get(ref, timeout=30)
            except Exception as e:
                self._on_trial_error(trial, f"poll failed: {e!r}")
                continue
            decision = CONTINUE
            for rep in out["reports"]:
                decision = self._on_report(trial, rep)
                if decision in (STOP, PAUSE):
                    break
            if decision == STOP:
                self._stop_trial(trial, TERMINATED)
                continue
            if decision == PAUSE:
                self._pause_trial(trial)
                continue
            if out["done"]:
                if out["error"]:
                    self._on_trial_error(trial, out["error"])
                else:
                    final = out.get("final_return")
                    if final:
                        rep = {"metrics": final, "seq": -1}
                        self._on_report(trial, rep)
                    self._stop_trial(trial, TERMINATED)
                continue
            self._maybe_perturb(trial)

    def _on_report(self, trial: Trial, rep: Dict[str, Any]) -> str:
        metrics = dict(rep["metrics"])
        metrics.setdefault("training_iteration", len(trial.metrics_history) + 1)
        metrics["trial_id"] = trial.trial_id
        if rep.get("checkpoint_path"):
            trial.latest_checkpoint_path = rep["checkpoint_path"]
            trial.checkpoint_paths.append(rep["checkpoint_path"])
        trial.last_result = metrics
        trial.metrics_history.append(metrics)
        self.searcher.on_trial_result(trial.trial_id, metrics)
        self._cb("on_trial_result", trial, metrics)
        decision = self.scheduler.on_trial_result(trial, metrics)
        if self._hit_stop_criteria(metrics):
            decision = STOP
        return decision

    def _hit_stop_criteria(self, metrics: Dict[str, Any]) -> bool:
        for k, v in self.stop_criteria.items():
            if callable(v):
                if v(metrics.get("trial_id"), metrics):
                    return True
            elif k in metrics and metrics[k] >= v:
                return True
        return False

    def _on_trial_error(self, trial: Trial, error: str):
        trial.num_failures += 1
        self._release_actor(trial)
        if self.max_failures < 0 or trial.num_failures <= self.max_failures:
            # retry from the latest checkpoint
            self._start_trial(trial)
        else:
            trial.status = ERRORED
            trial.error = error
            self.searcher.on_trial_complete(trial.trial_id, None, error=True)
            self.scheduler.on_trial_complete(trial, None)
            self._cb("on_trial_error", trial)

    def _maybe_perturb(self, trial: Trial):
        decision = self.scheduler.choose_perturbation(trial, self.trials)
        if not decision:
            return
        self._release_actor(trial)
        trial.config = decision["config"]
        if decision.get("resources"):
            trial.resources = dict(decision["resources"])
            # kill() releases the old actor's resources asynchronously; a
            # grown request can race that release and fail create_actor.
            # Wait (bounded) until the cluster can actually host the new
            # shape before restarting.
            need = float(trial.resources.get("num_cpus", 0))
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline:
                try:
                    if ca.available_resources().get("CPU", 0.0) >= need:
                        break
                except Exception:
                    break
                time.sleep(0.05)
        self._start_trial(trial, checkpoint_path=decision.get("checkpoint_path"))

    # ------------------------------------------------------------ persistence
    def save_state(self):
        state = {
            "experiment_name": self.experiment_name,
            "metric": self.metric,
            "mode": self.mode,
            "num_samples": getattr(self.searcher, "num_samples", None),
            "seed": getattr(self.searcher, "seed", None),
            "trials": [t.to_json() for t in self.trials],
        }
        path = os.path.join(self.experiment_dir, _STATE_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, path)

    @staticmethod
    def load_state(experiment_dir: str) -> Dict[str, Any]:
        with open(os.path.join(experiment_dir, _STATE_FILE)) as f:
            return json.load(f)
