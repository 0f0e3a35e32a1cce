"""ResourceChangingScheduler: reallocate trial resources mid-experiment.

Reference parity: ``python/ray/tune/schedulers/resource_changing_scheduler.py``
(ResourceChangingScheduler + DistributeResources).  Wraps any base
scheduler; after results arrive it may propose a new resource allocation
for a trial, which the controller applies by restarting the trial from its
latest checkpoint with the new actor options — the same restart path PBT
perturbations use.

`DistributeResources` is the canonical allocation policy: spread the
cluster's free CPUs evenly across live trials (each keeps at least its
base request), so finished trials' resources flow to the survivors.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from .schedulers import TrialScheduler


class DistributeResources:
    """Evenly share total CPUs across live trials (>= base each)."""

    def __init__(self, base_cpus: float = 1.0):
        self.base_cpus = base_cpus

    def __call__(self, controller, trial, all_trials) -> Optional[Dict[str, float]]:
        from ..core import api as ca

        live = [
            t for t in all_trials
            if t.status in ("RUNNING", "PENDING", "PAUSED")
        ]
        if not live:
            return None
        try:
            total = float(ca.cluster_resources().get("CPU", 0))
        except Exception:
            return None
        share = max(self.base_cpus, total // max(1, len(live)))
        return {"num_cpus": float(share)}


class ResourceChangingScheduler(TrialScheduler):
    def __init__(
        self,
        base_scheduler: Optional[TrialScheduler] = None,
        resources_allocation_function: Optional[Callable] = None,
        reallocate_interval_s: float = 5.0,
    ):
        self.base = base_scheduler or TrialScheduler()
        self.alloc = resources_allocation_function or DistributeResources()
        self.interval = reallocate_interval_s
        self._last_alloc: Dict[str, float] = {}  # trial_id -> last check ts

    def set_properties(self, metric: str, mode: str):
        super().set_properties(metric, mode)
        self.base.set_properties(metric, mode)

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        return self.base.on_trial_result(trial, result)

    def on_trial_complete(self, trial, result):
        self.base.on_trial_complete(trial, result)

    def attach_searcher(self, searcher):
        fn = getattr(self.base, "attach_searcher", None)
        if fn:
            fn(searcher)  # BOHB coupling survives the wrapping

    def choose_perturbation(self, trial, all_trials) -> Optional[Dict[str, Any]]:
        base_decision = self.base.choose_perturbation(trial, all_trials)
        if base_decision is not None:
            return base_decision
        if trial.latest_checkpoint_path is None:
            # a restart without a checkpoint replays the trial from step 0;
            # reallocation is never worth losing progress
            return None
        now = time.monotonic()
        if now - self._last_alloc.get(trial.trial_id, 0.0) < self.interval:
            return None
        self._last_alloc[trial.trial_id] = now
        # the allocation function sees the controller when the controller
        # installed itself (duck-typed: None works for policies that only
        # need the trials + cluster state)
        ctrl = getattr(self, "_controller", None)
        new_res = self.alloc(ctrl, trial, all_trials)
        if not new_res:
            return None
        # effective current = controller base overlaid with any prior
        # reallocation, so the first proposal equal to the base shape is
        # recognized as "no change" instead of forcing a spurious restart
        base_res = dict(getattr(ctrl, "resources", None) or {})
        current = {**base_res, **(getattr(trial, "resources", None) or {})}
        if all(current.get(k) == v for k, v in new_res.items()):
            return None  # no change: don't churn a restart
        return {
            "config": dict(trial.config),
            "checkpoint_path": trial.latest_checkpoint_path,
            "resources": dict(new_res),
        }

    # pass-through of the sync-scheduler hooks so wrapping HyperBand works
    def trials_to_resume(self):
        fn = getattr(self.base, "trials_to_resume", None)
        return fn() if fn else []

    def trials_to_stop(self):
        fn = getattr(self.base, "trials_to_stop", None)
        return fn() if fn else []

    def on_no_more_trials(self):
        fn = getattr(self.base, "on_no_more_trials", None)
        if fn:
            fn()
