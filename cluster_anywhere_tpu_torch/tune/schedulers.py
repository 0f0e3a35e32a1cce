"""Trial schedulers (analogue of python/ray/tune/schedulers/ —
FIFOScheduler, AsyncHyperBandScheduler/ASHA, MedianStoppingRule,
PopulationBasedTraining).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional

import numpy as np

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def set_properties(self, metric: str, mode: str):
        self.metric, self.mode = metric, mode

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial, result: Optional[Dict[str, Any]]):
        pass

    def choose_perturbation(self, trial, all_trials) -> Optional[Dict[str, Any]]:
        """PBT hook: non-None => restart `trial` with {config, checkpoint}."""
        return None


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference tune/schedulers/async_hyperband.py): rungs at
    grace_period * reduction_factor^k; a trial reaching a rung is stopped
    unless it is in the top 1/reduction_factor of completions at that rung."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        reduction_factor: float = 4,
        max_t: int = 100,
        brackets: int = 1,
    ):
        self.time_attr = time_attr
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        # brackets start their rung ladders at grace * rf^b (late rungs stop
        # less aggressively — the standard late-bloomer defense); trials are
        # assigned round-robin
        self.num_brackets = max(1, brackets)
        # (bracket, rung value) -> recorded metric values
        self.rungs: Dict[tuple, List[float]] = defaultdict(list)
        self._bracket_levels: List[List[int]] = []
        for b in range(self.num_brackets):
            levels = []
            t = int(np.ceil(grace_period * reduction_factor**b))
            while t < max_t:
                levels.append(t)
                t = int(np.ceil(t * reduction_factor))
            self._bracket_levels.append(levels)
        self._assign_counter = 0
        self._trial_bracket: Dict[str, int] = {}

    def _bracket_of(self, trial) -> int:
        b = self._trial_bracket.get(trial.trial_id)
        if b is None:
            b = self._assign_counter % self.num_brackets
            self._assign_counter += 1
            self._trial_bracket[trial.trial_id] = b
        return b

    def on_trial_result(self, trial, result) -> str:
        t = result.get(self.time_attr)
        v = result.get(self.metric)
        if t is None or v is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        bracket = self._bracket_of(trial)
        decision = CONTINUE
        for rung in self._bracket_levels[bracket]:
            if t < rung or rung in trial.rungs_recorded:
                continue
            trial.rungs_recorded.add(rung)
            recorded = self.rungs[(bracket, rung)]
            sign = 1.0 if self.mode == "max" else -1.0
            recorded.append(sign * float(v))
            if len(recorded) >= self.rf:
                cutoff = np.quantile(recorded, 1.0 - 1.0 / self.rf)
                if sign * float(v) < cutoff:
                    decision = STOP
        return decision


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far is worse than the median of the
    running averages of completed trials at the same step
    (reference tune/schedulers/median_stopping_rule.py)."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._avgs: Dict[str, List[float]] = defaultdict(list)

    def on_trial_result(self, trial, result) -> str:
        t = result.get(self.time_attr)
        v = result.get(self.metric)
        if t is None or v is None or t < self.grace:
            return CONTINUE
        self._avgs[trial.trial_id].append(float(v))
        mine = np.mean(self._avgs[trial.trial_id])
        others = [np.mean(vals) for tid, vals in self._avgs.items() if tid != trial.trial_id]
        if len(others) < self.min_samples:
            return CONTINUE
        med = np.median(others)
        worse = mine < med if self.mode == "max" else mine > med
        return STOP if worse else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference tune/schedulers/pbt.py): every perturbation_interval
    steps, a bottom-quantile trial exploits a top-quantile trial (copies its
    checkpoint + config) and explores (mutates hyperparams)."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        perturbation_interval: int = 5,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: Optional[int] = None,
    ):
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.rng = np.random.default_rng(seed)

    def on_trial_result(self, trial, result) -> str:
        t = result.get(self.time_attr)
        if t is not None and t - trial.last_perturb_t >= self.interval:
            trial.ready_to_perturb = True
        return CONTINUE

    def choose_perturbation(self, trial, all_trials) -> Optional[Dict[str, Any]]:
        if not getattr(trial, "ready_to_perturb", False):
            return None
        trial.ready_to_perturb = False
        trial.last_perturb_t = (trial.last_result or {}).get(self.time_attr, 0)
        scored = [
            tr
            for tr in all_trials
            if tr.last_result and self.metric in tr.last_result
        ]
        if len(scored) < 2:
            return None
        sign = 1.0 if self.mode == "max" else -1.0
        scored.sort(key=lambda tr: sign * float(tr.last_result[self.metric]))
        n = max(1, int(len(scored) * self.quantile))
        bottom, top = scored[:n], scored[-n:]
        if trial not in bottom:
            return None
        src = top[int(self.rng.integers(0, len(top)))]
        if src is trial:
            return None
        new_config = dict(src.config)
        for k, spec in self.mutations.items():
            if self.rng.random() < self.resample_prob or k not in new_config:
                new_config[k] = self._sample(spec)
            else:
                factor = 1.2 if self.rng.random() > 0.5 else 0.8
                if isinstance(new_config[k], (int, float)):
                    new_config[k] = type(new_config[k])(new_config[k] * factor)
        return {"config": new_config, "checkpoint_path": src.latest_checkpoint_path}

    def _sample(self, spec):
        from .search_space import Domain

        if isinstance(spec, Domain):
            return spec.sample(self.rng)
        if isinstance(spec, list):
            return spec[int(self.rng.integers(0, len(spec)))]
        if callable(spec):
            return spec()
        return spec
