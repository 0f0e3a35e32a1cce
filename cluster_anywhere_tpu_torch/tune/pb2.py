"""PB2: Population Based Bandit optimization (Parker-Holder et al., 2020).

Reference parity: ``python/ray/tune/schedulers/pb2.py`` / ``pb2_utils.py``.
PB2 keeps PBT's exploit step (bottom-quantile trial copies a top trial's
checkpoint) but replaces the random explore step with a GP-bandit: a
Gaussian process is fit to (previous config, time, reward change)
observations collected from the whole population, and the new config is the
UCB-maximising candidate — so hyperparameter schedules are *learned*, not
random-walked.  The reference leans on sklearn's GP; this implementation
carries its own ~30-line numpy GP (RBF kernel + jitter, exact solve — the
data set is the population history, tens of points)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .schedulers import PopulationBasedTraining
from .search_space import Float, Integer


class _TinyGP:
    """Exact GP regression, RBF kernel; fine for the tens of observations a
    PB2 population produces."""

    def __init__(self, length_scale: float = 0.3, noise: float = 1e-2):
        self.ls = length_scale
        self.noise = noise
        self.X: Optional[np.ndarray] = None

    def _k(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.ls**2))

    def fit(self, X: np.ndarray, y: np.ndarray):
        self.X = X
        self.y_mean = float(y.mean())
        self.y_std = float(y.std()) or 1.0
        yn = (y - self.y_mean) / self.y_std
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(self.L.T, np.linalg.solve(self.L, yn))

    def predict(self, Xq: np.ndarray):
        Ks = self._k(Xq, self.X)
        mu = Ks @ self.alpha
        v = np.linalg.solve(self.L, Ks.T)
        var = np.clip(1.0 - (v**2).sum(0), 1e-9, None)
        return mu * self.y_std + self.y_mean, np.sqrt(var) * self.y_std


class PB2(PopulationBasedTraining):
    """PBT with GP-UCB explore over the numeric hyperparams in
    `hyperparam_bounds` ({key: (low, high)} or search-space Domains)."""

    def __init__(
        self,
        time_attr: str = "training_iteration",
        perturbation_interval: int = 5,
        hyperparam_bounds: Optional[Dict[str, Any]] = None,
        quantile_fraction: float = 0.25,
        ucb_kappa: float = 2.0,
        num_candidates: int = 128,
        seed: Optional[int] = None,
    ):
        super().__init__(
            time_attr=time_attr,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={},
            quantile_fraction=quantile_fraction,
            seed=seed,
        )
        self.bounds: Dict[str, tuple] = {}
        for k, spec in (hyperparam_bounds or {}).items():
            if isinstance(spec, (Float, Integer)):
                self.bounds[k] = (float(spec.low), float(spec.high))
            else:
                lo, hi = spec
                self.bounds[k] = (float(lo), float(hi))
        self.kappa = ucb_kappa
        self.num_candidates = num_candidates
        # (normalized config vector, t, reward delta) observations
        self._data: List[tuple] = []
        self._last_seen: Dict[str, tuple] = {}  # trial -> (t, metric)

    # ------------------------------------------------------------ observation

    def on_trial_result(self, trial, result) -> str:
        t = result.get(self.time_attr)
        m = result.get(self.metric)
        if t is not None and m is not None:
            prev = self._last_seen.get(trial.trial_id)
            if prev is not None and t > prev[0]:
                delta = (float(m) - prev[1]) / max(1, t - prev[0])
                if self.mode == "min":
                    delta = -delta
                self._data.append((self._vec(trial.config), float(t), delta))
            self._last_seen[trial.trial_id] = (t, float(m))
        return super().on_trial_result(trial, result)

    def _vec(self, config: Dict[str, Any]) -> np.ndarray:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / (hi - lo + 1e-12))
        return np.asarray(out, dtype=float)

    # --------------------------------------------------------------- explore

    def choose_perturbation(self, trial, all_trials) -> Optional[Dict[str, Any]]:
        base = super().choose_perturbation(trial, all_trials)
        if base is None or not self.bounds:
            return base
        new_config = dict(base["config"])
        if len(self._data) >= 4:
            X = np.array([np.concatenate([v, [t]]) for v, t, _ in self._data])
            # normalize the time column so the RBF treats it like the others
            tmax = X[:, -1].max() or 1.0
            X[:, -1] /= tmax
            y = np.array([d for _, _, d in self._data])
            gp = _TinyGP()
            try:
                gp.fit(X, y)
                t_now = (trial.last_result or {}).get(self.time_attr, 0) / tmax
                cand = self.rng.random((self.num_candidates, len(self.bounds)))
                Xq = np.concatenate(
                    [cand, np.full((len(cand), 1), t_now)], axis=1
                )
                mu, sd = gp.predict(Xq)
                best = cand[int(np.argmax(mu + self.kappa * sd))]
            except np.linalg.LinAlgError:
                best = self.rng.random(len(self.bounds))
        else:
            best = self.rng.random(len(self.bounds))
        for i, (k, (lo, hi)) in enumerate(self.bounds.items()):
            v = lo + float(best[i]) * (hi - lo)
            if isinstance(new_config.get(k), int):
                v = int(round(v))
            new_config[k] = v
        base["config"] = new_config
        return base
