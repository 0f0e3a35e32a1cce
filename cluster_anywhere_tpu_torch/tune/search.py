"""Searchers (analogue of python/ray/tune/search/ — BasicVariantGenerator,
Searcher interface, ConcurrencyLimiter, and a TPE-flavoured model-based
searcher standing in for the Optuna/HyperOpt integrations).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

import numpy as np

from .search_space import Domain, grid_axes, resolve, set_path


class Searcher:
    """suggest(trial_id) -> config | None (exhausted) | "pending" (wait)."""

    metric: Optional[str] = None
    mode: str = "max"

    def set_search_properties(self, metric: Optional[str], mode: str, space: Dict[str, Any]):
        self.metric, self.mode, self.space = metric, mode, space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]):
        pass

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict[str, Any]] = None, error: bool = False
    ):
        pass


class BasicVariantGenerator(Searcher):
    """Grid axes expanded combinatorially x num_samples random draws
    (reference tune/search/basic_variant.py)."""

    def __init__(self, num_samples: int = 1, seed: Optional[int] = None):
        self.num_samples = num_samples
        self.seed = seed  # persisted so restore() replays the same variants
        self.rng = np.random.default_rng(seed)
        self._variants: Optional[List[Dict[str, Any]]] = None
        self._i = 0

    def _expand(self):
        import copy

        axes = grid_axes(self.space)
        variants = []
        for _ in range(self.num_samples):
            if axes:
                for combo in itertools.product(*[vals for _, vals in axes]):
                    cfg = copy.deepcopy(self.space)
                    for (path, _), val in zip(axes, combo):
                        set_path(cfg, path, val)
                    variants.append(resolve(cfg, self.rng))
            else:
                variants.append(resolve(self.space, self.rng))
        self._variants = variants

    def total_variants(self) -> int:
        if self._variants is None:
            self._expand()
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._variants is None:
            self._expand()
        if self._i >= len(self._variants):
            return None
        cfg = self._variants[self._i]
        self._i += 1
        return cfg


class RandomSearch(BasicVariantGenerator):
    pass


class TPESearcher(Searcher):
    """Tree-structured-Parzen-flavoured model-based search: split observed
    trials into good/bad by quantile `gamma`, sample candidates, pick the one
    most likely under the good distribution (density ratio via per-dimension
    Gaussian KDE over normalized params).  Stands in for the reference's
    OptunaSearch (tune/search/optuna/optuna_search.py) without the external
    dependency.
    """

    def __init__(
        self,
        n_startup_trials: int = 10,
        gamma: float = 0.25,
        n_candidates: int = 24,
        seed: Optional[int] = None,
    ):
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = np.random.default_rng(seed)
        self._observed: List[tuple] = []  # (config, score)
        self._live: Dict[str, Dict[str, Any]] = {}

    def _numeric_keys(self) -> List[str]:
        from .search_space import Categorical, Float, Integer

        keys = []
        for k, v in self.space.items():
            if isinstance(v, (Float, Integer)):
                keys.append(k)
        return keys

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._observed) < self.n_startup:
            cfg = resolve(self.space, self.rng)
            self._live[trial_id] = cfg
            return cfg
        keys = self._numeric_keys()
        if not keys:
            cfg = resolve(self.space, self.rng)
            self._live[trial_id] = cfg
            return cfg
        scores = np.asarray([s for _, s in self._observed])
        order = np.argsort(-scores if self.mode == "max" else scores)
        n_good = max(1, int(len(order) * self.gamma))
        good = [self._observed[i][0] for i in order[:n_good]]
        bad = [self._observed[i][0] for i in order[n_good:]] or good
        candidates = [resolve(self.space, self.rng) for _ in range(self.n_candidates)]

        def loglik(cfg, population):
            ll = 0.0
            for k in keys:
                vals = np.asarray([float(p[k]) for p in population])
                x = float(cfg[k])
                scale = max(vals.std(), 1e-6 * max(abs(x), 1.0), 1e-12)
                ll += np.log(
                    np.mean(np.exp(-0.5 * ((x - vals) / scale) ** 2) / scale) + 1e-300
                )
            return ll

        best = max(candidates, key=lambda c: loglik(c, good) - loglik(c, bad))
        self._live[trial_id] = best
        return best

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._live.pop(trial_id, None)
        if cfg is not None and result is not None and not error and self.metric in result:
            self._observed.append((cfg, float(result[self.metric])))


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference tune/search/concurrency_limiter.py)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, space):
        super().set_search_properties(metric, mode, space)
        self.searcher.set_search_properties(metric, mode, space)

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return "pending"
        cfg = self.searcher.suggest(trial_id)
        if isinstance(cfg, dict):
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)
