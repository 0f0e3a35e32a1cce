"""TuneBOHB: the model-based half of BOHB (Falkner et al., 2018).

Reference parity: ``python/ray/tune/search/bohb/bohb_search.py`` (which
wraps hpbandster's KDE model — unavailable offline, so the density model is
implemented here directly): per-BUDGET TPE.  For each rung budget we keep
the (config, metric) observations HyperBandForBOHB reports; suggestions
come from the largest budget with enough points — split into good/bad by
the top_n_percent quantile, fit a per-dimension kernel density (Gaussian
for numeric dims, category frequencies with add-one smoothing for
categorical), sample candidates from the good density and keep the one
maximizing good(x)/bad(x).  Until any budget has enough points, fall back
to random sampling — exactly BOHB's random fraction.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from .search import Searcher
from .search_space import Categorical, Domain, Float, Integer, resolve


class TuneBOHB(Searcher):
    def __init__(
        self,
        space: Optional[Dict[str, Any]] = None,
        *,
        min_points_in_model: Optional[int] = None,
        top_n_percent: int = 15,
        num_candidates: int = 64,
        random_fraction: float = 1 / 3,
        seed: Optional[int] = None,
    ):
        self.space = space or {}
        self.top_n_percent = top_n_percent
        self.num_candidates = num_candidates
        self.random_fraction = random_fraction
        self._min_points = min_points_in_model
        self.rng = np.random.default_rng(seed)
        # budget -> list of (config, metric)
        self.obs: Dict[int, List[tuple]] = {}
        # trial_id -> the config we suggested (controller completion results
        # carry metrics only, never the config)
        self._suggested: Dict[str, Dict[str, Any]] = {}
        self.metric = None
        self.mode = "max"

    def set_search_properties(self, metric, mode, space):
        self.metric, self.mode = metric, mode
        if space:
            self.space = space

    # ------------------------------------------------------------ observation

    def on_rung_result(self, budget: int, config: Dict[str, Any], metric: float):
        """HyperBandForBOHB feeds every rung completion here."""
        self.obs.setdefault(int(budget), []).append((config, float(metric)))

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._suggested.pop(trial_id, None)
        if result and self.metric in result and cfg is not None:
            # -1 = "unknown budget" bucket; real rung budgets (fed via
            # on_rung_result) always outrank it in suggest()'s budget pick
            self.on_rung_result(-1, cfg, result[self.metric])

    # -------------------------------------------------------------- suggest

    def _model_dims(self):
        dims = []
        for k, dom in self.space.items():
            if isinstance(dom, (Float, Integer, Categorical)):
                dims.append((k, dom))
        return dims

    def _to_unit(self, dom: Domain, v):
        if isinstance(dom, Float):
            if dom.log:
                return (math.log(v) - math.log(dom.low)) / (
                    math.log(dom.high) - math.log(dom.low) + 1e-12
                )
            return (v - dom.low) / (dom.high - dom.low + 1e-12)
        if isinstance(dom, Integer):
            # Integer.sample draws from [low, high) — normalize over the
            # actual value range [low, high-1] so the KDE tail can't land
            # on the excluded endpoint
            return (v - dom.low) / max(1, dom.high - 1 - dom.low)
        raise TypeError(dom)

    def _from_unit(self, dom: Domain, u: float):
        u = float(np.clip(u, 0.0, 1.0))
        if isinstance(dom, Float):
            if dom.log:
                v = math.exp(
                    math.log(dom.low) + u * (math.log(dom.high) - math.log(dom.low))
                )
            else:
                v = dom.low + u * (dom.high - dom.low)
            if dom.q:
                v = min(round(v / dom.q) * dom.q, dom.high)
            return float(v)
        if isinstance(dom, Integer):
            return int(round(dom.low + u * max(0, dom.high - 1 - dom.low)))
        raise TypeError(dom)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        dims = self._model_dims()
        budget = None
        min_pts = self._min_points or (len(dims) + 2)
        for b in sorted(self.obs, reverse=True):
            if len(self.obs[b]) >= max(min_pts, 4):
                budget = b
                break
        if budget is None or self.rng.random() < self.random_fraction or not dims:
            cfg = resolve(self.space, self.rng)
            self._suggested[trial_id] = dict(cfg)
            return cfg

        rows = self.obs[budget]
        vals = np.array([m for _, m in rows], dtype=float)
        if self.mode == "min":
            vals = -vals
        n_good = max(2, int(math.ceil(len(rows) * self.top_n_percent / 100)))
        order = np.argsort(-vals)
        good = [rows[i][0] for i in order[:n_good]]
        bad = [rows[i][0] for i in order[n_good:]] or good

        def densities(cfgs, key, dom):
            if isinstance(dom, Categorical):
                counts = {c: 1.0 for c in dom.categories}  # add-one smoothing
                for c in cfgs:
                    if key in c and c[key] in counts:
                        counts[c[key]] += 1.0
                tot = sum(counts.values())
                return {c: n / tot for c, n in counts.items()}
            xs = np.array(
                [self._to_unit(dom, c[key]) for c in cfgs if key in c], dtype=float
            )
            if len(xs) == 0:
                xs = np.array([0.5])
            bw = max(1e-3, xs.std() * len(xs) ** (-1 / 5) + 1e-3)  # Scott
            return (xs, bw)

        def logpdf(model, dom, v):
            if isinstance(dom, Categorical):
                return math.log(model.get(v, 1e-12))
            xs, bw = model
            u = self._to_unit(dom, v)
            z = (u - xs) / bw
            return float(
                np.log(np.mean(np.exp(-0.5 * z * z)) / (bw * math.sqrt(2 * math.pi)) + 1e-300)
            )

        good_m = {k: densities(good, k, dom) for k, dom in dims}
        bad_m = {k: densities(bad, k, dom) for k, dom in dims}

        best_cfg, best_score = None, -np.inf
        for _ in range(self.num_candidates):
            cand = resolve(self.space, self.rng)
            for k, dom in dims:
                # sample numeric dims from the good KDE (mixture draw),
                # categoricals from the good frequency table
                if isinstance(dom, Categorical):
                    cats = list(good_m[k].keys())
                    probs = np.array([good_m[k][c] for c in cats])
                    cand[k] = cats[self.rng.choice(len(cats), p=probs / probs.sum())]
                else:
                    xs, bw = good_m[k]
                    center = xs[self.rng.integers(len(xs))]
                    cand[k] = self._from_unit(dom, self.rng.normal(center, bw))
            score = sum(
                logpdf(good_m[k], dom, cand[k]) - logpdf(bad_m[k], dom, cand[k])
                for k, dom in dims
            )
            if score > best_score:
                best_cfg, best_score = cand, score
        self._suggested[trial_id] = dict(best_cfg or {})
        return best_cfg
