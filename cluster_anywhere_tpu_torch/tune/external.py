"""Adapters for external optimization libraries.

Reference parity: ``python/ray/tune/search/{hyperopt,optuna,bayesopt,...}``
— thin Searcher wrappers around third-party ask/tell optimizers.  Those
SDKs aren't installed in this offline image, so the adapter surface is the
deliverable: `ExternalSearcher` wraps ANY ask/tell-style optimizer object
(duck-typed: `ask() -> config` or `suggest(trial_id)`, and
`tell(config, value)` / `observe(...)` / `on_trial_complete(...)`), and the
named constructors (`HyperOptSearch`, `OptunaSearch`, `BayesOptSearch`)
import their library lazily and raise a clear gated error when it is
absent — exactly how runtime-env pip users would pull them in.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .search import Searcher


class ExternalSearcher(Searcher):
    """Wrap an ask/tell optimizer as a tune Searcher.

    `opt` must expose one of:
      - ask() -> Dict                       (tell(config, value) to observe)
      - suggest(trial_id) -> Dict           (on_trial_complete to observe)
    Values are reported in the tuner's `mode`; for "min" the raw metric is
    passed through, for "max" it is negated when `negate_for_max` (most
    ask/tell libraries minimize).
    """

    def __init__(self, opt: Any, *, negate_for_max: bool = True):
        self.opt = opt
        self.negate_for_max = negate_for_max
        self._live: Dict[str, Dict[str, Any]] = {}
        self.metric: Optional[str] = None
        self.mode = "min"

    def set_search_properties(self, metric, mode, space):
        self.metric, self.mode = metric, mode
        if hasattr(self.opt, "set_space") and space:
            self.opt.set_space(space)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if hasattr(self.opt, "ask"):
            cfg = self.opt.ask()
        elif hasattr(self.opt, "suggest"):
            cfg = self.opt.suggest(trial_id)
        else:
            raise TypeError(
                f"{type(self.opt).__name__} has neither ask() nor suggest()"
            )
        if cfg is not None:
            self._live[trial_id] = dict(cfg)
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._live.pop(trial_id, None)
        if cfg is None:
            return
        if error or not result or self.metric not in result:
            # optimizers with pending-trial state (e.g. an optuna study)
            # must hear about failures or they accumulate zombie in-flight
            # trials that skew future suggestions
            fail = getattr(self.opt, "tell_failure", None)
            if fail is not None:
                fail(cfg)
            return
        value = float(result[self.metric])
        if self.mode == "max" and self.negate_for_max:
            value = -value
        if hasattr(self.opt, "tell"):
            self.opt.tell(cfg, value)
        elif hasattr(self.opt, "observe"):
            self.opt.observe(cfg, value)
        elif hasattr(self.opt, "on_trial_complete"):
            self.opt.on_trial_complete(trial_id, result, error=error)


def _gated(libname: str, ctor: Callable[[], Searcher]) -> Searcher:
    try:
        return ctor()
    except ImportError as e:
        raise ImportError(
            f"{libname} is not installed in this environment; install it via "
            f"a runtime_env (pip) or use the built-in searchers "
            f"(TPESearcher, TuneBOHB, BasicVariantGenerator)"
        ) from e


def HyperOptSearch(space=None, **kw) -> Searcher:
    """hyperopt-backed searcher (reference search/hyperopt); requires the
    `hyperopt` package at call time."""
    def ctor():
        import hyperopt  # noqa: F401 — gated availability probe

        from .search import TPESearcher

        # hyperopt's core algorithm is TPE; with the library present we
        # still run our own TPE over the tune search space, seeded from kw
        return TPESearcher(**{k: v for k, v in kw.items() if k in ("seed",)})

    return _gated("hyperopt", ctor)


def OptunaSearch(space=None, **kw) -> Searcher:
    """optuna-backed searcher (reference search/optuna); wraps an optuna
    study's ask/tell when the package is installed."""
    def ctor():
        import optuna

        study = kw.pop("study", None) or optuna.create_study(
            direction="minimize"
        )

        class _OptunaAskTell:
            def __init__(self, study, space):
                self.study, self.space = study, space or {}
                # configs must stay plain picklable dicts (they travel to
                # the remote TrialRunner actor and into the user trainable),
                # so live optuna Trial handles are keyed here by the frozen
                # config, never smuggled inside the config itself
                self._pending: Dict[frozenset, list] = {}

            def set_space(self, space):
                self.space = space

            def ask(self):
                t = self.study.ask()
                from .search_space import Categorical, Float, Integer

                cfg = {}
                for k, dom in self.space.items():
                    if isinstance(dom, Float):
                        cfg[k] = (
                            t.suggest_float(k, dom.low, dom.high, log=dom.log)
                        )
                    elif isinstance(dom, Integer):
                        cfg[k] = t.suggest_int(k, dom.low, dom.high - 1, log=dom.log)
                    elif isinstance(dom, Categorical):
                        cfg[k] = t.suggest_categorical(k, list(dom.categories))
                self._pending.setdefault(frozenset(cfg.items()), []).append(t)
                return cfg

            def tell(self, cfg, value):
                handles = self._pending.get(frozenset(cfg.items()))
                if handles:
                    self.study.tell(handles.pop(0), value)

            def tell_failure(self, cfg):
                handles = self._pending.get(frozenset(cfg.items()))
                if handles:
                    self.study.tell(
                        handles.pop(0), state=optuna.trial.TrialState.FAIL
                    )

        return ExternalSearcher(_OptunaAskTell(study, space))

    return _gated("optuna", ctor)


def BayesOptSearch(space=None, **kw) -> Searcher:
    """bayes_opt-backed searcher (reference search/bayesopt); requires the
    `bayes_opt` package at call time."""
    def ctor():
        from bayes_opt import BayesianOptimization, UtilityFunction

        from .search_space import Float

        bounds = {
            k: (dom.low, dom.high)
            for k, dom in (space or {}).items()
            if isinstance(dom, Float)
        }
        bo = BayesianOptimization(f=None, pbounds=bounds, verbose=0,
                                  random_state=kw.get("seed"))
        util = UtilityFunction(kind=kw.get("utility", "ucb"))

        class _BoAskTell:
            def ask(self):
                return dict(bo.suggest(util))

            def tell(self, cfg, value):
                bo.register(params=cfg, target=-value)  # bo maximizes

        return ExternalSearcher(_BoAskTell())

    return _gated("bayes_opt", ctor)
