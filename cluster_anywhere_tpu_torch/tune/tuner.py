"""Tuner: the user-facing HPO entrypoint (analogue of python/ray/tune/tuner.py
Tuner + tune/result_grid.py ResultGrid).

Counterpart of cluster_anywhere_tpu/tune/tuner.py, which it copies, with
one change: a trial's `"gpu"` resource (`with_resources`) becomes the
actor's `num_gpus`, so the trial runs in the GPU pool with the card in view,
where the JAX package maps `"tpu"` to `num_tpus`; a `"tpu"` key raises.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..train.checkpoint import Checkpoint
from ..train.config import RunConfig
from ..train.controller import Result
from .controller import TuneController, _STATE_FILE
from .schedulers import TrialScheduler
from .search import Searcher
from .trial import ERRORED, TERMINATED, Trial


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    time_budget_s: Optional[float] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")


class ResultGrid:
    def __init__(self, results: List[Result], experiment_path: str):
        self._results = results
        self.experiment_path = experiment_path

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> Result:
        metric = metric or getattr(self, "_default_metric", None)
        mode = mode or getattr(self, "_default_mode", "max")
        if metric is None:
            raise ValueError("pass metric= or set TuneConfig.metric")
        scored = [
            r for r in self._results if r.error is None and metric in (r.metrics or {})
        ]
        if not scored:
            raise RuntimeError("no successful trial reported the metric")
        key = lambda r: r.metrics[metric]
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = dict(r.metrics or {})
            for k, v in (r.config or {}).items():
                row[f"config/{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)


# Result gains a config field for tune results via subclass
@dataclass
class TrialResult(Result):
    config: Dict[str, Any] = field(default_factory=dict)


class Tuner:
    def __init__(
        self,
        trainable: Callable[[Dict[str, Any]], Any],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        _restored_trials: Optional[List[Trial]] = None,
        _experiment_dir: Optional[str] = None,
    ):
        from ..train.trainer import DataParallelTrainer

        if isinstance(trainable, DataParallelTrainer):
            raise TypeError(
                "pass the train loop function; wrap trainers with tune_trainer()"
            )
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restored_trials = _restored_trials
        self._experiment_dir = _experiment_dir

    def _resources(self) -> Dict[str, Any]:
        return _actor_resources(getattr(self.trainable, "_tune_resources", None))

    def fit(self) -> ResultGrid:
        name = self.run_config.name or f"tune_{int(time.time())}"
        exp_dir = self._experiment_dir or os.path.join(
            self.run_config.resolved_storage_path(), name
        )
        fn = self.trainable
        base = getattr(fn, "_tune_wrapped", fn)
        controller = TuneController(
            base,
            self.param_space,
            metric=self.tune_config.metric,
            mode=self.tune_config.mode,
            num_samples=self.tune_config.num_samples,
            max_concurrent_trials=self.tune_config.max_concurrent_trials,
            search_alg=self.tune_config.search_alg,
            scheduler=self.tune_config.scheduler,
            time_budget_s=self.tune_config.time_budget_s,
            resources_per_trial=self._resources(),
            max_failures=self.run_config.failure_config.max_failures,
            experiment_dir=exp_dir,
            experiment_name=name,
            seed=self.tune_config.seed,
            restored_trials=self._restored_trials,
            callbacks=self.run_config.callbacks,
        )
        trials = controller.run()
        results = []
        for t in trials:
            results.append(
                TrialResult(
                    metrics=t.last_result or {},
                    checkpoint=(
                        Checkpoint(t.latest_checkpoint_path)
                        if t.latest_checkpoint_path
                        else None
                    ),
                    path=t.local_dir,
                    error=RuntimeError(t.error) if t.status == ERRORED else None,
                    metrics_history=t.metrics_history,
                    config=t.config,
                )
            )
        grid = ResultGrid(results, exp_dir)
        grid._default_metric = self.tune_config.metric
        grid._default_mode = self.tune_config.mode
        return grid

    @classmethod
    def can_restore(cls, path: str) -> bool:
        return os.path.exists(os.path.join(path, _STATE_FILE))

    @classmethod
    def restore(
        cls,
        path: str,
        trainable: Callable[[Dict[str, Any]], Any],
        *,
        resume_errored: bool = False,
        restart_errored: bool = False,
    ) -> "Tuner":
        """Resume an interrupted experiment from its state file: finished
        trials keep their results; unfinished (and optionally errored) trials
        run again, resuming from their latest checkpoint."""
        state = TuneController.load_state(path)
        trials = []
        for tj in state["trials"]:
            t = Trial.from_json(tj, path)
            if t.status not in (TERMINATED, ERRORED):
                t.status = "PENDING"
            elif t.status == ERRORED and resume_errored:
                t.status = "PENDING"
            elif t.status == ERRORED and restart_errored:
                t.status = "PENDING"
                t.latest_checkpoint_path = None
            trials.append(t)
        # reconstruct the searcher so not-yet-suggested samples still run:
        # the variant sequence is deterministic given (space, seed), so
        # fast-forwarding past len(trials) yields exactly the remainder
        param_space: Dict[str, Any] = {}
        search_alg = None
        space_file = os.path.join(path, "search_space.pkl")
        if os.path.exists(space_file) and state.get("num_samples"):
            import cloudpickle

            from .search import BasicVariantGenerator

            with open(space_file, "rb") as f:
                param_space = cloudpickle.load(f)
            bv = BasicVariantGenerator(
                num_samples=state["num_samples"], seed=state.get("seed")
            )
            bv.set_search_properties(state.get("metric"), state.get("mode", "max"), param_space)
            bv._expand()
            bv._i = min(len(trials), len(bv._variants))
            search_alg = bv
        tc = TuneConfig(
            metric=state.get("metric"),
            mode=state.get("mode", "max"),
            num_samples=0,
            search_alg=search_alg,
        )
        rc = RunConfig(name=state.get("experiment_name"))
        return cls(
            trainable,
            param_space=param_space,
            tune_config=tc,
            run_config=rc,
            _restored_trials=trials,
            _experiment_dir=path,
        )


def _actor_resources(res: Optional[Dict[str, float]]) -> Dict[str, Any]:
    """A trial's actor options from its with_resources request: "cpu" is
    num_cpus, "gpu" num_gpus (a whole count or a fraction below one; the
    trial runs in the GPU pool), anything else a custom resource; "tpu"
    raises."""
    out: Dict[str, Any] = {"num_cpus": 1}
    if res:
        if "tpu" in res:
            raise ValueError(
                "with_resources(..., {'tpu': ...}): the port runs trials on "
                "GPUs; ask for them with {'gpu': n}"
            )
        if "cpu" in res:
            out["num_cpus"] = res["cpu"]
        if "gpu" in res:
            from ..core.accelerators import validate_chip_request

            validate_chip_request(res["gpu"])
            out["num_gpus"] = res["gpu"]
        extra = {k: v for k, v in res.items() if k not in ("cpu", "gpu")}
        if extra:
            out["resources"] = extra
    return out


def with_resources(trainable: Callable, resources: Dict[str, float]) -> Callable:
    """Attach per-trial resource requests (reference tune/tune.py with_resources)."""
    _actor_resources(resources)  # refuse a "tpu" request here, not at fit()

    def wrapped(config):
        return trainable(config)

    wrapped._tune_wrapped = trainable
    wrapped._tune_resources = resources
    wrapped.__name__ = getattr(trainable, "__name__", "trainable")
    return wrapped


def with_parameters(trainable: Callable, **params) -> Callable:
    """Bind large constant objects outside the search space
    (reference tune/trainable/util.py with_parameters)."""

    def wrapped(config):
        return trainable(config, **params)

    wrapped.__name__ = getattr(trainable, "__name__", "trainable")
    return wrapped
