"""Experiment callbacks + logger integrations.

Reference parity: ``python/ray/tune/callback.py`` (Callback hook surface),
``python/ray/tune/logger/{json,csv}.py`` (per-trial result logging), and the
AIR tracking integrations (``air/integrations/mlflow.py``).  The MLflow
logger here writes the *file-store layout* directly (mlruns/<exp>/<run>/
params|metrics|tags) so a stock ``mlflow ui`` can browse experiments without
the mlflow package being importable in this zero-dependency environment.
"""

from __future__ import annotations

import csv
import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional


class Callback:
    """Hook surface invoked by the tune controller (tune/callback.py)."""

    def on_trial_start(self, trial) -> None: ...

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None: ...

    def on_trial_complete(self, trial) -> None: ...

    def on_trial_error(self, trial) -> None: ...

    def on_experiment_end(self, trials: List[Any]) -> None: ...


class JsonLoggerCallback(Callback):
    """Append every result as one JSON line in the trial dir
    (tune/logger/json.py result.json)."""

    def __init__(self):
        self._files: Dict[str, Any] = {}

    def on_trial_start(self, trial) -> None:
        # restart-safe: retry-from-checkpoint / PBT re-invoke this for the
        # same trial — keep appending through the existing handle
        if trial.trial_id in self._files:
            return
        os.makedirs(trial.local_dir, exist_ok=True)
        self._files[trial.trial_id] = open(
            os.path.join(trial.local_dir, "result.json"), "a", buffering=1
        )
        with open(os.path.join(trial.local_dir, "params.json"), "w") as f:
            json.dump(trial.config, f, default=str)

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        f = self._files.get(trial.trial_id)
        if f is not None:
            f.write(json.dumps(result, default=str) + "\n")

    def _close(self, trial) -> None:
        f = self._files.pop(trial.trial_id, None)
        if f is not None:
            f.close()

    on_trial_complete = _close
    on_trial_error = _close


class CSVLoggerCallback(Callback):
    """progress.csv per trial (tune/logger/csv.py); columns fixed by the
    first result, later unknown keys are dropped like the reference."""

    def __init__(self):
        self._writers: Dict[str, Any] = {}

    def on_trial_start(self, trial) -> None:
        if trial.trial_id in self._writers:  # trial restart: keep appending
            return
        os.makedirs(trial.local_dir, exist_ok=True)
        path = os.path.join(trial.local_dir, "progress.csv")
        keys = None
        if os.path.exists(path) and os.path.getsize(path) > 0:
            # resuming an experiment: adopt the existing header instead of
            # writing a second one mid-file
            with open(path, newline="") as existing:
                header = existing.readline().strip()
            keys = header.split(",") if header else None
        f = open(path, "a", newline="")
        st = {"file": f, "writer": None, "keys": keys}
        if keys:
            st["writer"] = csv.DictWriter(f, fieldnames=keys)
        self._writers[trial.trial_id] = st

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        st = self._writers.get(trial.trial_id)
        if st is None:
            return
        flat = {k: v for k, v in result.items() if not isinstance(v, (dict, list))}
        if st["writer"] is None:
            st["keys"] = sorted(flat)
            st["writer"] = csv.DictWriter(st["file"], fieldnames=st["keys"])
            st["writer"].writeheader()
        st["writer"].writerow({k: flat.get(k, "") for k in st["keys"]})
        st["file"].flush()

    def _close(self, trial) -> None:
        st = self._writers.pop(trial.trial_id, None)
        if st is not None:
            st["file"].close()

    on_trial_complete = _close
    on_trial_error = _close


class MLflowLoggerCallback(Callback):
    """Log params/metrics/tags in the MLflow *file-store* layout
    (air/integrations/mlflow.py role, without importing mlflow):

        <tracking_dir>/<experiment_id>/meta.yaml
        <tracking_dir>/<experiment_id>/<run_id>/meta.yaml
        .../params/<key>          one value per file
        .../metrics/<key>         lines of "<ts_ms> <value> <step>"
        .../tags/<key>

    A stock ``mlflow ui --backend-store-uri <tracking_dir>`` browses it."""

    def __init__(self, tracking_dir: str, experiment_name: str = "default",
                 tags: Optional[Dict[str, str]] = None):
        self.root = os.path.abspath(tracking_dir)
        self.experiment_name = experiment_name
        self.tags = tags or {}
        self.exp_id: Optional[str] = None  # resolved by name on first use
        self._runs: Dict[str, str] = {}  # trial_id -> run dir
        self._steps: Dict[str, int] = {}

    def _ensure_experiment(self) -> None:
        """Resolve the experiment id by NAME: reuse an existing experiment
        whose meta.yaml names ours, else allocate the next free numeric id —
        two experiments sharing one tracking dir never merge."""
        if self.exp_id is not None:
            return
        os.makedirs(self.root, exist_ok=True)
        taken = []
        for d in os.listdir(self.root):
            meta = os.path.join(self.root, d, "meta.yaml")
            if not os.path.isfile(meta):
                continue
            taken.append(d)
            try:
                for line in open(meta):
                    if line.strip() == f"name: {self.experiment_name}":
                        self.exp_id = d
                        return
            except OSError:
                continue
        nid = 0
        while str(nid) in taken:
            nid += 1
        self.exp_id = str(nid)
        exp_dir = os.path.join(self.root, self.exp_id)
        os.makedirs(exp_dir, exist_ok=True)
        with open(os.path.join(exp_dir, "meta.yaml"), "w") as f:
            f.write(
                f"artifact_location: file://{exp_dir}\n"
                f"experiment_id: '{self.exp_id}'\n"
                f"lifecycle_stage: active\n"
                f"name: {self.experiment_name}\n"
            )

    def on_trial_start(self, trial) -> None:
        if trial.trial_id in self._runs:  # trial restart: same run continues
            return
        self._ensure_experiment()
        run_id = uuid.uuid4().hex
        run_dir = os.path.join(self.root, self.exp_id, run_id)
        for sub in ("params", "metrics", "tags"):
            os.makedirs(os.path.join(run_dir, sub), exist_ok=True)
        now_ms = int(time.time() * 1000)
        with open(os.path.join(run_dir, "meta.yaml"), "w") as f:
            f.write(
                f"artifact_uri: file://{run_dir}/artifacts\n"
                f"end_time: null\n"
                f"experiment_id: '{self.exp_id}'\n"
                f"lifecycle_stage: active\n"
                f"run_id: {run_id}\n"
                f"run_name: {trial.trial_id}\n"
                f"start_time: {now_ms}\n"
                f"status: 1\n"
            )
        for k, v in trial.config.items():
            self._write_kv(run_dir, "params", k, v)
        for k, v in {**self.tags, "trial_id": trial.trial_id}.items():
            self._write_kv(run_dir, "tags", k, v)
        self._runs[trial.trial_id] = run_dir
        self._steps[trial.trial_id] = 0

    @staticmethod
    def _write_kv(run_dir: str, sub: str, key: str, value: Any) -> None:
        safe = str(key).replace("/", "_")
        with open(os.path.join(run_dir, sub, safe), "w") as f:
            f.write(str(value))

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        run_dir = self._runs.get(trial.trial_id)
        if run_dir is None:
            return
        step = self._steps.get(trial.trial_id, 0)
        self._steps[trial.trial_id] = step + 1
        now_ms = int(time.time() * 1000)
        for k, v in result.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            safe = str(k).replace("/", "_")
            with open(os.path.join(run_dir, "metrics", safe), "a") as f:
                f.write(f"{now_ms} {v} {step}\n")

    def _finish(self, trial, status: int) -> None:
        run_dir = self._runs.pop(trial.trial_id, None)
        if run_dir is None:
            return
        meta = os.path.join(run_dir, "meta.yaml")
        try:
            txt = open(meta).read()
            txt = txt.replace("end_time: null", f"end_time: {int(time.time()*1000)}")
            txt = txt.replace("status: 1", f"status: {status}")
            with open(meta, "w") as f:
                f.write(txt)
        except OSError:
            pass

    def on_trial_complete(self, trial) -> None:
        self._finish(trial, 3)  # FINISHED

    def on_trial_error(self, trial) -> None:
        self._finish(trial, 4)  # FAILED


def _numeric_metrics(result: Dict[str, Any]) -> Dict[str, float]:
    """Chartable scalars only: bools are ints in python but are status
    flags, not metrics (matches MLflowLoggerCallback's filter)."""
    return {
        k: v for k, v in result.items()
        if not isinstance(v, bool) and isinstance(v, (int, float))
    }


class WandbLoggerCallback(Callback):
    """Weights & Biases logger (reference air/integrations/wandb.py role).
    The SDK is not installed in this offline image; construction raises a
    clear gated error unless `wandb` is importable (e.g. pulled in via a
    runtime_env).  With it present, each trial becomes a wandb run and
    results stream to `wandb.log`."""

    def __init__(self, project: str = "cluster_anywhere_tpu_torch", **init_kwargs):
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "wandb is not installed in this environment; install it via "
                "a runtime_env (pip) or use JSON/CSV/MLflowLoggerCallback"
            ) from e
        self._wandb = wandb
        self.project = project
        self.init_kwargs = init_kwargs
        self._runs: Dict[str, Any] = {}

    def on_trial_start(self, trial) -> None:
        if trial.trial_id in self._runs:
            return  # restart (retry/pause-resume/reallocation): same run
        self._runs[trial.trial_id] = self._wandb.init(
            project=self.project, name=trial.trial_id, config=dict(trial.config),
            reinit=True, **self.init_kwargs,
        )

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        run = self._runs.get(trial.trial_id)
        if run is not None:
            run.log(_numeric_metrics(result))

    def on_trial_complete(self, trial) -> None:
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            run.finish()

    def on_trial_error(self, trial) -> None:
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            run.finish(exit_code=1)  # shows as failed, not successful


class CometLoggerCallback(Callback):
    """Comet ML logger (reference air/integrations/comet.py role); gated on
    the `comet_ml` SDK exactly like WandbLoggerCallback."""

    def __init__(self, project_name: str = "cluster_anywhere_tpu_torch", **kw):
        try:
            import comet_ml  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "comet_ml is not installed in this environment; install it "
                "via a runtime_env (pip) or use JSON/CSV/MLflowLoggerCallback"
            ) from e
        self._comet = comet_ml
        self.project_name = project_name
        self.kw = kw
        self._exps: Dict[str, Any] = {}

    def on_trial_start(self, trial) -> None:
        if trial.trial_id in self._exps:
            return  # restart: keep logging into the same experiment
        exp = self._comet.Experiment(project_name=self.project_name, **self.kw)
        exp.set_name(trial.trial_id)
        exp.log_parameters(dict(trial.config))
        self._exps[trial.trial_id] = exp

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        exp = self._exps.get(trial.trial_id)
        if exp is not None:
            exp.log_metrics(_numeric_metrics(result))

    def on_trial_complete(self, trial) -> None:
        exp = self._exps.pop(trial.trial_id, None)
        if exp is not None:
            exp.end()

    def on_trial_error(self, trial) -> None:
        exp = self._exps.pop(trial.trial_id, None)
        if exp is not None:
            exp.add_tag("failed")
            exp.end()
