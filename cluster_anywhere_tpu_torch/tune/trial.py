"""Trial state + the actor that runs one trial (analogue of
python/ray/tune/experiment/trial.py Trial and the function-trainable wrapper
python/ray/tune/trainable/function_trainable.py).
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"  # checkpointed + resources released (sync HyperBand rungs)
TERMINATED = "TERMINATED"
ERRORED = "ERRORED"


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any], experiment_dir: str):
        self.trial_id = trial_id
        self.config = config
        self.status = PENDING
        self.last_result: Optional[Dict[str, Any]] = None
        self.metrics_history: List[Dict[str, Any]] = []
        self.error: Optional[str] = None
        self.num_failures = 0
        self.actor = None
        self.local_dir = os.path.join(experiment_dir, self.trial_id)
        self.latest_checkpoint_path: Optional[str] = None
        self.checkpoint_paths: List[str] = []
        # per-trial actor resource override (ResourceChangingScheduler)
        self.resources: Optional[Dict[str, float]] = None
        # scheduler bookkeeping
        self.rungs_recorded: set = set()
        self.last_perturb_t: int = 0
        self.ready_to_perturb: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {
            "trial_id": self.trial_id,
            "config": _jsonable(self.config),
            "status": self.status,
            "last_result": _jsonable(self.last_result),
            "metrics_history": _jsonable(self.metrics_history),
            "error": self.error,
            "latest_checkpoint_path": self.latest_checkpoint_path,
            "checkpoint_paths": self.checkpoint_paths,
            "local_dir": self.local_dir,
            "resources": self.resources,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any], experiment_dir: str) -> "Trial":
        t = cls(d["trial_id"], d["config"], experiment_dir)
        t.status = d["status"]
        t.last_result = d.get("last_result")
        t.metrics_history = d.get("metrics_history") or []
        t.error = d.get("error")
        t.latest_checkpoint_path = d.get("latest_checkpoint_path")
        t.checkpoint_paths = d.get("checkpoint_paths", [])
        t.resources = d.get("resources")
        return t


def _jsonable(obj):
    import json

    if obj is None:
        return None
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {k: _jsonable(v) for k, v in obj.items()}
        return repr(obj)


class TrialRunner:
    """Actor hosting one trial: runs the user function on a thread with a
    train-session installed so `tune.report` (== `train.report`) works."""

    def __init__(
        self,
        fn,
        config: Dict[str, Any],
        trial_id: str,
        trial_dir: str,
        experiment_name: str,
        storage_path: str,
        resume_checkpoint_path: Optional[str] = None,
    ):
        from ..train.checkpoint import Checkpoint
        from ..train.session import TrainContext, _Session, _set_session

        os.makedirs(trial_dir, exist_ok=True)
        ctx = TrainContext(
            world_size=1,
            world_rank=0,
            local_rank=0,
            node_rank=0,
            experiment_name=experiment_name,
            storage_path=storage_path,
            trial_dir=trial_dir,
        )
        resume = (
            Checkpoint(resume_checkpoint_path) if resume_checkpoint_path else None
        )
        self.session = _Session(ctx, resume_checkpoint=resume)
        _set_session(self.session)
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.final_return: Optional[Dict[str, Any]] = None

        def run():
            try:
                out = fn(config)
                if isinstance(out, dict):
                    self.final_return = out
            except BaseException:
                self.error = traceback.format_exc()
            finally:
                self.done.set()

        self.thread = threading.Thread(target=run, daemon=True, name=f"trial-{trial_id}")
        self.thread.start()

    def poll(self) -> Dict[str, Any]:
        reports = self.session.drain_reports()
        done = self.done.is_set()
        out: Dict[str, Any] = {"reports": reports, "done": done, "error": self.error}
        if done and self.final_return is not None:
            out["final_return"] = self.final_return
        return out
