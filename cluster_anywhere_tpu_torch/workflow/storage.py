"""Workflow storage: per-workflow checkpoint directory (analogue of the
reference's python/ray/workflow/workflow_storage.py).

Layout under <storage_root>/<workflow_id>/:
    status.json           — RUNNING | SUCCEEDED | FAILED | CANCELED + metadata
    dag.pkl               — the cloudpickled DAG (for resume)
    steps/<step_key>.pkl  — checkpointed result of each completed step
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import cloudpickle


def default_storage_root() -> str:
    return os.environ.get(
        "CA_WORKFLOW_STORAGE", os.path.expanduser("~/ca_workflows")
    )


class WorkflowStorage:
    def __init__(self, workflow_id: str, storage_root: Optional[str] = None):
        self.workflow_id = workflow_id
        self.root = os.path.join(storage_root or default_storage_root(), workflow_id)
        self.steps_dir = os.path.join(self.root, "steps")

    def create(self):
        os.makedirs(self.steps_dir, exist_ok=True)

    def exists(self) -> bool:
        return os.path.exists(os.path.join(self.root, "status.json"))

    # ------------------------------------------------------------ status
    def save_status(self, status: str, **extra):
        self.create()
        path = os.path.join(self.root, "status.json")
        doc = {"status": status, "updated_at": time.time(), **extra}
        if os.path.exists(path):
            with open(path) as f:
                old = json.load(f)
            doc = {**old, **doc}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def load_status(self) -> Dict[str, Any]:
        with open(os.path.join(self.root, "status.json")) as f:
            return json.load(f)

    # --------------------------------------------------------------- dag
    def save_dag(self, dag):
        self.create()
        with open(os.path.join(self.root, "dag.pkl"), "wb") as f:
            cloudpickle.dump(dag, f)

    def load_dag(self):
        with open(os.path.join(self.root, "dag.pkl"), "rb") as f:
            return cloudpickle.load(f)

    # ------------------------------------------------------------- steps
    def _step_path(self, step_key: str) -> str:
        return os.path.join(self.steps_dir, f"{step_key}.pkl")

    def has_step(self, step_key: str) -> bool:
        return os.path.exists(self._step_path(step_key))

    def save_step(self, step_key: str, value: Any):
        tmp = self._step_path(step_key) + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump(value, f)
        os.replace(tmp, self._step_path(step_key))

    def load_step(self, step_key: str) -> Any:
        with open(self._step_path(step_key), "rb") as f:
            return cloudpickle.load(f)

    def completed_steps(self) -> List[str]:
        if not os.path.isdir(self.steps_dir):
            return []
        return [f[:-4] for f in os.listdir(self.steps_dir) if f.endswith(".pkl")]

    def delete(self):
        import shutil

        shutil.rmtree(self.root, ignore_errors=True)

    @staticmethod
    def list_workflows(storage_root: Optional[str] = None) -> List[str]:
        root = storage_root or default_storage_root()
        if not os.path.isdir(root):
            return []
        return [
            d
            for d in sorted(os.listdir(root))
            if os.path.exists(os.path.join(root, d, "status.json"))
        ]
