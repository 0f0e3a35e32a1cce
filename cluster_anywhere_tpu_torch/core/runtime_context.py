"""Runtime context (analogue of python/ray/runtime_context.py)."""

from __future__ import annotations

from typing import Optional

from .worker import global_worker


class RuntimeContext:
    def __init__(self, worker):
        self._worker = worker

    @property
    def job_id(self):
        return self._worker.job_id

    @property
    def node_id(self):
        return self._worker.node_id

    def get_task_id(self) -> Optional[str]:
        t = self._worker.current_task_id
        return t.hex() if t else None

    def get_actor_id(self) -> Optional[str]:
        a = self._worker.current_actor_id
        return a.hex() if a else None

    def get_worker_id(self) -> str:
        return self._worker.client_id

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False  # filled in by the actor-restart milestone


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(global_worker())
