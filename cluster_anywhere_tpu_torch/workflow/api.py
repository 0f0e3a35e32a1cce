"""Workflow execution engine (analogue of the reference's
python/ray/workflow/workflow_executor.py + api.py).

Steps execute as remote tasks in topological order; each completed step's
result is checkpointed before dependents run, so a crashed workflow resumes
from its last completed frontier. Step keys come from the pickled DAG's node
ids — stable across resume because the DAG itself is checkpointed on first
run and reloaded thereafter.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Dict, List, Optional

from ..core import api as ca
from ..dag.node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)
from .storage import WorkflowStorage


class WorkflowStatus:
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    CANCELED = "CANCELED"
    RESUMABLE = "RESUMABLE"


class WorkflowError(RuntimeError):
    pass


def _step_key(node: DAGNode) -> str:
    return f"step_{node._id}_{node._label().replace('/', '_').replace(':', '_')}"


def _check_dag(dag: DAGNode):
    for node in dag._walk():
        if isinstance(node, ClassMethodNode):
            raise WorkflowError(
                "workflows only support task nodes (fn.bind(...)): actor-method "
                "steps are not durable across restarts"
            )


def _execute(
    storage: WorkflowStorage,
    dag: DAGNode,
    input_args: tuple,
    input_kwargs: Dict[str, Any],
    max_step_retries: int,
) -> Any:
    values: Dict[int, Any] = {}
    for node in dag._walk():
        status = storage.load_status()
        if status["status"] == WorkflowStatus.CANCELED:
            raise WorkflowError(f"workflow {storage.workflow_id} canceled")
        key = _step_key(node)
        if isinstance(node, InputNode):
            values[node._id] = node._execute_impl((), {}, input_args, input_kwargs)
            continue
        if isinstance(node, InputAttributeNode):
            args = [values[u._id] for u in node._upstream()]
            values[node._id] = node._execute_impl(args, {}, input_args, input_kwargs)
            continue
        if storage.has_step(key):
            values[node._id] = storage.load_step(key)
            continue
        args = [
            values[a._id] if isinstance(a, DAGNode) else a for a in node._bound_args
        ]
        kwargs = {
            k: values[v._id] if isinstance(v, DAGNode) else v
            for k, v in node._bound_kwargs.items()
        }
        if isinstance(node, MultiOutputNode):
            value = list(args)
        else:
            assert isinstance(node, FunctionNode)
            attempts = max_step_retries + 1
            last: Optional[BaseException] = None
            for _ in range(attempts):
                try:
                    value = ca.get(node._remote_fn.remote(*args, **kwargs))
                    last = None
                    break
                except Exception as e:  # step failed; retry
                    last = e
            if last is not None:
                raise last
        storage.save_step(key, value)  # checkpoint BEFORE dependents run
        values[node._id] = value
    return values[dag._id]


def _run_to_completion(
    storage: WorkflowStorage,
    dag: DAGNode,
    input_args: tuple,
    input_kwargs: Dict[str, Any],
    max_step_retries: int,
) -> Any:
    import os as _os

    storage.save_status(
        WorkflowStatus.RUNNING,
        started_at=time.time(),
        driver_pid=_os.getpid(),
        error=None,  # clear any stale failure from a previous attempt
    )
    try:
        result = _execute(storage, dag, input_args, input_kwargs, max_step_retries)
    except BaseException as e:
        final = (
            WorkflowStatus.CANCELED
            if storage.load_status()["status"] == WorkflowStatus.CANCELED
            else WorkflowStatus.FAILED
        )
        if final == WorkflowStatus.FAILED:
            storage.save_status(WorkflowStatus.FAILED, error=repr(e))
        raise
    storage.save_step("__output__", result)
    storage.save_status(WorkflowStatus.SUCCEEDED, finished_at=time.time())
    return result


def run(
    dag: DAGNode,
    *input_args,
    workflow_id: Optional[str] = None,
    storage_root: Optional[str] = None,
    max_step_retries: int = 3,
    **input_kwargs,
) -> Any:
    """Run a DAG durably; if `workflow_id` already exists, resume it (a
    SUCCEEDED workflow returns its stored output without re-running)."""
    workflow_id = workflow_id or f"wf_{int(time.time() * 1000)}"
    storage = WorkflowStorage(workflow_id, storage_root)
    if storage.exists():
        return resume(
            workflow_id, storage_root=storage_root, max_step_retries=max_step_retries
        )
    _check_dag(dag)
    storage.create()
    storage.save_dag((dag, input_args, input_kwargs))
    return _run_to_completion(storage, dag, input_args, input_kwargs, max_step_retries)


def run_async(
    dag: DAGNode,
    *input_args,
    workflow_id: Optional[str] = None,
    storage_root: Optional[str] = None,
    max_step_retries: int = 3,
    **input_kwargs,
) -> concurrent.futures.Future:
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(
        run,
        dag,
        *input_args,
        workflow_id=workflow_id,
        storage_root=storage_root,
        max_step_retries=max_step_retries,
        **input_kwargs,
    )
    ex.shutdown(wait=False)
    return fut


def resume(
    workflow_id: str,
    *,
    storage_root: Optional[str] = None,
    max_step_retries: int = 3,
) -> Any:
    storage = WorkflowStorage(workflow_id, storage_root)
    if not storage.exists():
        raise WorkflowError(f"no workflow {workflow_id!r}")
    status = storage.load_status()
    if status["status"] == WorkflowStatus.SUCCEEDED:
        return storage.load_step("__output__")
    if status["status"] == WorkflowStatus.CANCELED:
        raise WorkflowError(f"workflow {workflow_id!r} was canceled")
    dag, input_args, input_kwargs = storage.load_dag()
    return _run_to_completion(storage, dag, input_args, input_kwargs, max_step_retries)


def get_status(workflow_id: str, *, storage_root: Optional[str] = None) -> str:
    import os as _os

    storage = WorkflowStorage(workflow_id, storage_root)
    if not storage.exists():
        raise WorkflowError(f"no workflow {workflow_id!r}")
    doc = storage.load_status()
    s = doc["status"]
    if s == WorkflowStatus.RUNNING:
        # a RUNNING workflow whose driver died is resumable, not running
        pid = doc.get("driver_pid")
        alive = False
        if pid:
            try:
                _os.kill(pid, 0)
                alive = True
            except PermissionError:
                alive = True
            except (ProcessLookupError, OSError):
                alive = False
        if not alive:
            return WorkflowStatus.RESUMABLE
    return s


def get_output(workflow_id: str, *, storage_root: Optional[str] = None) -> Any:
    storage = WorkflowStorage(workflow_id, storage_root)
    if not storage.exists():
        raise WorkflowError(f"no workflow {workflow_id!r}")
    if storage.load_status()["status"] != WorkflowStatus.SUCCEEDED:
        raise WorkflowError(f"workflow {workflow_id!r} has no output yet")
    return storage.load_step("__output__")


def get_metadata(workflow_id: str, *, storage_root: Optional[str] = None) -> Dict[str, Any]:
    storage = WorkflowStorage(workflow_id, storage_root)
    if not storage.exists():
        raise WorkflowError(f"no workflow {workflow_id!r}")
    meta = storage.load_status()
    meta["completed_steps"] = sorted(
        k for k in storage.completed_steps() if k != "__output__"
    )
    return meta


def list_all(*, storage_root: Optional[str] = None) -> List[tuple]:
    out = []
    for wid in WorkflowStorage.list_workflows(storage_root):
        try:
            out.append((wid, WorkflowStorage(wid, storage_root).load_status()["status"]))
        except Exception:
            continue
    return out


def cancel(workflow_id: str, *, storage_root: Optional[str] = None):
    storage = WorkflowStorage(workflow_id, storage_root)
    if not storage.exists():
        raise WorkflowError(f"no workflow {workflow_id!r}")
    storage.save_status(WorkflowStatus.CANCELED)


def delete(workflow_id: str, *, storage_root: Optional[str] = None):
    WorkflowStorage(workflow_id, storage_root).delete()


# --------------------------------------------------------------------- events
class EventListener:
    """Blocks a workflow step until an external event arrives (reference
    workflow event system: workflow/api.py wait_for_event + event_listener).
    Subclass and implement poll_for_event(); the returned payload becomes
    the step's checkpointed result, so a resumed workflow never re-waits
    for an event it already received."""

    def poll_for_event(self) -> Any:
        raise NotImplementedError


class KVEventListener(EventListener):
    """Built-in listener over the cluster KV: completes when some process
    calls ``workflow.signal_event(key, payload)``."""

    NS = "__workflow_events__"

    def __init__(self, key: str, poll_interval_s: float = 0.1,
                 timeout_s: Optional[float] = None):
        self.key = key
        self.poll_interval_s = poll_interval_s
        self.timeout_s = timeout_s

    def poll_for_event(self) -> Any:
        import pickle as _pickle

        from ..core.worker import global_worker

        w = global_worker()
        deadline = (
            time.monotonic() + self.timeout_s if self.timeout_s is not None else None
        )
        while True:
            v = w.head_call("kv_get", ns=self.NS, key=self.key)["value"]
            if v is not None:
                return _pickle.loads(v)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"event {self.key!r} did not arrive")
            time.sleep(self.poll_interval_s)


def signal_event(key: str, payload: Any = None):
    """Deliver the event that a KVEventListener step is waiting for."""
    import pickle as _pickle

    from ..core.worker import global_worker

    global_worker().head_call(
        "kv_put", ns=KVEventListener.NS, key=key, value=_pickle.dumps(payload)
    )


def wait_for_event(listener_cls, *args, **kwargs) -> DAGNode:
    """A workflow step that completes when `listener_cls(*args).poll_for_event()`
    returns; use its node as an upstream dependency of steps that need the
    event payload."""
    if not (isinstance(listener_cls, type) and issubclass(listener_cls, EventListener)):
        raise TypeError("wait_for_event expects an EventListener subclass")

    @ca.remote
    def __wf_wait_for_event(cls, cls_args, cls_kwargs):
        return cls(*cls_args, **cls_kwargs).poll_for_event()

    return __wf_wait_for_event.bind(listener_cls, args, kwargs)
