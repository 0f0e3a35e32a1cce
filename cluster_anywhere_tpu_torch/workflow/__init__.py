"""cluster_anywhere_tpu_torch.workflow: durable execution of task DAGs (analogue of
the reference's Ray Workflow, python/ray/workflow/ — WorkflowExecutor,
workflow_storage.py checkpointing, recovery from storage).

    @ca.remote
    def fetch(x): ...
    @ca.remote
    def combine(a, b): ...

    dag = combine.bind(fetch.bind(1), fetch.bind(2))
    result = workflow.run(dag, workflow_id="my_wf")

Every step's result is checkpointed; `workflow.resume("my_wf")` after a crash
re-runs only the steps that never completed.

Counterpart of cluster_anywhere_tpu/workflow/, which it copies.  A step on
the card is a task with `num_gpus`; its result is stored with cloudpickle,
so a step should return host values (numpy) for its checkpoint to load in a
process without a GPU.
"""

from .api import (
    EventListener,
    KVEventListener,
    WorkflowStatus,
    cancel,
    delete,
    get_metadata,
    get_output,
    get_status,
    list_all,
    resume,
    signal_event,
    wait_for_event,
    run,
    run_async,
)

__all__ = [
    "run",
    "run_async",
    "resume",
    "get_status",
    "get_output",
    "get_metadata",
    "list_all",
    "cancel",
    "delete",
    "WorkflowStatus",
]
