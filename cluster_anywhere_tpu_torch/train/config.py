"""Train configuration dataclasses.

Analogues of the reference's air/config.py (`RunConfig`/`ScalingConfig`/
`FailureConfig`, reference python/ray/air/config.py) and
CheckpointConfig (keep-K by score).  Counterpart of
cluster_anywhere_tpu/train/config.py: ScalingConfig asks for the `GPU`
resource (`use_gpu`, `gpus_per_worker`) where the JAX package asks for
"TPU"; it still takes the JAX fields `use_tpu` and `chips_per_worker`, and
`use_tpu=True` raises.  The JAX package's JaxConfig has no counterpart: its
rank-env-only mode is the base BackendConfig here, and its
`init_jax_distributed=True` mode is TorchConfig (a torch.distributed group).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ScalingConfig:
    """How many training workers to launch and what each needs.

    num_workers: number of SPMD training worker processes (the driver
        assigns consecutive ranks).
    use_gpu: request `gpus_per_worker` of the "GPU" resource per worker, so
        the workers run in the GPU pool; on by default, as every entry point
        of the port runs on the card unless told otherwise.  A request is a
        whole count or a fraction below one (4 workers at 0.25 share one
        card).  Training on the host takes use_gpu=False.
    use_tpu, chips_per_worker: the JAX package's fields, accepted so that a
        config written for it constructs; use_tpu=True raises.
    resources_per_worker: extra custom resources per worker.
    placement_strategy: PACK | SPREAD | STRICT_PACK | STRICT_SPREAD for the
        placement group that gangs the workers.
    """

    num_workers: int = 1
    use_gpu: bool = True
    gpus_per_worker: float = 1.0
    use_tpu: bool = False
    chips_per_worker: int = 1
    cpus_per_worker: float = 1.0
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    placement_strategy: str = "PACK"
    # Pin the whole gang to label-matching nodes (every bundle gets this
    # hard selector), e.g. {"zone": In("a")}.
    label_selector: Optional[Dict[str, Any]] = None
    # Elastic bounds (Train-v2 style); None disables elasticity.
    min_workers: Optional[int] = None
    max_workers: Optional[int] = None

    def __post_init__(self):
        if self.use_tpu:
            raise ValueError(
                "ScalingConfig(use_tpu=True): the port trains on GPUs; ask for "
                "them with use_gpu=True and gpus_per_worker"
            )
        if self.use_gpu:
            from ..core.accelerators import validate_chip_request

            validate_chip_request(self.gpus_per_worker)

    def bundle(self) -> Dict[str, float]:
        b: Dict[str, float] = {"CPU": float(self.cpus_per_worker)}
        if self.use_gpu:
            b["GPU"] = float(self.gpus_per_worker)
        b.update(self.resources_per_worker)
        return b


@dataclass
class CheckpointConfig:
    """Keep-K checkpoint retention (reference train/_internal/checkpoint_manager.py)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # "max" | "min"

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")


@dataclass
class FailureConfig:
    """max_failures: worker-group restarts allowed before the run fails.
    -1 = unlimited (reference air/config.py FailureConfig).

    Preemption elasticity: with drain_aware on (default), the controller
    watches the drain plane's preemption warnings (`worker.draining_node_ids`)
    and, when a node hosting a gang member enters its drain window, asks
    every rank to checkpoint at the next step boundary
    (`train.should_checkpoint()`), waits up to preempt_barrier_timeout_s for
    the barrier, and rebuilds the group on survivors BEFORE the kill lands.
    Preemption-caused attempts never consume max_failures — an announced
    exit is the system's fault, not the application's (mirrors the drain
    plane's budget-exempt task retry)."""

    max_failures: int = 0
    drain_aware: bool = True
    preempt_barrier_timeout_s: float = 15.0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 0
    # experiment callbacks (tune/callback.py): logger integrations etc.
    callbacks: List[Any] = field(default_factory=list)

    def resolved_storage_path(self) -> str:
        return os.path.expanduser(
            self.storage_path or os.environ.get("CA_STORAGE_PATH", "~/ca_results")
        )


@dataclass
class BackendConfig:
    """Base class for framework backend configs (reference
    train/backend/backend.py).  Its backend exports the rank env vars only
    (the JAX package's JaxConfig without init_jax_distributed)."""

    def backend_cls(self):
        from .backend import Backend

        return Backend


@dataclass
class TrainingFailedError(Exception):
    """Raised by trainer.fit() when training failed after exhausting retries."""

    message: str = ""
    worker_errors: Any = None

    def __str__(self):
        return self.message or "training failed"


@dataclass
class TorchConfig(BackendConfig):
    """torch.distributed backend (reference train/torch/config.py
    TorchConfig): one process group over the worker group, which
    parallel.make_mesh inside the loop joins.  gloo by default, for CPU
    hosts and for ranks that share one card (NCCL refuses two ranks on one
    device); a mesh on CUDA defaults to NCCL, so a loop on a gloo group
    passes make_mesh(..., backend="gloo").  The init timeout mirrors the
    reference's default."""

    backend: str = "gloo"
    port: int = 0  # 0 = pick a free port on rank-0's node
    timeout_s: float = 1800.0

    def backend_cls(self):
        from .backend import TorchBackend

        return TorchBackend
