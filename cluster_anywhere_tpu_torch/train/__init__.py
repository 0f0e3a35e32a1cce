"""cluster_anywhere_tpu_torch.train: distributed training on the actor runtime.

Same capability surface as the reference's Ray Train (v1 trainer API +
v2 controller/scaling/failure policies).  Counterpart of
cluster_anywhere_tpu.train with the framework backend torch.distributed:
TorchTrainer (JaxTrainer there) binds TorchConfig, a process group over
the workers that parallel.make_mesh joins; ScalingConfig asks for GPUs
(use_gpu, on by default) where the JAX package asks for TPUs.

In-loop API (inside train_loop_per_worker):
    from cluster_anywhere_tpu_torch import train
    train.report(metrics, checkpoint=...)
    train.get_checkpoint(); train.get_dataset_shard("train")
    train.get_context().get_world_rank()
"""

from .checkpoint import Checkpoint, CheckpointManager
from .config import (
    BackendConfig,
    CheckpointConfig,
    FailureConfig,
    TorchConfig,
    RunConfig,
    ScalingConfig,
    TrainingFailedError,
)
from .controller import (
    ElasticScalingPolicy,
    FailureDecision,
    FailureKind,
    FailurePolicy,
    FixedScalingPolicy,
    Result,
    ScalingPolicy,
    TrainController,
)
from .session import (
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    make_temp_checkpoint_dir,
    report,
    shared_checkpoint_dir,
    should_checkpoint,
)
from .trainer import DataParallelTrainer, TorchTrainer
from .worker_group import TrainWorker, WorkerGroup

__all__ = [
    "Checkpoint",
    "CheckpointManager",
    "CheckpointConfig",
    "BackendConfig",
    "TorchConfig",
    "FailureConfig",
    "RunConfig",
    "ScalingConfig",
    "TrainingFailedError",
    "Result",
    "TrainController",
    "ScalingPolicy",
    "FixedScalingPolicy",
    "ElasticScalingPolicy",
    "FailurePolicy",
    "FailureDecision",
    "FailureKind",
    "TrainContext",
    "report",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "make_temp_checkpoint_dir",
    "shared_checkpoint_dir",
    "should_checkpoint",
    "DataParallelTrainer",
    "TorchTrainer",
    "TrainWorker",
    "WorkerGroup",
]
