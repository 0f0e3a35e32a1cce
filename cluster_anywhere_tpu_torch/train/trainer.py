"""Trainers: user-facing entry points.

`DataParallelTrainer` is the analogue of the reference's
train/data_parallel_trainer.py:26 (`fit` at base_trainer.py:649);
`TorchTrainer` specialises it with the torch.distributed backend, as the
reference's TorchTrainer binds `_TorchBackend`
(train/torch/torch_trainer.py:11).  It is the counterpart of the JAX
package's JaxTrainer, which binds JaxConfig.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .checkpoint import Checkpoint
from .config import BackendConfig, RunConfig, ScalingConfig, TorchConfig
from .controller import Result, TrainController


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        backend_config: Optional[BackendConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend_config = backend_config or BackendConfig()
        self.datasets = datasets
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        controller = TrainController(
            train_fn=self.train_loop_per_worker,
            train_fn_config=self.train_loop_config,
            scaling_config=self.scaling_config,
            run_config=self.run_config,
            backend_config=self.backend_config,
            datasets=self.datasets,
            resume_from_checkpoint=self.resume_from_checkpoint,
        )
        result = controller.run()
        if result.error is not None:
            raise result.error
        return result


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer with the torch.distributed backend (TorchConfig,
    gloo) bound by default."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("backend_config", TorchConfig())
        super().__init__(*args, **kwargs)
