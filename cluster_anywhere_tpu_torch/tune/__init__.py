"""cluster_anywhere_tpu_torch.tune: distributed hyperparameter search
(analogue of the reference's Ray Tune, python/ray/tune/).

    from cluster_anywhere_tpu_torch import tune

    def trainable(config):
        for step in range(100):
            loss = (config["lr"] - 0.1) ** 2 + step * 0.0
            tune.report({"loss": loss, "training_iteration": step + 1})

    tuner = tune.Tuner(
        trainable,
        param_space={"lr": tune.loguniform(1e-4, 1e-1)},
        tune_config=tune.TuneConfig(metric="loss", mode="min", num_samples=8),
    )
    best = tuner.fit().get_best_result()

The in-loop API is shared with train: `tune.report` is `train.report`
(the reference unified these the same way).

Counterpart of cluster_anywhere_tpu/tune/, copied module for module with
the same public names.  A trial asks for the card with
`with_resources(trainable, {"gpu": 0.25})` (its actor then runs in the GPU
pool); `{"cpu": 1}` trials run on the host.  Trials that train the model
build it with `device=` as every entry point of the port does.
"""

from ..train.checkpoint import Checkpoint
from ..train.config import CheckpointConfig, FailureConfig, RunConfig
from ..train.session import (
    get_checkpoint,
    get_context,
    make_temp_checkpoint_dir,
    report,
)
from .bohb import TuneBOHB
from .external import (
    BayesOptSearch,
    ExternalSearcher,
    HyperOptSearch,
    OptunaSearch,
)
from .hyperband import PAUSE, HyperBandForBOHB, HyperBandScheduler
from .pb2 import PB2
from .resource_changing import DistributeResources, ResourceChangingScheduler
from .schedulers import (
    CONTINUE,
    STOP,
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from .search import (
    BasicVariantGenerator,
    ConcurrencyLimiter,
    RandomSearch,
    Searcher,
    TPESearcher,
)
from .search_space import (
    choice,
    grid_search,
    lograndint,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from .callbacks import (
    Callback,
    CSVLoggerCallback,
    JsonLoggerCallback,
    MLflowLoggerCallback,
    WandbLoggerCallback,
    CometLoggerCallback,
)
from .tuner import (
    ResultGrid,
    TrialResult,
    TuneConfig,
    Tuner,
    with_parameters,
    with_resources,
)

ASHAScheduler = AsyncHyperBandScheduler

__all__ = [
    "Callback",
    "CSVLoggerCallback",
    "JsonLoggerCallback",
    "MLflowLoggerCallback",
    "WandbLoggerCallback",
    "CometLoggerCallback",
    "Tuner",
    "TuneConfig",
    "ResultGrid",
    "TrialResult",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "Checkpoint",
    "report",
    "get_checkpoint",
    "get_context",
    "make_temp_checkpoint_dir",
    "with_resources",
    "with_parameters",
    "uniform",
    "loguniform",
    "quniform",
    "randint",
    "lograndint",
    "choice",
    "sample_from",
    "grid_search",
    "Searcher",
    "BasicVariantGenerator",
    "RandomSearch",
    "TPESearcher",
    "ConcurrencyLimiter",
    "TrialScheduler",
    "FIFOScheduler",
    "AsyncHyperBandScheduler",
    "ASHAScheduler",
    "HyperBandScheduler",
    "HyperBandForBOHB",
    "TuneBOHB",
    "PB2",
    "ResourceChangingScheduler",
    "DistributeResources",
    "ExternalSearcher",
    "HyperOptSearch",
    "OptunaSearch",
    "BayesOptSearch",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "CONTINUE",
    "STOP",
    "PAUSE",
]
