"""cluster_anywhere_tpu_torch.autoscaler: declarative cluster autoscaling
(analogue of the reference's autoscaler v2, python/ray/autoscaler/v2/).

    from cluster_anywhere_tpu_torch import autoscaler
    prov = autoscaler.LocalNodeProvider()
    asc = autoscaler.Autoscaler(prov, autoscaler.AutoscalerConfig(
        node_types=[autoscaler.NodeType("cpu2", {"CPU": 2.0})],
        idle_timeout_s=30,
    ))
    asc.start()
"""

from .provider import (
    AgentNodeProvider,
    CommandRunnerNodeProvider,
    LocalNodeProvider,
    NodeInfo,
    NodeProvider,
    NodeType,
)
from .reconciler import Autoscaler, AutoscalerConfig, Reconciler

__all__ = [
    "NodeProvider",
    "LocalNodeProvider",
    "AgentNodeProvider",
    "CommandRunnerNodeProvider",
    "NodeType",
    "NodeInfo",
    "Autoscaler",
    "AutoscalerConfig",
    "Reconciler",
]
