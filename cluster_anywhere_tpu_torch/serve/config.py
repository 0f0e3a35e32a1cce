"""Serve configuration schemas (analogue of python/ray/serve/config.py and
serve/schema.py — DeploymentConfig, AutoscalingConfig, HTTPOptions).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 1.0
    downscale_delay_s: float = 5.0
    metrics_interval_s: float = 0.5

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < max(1, self.min_replicas):
            raise ValueError("need 0 <= min_replicas <= max_replicas, max >= 1")


@dataclass
class AdmissionPolicy:
    """Proxy-side admission control for one deployment (the reference gets
    this from external gateways; here the HTTP proxy is the gate).  Instead
    of queueing unboundedly past the saturation knee, the proxy SHEDS:

    - queue-depth gate: more than `max_queue_depth` requests in flight
      through this proxy (dispatched + streaming) -> 503.  None derives
      `queue_depth_factor * replicas * max_ongoing_requests` from the live
      deployment state, so the cap scales with the autoscaler.
    - token-budget gate (LLM deployments): the summed cost estimate of
      in-flight requests (prompt chars/4 + max_new_tokens, or
      `default_request_tokens` when the body carries neither) would exceed
      `max_tokens_in_flight` -> 429.  None disables the gate.

    Shed responses carry `Retry-After: retry_after_s` and count into
    ca_serve_shed_total{deployment,reason}."""

    max_queue_depth: Optional[int] = None
    queue_depth_factor: float = 2.0
    max_tokens_in_flight: Optional[int] = None
    default_request_tokens: int = 64
    retry_after_s: float = 1.0

    def depth_cap(self, replicas: int, max_ongoing: int) -> int:
        if self.max_queue_depth is not None:
            return max(1, int(self.max_queue_depth))
        return max(1, int(self.queue_depth_factor * max(1, replicas) * max_ongoing))

    def to_wire(self) -> Dict[str, Any]:
        return {
            "max_queue_depth": self.max_queue_depth,
            "queue_depth_factor": self.queue_depth_factor,
            "max_tokens_in_flight": self.max_tokens_in_flight,
            "default_request_tokens": self.default_request_tokens,
            "retry_after_s": self.retry_after_s,
        }


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    user_config: Optional[Dict[str, Any]] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    admission: Optional[AdmissionPolicy] = None
    health_check_period_s: float = 2.0
    graceful_shutdown_timeout_s: float = 5.0
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    resources: Dict[str, float] = field(default_factory=dict)
    max_restarts: int = 3

    def actor_options(self) -> Dict[str, Any]:
        opts: Dict[str, Any] = {
            "num_cpus": self.num_cpus,
            "max_concurrency": max(2, self.max_ongoing_requests + 2),
            # the controller drains replicas app-aware (replacements first,
            # in-flight streams run out); the head must not restart-migrate
            # them mid-request on a node drain
            "drain_migration": False,
        }
        if self.num_gpus:
            opts["num_gpus"] = self.num_gpus
        if self.resources:
            opts["resources"] = dict(self.resources)
        return opts


@dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = 8000


@dataclass
class ReplicaInfo:
    """What routers need to reach one replica."""

    replica_id: str
    actor_name: str
    max_ongoing_requests: int


@dataclass
class DeploymentStatus:
    name: str
    status: str  # UPDATING | HEALTHY | UNHEALTHY
    replica_states: Dict[str, int] = field(default_factory=dict)
    message: str = ""
