"""Connector pipelines (analogue of the reference's rllib/connectors/):
composable transforms between the environment and the module, so
preprocessing is configuration, not code baked into each algorithm.

Two pipelines, mirroring rllib's env-to-module and module-to-env split:

- env->module: observation transforms applied before the policy forward
  pass, in both sampling and evaluation (and, because the runner stores the
  TRANSFORMED observations in its rollouts, training consumes exactly what
  the policy saw — no train/serve skew).
- module->env: action transforms applied to the sampled action before
  env.step (e.g. squashing/rescaling into the env's action box).

Connectors are plain callables on numpy batches; stateful ones (e.g.
RunningObsNormalizer) carry their state and are checkpointed with the
runner's weights payload so restored policies keep their normalization.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class Connector:
    """One transform step.  Subclass or wrap a callable via Lambda."""

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # stateful connectors override these to ride the weight broadcast
    def get_state(self) -> Optional[dict]:
        return None

    def set_state(self, state: Optional[dict]) -> None:
        pass


class Lambda(Connector):
    def __init__(self, fn: Callable[[np.ndarray], np.ndarray]):
        self.fn = fn

    def __call__(self, batch):
        return self.fn(batch)


class ClipObs(Connector):
    """Clip observations into [-bound, bound] (rllib's clip_rewards/obs
    filters family)."""

    def __init__(self, bound: float = 10.0):
        self.bound = float(bound)

    def __call__(self, batch):
        return np.clip(batch, -self.bound, self.bound)


class RunningObsNormalizer(Connector):
    """Online mean/variance observation filter (rllib MeanStdFilter):
    normalizes with running statistics updated on every sampling batch.
    update=False freezes it (evaluation-time behavior)."""

    def __init__(self, eps: float = 1e-8):
        self.count = 0.0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None
        self.eps = eps
        self.update = True

    def __call__(self, batch):
        b = np.asarray(batch, np.float64)
        if self.mean is None:
            self.mean = np.zeros(b.shape[-1])
            self.m2 = np.ones(b.shape[-1])
        if self.update:
            flat = b.reshape(-1, b.shape[-1])
            for row in flat:  # Welford; rollout batches are small
                self.count += 1
                d = row - self.mean
                self.mean += d / self.count
                self.m2 += d * (row - self.mean)
        var = self.m2 / max(self.count, 1.0)
        return ((b - self.mean) / np.sqrt(var + self.eps)).astype(np.float32)

    def get_state(self):
        if self.mean is None:
            return {"count": 0.0}
        return {"count": self.count, "mean": self.mean.copy(), "m2": self.m2.copy()}

    def set_state(self, state):
        if not state or state.get("count", 0.0) == 0.0:
            return
        self.count = state["count"]
        self.mean = np.asarray(state["mean"], np.float64).copy()
        self.m2 = np.asarray(state["m2"], np.float64).copy()


class RescaleActions(Connector):
    """module->env: map tanh-range [-1, 1] actions into [low, high]."""

    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def __call__(self, batch):
        return self.low + (np.asarray(batch) + 1.0) * 0.5 * (self.high - self.low)


class ConnectorPipeline(Connector):
    """Ordered composition; state is the list of per-connector states."""

    def __init__(self, connectors: Sequence[Connector] = ()):
        self.connectors: List[Connector] = [
            c if isinstance(c, Connector) else Lambda(c) for c in connectors
        ]

    def __call__(self, batch):
        for c in self.connectors:
            batch = c(batch)
        return batch

    def append(self, c: Connector) -> "ConnectorPipeline":
        self.connectors.append(c if isinstance(c, Connector) else Lambda(c))
        return self

    def get_state(self):
        states = [c.get_state() for c in self.connectors]
        return {"steps": states} if any(s is not None for s in states) else None

    def set_state(self, state):
        if not state:
            return
        for c, s in zip(self.connectors, state.get("steps", [])):
            c.set_state(s)

    def set_update(self, update: bool) -> None:
        for c in self.connectors:
            if hasattr(c, "update"):
                c.update = update
