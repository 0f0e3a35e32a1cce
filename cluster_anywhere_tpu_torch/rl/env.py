"""Environment API + built-in envs (analogue of the reference's
rllib/env/ — gymnasium-style step/reset; CartPole implemented in numpy so
tests run without external deps, vectorized for batched sampling).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class Env:
    """Single environment: gymnasium-style API."""

    observation_dim: int
    num_actions: int

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, Dict[str, Any]]:
        raise NotImplementedError


class CartPole(Env):
    """Classic control CartPole-v1 dynamics (Barto, Sutton, Anderson)."""

    observation_dim = 4
    num_actions = 2
    max_steps = 500

    def __init__(self):
        self.gravity = 9.8
        self.masscart, self.masspole = 1.0, 0.1
        self.total_mass = self.masscart + self.masspole
        self.length = 0.5
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4
        self.rng = np.random.default_rng()
        self.state = np.zeros(4)
        self.steps = 0

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, size=4)
        self.steps = 0
        return self.state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.polemass_length * theta_dot**2 * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self.steps += 1
        terminated = bool(
            abs(x) > self.x_threshold
            or abs(theta) > self.theta_threshold
            or self.steps >= self.max_steps
        )
        return self.state.astype(np.float32), 1.0, terminated, {}


class Pendulum(Env):
    """Classic control Pendulum-v1 dynamics: continuous torque in
    [-max_torque, max_torque] swings the pole upright.  The continuous-action
    counterpart of CartPole for SAC coverage (rllib/algorithms/sac trains on
    exactly this family)."""

    observation_dim = 3
    num_actions = 0  # continuous
    continuous = True
    action_dim = 1
    action_scale = 2.0  # torque bound
    max_steps = 200

    def __init__(self):
        self.g, self.m, self.length = 10.0, 1.0, 1.0
        self.dt = 0.05
        self.max_speed = 8.0
        self.rng = np.random.default_rng()
        self.th = 0.0
        self.thdot = 0.0
        self.steps = 0

    def _obs(self) -> np.ndarray:
        return np.array(
            [np.cos(self.th), np.sin(self.th), self.thdot], np.float32
        )

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.th = self.rng.uniform(-np.pi, np.pi)
        self.thdot = self.rng.uniform(-1.0, 1.0)
        self.steps = 0
        return self._obs()

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0], -self.action_scale, self.action_scale))
        th_norm = ((self.th + np.pi) % (2 * np.pi)) - np.pi
        cost = th_norm**2 + 0.1 * self.thdot**2 + 0.001 * u**2
        self.thdot = self.thdot + (
            3 * self.g / (2 * self.length) * np.sin(self.th)
            + 3.0 / (self.m * self.length**2) * u
        ) * self.dt
        self.thdot = float(np.clip(self.thdot, -self.max_speed, self.max_speed))
        self.th = self.th + self.thdot * self.dt
        self.steps += 1
        return self._obs(), -float(cost), self.steps >= self.max_steps, {}


class MemoryChain(Env):
    """Memory-requiring diagnostic env (the T-maze family rllib uses to
    exercise use_lstm): a binary cue is visible ONLY on the first step; after
    `corridor` blank steps the agent must emit the cue as its action.
    Reward +1 for recalling correctly at the final step, -1 otherwise, 0 in
    the corridor.  A memoryless policy cannot beat 0 expected return; a
    recurrent one reaches ~+1."""

    observation_dim = 3  # [cue_is_0, cue_is_1, at_query_step]
    num_actions = 2

    def __init__(self, corridor: int = 4):
        self.corridor = corridor
        self.rng = np.random.default_rng()
        self.cue = 0
        self.t = 0

    def _obs(self) -> np.ndarray:
        o = np.zeros(3, np.float32)
        if self.t == 0:
            o[self.cue] = 1.0
        if self.t == self.corridor:
            o[2] = 1.0
        return o

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.cue = int(self.rng.integers(0, 2))
        self.t = 0
        return self._obs()

    def step(self, action: int):
        if self.t >= self.corridor:
            r = 1.0 if int(action) == self.cue else -1.0
            return self._obs(), r, True, {}
        self.t += 1
        return self._obs(), 0.0, False, {}


_ENV_REGISTRY: Dict[str, Callable[[], Env]] = {
    "CartPole-v1": CartPole,
    "Pendulum-v1": Pendulum,
    "MemoryChain-v0": MemoryChain,
}


def register_env(name: str, creator: Callable[[], Env]):
    _ENV_REGISTRY[name] = creator


def make_env(name_or_creator) -> Env:
    if callable(name_or_creator):
        return name_or_creator()
    if name_or_creator in _ENV_REGISTRY:
        return _ENV_REGISTRY[name_or_creator]()
    raise KeyError(f"unknown env {name_or_creator!r}; register_env() it first")


class VectorEnv:
    """N independent env copies with auto-reset (reference: vectorized
    sampling inside SingleAgentEnvRunner)."""

    def __init__(self, name_or_creator, num_envs: int, seed: int = 0):
        self.envs = [make_env(name_or_creator) for _ in range(num_envs)]
        self.obs = np.stack([e.reset(seed + i) for i, e in enumerate(self.envs)])
        self.episode_returns = np.zeros(num_envs)
        self.completed_returns: list = []
        self.continuous = bool(getattr(self.envs[0], "continuous", False))

    @property
    def num_envs(self) -> int:
        return len(self.envs)

    def step(self, actions: np.ndarray):
        obs, rewards, dones = [], [], []
        for i, (e, a) in enumerate(zip(self.envs, actions)):
            o, r, d, _ = e.step(a if self.continuous else int(a))
            self.episode_returns[i] += r
            if d:
                self.completed_returns.append(self.episode_returns[i])
                self.episode_returns[i] = 0.0
                o = e.reset()
            obs.append(o)
            rewards.append(r)
            dones.append(d)
        self.obs = np.stack(obs)
        return self.obs, np.asarray(rewards, np.float32), np.asarray(dones)

    def drain_metrics(self) -> Dict[str, float]:
        rets = self.completed_returns
        self.completed_returns = []
        if not rets:
            return {"episodes": 0}
        return {
            "episodes": len(rets),
            "episode_return_mean": float(np.mean(rets)),
            "episode_return_max": float(np.max(rets)),
        }
