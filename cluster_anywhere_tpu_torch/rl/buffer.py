"""Replay buffers (analogue of rllib/utils/replay_buffers/): a uniform ring
buffer over flat numpy transitions, and a proportional prioritized buffer
(sum-tree, alpha/beta importance correction — the PER of
rllib/utils/replay_buffers/prioritized_episode_buffer.py, transition-level)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, obs_dim: int, seed: int = 0,
                 action_dim: int = 0):
        """action_dim=0 stores scalar int actions (DQN); >0 stores float
        action vectors of that width (SAC)."""
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        if action_dim > 0:
            self.actions = np.zeros((capacity, action_dim), np.float32)
        else:
            self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self.idx = 0
        self.size = 0
        self.rng = np.random.default_rng(seed)

    def add_batch(self, obs, actions, rewards, dones, next_obs):
        for i in range(len(obs)):
            j = self.idx
            self.obs[j] = obs[i]
            self.actions[j] = actions[i]
            self.rewards[j] = rewards[i]
            self.dones[j] = dones[i]
            self.next_obs[j] = next_obs[i]
            self.idx = (self.idx + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self.rng.integers(0, self.size, size=batch_size)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
            "next_obs": self.next_obs[idx],
        }

    def __len__(self):
        return self.size


class _SumTree:
    """Flat binary sum-tree: O(log n) priority update and proportional
    prefix-sum sampling.  Leaves are padded to a power of two so every leaf
    sits at the same depth (uniform descent loop, vectorized)."""

    def __init__(self, capacity: int):
        n = 1
        while n < capacity:
            n *= 2
        self.n_leaves = n
        self.tree = np.zeros(2 * n, np.float64)

    def set(self, idx: np.ndarray, priority: np.ndarray) -> None:
        parents = np.asarray(idx, np.int64) + self.n_leaves
        if len(parents) == 0:
            return
        self.tree[parents] = priority
        parents = np.unique(parents // 2)
        while parents[0] >= 1:
            self.tree[parents] = self.tree[2 * parents] + self.tree[2 * parents + 1]
            if parents[0] == 1:
                break
            parents = np.unique(parents // 2)

    @property
    def total(self) -> float:
        return float(self.tree[1])

    def prefix_sample(self, values: np.ndarray) -> np.ndarray:
        """For each v in [0, total), find the leaf whose cumulative range
        contains v (vectorized level-synchronous descent)."""
        idx = np.ones(len(values), np.int64)
        v = values.astype(np.float64).copy()
        while idx[0] < self.n_leaves:
            left = 2 * idx
            lsum = self.tree[left]
            go_right = v >= lsum
            v = np.where(go_right, v - lsum, v)
            idx = np.where(go_right, left + 1, left)
        return idx - self.n_leaves

    def max_leaf(self) -> float:
        return float(self.tree[self.n_leaves :].max())

    def get(self, idx: np.ndarray) -> np.ndarray:
        return self.tree[np.asarray(idx, np.int64) + self.n_leaves]


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional PER (Schaul et al.): sample i with p_i^alpha / sum, and
    correct the induced bias with importance weights (N * P(i))^-beta
    normalized by the max weight.  New transitions enter at the current max
    priority so everything is seen at least once; the learner feeds TD
    errors back via update_priorities."""

    def __init__(
        self,
        capacity: int,
        obs_dim: int,
        seed: int = 0,
        action_dim: int = 0,
        alpha: float = 0.6,
        beta: float = 0.4,
        beta_final: float = 1.0,
        beta_anneal_steps: int = 100_000,
        eps: float = 1e-6,
    ):
        super().__init__(capacity, obs_dim, seed, action_dim)
        self.alpha = alpha
        self.beta0 = beta
        self.beta_final = beta_final
        self.beta_anneal_steps = max(1, beta_anneal_steps)
        self.eps = eps
        self.tree = _SumTree(capacity)
        self._samples_drawn = 0

    @property
    def beta(self) -> float:
        frac = min(1.0, self._samples_drawn / self.beta_anneal_steps)
        return self.beta0 + frac * (self.beta_final - self.beta0)

    def add_batch(self, obs, actions, rewards, dones, next_obs):
        n = len(obs)
        start = self.idx
        super().add_batch(obs, actions, rewards, dones, next_obs)
        new_idx = (start + np.arange(n)) % self.capacity
        p0 = max(self.tree.max_leaf(), 1.0)
        self.tree.set(new_idx, np.full(n, p0))

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        total = self.tree.total
        # stratified: one draw per equal segment of the cumulative mass
        seg = total / batch_size
        v = (np.arange(batch_size) + self.rng.random(batch_size)) * seg
        idx = self.tree.prefix_sample(np.minimum(v, np.nextafter(total, 0)))
        idx = np.minimum(idx, self.size - 1)
        p = self.tree.get(idx) / max(total, 1e-12)
        w = (self.size * np.maximum(p, 1e-12)) ** (-self.beta)
        w /= w.max()
        self._samples_drawn += batch_size
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "dones": self.dones[idx],
            "next_obs": self.next_obs[idx],
            "weights": w.astype(np.float32),
            "indices": idx.astype(np.int64),
        }

    def update_priorities(self, indices: np.ndarray, td_errors: np.ndarray) -> None:
        p = (np.abs(np.asarray(td_errors, np.float64)) + self.eps) ** self.alpha
        self.tree.set(np.asarray(indices, np.int64), p)
