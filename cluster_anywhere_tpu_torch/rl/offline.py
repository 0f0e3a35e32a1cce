"""Offline RL: rollout persistence + learning from logged data.

Reference parity: ``rllib/offline/json_writer.py`` / ``json_reader.py``
(SampleBatch JSONL persistence) and ``rllib/algorithms/bc`` (behavior
cloning, the canonical offline baseline).  Batches are stored as npz shards
(dense numeric arrays) with a JSONL manifest for streaming reads: the JAX
package's files, byte for byte, so either package reads the other's.
Learners take `device=None` (the card; raises without one).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from .learner import _frozen, _Learner, adam, adam_step, to_device


class RolloutWriter:
    """Append rollout batches as npz shards under `path` with a manifest
    (json_writer.py analogue)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.manifest = os.path.join(path, "manifest.jsonl")
        self._n = 0

    def write(self, batch: Dict[str, np.ndarray]) -> str:
        name = f"shard_{int(time.time()*1000)}_{self._n:06d}.npz"
        self._n += 1
        fpath = os.path.join(self.path, name)
        # write via file object so numpy can't append another .npz suffix;
        # the .tmp name keeps a crashed partial write out of any *.npz glob
        with open(fpath + ".tmp", "wb") as f:
            np.savez_compressed(f, **batch)
        os.rename(fpath + ".tmp", fpath)
        rows = int(len(next(iter(batch.values()))))
        with open(self.manifest, "a") as f:
            f.write(json.dumps({"file": name, "rows": rows, "keys": sorted(batch)}) + "\n")
        return fpath


class RolloutReader:
    """Stream shards back (json_reader.py analogue); `sample` draws a
    uniform minibatch across all shards for offline updates."""

    def __init__(self, path: str, seed: int = 0):
        self.path = path
        self.shards: List[str] = []
        manifest = os.path.join(path, "manifest.jsonl")
        if os.path.exists(manifest):
            with open(manifest) as f:
                for line in f:
                    rec = json.loads(line)
                    self.shards.append(os.path.join(path, rec["file"]))
        else:
            self.shards = sorted(
                os.path.join(path, n) for n in os.listdir(path) if n.endswith(".npz")
            )
        if not self.shards:
            raise FileNotFoundError(f"no rollout shards under {path}")
        self.rng = np.random.default_rng(seed)
        self._cache: Optional[Dict[str, np.ndarray]] = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for s in self.shards:
            with np.load(s) as z:
                yield {k: z[k] for k in z.files}

    def _all(self) -> Dict[str, np.ndarray]:
        if self._cache is None:
            parts: Dict[str, list] = {}
            for batch in self:
                for k, v in batch.items():
                    parts.setdefault(k, []).append(v)
            self._cache = {k: np.concatenate(v) for k, v in parts.items()}
        return self._cache

    @property
    def num_rows(self) -> int:
        return int(len(next(iter(self._all().values()))))

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        data = self._all()
        idx = self.rng.integers(0, self.num_rows, size=batch_size)
        return {k: v[idx] for k, v in data.items()}

    def add_derived_column(self, name: str, per_shard_fn) -> None:
        """Attach a computed column aligned with the stored rows.

        per_shard_fn(shard_dict) -> 1-D array of len(shard rows); shards are
        visited in this reader's iteration order, so the concatenation
        matches `_all()`'s row order by construction — callers never need to
        reason about (or reach into) the cache layout.  Used by MARWIL to
        inject per-episode discounted returns.

        A column already present in the data (e.g. returns logged at
        collection time with a different scheme) is honored, not
        overwritten."""
        if name in self._all():
            return
        parts = [np.asarray(per_shard_fn(shard)) for shard in self]
        data = dict(self._all())
        col = np.concatenate(parts)
        if len(col) != self.num_rows:
            raise ValueError(
                f"derived column {name!r} has {len(col)} rows, store has "
                f"{self.num_rows}"
            )
        data[name] = col
        self._cache = data


class BCLearner(_Learner):
    """Behavior cloning: maximize log-likelihood of the logged actions
    (rllib/algorithms/bc; one cross-entropy update)."""

    def __init__(self, module, *, lr: float = 1e-3, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.module = module.init(seed).to(self.device)
        self.opt = adam(self.module.parameters(), lr)

    def _modules(self):
        return (self.module,)

    def loss(self, batch):
        logp = F.log_softmax(self.module.logits(batch["obs"]), dim=-1)
        return torch.mean(-logp.gather(-1, batch["actions"][:, None])[:, 0])

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        batch = {k: batch[k] for k in ("obs", "actions")}
        loss = self.loss(to_device(batch, self.device, self.dtype))
        adam_step(self.opt, loss)
        return {"bc_loss": loss.item()}


def record_rollouts(algo, path: str, num_iterations: int = 1) -> str:
    """Sample from a built Algorithm's env runners and persist the flat
    transitions — the 'generate offline data from a policy' workflow the
    reference documents for BC."""
    from ..core import api as _ca

    writer = RolloutWriter(path)
    for _ in range(num_iterations):
        rollouts = _ca.get(
            [r.sample.remote(algo.config.rollout_length) for r in algo.runners]
        )
        for ro in rollouts:
            ro.pop("metrics", None)
            T, N = ro["rewards"].shape
            acts = ro["actions"]
            if acts.ndim == 3:  # continuous [T, N, A]: keep vectors + dtype
                acts = acts.reshape(T * N, -1).astype(np.float32)
            else:
                acts = acts.reshape(-1).astype(np.int32)
            writer.write({
                "obs": ro["obs"].reshape(T * N, -1).astype(np.float32),
                "actions": acts,
                "rewards": ro["rewards"].reshape(-1).astype(np.float32),
                "dones": ro["dones"].reshape(-1).astype(np.float32),
            })
    return path


def train_bc(
    path: str,
    obs_dim: int,
    num_actions: int,
    *,
    hidden=(64, 64),
    lr: float = 1e-3,
    batch_size: int = 256,
    num_updates: int = 500,
    seed: int = 0,
    device=None,
):
    """Offline BC training loop over logged rollouts; returns the learner."""
    from .module import DiscretePolicyModule

    reader = RolloutReader(path, seed=seed)
    learner = BCLearner(
        DiscretePolicyModule(obs_dim, num_actions, hidden), lr=lr, seed=seed, device=device
    )
    stats = {}
    for _ in range(num_updates):
        stats = learner.update(reader.sample(batch_size))
    learner.last_stats = stats
    return learner


class CQLLearner(_Learner):
    """Discrete conservative Q-learning (reference rllib/algorithms/cql):
    double-DQN TD loss plus the CQL regularizer — logsumexp over all
    actions minus the logged action's Q — which penalizes out-of-dataset
    actions so purely offline data can't inflate unseen-action values."""

    def __init__(self, module, *, lr: float = 1e-3, gamma: float = 0.99,
                 cql_alpha: float = 1.0, target_update_freq: int = 100,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.module = module.init(seed).to(self.device)
        self.target = _frozen(self.module)
        self.gamma = gamma
        self.cql_alpha = cql_alpha
        self.target_update_freq = target_update_freq
        self.opt = adam(self.module.parameters(), lr)
        self.updates_done = 0

    def _modules(self):
        return (self.module,)

    def loss(self, batch):
        q = self.module.q_values(batch["obs"])
        q_taken = q.gather(-1, batch["actions"][:, None])[:, 0]
        best = torch.argmax(self.module.q_values(batch["next_obs"]), dim=-1)
        q_next = self.target.q_values(batch["next_obs"]).gather(-1, best[:, None])[:, 0]
        target = batch["rewards"] + self.gamma * (1.0 - batch["dones"]) * q_next
        td = torch.mean((q_taken - target.detach()) ** 2)
        # conservative penalty: push down the soft-max over ALL actions,
        # push up the action the dataset actually took
        cql = torch.mean(torch.logsumexp(q, dim=-1) - q_taken)
        return td + self.cql_alpha * cql, (td, cql)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        keys = ("obs", "actions", "rewards", "dones", "next_obs")
        tb = to_device({k: batch[k] for k in keys}, self.device, self.dtype)
        loss, (td, cql) = self.loss(tb)
        adam_step(self.opt, loss)
        self.updates_done += 1
        if self.updates_done % self.target_update_freq == 0:
            self.target.load_state_dict(self.module.state_dict())
        return {"loss": loss.item(), "td_loss": td.item(), "cql_penalty": cql.item()}


def train_cql(
    path: str,
    obs_dim: int,
    num_actions: int,
    *,
    hidden=(64, 64),
    lr: float = 1e-3,
    gamma: float = 0.99,
    cql_alpha: float = 1.0,
    batch_size: int = 256,
    num_updates: int = 1000,
    seed: int = 0,
    device=None,
):
    """Offline CQL over logged transitions (shards must carry obs/actions/
    rewards/dones/next_obs; record_rollouts writes obs/actions/rewards/dones
    — next_obs is derived by shifting within each shard)."""
    from .module import QModule

    reader = RolloutReader(path, seed=seed)
    data = reader._all()
    if "next_obs" not in data:
        nxt = np.concatenate([data["obs"][1:], data["obs"][-1:]], axis=0)
        data = dict(data, next_obs=nxt)
        reader._cache = data
    learner = CQLLearner(
        QModule(obs_dim, num_actions, hidden),
        lr=lr, gamma=gamma, cql_alpha=cql_alpha, seed=seed, device=device,
    )
    stats = {}
    for _ in range(num_updates):
        stats = learner.update(reader.sample(batch_size))
    learner.last_stats = stats
    return learner
