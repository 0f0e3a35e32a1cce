"""MARWIL: Monotonic Advantage Re-Weighted Imitation Learning.

Reference parity: ``rllib/algorithms/marwil/marwil.py`` (+ the MARWIL loss
in ``marwil/torch/marwil_torch_learner.py``) — offline learning that
interpolates between behavior cloning (beta=0) and advantage-weighted
policy improvement (beta>0): logged actions are imitated with weight
exp(beta * A / c), where A = R - V(s) and c is a running scale estimate of
the advantage magnitude (the "monotonic" normalizer from the paper).

One update (policy CE + value regression in one backward), the running
advantage scale kept as a tensor on the learner's device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from .learner import _Learner, adam, adam_step, to_device


def compute_returns(
    rewards: np.ndarray, dones: np.ndarray, gamma: float = 0.99,
    n_envs: int = 1,
) -> np.ndarray:
    """Discounted Monte-Carlo returns over a recorded transition stream,
    reset at episode boundaries (dones).

    record_rollouts flattens [T, N] batches C-order (row = t*N + n), so a
    shard with n_envs > 1 interleaves N independent env streams; returns
    must run down each column, not the interleaved flat order."""
    flat = np.asarray(rewards, dtype=np.float32)
    d = np.asarray(dones, dtype=bool)
    if n_envs > 1:
        if len(flat) % n_envs:
            raise ValueError(
                f"shard rows {len(flat)} not divisible by n_envs {n_envs}"
            )
        r2 = flat.reshape(-1, n_envs)
        d2 = d.reshape(-1, n_envs)
        out = np.zeros_like(r2)
        acc = np.zeros(n_envs, dtype=np.float32)
        for t in range(r2.shape[0] - 1, -1, -1):
            acc[d2[t]] = 0.0
            acc = r2[t] + gamma * acc
            out[t] = acc
        return out.reshape(-1)
    out = np.zeros(len(flat), dtype=np.float32)
    acc0 = 0.0
    for i in range(len(flat) - 1, -1, -1):
        if d[i]:
            acc0 = 0.0
        acc0 = float(flat[i]) + gamma * acc0
        out[i] = acc0
    return out


class MARWILLearner(_Learner):
    """One MARWIL update over (obs, actions, returns) minibatches."""

    def __init__(
        self,
        module,
        *,
        beta: float = 1.0,
        vf_coeff: float = 1.0,
        moving_average_sqd_adv_norm_update_rate: float = 1e-8,
        lr: float = 1e-3,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.module = module.init(seed).to(self.device)
        self.opt = adam(self.module.parameters(), lr)
        self.beta, self.vf_coeff = beta, vf_coeff
        self.tau = moving_average_sqd_adv_norm_update_rate
        # c^2: running estimate of E[A^2] (reference:
        # ma_adv_norm / MOVING_AVERAGE_SQD_ADV_NORM_UPDATE_RATE)
        self.adv_norm_sq = torch.tensor(1.0, device=self.device)

    def _modules(self):
        return (self.module,)

    def loss(self, batch, adv_norm_sq):
        logits = self.module.logits(batch["obs"])
        v = self.module.value(batch["obs"])
        ret = batch["returns"]
        adv = ret - v.detach()
        vf_loss = torch.mean((ret - v) ** 2)
        if self.beta != 0.0:
            # update c^2 first, then weight by exp(beta * A / c), both per
            # the paper; clip the exponent like the reference so a stray
            # advantage can't produce an inf weight
            new_norm = adv_norm_sq + self.tau * (torch.mean(adv**2) - adv_norm_sq)
            c = torch.sqrt(new_norm + 1e-8)
            w = torch.exp(torch.clamp(self.beta * adv / c, -20.0, 20.0)).detach()
        else:
            new_norm = adv_norm_sq
            w = torch.ones_like(ret)
        act_logp = F.log_softmax(logits, dim=-1).gather(-1, batch["actions"][:, None])[:, 0]
        policy_loss = -torch.mean(w * act_logp)
        total = policy_loss + self.vf_coeff * vf_loss
        return total, (policy_loss, vf_loss, new_norm.detach())

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        keys = ("obs", "actions", "returns")
        tb = to_device({k: batch[k] for k in keys}, self.device, self.dtype)
        total, (pl, vl, self.adv_norm_sq) = self.loss(tb, self.adv_norm_sq)
        adam_step(self.opt, total)
        return {
            "marwil_loss": total.item(),
            "policy_loss": pl.item(),
            "vf_loss": vl.item(),
            "adv_norm": float(self.adv_norm_sq) ** 0.5,
        }


def train_marwil(
    path: str,
    obs_dim: int,
    num_actions: int,
    *,
    beta: float = 1.0,
    gamma: float = 0.99,
    n_envs: int = 1,
    hidden=(64, 64),
    lr: float = 1e-3,
    vf_coeff: float = 1.0,
    batch_size: int = 256,
    num_updates: int = 500,
    seed: int = 0,
    device=None,
) -> MARWILLearner:
    """Offline MARWIL over logged rollouts (rllib algorithms/marwil role):
    returns are computed per shard (time-ordered within a shard) and sampled
    as flat (obs, action, return) rows."""
    from .module import DiscretePolicyModule
    from .offline import RolloutReader

    reader = RolloutReader(path, seed=seed)
    reader.add_derived_column(
        "returns",
        lambda shard: compute_returns(
            shard["rewards"], shard["dones"], gamma=gamma, n_envs=n_envs
        ),
    )
    learner = MARWILLearner(
        DiscretePolicyModule(obs_dim, num_actions, hidden),
        beta=beta, vf_coeff=vf_coeff, lr=lr, seed=seed, device=device,
    )
    stats: Dict[str, float] = {}
    for _ in range(num_updates):
        stats = learner.update(reader.sample(batch_size))
    learner.last_stats = stats
    return learner
