"""Learners: parameter updates with torch.optim.Adam on the learner's
device (the JAX package's rl/learner.py, whose updates are jitted optax
programs).

A learner takes `device=None`, meaning the card, and raises without one;
only `device="cpu"` runs on the host.  Its update reads numpy batches,
moves them to the device and returns host floats.  The numerics are the
JAX package's: optax.adam is torch.optim.Adam(lr, eps=1e-8) (a parameter
the loss does not reach still steps on its moments, as optax's zero
gradient does), stop_gradient is detach(), scans are loops in the same
order, and the noise of SAC and TD3 is an argument of `update` (drawn
from a torch.Generator on the device when not given).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from .module import detached, load_tree

ADAM_EPS = 1e-8  # optax.adam's


def adam(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(list(params), lr=lr, eps=ADAM_EPS)


def adam_step(opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """One optax.adam step on `loss`: a parameter without a gradient gets a
    zero one, so that it moves on its moments as optax's does."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    step_all(opt)


def step_all(opt: torch.optim.Optimizer) -> None:
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()


def to_device(batch: Dict[str, Any], device: torch.device,
              dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """numpy arrays as tensors on `device`: floats and bools in the
    learner's dtype (float32, as the JAX package runs without x64),
    integers as int64 (indices)."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if a.dtype.kind in "iu":
            out[k] = torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    return out


def _tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A noise draw (numpy or a tensor) on device, in dtype."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device, dtype)


def _taken(logp_all: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    return logp_all.gather(-1, actions[..., None]).squeeze(-1)


def _entropy(logp_all: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))


def _frozen(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of `module` that takes no gradient (a target network)."""
    target = copy.deepcopy(module)
    for p in target.parameters():
        p.requires_grad_(False)
    return target


def _polyak(target: torch.nn.Module, online: torch.nn.Module, tau: float) -> None:
    with torch.no_grad():
        for t, p in zip(target.parameters(), online.parameters()):
            t.copy_((1 - tau) * t + tau * p)


@contextlib.contextmanager
def _constant(module: torch.nn.Module):
    """Builds graph with module's parameters held constant (JAX: the module
    applied to stop_gradient(params)): gradients still reach its inputs."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class _Learner:
    """What every learner shares: its device, its module(s) and the
    weight tree (the JAX package's `params`)."""

    device: torch.device

    def _modules(self) -> tuple:
        """The learner's modules, in the order of its weight tree."""
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' dtype, in which the update computes (float32;
        a test may cast the modules to float64)."""
        return next(self._modules()[0].parameters()).dtype

    def param_tree(self) -> Dict[str, Any]:
        tree: Dict[str, Any] = {}
        for m in self._modules():
            tree.update(m.param_tree())
        return tree

    def get_weights(self):
        """The weights as the JAX tree, detached copies on the device."""
        return detached(self.param_tree())

    def set_weights(self, params):
        load_tree(self.param_tree(), params)
        return "ok"


class PPOLearner(_Learner):
    """Clipped-surrogate PPO with GAE (reference rllib/algorithms/ppo/)."""

    def __init__(
        self,
        module,
        *,
        lr: float = 3e-4,
        clip: float = 0.2,
        vf_coeff: float = 0.5,
        entropy_coeff: float = 0.01,
        epochs: int = 4,
        minibatches: int = 4,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.module = module.init(seed).to(self.device)
        self.clip = clip
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.epochs = epochs
        self.minibatches = minibatches
        self.opt = adam(self.module.parameters(), lr)
        # minibatch order from numpy, as the JAX package draws it
        self.rng = np.random.default_rng(seed)

    def _modules(self):
        return (self.module,)

    def loss(self, batch):
        logp_all = F.log_softmax(self.module.logits(batch["obs"]), dim=-1)
        ratio = torch.exp(_taken(logp_all, batch["actions"]) - batch["logp_old"])
        adv = batch["advantages"]
        clipped = torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv
        pi_loss = -torch.mean(torch.minimum(ratio * adv, clipped))
        vf_loss = torch.mean((self.module.value(batch["obs"]) - batch["returns"]) ** 2)
        entropy = _entropy(logp_all)
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """batch: flat arrays obs/actions/logp_old/advantages/returns."""
        n = len(batch["obs"])
        for _ in range(self.epochs):
            order = self.rng.permutation(n)
            for mb in np.array_split(order, self.minibatches):
                sub = to_device({k: v[mb] for k, v in batch.items()}, self.device, self.dtype)
                loss, aux = self.loss(sub)
                adam_step(self.opt, loss)
        stats = {"loss": loss.item()}
        stats.update({k: v.item() for k, v in aux.items()})
        return stats


class RecurrentPPOLearner(_Learner):
    """PPO over sequences with a recurrent (GRU) module.  The loss unrolls
    the whole [T, N] rollout from each sequence's stored initial state,
    resetting the state at episode boundaries; epochs re-unroll the same
    sequences."""

    def __init__(
        self,
        module,
        *,
        lr: float = 3e-4,
        clip: float = 0.2,
        vf_coeff: float = 0.5,
        entropy_coeff: float = 0.01,
        epochs: int = 4,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.module = module.init(seed).to(self.device)
        self.clip = clip
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.epochs = epochs
        self.opt = adam(self.module.parameters(), lr)

    def _modules(self):
        return (self.module,)

    def loss(self, batch):
        # dones shifted: done at t resets the state entering t+1; the
        # state entering t=0 is state0 (recorded by the runner)
        dones = batch["dones"]
        prev_dones = torch.cat([torch.zeros_like(dones[:1]), dones[:-1]], dim=0)
        logits, values, _ = self.module.unroll(batch["obs"], batch["state0"], prev_dones)
        logp_all = F.log_softmax(logits, dim=-1)
        ratio = torch.exp(_taken(logp_all, batch["actions"]) - batch["logp_old"])
        adv = batch["advantages"]
        clipped = torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv
        pi_loss = -torch.mean(torch.minimum(ratio * adv, clipped))
        vf_loss = torch.mean((values - batch["returns"]) ** 2)
        entropy = _entropy(logp_all)
        total = pi_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """batch: sequence-shaped obs [T,N,D], actions/logp_old/advantages/
        returns/dones [T,N], state0 [N,H]."""
        tb = to_device(batch, self.device, self.dtype)
        for _ in range(self.epochs):
            loss, aux = self.loss(tb)
            adam_step(self.opt, loss)
        stats = {"loss": loss.item()}
        stats.update({k: v.item() for k, v in aux.items()})
        return stats


class DQNLearner(_Learner):
    """Double-DQN update with a periodically synced target net
    (reference rllib/algorithms/dqn/)."""

    def __init__(
        self,
        module,
        *,
        lr: float = 1e-3,
        gamma: float = 0.99,
        target_update_freq: int = 100,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.module = module.init(seed).to(self.device)
        self.target = _frozen(self.module)
        self.gamma = gamma
        self.target_update_freq = target_update_freq
        self.opt = adam(self.module.parameters(), lr)
        self.updates_done = 0

    def _modules(self):
        return (self.module,)

    def td_errors(self, batch):
        q = self.module.q_values(batch["obs"])
        q_taken = _taken(q, batch["actions"])
        # double dqn: online net picks the argmax, target net evaluates it
        best = torch.argmax(self.module.q_values(batch["next_obs"]), dim=-1)
        q_next = _taken(self.target.q_values(batch["next_obs"]), best)
        target = batch["rewards"] + self.gamma * (1.0 - batch["dones"]) * q_next
        return q_taken - target.detach()

    def loss(self, batch, weights):
        td = self.td_errors(batch)
        return torch.mean(weights * td**2), torch.abs(td).detach()

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """PER batches carry "weights" (importance correction applied to the
        per-sample squared TD) and "indices"; td_abs comes back so the
        caller can feed buffer.update_priorities."""
        tb = to_device({k: v for k, v in batch.items() if k not in ("weights", "indices")},
                       self.device, self.dtype)
        w = to_device({"w": batch.get("weights", np.ones(len(batch["rewards"]), np.float32))},
                      self.device, self.dtype)["w"]
        loss, td_abs = self.loss(tb, w)
        adam_step(self.opt, loss)
        self.updates_done += 1
        if self.updates_done % self.target_update_freq == 0:
            self.target.load_state_dict(self.module.state_dict())
        out = {"loss": loss.item()}
        if "indices" in batch:
            out["td_abs"] = td_abs.cpu().numpy()
            out["indices"] = batch["indices"]
        return out


class IMPALALearner(_Learner):
    """V-trace actor-critic (reference rllib/algorithms/impala/): rollouts
    from runners whose policies lag the learner; importance-weighted
    V-trace targets correct the off-policy gap.

    ``surrogate_clip`` turns this into APPO: the PPO clipped surrogate on
    the V-trace advantage instead of the plain policy gradient."""

    def __init__(
        self,
        module,
        *,
        lr: float = 3e-4,
        gamma: float = 0.99,
        vf_coeff: float = 0.5,
        entropy_coeff: float = 0.01,
        rho_clip: float = 1.0,
        c_clip: float = 1.0,
        surrogate_clip: float = None,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.module = module.init(seed).to(self.device)
        self.gamma = gamma
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.rho_clip, self.c_clip = rho_clip, c_clip
        self.surrogate_clip = surrogate_clip
        self.opt = adam(self.module.parameters(), lr)

    def _modules(self):
        return (self.module,)

    def loss(self, batch):
        # batch arrays are [T, N, ...] time-major; bootstrap obs [N, ...]
        obs, actions, rewards = batch["obs"], batch["actions"], batch["rewards"]
        T, N = actions.shape
        flat_obs = obs.reshape(T * N, -1)
        logits = self.module.logits(flat_obs).reshape(T, N, -1)
        values = self.module.value(flat_obs).reshape(T, N)
        boot_value = self.module.value(batch["next_obs"])  # [N]
        logp_all = F.log_softmax(logits, dim=-1)
        logp = _taken(logp_all, actions)
        rho = torch.exp(logp - batch["logp"])
        discounts = self.gamma * (1.0 - batch["dones"])
        # V-trace targets take no gradient: every use below is stopped
        with torch.no_grad():
            rho_bar = torch.clamp(rho, max=self.rho_clip)
            c_bar = torch.clamp(rho, max=self.c_clip)
            next_values = torch.cat([values[1:], boot_value[None]], dim=0)
            deltas = rho_bar * (rewards + discounts * next_values - values)
            acc = torch.zeros(N, dtype=values.dtype, device=values.device)
            vs_minus_v = [None] * T
            for t in range(T - 1, -1, -1):  # the reverse scan
                acc = deltas[t] + discounts[t] * c_bar[t] * acc
                vs_minus_v[t] = acc
            vs = torch.stack(vs_minus_v) + values
            next_vs = torch.cat([vs[1:], boot_value[None]], dim=0)
            pg_adv = rho_bar * (rewards + discounts * next_vs - values)
            adv = rewards + discounts * next_vs - values
        if self.surrogate_clip is not None:
            # APPO: clipped surrogate on the V-trace advantage
            clipped = torch.clamp(rho, 1 - self.surrogate_clip, 1 + self.surrogate_clip)
            pg_loss = -torch.mean(torch.minimum(rho * adv, clipped * adv))
        else:
            pg_loss = -torch.mean(logp * pg_adv)
        vf_loss = torch.mean((values - vs) ** 2)
        entropy = _entropy(logp_all)
        total = pg_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"pi_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy,
                       "mean_rho": torch.mean(rho)}

    def update(self, rollout: Dict[str, np.ndarray]) -> Dict[str, float]:
        """rollout: time-major [T, N] arrays obs/actions/rewards/dones/logp
        plus bootstrap next_obs [N]."""
        keys = ("obs", "actions", "rewards", "dones", "logp", "next_obs")
        loss, aux = self.loss(to_device({k: rollout[k] for k in keys}, self.device, self.dtype))
        adam_step(self.opt, loss)
        out = {"loss": loss.item()}
        out.update({k: v.item() for k, v in aux.items()})
        return out


def compute_gae(rollout: Dict[str, np.ndarray], gamma: float, lam: float):
    """rollout arrays [T, N]; returns flat advantages/returns [T*N]."""
    rewards, values, dones = rollout["rewards"], rollout["values"], rollout["dones"]
    last_values = rollout["last_values"]
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last_gae = np.zeros(N, np.float32)
    next_values = last_values
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_values * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_values = values[t]
    returns = adv + values
    adv_flat = adv.reshape(-1)
    adv_flat = (adv_flat - adv_flat.mean()) / (adv_flat.std() + 1e-8)
    return adv_flat, returns.reshape(-1)


class _NoiseLearner(_Learner):
    """A learner whose update draws Gaussian noise: from a generator on its
    device seeded seed + 1 (the JAX package's key), unless the caller
    passes the draws."""

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device).to(self.dtype)


class SACLearner(_NoiseLearner):
    """Soft actor-critic with clipped double-Q, polyak target critics, and
    automatic entropy-temperature tuning (reference rllib/algorithms/sac/);
    one Adam over the policy, both critics and log_alpha."""

    def __init__(
        self,
        policy_module,
        q_module,
        *,
        lr: float = 3e-4,
        gamma: float = 0.99,
        tau: float = 0.005,
        target_entropy: float = None,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.policy = policy_module.init(seed).to(self.device)
        self.qnet = q_module.init(seed + 1).to(self.device)
        self.log_alpha = torch.nn.Parameter(torch.zeros((), device=self.device))
        self.target = _frozen(self.qnet)
        self.gamma = gamma
        self.tau = tau
        if target_entropy is None:
            target_entropy = -float(policy_module.action_dim)
        self.target_entropy = target_entropy
        self.opt = adam([*self.policy.parameters(), *self.qnet.parameters(), self.log_alpha], lr)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    def _modules(self):
        return (self.policy, self.qnet)

    def param_tree(self):
        return {**super().param_tree(), "log_alpha": self.log_alpha}

    def losses(self, batch, eps_next, eps):
        alpha = torch.exp(self.log_alpha)
        # critic targets from the frozen nets + current policy (actions
        # are env-scaled on both the buffer and the sampler side)
        next_act, next_logp = self.policy.sample(batch["next_obs"], eps_next)
        tq1, tq2 = self.target.q(batch["next_obs"], next_act)
        soft_v = torch.minimum(tq1, tq2) - alpha.detach() * next_logp
        y = (batch["rewards"] + self.gamma * (1.0 - batch["dones"]) * soft_v).detach()
        q1, q2 = self.qnet.q(batch["obs"], batch["actions"])
        critic_loss = torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)
        # actor: maximize min-Q of a fresh sample minus entropy cost, the
        # critics held constant
        act, logp = self.policy.sample(batch["obs"], eps)
        with _constant(self.qnet):
            pq1, pq2 = self.qnet.q(batch["obs"], act)
        actor_loss = torch.mean(alpha.detach() * logp - torch.minimum(pq1, pq2))
        # temperature: drive policy entropy toward the target
        alpha_loss = -torch.mean(self.log_alpha * (logp + self.target_entropy).detach())
        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss, "actor_loss": actor_loss, "alpha": alpha,
                       "entropy": -torch.mean(logp)}

    def update(self, batch: Dict[str, np.ndarray],
               noise: Optional[Tuple[Any, Any]] = None) -> Dict[str, float]:
        """noise: (eps for next_obs's sample, eps for obs's sample), each
        standard normal [B, action_dim]; drawn here when None."""
        tb = to_device(batch, self.device, self.dtype)
        shape = (len(batch["obs"]), self.policy.action_dim)
        if noise is None:
            noise = (self._normal(shape), self._normal(shape))
        eps_next, eps = (_tensor(n, self.device, self.dtype) for n in noise)
        total, aux = self.losses(tb, eps_next, eps)
        adam_step(self.opt, total)
        _polyak(self.target, self.qnet, self.tau)
        return {k: v.item() for k, v in aux.items()}


class TD3Learner(_NoiseLearner):
    """Twin Delayed DDPG (reference rllib/algorithms/td3): deterministic
    actor, clipped double-Q critics, target-policy smoothing (clipped
    Gaussian noise on the target action), and delayed actor/target updates
    (policy_delay critic steps per actor step), each on its own Adam."""

    def __init__(
        self,
        policy_module,
        q_module,
        *,
        lr: float = 3e-4,
        gamma: float = 0.99,
        tau: float = 0.005,
        policy_delay: int = 2,
        target_noise: float = 0.2,
        noise_clip: float = 0.5,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.policy = policy_module.init(seed).to(self.device)
        self.qnet = q_module.init(seed + 1).to(self.device)
        self.target_policy = _frozen(self.policy)
        self.target_q = _frozen(self.qnet)
        self.gamma = gamma
        self.tau = tau
        self.policy_delay = max(1, int(policy_delay))
        self.target_noise = target_noise
        self.noise_clip = noise_clip
        # separate optimizers: a shared Adam would keep moving the actor on
        # critic-only steps via accumulated momentum, defeating the delay
        self.opt_c = adam(self.qnet.parameters(), lr)
        self.opt_a = adam(self.policy.parameters(), lr)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.steps = 0

    def _modules(self):
        return (self.policy, self.qnet)

    def critic_loss(self, batch, noise):
        scale = self.policy.action_scale
        # target-policy smoothing: noise on the target action, clipped,
        # then clipped back into the action box
        next_mu = self.target_policy.mean_action(batch["next_obs"])
        n = torch.clamp(noise * self.target_noise * scale, -self.noise_clip * scale,
                        self.noise_clip * scale)
        next_act = torch.clamp(next_mu + n, -scale, scale)
        tq1, tq2 = self.target_q.q(batch["next_obs"], next_act)
        y = (batch["rewards"] + self.gamma * (1.0 - batch["dones"])
             * torch.minimum(tq1, tq2)).detach()
        q1, q2 = self.qnet.q(batch["obs"], batch["actions"])
        return torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)

    def actor_loss(self, batch):
        with _constant(self.qnet):
            q1, _ = self.qnet.q(batch["obs"], self.policy.mean_action(batch["obs"]))
        return -torch.mean(q1)

    def update(self, batch: Dict[str, np.ndarray], noise=None) -> Dict[str, float]:
        """noise: standard normal [B, action_dim] for the target smoothing;
        drawn here when None."""
        tb = to_device(batch, self.device, self.dtype)
        if noise is None:
            noise = self._normal((len(batch["obs"]), self.policy.action_dim))
        noise = _tensor(noise, self.device, self.dtype)
        closs = self.critic_loss(tb, noise)
        do_actor = self.steps % self.policy_delay == 0
        self.opt_c.zero_grad(set_to_none=True)
        closs.backward()
        if do_actor:
            # the actor's loss reads the critics from before this step's update
            aloss = self.actor_loss(tb)
            self.opt_a.zero_grad(set_to_none=True)
            aloss.backward()
        step_all(self.opt_c)
        if do_actor:
            step_all(self.opt_a)
            # delayed target polyak, same cadence as the actor
            _polyak(self.target_policy, self.policy, self.tau)
            _polyak(self.target_q, self.qnet, self.tau)
        self.steps += 1
        return {"critic_loss": closs.item(), "actor_loss": aloss.item() if do_actor else 0.0}
