"""RLModule: the neural networks as torch modules (the JAX package's
rl/module.py, whose modules are pure pytrees).

Every weight keeps the JAX tree's layout: a dense layer is {"w": [fan_in,
fan_out], "b": [fan_out]} applied as x @ w + b, and `param_tree()` gives
the module's parameters in the JAX module's tree ({"pi": [...], "vf":
[...]}, ...), so weights move between the packages unchanged
(`load_tree`, models/convert.py) and a checkpoint has the same keys.
`init(seed)` draws fresh weights as the JAX `init(key)` does (He-normal
weights, zero biases) from a torch generator; the draws differ from JAX's,
so parity tests carry JAX's params across.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
from torch import nn


class Dense(nn.Module):
    """x @ w + b with w [fan_in, fan_out] (the JAX layout)."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out))
        self.b = nn.Parameter(torch.zeros(fan_out))

    def reset(self, gen: torch.Generator) -> None:
        """He-normal weights (JAX: normal * (2 / fan_in) ** 0.5), zero bias."""
        self.w.copy_(torch.randn(self.w.shape, generator=gen) * (2.0 / self.w.shape[0]) ** 0.5)
        self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b

    def tree(self) -> Dict[str, nn.Parameter]:
        return {"w": self.w, "b": self.b}


class MLP(nn.Module):
    """Dense layers with `act` between them (JAX `mlp_forward`: tanh, the
    last layer linear; act_last also after the last)."""

    def __init__(self, sizes: Sequence[int], act=torch.tanh, act_last: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(Dense(m, n) for m, n in zip(sizes[:-1], sizes[1:]))
        self.act, self.act_last = act, act_last

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last or self.act_last:
                x = self.act(x)
        return x

    def tree(self) -> list:
        return [layer.tree() for layer in self.layers]


class RLModule(nn.Module):
    """Base of the port's RL modules: the JAX tree of the parameters and a
    seeded init."""

    def param_tree(self) -> Dict[str, Any]:
        raise NotImplementedError

    def init(self, seed: int) -> "RLModule":
        """Fresh weights from `seed` (JAX: `module.init(key)`), drawn on the
        host so that every device gets the same ones."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in self.modules():
                if m is not self and hasattr(m, "reset"):  # Dense, Dreamer's GRU
                    m.reset(gen)
        return self


def load_tree(dst, src) -> None:
    """Copy the values of `src` (numpy arrays or tensors on any device, in
    the JAX tree's layout) into the parameters of the tree `dst` (a
    module's param_tree()).  Only dst's keys are read: a learner's whole
    tree loads into a runner's policy."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            load_tree(v, src[k])
        return
    if isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f"a tree of {len(src)} layers does not fit {len(dst)}")
        for d, s in zip(dst, src):
            load_tree(d, s)
        return
    value = src.detach() if isinstance(src, torch.Tensor) else torch.from_numpy(
        np.array(src, dtype=np.float32))
    if tuple(value.shape) != tuple(dst.shape):
        raise ValueError(f"param shape {tuple(value.shape)} != expected {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(value.to(dst.device, dst.dtype))


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def detached(tree):
    """A copy of the tree's tensors, detached, on their device."""
    return tree_map(lambda t: t.detach().clone(), tree)


def to_numpy(tree):
    """The tree as float32 numpy arrays on the host, copies (never views
    of a CPU module's live parameters)."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32, copy=True).numpy(), tree)


class DiscretePolicyModule(RLModule):
    """Separate policy and value MLPs over a flat observation."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.pi = MLP((obs_dim, *self.hidden, num_actions))
        self.vf = MLP((obs_dim, *self.hidden, 1))

    def param_tree(self):
        return {"pi": self.pi.tree(), "vf": self.vf.tree()}

    def logits(self, obs):
        return self.pi(obs)

    def value(self, obs):
        return self.vf(obs)[..., 0]


class RecurrentPolicyModule(RLModule):
    """GRU-core actor-critic: obs -> encoder MLP -> GRU -> policy/value
    heads.  The GRU is the JAX module's, not torch.nn.GRU: its z, r and n
    gates each come from their own weight over [x, h], r multiplies h
    before the candidate's product, and h' = (1 - z) * n + z * h."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 64,
                 encoder: Sequence[int] = (64,)):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = int(hidden)
        self.encoder = tuple(encoder)
        enc_out = self.encoder[-1] if self.encoder else obs_dim
        h = self.hidden
        self.enc = MLP((obs_dim, *self.encoder)) if self.encoder else None
        # update / reset / candidate gates, each over [x, h]
        self.gru = nn.ModuleDict({name: Dense(enc_out + h, h) for name in ("z", "r", "n")})
        self.pi = MLP((h, num_actions))
        self.vf = MLP((h, 1))

    def param_tree(self):
        return {
            "enc": self.enc.tree() if self.enc is not None else [],
            "gru": {name: self.gru[name].tree() for name in ("z", "r", "n")},
            "pi": self.pi.tree(),
            "vf": self.vf.tree(),
        }

    def initial_state(self, batch_size: int):
        return np.zeros((batch_size, self.hidden), np.float32)

    def _encode(self, obs):
        if self.enc is None:
            return obs
        return torch.tanh(self.enc(obs))  # the MLP leaves its last layer linear

    def _gru_cell(self, x, state):
        xh = torch.cat([x, state], dim=-1)
        z = torch.sigmoid(self.gru["z"](xh))
        r = torch.sigmoid(self.gru["r"](xh))
        n = torch.tanh(self.gru["n"](torch.cat([x, r * state], dim=-1)))
        return (1.0 - z) * n + z * state

    def step(self, obs, state):
        """One timestep: obs [B, D], state [B, H] ->
        (logits [B, A], value [B], new_state [B, H])."""
        h = self._gru_cell(self._encode(obs), state)
        return self.pi(h), self.vf(h)[..., 0], h

    def unroll(self, obs_seq, state0, resets):
        """Sequence forward: obs_seq [T, B, D], state0 [B, H], resets [T, B]:
        resets[t] = 1 zeroes the state before obs[t].  Returns (logits
        [T, B, A], values [T, B], final state)."""
        state = state0
        logits, values = [], []
        for t in range(obs_seq.shape[0]):
            state = torch.where(resets[t][:, None] > 0, torch.zeros_like(state), state)
            lg, v, state = self.step(obs_seq[t], state)
            logits.append(lg)
            values.append(v)
        return torch.stack(logits), torch.stack(values), state


class QModule(RLModule):
    """Q-network (+ the same arch reused for the DQN target net)."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.q = MLP((obs_dim, *self.hidden, num_actions))

    def param_tree(self):
        return {"q": self.q.tree()}

    def q_values(self, obs):
        return self.q(obs)


class SquashedGaussianModule(RLModule):
    """tanh-squashed Gaussian policy over a continuous action box (the SAC
    policy head).  The noise is an argument: the learner and the runner
    draw it from their own generators."""

    LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0

    def __init__(self, obs_dim: int, action_dim: int, action_scale: float = 1.0,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.action_scale = float(action_scale)
        self.hidden = tuple(hidden)
        self.pi = MLP((obs_dim, *self.hidden, 2 * action_dim))

    def param_tree(self):
        return {"pi": self.pi.tree()}

    def dist(self, obs):
        mean, log_std = torch.chunk(self.pi(obs), 2, dim=-1)
        return mean, torch.clamp(log_std, self.LOG_STD_MIN, self.LOG_STD_MAX)

    def sample(self, obs, eps):
        """Reparameterized squashed sample for standard-normal `eps` (the
        mean's shape) -> (action, logp)."""
        mean, log_std = self.dist(obs)
        std = torch.exp(log_std)
        pre = mean + std * eps
        act = torch.tanh(pre)
        # N(pre; mean, std) log-density with the change of variables for
        # tanh and the affine action_scale (a log(scale) per dim)
        logp = -0.5 * (((pre - mean) / std) ** 2 + 2 * log_std + float(np.log(2 * np.pi)))
        logp = logp - torch.log(1.0 - act**2 + 1e-6) - float(np.log(self.action_scale))
        return act * self.action_scale, torch.sum(logp, dim=-1)

    def mean_action(self, obs):
        mean, _ = self.dist(obs)
        return torch.tanh(mean) * self.action_scale


class DeterministicPolicyModule(RLModule):
    """Deterministic continuous policy mu(s) = tanh(mlp(s)) * scale (the
    TD3/DDPG actor).  Exploration noise is the runner's job."""

    def __init__(self, obs_dim: int, action_dim: int, action_scale: float = 1.0,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.action_scale = float(action_scale)
        self.hidden = tuple(hidden)
        self.mu = MLP((obs_dim, *self.hidden, action_dim))

    def param_tree(self):
        return {"mu": self.mu.tree()}

    def mean_action(self, obs):
        return torch.tanh(self.mu(obs)) * self.action_scale


class TwinQModule(RLModule):
    """Two independent Q(s, a) critics over concatenated obs+action
    (clipped double-Q)."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.hidden = tuple(hidden)
        sizes = (obs_dim + action_dim, *self.hidden, 1)
        self.q1, self.q2 = MLP(sizes), MLP(sizes)

    def param_tree(self):
        return {"q1": self.q1.tree(), "q2": self.q2.tree()}

    def q(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.q1(x)[..., 0], self.q2(x)[..., 0]


def softmax_sample(rng, logits: np.ndarray):
    """Numpy-side categorical sampling from a batch of logits.
    Returns (actions int32 [B], logp float32 [B]).  Shared by every env
    runner so the sampling numerics live in exactly one place."""
    z = logits - logits.max(-1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(-1, keepdims=True)
    actions = np.array([rng.choice(p.shape[-1], p=row) for row in p], np.int32)
    logp = np.log(p[np.arange(len(actions)), actions] + 1e-9).astype(np.float32)
    return actions, logp
