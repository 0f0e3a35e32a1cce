"""DreamerV3 (compact): model-based RL via a recurrent state-space world
model and an actor-critic trained purely in imagination (the JAX package's
rl/dreamer.py, on torch; reference parity: ``rllib/algorithms/dreamerv3``).

- **RSSM**: deterministic GRU path + categorical stochastic latents
  (groups x classes, straight-through gradients, 1% unimix), prior from
  h_t, posterior from [h_t, enc(o_t)].
- **Heads**: decoder (symlog MSE), reward (twohot over symlog bins),
  continue (Bernoulli).
- **World-model loss**: prediction terms + KL balancing (dyn/rep scales
  with free bits).
- **Imagination actor-critic**: H-step latent rollouts from posterior
  starts; lambda-returns; critic twohot regression with an EMA target
  network; actor REINFORCE with returns normalized by an EMA of the
  5th-95th percentile range + entropy bonus.

The world model and the actor-critic each take one Adam step a batch,
after optax's global-norm clip at 100 (written out: optax scales by
max_norm / norm above the bound, where clip_grad_norm_ adds 1e-6).  Every
categorical draw is Gumbel-argmax (jax.random.categorical's), over draws
passed in or taken from a generator on the learner's device seeded
seed + 1; the scans over the sequence and the horizon are loops.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .learner import _frozen, _tensor, adam, to_device
from .module import MLP, RLModule

CLIP_NORM = 100.0  # optax.clip_by_global_norm's bound in the JAX package

# ------------------------------------------------------------------ symlog


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def one_hot(idx, n: int):
    """jax.nn.one_hot: float32, by comparison (F.one_hot syncs with the
    host to check its range)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def twohot(x, bins):
    """Two-hot encode scalar x over a 1-D bin grid (piecewise-linear)."""
    x = torch.clamp(x, bins[0], bins[-1])
    idx = torch.sum((bins <= x[..., None]).to(torch.int64), dim=-1) - 1
    idx = torch.clamp(idx, 0, len(bins) - 2)
    lo, hi = bins[idx], bins[idx + 1]
    w_hi = (x - lo) / torch.clamp(hi - lo, min=1e-8)
    n = len(bins)
    return one_hot(idx, n) * (1 - w_hi)[..., None] + one_hot(idx + 1, n) * w_hi[..., None]


def sigmoid_ce(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, as jax.random.gumbel makes them from a
    uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


class DreamerConfig(NamedTuple):
    obs_dim: int = 4
    num_actions: int = 2
    hidden: int = 128
    deter: int = 128
    groups: int = 8
    classes: int = 8
    num_bins: int = 41
    horizon: int = 10
    seq_len: int = 16
    batch_size: int = 16
    wm_lr: float = 3e-4
    ac_lr: float = 1e-4
    gamma: float = 0.985
    lam: float = 0.95
    entropy: float = 3e-3
    kl_dyn: float = 0.5
    kl_rep: float = 0.1
    free_bits: float = 1.0
    unimix: float = 0.01
    critic_ema: float = 0.02
    retnorm_decay: float = 0.99


def _silu_mlp(sizes, act_last=False):
    return MLP(sizes, act=F.silu, act_last=act_last)


class _GRU(nn.Module):
    """The RSSM's GRU: r, z and n split out of one product over x and one
    over h, and n = tanh(r * n) (not module.py's cell, not torch.nn.GRU)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.wi = nn.Parameter(torch.zeros(in_dim, 3 * hidden))
        self.wh = nn.Parameter(torch.zeros(hidden, 3 * hidden))
        self.b = nn.Parameter(torch.zeros(3 * hidden))
        self.scale = (2.0 / (in_dim + hidden)) ** 0.5

    def reset(self, gen: torch.Generator) -> None:
        self.wi.copy_(torch.randn(self.wi.shape, generator=gen) * self.scale)
        self.wh.copy_(torch.randn(self.wh.shape, generator=gen) * self.scale)
        self.b.zero_()

    def forward(self, h, x):
        r, z, n = torch.chunk(x @ self.wi + h @ self.wh + self.b, 3, dim=-1)
        r, z = torch.sigmoid(r), torch.sigmoid(z)
        n = torch.tanh(r * n)
        return (1 - z) * n + z * h

    def tree(self):
        return {"wi": self.wi, "wh": self.wh, "b": self.b}


class WorldModel(RLModule):
    """The RSSM and its heads; param_tree() is the JAX learner's `params`."""

    def __init__(self, cfg: DreamerConfig):
        super().__init__()
        stoch = cfg.groups * cfg.classes
        feat = cfg.deter + stoch
        self.enc = _silu_mlp([cfg.obs_dim, cfg.hidden, cfg.hidden], act_last=True)
        self.gru = _GRU(stoch + cfg.num_actions, cfg.deter)
        self.prior = _silu_mlp([cfg.deter, cfg.hidden, stoch])
        self.post = _silu_mlp([cfg.deter + cfg.hidden, cfg.hidden, stoch])
        self.dec = _silu_mlp([feat, cfg.hidden, cfg.obs_dim])
        self.rew = _silu_mlp([feat, cfg.hidden, cfg.num_bins])
        self.cont = _silu_mlp([feat, cfg.hidden, 1])

    def param_tree(self):
        return {"enc": self.enc.tree(), "gru": self.gru.tree(), "prior": self.prior.tree(),
                "post": self.post.tree(), "dec": self.dec.tree(), "rew": self.rew.tree(),
                "cont": self.cont.tree()}


class ActorCritic(RLModule):
    """param_tree() is the JAX learner's `ac_params`."""

    def __init__(self, cfg: DreamerConfig):
        super().__init__()
        feat = cfg.deter + cfg.groups * cfg.classes
        self.actor = _silu_mlp([feat, cfg.hidden, cfg.num_actions])
        self.critic = _silu_mlp([feat, cfg.hidden, cfg.num_bins])

    def param_tree(self):
        return {"actor": self.actor.tree(), "critic": self.critic.tree()}


def _clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the gradients, in place: above the bound
    each becomes g / norm * max_norm."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def _step(opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """optax.chain(clip_by_global_norm(100), adam(lr)): one step."""
    params = [p for group in opt.param_groups for p in group["params"]]
    opt.zero_grad(set_to_none=True)
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _clip_by_global_norm(params, CLIP_NORM)
    opt.step()


class DreamerV3Learner:
    """World model + imagination actor-critic on the learner's device
    (`device=None`: the card; raises without one)."""

    def __init__(self, cfg: DreamerConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.wm = WorldModel(cfg).init(seed).to(self.device)
        self.ac = ActorCritic(cfg).init(seed + 1).to(self.device)
        self.target_critic = _frozen(self.ac.critic)
        self.bins = torch.linspace(-10.0, 10.0, cfg.num_bins, device=self.device)  # symlog space
        self.wm_opt = adam(self.wm.parameters(), cfg.wm_lr)
        self.ac_opt = adam(self.ac.parameters(), cfg.ac_lr)
        self.ret_range = torch.tensor(1.0, device=self.device)  # EMA of return 5-95 percentile
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)

    # ------------------------------------------------------------ primitives

    def _gumbel(self, shape, gen=None):
        return gumbel(shape, self.gen if gen is None else gen, self.device)

    def _sample_latent(self, logits, g):
        """Straight-through categorical sample per group with unimix, over
        Gumbel draws g [..., groups, classes]."""
        cfg = self.cfg
        logits = logits.reshape(*logits.shape[:-1], cfg.groups, cfg.classes)
        probs = torch.softmax(logits, dim=-1)
        probs = (1 - cfg.unimix) * probs + cfg.unimix / cfg.classes
        logp = torch.log(probs)
        onehot = one_hot(torch.argmax(logp + g, dim=-1), cfg.classes)
        sample = onehot + probs - probs.detach()  # straight-through
        return sample.reshape(*sample.shape[:-2], -1), logp

    def _head_scalar(self, logits):
        """Expected value of a twohot head, decoded from symlog space."""
        return symexp(torch.sum(torch.softmax(logits, dim=-1) * self.bins, dim=-1))

    def _twohot_nll(self, logits, target_scalar):
        target = twohot(symlog(target_scalar), self.bins)
        return -torch.sum(target * F.log_softmax(logits, dim=-1), dim=-1)

    def _obs_step(self, h, z_prev, a_prev_onehot, obs, g):
        """One posterior RSSM step."""
        wm = self.wm
        h = wm.gru(h, torch.cat([z_prev, a_prev_onehot], dim=-1))
        e = wm.enc(obs)
        post_logits = wm.post(torch.cat([h, e], dim=-1))
        prior_logits = wm.prior(h)
        z, _ = self._sample_latent(post_logits, g)
        return h, z, post_logits, prior_logits

    # ---------------------------------------------------------------- losses

    def wm_loss(self, batch, g):
        """batch: obs [B,L,O], actions [B,L] int, rewards [B,L], cont [B,L]
        (1 - done), is_first [B,L]; g: Gumbel draws [L, B, groups,
        classes] for the posterior samples."""
        cfg = self.cfg
        B, L = batch["actions"].shape
        a_onehot = one_hot(batch["actions"], cfg.num_actions)
        is_first = batch["is_first"]
        h = torch.zeros(B, cfg.deter, device=self.device)
        z = torch.zeros(B, cfg.groups * cfg.classes, device=self.device)
        hs, zs, posts, priors = [], [], [], []
        for t in range(L):
            # episode boundary inside the segment: reset the recurrent
            # state and the previous action (stream replay)
            keep = (1.0 - is_first[:, t])[:, None]
            h = h * keep
            z = z * keep
            a_prev = (torch.zeros_like(a_onehot[:, 0]) if t == 0 else a_onehot[:, t - 1]) * keep
            h, z, post_l, prior_l = self._obs_step(h, z, a_prev, batch["obs"][:, t], g[t])
            hs.append(h)
            zs.append(z)
            posts.append(post_l)
            priors.append(prior_l)
        hs, zs = torch.stack(hs, dim=1), torch.stack(zs, dim=1)  # [B, L, ...]
        post_l, prior_l = torch.stack(posts, dim=1), torch.stack(priors, dim=1)
        feat = torch.cat([hs, zs], dim=-1)
        wm = self.wm
        loss_obs = torch.mean(torch.sum((wm.dec(feat) - symlog(batch["obs"])) ** 2, dim=-1))
        loss_rew = torch.mean(self._twohot_nll(wm.rew(feat), batch["rewards"]))
        loss_cont = torch.mean(sigmoid_ce(wm.cont(feat)[..., 0], batch["cont"]))

        def cat_kl(lp, lq):
            """KL(p || q) per group, summed over groups; unimix'd."""
            shape = (*lp.shape[:-1], cfg.groups, cfg.classes)
            p = (1 - cfg.unimix) * torch.softmax(lp.reshape(shape), -1) + cfg.unimix / cfg.classes
            q = (1 - cfg.unimix) * torch.softmax(lq.reshape(shape), -1) + cfg.unimix / cfg.classes
            return torch.sum(p * (torch.log(p) - torch.log(q)), dim=(-2, -1))

        free = torch.tensor(cfg.free_bits, device=self.device)
        kl_dyn = torch.maximum(torch.mean(cat_kl(post_l.detach(), prior_l)), free)
        kl_rep = torch.maximum(torch.mean(cat_kl(post_l, prior_l.detach())), free)
        loss = loss_obs + loss_rew + loss_cont + cfg.kl_dyn * kl_dyn + cfg.kl_rep * kl_rep
        aux = {"wm_loss": loss, "obs_loss": loss_obs, "rew_loss": loss_rew, "kl_dyn": kl_dyn,
               "feat": feat}
        return loss, aux

    def imagine(self, feat0, g_act, g_lat):
        """Roll the actor H steps through the prior dynamics: [H, N, F]
        features and [H, N] actions, no gradient (every use is stopped).
        g_act [H, N, A] and g_lat [H, N, groups, classes]: Gumbel draws."""
        cfg = self.cfg
        h, z = feat0[:, : cfg.deter], feat0[:, cfg.deter:]
        feats, acts = [], []
        with torch.no_grad():
            for t in range(cfg.horizon):
                a = torch.argmax(self.ac.actor(torch.cat([h, z], dim=-1)) + g_act[t], dim=-1)
                h = self.wm.gru(h, torch.cat([z, one_hot(a, cfg.num_actions)], dim=-1))
                z, _ = self._sample_latent(self.wm.prior(h), g_lat[t])
                feats.append(torch.cat([h, z], dim=-1))
                acts.append(a)
        return torch.stack(feats), torch.stack(acts)

    def ac_loss(self, feat0, g_act, g_lat):
        cfg = self.cfg
        feats_post, acts = self.imagine(feat0, g_act, g_lat)
        # state indexing: feat0 = s_0 (where a_0 is chosen); feats_post[t] =
        # s_{t+1} (reached by a_t).  Rewards/continues belong to the
        # arrived-at states s_1..s_H; action log-probs and advantages to the
        # pre-action states s_0..s_{H-1}.
        feats_pre = torch.cat([feat0[None], feats_post[:-1]], dim=0).detach()
        with torch.no_grad():
            rew = self._head_scalar(self.wm.rew(feats_post))
            disc = cfg.gamma * torch.sigmoid(self.wm.cont(feats_post)[..., 0])
            v_post = self._head_scalar(self.target_critic(feats_post))
            # lambda-returns at s_0..s_{H-1}:
            #   R_t = r_{t+1} + gamma c_{t+1} ((1-lam) V(s_{t+1}) + lam R_{t+1})
            rets = [None] * cfg.horizon
            nxt = v_post[-1]
            for t in range(cfg.horizon - 1, -1, -1):
                nxt = rew[t] + disc[t] * ((1 - cfg.lam) * v_post[t] + cfg.lam * nxt)
                rets[t] = nxt
            rets = torch.stack(rets)  # [H, N]: rets[t] = R at s_t
            # percentile return scale (EMA outside); jnp.percentile's and
            # torch.quantile's interpolation are both linear
            flat = rets.reshape(-1)
            new_range = torch.clamp(torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05),
                                    min=1.0)
        critic_logits = self.ac.critic(feats_pre)
        critic_loss = torch.mean(self._twohot_nll(critic_logits, rets))
        logp = F.log_softmax(self.ac.actor(feats_pre), dim=-1)
        act_logp = logp.gather(-1, acts[..., None])[..., 0]
        v_pre = self._head_scalar(critic_logits)
        adv = ((rets - v_pre) / torch.clamp(self.ret_range, min=1.0)).detach()
        entropy = -torch.sum(torch.exp(logp) * logp, dim=-1)
        # weight[t] = probability the imagined trajectory is still alive at
        # s_t (products of continues up to s_t); s_0 is alive
        weight = torch.cumprod(torch.cat([torch.ones_like(disc[:1]), disc[:-1]], dim=0), dim=0)
        actor_loss = -torch.mean(weight * (act_logp * adv + cfg.entropy * entropy))
        total = actor_loss + critic_loss
        return total, (new_range, torch.mean(rets), torch.mean(entropy.detach()))

    # ------------------------------------------------------------------- api

    def noise(self, batch_size: int, gen: Optional[torch.Generator] = None):
        """The Gumbel draws of one update on batch_size sequences."""
        cfg = self.cfg
        n = batch_size * cfg.seq_len
        return {"wm": self._gumbel((cfg.seq_len, batch_size, cfg.groups, cfg.classes), gen),
                "act": self._gumbel((cfg.horizon, n, cfg.num_actions), gen),
                "lat": self._gumbel((cfg.horizon, n, cfg.groups, cfg.classes), gen)}

    def init_state(self, batch: int = 1):
        cfg = self.cfg
        return (
            torch.zeros(batch, cfg.deter, device=self.device),
            torch.zeros(batch, cfg.groups * cfg.classes, device=self.device),
            torch.zeros(batch, cfg.num_actions, device=self.device),
        )

    def act(self, state, obs, greedy=False, noise=None, gen=None):
        """One env step: (new state, action).  noise: Gumbel draws
        (latent [1, groups, classes], action [1, A]), else drawn from gen
        or the learner's generator."""
        cfg = self.cfg
        h, z, a_prev = state
        if noise is None:
            noise = (self._gumbel((1, cfg.groups, cfg.classes), gen),
                     self._gumbel((1, cfg.num_actions), gen))
        g_lat, g_act = (_tensor(g, self.device, torch.float32) for g in noise)
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)[None]
        with torch.no_grad():
            h, z, _, _ = self._obs_step(h, z, a_prev, obs, g_lat)
            logits = self.ac.actor(torch.cat([h, z], dim=-1))
            a = torch.argmax(logits if greedy else logits + g_act, dim=-1)
        return (h, z, one_hot(a, cfg.num_actions)), int(a[0])

    def wm_update(self, batch: Dict[str, torch.Tensor], g) -> Dict[str, torch.Tensor]:
        """One world-model step: its stats, and the posterior features
        [B*L, F] the actor-critic starts from."""
        cfg = self.cfg
        loss, aux = self.wm_loss(batch, g)
        _step(self.wm_opt, loss)
        aux["feat"] = aux["feat"].detach().reshape(-1, cfg.deter + cfg.groups * cfg.classes)
        return aux

    def ac_update(self, feat, g_act, g_lat) -> Dict[str, torch.Tensor]:
        """One actor-critic step in imagination from feat, then the target
        critic's EMA and the return range's."""
        cfg = self.cfg
        loss, (new_range, ret_mean, ent) = self.ac_loss(feat, g_act, g_lat)
        _step(self.ac_opt, loss)
        with torch.no_grad():
            for t, o in zip(self.target_critic.parameters(), self.ac.critic.parameters()):
                t.copy_((1 - cfg.critic_ema) * t + cfg.critic_ema * o)
            self.ret_range = (cfg.retnorm_decay * self.ret_range
                              + (1 - cfg.retnorm_decay) * new_range)
        return {"ac_loss": loss, "ret_mean": ret_mean, "entropy": ent}

    def update(self, batch: Dict[str, np.ndarray], noise=None) -> Dict[str, float]:
        """One world-model and one actor-critic step on a replay batch;
        noise: {"wm", "act", "lat"} Gumbel draws (self.noise's shapes),
        drawn here when None."""
        keys = ("obs", "actions", "rewards", "cont", "is_first")
        tb = to_device({k: batch[k] for k in keys}, self.device)
        if noise is None:
            noise = self.noise(len(batch["actions"]))
        g = {k: _tensor(v, self.device, torch.float32) for k, v in noise.items()}
        aux = self.wm_update(tb, g["wm"])
        out = self.ac_update(aux.pop("feat"), g["act"], g["lat"])
        return {k: v.item() for k, v in {**aux, **out}.items()}


class _SeqReplay:
    """Stream replay: episodes concatenate into one step stream with
    is_first flags; any L-window is sampleable (segments span episode
    boundaries, which wm_loss handles by resetting the RSSM state).  A
    per-episode sampler silently excludes episodes shorter than L — a
    degrading policy then stops contributing data at all, making collapse
    an absorbing state (observed)."""

    def __init__(self, seq_len: int, capacity: int = 200_000, seed: int = 0):
        self.seq_len = seq_len
        self.capacity = capacity
        self.rng = np.random.default_rng(seed)
        self.obs: list = []
        self.actions: list = []
        self.rewards: list = []
        self.cont: list = []
        self.is_first: list = []

    def add_episode(self, obs, actions, rewards, dones):
        n = len(actions)
        self.obs.extend(np.asarray(o, np.float32) for o in obs)
        self.actions.extend(int(a) for a in actions)
        self.rewards.extend(float(r) for r in rewards)
        self.cont.extend(1.0 - float(d) for d in dones)
        self.is_first.extend([1.0] + [0.0] * (n - 1))
        if len(self.actions) > self.capacity:
            cut = len(self.actions) - self.capacity
            for lst in (self.obs, self.actions, self.rewards, self.cont,
                        self.is_first):
                del lst[:cut]
            if self.is_first:
                self.is_first[0] = 1.0  # truncated head starts a segment

    @property
    def num_steps(self):
        return len(self.actions)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        L = self.seq_len
        if len(self.actions) < L:
            raise ValueError("replay shorter than one segment")
        out = {"obs": [], "actions": [], "rewards": [], "cont": [],
               "is_first": []}
        for _ in range(batch_size):
            start = int(self.rng.integers(0, len(self.actions) - L + 1))
            sl = slice(start, start + L)
            out["obs"].append(np.stack(self.obs[sl]))
            out["actions"].append(np.asarray(self.actions[sl], np.int32))
            out["rewards"].append(np.asarray(self.rewards[sl], np.float32))
            out["cont"].append(np.asarray(self.cont[sl], np.float32))
            first = np.asarray(self.is_first[sl], np.float32)
            first[0] = 1.0  # a window head is always a fresh RSSM start
            out["is_first"].append(first)
        return {k: np.stack(v) for k, v in out.items()}


def train_dreamer(
    env_maker,
    *,
    cfg: Optional[DreamerConfig] = None,
    episodes: int = 60,
    updates_per_episode: int = 20,
    seed: int = 0,
    warmup_episodes: int = 5,
    explore_eps: float = 0.1,
    device=None,
) -> DreamerV3Learner:
    """Online DreamerV3 loop: collect an episode with the current policy,
    then train the world model + imagination actor-critic from replay.

    explore_eps: epsilon-random actions during collection.  Imagination
    training is only as good as the model, and the model only knows the
    data — without a floor of exploration an early actor collapse makes the
    replay single-action and the collapse self-reinforcing."""
    env = env_maker()
    if cfg is None:
        cfg = DreamerConfig(
            obs_dim=env.observation_dim, num_actions=env.num_actions
        )
    learner = DreamerV3Learner(cfg, seed=seed, device=device)
    replay = _SeqReplay(cfg.seq_len, seed=seed)
    rng = np.random.default_rng(seed)
    returns = []

    def with_action(state, a):
        h, z, _ = state
        return (h, z, one_hot(torch.tensor([a], device=learner.device), cfg.num_actions))

    for ep in range(episodes):
        obs = env.reset(seed=int(rng.integers(2**31)))
        state = learner.init_state(1)
        ep_obs, ep_act, ep_rew = [], [], []
        done = False
        while not done:
            if ep < warmup_episodes:
                a = int(rng.integers(env.num_actions))
                # still advance the RSSM state so a_prev stays consistent
                state, _ = learner.act(state, obs)
                state = with_action(state, a)
            else:
                state, a = learner.act(state, obs)
                if rng.random() < explore_eps:
                    a = int(rng.integers(env.num_actions))
                    state = with_action(state, a)
            nxt, r, done, _ = env.step(a)
            ep_obs.append(obs); ep_act.append(a); ep_rew.append(r)
            obs = nxt
        # canonical DreamerV3 row layout: one row per OBSERVED state incl.
        # the terminal one; reward is the reward received ON ARRIVAL at that
        # state, and cont marks the state itself non-terminal.  The
        # terminal row's action is a dummy — the next row is a new episode
        # whose is_first resets a_prev anyway.
        rows_obs = ep_obs + [obs]
        rows_act = ep_act + [0]
        rows_rew = [0.0] + list(ep_rew)
        rows_cont_inv = [0.0] * len(ep_obs) + [1.0]  # "done" per row
        replay.add_episode(rows_obs, rows_act, rows_rew, rows_cont_inv)
        returns.append(sum(ep_rew))
        if replay.num_steps >= cfg.batch_size * cfg.seq_len:
            for _ in range(updates_per_episode):
                learner.last_stats = learner.update(replay.sample(cfg.batch_size))
    learner.episode_returns = returns
    return learner


def evaluate_dreamer(learner: DreamerV3Learner, env_maker, episodes: int = 3,
                     seed: int = 123) -> float:
    env = env_maker()
    gen = torch.Generator(device=learner.device).manual_seed(seed)
    total = 0.0
    for ep in range(episodes):
        obs = env.reset(seed=seed + ep)
        state = learner.init_state(1)
        done = False
        while not done:
            state, a = learner.act(state, obs, greedy=True, gen=gen)
            obs, r, done, _ = env.step(a)
            total += r
    return total / episodes
