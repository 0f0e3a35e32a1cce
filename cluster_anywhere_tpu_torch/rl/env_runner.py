"""EnvRunner actor: samples rollouts with the current weights (analogue of
the reference's rllib/env/single_agent_env_runner.py on the actor runtime).

The policy runs on the CPU with torch: a runner is a CPU-pool actor, which
sees no GPU, and a 64-wide MLP over a few envs gains nothing from a card.
Weights arrive as the learner's tree (tensors from any device, or numpy)
and are copied into the runner's module.  Actions come from the same numpy
generator as the JAX package's runner, so equal logits give equal actions;
the SAC runner's noise comes from a torch generator seeded seed + 2.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class EnvRunner:
    def __init__(
        self,
        env_spec,
        module_spec: Dict[str, Any],
        num_envs: int = 4,
        seed: int = 0,
        explore: str = "sample",  # sample | epsilon
        env_to_module=None,  # connector factory: obs pipeline (rllib connectors)
        module_to_env=None,  # connector factory: action pipeline
    ):
        import torch

        from .connectors import ConnectorPipeline
        from .env import VectorEnv
        from .module import DiscretePolicyModule, QModule

        # no torch.set_num_threads here: the compiled DAG calls sync_sample
        # on a thread of its own, and after set_num_threads(1) on one thread
        # torch's small CPU ops crawled on another (torch 2.13, CPU), which
        # made a DAG iteration take seconds instead of a fraction of one
        self.torch = torch

        def _mk(factory) -> Optional[ConnectorPipeline]:
            """Accepts: None | pipeline | Connector | list of connectors |
            zero-arg FACTORY returning any of those.  A bare function is
            treated as a factory — wrap batch transforms in rl.Lambda."""
            from .connectors import Connector

            if factory is None:
                return None
            if isinstance(factory, (ConnectorPipeline, Connector, list, tuple)):
                made = factory
            elif callable(factory):
                made = factory()
            else:
                made = factory
            if isinstance(made, ConnectorPipeline):
                return made
            return ConnectorPipeline(made if isinstance(made, (list, tuple)) else [made])

        # env->module obs pipeline runs before EVERY policy forward (sample,
        # bootstrap, evaluate) and rollouts store the TRANSFORMED obs, so
        # training sees exactly what the policy saw
        self.obs_pipe = _mk(env_to_module)
        self.act_pipe = _mk(module_to_env)

        self.env_spec = env_spec
        self.vec = VectorEnv(env_spec, num_envs, seed)
        kind = module_spec.get("kind", "policy")
        if kind == "recurrent":
            from .module import RecurrentPolicyModule

            self.module = RecurrentPolicyModule(
                module_spec["obs_dim"], module_spec["num_actions"],
                module_spec.get("lstm_hidden", 64),
            )
            self.state = self.module.initial_state(num_envs)
        elif kind == "policy":
            self.module = DiscretePolicyModule(
                module_spec["obs_dim"], module_spec["num_actions"],
                module_spec.get("hidden", (64, 64)),
            )
        elif kind == "gaussian":
            from .module import SquashedGaussianModule

            self.module = SquashedGaussianModule(
                module_spec["obs_dim"], module_spec["action_dim"],
                module_spec.get("action_scale", 1.0),
                module_spec.get("hidden", (64, 64)),
            )
            self._sample_gen = torch.Generator().manual_seed(seed + 2)
        elif kind == "deterministic":
            from .module import DeterministicPolicyModule

            self.module = DeterministicPolicyModule(
                module_spec["obs_dim"], module_spec["action_dim"],
                module_spec.get("action_scale", 1.0),
                module_spec.get("hidden", (64, 64)),
            )
            self.explore_noise = float(module_spec.get("explore_noise", 0.1))
        else:
            self.module = QModule(
                module_spec["obs_dim"], module_spec["num_actions"],
                module_spec.get("hidden", (64, 64)),
            )
        self.kind = kind
        self.module.init(seed).requires_grad_(False)
        self.rng = np.random.default_rng(seed + 1)
        self.explore = explore
        self.epsilon = 1.0

    def set_weights(self, params, epsilon: Optional[float] = None, connector_state=None):
        from .module import load_tree

        load_tree(self.module.param_tree(), params)
        if epsilon is not None:
            self.epsilon = epsilon
        if connector_state is not None:
            if self.obs_pipe is not None:
                self.obs_pipe.set_state(connector_state.get("obs"))
            if self.act_pipe is not None:
                self.act_pipe.set_state(connector_state.get("act"))
        return "ok"

    def connector_state(self):
        """Both pipelines' state (stateful action connectors checkpoint
        too); None when nothing is stateful."""
        state = {}
        if self.obs_pipe is not None:
            s = self.obs_pipe.get_state()
            if s is not None:
                state["obs"] = s
        if self.act_pipe is not None:
            s = self.act_pipe.get_state()
            if s is not None:
                state["act"] = s
        return state or None

    def _obs_t(self, obs):
        return self.obs_pipe(obs) if self.obs_pipe is not None else obs

    def _obs_t_frozen(self, obs):
        """Transform WITHOUT updating stateful connector stats — for rollout
        boundaries (bootstrap value, next_obs), whose observations are
        transformed again (with updates) as the first obs of the next
        sample(); updating here would double-count them."""
        if self.obs_pipe is None:
            return obs
        saved = [
            (c, c.update) for c in self.obs_pipe.connectors if hasattr(c, "update")
        ]
        for c, _ in saved:
            c.update = False
        try:
            return self.obs_pipe(obs)
        finally:
            for c, flag in saved:
                c.update = flag

    def _act_t(self, actions):
        return self.act_pipe(actions) if self.act_pipe is not None else actions

    def _t(self, x):
        """An observation batch as a float32 tensor (the JAX package's
        jnp.asarray without x64)."""
        return self.torch.from_numpy(np.ascontiguousarray(x, np.float32))

    def sync_sample(self, params, num_steps: int) -> Dict[str, np.ndarray]:
        """Fused set_weights + sample for the compiled-DAG experience edge:
        weights arrive through the DAG's input channel (one shm write,
        broadcast to every runner) and the rollout leaves over this node's
        tensor-transport output channel — no per-iteration RPCs."""
        self.set_weights(params)
        return self.sample(num_steps)

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect num_steps per env. Returns flat [T*N, ...] arrays plus
        bootstrap values and episode metrics."""
        with self.torch.no_grad():
            if self.kind == "recurrent":
                return self._sample_recurrent(num_steps)
            return self._sample(num_steps)

    def _sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        obs_l, act_l, rew_l, done_l, logp_l, val_l = [], [], [], [], [], []
        for _ in range(num_steps):
            obs = self._obs_t(self.vec.obs)
            if self.kind == "gaussian":
                eps = self.torch.randn((len(obs), self.module.action_dim),
                                       generator=self._sample_gen)
                act, _ = self.module.sample(self._t(obs), eps)
                actions = act.numpy().astype(np.float32)
                logp = np.zeros(len(actions), np.float32)
                values = np.zeros(len(actions), np.float32)
            elif self.kind == "deterministic":
                # TD3 exploration: Gaussian noise on the deterministic
                # action, clipped into the action box
                mu = self.module.mean_action(self._t(obs)).numpy()
                scale = self.module.action_scale
                noise = self.rng.normal(0.0, self.explore_noise * scale, mu.shape)
                actions = np.clip(mu + noise, -scale, scale).astype(np.float32)
                logp = np.zeros(len(actions), np.float32)
                values = np.zeros(len(actions), np.float32)
            elif self.kind == "policy":
                from .module import softmax_sample

                out = self.module.logits(self._t(obs)).numpy()
                if self.explore == "sample":
                    actions, logp = softmax_sample(self.rng, out)
                else:
                    actions = out.argmax(-1).astype(np.int32)
                    z = out - out.max(-1, keepdims=True)
                    p = np.exp(z)
                    p /= p.sum(-1, keepdims=True)
                    logp = np.log(p[np.arange(len(actions)), actions] + 1e-9)
                values = self.module.value(self._t(obs)).numpy()
            else:  # epsilon-greedy over q-values
                out = self.module.q_values(self._t(obs)).numpy()
                greedy = out.argmax(-1)
                rand = self.rng.integers(0, out.shape[-1], size=len(greedy))
                mask = self.rng.random(len(greedy)) < self.epsilon
                actions = np.where(mask, rand, greedy).astype(np.int32)
                logp = np.zeros(len(actions), np.float32)
                values = np.zeros(len(actions), np.float32)
            next_obs, rewards, dones = self.vec.step(self._act_t(actions))
            obs_l.append(obs)
            act_l.append(actions)
            rew_l.append(rewards)
            done_l.append(dones)
            logp_l.append(logp)
            val_l.append(values)
        # bootstrap value of the final obs (PPO/GAE); transformed ONCE with
        # frozen stats and reused for next_obs so the stored pair agrees
        tail_obs = self._obs_t_frozen(self.vec.obs)
        if self.kind == "policy":
            last_values = self.module.value(self._t(tail_obs)).numpy()
        else:
            last_values = np.zeros(self.vec.num_envs, np.float32)
        return {
            "obs": np.stack(obs_l),            # [T, N, D]
            "actions": np.stack(act_l),        # [T, N]
            "rewards": np.stack(rew_l),        # [T, N]
            "dones": np.stack(done_l),         # [T, N]
            "logp": np.stack(logp_l),          # [T, N]
            "values": np.stack(val_l),         # [T, N]
            "last_values": last_values,        # [N]
            "next_obs": np.asarray(tail_obs).copy(),  # [N, D] (transformed like obs)
            "metrics": self.vec.drain_metrics(),
        }

    def _sample_recurrent(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Recurrent rollout: hidden state carried across sample() calls and
        zeroed per env at episode ends; the state at rollout start ships
        with the batch so the learner unrolls from the same point."""
        from .module import softmax_sample

        state0 = self.state.copy()
        obs_l, act_l, rew_l, done_l, logp_l, val_l = [], [], [], [], [], []
        for _ in range(num_steps):
            obs = self._obs_t(self.vec.obs)
            logits, values, new_state = self.module.step(self._t(obs), self._t(self.state))
            actions, logp = softmax_sample(self.rng, logits.numpy())
            next_obs, rewards, dones = self.vec.step(self._act_t(actions))
            self.state = new_state.numpy().copy()
            self.state[dones.astype(bool)] = 0.0
            obs_l.append(obs)
            act_l.append(actions)
            rew_l.append(rewards)
            done_l.append(dones)
            logp_l.append(logp)
            val_l.append(values.numpy())
        tail_obs = self._obs_t_frozen(self.vec.obs)
        _, last_values, _ = self.module.step(self._t(tail_obs), self._t(self.state))
        return {
            "obs": np.stack(obs_l),
            "actions": np.stack(act_l),
            "rewards": np.stack(rew_l),
            "dones": np.stack(done_l),
            "logp": np.stack(logp_l),
            "values": np.stack(val_l),
            "last_values": last_values.numpy(),
            "next_obs": np.asarray(tail_obs).copy(),
            "state0": state0,
            "metrics": self.vec.drain_metrics(),
        }

    def evaluate(self, num_episodes: int = 5) -> float:
        """Greedy episode returns on a fresh env (recurrent policies thread
        their hidden state through the episode)."""
        from .env import make_env

        env = make_env(self.env_spec)
        # freeze stateful obs connectors during eval, restoring each
        # connector's PRIOR flag after (a user-frozen normalizer must not
        # be silently re-enabled by an evaluate() call)
        saved_flags = []
        if self.obs_pipe is not None:
            for c in self.obs_pipe.connectors:
                if hasattr(c, "update"):
                    saved_flags.append((c, c.update))
                    c.update = False
        try:
            with self.torch.no_grad():
                total = 0.0
                for ep in range(num_episodes):
                    obs = env.reset(seed=1000 + ep)
                    done, ret = False, 0.0
                    if self.kind == "recurrent":
                        state = self.module.initial_state(1)
                    while not done:
                        tobs = self._t(self._obs_t(obs[None]))
                        if self.kind in ("gaussian", "deterministic"):
                            a = self.module.mean_action(tobs).numpy()[0]
                            act = self._act_t(a[None])[0]
                        elif self.kind == "recurrent":
                            logits, _, state_t = self.module.step(tobs, self._t(state))
                            state = state_t.numpy()
                            # action connector applies in eval exactly as in
                            # sampling — same policy, same executed actions
                            act = int(self._act_t(logits.numpy().argmax(-1))[0])
                        elif self.kind == "policy":
                            act = int(self._act_t(self.module.logits(tobs).numpy().argmax(-1))[0])
                        else:
                            act = int(self._act_t(self.module.q_values(tobs).numpy().argmax(-1))[0])
                        obs, r, done, _ = env.step(act)
                        ret += r
                    total += ret
                return total / num_episodes
        finally:
            for c, flag in saved_flags:
                c.update = flag
