"""Multi-agent RL: dict-keyed envs, policy mapping, per-policy learners.

Reference parity: ``rllib/env/multi_agent_env.py`` (MultiAgentEnv API with
``__all__`` done signaling), ``rllib/policy/policy_map.py`` + the
``policy_mapping_fn`` config surface, and the multi-agent sampling/training
split inside rllib's Algorithm.  Compressed to the same shape as this
package's single-agent stack: env runners are plain actors (their
policies on the CPU), each policy owns one PPOLearner on the learners'
device, and a training step is sample -> group-by-policy -> per-policy GAE
+ update -> broadcast.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core import api as _ca
from ..core.actor import kill
from .learner import PPOLearner, compute_gae
from .module import DiscretePolicyModule


class MultiAgentEnv:
    """Dict-keyed environment: every method speaks {agent_id: value}.

    ``step`` returns (obs, rewards, dones, infos); ``dones["__all__"]``
    terminates the episode (multi_agent_env.py contract).  Agent sets are
    fixed per episode for this runtime (no mid-episode joins)."""

    agent_ids: Tuple[str, ...]
    observation_dim: int
    num_actions: int

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]):
        raise NotImplementedError


class CoordinationGame(MultiAgentEnv):
    """Repeated 2-player coordination: both pick the same arm -> +1 each.

    Observations encode the opponent's previous action, so coordinated
    equilibria are learnable by independent PPO (the standard smoke test for
    a multi-agent training loop)."""

    agent_ids = ("a0", "a1")
    observation_dim = 3  # one-hot of opponent's last action + "first step" bit
    num_actions = 2
    episode_len = 16

    def __init__(self):
        self.t = 0
        self.last = {aid: -1 for aid in self.agent_ids}

    def _obs(self) -> Dict[str, np.ndarray]:
        out = {}
        for aid in self.agent_ids:
            other = self.agent_ids[1] if aid == self.agent_ids[0] else self.agent_ids[0]
            o = np.zeros(3, np.float32)
            if self.last[other] < 0:
                o[2] = 1.0
            else:
                o[self.last[other]] = 1.0
            out[aid] = o
        return out

    def reset(self, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        self.t = 0
        self.last = {aid: -1 for aid in self.agent_ids}
        return self._obs()

    def step(self, actions: Dict[str, int]):
        self.t += 1
        self.last = dict(actions)
        r = 1.0 if actions["a0"] == actions["a1"] else 0.0
        rewards = {aid: r for aid in self.agent_ids}
        done = self.t >= self.episode_len
        dones = {aid: done for aid in self.agent_ids}
        dones["__all__"] = done
        return self._obs(), rewards, dones, {}


class RockPaperScissors(MultiAgentEnv):
    """Zero-sum repeated RPS; the classic rllib multi-agent example env."""

    agent_ids = ("player1", "player2")
    observation_dim = 4  # one-hot of opponent's last throw + first-step bit
    num_actions = 3
    episode_len = 10

    _BEATS = {0: 2, 1: 0, 2: 1}  # rock>scissors, paper>rock, scissors>paper

    def __init__(self):
        self.t = 0
        self.last = {aid: -1 for aid in self.agent_ids}

    def _obs(self):
        p1, p2 = self.agent_ids
        out = {}
        for aid, other in ((p1, p2), (p2, p1)):
            o = np.zeros(4, np.float32)
            if self.last[other] < 0:
                o[3] = 1.0
            else:
                o[self.last[other]] = 1.0
            out[aid] = o
        return out

    def reset(self, seed: Optional[int] = None):
        self.t = 0
        self.last = {aid: -1 for aid in self.agent_ids}
        return self._obs()

    def step(self, actions):
        self.t += 1
        self.last = dict(actions)
        a1, a2 = actions["player1"], actions["player2"]
        if a1 == a2:
            r1 = 0.0
        elif self._BEATS[a1] == a2:
            r1 = 1.0
        else:
            r1 = -1.0
        rewards = {"player1": r1, "player2": -r1}
        done = self.t >= self.episode_len
        dones = {aid: done for aid in self.agent_ids}
        dones["__all__"] = done
        return self._obs(), rewards, dones, {}


class MultiAgentEnvRunner:
    """Actor: samples one multi-agent env with per-policy networks, returning
    per-policy [T, ...] rollout arrays (single_agent_env_runner.py's
    multi-agent sibling, flattened for the learners)."""

    def __init__(self, env_creator, policy_specs: Dict[str, dict],
                 policy_mapping: Dict[str, str], seed: int = 0):
        self.env = env_creator()
        self.mapping = policy_mapping
        self.modules = {
            pid: DiscretePolicyModule(
                spec["obs_dim"], spec["num_actions"], spec.get("hidden", (64, 64))
            ).init(seed + i).requires_grad_(False)
            for i, (pid, spec) in enumerate(policy_specs.items())
        }
        self.rng = np.random.default_rng(seed + 17)
        self.obs = self.env.reset(seed=seed)

    def set_weights(self, params: Dict[str, Any], _eps=None):
        from .module import load_tree

        for pid, tree in params.items():
            load_tree(self.modules[pid].param_tree(), tree)
        return "ok"

    def _forward(self, pid: str, aids: List[str], obs: Dict[str, np.ndarray], logits: bool):
        import torch

        module = self.modules[pid]
        stacked = torch.from_numpy(np.stack([obs[a] for a in aids]).astype(np.float32))
        with torch.no_grad():
            out = module.logits(stacked) if logits else module.value(stacked)
        return out.numpy()

    def _policy_batch(self, pid: str, aids: List[str], obs: Dict[str, np.ndarray]):
        """One batched logits+value dispatch for every agent of a policy
        (same batching the single-agent EnvRunner gets over its N envs)."""
        from .module import softmax_sample

        actions, logp = softmax_sample(self.rng, self._forward(pid, aids, obs, True))
        values = self._forward(pid, aids, obs, False).astype(np.float32)
        return actions, logp, values

    def sample(self, num_steps: int) -> Dict[str, Any]:
        """Per-policy rollout arrays over num_steps env steps.  Column order
        is the env's agent_ids declaration order throughout — per-step rows,
        and the bootstrap values — so GAE columns always line up."""
        policy_agents: Dict[str, List[str]] = {pid: [] for pid in self.modules}
        for aid in self.env.agent_ids:
            policy_agents[self.mapping[aid]].append(aid)
        cols: Dict[str, Dict[str, list]] = {
            pid: {k: [] for k in ("obs", "actions", "rewards", "dones", "logp", "values")}
            for pid in self.modules
        }
        ep_returns: List[float] = []
        ep_acc = 0.0
        for _ in range(num_steps):
            prev_obs = self.obs
            acts: Dict[str, int] = {}
            per_policy = {}
            for pid, aids in policy_agents.items():
                if not aids:
                    continue
                actions, logp, values = self._policy_batch(pid, aids, prev_obs)
                per_policy[pid] = (actions, logp, values)
                for i, aid in enumerate(aids):
                    acts[aid] = int(actions[i])
            nobs, rewards, dones, _ = self.env.step(acts)
            ep_acc += float(np.mean(list(rewards.values())))
            for pid, aids in policy_agents.items():
                if not aids:
                    continue
                actions, logp, values = per_policy[pid]
                c = cols[pid]
                c["obs"].append([prev_obs[a] for a in aids])
                c["actions"].append(list(actions))
                c["rewards"].append([rewards[a] for a in aids])
                c["dones"].append([dones.get(a, dones["__all__"]) for a in aids])
                c["logp"].append(list(logp))
                c["values"].append(list(values))
            if dones["__all__"]:
                ep_returns.append(ep_acc)
                ep_acc = 0.0
                nobs = self.env.reset()
            self.obs = nobs
        out: Dict[str, Any] = {"metrics": {
            "episodes": len(ep_returns),
            **({"episode_return_mean": float(np.mean(ep_returns))} if ep_returns else {}),
        }}
        for pid, aids in policy_agents.items():
            c = cols[pid]
            if not aids or not c["obs"]:
                continue
            ro = {
                "obs": np.asarray(c["obs"], np.float32),          # [T, N, D]
                "actions": np.asarray(c["actions"], np.int32),    # [T, N]
                "rewards": np.asarray(c["rewards"], np.float32),
                "dones": np.asarray(c["dones"]),
                "logp": np.asarray(c["logp"], np.float32),
                "values": np.asarray(c["values"], np.float32),
            }
            # bootstrap values for the final obs, same agent order as the
            # columns above; value-only (no sampling, rng untouched)
            ro["last_values"] = self._forward(pid, aids, self.obs, False).astype(np.float32)
            out[pid] = ro
        return out


class MultiAgentPPO:
    """Independent PPO over a policy map (the rllib multi-agent default).

    ``policies``: policy_id -> {} (spec overrides); ``policy_mapping_fn``:
    agent_id -> policy_id, resolved once per agent id (fixed agent sets)."""

    def __init__(
        self,
        env_creator: Callable[[], MultiAgentEnv],
        policies: Dict[str, dict],
        policy_mapping_fn: Callable[[str], str],
        *,
        num_env_runners: int = 2,
        rollout_length: int = 128,
        gamma: float = 0.99,
        lam: float = 0.95,
        lr: float = 3e-3,
        hidden: Tuple[int, ...] = (64, 64),
        seed: int = 0,
        device=None,
    ):
        """device: the learners' (None: the card; raises without one)."""
        probe = env_creator()
        self.gamma, self.lam = gamma, lam
        self.mapping = {aid: policy_mapping_fn(aid) for aid in probe.agent_ids}
        unknown = set(self.mapping.values()) - set(policies)
        if unknown:
            raise ValueError(f"policy_mapping_fn returned unknown policies {sorted(unknown)}")
        self.specs = {
            pid: {
                "obs_dim": spec.get("obs_dim", probe.observation_dim),
                "num_actions": spec.get("num_actions", probe.num_actions),
                "hidden": spec.get("hidden", hidden),
            }
            for pid, spec in policies.items()
        }
        self.learners = {
            pid: PPOLearner(
                DiscretePolicyModule(s["obs_dim"], s["num_actions"], s["hidden"]),
                lr=lr, seed=seed + j, device=device,
            )
            for j, (pid, s) in enumerate(self.specs.items())
        }
        Runner = _ca.remote(MultiAgentEnvRunner)
        self.runners = [
            Runner.remote(env_creator, self.specs, self.mapping, seed=seed + 100 * i)
            for i in range(num_env_runners)
        ]
        self.rollout_length = rollout_length
        self.iteration = 0
        self._broadcast()

    def _broadcast(self):
        weights = {pid: ln.get_weights() for pid, ln in self.learners.items()}
        _ca.get([r.set_weights.remote(weights) for r in self.runners])

    def train(self) -> Dict[str, Any]:
        rollouts = _ca.get([r.sample.remote(self.rollout_length) for r in self.runners])
        metrics: Dict[str, Any] = {}
        rets = [
            ro["metrics"]["episode_return_mean"]
            for ro in rollouts
            if "episode_return_mean" in ro["metrics"]
        ]
        for pid, learner in self.learners.items():
            batches = []
            for ro in rollouts:
                if pid not in ro:
                    continue
                r = ro[pid]
                adv, ret = compute_gae(r, self.gamma, self.lam)
                batches.append({
                    "obs": r["obs"].reshape(-1, r["obs"].shape[-1]),
                    "actions": r["actions"].reshape(-1),
                    "logp_old": r["logp"].reshape(-1),
                    "advantages": adv,
                    "returns": ret,
                })
            if not batches:
                continue
            batch = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
            stats = learner.update(batch)
            metrics[pid] = stats
        self._broadcast()
        self.iteration += 1
        metrics["training_iteration"] = self.iteration
        if rets:
            metrics["episode_return_mean"] = float(np.mean(rets))
        return metrics

    def get_policy_weights(self, policy_id: str):
        return self.learners[policy_id].get_weights()

    def stop(self):
        for r in self.runners:
            try:
                kill(r)
            except Exception:
                pass
