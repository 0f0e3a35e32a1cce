"""Algorithm + AlgorithmConfig: the training driver (analogue of the
reference's rllib/algorithms/algorithm.py — EnvRunnerGroup sampling in
parallel actors, a torch Learner updating, weights broadcast each
iteration).

The learner runs on `config.device` (None: the card; it raises without
one) and the env runners on the CPU.  Weights go to the runners as the
learner's tensors, over RPC as actor arguments or through the compiled
DAG's input channel, and land on the runners' CPU; rollouts that come back
over the DAG's tensor-transport edge land on the learner's device and are
brought to the host, where GAE runs, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import api as ca
from ..core.actor import kill
from .env import make_env
from .env_runner import EnvRunner
from .learner import DQNLearner, IMPALALearner, PPOLearner, compute_gae
from .module import DiscretePolicyModule, QModule


def _host(v):
    """A landed leaf (a tensor on any device) as a host numpy array."""
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class AlgorithmConfig:
    def __init__(self, algo: str = "PPO"):
        self.algo = algo
        self.env: Any = "CartPole-v1"
        self.num_env_runners = 2
        self.num_envs_per_runner = 4
        self.rollout_length = 64
        self.gamma = 0.99
        self.lam = 0.95
        self.lr = 3e-4
        self.hidden = (64, 64)
        self.seed = 0
        # ppo
        self.clip = 0.2
        self.epochs = 4
        self.minibatches = 4
        self.entropy_coeff = 0.01
        # dqn
        self.buffer_capacity = 50_000
        self.train_batch_size = 64
        self.target_update_freq = 100
        self.epsilon_decay = 0.99
        self.min_epsilon = 0.05
        self.updates_per_iteration = 32
        # prioritized replay (DQN): proportional PER with IS correction
        self.replay = "uniform"  # uniform | prioritized
        self.per_alpha = 0.6
        self.per_beta = 0.4
        self.per_beta_anneal_steps = 100_000
        # recurrent policy (PPO): GRU core instead of the plain MLP
        self.use_lstm = False
        self.lstm_hidden = 64
        # connector pipelines (rllib/connectors/): factories returning a
        # ConnectorPipeline (or list of connectors); obs transforms run
        # before every policy forward, action transforms before env.step
        self.env_to_module_connector = None
        self.module_to_env_connector = None
        # compiled actor->learner experience edge (flagship: PPO): rollouts
        # arrive over shm channels from a compiled DAG instead of per-
        # iteration RPCs; weights broadcast through the DAG input channel
        self.compiled_dag = False
        # sac
        self.tau = 0.005
        self.target_entropy = None  # default: -action_dim
        # td3
        self.policy_delay = 2
        self.target_noise = 0.2
        self.noise_clip = 0.5
        self.exploration_noise = 0.1
        # the learner's device: None is the card (raises without one)
        self.device = None

    def environment(self, env) -> "AlgorithmConfig":
        self.env = env
        return self

    def env_runners(self, num_env_runners: int, num_envs_per_runner: int = 4) -> "AlgorithmConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_runner
        return self

    def training(self, **kw) -> "AlgorithmConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "Algorithm":
        return Algorithm(self)


class Algorithm:
    def __init__(self, config: AlgorithmConfig):
        self.config = config
        probe = make_env(config.env)
        obs_dim, num_actions = probe.observation_dim, probe.num_actions
        if config.algo == "SAC":
            kind = "gaussian"
        elif config.algo == "TD3":
            kind = "deterministic"
        elif config.algo == "PPO" and config.use_lstm:
            kind = "recurrent"
        elif config.algo in ("PPO", "IMPALA", "APPO"):
            kind = "policy"
        else:
            kind = "q"
        module_spec = {
            "kind": kind,
            "obs_dim": obs_dim,
            "num_actions": num_actions,
            "hidden": config.hidden,
            "lstm_hidden": config.lstm_hidden,
        }
        if kind in ("gaussian", "deterministic"):
            module_spec["action_dim"] = probe.action_dim
            module_spec["action_scale"] = getattr(probe, "action_scale", 1.0)
        if kind == "deterministic":
            module_spec["explore_noise"] = config.exploration_noise
        if kind == "recurrent":
            from .learner import RecurrentPPOLearner
            from .module import RecurrentPolicyModule

            self.module = RecurrentPolicyModule(
                obs_dim, num_actions, config.lstm_hidden
            )
            self.learner = RecurrentPPOLearner(
                self.module,
                lr=config.lr,
                clip=config.clip,
                entropy_coeff=config.entropy_coeff,
                epochs=config.epochs,
                seed=config.seed,
                device=config.device,
            )
        elif config.algo == "PPO":
            self.module = DiscretePolicyModule(obs_dim, num_actions, config.hidden)
            self.learner = PPOLearner(
                self.module,
                lr=config.lr,
                clip=config.clip,
                entropy_coeff=config.entropy_coeff,
                epochs=config.epochs,
                minibatches=config.minibatches,
                seed=config.seed,
                device=config.device,
            )
        elif config.algo in ("IMPALA", "APPO"):
            self.module = DiscretePolicyModule(obs_dim, num_actions, config.hidden)
            self.learner = IMPALALearner(
                self.module,
                lr=config.lr,
                gamma=config.gamma,
                entropy_coeff=config.entropy_coeff,
                surrogate_clip=config.clip if config.algo == "APPO" else None,
                seed=config.seed,
                device=config.device,
            )
            self._pending: Dict[Any, int] = {}  # in-flight sample ref -> runner idx
        elif config.algo == "DQN":
            from .buffer import PrioritizedReplayBuffer, ReplayBuffer

            self.module = QModule(obs_dim, num_actions, config.hidden)
            self.learner = DQNLearner(
                self.module,
                lr=config.lr,
                gamma=config.gamma,
                target_update_freq=config.target_update_freq,
                seed=config.seed,
                device=config.device,
            )
            if config.replay == "prioritized":
                self.buffer = PrioritizedReplayBuffer(
                    config.buffer_capacity, obs_dim, config.seed,
                    alpha=config.per_alpha, beta=config.per_beta,
                    beta_anneal_steps=config.per_beta_anneal_steps,
                )
            else:
                self.buffer = ReplayBuffer(config.buffer_capacity, obs_dim, config.seed)
            self.epsilon = 1.0
        elif config.algo == "SAC":
            from .buffer import ReplayBuffer
            from .learner import SACLearner
            from .module import SquashedGaussianModule, TwinQModule

            self.module = SquashedGaussianModule(
                obs_dim, probe.action_dim,
                getattr(probe, "action_scale", 1.0), config.hidden,
            )
            self.learner = SACLearner(
                self.module,
                TwinQModule(obs_dim, probe.action_dim, config.hidden),
                lr=config.lr,
                gamma=config.gamma,
                tau=config.tau,
                target_entropy=config.target_entropy,
                seed=config.seed,
                device=config.device,
            )
            self.buffer = ReplayBuffer(
                config.buffer_capacity, obs_dim, config.seed,
                action_dim=probe.action_dim,
            )
        elif config.algo == "TD3":
            from .buffer import ReplayBuffer
            from .learner import TD3Learner
            from .module import DeterministicPolicyModule, TwinQModule

            self.module = DeterministicPolicyModule(
                obs_dim, probe.action_dim,
                getattr(probe, "action_scale", 1.0), config.hidden,
            )
            self.learner = TD3Learner(
                self.module,
                TwinQModule(obs_dim, probe.action_dim, config.hidden),
                lr=config.lr,
                gamma=config.gamma,
                tau=config.tau,
                policy_delay=config.policy_delay,
                target_noise=config.target_noise,
                noise_clip=config.noise_clip,
                seed=config.seed,
                device=config.device,
            )
            self.buffer = ReplayBuffer(
                config.buffer_capacity, obs_dim, config.seed,
                action_dim=probe.action_dim,
            )
        else:
            raise ValueError(f"unknown algo {config.algo!r}")
        # resolve string env names to their creator callable here: the
        # registry is per-process, so runner actors must receive something
        # self-contained (cloudpickle ships locally-defined env classes)
        from .env import _ENV_REGISTRY

        env_spec = config.env
        if isinstance(env_spec, str):
            if env_spec not in _ENV_REGISTRY:
                raise KeyError(f"unknown env {env_spec!r}; register_env() it first")
            env_spec = _ENV_REGISTRY[env_spec]
        Runner = ca.remote(EnvRunner)
        self.runners = [
            Runner.remote(
                env_spec,
                module_spec,
                num_envs=config.num_envs_per_runner,
                seed=config.seed + 100 * i,
                explore="sample" if kind in ("policy", "recurrent") else "epsilon",
                env_to_module=config.env_to_module_connector,
                module_to_env=config.module_to_env_connector,
            )
            for i in range(config.num_env_runners)
        ]
        self._broadcast()
        self.iteration = 0
        self._dag = None  # compiled experience edge, built on first use

    def _broadcast(self):
        eps = getattr(self, "epsilon", None)
        ca.get([r.set_weights.remote(self.learner.get_weights(), eps) for r in self.runners])

    def _train_impala(self) -> Dict[str, Any]:
        """One IMPALA iteration: consume one rollout per runner AS THEY
        ARRIVE (actor-learner decoupling — runners keep sampling with lagged
        weights; V-trace corrects), update after each, resubmit immediately
        with fresh weights.  Reference rllib/algorithms/impala/ async mode."""
        cfg = self.config
        t0 = time.monotonic()
        if not self._pending:
            self._pending = {
                r.sample.remote(cfg.rollout_length): i
                for i, r in enumerate(self.runners)
            }
        stats: Dict[str, Any] = {}
        episodes, ep_returns = 0, []
        for _ in range(len(self.runners)):
            ready, _ = ca.wait(list(self._pending), num_returns=1, timeout=120)
            if not ready:
                raise TimeoutError(
                    "IMPALA: no env-runner produced a rollout within 120s "
                    f"({len(self._pending)} in flight)"
                )
            ref = ready[0]
            idx = self._pending.pop(ref)
            ro = ca.get(ref)
            m = ro.pop("metrics")
            episodes += m.get("episodes", 0)
            if "episode_return_mean" in m:
                ep_returns.append(m["episode_return_mean"])
            stats = self.learner.update(ro)
            runner = self.runners[idx]
            runner.set_weights.remote(self.learner.get_weights(), None)
            self._pending[runner.sample.remote(cfg.rollout_length)] = idx
        self.iteration += 1
        out = dict(stats)
        out.update(
            {
                "training_iteration": self.iteration,
                "episodes_this_iter": episodes,
                "env_steps_this_iter": cfg.rollout_length
                * cfg.num_envs_per_runner
                * cfg.num_env_runners,
                "time_this_iter_s": time.monotonic() - t0,
            }
        )
        if ep_returns:
            out["episode_return_mean"] = float(np.mean(ep_returns))
        return out

    def _dag_rollouts(self):
        """Compiled actor->learner experience edge: one shm write broadcasts
        the weights to every runner (the DAG input channel has num_readers=N,
        so the payload crosses process boundaries once, not N times), each
        runner's fused sync_sample ships its rollout back over a tensor-
        transport channel (per-shard buffer borrows, no pickle of array
        bytes) — versus 2N RPCs per iteration on the default path.

        On DeadActorError (a runner died mid-iteration) the DAG recompiles
        against the restarted actors once; a second death in the same
        iteration propagates."""
        from ..core.errors import DeadActorError
        from ..dag import InputNode, MultiOutputNode

        cfg = self.config
        if self._dag is None:
            with InputNode() as inp:
                leaves = [
                    r.sync_sample.bind(inp[0], inp[1]).with_tensor_transport()
                    for r in self.runners
                ]
            self._dag = MultiOutputNode(leaves).experimental_compile(
                max_inflight_executions=2
            )
        try:
            rollouts = self._dag.execute(
                self.learner.get_weights(), cfg.rollout_length
            ).get()
        except DeadActorError:
            self._dag.recompile()
            rollouts = self._dag.execute(
                self.learner.get_weights(), cfg.rollout_length
            ).get()
        # tensor transport lands the array leaves on this process's device
        # (the card's, where the learner is); GAE runs on numpy on the
        # host, so bring them back here
        return [
            {k: v if k == "metrics" else _host(v) for k, v in ro.items()}
            for ro in rollouts
        ]

    def _sample(self, use_dag: bool):
        """One rollout per runner: over the compiled DAG, or by RPC."""
        if use_dag:
            return self._dag_rollouts()
        cfg = self.config
        return ca.get([r.sample.remote(cfg.rollout_length) for r in self.runners])

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        if cfg.algo in ("IMPALA", "APPO"):
            return self._train_impala()
        t0 = time.monotonic()
        use_dag = cfg.compiled_dag and cfg.algo == "PPO" and not cfg.use_lstm
        rollouts = self._sample(use_dag)
        metrics: Dict[str, Any] = {}
        episodes, ep_returns = 0, []
        for ro in rollouts:
            m = ro.pop("metrics")
            episodes += m.get("episodes", 0)
            if "episode_return_mean" in m:
                ep_returns.append(m["episode_return_mean"])
        if cfg.algo == "PPO" and cfg.use_lstm:
            # sequence-shaped batch: runners concatenate along the env axis,
            # each sequence unrolled from its recorded initial hidden state
            batches = []
            for ro in rollouts:
                a, r = compute_gae(ro, cfg.gamma, cfg.lam)
                T, N = ro["rewards"].shape
                batches.append(
                    {
                        "obs": ro["obs"],
                        "actions": ro["actions"],
                        "logp_old": ro["logp"],
                        "dones": ro["dones"].astype(np.float32),
                        "advantages": a.reshape(T, N),
                        "returns": r.reshape(T, N),
                        "state0": ro["state0"],
                    }
                )
            batch = {
                k: np.concatenate(
                    [b[k] for b in batches], axis=0 if k == "state0" else 1
                )
                for k in batches[0]
            }
            stats = self.learner.update(batch)
        elif cfg.algo == "PPO":
            advs, rets, batches = [], [], []
            for ro in rollouts:
                a, r = compute_gae(ro, cfg.gamma, cfg.lam)
                obs = ro["obs"].reshape(-1, ro["obs"].shape[-1])
                batches.append(
                    {
                        "obs": obs,
                        "actions": ro["actions"].reshape(-1),
                        "logp_old": ro["logp"].reshape(-1),
                        "advantages": a,
                        "returns": r,
                    }
                )
            batch = {
                k: np.concatenate([b[k] for b in batches]) for k in batches[0]
            }
            stats = self.learner.update(batch)
        else:
            for ro in rollouts:
                T, N = ro["rewards"].shape
                obs = ro["obs"]
                next_obs = np.concatenate([obs[1:], ro["next_obs"][None]], axis=0)
                acts = ro["actions"]
                # continuous actions are [T, N, A]; discrete are [T, N]
                acts = acts.reshape(T * N, -1) if acts.ndim == 3 else acts.reshape(-1)
                self.buffer.add_batch(
                    obs.reshape(T * N, -1),
                    acts,
                    ro["rewards"].reshape(-1),
                    ro["dones"].reshape(-1).astype(np.float32),
                    next_obs.reshape(T * N, -1),
                )
            stats = {}
            if len(self.buffer) >= cfg.train_batch_size:
                for _ in range(cfg.updates_per_iteration):
                    stats = self.learner.update(self.buffer.sample(cfg.train_batch_size))
                    td_abs = stats.pop("td_abs", None)
                    indices = stats.pop("indices", None)
                    if td_abs is not None and hasattr(self.buffer, "update_priorities"):
                        self.buffer.update_priorities(indices, td_abs)
            if cfg.algo == "DQN":
                self.epsilon = max(cfg.min_epsilon, self.epsilon * cfg.epsilon_decay)
        if not use_dag:
            # dag path: fresh weights ride the NEXT execute()'s input write,
            # so a post-update RPC broadcast would be pure overhead
            self._broadcast()
        self.iteration += 1
        metrics.update(stats)
        metrics.update(
            {
                "training_iteration": self.iteration,
                "episodes_this_iter": episodes,
                "env_steps_this_iter": cfg.rollout_length
                * cfg.num_envs_per_runner
                * cfg.num_env_runners,
                "time_this_iter_s": time.monotonic() - t0,
            }
        )
        if ep_returns:
            metrics["episode_return_mean"] = float(np.mean(ep_returns))
        return metrics

    def evaluate(self, num_episodes: int = 5) -> float:
        return ca.get(self.runners[0].evaluate.remote(num_episodes))

    # ------------------------------------------------------------ checkpoint
    def save(self, path: str) -> str:
        from ..llm import _params_io

        _params_io.save_params({"weights": self.learner.get_weights()}, path)
        # connector stats (e.g. obs normalizer) are part of the policy: a
        # restored policy without them sees differently-scaled observations.
        # Side file (pickle): the state nests lists/None, which the flat
        # npz params format doesn't model
        cs = ca.get(self.runners[0].connector_state.remote())
        if cs is not None:
            import pickle

            with open(os.path.join(path, "connectors.pkl"), "wb") as f:
                pickle.dump(cs, f)
        return path

    def load(self, path: str):
        from ..llm import _params_io

        self.learner.set_weights(_params_io.load_params(path)["weights"])
        cpath = os.path.join(path, "connectors.pkl")
        if os.path.exists(cpath):
            import pickle

            with open(cpath, "rb") as f:
                cs = pickle.load(f)
            ca.get(
                [
                    r.set_weights.remote(self.learner.get_weights(), None, cs)
                    for r in self.runners
                ]
            )
        self._broadcast()

    def stop(self):
        if self._dag is not None:
            try:
                self._dag.teardown()
            except Exception:
                pass
            self._dag = None
        for r in self.runners:
            try:
                kill(r)
            except Exception:
                pass
