"""cluster_anywhere_tpu_torch.rl: reinforcement learning on the actor runtime
(compact analogue of the reference's RLlib, rllib/ — Algorithm/
AlgorithmConfig, EnvRunner actors on the CPU, torch Learners on the card;
PPO/recurrent-PPO, DQN+PER, IMPALA/APPO, SAC, TD3, connectors,
multi-agent, offline BC/CQL/MARWIL, DreamerV3).  The JAX package's
cluster_anywhere_tpu.rl, with the same names.

    from cluster_anywhere_tpu_torch import rl
    algo = rl.AlgorithmConfig("PPO").environment("CartPole-v1").env_runners(2).build()
    # .training(device="cpu") runs the learner on the host
    for _ in range(20):
        result = algo.train()
"""

from .algorithm import Algorithm, AlgorithmConfig
from .connectors import (
    ClipObs,
    Connector,
    ConnectorPipeline,
    Lambda,
    RescaleActions,
    RunningObsNormalizer,
)
from .buffer import PrioritizedReplayBuffer, ReplayBuffer
from .env import CartPole, Env, MemoryChain, Pendulum, VectorEnv, make_env, register_env
from .env_runner import EnvRunner
from .learner import (
    DQNLearner,
    IMPALALearner,
    PPOLearner,
    RecurrentPPOLearner,
    TD3Learner,
    compute_gae,
)
from .module import (
    DeterministicPolicyModule,
    DiscretePolicyModule,
    QModule,
    RecurrentPolicyModule,
)
from .dreamer import (
    DreamerConfig,
    DreamerV3Learner,
    evaluate_dreamer,
    train_dreamer,
)
from .marwil import MARWILLearner, compute_returns, train_marwil
from .offline import (
    BCLearner,
    CQLLearner,
    RolloutReader,
    RolloutWriter,
    record_rollouts,
    train_bc,
    train_cql,
)
from .multi_agent import (
    CoordinationGame,
    MultiAgentEnv,
    MultiAgentPPO,
    RockPaperScissors,
)

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "Connector",
    "ConnectorPipeline",
    "Lambda",
    "ClipObs",
    "RunningObsNormalizer",
    "RescaleActions",
    "Env",
    "CartPole",
    "Pendulum",
    "MultiAgentEnv",
    "MultiAgentPPO",
    "CoordinationGame",
    "RockPaperScissors",
    "BCLearner",
    "DreamerConfig",
    "DreamerV3Learner",
    "train_dreamer",
    "evaluate_dreamer",
    "MARWILLearner",
    "train_marwil",
    "compute_returns",
    "CQLLearner",
    "train_cql",
    "RolloutReader",
    "RolloutWriter",
    "record_rollouts",
    "train_bc",
    "VectorEnv",
    "make_env",
    "register_env",
    "EnvRunner",
    "PPOLearner",
    "DQNLearner",
    "IMPALALearner",
    "RecurrentPPOLearner",
    "TD3Learner",
    "compute_gae",
    "ReplayBuffer",
    "PrioritizedReplayBuffer",
    "DiscretePolicyModule",
    "QModule",
    "RecurrentPolicyModule",
    "DeterministicPolicyModule",
    "MemoryChain",
]
