"""The port's RL Algorithm (cluster_anywhere_tpu_torch.rl) driven through
its runtime on the CPU (ca.init(num_cpus=4, num_gpus=0), the learner on
device="cpu", the env runners as actors), against the JAX package's.

- Checkpoints cross: a checkpoint the JAX package's Algorithm.save wrote,
  loaded by the port's Algorithm.load, gives a first PPO train() whose
  rollouts and stats equal the JAX package's, over RPC and over the
  compiled DAG; and the JAX package's Algorithm loads the port's and
  trains as the port does.  The JAX side runs in a subprocess started with
  the file.
- One iteration each of DQN with prioritized replay, IMPALA, APPO, SAC,
  TD3, recurrent PPO and MultiAgentPPO: the port's learner starts from the
  JAX learner's state, its inputs in the iteration are recorded, and the
  JAX learner replays them (SAC and TD3 with JAX's noise fed to the
  port): equal stats and params.
- Offline BC, CQL and MARWIL over rollout files the JAX package wrote,
  from JAX-initialised modules: equal stats and params.

Tolerances: env leaves (obs, actions, rewards, dones, next_obs) exact;
network leaves of a rollout (logp, values, last_values, state0) 1e-6;
losses 1e-5 relative (absolute below 1.0); params 1e-4 relative L2 per
leaf; SAC in float64 on both sides (tests/test_torch_rl.py's FLOAT64).
Learning runs stay out: equal iterations show the port computes the JAX
package's updates.  Every wait has a timeout.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import cluster_anywhere_tpu_torch as ca
from cluster_anywhere_tpu.rl import learner as jl
from cluster_anywhere_tpu.rl import marwil as jmw
from cluster_anywhere_tpu.rl import module as jm
from cluster_anywhere_tpu.rl import offline as joff
from cluster_anywhere_tpu_torch import rl
from cluster_anywhere_tpu_torch.llm import _params_io as tio
from cluster_anywhere_tpu_torch.models.convert import rl_from_jax_params, rl_to_jax_params
from cluster_anywhere_tpu_torch.rl import module as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 90  # seconds: the bound on every wait of this file
NET_TOL = 1e-6
LOSS_REL = 1e-5
PARAM_REL_L2 = 1e-4
ENV_LEAVES = ("obs", "actions", "rewards", "dones", "next_obs")
PPO = dict(env="CartPole-v1", runners=2, envs=2,
           training=dict(lr=3e-3, rollout_length=16, epochs=2, minibatches=2, seed=3))

JAX_SIDE = textwrap.dedent("""
    import copy, json, pickle, sys
    import numpy as np
    import cluster_anywhere_tpu as ca
    from cluster_anywhere_tpu import rl
    from cluster_anywhere_tpu.rl import algorithm as alg

    spec, jax_ckpt, port_ckpt, out_path = json.loads(sys.argv[1]), *sys.argv[2:5]
    ca.init(num_cpus=4)


    def host(ro):
        return {k: copy.deepcopy(v) if k == "metrics" else np.asarray(v) for k, v in ro.items()}


    class Recorder:
        # the module's `ca`, recording the rollouts of its ca.get
        def __init__(self):
            self.rollouts = []

        def __getattr__(self, name):
            return getattr(ca, name)

        def get(self, refs, *a, **kw):
            out = ca.get(refs, *a, **kw)
            if isinstance(out, list) and out and isinstance(out[0], dict) and "obs" in out[0]:
                self.rollouts.append([host(ro) for ro in out])
            return out


    def build(**kw):
        return (rl.AlgorithmConfig("PPO").environment(spec["env"])
                .env_runners(spec["runners"], num_envs_per_runner=spec["envs"])
                .training(**spec["training"], **kw).build())


    def first_iteration(algo, load=None):
        rec = Recorder()
        alg.ca = rec
        if load is not None:
            algo.load(load)
        if algo.config.compiled_dag:
            inner = algo._dag_rollouts

            def recorded():
                out = inner()
                rec.rollouts.append([host(ro) for ro in out])
                return out
            algo._dag_rollouts = recorded
        try:
            stats = algo.train()
        finally:
            alg.ca = ca
            algo.stop()
        return {"rollouts": rec.rollouts[-1], "stats": stats}


    out = {}
    a = build()
    a.save(jax_ckpt)
    out["rpc"] = first_iteration(a)
    out["dag"] = first_iteration(build(compiled_dag=True))
    out["loaded_port"] = first_iteration(build(), load=port_ckpt)
    ca.shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
""")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(a, b, rel=LOSS_REL):
    return abs(float(a) - float(b)) <= rel * max(abs(float(a)), abs(float(b)), 1.0)


def assert_stats(got, want):
    skip = {"time_this_iter_s"}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in set(want) - skip:
        if isinstance(want[k], dict):
            assert_stats(got[k], want[k])
        elif isinstance(want[k], np.ndarray):
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_REL, atol=LOSS_REL)
        elif isinstance(want[k], (int, np.integer)) and not isinstance(want[k], bool):
            assert got[k] == want[k], k
        else:
            assert close(got[k], want[k]), (k, got[k], want[k])


def assert_params(port_tree, jax_tree):
    flat_t, flat_j = tio._flatten(port_tree), tio._flatten(np_tree(jax_tree))
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_j:
        a, b = np.asarray(flat_t[k], np.float64), np.asarray(flat_j[k], np.float64)
        assert np.linalg.norm(a - b) <= PARAM_REL_L2 * max(np.linalg.norm(b), 1e-12), k


def assert_rollouts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["metrics"] == w["metrics"]
        for k in w:
            if k == "metrics":
                continue
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, (k, g[k].dtype, w[k].dtype)
            if k in ENV_LEAVES:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=NET_TOL, atol=NET_TOL, err_msg=k)


def _host(ro):
    return {k: dict(v) if k == "metrics" else np.array(v) for k, v in ro.items()}


def ppo(**kw):
    return (rl.AlgorithmConfig("PPO").environment(PPO["env"])
            .env_runners(PPO["runners"], num_envs_per_runner=PPO["envs"])
            .training(**PPO["training"], device="cpu", **kw).build())


def first_iteration(algo, load=None):
    """train() once (after load(load)): the rollouts it sampled and its
    stats; stops the algorithm."""
    seen = []
    inner = algo._sample

    def recorded(use_dag):
        out = inner(use_dag)
        seen.append([_host(ro) for ro in out])
        return out

    algo._sample = recorded
    try:
        if load is not None:
            algo.load(load)
        stats = algo.train()
    finally:
        algo.stop()
    return {"rollouts": seen[-1], "stats": stats}


@pytest.fixture(scope="module")
def cluster():
    if ca.is_initialized():
        ca.shutdown()
    ca.init(num_cpus=4, num_gpus=0, dag_execute_timeout_s=60)
    yield
    ca.shutdown()


@pytest.fixture(scope="module", autouse=True)
def checkpoints(cluster, tmp_path_factory):
    """The port's PPO saved before the JAX side starts (which loads it),
    then the JAX side in a subprocess, started with the file so that it
    overlaps the port's tests (the checkpoint tests come last); a function
    that waits for its results."""
    d = tmp_path_factory.mktemp("rl_ckpt")
    port_ckpt, jax_ckpt, out_path = str(d / "port"), str(d / "jax"), str(d / "jax_side.pkl")
    algo = ppo()
    algo.save(port_ckpt)
    port_first = first_iteration(algo)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SIDE, json.dumps(PPO), jax_ckpt, port_ckpt,
                             out_path], env=env, cwd="/", stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    box = {}

    def result():
        if "out" not in box:
            _, err = proc.communicate(timeout=T)
            assert proc.returncode == 0, err[-3000:]
            with open(out_path, "rb") as f:
                box["out"] = dict(pickle.load(f), jax_ckpt=jax_ckpt, port_first=port_first)
        return box["out"]

    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.communicate(timeout=T)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()


# ------------------------------------------------- one iteration, replayed


def carry(j, t):
    """The JAX learner's params and target nets into the port learner."""
    t.set_weights(np_tree(j.params))
    for attr, jattr in (("target", "target_params"), ("target", "target"),
                        ("target_policy", "target"), ("target_q", "target")):
        if hasattr(t, attr) and hasattr(j, jattr):
            rl_from_jax_params(getattr(t, attr), np_tree(getattr(j, jattr)))


def _jax_learner(name, cfg):
    """The JAX learner the JAX package's Algorithm builds for this config."""
    if name == "SAC":
        return jl.SACLearner(jm.SquashedGaussianModule(3, 1, 2.0, cfg.hidden),
                             jm.TwinQModule(3, 1, cfg.hidden), lr=cfg.lr, gamma=cfg.gamma,
                             tau=cfg.tau, seed=cfg.seed)
    if name == "TD3":
        return jl.TD3Learner(jm.DeterministicPolicyModule(3, 1, 2.0, cfg.hidden),
                             jm.TwinQModule(3, 1, cfg.hidden), lr=cfg.lr, gamma=cfg.gamma,
                             tau=cfg.tau, policy_delay=cfg.policy_delay,
                             target_noise=cfg.target_noise, noise_clip=cfg.noise_clip,
                             seed=cfg.seed)
    if name == "DQN":
        return jl.DQNLearner(jm.QModule(4, 2, cfg.hidden), lr=cfg.lr, gamma=cfg.gamma,
                             target_update_freq=cfg.target_update_freq, seed=cfg.seed)
    if name in ("IMPALA", "APPO"):
        return jl.IMPALALearner(jm.DiscretePolicyModule(4, 2, cfg.hidden), lr=cfg.lr,
                                gamma=cfg.gamma, entropy_coeff=cfg.entropy_coeff,
                                surrogate_clip=cfg.clip if name == "APPO" else None,
                                seed=cfg.seed)
    return jl.RecurrentPPOLearner(jm.RecurrentPolicyModule(3, 2, cfg.lstm_hidden), lr=cfg.lr,
                                  clip=cfg.clip, entropy_coeff=cfg.entropy_coeff,
                                  epochs=cfg.epochs, seed=cfg.seed)


ONE_ITERATION = {
    "DQN": ("CartPole-v1", dict(replay="prioritized", train_batch_size=16,
                                updates_per_iteration=3, target_update_freq=2)),
    "IMPALA": ("CartPole-v1", {}),
    "APPO": ("CartPole-v1", {}),
    "SAC": ("Pendulum-v1", dict(train_batch_size=16, updates_per_iteration=3)),
    "TD3": ("Pendulum-v1", dict(train_batch_size=16, updates_per_iteration=3)),
    "PPO-lstm": ("MemoryChain-v0", dict(use_lstm=True, lstm_hidden=16, epochs=2)),
}


def _jax_noise(name, key, n):
    """The noise the JAX learner's next update draws from key, and the
    key after it (SACLearner / TD3Learner's update_step)."""
    if name == "SAC":
        key, k1, k2 = jax.random.split(key, 3)
        return key, (np.asarray(jax.random.normal(k1, (n, 1))),
                     np.asarray(jax.random.normal(k2, (n, 1))))
    key, kn = jax.random.split(key)
    return key, np.asarray(jax.random.normal(kn, (n, 1)))


@pytest.mark.parametrize("name", list(ONE_ITERATION))
def test_one_iteration_is_the_jax_learners(cluster, name):
    env, kw = ONE_ITERATION[name]
    algo_name = "PPO" if name == "PPO-lstm" else name
    cfg = (rl.AlgorithmConfig(algo_name).environment(env).env_runners(1, num_envs_per_runner=2)
           .training(rollout_length=16, seed=5, device="cpu", **kw))
    float64 = name == "SAC"
    with jax.enable_x64(float64):
        j = _jax_learner(name, cfg)
        algo = cfg.build()
        try:
            t = algo.learner
            if float64:
                for m in (t.policy, t.qnet, t.target):
                    m.double()
                t.log_alpha.data = t.log_alpha.data.double()
            carry(j, t)
            algo._broadcast()
            inputs, outputs = [], []
            update = t.update
            key = j._key if name in ("SAC", "TD3") else None

            def recorded(batch):
                nonlocal key
                batch = {k: np.array(v) for k, v in batch.items()}
                inputs.append(batch)
                if key is None:
                    out = update(batch)
                else:
                    key, noise = _jax_noise(name, key, len(batch["obs"]))
                    out = update(batch, noise)
                outputs.append(dict(out))
                return out

            t.update = recorded
            stats = algo.train()
        finally:
            algo.stop()
        assert inputs, "the iteration made no update"
        for batch, got in zip(inputs, outputs):
            assert_stats(got, j.update(batch))
        assert_params(rl_to_jax_params(t), j.params)
    for k, v in outputs[-1].items():
        if k not in ("td_abs", "indices"):
            assert stats[k] == v


def test_multi_agent_ppo_one_iteration_is_the_jax_learners(cluster):
    ma = rl.MultiAgentPPO(rl.CoordinationGame, {"p0": {}, "p1": {}},
                          lambda aid: "p0" if aid == "a0" else "p1", num_env_runners=1,
                          rollout_length=16, seed=6, device="cpu")
    js = {pid: jl.PPOLearner(jm.DiscretePolicyModule(3, 2), lr=3e-3, seed=6 + i)
          for i, pid in enumerate(("p0", "p1"))}
    try:
        inputs = {}
        for pid, t in ma.learners.items():
            carry(js[pid], t)
            update = t.update

            def recorded(batch, pid=pid, update=update):
                inputs[pid] = {k: np.array(v) for k, v in batch.items()}
                return update(batch)

            t.update = recorded
        ma._broadcast()
        stats = ma.train()
    finally:
        ma.stop()
    assert sorted(inputs) == ["p0", "p1"]
    for pid, j in js.items():
        assert_stats(stats[pid], j.update(inputs[pid]))
        assert_params(rl_to_jax_params(ma.learners[pid]), j.params)


# ------------------------------------------------------------------ offline


@pytest.fixture
def jax_init(monkeypatch):
    """The port's single-module inits give the JAX module's init(key(seed))
    (as the JAX learners call it), so offline learners start equal."""
    pairs = ((tm.DiscretePolicyModule, jm.DiscretePolicyModule), (tm.QModule, jm.QModule))
    for port_cls, jax_cls in pairs:
        def init(self, seed, jax_cls=jax_cls):
            twin = jax_cls(self.obs_dim, self.num_actions, self.hidden)
            tm.load_tree(self.param_tree(), np_tree(twin.init(jax.random.key(seed))))
            return self

        monkeypatch.setattr(port_cls, "init", init)


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    """Rollout shards the JAX package's RolloutWriter wrote (2 envs
    interleaved, as record_rollouts flattens [T, N])."""
    path = str(tmp_path_factory.mktemp("offline") / "shards")
    rng = np.random.default_rng(7)
    writer = joff.RolloutWriter(path)
    for _ in range(2):
        n = 96
        obs = rng.normal(size=(n, 4)).astype(np.float32)
        writer.write({"obs": obs, "actions": rng.integers(0, 2, n).astype(np.int32),
                      "rewards": np.ones(n, np.float32),
                      "dones": (rng.random(n) < 0.08).astype(np.float32)})
    return path


@pytest.mark.parametrize("name", ["BC", "CQL", "MARWIL"])
def test_offline_learning_from_jax_files_matches_jax(jax_shards, jax_init, name):
    kw = dict(batch_size=32, num_updates=3, seed=8)
    if name == "BC":
        got, want = rl.train_bc(jax_shards, 4, 2, device="cpu", **kw), joff.train_bc(jax_shards, 4, 2, **kw)
    elif name == "CQL":
        got, want = rl.train_cql(jax_shards, 4, 2, device="cpu", **kw), joff.train_cql(jax_shards, 4, 2, **kw)
    else:
        kw.update(beta=1.0, n_envs=2)
        got = rl.train_marwil(jax_shards, 4, 2, device="cpu", **kw)
        want = jmw.train_marwil(jax_shards, 4, 2, **kw)
    assert_stats(got.last_stats, want.last_stats)
    assert_params(rl_to_jax_params(got), want.params)


# --------------------------------------------------------- checkpoints cross


def test_the_checkpoint_has_the_jax_packages_keys(checkpoints):
    got = checkpoints()
    with np.load(os.path.join(got["jax_ckpt"], "params.npz")) as f:
        jax_keys = sorted(f.files)
    learner = rl.PPOLearner(rl.DiscretePolicyModule(4, 2), device="cpu")
    tree = tio._flatten({"weights": learner.get_weights()})
    assert sorted(tree) == jax_keys
    assert all(v.dtype == np.float32 for v in tree.values())


@pytest.mark.parametrize("dag", [False, True], ids=["rpc", "compiled_dag"])
def test_a_jax_checkpoint_gives_the_jax_packages_first_iteration(checkpoints, dag):
    want = checkpoints()["dag" if dag else "rpc"]
    got = first_iteration(ppo(compiled_dag=dag), load=checkpoints()["jax_ckpt"])
    assert_rollouts(got["rollouts"], want["rollouts"])
    assert_stats(got["stats"], want["stats"])


def test_the_jax_package_loads_the_ports_checkpoint(checkpoints):
    got = checkpoints()
    assert_rollouts(got["loaded_port"]["rollouts"], got["port_first"]["rollouts"])
    assert_stats(got["port_first"]["stats"], got["loaded_port"]["stats"])
