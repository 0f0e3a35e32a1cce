"""The port's RL library (cluster_anywhere_tpu_torch.rl) against the JAX
package's (cluster_anywhere_tpu.rl), module by module, on the CPU.

The same numpy inputs, made from a seed, go through both; JAX-initialised
params are carried into the port (models/convert.py's rl_from_jax_params),
and where an update draws noise (SAC, TD3, Dreamer) the port is fed JAX's
own draws, made from the JAX learner's key the way it makes them.

Tolerances, stated where they are used:
- envs, buffers, connectors, compute_gae, compute_returns and rollout
  files are numpy code copied over: exact;
- each module's forward (the GRU's step and unroll included): 1e-6
  (rtol and atol); the squashed Gaussian's log-density 1e-5, where
  log(1 - tanh^2) amplifies the two tanh implementations' last ulp;
- each learner's losses within 1e-5 relative (absolute below 1.0), and
  every parameter within 1e-4 relative L2 after 3 updates (SAC in
  float64 on both sides: see FLOAT64);
- Dreamer: the world-model and actor-critic losses within 1e-5 relative,
  one update of each within 1e-4 relative L2 per parameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_anywhere_tpu import rl as jrl
from cluster_anywhere_tpu.rl import dreamer as jdr
from cluster_anywhere_tpu.rl import env_runner as jer
from cluster_anywhere_tpu.rl import learner as jl
from cluster_anywhere_tpu.rl import marwil as jmw
from cluster_anywhere_tpu.rl import module as jm
from cluster_anywhere_tpu.rl import offline as joff
from cluster_anywhere_tpu_torch import rl as trl
from cluster_anywhere_tpu_torch.llm import _params_io as tio
from cluster_anywhere_tpu_torch.models.convert import rl_from_jax_params, rl_to_jax_params
from cluster_anywhere_tpu_torch.rl import dreamer as tdr
from cluster_anywhere_tpu_torch.rl import env_runner as ter
from cluster_anywhere_tpu_torch.rl import learner as tl
from cluster_anywhere_tpu_torch.rl import marwil as tmw
from cluster_anywhere_tpu_torch.rl import module as tm
from cluster_anywhere_tpu_torch.rl import offline as toff

FWD_TOL = 1e-6
LOSS_REL = 1e-5
PARAM_REL_L2 = 1e-4
UPDATES = 3


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(a, b, rel=LOSS_REL):
    """|a - b| within rel of the larger magnitude, or of 1 below it."""
    return abs(float(a) - float(b)) <= rel * max(abs(float(a)), abs(float(b)), 1.0)


def assert_stats(got, want, rel=LOSS_REL):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_allclose(got[k], want[k], rtol=rel, atol=rel)
        else:
            assert close(got[k], want[k], rel), (k, got[k], want[k])


def assert_params(port_tree, jax_tree, rel=PARAM_REL_L2):
    """Every leaf within rel relative L2 (a leaf both keep at 0 passes)."""
    flat_t = tio._flatten(port_tree)
    flat_j = tio._flatten(np_tree(jax_tree))
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_j:
        diff = np.linalg.norm(np.asarray(flat_t[k], np.float64) - np.asarray(flat_j[k], np.float64))
        ref = np.linalg.norm(np.asarray(flat_j[k], np.float64))
        assert diff <= rel * max(ref, 1e-12), (k, diff, ref)


# --------------------------------------------------------------- the surface


def test_the_port_exports_the_jax_packages_names():
    assert sorted(trl.__all__) == sorted(jrl.__all__)
    assert all(hasattr(trl, n) for n in jrl.__all__)
    # the modules and helpers outside __all__ that other modules use
    for name in ("SquashedGaussianModule", "TwinQModule", "softmax_sample"):
        assert hasattr(tm, name)
    for name in ("SACLearner", "TD3Learner"):
        assert hasattr(tl, name)


def test_learners_and_config_default_to_the_card():
    """device=None is the card: with none, a learner raises; the config's
    device is None until .training(device=...) sets it."""
    assert trl.AlgorithmConfig("PPO").device is None
    assert trl.AlgorithmConfig("PPO").training(device="cpu").device == "cpu"
    if not torch.cuda.is_available():
        for make in (lambda: trl.PPOLearner(trl.DiscretePolicyModule(4, 2)),
                     lambda: trl.DQNLearner(trl.QModule(4, 2)),
                     lambda: trl.DreamerV3Learner(trl.DreamerConfig()),
                     lambda: trl.AlgorithmConfig("PPO").build()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    learner = trl.PPOLearner(trl.DiscretePolicyModule(4, 2), device="cpu")
    assert {p.device.type for p in learner.module.parameters()} == {"cpu"}


# ------------------------------------------------------- numpy, copied over


def test_envs_give_equal_steps():
    rng = np.random.default_rng(0)
    for name in ("CartPole-v1", "Pendulum-v1", "MemoryChain-v0"):
        envs = [pkg.make_env(name) for pkg in (jrl, trl)]
        obs = [e.reset(seed=3) for e in envs]
        np.testing.assert_array_equal(obs[0], obs[1])
        for _ in range(60):
            a = rng.uniform(-2, 2, 1).astype(np.float32) if name == "Pendulum-v1" \
                else int(rng.integers(2))
            outs = [e.step(a) for e in envs]
            for x, y in zip(outs[0][:3], outs[1][:3]):
                np.testing.assert_array_equal(x, y)
            if outs[0][2]:
                obs = [e.reset() for e in envs]
                np.testing.assert_array_equal(obs[0], obs[1])
    vecs = [pkg.VectorEnv("CartPole-v1", 3, seed=5) for pkg in (jrl, trl)]
    for _ in range(120):
        acts = rng.integers(0, 2, 3).astype(np.int32)
        for x, y in zip(*[v.step(acts) for v in vecs]):
            np.testing.assert_array_equal(x, y)
    assert vecs[0].drain_metrics() == vecs[1].drain_metrics()


def test_buffers_give_equal_samples_and_priorities():
    rng = np.random.default_rng(1)
    for kind in ("uniform", "prioritized"):
        bufs = [(pkg.PrioritizedReplayBuffer if kind == "prioritized" else pkg.ReplayBuffer)(
            64, 3, seed=2) for pkg in (jrl, trl)]
        for step in range(5):
            n = 20
            data = (rng.normal(size=(n, 3)).astype(np.float32), rng.integers(0, 2, n),
                    rng.normal(size=n).astype(np.float32), (rng.random(n) < 0.1).astype(np.float32),
                    rng.normal(size=(n, 3)).astype(np.float32))
            for b in bufs:
                b.add_batch(*data)
            samples = [b.sample(16) for b in bufs]
            assert sorted(samples[0]) == sorted(samples[1])
            for k in samples[0]:
                np.testing.assert_array_equal(samples[0][k], samples[1][k])
            if kind == "prioritized":
                td = rng.normal(size=16)
                for b, s in zip(bufs, samples):
                    b.update_priorities(s["indices"], td)
                np.testing.assert_array_equal(bufs[0].tree.tree, bufs[1].tree.tree)
                assert bufs[0].beta == bufs[1].beta


def test_connectors_give_equal_batches_and_states():
    rng = np.random.default_rng(2)
    pipes = [pkg.ConnectorPipeline([pkg.RunningObsNormalizer(), pkg.ClipObs(2.0),
                                    pkg.Lambda(lambda x: x * 2)]) for pkg in (jrl, trl)]
    acts = [pkg.RescaleActions(-2.0, 2.0) for pkg in (jrl, trl)]
    for _ in range(4):
        batch = rng.normal(size=(5, 3)).astype(np.float32) * 3
        np.testing.assert_array_equal(pipes[0](batch), pipes[1](batch))
        a = rng.uniform(-1, 1, (5, 1))
        np.testing.assert_array_equal(acts[0](a), acts[1](a))
    s = [p.get_state() for p in pipes]
    np.testing.assert_array_equal(s[0]["steps"][0]["mean"], s[1]["steps"][0]["mean"])
    np.testing.assert_array_equal(s[0]["steps"][0]["m2"], s[1]["steps"][0]["m2"])
    fresh = trl.ConnectorPipeline([trl.RunningObsNormalizer(), trl.ClipObs(2.0)])
    fresh.set_state(s[0])
    fresh.set_update(False)
    batch = rng.normal(size=(5, 3)).astype(np.float32)
    pipes[0].set_update(False)
    np.testing.assert_array_equal(fresh(batch), pipes[0].connectors[1](pipes[0].connectors[0](batch)))


def test_gae_and_returns_are_equal():
    rng = np.random.default_rng(3)
    T, N = 17, 3
    ro = {"rewards": rng.normal(size=(T, N)).astype(np.float32),
          "values": rng.normal(size=(T, N)).astype(np.float32),
          "dones": rng.random((T, N)) < 0.2,
          "last_values": rng.normal(size=N).astype(np.float32)}
    for a, b in zip(jrl.compute_gae(ro, 0.99, 0.95), trl.compute_gae(ro, 0.99, 0.95)):
        np.testing.assert_array_equal(a, b)
    for n_envs in (1, 3):
        args = (ro["rewards"].reshape(-1), ro["dones"].reshape(-1), 0.97, n_envs)
        np.testing.assert_array_equal(jrl.compute_returns(*args), trl.compute_returns(*args))


def test_rollout_files_are_the_same_bytes_and_cross_read(tmp_path):
    rng = np.random.default_rng(4)
    batch = {"obs": rng.normal(size=(12, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, 12).astype(np.int32),
             "rewards": np.ones(12, np.float32), "dones": (rng.random(12) < 0.2).astype(np.float32)}
    paths = {}
    for name, pkg in (("jax", joff), ("port", toff)):
        paths[name] = pkg.RolloutWriter(str(tmp_path / name)).write(batch)
    import zipfile

    with zipfile.ZipFile(paths["jax"]) as zj, zipfile.ZipFile(paths["port"]) as zt:
        assert zj.namelist() == zt.namelist()
        assert all(zj.read(n) == zt.read(n) for n in zj.namelist())
    for reader_pkg, writer in ((toff, "jax"), (joff, "port")):
        r = reader_pkg.RolloutReader(str(tmp_path / writer), seed=1)
        got = r.sample(8)
        want = toff.RolloutReader(str(tmp_path / writer), seed=1).sample(8)
        for k in batch:
            np.testing.assert_array_equal(got[k], want[k])
        assert r.num_rows == 12


# ---------------------------------------------------------------- modules


def _carried(jax_module, port_module, seed=0):
    """JAX's init(key(seed)) params, and the port module holding them."""
    params = np_tree(jax_module.init(jax.random.key(seed)))
    return params, rl_from_jax_params(port_module, params)


def test_converter_round_trips_every_module_tree():
    for jmod, tmod in ((jm.DiscretePolicyModule(4, 2), tm.DiscretePolicyModule(4, 2)),
                       (jm.RecurrentPolicyModule(3, 2, 16), tm.RecurrentPolicyModule(3, 2, 16)),
                       (jm.TwinQModule(3, 1), tm.TwinQModule(3, 1))):
        params, port = _carried(jmod, tmod)
        back = rl_to_jax_params(port)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="param shape"):
        rl_from_jax_params(tm.DiscretePolicyModule(5, 2),
                           np_tree(jm.DiscretePolicyModule(4, 2).init(jax.random.key(0))))


def _obs(n, d, seed=5):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _allclose(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("kind", ["discrete", "q", "gaussian", "deterministic", "twinq"])
def test_module_forward_matches_jax(kind):
    obs = _obs(8, 3)
    t_obs = torch.from_numpy(obs)
    if kind == "discrete":
        p, port = _carried(jm.DiscretePolicyModule(3, 2), tm.DiscretePolicyModule(3, 2))
        _allclose(port.logits(t_obs), jm.DiscretePolicyModule.logits(p, obs))
        _allclose(port.value(t_obs), jm.DiscretePolicyModule.value(p, obs))
    elif kind == "q":
        p, port = _carried(jm.QModule(3, 4), tm.QModule(3, 4))
        _allclose(port.q_values(t_obs), jm.QModule.q_values(p, obs))
    elif kind == "gaussian":
        jmod = jm.SquashedGaussianModule(3, 2, 2.0)
        p, port = _carried(jmod, tm.SquashedGaussianModule(3, 2, 2.0))
        key = jax.random.key(9)
        eps = np.array(jax.random.normal(key, (8, 2)))  # what sample() draws from key
        act, logp = port.sample(t_obs, torch.from_numpy(eps))
        want_act, want_logp = jmod.sample(p, obs, key)
        _allclose(act, want_act)
        # log(1 - tanh^2) amplifies the last-ulp differences of XLA's and
        # torch's tanh near saturation: 1e-5 for the log-density
        np.testing.assert_allclose(logp.detach().numpy(), np.asarray(want_logp), rtol=1e-5, atol=1e-5)
        _allclose(port.mean_action(t_obs), jmod.mean_action(p, obs))
        for a, b in zip(port.dist(t_obs), jmod.dist(p, obs)):
            _allclose(a, b)
    elif kind == "deterministic":
        jmod = jm.DeterministicPolicyModule(3, 2, 2.0)
        p, port = _carried(jmod, tm.DeterministicPolicyModule(3, 2, 2.0))
        _allclose(port.mean_action(t_obs), jmod.mean_action(p, obs))
    else:
        p, port = _carried(jm.TwinQModule(3, 2), tm.TwinQModule(3, 2))
        act = _obs(8, 2, seed=6)
        for a, b in zip(port.q(t_obs, torch.from_numpy(act)), jm.TwinQModule.q(p, obs, act)):
            _allclose(a, b)


def test_recurrent_step_and_unroll_match_jax():
    jmod = jm.RecurrentPolicyModule(3, 2, hidden=16)
    p, port = _carried(jmod, tm.RecurrentPolicyModule(3, 2, hidden=16))
    rng = np.random.default_rng(7)
    obs = rng.normal(size=(6, 4, 3)).astype(np.float32)
    state0 = rng.normal(size=(4, 16)).astype(np.float32)
    resets = (rng.random((6, 4)) < 0.3).astype(np.float32)
    for got, want in zip(port.step(torch.from_numpy(obs[0]), torch.from_numpy(state0)),
                         jmod.step(p, obs[0], state0)):
        _allclose(got, want)
    for got, want in zip(port.unroll(*map(torch.from_numpy, (obs, state0, resets))),
                         jmod.unroll(p, obs, state0, resets)):
        _allclose(got, want)


# ---------------------------------------------------------------- learners


def _ppo_batch(rng, n=48, d=4, a=2):
    return {"obs": rng.normal(size=(n, d)).astype(np.float32),
            "actions": rng.integers(0, a, n).astype(np.int32),
            "logp_old": (np.log(0.5) + rng.normal(0, 0.2, n)).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "returns": rng.normal(size=n).astype(np.float32)}


def _transitions(rng, n=32, d=4, a=2, act_dim=0):
    acts = rng.uniform(-2, 2, (n, act_dim)).astype(np.float32) if act_dim \
        else rng.integers(0, a, n).astype(np.int32)
    return {"obs": rng.normal(size=(n, d)).astype(np.float32), "actions": acts,
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": (rng.random(n) < 0.2).astype(np.float32),
            "next_obs": rng.normal(size=(n, d)).astype(np.float32)}


def _rollout(rng, T=10, N=3, d=4, a=2):
    return {"obs": rng.normal(size=(T, N, d)).astype(np.float32),
            "actions": rng.integers(0, a, (T, N)).astype(np.int32),
            "rewards": rng.normal(size=(T, N)).astype(np.float32),
            "dones": rng.random((T, N)) < 0.15,
            "logp": (np.log(0.5) + rng.normal(0, 0.2, (T, N))).astype(np.float32),
            "next_obs": rng.normal(size=(N, d)).astype(np.float32)}


def _learner_pair(name):
    """(JAX learner, port learner with JAX's state carried in, make_batch,
    noise(jax learner) -> the port update's noise argument, or None)."""
    if name == "PPO":
        j = jl.PPOLearner(jm.DiscretePolicyModule(4, 2), epochs=2, minibatches=2, seed=1)
        t = tl.PPOLearner(tm.DiscretePolicyModule(4, 2), epochs=2, minibatches=2, seed=1, device="cpu")
        return j, t, _ppo_batch, None
    if name == "RecurrentPPO":
        j = jl.RecurrentPPOLearner(jm.RecurrentPolicyModule(4, 2, 16), epochs=2, seed=2)
        t = tl.RecurrentPPOLearner(tm.RecurrentPolicyModule(4, 2, 16), epochs=2, seed=2, device="cpu")

        def batch(rng):
            T, N = 8, 3
            return {"obs": rng.normal(size=(T, N, 4)).astype(np.float32),
                    "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
                    "logp_old": (np.log(0.5) + rng.normal(0, 0.2, (T, N))).astype(np.float32),
                    "dones": (rng.random((T, N)) < 0.2).astype(np.float32),
                    "advantages": rng.normal(size=(T, N)).astype(np.float32),
                    "returns": rng.normal(size=(T, N)).astype(np.float32),
                    "state0": rng.normal(size=(N, 16)).astype(np.float32)}
        return j, t, batch, None
    if name == "DQN-PER":
        j = jl.DQNLearner(jm.QModule(4, 3), target_update_freq=2, seed=3)
        t = tl.DQNLearner(tm.QModule(4, 3), target_update_freq=2, seed=3, device="cpu")

        def batch(rng):
            b = _transitions(rng, a=3)
            b["weights"] = rng.uniform(0.2, 1.0, len(b["obs"])).astype(np.float32)
            b["indices"] = np.arange(len(b["obs"]), dtype=np.int64)
            return b
        return j, t, batch, None
    if name in ("IMPALA", "APPO"):
        clip = 0.2 if name == "APPO" else None
        j = jl.IMPALALearner(jm.DiscretePolicyModule(4, 2), surrogate_clip=clip, seed=4)
        t = tl.IMPALALearner(tm.DiscretePolicyModule(4, 2), surrogate_clip=clip, seed=4, device="cpu")
        return j, t, _rollout, None
    if name == "SAC":
        j = jl.SACLearner(jm.SquashedGaussianModule(3, 1, 2.0), jm.TwinQModule(3, 1), seed=5)
        t = tl.SACLearner(tm.SquashedGaussianModule(3, 1, 2.0), tm.TwinQModule(3, 1), seed=5,
                          device="cpu")

        def noise(jlearner, n):
            # SACLearner's update_step: key, k1, k2 = split(key, 3)
            _, k1, k2 = jax.random.split(jlearner._key, 3)
            return (np.asarray(jax.random.normal(k1, (n, 1))), np.asarray(jax.random.normal(k2, (n, 1))))
        return j, t, lambda rng: _transitions(rng, d=3, act_dim=1), noise
    if name == "TD3":
        j = jl.TD3Learner(jm.DeterministicPolicyModule(3, 1, 2.0), jm.TwinQModule(3, 1), seed=6)
        t = tl.TD3Learner(tm.DeterministicPolicyModule(3, 1, 2.0), tm.TwinQModule(3, 1), seed=6,
                          device="cpu")

        def noise(jlearner, n):
            _, kn = jax.random.split(jlearner._key)  # TD3Learner's update_step
            return np.asarray(jax.random.normal(kn, (n, 1)))
        return j, t, lambda rng: _transitions(rng, d=3, act_dim=1), noise
    if name == "BC":
        j = joff.BCLearner(jm.DiscretePolicyModule(4, 2), seed=7)
        t = toff.BCLearner(tm.DiscretePolicyModule(4, 2), seed=7, device="cpu")
        return j, t, _ppo_batch, None
    if name == "CQL":
        j = joff.CQLLearner(jm.QModule(4, 2), target_update_freq=2, seed=8)
        t = toff.CQLLearner(tm.QModule(4, 2), target_update_freq=2, seed=8, device="cpu")
        return j, t, _transitions, None
    if name == "MARWIL":
        j = jmw.MARWILLearner(jm.DiscretePolicyModule(4, 2), beta=1.0,
                              moving_average_sqd_adv_norm_update_rate=0.1, seed=9)
        t = tmw.MARWILLearner(tm.DiscretePolicyModule(4, 2), beta=1.0,
                              moving_average_sqd_adv_norm_update_rate=0.1, seed=9, device="cpu")
        return j, t, _ppo_batch, None
    raise KeyError(name)


def carry(j, t):
    """The JAX learner's whole state (params and target nets) into the
    port learner."""
    t.set_weights(np_tree(j.params))
    for attr, jattr in (("target", "target_params"), ("target", "target"),
                        ("target_policy", "target"), ("target_q", "target")):
        if hasattr(t, attr) and hasattr(j, jattr):
            rl_from_jax_params(getattr(t, attr), np_tree(getattr(j, jattr)))


LEARNERS = ["PPO", "RecurrentPPO", "DQN-PER", "IMPALA", "APPO", "SAC", "TD3", "BC", "CQL",
            "MARWIL"]


# SAC's log-density log(1 - tanh(pre)^2 + 1e-6) turns an ulp of tanh into
# up to 1e-1 where the sample saturates, and XLA's CPU tanh is an
# approximation (up to 4 ulp from the rounded value, torch's within 1):
# both packages run SAC in float64 here, where the formulas are held to the
# same tolerances.
FLOAT64 = {"SAC"}


def _to_float64(t):
    for m in (t.policy, t.qnet, t.target):
        m.double()
    t.log_alpha.data = t.log_alpha.data.double()


@pytest.mark.parametrize("name", LEARNERS)
def test_learner_updates_match_jax(name):
    with jax.enable_x64(name in FLOAT64):
        j, t, make_batch, noise = _learner_pair(name)
        if name in FLOAT64:
            _to_float64(t)
        carry(j, t)
        rng = np.random.default_rng(10)
        for _ in range(UPDATES):
            batch = make_batch(rng)
            if noise is None:
                got = t.update(batch)
            else:
                got = t.update(batch, noise(j, len(batch["obs"])))
            want = j.update(batch)
            assert_stats(got, want)
        assert_params(rl_to_jax_params(t), j.params)
        if name == "DQN-PER":  # the target synced after update 2, as JAX's
            assert_params(tm.to_numpy(t.target.param_tree()), j.target_params)


# ---------------------------------------------------------------- runners


@pytest.mark.parametrize("kind", ["policy", "q", "deterministic", "recurrent"])
def test_env_runner_samples_match_jax(kind):
    """Both packages' EnvRunner (in this process, no cluster) with the same
    weights: equal env and action leaves where the actions are discrete,
    every other leaf within 1e-6."""
    spec = {"kind": kind, "obs_dim": 4, "num_actions": 2, "hidden": (16, 16), "lstm_hidden": 16}
    env = "CartPole-v1"
    if kind == "deterministic":
        spec.update(obs_dim=3, num_actions=0, action_dim=1, action_scale=2.0, explore_noise=0.1)
        env = "Pendulum-v1"
    explore = "sample" if kind in ("policy", "recurrent") else "epsilon"
    runners = [pkg.EnvRunner(env, spec, num_envs=3, seed=11, explore=explore) for pkg in (jer, ter)]
    weights = np_tree(runners[0].params)
    runners[1].set_weights(weights, 0.5)
    runners[0].set_weights(runners[0].params, 0.5)
    for _ in range(2):
        want, got = (r.sample(12) for r in runners)
        assert sorted(got) == sorted(want)
        assert got.pop("metrics") == want.pop("metrics")
        for k in want:
            if k in ("obs", "actions", "rewards", "dones", "next_obs") and kind != "deterministic":
                np.testing.assert_array_equal(got[k], want[k])
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=FWD_TOL, atol=FWD_TOL)
            assert got[k].dtype == np.asarray(want[k]).dtype, (k, got[k].dtype, want[k].dtype)
    assert runners[1].evaluate(1) == pytest.approx(runners[0].evaluate(1), rel=1e-4)


def test_a_gaussian_runner_draws_from_its_own_generator():
    """SAC's runner noise comes from torch.Generator(seed + 2): the same
    seed gives the same actions, inside the box; its greedy evaluation is
    JAX's (no noise)."""
    spec = {"kind": "gaussian", "obs_dim": 3, "action_dim": 1, "action_scale": 2.0,
            "hidden": (16, 16)}
    a, b = (ter.EnvRunner("Pendulum-v1", spec, num_envs=2, seed=12) for _ in range(2))
    ja = jer.EnvRunner("Pendulum-v1", spec, num_envs=2, seed=12)
    for r in (a, b):
        r.set_weights(np_tree(ja.params))
    ra, rb = a.sample(8), b.sample(8)
    np.testing.assert_array_equal(ra["actions"], rb["actions"])
    assert ra["actions"].dtype == np.float32 and np.abs(ra["actions"]).max() <= 2.0
    assert a.evaluate(1) == pytest.approx(ja.evaluate(1), rel=1e-5)


# ---------------------------------------------------------------- dreamer

DREAMER = dict(obs_dim=4, num_actions=2, hidden=32, deter=32, groups=4, classes=4, num_bins=41,
               horizon=5, seq_len=6, batch_size=3, ac_lr=3e-4)


def _dreamer_pair():
    cfg_j, cfg_t = jdr.DreamerConfig(**DREAMER), tdr.DreamerConfig(**DREAMER)
    j = jdr.DreamerV3Learner(cfg_j, seed=13)
    t = tdr.DreamerV3Learner(cfg_t, seed=13, device="cpu")
    rl_from_jax_params(t.wm, np_tree(j.params))
    rl_from_jax_params(t.ac, np_tree(j.ac_params))
    tm.load_tree(t.target_critic.tree(), np_tree(j.target_critic))
    return j, t


def _dreamer_batch(rng, cfg):
    B, L = cfg["batch_size"], cfg["seq_len"]
    first = (rng.random((B, L)) < 0.2).astype(np.float32)
    first[:, 0] = 1.0
    return {"obs": rng.normal(size=(B, L, cfg["obs_dim"])).astype(np.float32),
            "actions": rng.integers(0, cfg["num_actions"], (B, L)).astype(np.int32),
            "rewards": rng.normal(size=(B, L)).astype(np.float32),
            "cont": (rng.random((B, L)) > 0.1).astype(np.float32), "is_first": first}


def _dreamer_noise(key, cfg):
    """The Gumbel draws JAX's update makes from key: the world model's
    categorical per step (split(k1, L)), and per imagination step an
    action's and a latent's (split(k2, H), each split in two)."""
    B, L, H = cfg["batch_size"], cfg["seq_len"], cfg["horizon"]
    G, C, A, n = cfg["groups"], cfg["classes"], cfg["num_actions"], cfg["batch_size"] * cfg["seq_len"]
    k1, k2 = jax.random.split(key)
    wm = [jax.random.gumbel(k, (B, G, C)) for k in jax.random.split(k1, L)]
    act, lat = [], []
    for k in jax.random.split(k2, H):
        ka, kz = jax.random.split(k)
        act.append(jax.random.gumbel(ka, (n, A)))
        lat.append(jax.random.gumbel(kz, (n, G, C)))
    return {"wm": np.stack(wm), "act": np.stack(act), "lat": np.stack(lat)}


def test_jax_categorical_is_gumbel_argmax():
    """The port's draws rest on jax.random.categorical(key, logits) being
    argmax(logits + gumbel(key, logits.shape))."""
    logits = jnp.asarray(_obs(64, 5, seed=14))
    key = jax.random.key(15)
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(key, logits)),
        np.asarray(jnp.argmax(logits + jax.random.gumbel(key, logits.shape), -1)))


def test_dreamer_helpers_match_jax():
    x = _obs(7, 3, seed=16).reshape(-1) * 20
    bins_j = jnp.linspace(-10.0, 10.0, 41)
    t = tdr.DreamerV3Learner(tdr.DreamerConfig(**DREAMER), device="cpu")
    _allclose(t.bins, bins_j)
    _allclose(tdr.symlog(torch.from_numpy(x)), jdr.symlog(x))
    _allclose(tdr.symexp(torch.from_numpy(x / 10)), jdr.symexp(x / 10))
    _allclose(tdr.twohot(tdr.symlog(torch.from_numpy(x)), t.bins), jdr.twohot(jdr.symlog(x), bins_j))
    rets = _obs(5, 6, seed=17) * 3
    for q in (5, 95):
        assert close(torch.quantile(torch.from_numpy(rets).reshape(-1), q / 100).item(),
                     float(jnp.percentile(rets, q)), 1e-6)


def test_dreamer_updates_match_jax():
    """One update: the world-model step's and the actor-critic step's losses
    and stats, then every parameter of both and the target critic; a second
    update from there, the return range's EMA carried."""
    j, t = _dreamer_pair()
    rng = np.random.default_rng(18)
    key = jax.random.key(19)
    for _ in range(2):
        key, k = jax.random.split(key)
        batch = _dreamer_batch(rng, DREAMER)
        got = t.update(batch, _dreamer_noise(k, DREAMER))
        want = j.update(k, batch)
        assert_stats(got, want)
        assert_params(rl_to_jax_params(t.wm), j.params)
        assert_params(rl_to_jax_params(t.ac), j.ac_params)
        assert_params(tm.to_numpy(t.target_critic.tree()), j.target_critic)
        assert close(t.ret_range.item(), float(j.ret_range))


def test_dreamer_act_matches_jax():
    j, t = _dreamer_pair()
    obs = _obs(1, 4, seed=20)[0]
    key = jax.random.key(21)
    k_latent, k_act = jax.random.split(key)
    G, C, A = DREAMER["groups"], DREAMER["classes"], DREAMER["num_actions"]
    noise = (np.asarray(jax.random.gumbel(k_latent, (1, G, C))),
             np.asarray(jax.random.gumbel(k_act, (1, A))))
    for greedy in (False, True):
        (h, z, a1), a = t.act(t.init_state(1), obs, greedy=greedy, noise=noise)
        (hj, zj, a1j), aj = j.act(key, j.init_state(1), obs, greedy=greedy)
        assert a == aj
        _allclose(h, hj)
        _allclose(z, zj)
        _allclose(a1, a1j)
