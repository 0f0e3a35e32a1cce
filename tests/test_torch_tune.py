"""The port's Tune library (cluster_anywhere_tpu_torch.tune) against the JAX
package's (cluster_anywhere_tpu.tune), on the CPU.

- (a) the public names are equal;
- (b) searchers give equal configs for the same space and seed
  (BasicVariantGenerator over grid, random and nested spaces, TPE fed the
  same scores, BOHB fed the same rung results); the external adapters raise
  equal gated errors (none of their libraries is installed);
- (c) schedulers fed the same scripted results on stub trials give equal
  decisions and perturbations (FIFO, ASHA, median stopping, HyperBand,
  HyperBandForBOHB, PBT, PB2, ResourceChangingScheduler);
- (d) the logger callbacks write equal files, apart from times and ids;
- (e) one numpy-only program under each package's Tuner, in subprocesses of
  their own started with the file: equal trial configs, statuses, metrics
  histories and experiment_state.json (apart from times and paths), and a
  restored experiment finishing the samples it never ran; the port maps
  {"gpu": n} to num_gpus (the trial runs in the GPU pool) and refuses
  {"tpu": n};
- (f) the slice as a whole: an ASHA Tuner over trials that train a tiny
  model with the port's make_train_step(device="cpu") in fp32, each trial's
  losses held to JAX's make_train_step on the same params and batches to
  2e-5 relative (tests/test_torch_train.py's bound).

Trainables are nested in their tests or programs, so that they travel to
the trial actors by value.  Every wait is bounded.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import cluster_anywhere_tpu.tune as jtune
import cluster_anywhere_tpu_torch as ca
import cluster_anywhere_tpu_torch.tune as ttune
from cluster_anywhere_tpu.tune import trial as jtrial
from cluster_anywhere_tpu_torch.tune import trial as ttrial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 240  # seconds: the bound on every wait of this file (a Tuner's time_budget_s too)
PACKAGES = [(jtune, jtrial), (ttune, ttrial)]


# ------------------------------------------------------------- (e)'s program

PROGRAM = r"""
import importlib, json, os, pickle, shutil, signal, sys
import numpy as np

pkg, storage, out_path = sys.argv[1:4]
ca = importlib.import_module(pkg)
tune = importlib.import_module(pkg + ".tune")
cpu = {"num_gpus": 0} if pkg.endswith("_torch") else {}


def _terminated(signum, frame):
    raise SystemExit(128 + signum)  # unwinds to the finally below: ca.shutdown()


signal.signal(signal.SIGTERM, _terminated)


def trainable(config):
    start = 0
    ck = tune.get_checkpoint()
    if ck is not None:
        start = int(ck.load_pytree()["step"]) + 1
    for step in range(start, 6):
        loss = (config["lr"] * 10 - 0.3) ** 2 + 1.0 / (step + 1) + 1e-3 * config["seed"]
        c = tune.Checkpoint(tune.make_temp_checkpoint_dir())
        c.save_pytree({"step": np.array(step)})
        tune.report({"loss": loss, "step": step, "resumed_from": start}, checkpoint=c)


def results(grid):
    return [{"config": r.config, "history": r.metrics_history,
             "error": r.error is not None} for r in grid]


try:
    ca.init(num_cpus=2, **cpu)
    grid = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.01, 0.03, 0.05, 0.07]),
                     "seed": tune.randint(0, 100)},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1, seed=5, time_budget_s=240,
            scheduler=tune.ASHAScheduler(max_t=6, grace_period=2, reduction_factor=2)),
        run_config=tune.RunConfig(name="fit", storage_path=storage)).fit()
    exp = grid.experiment_path
    with open(os.path.join(exp, "experiment_state.json")) as f:
        state = json.load(f)
    # an interrupted copy: two trials on record, the second still running
    # from its step-1 checkpoint; the last two never suggested
    cut = os.path.join(storage, "cut")
    shutil.copytree(exp, cut)
    partial = json.loads(json.dumps(state))
    partial["trials"] = partial["trials"][:2]
    t = partial["trials"][1]
    t["status"] = "RUNNING"
    t["metrics_history"] = t["metrics_history"][:2]
    t["last_result"] = t["metrics_history"][-1]
    t["checkpoint_paths"] = t["checkpoint_paths"][:2]
    t["latest_checkpoint_path"] = t["checkpoint_paths"][-1]
    with open(os.path.join(cut, "experiment_state.json"), "w") as f:
        json.dump(partial, f)
    can = tune.Tuner.can_restore(cut)
    restored = tune.Tuner.restore(cut, trainable).fit()
    with open(os.path.join(cut, "experiment_state.json")) as f:
        restored_state = json.load(f)
    with open(out_path, "wb") as f:
        pickle.dump({"fit": results(grid), "state": state, "can_restore": can,
                     "restored": results(restored), "restored_state": restored_state}, f)
finally:
    ca.shutdown()
"""
SHUTDOWN_WAIT = 30  # seconds a program has for its ca.shutdown() after SIGTERM


@pytest.fixture(scope="module", autouse=True)
def programs(tmp_path_factory):
    """(e)'s program under each package, started with the file, so that
    they run while the in-process tests do.  At teardown a program still
    running gets SIGTERM, which it answers with ca.shutdown(), and is
    killed only after SHUTDOWN_WAIT seconds."""
    tmp = tmp_path_factory.mktemp("tune_programs")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = {}
    try:
        for pkg in ("cluster_anywhere_tpu", "cluster_anywhere_tpu_torch"):
            os.makedirs(tmp / f"{pkg}_storage")
            procs[pkg] = subprocess.Popen(
                [sys.executable, "-c", PROGRAM, pkg, str(tmp / f"{pkg}_storage"), str(tmp / pkg)],
                env=env, cwd="/", stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        yield {"procs": procs, "dir": tmp}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        for p in procs.values():
            try:
                p.communicate(timeout=SHUTDOWN_WAIT)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate(timeout=SHUTDOWN_WAIT)


@pytest.fixture(scope="module")
def cluster(programs):
    """The port's cluster for (e)'s GPU check and (f): one GPU declared and
    none present, so a GPU trial is placed in the GPU pool on the CPU."""
    if ca.is_initialized():
        ca.shutdown()
    info = ca.init(num_cpus=4, num_gpus=1)
    try:
        yield info
    finally:
        ca.shutdown()


def _program_outputs(programs):
    import pickle

    out = {}
    for pkg, p in programs["procs"].items():
        try:
            _, err = p.communicate(timeout=T)
        except subprocess.TimeoutExpired:
            pytest.fail(f"{pkg}'s Tuner program did not finish in {T} s")
        assert p.returncode == 0, (pkg, err[-3000:])
        with open(programs["dir"] / pkg, "rb") as f:
            out[pkg] = pickle.load(f)
    return out["cluster_anywhere_tpu"], out["cluster_anywhere_tpu_torch"]


# ------------------------------------------------------------------------ (a)

def test_public_names_are_equal():
    assert ttune.__all__ == jtune.__all__
    assert all(hasattr(ttune, n) for n in ttune.__all__)
    from cluster_anywhere_tpu import workflow as jwf
    from cluster_anywhere_tpu_torch import workflow as twf

    assert twf.__all__ == jwf.__all__


# ------------------------------------------------------------------------ (b)

def _spaces(tune):
    return {
        "grid": {"a": tune.grid_search([1, 2, 3]), "b": tune.grid_search(["x", "y"])},
        "random": {"lr": tune.loguniform(1e-4, 1e-1), "u": tune.uniform(-1, 1),
                   "q": tune.quniform(0, 10, 0.5), "k": tune.randint(1, 9),
                   "lk": tune.lograndint(1, 100), "c": tune.choice([16, 32, 64])},
        "nested": {"opt": {"lr": tune.loguniform(1e-4, 1e-1), "b": tune.grid_search([0.9, 0.99])},
                   "model": {"width": tune.choice([64, 128]), "depth": 2},
                   "seed": tune.grid_search([0, 1])},
    }


@pytest.mark.parametrize("space", ["grid", "random", "nested"])
def test_variant_generator_gives_equal_configs(space):
    out = []
    for tune, _ in PACKAGES:
        bv = tune.BasicVariantGenerator(num_samples=3, seed=11)
        bv.set_search_properties("loss", "min", _spaces(tune)[space])
        cfgs = []
        while (cfg := bv.suggest(f"t{len(cfgs)}")) is not None:
            cfgs.append(cfg)
        out.append(cfgs)
    assert out[0] == out[1] and len(out[0]) >= 3


def _score(cfg):
    return (np.log10(cfg["lr"]) + 2.5) ** 2 + cfg["u"] ** 2 + 0.01 * cfg["k"] + (cfg["c"] == 32)


@pytest.mark.parametrize("searcher", ["tpe", "bohb"])
def test_model_based_searchers_give_equal_configs(searcher):
    out = []
    for tune, _ in PACKAGES:
        space = _spaces(tune)["random"]
        if searcher == "tpe":
            s = tune.TPESearcher(n_startup_trials=5, n_candidates=16, seed=4)
        else:
            s = tune.TuneBOHB(min_points_in_model=4, num_candidates=16, seed=4)
        s.set_search_properties("loss", "min", space)
        cfgs = []
        for i in range(14):
            cfg = s.suggest(f"t{i}")
            cfgs.append(cfg)
            if searcher == "bohb":
                s.on_rung_result(3 if i % 2 else 9, cfg, _score(cfg))
            s.on_trial_complete(f"t{i}", {"loss": _score(cfg)})
        out.append(cfgs)
    assert out[0] == out[1]


@pytest.mark.parametrize("name", ["HyperOptSearch", "OptunaSearch", "BayesOptSearch"])
def test_external_adapters_raise_equal_gated_errors(name):
    errs = []
    for tune, _ in PACKAGES:
        with pytest.raises(ImportError) as info:
            getattr(tune, name)()
        errs.append((str(info.value), type(info.value.__cause__).__name__))
    assert errs[0] == errs[1]


# ------------------------------------------------------------------------ (c)

def _schedulers(tune):
    def alloc(controller, trial, all_trials):
        return {"num_cpus": 2.0} if trial.last_result["training_iteration"] % 3 == 0 else None

    return {
        "fifo": lambda: tune.FIFOScheduler(),
        "asha": lambda: tune.ASHAScheduler(max_t=9, grace_period=1, reduction_factor=2),
        "asha-brackets": lambda: tune.ASHAScheduler(max_t=9, grace_period=1, reduction_factor=2,
                                                    brackets=2),
        "median": lambda: tune.MedianStoppingRule(grace_period=2, min_samples_required=2),
        "hyperband": lambda: tune.HyperBandScheduler(max_t=9, reduction_factor=3),
        "hyperband-bohb": lambda: tune.HyperBandForBOHB(max_t=9, reduction_factor=3),
        "pbt": lambda: tune.PopulationBasedTraining(
            perturbation_interval=2, quantile_fraction=0.34, resample_probability=0.3, seed=2,
            hyperparam_mutations={"lr": tune.loguniform(1e-4, 1e-1), "m": [0.8, 0.9, 0.99]}),
        "pb2": lambda: tune.PB2(perturbation_interval=2, quantile_fraction=0.34, seed=2,
                                hyperparam_bounds={"lr": (1e-4, 1e-1), "m": tune.uniform(0.8, 1.0)}),
        "resource-changing": lambda: tune.ResourceChangingScheduler(
            base_scheduler=tune.ASHAScheduler(max_t=9, grace_period=1, reduction_factor=2),
            resources_allocation_function=alloc, reallocate_interval_s=0.0),
    }


def _drive(tune, trial_mod, make, tmp, mode):
    """Feed 6 stub trials 9 scripted steps each, as the controller would:
    decisions, perturbations and the sync scheduler's queues, in order."""
    sched = make()
    sched.set_properties("score", mode)
    if isinstance(sched, tune.HyperBandForBOHB):
        bohb = tune.TuneBOHB(seed=1)
        bohb.set_search_properties("score", mode, {"lr": tune.loguniform(1e-4, 1e-1)})
        sched.attach_searcher(bohb)
    trials = [trial_mod.Trial(f"t{i}", {"lr": 10 ** -(1 + i / 2), "m": 0.9}, str(tmp))
              for i in range(6)]
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((6, 10)) * 0.05
    log, live = [], {t.trial_id for t in trials}
    for step in range(1, 10):
        for i, tr in enumerate(trials):
            if tr.trial_id not in live:
                continue
            r = {"training_iteration": step, "trial_id": tr.trial_id,
                 "score": float(np.log10(tr.config["lr"]) * -0.3 * step ** 0.5 + noise[i, step])}
            tr.last_result = r
            tr.metrics_history.append(r)
            tr.latest_checkpoint_path = f"{tr.trial_id}/ck{step}"
            d = sched.on_trial_result(tr, r)
            log.append((tr.trial_id, step, d))
            if d == tune.STOP:
                live.discard(tr.trial_id)
                sched.on_trial_complete(tr, r)
            elif d == tune.PAUSE:
                live.discard(tr.trial_id)
            else:
                p = sched.choose_perturbation(tr, trials)
                if p:
                    log.append(("perturb", tr.trial_id, step, json.dumps(p, sort_keys=True)))
                    tr.config = p["config"]
                    if p.get("resources"):
                        tr.resources = p["resources"]
        for tid in getattr(sched, "trials_to_stop", lambda: [])():
            log.append(("stop", tid, step))
        for tid, budget in getattr(sched, "trials_to_resume", lambda: [])():
            log.append(("resume", tid, step, budget))
            live.add(tid)
    if hasattr(sched, "on_no_more_trials"):
        sched.on_no_more_trials()
        log.append(("end", sorted(sched.trials_to_stop()), sorted(sched.trials_to_resume())))
    return log


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("name", ["fifo", "asha", "asha-brackets", "median", "hyperband",
                                  "hyperband-bohb", "pbt", "pb2", "resource-changing"])
def test_schedulers_decide_and_perturb_equally(name, mode, tmp_path):
    logs = [_drive(tune, tm, _schedulers(tune)[name], tmp_path, mode) for tune, tm in PACKAGES]
    assert logs[0] == logs[1]
    assert len(logs[0]) >= 6


# ------------------------------------------------------------------------ (d)

_RUN_ID = re.compile(r"[0-9a-f]{32}")


def _tree(root):
    """{relative path: lines} of every file under root, with each MLflow
    run id put as its run's name, the root path and millisecond times taken
    out."""
    names = {}
    for d, _, files in os.walk(root):
        if _RUN_ID.fullmatch(os.path.basename(d)) and "meta.yaml" in files:
            with open(os.path.join(d, "meta.yaml")) as f:
                names[os.path.basename(d)] = re.search(r"run_name: (\S+)", f.read()).group(1)
    run = lambda text: _RUN_ID.sub(lambda m: f"<run {names[m.group(0)]}>", text)  # noqa: E731
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            rel = run(os.path.relpath(path, root))
            with open(path) as f:
                text = run(f.read().replace(str(root), "<root>"))
            lines = []
            for line in text.splitlines():
                line = re.sub(r"^(start_time|end_time): \d+$", r"\1: <t>", line)
                line = re.sub(r"^\d{13} ", "<t> ", line)
                lines.append(line)
            out[rel] = lines
    return out


def test_logger_callbacks_write_equal_files(tmp_path):
    trees = []
    for tune, trial_mod in PACKAGES:
        root = tmp_path / tune.__name__
        cbs = [tune.JsonLoggerCallback(), tune.CSVLoggerCallback(),
               tune.MLflowLoggerCallback(str(root / "mlflow"), experiment_name="exp",
                                         tags={"team": "a"})]
        trials = [trial_mod.Trial(f"t{i}", {"lr": 0.1 * (i + 1), "opt": {"b": i}}, str(root / "exp"))
                  for i in range(3)]
        for tr in trials:
            for cb in cbs:
                cb.on_trial_start(tr)
        for step in range(1, 4):
            for tr in trials:
                r = {"loss": 1.0 / step + tr.config["lr"], "training_iteration": step,
                     "done": False, "nested": {"x": 1}, "tag": "s"}
                for cb in cbs:
                    cb.on_trial_result(tr, r)
        for cb in cbs:
            cb.on_trial_complete(trials[0])
            cb.on_trial_error(trials[1])
            cb.on_trial_complete(trials[2])
            cb.on_experiment_end(trials)
        trees.append(_tree(root))
        for name in ("WandbLoggerCallback", "CometLoggerCallback"):
            with pytest.raises(ImportError):
                getattr(tune, name)()
    assert trees[0] == trees[1]
    # per trial result.json, params.json, progress.csv; MLflow's experiment
    # meta.yaml, and per run meta.yaml, 2 params, 2 tags, 2 numeric metrics
    assert len(trees[0]) == 3 * 3 + 1 + 3 * (1 + 2 + 2 + 2)


# ------------------------------------------------------------------------ (e)

def _strip(obj):
    """Drop times and paths from a result or state tree."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if not re.search(r"time|timestamp|date|path|local_dir|hostname|pid", k)}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_tuner_fit_and_restore_match_jax(programs):
    jax_out, port_out = _program_outputs(programs)
    assert _strip(port_out["fit"]) == _strip(jax_out["fit"])
    assert _strip(port_out["state"]) == _strip(jax_out["state"])
    statuses = [t["status"] for t in port_out["state"]["trials"]]
    assert statuses == ["TERMINATED"] * 4
    steps = [len(r["history"]) for r in port_out["fit"]]
    assert steps[0] == 6 and min(steps) < 6  # ASHA stopped a trial early
    assert [len(t["checkpoint_paths"]) for t in port_out["state"]["trials"]] == steps
    assert port_out["can_restore"] and jax_out["can_restore"]
    restored = port_out["restored"]
    assert _strip(restored) == _strip(jax_out["restored"])
    assert _strip(port_out["restored_state"]) == _strip(jax_out["restored_state"])
    assert [r["config"] for r in restored] == [r["config"] for r in port_out["fit"]]
    # the running trial resumed from its step-1 checkpoint; the two never
    # suggested ran from the start
    assert [[m["resumed_from"] for m in r["history"]][-1] for r in restored] == [0, 2, 0, 0]
    assert [len(r["history"]) for r in restored] == [steps[0], 6, 6, 6]


def test_gpu_trials_run_in_the_gpu_pool_and_tpu_is_refused(cluster, tmp_path):
    from cluster_anywhere_tpu_torch.tune.tuner import _actor_resources

    def trainable(config):
        import os

        from cluster_anywhere_tpu_torch import tune

        tune.report({"view": os.environ.get("CUDA_VISIBLE_DEVICES")})

    assert _actor_resources({"gpu": 0.5}) == {"num_cpus": 1, "num_gpus": 0.5}
    assert _actor_resources({"cpu": 2, "gpu": 1, "disk": 1}) == {
        "num_cpus": 2, "num_gpus": 1, "resources": {"disk": 1}}
    with pytest.raises(ValueError, match="'gpu'"):
        ttune.with_resources(trainable, {"tpu": 1})
    with pytest.raises(ValueError, match="whole GPUs"):
        ttune.with_resources(trainable, {"gpu": 1.5})
    views = {}
    for res in ({"gpu": 0.5}, {"cpu": 1}):
        grid = ttune.Tuner(
            ttune.with_resources(trainable, res),
            tune_config=ttune.TuneConfig(max_concurrent_trials=1, time_budget_s=T),
            run_config=ttune.RunConfig(name=f"res{len(views)}", storage_path=str(tmp_path)),
        ).fit()
        assert grid.num_errors == 0
        views[json.dumps(res)] = grid[0].metrics["view"]
    # the GPU pool keeps the driver's view of the card; the CPU pool sees none
    assert views == {'{"gpu": 0.5}': os.environ.get("CUDA_VISIBLE_DEVICES"), '{"cpu": 1}': ""}


# ------------------------------------------------------------------------ (f)

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
            max_seq_len=64)


def test_asha_trials_train_like_jaxs_train_step(cluster, tmp_path):
    """Each trial trains the tiny model from the same JAX-initialised params
    on the same batches at its own learning rate; its reported losses equal
    JAX's make_train_step's to 2e-5 relative, for as many steps as ASHA let
    it run."""
    import jax
    import jax.numpy as jnp

    from cluster_anywhere_tpu.models import transformer as jtf
    from cluster_anywhere_tpu_torch.models import transformer as ttf

    b, steps, lrs = 2, 4, [1e-3, 3e-3, 1e-2]
    jcfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**TINY, dtype="float32")
    _, jinit = jtf.make_train_step(jcfg, None, learning_rate=lrs[0])
    jparams, _ = jinit(jax.random.key(7))
    params = jax.tree_util.tree_map(np.asarray, jparams)
    ids = np.random.default_rng(8).integers(0, TINY["vocab_size"], (b * steps, 33)).astype(np.int32)

    def trainable(config, cfg=None, params=None, ids=None):
        import sys

        import torch

        from cluster_anywhere_tpu_torch import tune
        from cluster_anywhere_tpu_torch.models import make_train_step
        from cluster_anywhere_tpu_torch.models.convert import from_jax_params

        step, init_state = make_train_step(cfg, learning_rate=config["lr"], device="cpu")
        model, opt = init_state(from_jax_params(params, cfg, device="cpu"))
        bsz = len(ids) // 4
        for s in range(4):
            batch = {"ids": torch.from_numpy(ids[s * bsz:(s + 1) * bsz]).long()}
            model, opt, loss = step(model, opt, batch)
            tune.report({"loss": loss.item(), "jax_loaded": "jax" in sys.modules})

    grid = ttune.Tuner(
        ttune.with_parameters(trainable, cfg=tcfg, params=params, ids=ids),
        param_space={"lr": ttune.grid_search(lrs)},
        tune_config=ttune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=1, time_budget_s=T,
            scheduler=ttune.ASHAScheduler(max_t=steps, grace_period=1, reduction_factor=2)),
        run_config=ttune.RunConfig(name="slice", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0
    assert [r.config["lr"] for r in grid] == lrs
    ran = [len(r.metrics_history) for r in grid]
    assert ran[0] == steps and min(ran) < steps  # ASHA stopped a trial
    for r in grid:
        jstep, jinit = jtf.make_train_step(jcfg, None, learning_rate=r.config["lr"])
        jstep = jax.jit(jstep)
        p, o = jinit(jax.random.key(7))
        for m, s in zip(r.metrics_history, range(steps)):
            p, o, jloss = jstep(p, o, {"ids": jnp.asarray(ids[s * b:(s + 1) * b])})
            assert not m["jax_loaded"]
            assert abs(m["loss"] - float(jloss)) <= 2e-5 * abs(float(jloss)), (r.config, s)
