"""The port's Train library (cluster_anywhere_tpu_torch.train) against the
JAX package's (cluster_anywhere_tpu.train), on the CPU: use_gpu=False,
device="cpu" in the loops, the plain attention.

- (a) every field of the JAX configs constructs in the port;
- (b) checkpoints: the same seeded numpy tree saved by both packages gives
  equal .npz members; a sharded save on a 4-process gloo mesh (fsdp2 x
  tp2) writes the chunk boxes JAX writes from its virtual CPU devices; the
  8 -> 6 -> 8 reshard roundtrip of tests/test_train.py; JAX's leaf order;
- (c) one numpy-only program under each package's DataParallelTrainer, in
  subprocesses of their own (started by the test's own fixture):
  report, keep-K, a failure retried from the checkpoint, failures
  exhausted, elastic shrink;
- (d) the slice as a whole: TorchTrainer trains a tiny model 3 steps on
  cad.from_numpy rows, held to JAX's make_train_step on the same params and
  rows, with and without an injected failure;
- (e) 2 workers on an fsdp2 mesh (TorchConfig) save a sharded checkpoint,
  and 1 worker resumes from it.

Train loops are nested in their tests, so that they travel to the workers
by value.  Every wait is bounded.
"""

import ast
import dataclasses
import glob
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import cluster_anywhere_tpu_torch as ca
import cluster_anywhere_tpu_torch.data as cad
from cluster_anywhere_tpu import train as jtrain
from cluster_anywhere_tpu.models import transformer as jtf
from cluster_anywhere_tpu_torch import train
from cluster_anywhere_tpu_torch.models import transformer as ttf
from cluster_anywhere_tpu_torch.models.convert import from_jax_params, to_jax_params
from cluster_anywhere_tpu_torch.parallel.mesh import AXES
from cluster_anywhere_tpu_torch.parallel.sharding import P
from cluster_anywhere_tpu_torch.train.checkpoint import tree_flatten
import torch_train_cases as cases
from torch_dist_pool import RankPool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 90  # seconds: the bound on every wait of this file
ADAM_EPS = 1e-8  # make_train_step's AdamW eps (optax.adamw's default)
TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
            max_seq_len=64)


# ---------------------------------------------------------------- (c)'s program

PROGRAM = r"""
import importlib, os, pickle, signal, sys
import numpy as np

pkg, storage, out_path = sys.argv[1:4]
ca = importlib.import_module(pkg)
train = importlib.import_module(pkg + ".train")
cpu = {"use_gpu": False} if pkg.endswith("_torch") else {}


def _terminated(signum, frame):
    raise SystemExit(128 + signum)  # unwinds to the finally below: ca.shutdown()


signal.signal(signal.SIGTERM, _terminated)


def fit(loop, name, config=None, **kw):
    scaling = kw.pop("scaling", None) or train.ScalingConfig(num_workers=1, **cpu)
    try:
        r = train.DataParallelTrainer(
            loop, train_loop_config=config, scaling_config=scaling,
            run_config=train.RunConfig(name=name, storage_path=storage, **kw)).fit()
    except train.TrainingFailedError as e:
        return {"error": type(e).__name__, "message": str(e).splitlines()[0].split(":")[0]}
    kept = sorted(int(c.load_pytree()["step"]) for c, _ in r.best_checkpoints)
    return {"metrics": r.metrics, "history": r.metrics_history, "kept": kept,
            "latest": int(r.checkpoint.load_pytree()["step"]) if r.checkpoint else None}


def keep_k(config):
    for step in range(4):
        c = train.Checkpoint(train.make_temp_checkpoint_dir())
        c.save_pytree({"step": np.array(step), "w": np.arange(3.0) * step})
        train.report({"loss": 1.0 / (step + 1), "step": step, "parity": step % 2}, checkpoint=c)


def retry(config):
    start = 0
    ck = train.get_checkpoint()
    if ck is not None:
        start = int(ck.load_pytree()["step"]) + 1
    for step in range(start, 5):
        c = train.Checkpoint(train.make_temp_checkpoint_dir())
        c.save_pytree({"step": np.array(step)})
        train.report({"step": step, "attempt": train.get_context().attempt,
                      "resumed_from": start}, checkpoint=c)
        if step == 2 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError("injected failure")


def boom(config):
    raise ValueError("boom")


def elastic(config):
    train.report({"n": train.get_context().get_world_size(),
                  "rank": train.get_context().get_world_rank()})


try:
    ca.init(num_cpus=4)
    out = {
        "keep_k": fit(keep_k, "keepk", {}, checkpoint_config=train.CheckpointConfig(
            num_to_keep=2, checkpoint_score_attribute="loss", checkpoint_score_order="min")),
        "retry": fit(retry, "retry", {"marker": os.path.join(storage, "marker")},
                     failure_config=train.FailureConfig(max_failures=1)),
        "exhausted": fit(boom, "boom", {}, failure_config=train.FailureConfig(max_failures=1)),
        "elastic": fit(elastic, "elastic", {}, scaling=train.ScalingConfig(
            num_workers=8, min_workers=1, max_workers=8, **cpu)),
    }
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
finally:
    ca.shutdown()
"""
SHUTDOWN_WAIT = 30  # seconds a program has for its ca.shutdown() after SIGTERM


@pytest.fixture(scope="module", autouse=True)
def cluster():
    """The port's cluster for this file (no GPU)."""
    if ca.is_initialized():
        ca.shutdown()
    info = ca.init(num_cpus=4, num_gpus=0)
    try:
        yield {"info": info}
    finally:
        ca.shutdown()


@pytest.fixture
def programs(tmp_path):
    """(c)'s two programs, one under each package.  At teardown a program
    still running gets SIGTERM, which it answers with ca.shutdown(), and
    is killed only after SHUTDOWN_WAIT seconds: however the file is
    filtered, no session of theirs outlives the run."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = {}
    try:
        for pkg in ("cluster_anywhere_tpu", "cluster_anywhere_tpu_torch"):
            os.makedirs(tmp_path / f"{pkg}_storage")
            procs[pkg] = subprocess.Popen(
                [sys.executable, "-c", PROGRAM, pkg, str(tmp_path / f"{pkg}_storage"),
                 str(tmp_path / pkg)],
                env=env, cwd="/", stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        yield {"procs": procs, "dir": tmp_path}
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


# ------------------------------------------------------------------------ (a)

@pytest.mark.parametrize("name", ["ScalingConfig", "RunConfig", "CheckpointConfig",
                                  "FailureConfig", "TorchConfig"])
def test_every_jax_config_field_constructs(name):
    jcls, tcls = getattr(jtrain, name), getattr(train, name)
    samples = {
        "ScalingConfig": dict(num_workers=3, chips_per_worker=4, cpus_per_worker=2.0,
                              resources_per_worker={"disk": 1.0}, placement_strategy="SPREAD",
                              label_selector={"zone": "a"}, min_workers=1, max_workers=4),
        "RunConfig": dict(name="r", storage_path="/x", verbose=1,
                          failure_config=train.FailureConfig(max_failures=2)),
        "CheckpointConfig": dict(num_to_keep=3, checkpoint_score_attribute="loss",
                                 checkpoint_score_order="min"),
        "FailureConfig": dict(max_failures=-1, drain_aware=False, preempt_barrier_timeout_s=3.0),
        "TorchConfig": dict(backend="gloo", port=1234, timeout_s=60.0),
    }[name]
    for kw in ({f.name: getattr(jcls(), f.name) for f in dataclasses.fields(jcls)}, samples):
        got = tcls(**kw)
        assert all(getattr(got, k) == v for k, v in kw.items()), kw
    jax_only = {f.name for f in dataclasses.fields(jcls)} - {f.name for f in dataclasses.fields(tcls)}
    assert not jax_only


def test_scaling_config_asks_for_the_gpu():
    assert train.ScalingConfig().bundle() == {"CPU": 1.0, "GPU": 1.0}
    assert train.ScalingConfig(gpus_per_worker=0.25).bundle()["GPU"] == 0.25
    assert train.ScalingConfig(use_gpu=False).bundle() == {"CPU": 1.0}
    with pytest.raises(ValueError, match="use_gpu"):
        train.ScalingConfig(use_tpu=True)
    with pytest.raises(ValueError, match="whole GPUs"):
        train.ScalingConfig(gpus_per_worker=1.5)
    assert not hasattr(train, "JaxTrainer") and not hasattr(train, "JaxConfig")
    assert isinstance(train.TorchTrainer(lambda: None).backend_config, train.TorchConfig)
    assert train.TorchConfig().backend == "gloo"


def test_fit_without_a_gpu_raises_naming_it_and_starts_no_worker():
    from cluster_anywhere_tpu_torch.util import state

    before = (len(state.list_actors()), len(state.list_placement_groups()))
    for scaling in (train.ScalingConfig(), train.ScalingConfig(num_workers=2, gpus_per_worker=0.5)):
        with pytest.raises(ValueError, match=r"need \d+ GPU, and the cluster has 0 GPU"):
            train.TorchTrainer(lambda: None, scaling_config=scaling).fit()
    assert (len(state.list_actors()), len(state.list_placement_groups())) == before


def test_report_refuses_a_cuda_tensor(tmp_path):
    """A CUDA tensor in a report's metrics is kept (the refusal this test
    was named for went with the port of device objects), and the polled
    reports carry it to the driver through the transport."""
    from cluster_anywhere_tpu_torch.core import serialization
    from cluster_anywhere_tpu_torch.train.session import TrainContext, _Session

    class FakeCuda(torch.Tensor):
        is_cuda = property(lambda self: True)

    s = _Session(TrainContext(1, 0, 0, 0, "x", str(tmp_path), str(tmp_path)))
    loss = torch.ones(()).as_subclass(FakeCuda)
    s.report({"loss": loss})
    s.report({"loss": 1.0})
    reports = s.drain_reports()
    assert reports[0]["metrics"]["loss"] is loss and reports[1]["metrics"] == {"loss": 1.0}
    landed = serialization.unpack(serialization.pack(reports))[0]["metrics"]["loss"]
    assert type(landed) is torch.Tensor and landed.item() == 1.0


def test_the_port_imports_nothing_of_jax():
    """No module of the port, nor chip_smoke.py, imports jax, jaxlib or the
    JAX package (its tests are the only place both meet)."""
    files = glob.glob(os.path.join(REPO, "cluster_anywhere_tpu_torch", "**", "*.py"), recursive=True)
    bad = []
    for path in files + [os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "cluster_anywhere_tpu"):
                    bad.append((os.path.relpath(path, REPO), n))
    assert len(files) > 80 and not bad, bad


# ------------------------------------------------------------------------ (b)

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {  # keys out of order: both packages flatten sorted
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "b": [rng.integers(0, 9, 5), (np.float32(2.5), None, rng.standard_normal(2))],
        "a": {"z": np.int64(7), "y": rng.standard_normal((2, 2, 2)).astype(np.float32)},
    }


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_save_pytree_writes_the_jax_packages_npz(tmp_path):
    tree = _tree()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    (tmp_path / "torch").mkdir()
    jtrain.Checkpoint(str(tmp_path / "jax")).save_pytree(tree)
    train.Checkpoint(str(tmp_path / "port")).save_pytree(tree)
    as_tensors = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.asarray(x)) if np.ndim(x) else x, tree)
    train.Checkpoint(str(tmp_path / "torch")).save_pytree(as_tensors)
    want = _npz(tmp_path / "jax" / "state.npz")
    for d in ("port", "torch"):
        got = _npz(tmp_path / d / "state.npz")
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (d, k)
    back = train.Checkpoint(str(tmp_path / "port")).load_pytree()
    jback = jtrain.Checkpoint(str(tmp_path / "jax")).load_pytree()
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jback)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jback)):
        assert np.array_equal(a, b)
    # the structure files are the packages' own
    with pytest.raises(pickle.UnpicklingError, match="not interchangeable"):
        train.Checkpoint(str(tmp_path / "jax")).load_pytree()


def test_flatten_follows_jax_leaf_order():
    tree = {"c": [3, {"y": 4, "x": 5}], "a": (1, None, 2), "b": {"k": 6, "j": {"q": 7}}}
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree) == [1, 2, 7, 6, 3, 5, 4]
    assert len(leaves) == jax.tree_util.tree_structure(tree).num_leaves
    with pytest.raises(TypeError, match="bfloat16"):
        train.Checkpoint("/nonexistent").save_pytree({"x": torch.ones(2, dtype=torch.bfloat16)})


SHARDED_SPECS = {"w": ("fsdp", "tp"), "b": ("tp",), "e": (None, "fsdp"), "r": ()}


def _sharded_tree():
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal(6).astype(np.float32),
            "e": rng.standard_normal((3, 4)).astype(np.float32),
            "r": rng.standard_normal(5).astype(np.float32),
            "step": np.int64(3)}


def _chunks(d, name="state"):
    """{leaf: sorted [(box, bytes)]} over every shard file of a sharded save."""
    out = {}
    for m in sorted(glob.glob(os.path.join(d, f"{name}.shard*.json"))):
        with open(m) as f:
            man = json.load(f)
        arrays = _npz(m[:-len(".json")] + ".npz")
        for c in man["chunks"]:
            out.setdefault(c["leaf"], []).append((c["box"], arrays[c["key"]].tobytes()))
    return {k: sorted(v) for k, v in out.items()}


def test_sharded_save_writes_jaxs_chunk_boxes(tmp_path):
    """fsdp2 x tp2: the port's 4 gloo ranks each write their replica-0
    shards; JAX writes the same boxes (from one process over 4 of its
    virtual devices).  The indexes agree but for world_size, the number of
    writing processes (JAX 1, the port 4)."""
    tree = _sharded_tree()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("fsdp", "tp"))
    jtree = {k: jax.device_put(v, NamedSharding(mesh, JP(*SHARDED_SPECS[k])))
             if k in SHARDED_SPECS else v for k, v in tree.items()}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jtrain.Checkpoint(str(tmp_path / "jax")).save_pytree_sharded(jtree)
    pool = RankPool(4)
    try:
        assert pool.run(cases.save_sharded, tree, SHARDED_SPECS, {"fsdp": 2, "tp": 2},
                        str(tmp_path / "port"), deadline=T) == [True] * 4
    finally:
        pool.close()
    assert _chunks(tmp_path / "port") == _chunks(tmp_path / "jax")
    assert len(glob.glob(str(tmp_path / "port" / "state.shard*.npz"))) == 4
    with open(tmp_path / "jax" / "state.index.json") as f:
        jindex = json.load(f)
    with open(tmp_path / "port" / "state.index.json") as f:
        index = json.load(f)
    assert (jindex.pop("world_size"), index.pop("world_size")) == (1, 4)
    assert index == jindex
    back = train.Checkpoint(str(tmp_path / "port")).load_pytree_sharded()
    assert all(np.array_equal(back[k], tree[k]) for k in tree)


class _RankMesh:
    """One rank's view of a mesh with the AXES dims, which is all a sharded
    checkpoint reads: the dims' sizes, this rank's coordinate and the device
    type.  It lets one process play every rank of an 8- and a 6-rank world."""

    mesh_dim_names = AXES
    device_type = "cpu"

    def __init__(self, fsdp, rank):
        self.mesh = np.zeros((1, fsdp, 1, 1, 1, 1))
        self._coord = [0, rank, 0, 0, 0, 0]

    def get_coordinate(self):
        return self._coord


def _save_world(path, w, b, world):
    specs = {"w": P("fsdp"), "b": None, "step": None}
    rows = w.shape[0] // world
    for r in range(world):
        local = {"w": torch.from_numpy(w[r * rows:(r + 1) * rows]), "b": torch.from_numpy(b),
                 "step": np.int64(5)}
        train.Checkpoint(path).save_pytree_sharded(local, process_index=r, num_processes=world,
                                                   mesh=_RankMesh(world, r), specs=specs)
    return specs


def _load_world(path, w, b, world, specs):
    rows = w.shape[0] // world
    for r in range(world):
        t = train.Checkpoint(path).load_pytree_sharded(mesh=_RankMesh(world, r), specs=specs)
        assert torch.equal(t["w"], torch.from_numpy(w[r * rows:(r + 1) * rows]))
        assert torch.equal(t["b"], torch.from_numpy(b)) and int(t["step"]) == 5


def test_reshard_roundtrip_8_to_6_to_8(tmp_path):
    """tests/test_train.py's roundtrip in the port: save at 8 ranks, restore
    at 6 (6-row chunks stitched into 8-row shards), save at 6, restore at
    8, and the host read; a stale larger-world shard is swept; a missing
    rank's shard raises instead of zero-filling."""
    w = np.arange(48 * 4, dtype=np.float32).reshape(48, 4)
    b = np.arange(4, dtype=np.float32)
    d8, d6 = str(tmp_path / "ck8"), str(tmp_path / "ck6")
    os.makedirs(d8)
    os.makedirs(d6)
    specs = _save_world(d8, w, b, 8)
    host = train.Checkpoint(d8).load_pytree_sharded()
    assert np.array_equal(host["w"], w) and np.array_equal(host["b"], b) and int(host["step"]) == 5
    assert len(glob.glob(os.path.join(d8, "state.shard*.npz"))) == 8
    _load_world(d8, w, b, 6, specs)
    _save_world(d6, w, b, 6)
    _load_world(d6, w, b, 8, specs)
    stale = os.path.join(d8, "state.shard7.json")
    _save_world(d8, w, b, 1)  # world 1 into the 8-rank dir: sweeps shards 1-7
    assert not os.path.exists(stale)
    assert np.array_equal(train.Checkpoint(d8).load_pytree_sharded()["w"], w)
    os.unlink(os.path.join(d8, "state.shard0.npz"))
    os.unlink(os.path.join(d8, "state.shard0.json"))
    with pytest.raises(ValueError, match="not fully covered"):
        train.Checkpoint(d8).load_pytree_sharded()


# ------------------------------------------------------------------------ (d)

def _tiny_pair(seed=7):
    jcfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**TINY, dtype="float32")
    return jcfg, tcfg


def _tiny_loop():
    def loop(config):
        import os
        import sys

        import torch

        from cluster_anywhere_tpu_torch import train
        from cluster_anywhere_tpu_torch.models import load_train_state, make_train_step, train_state
        from cluster_anywhere_tpu_torch.models.convert import from_jax_params, to_jax_params

        torch.set_num_threads(1)
        cfg = config["cfg"]
        step, init_state = make_train_step(cfg, learning_rate=config["lr"], device="cpu")
        model, opt = init_state(from_jax_params(config["params"], cfg, device="cpu"))
        start = 0
        ck = train.get_checkpoint()
        if ck is not None:
            tree = ck.load_pytree()
            load_train_state(model, opt, tree)
            start = int(tree["opt"]["count"])
        shard = train.get_dataset_shard("train")
        batches = [b["data"] for b in shard.iter_torch_batches(batch_size=config["b"], device="cpu")]
        for s in range(start + 1, config["steps"] + 1):
            _, _, loss = step(model, opt, {"ids": batches[s - 1]})
            c = train.Checkpoint(train.make_temp_checkpoint_dir())
            c.save_pytree(train_state(model, opt))
            train.report({"step": s, "loss": loss.item(), "attempt": train.get_context().attempt,
                          "jax_loaded": [m in sys.modules for m in ("jax", "cluster_anywhere_tpu")]},
                         checkpoint=c)
            if s == config.get("fail_after") and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("injected failure")

    return loop


def test_torch_trainer_trains_like_jaxs_train_step(tmp_path):
    """3 AdamW steps of TorchTrainer (1 worker, rows from cad.from_numpy)
    against JAX's make_train_step on the same params and rows: losses to
    2e-5 relative; the final checkpoint's params equal to the same steps
    run in this process by the port's make_train_step, bit for bit (the
    Train library must not change the computation), and to JAX's within
    tests/test_torch_train.py::test_adamw_steps_match_jax's limits (1e-7 +
    2e-6 relative, 3 * lr where a gradient is within rounding noise of
    zero).  Here that band also takes the elements whose gradient on some
    step is within 100x Adam's eps (1e-8) of zero: there the update
    lr * g / (|g| + eps) follows the gradient's last bits, and this size
    has a few (3 of 16,384 in w_down and w_up, off by up to 1.1e-6) that
    miss the 1e-7 relative band by the plain steps alone, trainer or not.
    The same fit with a failure after step 2, restarted from step 2's
    checkpoint, gives the same losses."""
    lr, b, steps = 3e-4, 2, 3
    jcfg, tcfg = _tiny_pair()
    jstep, jinit = jtf.make_train_step(jcfg, None, learning_rate=lr)
    jparams, jopt = jinit(jax.random.key(7))
    params = jax.tree_util.tree_map(np.asarray, jparams)
    ids = np.random.default_rng(8).integers(0, TINY["vocab_size"], (b * steps, 33))
    jstep, jgrad = jax.jit(jstep), jax.jit(jax.grad(jtf.make_loss_fn(jcfg)))
    jlosses, near_zero = [], {}
    for i in range(steps):
        batch = {"ids": jnp.asarray(ids[i * b:(i + 1) * b].astype(np.int32))}
        grads = jgrad(jparams, batch)
        for name, g in _leaves(grads).items():
            noise = np.maximum(1e-7 * np.abs(g).max(), 100 * ADAM_EPS)
            near_zero[name] = near_zero.get(name, False) | (np.abs(g) <= noise)
        jparams, jopt, jloss = jstep(jparams, jopt, batch)
        jlosses.append(float(jloss))
    tstep, tinit = ttf.make_train_step(tcfg, learning_rate=lr, device="cpu")
    model, opt = tinit(from_jax_params(params, tcfg, device="cpu"))
    for i in range(steps):
        model, opt, _ = tstep(model, opt, {"ids": torch.from_numpy(ids[i * b:(i + 1) * b])})
    in_process = _leaves(to_jax_params(model))
    config = {"cfg": tcfg, "params": params, "lr": lr, "b": b, "steps": steps,
              "marker": str(tmp_path / "marker")}
    results = {}
    for name, extra in (("clean", {}), ("failing", {"fail_after": 2})):
        results[name] = train.TorchTrainer(
            _tiny_loop(), train_loop_config=dict(config, **extra),
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=False),
            run_config=train.RunConfig(name=name, storage_path=str(tmp_path),
                                       failure_config=train.FailureConfig(max_failures=1)),
            datasets={"train": cad.from_numpy(ids)}).fit()
    clean = results["clean"].metrics_history
    assert [m["step"] for m in clean] == [1, 2, 3]
    assert all(m["jax_loaded"] == [False, False] for m in clean)
    for m, want in zip(clean, jlosses):
        assert abs(m["loss"] - want) <= 2e-5 * abs(want), (m, want)
    failing = results["failing"].metrics_history
    assert [(m["attempt"], m["step"]) for m in failing] == [(0, 1), (0, 2), (1, 3)]
    assert [m["loss"] for m in failing] == [m["loss"] for m in clean]
    for result in results.values():
        tree = result.checkpoint.load_pytree()
        assert int(tree["opt"]["count"]) == steps
        got, want = _leaves(tree["params"]), _leaves(jparams)
        for name in want:
            assert np.array_equal(got[name], in_process[name]), name
            diff = np.abs(got[name] - want[name])
            ok = diff <= 1e-7 + 2e-6 * np.abs(want[name])
            ok |= near_zero[name] & (diff <= 3 * lr)
            assert ok.all(), (name, diff.max())
            assert near_zero[name].mean() < 0.02 or name == "embed", name


def _leaves(tree):
    out = {n: np.asarray(tree[n]) for n in ("embed", "ln_f", "lm_head")}
    out.update({n: np.asarray(a) for n, a in tree["blocks"].items()})
    return out


# ------------------------------------------------------------------------ (e)

def _sharded_loop():
    def loop(config):
        import torch

        from cluster_anywhere_tpu_torch import train
        from cluster_anywhere_tpu_torch.models import (load_train_state, make_train_step,
                                                       train_state, train_state_specs)
        from cluster_anywhere_tpu_torch.parallel.mesh import MeshSpec, make_mesh

        torch.set_num_threads(1)
        cfg = config["cfg"]
        mesh = make_mesh(MeshSpec(**config["axes"]), device="cpu")
        step, init_state = make_train_step(cfg, mesh)
        model, opt = init_state(0)
        specs = train_state_specs(cfg)
        start = 0
        ck = train.get_checkpoint()
        if ck is not None:
            load_train_state(model, opt, ck.load_pytree_sharded(mesh=mesh, specs=specs))
            start = int(float(opt.state[model.embed]["step"]))
        ids = torch.tensor(config["ids"])
        for s in range(start + 1, config["steps"] + 1):
            _, _, loss = step(model, opt, {"ids": ids})
            ckpt = None
            if s == config.get("ckpt_at"):
                ckpt = train.Checkpoint(train.shared_checkpoint_dir(s))
                ckpt.save_pytree_sharded(train_state(model, opt), mesh=mesh, specs=specs)
            train.report({"step": s, "loss": loss.item(),
                          "world": torch.distributed.get_world_size()}, checkpoint=ckpt)

    return loop


def test_sharded_checkpoint_resumes_on_another_world(tmp_path):
    """2 workers (TorchConfig's gloo group) train on an fsdp2 mesh and save
    after step 2 with save_pytree_sharded; 1 worker resumes from it through
    load_pytree_sharded and takes step 3 with the 2-worker run's loss
    (1e-5 relative)."""
    _, tcfg = _tiny_pair()
    ids = np.random.default_rng(9).integers(0, TINY["vocab_size"], (4, 33))
    config = {"cfg": tcfg, "ids": ids, "steps": 3}
    runs = {}
    for name, workers, extra in (("two", 2, {"axes": {"fsdp": 2}, "ckpt_at": 2}),
                                 ("one", 1, {"axes": {}})):
        runs[name] = train.TorchTrainer(
            _sharded_loop(), train_loop_config=dict(config, **extra),
            scaling_config=train.ScalingConfig(num_workers=workers, use_gpu=False),
            run_config=train.RunConfig(name=name, storage_path=str(tmp_path)),
            resume_from_checkpoint=runs["two"].checkpoint if name == "one" else None).fit()
    two, one = runs["two"].metrics_history, runs["one"].metrics_history
    assert [(m["step"], m["world"]) for m in two] == [(1, 2), (2, 2), (3, 2)]
    assert [(m["step"], m["world"]) for m in one] == [(3, 1)]
    assert runs["two"].checkpoint.is_sharded()
    assert len(glob.glob(os.path.join(runs["two"].checkpoint.path, "state.shard*.npz"))) == 2
    assert abs(one[0]["loss"] - two[2]["loss"]) <= 1e-5 * abs(two[2]["loss"])


# ------------------------------------------------------------------------ (c)

def test_trainer_program_gives_the_jax_packages_results(programs):
    """The same numpy-only program under both packages' DataParallelTrainer:
    equal Result.metrics, metrics history, kept checkpoints and restart."""
    out = {}
    for pkg, p in programs["procs"].items():
        _, err = p.communicate(timeout=T)
        assert p.returncode == 0, (pkg, err[-3000:])
        with open(programs["dir"] / pkg, "rb") as f:
            out[pkg] = pickle.load(f)
    jax_out, port = out["cluster_anywhere_tpu"], out["cluster_anywhere_tpu_torch"]
    assert port == jax_out
    assert port["keep_k"]["kept"] == [2, 3] and port["keep_k"]["latest"] == 3
    # the failure after step 2's report: the retry resumes after step 2
    assert [m["step"] for m in port["retry"]["history"]] == [0, 1, 2, 3, 4]
    assert port["retry"]["history"][3] == {"step": 3, "attempt": 1, "resumed_from": 3}
    assert port["exhausted"]["error"] == "TrainingFailedError"
    assert 1 <= port["elastic"]["metrics"]["n"] <= 4
