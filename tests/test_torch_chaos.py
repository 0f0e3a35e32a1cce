"""The port's fault injection (cluster_anywhere_tpu_torch.util.chaos)
against the JAX package's (cluster_anywhere_tpu.util.chaos), on the CPU.

- WorkerKiller under load, an actor restarting after a kill, and a
  NetworkPartition that severs a node (death verdict, the work resubmitted
  to the survivors, the node rejoining at a fresh incarnation after the
  scheduled heal) run as one program under each package, in subprocesses
  of their own started with the file; the outcomes must be equal.
- PreemptionSimulator against the Train library's drain-aware controller:
  a 2-worker TorchTrainer on the CPU (gloo) across two nodes; the
  simulator warns one node mid-run and the run checkpoints at the step
  barrier, restarts budget-exempt at world 1 on the survivor, resumes from
  the checkpoint written at world 2 and loses no step.  These are the
  assertions of tests/test_train.py::test_preempt_elastic_shrink_resume,
  one of the reference's unsteady tests (ROADMAP Queue 3), so no JAX side
  runs.

Every wait is bounded.
"""

import os
import threading
import time

import pytest
from torch_programs import run_under_each_package

T = 150  # seconds: the bound on every wait of this file

PROGRAM = r"""
import importlib, os, pickle, signal, sys, time

pkg, scratch, out_path = sys.argv[1:4]
ca = importlib.import_module(pkg)
chaos = importlib.import_module(pkg + ".util.chaos")
Cluster = importlib.import_module(pkg + ".cluster_utils").Cluster
CAConfig = importlib.import_module(pkg + ".core.config").CAConfig
Affinity = importlib.import_module(
    pkg + ".core.scheduling_strategies").NodeAffinitySchedulingStrategy
port = pkg.endswith("_torch")
cpu = {"num_gpus": 0} if port else {}


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


signal.signal(signal.SIGTERM, _terminated)


def worker_killer():
    def work(i):
        time.sleep(0.05)
        return i * i

    killer = chaos.WorkerKiller(period_s=0.4, max_kills=4).start()
    try:
        got = ca.get([ca.remote(max_retries=5)(work).remote(i) for i in range(200)], timeout=120)
    finally:
        killer.stop()
    return [got == [i * i for i in range(200)], killer.kills >= 1, killer.kills <= 4]


def actor_restart():
    class Svc:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return os.getpid(), self.n

    a = ca.remote(max_restarts=2)(Svc).remote()
    pid1, n1 = ca.get(a.bump.remote(), timeout=30)
    os.kill(pid1, signal.SIGKILL)
    deadline, got = time.time() + 30, None
    while time.time() < deadline:
        try:
            got = ca.get(a.bump.remote(), timeout=10)
            if got[0] != pid1:
                break
        except Exception:
            time.sleep(0.2)
    return [n1, got is not None and got[0] != pid1, got[1] if got else None]


def partition():
    cfg = CAConfig()
    cfg.health_check_period_s = 0.5
    cfg.health_check_failure_threshold = 3
    c = Cluster(head_resources={"CPU": 2}, config=cfg)
    try:
        nid = c.add_node(num_cpus=2)
        c.connect()
        c.wait_for_nodes(2, timeout=60)
        inc0 = next(n for n in ca.nodes() if n["node_id"] == nid)["incarnation"]

        def work(i, s):
            time.sleep(s)
            return i

        refs = [ca.remote(max_retries=5)(work).remote(i, 2.0) for i in range(6)]
        time.sleep(0.4)
        part = chaos.NetworkPartition(nid, "n0", duration_s=4.0, seed=7).start()
        spec = part.spec
        deadline, row = time.time() + 30, None
        while time.time() < deadline:
            row = next((n for n in ca.nodes() if n["node_id"] == nid), None)
            if row is None or not row["alive"]:
                break
            time.sleep(0.05)
        verdict = row is None or not row["alive"]
        done = ca.get(refs, timeout=120) == list(range(6))
        part.wait_heal()
        deadline, row = time.time() + 40, None
        while time.time() < deadline:
            row = next((n for n in ca.nodes() if n["node_id"] == nid), None)
            if row is not None and row["alive"] and row["incarnation"] > inc0:
                break
            time.sleep(0.1)
        rejoined = row is not None and row["alive"] and row["incarnation"] > inc0
        part.clear()

        def where():
            return os.environ.get("CA_NODE_ID", "n0")

        after = ca.get(ca.remote(where).options(scheduling_strategy=Affinity(nid)).remote(),
                       timeout=60)
        return [spec, round(part.heals_at() - part.epoch, 3), verdict, done, rejoined, after == nid]
    finally:
        c.shutdown()


out = {}
try:
    ca.init(num_cpus=4, **cpu)
    for name, fn in (("worker_killer", worker_killer), ("actor_restart", actor_restart)):
        try:
            out[name] = {"result": fn()}
        except Exception as e:
            out[name] = {"raised": repr(e)}
    ca.shutdown()
    try:
        out["partition"] = {"result": partition()}
    except Exception as e:
        out["partition"] = {"raised": repr(e)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
finally:
    ca.shutdown()
"""


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """The program under each package, one after the other
    (tests/torch_programs.py)."""
    return run_under_each_package(PROGRAM, tmp_path_factory.mktemp("chaos_programs"), timeout=T)


def _outputs(programs):
    jax_out, port_out = programs["cluster_anywhere_tpu"], programs["cluster_anywhere_tpu_torch"]
    assert "error" not in jax_out and "error" not in port_out, (jax_out.get("error"),
                                                                port_out.get("error"))
    return jax_out, port_out


EXPECTED = {
    "worker_killer": [True, True, True],
    "actor_restart": [1, True, 1],  # a fresh instance on the restart
    "partition": ["seed=7;{nid}<>n0:blackhole@0.2+4.0", 4.2, True, True, True, True],
}


@pytest.mark.parametrize("name", ["worker_killer", "actor_restart", "partition"])
def test_chaos_matches_jax(name, programs):
    jax_out, port_out = _outputs(programs)
    assert "raised" not in port_out[name], port_out[name]
    assert port_out[name] == jax_out[name]
    want = EXPECTED[name]
    if name == "partition":
        want = [want[0].format(nid="node1")] + want[1:]
    assert port_out[name]["result"] == want


def test_chaos_exports_match_jax():
    import cluster_anywhere_tpu.util.chaos as jc
    import cluster_anywhere_tpu_torch.util.chaos as tc

    for name in ("WorkerKiller", "NetworkPartition", "PreemptionSimulator"):
        assert hasattr(tc, name) and hasattr(jc, name)
    args = ("a", "b", 3.0, 5, 0.5)
    assert tc.NetworkPartition(*args).spec == jc.NetworkPartition(*args).spec
    assert vars(tc.PreemptionSimulator("x")).keys() == vars(jc.PreemptionSimulator("x")).keys()


def _running(pid):
    """The process exists and is not a zombie awaiting its parent's wait."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def test_preemption_simulator_shrinks_a_torch_trainer_to_its_survivor(tmp_path):
    """PreemptionSimulator warns one node of a 2-worker gang: the run
    checkpoints at the step barrier, restarts budget-exempt
    (max_failures=0 still succeeds), re-forms at world 1 on the survivor,
    resumes from the sharded checkpoint written at world 2 and loses no
    step; the warned agent drains and exits inside the warning window."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch import train
    from cluster_anywhere_tpu_torch.cluster_utils import Cluster
    from cluster_anywhere_tpu_torch.core.worker import TRAIN_STATS
    from cluster_anywhere_tpu_torch.util.chaos import PreemptionSimulator
    from cluster_anywhere_tpu_torch.util.state import train_plane

    if ca.is_initialized():
        ca.shutdown()
    c = Cluster(head_resources={"CPU": 0})
    sims = []
    try:
        n1 = c.add_node(num_cpus=1)
        c.add_node(num_cpus=1)
        c.connect()
        c.wait_for_nodes(3, timeout=60)
        go = str(tmp_path / "go")
        stats0 = dict(TRAIN_STATS)

        def loop(config):
            import time as _t

            import numpy as _np
            import torch.distributed as _dist

            from cluster_anywhere_tpu_torch import train as _train

            ctx = _train.get_context()
            assert _dist.is_initialized() and _dist.get_world_size() == ctx.get_world_size()
            ck = _train.get_checkpoint()
            start = 0
            if ck is not None:
                start = int(ck.load_pytree_sharded()["step"]) + 1
            for step in range(start, 12):
                _t.sleep(0.08)
                if step == 3 and ctx.get_world_rank() == 0 and start == 0:
                    open(config["go"], "w").close()  # arm the preempter
                metrics = {"step": step, "world": ctx.get_world_size()}
                if _train.should_checkpoint() or step == 11:
                    cko = _train.Checkpoint(_train.shared_checkpoint_dir(step))
                    cko.save_pytree_sharded({"step": _np.int64(step)},
                                            process_index=ctx.get_world_rank(),
                                            num_processes=ctx.get_world_size())
                    _train.report(metrics, checkpoint=cko)
                else:
                    _train.report(metrics)

        agent = next(n["pid"] for n in ca.nodes() if n["node_id"] == n1)

        def preempter():
            deadline = time.monotonic() + T
            while not os.path.exists(go) and time.monotonic() < deadline:
                time.sleep(0.02)
            sims.append(PreemptionSimulator(n1, kill_after_s=60.0).start())

        th = threading.Thread(target=preempter, daemon=True)
        th.start()
        result = train.TorchTrainer(
            loop, train_loop_config={"go": go},
            scaling_config=train.ScalingConfig(num_workers=2, min_workers=1, max_workers=2,
                                               use_gpu=False),
            run_config=train.RunConfig(name="preempt_fast", storage_path=str(tmp_path),
                                       failure_config=train.FailureConfig(max_failures=0)),
            backend_config=train.TorchConfig(backend="gloo"),
        ).fit()
        th.join(timeout=10)
        assert result.error is None  # max_failures=0: the restart was exempt
        assert result.metrics["step"] == 11
        assert result.metrics["world"] == 1  # shrunk onto the survivor
        steps = sorted(m["step"] for m in result.metrics_history)
        assert set(steps) == set(range(12)), steps
        assert len(steps) <= 14, steps
        d = {k: TRAIN_STATS[k] - stats0.get(k, 0) for k in TRAIN_STATS}
        assert d["preempt_restarts_total"] == 1
        assert d["preempt_barrier_acked_total"] == 1
        assert d["budget_exempt_attempts_total"] == 1
        run = train_plane()["runs"]["preempt_fast"]
        assert run["status"] == "FINISHED"
        assert run["world_size"] == 1
        assert run["preempt_restarts"] == 1
        assert run["failure_count"] == 0
        assert run["last_checkpoint"]
        # the warned agent drained and exited on its own, well inside the
        # simulator's 60-s window
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and _running(agent):
            time.sleep(0.2)
        assert not _running(agent)
        assert not any(n["node_id"] == n1 and n["alive"] for n in ca.nodes())
        assert len(sims) == 1 and not sims[0].sigkilled
    finally:
        for s in sims:
            s.stop()
        c.shutdown()
