"""The port's multi-node Cluster (cluster_anywhere_tpu_torch.cluster_utils)
against the JAX package's (cluster_anywhere_tpu.cluster_utils), on the CPU.

The scenarios of tests/test_cluster.py (nodes joining with a declared
accelerator, spillover, node affinity and SPREAD, node-to-node object
transfer, placement groups, node death with task retry, actor restart and
object loss) run as one program under each package, in subprocesses of
their own started with the file, and their outcomes must be equal: node
counts, placement, results and error types.  The accelerator is the
package's own (`num_gpus` / GPU in the port, `num_tpus` / TPU in the JAX
package): it is declared and none is present.  Each node agent pins its
accelerator-pool workers to its view of the cards and hides them from its
CPU-pool workers (CUDA_VISIBLE_DEVICES="" in the port, JAX_PLATFORMS=cpu in
the JAX package); both rules are compared, the JAX package's on the CPU
platform these tests run it on.  Every wait is bounded.
"""

import os

import pytest
from torch_programs import run_under_each_package

T = 150  # seconds: the bound on every wait of this file

PROGRAM = r"""
import importlib, os, pickle, signal, sys, time

import numpy as np

pkg, scratch, out_path = sys.argv[1:4]
ca = importlib.import_module(pkg)
Cluster = importlib.import_module(pkg + ".cluster_utils").Cluster
Affinity = importlib.import_module(
    pkg + ".core.scheduling_strategies").NodeAffinitySchedulingStrategy
errors = importlib.import_module(pkg + ".core.errors")
port = pkg.endswith("_torch")
ACC, OPT = ("GPU", "num_gpus") if port else ("TPU", "num_tpus")
# the variable each package's agents use to give a worker the cards or not
VIEW, HIDDEN = ("CUDA_VISIBLE_DEVICES", "") if port else ("JAX_PLATFORMS", "cpu")
# the view of the cards the accelerator node's agent gives its accelerator
# workers: the port's agent gets one set here; the JAX package's keeps the
# CPU platform these tests run it on (an accelerator platform there would
# make a worker that imports JAX look for a TPU)
AGENT_VIEW = "0,1" if port else "cpu"
ACC_NODE = {"num_cpus": 2, OPT: 1, "env_overrides": {VIEW: AGENT_VIEW}}
open_clusters = []


def _terminated(signum, frame):
    raise SystemExit(128 + signum)  # unwinds to the finally below


signal.signal(signal.SIGTERM, _terminated)


def error(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return None


def which_node():
    return os.environ.get("CA_NODE_ID", "n0")


def env_view():
    return os.environ.get("CA_NODE_ID", "n0"), os.environ.get(VIEW)


def start(head, *nodes):
    c = Cluster(head_resources=head)
    open_clusters.append(c)
    ids = [c.add_node(**n) for n in nodes]
    c.connect()
    c.wait_for_nodes(1 + len(nodes), timeout=60)
    return c, ids


def stop(c):
    c.shutdown()
    open_clusters.remove(c)
    return [os.path.exists(c.session_dir),
            os.path.exists(os.path.join("/dev/shm", os.path.basename(c.session_dir)))]


def cluster3():
    # head (1 CPU) + two 2-CPU agent nodes, the second with one accelerator
    # whose agent sees the cards as AGENT_VIEW
    c, ids = start({"CPU": 1}, {"num_cpus": 2}, ACC_NODE)
    out = {}
    nodes = [n for n in c.nodes() if n["alive"]]
    total = ca.cluster_resources()
    out["join"] = [len(nodes), sorted(n["node_id"] for n in nodes),
                   [n["node_id"] for n in nodes if n["is_head_node"]], total["CPU"],
                   total.get(ACC), {n["node_id"]: n["resources"].get(ACC, 0.0) for n in nodes}]
    out["session"] = c.session_dir.startswith(c.config.session_dir_root)

    f = ca.remote(which_node)

    def here(t):
        time.sleep(t)
        return os.environ.get("CA_NODE_ID", "n0")

    spots = set(ca.get([ca.remote(here).remote(1.0) for _ in range(5)], timeout=60))
    out["spillover"] = len(spots) >= 2
    got = ca.get(f.options(scheduling_strategy=Affinity(ids[0])).remote(), timeout=60)
    bad = error(lambda: ca.get(f.options(scheduling_strategy=Affinity("nope")).remote(),
                               timeout=30))
    spread = ca.get(f.options(scheduling_strategy="SPREAD").remote(), timeout=60)
    out["affinity"] = [got == ids[0], bad, spread in {n["node_id"] for n in c.nodes()}]

    def produce():
        return np.arange(3_000_000, dtype=np.float64)

    def consume(arr):
        return float(arr.sum()), os.environ.get("CA_NODE_ID", "n0")

    ref = ca.remote(produce).options(scheduling_strategy=Affinity(ids[0])).remote()
    arr = ca.get(ref, timeout=60)
    total2, where = ca.get(ca.remote(consume).options(scheduling_strategy=Affinity(ids[1]))
                           .remote(ref), timeout=60)
    big = ca.put(np.ones(2_000_000))
    total3, where3 = ca.get(ca.remote(consume).options(scheduling_strategy=Affinity(ids[0]))
                            .remote(big), timeout=60)
    out["transfer"] = [arr.shape, float(arr[-1]), total2, where == ids[1], total3, where3 == ids[0]]

    pg_mod = importlib.import_module(pkg)
    pg = pg_mod.placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    ca.get(pg.ready(), timeout=30)
    s3 = ca.get([f.options(placement_group=pg, placement_group_bundle_index=i).remote()
                 for i in range(3)], timeout=60)
    ca.remove_placement_group(pg)
    pg2 = pg_mod.placement_group([{"CPU": 1}] * 2, strategy="STRICT_PACK")
    ca.get(pg2.ready(), timeout=30)
    s2 = ca.get([f.options(placement_group=pg2, placement_group_bundle_index=i).remote()
                 for i in range(2)], timeout=60)
    ca.remove_placement_group(pg2)

    def infeasible():
        pg3 = pg_mod.placement_group([{"CPU": 1}] * 4, strategy="STRICT_SPREAD")
        ca.get(pg3.ready(), timeout=30)

    out["pgs"] = [len(set(s3)), len(set(s2)), error(infeasible)]

    # the accelerator node: its accelerator worker keeps the agent's view
    # of the cards, its CPU worker is hidden from them
    acc = ca.get(ca.remote(env_view).options(**{OPT: 1}).remote(), timeout=60)
    cpu = ca.get(ca.remote(env_view).options(scheduling_strategy=Affinity(ids[1]),
                                             num_cpus=1).remote(), timeout=60)
    out["views"] = [acc[0] == ids[1], acc[1] == AGENT_VIEW, cpu[0] == ids[1], cpu[1] == HIDDEN]
    out["shutdown_left"] = stop(c)
    return out


def node_death_task_retry():
    c, (nid,) = start({"CPU": 2}, {"num_cpus": 2})

    def slow():
        time.sleep(3.0)
        return os.environ.get("CA_NODE_ID", "n0")

    ref = ca.remote(max_retries=2)(slow).options(
        scheduling_strategy=Affinity(nid, soft=True)).remote()
    time.sleep(1.0)
    c.remove_node(nid)
    got = ca.get(ref, timeout=60)
    stop(c)
    return got


def actor_restart_on_node_death():
    c, (nid,) = start({"CPU": 2}, {"num_cpus": 2})

    class Where:
        def node(self):
            return os.environ.get("CA_NODE_ID", "n0")

    a = ca.remote(max_restarts=2, num_cpus=1)(Where).options(
        scheduling_strategy=Affinity(nid, soft=True)).remote()
    first = ca.get(a.node.remote(), timeout=60)
    c.remove_node(nid)
    deadline, where = time.time() + 60, None
    while time.time() < deadline:
        try:
            where = ca.get(a.node.remote(), timeout=10)
            if where == "n0":
                break
        except Exception:
            pass
        time.sleep(0.5)
    stop(c)
    return [first == nid, where]


def object_lost_on_node_death():
    c, (nid,) = start({"CPU": 2}, {"num_cpus": 2})

    def produce():
        return np.ones(1_000_000)

    ref = ca.remote(max_retries=0)(produce).options(scheduling_strategy=Affinity(nid)).remote()
    ca.wait([ref], num_returns=1, timeout=60)
    c.remove_node(nid)
    time.sleep(1.0)
    got = error(lambda: ca.get(ref, timeout=30))
    stop(c)
    return got


SCENARIOS = {"cluster3": cluster3, "node_death_task_retry": node_death_task_retry,
             "actor_restart_on_node_death": actor_restart_on_node_death,
             "object_lost_on_node_death": object_lost_on_node_death}
out = {}
try:
    for name, fn in SCENARIOS.items():
        try:
            out[name] = {"result": fn()}
        except Exception as e:
            out[name] = {"raised": repr(e)}
            for c in list(open_clusters):
                stop(c)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
finally:
    for c in list(open_clusters):
        c.shutdown()
"""


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """The program under each package, one after the other
    (tests/torch_programs.py)."""
    return run_under_each_package(PROGRAM, tmp_path_factory.mktemp("cluster_programs"), timeout=T)


def _outputs(programs):
    jax_out, port_out = programs["cluster_anywhere_tpu"], programs["cluster_anywhere_tpu_torch"]
    assert "error" not in jax_out and "error" not in port_out, (jax_out.get("error"),
                                                                port_out.get("error"))
    return jax_out, port_out


@pytest.mark.parametrize("part", ["join", "spillover", "affinity", "transfer", "pgs", "views"])
def test_cluster3_matches_jax(part, programs):
    """Each part of the three-node scenario gives both packages the same
    outcome, and tests/test_cluster.py's expectations."""
    jax_out, port_out = _outputs(programs)
    assert "raised" not in port_out["cluster3"], port_out["cluster3"]
    assert port_out["cluster3"]["result"][part] == jax_out["cluster3"]["result"][part]
    want = {
        "join": [3, ["n0", "node1", "node2"], ["n0"], 5.0, 1.0,
                 {"n0": 0.0, "node1": 0.0, "node2": 1.0}],
        "spillover": True,
        "affinity": [True, jax_out["cluster3"]["result"]["affinity"][1], True],
        "transfer": [(3_000_000,), 2_999_999.0, float(sum(range(3_000_000))), True,
                     2_000_000.0, True],
        "pgs": [3, 1, "PlacementGroupError"],
        "views": [True, True, True, True],
    }[part]
    assert port_out["cluster3"]["result"][part] == want
    if part == "affinity":
        assert want[1] is not None  # hard affinity to an unknown node fails


@pytest.mark.parametrize("name", ["node_death_task_retry", "actor_restart_on_node_death",
                                  "object_lost_on_node_death"])
def test_node_death_matches_jax(name, programs):
    jax_out, port_out = _outputs(programs)
    assert "raised" not in port_out[name], port_out[name]
    assert port_out[name] == jax_out[name]
    want = {"node_death_task_retry": "n0", "actor_restart_on_node_death": [True, "n0"],
            "object_lost_on_node_death": "ObjectLostError"}[name]
    assert port_out[name]["result"] == want


def test_session_under_the_ports_root_and_removed(programs):
    """The port's Cluster keeps its session under the port's root (never
    /tmp/ca_tpu), and shutdown() removes it and its /dev/shm namespace."""
    _, port_out = _outputs(programs)
    got = port_out["cluster3"]["result"]
    assert got["session"] is True
    assert got["shutdown_left"] == [False, False]


def test_add_node_declares_gpu_and_agents_pin_it():
    """add_node(num_gpus=...) puts GPU in the node's shape.  An agent with
    two GPUs pins each GPU-pool worker to one card of its view; agents that
    declare one GPU each (two on a one-card machine) leave their GPU
    workers the whole view, so both use cuda:0.  The session is under the
    port's root, and shutdown() removes it."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.cluster_utils import Cluster
    from cluster_anywhere_tpu_torch.core.config import CAConfig
    from cluster_anywhere_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy as Affinity,
    )

    root = CAConfig().session_dir_root
    assert "ca_torch" in root and not root.startswith("/tmp/ca_tpu")
    if ca.is_initialized():
        ca.shutdown()
    c = Cluster(head_resources={"CPU": 1})
    try:
        two = c.add_node(num_cpus=1, num_gpus=2, resources={"fast": 1},
                         env_overrides={"CUDA_VISIBLE_DEVICES": "4,5"})
        ones = [c.add_node(num_cpus=1, num_gpus=1, env_overrides={"CUDA_VISIBLE_DEVICES": "0"})
                for _ in range(2)]
        assert c.session_dir.startswith(root)
        c.connect()
        c.wait_for_nodes(4, timeout=60)
        node = next(n for n in c.nodes() if n["node_id"] == two)
        assert {k: node["resources"][k] for k in ("CPU", "GPU", "fast")} == \
            {"CPU": 1.0, "GPU": 2.0, "fast": 1.0}

        @ca.remote(num_gpus=1)
        def view():
            return os.environ.get("CA_NODE_ID"), os.environ.get("CUDA_VISIBLE_DEVICES")

        got = ca.get([view.options(scheduling_strategy=Affinity(n)).remote()
                      for n in [two] + ones], timeout=T)
        assert got == [(two, "4"), (ones[0], "0"), (ones[1], "0")]
        assert ca.cluster_resources()["GPU"] == 4.0
    finally:
        c.shutdown()
    assert not os.path.exists(c.session_dir)
    assert not os.path.exists(os.path.join("/dev/shm", os.path.basename(c.session_dir)))
