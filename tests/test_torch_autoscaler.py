"""The port's autoscaler (cluster_anywhere_tpu_torch.autoscaler) against the
JAX package's (cluster_anywhere_tpu.autoscaler), on the CPU.

- The reconciler cases of tests/test_autoscaler.py run in this process
  under each package's Reconciler, through a fake provider and synthetic
  cluster states: the decisions (launches, terminations, node types) must
  be equal, and the JAX test's.
- The providers end to end, one program under each package in a subprocess
  of its own started with the file, with an accelerator node type (GPU in
  the port, TPU in the JAX package; declared, none present):
  LocalNodeProvider's capacity credit, AgentNodeProvider under a
  Reconciler, CommandRunnerNodeProvider launching `cli join`, and an
  Autoscaler's idle termination.  Node counts, placement and results must
  be equal.

The record of what an accelerator credit through LocalNodeProvider does
(test_local_provider_credit_places_accelerator_work_in_the_heads_pool):
the credit raises the head node's total; a task asking for the
accelerator runs in an accelerator-pool worker that the head spawns on its
own node, with the head's view of the cards, never on the provider's
workers, which join the CPU pool and are hidden from the cards.  Both
packages do the same.

One difference is a fault of both packages that the port fixes: an actor
whose shape fits no node failed at once, so no autoscaler ever saw its
demand (test_pending_accelerator_actor_under_an_autoscaler).  The port's
head now holds it as demand while an autoscaler reads the head's state.
Every wait is bounded.
"""

import time

import pytest
from torch_programs import run_under_each_package

import cluster_anywhere_tpu.autoscaler.provider as jprov
import cluster_anywhere_tpu.autoscaler.reconciler as jrec
import cluster_anywhere_tpu_torch.autoscaler.provider as tprov
import cluster_anywhere_tpu_torch.autoscaler.reconciler as trec

T = 150  # seconds: the bound on every wait of this file
PACKAGES = {"jax": (jprov, jrec), "torch": (tprov, trec)}


def _fake_provider(prov):
    class FakeProvider(prov.NodeProvider):
        def __init__(self):
            self.nodes, self._seq, self.created, self.terminated = {}, 0, [], []

        def create_node(self, node_type):
            self._seq += 1
            info = prov.NodeInfo(node_id=f"f{self._seq}", node_type=node_type.name,
                                 resources=dict(node_type.resources))
            self.nodes[info.node_id] = info
            self.created.append(node_type.name)
            return info

        def terminate_node(self, node):
            node.state = "terminated"
            self.terminated.append(node.node_id)
            self.nodes.pop(node.node_id, None)

        def non_terminated_nodes(self):
            return [n for n in self.nodes.values() if n.state != "terminated"]

    return FakeProvider()


def _make(pkg, states, node_types=None, **cfg_kw):
    prov, rec = PACKAGES[pkg]
    provider = _fake_provider(prov)
    types = [prov.NodeType(*t) if isinstance(t, tuple) else t for t in (node_types or [])] or None
    config = rec.AutoscalerConfig(node_types=types, **cfg_kw)
    r = rec.Reconciler(provider, config, state_fn=lambda: dict(
        states, pending_demands=list(states["pending_demands"])))
    return prov, provider, r


def _state(demands, total, avail, idle=0, n=0):
    return {"pending_demands": demands, "total": total, "available": avail,
            "idle_workers": idle, "n_workers": n}


def case_scale_up_on_unmet_demand(pkg):
    states = _state([{"CPU": 2.0}, {"CPU": 2.0}], {"CPU": 2.0}, {"CPU": 0.0}, 0, 2)
    _, p, r = _make(pkg, states, node_types=[("cpu2", {"CPU": 2.0})])
    return [r.step(), p.created]


def case_no_launch_when_capacity_free(pkg):
    states = _state([{"CPU": 1.0}], {"CPU": 4.0}, {"CPU": 3.0}, 2, 2)
    _, p, r = _make(pkg, states)
    return [r.step(), p.created]


def case_bin_packing_prefers_small_nodes(pkg):
    states = _state([{"CPU": 1.0}] * 3, {"CPU": 0.0}, {"CPU": 0.0})
    _, p, r = _make(pkg, states, node_types=[("cpu1", {"CPU": 1.0}), ("cpu4", {"CPU": 4.0})])
    return [r.step(), p.created]


def case_max_total_nodes_cap(pkg):
    states = _state([{"CPU": 1.0}] * 10, {"CPU": 0.0}, {"CPU": 0.0})
    _, p, r = _make(pkg, states, node_types=[("cpu1", {"CPU": 1.0}, 100)], max_total_nodes=3)
    return [r.step(), p.created]


def case_idle_terminate_after_timeout(pkg):
    states = _state([{"CPU": 1.0}], {"CPU": 2.0}, {"CPU": 0.0}, 0, 2)
    _, p, r = _make(pkg, states, node_types=[("cpu2", {"CPU": 2.0})], idle_timeout_s=0.3)
    out = [r.step(), len(p.non_terminated_nodes())]
    states.update(pending_demands=[], total={"CPU": 4.0}, available={"CPU": 4.0})
    out.append(r.step())
    time.sleep(0.4)
    out += [r.step(), p.non_terminated_nodes(), p.terminated]
    return out


def case_no_terminate_while_provider_capacity_busy(pkg):
    states = _state([], {"CPU": 4.0}, {"CPU": 1.0}, 0, 4)
    _, p, r = _make(pkg, states, node_types=[("cpu2", {"CPU": 2.0})], idle_timeout_s=0.0)
    p.create_node(r.config.node_types[0])
    return [r.step() for _ in range(3)]


def case_requested_min_launches_and_pins(pkg):
    states = _state([], {"CPU": 1.0}, {"CPU": 1.0}, 1, 1)
    _, p, r = _make(pkg, states, node_types=[("cpu2", {"CPU": 2.0})], idle_timeout_s=0.0)
    r.request_resources({"CPU": 3.0})
    out = [r.step()]
    states.update(total={"CPU": 3.0}, available={"CPU": 3.0})
    out.append(r.step())
    time.sleep(0.05)
    out += [r.step(), len(p.non_terminated_nodes())]
    return out


def case_accelerator_node_type(pkg):
    """Accelerator demand goes to the node type that has the accelerator."""
    acc = "GPU" if pkg == "torch" else "TPU"
    states = _state([{"CPU": 1.0, acc: 1.0}, {"CPU": 1.0}, {acc: 1.0}], {"CPU": 1.0},
                    {"CPU": 0.0})
    _, p, r = _make(pkg, states, node_types=[("cpu2", {"CPU": 2.0}),
                                             ("acc1", {"CPU": 2.0, acc: 1.0}, 1)])
    return [r.step(), p.created]


CASES = {  # each case's decisions, as tests/test_autoscaler.py asserts them
    case_scale_up_on_unmet_demand: [{"launched": 2, "terminated": 0}, ["cpu2", "cpu2"]],
    case_no_launch_when_capacity_free: [{"launched": 0, "terminated": 0}, []],
    case_bin_packing_prefers_small_nodes: [{"launched": 3, "terminated": 0},
                                           ["cpu1", "cpu1", "cpu1"]],
    case_max_total_nodes_cap: [{"launched": 3, "terminated": 0}, ["cpu1"] * 3],
    case_idle_terminate_after_timeout: [{"launched": 1, "terminated": 0}, 1,
                                        {"launched": 0, "terminated": 0},
                                        {"launched": 0, "terminated": 1}, [], ["f1"]],
    case_no_terminate_while_provider_capacity_busy: [{"launched": 0, "terminated": 0}] * 3,
    case_requested_min_launches_and_pins: [{"launched": 1, "terminated": 0},
                                           {"launched": 0, "terminated": 0},
                                           {"launched": 0, "terminated": 0}, 1],
    # the CPU demand packs onto the accelerator node planned for the first;
    # the third finds acc1 at its max_nodes and no other type that fits
    case_accelerator_node_type: [{"launched": 1, "terminated": 0}, ["acc1"]],
}


@pytest.mark.parametrize("case", list(CASES), ids=[c.__name__[5:] for c in CASES])
def test_reconciler_decisions_match_jax(case):
    got = {pkg: case(pkg) for pkg in PACKAGES}
    assert got["torch"] == got["jax"] == CASES[case]


def test_config_and_exports_match_jax():
    import cluster_anywhere_tpu.autoscaler as ja
    import cluster_anywhere_tpu_torch.autoscaler as ta

    assert ta.__all__ == ja.__all__
    assert vars(trec.AutoscalerConfig()).keys() == vars(jrec.AutoscalerConfig()).keys()
    assert [(t.name, t.resources) for t in trec.AutoscalerConfig().node_types] == \
        [(t.name, t.resources) for t in jrec.AutoscalerConfig().node_types]
    assert tprov.NodeType("a", {"CPU": 1.0}).__dict__ == jprov.NodeType("a", {"CPU": 1.0}).__dict__


PROGRAM = r"""
import importlib, os, pickle, signal, sys, time

pkg, scratch, out_path = sys.argv[1:4]
ca = importlib.import_module(pkg)
prov = importlib.import_module(pkg + ".autoscaler.provider")
rec = importlib.import_module(pkg + ".autoscaler.reconciler")
Affinity = importlib.import_module(
    pkg + ".core.scheduling_strategies").NodeAffinitySchedulingStrategy
worker = importlib.import_module(pkg + ".core.worker")
port = pkg.endswith("_torch")
ACC, OPT = ("GPU", "num_gpus") if port else ("TPU", "num_tpus")
if port:
    # the head's view of the cards, which its GPU-pool workers keep (the
    # JAX package runs on the CPU platform here: its view is not compared)
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


signal.signal(signal.SIGTERM, _terminated)


def where():
    view = os.environ.get("CUDA_VISIBLE_DEVICES") if port else None
    return os.environ.get("CA_WORKER_ID", "?"), os.environ.get("CA_NODE_ID", "n0"), view


def alive_agents():
    return [n for n in ca.nodes() if n["alive"] and not n["is_head_node"]]


def wait_for(cond, limit=30):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.2)
    return cond()


def local_credit():
    p = prov.LocalNodeProvider(workers_per_node=1)
    node = p.create_node(prov.NodeType("acc1", {"CPU": 1.0, ACC: 1.0}))
    total = ca.cluster_resources().get(ACC)
    wid, nid, view = ca.get(ca.remote(where).options(**{OPT: 1}).remote(), timeout=60)
    exts = wait_for(lambda: [w for w in worker.global_worker().head_call("list_workers")["workers"]
                             if w["worker_id"].startswith("ext-") and w["state"] != "dead"])
    ext_states = [w["state"] for w in exts]  # the provider's worker took no work
    p.terminate_node(node)
    return [total, wid.startswith("ext-"), nid, ext_states, ca.cluster_resources().get(ACC, 0.0),
            len(p.non_terminated_nodes()), view]


def agent_provider():
    p = prov.AgentNodeProvider()
    r = rec.Reconciler(p, rec.AutoscalerConfig(
        node_types=[prov.NodeType("acc1", {"CPU": 2.0, ACC: 1.0})], idle_timeout_s=300))

    def hold(t):
        time.sleep(t)
        return os.environ.get("CA_NODE_ID", "n0")

    # two queued demands of one accelerator each: one pass launches a node
    # for each, and each task runs on its own
    refs = [ca.remote(hold).options(**{OPT: 1}).remote(1.0) for _ in range(2)]
    head = worker.global_worker().head_call
    wait_for(lambda: len(head("autoscaler_state")["pending_demands"]) == 2)
    launched = r.step()["launched"]
    agents = wait_for(lambda: len(alive_agents()) == launched and alive_agents())
    got = ca.get(refs, timeout=60)
    mine = sorted(p.nodes)
    for n in list(p.non_terminated_nodes()):
        p.terminate_node(n)
    gone = wait_for(lambda: not alive_agents())
    return [launched, len(agents), sorted(n["resources"].get(ACC) for n in agents),
            sorted(n["node_id"] for n in agents) == mine, sorted(set(got)) == mine, gone]


def command_runner():
    launch = (f"{sys.executable} -m {pkg}.cli join --head {{head_addr}} --node-id {{node_id}} "
              f"--num-cpus 2 --{'num-gpus' if port else 'num-tpus'} 1 "
              f"--resources {{resources_json}} --session-root {scratch}/joinroot")
    p = prov.CommandRunnerNodeProvider(hosts=["host-a", "host-b"], launch_cmd=launch)
    info = p.create_node(prov.NodeType("acc1", {"CPU": 2.0, ACC: 1.0}))
    row = next(n for n in ca.nodes() if n["node_id"] == info.node_id)
    got = ca.get(ca.remote(where).options(scheduling_strategy=Affinity(info.node_id), **{OPT: 1})
                 .remote(), timeout=60)
    n_live = len(p.non_terminated_nodes())
    p.terminate_node(info)
    dead = wait_for(lambda: not any(n["node_id"] == info.node_id and n["alive"]
                                    for n in ca.nodes()))
    return [row["alive"], row["resources"].get(ACC), got[1] == info.node_id, n_live, dead]


def autoscaler_idle():
    p = prov.AgentNodeProvider()
    a = rec.Autoscaler(p, rec.AutoscalerConfig(
        node_types=[prov.NodeType("acc1", {"CPU": 2.0, ACC: 1.0}, max_nodes=1)],
        idle_timeout_s=1.0, interval_s=0.3))
    a.start()
    try:
        got = ca.get(ca.remote(where).options(**{OPT: 1}).remote(), timeout=60)
        handles = [n.handle for n in p.nodes.values()]
        ended = wait_for(lambda: handles and all(h.poll() is not None for h in handles), 40)
        return [got[1].startswith("as-"), len(handles), bool(ended), len(alive_agents())]
    finally:
        a.stop()


def pending_actor():
    # an actor whose shape fits no node, with an autoscaler reading the
    # head's demand (JAX: fails at once; the port: waits for the node)
    p = prov.AgentNodeProvider()
    a = rec.Autoscaler(p, rec.AutoscalerConfig(
        node_types=[prov.NodeType("acc1", {"CPU": 2.0, ACC: 1.0}, max_nodes=1)],
        idle_timeout_s=1.0, interval_s=0.3))
    a.start()
    try:
        time.sleep(1.0)

        class Where:
            def node(self):
                return os.environ.get("CA_NODE_ID", "n0")

        try:
            actor = ca.remote(**{OPT: 1})(Where).remote()
            out = ca.get(actor.node.remote(), timeout=60)
            out = ["placed", out.startswith("as-"), [n.node_id for n in p.nodes.values()] == [out]]
            ca.kill(actor)
        except Exception as e:
            out = [type(e).__name__, str(e)[:80]]
        handles = [n.handle for n in p.nodes.values()]
        ended = wait_for(lambda: all(h.poll() is not None for h in handles), 40)
        return out + [bool(ended)]
    finally:
        a.stop()


# local_credit last: the driver keeps the lease of its accelerator task on
# the head's worker past the debit, which later accelerator tasks would reuse
SCENARIOS = {"agent_provider": agent_provider, "command_runner": command_runner,
             "autoscaler_idle": autoscaler_idle, "pending_actor": pending_actor,
             "local_credit": local_credit}
out = {}
try:
    ca.init(num_cpus=2, **{OPT: 0})
    for name, fn in SCENARIOS.items():
        try:
            out[name] = {"result": fn()}
        except Exception as e:
            out[name] = {"raised": repr(e)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
finally:
    ca.shutdown()
"""


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """The program under each package, one after the other
    (tests/torch_programs.py)."""
    return run_under_each_package(PROGRAM, tmp_path_factory.mktemp("autoscaler_programs"), timeout=T)


def _outputs(programs):
    jax_out, port_out = programs["cluster_anywhere_tpu"], programs["cluster_anywhere_tpu_torch"]
    assert "error" not in jax_out and "error" not in port_out, (jax_out.get("error"),
                                                                port_out.get("error"))
    return jax_out, port_out


def test_local_provider_credit_places_accelerator_work_in_the_heads_pool(programs):
    jax_out, port_out = _outputs(programs)
    assert "raised" not in port_out["local_credit"], port_out["local_credit"]
    assert port_out["local_credit"]["result"][:-1] == jax_out["local_credit"]["result"][:-1]
    # credited; the accelerator task ran in a head-spawned worker on n0, not
    # on the provider's worker, which idled in the CPU pool; debited after;
    # the port's GPU worker kept the head's view of the cards ("0")
    assert port_out["local_credit"]["result"] == [1.0, False, "n0", ["idle"], 0.0, 0, "0"]


@pytest.mark.parametrize("name", ["agent_provider", "command_runner", "autoscaler_idle"])
def test_provider_matches_jax(name, programs):
    jax_out, port_out = _outputs(programs)
    assert "raised" not in port_out[name], port_out[name]
    assert port_out[name] == jax_out[name]
    want = {"agent_provider": [2, 2, [1.0, 1.0], True, True, True],
            "command_runner": [True, 1.0, True, 1, True],
            "autoscaler_idle": [True, 1, True, 0]}[name]
    assert port_out[name]["result"] == want


def test_pending_accelerator_actor_under_an_autoscaler(programs):
    """The JAX package fails an actor whose shape fits no node at once, so
    its autoscaler never launches a node for it; the port holds the actor
    as demand while an autoscaler reads the head, places it on the node the
    autoscaler launches, and the idle node is terminated after the kill."""
    jax_out, port_out = _outputs(programs)
    assert jax_out["pending_actor"]["result"][0] == "ActorDiedError"
    assert "resources unavailable" in jax_out["pending_actor"]["result"][1]
    assert port_out["pending_actor"]["result"] == ["placed", True, True, True]


def test_infeasible_actor_without_an_autoscaler_fails_at_once():
    """With no autoscaler reading the head, an actor that fits no node
    still fails at once, as in the JAX package."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.core.errors import ActorDiedError

    if ca.is_initialized():
        ca.shutdown()
    ca.init(num_cpus=1, num_gpus=0)
    try:
        class Where:
            def node(self):
                return 1

        t0 = time.monotonic()
        with pytest.raises(ActorDiedError, match="resources unavailable"):
            ca.get(ca.remote(num_gpus=1)(Where).remote().node.remote(), timeout=30)
        assert time.monotonic() - t0 < 15
    finally:
        ca.shutdown()
