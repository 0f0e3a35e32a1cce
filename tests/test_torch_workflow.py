"""The port's Workflows (cluster_anywhere_tpu_torch.workflow) against the JAX
package's (cluster_anywhere_tpu.workflow), on the CPU.

The scenarios of tests/test_workflow.py (run, input node, resume that skips
completed steps, retries, multi-output, cancel and delete, actor steps
rejected, metadata, wait for an event) run as one program under each
package, in subprocesses of their own started with the file.  Each
scenario's results, its status.json (apart from times, the driver's pid and
the error's text) and every stored step value read back must be equal.

A package's pickles name its own classes, so no file written by one package
is loaded by the other: the programs compare values and JSON.  Every wait is
bounded.
"""

import os
import pickle
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 180  # seconds: the bound on every wait of this file
SHUTDOWN_WAIT = 30  # seconds a program has for its ca.shutdown() after SIGTERM

PROGRAM = r"""
import importlib, json, os, pickle, re, signal, sys, threading, time

pkg, root, out_path = sys.argv[1:4]
ca = importlib.import_module(pkg)
workflow = importlib.import_module(pkg + ".workflow")
dag_mod = importlib.import_module(pkg + ".dag")
storage_mod = importlib.import_module(pkg + ".workflow.storage")
cpu = {"num_gpus": 0} if pkg.endswith("_torch") else {}


def _terminated(signum, frame):
    raise SystemExit(128 + signum)  # unwinds to the finally below: ca.shutdown()


signal.signal(signal.SIGTERM, _terminated)


def status(wid):
    with open(os.path.join(root, wid, "status.json")) as f:
        doc = json.load(f)
    for k in ("updated_at", "started_at", "finished_at", "driver_pid"):
        doc.pop(k, None)
    if doc.get("error"):
        doc["error"] = re.match(r"\w+", doc["error"]).group(0)
    return doc


def steps(wid):
    st = storage_mod.WorkflowStorage(wid, root)
    return {k: st.load_step(k) for k in sorted(st.completed_steps())}


def error(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__
    return None


def basic():
    @ca.remote
    def add(a, b):
        return a + b

    @ca.remote
    def double(x):
        return x * 2

    dag = add.bind(double.bind(3), double.bind(4))
    out = workflow.run(dag, workflow_id="basic", storage_root=root)
    return [out, workflow.get_status("basic", storage_root=root),
            workflow.get_output("basic", storage_root=root),
            workflow.run(dag, workflow_id="basic", storage_root=root)]


def input_node():
    @ca.remote
    def inc(x):
        return x + 1

    with dag_mod.InputNode() as inp:
        dag = inc.bind(inc.bind(inp))
    return workflow.run(dag, 10, workflow_id="inp", storage_root=root)


def resume():
    marker = os.path.join(root, "ran_expensive")
    flag = os.path.join(root, "fail_on")

    @ca.remote
    def expensive(path):
        with open(path, "a") as f:
            f.write("x")
        return 100

    @ca.remote
    def flaky(v, fail_flag_path):
        if os.path.exists(fail_flag_path):
            raise RuntimeError("injected")
        return v + 1

    open(flag, "w").close()
    dag = flaky.bind(expensive.bind(marker), flag)
    err = error(lambda: workflow.run(dag, workflow_id="resume1", storage_root=root,
                                     max_step_retries=0))
    failed = [workflow.get_status("resume1", storage_root=root), status("resume1"),
              open(marker).read()]
    os.unlink(flag)
    out = workflow.resume("resume1", storage_root=root)
    return [err, failed, out, open(marker).read()]


def retries():
    attempts = os.path.join(root, "attempts")

    @ca.remote
    def sometimes(path):
        with open(path, "a") as f:
            f.write("a")
        if os.path.getsize(path) < 3:
            raise RuntimeError("not yet")
        return "done"

    out = workflow.run(sometimes.bind(attempts), workflow_id="retry", storage_root=root,
                       max_step_retries=5)
    return [out, os.path.getsize(attempts)]


def multi_output():
    @ca.remote
    def f(x):
        return x * 10

    dag = dag_mod.MultiOutputNode([f.bind(1), f.bind(2)])
    return workflow.run(dag, workflow_id="multi", storage_root=root)


def cancel_and_delete():
    @ca.remote
    def quick():
        return 1

    workflow.run(quick.bind(), workflow_id="c1", storage_root=root)
    workflow.cancel("c1", storage_root=root)
    out = [workflow.get_status("c1", storage_root=root), status("c1"),
           error(lambda: workflow.resume("c1", storage_root=root)),
           ("c1", "CANCELED") in workflow.list_all(storage_root=root)]
    workflow.delete("c1", storage_root=root)
    out.append(("c1", "CANCELED") in workflow.list_all(storage_root=root))
    out.append(error(lambda: workflow.get_status("c1", storage_root=root)))
    return out


def actor_steps():
    @ca.remote
    class A:
        def m(self):
            return 1

    a = A.remote()
    try:
        return error(lambda: workflow.run(a.m.bind(), workflow_id="bad", storage_root=root))
    finally:
        ca.kill(a)


def metadata():
    @ca.remote
    def s1():
        return 1

    @ca.remote
    def s2(x):
        return x + 1

    workflow.run(s2.bind(s1.bind()), workflow_id="meta", storage_root=root)
    meta = workflow.get_metadata("meta", storage_root=root)
    for k in ("updated_at", "started_at", "finished_at", "driver_pid"):
        meta.pop(k, None)
    return meta


def wait_for_event():
    @ca.remote
    def combine(ev_payload, x):
        return f"{ev_payload}-{x}"

    ev = workflow.wait_for_event(workflow.KVEventListener, "go", 0.05, 30.0)
    dag = combine.bind(ev, 7)

    def signal_later():
        time.sleep(0.8)
        workflow.signal_event("go", "launched")

    t = threading.Thread(target=signal_later)
    t.start()
    t0 = time.monotonic()
    out = workflow.run(dag, workflow_id="wf_event", storage_root=root)
    t.join()
    return [out, time.monotonic() - t0 >= 0.7,
            workflow.resume("wf_event", storage_root=root)]


SCENARIOS = {"basic": basic, "input_node": input_node, "resume": resume,
             "retries": retries, "multi_output": multi_output,
             "cancel_and_delete": cancel_and_delete, "actor_steps": actor_steps,
             "metadata": metadata, "wait_for_event": wait_for_event}
WORKFLOWS = {"basic": "basic", "input_node": "inp", "resume": "resume1", "retries": "retry",
             "multi_output": "multi", "metadata": "meta", "wait_for_event": "wf_event"}
try:
    ca.init(num_cpus=4, **cpu)
    out = {}
    for name, fn in SCENARIOS.items():
        try:
            got = {"result": fn()}
        except Exception as e:
            got = {"raised": repr(e)}
        wid = WORKFLOWS.get(name)
        if wid:
            got["status"] = status(wid)
            got["steps"] = steps(wid)
        out[name] = got
    out["list_all"] = workflow.list_all(storage_root=root)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
finally:
    ca.shutdown()
"""

SCENARIOS = ["basic", "input_node", "resume", "retries", "multi_output",
             "cancel_and_delete", "actor_steps", "metadata", "wait_for_event"]
EXPECTED = {  # tests/test_workflow.py's expectations
    "basic": [14, "SUCCEEDED", 14, 14],
    "input_node": 12,
    "retries": ["done", 3],
    "multi_output": [10, 20],
    "actor_steps": "WorkflowError",
}


@pytest.fixture(scope="module", autouse=True)
def programs(tmp_path_factory):
    """The program under each package, started with the file.  At teardown
    a program still running gets SIGTERM, which it answers with
    ca.shutdown(), and is killed only after SHUTDOWN_WAIT seconds."""
    tmp = tmp_path_factory.mktemp("workflow_programs")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = {}
    try:
        for pkg in ("cluster_anywhere_tpu", "cluster_anywhere_tpu_torch"):
            os.makedirs(tmp / f"{pkg}_root")
            procs[pkg] = subprocess.Popen(
                [sys.executable, "-c", PROGRAM, pkg, str(tmp / f"{pkg}_root"), str(tmp / pkg)],
                env=env, cwd="/", stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        yield {"procs": procs, "dir": tmp, "out": {}}
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


def _outputs(programs):
    if not programs["out"]:
        for pkg, p in programs["procs"].items():
            try:
                _, err = p.communicate(timeout=T)
            except subprocess.TimeoutExpired:
                pytest.fail(f"{pkg}'s workflow program did not finish in {T} s")
            assert p.returncode == 0, (pkg, err[-3000:])
            with open(programs["dir"] / pkg, "rb") as f:
                programs["out"][pkg] = pickle.load(f)
    return programs["out"]["cluster_anywhere_tpu"], programs["out"]["cluster_anywhere_tpu_torch"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_jax(name, programs):
    jax_out, port_out = _outputs(programs)
    assert "raised" not in port_out[name], port_out[name]
    assert port_out[name] == jax_out[name]
    if name in EXPECTED:
        assert port_out[name]["result"] == EXPECTED[name]


def test_resume_skips_completed_steps_and_keeps_their_values(programs):
    _, port_out = _outputs(programs)
    err, failed, out, marker = port_out["resume"]["result"]
    assert err is not None and failed[0] == "FAILED" and failed[1]["status"] == "FAILED"
    assert failed[2] == "x" and (out, marker) == (101, "x")  # expensive ran once
    stored = port_out["resume"]["steps"]
    assert sorted(stored.values(), key=repr) == [100, 101, 101]  # two steps and the output
    assert port_out["resume"]["status"]["status"] == "SUCCEEDED"


def test_event_is_awaited_once_and_listing_matches(programs):
    jax_out, port_out = _outputs(programs)
    assert port_out["wait_for_event"]["result"] == ["launched-7", True, "launched-7"]
    canceled = port_out["cancel_and_delete"]["result"]
    assert canceled[0] == "CANCELED" and canceled[1]["status"] == "CANCELED"
    assert canceled[2:] == ["WorkflowError", True, False, "WorkflowError"]
    meta = port_out["metadata"]["result"]
    assert meta["status"] == "SUCCEEDED" and len(meta["completed_steps"]) == 2
    assert port_out["list_all"] == jax_out["list_all"]
    assert ("basic", "SUCCEEDED") in port_out["list_all"]
