"""The port's jobs, dashboard, Grafana JSON and CLI
(cluster_anywhere_tpu_torch.jobs, .dashboard, .util.grafana, .cli)
against the JAX package's, on the CPU.

- In this process: JobInfo, the Grafana JSON (titles aside), the CLI's
  parsers (`--num-gpus` for `--num-tpus`) and renderers, `ca lint` (its
  rule list equal to the JAX CLI's, a clean run over this checkout) and
  `ca microbenchmark`, each flag routed to the runner the JAX CLI runs
  for it (the runners stubbed).
- One program under each package, in subprocesses of their own started
  with the file: job submission, logs, failure, stop and a job driver that
  joins the cluster, through JobSubmissionClient and through the
  dashboard's REST API, and the JSON keys of every dashboard route.  The
  results must be equal.  A job submitted through the client runs its
  driver from the JobSupervisor, a CPU-pool actor, so it gets the CPU
  pool's environment (no card: CUDA_VISIBLE_DEVICES="" in the port); a
  REST job's driver is a child of the head, with the head's environment.
  Both packages follow that rule: the test reads whose child each driver
  is, and in the port what it sees of the cards.
- The port's CLI end to end (`ca start --num-gpus`, `status`, `submit`,
  `jobs`, `metrics --grafana-out`, `stop`; `up` and `down` of a YAML with
  a GPU node; `debug`), held to the assertions of tests/test_jobs_cli.py.
  That file's test_ca_up_down and test_cli_debug_attaches_to_breakpoint
  are among the reference's unsteady tests (ROADMAP Queue 3), so their
  counterparts here run no JAX side.

Every wait is bounded.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import pytest
from torch_programs import run_under_each_package

from cluster_anywhere_tpu import cli as jcli
from cluster_anywhere_tpu import jobs as jjobs
from cluster_anywhere_tpu.util import grafana as jgrafana
from cluster_anywhere_tpu_torch import cli as tcli
from cluster_anywhere_tpu_torch import jobs as tjobs
from cluster_anywhere_tpu_torch.util import grafana as tgrafana

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 120  # seconds: the bound on every wait of this file


def _named_for_jax(obj):
    """The port's JSON with its package's name replaced by the JAX package's."""
    return json.loads(json.dumps(obj).replace("cluster_anywhere_tpu_torch", "cluster_anywhere_tpu"))


# ------------------------------------------------------------ in-process


def test_job_info_matches_jax():
    kw = dict(submission_id="job_1", status=tjobs.RUNNING, entrypoint="echo hi", start_time=1.0)
    t, j = tjobs.JobInfo(**kw), jjobs.JobInfo(**kw)
    assert t.__dict__ == j.__dict__ and t.log_path == j.log_path == "job-job_1.log"
    assert [tjobs.PENDING, tjobs.RUNNING, tjobs.SUCCEEDED, tjobs.FAILED, tjobs.STOPPED] == \
        [jjobs.PENDING, jjobs.RUNNING, jjobs.SUCCEEDED, jjobs.FAILED, jjobs.STOPPED]
    assert tjobs._JOB_NS == jjobs._JOB_NS


SNAPSHOT = {
    "ca_serve_request_latency_seconds": {
        "type": "histogram", "description": "latency", "tag_keys": ["deployment"],
        "boundaries": [0.1, 1.0], "series": {"deployment=a": {"buckets": [1, 2, 0], "sum": 1.5,
                                                               "count": 3}}},
    "user_counter": {"type": "counter", "description": "a counter", "tag_keys": [],
                     "series": {"": 4.0}},
    "user_gauge": {"type": "gauge", "description": "a gauge", "tag_keys": ["node"],
                   "series": {"node=n0": 2.0}},
}


def test_grafana_json_matches_jax(tmp_path):
    """The dashboards are the JAX package's JSON; the titles and folder name
    the port."""
    t, j = tgrafana.generate_default_dashboard(), jgrafana.generate_default_dashboard()
    assert "cluster_anywhere_tpu_torch" in t["title"]
    assert _named_for_jax(t) == j
    t2 = tgrafana.dashboard_from_snapshot(SNAPSHOT)
    assert _named_for_jax(t2) == jgrafana.dashboard_from_snapshot(SNAPSHOT)
    tp = tgrafana.write_grafana_dashboards(str(tmp_path / "t"), snapshot=SNAPSHOT)
    jp = jgrafana.write_grafana_dashboards(str(tmp_path / "j"), snapshot=SNAPSHOT)
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        ta, tb = open(a).read(), open(b).read()  # the provisioning stub names its folder
        ta = ta.replace(str(tmp_path / "t"), str(tmp_path / "j"))
        assert ta.replace("cluster_anywhere_tpu_torch", "cluster_anywhere_tpu") == tb


class _Parsed(Exception):
    pass


def _parser(cli_mod, monkeypatch):
    """The argparse parser cli.main builds, caught at parse_args."""
    got = []

    def catch(self, args=None, namespace=None):
        got.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed):
        cli_mod.main(["status"])
    monkeypatch.undo()
    return got[0]


def _commands(parser):
    """{command: {option: (default, type)}} of a parser's subcommands."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, sp in sub.choices.items():
        out[name] = {
            (a.option_strings[-1] if a.option_strings else a.dest).replace("tpus", "gpus"):
                (a.default, getattr(a.type, "__name__", None), a.nargs)
            for a in sp._actions if not isinstance(a, argparse._HelpAction)
        }
    return out


def test_cli_parsers_match_jax(monkeypatch):
    """Every command and option of the JAX package's CLI, `--num-gpus` in
    place of `--num-tpus` in `start` and `join`."""
    t = _commands(_parser(tcli, monkeypatch))
    j = _commands(_parser(jcli, monkeypatch))
    assert t == j
    assert "--num-gpus" in t["start"] and "--num-gpus" in t["join"]
    assert t["start"]["--num-gpus"] == (None, "int", None)


def test_cli_renderers_match_jax():
    data = "\n".join(json.dumps({"wid": "w1", "trace": {"sid": f"s{i}"}, "line": f"line {i}"})
                     for i in range(3)) + "\nnot json\n"
    assert tcli._render_log_trace(data) == jcli._render_log_trace(data)
    ev = {"ts": 100.5, "plane": "drain", "event": "node_draining", "node": "n1", "proc": "head",
          "trace": {"tid": "t1"}, "reason": "preemption", "extra": {"a": 1}}
    assert tcli._format_flight_event(ev) == jcli._format_flight_event(ev)
    assert tcli._format_flight_event(ev, 100.0) == jcli._format_flight_event(ev, 100.0)


STATS_DICTS = {  # series prefix -> (module, the counters dict behind it)
    "head_rpc_": ("core.protocol", "WIRE_STATS"), "ca_dag_": ("dag.compiled", "DAG_STATS"),
    "ca_owner_": ("core.ownership", "OWNER_STATS"),
    "ca_train_": ("core.worker", "TRAIN_STATS"), "ca_transfer_": ("core.worker", "TRANSFER_STATS"),
    "ca_flightrec_": ("util.flightrec", "FLIGHTREC_STATS"),
}


def _emits(pkg, name):
    """Does the package produce the series `name`: a counter of a dict that
    util/metrics.py ships (or the head's wire counters), a head stats key
    (head_*), or a metric its source creates by that name?"""
    import importlib

    for prefix, (mod, var) in STATS_DICTS.items():
        if name.startswith(prefix):
            return name[len(prefix):] in getattr(importlib.import_module(f"{pkg}.{mod}"), var)
    root = os.path.join(REPO, pkg)
    if name.startswith("head_"):
        with open(os.path.join(root, "core", "head.py")) as f:
            return f'"{name[len("head_"):]}"' in f.read()
    base = name[:-len("_count")] if name.endswith("_count") else name
    for d, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py") and f'"{base}"' in open(os.path.join(d, fn)).read():
                return True
    return False


def test_dashboard_reads_names_the_port_emits():
    """Every series the dashboard page's sparklines read (/api/timeseries)
    is one the port produces, as the JAX package does (the port's
    util/metrics.py ships the channel and DAG counters again)."""
    from cluster_anywhere_tpu import dashboard as jdash
    from cluster_anywhere_tpu_torch import dashboard as tdash

    def names(mod):
        block = mod._PAGE.split("async function refreshSparks()")[1].split("];")[0]
        return re.findall(r'\["(\w+)",', block)

    assert names(tdash) == names(jdash) and len(names(tdash)) == 12
    missing = {pkg: [n for n in names(tdash) if not _emits(pkg, n)]
               for pkg in ("cluster_anywhere_tpu", "cluster_anywhere_tpu_torch")}
    assert missing == {"cluster_anywhere_tpu": [], "cluster_anywhere_tpu_torch": []}
    assert _named_for_jax(tdash._PAGE) == jdash._PAGE


def _exit_and_output(main, argv, capsys):
    with pytest.raises(SystemExit) as ei:
        main(argv)
    return ei.value.code, capsys.readouterr().out


def test_lint_rules_match_jax(capsys):
    t = _exit_and_output(tcli.main, ["lint", "--rules"], capsys)
    j = _exit_and_output(jcli.main, ["lint", "--rules"], capsys)
    assert t == j and t[0] == 0 and "pass cancel:" in t[1]


def test_lint_json_over_the_checkout_is_clean(capsys):
    """`ca lint --format json` (no `--` needed) over this checkout: exit 0,
    no finding, the port's files analyzed."""
    code, out = _exit_and_output(tcli.main, ["lint", "--format", "json"], capsys)
    report = json.loads(out)
    assert code == 0 and report["ok"] and report["findings"] == [] and report["new"] == []


RUNNERS = ("run_microbenchmarks", "run_multiclient", "run_scalability", "run_collective_bw",
           "run_lease_plane", "run_owner_plane", "run_metrics_plane", "run_transfer_plane",
           "run_serve_plane", "run_dag_plane", "run_train_elastic", "run_partition_chaos",
           "run_obsplane", "run_ha_plane", "head_saturation")


def _routed(pkg, argv, monkeypatch):
    """The runners `ca microbenchmark argv` called and the init calls it
    made, with every runner and init/shutdown stubbed."""
    import importlib

    ca = importlib.import_module(pkg)
    mb = importlib.import_module(pkg + ".microbenchmark")
    cli = importlib.import_module(pkg + ".cli")
    calls = []
    for name in RUNNERS:
        monkeypatch.setattr(mb, name, lambda _n=name, **kw: calls.append((_n, kw)))
    monkeypatch.setattr(ca, "init", lambda **kw: calls.append(("init", kw)))
    monkeypatch.setattr(ca, "shutdown", lambda: calls.append(("shutdown", {})))
    cli.main(["microbenchmark"] + argv)
    monkeypatch.undo()
    return calls


MB_FLAGS = [[], ["--quick"], ["--num-cpus", "2"], ["--saturation"], ["--multi"],
            ["--scalability"], ["--collective", "--quick"], ["--lease-plane"], ["--owner-plane"],
            ["--metrics-plane"], ["--transfer"], ["--serve", "--quick"], ["--dag"],
            ["--train-elastic"], ["--partition"], ["--obsplane"], ["--ha"]]


@pytest.mark.parametrize("argv", MB_FLAGS, ids=[" ".join(f) or "default" for f in MB_FLAGS])
def test_microbenchmark_flag_routes_as_jax(argv, monkeypatch):
    t = _routed("cluster_anywhere_tpu_torch", argv, monkeypatch)
    j = _routed("cluster_anywhere_tpu", argv, monkeypatch)
    assert t == j
    runners = [name for name, _ in t if name in RUNNERS]
    assert len(runners) == 1 and t[[n for n, _ in t].index(runners[0])][1] == {
        "quick": "--quick" in argv}


# ------------------------------------------------ a program under each package

PROGRAM = r"""
import http.client, importlib, json, os, pickle, signal, sys, time

pkg, scratch, out_path = sys.argv[1:4]
ca = importlib.import_module(pkg)
jobs = importlib.import_module(pkg + ".jobs")
worker = importlib.import_module(pkg + ".core.worker")
port = pkg.endswith("_torch")
if port:
    os.environ["CUDA_VISIBLE_DEVICES"] = "0"  # the head's view of the cards


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


signal.signal(signal.SIGTERM, _terminated)
ca.init(num_cpus=4, **({"num_gpus": 0} if port else {}))
out = {}
try:
    w = worker.global_worker()
    sdir = w.session_dir
    with open(os.path.join(sdir, "head.ready")) as f:
        head_pid = int(f.read())
    client = jobs.JobSubmissionClient()

    def whose(pid):
        if pid == head_pid:
            return "head"
        ws = [x for x in w.head_call("list_workers")["workers"] if x["pid"] == pid]
        return f"worker of {ws[0]['node_id']}" if ws else "?"

    def view(text):
        m = {k: v for k, v in (p.split("=", 1) for p in text.split() if "=" in p)}
        return [whose(int(m["PPID"])), m["VIEW"] if port else None]

    probe = "echo PPID=$PPID VIEW=${CUDA_VISIBLE_DEVICES-unset}"

    sid = client.submit_job(entrypoint="echo hello_from_job && echo line2")
    st = client.wait_until_finish(sid, timeout_s=60)
    logs = client.get_job_logs(sid)
    out["submit"] = [st, "hello_from_job" in logs and "line2" in logs,
                     any(i.submission_id == sid for i in client.list_jobs()),
                     client.get_job_info(sid).return_code]
    sid = client.submit_job(entrypoint="exit 3")
    out["failure"] = [client.wait_until_finish(sid, timeout_s=60),
                      client.get_job_info(sid).return_code]
    sid = client.submit_job(entrypoint="sleep 60")
    time.sleep(0.5)
    stopped = client.stop_job(sid)
    out["stop"] = [stopped, client.wait_until_finish(sid, timeout_s=30),
                   client.delete_job(sid), client.stop_job("nope")]
    script = os.path.join(scratch, "driver.py")
    with open(script, "w") as f:
        f.write(f"import os, sys\nimport {pkg} as ca\nca.init(address=os.environ['CA_ADDRESS'])\n"
                "@ca.remote\ndef f(x):\n    return x * 2\n"
                "print('job-result:', ca.get(f.remote(21), timeout=60))\nca.shutdown()\n")
    sid = client.submit_job(entrypoint=f"{sys.executable} {script}",
                            runtime_env={"env_vars": {"PYTHONPATH": os.environ["PYTHONPATH"]}})
    out["driver"] = [client.wait_until_finish(sid, timeout_s=60),
                     "job-result: 42" in client.get_job_logs(sid)]
    sid = client.submit_job(entrypoint=probe)
    client.wait_until_finish(sid, timeout_s=60)
    out["client_env"] = view(client.get_job_logs(sid))
    tail = "".join(client.tail_job_logs(client.submit_job(entrypoint="echo tailed")))
    out["tail"] = "tailed" in tail

    deadline = time.time() + 10
    addr_file = os.path.join(sdir, "dashboard.addr")
    while not os.path.exists(addr_file) and time.time() < deadline:
        time.sleep(0.1)
    host, port_no = open(addr_file).read().strip().replace("http://", "").split(":")

    def req(method, path, body=None):
        conn = http.client.HTTPConnection(host, int(port_no), timeout=30)
        conn.request(method, path, body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        raw = r.read()
        conn.close()
        try:
            return r.status, json.loads(raw or b"{}")
        except ValueError:
            return r.status, raw.decode()

    def rest_job(entrypoint):
        status, resp = req("POST", "/api/jobs", {"entrypoint": entrypoint})
        sid = resp["submission_id"]
        deadline, info = time.time() + 60, {}
        while time.time() < deadline:
            _, info = req("GET", f"/api/jobs/{sid}")
            if info.get("status") in ("SUCCEEDED", "FAILED", "STOPPED"):
                break
            time.sleep(0.2)
        with open(os.path.join(sdir, f"job-{sid}.log")) as f:
            return status, sid, info, f.read()

    code = (f"import {pkg} as ca; ca.init(address='auto'); "
            "print('rest job ran', ca.get(ca.put(41)) + 1)")
    status, sid, info, log = rest_job(f"{sys.executable} -c \"{code}\"")
    out["rest"] = [status, info.get("status"), info.get("return_code"), "rest job ran 42" in log,
                   any(j.submission_id == sid for j in client.list_jobs()),
                   any(j["submission_id"] == sid for j in req("GET", "/api/jobs")[1]),
                   req("GET", "/api/jobs/nope")[0], req("POST", "/api/jobs", {})[0]]
    out["rest_env"] = view(rest_job(probe)[3])
    _, resp = req("POST", "/api/jobs", {"entrypoint": "sleep 60"})
    time.sleep(0.5)
    status, stopped = req("POST", f"/api/jobs/{resp['submission_id']}/stop")
    out["rest_stop"] = [status, stopped.get("status")]

    def keys(x):
        if isinstance(x, dict):
            return sorted(x)
        if isinstance(x, list):
            return ["list", keys(x[0]) if x else None]
        return type(x).__name__

    routes = ["/api/summary", "/api/nodes", "/api/actors", "/api/workers", "/api/objects",
              "/api/jobs", "/api/pgs", "/api/serve", "/api/timeseries", "/api/logplane",
              "/api/flightrec", "/api/logs", "/api/logs?id=head&tail=5"]
    out["routes"] = {r: [req("GET", r)[0], keys(req("GET", r)[1])] for r in routes}
    out["summary"] = sorted(req("GET", "/api/nodes")[1][0]["resources"])
    status, text = req("GET", "/metrics")
    out["metrics"] = [status, isinstance(text, str)]
    out["page"] = req("GET", "/")[0]
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
finally:
    ca.shutdown()
"""


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """The program under each package, one after the other
    (tests/torch_programs.py)."""
    return run_under_each_package(PROGRAM, tmp_path_factory.mktemp("jobs_programs"), timeout=T)


def _outputs(programs):
    jax_out, port_out = programs["cluster_anywhere_tpu"], programs["cluster_anywhere_tpu_torch"]
    assert "error" not in jax_out and "error" not in port_out, (jax_out.get("error"),
                                                                port_out.get("error"))
    return jax_out, port_out


EXPECTED = {  # tests/test_jobs_cli.py's expectations
    "submit": ["SUCCEEDED", True, True, 0],
    "failure": ["FAILED", 3],
    "stop": [True, "STOPPED", True, False],
    "driver": ["SUCCEEDED", True],
    "tail": True,
    "rest": [200, "SUCCEEDED", 0, True, True, True, 404, 400],
    "rest_stop": [200, "STOPPED"],
    "metrics": [200, True],
    "page": 200,
}


@pytest.mark.parametrize("name", ["submit", "failure", "stop", "driver", "tail", "rest",
                                  "rest_stop", "metrics", "page"])
def test_jobs_match_jax(name, programs):
    jax_out, port_out = _outputs(programs)
    assert port_out[name] == jax_out[name]
    assert port_out[name] == EXPECTED[name]


def test_job_driver_environment_rule_matches_jax(programs):
    """A client job's driver is the child of a CPU-pool worker (the
    JobSupervisor actor's) and, in the port, sees no card; a REST job's
    driver is the head's child, with the head's view ("0" here)."""
    jax_out, port_out = _outputs(programs)
    assert [v[0] for v in (port_out["client_env"], port_out["rest_env"])] == \
        [v[0] for v in (jax_out["client_env"], jax_out["rest_env"])] == ["worker of n0", "head"]
    assert port_out["client_env"][1] == "" and port_out["rest_env"][1] == "0"


def test_dashboard_routes_match_jax(programs):
    """Every route answers with the JAX package's JSON keys."""
    jax_out, port_out = _outputs(programs)
    assert port_out["routes"] == jax_out["routes"]
    assert all(status == 200 for status, _ in port_out["routes"].values())
    assert port_out["summary"] == jax_out["summary"]


# ---------------------------------------------------------- the port's CLI


def _cli(args, env, timeout=T, cwd=None, input=None):
    return subprocess.run([sys.executable, "-m", "cluster_anywhere_tpu_torch.cli", *args],
                          env=env, cwd=cwd, capture_output=True, text=True, timeout=timeout,
                          input=input)


@pytest.fixture
def cli_env(tmp_path):
    """The CLI's environment: the repo on the path, a temp dir of its own
    (so `address="auto"` finds only this test's session), no card."""
    tmp = tmp_path / "t"
    tmp.mkdir()
    return dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp), CUDA_VISIBLE_DEVICES="")


def _alive_pids(sdir):
    """The pids of a session's head and workers (from its worker logs'
    names and head.ready), for the no-process-left check."""
    from cluster_anywhere_tpu_torch.util import state

    with open(os.path.join(sdir, "head.ready")) as f:
        pids = [int(f.read())]
    pids += [n["pid"] for n in state._head("nodes")["nodes"] if n.get("pid")]
    return pids + [w["pid"] for w in state.list_workers() if w.get("pid")]


def _gone(pids):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        left = []
        for p in pids:
            try:
                os.kill(p, 0)
                with open(f"/proc/{p}/stat") as f:
                    if f.read().split(")")[-1].split()[0] != "Z":
                        left.append(p)
            except (ProcessLookupError, FileNotFoundError):
                pass
        if not left:
            return []
        time.sleep(0.2)
    return left


def test_cli_start_status_submit_jobs_metrics_stop(cli_env, tmp_path):
    """`ca start --num-gpus 1` declares the GPU; `status`, `submit`, `jobs`
    and `metrics --grafana-out` work against it; `stop` ends it."""
    import cluster_anywhere_tpu_torch as ca

    if ca.is_initialized():
        ca.shutdown()
    out = _cli(["start", "--num-cpus", "2", "--num-gpus", "1"], cli_env)
    assert out.returncode == 0, out.stderr
    sdir = re.search(r"started cluster at (\S+)", out.stdout).group(1)
    assert "'GPU': 1.0" in out.stdout and "ca_torch" in sdir
    try:
        st = _cli(["status", "--address", sdir], cli_env)
        assert st.returncode == 0, st.stderr
        assert re.search(r"^  GPU: 1 / 1 available$", st.stdout, re.M)
        assert re.search(r"^  CPU: 2 / 2 available$", st.stdout, re.M)
        sub = _cli(["submit", "--address", sdir, "--", "echo", "hello_from_cli"], cli_env,
                   cwd=str(tmp_path))
        assert sub.returncode == 0, sub.stdout + sub.stderr
        assert "hello_from_cli" in sub.stdout and "SUCCEEDED" in sub.stdout
        sid = re.search(r"submitted (\S+):", sub.stdout).group(1)
        jl = _cli(["jobs", "--address", sdir], cli_env)
        assert re.search(rf"^{sid}\s+SUCCEEDED\s", jl.stdout, re.M), jl.stdout
        gdir = tmp_path / "grafana"
        gm = _cli(["metrics", "--address", sdir, "--grafana-out", str(gdir)], cli_env)
        assert gm.returncode == 0, gm.stderr
        written = [ln for ln in gm.stdout.splitlines() if ln.strip()]
        assert written and all(os.path.exists(p) for p in written)
        boards = [json.load(open(p)) for p in written if p.endswith(".json")]
        assert boards and all("cluster_anywhere_tpu_torch" in b["title"] for b in boards)
        url = _cli(["dashboard", "--address", sdir], cli_env).stdout.strip()
        assert url.startswith("http://127.0.0.1:")
        ca.init(address=sdir)
        try:
            pids = _alive_pids(sdir)
        finally:
            ca.shutdown()
    finally:
        stop = _cli(["stop", "--address", sdir], cli_env)
    assert stop.returncode == 0 and "stopping cluster" in stop.stdout, stop.stdout + stop.stderr
    assert _gone(pids) == []


def test_ca_up_down(cli_env, tmp_path):
    """`ca up <yaml>` boots a head and agent nodes (one of them a GPU node)
    from a config; `ca down` tears the whole cluster down (the assertions
    of tests/test_jobs_cli.py::test_ca_up_down; the reference's own is
    unsteady under load, so no JAX side runs)."""
    import cluster_anywhere_tpu_torch as ca

    if ca.is_initialized():
        ca.shutdown()
    cfg = tmp_path / "cluster.yaml"
    cfg.write_text("head: {num_cpus: 2, num_gpus: 0}\n"
                   "nodes:\n"
                   "  - {count: 1, num_cpus: 2}\n"
                   "  - {count: 1, num_cpus: 2, num_gpus: 1}\n")
    out = _cli(["up", str(cfg)], cli_env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "cluster up: 3 nodes" in out.stdout, out.stdout
    sdir = re.search(r"head up at (\S+)", out.stdout).group(1)
    pids = []
    try:
        ca.init(address=sdir)
        alive = [n for n in ca.nodes() if n["alive"]]
        assert len(alive) == 3
        assert ca.cluster_resources().get("CPU") == 6.0
        assert ca.cluster_resources().get("GPU") == 1.0
        assert [n["resources"].get("GPU", 0.0) for n in alive
                if not n["is_head_node"]].count(1.0) == 1

        @ca.remote
        def f(x):
            return x + 1

        assert ca.get([f.remote(i) for i in range(12)], timeout=60) == list(range(1, 13))
        # the dashboard (the port's head starts it) shows the GPU node's
        # total and what is available, and only on that node
        gpu_node = next(n["node_id"] for n in alive if n["resources"].get("GPU"))

        url = _cli(["dashboard", "--address", sdir], cli_env).stdout.strip()
        with urllib.request.urlopen(url + "/api/nodes", timeout=30) as r:
            rows = {n["node_id"]: n for n in json.loads(r.read())}
        assert {k: (n["resources"].get("GPU"), n["available"].get("GPU"))
                for k, n in rows.items() if n["alive"]} == \
            {n["node_id"]: ((1.0, 1.0) if n["node_id"] == gpu_node else (None, None))
             for n in alive}
        # a GPU task runs on the GPU node, with its agent's view of the
        # cards (none: the CLI ran with CUDA_VISIBLE_DEVICES="")

        @ca.remote(num_gpus=1)
        def view():
            return os.environ.get("CA_NODE_ID"), os.environ.get("CUDA_VISIBLE_DEVICES")

        assert ca.get(view.remote(), timeout=60) == (gpu_node, "")
        pids = _alive_pids(sdir)
        ca.shutdown()
    finally:
        down = _cli(["down", "--address", sdir], cli_env)
    assert down.returncode == 0, down.stdout + down.stderr
    assert "stopping cluster" in down.stdout
    assert _gone(pids) == []


def test_cli_debug_attaches_to_breakpoint():
    """`ca debug <idx>`: a task parks on set_trace, the CLI lists the
    breakpoint, attaches over TCP, inspects a local, continues, and the task
    finishes (the assertions of tests/test_jobs_cli.py's test; the
    reference's own is unsteady under load, so no JAX side runs)."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.core.worker import global_worker
    from cluster_anywhere_tpu_torch.util import rpdb

    if ca.is_initialized():
        ca.shutdown()
    ca.init(num_cpus=2, num_gpus=0)
    try:
        @ca.remote
        def buggy(x):
            secret = x * 7
            from cluster_anywhere_tpu_torch.util.rpdb import set_trace

            set_trace(timeout=60)
            return secret

        ref = buggy.remote(6)
        w = global_worker()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not rpdb.list_breakpoints(w):
            time.sleep(0.2)
        assert rpdb.list_breakpoints(w)
        env = dict(os.environ, PYTHONPATH=REPO)
        out = _cli(["debug", "0", "--address", w.session_dir], env, timeout=90,
                   input="p secret\nc\n")
        assert out.returncode == 0, out.stderr
        assert "42" in out.stdout, out.stdout
        assert ca.get(ref, timeout=30) == 42
    finally:
        ca.shutdown()
