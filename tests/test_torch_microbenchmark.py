"""The port's microbenchmark (cluster_anywhere_tpu_torch.microbenchmark, `ca
microbenchmark`) against the JAX package's, on the CPU.

- In this process: the helpers `_pct`, `_rate`, `_sse_request` and
  `_open_loop` of both packages give equal results (a scripted clock
  where they read one) against one local SSE stub; and run_serve_plane and
  run_dag_plane, given no device on a host with no GPU, raise before they
  start a session.
- One program under each package, in subprocesses started with the file:
  the default table (run_microbenchmarks) and the host allreduce
  (run_collective_bw), both quick, on one cluster: the port's rows have
  the JAX rows' names and units, every rate above 0, and no head KV or
  locate op during the allreduce loop.
- The port alone, in subprocesses: run_dag_plane(quick=True,
  device="cpu"), whose two serve arms (streaming RPC and the compiled
  stream) answer every request with HTTP 200 and equal event counts; and
  run_train_elastic(quick=True), whose 2-worker gang on 1-CPU nodes asks
  for no GPU and restarts in both arms.

Every wait is bounded.
"""

import http.server
import math
import threading
import types

import numpy as np
import pytest
from torch_programs import PACKAGES, run_under_each_package, run_under_package

from cluster_anywhere_tpu import microbenchmark as jmb
from cluster_anywhere_tpu_torch import microbenchmark as tmb

JAX, PORT = PACKAGES
T = 240  # seconds: the bound on each program of this file

# ------------------------------------------------------------ in-process


class _Stub(http.server.BaseHTTPRequestHandler):
    """POST /ok: 200 and 5 SSE events written in pieces that split a
    `data:` across two writes; /shed: 429 and a small JSON body."""

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if self.path == "/shed":
            body = b'{"error": "shed"}'
            self.wfile.write(b"HTTP/1.1 429 Too Many Requests\r\nContent-Length: "
                             + str(len(body)).encode() + b"\r\nConnection: close\r\n\r\n" + body)
            return
        self.wfile.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                         b"Connection: close\r\n\r\n")
        events = b"".join(b'data: {"token": %d}\n\n' % i for i in range(5))
        for k in range(0, len(events), 7):  # a `data:` straddles two writes
            self.wfile.write(events[k:k + 7])
            self.wfile.flush()

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def stub():
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield server.server_address[1]
    server.shutdown()
    server.server_close()
    th.join(timeout=10)
    assert not th.is_alive()


def _scripted_clock(monkeypatch, mod):
    """mod's clock replaced by one that reads 0, 1, 2, ... s, one step a read."""
    reads = iter(range(10 ** 6))
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=lambda: float(next(reads)),
                                                           sleep=lambda s: None))


def test_pct_and_rate_match_jax(monkeypatch):
    xs = [0.5, 0.1, 0.3, 0.9, 0.2, 0.7]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert tmb._pct(xs, q) == jmb._pct(xs, q)
    assert tmb._pct([], 0.5) == jmb._pct([], 0.5) == 0.0
    got = {}
    for name, mod in ((JAX, jmb), (PORT, tmb)):
        _scripted_clock(monkeypatch, mod)
        calls = []
        got[name] = (mod._rate(250, lambda: calls.append(1)), len(calls))
    assert got[PORT] == got[JAX] == (250.0, 1)


@pytest.mark.parametrize("path", ["/ok", "/shed"])
def test_sse_request_matches_jax(stub, monkeypatch, path):
    got = {}
    for name, mod in ((JAX, jmb), (PORT, tmb)):
        _scripted_clock(monkeypatch, mod)
        got[name] = mod._sse_request("127.0.0.1", stub, path, {"prompt": "x"}, timeout=30)
    want = (200, 1.0, 2.0, 5) if path == "/ok" else (429, None, 1.0, 0)
    assert got[PORT] == got[JAX] == want


def test_open_loop_matches_jax(stub):
    got = {}
    for name, mod in ((JAX, jmb), (PORT, tmb)):
        rs, wall = mod._open_loop("127.0.0.1", stub, "/ok", lambda i: {"i": i}, 20.0, 0.5)
        assert wall > 0.5
        got[name] = sorted((status, ttft is not None, n) for _, status, ttft, _, n in rs)
        starts = sorted(start for start, *_ in rs)
        assert len(starts) == 11 and all(b >= a for a, b in zip(starts, starts[1:]))
    assert got[PORT] == got[JAX] == [(200, True, 5)] * 11


@pytest.mark.parametrize("runner", ["run_serve_plane", "run_dag_plane"])
def test_llm_planes_raise_without_a_gpu(runner, monkeypatch):
    """No device means the card: with none the runner raises before it
    starts a session (there is no quiet CPU run)."""
    import torch

    from cluster_anywhere_tpu_torch.core import api

    def init(*a, **kw):
        raise AssertionError("a session was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(api, "init", init)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tmb, runner)(quick=True)


# ------------------------------------------------ programs in subprocesses

TABLE_PROGRAM = r"""
import importlib, pickle, signal, sys

pkg, scratch, out_path = sys.argv[1:4]


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


signal.signal(signal.SIGTERM, _terminated)
ca = importlib.import_module(pkg)
mb = importlib.import_module(pkg + ".microbenchmark")
ca.init(num_cpus=4, **({"num_gpus": 0} if pkg.endswith("_torch") else {}))
try:
    out = {"table": mb.run_microbenchmarks(quick=True),
           "collective": mb.run_collective_bw(quick=True)}
finally:
    ca.shutdown()
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return run_under_each_package(TABLE_PROGRAM, tmp_path_factory.mktemp("tables"), timeout=T)


def _names_units(rows):
    return [(name, unit) for name, _, unit in rows]


def test_default_table_matches_jax(tables):
    assert "error" not in tables[PORT] and "error" not in tables[JAX], tables
    port, jax = tables[PORT]["table"], tables[JAX]["table"]
    assert _names_units(port) == _names_units(jax)
    assert len(port) == 10 and all(math.isfinite(v) and v > 0 for _, v, _ in port), port


def test_collective_rows_match_jax_with_no_head_traffic(tables):
    assert "error" not in tables[PORT] and "error" not in tables[JAX], tables
    port, jax = tables[PORT]["collective"], tables[JAX]["collective"]
    assert _names_units(port) == _names_units(jax)
    rates = [v for name, v, _ in port if name.startswith("host allreduce")]
    head_ops = [v for name, v, _ in port if name.startswith("head KV/locate ops")]
    assert len(rates) == 2 and all(v > 0 for v in rates)
    assert head_ops == [0, 0]


PORT_PROGRAM = r"""
import os, pickle, signal, sys

pkg, scratch, out_path = sys.argv[1:4]


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


signal.signal(signal.SIGTERM, _terminated)
from cluster_anywhere_tpu_torch import microbenchmark as mb
from cluster_anywhere_tpu_torch import train

out = {}
if os.environ["MB_CASE"] == "dag":
    requests, real = [], mb._sse_request

    def counted(host, port, path, body=None, timeout=120.0):
        r = real(host, port, path, body, timeout)
        requests.append((os.environ.get("CA_SERVE_COMPILED_DAG"), r[0], r[3]))
        return r

    mb._sse_request = counted
    out["rows"] = mb.run_dag_plane(quick=True, device="cpu")
    out["requests"] = requests
else:
    scaling = []

    class Scaling(train.ScalingConfig):
        def __post_init__(self):
            super().__post_init__()
            scaling.append((self.num_workers, self.use_gpu))

    train.ScalingConfig = Scaling
    out["rows"] = mb.run_train_elastic(quick=True)
    out["scaling"] = scaling
with open(out_path, "wb") as f:
    pickle.dump(out, f)
"""


def test_dag_plane_serves_both_arms_equally(tmp_path):
    got = run_under_package(PORT, PORT_PROGRAM, tmp_path, timeout=T, env={"MB_CASE": "dag"})
    assert "error" not in got, got
    rows = {name: (v, unit) for name, v, unit in got["rows"]}
    arms = {"0": [], "1": []}
    for flag, status, n_events in got["requests"]:
        arms[flag].append((status, n_events))
    # 2 warm-up requests and 8 timed ones an arm, every one answered
    assert [len(a) for a in arms.values()] == [10, 10]
    assert all(status == 200 and n > 0 for a in arms.values() for status, n in a), arms
    assert arms["0"] == arms["1"]  # greedy decoding: the same events an arm
    timed = sum(n for _, n in arms["1"][2:])
    assert rows["dag serve rpc-stream events"] == rows["dag serve compiled events"] == (timed, "ev")
    for arm in ("rpc-stream", "compiled"):
        assert rows[f"dag serve {arm} TTFT p50"][0] > 0
    assert rows["dag compiled tick sync p50"][0] > 0 and rows["dag rpc actor-call async"][0] > 0


def test_train_elastic_runs_on_cpu_nodes(tmp_path):
    got = run_under_package(PORT, PORT_PROGRAM, tmp_path, timeout=T, env={"MB_CASE": "elastic"})
    assert "error" not in got, got
    assert got["scaling"] == [(2, False), (2, False)]
    rows = {name: v for name, v, _ in got["rows"]}
    assert list(rows) == ["train-elastic proactive restart latency",
                          "train-elastic proactive steps lost",
                          "train-elastic reactive restart latency",
                          "train-elastic reactive steps lost"]
    assert all(np.isfinite(v) and v >= 0 for v in rows.values())
    assert rows["train-elastic proactive restart latency"] > 0
