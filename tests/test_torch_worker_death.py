"""A dead worker names its cause: the head's `worker_died` event and the
error a caller of the dead actor gets say how the worker died (its exit
status, or the heartbeat it stopped sending) and quote the end of its log.
A worker whose heartbeats stop because a thread holds the GIL while its
process keeps working is not declared dead at the heartbeat bound; one
that is stopped, or blocked holding the GIL, is.

One cluster of the port on the CPU, with a short heartbeat bound
(health_check_period_s 0.3 x failure threshold 10 = 3 s).  Every wait has
a bound.
"""

import json
import os
import signal
import threading
import time

import pytest

import cluster_anywhere_tpu_torch as ca
from cluster_anywhere_tpu_torch.core.head import BUSY_SILENCE_FACTOR, BUSY_WINDOW_S
from cluster_anywhere_tpu_torch.core.worker import global_worker

T = 30  # seconds: the bound on every wait of this file
PERIOD, THRESHOLD = 0.3, 10
BOUND = PERIOD * THRESHOLD


@pytest.fixture(scope="module", autouse=True)
def cluster():
    if ca.is_initialized():
        ca.shutdown()
    ca.init(num_cpus=2, num_gpus=0, health_check_period_s=PERIOD,
            health_check_failure_threshold=THRESHOLD)
    yield
    ca.shutdown()


def _actor_class():
    @ca.remote
    class Proc:
        def pid(self):
            print("actor ready", flush=True)
            return os.getpid()

        def spin(self, seconds):
            """Hold the GIL, running, for `seconds`: a busy loop under a
            switch interval longer than the loop, so no other thread of
            the process gets the GIL until it ends."""
            import sys

            interval = sys.getswitchinterval()
            sys.setswitchinterval(10 * seconds)
            try:
                t0 = time.monotonic()
                while time.monotonic() - t0 < seconds:
                    pass
                return time.monotonic() - t0
            finally:
                sys.setswitchinterval(interval)

        def block(self, seconds):
            """Hold the GIL, asleep: libc's sleep called through PyDLL."""
            import ctypes

            ctypes.PyDLL(None).sleep(seconds)
            return "woke"

    return Proc


def _worker_died(wid, deadline):
    """The head's worker_died event for wid, waiting until deadline."""
    path = os.path.join(global_worker().session_dir, "events.jsonl")
    while time.monotonic() < deadline:
        with open(path) as f:
            for line in f:
                ev = json.loads(line)
                if ev.get("event") == "worker_died" and ev.get("worker_id") == wid:
                    return ev
        time.sleep(0.1)
    raise AssertionError(f"no worker_died event for {wid}")


def _start():
    a = _actor_class().remote()
    pid = ca.get(a.pid.remote(), timeout=T)
    workers = global_worker().head_call("list_workers")["workers"]
    wid = next(w["worker_id"] for w in workers if w["pid"] == pid)
    return a, pid, wid


def _caller_error(actor):
    with pytest.raises(ca.ActorDiedError) as info:
        ca.get(actor.pid.remote(), timeout=T)
    return str(info.value)


def test_a_killed_worker_reports_its_signal():
    a, pid, wid = _start()
    os.kill(pid, signal.SIGKILL)
    ev = _worker_died(wid, time.monotonic() + T)
    assert ev["cause"] == "signal 9", ev
    err = _caller_error(a)
    assert "signal 9" in err and wid in err, err
    assert "actor ready" in err, err  # the log's tail


def test_a_worker_killed_in_init_names_its_signal(tmp_path):
    """The worker dies while the actor's __init__ runs: the actor's death
    cause, what its caller is told, names the worker's signal."""

    @ca.remote
    class Slow:
        def __init__(self, path):
            with open(path + ".tmp", "w") as f:
                f.write(str(os.getpid()))
            os.rename(path + ".tmp", path)
            time.sleep(T)

        def pid(self):
            return os.getpid()

    path = str(tmp_path / "pid")
    killed = []

    def kill_in_init():
        deadline = time.monotonic() + T
        while not os.path.exists(path) and time.monotonic() < deadline:
            time.sleep(0.05)
        with open(path) as f:
            pid = int(f.read())
        workers = global_worker().head_call("list_workers")["workers"]
        killed.append(next(w["worker_id"] for w in workers if w["pid"] == pid))
        os.kill(pid, signal.SIGKILL)

    # creating the actor returns once its __init__ has run: kill from a thread
    killer = threading.Thread(target=kill_in_init, daemon=True)
    killer.start()
    with pytest.raises(ca.ActorDiedError) as info:
        Slow.remote(path)
    killer.join(T)
    wid = killed[0]
    assert _worker_died(wid, time.monotonic() + T)["cause"] == "signal 9"
    err = str(info.value)
    assert "actor __init__ failed" in err and "signal 9" in err and wid in err, err


def test_a_stopped_worker_reports_its_missed_heartbeat():
    a, pid, wid = _start()
    os.kill(pid, signal.SIGSTOP)
    t0 = time.monotonic()
    try:
        ev = _worker_died(wid, t0 + T)
        declared = time.monotonic() - t0
    finally:
        os.kill(pid, signal.SIGCONT)
    assert ev["cause"].startswith("no heartbeat for "), ev
    assert ev["cause"].endswith(" s in state actor"), ev
    gap = float(ev["cause"].split()[3])
    assert BOUND <= gap < BOUND + 2.0, ev  # to 0.1 s
    assert declared < BOUND + 5.0  # within the configured bound
    assert ca.cluster_stats()["max_heartbeat_gap_s"] > BOUND
    err = _caller_error(a)
    assert "no heartbeat for" in err and wid in err, err
    # the fenced worker exits once it runs again (a zombie of the head's
    # until reaped)
    deadline = time.monotonic() + T
    while _running(pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _running(pid), f"worker {pid} did not exit after its fence"


def _running(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_a_worker_holding_the_gil_while_working_is_not_declared_dead():
    """Its IO loop sends no heartbeat for half a bound past the bound, while
    its process runs: the head waits (up to BUSY_SILENCE_FACTOR bounds)."""
    a, pid, wid = _start()
    busy = ca.cluster_stats().get("busy_silences", 0)
    held = ca.get(a.spin.remote(1.5 * BOUND), timeout=T)
    assert BOUND < held < BOUND * BUSY_SILENCE_FACTOR, held
    assert ca.get(a.pid.remote(), timeout=T) == pid  # the same worker, alive
    stats = ca.cluster_stats()
    assert stats["busy_silences"] > busy and stats["max_heartbeat_gap_s"] > BOUND
    path = os.path.join(global_worker().session_dir, "events.jsonl")
    with open(path) as f:
        events = [json.loads(line) for line in f]
    assert not [e for e in events if e.get("event") == "worker_died"
                and e.get("worker_id") == wid]
    assert [e for e in events if e.get("event") == "worker_silent"
            and e.get("worker_id") == wid]
    ca.kill(a)


def test_a_worker_blocked_holding_the_gil_is_declared_dead_at_the_bound():
    """Asleep with the GIL held, the process does no work: a hang, declared
    one CPU-share window after the heartbeat bound; a caller's next error
    says so."""
    a, pid, wid = _start()
    ref = a.block.remote(int(BOUND) + 4)
    t0 = time.monotonic()
    ev = _worker_died(wid, t0 + T)
    declared = time.monotonic() - t0
    assert ev["cause"].startswith("no heartbeat for ") and ev["cause"].endswith("in state actor")
    assert declared < BOUND + BUSY_WINDOW_S + 2.0, declared
    try:  # the call in flight may still deliver its result as the worker wakes
        ca.get(ref, timeout=T)
    except ca.ActorDiedError:
        pass
    assert "no heartbeat for" in _caller_error(a)
