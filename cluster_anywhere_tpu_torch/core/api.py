"""Top-level API: init/shutdown/remote/get/put/wait and cluster introspection
(analogue of python/ray/_private/worker.py's public functions).
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from .actor import ActorClass
from .config import CAConfig, get_config, set_config
from .object_ref import ObjectRef
from .remote_function import RemoteFunction
from .worker import Worker, global_worker, set_global_worker, try_global_worker

_head_proc: Optional[subprocess.Popen] = None
_session_dir: Optional[str] = None


def is_initialized() -> bool:
    return try_global_worker() is not None


def _sweep_stale_sessions(root: str):
    """GC session dirs (and their /dev/shm segments) whose head process is
    gone — hard-killed clusters can't clean up after themselves."""
    import shutil

    for name in os.listdir(root):
        path = os.path.join(root, name)
        if name.startswith("client_"):
            # client-mode scratch (pull caches): live clients refresh their
            # dir mtime every 30s (worker housekeeping), so a >1h-stale
            # mtime means abandoned — no pid probe (the embedded pid may
            # have been recycled by an unrelated process, which would make
            # the dir unreclaimable forever)
            try:
                if time.time() - os.path.getmtime(path) > 3600:
                    shutil.rmtree(path, ignore_errors=True)
                    shutil.rmtree(os.path.join("/dev/shm", name), ignore_errors=True)
            except OSError:
                pass
            continue
        if not name.startswith("session_"):
            continue
        ready = os.path.join(path, "head.ready")
        pid = None
        try:
            pid = int(open(ready).read().strip())
        except (OSError, ValueError):
            # head.ready not written yet: a concurrent init may own this dir —
            # only sweep if it has been around a while
            try:
                if time.time() - os.path.getmtime(path) < 120:
                    continue
            except OSError:
                continue
        alive = False
        if pid is not None:
            try:
                os.kill(pid, 0)
                alive = True
            except (ProcessLookupError, PermissionError):
                pass
        if not alive:
            # dead head, but a recently-touched dir may be a cluster mid
            # head-restart (head FT): leave young sessions alone — a later
            # init will sweep them once they are genuinely abandoned
            try:
                if time.time() - os.path.getmtime(path) < 120:
                    continue
            except OSError:
                continue
            shutil.rmtree(path, ignore_errors=True)
            shutil.rmtree(os.path.join("/dev/shm", name), ignore_errors=True)


def _find_session(address: str, root: str) -> str:
    """Resolve `address` to a running session dir ("auto" = newest)."""
    def _alive(path: str) -> bool:
        try:
            pid = int(open(os.path.join(path, "head.ready")).read().strip())
        except (OSError, ValueError):
            return False
        try:
            os.kill(pid, 0)
            return True
        except PermissionError:
            return True  # EPERM: process exists, owned by another user
        except ProcessLookupError:
            return False

    if address != "auto":
        if _alive(address):
            return address
        raise ConnectionError(f"no running cluster at {address!r}")
    if os.path.isdir(root):
        for name in sorted(os.listdir(root), reverse=True):
            path = os.path.join(root, name)
            if _alive(path):
                return path
    raise ConnectionError(f"no running cluster found under {root}")


def init(
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    config: Optional[CAConfig] = None,
    session_dir: Optional[str] = None,
    address: Optional[str] = None,
    **config_overrides,
) -> Dict[str, Any]:
    """Start a local cluster (head + worker pool) and connect this process as
    the driver — or, with `address=` ("auto" or a session dir), connect to an
    already-running cluster as an additional driver.
    Mirrors ray.init (python/ray/_private/worker.py:1275).

    A tcp `address=` may be a comma-separated list naming the active head
    plus warm standbys ("tcp:h1:6379,tcp:h2:6379"): the driver dials the
    first reachable entry and fails over along the list (plus any standbys
    learned at register time) when the active head dies mid-session.

    Config overrides pass as keywords, e.g. `init(log_to_driver=False)` to
    opt this driver out of the cluster log stream (worker prints echoed with
    task/worker/node attribution — see util/logplane.py)."""
    global _head_proc, _session_dir
    if is_initialized():
        raise RuntimeError("already initialized; call shutdown() first")
    cfg = config or CAConfig()
    for k, v in config_overrides.items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown config key {k!r}")
        setattr(cfg, k, v)
    if address is not None:
        if any(
            x is not None
            for x in (num_cpus, num_gpus, resources, object_store_memory, session_dir)
        ):
            raise ValueError(
                "resource/session arguments have no effect when joining an "
                "existing cluster via address=; the head's values apply"
            )
        set_config(cfg)
        if address.startswith("tcp:"):
            # remote driver (Ray-Client analogue, ray:// role): connect to
            # the head's TCP endpoint from a host with no session dir.  Puts
            # upload to the head's store; worker/actor addresses arrive as
            # TCP duals; pulled objects cache in a client-private namespace.
            root = cfg.session_dir_root
            os.makedirs(root, exist_ok=True)
            sdir = os.path.join(root, f"client_{int(time.time()*1000)}_{os.getpid()}")
            os.makedirs(sdir, exist_ok=True)
            _session_dir = sdir
            w = Worker(
                mode="driver",
                session_dir=sdir,
                head_sock=address,
                config=cfg,
                client_mode=True,
            )
            set_global_worker(w)
            w.connect()
            return {
                "session_dir": sdir,
                "node_id": w.node_id,
                "resources": w.total_resources,
            }
        sdir = _find_session(address, cfg.session_dir_root)
        _session_dir = sdir
        w = Worker(
            mode="driver",
            session_dir=sdir,
            head_sock=os.path.join(sdir, "head.sock"),
            config=cfg,
        )
        set_global_worker(w)
        w.connect()
        return {
            "session_dir": sdir,
            "node_id": w.node_id,
            "resources": w.total_resources,
        }
    if object_store_memory is not None:
        cfg.object_store_memory = object_store_memory
    set_config(cfg)

    if num_cpus is None:
        num_cpus = min(os.cpu_count() or 4, 16)
    total: Dict[str, float] = {"CPU": float(num_cpus)}
    from . import accelerators

    if num_gpus is None:
        # detect GPUs without importing torch (CUDA_VISIBLE_DEVICES or the
        # driver's device files; accelerators.py = nvidia_gpu.py analogue)
        num_gpus = int(os.environ.get("CA_NUM_GPUS") or accelerators.num_gpus())
    if num_gpus:
        total["GPU"] = float(num_gpus)
    total["memory"] = float(cfg.object_store_memory)
    if resources:
        total.update({k: float(v) for k, v in resources.items()})

    if session_dir is None:
        root = cfg.session_dir_root
        os.makedirs(root, exist_ok=True)
        _sweep_stale_sessions(root)
        session_dir = os.path.join(root, f"session_{int(time.time()*1000)}_{os.getpid()}")
    os.makedirs(session_dir, exist_ok=True)
    _session_dir = session_dir

    env = dict(os.environ)
    env["CA_SESSION_DIR"] = session_dir
    env["CA_CONFIG_JSON"] = cfg.to_json()
    env["CA_RESOURCES"] = json.dumps(total)
    # child processes must find this package regardless of the driver's cwd
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    head_log = open(os.path.join(session_dir, "head.log"), "ab")
    _head_proc = subprocess.Popen(
        [sys.executable, "-m", "cluster_anywhere_tpu_torch.core.head"],
        env=env,
        stdout=head_log,
        stderr=subprocess.STDOUT,
        start_new_session=True,
    )
    head_log.close()
    ready = os.path.join(session_dir, "head.ready")
    deadline = time.monotonic() + 30
    while not os.path.exists(ready):
        if _head_proc.poll() is not None:
            raise RuntimeError(
                f"head process exited with {_head_proc.returncode}; "
                f"see {session_dir}/head.log"
            )
        if time.monotonic() > deadline:
            raise RuntimeError("timed out waiting for head to start")
        time.sleep(0.01)

    w = Worker(
        mode="driver",
        session_dir=session_dir,
        head_sock=os.path.join(session_dir, "head.sock"),
        config=cfg,
    )
    set_global_worker(w)
    w.connect()
    return {"session_dir": session_dir, "node_id": w.node_id, "resources": total}


def shutdown():
    global _head_proc, _session_dir
    w = try_global_worker()
    client_cleanup = None
    if w is not None:
        if w.client_mode:
            # client-private scratch: this host's pull-cache namespace and
            # session dir are invisible to the cluster — remove them here
            client_cleanup = (w.session_name, w.session_dir)
        # only a driver that spawned the head tears the cluster down; a
        # driver that joined via address= just disconnects
        w.shutdown(stop_cluster=_head_proc is not None)
    if client_cleanup is not None:
        import shutil

        shutil.rmtree(os.path.join("/dev/shm", client_cleanup[0]), ignore_errors=True)
        shutil.rmtree(client_cleanup[1], ignore_errors=True)
    if _head_proc is not None:
        try:
            _head_proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            _head_proc.kill()
            _head_proc.wait(timeout=5)
        _head_proc = None
    _session_dir = None


def put(value: Any) -> ObjectRef:
    return global_worker().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    return global_worker().get(refs, timeout=timeout)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = False) -> None:
    """Cancel the task producing `ref` (ray.cancel analogue).  Queued tasks
    drop immediately; running ones get TaskCancelledError raised at their
    next bytecode boundary; force=True kills the executing worker process
    (for C-level blocking calls).  get(ref) then raises TaskCancelledError;
    cancelled tasks are never retried.  No-op on finished tasks."""
    global_worker().cancel(ref, force=force, recursive=recursive)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
):
    return global_worker().wait(refs, num_returns=num_returns, timeout=timeout)


def remote(*args, **kwargs):
    """@remote decorator for functions and classes, with or without options:
    @remote / @remote(num_cpus=2, num_returns=2)."""

    def make(obj, opts):
        if inspect.isclass(obj):
            return ActorClass(obj, opts)
        if callable(obj):
            return RemoteFunction(obj, opts)
        raise TypeError("@remote must decorate a function or class")

    if len(args) == 1 and not kwargs and (callable(args[0]) or inspect.isclass(args[0])):
        return make(args[0], {})
    if args:
        raise TypeError("@remote options must be keyword arguments")
    return lambda obj: make(obj, kwargs)


def nodes() -> List[dict]:
    return global_worker().head_call("nodes")["nodes"]


def cluster_resources() -> Dict[str, float]:
    return global_worker().head_call("cluster_resources")["total"]


def available_resources() -> Dict[str, float]:
    return global_worker().head_call("cluster_resources")["available"]


def cluster_stats() -> Dict[str, Any]:
    return global_worker().head_call("stats")["stats"]


def drain_node(
    node_id: str, *, reason: str = "manual", deadline_s: Optional[float] = None
) -> Dict[str, Any]:
    """Gracefully drain a node (DrainNode protocol analogue): stop new
    placement on it, recall its delegated lease blocks, migrate its actors
    and sole-copy objects to survivors, and give running tasks until the
    deadline before the kill — whose retries do NOT consume the tasks'
    max_retries budget.  `reason` is one of "manual" | "idle" | "preemption";
    `deadline_s` defaults to the cluster's drain_deadline_s.  Returns the
    head's reply ({"state": "draining", "deadline_s": ...}, or the current
    state when the node is already draining/drained/dead)."""
    fields: Dict[str, Any] = {"node_id": node_id, "reason": reason}
    if deadline_s is not None:
        fields["deadline_s"] = float(deadline_s)
    return global_worker().head_call("drain_node", **fields)


def timeline(filename: Optional[str] = None, *, limit: int = 100_000) -> List[dict]:
    """Chrome-trace/Perfetto events of task lifecycles, with flow arrows
    between submit and execute spans when tracing is enabled (see
    util.state.timeline)."""
    from ..util.state import timeline as _timeline

    return _timeline(filename, limit=limit)
