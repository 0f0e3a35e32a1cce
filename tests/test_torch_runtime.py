"""The port's runtime core (cluster_anywhere_tpu_torch.core): tasks, actors,
the object store, placement groups and the GPU resource, on one local
cluster of the port started on the CPU, plus the parity of one small
program run under each package.

Every get, wait and result has a timeout, so a fault fails the test
instead of hanging the run.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

import cluster_anywhere_tpu_torch as ca
from cluster_anywhere_tpu_torch.core import accelerators, config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60  # seconds: the bound on every wait of this file


@pytest.fixture(scope="module", autouse=True)
def cluster():
    if ca.is_initialized():
        ca.shutdown()
    # one GPU declared, none present: GPU-pool placement runs on the CPU
    info = ca.init(num_cpus=4, num_gpus=1)
    yield info
    ca.shutdown()


@ca.remote
def _add(a, b):
    return a + b


@ca.remote
def _nested(n):
    return sum(ca.get([_add.remote(i, i) for i in range(n)], timeout=T))


@ca.remote
def _boom():
    raise ValueError("boom")


@ca.remote
def _visible_devices():
    return os.environ.get("CUDA_VISIBLE_DEVICES")


@ca.remote
class _Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, by=1):
        self.n += by
        return self.n


@ca.remote
class _Probe:
    """A fresh actor process reports what it has imported and sees."""

    def modules(self):
        names = ("jax", "cluster_anywhere_tpu", "torch", "cluster_anywhere_tpu_torch")
        return {m: m in sys.modules for m in names}

    def visible_devices(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it is on the card: how the device plane is
    reached without one."""

    @property
    def is_cuda(self):
        return True


def test_session_root_is_the_ports_own(cluster):
    root = os.path.dirname(cluster["session_dir"])
    assert root == config.CAConfig().session_dir_root
    assert os.path.basename(cluster["session_dir"]).startswith("session_")
    assert os.path.basename(root).startswith("ca_torch")
    assert root != "/tmp/ca_tpu"
    assert cluster["resources"]["GPU"] == 1.0


def test_session_root_follows_the_temp_dir(monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", "/var/tmp/checkout-a")
    assert config.CAConfig().session_dir_root == "/var/tmp/checkout-a/ca_torch"


def test_session_root_stays_short_enough_for_unix_sockets(monkeypatch):
    """A temp dir too long for the sockets under it gets a short root of its
    own, named after its hash, so two such temp dirs still do not meet."""
    roots = []
    for tail in ("a", "b"):
        monkeypatch.setattr(tempfile, "tempdir", "/tmp/" + "x" * 80 + tail)
        roots.append(config.CAConfig().session_dir_root)
    assert roots[0] != roots[1]
    for root in roots:
        assert root.startswith("/tmp/ca_torch_")
        assert len(root) + config._SOCK_TAIL <= config._SUN_PATH_MAX


@pytest.mark.parametrize("value", [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.zeros(1 << 20, np.uint8),  # above the inline limit: shared memory
    torch.arange(6.0).reshape(2, 3),
    {"w": torch.ones(3, dtype=torch.bfloat16), "ids": np.arange(4)},
])
def test_put_get_roundtrip(value):
    got = ca.get(ca.put(value), timeout=T)
    if isinstance(value, dict):
        assert torch.equal(got["w"], value["w"]) and (got["ids"] == value["ids"]).all()
    elif isinstance(value, torch.Tensor):
        assert torch.equal(got, value)
    else:
        np.testing.assert_array_equal(got, value)


def test_tasks_and_nested_tasks():
    assert ca.get(_add.remote(2, 3), timeout=T) == 5
    assert ca.get([_add.remote(i, 1) for i in range(8)], timeout=T) == list(range(1, 9))
    assert ca.get(_nested.remote(5), timeout=T) == 20
    ref = ca.put(np.arange(5))
    assert (ca.get(_add.remote(ref, 1), timeout=T) == np.arange(1, 6)).all()


def test_actor_state_named_lookup_and_kill():
    c = _Counter.remote(10)
    assert ca.get([c.inc.remote() for _ in range(3)], timeout=T) == [11, 12, 13]
    named = _Counter.options(name="torch-runtime-counter").remote()
    ca.get(named.inc.remote(5), timeout=T)
    again = ca.get_actor("torch-runtime-counter")
    assert ca.get(again.inc.remote(), timeout=T) == 6
    ca.kill(again)
    with pytest.raises(ca.ActorError):
        ca.get(named.inc.remote(), timeout=T)


def test_wait_returns_ready_first():
    @ca.remote
    def sleepy(s):
        import time

        time.sleep(s)
        return s

    slow, fast = sleepy.remote(8.0), sleepy.remote(0.0)
    ready, pending = ca.wait([slow, fast], num_returns=1, timeout=T)
    assert ready == [fast] and pending == [slow]
    ready, pending = ca.wait([slow, fast], num_returns=2, timeout=T)
    assert len(ready) == 2 and not pending


def test_task_error_carries_the_cause():
    with pytest.raises(ca.TaskError, match="boom"):
        ca.get(_boom.remote(), timeout=T)


def test_placement_group_bundles():
    pg = ca.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert pg.wait(timeout_seconds=T)
    strat = ca.PlacementGroupSchedulingStrategy(pg, placement_group_bundle_index=1)
    assert ca.get(_add.options(scheduling_strategy=strat).remote(1, 1), timeout=T) == 2
    ca.remove_placement_group(pg)


def test_cpu_pool_sees_no_gpu_and_gpu_pool_keeps_the_view():
    assert ca.get(_visible_devices.remote(), timeout=T) == ""
    # one GPU on the host: its worker is not pinned, it inherits the view
    gpu_view = ca.get(_visible_devices.options(num_gpus=1).remote(), timeout=T)
    assert gpu_view == os.environ.get("CUDA_VISIBLE_DEVICES")


def test_workers_and_head_load_neither_jax_nor_torch():
    """A fresh CPU worker imports the port and nothing of JAX, the JAX
    package or torch; the head maps no jaxlib or torch library."""
    probe = _Probe.remote()
    assert ca.get(probe.modules.remote(), timeout=T) == {
        "jax": False, "cluster_anywhere_tpu": False, "torch": False,
        "cluster_anywhere_tpu_torch": True,
    }
    assert ca.get(probe.visible_devices.remote(), timeout=T) == ""
    from cluster_anywhere_tpu_torch.core import api

    with open(f"/proc/{api._head_proc.pid}/maps") as f:
        maps = f.read()
    assert "jaxlib" not in maps and "libtorch" not in maps
    with open(f"/proc/{api._head_proc.pid}/cmdline", "rb") as f:
        assert b"cluster_anywhere_tpu_torch.core.head" in f.read()


@pytest.mark.parametrize("env, want", [
    ({"CUDA_VISIBLE_DEVICES": "0,1,2"}, 3),
    ({"CUDA_VISIBLE_DEVICES": ""}, 0),
    ({"CUDA_VISIBLE_DEVICES": "1,-1,2"}, 1),
])
def test_gpu_detection_from_visible_devices(monkeypatch, env, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert accelerators.num_gpus() == want


def test_gpu_resource_from_env_override():
    """CA_NUM_GPUS sets the GPU count a new cluster registers, without torch."""
    code = textwrap.dedent("""
        import sys
        import cluster_anywhere_tpu_torch as ca
        info = ca.init(num_cpus=1)
        print("GPU", info["resources"].get("GPU"), "torch" in sys.modules)
        ca.shutdown()
    """)
    env = dict(os.environ, CA_NUM_GPUS="2", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=T, cwd="/")
    assert out.returncode == 0, out.stderr
    assert "GPU 2.0 False" in out.stdout


def test_refusals_name_their_roadmap_item():
    """Each site that refused a device value while device objects were
    not ported (the test's name is from then) now does what the JAX
    package does: DeviceRef constructs, .bind makes DAG nodes, a CUDA value
    put stays in the driver, as a task argument it lands on the task's
    device (the CPU here), nested deep it travels by its reducer, and a
    task's CUDA result stays in the worker and lands in the getter."""
    from cluster_anywhere_tpu_torch.core.ids import ObjectID
    from cluster_anywhere_tpu_torch.core.worker import global_worker
    from cluster_anywhere_tpu_torch.dag import ClassMethodNode, FunctionNode

    assert isinstance(ca.DeviceRef(ObjectID.from_random()), ca.ObjectRef)
    assert type(_Counter.remote().inc.bind()) is ClassMethodNode
    assert type(_add.bind(1, 2)) is FunctionNode
    assert ca.get(_add.bind(1, 2).execute(), timeout=T) == 3
    cuda_like = torch.ones(3).as_subclass(_FakeCuda)
    ref = ca.put({"x": cuda_like})
    assert global_worker().device_objects[ref.id.binary()]["x"] is cuda_like
    got = ca.get(_add.remote(cuda_like, 1), timeout=T)  # landed on the task's CPU
    assert type(got) is torch.Tensor and torch.equal(got, torch.full((3,), 2.0))
    nested = ca.get(ca.put([object(), _Holder(cuda_like)]), timeout=T)
    assert nested[1].t is cuda_like  # the driver's own value, never pickled
    got = ca.get(_cuda_result.remote(), timeout=T)
    assert type(got) is torch.Tensor and torch.equal(got, torch.ones(2))


@ca.remote
def _cuda_result():
    import torch

    class FakeCuda(torch.Tensor):  # defined here: the worker cannot import this file
        is_cuda = property(lambda self: True)

    return torch.ones(2).as_subclass(FakeCuda)


class _Holder:
    def __init__(self, t):
        self.t = t


PARITY_PROGRAM = """
import sys
import numpy as np
ca = __import__(sys.argv[1])
ca.init(num_cpus=2)

@ca.remote
def square(x):
    return x * x

@ca.remote
def total(xs):
    return int(sum(ca.get([square.remote(x) for x in xs], timeout=60)))

@ca.remote
class Counter:
    def __init__(self):
        self.n = 0
    def add(self, k):
        self.n += k
        return self.n

out = {}
out["tasks"] = ca.get([square.remote(i) for i in range(6)], timeout=60)
out["nested"] = ca.get(total.remote([1, 2, 3]), timeout=60)
c = Counter.remote()
out["actor"] = ca.get([c.add.remote(k) for k in (1, 2, 3)], timeout=60)
arr = np.arange(10, dtype=np.int64)
out["put_get"] = ca.get(ca.put(arr), timeout=60).tolist()
refs = [square.remote(i) for i in range(4)]
ready, pending = ca.wait(refs, num_returns=4, timeout=60)
out["wait"] = [ca.get(r, timeout=60) for r in ready] + [len(pending)]
try:
    ca.get(square.remote("x"), timeout=60)
except ca.TaskError as e:
    out["error"] = type(e).__name__
print("RESULT", sorted(out.items()))
ca.shutdown()
"""


def test_same_program_same_results_under_both_packages():
    results = {}
    for pkg in ("cluster_anywhere_tpu", "cluster_anywhere_tpu_torch"):
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, "-c", PARITY_PROGRAM, pkg], env=env,
                             capture_output=True, text=True, timeout=2 * T, cwd="/")
        assert out.returncode == 0, (pkg, out.stderr[-2000:])
        results[pkg] = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    assert results["cluster_anywhere_tpu"] == results["cluster_anywhere_tpu_torch"]
    assert "('error', 'TaskError')" in results["cluster_anywhere_tpu"][0]
