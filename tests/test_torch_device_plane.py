"""The port's device plane against the JAX package's: the tensor transport
(cluster_anywhere_tpu_torch.channel.device_transport), device objects
(DeviceRef, `device_objects`), tensor-transport DAG edges, the compiled
SSE stream under the LLM deployments, and the device-plane dry run.

There is no card here: the tests reach the device plane with a CPU tensor
subclass whose `is_cuda` is True (as tests/test_torch_runtime.py reaches
the runtime), which the port treats as a CUDA value; a process that sees
no GPU lands every leaf on the CPU and counts it in stats()["cpu_landings"].

Tolerances: transport round trips, DeviceRef values, DTensor shards and
the lifetime counts are exact; the SSE tokens follow
tests/test_torch_serve_llm.py (greedy fp32, equal token for token).  The
JAX side of the lifetime check and the LLM reference run in a subprocess
started with the file; DTensor leaves run on gloo ranks of
tests/torch_dist_pool.py.
Every get, result and read has a timeout; each cluster of this file sets
dag_execute_timeout_s to 60 and tears its compiled DAGs down in `finally`.
"""

import gc
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict, defaultdict, namedtuple

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import cluster_anywhere_tpu.channel.device_transport as jdt
import cluster_anywhere_tpu.core.serialization as jser
import cluster_anywhere_tpu_torch as ca
import cluster_anywhere_tpu_torch.channel.device_transport as tdt
import cluster_anywhere_tpu_torch.core.serialization as tser
from cluster_anywhere_tpu_torch import llm, serve
from cluster_anywhere_tpu_torch.core.config import get_config
from cluster_anywhere_tpu_torch.core.ids import ObjectID
from cluster_anywhere_tpu_torch.core.worker import global_worker
from cluster_anywhere_tpu_torch.dag import InputNode

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_pool import RankPool  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60  # seconds: the bound on every wait of this file
Pair = namedtuple("Pair", "a b")


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it is on the card."""

    @property
    def is_cuda(self):
        return True


def _cuda_like(t):
    return t.as_subclass(_FakeCuda)


# ------------------------------------------------------- JAX side, early

JAX_SIDE = textwrap.dedent("""
    import gc, json, sys, time
    import jax
    import numpy as np
    import cluster_anywhere_tpu as ca
    from cluster_anywhere_tpu.llm import _params_io as jio
    from cluster_anywhere_tpu.llm import processor as jproc
    from cluster_anywhere_tpu.llm import serve_llm as jserve
    from cluster_anywhere_tpu.models import transformer as jtf

    # the lifetime of an actor's device results
    ca.init(num_cpus=2)

    @ca.remote
    class Holder:
        def make(self, n):
            import jax.numpy as jnp
            return {"kv": jnp.arange(n, dtype=jnp.bfloat16), "n": n}

        def count(self):
            from cluster_anywhere_tpu.core.worker import global_worker
            return len(global_worker().device_objects)

    h = Holder.remote()
    refs = [h.make.remote(n) for n in (4, 5)]
    got = [float(ca.get(r, timeout=60)["kv"].astype("float32").sum()) for r in refs]
    before = ca.get(h.count.remote(), timeout=60)
    del refs
    gc.collect()
    time.sleep(1.0)
    after = ca.get(h.count.remote(), timeout=60)
    ca.shutdown()

    # the LLM deployment's reference: a saved tiny fp32 checkpoint served
    # in-process by the JAX ContinuousLLMServer, greedy
    spec = dict(preset="tiny", config_overrides={"dtype": "float32"})
    jio.save_params(jtf.init_params(jax.random.key(4), jproc.ModelSpec(**spec).transformer_config(259)),
                    sys.argv[1])
    srv = jserve.ContinuousLLMServer(jproc.ProcessorConfig(
        model=jproc.ModelSpec(**spec, params_path=sys.argv[1]), **json.loads(sys.argv[2])), slots=4)
    try:
        ids = [[t["token_id"] for t in srv.stream({"prompt": p})] for p in json.loads(sys.argv[3])]
        texts = [srv.tok.decode(np.asarray(t, np.int32)) for t in ids]
    finally:
        srv.close()
    print("RESULT " + json.dumps({"lifetime": [got, before, after], "ids": ids, "texts": texts}))
""")
LLM_KW = dict(max_prompt_len=24, max_new_tokens=8)
PROMPTS = ["hello", "the quick brown fox", "serve me"]


@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory):
    """The JAX package's lifetime reading and LLM reference, from a
    subprocess started with the file so that it overlaps the port's tests;
    the fixture is a function that waits for them (and the checkpoint's
    path, which the subprocess writes)."""
    ckpt = str(tmp_path_factory.mktemp("jax_side") / "ckpt")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SIDE, ckpt, json.dumps(LLM_KW),
                             json.dumps(PROMPTS)], env=env, cwd="/",
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}

    def result():
        if "out" not in box:
            out, err = proc.communicate(timeout=3 * T)
            assert proc.returncode == 0, err[-3000:]
            line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
            box["out"] = dict(json.loads(line[len("RESULT "):]), ckpt=ckpt)
        return box["out"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def cluster():
    if ca.is_initialized():
        ca.shutdown()
    ca.init(num_cpus=4, num_gpus=0, dag_execute_timeout_s=60)
    yield
    ca.shutdown()


# ------------------------------------------------------------- transport


def _trees():
    """The same tree in each package: fp32, bf16, int64, bool, 0-d, empty
    and non-contiguous tensors (arrays in JAX), a numpy leaf, and
    non-tensor leaves in the skeleton."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    ints = rng.integers(-5, 5, (2, 3))
    mask = rng.random(5) > 0.5
    strided = np.arange(12, dtype=np.float32).reshape(3, 4)
    meta = {"name": "kv", "step": 3, "none": None, "nested": [1, ("x", 2.5)]}
    port = {"f32": torch.from_numpy(f32), "bf16": torch.from_numpy(f32).to(torch.bfloat16),
            "i64": torch.from_numpy(ints), "bool": torch.from_numpy(mask),
            "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3),
            "strided": torch.from_numpy(strided).t(), "np": ints.copy(),
            "pair": Pair(torch.ones(2), "b"), "meta": meta,
            "ordered": OrderedDict(z=torch.ones(1), a=2), "default": defaultdict(list, k=[1])}
    jx = {"f32": jnp.asarray(f32), "bf16": jnp.asarray(f32).astype(jnp.bfloat16),
          "i64": jnp.asarray(ints), "bool": jnp.asarray(mask), "scalar": jnp.asarray(2.5),
          "empty": jnp.zeros((0, 3)), "strided": jnp.asarray(strided).T, "np": ints.copy(),
          "pair": Pair(jnp.ones(2), "b"), "meta": meta,
          "ordered": OrderedDict(z=jnp.ones(1), a=2), "default": defaultdict(list, k=[1])}
    return port, jx


def _port_hop(value):
    return tdt.maybe_unpack(tser.unpack(tser.pack(tdt.pack_device_value(value))))


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, dtype=np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)


def test_round_trip_matches_jax():
    """Every leaf lands with the JAX package's values, shape and dtype
    (bf16 bit for bit; int64 stays int64, where JAX without x64 lands
    int32), and the skeleton's other leaves are untouched."""
    port, jx = _trees()
    got = _port_hop(port)
    want = jdt.unpack_device_value(jser.unpack(jser.pack(jdt.pack_device_value(jx))))
    for k in ("f32", "bf16", "i64", "bool", "scalar", "empty", "strided", "np"):
        assert isinstance(got[k], torch.Tensor) and type(got[k]) is torch.Tensor, k
        np.testing.assert_array_equal(_as_numpy(got[k]), _as_numpy(want[k]), err_msg=k)
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        if k not in ("i64", "np"):
            assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
    assert got["i64"].dtype == torch.int64 and got["np"].dtype == torch.int64
    assert torch.equal(got["bf16"].view(torch.int16), port["bf16"].view(torch.int16))
    assert got["strided"].is_contiguous() and torch.equal(got["strided"], port["strided"])
    assert type(got["pair"]) is Pair and got["pair"].b == "b" == want["pair"].b
    assert got["meta"] == port["meta"] == want["meta"]
    for k in ("ordered", "default"):  # containers keep their type, order and state
        assert type(got[k]) is type(want[k]) and list(got[k]) == list(want[k]), k
    assert got["default"].default_factory is list and got["ordered"]["a"] == 2


def test_a_cuda_leaf_is_copied_once_into_a_host_copy_it_owns():
    src = _cuda_like(torch.arange(6, dtype=torch.bfloat16))
    tdt.reset_stats()
    env = tdt.pack_device_value({"kv": src, "id": 7})
    src.add_(100)  # the producer reuses its memory after the pack
    st = tdt.stats()
    assert (st["d2h_copies"], st["d2h_bytes"], st["host_leaves"]) == (1, 12, 0)
    got = tdt.unpack_device_value(tser.unpack(tser.pack(env)))
    assert torch.equal(got["kv"], torch.arange(6, dtype=torch.bfloat16)) and got["id"] == 7
    assert type(got["kv"]) is torch.Tensor and not got["kv"].is_cuda


def test_stats_count_packs_and_landings():
    port, _ = _trees()
    tdt.reset_stats()
    _port_hop(port)
    st = tdt.stats()
    # 9 tensors (the pair's and the OrderedDict's included) and the numpy
    # leaf; no GPU here
    assert st == {"leaves_packed": 10, "d2h_copies": 0, "d2h_bytes": 0, "host_leaves": 10,
                  "leaves_landed": 10, "cuda_landings": 0, "cpu_landings": 10,
                  "sharded_landings": 0, "whole_landings": 0, "host_assembles": 0}
    tdt.reset_stats()
    assert set(tdt.stats().values()) == {0}


class _Box:
    """An object the device-value tree walk does not enter."""

    def __init__(self, t):
        self.t = t


def test_a_nested_cuda_tensor_travels_by_its_reducer():
    """A CUDA tensor inside an object the tree walk does not enter is
    pickled by the serializer's reducer as a transport leaf (its bytes out
    of band) and lands on this process's device."""
    box = _Box(_cuda_like(torch.arange(4.0)))
    tdt.reset_stats()
    data, buffers = tser.serialize([object(), box])
    assert len(buffers) == 1 and bytes(buffers[0].raw()) == torch.arange(4.0).numpy().tobytes()
    got = tser.unpack(tser.pack([1, box]))[1]
    assert type(got.t) is torch.Tensor and torch.equal(got.t, torch.arange(4.0))
    assert (tdt.stats()["d2h_copies"], tdt.stats()["cpu_landings"]) == (2, 1)


def test_dtensor_leaves_on_one_and_two_ranks():
    """A DTensor lands with its placements over a registered mesh; with
    none, a Replicate-only one lands whole, a sharded one whose shard is
    the whole tensor lands whole unless strict mode is on, and one whose
    other shards are on another rank raises, naming its spec."""
    import torch_transport_cases as cases

    one, two = RankPool(world=1, deadline=T), RankPool(world=2, deadline=T)
    one.start()
    two.start()
    try:
        [solo] = one.run(cases.dtensor_cases)
        pair = two.run(cases.dtensor_cases)
    finally:
        one.close()
        two.close()
    for out in [solo] + pair:
        assert out["registered"] == [True, True, True, ("t", 1)]
        assert out["registered_full"]
        st = out["registered_stats"]
        assert (st["sharded_landings"], st["cpu_landings"], st["host_assembles"]) == (3, 3, 0)
        assert out["replicated_whole"] == ["Tensor", True]
    assert solo["sharded_lax"] == ["Tensor", True]
    assert "drop the sharding" in solo["sharded_strict"] and "STRICT" in solo["sharded_strict"]
    assert solo["unregistered_stats"]["host_assembles"] == 1
    for out in pair:
        for key in ("sharded_lax", "sharded_strict"):
            assert out[key].startswith("RuntimeError: device transport cannot land a DTensor")
            assert "('shard', 0)" in out[key]
    assert pair[0]["from_rank0"] == "landed"
    assert "cannot land" in pair[1]["from_rank0"] and "at (0, 0, 0, 0, 0, 0)" in pair[1]["from_rank0"]
    assert pair[1]["from_rank0_replicated"] == [False, True]


# --------------------------------------------------------- device objects


def _dev_class():
    """An actor that makes CUDA-like values, tensor-transport payloads and
    reports on what it holds (defined in a function: it travels to the
    worker by value)."""

    @ca.remote
    class Dev:
        def __init__(self):
            self.keep = []

        def make(self, n):
            import torch

            class FakeCuda(torch.Tensor):
                is_cuda = property(lambda self: True)

            kv = torch.arange(n, dtype=torch.bfloat16).as_subclass(FakeCuda)
            self.keep.append(kv)
            return {"kv": kv, "n": n}

        def is_mine(self, v):
            return any(v["kv"] is k for k in self.keep)

        def describe(self, v):
            """[type, is_cuda, dtype, values] of v's "kv" leaf (or of v)."""
            kv = v["kv"] if isinstance(v, dict) else v
            return [type(kv).__name__, bool(kv.is_cuda), str(kv.dtype), kv.float().tolist()]

        def count(self):
            from cluster_anywhere_tpu_torch.core.worker import global_worker

            return len(global_worker().device_objects)

        def payload(self, n):
            import numpy as np
            import torch

            class FakeCuda(torch.Tensor):
                is_cuda = property(lambda self: True)

            return {"np": np.arange(n), "cpu": torch.ones(n),
                    "kv": torch.arange(n, dtype=torch.bfloat16).as_subclass(FakeCuda),
                    "tag": f"n{n}"}

        def leaves(self, v):
            """Each tensor leaf's [type, dtype, sum], the tag, and the
            transport's counters here."""
            import torch

            from cluster_anywhere_tpu_torch.channel import device_transport

            leaves = {k: [type(x).__name__, str(x.dtype), x.float().sum().item()]
                      for k, x in v.items() if isinstance(x, torch.Tensor)}
            return [leaves, v["tag"], device_transport.stats()]

        def reset_stats(self):
            from cluster_anywhere_tpu_torch.channel import device_transport

            device_transport.reset_stats()

        def big(self, n):
            import torch

            return torch.arange(n, dtype=torch.float32)

        def total(self, t):
            return [type(t).__name__, float(t.sum())]

        def spills(self):
            from cluster_anywhere_tpu_torch.channel.shm_channel import CHANNEL_STATS

            return CHANNEL_STATS["spills"]

        def relay(self, other, n):
            """Passes a CUDA value it makes to `other` as a task argument:
            what `other` saw, and how many device objects this actor held
            before and after the call."""
            import torch

            import cluster_anywhere_tpu_torch as ca
            from cluster_anywhere_tpu_torch.core.worker import global_worker

            class FakeCuda(torch.Tensor):
                is_cuda = property(lambda self: True)

            held = len(global_worker().device_objects)
            kv = torch.arange(n, dtype=torch.bfloat16).as_subclass(FakeCuda)
            seen = ca.get(other.describe.remote({"kv": kv}), timeout=60)
            return [seen, held, len(global_worker().device_objects)]

    return Dev


@pytest.fixture(scope="module")
def actors(cluster):
    """Two actors, shared by this file's cluster tests (each worker imports
    torch once)."""
    Dev = _dev_class()
    a, b = Dev.remote(), Dev.remote()
    assert ca.get([a.count.remote(), b.count.remote()], timeout=T) == [0, 0]
    return a, b


def test_put_keeps_a_cuda_value_in_the_driver(actors):
    w = global_worker()
    value = {"kv": _cuda_like(torch.arange(3.0)), "n": 3}
    ref = ca.put(value)
    assert w.device_objects[ref.id.binary()] is value
    assert ca.get(ref, timeout=T) is value  # the owner gets the object itself
    # an argument from the driver (no serving socket) travels as an envelope
    for arg in (ref, value):
        assert ca.get(actors[0].describe.remote(arg), timeout=T) == [
            "Tensor", False, "torch.float32", [0.0, 1.0, 2.0]]
    del ref
    gc.collect()
    assert not any(v is value for v in w.device_objects.values())  # the owner's ref count


def test_an_actors_cuda_argument_stays_in_the_actor(actors):
    """A worker that passes a CUDA value as a task argument keeps it in its
    own device_objects and sends a "dev" handle; the callee lands a copy
    (the driver, with no serving socket, sends an envelope instead).  The
    JAX package's worker puts it under a ref it drops at once, so the
    callee's fetch finds nothing (ROADMAP Queue 3); the port keeps it, as
    it keeps a device result it returned."""
    a, b = actors
    seen, before, after = ca.get(a.relay.remote(b, 3), timeout=T)
    assert seen == ["Tensor", False, "torch.bfloat16", [0.0, 1.0, 2.0]]
    assert after == before + 1


def test_an_actor_result_stays_in_the_actor(actors):
    owner, other = actors
    base = ca.get(owner.count.remote(), timeout=T)
    ref = owner.make.remote(4)
    assert ca.wait([ref], timeout=T)[0] == [ref]
    entry = global_worker().memory_store.get_entry(ref.id)
    assert entry.state == "device"  # the driver holds a handle, not the value
    assert "(4,)" in entry.value and "bfloat16" in entry.value
    assert ca.get(owner.is_mine.remote(ref), timeout=T) is True  # the stored object itself
    assert ca.get(owner.count.remote(), timeout=T) == base + 1
    assert ca.get(other.describe.remote(ref), timeout=T) == [
        "Tensor", False, "torch.bfloat16", [0.0, 1.0, 2.0, 3.0]]  # landed on the CPU here
    got = ca.get(ref, timeout=T)
    assert type(got["kv"]) is torch.Tensor and got["n"] == 4
    assert torch.equal(got["kv"], torch.arange(4, dtype=torch.bfloat16))
    assert ca.get(ref, timeout=T) is got  # the landed value is cached in the getter


def test_device_ref_handle_round_trips():
    ref = ca.DeviceRef(ObjectID.from_random(), owner="w1",
                       spec="Tensor(8, 8, 544, 4, 128):torch.bfloat16")
    again = tser.unpack(tser.pack(ref))
    assert type(again) is ca.DeviceRef and again.id == ref.id
    assert (again.owner, again.spec) == ("w1", ref.spec)
    assert repr(again).startswith("DeviceRef(") and "544" in repr(again)


def test_lifetime_of_an_actors_device_results_matches_jax(actors, jax_side):
    """The owner of an actor's result is the driver, so only the driver's
    eviction pops its device_objects entry: the actor keeps every device
    result it returned after the driver dropped its refs, as in the JAX
    package (ROADMAP Queue 3)."""
    holder = actors[1]
    base = ca.get(holder.count.remote(), timeout=T)
    refs = [holder.make.remote(n) for n in (4, 5)]
    got = [float(ca.get(r, timeout=T)["kv"].float().sum()) for r in refs]
    before = ca.get(holder.count.remote(), timeout=T) - base
    del refs
    gc.collect()
    time.sleep(1.0)
    after = ca.get(holder.count.remote(), timeout=T) - base
    assert [got, before, after] == jax_side()["lifetime"] == [[6.0, 10.0], 2, 2]


def test_train_report_takes_device_metrics(tmp_path):
    """train.report keeps a CUDA tensor as it is; the polled reports,
    pickled for the driver, land it on the driver's device."""
    from cluster_anywhere_tpu_torch.train.session import TrainContext, _Session

    s = _Session(TrainContext(1, 0, 0, 0, "x", str(tmp_path), str(tmp_path)))
    loss = _cuda_like(torch.tensor(1.5))
    s.report({"loss": loss})
    reports = s.drain_reports()
    assert reports[0]["metrics"]["loss"] is loss
    landed = tser.unpack(tser.pack([reports]))[0][0]["metrics"]["loss"]
    assert type(landed) is torch.Tensor and landed.item() == 1.5


# --------------------------------------------------- tensor-transport DAGs


def test_tensor_transport_lands_numpy_and_cpu_leaves_as_tensors(actors):
    """numpy arrives as a tensor (tests/test_dag.py:260-298: as a
    jax.Array); with no GPU every leaf lands on the CPU, counted so."""
    p, c = actors
    ca.get(c.reset_stats.remote(), timeout=T)
    with InputNode() as inp:
        out = c.leaves.bind(p.payload.bind(inp).with_tensor_transport())
    dag = out.experimental_compile()
    try:
        results = [dag.execute(n).get(timeout=T) for n in (3, 4)]
    finally:
        dag.teardown()
    leaves, tag, st = results[1]
    assert tag == "n4"
    assert leaves == {"np": ["Tensor", "torch.int64", 6.0], "cpu": ["Tensor", "torch.float32", 4.0],
                      "kv": ["Tensor", "torch.bfloat16", 6.0]}
    assert st["leaves_landed"] == st["cpu_landings"] == 6 and st["cuda_landings"] == 0


def test_a_frame_larger_than_the_segment_spills(actors):
    """A transport frame over the channel's segment goes through the object
    store (the spill path), never cut or copied elsewhere."""
    p, c = actors
    spills = ca.get(p.spills.remote(), timeout=T)
    with InputNode() as inp:
        out = c.total.bind(p.big.bind(inp).with_tensor_transport())
    dag = out.experimental_compile(buffer_size=1 << 16)
    try:
        n = 1 << 16  # 256 KiB of fp32 through a 64 KiB segment
        assert dag.execute(n).get(timeout=T) == ["Tensor", float(n * (n - 1) / 2)]
        assert dag.execute(8).get(timeout=T) == ["Tensor", 28.0]
    finally:
        dag.teardown()
    assert ca.get(p.spills.remote(), timeout=T) == spills + 1


# ------------------------------------------------------------ SSE stream

FP32 = {"dtype": "float32"}


def _request(url, body, accept=None):
    """One POST, retried while the proxy has not learned the route; the
    JSON answer, or the SSE events with accept=text/event-stream."""
    headers = {"Content-Type": "application/json"}
    if accept:
        headers["Accept"] = accept
    deadline = time.monotonic() + T
    while True:
        req = urllib.request.Request(url, data=json.dumps(body).encode(), headers=headers,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=T) as resp:
                raw = resp.read().decode()
            break
        except urllib.error.HTTPError as e:
            if e.code != 404 or time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    if accept:
        return [_sse_data(ln[len("data: "):]) for ln in raw.splitlines()
                if ln.startswith("data: ")]
    return json.loads(raw)


def _sse_data(text):
    """An SSE event's data: JSON where the proxy sent an object, else the
    text itself (a str item)."""
    try:
        return json.loads(text)
    except ValueError:
        return text


def _proxy():
    return ca.get_actor(serve.PROXY_NAME)


def test_the_proxy_delivers_the_channels_frames(cluster):
    """tests/test_dag_plane.py:172 on the port: SSE rides the compiled shm
    stream when the deployment has dag_stream."""
    from cluster_anywhere_tpu_torch.serve.dag_stream import DAG_EOF

    @serve.deployment
    class DualPath:
        def __call__(self, req):
            for i in range(4):
                yield f"rpc{i}"  # only seen if the compiled path is skipped

        def dag_stream(self, req):
            from cluster_anywhere_tpu_torch.channel.shm_channel import (
                BufferedShmChannel,
                ChannelClosedError,
            )

            ch = BufferedShmChannel(num_readers=1, num_buffers=4)

            def forward():
                try:
                    for i in range(4):
                        ch.write(f"dag{i}", timeout=30)
                    ch.write(DAG_EOF, timeout=30)
                    ch.wait_consumed(30.0)
                except (ChannelClosedError, TimeoutError):
                    pass
                finally:
                    ch.release()

            threading.Thread(target=forward, daemon=True).start()
            return ch.spec()

    serve.start(port=0)
    url = ca.get(_proxy().ready.remote(), timeout=T)
    serve.run(DualPath.bind(), name="dagsse", route_prefix="/dagsse")
    try:
        before = ca.get(_proxy().stream_stats.remote(), timeout=T)
        events = _request(url + "/dagsse", {}, accept="text/event-stream")
        assert events == [f"dag{i}" for i in range(4)]
        after = ca.get(_proxy().stream_stats.remote(), timeout=T)
        assert after["dag"] == before["dag"] + 1 and after["rpc"] == before["rpc"]
    finally:
        serve.delete("dagsse")


@pytest.fixture(scope="module")
def llm_case(jax_side):
    """The JAX-saved tiny fp32 checkpoint, the port's config over it, and
    the JAX ContinuousLLMServer's greedy tokens and texts."""
    ref = jax_side()
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny", config_overrides=FP32,
                                                  params_path=ref["ckpt"]), **LLM_KW)
    return {"cfg": cfg, "prompts": PROMPTS, "ids": ref["ids"], "texts": ref["texts"]}


def _serve_llm(case, name):
    """The case's prompts over SSE and JSON through a fresh deployment; the
    token ids, the texts and the proxy's stream counts during the SSE."""
    serve.start(port=0)
    url = ca.get(_proxy().ready.remote(), timeout=T) + "/" + name
    handle = serve.run(llm.build_continuous_llm_deployment(case["cfg"], slots=4,
                                                           sse_ingress=True, device="cpu"),
                       name=name, route_prefix="/" + name)
    try:
        before = ca.get(_proxy().stream_stats.remote(), timeout=T)
        ids = [[e["token_id"] for e in _request(url, {"prompt": p}, accept="text/event-stream")]
               for p in case["prompts"]]
        after = ca.get(_proxy().stream_stats.remote(), timeout=T)
        texts = [_request(url, {"prompt": p})["generated_text"] for p in case["prompts"]]
        # the driver's own router reaches this session's replica
        assert handle.remote({"prompt": case["prompts"][0]}).result(timeout_s=T)[
            "generated_text"] == texts[0]
    finally:
        serve.delete(name)
    return ids, texts, {k: after[k] - before[k] for k in ("dag", "rpc", "fallbacks")}


def test_llm_sse_over_the_compiled_stream_matches_jax(cluster, llm_case):
    assert get_config().serve_compiled_dag is True
    ids, texts, streams = _serve_llm(llm_case, "cllm")
    assert ids == llm_case["ids"] and texts == llm_case["texts"]
    assert streams == {"dag": 3, "rpc": 0, "fallbacks": 0}


# ---------------------------------------- sessions of their own, last


def test_llm_sse_with_the_compiled_stream_off_matches_jax(llm_case):
    """serve_compiled_dag=False (with the other two DAG fields, which the
    port's ca.init used to refuse): every token rides an RPC frame, and
    the tokens are the same."""
    if ca.is_initialized():
        ca.shutdown()
    ca.init(num_cpus=4, num_gpus=0, serve_compiled_dag=False, dag_execute_timeout_s=30,
            serve_dag_stream_buffers=4)
    try:
        cfg = get_config()
        assert (cfg.serve_compiled_dag, cfg.dag_execute_timeout_s,
                cfg.serve_dag_stream_buffers) == (False, 30, 4)
        ids, texts, streams = _serve_llm(llm_case, "cllm")  # the name of a dead session's app
        assert ids == llm_case["ids"] and texts == llm_case["texts"]
        assert streams == {"dag": 0, "rpc": 3, "fallbacks": 0}
    finally:
        serve.shutdown()
        ca.shutdown()


def test_dryrun_device_plane_on_the_cpu(capsys):
    from cluster_anywhere_tpu_torch.entry import dryrun_device_plane

    if ca.is_initialized():
        ca.shutdown()
    dryrun_device_plane(device="cpu")
    assert "device plane: DAG hop across processes ok" in capsys.readouterr().out
    assert "CA_DEVICE_TRANSPORT_STRICT" not in os.environ
