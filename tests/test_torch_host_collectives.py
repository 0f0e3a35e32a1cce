"""The port's host collective groups (cluster_anywhere_tpu_torch.parallel.
collectives: HostCollectiveGroup, P2PCollectiveGroup, init_collective_group
and the module-level ops) against the JAX package's.

One program runs under each package in a subprocess of its own (each
starts its own cluster; the actor class travels by value from the
program's __main__), both at once: 4 CPU actors in a "host" (p2p) group
and in a "kv" group run allreduce (sum, max), allgather, reducescatter,
broadcast and send/recv on the same seeded numpy inputs, and the p2p group
the int8 and bf16 quantized allreduce.  Every result must be equal, dtype
included.  The wire codec (quantize_chunk) is held to the JAX package's
bytes in this process, on seeded inputs with exact ties at .5 and a zero
block.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from cluster_anywhere_tpu.parallel import collectives as jax_coll
from cluster_anywhere_tpu_torch.parallel import collectives as coll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 90  # seconds: the bound on each program

PROGRAM = r"""
import importlib, pickle, sys
import numpy as np

pkg, out_path = sys.argv[1], sys.argv[2]
ca = importlib.import_module(pkg)
coll = importlib.import_module(pkg + ".parallel.collectives")
W = 4


class Rank(coll.CollectiveActorMixin):
    def run(self, rank, group, quantized):
        import importlib
        import numpy as np

        coll = importlib.import_module(pkg + ".parallel.collectives")
        rng = np.random.default_rng(rank)
        x = rng.standard_normal((37, 5)).astype(np.float32)
        i = rng.integers(-50, 50, 11)
        got = {
            "sum": coll.allreduce(x, group_name=group),
            "max": coll.allreduce(x, op="max", group_name=group),
            "isum": coll.allreduce(i, group_name=group),
            "gather": coll.allgather(x[: rank + 1], group_name=group),
            "scatter": coll.reducescatter(x, group_name=group),
            "bcast": coll.broadcast(x if rank == 1 else None, src_rank=1, group_name=group),
        }
        coll.send(x * 2, (rank + 1) % W, group_name=group)
        got["recv"] = coll.recv((rank - 1) % W, group_name=group)
        if quantized:
            for mode in ("int8", "bf16"):
                got[mode] = coll.allreduce(x, group_name=group, quantize=mode)
        else:
            try:
                coll.allreduce(x, group_name=group, quantize="int8")
            except ValueError:
                got["kv_int8"] = "ValueError"
        if pkg.endswith("_torch"):
            import torch

            t = torch.from_numpy(x)
            outs = [coll.allreduce(t, group_name=group), coll.reducescatter(t, group_name=group),
                    *coll.allgather(t, group_name=group)]
            got["tensor"] = ([(type(o).__name__, str(o.device)) for o in outs],
                             np.array_equal(outs[0].numpy(), got["sum"]),
                             np.array_equal(outs[1].numpy(), got["scatter"]))
        return got

    def many(self, n_ops, group):
        import importlib
        import numpy as np

        coll = importlib.import_module(pkg + ".parallel.collectives")
        for _ in range(n_ops):
            coll.allreduce(np.ones(8, np.float64), group_name=group)
        return True


def head_counts():
    from importlib import import_module

    w = import_module(pkg + ".core.worker").global_worker()
    return w.head_call("stats").get("rpc_counts", {})


ca.init(num_cpus=W)
R = ca.remote(Rank).options(num_cpus=0.5)
out = {}
for backend, group in (("host", "p2p"), ("kv", "kvg")):
    ranks = [R.remote() for _ in range(W)]
    coll.create_collective_group(ranks, W, list(range(W)), backend=backend, group_name=group)
    out[backend] = ca.get([r.run.remote(i, group, backend == "host") for i, r in enumerate(ranks)],
                          timeout=60)
    if backend == "host":
        ca.get([r.many.remote(1, group) for r in ranks], timeout=60)  # peers resolved
        before = head_counts()
        ca.get([r.many.remote(10, group) for r in ranks], timeout=60)
        after = head_counts()
        out["head_delta"] = {m: after.get(m, 0) - before.get(m, 0)
                             for m in ("kv_get", "kv_put", "kv_keys", "obj_locate")}
    coll.destroy_group_on(ranks, group)
    for r in ranks:
        ca.kill(r)
with open(out_path, "wb") as f:
    pickle.dump(out, f)
ca.shutdown()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both packages' results, the programs run at once."""
    d = tmp_path_factory.mktemp("host_coll")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = {}
    for pkg in ("cluster_anywhere_tpu", "cluster_anywhere_tpu_torch"):
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-c", PROGRAM, pkg, str(d / pkg)], env=env, cwd="/",
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for pkg, p in procs.items():
        try:
            _, err = p.communicate(timeout=T)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, (pkg, err[-3000:])
        with open(d / pkg, "rb") as f:
            out[pkg] = pickle.load(f)
    return out["cluster_anywhere_tpu"], out["cluster_anywhere_tpu_torch"]


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("backend", ["host", "kv"])
def test_group_results_equal_the_jax_packages(results, backend):
    jax_out, port_out = results
    port = [{k: v for k, v in r.items() if k != "tensor"} for r in port_out[backend]]
    _assert_same(jax_out[backend], port, backend)
    # and they are the collectives' values
    xs = [np.random.default_rng(r).standard_normal((37, 5)).astype(np.float32) for r in range(4)]
    for r, got in enumerate(port):
        np.testing.assert_allclose(got["sum"], sum(xs), rtol=1e-6, atol=1e-6)
        assert np.array_equal(got["max"], np.max(xs, axis=0))
        assert [g.shape[0] for g in got["gather"]] == [1, 2, 3, 4]
        assert np.array_equal(got["bcast"], xs[1])
        assert np.array_equal(got["recv"], xs[(r - 1) % 4] * 2)
    if backend == "kv":
        assert all(g["kv_int8"] == "ValueError" for g in port)


def test_quantized_allreduce_equal_and_agreeing(results):
    jax_out, port_out = results
    for mode in ("int8", "bf16"):
        for j, p in zip(jax_out["host"], port_out["host"]):
            assert p[mode].dtype == np.float32
            assert np.array_equal(j[mode], p[mode]), mode
        # every rank decodes the same forwarded bytes
        assert all(np.array_equal(p[mode], port_out["host"][0][mode]) for p in port_out["host"])


def test_tensor_in_tensor_out(results):
    """A numpy input gives numpy; a tensor goes to the host through the
    group and comes back a tensor on its own device."""
    _, port_out = results
    for p in port_out["host"] + port_out["kv"]:
        assert isinstance(p["sum"], np.ndarray)
        assert p["tensor"] == ([("Tensor", "cpu")] * 6, True, True)


def test_p2p_ops_add_no_per_op_head_traffic(results):
    """After the one-time rendezvous, 4 ranks x 10 allreduces add no
    kv_get/kv_put/kv_keys/obj_locate call at the head (as
    tests/test_ownership.py holds the JAX package to)."""
    jax_out, port_out = results
    assert port_out["head_delta"] == {"kv_get": 0, "kv_put": 0, "kv_keys": 0, "obj_locate": 0}
    assert jax_out["head_delta"] == port_out["head_delta"]


def _codec_inputs():
    rng = np.random.default_rng(5)
    out = [(rng.standard_normal(n) * s).astype(np.float32)
           for n, s in ((10_000, 3.0), (513, 100.0), (4096 * 3 + 7, 0.01))]
    # exact ties: a block whose max is 127 has scale 1, so k + 0.5 lands on
    # .5 (rounded half to even: 2.5 -> 2, 3.5 -> 4), and 254 gives scale 2
    ties = np.concatenate([np.array([127.0, -127.0, 2.5, 3.5, -2.5, -3.5, 0.5, 1.5] * 8),
                           np.array([254.0, 5.0, 7.0, -5.0, -7.0, 1.0, 3.0, -1.0] * 8)])
    out.append(ties.astype(np.float32))
    out.append(np.concatenate([np.zeros(64, np.float32), out[0][:64]]))  # a zero block
    out.append(np.zeros(0, np.float32))
    return out


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("block", [64, 4096])
def test_wire_bytes_equal_the_jax_packages(mode, block):
    for x in _codec_inputs():
        payload, meta = coll.quantize_chunk(x, mode, block)
        want_payload, want_meta = jax_coll.quantize_chunk(x, mode, block)
        assert payload == want_payload and meta == want_meta, (x.size, mode, block)
        assert np.array_equal(coll.dequantize_chunk(payload, meta),
                              jax_coll.dequantize_chunk(want_payload, want_meta))


def test_int8_ties_round_half_to_even_and_zero_blocks_are_exact():
    x = _codec_inputs()[3]
    q = np.frombuffer(coll.quantize_chunk(x, "int8", 64)[0], np.int8)
    assert list(q[:8]) == [127, -127, 2, 4, -2, -4, 0, 2]
    assert list(q[64:72]) == [127, 2, 4, -2, -4, 0, 2, 0]
    z = _codec_inputs()[4]
    payload, meta = coll.quantize_chunk(z, "int8", 64)
    assert not coll.dequantize_chunk(payload, meta)[:64].any()
    assert np.frombuffer(meta["sc"], np.float32)[0] == 0.0


def test_int8_roundtrip_within_the_documented_bound():
    x = _codec_inputs()[0]
    y = coll.dequantize_chunk(*coll.quantize_chunk(x, "int8", 512))
    for i in range(0, x.size, 512):
        b = x[i:i + 512]
        assert np.abs(y[i:i + 512] - b).max() <= np.abs(b).max() / 254 * (1 + 1e-5)
