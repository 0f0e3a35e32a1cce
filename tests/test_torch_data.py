"""The port's Data library (cluster_anywhere_tpu_torch.data) against the JAX
package's, on the CPU.

One program of pipelines runs under each package's `data`, each in its own
subprocess and cluster, and every pipeline's rows, batches and aggregates
must be equal, Python types and numpy dtypes included.  The same program
runs once more under the port with pyarrow and pandas hidden from the driver
and every worker (a meta-path blocker in a sitecustomize on PYTHONPATH): the
rows must not change, and the functions that name Arrow or pandas raise
ImportError naming the package.  Then the port's own surface: the device
iterator on the host, its refusals, the GPU actor pool's placement and its
refusal, and an import that loads no torch.

Every wait has a timeout, so a fault fails the test instead of hanging.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

import cluster_anywhere_tpu_torch as ca
import cluster_anywhere_tpu_torch.data as cad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60  # seconds: the bound on every wait of this file

PROGRAM = r'''
import importlib, json, os, sys, tempfile
import numpy as np

pkg, out_path = sys.argv[1], sys.argv[2]
ca = importlib.import_module(pkg)
cad = importlib.import_module(pkg + ".data")
ca.init(num_cpus=2)
tmp = tempfile.mkdtemp()


def canon(x):
    """Values as JSON that keeps Python types and numpy dtypes apart."""
    if isinstance(x, dict):
        return {"dict": [[k, canon(v)] for k, v in x.items()]}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return {"ndarray": str(x.dtype), "shape": list(x.shape), "v": canon(x.tolist())}
    if isinstance(x, np.generic):
        return {"np": str(x.dtype), "v": canon(x.item())}
    if isinstance(x, bytes):
        return {"bytes": x.hex()}
    if isinstance(x, float):
        return {"float": repr(x)}
    return x


class AddConst:
    def __init__(self, c):
        self.c = c

    def __call__(self, batch):
        return {"x": batch["id"] + self.c}


def gen():
    for i in range(10):
        yield {"i": i, "sq": i * i}


def case_range():
    ds = cad.range(100)
    return [ds.count(), ds.take(5), ds.take_all()[-1], ds.columns()]


def case_from_items():
    return [cad.from_items([1, 2, 3]).take_all(),
            cad.from_items([{"a": 1, "b": "x", "c": 0.5, "d": True},
                            {"a": 2, "b": "y", "c": 1.5, "d": False}]).take_all(),
            cad.from_items(["p", "q"]).take_batch(2),
            cad.from_items([{"a": 1, "b": "x"}]).take_batch(1)]


def case_from_numpy():
    arr = np.arange(12).reshape(6, 2)
    ds = cad.from_numpy(arr)
    return [ds.take_batch(6), ds.take_all(), cad.from_numpy(np.arange(5.0)).take_all()]


def case_map_filter_flat_map():
    return [cad.range(20).filter(lambda r: r["id"] % 2 == 0).take_all(),
            cad.range(3).map(lambda r: {"v": r["id"] ** 2}).take_all(),
            cad.range(3).flat_map(lambda r: [{"v": r["id"]}, {"v": -r["id"]}]).take_all(),
            cad.range(4).map(lambda r: r["id"] * 10).take_all(),
            cad.range(6).filter(lambda r: False).take_all()]


def case_map_batches_tasks_and_fusion():
    ds = (cad.range(1000).map_batches(lambda b: {"x": b["id"] * 2})
          .map_batches(lambda b: {"x": b["x"] + 1}))
    # batch_size slices within a block: 50-row blocks give 32 + 18
    sizes = cad.range(100, override_num_blocks=2).map_batches(
        lambda b: {"n": np.full(len(b["id"]), len(b["id"]))}, batch_size=32)
    rows = cad.range(6).map_batches(lambda rows: [{"r": r["id"]} for r in rows],
                                    batch_format="rows")
    return [ds.take(3), ds.count(), sizes.take_all(), rows.take_all(),
            cad.range(8).map_batches(lambda b: None).count()]


def case_map_batches_actors():
    ds = cad.range(100).map_batches(AddConst, fn_constructor_args=(10,), concurrency=2)
    return [ds.take(2), ds.take_all(), ds.count()]


def case_column_ops():
    ds = cad.range(10).add_column("double", lambda b: b["id"] * 2)
    return [ds.take(2), ds.columns(), ds.drop_columns(["id"]).columns(),
            ds.rename_columns({"double": "d2"}).take(1), ds.select_columns(["id"]).take(1)]


def case_sort():
    ds = cad.from_items([{"v": x} for x in [5, 3, 8, 1, 9, 2, 7]])
    vals = np.random.default_rng(0).integers(0, 10000, size=2000)
    big = cad.from_items([{"v": int(v)} for v in vals]).sort("v")
    return [ds.sort("v").take_all(), ds.sort("v", descending=True).take_all(),
            [r["v"] for r in big.take_all()]]


def case_groupby():
    ds = cad.from_items([{"k": i % 3, "v": i} for i in range(30)])
    strs = cad.from_items([{"k": n, "v": 1} for n in ["alpha", "beta", "gamma"] * 20])
    aggs = ds.groupby("k").aggregate(
        cad.Count(), cad.Sum("v"), cad.Min("v"), cad.Max("v"), cad.Mean("v"), cad.Std("v"),
        cad.AbsMax("v"), cad.Quantile("v", q=0.25))
    groups = cad.from_items([{"k": i % 2, "v": float(i)} for i in range(10)]).groupby("k").map_groups(
        lambda g: {"k": g["k"][:1], "m": np.asarray([g["v"].mean()])})
    return [sorted(ds.groupby("k").sum("v").take_all(), key=lambda r: r["k"]),
            sorted(ds.groupby("k").count().take_all(), key=lambda r: r["k"]),
            sorted(strs.groupby("k").sum("v").take_all(), key=lambda r: r["k"]),
            sorted(aggs.take_all(), key=lambda r: r["k"]),
            sorted(groups.take_all(), key=lambda r: r["k"]),
            sorted(ds.unique("k"))]


def case_shuffle_and_repartition():
    mat = cad.range(100, override_num_blocks=8).repartition(3).materialize()
    return [cad.range(200, override_num_blocks=4).random_shuffle(seed=7).take_all(),
            mat.num_blocks(), mat.take_all(),
            cad.range(40, override_num_blocks=4).randomize_block_order(seed=3).take_all(),
            cad.range(100, override_num_blocks=4).random_sample(0.2, seed=5).take_all()]


def case_limit_union_zip():
    z = cad.range(5).zip(cad.range(5).map_batches(lambda b: {"other": b["id"] * 10}))
    same = cad.range(3).zip(cad.range(3))
    return [cad.range(100).limit(7).take_all(), cad.range(5).union(cad.range(5)).take_all(),
            z.take_all(), same.take_all()]


def case_split():
    parts = cad.range(100).split(3)
    equal = cad.range(100).split(3, equal=True)
    tr, te = cad.range(100).train_test_split(0.2)
    str_, ste = cad.range(50).train_test_split(0.3, shuffle=True, seed=2)
    at = cad.range(20).split_at_indices([3, 11])
    prop = cad.range(20).split_proportionately([0.25, 0.5])
    return [[p.take_all() for p in parts], [p.count() for p in equal],
            [tr.take_all(), te.take_all()], [str_.take_all(), ste.take_all()],
            [p.take_all() for p in at], [p.count() for p in prop]]


def case_iter_batches():
    ds = cad.range(100, override_num_blocks=7)
    return [list(ds.iter_batches(batch_size=32)),
            list(ds.iter_batches(batch_size=32, drop_last=True)),
            list(ds.iter_batches(batch_size=None)),
            list(ds.iter_batches(batch_size=10, local_shuffle_buffer_size=50,
                                 local_shuffle_seed=1)),
            list(ds.iter_batches(batch_size=16, batch_format="rows")),
            list(ds.iter_rows())[:5]]


def case_take_batch_and_aggregates():
    ds = cad.range(101)
    return [ds.take_batch(5), ds.sum("id"), ds.min("id"), ds.max("id"), ds.mean("id"),
            ds.std("id"), ds.aggregate(cad.Count(), cad.Sum("id"), cad.Mean("id")),
            cad.from_items([{"c": v} for v in [1, 2, 2, 3, 1]]).unique("c")]


def case_tensors():
    ds = cad.range_tensor(8, shape=(2, 2))
    mapped = ds.map(lambda r: {"s": int(r["data"].sum()), "t": r["data"] * 2})
    return [ds.take_batch(4), ds.take(2), mapped.take_all(),
            ds.map_batches(lambda b: {"flat": b["data"].reshape(len(b["data"]), -1)}).take(2)]


def case_generator():
    return [cad.from_generator(gen, rows_per_block=3).take_all()]


def case_write_read_numpy_json_text():
    npy = os.path.join(tmp, "npy")
    cad.from_numpy(np.arange(12).reshape(6, 2)).write_numpy(npy)
    js = os.path.join(tmp, "json")
    cad.from_items([{"a": i, "s": f"v{i}", "f": i / 2} for i in range(5)]).write_json(js)
    txt = os.path.join(tmp, "f.txt")
    with open(txt, "w") as f:
        f.write("hello\nworld\n\n")
    binf = os.path.join(tmp, "b.bin")
    with open(binf, "wb") as f:
        f.write(bytes(range(8)))
    return [cad.read_numpy(npy).take_all(), sorted(cad.read_json(js).take_all(),
                                                    key=lambda r: r["a"]),
            cad.read_text(txt).take_all(), cad.read_binary_files(binf).take_all()]


def case_parquet_csv():
    pq = os.path.join(tmp, "pq")
    cad.range(50).map(lambda r: {"id": r["id"], "s": str(r["id"])}).write_parquet(pq)
    tq = os.path.join(tmp, "tq")
    cad.range_tensor(6, shape=(3,)).write_parquet(tq)
    csv = os.path.join(tmp, "csv")
    cad.from_items([{"a": 1, "b": 2}, {"a": 3, "b": 4}]).write_csv(csv)
    return [sorted(cad.read_parquet(pq).take_all(), key=lambda r: r["id"]),
            cad.read_parquet(tq).take_batch(6), cad.read_csv(csv).take_all()]


def case_pandas_arrow():
    import pandas as pd
    import pyarrow as pa

    df = pd.DataFrame({"x": [1, 2, 3], "y": ["a", "b", "c"]})
    out = cad.from_pandas(df).to_pandas()
    by_pandas = cad.range(6).map_batches(lambda d: d.assign(z=d["id"] * 3),
                                         batch_format="pandas")
    by_arrow = cad.range(4).map_batches(lambda t: t.append_column("w", t.column("id")),
                                        batch_format="pyarrow")
    return [out.to_dict("list"), cad.from_pandas(df).take_all(),
            cad.from_arrow(pa.table({"q": [1.5, 2.5]})).take_all(), by_pandas.take_all(),
            by_arrow.take_all()]


ARROW_CASES = {"parquet_csv", "pandas_arrow"}
results = {}
for name, fn in sorted((n[5:], f) for n, f in list(globals().items()) if n.startswith("case_")):
    try:
        results[name] = canon(fn())
    except Exception as e:  # a remote ImportError arrives as the task's error
        results[name] = {"error": f"{type(e).__name__}: {e}"}
if pkg.endswith("_torch"):
    @ca.remote
    def loaded():
        return sorted(m for m in ("pyarrow", "pandas", "torch") if m in sys.modules)

    results["_modules"] = {"driver": sorted(m for m in ("pyarrow", "pandas", "torch")
                                            if m in sys.modules),
                           "workers": ca.get([loaded.remote() for _ in range(4)], timeout=60)}
with open(out_path, "w") as f:
    json.dump(results, f)
ca.shutdown()
'''

CASES = ("range", "from_items", "from_numpy", "map_filter_flat_map",
         "map_batches_tasks_and_fusion", "map_batches_actors", "column_ops", "sort", "groupby",
         "shuffle_and_repartition", "limit_union_zip", "split", "iter_batches",
         "take_batch_and_aggregates", "tensors", "generator", "write_read_numpy_json_text",
         "parquet_csv", "pandas_arrow")
ARROW_CASES = ("parquet_csv", "pandas_arrow")

BLOCKER = textwrap.dedent('''
    import sys

    class _Hidden:
        """pyarrow and pandas are not installed, as far as this process knows."""

        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("pyarrow", "pandas"):
                raise ImportError(f"No module named {name!r}")
            return None

    sys.meta_path.insert(0, _Hidden())
''')


@pytest.fixture(scope="module")
def parity_runs():
    """The program under the JAX package, the port, and the port with
    pyarrow and pandas hidden: three subprocesses, one after another (one
    cluster at a time keeps the load on a shared machine low)."""
    tmp = tempfile.mkdtemp()
    blocker_dir = os.path.join(tmp, "hide_arrow")
    os.makedirs(blocker_dir)
    with open(os.path.join(blocker_dir, "sitecustomize.py"), "w") as f:
        f.write(BLOCKER)
    runs = {"jax": ("cluster_anywhere_tpu", REPO), "port": ("cluster_anywhere_tpu_torch", REPO),
            "port_no_arrow": ("cluster_anywhere_tpu_torch", blocker_dir + os.pathsep + REPO)}
    results = {}
    for key, (pkg, path) in runs.items():
        env = dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu",
                   TMPDIR=os.path.join(tmp, key))  # each run's own sessions
        os.makedirs(env["TMPDIR"])
        out = os.path.join(tmp, key + ".json")
        proc = subprocess.run([sys.executable, "-c", PROGRAM, pkg, out], env=env, cwd="/",
                              capture_output=True, text=True, timeout=2 * T)
        assert proc.returncode == 0, (key, proc.stderr[-3000:])
        with open(out) as f:
            results[key] = json.load(f)
    return results


@pytest.mark.parametrize("case", CASES)
def test_pipeline_matches_the_jax_package(parity_runs, case):
    jax_rows, port_rows = parity_runs["jax"][case], parity_runs["port"][case]
    assert "error" not in port_rows and "error" not in jax_rows, (port_rows, jax_rows)
    assert port_rows == jax_rows


@pytest.mark.parametrize("case", CASES)
def test_pipeline_rows_with_pyarrow_hidden(parity_runs, case):
    got = parity_runs["port_no_arrow"][case]
    if case in ARROW_CASES:
        assert "ImportError" in got["error"]
        assert "needs the pyarrow package" in got["error"] or "No module named 'pandas'" in got["error"]
    else:
        assert got == parity_runs["port"][case]


def test_no_process_of_the_hidden_run_loaded_pyarrow(parity_runs):
    mods = parity_runs["port_no_arrow"]["_modules"]
    assert mods["driver"] == []
    assert mods["workers"] == [[]] * 4  # nor torch: the CPU workers stay torch-free


def test_importing_data_loads_no_torch_no_jax_no_arrow():
    code = ("import sys, cluster_anywhere_tpu_torch.data\n"
            "print(sorted(m for m in ('torch', 'jax', 'cluster_anywhere_tpu', 'pyarrow', 'pandas')"
            " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=T, cwd="/")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture(scope="module")
def cluster():
    if ca.is_initialized():
        ca.shutdown()
    # one GPU declared, none present: GPU-pool placement runs on the CPU
    info = ca.init(num_cpus=2, num_gpus=1)
    yield info
    ca.shutdown()


def _mixed():
    return cad.range(40, override_num_blocks=3).map(
        lambda r: {"a": r["id"], "x": float(r["id"]) / 4, "img": np.full((2, 3), r["id"]),
                   "tag": f"t{r['id']}"})


@pytest.mark.parametrize("prefetch", [0, 1, 3])
@pytest.mark.parametrize("dtypes, want", [
    (None, {"a": torch.int64, "x": torch.float64, "img": torch.int64}),
    ("float32", {"a": torch.float32, "x": torch.float32, "img": torch.float32}),
    ({"a": torch.int32, "x": "bfloat16"}, {"a": torch.int32, "x": torch.bfloat16,
                                           "img": torch.int64}),
])
def test_iter_torch_batches_on_the_host_equals_the_numpy_batches(cluster, prefetch, dtypes, want):
    ds = _mixed()
    ref = list(ds.iter_batches(batch_size=16))
    got = list(ds.iter_torch_batches(batch_size=16, dtypes=dtypes, device="cpu",
                                     prefetch=prefetch))
    assert [len(b["a"]) for b in got] == [16, 16, 8]
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        assert g["tag"].dtype == object and g["tag"].tolist() == r["tag"].tolist()
        for k, dt in want.items():
            assert g[k].device.type == "cpu" and g[k].dtype == dt
            assert torch.equal(g[k], torch.from_numpy(r[k]).to(dt))


def test_iter_torch_batches_defaults_to_the_card(cluster, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(iter(cad.range(4).iter_torch_batches(batch_size=2)))


def test_iter_torch_batches_refuses_a_sharding(cluster):
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        next(iter(cad.range(4).iter_torch_batches(batch_size=2, device="cpu", sharding=object())))


def test_from_torch_rows(cluster):
    class Squares(torch.utils.data.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return torch.tensor(i * i)

    assert cad.from_torch(Squares()).take_all() == [i * i for i in range(6)]


def _view_probe():
    """An actor UDF reporting the CUDA_VISIBLE_DEVICES its worker sees;
    made in a function, so it travels by value to the worker."""
    class ViewProbe:
        def __call__(self, batch):
            view = os.environ.get("CUDA_VISIBLE_DEVICES")
            return {"id": batch["id"], "view": np.asarray([str(view)] * len(batch["id"]), object)}

    return ViewProbe


def test_gpu_actor_pool_lands_in_the_gpu_pool(cluster):
    probe = _view_probe()
    on_gpu = cad.range(6).map_batches(probe, concurrency=1, num_gpus=1).take_all()
    on_cpu = cad.range(6).map_batches(probe, concurrency=1).take_all()
    assert {r["view"] for r in on_cpu} == {""}
    assert {r["view"] for r in on_gpu} == {str(os.environ.get("CUDA_VISIBLE_DEVICES"))}
    assert [r["id"] for r in on_gpu] == list(range(6))


def test_gpu_actor_pool_larger_than_the_cluster_is_refused(cluster):
    from cluster_anywhere_tpu_torch.util import state

    before = len(state.list_actors())
    ds = cad.range(6).map_batches(_view_probe(), concurrency=2, num_gpus=1)
    with pytest.raises(ValueError, match=r"2 actors of 1 GPU each need 2 GPUs.*cluster has 1"):
        ds.take_all()
    assert len(state.list_actors()) == before
