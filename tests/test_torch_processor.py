"""The port's batch LLM inference (cluster_anywhere_tpu_torch.llm.Processor /
build_llm_processor) against the JAX package's, on the CPU.

One checkpoint, saved by the JAX package's _params_io, runs in both
packages' Processors over the same rows with the same preprocess and
postprocess: the JAX one in a subprocess with its own cluster, the port's
with device="cpu" on a port cluster in this process.  Every row's greedy
tokens (their dtype too), text and templated prompt must be equal.  Then
the port's own rules: on the card each inference actor asks for one GPU, a
concurrency the cluster's GPUs cannot hold is refused before any actor
starts, an actor that finds no card fails the run instead of falling back to
the CPU, and build_llm_processor without a card raises at once.

Every wait has a timeout, so a fault fails the test instead of hanging.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax

import cluster_anywhere_tpu_torch as ca
import cluster_anywhere_tpu_torch.data as cad
from cluster_anywhere_tpu.llm import _params_io as jio
from cluster_anywhere_tpu.llm import processor as jproc
from cluster_anywhere_tpu.models import transformer as jtf
from cluster_anywhere_tpu_torch import llm
from cluster_anywhere_tpu_torch.llm import processor as port_proc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60  # seconds: the bound on every wait of this file
SPEC = dict(preset="tiny", config_overrides={"dtype": "float32"})

# (ProcessorConfig fields, number of rows, blocks): a ragged last batch (7
# rows in one block, batches of 3), no template (two blocks of 3 rows,
# batch_size 4), two actors (four blocks of 2 rows)
CASES = {
    "template_system_ragged": (dict(apply_chat_template=True, system_prompt="Answer briefly.",
                                    batch_size=3), 7, 1),
    "no_template": (dict(batch_size=4), 6, 2),
    "template_concurrency_2": (dict(apply_chat_template=True, batch_size=2, concurrency=2), 8, 4),
}

STAGES = r'''
def preprocess(row):
    return {"id": row["id"], "prompt": "item %d: %s" % (row["id"], row["text"])}


def postprocess(row):
    return {"id": row["id"], "prompt": row["prompt"], "text": row["generated_text"],
            "tokens": row["generated_tokens"].tolist(),
            "dtype": str(row["generated_tokens"].dtype)}


def items(n):
    words = ["cluster", "actor", "task", "object", "node", "drain", "lineage", "shed"]
    return [{"id": i, "text": " ".join(words[(i * 3 + j) % 8] for j in range(1 + i % 4))}
            for i in range(n)]


def run(cad, llm_mod, ckpt, case, **kw):
    fields, n, blocks = case
    cfg = llm_mod.ProcessorConfig(
        model=llm_mod.ModelSpec(preset="tiny", config_overrides={"dtype": "float32"},
                                params_path=ckpt),
        max_prompt_len=48, max_new_tokens=6, **fields)
    processor = llm_mod.build_llm_processor(cfg, preprocess=preprocess,
                                            postprocess=postprocess, **kw)
    rows = processor(cad.from_items(items(n), override_num_blocks=blocks)).take_all()
    # a tensor column comes back as one ndarray a row: a list, for JSON
    return sorted(({k: getattr(v, "tolist", lambda: v)() for k, v in r.items()} for r in rows),
                  key=lambda r: r["id"])
'''

# the same stages for the port's runs, in a namespace no worker can import,
# so that they travel by value
_stages = {"__name__": "processor_stages"}
exec(STAGES, _stages)
run = _stages["run"]

JAX_PROGRAM = STAGES + r'''
import json, sys
import cluster_anywhere_tpu as ca
import cluster_anywhere_tpu.data as cad
from cluster_anywhere_tpu import llm

ckpt, cases, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
ca.init(num_cpus=4)
with open(out, "w") as f:
    json.dump({name: run(cad, llm, ckpt, case) for name, case in cases.items()}, f)
ca.shutdown()
'''


@pytest.fixture(scope="module")
def checkpoint():
    tmp = tempfile.mkdtemp()
    ckpt = os.path.join(tmp, "ckpt")
    jio.save_params(jtf.init_params(jax.random.key(4),
                                    jproc.ModelSpec(**SPEC).transformer_config(259)), ckpt)
    return ckpt


@pytest.fixture(scope="module")
def jax_rows(checkpoint):
    """The JAX package's Processor over every case, in a subprocess started
    before the port's runs so that the two overlap."""
    tmp = os.path.dirname(checkpoint)
    out = os.path.join(tmp, "jax.json")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", TMPDIR=tmp)
    proc = subprocess.Popen([sys.executable, "-c", JAX_PROGRAM, checkpoint, json.dumps(CASES), out],
                            env=env, cwd="/", stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result():
        try:
            _, err = proc.communicate(timeout=4 * T)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, err[-3000:]
        with open(out) as f:
            return json.load(f)

    box = []
    yield lambda: box[0] if box else box.append(result()) or box[0]
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module", autouse=True)
def cluster():
    if ca.is_initialized():
        ca.shutdown()
    # one GPU declared, none present: GPU-pool placement runs on the CPU
    info = ca.init(num_cpus=4, num_gpus=1)
    yield info
    ca.shutdown()


@pytest.mark.parametrize("case", CASES)
def test_processor_matches_the_jax_package(checkpoint, jax_rows, case):
    got = run(cad, llm, checkpoint, CASES[case], device="cpu")
    want = jax_rows()[case]
    n = CASES[case][1]
    assert [r["id"] for r in got] == list(range(n))
    assert all(r["dtype"] == "int32" and len(r["tokens"]) == 6 for r in got)
    assert got == want
    if CASES[case][0].get("apply_chat_template"):
        system = CASES[case][0].get("system_prompt")
        head = f"<|system|>{system}<|user|>" if system else "<|user|>"
        assert all(r["prompt"].startswith(head) and r["prompt"].endswith("<|assistant|>")
                   for r in got)


def test_cpu_stages_load_no_torch():
    """The template, preprocess and postprocess run in CPU-pool workers
    that never import torch (only the inference actor does)."""
    def pre(row):
        import sys

        return {"prompt": row["text"], "pre": "torch" in sys.modules}

    def post(row):
        import sys

        return {"pre": row["pre"], "post": "torch" in sys.modules, "n": len(row["generated_tokens"])}

    cfg = llm.ProcessorConfig(model=llm.ModelSpec(**SPEC), max_prompt_len=16, max_new_tokens=2,
                              apply_chat_template=True, system_prompt="s", batch_size=2)
    rows = llm.build_llm_processor(cfg, preprocess=pre, postprocess=post, device="cpu")(
        cad.from_items([{"text": f"q{i}"} for i in range(5)])).take_all()
    assert rows == [{"pre": False, "post": False, "n": 2}] * 5


def _view_worker():
    """Stands in for _InferenceWorker in the Processor's map_batches call
    and reports the CUDA_VISIBLE_DEVICES of the worker it lands in; made in
    a function, so it travels by value to that worker."""
    class ViewWorker:
        def __init__(self, cfg, device):
            self.view = str(os.environ.get("CUDA_VISIBLE_DEVICES"))
            self.device = device

        def __call__(self, batch):
            n = len(batch["prompt"])
            return {"view": np.asarray([self.view] * n, object),
                    "device": np.asarray([str(self.device)] * n, object)}

    return ViewWorker


def test_on_the_card_each_inference_actor_asks_for_one_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # the driver believes in a card
    monkeypatch.setattr(port_proc, "_InferenceWorker", _view_worker())
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(**SPEC), batch_size=2)
    ds = llm.build_llm_processor(cfg)(cad.from_items([{"prompt": "x"}] * 3))
    op = ds._plan.ops[-1]
    assert (op.num_gpus, op.concurrency, op.batch_size, op.fn_constructor_args) == (1.0, 1, 2,
                                                                                    (cfg, None))
    rows = ds.take_all()
    # the GPU pool keeps the host's view; a CPU-pool worker would see ""
    assert rows == [{"view": str(os.environ.get("CUDA_VISIBLE_DEVICES")), "device": "None"}] * 3
    cpu_op = llm.build_llm_processor(cfg, device="cpu")(cad.from_items([{"prompt": "x"}]))._plan.ops[-1]
    assert cpu_op.num_gpus == 0.0


def test_concurrency_beyond_the_clusters_gpus_is_refused_before_any_actor(monkeypatch):
    from cluster_anywhere_tpu_torch.util import state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(**SPEC), concurrency=2)
    before = len(state.list_actors())
    ds = llm.build_llm_processor(cfg)(cad.from_items([{"prompt": "x"}] * 4))
    with pytest.raises(ValueError, match=r"2 actors of 1 GPU each need 2 GPUs.*cluster has 1"):
        ds.take_all()
    assert len(state.list_actors()) == before


def test_an_actor_without_a_card_fails_the_run(monkeypatch):
    """No fallback: the actor resolves the card in its own process, finds
    none, and the run fails rather than generating on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(**SPEC), max_prompt_len=8, max_new_tokens=1)
    ds = llm.build_llm_processor(cfg)(cad.from_items([{"prompt": "x"}]))
    with pytest.raises(Exception, match="no CUDA device"):
        ds.take_all()


def test_build_llm_processor_without_a_card_raises_at_once(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llm.build_llm_processor(llm.ProcessorConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llm.Processor(llm.ProcessorConfig(), device="cuda")
