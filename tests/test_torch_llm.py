"""Parity of the port's LLM serving layer (cluster_anywhere_tpu_torch.llm)
with the JAX package, on the CPU at a small size and without a cluster.

Both packages run on the same weights (JAX params converted with
from_jax_params, or one npz checkpoint loaded by both), in fp32, where
greedy tokens must be identical.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cluster_anywhere_tpu.llm import _params_io as jio
from cluster_anywhere_tpu.llm import continuous as jcont
from cluster_anywhere_tpu.llm import processor as jproc
from cluster_anywhere_tpu.models import transformer as jtf
from cluster_anywhere_tpu_torch import llm
from cluster_anywhere_tpu_torch.llm import _params_io as tio
from cluster_anywhere_tpu_torch.llm import continuous as tcont
from cluster_anywhere_tpu_torch.llm import processor as tproc
from cluster_anywhere_tpu_torch.llm.serve_llm import _parse_body
from cluster_anywhere_tpu_torch.models import generate as tgen
from cluster_anywhere_tpu_torch.models import transformer as ttf
from cluster_anywhere_tpu_torch.models.convert import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP32 = {"dtype": "float32"}


def _pair(seed=0, **widths):
    widths = {**dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_head=8,
                     d_ff=64), **widths}
    jcfg = jtf.TransformerConfig(**widths, dtype=jnp.float32)
    jparams = jtf.init_params(jax.random.key(seed), jcfg)
    tcfg = ttf.TransformerConfig(**widths, dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, from_jax_params(tree, tcfg, device="cpu")


def _drive(cb, script):
    """Run a submit/step script on a batcher of either package; returns each
    request's tokens, the per-step output membership, and the stats."""
    reqs, members = [], []
    for kind, arg in script:
        if kind == "submit":
            prompt, n = arg
            reqs.append(cb.submit(prompt, max_new_tokens=n, temperature=0.0))
        elif kind == "pump":
            while cb.has_work:
                members.append(sorted(cb.step()))
    return [r.out_tokens for r in reqs], members, dict(cb.stats)


def test_byte_tokenizer_roundtrip():
    tok = llm.ByteTokenizer()
    ids = tok.encode("hello world")
    assert ids[0] == tok.bos_id and tok.decode(ids) == "hello world"
    assert tok.decode(tok.encode("émojis 🎉")) == "émojis 🎉"
    assert tok.encode("ab") == jproc.ByteTokenizer().encode("ab")


@pytest.mark.parametrize("slots,buckets", [(2, (8,)), (2, (8, 16)), (3, (16,))])
def test_continuous_batcher_slot_churn_matches_jax(slots, buckets):
    """Same requests, same slot churn: every request's tokens, every step's
    membership and the stats equal the JAX batcher's."""
    jcfg, jparams, tcfg, model = _pair()
    script = [
        ("submit", ([1, 2], 2)), ("submit", ([3, 4], 10)), ("submit", ([5, 6], 3)),
        ("submit", ([7, 8, 9, 10, 11], 6)), ("pump", None),
        ("submit", ([1, 5, 9], 6)), ("pump", None),
    ]
    want = _drive(jcont.ContinuousBatcher(jparams, jcfg, slots=slots, t_max=64,
                                          prefill_buckets=buckets), script)
    got = _drive(tcont.ContinuousBatcher(model, tcfg, slots=slots, t_max=64,
                                         prefill_buckets=buckets), script)
    assert got == want


def test_continuous_batcher_matches_sequential_generate():
    """A request decoded next to others gets the tokens it gets alone
    through generate() (greedy)."""
    _, _, tcfg, model = _pair()
    prompts = [[1, 5, 9], [2, 3], [7, 8, 9, 10, 11]]
    want = [tgen.generate(model, torch.tensor([p]), cfg=tcfg, max_new_tokens=6)[0].tolist()
            for p in prompts]
    cb = tcont.ContinuousBatcher(model, tcfg, slots=2, t_max=64, prefill_buckets=(8, 16))
    reqs = [cb.submit(p, max_new_tokens=6) for p in prompts]
    done = cb.pump()
    assert len(done) == 3 and [r.out_tokens for r in reqs] == want
    assert cb.stats["decode_steps"] < 15


def test_prefix_cache_hit_equals_miss_and_stats_match_jax():
    jcfg, jparams, tcfg, model = _pair(n_heads=2, n_kv_heads=2, d_head=16)
    sys_prefix = list(range(1, 33))
    script = [
        ("submit", (sys_prefix + [40, 41, 42], 8)), ("pump", None),
        ("submit", (sys_prefix + [40, 41, 42], 8)), ("pump", None),
        ("submit", (sys_prefix + [50, 51], 8)), ("pump", None),
        ("submit", ([100 % 64 + i % 8 for i in range(32)] + [1, 2], 2)),
        ("submit", ([200 % 64 + i % 8 for i in range(32)] + [1, 2], 2)), ("pump", None),
        ("submit", (sys_prefix + [40, 41, 42], 8)), ("pump", None),
    ]
    kw = dict(slots=2, t_max=128, prefill_buckets=(32, 64), prefix_cache_entries=2,
              prefix_block=16)
    jcb = jcont.ContinuousBatcher(jparams, jcfg, **kw)
    tcb = tcont.ContinuousBatcher(model, tcfg, **kw)
    want, got = _drive(jcb, script), _drive(tcb, script)
    assert got == want
    toks, _, stats = got
    assert toks[1] == toks[0], "warm hit diverged from cold miss"
    assert stats["prefix_hits"] >= 2 and stats["prefix_misses"] >= 2
    assert len(tcb.prefix_cache) <= 2 and tcb.prefix_cache.evictions == jcb.prefix_cache.evictions
    # the prefix-cache admit path equals a cache-less full prefill
    plain = tcont.ContinuousBatcher(model, tcfg, slots=2, t_max=128, prefill_buckets=(32, 64))
    r = plain.submit(sys_prefix + [40, 41, 42], max_new_tokens=8)
    plain.pump()
    assert r.out_tokens == toks[0]


def test_batcher_cancel_frees_slot():
    _, _, tcfg, model = _pair()
    cb = tcont.ContinuousBatcher(model, tcfg, slots=1, t_max=64, prefill_buckets=(8,))
    ra = cb.submit([1, 2, 3], max_new_tokens=40)
    rb = cb.submit([4, 5], max_new_tokens=2)
    assert cb.cancel(rb.request_id) is True  # queued
    cb.step()
    assert not ra.done and cb.cancel(ra.request_id) is True  # slotted
    assert ra.done and cb.stats["cancelled"] == 2 and cb.cancel(ra.request_id) is False
    assert not cb.has_work
    with pytest.raises(ValueError):
        cb.submit(list(range(60)), max_new_tokens=8)


def test_sample_rowwise_masks_and_greedy_rows():
    logits = torch.tensor([[3.0, 2.0, 1.0, 0.0]] * 3)
    gen = torch.Generator().manual_seed(0)
    temps = torch.tensor([0.0, 2.0, 2.0])
    top_ks = torch.tensor([0, 1, 0])
    top_ps = torch.tensor([1.0, 1.0, 0.4])
    for _ in range(20):
        out = tcont._sample_rowwise(logits, gen, temps, top_ks, top_ps)
        # row 0 greedy, row 1 top-1, row 2 nucleus 0.4 keeps only the top token (p=0.455)
        assert out.tolist() == [0, 0, 0]


def test_checkpoint_from_jax_serves_same_text(tmp_path):
    """JAX save_params -> port load_params -> the port's _InferenceWorker
    gives the JAX worker's greedy text."""
    spec = dict(preset="tiny", config_overrides=FP32)
    jcfg = jproc.ModelSpec(**spec).transformer_config(259)
    jio.save_params(jtf.init_params(jax.random.key(3), jcfg), str(tmp_path / "ckpt"))
    kw = dict(max_prompt_len=24, max_new_tokens=6)
    jw = jproc._InferenceWorker(jproc.ProcessorConfig(
        model=jproc.ModelSpec(**spec, params_path=str(tmp_path / "ckpt")), **kw))
    tw = tproc._InferenceWorker(tproc.ProcessorConfig(
        model=tproc.ModelSpec(**spec, params_path=str(tmp_path / "ckpt")), **kw), device="cpu")
    batch = {"prompt": np.asarray(["hello", "the quick brown fox", ""], dtype=object)}
    want, got = jw(batch), tw(batch)
    np.testing.assert_array_equal(got["generated_tokens"], np.asarray(want["generated_tokens"]))
    assert list(got["generated_text"]) == list(want["generated_text"])
    streamed = [t["token_id"] for t in tw.stream("hello")]
    assert streamed == got["generated_tokens"][0].tolist()
    # and the port saves what the JAX package loads
    tio.save_params(tw.params, str(tmp_path / "back"))
    back = jio.load_params(str(tmp_path / "back"))
    np.testing.assert_array_equal(np.asarray(back["blocks"]["wq"]),
                                  np.asarray(jio.load_params(str(tmp_path / "ckpt"))["blocks"]["wq"]))


def test_llm_server_call_and_stream():
    srv = llm.LLMServer(llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny"), max_new_tokens=3),
                        device="cpu")
    out = srv({"prompt": "hello"})
    assert out["prompt"] == "hello" and out["num_generated_tokens"] == 3
    assert isinstance(out["generated_text"], str)
    assert srv("hello") == out  # a bare string body, greedy
    toks = list(srv.stream({"prompt": "hi", "max_new_tokens": 4}))
    assert len(toks) == 4 and all("token_id" in t and "text" in t for t in toks)
    assert _parse_body("x") == {"prompt": "x"} and _parse_body({"prompt": "y"}) == {"prompt": "y"}


def test_continuous_llm_server_concurrent_requests():
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny", config_overrides=FP32),
                              max_prompt_len=16, max_new_tokens=8)
    srv = llm.ContinuousLLMServer(cfg, slots=4, device="cpu")
    try:
        prompts = ["hi", "hello there", "abc"]
        results = {}

        def call(p):
            results[p] = srv({"prompt": p})

        threads = [threading.Thread(target=call, args=(p,)) for p in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert set(results) == set(prompts)
        assert all(results[p]["num_generated_tokens"] == 8 for p in prompts)
        assert srv.cb.stats["admitted"] == 3 and srv.cb.stats["decode_steps"] < 21
        static = tproc._InferenceWorker(cfg, device="cpu")(
            {"prompt": np.asarray(["hello there"], dtype=object)})
        assert results["hello there"]["generated_text"] == str(static["generated_text"][0])
        streamed = list(srv.stream({"prompt": "abc"}))
        assert srv.tok.decode([t["token_id"] for t in streamed]) == results["abc"]["generated_text"]
        srv.check_health()
    finally:
        srv.close()
    assert not srv._pump.is_alive()


def test_continuous_llm_server_pump_death_fails_fast():
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny"), max_prompt_len=16,
                              max_new_tokens=8)
    srv = llm.ContinuousLLMServer(cfg, slots=4, device="cpu")
    try:
        orig_step = srv.cb.step
        calls = {"n": 0}

        def dying_step():
            calls["n"] += 1
            if calls["n"] >= 2:
                raise RuntimeError("simulated device OOM")
            return orig_step()

        srv.cb.step = dying_step
        errs = {}

        def call():
            try:
                srv({"prompt": "hello"})
                errs["v"] = None
            except RuntimeError as e:
                errs["v"] = e

        t = threading.Thread(target=call)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "caller stranded after pump death"
        assert errs["v"] is not None and "pump died" in str(errs["v"])
        with pytest.raises(RuntimeError, match="pump died"):
            srv.check_health()
        with pytest.raises(RuntimeError, match="pump died"):
            srv({"prompt": "after death"})
    finally:
        srv.close()


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX and the JAX package
    out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib, cluster_anywhere_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cluster_anywhere_tpu' or m.startswith('cluster_anywhere_tpu.')]\n"
        "print('LOADED', len([m for m in sys.modules if m.startswith('cluster_anywhere_tpu_torch')]))\n"
        "assert not bad, bad\n"
        "new = ['channel', 'channel.shm_channel', 'channel.device_transport', 'dag', 'dag.node',\n"
        "       'dag.operation', 'dag.compiled', 'serve.dag_stream', 'tune', 'tune.search_space',\n"
        "       'tune.search', 'tune.schedulers', 'tune.hyperband', 'tune.bohb', 'tune.pb2',\n"
        "       'tune.resource_changing', 'tune.external', 'tune.trial', 'tune.callbacks',\n"
        "       'tune.controller', 'tune.tuner', 'workflow', 'workflow.storage', 'workflow.api',\n"
        "       'cluster_utils', 'jobs', 'cli', 'dashboard', 'util.chaos', 'util.grafana',\n"
        "       'autoscaler', 'autoscaler.provider', 'autoscaler.reconciler']\n"
        "assert all('cluster_anywhere_tpu_torch.' + m in sys.modules for m in new)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split("LOADED")[1]) >= 131


@pytest.mark.parametrize("entry", ["init_params", "from_jax_params", "worker", "llm_server",
                                   "continuous_server"])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """With no GPU, entry points raise unless called with device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny"), max_prompt_len=8,
                              max_new_tokens=2)
    tcfg = cfg.model.transformer_config(259)
    calls = {
        "init_params": lambda **kw: ttf.init_params(tcfg, 0, **kw),
        "from_jax_params": lambda **kw: from_jax_params(_tiny_tree(tcfg), tcfg, **kw),
        "worker": lambda **kw: tproc._InferenceWorker(cfg, **kw),
        "llm_server": lambda **kw: llm.LLMServer(cfg, **kw),
        "continuous_server": lambda **kw: llm.ContinuousLLMServer(cfg, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    made = calls[entry](device="cpu")
    if hasattr(made, "close"):
        made.close()


def _tiny_tree(tcfg):
    from cluster_anywhere_tpu_torch.models.convert import to_jax_params

    return to_jax_params(ttf.init_params(tcfg, 0, device="cpu"))
