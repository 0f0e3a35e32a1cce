"""The port's LLM deployments on its Serve (cluster_anywhere_tpu_torch.llm
build_llm_deployment / build_continuous_llm_deployment), on the CPU with
device="cpu": a handle call and a token stream, concurrent HTTP POSTs and
an SSE stream through the proxy on a free port, user_config reaching
reconfigure, and the slice as a whole against the JAX package: one saved
checkpoint, served in-process by the JAX ContinuousLLMServer and over HTTP
by the port's deployment, gives the same greedy text in fp32.

Every wait has a timeout, so a fault fails the test instead of hanging.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import jax

import cluster_anywhere_tpu_torch as ca
from cluster_anywhere_tpu.llm import _params_io as jio
from cluster_anywhere_tpu.llm import processor as jproc
from cluster_anywhere_tpu.llm import serve_llm as jserve
from cluster_anywhere_tpu.models import transformer as jtf
from cluster_anywhere_tpu_torch import llm, serve

T = 60  # seconds: the bound on every wait of this file
FP32 = {"dtype": "float32"}


@pytest.fixture(scope="module", autouse=True)
def cluster():
    if ca.is_initialized():
        ca.shutdown()
    ca.init(num_cpus=4)
    serve.start(port=0)  # the OS picks a free port
    yield
    serve.shutdown()
    ca.shutdown()


@pytest.fixture(scope="module")
def base_url(cluster):
    return ca.get(ca.get_actor(serve.PROXY_NAME).ready.remote(), timeout=T)


def _post(url, body, accept=None):
    """One POST, retried while the proxy has not learned the route yet;
    the JSON answer, or with accept=text/event-stream the SSE events."""
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
        return [json.loads(ln[len("data: "):]) for ln in raw.splitlines()
                if ln.startswith("data: ")]
    return json.loads(raw)


def _concurrently(fn, args):
    out, errs = {}, []

    def run(i, a):
        try:
            out[i] = fn(a)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, a)) for i, a in enumerate(args)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * T)
    assert not errs and not any(t.is_alive() for t in threads), errs
    return [out[i] for i in range(len(args))]


def test_llm_deployment_call_and_stream():
    """tests/test_llm.py::test_llm_serve_deployment through the port."""
    app = llm.build_llm_deployment(
        llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny"), max_new_tokens=3), device="cpu")
    assert app.deployment.config.num_gpus == 0  # a CPU replica holds no GPU
    handle = serve.run(app, name="llm_test", route_prefix="/llm_test")
    out = handle.remote({"prompt": "hello"}).result(timeout_s=T)
    assert out["prompt"] == "hello" and out["num_generated_tokens"] == 3
    assert isinstance(out["generated_text"], str)
    toks = list(handle.options(method_name="stream", stream=True).remote(
        {"prompt": "hi", "max_new_tokens": 4}))
    assert len(toks) == 4 and all("token_id" in t and "text" in t for t in toks)
    serve.delete("llm_test")


def test_user_config_reaches_reconfigure():
    dep = serve.deployment(llm.LLMServer, name="llm_cfg", num_gpus=0,
                           user_config={"max_new_tokens": 5, "temperature": 0.0})
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny"), max_new_tokens=2)
    handle = serve.run(dep.bind(cfg, "cpu"), name="llm_cfg", route_prefix="/llm_cfg")
    assert handle.remote({"prompt": "hi"}).result(timeout_s=T)["num_generated_tokens"] == 5
    serve.delete("llm_cfg")


def test_deployments_default_to_one_gpu_on_the_card():
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny"))
    assert llm.build_llm_deployment(cfg).deployment.config.num_gpus == 1
    app = llm.build_continuous_llm_deployment(cfg, slots=4)
    assert app.deployment.config.num_gpus == 1 and app.args == (cfg, 4, None)
    assert llm.build_continuous_llm_deployment(cfg, num_gpus=2).deployment.config.num_gpus == 2


def test_continuous_deployment_over_http_and_sse(base_url):
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny", config_overrides=FP32),
                              max_prompt_len=16, max_new_tokens=6)
    app = llm.build_continuous_llm_deployment(cfg, slots=4, sse_ingress=True, device="cpu")
    handle = serve.run(app, name="cllm", route_prefix="/cllm")
    prompts = ["hi", "hello there", "abc", "the quick"]
    answers = _concurrently(lambda p: _post(base_url + "/cllm", {"prompt": p}), prompts)
    assert [a["prompt"] for a in answers] == prompts
    assert all(a["num_generated_tokens"] == 6 for a in answers)
    # the same text through the handle: HTTP adds nothing to the answer
    assert handle.remote({"prompt": "abc"}).result(timeout_s=T) == answers[2]
    events = _post(base_url + "/cllm", {"prompt": "hello there"}, accept="text/event-stream")
    streamed = handle.options(method_name="stream", stream=True).remote({"prompt": "hello there"})
    assert [e["token_id"] for e in events] == [t["token_id"] for t in streamed]
    assert len(events) == 6
    with pytest.raises(Exception, match="item 4"):
        handle.options(method_name="dag_stream").remote({"prompt": "x"}).result(timeout_s=T)
    # the pump ships the batcher's counters as cluster metrics about once a second
    from cluster_anywhere_tpu_torch.util.metrics import get_metrics_snapshot

    deadline, steps = time.monotonic() + T, 0
    while steps < 5 and time.monotonic() < deadline:
        time.sleep(0.5)
        rec = get_metrics_snapshot().get("ca_serve_decode_steps_total", {})
        steps = sum(rec.get("data", {}).values())
    assert steps >= 5
    serve.delete("cllm")


def test_http_deployment_matches_jax_continuous_server(base_url, tmp_path):
    """The slice against the JAX package: weights saved by the JAX
    _params_io, greedy fp32, equal text token for token."""
    spec = dict(preset="tiny", config_overrides=FP32)
    jcfg = jproc.ModelSpec(**spec).transformer_config(259)
    ckpt = str(tmp_path / "ckpt")
    jio.save_params(jtf.init_params(jax.random.key(4), jcfg), ckpt)
    kw = dict(max_prompt_len=24, max_new_tokens=8)
    prompts = ["hello", "the quick brown fox", "", "serve me"]
    jsrv = jserve.ContinuousLLMServer(
        jproc.ProcessorConfig(model=jproc.ModelSpec(**spec, params_path=ckpt), **kw), slots=4)
    try:
        want = [jsrv({"prompt": p})["generated_text"] for p in prompts]
        want_ids = [[t["token_id"] for t in jsrv.stream({"prompt": p})] for p in prompts]
    finally:
        jsrv.close()
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(**spec, params_path=ckpt), **kw)
    handle = serve.run(llm.build_continuous_llm_deployment(cfg, slots=4, device="cpu"),
                       name="parity", route_prefix="/parity")
    got = _concurrently(lambda p: _post(base_url + "/parity", {"prompt": p}), prompts)
    assert [g["generated_text"] for g in got] == want
    got_ids = [[t["token_id"] for t in handle.options(method_name="stream", stream=True).remote(
        {"prompt": p})] for p in prompts]
    assert got_ids == want_ids
    serve.delete("parity")


def test_grpc_ingress_reaches_the_llm_deployment():
    """The gRPC ingress (pickled and msgpack-typed surfaces) in front of
    the continuous deployment; the card's tests cover HTTP only."""
    pytest.importorskip("grpc")
    cfg = llm.ProcessorConfig(model=llm.ModelSpec(preset="tiny"), max_prompt_len=16,
                              max_new_tokens=3)
    serve.run(llm.build_continuous_llm_deployment(cfg, slots=2, device="cpu"), name="grpc_llm",
              route_prefix="/grpc_llm")
    target = serve.start_grpc_proxy()
    out = serve.grpc_call(target, "grpc_llm", {"prompt": "hi"}, timeout=T)
    assert out["prompt"] == "hi" and out["num_generated_tokens"] == 3
    deadline = time.monotonic() + T
    while "grpc_llm" not in serve.grpc_list_applications(target):
        assert time.monotonic() < deadline, "the gRPC proxy never listed the application"
        time.sleep(0.2)
    typed = serve.grpc_call_typed(target, "grpc_llm", {"prompt": "hi"}, timeout=T)
    assert typed == out  # greedy: the same answer through the typed surface
    serve.delete("grpc_llm")
