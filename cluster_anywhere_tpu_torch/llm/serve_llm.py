"""LLM serving classes and their Serve deployments (counterpart of
cluster_anywhere_tpu/llm/serve_llm.py): `LLMServer` answers each request with
one static generate() call; `ContinuousLLMServer` shares decode iterations
between concurrent requests through one ContinuousBatcher driven by a pump
thread; `StreamingLLMIngress` streams SSE from __call__.  The classes take a
Serve HTTP Request, a dict or a bare prompt string, and run in the caller's
process or as the replicas of `build_llm_deployment` /
`build_continuous_llm_deployment`.

`ContinuousLLMServer.dag_stream` streams tokens to the Serve proxy over a
pre-opened shm channel (serve/dag_stream.py), the proxy's default SSE
transport under `serve_compiled_dag`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from .processor import ByteTokenizer, ProcessorConfig, _gpus_for, _InferenceWorker, load_model


def _parse_body(request) -> Dict[str, Any]:
    """Accept a serve HTTP Request, a dict, or a bare prompt string — the
    one body parser every LLM deployment method shares."""
    from ..serve import Request

    if isinstance(request, Request):
        return request.json() if request.method == "POST" else dict(request.query_params)
    return request if isinstance(request, dict) else {"prompt": str(request)}


def _sampling_overrides(body: Dict[str, Any]) -> Dict[str, Any]:
    casts = {"max_new_tokens": int, "temperature": float, "top_k": int, "top_p": float}
    return {k: cast(body[k]) for k, cast in casts.items() if k in body}


class LLMServer:
    """Hosts one model; {"prompt": "...", "max_new_tokens": 16} ->
    {"prompt", "generated_text", "num_generated_tokens"}."""

    def __init__(self, config: ProcessorConfig, device=None):
        self.config = config
        self.worker = _InferenceWorker(config, device)

    def reconfigure(self, cfg: Dict[str, Any]):
        """Serve's user_config hook: new defaults for later requests."""
        if "max_new_tokens" in cfg:
            self.config.max_new_tokens = int(cfg["max_new_tokens"])
        if "temperature" in cfg:
            self.config.temperature = float(cfg["temperature"])

    def __call__(self, request) -> Dict[str, Any]:
        body = _parse_body(request)
        prompt = body.get("prompt", "")
        out = self.worker({"prompt": np.asarray([prompt], dtype=object)}, **_sampling_overrides(body))
        return {
            "prompt": prompt,
            "generated_text": str(out["generated_text"][0]),
            "num_generated_tokens": int(len(out["generated_tokens"][0])),
        }

    def stream(self, request):
        """Token-streaming twin of __call__: one {"token_id", "text"} per token."""
        body = _parse_body(request)
        yield from self.worker.stream(body.get("prompt", ""), **_sampling_overrides(body))


def build_llm_deployment(
    config: Optional[ProcessorConfig] = None,
    *,
    num_replicas: int = 1,
    num_gpus: Optional[float] = None,
    name: str = "LLMServer",
    device=None,
):
    """Returns a bound serve Application for `serve.run`.  device: where
    each replica runs the model (None means the card); num_gpus: GPUs per
    replica (None: 1 on the card, 0 with device="cpu")."""
    from .. import serve

    config = config or ProcessorConfig()
    dep = serve.deployment(
        LLMServer,
        name=name,
        num_replicas=num_replicas,
        num_gpus=_gpus_for(device, num_gpus),
        max_ongoing_requests=4,
    )
    return dep.bind(config, device)


class ContinuousLLMServer:
    """Iteration-level scheduling: concurrent requests share the decode loop
    through one ContinuousBatcher, and a request admits the moment a slot
    frees.  One background pump thread drives decode steps; caller threads
    submit and wait on a per-request token queue."""

    def __init__(self, config: ProcessorConfig, slots: int = 8, device=None):
        from .._device import resolve_device
        from .continuous import ContinuousBatcher

        self.config = config
        self.tok = config.tokenizer or ByteTokenizer()
        tcfg = config.model.transformer_config(self.tok.vocab_size)
        params = load_model(config, tcfg, resolve_device(device))
        self.cb = ContinuousBatcher(
            params, tcfg, slots=slots, t_max=config.max_prompt_len + config.max_new_tokens,
            prefill_buckets=(config.max_prompt_len,), top_k=config.top_k,
            prefix_cache_entries=config.prefix_cache_entries, prefix_block=config.prefix_block,
        )
        self._metrics_synced: dict = {}
        self._lock = threading.Lock()  # the batcher is single-threaded inside
        self._queues: dict = {}  # request_id -> queue of token ids (+ None at the end)
        self._reqs: dict = {}  # request_id -> Request (done detection)
        self._stop = False
        self._engine_error: Optional[BaseException] = None
        self._pump = threading.Thread(target=self._pump_loop, daemon=True, name="llm-pump")
        self._pump.start()

    def check_health(self):
        """Raises when the pump died: every request would hang otherwise."""
        if self._engine_error is not None:
            raise RuntimeError(f"LLM engine pump died: {self._engine_error!r}")

    def close(self):
        """Stop the pump thread (it holds the params and the KV cache)."""
        self._stop = True
        if self._pump.is_alive():
            self._pump.join(timeout=5)

    def __del__(self):  # best effort; close() is the contract
        try:
            self.close()
        except Exception:
            pass

    _llm_metrics: dict = {}  # class-level: one registry entry per process

    def _sync_engine_metrics(self):
        """Ship the batcher's counters (prefix-cache hits/misses/tokens
        reused, decode steps) as ca_serve_* cluster metrics."""
        if not self._llm_metrics:
            from ..util import metrics as m

            for key, name, desc in (
                ("prefix_hits", "ca_serve_prefix_hits_total",
                 "LLM admits that reused cached prefix KV rows"),
                ("prefix_misses", "ca_serve_prefix_misses_total",
                 "LLM admits that prefilled (and cached) their prefix"),
                ("prefix_tokens_reused", "ca_serve_prefix_tokens_reused_total",
                 "prompt tokens whose prefill was skipped via the prefix cache"),
                ("decode_steps", "ca_serve_decode_steps_total",
                 "continuous-batcher decode iterations"),
            ):
                self._llm_metrics[key] = m.Counter(name, desc)
        for key, counter in self._llm_metrics.items():
            cur = self.cb.stats.get(key, 0)
            delta = cur - self._metrics_synced.get(key, 0)
            if delta:
                counter.inc(delta)
                self._metrics_synced[key] = cur

    def _pump_loop(self):
        last_sync = 0.0
        while not self._stop:
            now = time.monotonic()
            if now - last_sync > 1.0:
                last_sync = now
                try:
                    self._sync_engine_metrics()
                except Exception:
                    pass  # metrics must never kill the decode pump
            try:
                with self._lock:
                    work = self.cb.has_work
                    out = self.cb.step() if work else {}
                    for rid, toks in out.items():
                        q = self._queues.get(rid)
                        if q is None:
                            continue
                        for t in toks:
                            q.put(t)
                        req = self._reqs.get(rid)
                        if req is not None and req.done:
                            q.put(None)
                            self._reqs.pop(rid, None)
            except Exception as e:
                # engine failure (device OOM, a shape bug): fail every waiting
                # request now, mark the server unhealthy, stop pumping
                with self._lock:
                    self._engine_error = e
                    for q in self._queues.values():
                        q.put(e)
                    self._queues.clear()
                    self._reqs.clear()
                return
            if not work:
                time.sleep(0.005)

    def _submit(self, body) -> tuple:
        prompt = body.get("prompt", "")
        ids = self.tok.encode(prompt)[: self.config.max_prompt_len]
        top_k = body.get("top_k")
        q: queue.Queue = queue.Queue()
        with self._lock:
            if self._engine_error is not None:
                raise RuntimeError(
                    f"LLM engine pump died: {self._engine_error!r}"
                ) from self._engine_error
            # the queue is registered under the submit lock, so the pump's
            # next step finds it before any token flows
            req = self.cb.submit(
                ids,
                max_new_tokens=int(body.get("max_new_tokens", self.config.max_new_tokens)),
                temperature=float(body.get("temperature", self.config.temperature)),
                top_k=None if top_k is None else int(top_k),
                top_p=float(body.get("top_p", 1.0)),
            )
            self._queues[req.request_id] = q
            self._reqs[req.request_id] = req
        return prompt, req, q

    def _forget(self, req):
        with self._lock:
            self._queues.pop(req.request_id, None)
            self._reqs.pop(req.request_id, None)
            if not req.done:
                # the consumer left mid-decode: free the slot now
                self.cb.cancel(req.request_id)

    def _tokens(self, q):
        while True:
            t = q.get(timeout=120)
            if t is None:
                return
            if isinstance(t, BaseException):
                raise RuntimeError(f"LLM engine pump died: {t!r}") from t
            yield t

    def __call__(self, request) -> Dict[str, Any]:
        prompt, req, q = self._submit(_parse_body(request))
        try:
            toks = list(self._tokens(q))
        finally:
            self._forget(req)
        return {
            "prompt": prompt,
            "generated_text": self.tok.decode(toks),
            "num_generated_tokens": len(toks),
        }

    def stream(self, request):
        """Per-token streaming while other requests decode in the same loop."""
        _, req, q = self._submit(_parse_body(request))
        try:
            for t in self._tokens(q):
                yield {"token_id": int(t), "text": self.tok.decode([t])}
        finally:
            self._forget(req)

    def dag_stream(self, request) -> dict:
        """Compiled-DAG streaming: decode-step -> detokenize -> stream-out
        without a per-token RPC.  Submits the prompt, pre-opens a shm
        channel, and returns its spec; a forwarder thread pushes
        {"token_id","text"} frames into the channel and the proxy-side
        DagStreamReader futex-waits on them.  The only RPC left on the hot
        path is this handshake."""
        from ..channel.shm_channel import BufferedShmChannel, ChannelClosedError
        from ..core.config import get_config
        from ..serve.dag_stream import DAG_EOF, DAG_ERR

        cfg = get_config()
        _, req, q = self._submit(_parse_body(request))
        ch = BufferedShmChannel(
            num_readers=1, num_buffers=max(2, cfg.serve_dag_stream_buffers)
        )
        spec = ch.spec()

        def forward():
            try:
                while True:
                    t = q.get(timeout=120)
                    if t is None:
                        ch.write(DAG_EOF, timeout=30)
                        # drain barrier: release() unlinks the segment, so
                        # wait until the proxy acked the EOF frame first
                        ch.wait_consumed(30.0)
                        return
                    if isinstance(t, BaseException):
                        ch.write({DAG_ERR: f"LLM engine pump died: {t!r}"}, timeout=30)
                        ch.wait_consumed(30.0)
                        return
                    # 120s matches the RPC path's queue timeout: a consumer
                    # stalled longer than that loses the stream either way
                    ch.write({"token_id": int(t), "text": self.tok.decode([t])}, timeout=120)
            except (ChannelClosedError, TimeoutError, queue.Empty):
                pass  # proxy abandoned the stream; free the decode slot below
            finally:
                self._forget(req)
                ch.release()

        threading.Thread(target=forward, daemon=True, name="ca-dag-stream").start()
        return spec


class StreamingLLMIngress(ContinuousLLMServer):
    """ContinuousLLMServer whose __call__ STREAMS when the HTTP client asks
    for SSE (Accept: text/event-stream) and answers one JSON body otherwise
    — the proxy's SSE path invokes the ingress's __call__, so token
    streaming over plain `curl -H 'Accept: text/event-stream'` needs the
    branch here."""

    def __call__(self, request):
        from ..serve import Request

        if isinstance(request, Request) and "text/event-stream" in request.headers.get(
            "accept", ""
        ):
            return self.stream(request)  # generator -> one SSE event per token
        return ContinuousLLMServer.__call__(self, request)


def build_continuous_llm_deployment(
    config: Optional[ProcessorConfig] = None,
    *,
    slots: int = 8,
    num_replicas: int = 1,
    num_gpus: Optional[float] = None,
    name: str = "ContinuousLLMServer",
    admission=None,
    autoscaling_config=None,
    sse_ingress: bool = False,
    device=None,
):
    """Continuous-batching twin of build_llm_deployment: up to `slots`
    requests share every decode iteration on each replica.  `admission`
    (AdmissionPolicy/dict) arms the proxy's load-shedding gate;
    `sse_ingress=True` serves token-streaming SSE from __call__.  device
    and num_gpus as in build_llm_deployment."""
    from .. import serve

    config = config or ProcessorConfig()
    dep = serve.deployment(
        StreamingLLMIngress if sse_ingress else ContinuousLLMServer,
        name=name,
        num_replicas=num_replicas,
        num_gpus=_gpus_for(device, num_gpus),
        max_ongoing_requests=slots,  # callers block in __call__; pump is a thread
        admission=admission,
        autoscaling_config=autoscaling_config,
    )
    return dep.bind(config, slots, device)
