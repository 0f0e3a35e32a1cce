"""Open-loop serving through the port's ContinuousLLMServer, in process.

Set-up builds the server the traffic's `engine` describes, copies the
seed's weights into the model it holds, and warms up the cell's shapes (one
padded prefill and a few decode steps).  The window then sends each request
of generator.open_loop on its own client thread at the time it is due,
through `ContinuousLLMServer.stream`, and times it from that due time.
Requests sent in the window are followed to their end, for at most the
mix's `drain_s`.  Then the server is closed and its memory freed, and the
reference (reference.served_logits) reads a sample of the finished requests
drawn from the seed, the longest among them: the widest gap by which a
served token's logit lies below the reference's best decides `correct`.

With trace, the batcher instance's `_admit` and `step` are wrapped to time
each admission and to mark the profiled sub-window's phases.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

from .. import generator, harness, profiling, reference
from .. import weights as W
from ..manifest import model_dims


class PassThroughTokenizer:
    """Token ids in, the same ids out: the traffic brings ids, not text."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, ids, add_bos: bool = True):
        return list(ids)

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)


def build_server(m: Dict, engine: Dict, device):
    from cluster_anywhere_tpu_torch.llm.processor import ModelSpec, ProcessorConfig
    from cluster_anywhere_tpu_torch.llm.serve_llm import ContinuousLLMServer

    pcfg = ProcessorConfig(
        model=ModelSpec(preset="custom", seed=0, config_overrides=harness.port_config_fields(m)),
        tokenizer=PassThroughTokenizer(m["vocab"]),
        max_prompt_len=engine["max_prompt_len"],
        max_new_tokens=engine["max_new_tokens"],
        temperature=0.0, top_k=0, top_p=1.0,
        prefix_cache_entries=engine["prefix_cache_entries"],
        prefix_block=engine["prefix_block"],
    )
    return ContinuousLLMServer(pcfg, slots=engine["slots"], device=str(device))


def _consume(server, body, rec):
    try:
        for ev in server.stream(body):
            rec["times"].append(time.perf_counter())
            rec["tokens"].append(int(ev["token_id"]))
    except Exception as e:  # a failed request is counted, never hidden
        rec["error"] = repr(e)


class _Instrument:
    """Wraps one batcher's _admit and step (instance attributes) for the
    traced run: per-admission wall ms and prompt lengths, each decode's live
    slots and K/V tokens, and the profiler, on the pump thread between two
    steps: prepared at the first step (during the warm-up traffic: its set-up
    holds the interpreter for seconds), started at `start_at` and stopped
    `seconds` after it started.  Admissions count from open() on."""

    def __init__(self, cb, seconds: float):
        from torch.profiler import record_function

        self.admissions, self.decodes = [], []
        self.trace = profiling.Trace()
        self.seconds, self.start_at, self.stop_at = seconds, None, None
        self.state = "unprepared"
        self._live = (0, 0)
        admit, step = cb._admit, cb.step

        def timed_admit(out=None):
            before = list(cb.queue)
            t = time.perf_counter()
            with record_function("perfbench.admit"):
                admit(out)
            dt = time.perf_counter() - t
            k = len(before) - len(cb.queue)
            if k and self.start_at is not None:
                self.admissions.append({"ms": dt * 1e3 / k, "k": k,
                                        "lens": [len(r.prompt_ids) for r in before[:k]],
                                        "profiled": self.state == "on"})
            live = [s for s, r in enumerate(cb._by_slot) if r is not None]
            self._live = (len(live), sum(int(cb._pos[s] - cb._pads[s]) + 1 for s in live))

        def timed_step():
            now = time.perf_counter()
            if self.state == "unprepared":
                self.trace.prepare()
                self.state = "ready"
            elif self.state == "ready" and self.start_at is not None and now >= self.start_at:
                self.trace.begin()
                self.stop_at = time.perf_counter() + self.seconds
                self.state = "on"
            if self.state == "on" and now >= self.stop_at:
                self.trace.end()
                self.state = "done"
            self._live = (0, 0)
            with record_function("perfbench.step"):
                out = step()
            if self._live[0] and self.start_at is not None:
                self.decodes.append({"live": self._live[0], "kv_tokens": self._live[1],
                                     "profiled": self.state == "on"})
            return out

        cb._admit, cb.step = timed_admit, timed_step

    def open(self, start_at: float):
        """The window is open: count from now, profile from start_at."""
        self.start_at = start_at

    def close(self, server):
        """Finish the trace on the pump thread, where the profiler has to
        stop: a trace still on ends, one never started starts and ends, each
        at the next step, which a 1-token request makes the pump take."""
        now = time.perf_counter()
        self.seconds = 0.0
        self.start_at = min(self.start_at or now, now)
        self.stop_at = now if self.stop_at is not None else None
        while self.state != "done":
            for _ in server.stream({"prompt": [0], "max_new_tokens": 1}):
                pass


def sample_requests(recs: List[Dict], seed: int, served_tokens: int, max_requests: int) -> List[Dict]:
    """Finished requests for the reference: the longest (prompt + output),
    then others drawn from the seed until `served_tokens` are covered."""
    done = [r for r in recs if r["finished"]]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r["prompt"]) + len(r["tokens"]))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(generator.derive(seed, "sample")).permutation(len(rest))
    out, n = [longest], len(longest["tokens"])
    for i in order:
        if n >= served_tokens or len(out) >= max_requests:
            break
        out.append(rest[i])
        n += len(rest[i]["tokens"])
    return out


def logit_gaps(w, m: Dict, sample: List[Dict], fmt: str = "fp32"):
    """Per sampled request, the gap by which each served token's reference
    logit lies below the reference's best at its position.  With `fmt`
    other than fp32, the control: the gap, under the fp32 reference, of the
    token that a reference computed in `fmt` puts first there."""
    import torch

    seqs = [r["prompt"] + r["tokens"][:-1] for r in sample]
    rows = [range(len(r["prompt"]) - 1, len(r["prompt"]) + len(r["tokens"]) - 1) for r in sample]
    ref = reference.served_logits(w, m, seqs, rows)
    if fmt == "fp32":
        picks = [torch.as_tensor(r["tokens"], device=lg.device) for r, lg in zip(sample, ref)]
    else:
        picks = [lg.argmax(dim=-1) for lg in reference.served_logits(w, m, seqs, rows, fmt=fmt)]
    return [(lg.max(dim=-1).values - lg.gather(-1, t.long()[:, None])[:, 0]).cpu().numpy()
            for lg, t in zip(ref, picks)]


def release(server) -> None:
    """Stop the pump and drop the server's model and KV cache, also where a
    client thread that never finished still holds the server."""
    server.close()
    cb = server.cb
    cb.params = cb.cache = cb.prefix_cache = None
    server.cb = None


def setup(m: Dict, engine: Dict, seed: int, device):
    """The server of `engine` holding the seed's weights, its cell's shapes
    warmed up: a padded prefill and a few decode steps, twice (the first
    call builds the kernels)."""
    server = build_server(m, engine, device)
    harness.load_weights(server.cb.params, m, seed)
    warm = np.random.default_rng(generator.derive(seed, "warmup"))
    for _ in range(2):
        body = {"prompt": warm.integers(0, m["vocab"], engine["max_prompt_len"] // 4).tolist(),
                "max_new_tokens": 4}
        toks = [ev["token_id"] for ev in server.stream(body)]
        if len(toks) != 4:
            raise RuntimeError(f"the warm-up request gave {len(toks)} tokens, not 4")
    harness.sync(server.cb.device)
    return server


def drive(server, reqs: List[Dict], warm_s: float, seconds: float, drain_s: float,
          on_start=None) -> Dict:
    """Send each request at its due time on a client thread of its own.
    Requests due in the first warm_s bring the server to its steady state;
    the window opens then (on_start(t) runs as it opens), lasts `seconds`,
    and the requests due in it are followed to their end for at most
    drain_s after it closes.  Returns the records and the clock marks."""
    recs = [{"prompt": r["prompt"], "n": r["max_new_tokens"], "tokens": [], "times": [],
             "error": None, "finished": False, "measured": r["due_s"] >= warm_s} for r in reqs]
    t0 = time.perf_counter()
    t_open, t_end = t0 + warm_s, t0 + warm_s + seconds
    threads, late, opened = [], [], False
    for r, rec in zip(reqs, recs):
        rec["due"] = due = t0 + r["due_s"]
        if rec["measured"] and not opened:
            time.sleep(max(0.0, t_open - time.perf_counter()))
            opened = True
            if on_start is not None:
                on_start(t_open)
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(time.perf_counter() - due)
        th = threading.Thread(target=_consume, daemon=True, args=(
            server, {"prompt": r["prompt"], "max_new_tokens": r["max_new_tokens"]}, rec))
        th.start()
        if rec["measured"]:
            threads.append(th)
    time.sleep(max(0.0, t_end - time.perf_counter()))
    backlog = len(server.cb.queue)
    deadline = t_end + drain_s
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.perf_counter()))
    for rec in recs:
        rec["finished"] = rec["error"] is None and len(rec["tokens"]) == rec["n"]
    return {"recs": recs, "t_open": t_open, "t_end": t_end, "deadline": deadline,
            "late_s": max(late), "backlog": backlog}


def end_to_end(run: Dict, seconds: float) -> Dict:
    """Over the requests sent in the window: every gap between a request's
    tokens, and TTFT from each one's due time (one with no token counts at
    the drain's deadline).  The gaps fall in modes about an admission's
    prefill apart (a decode step; one holding one admission, two, ...), so a
    percentile flips between two modes from run to run: the ITL tail is the
    mean of the slowest tenth.  And the output tokens of every request
    delivered inside the window, over its seconds."""
    measured = [r for r in run["recs"] if r["measured"]]
    ttft = [((r["times"][0] if r["times"] else run["deadline"]) - r["due"]) * 1e3
            for r in measured]
    gaps_ms = [g * 1e3 for r in measured for g in np.diff(r["times"])]
    delivered = sum(1 for r in run["recs"] for t in r["times"] if run["t_open"] <= t <= run["t_end"])
    return {
        "ttft_p95_ms": harness.p95(ttft),
        "ttft_p50_ms": float(np.median(ttft)),
        "itl_p95_ms": harness.p95(gaps_ms) if gaps_ms else None,
        "itl_tail10_mean_ms": harness.tail_mean(gaps_ms, 0.1) if gaps_ms else None,
        "output_tok_s": delivered / seconds,
    }


def traffic(mix: Dict, seconds: float, seed: int, vocab: int) -> List[Dict]:
    """The run's requests: the mix's arrivals over its warm-up and the
    window together."""
    return generator.open_loop(mix, mix["warm_s"] + seconds, seed, vocab)


def widest_gap(m: Dict, seed: int, sample: List[Dict], device, fmt: str = "fp32") -> float:
    """The reference's verdict on a sample: the widest logit gap of the
    served tokens (fmt fp32), or of the tokens a reference in `fmt` puts
    first (the control); the seed's weights made anew."""
    import torch

    reference.strict_fp32()
    w = W.make_all(m, seed, device, torch.bfloat16 if m["param_dtype"] == "bfloat16"
                   else torch.float32)
    gaps = logit_gaps(w, m, sample, fmt=fmt)
    del w
    harness.free(device)
    return max((float(g.max()) for g in gaps), default=float("inf"))


def run(cell: Dict, *, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    m = model_dims(cell["config"])
    mix = cell["traffic"]
    limits = cell["config"]["limits"]["serve"]

    server = setup(m, mix["engine"], seed, device)
    cb = server.cb
    inst = _Instrument(cb, mix["profile"]["seconds"]) if trace else None
    reqs = traffic(mix, seconds, seed, m["vocab"])
    marks = {}

    def on_start(t_open):
        marks["setup_s"] = time.time() - t_start
        if inst is not None:
            inst.open(t_open + mix["profile"]["start_fraction"] * seconds)

    # launches and admissions are counted over all the traffic, from an idle
    # pump to the drained one: a count taken while the pump runs can fall
    # inside an admission
    stats0, launches0 = dict(cb.stats), harness.launches()
    run_ = drive(server, reqs, mix["warm_s"], seconds, mix["drain_s"], on_start)
    if inst is not None:
        inst.close(server)
    stats1, launches1 = dict(cb.stats), harness.launches()
    memory_peak = harness.peak_bytes(device)
    recs = run_["recs"]
    measured = [rec for rec in recs if rec["measured"]]
    failed = sum(1 for rec in measured if not rec["finished"])
    e2e = end_to_end(run_, seconds)
    e2e["setup_s"] = marks["setup_s"]
    admitted = stats1["admitted"] - stats0["admitted"]
    fwd = launches1["flash_fwd"] - launches0["flash_fwd"]
    harness.log(f"{len(measured)} requests over {seconds} s after {len(recs) - len(measured)} "
                f"in {mix['warm_s']} s of warm-up, {failed} failed, generator late by at most "
                f"{run_['late_s'] * 1e3:.1f} ms, {run_['backlog']} queued at the window's end; "
                f"{admitted} admitted, {stats1['decode_steps'] - stats0['decode_steps']} decode "
                f"steps, {fwd} flash_fwd launches; e2e {e2e}; peak {memory_peak / 1e9:.2f} GB")

    ctx = summary = None
    if trace:
        summary = inst.trace.reduce()
        ctx = {"dims": m, "mix": mix, "trace": summary, "admissions": inst.admissions,
               "decodes": inst.decodes, "seconds": seconds}
        harness.log(f"trace: {len(summary['kernels'])} kernels, busy {summary['busy_s']:.3f} s of "
                    f"{summary['window_s']:.3f} s, reduced in {summary['reduce_s']:.1f} s, "
                    f"{sum(1 for k in summary['kernels'] if k[3] is None)} outside any phase")

    sample = sample_requests(measured, seed, limits["served_tokens"], limits["max_requests"])
    release(server)
    del server, cb, inst
    harness.free(device)

    t_ref = time.perf_counter()
    widest = widest_gap(m, seed, sample, device)
    harness.log(f"reference: {len(sample)} requests, {sum(len(r['tokens']) for r in sample)} "
                f"served tokens, widest logit gap {widest:.5f}, in "
                f"{time.perf_counter() - t_ref:.1f} s")

    checks = {"logit_gap": harness.check(widest, limits["logit_gap"])}
    if device.type == "cuda":  # the port counts kernel launches, not its CPU path
        checks["flash_fwd_launches_off"] = harness.check(abs(m["n_layers"] * admitted - fwd), 0)
    out = {
        "correct": all(c["pass"] for c in checks.values()),
        "attempted": len(measured),
        "failed": failed,
        "e2e": e2e,
        "memory_peak_bytes": memory_peak,
        "checks": checks,
        "ctx": ctx,
    }
    if trace:
        out["trace"] = {"busy_s": summary["busy_s"], "window_s": summary["window_s"]}
        out["breakdown"] = profiling.breakdown(summary)
    return out
